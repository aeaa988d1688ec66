"""``valle2_tpu_torch/profiling.py`` on the CPU (``valle2_tpu/profiling.py``):
``trace`` writes a Chrome-format ``trace.json`` holding the ``annotate``
ranges (the TTS pipeline's stages among them), ``memory_stats`` has JAX's
three keys (zeros on the CPU), an injected NaN raises ``FloatingPointError``
under ``enable_nan_checks`` (in the loss, and in a grad alone), the port's
kernel names are read from the CUDA sources, and the train CLI runs with
``--profile`` and ``--debug-nans`` on the CPU."""

import json

import numpy as np
import pytest
import torch
from torch_port_helpers import SMALL
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu import profiling as jprof
from valle2_tpu_torch import profiling
from valle2_tpu_torch import train as ttrain
from valle2_tpu_torch.config import ConfigValle
from valle2_tpu_torch.kernels import _build

TINY = dict(SMALL, max_audio_len=6, num_beams=1, temperature=0.0, batch_size=2)


def names(path) -> set:
    with open(path) as f:
        return {e.get('name') for e in json.load(f)['traceEvents']}


@pytest.fixture
def nan_checks():
    profiling.enable_nan_checks()
    yield
    profiling.enable_nan_checks(False)


def test_trace_writes_chrome_json_with_annotate_ranges(tmp_path):
    @profiling.annotate('decorated_range')
    def work():
        return torch.ones(64, 64) @ torch.ones(64, 64)

    with profiling.trace(tmp_path / 'prof') as stats:
        with profiling.annotate('outer_range'):
            work()
    assert stats.path == tmp_path / 'prof' / 'trace.json' and stats.path.exists()
    assert {'outer_range', 'decorated_range'} <= names(stats.path)
    assert stats.launches == 0 and stats.kernel_records == 0     # no card here


def test_trace_of_a_synthesis_holds_the_pipeline_stages(tmp_path):
    from valle2_tpu_torch.tts import ValleTTS
    tts = ValleTTS(ConfigValle(**TINY), device='cpu')
    rs = np.random.RandomState(0)
    with profiling.trace(tmp_path) as stats:
        tts.synthesize('hi there.', rs.randint(0, 60, (4,)), rs.randint(0, 1024, (5, 8)))
    assert {'frontend', 'ar_decode', 'nar_refine', 'codec_decode'} <= names(stats.path)


def test_trace_warns_when_records_fall_short_of_launches(tmp_path, monkeypatch):
    warned = []
    monkeypatch.setattr(profiling, 'log_warning', lambda msg, *a: warned.append(msg % a))
    counter = _build.LaunchCounter()
    try:
        with profiling.trace(tmp_path) as stats:
            counter.count += 3          # launches the trace cannot hold on the CPU
    finally:
        _build.COUNTERS.remove(counter)
    assert stats.launches == 3 and stats.kernel_records == 0
    assert any('0 records' in w and '3 launches' in w for w in warned), warned


def test_kernel_names_are_the_sources_global_functions():
    k = profiling.kernel_names()
    assert {'flash_fwd_cc_kernel', 'flash_fwd_kernel', 'step_persistent_kernel',
            'rvq_cluster_kernel', 'flash_bwd_kv_kernel', 'gemm_fullk_kernel'} <= k
    assert profiling._kernel_of('void flash_fwd_cc_kernel<float, 64>(float const*)') \
        == 'flash_fwd_cc_kernel'
    assert profiling._kernel_of('ampere_sgemm_128x64_nn') is None


def test_memory_stats_keys_match_jax():
    got = profiling.memory_stats('cpu')
    assert set(got) == {'bytes_in_use', 'peak_bytes_in_use', 'bytes_limit'}
    assert set(got) == set(jprof.memory_stats())
    assert all(v == 0 for v in got.values())


def test_peak_constant_and_flop_counters():
    assert profiling.H100_PEAK_BF16_FLOPS == 989e12
    cfg = ConfigValle(**TINY)
    assert profiling.train_step_flops(cfg, 2, 8, 12) == jprof.train_step_flops(cfg, 2, 8, 12)


def ar_batch(seed=0):
    rs = np.random.RandomState(seed)
    return {'tokens': torch.from_numpy(rs.randint(0, 256, (2, 6)).astype(np.int32)),
            'tokens_lens': torch.tensor([6, 4], dtype=torch.int32),
            'codes': torch.from_numpy(rs.randint(0, 1026, (2, 10)).astype(np.int32)),
            'codes_lens': torch.tensor([10, 7], dtype=torch.int32),
            'target': torch.from_numpy(rs.randint(0, 1025, (2, 10)).astype(np.int32))}


@pytest.mark.parametrize('where', ['param', 'grad'])
def test_injected_nan_raises_floating_point_error(nan_checks, where):
    cfg = ConfigValle(**TINY)
    state = ttrain.init_state(cfg, 'ValleAR', device='cpu')
    step = ttrain.make_train_step(cfg, 'ValleAR')
    with torch.no_grad():
        if where == 'param':        # NaN in the forward: the loss is NaN
            state.params['transformer']['ffn']['lin1']['w'][0, 0, 0] = float('nan')
        else:                       # a finite loss whose backward yields a NaN
            state.params['proj']['w'].register_hook(lambda g: g * float('nan'))
    before = state.params['audio_emb']['emb'].detach().clone()
    with pytest.raises(FloatingPointError):
        step(state, ar_batch(), 0)
    assert torch.equal(state.params['audio_emb']['emb'], before)   # no update applied


def test_without_nan_checks_a_nan_does_not_raise():
    cfg = ConfigValle(**TINY)
    state = ttrain.init_state(cfg, 'ValleAR', device='cpu')
    with torch.no_grad():
        state.params['transformer']['ffn']['lin1']['w'][0, 0, 0] = float('nan')
    _, m = ttrain.make_train_step(cfg, 'ValleAR')(state, ar_batch(), 0)
    assert not torch.isfinite(m['loss'])


def test_train_cli_profile_and_debug_nans_on_cpu(tmp_path):
    cfg = dict(TINY, max_steps=2, log_every_n_steps=1, ckpt_every_n_steps=0,
               ckpt_path=str(tmp_path / 'ckpt'), log_path=str(tmp_path / 'logs'),
               prefetch_batches=0, async_checkpoint=False)
    (tmp_path / 'cfg.json').write_text(json.dumps(cfg))
    try:
        ttrain.main(['-c', str(tmp_path / 'cfg.json'), '-m', 'ValleAR', '--synthetic',
                     '--device', 'cpu', '--profile', str(tmp_path / 'prof'), '--debug-nans'])
    finally:
        profiling.enable_nan_checks(False)
    assert 'train_step' in names(tmp_path / 'prof' / 'trace.json')
    assert (tmp_path / 'ckpt' / 'ValleAR' / 'step_2' / 'state.pt').exists()
