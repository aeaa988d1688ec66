"""The grammar tools of valle2_tpu_torch on the CPU: ``quant_quality`` over a
run directory built here (the grid, its JSON keys, the reference cell's
codes against an in-memory greedy decode), ``lora_sweep --smoke`` on it, and
``grammar_production --smoke --v3``: the train CLI three times as
subprocesses, a real SIGTERM after step N, the ``--resume`` run to the end,
then the v3 evaluation suite from the checkpoints.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu_torch.config import ConfigValle
from valle2_tpu_torch.data import grammar as tg
from valle2_tpu_torch.models import ValleAR, ValleNAR
from valle2_tpu_torch.tools import grammar_production, lora_sweep, quant_quality

RUN_CONFIG = dict(grammar_production.base_config(Path('.'), smoke=True),
                  dataset='grammar://speakers=2,pairs=8', max_audio_len=10,
                  kv_cache_dtype='float32', matmul_precision='highest')
QUANT_KEYS = {'run_dir', 'v3', 'n_sentences', 'speaker', 'reference_cell',
              'reference_quality', 'recommended', 'backend', 'grid'}   # the JAX tool's


@pytest.fixture(scope='module')
def run_dir(tmp_path_factory):
    """A run dir in grammar_production's layout: report.json and seeded
    AR / NAR / ASR params files."""
    root = tmp_path_factory.mktemp('grammar_run')
    cfg = ConfigValle.from_dict(RUN_CONFIG)
    runs = {}
    for name, model, over in (('ValleAR', ValleAR, {}),
                              ('ValleNAR', ValleNAR, dict(norm='AdaptiveLayerNorm')),
                              ('ValleASR', ValleAR, dict(direction='asr'))):
        m = model(dataclasses.replace(cfg, **over), seed=len(runs), device='cpu')
        m.save(root / f'{name}.pt')
        runs[name] = {'final_ckpt': str(root / f'{name}.pt')}
        runs[f'{name}_config'] = over
    (root / 'report.json').write_text(json.dumps({'config': RUN_CONFIG, 'runs': runs}))
    return root


def test_quant_quality_grid_on_a_local_run_dir(run_dir, tmp_path):
    out = tmp_path / 'qq.json'
    quant_quality.main(['--run-dir', str(run_dir), '--limit', '2', '--device', 'cpu',
                        '--out', str(out)])
    rep = json.loads(out.read_text())
    assert set(rep) == QUANT_KEYS and rep['backend'] == 'cpu' and rep['n_sentences'] == 2
    names = {quant_quality.cell_name(*c) for c in quant_quality.cells()}
    assert set(rep['grid']) == names and len(names) == 18
    for name, cell in rep['grid'].items():
        assert 'error' not in cell, (name, cell)
        assert 0.0 <= cell['quality'] <= 1.0 and np.isfinite(cell['nll_per_token'])
    assert rep['recommended'] in names
    # compute weights: one NLL whatever the cache and the route
    assert len({rep['grid'][quant_quality.cell_name('compute', k, f)]['nll_per_token']
                for k in ('float32', 'bfloat16', 'int8') for f in (True, False)}) == 1

    # the reference cell's greedy codes == the in-memory model's greedy decode
    cfg = ConfigValle.from_dict(RUN_CONFIG)
    ref = ValleAR(dataclasses.replace(cfg, temperature=0.0, num_beams=1,
                                      use_fused_decode=False), device='cpu')
    ref.load(run_dir / 'ValleAR.pt')
    mem = ValleAR(cfg, params=ref.params, device='cpu')
    tok = tg.PhonemeTokenizer(use_g2p=False)
    train_s, held_s = tg.split_sentences()
    spec = tg.multispeaker_spec(2, num_audio_tokens=cfg.num_audio_tokens)
    got, _ = quant_quality.decode_cell(ref, held_s[:2], spec, tok, train_s[0], 0, False)
    p_toks = tok(train_s[0] + ' ')
    pcodes = tg.synthesize_codes(p_toks, spec, 0).T
    want = mem.generate_batch([np.concatenate([p_toks, tok(s)]) for s in held_s[:2]],
                              [pcodes] * 2)
    assert all(np.array_equal(g, w.numpy()) for g, w in zip(got, want))


def test_quant_quality_scores_every_cell_of_a_bf16_run_dir(run_dir, tmp_path):
    """grammar_production's own dtype: under a bfloat16 model every cell
    scores, the float32-cache cells with the fused step included."""
    bf16 = tmp_path / 'bf16_run'
    bf16.mkdir()
    report = json.loads((run_dir / 'report.json').read_text())
    report['config'] = dict(report['config'], dtype='bfloat16')
    (bf16 / 'report.json').write_text(json.dumps(report))
    out = tmp_path / 'qq.json'
    quant_quality.main(['--run-dir', str(bf16), '--limit', '2', '--device', 'cpu',
                        '--out', str(out)])
    grid = json.loads(out.read_text())['grid']
    assert len(grid) == 18
    for name, cell in grid.items():
        assert 'error' not in cell, (name, cell)
        assert 0.0 <= cell['quality'] <= 1.0 and np.isfinite(cell['nll_per_token'])


class _DeviceSeen(Exception):
    pass


@pytest.mark.parametrize('tool', ['lora_sweep', 'grammar_production'])
def test_smoke_runs_on_the_card_unless_the_cpu_is_asked_for(tool, run_dir, tmp_path,
                                                             monkeypatch):
    """--smoke sets CPU-sized shapes only: without --device the tool asks
    for the card (the first device it hands on is 'cuda')."""
    def seen(*args, device=None, **kw):
        raise _DeviceSeen(str(device))
    if tool == 'lora_sweep':
        import valle2_tpu_torch.models.ar as ar_mod
        monkeypatch.setattr(ar_mod, 'ValleAR', seen)
        argv = ['--run-dir', str(run_dir), '--smoke', '--out', str(tmp_path / 'o.json')]
        main = lora_sweep.main
    else:
        monkeypatch.setattr(grammar_production, 'train_all', seen)
        argv = ['--smoke', '--v3', '--run-dir', str(tmp_path / 'run')]
        main = grammar_production.main
    with pytest.raises(_DeviceSeen, match='^cuda$'):
        main(argv)


def test_lora_sweep_smoke(run_dir, tmp_path):
    out = tmp_path / 'ls.json'
    lora_sweep.main(['--run-dir', str(run_dir), '--smoke', '--device', 'cpu',
                     '--out', str(out)])
    rep = json.loads(out.read_text())
    assert set(rep['arms']) == {'rank4', 'full_ft'} and rep['backend'] == 'cpu'
    r4, full = rep['arms']['rank4'], rep['arms']['full_ft']
    assert 0 < r4['trainable_params'] < full['trainable_params']
    for arm in (r4, full):
        assert arm['steps'] > 0 and len(arm['curve']) >= 1
        assert all(np.isfinite(c['loss']) for c in arm['curve'])
    assert rep['serving']['picked_arm'] == 'rank4'
    assert set(rep['serving']['per_voice_exact']) == {'base', 'adapted'}


def test_grammar_production_smoke_v3_end_to_end(tmp_path, monkeypatch):
    """The --v3 orchestration end to end at CPU scale (the JAX tool's
    assertions): the preemption fired and the resume finished, the NAR
    trained with corruption, every v3 evaluation ran.  The CLI children run
    one torch thread each, without tensorboardX (a stand-in module that
    fails to import: the trainer then logs no TensorBoard events)."""
    stub = tmp_path / 'stub' / 'tensorboardX'
    stub.mkdir(parents=True)
    (stub / '__init__.py').write_text("raise ImportError('tensorboardX left out')\n")
    monkeypatch.setenv('PYTHONPATH', str(stub.parent))
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    out = tmp_path / 'GRAMMAR_V3_SMOKE.json'
    grammar_production.main(['--smoke', '--v3', '--device', 'cpu',
                             '--run-dir', str(tmp_path / 'run'), '--out', str(out)])
    rep = json.loads(out.read_text())
    ar = rep['runs']['ValleAR']
    assert ar['phase_a']['preempted_at'] is not None
    assert ar['phase_b']['rc'] == 0 and ar['train']
    assert ar['phase_b']['train'][-1][0] == rep['config']['max_steps']
    for model in ('ValleAR', 'ValleNAR', 'ValleASR'):
        assert rep['runs'][model]['final_ckpt']
    assert rep['runs']['ValleNAR_config']['nar_corrupt_p'] > 0
    ev = rep['evals']
    for key in ('closed_loop_v3', 'temperature_curve', 'best_of_n_validity', 'nll',
                'nar_refinement', 'prompt_conditioning_v3'):
        assert key in ev, key
    assert ev['nll']['floor_per_phoneme'] > 0
    assert len(ev['temperature_curve']) == 4
    assert ev['backend'] == 'cpu'
    assert (tmp_path / 'run' / 'report.json').exists()
    assert torch.get_num_threads() == 1      # the module's fixture still holds
