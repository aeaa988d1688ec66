"""The kernel-build cache (``valle2_tpu_torch/compile_cache.py``), the AOT
library directory and its counting call sites (``aot.py``), and the
cold-start tool, on the CPU with the nvcc step stubbed (no CUDA toolchain
here): a stand-in ``nvcc`` writes a marker file, and the library loader
accepts only that marker, so a corrupt entry fails to load as a bad
library would.

Held to the JAX package's precedence cases (``tests/test_compile_cache.py``,
``tests/test_aot.py``); the library key changes with a source, the flags,
the nvcc release and the compute capability; ``CachedJit`` counts nvcc runs,
disk loads and rebuilt entries, a corrupt entry is rebuilt and replaced;
the CLIs take ``--compile-cache`` and ``--aot-cache``; the server's
``aot_*`` stats read the fused call's counters; ``coldstart_bench warmup``
prints its JSON line on a tiny CPU config."""

import json
import shutil
import stat
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_port_helpers import SMALL
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu import aot as jaot
from valle2_tpu import compile_cache as jcc
from valle2_tpu_torch import aot, compile_cache
from valle2_tpu_torch.kernels import _build

TINY = dict(SMALL, max_audio_len=6, num_beams=1, temperature=0.0, batch_size=2)
MARK = b'stub library\n'
FAKE_NVCC = f'''#!{sys.executable}
import sys
if '--version' in sys.argv:
    print('nvcc: NVIDIA (R) Cuda compiler driver')
    print('Cuda compilation tools, release 12.4, V12.4.131')
    raise SystemExit(0)
with open(sys.argv[sys.argv.index('-o') + 1], 'wb') as f:
    f.write({MARK!r})
'''


class StubLib:
    def __init__(self, path):
        self.path = path


def stub_dlopen(path):
    if Path(path).read_bytes() != MARK:
        raise OSError(f'{path}: invalid ELF header')
    return StubLib(path)


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """A fresh process's build state over the stand-in nvcc, restored after."""
    nvcc = tmp_path / 'nvcc'
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, '_nvcc', lambda: str(nvcc))
    monkeypatch.setattr(_build, '_dlopen', stub_dlopen)
    monkeypatch.setattr(_build, '_loaded', {})
    monkeypatch.setattr(_build, '_state', dict(_build._state, toolchain=None,
                                               build_dir=tmp_path / 'build', aot_dir=None))
    for var in ('VALLE2_COMPILE_CACHE', 'VALLE2_AOT_CACHE'):
        monkeypatch.delenv(var, raising=False)
    return tmp_path


def fresh_process(monkeypatch):
    """Forget the libraries loaded so far, as a restarted process would."""
    monkeypatch.setattr(_build, '_loaded', {})


def program(x):
    """A stand-in for a call site whose kernels load two libraries."""
    _build.load('rvq')
    _build.load('gemm')
    return x * 2


# ---- precedence (JAX tests/test_compile_cache.py:31-53, tests/test_aot.py:145) ----

@pytest.mark.parametrize('mod, jmod, resolve, var', [
    (compile_cache, jcc, 'resolve_cache_dir', 'VALLE2_COMPILE_CACHE'),
    (aot, jaot, 'resolve_aot_dir', 'VALLE2_AOT_CACHE')])
def test_resolution_precedence_matches_jax(monkeypatch, mod, jmod, resolve, var):
    ours, theirs = getattr(mod, resolve), getattr(jmod, resolve)
    monkeypatch.setenv(var, '/env/dir')
    for args in (('/arg/dir', '/cfg/dir'), (None, '/cfg/dir'), ('', '/cfg/dir')):
        assert ours(*args) == theirs(*args)
    assert ours('/arg/dir', '/cfg/dir') == '/arg/dir'
    assert ours(None, '/cfg/dir') == '/env/dir'
    monkeypatch.delenv(var)
    assert ours(None, '/cfg/dir') == '/cfg/dir' == theirs(None, '/cfg/dir')
    assert ours(None, '') is None and ours('', None) is None
    got = ours('~/cc')
    assert got is not None and not got.startswith('~')


def test_enable_points_the_builds_and_the_aot_dir(stub_nvcc):
    assert compile_cache.enable_compilation_cache(None, fallback='') is None
    assert _build.build_dir() == _build.BUILD_DIR          # empty everywhere: the default
    d = compile_cache.enable_compilation_cache(stub_nvcc / 'cc')
    assert d == str(stub_nvcc / 'cc') == compile_cache.cache_dir()
    assert _build._lib_path('rvq').parent == stub_nvcc / 'cc'
    assert aot.enable_aot_cache(None) is None and aot.aot_cache_dir() is None
    assert aot.enable_aot_cache(fallback=str(stub_nvcc / 'aot')) == str(stub_nvcc / 'aot')
    assert aot.aot_cache_dir() == str(stub_nvcc / 'aot')
    aot.disable_aot_cache()
    assert aot.aot_cache_dir() is None


# ---- the library key ---------------------------------------------------------

def test_key_changes_with_source_flags_nvcc_release_and_card(stub_nvcc, monkeypatch):
    csrc = stub_nvcc / 'csrc'
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, 'CSRC_DIR', csrc)
    base = _build.library_key('rvq')
    assert _build.toolchain() == ('release 12.4, V12.4.131', 'none')
    assert _build.library_key('rvq') == base                    # stable
    (csrc / 'rvq.cu').write_text((csrc / 'rvq.cu').read_text() + '\n// edit\n')
    assert _build.library_key('rvq') != base
    k_src = _build.library_key('rvq')
    (csrc / 'common.cuh').write_text((csrc / 'common.cuh').read_text() + '\n')
    assert _build.library_key('rvq') != k_src                   # headers count
    k_hdr = _build.library_key('rvq')
    monkeypatch.setitem(_build.BUILDS, 'rvq', ('rvq', ('-DX=1',)))
    assert _build.library_key('rvq') != k_hdr
    k_flags = _build.library_key('rvq')
    monkeypatch.setitem(_build._state, 'toolchain', ('release 12.8, V12.8.93', 'none'))
    assert _build.library_key('rvq') != k_flags
    k_nvcc = _build.library_key('rvq')
    monkeypatch.setitem(_build._state, 'toolchain', ('release 12.8, V12.8.93', '9.0'))
    assert _build.library_key('rvq') != k_nvcc


# ---- counting, the AOT dir, corrupt entries -----------------------------------

def test_cached_jit_counts_builds_then_disk_loads(stub_nvcc, monkeypatch):
    aot.enable_aot_cache(stub_nvcc / 'aot')
    cj = aot.cached_jit(program, tag='prog', extra_key='cfg')
    assert cj(torch.ones(3)).tolist() == [2, 2, 2]
    assert (cj.n_compiles, cj.n_disk_loads, cj.n_fallbacks) == (2, 0, 0)
    for d in ('build', 'aot'):                # built, then published to the AOT dir
        assert sorted(p.name.split('-')[0] for p in (stub_nvcc / d).glob('*.so')) \
            == ['gemm', 'rvq']
    cj(torch.ones(3))                         # same signature: nothing new
    cj(torch.ones(5))                         # a new one, libraries already in memory
    assert (cj.n_compiles, cj.n_disk_loads, cj.n_fallbacks) == (2, 0, 0)
    fresh_process(monkeypatch)                # a restarted process: loads from disk
    again = aot.cached_jit(program, tag='prog', extra_key='cfg')
    again(torch.ones(3))
    assert (again.n_compiles, again.n_disk_loads, again.n_fallbacks) == (0, 2, 0)
    fresh_process(monkeypatch)                # without the AOT dir: the build dir serves
    aot.disable_aot_cache()
    third = aot.cached_jit(program, tag='prog')
    third(torch.ones(3))
    assert (third.n_compiles, third.n_disk_loads) == (0, 2)


@pytest.mark.parametrize('where', ['aot', 'build'])
def test_corrupt_entry_is_rebuilt_and_replaced(stub_nvcc, monkeypatch, where):
    aot.enable_aot_cache(stub_nvcc / 'aot')
    aot.cached_jit(program, tag='prog')(torch.ones(2))
    fresh_process(monkeypatch)
    if where == 'build':
        aot.disable_aot_cache()
    bad = stub_nvcc / where / _build._lib_name('rvq')
    bad.write_bytes(b'\x7fELF truncated')
    cj = aot.cached_jit(program, tag='prog')
    assert cj(torch.ones(2)).tolist() == [2, 2]           # the kernels run, no plain fallback
    assert (cj.n_compiles, cj.n_disk_loads, cj.n_fallbacks) == (1, 1, 1)
    assert bad.read_bytes() == MARK                       # replaced by the rebuild
    assert (stub_nvcc / 'build' / _build._lib_name('rvq')).read_bytes() == MARK


def test_record_loads_splits_build_and_load_times(stub_nvcc):
    with _build.record_loads() as events:
        _build.load('rvq')
        _build.load('rvq')                    # in memory: not a load
    assert [(e['name'], e['how']) for e in events] == [('rvq', 'compiled')]
    assert events[0]['build_s'] > 0 and events[0]['load_s'] >= 0


def test_build_all_fills_the_build_and_aot_dirs(stub_nvcc):
    aot.enable_aot_cache(stub_nvcc / 'aot')
    _build.build_all()
    for d in ('build', 'aot'):
        assert {p.name.rsplit('-', 1)[0] for p in (stub_nvcc / d).glob('*.so')} \
            == set(_build.BUILDS)


def test_size_bound_evicts_least_recently_used(stub_nvcc):
    compile_cache.enable_compilation_cache(stub_nvcc / 'cc', max_size_bytes=2 * len(MARK))
    for name in ('rvq', 'gemm', 'fused_decode'):
        _build.load(name)
    left = sorted(p.name.rsplit('-', 1)[0] for p in (stub_nvcc / 'cc').glob('*.so'))
    assert left == ['fused_decode', 'gemm']


def test_signature_keys():
    cj = aot.cached_jit(lambda *a, **k: None, tag='t', extra_key='a')
    x = torch.ones(2, 3)
    k = cj._key((x, {'a': x}, 3), {})
    assert k == cj._key((torch.zeros(2, 3), {'a': x}, 3), {})     # values do not count
    assert k != cj._key((torch.ones(2, 4), {'a': x}, 3), {})      # shapes do
    assert k != cj._key((x.double(), {'a': x}, 3), {})            # dtypes do
    assert k != cj._key((x, {'a': x}, 4), {})                     # scalars do
    assert k != aot.cached_jit(lambda: None, tag='t', extra_key='b')._key((x, {'a': x}, 3), {})


# ---- the entry points ---------------------------------------------------------

@pytest.fixture
def tiny_cfg(tmp_path):
    path = tmp_path / 'tiny.json'
    path.write_text(json.dumps(dict(TINY, bucket_sizes=[16, 32, 64])))
    return path


@pytest.fixture
def restore_dirs(monkeypatch):
    monkeypatch.setattr(_build, '_state', dict(_build._state))
    for var in ('VALLE2_COMPILE_CACHE', 'VALLE2_AOT_CACHE'):
        monkeypatch.delenv(var, raising=False)


def test_tts_cli_takes_both_cache_flags(tmp_path, tiny_cfg, restore_dirs):
    from valle2_tpu_torch import tts
    from valle2_tpu_torch.utils import save_wav
    save_wav(tmp_path / 'p.wav', np.sin(np.arange(4000) / 9.0).astype(np.float32) * 0.5, 16000)
    tts.main(['-c', str(tiny_cfg), '--device', 'cpu', '--text', 'hi.', '--prompt-wav',
              str(tmp_path / 'p.wav'), '-o', str(tmp_path / 'out.wav'),
              '--compile-cache', str(tmp_path / 'cc'), '--aot-cache', str(tmp_path / 'aot')])
    assert (tmp_path / 'out.wav').exists()
    assert _build.build_dir() == tmp_path / 'cc' and _build.aot_dir() == tmp_path / 'aot'


def test_serve_cli_takes_both_cache_flags_and_stats_report_counters(tmp_path, tiny_cfg,
                                                                    restore_dirs, monkeypatch):
    from valle2_tpu_torch import serve
    seen = {}

    def fake_http(server, **kw):
        server.tts._fused_jit.n_compiles = 3      # as a cold card's first batch would
        server.tts._fused_jit.n_disk_loads = 1
        seen['stats'] = server.stats()
        return object()
    monkeypatch.setattr(serve, 'serve_http', fake_http)
    monkeypatch.setattr(serve, 'join_handler_threads', lambda httpd, timeout: True)
    serve.main(['-c', str(tiny_cfg), '--device', 'cpu', '--port', '0',
                '--compile-cache', str(tmp_path / 'cc'), '--aot-cache', str(tmp_path / 'aot')])
    assert _build.build_dir() == tmp_path / 'cc' and _build.aot_dir() == tmp_path / 'aot'
    assert {k: seen['stats'][k] for k in ('aot_compiles', 'aot_disk_loads', 'aot_fallbacks')} \
        == {'aot_compiles': 3, 'aot_disk_loads': 1, 'aot_fallbacks': 0}


def test_coldstart_bench_warmup_prints_its_line(tiny_cfg, restore_dirs, capsys):
    from valle2_tpu_torch.tools import coldstart_bench
    assert coldstart_bench.main(['warmup', '-c', str(tiny_cfg), '--device', 'cpu']) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line['mode'] == 'warmup'
    assert {'init_s', 'warmup_s', 'total_s', 'first_request_s', 'aot_compiles',
            'aot_disk_loads', 'aot_fallbacks', 'codes_sum'} <= set(line)
    assert line['first_request_s'] >= line['warmup_s'] > 0
    assert line['aot_compiles'] == line['aot_disk_loads'] == 0     # no kernel on the CPU


def test_the_new_modules_import_no_jax():
    """The port's checkpoint, audio, profiling, cache and tool modules import
    neither JAX nor the JAX package (only scripts/orbax_to_torch.py does)."""
    import subprocess
    code = ('import sys\n'
            'import valle2_tpu_torch.aot, valle2_tpu_torch.compile_cache, '
            'valle2_tpu_torch.profiling, valle2_tpu_torch.native.audio, '
            'valle2_tpu_torch.models, valle2_tpu_torch.models.convert, '
            'valle2_tpu_torch.tools.coldstart_bench, valle2_tpu_torch.tools.verify_pretrained, '
            'valle2_tpu_torch.train\n'
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", '
            '"valle2_tpu", "orbax"))\n'
            'assert not bad, bad')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize('mode', ['compile', 'decompose-compile'])
def test_coldstart_bench_other_modes_print_their_lines(tiny_cfg, restore_dirs, capsys, mode):
    from valle2_tpu_torch.tools import coldstart_bench
    assert coldstart_bench.main([mode, '-c', str(tiny_cfg), '--device', 'cpu']) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = ({'first_call_s', 'second_call_s'} if mode == 'compile'
            else {'compile_s', 'load_s', 'first_exec_s', 'libraries'})
    assert want | {'first_request_s', 'aot_compiles', 'aot_disk_loads'} <= set(line)
    assert line['aot_compiles'] == 0
