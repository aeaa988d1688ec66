"""The roofline probe's GEMM kernels (#9, #10) of valle2_tpu_torch against
the JAX package's Pallas ``matmul_fullk`` / ``matmul_ksplit``
(probes/_gemm_pallas_roofline.py), run in TPU interpret mode on the CPU, and
the port's probe in its CPU mode.  On the CPU each wrapper checks its inputs
as on the card, then takes ``matmul_plain``; chip_smoke.py and
tests/test_torch_cuda.py hold the CUDA kernels against it on the card.
Tolerance: ``gemm_roofline.tolerance`` (one bf16 ulp of the result plus the
f32 summation-order error)."""

import importlib.util
import io
import json
import os
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_port_helpers import close
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

import valle2_tpu.compile_cache
from valle2_tpu_torch.kernels import gemm
from valle2_tpu_torch.probes import gemm_roofline

ROOT = Path(__file__).resolve().parents[1]
CACHE_ENV = 'JAX_COMPILATION_CACHE_DIR'


@pytest.fixture(scope='module')
def jax_probe():
    """probes/_gemm_pallas_roofline.py loaded as a module, with what its
    import does to the process held off and put back: it calls
    ``enable_compilation_cache('/tmp/jax_cache_tpu')`` (a no-op here), sets
    the cache variable by default (set here to its current value, or
    removed, and restored) and prepends the repo to sys.path (restored).
    Returns (module, the cache directory and variable before the import)."""
    before = (jax.config.jax_compilation_cache_dir, os.environ.get(CACHE_ENV))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(valle2_tpu.compile_cache, 'enable_compilation_cache',
                   lambda *a, **k: None)
        mp.setenv(CACHE_ENV, before[1] or '')      # recorded, so restored on exit
        if before[1] is None:
            mp.delenv(CACHE_ENV)
        mp.setattr(sys, 'path', list(sys.path))
        spec = importlib.util.spec_from_file_location(
            '_gemm_pallas_roofline', ROOT / 'probes' / '_gemm_pallas_roofline.py')
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod, before


def operands(m, k, n, seed=0):
    rs = np.random.RandomState(seed)
    a = rs.standard_normal((m, k)).astype(np.float32)
    b = rs.standard_normal((k, n)).astype(np.float32)
    return (torch.from_numpy(a).to(torch.bfloat16), torch.from_numpy(b).to(torch.bfloat16),
            jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))


JAX_CASES = {
    # kernel: (JAX arm's keyword tiles, port wrapper, its keywords)
    'fullk': (dict(bm=128, bn=128), gemm.matmul_fullk, {}),
    'ksplit': (dict(bm=128, bn=128, bk=64), gemm.matmul_ksplit, dict(splits=2)),
}


@pytest.mark.parametrize('shape', [(256, 128, 256), (128, 256, 384)], ids=str)
@pytest.mark.parametrize('kernel', sorted(JAX_CASES))
def test_plain_matches_jax_pallas_probe(jax_probe, kernel, shape):
    """matmul_plain and the port wrapper on CPU tensors == the JAX Pallas
    kernel (TPU interpret mode) on the same bf16 operands."""
    mod, _ = jax_probe
    m, k, n = shape
    ta, tb, ja, jb = operands(m, k, n, seed=sum(shape))
    tiles, port_fn, port_kw = JAX_CASES[kernel]
    with pltpu.force_tpu_interpret_mode():
        want = getattr(mod, f'matmul_{kernel}')(ja, jb, **tiles)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    got = gemm.matmul_plain(ta, tb)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    allowed = gemm_roofline.tolerance(ta, tb, want)
    assert bool(((got.float() - want).abs() <= allowed).all())
    assert torch.equal(port_fn(ta, tb, **port_kw), got)
    xla = torch.from_numpy(np.array(mod.matmul_xla(ja, jb).astype(jnp.float32)))
    close(got.float(), xla, atol=float(allowed.max()))


def test_jax_probe_import_leaves_cache_and_env(jax_probe):
    _, before = jax_probe
    assert (jax.config.jax_compilation_cache_dir, os.environ.get(CACHE_ENV)) == before


@pytest.mark.parametrize('call', ['fullk_128x128', 'fullk_128x256', 'ksplit_128x128_k2',
                                  'ksplit_128x256_k4'])
def test_cpu_wrappers_take_the_plain_version_and_launch_nothing(call):
    ta, tb, _, _ = operands(256, 256, 512, seed=3)
    kind, tile, *rest = call.split('_')
    bm, bn = (int(x) for x in tile.split('x'))
    kw = dict(bm=bm, bn=bn, **({'splits': int(rest[0][1:])} if rest else {}))
    counts = (gemm.FULLK_COUNTER.count, gemm.KSPLIT_COUNTER.count)
    got = getattr(gemm, f'matmul_{kind}')(ta, tb, **kw)
    assert (gemm.FULLK_COUNTER.count, gemm.KSPLIT_COUNTER.count) == counts
    assert torch.equal(got, gemm.matmul_plain(ta, tb))


REFUSALS = {
    # name: (m, k, n, dtype, call keywords, error)
    'float32_operands': (128, 64, 128, torch.float32, {}, TypeError),
    'm_not_a_tile_multiple': (200, 64, 128, torch.bfloat16, {}, ValueError),
    'n_not_a_tile_multiple': (128, 64, 128, torch.bfloat16, dict(bn=256), ValueError),
    'k_not_a_stage_multiple': (128, 48, 128, torch.bfloat16, {}, ValueError),
    'k_not_split_evenly': (128, 96, 128, torch.bfloat16, dict(splits=2), ValueError),
    'tile_not_built': (128, 64, 128, torch.bfloat16, dict(bm=64), ValueError),
    'no_splits': (128, 64, 128, torch.bfloat16, dict(splits=0), ValueError),
    'more_splits_than_a_cluster': (128, 32 * 9, 128, torch.bfloat16, dict(splits=9),
                                   ValueError),
}


@pytest.mark.parametrize('case', sorted(REFUSALS))
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    m, k, n, dt, kw, err = REFUSALS[case]
    a, b = torch.ones(m, k, dtype=dt), torch.ones(k, n, dtype=dt)
    fn = gemm.matmul_ksplit if 'splits' in kw else gemm.matmul_fullk
    with pytest.raises(err):
        fn(a, b, **kw)


def test_wrappers_refuse_mismatched_and_strided_operands():
    a, b = torch.ones(128, 64, dtype=torch.bfloat16), torch.ones(96, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='M, K'):
        gemm.matmul_fullk(a, b)
    b = torch.ones(128, 64, dtype=torch.bfloat16).t()
    with pytest.raises(ValueError, match='contiguous'):
        gemm.matmul_ksplit(a, b)


def test_probe_cpu_mode_prints_well_formed_lines():
    out = io.StringIO()
    with redirect_stdout(out):
        assert gemm_roofline.main(['--device', 'cpu']) == 0
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    assert [r['arm'] for r in lines] == list(gemm_roofline.ARMS)
    for r in lines:
        assert r['device'] == 'cpu' and r['shape'] == 'cpu_small'
        assert 'ms' not in r and 'tflops' not in r          # a CPU run times nothing
        assert 0.0 <= r['max_abs_err'] < 1.0


def test_probe_shapes_are_the_jax_probes():
    src = (ROOT / 'probes' / '_gemm_pallas_roofline.py').read_text()
    for name, m, k, n in gemm_roofline.SHAPES:
        assert f"('{name}', {m}, {k}, {n})" in src


def test_probe_refuses_to_time_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA card'):
        gemm_roofline.run(device='cuda')
