"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where there is no CUDA card, because the
kernels build with ``nvcc`` and run only there.  On a machine with one:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest sets up JAX, which these tests do not
use.)  ``chip_smoke.py`` holds the kernels at the main path's shapes; these
cover the rest of what the wrappers accept: every head dim, ragged and fully
masked rows, the bidirectional mask, more rows than one projection block
holds, the last cache slot, a bfloat16 cache under a float32 model, and the
wrappers' refusals.
"""

import numpy as np
import pytest
import torch

from valle2_tpu_torch.config import ConfigValle, precision_scope
from valle2_tpu_torch.kernels import flash_attention as fa
from valle2_tpu_torch.kernels import fused_decode as fd
from valle2_tpu_torch.ops.transformer import KVCache, map_tree, transformer_init

pytestmark = pytest.mark.cuda

# Kernel against plain version: f32 sums in another order; in bf16 the plain
# versions round intermediates to bf16 where the kernels keep f32.
TOL = {torch.float32: dict(atol=1e-4, rtol=0.0), torch.bfloat16: dict(atol=5e-2, rtol=2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels build with nvcc and run only there')
    with precision_scope(ConfigValle(matmul_precision='highest')), torch.inference_mode():
        yield torch.device('cuda')


def assert_close(got, want, dtype):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


FLASH_CASES = {
    # (b, h, s, tokens_total, meta [tokens_valid, kv_end], causal)
    'ragged_causal': (2, 2, 100, 30, [[30, 100], [12, 77]], True),
    'bidirectional': (2, 2, 130, 40, [[40, 130], [25, 90]], False),
    'no_tokens': (1, 2, 70, 20, [[0, 70]], True),
    'slice_rows': (3, 4, 385, 128, [[112, 279], [97, 279], [81, 279]], True),
}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('hd', [32, 64, 128])
@pytest.mark.parametrize('case', sorted(FLASH_CASES))
def test_flash_kernel_matches_plain(dev, case, hd, dtype):
    b, h, s, tt, meta, causal = FLASH_CASES[case]
    gen = torch.Generator().manual_seed(hd)
    q, k, v = (torch.randn(b, h, s, hd, generator=gen).to(dev, dtype) for _ in range(3))
    meta = torch.tensor(meta, dtype=torch.int32, device=dev)
    before = fa.COUNTER.count
    o, lse = fa.flash_attention(q, k, v, meta, tt, causal)
    assert fa.COUNTER.count == before + 1
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, meta, tt, causal)
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert_close(o, o_ref, dtype)
    assert_close(lse, lse_ref, torch.float32)


def fused_inputs(dev, dtype, cache_dtype, hd, rows, L=2, h=2, ttm=24, pm=16, max_new=12):
    d = h * hd
    gen = torch.Generator().manual_seed(rows + hd)
    p = transformer_init(gen, L, d, h, 4 * d, adaptive_norm=False)
    p = map_tree(lambda a: a.to(dev, dtype).contiguous(), p)
    S = ttm + pm + max_new
    ck, cv = (torch.randn(L, rows, S, d, generator=gen).to(dev, cache_dtype)
              for _ in range(2))
    x = torch.randn(rows, 1, d, generator=gen).to(dev, dtype)
    rs = np.random.RandomState(rows)
    tl = rs.randint(0, ttm + 1, rows)
    tl[0] = 0                                   # a row with no source tokens
    cl = rs.randint(1, pm + 1, rows)
    lens = [torch.tensor(a, dtype=torch.int32, device=dev) for a in (tl, cl)]
    return p, x, ck, cv, lens, ttm, pm


@pytest.mark.parametrize('dtypes', [(torch.float32, torch.float32),
                                    (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.bfloat16)],
                         ids=['f32', 'f32_bf16cache', 'bf16'])
@pytest.mark.parametrize('hd', [32, 64, 128])
@pytest.mark.parametrize('rows', [5, 20], ids=['first_slot', 'last_slot_two_row_blocks'])
def test_fused_step_kernel_matches_plain(dev, rows, hd, dtypes):
    dtype, cache_dtype = dtypes
    p, x, ck, cv, (tl, cl), ttm, pm = fused_inputs(dev, dtype, cache_dtype, hd, rows)
    S = ck.shape[2]
    index = ttm + pm if rows == 5 else S - 1
    c_k, c_p = KVCache(ck.clone(), cv.clone()), KVCache(ck.clone(), cv.clone())
    before = fd.COUNTER.count
    y, out = fd.fused_decode_step(p, x, 2, c_k, index, tl, cl, ttm, pm)
    assert fd.COUNTER.count == before + 1 and out.k is c_k.k
    y_ref, _ = fd.fused_decode_step_plain(p, x, 2, c_p, index, tl, cl, ttm, pm)
    loose = torch.bfloat16 if torch.bfloat16 in dtypes else torch.float32
    assert_close(y, y_ref, loose)
    assert_close(c_k.k, c_p.k, loose)
    assert_close(c_k.v, c_p.v, loose)
    # Only slot `index` was written.
    untouched = torch.ones(S, dtype=torch.bool)
    untouched[index] = False
    assert torch.equal(c_k.k[:, :, untouched], ck[:, :, untouched])


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.randn(1, 2, 16, 48, device=dev)
    meta = torch.tensor([[4, 16]], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match='head dims'):
        fa.flash_attention(q, q, q, meta, 4)
    q = torch.randn(1, 2, 16, 32, device=dev)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        fa.flash_attention(q.half(), q.half(), q.half(), meta, 4)
    with pytest.raises(ValueError, match='contiguous'):
        t = q.transpose(2, 3).contiguous().transpose(2, 3)
        fa.flash_attention(t, t, t, meta, 4)
    p, x, ck, cv, (tl, cl), ttm, pm = fused_inputs(dev, torch.bfloat16, torch.float32, 32, 3)
    with pytest.raises(TypeError, match='bfloat16 cache'):
        fd.fused_decode_step(p, x, 2, KVCache(ck, cv), ttm + pm, tl, cl, ttm, pm)
    with pytest.raises(ValueError, match='outside'):
        fd.fused_decode_step(p, x, 2, KVCache(ck.bfloat16(), cv.bfloat16()), ttm + pm - 1,
                             tl, cl, ttm, pm)
