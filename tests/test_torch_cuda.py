"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where there is no CUDA card, because the
kernels build with ``nvcc`` and run only there.  On a machine with one:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest sets up JAX, which these tests do not
use.)  ``chip_smoke.py`` holds the kernels at the main path's shapes; these
cover the rest of what the wrappers accept: every head dim, ragged and fully
masked rows, the bidirectional mask, both backward routes on both sides of
``FUSED_BWD_MAX_SEQ``, more rows than one projection block holds, the last
cache slot, a bfloat16 cache under a float32 model, and the wrappers'
refusals.
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


BWD_CASES = {
    # (b, h, s, tokens_total, meta [tokens_valid, kv_end], causal); s rounded up
    # to 128 decides the route: <= 768 the fused kernel, past it dq then dkv.
    'ragged_causal': (2, 2, 100, 30, [[30, 100], [12, 77]], True),
    'bidirectional': (2, 2, 130, 40, [[40, 130], [25, 90]], False),
    'no_tokens': (1, 2, 70, 20, [[0, 70]], True),
    'fused_edge_768': (1, 2, 768, 128, [[100, 700]], True),
    'split_causal_900': (2, 1, 900, 256, [[256, 900], [131, 555]], True),
    'split_bidirectional_777': (1, 2, 777, 128, [[90, 700]], False),
}


def bwd_inputs(dev, case, hd, dtype):
    b, h, s, tt, meta, causal = BWD_CASES[case]
    gen = torch.Generator().manual_seed(hd + s)
    q, k, v, do = (torch.randn(b, h, s, hd, generator=gen).to(dev, dtype) for _ in range(4))
    meta = torch.tensor(meta, dtype=torch.int32, device=dev)
    o, lse = fa.flash_attention(q, k, v, meta, tt, causal)
    return (q, k, v, meta, o, lse, do), tt, causal


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('hd', [32, 64, 128])
@pytest.mark.parametrize('case', sorted(BWD_CASES))
def test_flash_bwd_kernels_match_plain(dev, case, hd, dtype):
    """Both backward routes (fused #3; dq #4 + dkv #5) against the plain
    backward, and the router picks the JAX package's route for s.  The fused
    kernel's dq sums through atomics in a varying order; f32 sums in another
    order: the f32 tolerance covers both."""
    args, tt, causal = bwd_inputs(dev, case, hd, dtype)
    want = fa.flash_attention_bwd_plain(*args, tt, causal)
    counts = [c.count for c in (fa.BWD_FUSED_COUNTER, fa.BWD_DQ_COUNTER, fa.BWD_DKV_COUNTER)]
    routed = fa.flash_attention_bwd(*args, tt, causal)
    fused = fa.uses_fused_bwd(args[0].shape[2])
    assert fused == (case in ('ragged_causal', 'bidirectional', 'no_tokens', 'fused_edge_768'))
    assert [c.count for c in (fa.BWD_FUSED_COUNTER, fa.BWD_DQ_COUNTER,
                              fa.BWD_DKV_COUNTER)] == [counts[0] + fused,
                                                      counts[1] + (not fused),
                                                      counts[2] + (not fused)]
    one_pass = fa.flash_bwd_fused(*args, tt, causal)
    split = (fa.flash_bwd_dq(*args, tt, causal), *fa.flash_bwd_dkv(*args, tt, causal))
    for got in (routed, one_pass, split):
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == w.shape
            assert_close(g, w, dtype)


def test_flash_bwd_fully_masked_rows_get_zero_grad(dev):
    """tokens_valid = 0: token rows see no key, so their dq is exactly 0 and
    they add nothing to dk, dv (the Pallas kernels' rule)."""
    args, tt, causal = bwd_inputs(dev, 'no_tokens', 32, torch.float32)
    for dq in (fa.flash_bwd_fused(*args, tt, causal)[0], fa.flash_bwd_dq(*args, tt, causal)):
        torch.cuda.synchronize()
        assert float(dq[:, :, :tt].abs().max()) == 0.0


def test_flash_function_grads_match_plain_route(dev):
    """FlashAttention.apply on the card: grads through the kernels == grads
    through the plain backward of the same forward."""
    args, tt, causal = bwd_inputs(dev, 'ragged_causal', 64, torch.float32)
    with torch.inference_mode(False), torch.enable_grad():
        q, k, v, meta, do = (a.clone() for a in (*args[:4], args[6]))
        q, k, v = (a.requires_grad_() for a in (q, k, v))
        o = fa.FlashAttention.apply(q, k, v, meta, tt, causal)
        o.backward(do)
    o_ref, lse_ref = fa.flash_attention_plain(q.detach(), k.detach(), v.detach(), meta, tt,
                                              causal)
    want = fa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), meta, o_ref,
                                        lse_ref, do, tt, causal)
    for g, w in zip((q.grad, k.grad, v.grad), want):
        assert_close(g, w, torch.float32)


@pytest.mark.parametrize('frames', [96, 1024], ids=['fused_s128', 'split_s1280'])
def test_full_width_ar_step_matches_plain_route(dev, frames):
    """One full-width AR train step (f32, TF32 off) through the kernels: its
    loss and every grad equal those of the plain bias route, and the step
    launches the forward and the backward route for its s."""
    import dataclasses

    from valle2_tpu_torch.models import ar as ar_mod
    from valle2_tpu_torch.train import init_state, make_train_step, tree_leaves
    cfg = ConfigValle(dropout=0.0, matmul_precision='highest', use_flash_attention=True)
    plain = dataclasses.replace(cfg, use_flash_attention=False)
    rs = np.random.RandomState(frames)
    tt = frames // 4
    batch = {'tokens': rs.randint(0, 256, (2, tt)), 'tokens_lens': np.asarray([tt, tt - 5]),
             'codes': rs.randint(0, 1026, (2, frames)),
             'codes_lens': np.asarray([frames, frames - 17]),
             'target': rs.randint(0, 1025, (2, frames))}
    with torch.inference_mode(False):
        batch = {k: torch.tensor(v, dtype=torch.int32, device=dev) for k, v in batch.items()}
        state = init_state(cfg, 'ValleAR', device=dev)
        leaves = tree_leaves(state.params)
        got = {}
        for name, c in (('kernels', cfg), ('plain', plain)):
            with precision_scope(c):
                loss, _ = ar_mod.loss_fn(state.params, c, batch)
                got[name] = (loss.detach(), torch.autograd.grad(loss, leaves))
        (lk, gk), (lp, gp) = got['kernels'], got['plain']
        torch.testing.assert_close(lk, lp, rtol=1e-5, atol=0)
        for a, w in zip(gk, gp):   # per leaf, relative to its largest |grad|
            assert float((a - w).abs().max()) <= 1e-4 * float(w.abs().max())
        counters = (fa.COUNTER, fa.BWD_FUSED_COUNTER, fa.BWD_DQ_COUNTER, fa.BWD_DKV_COUNTER)
        before = [c.count for c in counters]
        state, metrics = make_train_step(cfg, 'ValleAR')(state, batch, 0)
        torch.cuda.synchronize()
    fused = fa.uses_fused_bwd(tt + frames)
    assert [c.count - n for c, n in zip(counters, before)] == [
        cfg.num_layers, cfg.num_layers * fused, cfg.num_layers * (not fused),
        cfg.num_layers * (not fused)]
    torch.testing.assert_close(metrics['loss'], lk, rtol=1e-5, atol=0)
    assert state.opt_state.count == 1


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
    o, lse = fa.flash_attention(q, q, q, meta, 4)
    for wrapper in (fa.flash_bwd_fused, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        with pytest.raises(TypeError, match='float32 or bfloat16'):
            h = q.half()
            wrapper(h, h, h, meta, o.half(), lse, h, 4)
        with pytest.raises(ValueError, match='head dims'):
            w = torch.randn(1, 2, 16, 48, device=dev)
            wrapper(w, w, w, meta, w, lse, w, 4)
        with pytest.raises(ValueError, match='lse'):
            wrapper(q, q, q, meta, o, lse.double(), q, 4)
        with pytest.raises(ValueError, match='match in shape'):
            wrapper(q, q, q, meta, o, lse, q[:, :, :8].contiguous(), 4)
        with pytest.raises(ValueError, match='contiguous'):
            t = q.transpose(2, 3).contiguous().transpose(2, 3)
            wrapper(q, q, q, meta, o, lse, t, 4)
        with pytest.raises(ValueError, match='meta'):
            wrapper(q, q, q, meta.long(), o, lse, q, 4)
    p, x, ck, cv, (tl, cl), ttm, pm = fused_inputs(dev, torch.bfloat16, torch.float32, 32, 3)
    with pytest.raises(TypeError, match='bfloat16 cache'):
        fd.fused_decode_step(p, x, 2, KVCache(ck, cv), ttm + pm, tl, cl, ttm, pm)
    with pytest.raises(ValueError, match='outside'):
        fd.fused_decode_step(p, x, 2, KVCache(ck.bfloat16(), cv.bfloat16()), ttm + pm - 1,
                             tl, cl, ttm, pm)
