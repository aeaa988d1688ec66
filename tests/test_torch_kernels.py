"""The port's kernel modules, held against the JAX Pallas kernels (interpret
mode on the CPU, as tests/test_kernels.py runs them): the flash forward, the
flash backward on both JAX routes, and the fused decode step.  On the CPU
each wrapper takes its plain PyTorch version, so these tests pin down what
the CUDA kernels must compute; chip_smoke.py holds the kernels against the
plain versions on the card.  float32, tolerances as in tests/test_kernels.py;
the backward also in bfloat16 (``BF16_VJP_TOL``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import close, to_torch
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu.kernels.flash_attention import _flash_fwd, flash_attention, reference_attention
from valle2_tpu.kernels.fused_decode import fused_cache_layout as j_fused_cache_layout
from valle2_tpu.kernels.fused_decode import fused_decode_step as _j_fused_decode_step
from valle2_tpu.ops.transformer import KVCache as JKVCache
from valle2_tpu.ops.transformer import transformer_init
from valle2_tpu_torch.kernels import flash_attention as tflash
from valle2_tpu_torch.kernels import fused_decode as tfused
from valle2_tpu_torch.ops.transformer import KVCache

# The Pallas kernels (interpret mode) as one compiled program each: op-by-op
# dispatch compiles every op of the interpreted kernel.
j_flash_fwd = jax.jit(_flash_fwd, static_argnums=(4, 5, 6, 7))
j_fused_decode_step = jax.jit(_j_fused_decode_step, static_argnums=(2, 7, 8))
j_reference_attention = jax.jit(reference_attention, static_argnums=(4, 5))


def qkv(seed, b, h, s, hd):
    rs = np.random.RandomState(seed)
    return tuple(rs.standard_normal((b, h, s, hd)).astype(np.float32) for _ in range(3))


FLASH_CASES = {
    # (b, h, s, hd, tokens_total, meta, causal)
    'unpadded_causal': (2, 2, 160, 32, 48, [[48, 160], [48, 160]], True),
    'unpadded_bidirectional': (2, 2, 160, 32, 48, [[48, 160], [48, 160]], False),
    'padded_rows': (2, 2, 192, 32, 64, [[40, 150], [64, 192]], True),
    'non_multiple_s': (1, 2, 100, 32, 30, [[30, 100]], True),
    'slice_like': (3, 2, 97, 16, 32, [[20, 97], [32, 70], [7, 50]], True),
}


@pytest.mark.parametrize('case', sorted(FLASH_CASES))
def test_flash_plain_matches_pallas_kernel(case):
    """o and lse of the plain version == the Pallas forward (interpret mode);
    compared on the query rows the model consumes (q < kv_end)."""
    b, h, s, hd, tt, meta, causal = FLASH_CASES[case]
    q, k, v = qkv(sorted(FLASH_CASES).index(case), b, h, s, hd)
    meta = np.asarray(meta, np.int32)
    o_j, lse_j = j_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(meta), tt, causal, 64, 64)
    o_t, lse_t = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v), torch.from_numpy(meta), tt,
                                        causal)
    assert o_t.shape == (b, h, s, hd) and lse_t.shape == (b, h, s)
    o_j, lse_j = np.asarray(o_j), np.asarray(lse_j)
    for i, (_, kv_end) in enumerate(meta):
        close(o_t[i, :, :kv_end], o_j[i, :, :kv_end], atol=2e-5)
        close(lse_t[i, :, :kv_end], lse_j[i, :, :kv_end], atol=2e-5)
    want = j_reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(meta), tt, causal)
    close(o_t, want, atol=2e-5)


def test_flash_fully_masked_rows_are_uniform_not_nan():
    """tokens_valid = 0: token-block query rows see no key; the finite
    sentinel makes them the uniform average, like the JAX reference."""
    q, k, v = qkv(5, 1, 1, 12, 16)
    meta = np.asarray([[0, 12]], np.int32)
    o, lse = tflash.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                    torch.from_numpy(meta), 4, True)
    assert torch.isfinite(o).all()
    close(o[0, 0, :4], np.broadcast_to(v[0, 0].mean(0), (4, 16)), atol=1e-5)
    want = j_reference_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                 jnp.asarray(meta), 4, True)
    close(o, want, atol=1e-5)


# JAX backward routes: default (whole-row) blocks run the fused #3 kernel at
# these s; explicit 64-blocks run #4 (dq) then #5 (dk, dv).
BWD_ROUTES = {'fused': (None, None), 'split': (64, 64)}
# The edge shapes of the card tests' backward cases (tests/test_torch_cuda.py
# BWD_CASES: one row; a partial micro-tile; one key past a 64-key tile,
# ragged; a causal lower bound inside a q tile, past the fused bound), at hd
# 32: the plain backward that the CUDA kernels are held to there is held to
# JAX at the same shapes.
BWD_EDGE_CASES = {
    's1': (1, 2, 1, 32, 1, [[1, 1]], True),
    's17': (2, 2, 17, 32, 5, [[5, 17], [3, 12]], True),
    'ragged_65': (2, 2, 65, 32, 20, [[20, 65], [7, 64]], False),
    'split_causal_mid_833': (2, 2, 833, 32, 200, [[150, 833], [77, 601]], True),
}
BWD_CASES = {**FLASH_CASES, **BWD_EDGE_CASES}


def case_seed(case: str) -> int:
    if case in FLASH_CASES:
        return sorted(FLASH_CASES).index(case)
    return 100 + sorted(BWD_EDGE_CASES).index(case)


@functools.lru_cache(maxsize=None)
def jax_flash_vjp(case, route, dtype='float32'):
    """(inputs, dO, (dq, dk, dv)) of jax.vjp of the JAX flash_attention
    (Pallas interpret mode) on the case's inputs, cast to ``dtype`` first;
    inputs and grads come back as float32 numpy arrays."""
    b, h, s, hd, tt, meta, causal = BWD_CASES[case]
    q, k, v = qkv(case_seed(case), b, h, s, hd)
    do = np.random.RandomState(50 + case_seed(case)).standard_normal(
        (b, h, s, hd)).astype(np.float32)
    meta = np.asarray(meta, np.int32)
    bq, bk = BWD_ROUTES[route]
    jq, jk, jv, jdo = (jnp.asarray(a).astype(dtype) for a in (q, k, v, do))
    _, vjp = jax.vjp(lambda q_, k_, v_: flash_attention(q_, k_, v_, jnp.asarray(meta), tt,
                                                          causal, block_q=bq, block_k=bk),
                     jq, jk, jv)
    grads = tuple(np.asarray(g.astype(jnp.float32)) for g in vjp(jdo))
    return (q, k, v, meta), do, grads


@pytest.mark.parametrize('route', sorted(BWD_ROUTES))
@pytest.mark.parametrize('case', sorted(FLASH_CASES) + sorted(BWD_EDGE_CASES))
def test_flash_bwd_plain_matches_jax_vjp(case, route):
    """flash_attention_bwd_plain on the plain forward's (o, lse) == jax.vjp of
    the Pallas kernels, on both JAX routes (fused #3; dq #4 + dkv #5)."""
    (q, k, v, meta), do, want = jax_flash_vjp(case, route)
    _, _, _, _, tt, _, causal = BWD_CASES[case]
    t = [torch.from_numpy(a) for a in (q, k, v, meta, do)]
    o, lse = tflash.flash_attention_plain(*t[:4], tt, causal)
    counts = [c.count for c in (tflash.BWD_FUSED_COUNTER, tflash.BWD_DQ_COUNTER,
                                tflash.BWD_DKV_COUNTER)]
    got = tflash.flash_attention_bwd(*t[:4], o, lse, t[4], tt, causal)
    assert [c.count for c in (tflash.BWD_FUSED_COUNTER, tflash.BWD_DQ_COUNTER,
                              tflash.BWD_DKV_COUNTER)] == counts   # CPU: no kernel launch
    for g, w in zip(got, want):
        close(g, w, atol=2e-5)


# bf16: each side computes its forward (o, lse) and then its backward with p
# and ds rounded to bf16 at the Pallas points, and rounds each grad to bf16.
# The two forwards round p in other orders (the Pallas forward per kv block
# against the running max; the plain one after the whole-row softmax), so o,
# and with it delta = rowsum(dO∘o), part by about one bf16 ulp; that moves
# some p and ds across a bf16 rounding boundary.  Allowed: 4 bf16 ulps
# (2^-6) of the grad's largest element -- one for each side's final
# rounding, two for the flips of o, p and ds -- plus 2^-7 of the element.
BF16_VJP_TOL = dict(atol=2.0 ** -6, rtol=2.0 ** -7)


@pytest.mark.parametrize('route', sorted(BWD_ROUTES))
@pytest.mark.parametrize('case', sorted(FLASH_CASES))
def test_flash_bwd_plain_matches_jax_vjp_bf16(case, route):
    """The plain backward in bf16 (the version the tensor-core kernels are
    held to on the card) == jax.vjp of the Pallas kernels in bf16, on both
    JAX routes, within BF16_VJP_TOL."""
    (q, k, v, meta), do, want = jax_flash_vjp(case, route, 'bfloat16')
    _, _, _, _, tt, _, causal = FLASH_CASES[case]
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do))
    tmeta = torch.from_numpy(meta)
    o, lse = tflash.flash_attention_plain(tq, tk, tv, tmeta, tt, causal)
    got = tflash.flash_attention_bwd(tq, tk, tv, tmeta, o, lse, tdo, tt, causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        scale = float(np.abs(w).max())
        close(g.float(), w, atol=BF16_VJP_TOL['atol'] * scale, rtol=BF16_VJP_TOL['rtol'])


@pytest.mark.parametrize('case', sorted(FLASH_CASES))
def test_flash_function_grads_match_jax_vjp(case):
    """The FlashAttention autograd Function on the CPU: grads of q, k, v ==
    jax.vjp of the JAX flash_attention (default route)."""
    (q, k, v, meta), do, want = jax_flash_vjp(case, 'fused')
    _, _, _, _, tt, _, causal = FLASH_CASES[case]
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = tflash.FlashAttention.apply(q, k, v, torch.from_numpy(meta), tt, causal)
    o.backward(torch.from_numpy(do))
    for g, w in zip((q.grad, k.grad, v.grad), want):
        close(g, w, atol=2e-5)


def test_flash_bwd_plain_zero_grad_for_rows_that_see_nothing():
    """tokens_valid = 0: token rows see no key, so dq is 0 there (the Pallas
    kernels force p to 0 where the mask is false)."""
    q, k, v = (torch.from_numpy(a) for a in qkv(5, 1, 1, 12, 16))
    meta = torch.tensor([[0, 12]], dtype=torch.int32)
    o, lse = tflash.flash_attention_plain(q, k, v, meta, 4, True)
    dq, dk, dv = tflash.flash_attention_bwd_plain(q, k, v, meta, o, lse, torch.ones_like(o),
                                                  4, True)
    assert float(dq[0, 0, :4].abs().max()) == 0.0
    assert float(dq[0, 0, 4:].abs().max()) > 0.0


def test_bwd_route_follows_the_jax_bound():
    assert tflash.FUSED_BWD_MAX_SEQ == 768
    assert tflash.uses_fused_bwd(640) and tflash.uses_fused_bwd(768)
    assert not tflash.uses_fused_bwd(769) and not tflash.uses_fused_bwd(1280)


def fused_setup(L=2, rows=3, h=2, hd=16, dff=64, S=40):
    d = h * hd
    p = transformer_init(jax.random.key(0), L, d, h, dff, adaptive_norm=False)
    rs = np.random.RandomState(1)
    ck, cv = (rs.standard_normal((L, rows, h, S, hd)).astype(np.float32) for _ in range(2))
    x = rs.standard_normal((rows, 1, d)).astype(np.float32)
    return p, ck, cv, x


@pytest.mark.parametrize('step', [0, 5])
def test_fused_step_plain_matches_pallas_kernel(step):
    """y and the updated cache of the plain version == the Pallas fused step
    (interpret mode) at the geometry of tests/test_kernels.py."""
    h, ttm, pm = 2, 6, 8
    p, ck, cv, x = fused_setup(h=h)
    tl = np.asarray([6, 4, 5], np.int32)
    plen = np.asarray([8, 6, 3], np.int32)
    index = ttm + pm + step
    jcache = j_fused_cache_layout(JKVCache(jnp.asarray(ck), jnp.asarray(cv)))
    y_j, c_j = j_fused_decode_step(p, jnp.asarray(x), h, jcache, jnp.int32(index),
                                   jnp.asarray(tl), jnp.asarray(plen), ttm, pm)
    tcache = tfused.fused_cache_layout(KVCache(torch.from_numpy(ck), torch.from_numpy(cv)))
    close(tcache.k, jcache.k, atol=0)
    before = tfused.COUNTER.count
    y_t, c_t = tfused.fused_decode_step(to_torch(p), torch.from_numpy(x), h, tcache, index,
                                        torch.from_numpy(tl), torch.from_numpy(plen),
                                        ttm, pm)
    assert tfused.COUNTER.count == before          # CPU tensors: no kernel launch
    assert c_t.k is tcache.k                       # updated in place
    close(y_t, y_j, atol=1e-4, rtol=1e-4)
    close(c_t.k, c_j.k, atol=1e-5)
    close(c_t.v, c_j.v, atol=1e-5)


def test_per_head_view_inverts_the_fused_layout():
    _, ck, cv, _ = fused_setup()
    fused = tfused.fused_cache_layout(KVCache(torch.from_numpy(ck), torch.from_numpy(cv)))
    view = tfused.per_head_view(fused, 2)
    close(view.k, ck, atol=0)
    view.v[1, 2, 1, 7] = 0.0                       # a view: writes reach the layout
    assert float(fused.v[1, 2, 7, 16:].abs().sum()) == 0.0
