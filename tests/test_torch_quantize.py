"""The port's quantization against the JAX package: ``quantize.py`` (int8
W8A8, int4 W4A16), the int8 KV cache (``quantize_kv``, ``transformer_prefill``,
``quantize_kv_rowmajor``, the fused layout), the ``linear`` dispatch, and the
fused decode step's quantized variants: the plain version against the Pallas
kernel in interpret mode (as ``tests/test_kernels.py`` runs it) and against
``transformer_decode_step``.  Both sides compute on the same int8/int4 codes:
the JAX quantizers' outputs cross as numpy.  float32; tolerances as in
``tests/test_kernels.py`` and ``tests/test_quantize.py``.  The serving path
end to end is in ``tests/test_torch_quantize_serving.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import close
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu import quantize as jq
from valle2_tpu.kernels import fused_decode as jfd
from valle2_tpu.ops.nn import linear as j_linear
from valle2_tpu.ops.transformer import KVCache as JKVCache
from valle2_tpu.ops.transformer import quantize_kv as j_quantize_kv
from valle2_tpu.ops.transformer import transformer_decode_step as _j_decode_step
from valle2_tpu.ops.transformer import transformer_init as j_transformer_init
from valle2_tpu.ops.transformer import transformer_prefill as j_prefill
from valle2_tpu_torch import quantize as tq
from valle2_tpu_torch.kernels import fused_decode as tfd
from valle2_tpu_torch.ops.nn import linear as t_linear
from valle2_tpu_torch.ops.transformer import KVCache, quantize_kv, transformer_prefill

# JAX's decode step and the Pallas fused step (interpret mode) as one compiled
# program each (op-by-op dispatch compiles each op)
j_decode_step = jax.jit(_j_decode_step, static_argnums=2)
j_fused_step = jax.jit(jfd.fused_decode_step, static_argnums=(2, 7, 8))
j_quantize_transformer = jax.jit(jq.quantize_transformer, static_argnames='bits')
# The JAX quantizers, products and cache helpers likewise.  jit may turn
# x / 127 into a product by its reciprocal, which moves a scale by one ulp, so
# test_quantizers_equal_jax, which holds the port's scales to JAX's op-by-op
# ones bit for bit, stays op by op.
jqj = {name: jax.jit(getattr(jq, name)) for name in (
    'quantize_linear', 'quantize_linear_int4', 'unpack_int4', 'int8_matmul', 'int4_matmul')}
j_linear_jit = jax.jit(j_linear)
j_quantize_kv_jit = jax.jit(j_quantize_kv)
j_fused_cache_layout = jax.jit(jfd.fused_cache_layout)


def tt(tree):
    """JAX/numpy pytree → torch, bfloat16 leaves included."""
    if isinstance(tree, dict):
        return {k: tt(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tt(v) for v in tree)
    if tree is None:
        return None
    a = np.asarray(tree)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def npy(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def assert_codes_near(got, want, frac=1e-3):
    """int8 codes within one step, on under ``frac`` of the entries: where
    x / scale lands within rounding of a .5 boundary, float32 sums in another
    order round to the neighbour."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < frac, (diff.max(), (diff > 0).mean())


def weights(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize('shape', [(64, 32), (2, 48, 96), (2, 600, 16)])
def test_quantizers_equal_jax(shape):
    """Codes and scales of both layouts equal JAX's; so do the nibble planes
    and the dequantized weights.  (2, 600, 16): int4 groups of 100 (3 per
    plane)."""
    w = weights(shape, 0)
    b = weights(shape[:-2] + shape[-1:], 1)
    for quant, tquant, deq, tdeq in ((jq.quantize_linear, tq.quantize_linear,
                                      jq.dequantize_linear, tq.dequantize_linear),
                                     (jq.quantize_linear_int4, tq.quantize_linear_int4,
                                      jq.dequantize_linear_int4,
                                      tq.dequantize_linear_int4)):
        want = quant({'w': jnp.asarray(w), 'b': jnp.asarray(b)})
        got = tquant({'w': torch.from_numpy(w), 'b': torch.from_numpy(b)})
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == tt(want[k]).dtype, k
            np.testing.assert_array_equal(npy(got[k]), np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(tdeq(got)['w'].numpy(), np.asarray(deq(want)['w']))
    for g, p in zip(tq.unpack_int4(got['q4']), jqj['unpack_int4'](want['q4'])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))
    for n in (2, 6, 48, 64, 96, 200, 256, 600, 1024, 3072):
        assert tq.group4_for(n) == jq.group4_for(n)
    # The ranked packing of tensor-parallel int4 (each rank's input rows on
    # their own) equals JAX's, and so do its dequantized weights.
    want = jq.quantize_linear_int4_ranked({'w': jnp.asarray(w), 'b': jnp.asarray(b)}, 2)
    got = tq.quantize_linear_int4_ranked({'w': torch.from_numpy(w), 'b': torch.from_numpy(b)},
                                         2)
    for k in want:
        np.testing.assert_array_equal(npy(got[k]), np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(tq.dequantize_linear_int4_ranked(got, 2)['w'].numpy(),
                                  np.asarray(jq.dequantize_linear_int4_ranked(want, 2)['w']))
    with pytest.raises(ValueError, match='ranked packing is an int4'):
        tq.quantize_transformer({}, bits=8, tp_mp=2)


@pytest.mark.parametrize('k_in', [24, 1500])
def test_int8_matmul_equals_integer_simulation(k_in):
    """The exact integer product, against JAX and a numpy int32 simulation of
    quantize → s8 dot → rescale; K = 1500 > 1040 takes the split into exact
    float32 chunks."""
    x = weights((2, 5, k_in), 2) * 3.0
    qp = jqj['quantize_linear']({'w': jnp.asarray(weights((k_in, 16), 3))})
    q, scale = np.asarray(qp['q']), np.asarray(qp['scale'])
    got = tq.int8_matmul(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(scale))
    sx = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-8) / 127.0
    xq = np.clip(np.round(x / sx), -127, 127).astype(np.int32)
    want = (xq @ q.astype(np.int32)).astype(np.float32) * sx * scale
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(jqj['int8_matmul'](jnp.asarray(x), q,
                                                                       scale)),
                               rtol=1e-6, atol=1e-6)


def test_int4_matmul_and_linear_dispatch_match_jax():
    x = weights((3, 4, 512), 4)
    p = {'w': jnp.asarray(weights((512, 24), 5) * 0.05),
         'b': jnp.asarray(weights((24,), 6))}
    qp4 = jqj['quantize_linear_int4'](p)
    assert qp4['scale4'].shape == (4, 24)                  # four groups of 128
    close(tq.int4_matmul(torch.from_numpy(x), tt(qp4['q4']), tt(qp4['scale4'])),
          jqj['int4_matmul'](jnp.asarray(x), qp4['q4'], qp4['scale4']), atol=1e-5)
    for layout in (p, jqj['quantize_linear'](p), qp4):
        close(t_linear(tt(layout), torch.from_numpy(x)),
              j_linear_jit(layout, jnp.asarray(x)), atol=1e-5)


def test_quantize_kv_equals_jax():
    x = weights((2, 3, 7, 32), 7)
    for got, want in ((quantize_kv(torch.from_numpy(x)), j_quantize_kv_jit(jnp.asarray(x))),
                      (tfd.quantize_kv_rowmajor(torch.from_numpy(x), 2),
                       jfd.quantize_kv_rowmajor(jnp.asarray(x), 2))):
        for g, w in zip(got, want):
            assert g.dtype == tt(w).dtype
            np.testing.assert_array_equal(npy(g), np.asarray(w, np.float32)
                                          if w.dtype == jnp.bfloat16 else np.asarray(w))


def test_prefill_int8_cache_matches_jax():
    """transformer_prefill into an int8 cache: scales equal JAX's, codes
    within one step; the padded slots carry the 1e-8 floor's scale."""
    L, h, d, dff, b, s, S = 2, 2, 32, 64, 2, 9, 14
    p = j_transformer_init(jax.random.key(0), L, d, h, dff, adaptive_norm=False)
    x = weights((b, s, d), 8)
    yj, cj = j_prefill(p, jnp.asarray(x), h, S, cache_dtype=jnp.int8)
    yt, ct = transformer_prefill(tt(p), torch.from_numpy(x), h, S,
                                     cache_dtype=torch.int8)
    close(yt, yj, atol=1e-5)
    assert ct.k.dtype == torch.int8 and ct.k_scale.shape == (L, b, h, S, 1)
    for g, w in zip(ct, cj):
        if g.dtype == torch.int8:
            assert_codes_near(g.numpy(), w)
        else:
            np.testing.assert_array_equal(npy(g), np.asarray(w, np.float32))


def fused_case(variant, L=2, rows=3, h=2, hd=16, dff=512, S=40, ttm=6, pm=8):
    """JAX weights and cache of one variant (codes made by the JAX
    quantizers) and the step's inputs."""
    d = h * hd
    p = j_transformer_init(jax.random.key(0), L, d, h, dff, adaptive_norm=False)
    if variant.startswith('w8a8'):
        p = j_quantize_transformer(p, bits=8)
    elif variant.startswith('w4a16'):
        p = j_quantize_transformer(p, bits=4)
    kf, vf = weights((L, rows, h, S, hd), 9), weights((L, rows, h, S, hd), 10)
    if variant.endswith('kv8'):
        (kq, ks), (vq, vs) = (j_quantize_kv_jit(jnp.asarray(a)) for a in (kf, vf))
        cache = JKVCache(kq, vq, ks, vs)
    else:
        cache = JKVCache(jnp.asarray(kf), jnp.asarray(vf))
    x = weights((rows, 1, d), 11)
    tl, plen = np.asarray([6, 4, 5], np.int32), np.asarray([8, 6, 3], np.int32)
    return p, cache, x, tl, plen, ttm, pm, ttm + pm + 5


@pytest.mark.parametrize('variant', ['w8a8', 'w4a16', 'kv8', 'w8a8_kv8'])
def test_fused_step_plain_matches_pallas_and_xla(variant):
    """The plain fused step on a quantized layout == the Pallas fused step
    (interpret mode) and JAX transformer_decode_step: y within 1e-4 (5e-3
    with an int8 cache), cache codes within one step, no kernel launch."""
    p, cache, x, tl, plen, ttm, pm, index = fused_case(variant)
    h = 2
    yj, cj = j_fused_step(p, jnp.asarray(x), h, j_fused_cache_layout(cache),
                          jnp.int32(index), jnp.asarray(tl), jnp.asarray(plen), ttm, pm)
    slots = jnp.arange(cache.k.shape[3])[None, :]
    attend = ((slots < tl[:, None]) | ((slots >= ttm) & (slots < ttm + plen[:, None]))
              | ((slots >= ttm + pm) & (slots <= index)))
    yx, cx = j_decode_step(p, jnp.asarray(x), h, cache, jnp.int32(index),
                           attend_mask=attend)
    tcache = tfd.fused_cache_layout(KVCache(*tt(tuple(cache))))
    tp = tt(p)
    assert tfd.variant(tp, tcache) == variant
    before = {v: c.count for v, c in tfd.COUNTERS.items()}
    yt, ct = tfd.fused_decode_step(tp, torch.from_numpy(x), h, tcache, index,
                                   torch.from_numpy(tl), torch.from_numpy(plen), ttm, pm)
    assert {v: c.count for v, c in tfd.COUNTERS.items()} == before
    assert ct.k is tcache.k
    atol = 5e-3 if variant.endswith('kv8') else 1e-4
    close(yt, yj, atol=atol, rtol=atol)
    close(yt, yx, atol=atol, rtol=atol)
    for want in (cj, j_fused_cache_layout(cx)):
        for g, w in zip(ct, want):
            if g is None:
                assert w is None
            elif g.dtype == torch.int8:
                assert_codes_near(g.numpy(), w)
            elif g.dtype == torch.bfloat16:   # the new slot's scales: bf16 of f32 amax/127
                close(g.float(), np.asarray(w, np.float32), atol=0, rtol=2 ** -7)
            else:
                close(g, w, atol=1e-5)


def test_fused_layout_and_view_carry_the_scales():
    _, cache, *_ = fused_case('kv8')
    tcache = KVCache(*tt(tuple(cache)))
    fused = tfd.fused_cache_layout(tcache)
    jfused = j_fused_cache_layout(cache)
    assert fused.k_scale.shape == (2, 3, 40, 2) and fused.k_scale.is_contiguous()
    for g, w in zip(fused, jfused):
        np.testing.assert_array_equal(npy(g), np.asarray(w, np.float32)
                                      if w.dtype == jnp.bfloat16 else np.asarray(w))
    view = tfd.per_head_view(fused, 2)
    for g, w in zip(view, tcache):
        assert torch.equal(g, w)
    view.k_scale[1, 2, 1, 7] = 0.0                 # a view: writes reach the layout
    assert float(fused.k_scale[1, 2, 7, 1]) == 0.0
