"""The port's kernel modules, held against the JAX Pallas kernels (interpret
mode on the CPU, as tests/test_kernels.py runs them).  On the CPU each wrapper
takes its plain PyTorch version, so these tests pin down what the CUDA
kernels must compute; chip_smoke.py holds the kernels against the plain
versions on the card.  float32; tolerances as in tests/test_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import close, to_torch

from valle2_tpu.kernels.flash_attention import _flash_fwd, reference_attention
from valle2_tpu.kernels.fused_decode import fused_cache_layout as j_fused_cache_layout
from valle2_tpu.kernels.fused_decode import fused_decode_step as j_fused_decode_step
from valle2_tpu.ops.transformer import KVCache as JKVCache
from valle2_tpu.ops.transformer import transformer_init
from valle2_tpu_torch.kernels import flash_attention as tflash
from valle2_tpu_torch.kernels import fused_decode as tfused
from valle2_tpu_torch.ops.transformer import KVCache


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
    o_j, lse_j = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(meta), tt, causal, 64, 64)
    o_t, lse_t = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v), torch.from_numpy(meta), tt,
                                        causal)
    assert o_t.shape == (b, h, s, hd) and lse_t.shape == (b, h, s)
    o_j, lse_j = np.asarray(o_j), np.asarray(lse_j)
    for i, (_, kv_end) in enumerate(meta):
        close(o_t[i, :, :kv_end], o_j[i, :, :kv_end], atol=2e-5)
        close(lse_t[i, :, :kv_end], lse_j[i, :, :kv_end], atol=2e-5)
    want = reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
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
    want = reference_attention(*(jnp.asarray(a) for a in (q, k, v)),
                               jnp.asarray(meta), 4, True)
    close(o, want, atol=1e-5)


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
