"""Fused AR decode step: the CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``valle2_tpu/kernels/fused_decode.py``
(``fused_decode_step`` → ``_kernel``), base variant: dense weights, a float32 or
bfloat16 cache, one scalar write index, no tensor parallelism.  The kernels are
``csrc/fused_decode.cu`` (see its header for the design); the wrapper launches
all of one step's kernels with one host call.

Both versions take the cache in the fused head-major layout (L, rows, S, d)
(``fused_cache_layout``) and update it IN PLACE: slot ``index`` of every layer
receives the new token's k/v (the JAX version returns new k/v for the caller to
write; the resulting cache is the same).  The plain version is
``ops.transformer.transformer_decode_step`` over the per-head view of that
cache, with the three-range slot mask of ``ar.py:612-615, 647``.  The wrapper
takes the plain version only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..ops.transformer import KVCache, transformer_decode_step
from . import _build

COUNTER = _build.LaunchCounter()
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_MAX_K = 3072          # widest projection input the kernel's shared-memory tile holds


def fused_cache_layout(cache: KVCache) -> KVCache:
    """Standard cache (L, rows, h, S, hd) → head-major (L, rows, S, h*hd)."""
    def to_rows(a):
        L, r, h, S, hd = a.shape
        return a.permute(0, 1, 3, 2, 4).reshape(L, r, S, h * hd).contiguous()
    return KVCache(to_rows(cache.k), to_rows(cache.v))


def per_head_view(cache: KVCache, n_heads: int) -> KVCache:
    """The inverse of ``fused_cache_layout`` as a VIEW: (L, rows, h, S, hd)
    tensors sharing the fused cache's storage."""
    def view(a):
        L, r, S, d = a.shape
        return a.view(L, r, S, n_heads, d // n_heads).permute(0, 1, 3, 2, 4)
    return KVCache(view(cache.k), view(cache.v))


def slot_mask(S: int, index: int, tokens_lens, codes_lens, ttm: int, pm: int):
    """(rows, S) bool: the slots a decode token attends (``ar.py:612-615, 647``)."""
    slots = torch.arange(S, device=tokens_lens.device)[None, :]
    return ((slots < tokens_lens[:, None])
            | ((slots >= ttm) & (slots < ttm + codes_lens[:, None]))
            | ((slots >= ttm + pm) & (slots <= index)))


def fused_decode_step_plain(p, x, n_heads: int, cache: KVCache, index: int,
                            tokens_lens, codes_lens, ttm: int, pm: int):
    attend = slot_mask(cache.k.shape[2], index, tokens_lens, codes_lens, ttm, pm)
    y, _ = transformer_decode_step(p, x, n_heads, per_head_view(cache, n_heads), index,
                                   attend_mask=attend)
    return y, cache


def _lib():
    fn = _build.load('fused_decode').valle2_fused_decode_step
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, ci] + [vp] * 21 + [ci] * 9 + [ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return fn


def _weights(p, dtype, L: int, d: int, dff: int) -> list:
    """The stacked weights in the launcher's order, checked for the kernel."""
    want = [(p['norm1']['scale'], (L, d)), (p['norm1']['bias'], (L, d)),
            (p['attn']['qkv']['w'], (L, d, 3 * d)), (p['attn']['out']['w'], (L, d, d)),
            (p['attn']['out']['b'], (L, d)), (p['norm2']['scale'], (L, d)),
            (p['norm2']['bias'], (L, d)), (p['ffn']['lin1']['w'], (L, d, dff)),
            (p['ffn']['lin1']['b'], (L, dff)), (p['ffn']['lin2']['w'], (L, dff, d)),
            (p['ffn']['lin2']['b'], (L, d))]
    for w, shape in want:
        if w.shape != shape or w.dtype != dtype or not w.is_contiguous() \
                or w.device.type != 'cuda':
            raise ValueError('fused_decode_step kernel needs contiguous CUDA weights of '
                             f'the stacked layout in the compute dtype {dtype}; got '
                             f'{tuple(w.shape)} {w.dtype} for {shape}')
    return [w for w, _ in want]


def fused_decode_step(p, x, n_heads: int, cache: KVCache, index: int, tokens_lens,
                      codes_lens, ttm: int, pm: int):
    """One token through the whole stack.  p: stacked layer dict (L, ...);
    x: (rows, 1, d) token embeddings; cache: fused (L, rows, S, d) k/v;
    index: the write slot, ttm + pm <= index < S; tokens_lens / codes_lens:
    (rows,) int32 true lengths, tokens_lens <= ttm and codes_lens <= pm.
    Returns (y (rows, 1, d), cache) with the cache updated in place."""
    if x.device.type == 'cpu':
        return fused_decode_step_plain(p, x, n_heads, cache, index, tokens_lens,
                                       codes_lens, ttm, pm)
    if x.device.type != 'cuda':
        raise ValueError(f'fused_decode_step runs on CPU or CUDA tensors, got {x.device}')
    L, rows, S, d = cache.k.shape
    dff = p['ffn']['lin1']['w'].shape[-1]
    hd = d // n_heads
    if x.shape != (rows, 1, d) or x.dtype not in _DTYPE_CODE or not x.is_contiguous():
        raise ValueError(f'x must be a contiguous ({rows}, 1, {d}) float32/bfloat16 tensor')
    if cache.v.shape != cache.k.shape or cache.k.dtype not in _DTYPE_CODE \
            or cache.v.dtype != cache.k.dtype \
            or not (cache.k.is_contiguous() and cache.v.is_contiguous()):
        raise ValueError('cache k/v must be contiguous (L, rows, S, d) float32/bfloat16')
    if x.dtype == torch.bfloat16 and cache.k.dtype == torch.float32:
        raise TypeError('fused_decode_step kernel: a bfloat16 model needs a bfloat16 cache')
    if d % n_heads or hd not in _HEAD_DIMS:
        raise ValueError(f'fused_decode_step kernel takes head dims {_HEAD_DIMS}, got '
                         f'd={d}, n_heads={n_heads}')
    if max(d, dff) > _MAX_K:
        raise ValueError(f'fused_decode_step kernel takes widths up to {_MAX_K}')
    if not ttm + pm <= index < S:
        raise ValueError(f'index {index} outside [ttm + pm, S) = [{ttm + pm}, {S})')
    for t in (tokens_lens, codes_lens):
        if t.shape != (rows,) or t.dtype != torch.int32 or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError('tokens_lens / codes_lens must be contiguous (rows,) int32 '
                             'tensors on the device of x')
    ws = _weights(p, x.dtype, L, d, dff)
    y = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    qbuf, abuf, xmid = (torch.empty((rows, d), **f32) for _ in range(3))
    hmid = torch.empty((rows, dff), **f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _lib()(
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[cache.k.dtype], x.data_ptr(), y.data_ptr(),
        *(w.data_ptr() for w in ws), cache.k.data_ptr(), cache.v.data_ptr(),
        tokens_lens.data_ptr(), codes_lens.data_ptr(), qbuf.data_ptr(), abuf.data_ptr(),
        xmid.data_ptr(), hmid.data_ptr(), L, rows, S, d, n_heads, dff, int(index),
        int(ttm), int(pm), 1.0 / math.sqrt(hd), stream)
    _build.check(status, 'fused_decode_step')
    COUNTER.count += 1
    return y[:, None, :], cache
