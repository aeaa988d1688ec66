"""Fused AR decode step: the CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``valle2_tpu/kernels/fused_decode.py``
(``fused_decode_step`` → ``_kernel``) with one scalar write index and no
tensor parallelism, in every weight and cache format the serving path uses:
dense weights (#6), int8 W8A8 and int4 W4A16 weights (the ``'q'`` / ``'q4'``
layouts of ``quantize.py``), and a float32, bfloat16 or int8 cache (#6a).
The kernels are ``csrc/fused_decode.cu`` (see its header for the design); the
wrapper launches all of one step's kernels with one host call.

Both versions take the cache in the fused head-major layout (L, rows, S, d)
(``fused_cache_layout``), an int8 cache with its per-(slot, head) bfloat16
scales (L, rows, S, h), and update it IN PLACE: slot ``index`` of every layer
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

# Launch counts per variant: weight format, then '_kv8' for an int8 cache.
VARIANTS = ('dense', 'w8a8', 'w4a16', 'kv8', 'w8a8_kv8', 'w4a16_kv8')
COUNTERS = {v: _build.LaunchCounter() for v in VARIANTS}
COUNTER = COUNTERS['dense']    # the base variant (#6): dense weights, float cache
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_WEIGHT_FORMATS = {'w': (0, 'dense'), 'q': (1, 'w8a8'), 'q4': (2, 'w4a16')}
_HEAD_DIMS = (32, 64, 128)
_MAX_K = {0: 3072, 1: 2048, 2: 3072}   # widest projection input the shared tile holds


def fused_cache_layout(cache: KVCache) -> KVCache:
    """Standard cache (L, rows, h, S, hd) → head-major (L, rows, S, h*hd), and
    int8 scales (L, rows, h, S, 1) → (L, rows, S, h)."""
    def to_rows(a):
        L, r, h, S, hd = a.shape
        return a.permute(0, 1, 3, 2, 4).reshape(L, r, S, h * hd).contiguous()
    if cache.k_scale is None:
        return KVCache(to_rows(cache.k), to_rows(cache.v))
    return KVCache(to_rows(cache.k), to_rows(cache.v),
                   *(s[..., 0].permute(0, 1, 3, 2).contiguous()
                     for s in (cache.k_scale, cache.v_scale)))


def per_head_view(cache: KVCache, n_heads: int) -> KVCache:
    """The inverse of ``fused_cache_layout`` as a VIEW: (L, rows, h, S, hd)
    tensors (and (L, rows, h, S, 1) scales) sharing the fused cache's storage."""
    def view(a):
        L, r, S, d = a.shape
        return a.view(L, r, S, n_heads, d // n_heads).permute(0, 1, 3, 2, 4)
    if cache.k_scale is None:
        return KVCache(view(cache.k), view(cache.v))
    return KVCache(view(cache.k), view(cache.v),
                   *(s.permute(0, 1, 3, 2)[..., None] for s in (cache.k_scale,
                                                                cache.v_scale)))


def quantize_kv_rowmajor(x: torch.Tensor, n_heads: int):
    """Per-(slot, head) symmetric int8 quantization of a head-major (..., d)
    tensor → (int8 (..., d), bfloat16 scales (..., h)): ``quantize_kv`` on
    each head's slice, float32 arithmetic whatever x's dtype."""
    *lead, d = x.shape
    xs = x.reshape(*lead, n_heads, d // n_heads).float()
    scale = xs.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8) / 127.0
    q = torch.round(xs / scale).clamp(-127, 127).to(torch.int8)
    return q.reshape(*lead, d), scale[..., 0].to(torch.bfloat16)


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


def weight_format(p) -> str:
    """'w' (dense), 'q' (int8 W8A8) or 'q4' (int4 W4A16): the layout of the
    stacked qkv projection, which every linear of the stack shares."""
    fmt = next(k for k in ('w', 'q', 'q4') if k in p['attn']['qkv'])
    for lin in (p['attn']['out'], p['ffn']['lin1'], p['ffn']['lin2']):
        if fmt not in lin:
            raise ValueError('fused_decode_step kernel: every linear of the stack must '
                             f"share the {fmt!r} layout")
    return fmt


def variant(p, cache: KVCache) -> str:
    """The name of the kernel variant that ``p`` and ``cache`` launch."""
    name = _WEIGHT_FORMATS[weight_format(p)][1]
    if cache.k_scale is None:
        return name
    return 'kv8' if name == 'dense' else f'{name}_kv8'


def _lib():
    fn = _build.load('fused_decode').valle2_fused_decode_step
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        # formats; x, y, 11 weights, cache k/v, 4 weight scales, 2 cache scales,
        # lengths, 5 scratch buffers; 11 sizes; the q scale and the stream
        fn.argtypes = [ci] * 3 + [vp] * 28 + [ci] * 11 + [ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return fn


def _check(t, shape, dtype, what: str):
    if t is None or t.shape != shape or t.dtype != dtype or not t.is_contiguous() \
            or t.device.type != 'cuda':
        got = 'None' if t is None else f'{tuple(t.shape)} {t.dtype} on {t.device}'
        raise ValueError(f'fused_decode_step kernel needs {what} as a contiguous CUDA '
                         f'{tuple(shape)} {dtype} tensor; got {got}')
    return t


def _weights(p, fmt: str, dtype, L: int, d: int, dff: int) -> tuple[list, list, list]:
    """The stacked weights in the launcher's order, checked for the kernel:
    (norms, biases and weights), (the four weight scales, or none), and the
    int4 group counts of the d-wide and dff-wide inputs."""
    def qshape(k_in, n):              # the weight tensor of a (k_in, n) linear
        return (L, k_in // 2, n) if fmt == 'q4' else (L, k_in, n)
    wdt = dtype if fmt == 'w' else torch.int8
    lins = [(p['attn']['qkv'], d, 3 * d), (p['attn']['out'], d, d),
            (p['ffn']['lin1'], d, dff), (p['ffn']['lin2'], dff, d)]
    qkv, out, lin1, lin2 = (_check(lin[fmt], qshape(k_in, n), wdt, f'the {fmt!r} weight')
                            for lin, k_in, n in lins)
    vec = [(p['norm1']['scale'], d), (p['norm1']['bias'], d), (p['attn']['out']['b'], d),
           (p['norm2']['scale'], d), (p['norm2']['bias'], d), (p['ffn']['lin1']['b'], dff),
           (p['ffn']['lin2']['b'], d)]
    n1s, n1b, bout, n2s, n2b, b1, b2 = (_check(t, (L, n), dtype, 'a norm or bias')
                                        for t, n in vec)
    ws = [n1s, n1b, qkv, out, bout, n2s, n2b, lin1, b1, lin2, b2]
    if fmt == 'w':
        return ws, [None] * 4, [1, 1]
    if fmt == 'q':
        return ws, [_check(lin['scale'], (L, n), dtype, 'a weight scale')
                    for lin, _, n in lins], [1, 1]
    groups = []
    for k_in in (d, dff):
        g = [lin['scale4'].shape[1] for lin, kk, _ in lins if kk == k_in]
        if len(set(g)) != 1 or g[0] % 2 or (k_in // 2) % (g[0] // 2):
            raise ValueError(f'fused_decode_step kernel: int4 group counts {g} of the '
                             f'{k_in}-wide inputs must agree and align with the nibble '
                             'planes (quantize.group4_for)')
        groups.append(g[0])
    scales = [_check(lin['scale4'], (L, groups[kk != d], n), dtype, 'an int4 group scale')
              for lin, kk, n in lins]
    return ws, scales, groups


def fused_decode_step(p, x, n_heads: int, cache: KVCache, index: int, tokens_lens,
                      codes_lens, ttm: int, pm: int):
    """One token through the whole stack.  p: stacked layer dict (L, ...),
    dense or in a ``quantize.py`` layout ('q' int8 or 'q4' int4 weights, their
    scales in the compute dtype); x: (rows, 1, d) token embeddings; cache:
    fused (L, rows, S, d) k/v in float32 / bfloat16, or int8 with (L, rows,
    S, h) bfloat16 scales; index: the write slot, ttm + pm <= index < S;
    tokens_lens / codes_lens: (rows,) int32 true lengths, tokens_lens <= ttm
    and codes_lens <= pm.  Returns (y (rows, 1, d), cache) with the cache
    updated in place."""
    if x.device.type == 'cpu':
        return fused_decode_step_plain(p, x, n_heads, cache, index, tokens_lens,
                                       codes_lens, ttm, pm)
    if x.device.type != 'cuda':
        raise ValueError(f'fused_decode_step runs on CPU or CUDA tensors, got {x.device}')
    L, rows, S, d = cache.k.shape
    fmt = weight_format(p)
    wcode, _ = _WEIGHT_FORMATS[fmt]
    dff = p['ffn']['lin1'][fmt].shape[-1]
    hd = d // n_heads
    if x.shape != (rows, 1, d) or x.dtype not in (torch.float32, torch.bfloat16) \
            or not x.is_contiguous():
        raise ValueError(f'x must be a contiguous ({rows}, 1, {d}) float32/bfloat16 tensor')
    quant = cache.k.dtype == torch.int8
    if cache.v.shape != cache.k.shape or cache.k.dtype not in _DTYPE_CODE \
            or cache.v.dtype != cache.k.dtype \
            or not (cache.k.is_contiguous() and cache.v.is_contiguous()):
        raise ValueError('cache k/v must be contiguous (L, rows, S, d) float32, bfloat16 '
                         'or int8 tensors of one dtype')
    if quant:
        scales = [_check(s, (L, rows, S, n_heads), torch.bfloat16, 'an int8 cache scale')
                  for s in (cache.k_scale, cache.v_scale)]
    elif cache.k_scale is not None or cache.v_scale is not None:
        raise ValueError('cache scales belong to an int8 cache only')
    else:
        scales = [None, None]
    if x.dtype == torch.bfloat16 and cache.k.dtype == torch.float32:
        raise TypeError('fused_decode_step kernel: a bfloat16 model needs a bfloat16 cache')
    if d % n_heads or hd not in _HEAD_DIMS:
        raise ValueError(f'fused_decode_step kernel takes head dims {_HEAD_DIMS}, got '
                         f'd={d}, n_heads={n_heads}')
    if max(d, dff) > _MAX_K[wcode] or (fmt != 'w' and dff % 8):
        raise ValueError(f'fused_decode_step kernel takes widths up to {_MAX_K[wcode]} '
                         f'for {fmt!r} weights (quantized: dff a multiple of 8), got '
                         f'd={d}, dff={dff}')
    if not ttm + pm <= index < S:
        raise ValueError(f'index {index} outside [ttm + pm, S) = [{ttm + pm}, {S})')
    for t in (tokens_lens, codes_lens):
        if t.shape != (rows,) or t.dtype != torch.int32 or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError('tokens_lens / codes_lens must be contiguous (rows,) int32 '
                             'tensors on the device of x')
    ws, wscales, groups = _weights(p, fmt, x.dtype, L, d, dff)
    y = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    qbuf, abuf, xmid = (torch.empty((rows, d), **f32) for _ in range(3))
    hmid = torch.empty((rows, dff), **f32)
    kvnew = torch.empty((rows, 2 * d), **f32) if quant else None

    def ptr(t):
        return None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _lib()(
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[cache.k.dtype], wcode, x.data_ptr(),
        y.data_ptr(), *(w.data_ptr() for w in ws), cache.k.data_ptr(), cache.v.data_ptr(),
        *(ptr(s) for s in wscales), *(ptr(s) for s in scales), tokens_lens.data_ptr(),
        codes_lens.data_ptr(), qbuf.data_ptr(), abuf.data_ptr(), xmid.data_ptr(),
        hmid.data_ptr(), ptr(kvnew), L, rows, S, d, n_heads, dff, int(index), int(ttm),
        int(pm), *groups, 1.0 / math.sqrt(hd), stream)
    _build.check(status, 'fused_decode_step')
    COUNTERS[variant(p, cache)].count += 1
    return y[:, None, :], cache
