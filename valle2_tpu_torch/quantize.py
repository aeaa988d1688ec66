"""Weight quantization for the decode/serving path (``valle2_tpu/quantize.py``).

Two layouts of a linear layer, with the JAX package's rounding:

- **int8 W8A8** (``weight_dtype='int8'``): per-output-channel symmetric int8
  weights, ``{'q': int8 (..., in, out), 'scale': (..., out)}``, and dynamic
  per-token int8 activations; the product is exact in integers and rescales
  by ``sx * scale`` in float32 (``int8_matmul``).
- **int4 W4A16** (``weight_dtype='int4'``): group-wise symmetric int4 weights
  in [-7, 7], two per byte, ``{'q4': int8 (..., in/2, out), 'scale4':
  (..., in/G, out)}``; byte k holds input row k in its low nibble and row
  k + in/2 in its high nibble.  Activations stay in the compute dtype
  (``int4_matmul``).

Every quantizer is ``clip(round(x / scale), ...)`` with ``torch.round``
(half to even, as ``jnp.round``) and a true division, so the codes equal the
JAX package's on the same float32 weights.  ``quantize_transformer`` applies
a layout to the four big linears of a stacked transformer (qkv, attn.out,
ffn.lin1, ffn.lin2); embeddings, norms and the logit projection stay in the
compute dtype.  ``ops.nn.linear`` dispatches on the layout, and the fused
decode kernel (``kernels/fused_decode``) takes both.
"""

from __future__ import annotations

from typing import Any

import torch

from .config import tf32_scope

Params = dict[str, Any]

GROUP4 = 128     # int4 scale-group size along the input axis
EXACT_K = 1024   # longest exact f32 dot of int8 codes: 127² · 1024 < 2²⁴


def quantize_linear(p: Params) -> Params:
    """{'w': (..., in, out), 'b'?} → {'q': int8, 'scale': f32 (..., out), 'b'?}."""
    w = p['w'].float()
    scale = w.abs().amax(dim=-2).clamp(min=1e-8) / 127.0
    q = torch.round(w / scale[..., None, :]).clamp(-127, 127).to(torch.int8)
    return _with_bias({'q': q, 'scale': scale}, p)


def dequantize_linear(p: Params, dtype=torch.float32) -> Params:
    """Inverse of ``quantize_linear`` (fake-quant float weights, for tests)."""
    w = p['q'].float() * p['scale'][..., None, :]
    return _with_bias({'w': w.to(dtype)}, p)


def _with_bias(out: Params, p: Params) -> Params:
    if 'b' in p:
        out['b'] = p['b']
    return out


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(q)`` with dynamic per-token int8 activation quantization.

    x: (..., in) float; q: (in, out) int8; scale: (out,).  Returns x.dtype.
    The integer product is exact: float32 dots of int8 codes over at most
    ``EXACT_K`` inputs (every partial sum below 2²⁴, TF32 off whatever the
    caller's scope), summed as int32."""
    x32 = x.float()
    sx = x32.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8) / 127.0
    return (int8_dot(torch.round(x32 / sx).clamp(-127, 127), q).float() * sx
            * scale).to(x.dtype)


def int8_dot(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of float-held int8 activation codes (..., in)
    and int8 weights (in, out): float32 dots over at most ``EXACT_K`` inputs
    (every partial sum below 2²⁴, TF32 off whatever the caller's scope),
    summed as int32."""
    qf = q.float()
    y = torch.zeros((*xq.shape[:-1], q.shape[-1]), dtype=torch.int32, device=xq.device)
    with tf32_scope(False):
        for k0 in range(0, q.shape[0], EXACT_K):
            y += (xq[..., k0:k0 + EXACT_K] @ qf[k0:k0 + EXACT_K]).to(torch.int32)
    return y


def group4_for(in_dim: int, group: int = GROUP4) -> int:
    """Largest usable int4 group ≤ ``group``: it must divide in_dim / 2 so
    that no scale group straddles the two nibble planes."""
    g = min(group, max(in_dim // 2, 1))
    while g > 1 and (in_dim // 2) % g:
        g //= 2
    return g


def quantize_linear_int4(p: Params, group: int = GROUP4) -> Params:
    """{'w': (..., in, out), 'b'?} → {'q4': int8 (..., in/2, out), 'scale4':
    f32 (..., in/g, out), 'b'?}: ``scale = max|w| / 7`` over each group of g
    = ``group4_for(in)`` input rows, half-split nibble packing."""
    w = p['w'].float()
    in_dim = w.shape[-2]
    if in_dim % 2:
        raise ValueError(f'int4 packing needs an even input dim, got {in_dim}')
    g = group4_for(in_dim, group)
    gshape = (*w.shape[:-2], in_dim // g, g, w.shape[-1])
    scale = w.reshape(gshape).abs().amax(dim=-2).clamp(min=1e-8) / 7.0
    qi = torch.round(w.reshape(gshape) / scale[..., None, :]).clamp(-7, 7)
    qi = qi.to(torch.int32).reshape(w.shape)
    half = in_dim // 2
    packed = (qi[..., :half, :] & 0xF) | (qi[..., half:, :] << 4)
    return _with_bias({'q4': packed.to(torch.int8), 'scale4': scale}, p)


def unpack_int4(q4: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed (..., in/2, out) int8 → (lo, hi) int32 nibble planes in [-8, 7]:
    lo = input rows [0, in/2), hi = [in/2, in)."""
    p32 = q4.to(torch.int32)
    lo = ((p32 & 0xF) ^ 8) - 8                # the low nibble, sign-extended
    hi = p32 >> 4                             # arithmetic shift
    return lo, hi


def dequantize_linear_int4(p: Params, dtype=torch.float32) -> Params:
    """Inverse of ``quantize_linear_int4`` (fake-quant floats, for tests)."""
    lo, hi = unpack_int4(p['q4'])
    qi = torch.cat([lo, hi], dim=-2).float()
    in_dim, scale = qi.shape[-2], p['scale4']
    g = in_dim // scale.shape[-2]
    w = qi.reshape(*qi.shape[:-2], in_dim // g, g, qi.shape[-1]) * scale[..., None, :]
    return _with_bias({'w': w.reshape(qi.shape).to(dtype)}, p)


def int4_matmul(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(q4)``, W4A16: x (..., in) float; q4 (in/2, out) packed;
    scale (groups, out).  Each nibble plane dequantizes in f32 (group scale),
    rounds to x.dtype, and takes its half of x: y = x_lo @ W_lo + x_hi @ W_hi."""
    lo, hi = unpack_int4(q4)
    half, out = q4.shape
    gh = scale.shape[-2] // 2                 # group4_for keeps groups plane-aligned
    g = half // gh

    def plane(qp, sp):
        w = qp.float().reshape(gh, g, out) * sp[:, None, :]
        return w.reshape(half, out).to(x.dtype)

    y = x[..., :half] @ plane(lo, scale[:gh]) + x[..., half:] @ plane(hi, scale[gh:])
    return y.to(x.dtype)


def quantize_linear_int4_ranked(p: Params, mp: int, group: int = GROUP4) -> Params:
    """``quantize_linear_int4`` of each of ``mp`` tensor-parallel ranks' input
    row slices on its own, re-stacked rank-major: q4 (..., mp * in/mp/2, out),
    scale4 (..., mp * groups_r, out).  The global half-split packing pairs row
    k with row k + in/2 in one byte, so a contiguous row slice of it is no
    rank's input features; packed per rank, the r-th 1/mp of the rows (and of
    the group scales) is rank r's self-contained layout.  Where in/mp is a
    multiple of the group, the values equal the global quantization's."""
    w = p['w'].float()
    in_dim = w.shape[-2]
    if in_dim % mp or (in_dim // mp) % 2:
        raise ValueError(f'int4 ranked packing needs in % mp == 0 and an even in/mp, got '
                         f'{in_dim}/{mp}')
    in_r = in_dim // mp
    parts = [quantize_linear_int4({'w': w.narrow(-2, r * in_r, in_r)}, group)
             for r in range(mp)]
    return _with_bias({'q4': torch.cat([pt['q4'] for pt in parts], dim=-2),
                       'scale4': torch.cat([pt['scale4'] for pt in parts], dim=-2)}, p)


def dequantize_linear_int4_ranked(p: Params, mp: int, dtype=torch.float32) -> Params:
    """Inverse of ``quantize_linear_int4_ranked``: the float weights a
    tensor-parallel int4 decode multiplies by (tests, solo references)."""
    q4, s4 = p['q4'], p['scale4']
    half_r, groups_r = q4.shape[-2] // mp, s4.shape[-2] // mp
    ws = [dequantize_linear_int4({'q4': q4.narrow(-2, r * half_r, half_r),
                                  'scale4': s4.narrow(-2, r * groups_r, groups_r)})['w']
          for r in range(mp)]
    return _with_bias({'w': torch.cat(ws, dim=-2).to(dtype)}, p)


def quantize_transformer(tp: Params, bits: int = 8, tp_mp: int = 1) -> Params:
    """Quantize the four big linears of a stacked transformer layer dict
    (int8 W8A8 for ``bits=8``, int4 W4A16 for ``bits=4``); norms pass
    through.  ``tp_mp`` > 1 (int4 only): the row-parallel linears (attn.out,
    ffn.lin2) take the ranked packing (``quantize_linear_int4_ranked``), so
    that a row split hands each rank a self-contained layout; qkv and lin1
    keep the global packing (a rank holds their input rows whole)."""
    if bits not in (8, 4):
        raise ValueError(f'bits must be 8 or 4, got {bits}')
    quant = quantize_linear if bits == 8 else quantize_linear_int4
    rquant = quant
    if tp_mp > 1:
        if bits != 4:
            raise ValueError('ranked packing is an int4 (W4A16) layout')
        def rquant(p):
            return quantize_linear_int4_ranked(p, tp_mp)
    out = dict(tp)
    out['attn'] = {'qkv': quant(tp['attn']['qkv']), 'out': rquant(tp['attn']['out'])}
    out['ffn'] = {'lin1': quant(tp['ffn']['lin1']), 'lin2': rquant(tp['ffn']['lin2'])}
    return out


def quantize_decode_params(params: Params, bits: int = 8) -> Params:
    """AR/NAR model params → decode params with a quantized transformer stack;
    embeddings and the logit projection stay in full precision."""
    out = dict(params)
    out['transformer'] = quantize_transformer(params['transformer'], bits=bits)
    return out
