"""Core NN primitives as plain functions over dict parameters.

PyTorch counterpart of ``valle2_tpu/ops/nn.py``: the same parameter dicts and
layouts (linear weights stored (in, out), stacked per layer by the transformer),
so weights move between the two packages leaf by leaf.  Initializers follow the
torch defaults the JAX package reproduces (kaiming-uniform linear, N(0, 1)
embedding), drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..quantize import int4_matmul, int8_dot, int8_matmul

Params = dict[str, Any]


def _uniform(gen: torch.Generator, shape, bound: float, dtype) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2 - 1).mul_(
        bound).to(dtype)


def linear_init(gen: torch.Generator, in_dim: int, out_dim: int, use_bias: bool = True,
                dtype=torch.float32) -> Params:
    """torch nn.Linear default init, weight stored (in_dim, out_dim)."""
    bound = 1.0 / math.sqrt(in_dim)
    p: Params = {'w': _uniform(gen, (in_dim, out_dim), bound, dtype)}
    if use_bias:
        p['b'] = _uniform(gen, (out_dim,), bound, dtype)
    return p


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b``, or the quantized product of ``quantize.py``'s layouts:
    'q' (int8 W8A8) and 'q4' (int4 W4A16), the bias added after.  Mixed float
    dtypes promote to the wider one, as JAX promotes them (a bfloat16
    attention output from a bfloat16 KV cache meets float32 weights in the
    decode step)."""
    if 'q' in p:
        y = int8_matmul(x, p['q'], p['scale'])
    elif 'q4' in p:
        y = int4_matmul(x, p['q4'], p['scale4'])
    else:
        w = p['w']
        if x.dtype != w.dtype:
            wide = torch.promote_types(x.dtype, w.dtype)
            x, w = x.to(wide), w.to(wide)
        y = x @ w
    if 'b' in p:
        y = y + p['b']
    return y


def decode_logits(p: Params, x: torch.Tensor) -> torch.Tensor:
    """The decode loops' logits head, ``linear(p, x)`` in float32, with the
    same bits for a row whatever other rows share the batch.  On the card a
    float32 GEMM rounds as the kernel cuBLAS picks for the row count does
    (TF32 under the default precision), so a continuous-batching step's
    logits parted from the solo step's and a sampled session could draw
    another token; there the product runs in float64 (the products of
    float32 or bfloat16 inputs are exact) and rounds to float32 once.  On the
    CPU, and for quantized weights, it is ``linear``."""
    if x.device.type != 'cuda' or 'w' not in p:
        return linear(p, x).float()
    y = x.double() @ p['w'].double()
    if 'b' in p:
        y = y + p['b'].double()
    return y.float()


def linear_row_parallel(ps: list[Params], xs: list[torch.Tensor], reduce=None,
                        residual: list[torch.Tensor] | None = None) -> list[torch.Tensor]:
    """Row-parallel linear under tensor parallelism (JAX
    ``linear_row_parallel``): rank r's weight ``ps[r]`` holds a slice of the
    input features and ``xs[r]`` the matching slice of the input, so its
    product is a partial sum; the bias is added once, after the sum.  One
    output per rank, on its device, equal across ranks; with ``residual``
    (one tensor per rank), ``residual[r] + out`` instead, the caller's
    residual add.  int8 W8A8: the activation scale takes the amax over every
    rank's slice (the solo row's scale) and the ranks' int32 products sum
    exactly; dense and int4 W4A16 (the ranked packing) sum their float32
    partials through ``kernels.tp_allreduce.tp_row_reduce`` (the
    rank-ordered sum with the bias, the cast and the residual add in one
    epilogue: on the card 5c, one launch a card), or ``reduce``
    (``tp_allreduce_plain``: the plain version's sum, the epilogue in torch
    ops)."""
    if 'q' in ps[0]:
        x32s = [x.float() for x in xs]
        dev0 = xs[0].device
        amax = torch.stack([x.abs().amax(dim=-1, keepdim=True).to(dev0)
                            for x in x32s]).amax(dim=0)
        sx = amax.clamp(min=1e-8) / 127.0
        acc = None
        for p, x in zip(ps, x32s):
            part = int8_dot(torch.round(x / sx.to(x.device)).clamp(-127, 127), p['q'])
            acc = part.to(dev0) if acc is None else acc + part.to(dev0)
        ys = [(acc.to(x.device).float() * sx.to(x.device) * p['scale']).to(x.dtype)
              for p, x in zip(ps, xs)]
        return _row_parallel_epilogue(ps, xs, ys, residual)
    parts = []
    for p, x in zip(ps, xs):
        if 'q4' in p:
            parts.append(int4_matmul(x, p['q4'], p['scale4']).float())
        else:
            w = p['w']
            wide = torch.promote_types(x.dtype, w.dtype)
            parts.append((x.to(wide) @ w.to(wide)).float())
    biases = [p.get('b') for p in ps]
    if reduce is None:
        from ..kernels.tp_allreduce import tp_row_reduce
        return tp_row_reduce(parts, biases, residual, xs[0].dtype)
    return _row_parallel_epilogue(ps, xs, reduce(parts), residual)


def _row_parallel_epilogue(ps, xs, ys, residual):
    """The bias after the sum, the cast to the input's dtype, the residual."""
    out = []
    for r, (p, x, y) in enumerate(zip(ps, xs, ys)):
        if 'b' in p:
            y = y + p['b']
        y = y.to(x.dtype)
        out.append(y if residual is None else residual[r] + y)
    return out


def embedding_init(gen: torch.Generator, vocab_size: int, dim: int,
                   dtype=torch.float32) -> Params:
    """torch nn.Embedding default init: N(0, 1)."""
    return {'emb': torch.randn((vocab_size, dim), generator=gen).to(dtype)}


def embedding(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return p['emb'][ids]


def layernorm_init(dim: int, dtype=torch.float32) -> Params:
    return {'scale': torch.ones(dim, dtype=dtype), 'bias': torch.zeros(dim, dtype=dtype)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch nn.LayerNorm numerics (biased variance) with float32 statistics
    whatever the activation dtype, as the JAX package computes them."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p['scale'] + p['bias']).to(x.dtype)


def adaln_init(gen: torch.Generator, dim: int, dtype=torch.float32) -> Params:
    return {'proj': linear_init(gen, dim, 2 * dim, dtype=dtype),
            'ln': layernorm_init(dim, dtype)}


def adaln(p: Params, x: torch.Tensor, cond: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``weight * LN(x) + bias`` with (weight, bias) = split(proj(cond));
    ``cond`` is (1, d) or (b, d) and broadcasts over the sequence axis."""
    weight, bias = linear(p['proj'], cond).chunk(2, dim=-1)
    y = layernorm(p['ln'], x, eps)
    if cond.dim() == 2 and x.dim() == 3:
        weight, bias = weight[:, None, :], bias[:, None, :]
    return weight * y + bias


def ffn_init(gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.float32) -> Params:
    return {'lin1': linear_init(gen, d_model, d_ff, dtype=dtype),
            'lin2': linear_init(gen, d_ff, d_model, dtype=dtype)}


def cast_to_compute(params: Params, config) -> Params:
    """Differentiable mixed-precision cast: every leaf in the master
    ``param_dtype`` becomes the compute ``dtype`` (bf16 training); other leaves
    pass through.  Autograd of the cast returns the grads in the master dtype."""
    cdtype, pdtype = config.torch_dtype, config.torch_param_dtype
    if cdtype == pdtype:
        return params
    from .transformer import map_tree
    return map_tree(lambda a: a.to(cdtype) if a.dtype == pdtype else a, params)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout drawn from ``generator``; identity when it is None
    (deterministic / eval mode) or ``rate`` <= 0."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def ffn(p: Params, x: torch.Tensor, dropout_rate: float = 0.0,
        generator: torch.Generator | None = None) -> torch.Tensor:
    """Linear → exact (erf) GELU → dropout → Linear."""
    h = dropout(F.gelu(linear(p['lin1'], x)), dropout_rate, generator)
    return linear(p['lin2'], h)


def ffn_tp(ps: list[Params], xs: list[torch.Tensor], reduce=None,
           residual: list[torch.Tensor] | None = None) -> list[torch.Tensor]:
    """``ffn`` under tensor parallelism: lin1 column-split (rank r's slice of
    the hidden width, its bias slice), lin2 row-split (``linear_row_parallel``
    with ``reduce`` and ``residual``).  Inference only (no dropout)."""
    hs = [F.gelu(linear(p['lin1'], x)) for p, x in zip(ps, xs)]
    return linear_row_parallel([p['lin2'] for p in ps], hs, reduce, residual)


def sinusoidal_table(max_len: int, d_model: int, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """pe[pos, 2i] = sin(pos * exp(-2i ln(1e4)/d)), pe[pos, 2i+1] = cos(...)."""
    position = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                         * (-math.log(10000.0) / d_model))
    angles = position * div_term
    pe = torch.zeros((max_len, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angles)
    pe[:, 1::2] = torch.cos(angles)
    return pe.to(dtype)


def add_positional(pe: torch.Tensor, x: torch.Tensor, offset: int = 0,
                   dropout_rate: float = 0.0,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """x[..., t, :] += pe[offset + t], then dropout."""
    seq_len = x.shape[-2]
    return dropout(x + pe[offset:offset + seq_len].to(x.dtype), dropout_rate, generator)
