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
    """``x @ w + b``.  Mixed float dtypes promote to the wider one, as JAX
    promotes them (a bfloat16 attention output from a bfloat16 KV cache meets
    float32 weights in the decode step)."""
    w = p['w']
    if x.dtype != w.dtype:
        wide = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(wide), w.to(wide)
    y = x @ w
    if 'b' in p:
        y = y + p['b']
    return y


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
