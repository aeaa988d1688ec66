"""Multi-head attention for full sequences (``valle2_tpu/ops/attention.py``).

Fused QKV projection (no bias), output projection (bias), scale 1/sqrt(head_dim),
float32 softmax.  ``mha``'s ``flash`` route sends the prefix-LM attention
through ``kernels.flash_attention.FlashAttention`` (the CUDA forward and
backward kernels on the card, their plain versions on the CPU), with grad on
or off, instead of materializing a (b, 1, s, s) bias.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from .nn import linear, linear_init

Params = dict[str, Any]


def mha_init(gen: torch.Generator, d_model: int, n_heads: int,
             dtype=torch.float32) -> Params:
    del n_heads  # head count is a reshape, not a parameter
    return {'qkv': linear_init(gen, d_model, 3 * d_model, use_bias=False, dtype=dtype),
            'out': linear_init(gen, d_model, d_model, dtype=dtype)}


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, n_heads, d // n_heads).transpose(1, 2)   # (b, h, s, hd)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


def qkv_proj(p: Params, x: torch.Tensor, n_heads: int):
    """Fused QKV → per-head (b, h, s, hd) triple (views of one projection)."""
    q, k, v = linear(p['qkv'], x).chunk(3, dim=-1)
    return split_heads(q, n_heads), split_heads(k, n_heads), split_heads(v, n_heads)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         bias: torch.Tensor | None = None) -> torch.Tensor:
    """Scaled dot-product attention with float32 scores and softmax.

    q: (b, h, sq, hd), k/v: (b, h, sk, hd), bias broadcastable to (b, h, sq, sk).
    Products take the inputs' dtype upcast to f32 (exact for bf16 operands),
    matching ``preferred_element_type=float32`` in the JAX package; the
    probabilities round to v's dtype before the PV product, as there."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(v.dtype)


def mha(p: Params, x: torch.Tensor, n_heads: int, bias: torch.Tensor | None = None,
        return_kv: bool = False, flash: dict | None = None):
    """Full-sequence MHA.  Returns out, or (out, k, v) for cache prefill.

    ``flash``: optional {'meta': (b, 2) int32 [tokens_valid, kv_end],
    'tokens_total': int, 'causal': bool} — the flash kernel route."""
    q, k, v = qkv_proj(p, x, n_heads)
    if flash is not None:
        from ..kernels.flash_attention import FlashAttention
        attn = FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                    flash['meta'], flash['tokens_total'],
                                    flash.get('causal', True))
    else:
        attn = sdpa(q, k, v, bias)
    out = linear(p['out'], merge_heads(attn))
    if return_kv:
        return out, k, v
    return out
