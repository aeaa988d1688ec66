"""Pre-norm transformer stack with a preallocated KV cache
(``valle2_tpu/ops/transformer.py``).

Layer parameters are stacked on a leading layer axis, as in the JAX package,
so weight dicts cross between the two unchanged; the stack runs as a Python
loop over that axis.  The decode step writes the new token's k/v into the
cache IN PLACE (PyTorch tensors are mutable; the JAX version returns an
updated copy) and returns the same cache object.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .attention import merge_heads, mha, mha_init, qkv_proj, sdpa
from .masks import NEG_INF
from .nn import (adaln, adaln_init, dropout, ffn, ffn_init, layernorm, layernorm_init,
                 linear)

Params = dict[str, Any]


class KVCache(NamedTuple):
    """Per-layer KV cache: k, v of shape (L, b, h, max_len, hd), or the fused
    decode kernel's head-major (L, rows, max_len, d) layout
    (``kernels.fused_decode.fused_cache_layout``)."""
    k: torch.Tensor
    v: torch.Tensor


def encoder_layer_init(gen: torch.Generator, d_model: int, n_heads: int, d_ff: int,
                       adaptive_norm: bool, dtype=torch.float32) -> Params:
    attn = mha_init(gen, d_model, n_heads, dtype)
    ff = ffn_init(gen, d_model, d_ff, dtype)
    if adaptive_norm:
        norm1, norm2 = adaln_init(gen, d_model, dtype), adaln_init(gen, d_model, dtype)
    else:
        norm1, norm2 = layernorm_init(d_model, dtype), layernorm_init(d_model, dtype)
    return {'attn': attn, 'ffn': ff, 'norm1': norm1, 'norm2': norm2}


def stack_trees(trees: list) -> Params:
    """Leaf-wise ``torch.stack`` of identically structured dicts."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def map_tree(fn, tree):
    """Apply ``fn`` to every tensor leaf of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def layer_slice(p: Params, i: int) -> Params:
    return map_tree(lambda a: a[i], p)


def num_layers_of(p: Params) -> int:
    return p['attn']['qkv']['w'].shape[0]


def transformer_init(gen: torch.Generator, num_layers: int, d_model: int, n_heads: int,
                     d_ff: int, adaptive_norm: bool, dtype=torch.float32) -> Params:
    return stack_trees([encoder_layer_init(gen, d_model, n_heads, d_ff, adaptive_norm,
                                           dtype) for _ in range(num_layers)])


def _norm(p: Params, x: torch.Tensor, cond: torch.Tensor | None) -> torch.Tensor:
    if 'proj' in p:  # AdaptiveLayerNorm
        if cond is None:
            raise ValueError('AdaptiveLayerNorm requires a conditioning embedding')
        return adaln(p, x, cond)
    return layernorm(p, x)


def encoder_layer(p: Params, x: torch.Tensor, n_heads: int, bias: torch.Tensor | None,
                  cond: torch.Tensor | None, return_kv: bool = False,
                  flash: dict | None = None, dropout_rate: float = 0.0,
                  generator: torch.Generator | None = None):
    """One pre-norm block: ``x + drop(attn(norm1(x)))``; ``x + drop(ffn(norm2(x)))``,
    with the FFN's hidden dropout too.  The three masks are drawn from
    ``generator`` in that order (the JAX package splits one key per layer)."""
    h = _norm(p['norm1'], x, cond)
    if return_kv:
        attn_out, k, v = mha(p['attn'], h, n_heads, bias, return_kv=True, flash=flash)
    else:
        attn_out = mha(p['attn'], h, n_heads, bias, flash=flash)
    x = x + dropout(attn_out, dropout_rate, generator)
    h = ffn(p['ffn'], _norm(p['norm2'], x, cond), dropout_rate, generator)
    x = x + dropout(h, dropout_rate, generator)
    if return_kv:
        return x, k, v
    return x


def transformer(p: Params, x: torch.Tensor, n_heads: int, bias: torch.Tensor | None = None,
                cond: torch.Tensor | None = None, flash: dict | None = None,
                dropout_rate: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Full-sequence forward over the stacked layers; dropout masks come from
    one generator in layer order."""
    for i in range(num_layers_of(p)):
        x = encoder_layer(layer_slice(p, i), x, n_heads, bias, cond, flash=flash,
                          dropout_rate=dropout_rate, generator=generator)
    return x


def transformer_prefill(p: Params, x: torch.Tensor, n_heads: int, max_len: int,
                        bias: torch.Tensor | None = None, cond: torch.Tensor | None = None,
                        cache_dtype=None, flash: dict | None = None):
    """Forward pass that also fills a KV cache (L, b, h, max_len, hd) whose
    slots [0, seq_len) hold the prefix keys/values and the rest zeros."""
    num_layers = num_layers_of(p)
    b, seq_len, d = x.shape
    hd = d // n_heads
    dtype = cache_dtype if cache_dtype is not None else x.dtype
    shape = (num_layers, b, n_heads, max_len, hd)
    ck = torch.zeros(shape, dtype=dtype, device=x.device)
    cv = torch.zeros(shape, dtype=dtype, device=x.device)
    for i in range(num_layers):
        x, k, v = encoder_layer(layer_slice(p, i), x, n_heads, bias, cond,
                                return_kv=True, flash=flash)
        ck[i, :, :, :seq_len] = k
        cv[i, :, :, :seq_len] = v
    return x, KVCache(ck, cv)


def transformer_decode_step(p: Params, x: torch.Tensor, n_heads: int, cache: KVCache,
                            index: int, cond: torch.Tensor | None = None,
                            attend_mask: torch.Tensor | None = None):
    """Advance one token: x (b, 1, d) at absolute slot ``index`` (one scalar
    for every row).  Writes slot ``index`` of each layer's k/v in place, then
    attends over the slots ``attend_mask`` (b, max_len) allows — by default
    [0, index].  Returns (y (b, 1, d), cache)."""
    max_len = cache.k.shape[3]
    if attend_mask is None:
        attend_mask = (torch.arange(max_len, device=x.device) <= index)[None].expand(
            x.shape[0], max_len)
    bias = torch.where(attend_mask, 0.0, NEG_INF)[:, None, None, :]
    for li in range(num_layers_of(p)):
        lp = layer_slice(p, li)
        h = _norm(lp['norm1'], x, cond)
        q, k, v = qkv_proj(lp['attn'], h, n_heads)              # k, v: (b, h, 1, hd)
        cache.k[li, :, :, index] = k[:, :, 0].to(cache.k.dtype)
        cache.v[li, :, :, index] = v[:, :, 0].to(cache.v.dtype)
        attn = sdpa(q, cache.k[li], cache.v[li], bias)
        x = x + linear(lp['attn']['out'], merge_heads(attn))
        x = x + ffn(lp['ffn'], _norm(lp['norm2'], x, cond))
    return x, cache
