"""Pre-norm transformer stack with a preallocated KV cache
(``valle2_tpu/ops/transformer.py``).

Layer parameters are stacked on a leading layer axis, as in the JAX package,
so weight dicts cross between the two unchanged; the stack runs as a Python
loop over that axis.  The decode step writes the new token's k/v into the
cache IN PLACE (PyTorch tensors are mutable; the JAX version returns an
updated copy) and returns the same cache object; it takes one token or a
q-token block, at one slot for every row or at per-row slots.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .attention import merge_heads, mha, mha_init, mha_tp, qkv_proj, sdpa, sdpa_chunked
from .masks import NEG_INF
from .nn import (adaln, adaln_init, dropout, ffn, ffn_init, ffn_tp, layernorm,
                 layernorm_init, linear, linear_row_parallel)

Params = dict[str, Any]


class KVCache(NamedTuple):
    """Per-layer KV cache: k, v of shape (L, b, h, max_len, hd), or the fused
    decode kernel's head-major (L, rows, max_len, d) layout
    (``kernels.fused_decode.fused_cache_layout``).

    An int8 cache holds per-(slot, head) bfloat16 scales in ``k_scale`` /
    ``v_scale``, (L, b, h, max_len, 1) (head-major: (L, rows, max_len, h));
    the value of a slot is int8 * scale."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-slot (last-axis) symmetric int8 quantization → (int8 values,
    bfloat16 scales (..., 1)).  The scale and the rounding are float32
    whatever x's dtype, as the fused kernel quantizes its own slots."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8) / 127.0
    q = torch.round(x32 / scale).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


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
    return next(iter(p['attn']['qkv'].values())).shape[0]   # 'w', or 'q' / 'q4'


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
                dropout_rate: float = 0.0, generator: torch.Generator | None = None,
                remat: bool = False) -> torch.Tensor:
    """Full-sequence forward over the stacked layers; dropout masks come from
    one generator in layer order.  ``remat`` (JAX ``jax.checkpoint`` of the
    scanned layer): while autograd records, each layer keeps only its input
    for the backward, which runs the layer's forward again (``_remat_layer``);
    outputs and grads are those of the plain stack."""
    layer = _remat_layer if remat and torch.is_grad_enabled() else encoder_layer
    for i in range(num_layers_of(p)):
        x = layer(layer_slice(p, i), x, n_heads, bias, cond, flash=flash,
                  dropout_rate=dropout_rate, generator=generator)
    return x


def _remat_layer(p: Params, x: torch.Tensor, n_heads: int, bias: torch.Tensor | None,
                 cond: torch.Tensor | None, flash: dict | None = None,
                 dropout_rate: float = 0.0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """``encoder_layer`` under the non-reentrant ``torch.utils.checkpoint``
    (the reentrant one needs inputs that require grad; the params reach the
    layer as dict leaves).  The forward draws its dropout masks from
    ``generator``, which then stands where the plain layer leaves it; the
    recompute draws from a copy set to the state the layer started from, so
    it replays the same masks (``preserve_rng_state`` restores only the
    default generators, not one passed in)."""
    from torch.utils.checkpoint import checkpoint
    draws = generator is not None and dropout_rate > 0.0
    start = generator.get_state() if draws else None
    runs = []

    def run(x):
        gen = generator
        if runs and draws:        # the backward's recompute
            gen = torch.Generator(device=generator.device)
            gen.set_state(start)
        runs.append(None)
        return encoder_layer(p, x, n_heads, bias, cond, flash=flash,
                             dropout_rate=dropout_rate, generator=gen)
    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


def transformer_prefill(p: Params, x: torch.Tensor, n_heads: int, max_len: int,
                        bias: torch.Tensor | None = None, cond: torch.Tensor | None = None,
                        cache_dtype=None, flash: dict | None = None):
    """Forward pass that also fills a KV cache (L, b, h, max_len, hd) whose
    slots [0, seq_len) hold the prefix keys/values and the rest zeros.
    ``cache_dtype``: None (x's dtype), a float dtype, or ``torch.int8``: every
    slot quantized by ``quantize_kv``, the zero padding included (its scale is
    the 1e-8 floor's), as the JAX package quantizes the padded block."""
    cache = _empty_cache(p, x, n_heads, max_len, cache_dtype)
    for i in range(num_layers_of(p)):
        x, k, v = encoder_layer(layer_slice(p, i), x, n_heads, bias, cond,
                                return_kv=True, flash=flash)
        _store_prefix(cache, i, k, v)
    return x, cache


def _empty_cache(p: Params, x: torch.Tensor, n_heads: int, max_len: int,
                 cache_dtype) -> KVCache:
    """The prefill's (L, b, h, max_len, hd) cache of x's batch for the stack
    ``p`` (its attention width from the qkv columns: a tensor-parallel rank's
    local heads), zero slots (an int8 cache with empty scales)."""
    width = next(iter(p['attn']['qkv'].values())).shape[-1] // 3
    dtype = cache_dtype if cache_dtype is not None else x.dtype
    shape = (num_layers_of(p), x.shape[0], n_heads, max_len, width // n_heads)
    ck = torch.zeros(shape, dtype=dtype, device=x.device)
    cv = torch.zeros(shape, dtype=dtype, device=x.device)
    if dtype != torch.int8:
        return KVCache(ck, cv)
    return KVCache(ck, cv, *(torch.empty((*shape[:-1], 1), dtype=torch.bfloat16,
                                         device=x.device) for _ in range(2)))


def _store_prefix(cache: KVCache, i: int, k: torch.Tensor, v: torch.Tensor) -> None:
    """Layer i's prefix k/v (b, h, seq_len, hd) into the cache's first slots;
    an int8 cache quantizes the whole layer, zero padding included."""
    if cache.k_scale is None:
        cache.k[i, :, :, :k.shape[2]] = k
        cache.v[i, :, :, :v.shape[2]] = v
        return
    pad = (0, 0, 0, cache.k.shape[3] - k.shape[2])
    cache.k[i], cache.k_scale[i] = quantize_kv(torch.nn.functional.pad(k, pad))
    cache.v[i], cache.v_scale[i] = quantize_kv(torch.nn.functional.pad(v, pad))


def transformer_decode_step(p: Params, x: torch.Tensor, n_heads: int, cache: KVCache,
                            index, cond: torch.Tensor | None = None,
                            attend_mask: torch.Tensor | None = None,
                            chunks: tuple[int, int] | None = None):
    """Advance one token or a q-token block: x (b, q, d) at absolute slots
    ``index .. index + q - 1``.  ``index`` is one int for every row or a (b,)
    tensor of per-row start slots (speculative rows advance by different
    amounts, continuous-batching rows sit at their own depths); the block
    must fit, ``index + q <= max_len``, but for a per-row one-token step
    (q = 1) at slot ``max_len``: that row writes nothing, as the fused
    kernels skip it (a frozen row at its budget; only it could read the
    slot).  Writes those slots of each layer's k/v in place (quantized by
    ``quantize_kv`` into an int8 cache, whose slots then dequantize in x's
    dtype; per-row slots by advanced indexing), then attends over the slots
    ``attend_mask`` allows:
    (b, max_len) for every query of the block, or (b, q, max_len) per query
    (the speculative block's in-block causality) -- by default query i sees
    [0, index + i].  ``chunks`` = (chunk, n): the attention is
    ``sdpa_chunked`` over the first n chunks of the cache (the fused
    kernels' chunked branch) instead of one softmax over every slot.
    Returns (y (b, q, d), cache)."""
    attend = _decode_attention(x, cache, index, attend_mask, chunks)
    for li in range(num_layers_of(p)):
        lp = layer_slice(p, li)
        attn = attend(lp['attn'], _norm(lp['norm1'], x, cond), n_heads, li)
        x = x + linear(lp['attn']['out'], attn)
        x = x + ffn(lp['ffn'], _norm(lp['norm2'], x, cond))
    return x, cache


def _decode_attention(x: torch.Tensor, cache: KVCache, index, attend_mask, chunks):
    """The decode step's attention for x's block against ``cache``, as a
    function (layer's attn params, normed input, heads, layer) -> merged
    heads (b, q, h * hd), which writes the block's k/v into the layer's
    slots first (see ``transformer_decode_step``)."""
    max_len = cache.k.shape[3]
    b, q_len = x.shape[:2]
    per_row = torch.is_tensor(index) and index.dim() == 1
    if per_row:
        slots = index.long()[:, None] + torch.arange(q_len, device=x.device)   # (b, q)
        rows = torch.arange(b, device=x.device)[:, None].expand(b, q_len)
        # A slot past the cache keeps what it holds: written back to S - 1.
        inside = (slots < max_len)[..., None, None]
        slots = slots.clamp(max=max_len - 1)

        def write(buf, li, new):              # new (b, h, q, w) into its (b, q) slots
            buf[li][rows, :, slots] = torch.where(inside, new.transpose(1, 2),
                                                  buf[li][rows, :, slots])
    else:
        index = int(index)

        def write(buf, li, new):
            buf[li, :, :, index:index + q_len] = new
    if attend_mask is None:
        start = slots[:, :1, None] if per_row else index
        attend_mask = (torch.arange(max_len, device=x.device)[None, None, :]
                       <= start + torch.arange(q_len, device=x.device)[None, :, None])
        attend_mask = attend_mask.expand(b, q_len, max_len)
    attend = attend_mask[:, None] if attend_mask.dim() == 3 else attend_mask[:, None, None, :]
    bias = torch.where(attend, 0.0, NEG_INF)

    def attention(attn_p: Params, h: torch.Tensor, n_heads: int, li: int) -> torch.Tensor:
        q, k, v = qkv_proj(attn_p, h, n_heads)              # k, v: (b, h, q, hd)
        if cache.k_scale is not None:
            for buf, sbuf, new in ((cache.k, cache.k_scale, k),
                                   (cache.v, cache.v_scale, v)):
                codes, scale = quantize_kv(new)
                write(buf, li, codes)
                write(sbuf, li, scale)
            k_all = cache.k[li].to(x.dtype) * cache.k_scale[li].to(x.dtype)
            v_all = cache.v[li].to(x.dtype) * cache.v_scale[li].to(x.dtype)
        else:
            write(cache.k, li, k.to(cache.k.dtype))
            write(cache.v, li, v.to(cache.v.dtype))
            k_all, v_all = cache.k[li], cache.v[li]
        if chunks is None:
            attn = sdpa(q, k_all, v_all, bias)
        else:
            attn = sdpa_chunked(q, k_all, v_all, attend, *chunks)
        return merge_heads(attn)
    return attention


# --- Tensor parallelism (the JAX functions' ``tp_axis``): one tree, input
# and cache per rank (``parallel.shard_decode_params``), rank r on its
# tensors' device; the stack runs each rank's local heads and FFN slice and
# sums the row-parallel partials over the ranks (``linear_row_parallel``),
# so the hidden states stay equal on every rank. ---

def _on(t, dev):
    return None if t is None else t.to(dev)


def encoder_layer_tp(ps: list[Params], xs: list[torch.Tensor], n_heads: int,
                     bias: torch.Tensor | None, cond: torch.Tensor | None,
                     return_kv: bool = False, flash: dict | None = None):
    """``encoder_layer`` (inference) over the ranks; ``n_heads`` per rank.
    Both residual adds ride in the row-parallel sums' epilogue.  Returns the
    ranks' outputs, or (outs, ks, vs) with their local k/v."""
    hs = [_norm(p['norm1'], x, _on(cond, x.device)) for p, x in zip(ps, xs)]
    res = mha_tp([p['attn'] for p in ps], hs, n_heads, bias, return_kv=return_kv, flash=flash,
                 residual=xs)
    xs = res[0] if return_kv else res
    hs = [_norm(p['norm2'], x, _on(cond, x.device)) for p, x in zip(ps, xs)]
    xs = ffn_tp([p['ffn'] for p in ps], hs, residual=xs)
    return (xs, *res[1:]) if return_kv else xs


def transformer_tp(trees: list[Params], xs: list[torch.Tensor], n_heads: int,
                   bias: torch.Tensor | None = None, cond: torch.Tensor | None = None,
                   flash: dict | None = None) -> list[torch.Tensor]:
    """``transformer`` (inference) over the ranks."""
    for i in range(num_layers_of(trees[0])):
        xs = encoder_layer_tp([layer_slice(t, i) for t in trees], xs, n_heads, bias, cond,
                              flash=flash)
    return xs


def transformer_prefill_tp(trees: list[Params], xs: list[torch.Tensor], n_heads: int,
                           max_len: int, bias: torch.Tensor | None = None,
                           cond: torch.Tensor | None = None, cache_dtype=None,
                           flash: dict | None = None):
    """``transformer_prefill`` over the ranks: each rank's cache holds its
    local heads.  Returns (the ranks' outputs, their caches)."""
    caches = [_empty_cache(t, x, n_heads, max_len, cache_dtype)
              for t, x in zip(trees, xs)]
    for i in range(num_layers_of(trees[0])):
        xs, ks, vs = encoder_layer_tp([layer_slice(t, i) for t in trees], xs, n_heads, bias,
                                      cond, return_kv=True, flash=flash)
        for cache, k, v in zip(caches, ks, vs):
            _store_prefix(cache, i, k, v)
    return xs, caches


def transformer_decode_step_tp(trees: list[Params], xs: list[torch.Tensor], n_heads: int,
                               caches: list[KVCache], index,
                               cond: torch.Tensor | None = None,
                               attend_mask: torch.Tensor | None = None,
                               chunks: tuple[int, int] | None = None, reduce=None):
    """``transformer_decode_step`` over the ranks (``n_heads`` and the cache
    width per rank; ``reduce``: the sum of ``linear_row_parallel``).
    Returns (the ranks' outputs, their caches)."""
    attends = [_decode_attention(x, c, _on(index, x.device) if torch.is_tensor(index)
                                 else index, _on(attend_mask, x.device), chunks)
               for x, c in zip(xs, caches)]
    for li in range(num_layers_of(trees[0])):
        lps = [layer_slice(t, li) for t in trees]
        merged = [att(lp['attn'], _norm(lp['norm1'], x, _on(cond, x.device)), n_heads, li)
                  for att, lp, x in zip(attends, lps, xs)]
        xs = linear_row_parallel([lp['attn']['out'] for lp in lps], merged, reduce, xs)
        hs = [_norm(lp['norm2'], x, _on(cond, x.device)) for lp, x in zip(lps, xs)]
        xs = ffn_tp([lp['ffn'] for lp in lps], hs, reduce, xs)
    return xs, caches
