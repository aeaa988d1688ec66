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

from .masks import NEG_INF
from .nn import column_input, linear, linear_init, linear_row_parallel

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


def sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, attend: torch.Tensor,
                 chunk: int, n_chunks: int) -> torch.Tensor:
    """``sdpa`` under a boolean ``attend`` mask (broadcastable to (b, h, sq,
    sk)) as an online softmax over the key axis in chunks of ``chunk`` slots,
    in slot order, visiting only the first ``n_chunks``: the chunked branch
    of the fused decode kernels.  Per chunk: scores in f32, the running max
    and sum rescaled by exp(old max - new max); a chunk with no attended slot
    adds nothing (its probabilities are zeroed, not exp(-inf - -inf)).
    Probabilities stay f32 for the PV product, as in those kernels."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float() * scale
    m = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device)
    denom = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        ok = attend[..., sl]
        s = torch.where(ok, torch.matmul(qf, k[..., sl, :].float().transpose(-1, -2)), NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        denom = denom * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, v[..., sl, :].float())
        m = m_new
    return (acc / denom.clamp(min=1e-30)[..., None]).to(v.dtype)


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


def flash_shard_mesh(mesh, batch: int, n_heads: int) -> bool:
    """Whether the training flash kernel runs on a mesh (JAX
    ``flash_shard_mesh``'s answer), decided from the shapes before any
    launch: without a mesh (or with one rank), or where the rows divide the
    data axis and the heads the model axis (each (data, model) shard then
    runs the kernel on its rows and its local heads, ``mha_tp``); otherwise
    the caller takes the plain route (the bias)."""
    if mesh is None or mesh.size == 1:
        return True
    return batch % mesh.data == 0 and n_heads % mesh.model == 0


def mha_tp(ps: list[Params], xs: list[torch.Tensor], n_heads: int,
           bias: torch.Tensor | None = None, return_kv: bool = False,
           flash: dict | None = None, residual: list[torch.Tensor] | None = None,
           seq: list[tuple[int, int]] | None = None):
    """``mha`` under tensor parallelism (JAX ``mha`` with ``tp_axis``): rank
    r's fused qkv holds its ``n_heads`` local heads (``tp_permute_qkv``), it
    attends over them (the flash kernels #1 / #2 forward and #3 or #4 + #5
    backward on the card, on the rank's rows and heads, made contiguous),
    and the row-split output projection sums the ranks' partials
    (``linear_row_parallel``, which adds ``residual`` where given).  The
    input enters through ``nn.column_input`` (``seq``: sequence parallelism,
    each rank holding its slice of the positions).  Returns one output per
    rank, or (outs, ks, vs) with each rank's local k/v."""
    from ..parallel.mesh import on_device
    xs = column_input(xs, seq)
    merged, ks, vs = [], [], []
    for p, x in zip(ps, xs):
        with on_device(x.device):
            q, k, v = qkv_proj(p, x, n_heads)
            if flash is not None:
                from ..kernels.flash_attention import FlashAttention
                attn = FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                            flash['meta'].to(x.device), flash['tokens_total'],
                                            flash.get('causal', True))
            else:
                attn = sdpa(q, k, v, None if bias is None else bias.to(x.device))
        merged.append(merge_heads(attn))
        ks.append(k)
        vs.append(v)
    outs = linear_row_parallel([p['out'] for p in ps], merged, residual=residual, seq=seq)
    if return_kv:
        return outs, ks, vs
    return outs
