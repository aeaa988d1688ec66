"""Prefix-LM flash attention, forward and backward: the CUDA kernels, their
plain versions, and the ``torch.autograd.Function`` that joins them.

Replaces the Pallas TPU kernels of ``valle2_tpu/kernels/flash_attention.py``:
the forward ``_flash_fwd`` → ``_fwd_kernel`` (#1) and its head-folded form
``_flash_fwd_folded`` → ``_fwd_kernel_folded`` (#2), both in
``csrc/flash_attention.cu`` (bf16 on the tensor cores, f32 on the CUDA
cores), on the AR prefill and in every training step;
and the backward ``_flash_bwd`` (``csrc/flash_attention_bwd.cu``):
``_bwd_fused_kernel`` when the padded row fits (``FUSED_BWD_MAX_SEQ``), else
``_bwd_dq_kernel`` then ``_bwd_dkv_kernel``, the JAX package's routing rule.
See each source's header for its design.

Which forward runs is the JAX package's rule: ``fold_heads=None`` applies
``_fold_default``, which reads ``VALLE2_FLASH_FOLD`` (unset: #1).  The port
reads it at call time, where JAX reads it when it traces.  The JAX
``block_q`` / ``block_k`` are TPU VMEM tile choices that no caller passes;
the CUDA kernels fix their own tiles, so the port takes neither.

Each wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises, and counts its launches.
``flash_attention_plain`` is a port of the JAX ``reference_attention`` that
also returns the per-row logsumexp.  It is the plain version of #1 and #2
alike: both compute the same function, and the JAX package's own tests hold
both Pallas kernels against the one ``reference_attention``.
``flash_attention_bwd_plain`` is the explicit formulas of ``_bwd_fused_kernel``
on whole (s, s) matrices.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from ..ops.masks import NEG_INF, prefix_lm_attend
from . import _build

COUNTER = _build.LaunchCounter()
FOLD_COUNTER = _build.LaunchCounter()
BWD_FUSED_COUNTER = _build.LaunchCounter()
BWD_DQ_COUNTER = _build.LaunchCounter()
BWD_DKV_COUNTER = _build.LaunchCounter()
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
# The JAX package's bound for its one-pass backward (flash_attention.py:50):
# the fused kernel runs when s rounded up to 128 is at most this.
FUSED_BWD_MAX_SEQ = 768


def flash_attention_plain(q, k, v, meta, tokens_total: int, causal: bool = True):
    """Plain PyTorch version: (o (b, h, s, hd) like q, lse (b, h, s) f32).

    Scores and softmax in f32 from the inputs' values; the probabilities round
    to v's dtype before the PV product, like the kernel."""
    s = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    attend = prefix_lm_attend(s, tokens_total, meta[:, 0], meta[:, 1], causal)
    scores = torch.where(attend[:, None], scores, NEG_INF)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1)
    o = torch.matmul(probs.to(v.dtype).float(), v.float()).to(v.dtype)
    return o, lse


def flash_attention_bwd_plain(q, k, v, meta, o, lse, do, tokens_total: int,
                              causal: bool = True):
    """Plain PyTorch backward: (dq, dk, dv), each like its input.

    The formulas of the Pallas ``_bwd_fused_kernel`` on whole (s, s) matrices,
    with its rounding points: p = exp(scores - lse) where the mask attends and
    0 elsewhere, rounded to dO's dtype before pᵀ·dO; ds = p∘(dO·Vᵀ − delta)
    rounded to q's dtype before ds·K and dsᵀ·Q; scale multiplies dq and dk.
    A query row that sees no key therefore gets zero gradient, where autograd
    of the forward's uniform average over the −1e30 sentinel would not."""
    s = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    attend = prefix_lm_attend(s, tokens_total, meta[:, 0], meta[:, 1], causal)[:, None]
    p = torch.where(attend, torch.exp(scores - lse[..., None]), 0.0)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof).to(v.dtype)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (p * (dp - delta)).to(q.dtype).float()
    dq = (torch.matmul(ds, kf) * scale).to(q.dtype)
    dk = (torch.matmul(ds.transpose(-1, -2), qf) * scale).to(k.dtype)
    return dq, dk, dv


def _fn(lib_name: str, sym: str, argtypes):
    fn = getattr(_build.load(lib_name), sym)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_VP, _CI = ctypes.c_void_p, ctypes.c_int
# b, h, s, hd, tokens_total, causal, dtype, scale, stream
_SCALARS = [_CI, _CI, _CI, _CI, _CI, _CI, _CI, ctypes.c_float, _VP]


def _check_qkv(name: str, q, others, meta):
    """Device, dtype, head dim, shape and contiguity checks shared by the wrappers."""
    if q.device.type != 'cuda':
        raise ValueError(f'{name} runs on CPU or CUDA tensors, got {q.device}')
    for t in others:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f'{name}: q, k, v (and o, dO) must match in shape, dtype and '
                             'device')
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f'{name} kernel takes float32 or bfloat16, got {q.dtype}')
    b, _, _, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f'{name} kernel takes head dims {HEAD_DIMS}, got {hd}')
    if meta.shape != (b, 2) or meta.dtype != torch.int32 or meta.device != q.device:
        raise ValueError('meta must be a (b, 2) int32 tensor on the device of q')
    if not all(t.is_contiguous() for t in (q, *others, meta)):
        raise ValueError(f'{name} kernel needs contiguous inputs')


def _fold_default(h: int, s: int) -> bool:
    """The JAX package's head-fold policy (``flash_attention.py:321-335``):
    off unless ``VALLE2_FLASH_FOLD`` is set to anything but a falsey
    spelling ('0', 'false', 'off', 'no', '', any case, outer spaces)."""
    env = os.environ.get('VALLE2_FLASH_FOLD')
    if env is not None:
        return env.strip().lower() not in ('0', 'false', 'off', 'no', '')
    return False


def _forward(name: str, sym: str, counter, q, k, v, meta, tokens_total, causal):
    _check_qkv(name, q, (k, v), meta)
    b, h, s, hd = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    fn = _fn('flash_attention', sym, [_VP] * 6 + _SCALARS)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), meta.data_ptr(), o.data_ptr(),
                lse.data_ptr(), b, h, s, hd, int(tokens_total), int(bool(causal)),
                _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(hd), _stream(q))
    _build.check(status, name)
    counter.count += 1
    return o, lse


def flash_attention_folded(q, k, v, meta, tokens_total: int, causal: bool = True):
    """Kernel #2, the head-folded forward: one block per (q-tile, batch row)
    carrying every head.  Same arguments and result as ``flash_attention``."""
    if q.device.type == 'cpu':
        return flash_attention_plain(q, k, v, meta, tokens_total, causal)
    return _forward('flash_attention_folded', 'valle2_flash_attention_fwd_folded',
                    FOLD_COUNTER, q, k, v, meta, tokens_total, causal)


def flash_attention(q, k, v, meta, tokens_total: int, causal: bool = True,
                    fold_heads: bool | None = None):
    """Prefix-LM attention of q, k, v (b, h, s, hd) with meta (b, 2) int32 =
    [tokens_valid, kv_end] per batch row.  Returns (o, lse).  ``fold_heads``
    True runs #2, False #1; None applies ``_fold_default``."""
    if fold_heads is None:
        fold_heads = _fold_default(q.shape[1], q.shape[2])
    if fold_heads:
        return flash_attention_folded(q, k, v, meta, tokens_total, causal)
    if q.device.type == 'cpu':
        return flash_attention_plain(q, k, v, meta, tokens_total, causal)
    return _forward('flash_attention', 'valle2_flash_attention_fwd', COUNTER, q, k, v, meta,
                    tokens_total, causal)


# Launches of the CUDA-core bf16 route, which only chip_smoke.py's timing calls.
CUDA_CORES_COUNTER = _build.LaunchCounter()


def flash_attention_cuda_cores(q, k, v, meta, tokens_total: int, causal: bool = True):
    """#1 with bf16 products on the CUDA cores in f32 FMAs (the first design's
    route of ``csrc/flash_attention.cu``; f32 runs there in either case), kept to time
    the tensor-core route beside the design it replaced.  No path of the port
    calls it; CUDA tensors only."""
    return _forward('flash_attention_cuda_cores', 'valle2_flash_attention_fwd_cuda_cores',
                    CUDA_CORES_COUNTER, q, k, v, meta, tokens_total, causal)


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _bwd_inputs(name: str, q, k, v, meta, o, lse, do):
    """Checks of a backward wrapper; returns delta = rowsum(dO∘O) in f32 (a
    PyTorch op, as in the JAX wrapper, which computes it outside the kernels)."""
    _check_qkv(name, q, (k, v, o, do), meta)
    if (lse.shape != q.shape[:3] or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f'{name}: lse must be a contiguous (b, h, s) float32 tensor')
    return (do.float() * o.float()).sum(-1).contiguous()


def _bwd_scalars(q, tokens_total, causal):
    b, h, s, hd = q.shape
    return (b, h, s, hd, int(tokens_total), int(bool(causal)), _DTYPE_CODE[q.dtype],
            1.0 / math.sqrt(hd), _stream(q))


def flash_bwd_fused(q, k, v, meta, o, lse, do, tokens_total: int, causal: bool = True):
    """Kernel #3: dq, dk, dv in one pass per kv tile (dq through an f32
    scratch with atomics, then one pass that scales and casts it)."""
    if q.device.type == 'cpu':
        return flash_attention_bwd_plain(q, k, v, meta, o, lse, do, tokens_total, causal)
    delta = _bwd_inputs('flash_bwd_fused', q, k, v, meta, o, lse, do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    fn = _fn('flash_attention_bwd', 'valle2_flash_bwd_fused', [_VP] * 11 + _SCALARS)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), meta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), dq_acc.data_ptr(), *_bwd_scalars(q, tokens_total, causal))
    _build.check(status, 'flash_bwd_fused')
    BWD_FUSED_COUNTER.count += 1
    return dq, dk, dv


def flash_bwd_dq(q, k, v, meta, o, lse, do, tokens_total: int, causal: bool = True):
    """Kernel #4: dq per 64-row q tile over the visible kv tiles."""
    if q.device.type == 'cpu':
        return flash_attention_bwd_plain(q, k, v, meta, o, lse, do, tokens_total, causal)[0]
    delta = _bwd_inputs('flash_bwd_dq', q, k, v, meta, o, lse, do)
    dq = torch.empty_like(q)
    fn = _fn('flash_attention_bwd', 'valle2_flash_bwd_dq', [_VP] * 8 + _SCALARS)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), meta.data_ptr(), dq.data_ptr(),
                *_bwd_scalars(q, tokens_total, causal))
    _build.check(status, 'flash_bwd_dq')
    BWD_DQ_COUNTER.count += 1
    return dq


def flash_bwd_dkv(q, k, v, meta, o, lse, do, tokens_total: int, causal: bool = True):
    """Kernel #5: dk, dv per 64-key kv tile over the q tiles that see it."""
    if q.device.type == 'cpu':
        return flash_attention_bwd_plain(q, k, v, meta, o, lse, do, tokens_total, causal)[1:]
    delta = _bwd_inputs('flash_bwd_dkv', q, k, v, meta, o, lse, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _fn('flash_attention_bwd', 'valle2_flash_bwd_dkv', [_VP] * 9 + _SCALARS)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), meta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                *_bwd_scalars(q, tokens_total, causal))
    _build.check(status, 'flash_bwd_dkv')
    BWD_DKV_COUNTER.count += 1
    return dk, dv


def uses_fused_bwd(s: int) -> bool:
    """The JAX routing rule: the one-pass backward when s rounded up to 128
    fits ``FUSED_BWD_MAX_SEQ``."""
    return -(-s // 128) * 128 <= FUSED_BWD_MAX_SEQ


def flash_attention_bwd(q, k, v, meta, o, lse, do, tokens_total: int, causal: bool = True):
    """(dq, dk, dv) of ``flash_attention``: kernel #3, or #4 then #5 past
    ``FUSED_BWD_MAX_SEQ`` (for CPU tensors #3's wrapper takes the plain version)."""
    if q.device.type == 'cpu' or uses_fused_bwd(q.shape[2]):
        return flash_bwd_fused(q, k, v, meta, o, lse, do, tokens_total, causal)
    dq = flash_bwd_dq(q, k, v, meta, o, lse, do, tokens_total, causal)
    dk, dv = flash_bwd_dkv(q, k, v, meta, o, lse, do, tokens_total, causal)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(q, k, v, meta, tokens_total, causal[, fold])`` →
    o: the forward kernel (#2 when ``fold``, #1 otherwise; None, the default,
    applies ``_fold_default``), with the backward kernels as its gradient (the
    JAX ``_flash_attention_vjp``).  The backward is the same for both
    forwards, on their (b, h, s) lse, as in the JAX ``_bwd_rule``.  Saves q,
    k, v, o, lse and meta; meta is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, meta, tokens_total: int, causal: bool,
                fold: bool | None = None):
        o, lse = flash_attention(q, k, v, meta, tokens_total, causal, fold_heads=fold)
        ctx.save_for_backward(q, k, v, o, lse, meta)
        ctx.tokens_total, ctx.causal = tokens_total, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, meta = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, meta, o, lse, do.contiguous(),
                                         ctx.tokens_total, ctx.causal)
        return dq, dk, dv, None, None, None, None
