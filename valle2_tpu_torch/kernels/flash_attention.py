"""Prefix-LM flash attention forward: the CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``valle2_tpu/kernels/flash_attention.py``
(``_flash_fwd`` → ``_fwd_kernel``) on the AR prefill.  The kernel is
``csrc/flash_attention.cu`` (see its header for the design); this module holds
the wrapper that checks and launches it, and ``flash_attention_plain``, a
PyTorch port of the JAX package's ``reference_attention`` that also returns the
per-row logsumexp.  The wrapper takes the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.

Forward only: the ``torch.autograd.Function`` with the backward kernels comes
with the training slice (ROADMAP.md).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..ops.masks import NEG_INF, prefix_lm_attend
from . import _build

COUNTER = _build.LaunchCounter()
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


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


def _lib():
    lib = _build.load('flash_attention')
    fn = lib.valle2_flash_attention_fwd
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                       ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, meta, tokens_total: int, causal: bool = True):
    """Prefix-LM attention of q, k, v (b, h, s, hd) with meta (b, 2) int32 =
    [tokens_valid, kv_end] per batch row.  Returns (o, lse)."""
    if q.device.type == 'cpu':
        return flash_attention_plain(q, k, v, meta, tokens_total, causal)
    if q.device.type != 'cuda':
        raise ValueError(f'flash_attention runs on CPU or CUDA tensors, got {q.device}')
    b, h, s, hd = q.shape
    for name, t in (('k', k), ('v', v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f'{name} must match q in shape, dtype and device')
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f'flash_attention kernel takes float32 or bfloat16, got {q.dtype}')
    if hd not in _HEAD_DIMS:
        raise ValueError(f'flash_attention kernel takes head dims {_HEAD_DIMS}, got {hd}')
    if meta.shape != (b, 2) or meta.dtype != torch.int32 or meta.device != q.device:
        raise ValueError('meta must be a (b, 2) int32 tensor on the device of q')
    if not all(t.is_contiguous() for t in (q, k, v, meta)):
        raise ValueError('flash_attention kernel needs contiguous q, k, v and meta')
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), meta.data_ptr(),
                    o.data_ptr(), lse.data_ptr(), b, h, s, hd, int(tokens_total),
                    int(bool(causal)), _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(hd), stream)
    _build.check(status, 'flash_attention')
    COUNTER.count += 1
    return o, lse
