"""Residual VQ encode: the CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``valle2_tpu/kernels/rvq.py``
(``rvq_encode_fused`` → ``_rvq_kernel``): every RVQ stage of a batch of
latent frames in one call.  The kernel is ``csrc/rvq.cu`` (see its header for
the design); the plain version is ``codec.rvq.rvq_encode``.  The wrapper takes
the plain version only for tensors on the CPU; on the card every codec encode
goes through the kernel (the JAX package's ``use_pallas_rvq`` switch has no
counterpart here).
"""

from __future__ import annotations

import ctypes

import torch

from ..codec import rvq as _plain
from . import _build

COUNTER = _build.LaunchCounter()
LATENT_DIM = 128      # the kernel's frame width
CODE_TILE = 128       # codewords per shared-memory tile: V must be a multiple
# The tie rule between kernel and plain version: a differing code must score
# within TIE_RTOL * max(1, |best score|) of the plain best.  The two sum the
# 128-term dot products and |c|^2 in different orders, which moves a score by
# a few f32 ulps (~1e-7 relative per term); 1e-5 covers that with margin.
TIE_RTOL = 1e-5


def rvq_encode_plain(codebooks: torch.Tensor, latents: torch.Tensor,
                     n_q: int | None = None) -> torch.Tensor:
    """``codec.rvq.rvq_encode`` on bare codebooks."""
    return _plain.rvq_encode({'codebooks': codebooks}, latents, n_q)


def code_gaps(codebooks: torch.Tensor, latents: torch.Tensor, codes: torch.Tensor):
    """How far given codes fall short of the plain version's choice: replay
    the plain stages on ``codes`` (teacher-forced) and return, per (frame,
    stage), (plain max score − plain score of the given code, |plain max|),
    each (B*T, n_q).  A gap of 0 is the plain argmax or an exact tie; the
    kernel may differ from the plain version only where the gap lies within
    f32 rounding of the scores."""
    n_q = codes.shape[1]
    residual = latents.reshape(-1, latents.shape[-1])
    chosen = codes.permute(0, 2, 1).reshape(-1, n_q).long()
    gaps, tops = [], []
    for q in range(n_q):
        cb = codebooks[q]
        scores = 2.0 * (residual @ cb.T) - (cb * cb).sum(dim=-1)
        top = scores.max(dim=-1).values
        gaps.append(top - scores.gather(1, chosen[:, q:q + 1])[:, 0])
        tops.append(top.abs())
        residual = residual - cb[chosen[:, q]]
    return torch.stack(gaps, dim=1), torch.stack(tops, dim=1)


def _lib():
    fn = _build.load('rvq').valle2_rvq_encode
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 4 + [ci] * 4 + [vp]
        fn.restype = ctypes.c_int
    return fn


def rvq_encode_fused(codebooks: torch.Tensor, latents: torch.Tensor,
                     n_q: int | None = None) -> torch.Tensor:
    """codebooks (n_q_all, V, D), latents (B, T, D) → codes (B, n_q, T) int32,
    through the first ``n_q`` codebooks (all of them by default)."""
    if latents.device.type == 'cpu':
        return rvq_encode_plain(codebooks, latents, n_q)
    if latents.device.type != 'cuda':
        raise ValueError(f'rvq_encode_fused runs on CPU or CUDA tensors, got {latents.device}')
    if codebooks.dtype != torch.float32 or latents.dtype != torch.float32:
        raise TypeError('rvq_encode_fused kernel takes float32 codebooks and latents, got '
                        f'{codebooks.dtype} and {latents.dtype}')
    if codebooks.device != latents.device:
        raise ValueError('codebooks and latents must be on the same CUDA device')
    if not (codebooks.is_contiguous() and latents.is_contiguous()):
        raise ValueError('rvq_encode_fused kernel needs contiguous codebooks and latents')
    if codebooks.dim() != 3 or latents.dim() != 3 or codebooks.shape[2] != LATENT_DIM \
            or latents.shape[2] != LATENT_DIM:
        raise ValueError(f'rvq_encode_fused kernel takes (n_q, V, {LATENT_DIM}) codebooks '
                         f'and (B, T, {LATENT_DIM}) latents, got {tuple(codebooks.shape)} '
                         f'and {tuple(latents.shape)}')
    nq_all, v, _ = codebooks.shape
    n_q = nq_all if n_q is None else int(n_q)
    if not 1 <= n_q <= nq_all or v % CODE_TILE:
        raise ValueError(f'rvq_encode_fused kernel: n_q={n_q} of {nq_all} codebooks, '
                         f'V={v} must be a multiple of {CODE_TILE}')
    b, t, _ = latents.shape
    if b * t == 0:
        raise ValueError('rvq_encode_fused kernel needs at least one frame')
    codes = torch.empty((b, n_q, t), dtype=torch.int32, device=latents.device)
    csq = torch.empty((n_q, v), dtype=torch.float32, device=latents.device)
    stream = torch.cuda.current_stream(latents.device).cuda_stream
    status = _lib()(codebooks.data_ptr(), latents.data_ptr(), csq.data_ptr(),
                    codes.data_ptr(), b * t, t, n_q, v, stream)
    _build.check(status, 'rvq_encode_fused')
    COUNTER.count += 1
    return codes
