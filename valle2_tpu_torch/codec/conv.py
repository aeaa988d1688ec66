"""Causal 1-D convolutions for the SEANet stacks (``valle2_tpu/codec/conv.py``).

Public functions keep the JAX package's channel-last (B, T, C) layout and its
weight layout (kernel, in, out); they transpose to PyTorch's (B, C, T) around
``F.conv1d`` / ``F.conv_transpose1d``.

- causal conv: left-pad by ``(kernel-1)*dilation + 1 - stride`` plus the right
  "extra padding" that makes strided convs see only full windows; reflect
  padding with a zero-extension fallback for short inputs (encodec's pad1d).
- causal transposed conv: the full transposed conv, then trim
  ``kernel - stride`` samples from the right.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

Params = dict[str, Any]


def conv1d_init(gen: torch.Generator, in_ch: int, out_ch: int, kernel: int,
                dtype=torch.float32) -> Params:
    """torch nn.Conv1d default init (fan_in = in_ch * kernel), weight (k, in, out)."""
    bound = 1.0 / math.sqrt(in_ch * kernel)

    def u(*shape):
        return ((torch.rand(shape, generator=gen) * 2 - 1) * bound).to(dtype)
    return {'w': u(kernel, in_ch, out_ch), 'b': u(out_ch)}


def _pad_reflect_or_zero(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Reflect-pad (B, T, C) along time; zero-extend first when the signal is
    too short to reflect, then drop that extension (encodec pad1d)."""
    t = x.shape[1]
    max_pad = max(left, right)
    extra = max_pad - t + 1 if max_pad >= t else 0
    xc = x.transpose(1, 2)
    if extra:
        xc = F.pad(xc, (0, extra))
    out = F.pad(xc, (left, right), mode='reflect') if (left or right) else xc
    if extra:
        out = out[..., :out.shape[-1] - extra]
    return out.transpose(1, 2)


def causal_conv1d(p: Params, x: torch.Tensor, stride: int = 1, dilation: int = 1,
                  pad_mode: str = 'reflect') -> torch.Tensor:
    """x: (B, T, Cin) → (B, ceil(T/stride), Cout)."""
    kernel = p['w'].shape[0]
    eff_kernel = (kernel - 1) * dilation + 1
    padding_total = eff_kernel - stride
    t = x.shape[1]
    n_frames = (t - eff_kernel + padding_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + eff_kernel - padding_total
    extra = max(ideal - t, 0)
    if pad_mode == 'reflect':
        x = _pad_reflect_or_zero(x, padding_total, extra)
    else:
        x = F.pad(x, (0, 0, padding_total, extra))
    y = F.conv1d(x.transpose(1, 2), p['w'].permute(2, 1, 0), p['b'], stride=stride,
                 dilation=dilation)
    return y.transpose(1, 2)


def causal_conv_transpose1d(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    """x: (B, T, Cin) → (B, T*stride, Cout); weight (k, in, out)."""
    kernel = p['w'].shape[0]
    y = F.conv_transpose1d(x.transpose(1, 2), p['w'].permute(1, 2, 0), p['b'],
                           stride=stride)
    padding_total = kernel - stride
    if padding_total > 0:
        y = y[..., :-padding_total]
    return y.transpose(1, 2)
