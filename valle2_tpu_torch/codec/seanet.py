"""SEANet encoder and decoder, EnCodec-24kHz geometry (``valle2_tpu/codec/seanet.py``).

n_filters=32, dimension=128, ratios=[8,5,4,2] (the encoder downsamples in the
reverse order 2,4,5,8), kernel 7, residual kernel 3, compress 2, one residual
layer, 2 LSTM layers, ELU, causal reflect padding.  Hop = 8*5*4*2 = 320 → 75
fps at 24 kHz.  Channel-last (B, T, C) throughout.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from .conv import causal_conv1d, causal_conv_transpose1d, conv1d_init
from .lstm import lstm, lstm_init

Params = dict[str, Any]

RATIOS = (8, 5, 4, 2)
N_FILTERS = 32
DIMENSION = 128
KERNEL = 7
RES_KERNEL = 3
COMPRESS = 2
LSTM_LAYERS = 2
HOP = 320


def _resblock_init(gen: torch.Generator, dim: int, dtype=torch.float32) -> Params:
    hidden = dim // COMPRESS
    return {'conv1': conv1d_init(gen, dim, hidden, RES_KERNEL, dtype),
            'conv2': conv1d_init(gen, hidden, dim, 1, dtype),
            'shortcut': conv1d_init(gen, dim, dim, 1, dtype)}


def _resblock(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = causal_conv1d(p['conv1'], F.elu(x))
    h = causal_conv1d(p['conv2'], F.elu(h))
    return causal_conv1d(p['shortcut'], x) + h


def encoder_init(gen: torch.Generator, dtype=torch.float32) -> Params:
    mult = 1
    p: Params = {'stem': conv1d_init(gen, 1, N_FILTERS, KERNEL, dtype)}
    stages = []
    for ratio in reversed(RATIOS):                                 # 2, 4, 5, 8
        ch = mult * N_FILTERS
        stages.append({'res': _resblock_init(gen, ch, dtype),
                       'down': conv1d_init(gen, ch, ch * 2, ratio * 2, dtype)})
        mult *= 2
    p['stages'] = stages
    p['lstm'] = lstm_init(gen, mult * N_FILTERS, mult * N_FILTERS, LSTM_LAYERS, dtype)
    p['head'] = conv1d_init(gen, mult * N_FILTERS, DIMENSION, KERNEL, dtype)
    return p


def encode(p: Params, wav: torch.Tensor) -> torch.Tensor:
    """(B, T) waveform → (B, ceil(T/320), 128) latents."""
    x = causal_conv1d(p['stem'], wav[:, :, None])
    for stage, ratio in zip(p['stages'], reversed(RATIOS)):
        x = _resblock(stage['res'], x)
        x = causal_conv1d(stage['down'], F.elu(x), stride=ratio)
    x = lstm(p['lstm'], x)
    return causal_conv1d(p['head'], F.elu(x))


def decoder_init(gen: torch.Generator, dtype=torch.float32) -> Params:
    mult = 2 ** len(RATIOS)
    p: Params = {'stem': conv1d_init(gen, DIMENSION, mult * N_FILTERS, KERNEL, dtype),
                 'lstm': lstm_init(gen, mult * N_FILTERS, mult * N_FILTERS, LSTM_LAYERS,
                                   dtype)}
    stages = []
    for ratio in RATIOS:
        ch = mult * N_FILTERS
        stages.append({'up': conv1d_init(gen, ch, ch // 2, ratio * 2, dtype),
                       'res': _resblock_init(gen, ch // 2, dtype)})
        mult //= 2
    p['stages'] = stages
    p['head'] = conv1d_init(gen, N_FILTERS, 1, KERNEL, dtype)
    return p


def decode(p: Params, latents: torch.Tensor) -> torch.Tensor:
    """(B, F, 128) latents → (B, F*320) waveform."""
    x = causal_conv1d(p['stem'], latents)
    x = lstm(p['lstm'], x)
    for stage, ratio in zip(p['stages'], RATIOS):
        x = causal_conv_transpose1d(stage['up'], F.elu(x), stride=ratio)
        x = _resblock(stage['res'], x)
    x = causal_conv1d(p['head'], F.elu(x))
    return x[:, :, 0]
