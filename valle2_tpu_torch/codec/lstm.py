"""Stacked LSTM with residual skip (encodec SLSTM), ``valle2_tpu/codec/lstm.py``.

torch nn.LSTM numerics, gate order [i, f, g, o].  The input projection of every
timestep is one matmul; only the hidden-to-hidden recurrence runs step by step.
"""

from __future__ import annotations

import math
from typing import Any

import torch

Params = dict[str, Any]


def lstm_init(gen: torch.Generator, input_size: int, hidden_size: int, num_layers: int,
              dtype=torch.float32) -> Params:
    """torch nn.LSTM default init U(-1/sqrt(H), 1/sqrt(H)); weights stored (in, 4H)."""
    bound = 1.0 / math.sqrt(hidden_size)

    def u(*shape):
        return ((torch.rand(shape, generator=gen) * 2 - 1) * bound).to(dtype)
    layers = []
    for i in range(num_layers):
        in_dim = input_size if i == 0 else hidden_size
        layers.append({'w_ih': u(in_dim, 4 * hidden_size), 'w_hh': u(hidden_size, 4 * hidden_size),
                       'b_ih': u(4 * hidden_size), 'b_hh': u(4 * hidden_size)})
    return {'layers': layers}


def _lstm_layer(p: Params, x: torch.Tensor) -> torch.Tensor:
    """One LSTM layer over (B, T, C) → (B, T, H)."""
    b, t, _ = x.shape
    h_dim = p['w_hh'].shape[0]
    gates_x = x @ p['w_ih'] + (p['b_ih'] + p['b_hh'])               # (B, T, 4H)
    h = x.new_zeros((b, h_dim))
    c = x.new_zeros((b, h_dim))
    hs = []
    for step in range(t):
        gates = gates_x[:, step] + h @ p['w_hh']
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def lstm(p: Params, x: torch.Tensor, skip: bool = True) -> torch.Tensor:
    """y = lstm(x) + x (residual skip)."""
    y = x
    for layer_p in p['layers']:
        y = _lstm_layer(layer_p, y)
    return y + x if skip else y
