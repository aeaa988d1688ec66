"""EnCodec checkpoint (facebookresearch/encodec v0.1.1 naming) → codec params
(``valle2_tpu/codec/convert.py``, copied).

Weight-norm reparametrizations (``weight_g`` / ``weight_v``) fold into plain
kernels, conv weights turn to the channel-last (k, in, out) layout and LSTM
matrices transpose for ``x @ w``.  The result has numpy leaves;
``models.convert.codec_params_from_numpy`` turns it into tensors.

Sequential indices (causal 24 kHz model, 1 residual layer, 4 stages, 2 LSTM layers):
  encoder.model: 0 stem | per stage i: (1+3i) resblock, (3+3i) down conv | 13 lstm | 15 head
  decoder.model: 0 stem | 1 lstm | per stage i: (3+3i) up convtr, (4+3i) resblock | 15 head
  quantizer.vq.layers.{q}._codebook.embed : (1024, 128) codebooks
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

Params = dict[str, Any]

_N_STAGES = 4


def _fold_weight_norm(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    """weight = g * v / ||v|| with the norm over all dims except 0 (torch dim=0)."""
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt((v.astype(np.float64) ** 2).sum(axis=axes, keepdims=True))
    return (g.astype(np.float64) * v.astype(np.float64) / norm).astype(np.float32)


def _conv_weight(sd: Mapping[str, np.ndarray], prefix: str) -> np.ndarray:
    """Plain or weight-normed Conv1d weight (out, in, k) from state-dict keys."""
    if f'{prefix}.weight' in sd:
        return np.asarray(sd[f'{prefix}.weight'], np.float32)
    return _fold_weight_norm(np.asarray(sd[f'{prefix}.weight_g']),
                             np.asarray(sd[f'{prefix}.weight_v']))


def _conv(sd, prefix: str) -> Params:
    w = _conv_weight(sd, prefix)                       # torch (out, in, k)
    return {'w': np.ascontiguousarray(w.transpose(2, 1, 0)),  # → (k, in, out)
            'b': np.asarray(sd[f'{prefix}.bias'], np.float32)}


def _convtr(sd, prefix: str) -> Params:
    w = _conv_weight(sd, prefix)                       # torch (in, out, k)
    return {'w': np.ascontiguousarray(w.transpose(2, 0, 1)),  # → (k, in, out)
            'b': np.asarray(sd[f'{prefix}.bias'], np.float32)}


def _resblock(sd, prefix: str) -> Params:
    # block = [ELU, conv, ELU, conv]; shortcut is a 1x1 conv (true_skip=False).
    return {'conv1': _conv(sd, f'{prefix}.block.1.conv.conv'),
            'conv2': _conv(sd, f'{prefix}.block.3.conv.conv'),
            'shortcut': _conv(sd, f'{prefix}.shortcut.conv.conv')}


def _lstm(sd, prefix: str, num_layers: int = 2) -> Params:
    return {'layers': [{
        'w_ih': np.asarray(sd[f'{prefix}.weight_ih_l{i}'], np.float32).T.copy(),
        'w_hh': np.asarray(sd[f'{prefix}.weight_hh_l{i}'], np.float32).T.copy(),
        'b_ih': np.asarray(sd[f'{prefix}.bias_ih_l{i}'], np.float32),
        'b_hh': np.asarray(sd[f'{prefix}.bias_hh_l{i}'], np.float32),
    } for i in range(num_layers)]}


def convert_state_dict(sd: Mapping[str, np.ndarray]) -> Params:
    """Full encodec state dict → {'encoder', 'decoder', 'rvq'} of numpy arrays."""
    enc: Params = {'stem': _conv(sd, 'encoder.model.0.conv.conv'), 'stages': []}
    for i in range(_N_STAGES):                          # ratios 2, 4, 5, 8
        enc['stages'].append({
            'res': _resblock(sd, f'encoder.model.{1 + 3 * i}'),
            'down': _conv(sd, f'encoder.model.{3 + 3 * i}.conv.conv'),
        })
    enc['lstm'] = _lstm(sd, f'encoder.model.{1 + 3 * _N_STAGES}.lstm')
    enc['head'] = _conv(sd, f'encoder.model.{3 + 3 * _N_STAGES}.conv.conv')

    dec: Params = {'stem': _conv(sd, 'decoder.model.0.conv.conv'),
                   'lstm': _lstm(sd, 'decoder.model.1.lstm'), 'stages': []}
    for i in range(_N_STAGES):                          # ratios 8, 5, 4, 2
        dec['stages'].append({
            'up': _convtr(sd, f'decoder.model.{3 + 3 * i}.convtr.convtr'),
            'res': _resblock(sd, f'decoder.model.{4 + 3 * i}'),
        })
    dec['head'] = _conv(sd, f'decoder.model.{3 + 3 * _N_STAGES}.conv.conv')

    n_q = 0
    while f'quantizer.vq.layers.{n_q}._codebook.embed' in sd:
        n_q += 1
    codebooks = np.stack([np.asarray(sd[f'quantizer.vq.layers.{q}._codebook.embed'],
                                     np.float32) for q in range(n_q)])
    return {'encoder': enc, 'decoder': dec, 'rvq': {'codebooks': codebooks}}


def load_torch_checkpoint(path: str) -> Params:
    """Load a torch ``.th``/``.pt`` EnCodec checkpoint (a state dict, or one
    under ``best_state``) and convert it."""
    import torch
    obj = torch.load(path, map_location='cpu', weights_only=True)
    sd = obj.get('best_state', obj) if isinstance(obj, dict) else obj
    if hasattr(sd, 'state_dict'):
        sd = sd.state_dict()
    return convert_state_dict({k: v.numpy() for k, v in sd.items()})
