"""Carry weights into the port.

- ``load_ar_state_dict`` / ``load_nar_state_dict`` read the reference's torch
  state-dict naming, the dicts that ``valle2_tpu/models/convert.py``'s
  ``export_ar_state_dict`` / ``export_nar_state_dict`` write (numpy or tensor
  values), into the port's stacked parameter dicts (linear weights (in, out)).
- ``codec_params_from_numpy`` takes the JAX codec's decoder + RVQ pytree with
  numpy leaves, under the same keys (``valle2_tpu/codec`` layout).
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

from ..ops.transformer import stack_trees

Params = dict[str, Any]


def _t(sd: Mapping, key: str, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(sd[key], np.float32)).to(dtype)


def _num_layers(sd: Mapping, prefix: str) -> int:
    pat = re.compile(rf'^{re.escape(prefix)}\.layers\.(\d+)\.')
    idx = {int(m.group(1)) for k in sd if (m := pat.match(k))}
    return max(idx) + 1 if idx else 0


def _layer(sd: Mapping, prefix: str, adaptive: bool, dtype) -> Params:
    def t(name):
        return _t(sd, f'{prefix}.{name}', dtype)

    def norm(n: str) -> Params:
        if adaptive:
            return {'proj': {'w': t(f'{n}.project_layer.weight').T.contiguous(),
                             'b': t(f'{n}.project_layer.bias')},
                    'ln': {'scale': t(f'{n}.norm.weight'), 'bias': t(f'{n}.norm.bias')}}
        return {'scale': t(f'{n}.weight'), 'bias': t(f'{n}.bias')}

    return {
        'attn': {'qkv': {'w': t('self_attn.qkv.weight').T.contiguous()},
                 'out': {'w': t('self_attn.out.weight').T.contiguous(),
                         'b': t('self_attn.out.bias')}},
        'ffn': {'lin1': {'w': t('ffn.linear_1.weight').T.contiguous(),
                         'b': t('ffn.linear_1.bias')},
                'lin2': {'w': t('ffn.linear_2.weight').T.contiguous(),
                         'b': t('ffn.linear_2.bias')}},
        'norm1': norm('norm1'),
        'norm2': norm('norm2'),
    }


def _stack_layers(sd: Mapping, adaptive: bool, dtype) -> Params:
    n = _num_layers(sd, 'transformer')
    return stack_trees([_layer(sd, f'transformer.layers.{i}', adaptive, dtype)
                        for i in range(n)])


def load_ar_state_dict(sd: Mapping, dtype=torch.float32) -> Params:
    """Reference ValleAR state dict → ``models.ar.init_params``-shaped dict."""
    return {
        'tokens_emb': {'emb': _t(sd, 'tokens_emb.word_embeddings.weight', dtype)},
        'audio_emb': {'emb': _t(sd, 'audio_emb.word_embeddings.weight', dtype)},
        'transformer': _stack_layers(sd, adaptive=False, dtype=dtype),
        'proj': {'w': _t(sd, 'proj.weight', dtype).T.contiguous()},
    }


def load_nar_state_dict(sd: Mapping, dtype=torch.float32) -> Params:
    """Reference ValleNAR state dict → ``models.nar.init_params``-shaped dict."""
    nq = sum(1 for k in sd if re.fullmatch(r'codes_embs\.\d+\.word_embeddings\.weight', k))
    return {
        'tokens_emb': {'emb': _t(sd, 'tokens_emb.word_embeddings.weight', dtype)},
        'codes_embs': torch.stack([_t(sd, f'codes_embs.{q}.word_embeddings.weight', dtype)
                                   for q in range(nq)]),
        'stage_embs': torch.stack([_t(sd, f'stage_embs.{q}.word_embeddings.weight', dtype)[0]
                                   for q in range(nq - 1)]),
        'transformer': _stack_layers(sd, adaptive=True, dtype=dtype),
        'proj_layers': torch.stack([_t(sd, f'proj_layers.{q}.weight', dtype).T.contiguous()
                                    for q in range(nq - 1)]),
    }


def codec_params_from_numpy(tree, dtype=torch.float32):
    """A codec pytree with array leaves (dicts and lists, the JAX layout) → the
    same structure with torch tensors."""
    if isinstance(tree, dict):
        return {k: codec_params_from_numpy(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [codec_params_from_numpy(v, dtype) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32)).to(dtype)
