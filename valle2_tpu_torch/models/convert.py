"""Carry weights into and out of the port (``valle2_tpu/models/convert.py``).

- ``load_ar_state_dict`` / ``load_nar_state_dict`` read the reference's torch
  state-dict naming (numpy or tensor values) into the port's stacked
  parameter dicts (linear weights (in, out)); ``convert_ar_state_dict`` /
  ``convert_nar_state_dict`` are the JAX package's names for them.
- ``load_torch_checkpoint`` reads a checkpoint file of the reference stack (a
  raw state dict, or Lightning's ``{'state_dict': ...}`` with an optional
  ``model.`` key prefix); ``save_torch_checkpoint`` writes one through
  ``export_ar_state_dict`` / ``export_nar_state_dict``, the exact inverses of
  the loaders.  Files cross between the two packages either way.
- ``codec_params_from_numpy`` takes the JAX codec's decoder + RVQ pytree with
  numpy leaves, under the same keys (``valle2_tpu/codec`` layout).
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

from ..ops.transformer import map_tree, stack_trees

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


def convert_ar_state_dict(sd: Mapping, num_layers: int | None = None,
                          dtype=torch.float32) -> Params:
    """Reference ValleAR state dict → ``models.ar.init_params``-shaped dict;
    ``num_layers``, when given, must be the dict's layer count."""
    params = load_ar_state_dict(sd, dtype)
    _check_layers(params, num_layers)
    return params


def convert_nar_state_dict(sd: Mapping, num_layers: int | None = None,
                           num_quantizers: int = 8, dtype=torch.float32) -> Params:
    """Reference ValleNAR state dict → ``models.nar.init_params``-shaped dict."""
    params = load_nar_state_dict(sd, dtype)
    _check_layers(params, num_layers)
    if params['codes_embs'].shape[0] != num_quantizers:
        raise ValueError(f'the checkpoint has {params["codes_embs"].shape[0]} codebook '
                         f'embeddings, the model {num_quantizers}')
    return params


def _check_layers(params: Params, num_layers: int | None) -> None:
    n = params['transformer']['attn']['qkv']['w'].shape[0]
    if num_layers is not None and n != num_layers:
        raise ValueError(f'the checkpoint has {n} layers, the model {num_layers}')


def load_torch_checkpoint(path, model: str, num_layers: int = 8, num_quantizers: int = 8,
                          dtype=torch.float32, device='cpu') -> Params:
    """A torch / Lightning checkpoint file of the reference stack → the port's
    params of ``model`` ('ValleAR' | 'ValleASR' | 'ValleNAR') on ``device``.

    Takes a raw state dict or ``{'state_dict': {...}}`` with an optional
    ``model.`` key prefix, loaded with ``weights_only=True``."""
    obj = torch.load(path, map_location='cpu', weights_only=True)
    sd = obj.get('state_dict', obj) if isinstance(obj, dict) else obj
    sd = {k.removeprefix('model.'): v for k, v in sd.items()}
    if model == 'ValleNAR':
        params = convert_nar_state_dict(sd, num_layers, num_quantizers, dtype)
    else:
        params = convert_ar_state_dict(sd, num_layers, dtype)
    return map_tree(lambda t: t.to(device), params)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to('cpu', torch.float32).contiguous()


def _export_layers(tr: Params, prefix: str, adaptive: bool) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    for i in range(tr['attn']['qkv']['w'].shape[0]):
        pre = f'{prefix}.layers.{i}'
        sd[f'{pre}.self_attn.qkv.weight'] = _f32(tr['attn']['qkv']['w'][i].T)
        sd[f'{pre}.self_attn.out.weight'] = _f32(tr['attn']['out']['w'][i].T)
        sd[f'{pre}.self_attn.out.bias'] = _f32(tr['attn']['out']['b'][i])
        sd[f'{pre}.ffn.linear_1.weight'] = _f32(tr['ffn']['lin1']['w'][i].T)
        sd[f'{pre}.ffn.linear_1.bias'] = _f32(tr['ffn']['lin1']['b'][i])
        sd[f'{pre}.ffn.linear_2.weight'] = _f32(tr['ffn']['lin2']['w'][i].T)
        sd[f'{pre}.ffn.linear_2.bias'] = _f32(tr['ffn']['lin2']['b'][i])
        for n in ('norm1', 'norm2'):
            if adaptive:
                sd[f'{pre}.{n}.project_layer.weight'] = _f32(tr[n]['proj']['w'][i].T)
                sd[f'{pre}.{n}.project_layer.bias'] = _f32(tr[n]['proj']['b'][i])
                sd[f'{pre}.{n}.norm.weight'] = _f32(tr[n]['ln']['scale'][i])
                sd[f'{pre}.{n}.norm.bias'] = _f32(tr[n]['ln']['bias'][i])
            else:
                sd[f'{pre}.{n}.weight'] = _f32(tr[n]['scale'][i])
                sd[f'{pre}.{n}.bias'] = _f32(tr[n]['bias'][i])
    return sd


def export_ar_state_dict(params: Params) -> dict[str, torch.Tensor]:
    """AR params → the reference ValleAR state-dict naming (torch layouts,
    f32 CPU tensors).  A LoRA fine-tune state merges first
    (``lora.merged``)."""
    adaptive = 'proj' in params['transformer']['norm1']
    return {
        'tokens_emb.word_embeddings.weight': _f32(params['tokens_emb']['emb']),
        'audio_emb.word_embeddings.weight': _f32(params['audio_emb']['emb']),
        'proj.weight': _f32(params['proj']['w'].T),
        **_export_layers(params['transformer'], 'transformer', adaptive),
    }


def export_nar_state_dict(params: Params) -> dict[str, torch.Tensor]:
    """NAR params → the reference ValleNAR state-dict naming (torch layouts)."""
    adaptive = 'proj' in params['transformer']['norm1']
    sd = {'tokens_emb.word_embeddings.weight': _f32(params['tokens_emb']['emb'])}
    for q in range(params['codes_embs'].shape[0]):
        sd[f'codes_embs.{q}.word_embeddings.weight'] = _f32(params['codes_embs'][q])
    for q in range(params['stage_embs'].shape[0]):
        sd[f'stage_embs.{q}.word_embeddings.weight'] = _f32(params['stage_embs'][q][None])
        sd[f'proj_layers.{q}.weight'] = _f32(params['proj_layers'][q].T)
    sd.update(_export_layers(params['transformer'], 'transformer', adaptive))
    return sd


def save_torch_checkpoint(path, params: Params, model: str) -> None:
    """Write ``{'state_dict': {name: tensor}}`` in the reference's naming, the
    file the reference stack and ``load_torch_checkpoint`` (of either
    package) read.  model: 'ValleAR' | 'ValleASR' (AR naming) | 'ValleNAR'."""
    sd = export_nar_state_dict(params) if model == 'ValleNAR' else export_ar_state_dict(params)
    torch.save({'state_dict': sd}, path)


def codec_params_from_numpy(tree, dtype=torch.float32):
    """A codec pytree with array leaves (dicts and lists, the JAX layout) → the
    same structure with torch tensors."""
    if isinstance(tree, dict):
        return {k: codec_params_from_numpy(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [codec_params_from_numpy(v, dtype) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32)).to(dtype)
