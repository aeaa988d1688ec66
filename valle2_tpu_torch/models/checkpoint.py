"""Params save/load for the model wrappers and the trainer (``torch.save``).

Counterpart of ``valle2_tpu/models/checkpoint.py``.  A params checkpoint is
one file holding the params tree with CPU tensors; a trainer step dir
(``train.Trainer.save_checkpoint``) holds ``state.pt`` with
{'params', 'opt_state', 'step'}.  ``load_params`` takes either, as the JAX
loader does.  The JAX package's orbax checkpoints are directories of another
format and are not read here (ROADMAP.md queue 1 item 13).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

import torch

Params = dict[str, Any]
STATE_FILE = 'state.pt'


def to_cpu(tree):
    """A copy of a params (or optimizer) tree with every tensor on the CPU."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to('cpu', copy=True)
    return tree


def atomic_save(obj, path: Path) -> None:
    """``torch.save`` to a temporary name, then rename: a reader never sees
    half a file."""
    path = Path(path)
    tmp = path.with_name(f'{path.name}.{os.getpid()}.tmp')
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_params(path, params: Params) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    atomic_save(to_cpu(params), path)


def _match(template, loaded, where: str = ''):
    if isinstance(template, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(template):
            raise ValueError(f'checkpoint structure differs from the model at '
                             f'{where or "/"}')
        return {k: _match(template[k], loaded[k], f'{where}/{k}') for k in template}
    if tuple(loaded.shape) != tuple(template.shape):
        raise ValueError(f'{where}: checkpoint shape {tuple(loaded.shape)} != model shape '
                         f'{tuple(template.shape)}')
    return loaded.to(device=template.device, dtype=template.dtype)


def load_params(path, template: Params) -> Params:
    """Restore a params tree shaped like ``template`` (keeping its dtypes and
    devices) from a params file or a trainer step dir."""
    path = Path(path)
    if path.is_dir():
        path = path / STATE_FILE
    loaded = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(loaded, dict) and set(loaded) >= {'params', 'opt_state', 'step'}:
        loaded = loaded['params']
    return _match(template, loaded)
