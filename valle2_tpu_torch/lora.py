"""LoRA adapters: parameter-efficient fine-tuning (``valle2_tpu/lora.py``).

Adapters live in a tree parallel to the params and are merged into the dense
weights inside the train step's forward -- ``w_eff = w + (alpha / rank) * A
@ B`` (Hu et al. 2021) -- so autograd reaches A and B only, the base stays
bit-identical, and every consumer (the flash and fused-decode kernels, int8 /
int4 quantization, tensor-parallel stacks) sees ordinary dense params: serving
a fine-tune merges once and hands the dense tree to the model.

Adapters attach to every linear whose dict key is in ``config.lora_targets``
(default ``qkv`` / ``out`` / ``lin1`` / ``lin2``; per-layer leaves are stacked
``(L, in, out)``, so A and B stack ``(L, in, r)`` / ``(L, r, out)``).  Adding
``'proj'`` also adapts the output heads and the AdaLN projections.

Adapter files are npz archives of '/'-joined keys with the merge scale in a
float64 ``__scale__`` entry, the JAX package's layout: a file written by
either package loads in the other.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any

import numpy as np
import torch

Params = dict[str, Any]

#: Linear param-dict keys adapters attach to by default (ops/transformer.py).
DEFAULT_TARGETS = ('qkv', 'out', 'lin1', 'lin2')

_SCALE_KEY = '__scale__'   # reserved npz entry: the merge scale (alpha / rank)


def _is_linear(node) -> bool:
    return isinstance(node, dict) and isinstance(node.get('w'), torch.Tensor) \
        and node['w'].dim() >= 2


def lora_init(generator: torch.Generator, params: Params, rank: int,
              targets=DEFAULT_TARGETS) -> Params:
    """Adapter tree for every target linear reachable in ``params``.

    A ~ U(-1/sqrt(in), 1/sqrt(in)) (the base linears' kaiming-uniform bound)
    in ``w``'s dtype on ``w``'s device, drawn from ``generator`` in the
    tree's order; B = 0, so the attached model starts exactly at the base.
    Leading (stacked-layer) dims of ``w`` carry over to A and B."""
    if rank <= 0:
        raise ValueError(f'lora rank must be positive, got {rank}')
    count = [0]

    def walk(node):
        out = {}
        for name, sub in node.items():
            if name in targets and _is_linear(sub):
                w = sub['w']
                *batch, d_in, d_out = w.shape
                count[0] += 1
                bound = 1.0 / math.sqrt(d_in)
                u = torch.rand((*batch, d_in, rank), generator=generator,
                               device=generator.device)
                out[name] = {'lora_a': (u * (2 * bound) - bound).to(w.device, w.dtype),
                             'lora_b': torch.zeros((*batch, rank, d_out), dtype=w.dtype,
                                                   device=w.device)}
            elif isinstance(sub, dict):
                child = walk(sub)
                if child:
                    out[name] = child
        return out

    tree = walk(params)
    if count[0] == 0:
        raise ValueError(f'no LoRA targets {targets} found in the params tree')
    return tree


def merge_lora(params: Params, lora: Params, scale: float) -> Params:
    """Dense params with adapters folded in: ``w + (A @ B * scale)`` per
    target, the product in float32 and cast to ``w``'s dtype.  Differentiable
    (the train step merges inside its forward) and cheap (rank-r products).
    Non-target leaves are shared, not copied."""
    def walk(node, lnode):
        out = dict(node)
        for name, lsub in lnode.items():
            sub = node[name]
            if 'lora_a' in lsub:
                delta = torch.matmul(lsub['lora_a'].float(), lsub['lora_b'].float()) * scale
                out[name] = dict(sub, w=sub['w'] + delta.to(sub['w'].dtype))
            else:
                out[name] = walk(sub, lsub)
        return out

    return walk(params, lora)


def lora_scale(config) -> float:
    return float(config.lora_alpha) / float(config.lora_rank)


def attach(params: Params, config, generator: torch.Generator) -> Params:
    """Base params → the fine-tune state ``{'base': ..., 'lora': ...}`` that
    ``train.init_state`` builds and the Trainer checkpoints."""
    return {'base': params,
            'lora': lora_init(generator, params, config.lora_rank, tuple(config.lora_targets))}


def is_lora_state(tree) -> bool:
    return isinstance(tree, dict) and set(tree) == {'base', 'lora'}


def merged(tree: Params, config) -> Params:
    """Effective dense params: merged if ``tree`` is a fine-tune state, else
    ``tree`` itself -- the one entry the train and eval steps call."""
    if is_lora_state(tree):
        return merge_lora(tree['base'], tree['lora'], lora_scale(config))
    return tree


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*prefix, str(k)))
    else:
        yield prefix, tree


def adapter_count(lora: Params) -> int:
    return sum(leaf.numel() for _, leaf in _leaves(lora))


# ---------------------------------------------------------------------------
# Portable adapter files (npz: adapters are small; they travel without the
# base checkpoint)
# ---------------------------------------------------------------------------

def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    # numpy has no bfloat16: widen to float32, which holds every bf16 value
    # exactly (the merge computes its product in float32 either way).
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    if a.dtype.kind == 'V' and a.dtype.itemsize == 2:
        # bfloat16 leaves written by the JAX package load as 2-byte voids.
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def save_adapters(path, lora: Params, scale: float | None = None) -> None:
    """``scale`` (= alpha / rank at training time) makes the file
    self-contained: consumers (``serve.TTSServer.load_voice``) merge without
    the training config."""
    flat = {'/'.join(p): _to_numpy(leaf) for p, leaf in _leaves(lora)}
    if scale is not None:
        flat[_SCALE_KEY] = np.float64(scale)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)


def load_adapters(path) -> Params:
    return load_adapters_with_scale(path)[0]


def load_adapters_with_scale(path) -> tuple[Params, float | None]:
    """(adapter tree of CPU tensors, the embedded scale or None)."""
    tree: Params = {}
    scale = None
    with np.load(Path(path)) as z:
        for joined in z.files:
            if joined == _SCALE_KEY:
                scale = float(z[joined])
                continue
            node = tree
            *parents, leaf = joined.split('/')
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = _from_numpy(z[joined])
    return tree, scale
