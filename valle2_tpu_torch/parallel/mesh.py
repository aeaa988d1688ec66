"""Tensor-parallel serving on a ('model',) mesh (``valle2_tpu/parallel/mesh.py``).

One process drives every rank, as JAX's single controller drives a
``jax.shard_map``: a ``Mesh`` is a list of devices along the axis 'model', and
each rank holds a Megatron split of the transformer stack
(``shard_decode_params``): the fused qkv and FFN lin1 split by output columns
(the qkv columns first regrouped rank-major, ``tp_permute_qkv``), the
attention output and FFN lin2 split by input rows, everything else
replicated.  A rank runs its local heads and its slice of the FFN, and the
two row-parallel partials per layer are summed over the ranks
(``kernels.tp_allreduce``).

Virtual ranks (several ranks on one device, ``devices=['cpu'] * mp`` or
``['cuda:0'] * mp``) run only where the caller lists them; ``make_model_mesh``
otherwise takes the first mp cards.  The data axis, the GSPMD fallback for
splits that do not divide, and the training meshes (DP, ZeRO-1, SP, PP, CP)
are not ported (ROADMAP.md queue 1 item 14).
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch

Params = dict[str, Any]

ITEM14 = 'ROADMAP.md queue 1 item 14'


class Mesh:
    """The devices of a ('model',) mesh, rank r on ``devices[r]``, with one
    CUDA stream per rank (made at first use) for the phased twin of the
    fused TP steps (the persistent TP step runs one launch per card on that
    card's current stream, and uses none)."""

    axis_names = ('model',)

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError('a mesh needs at least one device')
        self.shape = {'model': len(self.devices)}
        self._streams = None

    @property
    def size(self) -> int:
        return len(self.devices)

    def streams(self) -> list:
        """One ``torch.cuda.Stream`` per rank, on the rank's card (virtual
        ranks on one card get a stream each, so the ranks' work runs under
        the cross-rank ordering of the phased TP step,
        ``kernels.fused_decode.fused_step_tp_phased``, not in issue order)."""
        if self._streams is None:
            self._streams = [torch.cuda.Stream(device=d) for d in self.devices]
        return self._streams

    def __repr__(self) -> str:
        return f"Mesh(model={self.size}, devices={[str(d) for d in self.devices]})"


def make_model_mesh(mp: int, devices=None) -> Mesh:
    """A ('model',) mesh of ``mp`` ranks over the first mp of ``devices``
    (default: every CUDA card).  Raises when fewer exist, as the JAX helper
    does; virtual ranks only where the caller lists a device more than once."""
    if devices is None:
        devices = [torch.device('cuda', i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if mp < 1 or mp > len(devices):
        raise ValueError(f'model mesh size {mp} needs {mp} devices, have {len(devices)}')
    return Mesh(devices[:mp])


def make_mesh(data: int | None = None, model: int = 1, devices=None):
    """The JAX package's ('data', 'model') mesh: only the pure model axis is
    ported (``make_model_mesh``)."""
    if data not in (None, 1):
        raise NotImplementedError(f'a data axis is not ported ({ITEM14}); use '
                                  'make_model_mesh for tensor-parallel serving')
    return make_model_mesh(model, devices)


def training_mesh(*_args, **_kwargs):
    """The training meshes (DP, ZeRO-1, SP, PP, CP) are not ported."""
    raise NotImplementedError(f'training meshes (DP, ZeRO-1, SP, PP, CP) are not ported '
                              f'({ITEM14})')


def tp_divisible(n_heads: int, d_ff: int, mp: int) -> bool:
    """Whether heads and the FFN width split evenly over ``mp`` ranks."""
    return mp > 0 and n_heads % mp == 0 and d_ff % mp == 0


def tp_permute_qkv(tparams: Params, mp: int) -> Params:
    """Regroup the fused-qkv output columns [q | k | v] rank-major, [q_0 k_0
    v_0 | q_1 k_1 v_1 | ...], so that rank r's contiguous 1/mp column slice is
    its local fused qkv (heads [r h/mp, (r+1) h/mp)); the int8 'q' / 'scale'
    and int4 'q4' / 'scale4' leaves follow the same column order (int4 packs
    input rows, so its columns regroup like the dense ones).  Returns a new
    tree; every other leaf is shared."""
    def perm_w(w):                        # (L, k, 3d) -> columns regrouped
        L, k, three_d = w.shape
        d = three_d // 3
        return w.reshape(L, k, 3, mp, d // mp).transpose(2, 3).reshape(L, k, three_d)

    def perm_vec(v):                      # (L, 3d) per-column scale
        L, three_d = v.shape
        d = three_d // 3
        return v.reshape(L, 3, mp, d // mp).transpose(1, 2).reshape(L, three_d)

    qkv = dict(tparams['attn']['qkv'])
    for key in ('w', 'q', 'q4', 'scale4'):
        if key in qkv:
            qkv[key] = perm_w(qkv[key])
    if 'scale' in qkv:
        qkv['scale'] = perm_vec(qkv['scale'])
    return {**tparams, 'attn': {**tparams['attn'], 'qkv': qkv}}


# The Megatron rule of the JAX package's tp_decode_specs, by the leaf's path.
_COLUMN = ('qkv/w', 'qkv/q', 'qkv/q4', 'qkv/scale', 'qkv/scale4', 'lin1/w', 'lin1/q',
           'lin1/q4', 'lin1/scale', 'lin1/scale4', 'lin1/b')
_ROW = ('out/w', 'out/q', 'out/q4', 'out/scale4', 'lin2/w', 'lin2/q', 'lin2/q4',
        'lin2/scale4')


def shard_decode_params(params: Params, mp: int) -> list[Params]:
    """Rank r's tree of a (qkv-permuted, ``tp_permute_qkv``) stack or model:
    qkv and lin1 (their scales and lin1's bias too) cut to the r-th 1/mp of
    their last axis, out and lin2 (and their int4 group scales) to the r-th
    1/mp of their input rows (axis -2), everything else shared.  The int4
    row split needs the ranked packing (``quantize_linear_int4_ranked``)."""
    def cut(a, axis, r):
        n = a.shape[axis] // mp
        return a.narrow(axis, r * n, n).contiguous()

    def rank_tree(tree, r, path=''):
        if isinstance(tree, dict):
            return {k: rank_tree(v, r, f'{path}/{k}') for k, v in tree.items()}
        if path.endswith(_COLUMN):
            return cut(tree, -1, r)
        if path.endswith(_ROW):
            return cut(tree, -2, r)
        return tree
    return [rank_tree(params, r) for r in range(mp)]


def shard_stack(stack: Params, mesh: Mesh, dtype, int4: bool = False) -> list[Params]:
    """The ranks' trees of a float transformer stack on ``mesh``: the qkv
    columns regrouped rank-major, the Megatron split, float leaves in
    ``dtype``, contiguous, each tree on its rank's device.  ``int4``:
    quantized first, with the ranked packing of the row-parallel linears
    (JAX ``ValleAR._tp_params``)."""
    from ..ops.transformer import map_tree
    from ..quantize import quantize_transformer
    mp = mesh.size
    if int4:
        stack = quantize_transformer(stack, bits=4, tp_mp=mp)
    trees = shard_decode_params(tp_permute_qkv(stack, mp), mp)

    def place(a, dev):
        return (a.to(dtype) if a.is_floating_point() else a).to(dev).contiguous()
    return [map_tree(lambda a, dev=dev: place(a, dev), tree)
            for tree, dev in zip(trees, mesh.devices)]


def on_device(device):
    """The context in which a rank's kernels launch: its card made current
    (a ctypes launcher takes the current device's streams), nothing on the CPU."""
    device = torch.device(device)
    if device.type == 'cuda':
        return torch.cuda.device(device)
    return contextlib.nullcontext()
