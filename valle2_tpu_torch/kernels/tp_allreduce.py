"""The tensor-parallel all-reduce (5c): the CUDA kernel and its plain version.

Replaces ``_ring_allreduce`` of ``valle2_tpu/kernels/fused_decode.py``, the
in-kernel all-reduce over the 'model' ring that completes the two
row-parallel partials of every layer in the TP fused decode and verify
steps: rank r's result is the sum over s = 0..mp-1 of rank s's float32
partial, in rank order, ``((0 + p_0) + p_1) + ...``, so every rank holds the
same bits.  On Hopper every rank's kernel reads the mp partials directly (its
own locally, its peers' over NVLink through peer pointers): an H100 host's
NVSwitch puts every peer one hop away, where the TPU torus needed a ring.
The kernel is ``tp_allreduce_kernel`` of ``csrc/fused_decode.cu`` (see the
header there for the ordering protocol), on the element function
``reduce_element`` of ``csrc/fused_decode.cuh``; ``tp_allreduce`` here
launches it alone, for the prefill's and the NAR's row-parallel sums.  The
fused TP steps do not launch it: the persistent TP step (``fused_step_tp``)
runs the same element function, with the bias and the residual fused in, in
two reduce phases a layer inside its one launch per card, and only its
phased twin (``fused_step_tp_phased``) launches this kernel between its
layers.  It takes the plain version only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

COUNTER = _build.LaunchCounter()
MAX_MP = 8                      # ranks one launch takes (csrc/fused_decode.cu MAX_MP)
_peers_enabled: set[tuple[int, int]] = set()


def tp_allreduce_plain(partials: list[torch.Tensor]) -> list[torch.Tensor]:
    """The rank-ordered float32 sum of the partials, one result per rank on
    that rank's device."""
    acc = torch.zeros(partials[0].shape, dtype=torch.float32, device=partials[0].device)
    for p in partials:
        acc = acc + p.to(acc.device, torch.float32)
    return [acc.to(p.device) for p in partials]


def _card(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def ensure_peer_access(devices) -> None:
    """Enable peer access between every pair of the cards in ``devices``, so
    that a rank's kernel can read its peers' memory.  Raises naming the first
    pair that cannot reach each other; nothing falls back."""
    cards = sorted({_card(torch.device(d)) for d in devices})
    for a in cards:
        for b in cards:
            if a == b or (a, b) in _peers_enabled:
                continue
            if not torch.cuda.can_device_access_peer(a, b):
                raise RuntimeError(f'tensor parallelism: cuda:{a} cannot access the memory '
                                   f'of cuda:{b} (no peer access between them)')
            lib = _build.load('fused_decode')
            lib.valle2_tp_enable_peer.argtypes = [ctypes.c_int, ctypes.c_int]
            _build.check(lib.valle2_tp_enable_peer(a, b), f'peer access cuda:{a} -> cuda:{b}')
            _peers_enabled.add((a, b))


def _ptr_array(ptrs) -> ctypes.Array:
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def tp_allreduce(partials: list[torch.Tensor]) -> list[torch.Tensor]:
    """5c: the rank-ordered float32 sum of one (..., d) float32 partial per
    rank, returned to every rank on its device, bit-equal across ranks.  On
    CUDA tensors one host call launches the kernel on every rank's current
    stream, after every rank's partial is written (CUDA events), and makes
    every rank's stream wait for all the reads before it goes on."""
    if all(p.device.type == 'cpu' for p in partials):
        return tp_allreduce_plain(partials)
    mp = len(partials)
    shape = partials[0].shape
    for p in partials:
        if p.device.type != 'cuda' or p.dtype != torch.float32 or p.shape != shape \
                or not p.is_contiguous():
            raise ValueError('tp_allreduce kernel needs one contiguous CUDA float32 partial '
                             f'of one shape per rank; got {tuple(p.shape)} {p.dtype} on '
                             f'{p.device}')
    if not 1 <= mp <= MAX_MP:
        raise ValueError(f'tp_allreduce kernel takes 1 to {MAX_MP} ranks, got {mp}')
    devices = [p.device for p in partials]
    ensure_peer_access(devices)
    outs = [torch.empty_like(p) for p in partials]
    lib = _build.load('fused_decode')
    fn = lib.valle2_tp_allreduce
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, vp, vp, vp, vp, ctypes.c_long]
        fn.restype = ctypes.c_int
    cards = (ctypes.c_int * mp)(*(_card(d) for d in devices))
    streams = [torch.cuda.current_stream(d).cuda_stream for d in devices]
    status = fn(mp, _ptr_array([p.data_ptr() for p in partials]),
                _ptr_array([o.data_ptr() for o in outs]), cards, _ptr_array(streams),
                partials[0].numel())
    _build.check(status, 'tp_allreduce')
    COUNTER.count += 1
    return outs
