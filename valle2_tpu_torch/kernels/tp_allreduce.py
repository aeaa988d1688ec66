"""The tensor-parallel all-reduce (5c): the CUDA kernel and its plain version.

Replaces ``_ring_allreduce`` of ``valle2_tpu/kernels/fused_decode.py``, the
in-kernel all-reduce over the 'model' ring that completes the two
row-parallel partials of every layer in the TP fused decode and verify
steps: rank r's result is the sum over s = 0..mp-1 of rank s's float32
partial, in rank order, ``((0 + p_0) + p_1) + ...``, so every rank holds the
same bits.  On Hopper every rank's kernel reads the mp partials directly (its
own locally, its peers' over NVLink through peer pointers): an H100 host's
NVSwitch puts every peer one hop away, where the TPU torus needed a ring.
``tp_row_reduce`` here is 5c alone, the prefill's and the NAR's
row-parallel sums, with the row-parallel epilogue inside: rank r gets
round(x_r + round(s + b_r)), the bias b_r added once after the sum, then
the caller's residual x_r (``linear_row_parallel``'s ``residual=``).  It is
ONE launch a card a sum (``tp_row_reduce_kernel`` of ``csrc/fused_decode.cu``,
which holds every virtual rank of its card), partials read once with
16-byte loads through L2; on one card its stream orders it and the call
makes no event or device call (``ordering_calls``); across cards flags in
peer memory inside a cooperative launch a card keep a partial from being
read before it is written or freed before it is read (see the source).
``tp_allreduce`` is the bare sum (float32, no bias or residual).  The
fused TP steps do not launch it: the
persistent TP step (``fused_step_tp``) runs 5c's element function
(``reduce_element``, ``csrc/fused_decode.cuh``) in two reduce phases a
layer inside its one launch per card, and only its phased twin
(``fused_step_tp_phased``) launches that element as ``tp_allreduce_kernel``
between its layers.  The wrappers take the plain version only for tensors
on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

COUNTER = _build.LaunchCounter()   # 5c launches: one a card a sum
MAX_MP = 8                      # ranks one launch takes (csrc/fused_decode.cu MAX_MP)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_peers_enabled: set[tuple[int, int]] = set()


def tp_allreduce_plain(partials: list[torch.Tensor]) -> list[torch.Tensor]:
    """The rank-ordered float32 sum of the partials, one result per rank on
    that rank's device."""
    acc = torch.zeros(partials[0].shape, dtype=torch.float32, device=partials[0].device)
    for p in partials:
        acc = acc + p.to(acc.device, torch.float32)
    return [acc.to(p.device) for p in partials]


def tp_row_reduce_plain(partials: list[torch.Tensor], biases=None, residuals=None,
                        dtype=torch.float32) -> list[torch.Tensor]:
    """The plain composition 5c's epilogue is held to: the rank-ordered sum,
    then per rank ``(y + b).to(dtype)`` (``linear_row_parallel``) and the
    caller's ``x + o``; a missing bias or residual is skipped."""
    out = []
    for r, y in enumerate(tp_allreduce_plain(partials)):
        if biases is not None and biases[r] is not None:
            y = y + biases[r]
        y = y.to(dtype)
        if residuals is not None and residuals[r] is not None:
            y = residuals[r] + y
        out.append(y)
    return out


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


def _lib():
    lib = _build.load('fused_decode')
    fn = lib.valle2_tp_row_reduce
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, ci, ci, vp, vp, vp, vp, vp, vp, ctypes.c_long, ci]
        fn.restype = ctypes.c_int
        lib.valle2_tp_row_reduce_ordering_calls.restype = ctypes.c_long
    return lib


def ordering_calls() -> int:
    """The ordering calls (cudaSetDevice; it makes no event call) 5c alone
    has made in this process."""
    return int(_lib().valle2_tp_row_reduce_ordering_calls())


def _ptrs(name: str, ts, devices, shape, dtypes) -> list:
    """The device pointers of one optional tensor per rank (None: null),
    each checked to be contiguous, of ``shape`` and a dtype of ``dtypes``,
    on its rank's device."""
    if ts is None:
        return [None] * len(devices)
    if len(ts) != len(devices):
        raise ValueError(f'tp_row_reduce: {len(ts)} {name} for {len(devices)} ranks')
    out = []
    for t, dev in zip(ts, devices):
        if t is None:
            out.append(None)
            continue
        if t.device != dev or t.dtype not in dtypes or t.shape != shape \
                or not t.is_contiguous():
            raise ValueError(f'tp_row_reduce kernel: each rank\'s {name} must be a contiguous '
                             f'{" or ".join(map(str, dtypes))} tensor of shape {tuple(shape)} '
                             f'on its rank\'s device; got {tuple(t.shape)} {t.dtype} on '
                             f'{t.device}')
        out.append(t.data_ptr())
    return out


class _Mesh:
    """What 5c needs of one tuple of rank devices, made once (the peer
    check with it): the cards as a ctypes array, the ranks of each card
    (card order of first appearance), each card's device."""

    def __init__(self, devices):
        cards = [_card(d) for d in devices]
        ensure_peer_access(devices)
        self.cards = (ctypes.c_int * len(cards))(*cards)
        self.groups: dict[int, list[int]] = {}
        for r, c in enumerate(cards):
            self.groups.setdefault(c, []).append(r)
        self.devices = {c: devices[ranks[0]] for c, ranks in self.groups.items()}


_meshes: dict[tuple, _Mesh] = {}


def tp_row_reduce(partials: list[torch.Tensor], biases=None, residuals=None,
                  dtype=torch.float32) -> list[torch.Tensor]:
    """5c with the row-parallel epilogue: rank r's (..., d) output, of
    ``dtype``, is round(x_r + round(s + b_r)), s the rank-ordered float32
    sum of the ranks' (..., d) float32 partials, b_r = ``biases[r]`` (d,)
    and x_r = ``residuals[r]`` (of ``dtype``; either list, or an entry,
    None to skip it), on rank r's device, bit-equal to
    ``tp_row_reduce_plain``.  On CUDA tensors: one launch a card on its
    current stream, holding that card's ranks; across cards ordered by flags
    in peer memory."""
    p0 = partials[0]
    if p0.device.type == 'cpu' and all(p.device.type == 'cpu' for p in partials):
        return tp_row_reduce_plain(partials, biases, residuals, dtype)
    mp = len(partials)
    shape = p0.shape
    for p in partials:
        if p.device.type != 'cuda' or p.dtype != torch.float32 or p.shape != shape \
                or not p.is_contiguous():
            raise ValueError('tp_allreduce kernel needs one contiguous CUDA float32 partial '
                             f'of one shape per rank; got {tuple(p.shape)} {p.dtype} on '
                             f'{p.device}')
    if not 1 <= mp <= MAX_MP:
        raise ValueError(f'tp_allreduce kernel takes 1 to {MAX_MP} ranks, got {mp}')
    if dtype not in _DTYPES:
        raise ValueError(f'tp_row_reduce kernel writes float32 or bfloat16, not {dtype}')
    devices = tuple(p.device for p in partials)
    mesh = _meshes.get(devices)
    if mesh is None:
        mesh = _meshes[devices] = _Mesh(devices)
    d = shape[-1] if len(shape) else 1
    bias_dtype = torch.float32
    if biases is not None:
        found = {b.dtype for b in biases if b is not None}
        if len(found) > 1:
            raise ValueError(f'tp_row_reduce kernel: the ranks\' biases differ in dtype {found}')
        bias_dtype = found.pop() if found else bias_dtype
    b_ptrs = _ptrs('bias', biases, devices, (d,), _DTYPES)
    x_ptrs = _ptrs('residual', residuals, devices, shape, (dtype,))
    outs: list = [None] * mp
    streams: list = [None] * mp
    for card, ranks in mesh.groups.items():   # one allocation a card for its ranks' outputs
        dev = mesh.devices[card]
        block = (torch.empty(shape, dtype=dtype, device=dev),) if len(ranks) == 1 else \
            torch.empty((len(ranks), *shape), dtype=dtype, device=dev).unbind(0)
        stream = torch._C._cuda_getCurrentRawStream(card)   # the card's current stream
        for r, o in zip(ranks, block):
            outs[r] = o
            streams[r] = stream
    ptrs = ctypes.c_void_p * mp
    status = _lib().valle2_tp_row_reduce(
        _DTYPES[dtype], _DTYPES[bias_dtype], mp, ptrs(*[p.data_ptr() for p in partials]),
        ptrs(*[o.data_ptr() for o in outs]), ptrs(*b_ptrs), ptrs(*x_ptrs), mesh.cards,
        ptrs(*streams), p0.numel(), d)
    _build.check(status, 'tp_row_reduce')
    COUNTER.count += len(mesh.groups)
    return outs


def tp_allreduce(partials: list[torch.Tensor]) -> list[torch.Tensor]:
    """5c's bare sum: the rank-ordered float32 sum of one (..., d) float32
    partial per rank, returned to every rank on its device, bit-equal across
    ranks (``tp_row_reduce`` with no bias or residual)."""
    return tp_row_reduce(partials)
