"""Fused AR decode step (#6) and speculative verify step (#7): the CUDA
kernels and their plain versions.

Replace the Pallas TPU kernels of ``valle2_tpu/kernels/fused_decode.py``:
``fused_decode_step`` → ``_kernel`` with one scalar write index or a (rows,)
vector of per-row indices (continuous batching: rows at their own depths),
and ``fused_verify_step`` → ``_verify_kernel``, a block of K query tokens per
row written from each row's own start slot (the per-row write of
``_write_rows_per_slot``), both in every weight and cache format the serving
path uses: dense weights (#6), int8 W8A8 and int4 W4A16 weights (the ``'q'``
/ ``'q4'`` layouts of ``quantize.py``), and a float32, bfloat16 or int8 cache
(#6a).  Both also run tensor-parallel over a ('model',) mesh (their ``tp``
argument, ``fused_step_tp``: each rank's local heads, the two row-parallel
partials of every layer summed by the all-reduce 5c of
``kernels.tp_allreduce``; dense and int4 weights, as in JAX).  The kernels
are ``csrc/fused_step.cu`` (the persistent #6, #7 and TP step, one build per
weight format) and ``csrc/fused_decode.cu`` (the phased route; see its
header for the design and the TP protocol), on the device code of
``csrc/fused_decode.cuh``.  On one card #6 and #7 are each ONE cooperative
launch a step (the persistent step: every block walks the layers, a
grid-wide barrier between the phases; ``persistent_plan`` says what it
does).  Under TP each card runs ONE cooperative launch a step holding its
ranks, 5c folded in as two reduce phases a layer (``tp_persistent_plan``).
``fused_verify_step_phased`` and ``fused_step_tp_phased``, the phased twins,
launch one kernel per phase: the persistent steps run their device code on
every item, so each is bit-equal to its twin (#6 at a block of one token).
They are the references of tests and ``chip_smoke.py``; no serving path
calls them.

Both versions take the cache in the fused head-major layout (L, rows, S, d)
(``fused_cache_layout``), an int8 cache with its per-(slot, head) bfloat16
scales (L, rows, S, h), and update it IN PLACE: the new tokens' k/v go into
their slots of every layer (the JAX versions return new k/v for the caller to
write; the resulting cache is the same).  The plain versions are
``ops.transformer.transformer_decode_step`` over the per-head view of that
cache, with the three-range slot mask of ``ar.py:612-615, 647`` in its
per-query form of ``ar.py:759-762`` (``verify_slot_mask``).  The wrappers
take the plain versions only for tensors on the CPU.  ``fit_error`` says
which stacks the kernels take; the config's 'auto' route asks it before any
launch.

The chunked cache (the chunk branch of the same Pallas calls): ``chunk_for``
picks a chunk of the cache's S slots as the JAX package does (whole-S unless
the k+v block of the TPU kernel would pass ``BLOCK_BYTES_CAP``, or a forced
chunk, ``decode_chunk`` / ``VALLE2_FUSED_CHUNK``), and S must be a multiple
of it (``padded_cache_len`` gives the prefill's length).  Below S, the plain
versions run the attention as an online softmax over the chunks in slot
order (``ops.attention.sdpa_chunked``) and the kernels split the cache over
thread blocks, one partial softmax per chunk, merged by a second kernel.
"""

from __future__ import annotations

import ctypes
import math
import os
import threading

import torch

from ..ops.transformer import KVCache, transformer_decode_step, transformer_decode_step_tp
from . import _build
from .tp_allreduce import MAX_MP, ensure_peer_access, tp_allreduce_plain

# Launch counts per variant: weight format, then '_kv8' for an int8 cache.
VARIANTS = ('dense', 'w8a8', 'w4a16', 'kv8', 'w8a8_kv8', 'w4a16_kv8')
COUNTERS = {v: _build.LaunchCounter() for v in VARIANTS}
COUNTER = COUNTERS['dense']    # the base variant (#6): dense weights, float cache
VERIFY_COUNTERS = {v: _build.LaunchCounter() for v in VARIANTS}    # #7
# Launches of the phased twin (fused_verify_step_phased, every variant).
PHASED_COUNTER = _build.LaunchCounter()
# Launches that split the attention over the cache's chunks (every variant),
# and calls of the plain versions (any device).
CHUNKED_COUNTERS = {k: _build.LaunchCounter(launches=False)
                    for k in ('fused_decode_step', 'fused_verify_step')}
# #6 launches with a per-row index (every variant), and those of them that
# split the attention over the cache's chunks.
PER_ROW_COUNTERS = {k: _build.LaunchCounter(launches=False)
                    for k in ('fused_decode_step_per_row', 'fused_decode_step_per_row_chunked')}
PLAIN_CALLS = _build.LaunchCounter(launches=False)
# Launches of the tensor-parallel steps (one host call for every rank: one
# cooperative launch a card), and of their phased twin (fused_step_tp_phased).
TP_COUNTERS = {k: _build.LaunchCounter() for k in ('fused_decode_step_tp',
                                                    'fused_verify_step_tp')}
TP_PHASED_COUNTER = _build.LaunchCounter()
# One TP launch at a time in the process, whichever build or route: each
# card's launches then queue in one order on every card, so no card's step
# waits at a barrier across cards for a peer's launch queued behind another.
_TP_LOCK = threading.Lock()
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_WEIGHT_FORMATS = {'w': (0, 'dense'), 'q': (1, 'w8a8'), 'q4': (2, 'w4a16')}
# config.weight_dtype -> the layout quantize.py gives the stack
LAYOUT_OF_WEIGHT_DTYPE = {'compute': 'w', 'int8': 'q', 'int4': 'q4'}
HEAD_DIMS = (32, 64, 96, 128)
# Widest projection input: a tile of 8 rows of it (f32, and int8 codes for
# W8A8) in shared memory (csrc/fused_decode.cu max_k8).
_MAX_K = {0: 6144, 1: 5120, 2: 6144}


# The persistent #6 and #7: one block shape for every phase, its
# projections' tiles and its phases a layer (csrc/fused_decode.cuh PNT, NCOL,
# KSPLIT, ANW, max_k16, STEP_PHASES, STEP_PHASES_KVQ).
PERSISTENT_THREADS = 512
_NCOL, _KSPLIT, _ANW = 32, 16, 16
STEP_PHASES = ('qkv', 'attention', 'out', 'ffn1', 'ffn2')
# #7 with an int8 cache: the cache write as a phase of its own
STEP_PHASES_KVQ = ('qkv', 'kv_quant', 'attention', 'out', 'ffn1', 'ffn2')
# The TP step (csrc/fused_decode.cuh STEP_PHASES_TP, _KVQ): OUT and FFN2
# write raw partials, each followed by a barrier across ranks and a reduce
# phase (5c's element) that adds every rank's partial in rank order.
STEP_PHASES_TP = ('qkv', 'attention', 'out', 'reduce_out', 'ffn1', 'ffn2', 'reduce_ffn2')
STEP_PHASES_TP_KVQ = ('qkv', 'kv_quant', 'attention', 'out', 'reduce_out', 'ffn1', 'ffn2',
                      'reduce_ffn2')
_MAX_K16 = {0: 3072, 1: 2048, 2: 3072}
SMEM_OPT_IN = 232448     # the shared memory an H100 block can opt into


def proj_tile_rows(K: int, layout: str) -> int:
    """The rows of a projection tile over a K-wide input: 16 where they fit
    shared memory, else 8 (``launch_proj``, ``run_proj``)."""
    return 16 if K <= _MAX_K16[_WEIGHT_FORMATS[layout][0]] else 8


def proj_smem_bytes(K: int, layout: str) -> int:
    """Shared memory of one projection tile (``proj_smem``): the tile's rows
    of the operand in f32, the K slices' partials, and for W8A8 the rows'
    scales and int8 codes."""
    mr = proj_tile_rows(K, layout)
    n = 4 * (mr * K + _KSPLIT * mr * _NCOL)
    return n + 4 * mr + mr * K if layout == 'q' else n


def persistent_plan(L: int, rows: int, d: int, dff: int, n_heads: int, S: int, chunk: int,
                    layout: str = 'w', q_len: int = 1, kv8: bool = False) -> dict:
    """What one launch of the persistent step does (``step_persistent_kernel``):
    #6 (``q_len`` 1) or #7 (a block of ``q_len`` tokens a row, rows * q_len
    query rows), over an int8 cache with ``kv8``.  Per layer, the tiles of
    each projection ((row tile, 32-column tile) of the query rows, 16 K
    slices each; ``proj_tile_rows``), the attention items (query row, head
    and, below S, chunk) and, for #7 over an int8 cache, the cache write's
    warps (query row, head, k|v; 16 a block); the phases of a layer
    (``STEP_PHASES``, or ``STEP_PHASES_KVQ`` for #7 over an int8 cache) and
    the grid-wide barriers of the step (one after each phase, less the
    last: 5 L - 1, or 6 L - 1); its dynamic shared memory a block, the
    largest of the projections' tiles and the attention's item, whatever
    ``q_len`` (the launcher sizes the grid by it: SM count x the blocks an
    SM holds).  An ``attention`` item takes a block's 16 warps."""
    if d % n_heads:
        raise ValueError(f'd={d} does not split over {n_heads} heads')
    if q_len < 1:
        raise ValueError(f'a block of {q_len} tokens')
    hd = d // n_heads
    n_chunks = S // chunk if chunk < S else 1
    query_rows = rows * q_len
    phases = STEP_PHASES_KVQ if kv8 and q_len > 1 else STEP_PHASES

    def tiles(K, N):
        mr = proj_tile_rows(K, layout)
        return -(-N // _NCOL) * -(-query_rows // mr)

    smem = max(proj_smem_bytes(d, layout), proj_smem_bytes(dff, layout),
               4 * (2 * _ANW + _ANW * hd))
    if smem > SMEM_OPT_IN:
        raise ValueError(f'the persistent step needs {smem} bytes of shared memory a block, '
                         f'over the {SMEM_OPT_IN} a block can take')
    items = {'qkv': tiles(d, 3 * d), 'attention': query_rows * n_heads * n_chunks,
             'out': tiles(d, d), 'ffn1': tiles(d, dff), 'ffn2': tiles(dff, d)}
    if 'kv_quant' in phases:
        items['kv_quant'] = query_rows * 2 * n_heads
    return dict(items=items, phases=phases, barriers=len(phases) * L - 1, smem_bytes=smem,
                threads=PERSISTENT_THREADS, launches=1)


def tp_card_groups(devices) -> list[list[int]]:
    """The ranks of each TP launch: the mesh's ranks grouped by device in
    the order each device first appears, each group in rank order
    (``Groups`` in csrc/fused_step.cu): ['cuda:0'] * mp is one group of all
    mp ranks, four cards four groups of one rank, ['cuda:0', 'cuda:0',
    'cuda:1', 'cuda:1'] [[0, 1], [2, 3]]."""
    groups: dict = {}
    for r, dev in enumerate(devices):
        dev = torch.device(dev)
        groups.setdefault((dev.type, dev.index), []).append(r)
    return list(groups.values())


def tp_persistent_plan(L: int, rows: int, d: int, dff: int, n_heads: int, S: int, chunk: int,
                       layout: str = 'w', q_len: int = 1, kv8: bool = False,
                       devices=('cuda:0',) * 2) -> dict:
    """What one TP step does (``step_tp_persistent_kernel``) for a stack of
    model widths d, n_heads, dff split over the ranks of ``devices`` (mp =
    len(devices); rank r on devices[r]): one cooperative launch per card
    group (``tp_card_groups``), each walking its ranks' items rank-major;
    per layer the phases ``STEP_PHASES_TP`` (``STEP_PHASES_TP_KVQ`` for #7,
    q_len > 1, over an int8 cache), a grid barrier after each but the last
    (``barriers``), of which 2 a layer are barriers across ranks
    (``rank_barriers``: on one card a grid barrier, across cards also a wait
    for every other card's flag and a second grid barrier, ``grid_syncs``).
    ``launches``: one a card group; ``per_launch``: per group its device,
    its ranks and its items a layer (the projections' tiles, the attention
    items, the int8 cache write's warps, the reduce phases' elements);
    ``smem_bytes`` of a block, the largest of the rank's projections
    (inputs d, d / mp, dff / mp) and its attention item."""
    mp = len(devices)
    if n_heads % mp or dff % mp:
        raise ValueError(f'{n_heads} heads and dff {dff} must split over {mp} ranks')
    da, h, dff_r = d // mp, n_heads // mp, dff // mp
    if d % n_heads:
        raise ValueError(f'd={d} does not split over {n_heads} heads')
    if q_len < 1:
        raise ValueError(f'a block of {q_len} tokens')
    hd = d // n_heads
    n_chunks = S // chunk if chunk < S else 1
    query_rows = rows * q_len
    phases = STEP_PHASES_TP_KVQ if kv8 and q_len > 1 else STEP_PHASES_TP

    def tiles(K, N):
        return -(-N // _NCOL) * -(-query_rows // proj_tile_rows(K, layout))

    smem = max(proj_smem_bytes(d, layout), proj_smem_bytes(da, layout),
               proj_smem_bytes(dff_r, layout), 4 * (2 * _ANW + _ANW * hd))
    if smem > SMEM_OPT_IN:
        raise ValueError(f'the persistent TP step needs {smem} bytes of shared memory a '
                         f'block, over the {SMEM_OPT_IN} a block can take')
    rank = {'qkv': tiles(d, 3 * da), 'attention': query_rows * h * n_chunks,
            'out': tiles(da, d), 'reduce_out': query_rows * d, 'ffn1': tiles(d, dff_r),
            'ffn2': tiles(dff_r, d), 'reduce_ffn2': query_rows * d}
    if 'kv_quant' in phases:
        rank['kv_quant'] = query_rows * 2 * h
    groups = tp_card_groups(devices)
    launches = [dict(device=str(torch.device(devices[g[0]])), ranks=g,
                     items={k: len(g) * n for k, n in rank.items()}) for g in groups]
    barriers = len(phases) * L - 1
    return dict(phases=phases, barriers=barriers, rank_barriers=2 * L,
                grid_syncs=barriers + (2 * L if len(groups) > 1 else 0), groups=groups,
                launches=len(groups), per_launch=launches, smem_bytes=smem,
                threads=PERSISTENT_THREADS)


def step_grid(dtype, cache_dtype, layout: str, hd: int, d: int, dff: int,
              da: int | None = None) -> tuple[int, int]:
    """(blocks, shared bytes a block) of the persistent launch (#6, or #7 at
    any block length) on the current card for a stack of these formats and
    widths (the launcher's own sizing, ``valle2_fused_step_grid``), or with
    ``da`` (d / mp) that of the TP step for a rank of attention width da and
    FFN width dff (``valle2_fused_step_tp_grid``); raises where the launch
    would fail: a card with no cooperative launch, or no block that fits."""
    ci = ctypes.c_int
    out = [ctypes.POINTER(ci), ctypes.POINTER(ctypes.c_long)]
    if da is None:
        fn, widths = _build.load(_step_build(layout)).valle2_fused_step_grid, (d, dff)
    else:
        fn, widths = _build.load(_tp_build(layout)).valle2_fused_step_tp_grid, (d, da, dff)
    if fn.argtypes is None:
        fn.argtypes = [ci] * (4 + len(widths)) + out
        fn.restype = ci
    blocks, smem = ctypes.c_int(0), ctypes.c_long(0)
    status = fn(_DTYPE_CODE[dtype], _DTYPE_CODE[cache_dtype], _WEIGHT_FORMATS[layout][0], hd,
                *widths, ctypes.byref(blocks), ctypes.byref(smem))
    _build.check(status, 'fused_decode_step (persistent grid)')
    return blocks.value, smem.value


def set_step_trace(buf, tp: bool = False) -> None:
    """The next persistent launch (#6 or #7) records its phase timestamps
    into ``buf``, a CUDA int64 tensor of 1 + 2 * P L * blocks elements, P its
    phases a layer (``persistent_plan``'s ``phases``: 5, or 6 for #7 over an
    int8 cache) (``%globaltimer`` ns: [0] the start, then each block's end
    of each of the P L phases, then each block's exit from each phase's
    barrier); None turns the hook off.  ``tp``: the next TP launch instead
    (P 7 or 8, ``tp_persistent_plan``), ``buf`` a tensor or a list of one per
    card group (``tp_card_groups``), each on its group's card.  A
    measurement hook: no path of the port sets it.  Set in the build of
    every weight format."""
    if tp:
        bufs = [] if buf is None else [buf] if torch.is_tensor(buf) else list(buf)
        for layout in TP_LAYOUTS:
            fn = _build.load(_tp_build(layout)).valle2_fused_step_tp_trace
            if fn.argtypes is None:
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
                fn.restype = None
            fn((ctypes.c_void_p * max(len(bufs), 1))(*(b.data_ptr() for b in bufs)), len(bufs))
        return
    for layout in _WEIGHT_FORMATS:
        fn = _build.load(_step_build(layout)).valle2_fused_step_trace
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = None
        fn(None if buf is None else buf.data_ptr())


DEFAULT_CHUNK = 256   # the JAX package's chunk constant (valle2_tpu/kernels/fused_decode.py)
BLOCK_BYTES_CAP = 8 * 1024 * 1024   # the TPU kernel's per-chunk k+v block budget


def env_chunk() -> int | None:
    """``VALLE2_FUSED_CHUNK``: the chunk that overrides every other choice."""
    val = os.environ.get('VALLE2_FUSED_CHUNK')
    return int(val) if val else None


def pick_chunk(seq: int, rows: int, d: int, n_heads: int, cache_itemsize: int, quant: bool,
               forced: int | None = None) -> int:
    """Cache slots per chunk, the JAX package's choice: ``VALLE2_FUSED_CHUNK``,
    else ``forced`` (``config.decode_chunk``) when it is below ``seq``, else
    whole-``seq`` when the k+v block (int8: plus its bf16 scales) of all rows
    fits ``BLOCK_BYTES_CAP``, else the largest multiple of 128 under the cap
    (at least 128).  Callers pad the cache length to a multiple."""
    forced = env_chunk() or forced
    if forced is not None and 0 < forced < seq:
        return forced
    per_slot = rows * 2 * d * cache_itemsize + (rows * 4 * n_heads if quant else 0)
    if seq * per_slot <= BLOCK_BYTES_CAP:
        return seq
    chunk = max(128, (BLOCK_BYTES_CAP // per_slot) // 128 * 128)
    return min(chunk, seq)


def chunk_for(seq: int, rows: int, d: int, n_heads: int, cache_dtype,
              forced: int | None = None) -> int:
    """``pick_chunk`` with the item size from the cache dtype: the one choice
    that the prefill's padding, the plain versions and the kernels share."""
    return pick_chunk(seq, rows, d, n_heads, cache_dtype.itemsize, cache_dtype == torch.int8,
                      forced=forced)


def padded_cache_len(total: int, rows: int, d: int, n_heads: int, cache_dtype,
                     forced: int | None = None) -> int:
    """The cache length the prefill allocates for ``total`` slots: the first
    fixed point of rounding up to ``chunk_for``'s chunk (a forced chunk
    between ``total`` and the padded length applies only to the padded one;
    JAX ``_decode_prefill``)."""
    for _ in range(3):
        chunk = chunk_for(total, rows, d, n_heads, cache_dtype, forced)
        if chunk >= total or total % chunk == 0:
            break
        total = -(-total // chunk) * chunk
    return total


def cache_chunk(cache: KVCache, n_heads: int, chunk_override: int | None,
                name: str = 'fused_decode_step') -> int:
    """The chunk of a fused (L, rows, S, d) cache; S must be a multiple."""
    _, rows, seq, d = cache.k.shape
    chunk = chunk_for(seq, rows, d, n_heads, cache.k.dtype, chunk_override)
    if seq % chunk:
        raise ValueError(f'{name}: cache length {seq} is not a multiple of the chunk '
                         f'{chunk}; pad the cache to a multiple (padded_cache_len, as '
                         'ar._decode_prefill does)')
    return chunk


def fit_error(d: int, n_heads: int, dff: int, layout: str, mp: int = 1) -> str | None:
    """Why the kernels cannot take a stack of these widths in this weight
    layout ('w', 'q' or 'q4'), split over ``mp`` tensor-parallel ranks, or
    None when they can.  A rank's projection inputs are d wide (QKV, FFN1),
    d / mp (the attention output) and dff / mp (FFN2)."""
    if d % n_heads or d // n_heads not in HEAD_DIMS:
        return (f'the fused decode kernels take head dims {HEAD_DIMS}, got d={d}, '
                f'n_heads={n_heads}')
    if mp > 1 and (n_heads % mp or dff % mp or layout == 'q'):
        return (f'the tensor-parallel fused steps take heads and dff that split over {mp} '
                f'ranks and dense or int4 weights (int8 W8A8 would need a global '
                f'activation amax inside the step: the plain TP path takes it), got '
                f'n_heads={n_heads}, dff={dff}, {layout!r} weights')
    wcode = _WEIGHT_FORMATS[layout][0]
    if max(d, dff // mp) > _MAX_K[wcode] or (layout != 'w' and (dff // mp) % 8):
        return (f'the fused decode kernels take widths up to {_MAX_K[wcode]} for '
                f'{layout!r} weights (quantized: dff a multiple of 8), got d={d}, '
                f'dff={dff // mp} per rank')
    return None


def fused_cache_layout(cache: KVCache) -> KVCache:
    """Standard cache (L, rows, h, S, hd) → head-major (L, rows, S, h*hd), and
    int8 scales (L, rows, h, S, 1) → (L, rows, S, h)."""
    def to_rows(a):
        L, r, h, S, hd = a.shape
        return a.permute(0, 1, 3, 2, 4).reshape(L, r, S, h * hd).contiguous()
    if cache.k_scale is None:
        return KVCache(to_rows(cache.k), to_rows(cache.v))
    return KVCache(to_rows(cache.k), to_rows(cache.v),
                   *(s[..., 0].permute(0, 1, 3, 2).contiguous()
                     for s in (cache.k_scale, cache.v_scale)))


def per_head_view(cache: KVCache, n_heads: int) -> KVCache:
    """The inverse of ``fused_cache_layout`` as a VIEW: (L, rows, h, S, hd)
    tensors (and (L, rows, h, S, 1) scales) sharing the fused cache's storage."""
    def view(a):
        L, r, S, d = a.shape
        return a.view(L, r, S, n_heads, d // n_heads).permute(0, 1, 3, 2, 4)
    if cache.k_scale is None:
        return KVCache(view(cache.k), view(cache.v))
    return KVCache(view(cache.k), view(cache.v),
                   *(s.permute(0, 1, 3, 2)[..., None] for s in (cache.k_scale,
                                                                cache.v_scale)))


def quantize_kv_rowmajor(x: torch.Tensor, n_heads: int):
    """Per-(slot, head) symmetric int8 quantization of a head-major (..., d)
    tensor → (int8 (..., d), bfloat16 scales (..., h)): ``quantize_kv`` on
    each head's slice, float32 arithmetic whatever x's dtype."""
    *lead, d = x.shape
    xs = x.reshape(*lead, n_heads, d // n_heads).float()
    scale = xs.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8) / 127.0
    q = torch.round(xs / scale).clamp(-127, 127).to(torch.int8)
    return q.reshape(*lead, d), scale[..., 0].to(torch.bfloat16)


def verify_slot_mask(S: int, index, q_len: int, tokens_lens, codes_lens, ttm: int,
                     pm: int):
    """(rows, q_len, S) bool: the slots query i of a block of q_len tokens
    attends (``ar.py:612-615, 647, 759-762``): the valid source and prompt
    slots, and generated slots up to index + i (a decode token: q_len = 1).
    ``index``: one int or a (rows,) tensor of per-row start slots."""
    dev = tokens_lens.device
    slots = torch.arange(S, device=dev)[None, None, :]
    start = index.long()[:, None, None] if torch.is_tensor(index) else int(index)
    last = start + torch.arange(q_len, device=dev)[None, :, None]
    return ((slots < tokens_lens[:, None, None])
            | ((slots >= ttm) & (slots < ttm + codes_lens[:, None, None]))
            | ((slots >= ttm + pm) & (slots <= last)))


def _step_plain(name: str, p, x, n_heads: int, cache: KVCache, index, tokens_lens,
                codes_lens, ttm: int, pm: int, chunk_override: int | None):
    """The q-block ``transformer_decode_step`` over the per-head view under
    ``verify_slot_mask``; below S, its attention is the online softmax over
    the chunks up to the one that holds the deepest query's own slot (the
    TPU kernels' clamp at max(index) // chunk, and for a verify block the
    block's own slots, which they merge from registers)."""
    PLAIN_CALLS.count += 1
    seq, q_len = cache.k.shape[2], x.shape[1]
    chunk = cache_chunk(cache, n_heads, chunk_override, name)
    attend = verify_slot_mask(seq, index, q_len, tokens_lens, codes_lens, ttm, pm)
    visit = None
    if chunk < seq:
        deepest = int(index.max()) if torch.is_tensor(index) else int(index)
        visit = (chunk, min(deepest + q_len - 1, seq - 1) // chunk + 1)
    y, _ = transformer_decode_step(p, x, n_heads, per_head_view(cache, n_heads), index,
                                   attend_mask=attend, chunks=visit)
    return y, cache


def fused_decode_step_plain(p, x, n_heads: int, cache: KVCache, index, tokens_lens,
                            codes_lens, ttm: int, pm: int, chunk_override: int | None = None):
    """``index``: one int, or a (rows,) tensor of per-row slots; a row at
    slot S writes nothing (as the kernel) and attends up to S - 1."""
    return _step_plain('fused_decode_step', p, x, n_heads, cache, index, tokens_lens,
                       codes_lens, ttm, pm, chunk_override)


def fused_verify_step_plain(p, x, n_heads: int, cache: KVCache, index, tokens_lens,
                            codes_lens, ttm: int, pm: int, chunk_override: int | None = None):
    """Under the speculative mask: row r's block written from its slot
    index[r] (``index + q <= S``), query i attending up to index[r] + i."""
    return _step_plain('fused_verify_step', p, x, n_heads, cache, index, tokens_lens,
                       codes_lens, ttm, pm, chunk_override)


def _step_plain_tp(name: str, trees, xs, n_heads: int, caches, index, tokens_lens,
                   codes_lens, ttm: int, pm: int, chunk_override: int | None):
    """``_step_plain`` over tensor-parallel ranks: each rank's local heads on
    its cache, the row-parallel partials summed by ``tp_allreduce_plain``
    (``transformer_decode_step_tp``)."""
    PLAIN_CALLS.count += 1
    seq, q_len = caches[0].k.shape[2], xs[0].shape[1]
    chunk = cache_chunk(caches[0], n_heads, chunk_override, name)
    attend = verify_slot_mask(seq, index, q_len, tokens_lens, codes_lens, ttm, pm)
    visit = None
    if chunk < seq:
        deepest = int(index.max()) if torch.is_tensor(index) else int(index)
        visit = (chunk, min(deepest + q_len - 1, seq - 1) // chunk + 1)
    ys, _ = transformer_decode_step_tp(trees, xs, n_heads,
                                       [per_head_view(c, n_heads) for c in caches], index,
                                       attend_mask=attend, chunks=visit,
                                       reduce=tp_allreduce_plain)
    return ys, caches


def weight_format(p) -> str:
    """'w' (dense), 'q' (int8 W8A8) or 'q4' (int4 W4A16): the layout of the
    stacked qkv projection, which every linear of the stack shares."""
    fmt = next(k for k in ('w', 'q', 'q4') if k in p['attn']['qkv'])
    for lin in (p['attn']['out'], p['ffn']['lin1'], p['ffn']['lin2']):
        if fmt not in lin:
            raise ValueError('fused_decode_step kernel: every linear of the stack must '
                             f"share the {fmt!r} layout")
    return fmt


def variant(p, cache: KVCache) -> str:
    """The name of the kernel variant that ``p`` and ``cache`` launch."""
    name = _WEIGHT_FORMATS[weight_format(p)][1]
    if cache.k_scale is None:
        return name
    return 'kv8' if name == 'dense' else f'{name}_kv8'


def _step_build(layout: str) -> str:
    """The build of the persistent #6 and #7 for a weight layout
    (csrc/fused_step.cu, one build per format)."""
    return f'fused_step_{_WEIGHT_FORMATS[layout][1]}'


# The weight layouts of the persistent TP step's builds (csrc/fused_step.cu
# with VALLE2_STEP_TP): W8A8 has none.
TP_LAYOUTS = ('w', 'q4')


def _tp_build(layout: str) -> str:
    """The build of the persistent TP step for a weight layout."""
    if layout not in TP_LAYOUTS:
        raise ValueError(f'the tensor-parallel fused steps take dense or int4 weights; '
                         f'{layout!r} (int8 W8A8) has no TP build')
    return f'fused_step_tp_{_WEIGHT_FORMATS[layout][1]}'


# launcher name -> its symbol; the phased twin is in csrc/fused_decode.cu's
# build, the persistent steps in each weight format's csrc/fused_step.cu
_LAUNCHERS = {'fused_decode_step': 'valle2_fused_decode_step',
              'fused_verify_step': 'valle2_fused_verify_step',
              'fused_verify_step_phased': 'valle2_fused_verify_step_phased'}


def _lib(name: str, layout: str = 'w'):
    """The launcher of #6 or #7 (the persistent step of ``layout``'s build)
    or of the phased twin ('fused_verify_step_phased')."""
    build = 'fused_decode' if name == 'fused_verify_step_phased' else _step_build(layout)
    fn = getattr(_build.load(build), _LAUNCHERS[name])
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        # formats; x, y, 11 weights, cache k/v, 4 weight scales, 2 cache scales,
        # lengths, the per-row slots (null: the decode step's scalar index), 6
        # scratch buffers (the last for the chunks' partial softmaxes); 12
        # sizes (the decode step's scalar index or the verify step's block
        # length among them, the chunk last); the q scale and the stream
        fn.argtypes = [ci] * 3 + [vp] * 30 + [ci] * 12 + [ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return fn


def _check(t, shape, dtype, what: str, name: str = 'fused_decode_step'):
    if not torch.is_tensor(t) or t.shape != shape or t.dtype != dtype \
            or not t.is_contiguous() or t.device.type != 'cuda':
        got = f'{tuple(t.shape)} {t.dtype} on {t.device}' if torch.is_tensor(t) else repr(t)
        raise ValueError(f'{name} kernel needs {what} as a contiguous CUDA '
                         f'{tuple(shape)} {dtype} tensor; got {got}')
    return t


def _weights(p, fmt: str, dtype, L: int, d: int, da: int, dff: int
             ) -> tuple[list, list, list]:
    """The stacked weights in the launcher's order, checked for the kernel:
    (norms, biases and weights), (the four weight scales, or none), and the
    int4 group counts of the d-wide, da-wide (the attention output's: d / mp
    under tensor parallelism) and dff-wide inputs."""
    def qshape(k_in, n):              # the weight tensor of a (k_in, n) linear
        return (L, k_in // 2, n) if fmt == 'q4' else (L, k_in, n)
    wdt = dtype if fmt == 'w' else torch.int8
    lins = [(p['attn']['qkv'], d, 3 * da), (p['attn']['out'], da, d),
            (p['ffn']['lin1'], d, dff), (p['ffn']['lin2'], dff, d)]
    qkv, out, lin1, lin2 = (_check(lin[fmt], qshape(k_in, n), wdt, f'the {fmt!r} weight')
                            for lin, k_in, n in lins)
    vec = [(p['norm1']['scale'], d), (p['norm1']['bias'], d), (p['attn']['out']['b'], d),
           (p['norm2']['scale'], d), (p['norm2']['bias'], d), (p['ffn']['lin1']['b'], dff),
           (p['ffn']['lin2']['b'], d)]
    n1s, n1b, bout, n2s, n2b, b1, b2 = (_check(t, (L, n), dtype, 'a norm or bias')
                                        for t, n in vec)
    ws = [n1s, n1b, qkv, out, bout, n2s, n2b, lin1, b1, lin2, b2]
    if fmt == 'w':
        return ws, [None] * 4, [1, 1, 1]
    if fmt == 'q':
        return ws, [_check(lin['scale'], (L, n), dtype, 'a weight scale')
                    for lin, _, n in lins], [1, 1, 1]
    groups = {}
    for k_in in dict.fromkeys((d, da, dff)):
        g = [lin['scale4'].shape[1] for lin, kk, _ in lins if kk == k_in]
        if len(set(g)) != 1 or g[0] % 2 or (k_in // 2) % (g[0] // 2):
            raise ValueError(f'fused_decode_step kernel: int4 group counts {g} of the '
                             f'{k_in}-wide inputs must agree and align with the nibble '
                             'planes (quantize.group4_for)')
        groups[k_in] = g[0]
    scales = [_check(lin['scale4'], (L, groups[kk], n), dtype, 'an int4 group scale')
              for lin, kk, n in lins]
    return ws, scales, [groups[d], groups[da], groups[dff]]


def _checked_launch_args(name: str, p, x, n_heads: int, cache: KVCache, q_len: int,
                         tokens_lens, codes_lens, chunk_override: int | None, mp: int = 1):
    """The checks both wrappers share (on the host, no device sync): formats,
    shapes, widths and the chunk.  ``mp`` > 1: ``p`` and ``cache`` are one
    tensor-parallel rank's, ``n_heads`` its local heads and the cache d / mp
    wide.  Returns (the launcher's leading arguments up to the lengths, its
    scratch buffers, (L, rows, S, d, d_att, dff), the int4 group counts and
    the chunk, the output y and the variant's name)."""
    if x.device.type != 'cuda':
        raise ValueError(f'{name} runs on CPU or CUDA tensors, got {x.device}')
    L, rows, S, da = cache.k.shape
    fmt = weight_format(p)
    wcode, _ = _WEIGHT_FORMATS[fmt]
    dff = p['ffn']['lin1'][fmt].shape[-1]
    d = da * mp
    if x.shape != (rows, q_len, d) or x.dtype not in (torch.float32, torch.bfloat16) \
            or not x.is_contiguous():
        raise ValueError(f'x must be a contiguous ({rows}, {q_len}, {d}) float32/bfloat16 '
                         'tensor')
    quant = cache.k.dtype == torch.int8
    if cache.v.shape != cache.k.shape or cache.k.dtype not in _DTYPE_CODE \
            or cache.v.dtype != cache.k.dtype \
            or not (cache.k.is_contiguous() and cache.v.is_contiguous()):
        raise ValueError('cache k/v must be contiguous (L, rows, S, d) float32, bfloat16 '
                         'or int8 tensors of one dtype')
    if quant:
        scales = [_check(s, (L, rows, S, n_heads), torch.bfloat16, 'an int8 cache scale',
                         name) for s in (cache.k_scale, cache.v_scale)]
    elif cache.k_scale is not None or cache.v_scale is not None:
        raise ValueError('cache scales belong to an int8 cache only')
    else:
        scales = [None, None]
    if x.dtype == torch.bfloat16 and cache.k.dtype == torch.float32:
        raise TypeError(f'{name} kernel: a bfloat16 model needs a bfloat16 cache')
    reason = fit_error(d, n_heads * mp, dff * mp, fmt, mp)
    if reason is not None:
        raise ValueError(f'{name}: {reason}')
    for t in (tokens_lens, codes_lens):
        if t.shape != (rows,) or t.dtype != torch.int32 or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError('tokens_lens / codes_lens must be contiguous (rows,) int32 '
                             'tensors on the device of x')
    chunk = cache_chunk(cache, n_heads, chunk_override, name)
    ws, wscales, groups = _weights(p, fmt, x.dtype, L, d, da, dff)
    y = torch.empty((rows, q_len, d), dtype=x.dtype, device=x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    rq = rows * q_len
    qbuf, abuf = (torch.empty((rq, da), **f32) for _ in range(2))
    xmid = torch.empty((rq, d), **f32)
    hmid = torch.empty((rq, dff), **f32)
    kvnew = torch.empty((rq, 2 * da), **f32) if quant else None
    # Per (query row, head, chunk): the chunk's running max, sum and
    # unnormalized output (head dim) of its online softmax.
    part = (torch.empty((rq * n_heads * (S // chunk), 2 + da // n_heads), **f32)
            if chunk < S else None)

    lead = [_DTYPE_CODE[x.dtype], _DTYPE_CODE[cache.k.dtype], wcode, x.data_ptr(),
            y.data_ptr(), *(w.data_ptr() for w in ws), cache.k.data_ptr(),
            cache.v.data_ptr(), *map(_ptr, wscales), *map(_ptr, scales),
            tokens_lens.data_ptr(), codes_lens.data_ptr()]
    # The scratch goes back as tensors, not pointers: the caller holds them
    # until its launch is queued.  Freed any earlier, their memory could go to
    # a tensor of another thread (a hub join's prefill beside the driver's
    # step) whose kernels are queued first, and the two would write it both.
    scratch = [qbuf, abuf, xmid, hmid, kvnew, part]
    sizes = (L, rows, S, d, da, dff)
    return lead, scratch, sizes, [*groups, chunk], y, variant(p, cache)


def _count(name: str, var: str, sizes, tail, per_row: bool = False) -> None:
    """One launch of a step kernel, and of its split attention below S."""
    (COUNTERS if name == 'fused_decode_step' else VERIFY_COUNTERS)[var].count += 1
    chunked = tail[-1] < sizes[2]
    if chunked:
        CHUNKED_COUNTERS[name].count += 1
    if per_row:
        PER_ROW_COUNTERS['fused_decode_step_per_row'].count += 1
        if chunked:
            PER_ROW_COUNTERS['fused_decode_step_per_row_chunked'].count += 1


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _check_slots(index, rows: int, x, name: str) -> None:
    """A (rows,) int32 tensor of per-row slots on the device of x, checked
    without reading it (no host sync)."""
    _check(index, (rows,), torch.int32, 'the per-row start slots', name)
    if index.device != x.device:
        raise ValueError(f'{name}: the per-row start slots must be on the device of x')


def fused_decode_step(p, x, n_heads: int, cache: KVCache, index, tokens_lens,
                      codes_lens, ttm: int, pm: int, chunk_override: int | None = None,
                      tp: tuple | None = None):
    """One token through the whole stack.  p: stacked layer dict (L, ...),
    dense or in a ``quantize.py`` layout ('q' int8 or 'q4' int4 weights, their
    scales in the compute dtype); x: (rows, 1, d) token embeddings; cache:
    fused (L, rows, S, d) k/v in float32 / bfloat16, or int8 with (L, rows,
    S, h) bfloat16 scales; index: the write slot of every row, ttm + pm <=
    index < S, or a contiguous (rows,) int32 tensor of per-row slots on the
    device of x, which the host never reads (continuous batching): the
    caller keeps ttm + pm <= index[r] <= S, and a row at S (frozen at its
    budget) writes nothing and attends up to S - 1; tokens_lens / codes_lens:
    (rows,) int32 true lengths, tokens_lens <= ttm and codes_lens <= pm;
    chunk_override: the forced chunk (``chunk_for``; None: the automatic
    one).  Returns (y (rows, 1, d), cache) with the cache updated in place.
    ``tp`` = (mesh, rank trees, rank caches): the tensor-parallel step
    (``fused_step_tp``) in place of ``p`` and ``cache``, which are None.
    On one card the kernel is one cooperative launch (the persistent step),
    which raises where the card takes none."""
    if tp is not None:
        return fused_step_tp('fused_decode_step_tp', *tp, x, n_heads, index, tokens_lens,
                             codes_lens, ttm, pm, chunk_override)
    if x.device.type == 'cpu':
        return fused_decode_step_plain(p, x, n_heads, cache, index, tokens_lens,
                                       codes_lens, ttm, pm, chunk_override)
    name = 'fused_decode_step'
    lead, scratch, sizes, tail, y, var = _checked_launch_args(
        name, p, x, n_heads, cache, 1, tokens_lens, codes_lens, chunk_override)
    L, rows, S, d, _, dff = sizes
    tail = [tail[0], *tail[2:]]            # d_att == d: its int4 groups are d's
    per_row = torch.is_tensor(index)
    if per_row:
        _check_slots(index, rows, x, name)
        slots, index = index.data_ptr(), 0
    elif not ttm + pm <= index < S:
        raise ValueError(f'index {index} outside [ttm + pm, S) = [{ttm + pm}, {S})')
    else:
        slots = None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _lib(name, weight_format(p))(*lead, slots, *map(_ptr, scratch), L, rows, S, d,
                                           n_heads, dff, int(index), int(ttm), int(pm),
                                           *tail, 1.0 / math.sqrt(d // n_heads), stream)
    _build.check(status, name)
    _count(name, var, sizes, tail, per_row)
    return y, cache


def fused_verify_step(p, x, n_heads: int, cache: KVCache, index, tokens_lens, codes_lens,
                      ttm: int, pm: int, chunk_override: int | None = None,
                      tp: tuple | None = None):
    """A K-token verify block through the whole stack (speculative decode).
    p, cache, tokens_lens, codes_lens as in ``fused_decode_step``; x: (rows,
    K, d) block embeddings at positions index[r] .. index[r] + K - 1; index:
    a contiguous (rows,) int32 tensor of per-row start slots on the device
    of x (the plain version also takes one int for every row), which the
    host never reads: the caller keeps
    ttm + pm <= index and index + K <= S (ar._decode_prefill leaves K slots of
    slack).  The kernel skips a write at a slot >= S, where JAX's
    ``dynamic_update_slice`` would clamp the block's start.  Returns (y (rows,
    K, d), cache) with every row's K slots written in place; query i of row r
    attends up to slot index[r] + i.  chunk_override as in
    ``fused_decode_step``: a block may straddle a chunk boundary.  ``tp`` as
    in ``fused_decode_step``.  On one card the kernel is one cooperative
    launch (the persistent step, rows * K query rows; over an int8 cache
    with its cache write as a phase of its own), which raises where the
    card takes none."""
    if tp is not None:
        return fused_step_tp('fused_verify_step_tp', *tp, x, n_heads, index, tokens_lens,
                             codes_lens, ttm, pm, chunk_override)
    if x.device.type == 'cpu':
        return fused_verify_step_plain(p, x, n_heads, cache, index, tokens_lens,
                                       codes_lens, ttm, pm, chunk_override)
    return _verify_launch('fused_verify_step', p, x, n_heads, cache, index, tokens_lens,
                          codes_lens, ttm, pm, chunk_override)


def fused_verify_step_phased(p, x, n_heads: int, cache: KVCache, index, tokens_lens,
                             codes_lens, ttm: int, pm: int,
                             chunk_override: int | None = None):
    """The phased twin of ``fused_verify_step`` (and, with K = 1, of the
    per-row ``fused_decode_step``): the same arguments and results, launched
    as one kernel per phase (csrc/fused_decode.cu, 5-7 a layer) on the
    device code every item of the persistent steps runs, so the persistent
    #6 and #7 are bit-equal to it.  The bit-exact reference of the card
    tests and ``chip_smoke.py``; no serving path calls it.  Counted in
    ``PHASED_COUNTER``."""
    if x.device.type == 'cpu':
        return fused_verify_step_plain(p, x, n_heads, cache, index, tokens_lens,
                                       codes_lens, ttm, pm, chunk_override)
    return _verify_launch('fused_verify_step_phased', p, x, n_heads, cache, index,
                          tokens_lens, codes_lens, ttm, pm, chunk_override)


def _verify_launch(name: str, p, x, n_heads: int, cache: KVCache, index, tokens_lens,
                   codes_lens, ttm: int, pm: int, chunk_override: int | None):
    """The checks and launch of #7 (``name`` 'fused_verify_step') or its
    phased twin on CUDA tensors."""
    if x.dim() != 3 or x.shape[1] < 1:
        raise ValueError(f'x must be a (rows, K, d) block with K >= 1, got {tuple(x.shape)}')
    q_len = x.shape[1]
    lead, scratch, sizes, tail, y, var = _checked_launch_args(
        name, p, x, n_heads, cache, q_len, tokens_lens, codes_lens, chunk_override)
    L, rows, S, d, _, dff = sizes
    tail = [tail[0], *tail[2:]]            # d_att == d: its int4 groups are d's
    _check_slots(index, rows, x, name)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _lib(name, weight_format(p))(*lead, index.data_ptr(), *map(_ptr, scratch), L,
                                           rows, S, d, n_heads, dff, q_len, int(ttm), int(pm),
                                           *tail, 1.0 / math.sqrt(d // n_heads), stream)
    _build.check(status, name)
    if name == 'fused_verify_step':
        _count(name, var, sizes, tail)
    else:
        PHASED_COUNTER.count += 1
    return y, cache


def _tp_lib(phased: bool, layout: str):
    """The TP launcher: the persistent step of ``layout``'s build, or the
    phased twin (csrc/fused_decode.cu's build), which also takes the ranks'
    own streams."""
    if phased:
        fn = _build.load('fused_decode').valle2_fused_step_tp_phased
    else:
        fn = _build.load(_tp_build(layout)).valle2_fused_step_tp
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        # verify, formats, mp; per rank: 32 pointers (those of the one-rank
        # launchers, then the two partial planes), its card, (phased: its
        # stream) and its caller's stream; 14 sizes; the q scale
        fn.argtypes = [ci] * 5 + [vp] * (4 if phased else 3) + [ci] * 14 + [ctypes.c_float]
        fn.restype = ctypes.c_int
    return fn


CUDA_ERROR_TIMEOUT = 909   # cudaErrorTimeout: a wait across cards gave up


def fused_step_tp(name: str, mesh, trees, caches, x, n_heads: int, index, tokens_lens,
                  codes_lens, ttm: int, pm: int, chunk_override: int | None = None):
    """The fused decode step (``name`` 'fused_decode_step_tp', x (rows, 1, d))
    or verify step ('fused_verify_step_tp', x (rows, K, d), per-row start
    slots) under tensor parallelism (JAX ``fused_decode_step`` /
    ``fused_verify_step`` with ``tp``): rank r of ``mesh`` holds
    ``trees[r]`` (``parallel.shard_decode_params``; dense or int4 weights in
    the ranked packing) and ``caches[r]``, the fused (L, rows, S, d / mp)
    cache of its ``n_heads`` local heads, updated in place.  x, the lengths
    and a per-row index go to every rank's device.  On CUDA tensors one host
    call launches the persistent TP step: ONE cooperative launch per card
    (the ranks grouped by card, ``tp_card_groups``), on the card's current
    stream, each rank's two row-parallel partials a layer summed in rank
    order by the reduce phases inside it (5c's element, ``kernels.tp_allreduce``)
    with the bias and residual added after the sum; across cards the launches
    wait for each other at the barriers across ranks through flags in peer
    memory.  It raises where the build, the cooperative launch or peer
    access between the cards is missing; nothing falls back.  int8 W8A8
    weights raise (``fit_error``): their activation scale would need a
    global amax inside the step (the models take the plain tensor-parallel
    path).  Returns (the ranks' y, equal on every rank, each on its device;
    caches)."""
    return _tp_step(name, False, mesh, trees, caches, x, n_heads, index, tokens_lens,
                    codes_lens, ttm, pm, chunk_override)


def fused_step_tp_phased(name: str, mesh, trees, caches, x, n_heads: int, index, tokens_lens,
                         codes_lens, ttm: int, pm: int, chunk_override: int | None = None):
    """The phased twin of ``fused_step_tp`` (same arguments and results): one
    kernel per phase on each rank's own stream (``Mesh.streams``), every
    rank's kernels queued layer by layer from one host call, 5c launched
    between the layers and CUDA events across the ranks (csrc/fused_decode.cu
    ``step_tp``).  Every item of the persistent TP step runs its device code,
    and the reduce phases 5c's element, so the two are bit-equal.  The
    bit-exact reference of the card tests and ``chip_smoke.py``; no serving
    path calls it.  Counted in ``TP_PHASED_COUNTER``."""
    return _tp_step(name, True, mesh, trees, caches, x, n_heads, index, tokens_lens,
                    codes_lens, ttm, pm, chunk_override)


def _tp_step(name: str, phased: bool, mesh, trees, caches, x, n_heads: int, index,
             tokens_lens, codes_lens, ttm: int, pm: int, chunk_override: int | None):
    """The checks and launch of ``fused_step_tp`` or its phased twin."""
    devices = mesh.devices
    mp = len(devices)
    if len(trees) != mp or len(caches) != mp:
        raise ValueError(f'{name}: the mesh has {mp} ranks, got {len(trees)} trees and '
                         f'{len(caches)} caches')
    per_row = torch.is_tensor(index)
    xs = [x.to(dev) for dev in devices]
    if x.device.type == 'cpu':
        return _step_plain_tp(name, trees, xs, n_heads, caches, index, tokens_lens,
                              codes_lens, ttm, pm, chunk_override)
    if not 1 <= mp <= MAX_MP:
        raise ValueError(f'{name}: 1 to {MAX_MP} ranks, got {mp}')
    verify = name == 'fused_verify_step_tp'
    q_len = x.shape[1]
    if verify and not per_row:
        raise ValueError(f'{name}: the verify step takes a (rows,) tensor of start slots')
    ensure_peer_access(devices)
    hold, ptrs, ys = [], [], []
    tail = sizes = None
    for dev, tree, cache, xr in zip(devices, trees, caches, xs):
        tl, pl = tokens_lens.to(dev), codes_lens.to(dev)
        lead, scratch, sizes_r, tail_r, y, var = _checked_launch_args(
            name, tree, xr, n_heads, cache, q_len, tl, pl, chunk_override, mp)
        if sizes is not None and (sizes_r, tail_r) != (sizes, tail):
            raise ValueError(f'{name}: the ranks\' stacks and caches must agree in shape')
        sizes, tail = sizes_r, tail_r
        slots = None
        if per_row:
            slots = index.to(dev)
            _check_slots(slots, cache.k.shape[1], xr, name)
        planes = [torch.empty((x.shape[0] * q_len, x.shape[-1]), dtype=torch.float32,
                              device=dev) for _ in range(2)]
        # Every tensor whose pointer goes to the launcher is held until it returns.
        hold += [tl, pl, slots, *scratch, *planes]
        ptrs += [*lead[3:], _ptr(slots), *map(_ptr, scratch), *map(_ptr, planes)]
        ys.append(y)
    L, rows, S, d, da, dff = sizes
    if not per_row and not ttm + pm <= index < S:
        raise ValueError(f'index {index} outside [ttm + pm, S) = [{ttm + pm}, {S})')
    cards = (ctypes.c_int * mp)(*(dev.index if dev.index is not None
                                  else torch.cuda.current_device() for dev in devices))
    callers = [torch.cuda.current_stream(dev).cuda_stream for dev in devices]
    streams = [(ctypes.c_void_p * mp)(*(s.cuda_stream for s in mesh.streams()))] if phased \
        else []
    with _TP_LOCK:
        status = _tp_lib(phased, weight_format(trees[0]))(
            int(verify), *lead[:3], mp, (ctypes.c_void_p * len(ptrs))(*ptrs), cards, *streams,
            (ctypes.c_void_p * mp)(*callers), L, rows, S, d, da, n_heads, dff,
            q_len if verify else (0 if per_row else int(index)), int(ttm), int(pm), *tail,
            1.0 / math.sqrt(da // n_heads))
    if status == CUDA_ERROR_TIMEOUT:
        raise RuntimeError(f'{name}: a card waited more than 10 s at a barrier across cards '
                           'for a peer\'s launch, and trapped (the CUDA context of that card '
                           'is lost)')
    _build.check(status, name)
    if phased:
        TP_PHASED_COUNTER.count += 1
    else:
        TP_COUNTERS[name].count += 1
    return ys, caches
