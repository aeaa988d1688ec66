"""Residual VQ encode: the CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``valle2_tpu/kernels/rvq.py``
(``rvq_encode_fused`` → ``_rvq_kernel``): every RVQ stage of a batch of
latent frames in one call.  The kernel is ``csrc/rvq.cu`` (see its header for
the design: a thread-block cluster of CTAs splits each stage's codewords for
one tile of frames); ``rvq_plan`` picks its tile and cluster from the shape,
and ``rvq_encode_split`` is the plain model of its split argmax.  The plain
version is ``codec.rvq.rvq_encode``.  The wrapper takes the plain version
only for tensors on the CPU; on the card every codec encode goes through the
kernel (the JAX package's ``use_pallas_rvq`` switch has no counterpart here).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..codec import rvq as _plain
from . import _build

COUNTER = _build.LaunchCounter()
LATENT_DIM = 128      # the kernel's frame width
CODE_TILE = 128       # V must be a multiple of this
# The kernel's tiles (csrc/rvq.cu TILE_DIMS, in its order): a CTA's frames x
# codewords, a thread's frames x codewords, a warp's lane rows (its lanes LG x
# 32 / LG, frames down, codewords across); its cluster sizes (16:
# non-portable) and its ring of 32-column codeword chunks.
TILES = ((16, 128, 4, 4, 1), (32, 128, 8, 4, 1), (32, 256, 8, 4, 1), (64, 128, 8, 4, 1),
         (64, 256, 8, 8, 4), (128, 128, 8, 8, 4))
CLUSTERS = (1, 2, 4, 8, 16)
RING = 4
# rvq_plan's cost model, in SM clocks (see there), fitted to the kernel's
# device times under every tile and cluster at five shapes on an H100
# (probes/rvq_allreduce_ab.py --sweep): it picks the fastest plan at four of
# them and one within 0.5% at the fifth.
CODE_LOAD_CLOCKS = 3  # shared-memory clocks of a warp's 16-byte codeword load
FRAME_LOAD_CLOCKS = 4   # ... of its frame load, a broadcast
LOAD_CLOCKS = 20      # a lone warp's wait for its loads, a chunk step
L2_BYTES_PER_CLOCK = 16


def stage_clocks(cluster: int) -> int:
    """A stage's merge and subtraction: block barriers and an L2 gather,
    plus a cluster barrier and remote reads when C > 1."""
    return 500 if cluster == 1 else 2000 + 300 * cluster


# The tie rule between kernel and plain version: a differing code must score
# within TIE_RTOL * max(1, |best score|) of the plain best.  The two sum the
# 128-term dot products and |c|^2 in different orders, which moves a score by
# a few f32 ulps (~1e-7 relative per term); 1e-5 covers that with margin.
TIE_RTOL = 1e-5


def rvq_encode_plain(codebooks: torch.Tensor, latents: torch.Tensor,
                     n_q: int | None = None) -> torch.Tensor:
    """``codec.rvq.rvq_encode`` on bare codebooks."""
    return _plain.rvq_encode({'codebooks': codebooks}, latents, n_q)


def code_gaps(codebooks: torch.Tensor, latents: torch.Tensor, codes: torch.Tensor):
    """How far given codes fall short of the plain version's choice: replay
    the plain stages on ``codes`` (teacher-forced) and return, per (frame,
    stage), (plain max score − plain score of the given code, |plain max|),
    each (B*T, n_q).  A gap of 0 is the plain argmax or an exact tie; the
    kernel may differ from the plain version only where the gap lies within
    f32 rounding of the scores."""
    n_q = codes.shape[1]
    residual = latents.reshape(-1, latents.shape[-1])
    chosen = codes.permute(0, 2, 1).reshape(-1, n_q).long()
    gaps, tops = [], []
    for q in range(n_q):
        cb = codebooks[q]
        scores = 2.0 * (residual @ cb.T) - (cb * cb).sum(dim=-1)
        top = scores.max(dim=-1).values
        gaps.append(top - scores.gather(1, chosen[:, q:q + 1])[:, 0])
        tops.append(top.abs())
        residual = residual - cb[chosen[:, q]]
    return torch.stack(gaps, dim=1), torch.stack(tops, dim=1)


def tile_warps(tile: int) -> int:
    frames, codes, tf, tj, lg = TILES[tile]
    return frames // (lg * tf) * (codes // (32 // lg * tj))


def tile_smem(tile: int) -> int:
    """Dynamic shared memory of one CTA of the tile (csrc/rvq.cu
    ``Tile::SMEM``): residuals, the chunk ring, the tile's |c|^2, the warps'
    and the CTA's bests, the winners."""
    frames, codes, _, tj, lg = TILES[tile]
    return 4 * (frames * (LATENT_DIM + 4) + RING * codes * 36 + codes
                + 2 * (codes // (32 // lg * tj)) * frames + 5 * frames)


@functools.lru_cache(maxsize=256)
def rvq_plan(rows: int, v: int, n_q: int, sms: int) -> dict:
    """The kernel's launch for ``rows`` frames, V codewords and n_q stages on
    a card of ``sms`` SMs: a tile (``TILES``: a CTA's frames x codewords, a
    thread's) and ``cluster`` CTAs a frame tile, CTA r scoring codewords
    [r V / C, (r + 1) V / C) of each stage.

    Picked by a cost model in SM clocks, the smallest first (then the
    smaller cluster, then the larger tile), over the tiles and clusters whose
    slice V / C the tile's codewords divide.  A CTA streams its slice of a
    stage in chunk steps of 4 columns; per step a warp issues TJ 16-byte
    codeword loads and TF frame loads from shared memory
    (``CODE_LOAD_CLOCKS``, ``FRAME_LOAD_CLOCKS`` each) and 4 TF TJ FMAs (one
    an SMSP a clock), and a warp alone waits ``LOAD_CLOCKS`` a step.  The
    SM's CTAs (ceil(CTAs / sms)) share its shared-memory and FMA pipes and
    its L2 reads (512 bytes a codeword a stage, ``L2_BYTES_PER_CLOCK``); a
    stage adds ``stage_clocks(C)`` for the merge, the cluster exchange and
    the subtraction.  A voice prompt of 150 frames thus spreads each stage's
    1024 codewords over clusters of 8 (80 CTAs), where one CTA a 32-frame
    tile reached 5 SMs."""
    best = None
    for tile, (frames, codes, tf, tj, lg) in enumerate(TILES):
        warps = tile_warps(tile)
        for c in CLUSTERS:
            if v % (c * codes):
                continue
            steps = v // (c * codes) * 32               # chunk steps a stage a warp
            ctas = -(-rows // frames) * c
            per_sm = -(-ctas // sms)
            shared = per_sm * warps * steps * (CODE_LOAD_CLOCKS * tj + FRAME_LOAD_CLOCKS * tf)
            fma = per_sm * warps * steps * tf * tj
            chain = steps * (4 * tf * tj + LOAD_CLOCKS)
            l2 = per_sm * v // c * 4 * LATENT_DIM / L2_BYTES_PER_CLOCK
            cost = n_q * (max(shared, fma, chain, l2) + stage_clocks(c))
            key = (cost, c, -frames * codes)
            if best is None or key < best[0]:
                best = (key, dict(tile=tile, frames=frames, codes=codes, thread=(tf, tj, lg),
                                  cluster=c, ctas=ctas, warps=warps, smem=tile_smem(tile),
                                  cost_clocks=cost))
    if best is None:
        raise ValueError(f'rvq_encode_fused kernel: no tile divides V={v}')
    return best[1]


def rvq_encode_split(codebooks: torch.Tensor, latents: torch.Tensor,
                     n_q: int | None = None, cluster: int = 1) -> torch.Tensor:
    """The plain model of the kernel's split argmax: each stage's scores
    (those of ``codec.rvq.nearest_code``) cut into ``cluster`` slices of V /
    cluster codewords, each slice's first best, then the cluster merge in
    rank order -- the higher score wins, the lower index wins equal scores.
    That is argmax's first index for any split, so the codes equal the plain
    version's."""
    nq_all, v, _ = codebooks.shape
    n_q = nq_all if n_q is None else int(n_q)
    if v % cluster:
        raise ValueError(f'V={v} does not split into {cluster} slices')
    span = v // cluster
    residual, codes = latents, []
    offsets = torch.arange(cluster, device=latents.device) * span
    for codebook in codebooks[:n_q]:
        scores = 2.0 * (residual @ codebook.T) - (codebook * codebook).sum(dim=-1)
        parts = scores.unflatten(-1, (cluster, span))
        idx = parts.argmax(dim=-1)
        val = parts.gather(-1, idx[..., None])[..., 0]
        idx = idx + offsets
        best, win = val[..., 0], idx[..., 0]
        for r in range(1, cluster):
            take = (val[..., r] > best) | ((val[..., r] == best) & (idx[..., r] < win))
            best = torch.where(take, val[..., r], best)
            win = torch.where(take, idx[..., r], win)
        residual = residual - codebook[win]
        codes.append(win.to(torch.int32))
    return torch.stack(codes, dim=1)


_sms: dict[int, int] = {}


def _sm_count(dev: torch.device) -> int:
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _sms:
        _sms[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _sms[i]


def _lib():
    fn = _build.load('rvq').valle2_rvq_encode
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 3 + [ci] * 6 + [vp]
        fn.restype = ctypes.c_int
    return fn


def rvq_encode_fused(codebooks: torch.Tensor, latents: torch.Tensor,
                     n_q: int | None = None, plan: dict | None = None) -> torch.Tensor:
    """codebooks (n_q_all, V, D), latents (B, T, D) → codes (B, n_q, T) int32,
    through the first ``n_q`` codebooks (all of them by default).  On the
    card one launch, with ``rvq_plan``'s tile and cluster unless ``plan``
    ({'tile', 'cluster'}) names others; a cluster the card cannot schedule
    raises."""
    if latents.device.type == 'cpu':
        return rvq_encode_plain(codebooks, latents, n_q)
    if latents.device.type != 'cuda':
        raise ValueError(f'rvq_encode_fused runs on CPU or CUDA tensors, got {latents.device}')
    if codebooks.dtype != torch.float32 or latents.dtype != torch.float32:
        raise TypeError('rvq_encode_fused kernel takes float32 codebooks and latents, got '
                        f'{codebooks.dtype} and {latents.dtype}')
    if codebooks.device != latents.device:
        raise ValueError('codebooks and latents must be on the same CUDA device')
    if not (codebooks.is_contiguous() and latents.is_contiguous()):
        raise ValueError('rvq_encode_fused kernel needs contiguous codebooks and latents')
    if codebooks.dim() != 3 or latents.dim() != 3 or codebooks.shape[2] != LATENT_DIM \
            or latents.shape[2] != LATENT_DIM:
        raise ValueError(f'rvq_encode_fused kernel takes (n_q, V, {LATENT_DIM}) codebooks '
                         f'and (B, T, {LATENT_DIM}) latents, got {tuple(codebooks.shape)} '
                         f'and {tuple(latents.shape)}')
    nq_all, v, _ = codebooks.shape
    n_q = nq_all if n_q is None else int(n_q)
    if not 1 <= n_q <= nq_all or v % CODE_TILE:
        raise ValueError(f'rvq_encode_fused kernel: n_q={n_q} of {nq_all} codebooks, '
                         f'V={v} must be a multiple of {CODE_TILE}')
    b, t, _ = latents.shape
    if b * t == 0:
        raise ValueError('rvq_encode_fused kernel needs at least one frame')
    p = rvq_plan(b * t, v, n_q, _sm_count(latents.device)) if plan is None else plan
    tile, cluster = p['tile'], p['cluster']
    if not 0 <= tile < len(TILES) or cluster not in CLUSTERS or v % (cluster * TILES[tile][1]):
        raise ValueError(f'rvq_encode_fused kernel: no tile {tile} in clusters of {cluster} '
                         f'at V={v}')
    codes = torch.empty((b, n_q, t), dtype=torch.int32, device=latents.device)
    stream = torch.cuda.current_stream(latents.device).cuda_stream
    status = _lib()(codebooks.data_ptr(), latents.data_ptr(), codes.data_ptr(), b * t, t, n_q,
                    v, tile, cluster, stream)
    _build.check(status, 'rvq_encode_fused')
    COUNTER.count += 1
    return codes
