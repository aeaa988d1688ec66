"""bf16 GEMMs with f32 accumulation on the tensor cores: the roofline probe's
two kernels and their plain version.

Replaces the Pallas TPU kernels of ``probes/_gemm_pallas_roofline.py``:
``matmul_fullk`` → ``_fullk_kernel`` (#9, all of K in one program) and
``matmul_ksplit`` → ``_ksplit_kernel`` (#10, K carried over an f32
accumulator), both in ``csrc/gemm.cu`` (see its header for the design): one
warp-specialised ``wgmma`` + TMA mainloop, #9 persistent, #10 with its K
slices summed inside a thread-block cluster, so that it allocates nothing
but C.  They exist to measure how close a hand-written GEMM gets to the
card's peak (``probes/gemm_roofline.py``); the port's models leave their
matrix products to ``torch.matmul``, as the JAX package left them to XLA.

Each wrapper checks its inputs first, on every device, and raises on what the
kernels do not take, so a CPU run refuses the same shapes as the card.  It
then takes ``matmul_plain`` only for tensors on the CPU; for CUDA tensors it
launches its kernel and counts the launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

FULLK_COUNTER = _build.LaunchCounter()
KSPLIT_COUNTER = _build.LaunchCounter()
TILES = ((128, 128), (128, 256))   # (bm, bn) the kernels are built for
BK = 32                            # K granularity: half of a 64-deep stage
MAX_SPLITS = 8                     # #10's K slices form one cluster: the portable size


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: f32 product of the bf16 values, rounded to bf16."""
    return (a.float() @ b.float()).to(torch.bfloat16)


def _check(name: str, a, b, bm: int, bn: int, k_multiple: int) -> tuple[int, int, int]:
    if a.device.type not in ('cpu', 'cuda') or b.device != a.device:
        raise ValueError(f'{name}: a and b must lie on one CPU or CUDA device, got '
                         f'{a.device} and {b.device}')
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f'{name} takes bfloat16 operands, got {a.dtype} and {b.dtype}')
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f'{name}: needs (M, K) @ (K, N), got {tuple(a.shape)} @ '
                         f'{tuple(b.shape)}')
    if (bm, bn) not in TILES:
        raise ValueError(f'{name}: tiles (bm, bn) must be one of {TILES}, got {(bm, bn)}')
    (m, k), n = a.shape, b.shape[1]
    if m % bm or n % bn or k % k_multiple:
        raise ValueError(f'{name}: M % {bm}, N % {bn} and K % {k_multiple} must be 0, got '
                         f'M={m}, N={n}, K={k}')
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f'{name} needs contiguous operands')
    if a.device.type == 'cuda' and (a.data_ptr() % 16 or b.data_ptr() % 16):
        raise ValueError(f'{name} needs 16-byte aligned operands')
    return m, n, k


def _fn(sym: str, argtypes):
    fn = getattr(_build.load('gemm'), sym)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_VP, _CI = ctypes.c_void_p, ctypes.c_int


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def matmul_fullk(a: torch.Tensor, b: torch.Tensor, bm: int = 128, bn: int = 128):
    """Kernel #9: bf16 (M, K) @ (K, N) → bf16, one persistent block per SM
    walking (bm, bn) output tiles, each over all of K."""
    m, n, k = _check('matmul_fullk', a, b, bm, bn, BK)
    if a.device.type == 'cpu':
        return matmul_plain(a, b)
    c = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    fn = _fn('valle2_gemm_fullk', [_VP] * 3 + [_CI] * 5 + [_VP])
    _build.check(fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, bm, bn, _stream(a)),
                 'matmul_fullk')
    FULLK_COUNTER.count += 1
    return c


def matmul_ksplit(a: torch.Tensor, b: torch.Tensor, splits: int = 2, bm: int = 128,
                  bn: int = 128):
    """Kernel #10: the same product with K cut into ``splits`` slices, one
    block each, the blocks of an output tile one cluster that sums their f32
    partials in slice order through distributed shared memory and rounds to
    bf16."""
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f'matmul_ksplit: splits must be in 1..{MAX_SPLITS} (one cluster), '
                         f'got {splits}')
    m, n, k = _check('matmul_ksplit', a, b, bm, bn, BK * splits)
    if a.device.type == 'cpu':
        return matmul_plain(a, b)
    c = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    fn = _fn('valle2_gemm_ksplit', [_VP] * 3 + [_CI] * 6 + [_VP])
    _build.check(fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, splits, bm, bn,
                    _stream(a)), 'matmul_ksplit')
    KSPLIT_COUNTER.count += 1
    return c
