"""How close does a hand-written bf16 GEMM get to the card's tensor-core peak?

    python -m valle2_tpu_torch.probes.gemm_roofline [--reps 30]    # one CUDA card
    python -m valle2_tpu_torch.probes.gemm_roofline --device cpu   # plain versions, small

The port of ``probes/_gemm_pallas_roofline.py``.  It A/Bs, in one process, at
the same three shapes:

  - ``torch_matmul``: PyTorch's bf16 GEMM (cuBLAS), the yardstick, as the
    JAX probe's ``xla`` arm was;
  - ``cuda_fullk_<bm>x<bn>``: kernel #9 (``kernels.gemm.matmul_fullk``);
  - ``cuda_ksplit_<bm>x<bn>_k<splits>``: kernel #10 (``matmul_ksplit``),

two tile configurations of each.  Times are CUDA events, the median of
``--reps`` calls after a warm-up, each call between its own two events, so
that ``ms`` includes the host's enqueue of the call (the wrappers' checks,
the tensor maps, the launch); ``back_to_back_ms`` is the median over five
windows of 20 calls in a row, where the device, not the host, sets the pace.
Each arm's output is held against ``matmul_plain`` first.  One JSON line per
(shape, arm): both times, TFLOP/s, the share of the 989 TFLOP/s bf16 dense
peak at each, the least time the card could take (operations or bytes,
whichever bounds it), and the card's name and power limit from
``nvidia-smi``.  ``--device cpu`` runs every arm through its plain
version at a small shape and prints only the agreement: a CPU run times
nothing.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess

import torch

from ..kernels.gemm import matmul_fullk, matmul_ksplit, matmul_plain

# (name, M, K, N): probes/_gemm_pallas_roofline.py:140-143.  10240 = 16 x 640
# is the tokens of the 204M training step at b=16 x 512 frames.
SHAPES = (('square4096', 4096, 4096, 4096),
          ('ffn1_204m', 10240, 1024, 4096),
          ('out_204m', 10240, 1024, 1024))
CPU_SHAPES = (('cpu_small', 256, 128, 256),)
ARMS = {
    'torch_matmul': torch.matmul,
    'cuda_fullk_128x128': functools.partial(matmul_fullk, bm=128, bn=128),
    'cuda_fullk_128x256': functools.partial(matmul_fullk, bm=128, bn=256),
    'cuda_ksplit_128x128_k2': functools.partial(matmul_ksplit, splits=2, bm=128, bn=128),
    'cuda_ksplit_128x256_k4': functools.partial(matmul_ksplit, splits=4, bm=128, bn=256),
}
# One H100 SXM (NVIDIA's data sheet): dense bf16 peak and HBM bytes/s.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def tolerance(a: torch.Tensor, b: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Largest |got - want| a right kernel may show, per element: one bf16 ulp
    of the result (2^-7 relative: the two round f32 sums that differ in their
    last bits) plus the f32 summation-order error, K * 2^-24 * max|a| * max|b|."""
    k = a.shape[1]
    order = k * 2.0 ** -24 * float(a.float().abs().max()) * float(b.float().abs().max())
    return want.float().abs() * 2.0 ** -7 + order


def bound_ms(m: int, k: int, n: int) -> tuple[float, str]:
    """(ms, 'operations' | 'bytes'): A and B read once, C written once, in bf16."""
    t_ops = 2.0 * m * k * n / PEAK_BF16_FLOPS
    t_bytes = 2.0 * (m * k + k * n + m * n) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), 'operations' if t_ops >= t_bytes else 'bytes'


def cuda_ms(fn, reps: int, warmup: int = 5) -> float:
    """Median CUDA-event time of fn() in milliseconds."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def back_to_back_ms(fn, calls: int = 20, windows: int = 5) -> float:
    """Median over ``windows`` of the CUDA-event time of ``calls`` calls of
    fn() in a row, per call, in milliseconds."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return sorted(times)[len(times) // 2]


def card() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def operands(m: int, k: int, n: int, device, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(m, k, generator=gen).to(device, torch.bfloat16)
    b = torch.randn(k, n, generator=gen).to(device, torch.bfloat16)
    return a, b


def run(reps: int = 30, device: str = 'cuda') -> list[dict]:
    """Every (shape, arm): held against ``matmul_plain`` (raises past the
    tolerance), then timed on the card.  Returns the records it prints."""
    dev = torch.device(device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('the GEMM probe times a CUDA card and none is available '
                               '(--device cpu checks the plain versions only)')
        smi = card()
    elif dev.type != 'cpu':
        raise ValueError(f'device must be cuda or cpu, got {device}')
    records = []
    for sname, m, k, n in SHAPES if dev.type == 'cuda' else CPU_SHAPES:
        a, b = operands(m, k, n, dev)
        want = matmul_plain(a, b)
        tol = tolerance(a, b, want)
        for arm, fn in ARMS.items():
            got = fn(a, b)
            err = (got.float() - want.float()).abs()
            if not bool(torch.isfinite(got).all()) or bool((err > tol).any()):
                raise AssertionError(f'{arm} at {sname}: max |err| {float(err.max()):.3e} '
                                     'past one bf16 ulp plus the f32 order error')
            rec = dict(shape=sname, m=m, k=k, n=n, arm=arm, device=dev.type,
                       max_abs_err=float(err.max()))
            if dev.type == 'cuda':
                ms = cuda_ms(lambda: fn(a, b), reps)
                b2b = back_to_back_ms(lambda: fn(a, b))
                flops = 2.0 * m * k * n
                rec.update(ms=ms, tflops=flops / ms / 1e9,
                           peak_share=flops / (ms * 1e-3) / PEAK_BF16_FLOPS,
                           back_to_back_ms=b2b,
                           back_to_back_peak_share=flops / (b2b * 1e-3) / PEAK_BF16_FLOPS,
                           kind=torch.cuda.get_device_name(dev), card=smi)
                rec['bound_ms'], rec['bound_by'] = bound_ms(m, k, n)
            print(json.dumps(rec), flush=True)
            records.append(rec)
        del a, b, want, tol
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--reps', type=int, default=30, help='timed calls per arm (median)')
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    args = ap.parse_args(argv)
    run(reps=args.reps, device=args.device)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
