"""Where does the time of the GEMM kernels (#9, #10) go?  Variants of
``csrc/gemm.cu`` with one part cut out, timed in turns with the kernel as it
is, on one CUDA card:

    python -m valle2_tpu_torch.probes.gemm_ablate [--rounds 2]

Variants (each a source edit of ``gemm.cu``, built beside the kernel into
``valle2_tpu_torch/_build/ablate/``; an edit whose anchor is gone fails):

  - ``kernel``: the source as it is;
  - ``no_epilogue``: #9 stores no C and #10 neither writes nor sums its
    partial and skips both cluster barriers (a dummy keeps the sums alive),
    leaving the launch and the mainloop;
  - ``no_remote_reads``: #10 sums only its own partial (no distributed
    shared memory reads);
  - ``one_cluster_barrier``: #10 without the barrier between writing the
    partials and reading them (the keep-alive barrier stays).

Only ``kernel`` is held against ``matmul_plain``: the others compute
something else.  At the probe's three shapes (``gemm_roofline.SHAPES``),
#9 at both tiles and #10 at 1, 2 and 4 K slices, each time the median
back-to-back time (``gemm_roofline.back_to_back_ms``) of every round; one
JSON line per shape, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from ..kernels import _build, gemm
from . import gemm_roofline as probe

ARMS = (('matmul_fullk', dict(bm=128, bn=128)), ('matmul_fullk', dict(bm=128, bn=256)),
        ('matmul_ksplit', dict(splits=1, bm=128, bn=128)),
        ('matmul_ksplit', dict(splits=2, bm=128, bn=128)),
        ('matmul_ksplit', dict(splits=2, bm=128, bn=256)),
        ('matmul_ksplit', dict(splits=4, bm=128, bn=256)))

_STORE9 = '      store_tile<Cf>(&tc, staging, acc, wg - 1, tm * BM, tn * BN);\n'
_KEEP = ('      {{ float sum_ = 0.f;\n'
         '#pragma unroll\n'
         '        for (int i_ = 0; i_ < Cf::ACC; ++i_) sum_ += acc[i_];\n'
         '        if (sum_ == 1234.5f) reinterpret_cast<float*>({buf})[threadIdx.x] = sum_; }}\n')
_PRODUCER_TAIL = ('    __syncwarp();\n    cluster_sync();   // the partials are written\n'
                  '    reduce_rows<Cf>(C, N, m0, n0, z, splits, smem_addr(r.base));\n'
                  '    cluster_sync();   // and read\n')
_CONSUMER_TAIL_START = '    named_barrier_sync(1, 256);\n'
_CONSUMER_TAIL_END = '    cluster_sync();   // and read\n  }\n}\n'
_FIRST_BARRIER = '    cluster_sync();   // the partials are written\n'
_OWN_ONLY = ('    float4 s = ld_cluster_f4(map_to_rank(at, 0));\n'
             '    for (int q = 1; q < splits; ++q) {\n')


def _cut(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise RuntimeError(f'gemm_ablate: anchor found {src.count(old)} times, not {count}: '
                           f'{old!r}')
    return src.replace(old, new)


def variant(src: str, name: str) -> str:
    """``gemm.cu``'s source with the part ``name`` names cut out."""
    if name == 'kernel':
        return src
    if name == 'no_epilogue':
        src = _cut(src, _STORE9, _KEEP.format(buf='staging'))
        src = _cut(src, _PRODUCER_TAIL, '')
        i = src.index(_CONSUMER_TAIL_START)
        j = src.index(_CONSUMER_TAIL_END, i)
        return src[:i] + _KEEP.format(buf='r.base') + src[j + len(_CONSUMER_TAIL_END) - 6:]
    if name == 'no_remote_reads':
        return _cut(src, _OWN_ONLY, _OWN_ONLY.replace('at, 0)', 'at, z)').replace(
            'q < splits', 'q < 1'))
    if name == 'one_cluster_barrier':
        return _cut(src, _FIRST_BARRIER, '', count=2)
    raise ValueError(f'unknown variant {name}')


VARIANTS = ('kernel', 'no_epilogue', 'no_remote_reads', 'one_cluster_barrier')


def build(names=VARIANTS) -> dict:
    """{variant: loaded library}, the nvcc runs started together."""
    src = (_build.CSRC_DIR / 'gemm.cu').read_text()
    out = _build.BUILD_DIR / 'ablate'
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in names:
        cu = out / f'gemm_{n}.cu'
        cu.write_text(variant(src, n))
        procs[n] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f'-I{_build.CSRC_DIR}', '-o',
             str(out / f'gemm_{n}.so'), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f'nvcc failed for the {n} variant:\n{log}')
        libs[n] = ctypes.CDLL(str(out / f'gemm_{n}.so'))
    return libs


def run(rounds: int = 2) -> list[dict]:
    if not torch.cuda.is_available():
        raise RuntimeError('gemm_ablate times a CUDA card and none is available')
    smi = probe.card()
    libs = build()
    load = _build.load
    records = []
    try:
        for sname, m, k, n in probe.SHAPES:
            a, b = probe.operands(m, k, n, 'cuda')
            want = gemm.matmul_plain(a, b)
            allowed = probe.tolerance(a, b, want)
            rec = dict(shape=sname, m=m, k=k, n=n, card=smi,
                       kind=torch.cuda.get_device_name(0),
                       torch_matmul=[probe.back_to_back_ms(lambda: torch.matmul(a, b))])
            for _ in range(rounds):
                for v, lib in libs.items():
                    _build.load = lambda name, lib=lib: lib
                    for fname, kw in ARMS:
                        fn = getattr(gemm, fname)
                        got = fn(a, b, **kw)
                        torch.cuda.synchronize()
                        if v == 'kernel' and bool(
                                ((got.float() - want.float()).abs() > allowed).any()):
                            raise AssertionError(f'{fname} {kw} at {sname}: past the tolerance')
                        key = (f"{v}:{fname.removeprefix('matmul_')}_{kw['bm']}x{kw['bn']}"
                               + (f"_k{kw['splits']}" if 'splits' in kw else ''))
                        rec.setdefault(key, []).append(
                            probe.back_to_back_ms(lambda: fn(a, b, **kw)))
                _build.load = load
            print(json.dumps(rec), flush=True)
            records.append(rec)
            del a, b, want, allowed
    finally:
        _build.load = load
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--rounds', type=int, default=2, help='turns through the variants')
    run(rounds=ap.parse_args(argv).rounds)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
