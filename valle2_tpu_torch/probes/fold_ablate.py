"""Where does the time of the head-folded flash forward (#2, bf16) go?
Variants of ``csrc/flash_attention.cu``'s bf16 #2 with one part changed,
timed in turns with the kernel as it is, beside #1 and SDPA, on one CUDA
card:

    python -m valle2_tpu_torch.probes.fold_ablate [--rounds 2]

Variants (each a source edit, built beside the kernel into
``valle2_tpu_torch/_build/ablate/``; an edit whose anchor is gone fails):

  - ``kernel``: the source as it is;
  - ``branchy_mask``: the per-element mask through #1's ``sees`` (its ``||``
    and ``&&`` compile to a branch an element);
  - ``no_fast_path``: every tile through the per-element mask, also where
    both of a thread's rows see the whole tile;
  - ``static_items``: block j takes items j, j + grid, ... instead of the
    next one from the counter.

Every variant computes the same function and is held bit for bit against
#1.  At chip_smoke.py's fold shapes (``SHAPES``: ragged meta, the last
batch row with tokens_valid == 0), each variant's device time (torch.profiler
over ten calls: the kernel alone, without the host's enqueue) per round,
the kernel's at every group size ``fold_plan`` could choose, and #1's and
SDPA's (with the same mask); one JSON line per shape, with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess

import torch

from ..kernels import _build
from ..kernels import flash_attention as fa
from ..ops.masks import prefix_lm_attend

# (b, h, s, tokens_total, causal): chip_smoke.py's FOLD_CASES.
SHAPES = {'serve': (3, 4, 385, 128, True), 'train_ar': (32, 4, 640, 128, True),
          'train_nar': (32, 4, 640, 128, False), '204m': (16, 16, 640, 128, True)}
HD = 64

_MASK = ('        const bool seen = (key < r.src_end) | ((key >= r.aud_lo) & '
         '(key < r.aud_hi));\n')
_FAST = '  if (sees_all(rr[0]) && sees_all(rr[1])) {\n'
_FETCH = '          i = atomicAdd(counter, 1);\n'


def _cut(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f'fold_ablate: anchor found {src.count(old)} times, not once: '
                           f'{old!r}')
    return src.replace(old, new)


def variant(src: str, name: str) -> str:
    """``flash_attention.cu``'s source with the part ``name`` names changed."""
    if name == 'kernel':
        return src
    if name == 'branchy_mask':
        return _cut(src, _MASK, '        const bool seen = sees(r, key);\n')
    if name == 'no_fast_path':
        return _cut(src, _FAST, '  if (false) {\n')
    if name == 'static_items':
        return _cut(src, _FETCH, '          i = blockIdx.x + (int)n * gridDim.x;\n')
    raise ValueError(f'unknown variant {name}')


VARIANTS = ('kernel', 'branchy_mask', 'no_fast_path', 'static_items')


def build(names=VARIANTS) -> dict:
    """{variant: loaded library}, the nvcc runs started together."""
    src = (_build.CSRC_DIR / 'flash_attention.cu').read_text()
    out = _build.BUILD_DIR / 'ablate'
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in names:
        cu = out / f'flash_{n}.cu'
        cu.write_text(variant(src, n))
        procs[n] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f'-I{_build.CSRC_DIR}', '-o',
             str(out / f'flash_{n}.so'), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f'nvcc failed for the {n} variant:\n{log}')
        libs[n] = ctypes.CDLL(str(out / f'flash_{n}.so'))
    return libs


def device_ms(fn, calls: int = 10, tries: int = 3) -> float:
    """Device time of one call of ``fn``: the device kernel that takes
    longest, its time summed over ``calls`` calls under torch.profiler and
    divided by them.  The profile is taken again where it holds no device
    event."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by_name: dict = {}
        for e in prof.events():
            if e.device_type.name == 'CUDA':
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        if by_name:
            return max(by_name.values()) / calls / 1e3
    raise RuntimeError('fold_ablate: torch.profiler recorded no device kernel')


def inputs(b: int, h: int, s: int, tt: int, seed: int = 3):
    """q, k, v (bf16) and a ragged meta whose last row has tokens_valid 0."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, h, s, HD, generator=gen).to('cuda', torch.bfloat16)
               for _ in range(3))
    meta = torch.tensor([[max(tt - 7 * i, 1), s - 13 * i] for i in range(b)],
                        dtype=torch.int32, device='cuda')
    meta[-1, 0] = 0
    return q, k, v, meta


def card() -> str:
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def run(rounds: int = 2) -> list[dict]:
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        raise RuntimeError('fold_ablate times a CUDA card and none is available')
    smi = card()
    libs = build()
    load = _build.load
    records = []
    try:
        for sname, (b, h, s, tt, causal) in SHAPES.items():
            q, k, v, meta = inputs(b, h, s, tt)
            args = (meta, tt, causal)
            mask = prefix_lm_attend(s, tt, meta[:, 0], meta[:, 1], causal)
            mask = mask.expand(-1, s, s)[:, None]
            o1, lse1 = fa.flash_attention(q, k, v, *args, fold_heads=False)
            plan = fa.fold_plan_for(q, tt, causal)
            rec = dict(shape=sname, b=b, h=h, s=s, hd=HD, causal=causal, card=smi,
                       kind=torch.cuda.get_device_name(0), plan=plan._asdict(),
                       one=[device_ms(lambda: fa.flash_attention(q, k, v, *args,
                                                                 fold_heads=False))],
                       sdpa=[device_ms(lambda: F.scaled_dot_product_attention(
                           q, k, v, attn_mask=mask))])
            for _ in range(rounds):
                for name, lib in libs.items():
                    _build.load = lambda n, lib=lib: lib
                    o, lse = fa.flash_attention_folded(q, k, v, *args)
                    torch.cuda.synchronize()
                    if not (torch.equal(o, o1) and torch.equal(lse, lse1)):
                        raise AssertionError(f'{name} at {sname}: differs from #1')
                    rec.setdefault(name, []).append(
                        device_ms(lambda: fa.flash_attention_folded(q, k, v, *args)))
                _build.load = load
            slots = fa.fold_slots(q.device, q.dtype, HD)
            q_tiles = math.ceil(s / fa.FOLD_BQ)
            for size in [g for g in range(h, 1, -1) if h % g == 0]:
                items = b * q_tiles * (h // size)
                sized = fa.FoldPlan(h // size, size, items, min(items, slots), 0.0)
                real = fa.fold_plan_for
                fa.fold_plan_for = lambda *_: sized
                try:
                    rec[f'group_size_{size}'] = device_ms(
                        lambda: fa.flash_attention_folded(q, k, v, *args))
                finally:
                    fa.fold_plan_for = real
            print(json.dumps(rec), flush=True)
            records.append(rec)
            del q, k, v, meta, o1, lse1
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
