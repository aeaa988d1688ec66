"""Where does the time of the f32 flash backward (#3, #4, #5 on the CUDA
cores) go?  Variants of ``csrc/flash_attention_bwd.cu`` with one part cut
out, timed in turns with the kernels as they are, beside SDPA's backward,
on one CUDA card:

    python -m valle2_tpu_torch.probes.bwd_ablate [--rounds 2]

Variants (each a source edit, built beside the kernels into
``valle2_tpu_torch/_build/ablate/``; an edit whose anchor is gone fails):

  - ``kernel``: the source as it is;
  - ``no_next_tile``: the streamed tiles after the first are not loaded
    (each tile pair multiplies the tile already in shared memory);
  - ``no_mask``: every tile through the unmasked path;
  - ``no_phase_a``: S and dP are not computed (left 0);
  - ``no_phase_b``: dK, dV and dQ are not accumulated;
  - ``unroll_more``: the product loops unrolled twice as far.

Only ``kernel`` and ``unroll_more`` compute the backward (each is held
against the plain version); the cut variants time what is left.  At the
training shapes of chip_smoke.py (``SHAPES``, hd 64, f32, ragged rows
like a training batch's), each variant's device time (torch.profiler over
ten calls, every device kernel of a call summed: the launch alone, without
the host's enqueue) per round, SDPA's backward on the same inputs and mask
timed alike, and the kernel's bound; one JSON line per shape and kernel,
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from ..config import ConfigValle, precision_scope
from ..kernels import _build
from ..kernels import flash_attention as fa
from ..ops.masks import prefix_lm_attend
from .fold_ablate import card

# chip_smoke.py's TRAIN_CASES: (b, tokens, frames, causal), s = tokens + frames.
SHAPES = {'ar': (32, 128, 512, True), 'nar': (32, 128, 512, False),
          'ar_long': (8, 256, 1024, True)}
H, HD = 4, 64
FFMA_FLOPS = 67e12          # H100 SXM, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

# (edit name) -> [(anchor, replacement, times the anchor occurs)], applied to
# the source with cc_tiles.cuh inlined (``inline_header``).
_EDITS = {
    'no_next_tile': [('if (qb + 1 < n_q) stage_q_tile(', 'if (false) stage_q_tile(', 2),
                     ('if (kb + 1 < n_tiles) stage_kv_tile(', 'if (false) stage_kv_tile(',
                      2)],
    'no_mask': [('        if (whole) {\n', '        if (true) {\n', 2)],
    'no_phase_a': [('      rows_dot<HD, TMA, MS>(grp == 0 ?',
                    '      if (false) rows_dot<HD, TMA, MS>(grp == 0 ?', 2)],
    'no_phase_b': [('    cols_outer<HD>(grp == 0 ?', '    if (false) cols_outer<HD>(grp == 0 ?',
                    1),
                   ('      rows_times<HD, TMQ, TNQ, BQ / TMQ, HD / 2>(dSs, Ks,',
                    '      if (false) rows_times<HD, TMQ, TNQ, BQ / TMQ, HD / 2>(dSs, Ks,', 1),
                   ('    rows_times<HD, TMQ, TNQ, BQ / TMQ, HD / 2>(dSs, ks,',
                    '    if (false) rows_times<HD, TMQ, TNQ, BQ / TMQ, HD / 2>(dSs, ks,', 1)],
    'unroll_more': [('#pragma unroll 2\n  for (int d = 0;', '#pragma unroll 4\n  for (int d = 0;',
                     1),
                    ('#pragma unroll 4\n  for (int r = 0;', '#pragma unroll 8\n  for (int r = 0;',
                     1),
                    ('#pragma unroll 2\n  for (int c = 0;', '#pragma unroll 4\n  for (int c = 0;',
                     1)],
}
VARIANTS = ('kernel', *_EDITS)
# The variants that compute the backward, held against the plain version.
EXACT = ('kernel', 'unroll_more')


def inline_header(src: str) -> str:
    """``src`` with its ``#include "cc_tiles.cuh"`` replaced by the header's
    text, so that an edit reaches the products the header defines."""
    text = (_build.CSRC_DIR / 'cc_tiles.cuh').read_text().replace('#pragma once\n', '')
    return src.replace('#include "cc_tiles.cuh"\n', text)


def variant(src: str, name: str) -> str:
    """``flash_attention_bwd.cu``'s source with the part ``name`` names
    changed (cc_tiles.cuh inlined)."""
    edits = _EDITS.get(name, ())
    if edits:
        src = inline_header(src)
    for old, new, count in edits:
        if src.count(old) != count:
            raise RuntimeError(f'bwd_ablate: anchor found {src.count(old)} times, not '
                               f'{count}: {old!r}')
        src = src.replace(old, new)
    return src


def build(names=VARIANTS) -> dict:
    """{variant: loaded library}, the nvcc runs started together."""
    src = (_build.CSRC_DIR / 'flash_attention_bwd.cu').read_text()
    out = _build.BUILD_DIR / 'ablate'
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in names:
        cu = out / f'bwd_{n}.cu'
        cu.write_text(variant(src, n))
        procs[n] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f'-I{_build.CSRC_DIR}', '-o',
             str(out / f'bwd_{n}.so'), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f'nvcc failed for the {n} variant:\n{log}')
        libs[n] = ctypes.CDLL(str(out / f'bwd_{n}.so'))
    return libs


def device_ms(fn, calls: int = 10, tries: int = 3) -> float:
    """Device time of one call of ``fn``: every device kernel's time summed
    over ``calls`` calls under torch.profiler, divided by them.  The profile
    is taken again where it holds no device event."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type.name == 'CUDA')
        if total > 0:
            return total / calls / 1e3
    raise RuntimeError('bwd_ablate: torch.profiler recorded no device kernel')


def sdpa_device_ms(q, k, v, mask, do) -> float:
    import torch.nn.functional as F
    with torch.inference_mode(False), torch.enable_grad():
        qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask.clone())
        return device_ms(lambda: torch.autograd.grad(out, (qq, kk, vv), do.clone(),
                                                     retain_graph=True))


def train_meta(b: int, tokens: int, frames: int, device='cuda', seed: int = 0):
    """chip_smoke.py's ``train_meta``: tokens_lens in [3/4, 1] of the token
    bucket, codes_lens in [3/4, 1] of the frame bucket."""
    rs = np.random.RandomState(seed)
    tl = rs.randint(tokens * 3 // 4, tokens + 1, b)
    cl = rs.randint(frames * 3 // 4, frames + 1, b)
    return torch.tensor(np.stack([tl, tokens + cl], axis=1), dtype=torch.int32,
                        device=device)


def run(rounds: int = 2) -> list[dict]:
    if not torch.cuda.is_available():
        raise RuntimeError('bwd_ablate times a CUDA card and none is available')
    smi = card()
    libs = build()
    load = _build.load
    gen = torch.Generator().manual_seed(1)
    records = []
    try:
        with precision_scope(ConfigValle(matmul_precision='highest')), torch.no_grad():
            for case, (b, tt, frames, causal) in SHAPES.items():
                s = tt + frames
                meta = train_meta(b, tt, frames)
                mask = prefix_lm_attend(s, tt, meta[:, 0], meta[:, 1], causal)
                mask = mask.expand(-1, s, s)[:, None]
                pairs = int(mask.sum()) * H
                q, k, v, do = (torch.randn(b, H, s, HD, generator=gen).to('cuda')
                               for _ in range(4))
                o, lse = fa.flash_attention(q, k, v, meta, tt, causal)
                args = (q, k, v, meta, o, lse, do, tt, causal)
                want = fa.flash_attention_bwd_plain(*args)
                delta = (do * o).sum(-1).contiguous()
                if fa.uses_fused_bwd(s):
                    kernels = {'flash_bwd_fused': (fa.flash_bwd_fused, (0, 1, 2), 5)}
                else:
                    kernels = {'flash_bwd_dq': (fa.flash_bwd_dq, (0,), 3),
                               'flash_bwd_dkv': (fa.flash_bwd_dkv, (1, 2), 4)}
                sdpa = sdpa_device_ms(q, k, v, mask, do)
                n = q.numel()
                for kname, (fn, outs, products) in kernels.items():
                    nbytes = (5 + len(outs)) * n * 4 + lse.numel() * 4
                    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                         products * 2 * HD * pairs / FFMA_FLOPS)
                    rec = dict(case=case, wrapper=kname, shape=[b, H, s, HD], causal=causal,
                               card=smi, kind=torch.cuda.get_device_name(0),
                               bound_ms=bound_ms, sdpa_ms=sdpa)
                    for _ in range(rounds):
                        for name, lib in libs.items():
                            _build.load = lambda _n, lib=lib: lib
                            call = (lambda fn=fn: fn(*args, delta=delta))
                            if name in EXACT:
                                got = call()
                                got = got if isinstance(got, tuple) else (got,)
                                torch.cuda.synchronize()
                                for g, i in zip(got, outs):
                                    err = float((g - want[i]).abs().max())
                                    if not err <= 1e-4:
                                        raise AssertionError(f'{name}, {kname} ({case}): '
                                                             f'max |err| {err:.3e}')
                            rec.setdefault(name, []).append(device_ms(call))
                        _build.load = load
                    print(json.dumps(rec), flush=True)
                    records.append(rec)
                del q, k, v, do, o, lse, args, want, delta
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
