"""Where does the time of the f32 flash forward (#1 on the CUDA cores) go?
Variants of ``csrc/flash_attention.cu`` with one part cut out, timed in
turns with the kernel as it is, beside SDPA's forward, on one CUDA card:

    python -m valle2_tpu_torch.probes.fwd_ablate [--rounds 2]

Variants (each a source edit of the file with ``cc_tiles.cuh`` inlined,
built beside the kernels into ``valle2_tpu_torch/_build/ablate/``; an edit
whose anchor is gone fails):

  - ``kernel``: the source as it is;
  - ``no_mask``: every tile through the unmasked path;
  - ``no_next_tile``: K and V are loaded for the first tile only (each tile
    multiplies the tiles already in shared memory);
  - ``no_softmax``: S goes to the p tile as it is (no mask, max, exp or
    sum; O is not rescaled);
  - ``no_pv``: O += P V is not computed;
  - ``bq128``: q tiles of 128 rows (8 x 8 of S a thread up to hd 64, two
    blocks an SM), not 64 (4 x 8, three blocks).

Only ``kernel`` and ``bq128`` compute the forward (each is held against the
plain version); the cut variants time what is left.  At the training shapes
of chip_smoke.py (``SHAPES``, hd 64, f32, ragged rows like a training
batch's), each variant's device time (torch.profiler over ten calls, every
device kernel of a call summed) per round, SDPA's forward on the same
inputs and mask timed alike, and the kernel's bound (its products at 67
TFLOP/s of FFMA); one JSON line per shape, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from ..config import ConfigValle, precision_scope
from ..kernels import _build
from ..kernels import flash_attention as fa
from ..ops.masks import prefix_lm_attend
from .bwd_ablate import (FFMA_FLOPS, HBM_BYTES_PER_S, HD, SHAPES, H, device_ms,
                         inline_header, train_meta)
from .fold_ablate import card

_V_LOAD = '    stage_rows<T, HD, CC_KEYS, NT>(Vs, v + base, k0, s);\n'
_K_NEXT = '    if (kb + 1 < n_tiles) stage_rows<T, HD, CC_KEYS, NT>(Ks,'
_SOFTMAX = ('    cc_softmax<T, TM, MS>(sc, m, l, alpha, Ps, tm, tn, q0, k0, s, mk, '
            'scale_log2);\n')
_RAW_P = ('#pragma unroll\n    for (int i = 0; i < TM; ++i) {\n      alpha[i] = 1.f;\n'
          '#pragma unroll\n      for (int j = 0; j < 8; ++j)\n'
          '        Ps[(tm + MS * i) * PS + tn + 8 * j] = sc[i][j];\n    }\n')
_PV = '    rows_times<HD, TM, TN, MS, 32>(Ps, Vs, tm, tn, acc);\n'
_MINB = '  static constexpr int MINB = HD <= 64 ? 3 : 1;'

# (edit name) -> [(anchor, replacement)]; each anchor must occur once.
_EDITS = {
    'no_mask': [('  if (whole) {\n', '  if (true) {\n')],
    'no_next_tile': [(_V_LOAD, '    if (kb == 0)\n' + _V_LOAD),
                     (_K_NEXT, '    if (false) stage_rows<T, HD, CC_KEYS, NT>(Ks,')],
    'no_softmax': [(_SOFTMAX, _RAW_P)],
    'no_pv': [(_PV, '    if (false)\n' + _PV)],
    'bq128': [('constexpr int BQ_CC = 64;', 'constexpr int BQ_CC = 128;'),
              (_MINB, _MINB.replace('? 3', '? 2'))],
}
VARIANTS = ('kernel', *_EDITS)
# The variants that compute the forward, held against the plain version.
EXACT = ('kernel', 'bq128')


def variant(src: str, name: str) -> str:
    """``flash_attention.cu``'s source with the part ``name`` names changed
    (cc_tiles.cuh inlined)."""
    edits = _EDITS.get(name, ())
    if edits:
        src = inline_header(src)
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f'fwd_ablate: anchor found {src.count(old)} times, not '
                               f'once: {old!r}')
        src = src.replace(old, new)
    return src


def build(names=VARIANTS) -> dict:
    """{variant: loaded library}, the nvcc runs started together."""
    src = (_build.CSRC_DIR / 'flash_attention.cu').read_text()
    out = _build.BUILD_DIR / 'ablate'
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in names:
        cu = out / f'fwd_{n}.cu'
        cu.write_text(variant(src, n))
        procs[n] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f'-I{_build.CSRC_DIR}', '-o',
             str(out / f'fwd_{n}.so'), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f'nvcc failed for the {n} variant:\n{log}')
        libs[n] = ctypes.CDLL(str(out / f'fwd_{n}.so'))
    return libs


def sdpa_device_ms(q, k, v, mask) -> float:
    import torch.nn.functional as F
    return device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))


def run(rounds: int = 2) -> list[dict]:
    if not torch.cuda.is_available():
        raise RuntimeError('fwd_ablate times a CUDA card and none is available')
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
                q, k, v = (torch.randn(b, H, s, HD, generator=gen).to('cuda')
                           for _ in range(3))
                args = (q, k, v, meta, tt, causal)
                o_ref, lse_ref = fa.flash_attention_plain(*args)
                nbytes = 4 * q.numel() * 4 + lse_ref.numel() * 4
                bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                     2 * 2 * HD * pairs / FFMA_FLOPS)
                rec = dict(case=case, wrapper='flash_attention', shape=[b, H, s, HD],
                           causal=causal, card=smi, kind=torch.cuda.get_device_name(0),
                           bound_ms=bound_ms, sdpa_ms=sdpa_device_ms(q, k, v, mask))
                for _ in range(rounds):
                    for name, lib in libs.items():
                        _build.load = lambda _n, lib=lib: lib
                        call = (lambda: fa.flash_attention(*args, fold_heads=False))
                        if name in EXACT:
                            o, lse = call()
                            torch.cuda.synchronize()
                            err = max(float((o - o_ref).abs().max()),
                                      float((lse - lse_ref).abs().max()))
                            if not err <= 1e-4:
                                raise AssertionError(
                                    f'{name} ({case}): max |err| {err:.3e}')
                        rec.setdefault(name, []).append(device_ms(call))
                    _build.load = load
                print(json.dumps(rec), flush=True)
                records.append(rec)
                del q, k, v, o_ref, lse_ref, args
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
