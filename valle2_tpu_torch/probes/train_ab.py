"""The training path of one checkout, timed through that checkout's own
``chip_smoke.py`` phases, so that two checkouts (this one, and its parent
unpacked by ``git archive`` into a git-ignored directory) can be held side
by side on one card, in turns (change, parent, parent, change):

    python3 valle2_tpu_torch/probes/train_ab.py --tree PATH --label NAME \\
        [--kernels | --first]

Run it as a script, not with ``-m``: the checkout at ``--tree`` must be the
first on ``sys.path`` when its package is imported.  ``--kernels`` times the
bf16 flash backward (#3; #4 and #5) at chip_smoke's ``TRAIN_CASES``, each
route held against the plain version; otherwise phases ``train`` and
``profile`` (AR and NAR) and the 204M AR / NAR steps of phase ``fold``, with
``--first`` also phases ``kernels (train)`` and ``grads``.  Prints one JSON
line per phase.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def kernels(cs, fa) -> dict:
    """bf16 backward ms at the training shapes, through the router and per kernel."""
    import torch
    dev = torch.device('cuda')
    h, hd = cs.SLICE['h'], cs.SLICE['hd']
    gen = torch.Generator().manual_seed(1)
    out = {}
    with torch.no_grad():
        for case, (b, tt, frames, causal) in cs.TRAIN_CASES.items():
            s = tt + frames
            meta = cs.train_meta(b, tt, frames, dev)
            q, k, v, do = (torch.randn(b, h, s, hd, generator=gen).to(dev, torch.bfloat16)
                           for _ in range(4))
            o, lse = fa.flash_attention(q, k, v, meta, tt, causal)
            args = (q, k, v, meta, o, lse, do, tt, causal)
            want = fa.flash_attention_bwd_plain(*args)
            got = fa.flash_attention_bwd(*args)
            torch.cuda.synchronize()
            r = {'max_abs_err': max(float((g.float() - w.float()).abs().max())
                                    for g, w in zip(got, want)),
                 'routed_ms': cs.cuda_ms(lambda: fa.flash_attention_bwd(*args))}
            if fa.uses_fused_bwd(s):
                r['fused_ms'] = cs.cuda_ms(lambda: fa.flash_bwd_fused(*args))
            else:
                r['dq_ms'] = cs.cuda_ms(lambda: fa.flash_bwd_dq(*args))
                r['dkv_ms'] = cs.cuda_ms(lambda: fa.flash_bwd_dkv(*args))
            out[case] = r
    return out


def training(cs, label: str, first: bool) -> None:
    import torch
    smi = cs.phase_device()
    if first:
        cs.phase_train_kernels({})
        cs.phase_grads()
    cs.phase_train(smi)
    cs.phase_profile(smi)
    cs.phase_profile(smi, 'ValleNAR')
    total = dict.fromkeys(cs.counters(), 0)
    for model, b, frames, n in cs.FOLD_TRAIN:
        res = None
        try:
            res = cs.fold_train_arms(model, b, frames, n, cs.LARGE, total)
        except torch.cuda.OutOfMemoryError:
            if model != 'ValleNAR' or b != 16:
                raise
        if res is None:          # out of the except block: its frames are freed
            torch.cuda.empty_cache()
            res = cs.fold_train_arms(model, 8, frames, n, cs.LARGE, total)
        cs.emit(phase='fold', run='train', width='204M', tree=label, **res)
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--tree', required=True, help='root of the checkout to time')
    ap.add_argument('--label', required=True)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument('--kernels', action='store_true')
    mode.add_argument('--first', action='store_true')
    args = ap.parse_args()
    root = Path(args.tree).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    import valle2_tpu_torch
    from valle2_tpu_torch.kernels import flash_attention as fa
    if not Path(valle2_tpu_torch.__file__).resolve().is_relative_to(root):
        raise SystemExit(f'valle2_tpu_torch came from {valle2_tpu_torch.__file__}, not {root}')
    print(json.dumps({'tree': args.label}), flush=True)
    if args.kernels:
        print(json.dumps({'tree': args.label, **kernels(cs, fa)}), flush=True)
    else:
        training(cs, args.label, args.first)
    return 0


if __name__ == '__main__':
    sys.exit(main())
