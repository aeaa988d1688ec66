"""The training path of one checkout, timed through that checkout's own
``chip_smoke.py`` phases, so that two checkouts (this one, and its parent
unpacked by ``git archive`` into a git-ignored directory) can be held side
by side on one card, in turns (change, parent, parent, change):

    python3 valle2_tpu_torch/probes/train_ab.py --tree PATH --label NAME \\
        [--kernels | --first | --gemm] [--dtype bfloat16 | float32]

Run it as a script, not with ``-m``: the checkout at ``--tree`` must be the
first on ``sys.path`` when its package is imported.  ``--kernels`` times the
flash forward (#1 at chip_smoke's ``TRAIN_CASES``; #2 and #1 at its
``FOLD_CASES`` '204m' and 'serve') and backward (#3; #4 and #5 at
``TRAIN_CASES``) in ``--dtype`` (f32 with TF32 off), each held against the
plain version, beside SDPA's forward or backward on the same inputs and
mask and each kernel's bound and share of it, then prints the digests of
``bits`` (the outputs of the f32 backward and of the bf16 tensor-core
routes on fixed inputs), which two trees' builds must share where their
sources compute alike; otherwise, in bf16, phases ``train`` and
``profile`` (AR and NAR) and the 204M AR / NAR steps of phase ``fold``,
with ``--first`` also phases ``kernels (train)`` and ``grads``, and in f32
the bench train steps of ``TRAIN_RUNS`` at the default ``ConfigValle``
(f32, TF32 as the default leaves it) through this script's own
``train_steps``, which needs of the checkout only its package,
``TRAIN_RUNS`` and ``bench_data``;
``--gemm`` runs that checkout's GEMM roofline probe
(``probes.gemm_roofline.run``: #9 and #10 at the 204M step's shapes and
4096^3, beside ``torch.matmul``).  Prints one JSON line per phase (the probe
one per shape and arm, then a summary of its ms).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def forward(cs, fa, q, k, v, meta, tt, causal, mask, dtype_name, fold=False) -> dict:
    """#1 (or #2 with ``fold``) on one input against the plain version: its
    ms, SDPA's forward ms on the same inputs and mask, the bound and its
    share (f32: of the FFMA bound)."""
    import torch
    if fold:
        def call():
            return fa.flash_attention_folded(q, k, v, meta, tt, causal)
    else:
        def call():
            return fa.flash_attention(q, k, v, meta, tt, causal, fold_heads=False)
    o, lse = call()
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, meta, tt, causal)
    torch.cuda.synchronize()
    r = {'max_abs_err': max(float((o.float() - o_ref.float()).abs().max()),
                            float((lse - lse_ref).abs().max())),
         'ms': cs.cuda_ms(call), 'sdpa_ms': cs.sdpa_ms(q, k, v, mask)}
    pairs = int(mask.sum()) * q.shape[1]
    r['bound_ms'], _ = cs.bound(4 * q.numel() * q.element_size() + lse.numel() * 4,
                                2 * 2 * q.shape[-1] * pairs, dtype_name)
    r['bound_share'] = r['bound_ms'] / r['ms']
    return r


def kernels(cs, fa, dtype_name: str = 'bfloat16') -> dict:
    """Forward and backward ms at the training shapes in ``dtype_name``
    (TF32 off): #1 and the backward through the router and per kernel,
    beside SDPA's on the same inputs and mask; #2 and #1 at the 204M and
    serving shapes of ``cs.FOLD_CASES``; each kernel's bound (``cs.bound``:
    bytes, or its products at the dtype's peak, 67 TFLOP/s of FFMA in f32)
    and its share."""
    import torch
    from valle2_tpu_torch.config import ConfigValle, precision_scope
    dev = torch.device('cuda')
    dt = getattr(torch, dtype_name)
    h, hd = cs.SLICE['h'], cs.SLICE['hd']
    gen = torch.Generator().manual_seed(1)
    out = {}
    with precision_scope(ConfigValle(matmul_precision='highest')), torch.no_grad():
        for case, (b, tt, frames, causal) in cs.TRAIN_CASES.items():
            s = tt + frames
            meta = cs.train_meta(b, tt, frames, dev)
            mask = cs.attend_mask(meta, s, tt, causal)
            pairs = int(mask.sum()) * h
            q, k, v, do = (torch.randn(b, h, s, hd, generator=gen).to(dev, dt)
                           for _ in range(4))
            fwd = forward(cs, fa, q, k, v, meta, tt, causal, mask, dtype_name)
            o, lse = fa.flash_attention(q, k, v, meta, tt, causal)
            args = (q, k, v, meta, o, lse, do, tt, causal)
            want = fa.flash_attention_bwd_plain(*args)
            got = fa.flash_attention_bwd(*args)
            torch.cuda.synchronize()
            r = {'fwd': fwd,
                 'max_abs_err': max(float((g.float() - w.float()).abs().max())
                                    for g, w in zip(got, want)),
                 'routed_ms': cs.cuda_ms(lambda: fa.flash_attention_bwd(*args)),
                 'sdpa_ms': cs.sdpa_ms(q, k, v, mask, do)}
            n, elt = q.numel(), q.element_size()
            in_bytes = 5 * n * elt + lse.numel() * 4
            if fa.uses_fused_bwd(s):
                timed = {'fused': (lambda: fa.flash_bwd_fused(*args), 3, 5)}
            else:
                timed = {'dq': (lambda: fa.flash_bwd_dq(*args), 1, 3),
                         'dkv': (lambda: fa.flash_bwd_dkv(*args), 2, 4)}
            for name, (fn, outs, products) in timed.items():
                ms = r[f'{name}_ms'] = cs.cuda_ms(fn)
                bound_ms, _ = cs.bound(in_bytes + outs * n * elt, products * 2 * hd * pairs,
                                       dtype_name)
                r[f'{name}_bound_ms'], r[f'{name}_bound_share'] = bound_ms, bound_ms / ms
            out[case] = r
            del q, k, v, do, o, lse, args, want, got
        for case in ('204m', 'serve'):
            b, h2, s, tt, causal = cs.FOLD_CASES[case]
            meta = cs.train_meta(b, tt, s - tt, dev, seed=4)
            meta[-1, 0] = 0
            mask = cs.attend_mask(meta, s, tt, causal)
            q, k, v = (torch.randn(b, h2, s, hd, generator=gen).to(dev, dt)
                       for _ in range(3))
            out[f'fold_{case}'] = {
                'folded': forward(cs, fa, q, k, v, meta, tt, causal, mask, dtype_name,
                                  fold=True),
                'per_head': forward(cs, fa, q, k, v, meta, tt, causal, mask, dtype_name)}
            del q, k, v
    return out


def digest(t) -> str:
    """sha256 prefix of a tensor's bytes."""
    import hashlib

    import torch
    as_int = t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.int16)
    return hashlib.sha256(as_int.cpu().numpy().tobytes()).hexdigest()[:16]


def bits(fa) -> dict:
    """{hd: {output: sha256 prefix}} on fixed inputs (numpy, seed 7 + hd;
    b=2, h=2, s=200, ragged meta, causal; lse and delta computed in float64
    on the CPU and passed in, so that no reduction on the card enters): the
    f32 backward's #3 dk, dv, #4 dq and #5 dk, dv, and the bf16 tensor-core
    routes' #1 and #2 o and lse (#3's dq, summed through atomics, is left
    out)."""
    import math

    import numpy as np
    import torch
    from valle2_tpu_torch.ops.masks import prefix_lm_attend
    b, h, s, tt, causal = 2, 2, 200, 40, True
    meta = torch.tensor([[40, 200], [25, 150]], dtype=torch.int32)
    out = {}
    for hd in (32, 64, 128):
        rs = np.random.RandomState(7 + hd)
        q, k, v, do = (torch.from_numpy(rs.standard_normal((b, h, s, hd)).astype('f4'))
                       for _ in range(4))
        scores = torch.matmul(q.double(), k.double().transpose(-1, -2)) / math.sqrt(hd)
        attend = prefix_lm_attend(s, tt, meta[:, 0], meta[:, 1], causal)[:, None]
        scores = torch.where(attend, scores, -1e30)
        lse = torch.logsumexp(scores, -1)
        o = torch.matmul(torch.softmax(scores, -1), v.double())
        delta = (do.double() * o).sum(-1).float().cuda()
        args = [t.cuda() for t in (q, k, v, meta, o.float(), lse.float(), do)]
        _, dk3, dv3 = fa.flash_bwd_fused(*args, tt, causal, delta=delta)
        dq4 = fa.flash_bwd_dq(*args, tt, causal, delta=delta)
        dk5, dv5 = fa.flash_bwd_dkv(*args, tt, causal, delta=delta)
        b16 = [t.cuda().bfloat16() for t in (q, k, v)]
        o1, lse1 = fa.flash_attention(*b16, args[3], tt, causal, fold_heads=False)
        o2, lse2 = fa.flash_attention_folded(*b16, args[3], tt, causal)
        torch.cuda.synchronize()
        out[hd] = {name: digest(t) for name, t in (
            ('f32_dk3', dk3), ('f32_dv3', dv3), ('f32_dq4', dq4), ('f32_dk5', dk5),
            ('f32_dv5', dv5), ('bf16_o1', o1), ('bf16_lse1', lse1), ('bf16_o2', o2),
            ('bf16_lse2', lse2))}
    return out


def train_steps(cs, label: str, dtype_name: str) -> None:
    """The bench train steps (``cs.TRAIN_RUNS``) at the default ConfigValle
    but ``dtype_name``: host ms a step over the timed steps (after two warm
    steps), then device ms a step by torch.profiler over 3 steps, in all and
    in the flash forward's and backward's kernels."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.train import init_state, make_train_step
    dev = torch.device('cuda')
    for model, b, frames, n in cs.TRAIN_RUNS:
        cfg = ConfigValle(dropout=0.1, batch_size=b, dtype=dtype_name)
        state = init_state(cfg, model, device=dev)
        step = make_train_step(cfg, model)
        data = cs.bench_data(model, b, frames, dev)
        for _ in range(2):
            state, _m = step(state, data, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state, m = step(state, data, 1)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / n
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                state, m = step(state, data, 1)
            torch.cuda.synchronize()
        dev_ms = {'all': 0.0, 'flash_fwd': 0.0, 'flash_bwd': 0.0}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                ms = e.self_device_time_total / 1e3 / 3
                dev_ms['all'] += ms
                for part in ('flash_fwd', 'flash_bwd'):
                    if part in e.key:
                        dev_ms[part] += ms
        cs.emit(phase='train_steps', tree=label, model=model, batch=b, frames=frames,
                dtype=dtype_name, step_ms=step_ms, device_ms_per_step=dev_ms,
                loss=float(m['loss']))
        del state, data, step
        torch.cuda.empty_cache()


def gemm() -> dict:
    """The checkout's GEMM probe; {shape: {arm: ms}}."""
    from valle2_tpu_torch.probes import gemm_roofline
    out: dict = {}
    for r in gemm_roofline.run(reps=30):
        out.setdefault(r['shape'], {})[r['arm']] = r['ms']
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
    mode.add_argument('--gemm', action='store_true')
    ap.add_argument('--dtype', choices=('bfloat16', 'float32'), default='bfloat16')
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
        print(json.dumps({'tree': args.label, 'dtype': args.dtype,
                          **kernels(cs, fa, args.dtype)}), flush=True)
        print(json.dumps({'tree': args.label, 'bits': bits(fa)}), flush=True)
    elif args.gemm:
        print(json.dumps({'tree': args.label, 'gemm_ms': gemm()}), flush=True)
    elif args.dtype == 'float32':
        train_steps(cs, args.label, args.dtype)
    else:
        training(cs, args.label, args.first)
    return 0


if __name__ == '__main__':
    sys.exit(main())
