"""RVQ encode (#8) and the row-parallel all-reduce 5c alone of one checkout,
timed at the shapes of ``chip_smoke.py``, so that two checkouts (this one,
and its parent unpacked by ``git archive`` into a git-ignored directory) can
be held side by side on one card, in turns (parent, change, change, parent):

    python3 valle2_tpu_torch/probes/rvq_allreduce_ab.py --tree PATH --label NAME
        [--sweep] [--cards N] [--only rvq|allreduce]

Run it as a script, not with ``-m``: the checkout at ``--tree`` must be the
first on ``sys.path`` when its package is imported.  #8 at the voice prompt
(1 x 150, n_q 8), a dataset batch (16 x 300), a ragged batch (3 x 77, n_q
4), three 3 s prompts (3 x 225) and 32 dataset items of 3 s (32 x 225):
CUDA-event ms a call (median of 30), the host's enqueue, and from
``torch.profiler`` over 10 calls the device ms and device kernels a call.
5c at mp 2 on virtual ranks of cuda:0, at the TP prefill's (3, 385, 256)
and NAR's (3, 512, 256) partials and the decode step's (12, 256): the bare
sum (``tp_allreduce``) beside ``torch.add`` of the two partials, and a
row-parallel output projection with its bias and the caller's residual add
(``linear_row_parallel`` then ``x + o``, or its ``residual=`` where the
checkout has it): the same numbers, so the device kernels a sum show
beside the GEMMs.  ``--sweep`` (a checkout whose ``kernels.rvq`` has
``rvq_plan``): #8's device ms under every tile and cluster size the kernel
builds, beside the plan's choice.  ``--cards N``: 5c over ranks on cuda:0
.. N-1 at the prefill's partial, timed on cuda:0's stream, with the
ordering calls a sum where the checkout counts them.  Prints one JSON line
per case.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
import time
from pathlib import Path

RVQ_CASES = {'prompt_1x150': (1, 150, 8), 'batch_16x300': (16, 300, 8),
             'ragged_3x77': (3, 77, 4), 'clone_3x225': (3, 225, 8), 'data_32x225': (32, 225, 8)}
SUM_SHAPES = {'prefill': (3, 385, 256), 'nar': (3, 512, 256), 'step_rows12': (12, 256)}


def cuda_ms(fn, warmup: int = 5, reps: int = 30) -> float:
    """Median CUDA-event time of fn() in ms, on the current stream."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def enqueue_ms(fn, reps: int = 8) -> float:
    """Host ms of one call with the device idle before it."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return 1e3 * t


def device_per_call(fn, calls: int = 10) -> tuple[float, float, dict]:
    """(device ms, device kernels, kernels by name) a call of fn, from
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(10000)    # the profiler may miss its window's first kernel
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
          and not any(w in e.name.lower() for w in ('sleep', 'spin'))]
    names: dict = {}
    for e in ev:
        key = e.name.split('<')[0].split('(')[0][-48:]
        names[key] = names.get(key, 0) + 1 / calls
    return sum(e.time_range.elapsed_us() for e in ev) / 1e3 / calls, len(ev) / calls, names


def timed(fn) -> dict:
    dev_ms, kernels, names = device_per_call(fn)
    return dict(ms=cuda_ms(fn), enqueue_ms=enqueue_ms(fn), device_ms=dev_ms,
                device_kernels=kernels, kernels_by_name=names)


def rvq(label: str, sweep: bool) -> None:
    import torch
    from valle2_tpu_torch.kernels import rvq as krvq
    dev = torch.device('cuda')
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(8)
    cb = (torch.rand(8, 1024, 128, generator=gen) * 2 - 1).to(dev)
    for case, (b, t, n_q) in RVQ_CASES.items():
        lat = torch.randn(b, t, 128, generator=gen).to(dev)
        out = dict(tree=label, kernel='rvq_encode', case=case,
                   **timed(lambda: krvq.rvq_encode_fused(cb, lat, n_q)))
        if hasattr(krvq, 'rvq_plan'):
            out['plan'] = krvq.rvq_plan(b * t, 1024, n_q, sms)
        print(json.dumps(out), flush=True)
        if sweep and hasattr(krvq, 'rvq_plan'):
            arms = {}
            for tile, (frames, codes, tf, tj, *lanes) in enumerate(krvq.TILES):
                for c in krvq.CLUSTERS:
                    if 1024 % (c * codes):
                        continue
                    plan = dict(tile=tile, cluster=c)
                    try:
                        ms, _, _ = device_per_call(
                            lambda plan=plan: krvq.rvq_encode_fused(cb, lat, n_q, plan=plan))
                    except RuntimeError as exc:      # a cluster the card cannot schedule
                        ms = str(exc)[:80]
                    arms[f'{frames}x{codes}_t{tf}x{tj}{"_l" + str(lanes[0]) if lanes else ""}'
                         f'_c{c}'] = ms
            ranked = sorted((v, k) for k, v in arms.items() if isinstance(v, float))
            print(json.dumps(dict(tree=label, kernel='rvq_encode', case=case, sweep=arms,
                                  best=ranked[:3], plan=out.get('plan'))), flush=True)


def allreduce(label: str) -> None:
    import torch
    from valle2_tpu_torch.kernels import tp_allreduce as ta
    from valle2_tpu_torch.ops.nn import linear_row_parallel
    dev = torch.device('cuda')
    fused = 'residual' in inspect.signature(linear_row_parallel).parameters
    gen = torch.Generator().manual_seed(9)
    for case, shape in SUM_SHAPES.items():
        parts = [torch.randn(*shape, generator=gen).to(dev) for _ in range(2)]
        d = shape[-1]
        w = torch.randn(d, d, generator=gen) / d ** 0.5
        ps = [{'w': c.contiguous().to(dev), 'b': torch.randn(d, generator=gen).to(dev)}
              for c in w.chunk(2, dim=0)]
        ps[1]['b'] = ps[0]['b']
        x = torch.randn(*shape[:-1], d, generator=gen).to(dev)
        xs = [c.contiguous() for c in x.chunk(2, dim=-1)]
        res = [torch.randn(*shape, generator=gen).to(dev)] * 2

        def row_parallel():
            if fused:
                return linear_row_parallel(ps, xs, residual=res)
            return [r + o for r, o in zip(res, linear_row_parallel(ps, xs))]
        for arm, fn in (('sum', lambda: ta.tp_allreduce(parts)),
                        ('torch_add', lambda: torch.add(parts[0], parts[1])),
                        ('row_parallel_with_residual', row_parallel)):
            print(json.dumps(dict(tree=label, kernel='tp_allreduce', case=case, arm=arm, mp=2,
                                  shape=list(shape), **timed(fn))), flush=True)


def cards(label: str, n: int) -> None:
    import torch
    from valle2_tpu_torch.kernels import tp_allreduce as ta
    devices = [torch.device('cuda', i) for i in range(n)]
    gen = torch.Generator().manual_seed(10)
    host = [torch.randn(*SUM_SHAPES['prefill'], generator=gen) for _ in devices]
    parts = [h.to(d) for h, d in zip(host, devices)]
    want = ta.tp_allreduce_plain(host)[0]
    outs = ta.tp_allreduce(parts)
    for d in devices:
        torch.cuda.synchronize(d)
    equal = all(torch.equal(o.cpu(), want) for o in outs)
    calls = getattr(ta, 'ordering_calls', None)
    before = calls() if calls else None
    ta.tp_allreduce(parts)
    per_sum = calls() - before if calls else None
    with torch.cuda.device(devices[0]):
        ms = cuda_ms(lambda: ta.tp_allreduce(parts))
        enq = enqueue_ms(lambda: ta.tp_allreduce(parts))
    print(json.dumps(dict(tree=label, kernel='tp_allreduce', case='prefill', cards=n,
                          bit_equal=equal, ms=ms, enqueue_ms=enq,
                          ordering_calls_a_sum=per_sum)), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--tree', required=True, help='root of the checkout to time')
    ap.add_argument('--label', required=True)
    ap.add_argument('--sweep', action='store_true', help="#8 under every tile and cluster")
    ap.add_argument('--cards', type=int, default=0, help='5c over this many cards only')
    ap.add_argument('--only', choices=('rvq', 'allreduce'), help='one of the two kernels')
    args = ap.parse_args()
    root = Path(args.tree).resolve()
    sys.path.insert(0, str(root))
    import torch
    import valle2_tpu_torch
    if not Path(valle2_tpu_torch.__file__).resolve().is_relative_to(root):
        raise SystemExit(f'valle2_tpu_torch came from {valle2_tpu_torch.__file__}, not {root}')
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        if args.cards:
            cards(args.label, args.cards)
            return 0
        if args.only != 'allreduce':
            rvq(args.label, args.sweep)
        if args.only != 'rvq':
            allreduce(args.label)
    return 0


if __name__ == '__main__':
    sys.exit(main())
