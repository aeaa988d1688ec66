"""The speculative verify step (#7) of one checkout, timed at the shapes of
``chip_smoke.py``, so that two checkouts (this one, and its parent unpacked
by ``git archive`` into a git-ignored directory) can be held side by side on
one card, in turns (parent, change, change, parent):

    python3 valle2_tpu_torch/probes/verify_ab.py --tree PATH --label NAME [--decode-only]

Run it as a script, not with ``-m``: the checkout at ``--tree`` must be the
first on ``sys.path`` when its package is imported.  Per case, that
checkout's ``fused_verify_step`` (whatever route it takes) at the serving
spec cell (3 rows x K = 4, S 901, start slots ttm + pm + {100, 137, 203}) in
every weight x cache variant, its chunked run (S 1024, chunk 512, row 1's
block across slot 512) and the 204M block (1 x 4, S 900), f32 with TF32 off
and bf16: CUDA-event ms a call (median of 30), the host's enqueue of one
call (the device idle before it), and from ``torch.profiler`` over 10 calls
the device ms and device kernels a call; the same of #6 (``STEP_CASES``: 12
rows at the serving shape, one row at the 204M widths), which shares #7's
device code.  Then the spec path: the 3 requests of phase main through
``ValleAR.generate_batch`` at one beam, bf16, ``max_audio_len`` 512,
``ignore_eos``, the plain loop (#6) and the speculative loop (K = 4, ngram
3) in turns (plain, spec, spec, plain): decode ms, turns, ms a turn and a
token.  Needs of the checkout only its package and
``chip_smoke.py``'s inputs (``quant_step_inputs``, ``slice_lengths``,
``make_requests``, the cell constants), which both sides of the A/B share.
Prints one JSON line per case and per decode run.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

# case -> (rows, S, chunk, 204M widths, (ttm, pm) from chip_smoke's SLICE or
# STREAM, the rows' start offsets past ttm + pm, variants, dtypes)
CASES = {
    'spec': (3, 901, None, False, 'SLICE', (100, 137, 203),
             ('dense', 'w8a8', 'w4a16', 'kv8', 'w8a8_kv8', 'w4a16_kv8'),
             ('bfloat16', 'float32')),
    'spec_chunked': (3, 1024, 512, False, 'SLICE', (100, 512 - 2 - 128 - 257, 203),
                     ('dense',), ('bfloat16', 'float32')),
    '204m': (1, 900, None, True, 'STREAM', (256,), ('dense',), ('bfloat16',)),
}
K = 4
# #6 beside it, whose device code #7's change shares: case -> (rows, S (None:
# chip_smoke's serving_len), 204M widths, the index past ttm + pm, dtypes)
STEP_CASES = {'serve': (12, None, False, 100, ('bfloat16', 'float32')),
              '204m': (1, 896, True, 300, ('bfloat16',))}


def device_per_call(fn, calls: int = 10) -> tuple[float, float]:
    """(device ms, device kernels) a call of fn, from torch.profiler."""
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
    return sum(e.time_range.elapsed_us() for e in ev) / 1e3 / calls, len(ev) / calls


def kernels(cs, label: str) -> None:
    import torch
    from valle2_tpu_torch.config import ConfigValle, precision_scope
    from valle2_tpu_torch.kernels import fused_decode as fd
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(17)
    large = dict(L=cs.LARGE['num_layers'], d=cs.LARGE['d_model'], h=cs.LARGE['n_heads'],
                 dff=cs.LARGE['dim_feedforward'])
    with precision_scope(ConfigValle(matmul_precision='highest')), torch.inference_mode():
        for case, (rows, S, chunk, is_large, geo, offsets, variants, dtypes) in CASES.items():
            g = getattr(cs, geo)
            ttm, pm = g['ttm'], g['pm']
            widths = large if is_large else {}
            d, h = widths.get('d', cs.SLICE['d']), widths.get('h', cs.SLICE['h'])
            tl, cl = (t[:rows].contiguous() for t in cs.slice_lengths(dev))
            index = torch.tensor([ttm + pm + o for o in offsets], dtype=torch.int32,
                                 device=dev)
            for dtype_name in dtypes:
                dt = getattr(torch, dtype_name)
                for variant in variants:
                    p, cache = cs.quant_step_inputs(variant, dt, gen, dev, rows=rows, S=S,
                                                    widths=widths)
                    x = torch.randn(rows, K, d, generator=gen).to(dev, dt)

                    def call(p=p, x=x, h=h, cache=cache):
                        return fd.fused_verify_step(p, x, h, cache, index, tl, cl, ttm, pm,
                                                    chunk_override=chunk)
                    ms = cs.cuda_ms(call)
                    enq = cs.enqueue_ms(call)
                    dev_ms, per_call = device_per_call(call)
                    print(json.dumps(dict(tree=label, case=case, variant=variant,
                                          dtype=dtype_name, ms=ms, enqueue_ms=enq,
                                          device_ms=dev_ms, device_kernels=per_call)),
                          flush=True)
                    del p, cache
        for case, (rows, S, is_large, offset, dtypes) in STEP_CASES.items():
            widths = large if is_large else {}
            d, h = widths.get('d', cs.SLICE['d']), widths.get('h', cs.SLICE['h'])
            ttm, pm = cs.SLICE['ttm'], cs.SLICE['pm']
            tl, cl = (t.repeat_interleave(4)[:rows].contiguous() for t in cs.slice_lengths(dev))
            for dtype_name in dtypes:
                dt = getattr(torch, dtype_name)
                p, cache = cs.quant_step_inputs('dense', dt, gen, dev, rows=rows, S=S,
                                                widths=widths)
                x = torch.randn(rows, 1, d, generator=gen).to(dev, dt)

                def step(p=p, x=x, h=h, cache=cache):
                    return fd.fused_decode_step(p, x, h, cache, ttm + pm + offset, tl, cl, ttm,
                                                pm)
                dev_ms, per_call = device_per_call(step)
                print(json.dumps(dict(tree=label, case=f'step_{case}', variant='dense',
                                      dtype=dtype_name, ms=cs.cuda_ms(step),
                                      enqueue_ms=cs.enqueue_ms(step), device_ms=dev_ms,
                                      device_kernels=per_call)), flush=True)
                del p, cache


def decode(cs, label: str) -> None:
    """The plain loop and the speculative loop on the same weights, in turns."""
    import numpy as np
    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.data.frontend import PhonemeTokenizer
    from valle2_tpu_torch.models.ar import ValleAR
    from valle2_tpu_torch.tts import StageClock
    texts, pts, pcs = cs.make_requests()
    tok = PhonemeTokenizer()
    tokens = [np.concatenate([pt, tok(t)]) for t, pt in zip(texts, pts)]
    base = dict(max_audio_len=cs.SLICE['max_new'], ignore_eos=True, dropout=0.0,
                dtype='bfloat16', num_beams=1)
    plain = ValleAR(ConfigValle(**base), device='cuda')
    spec = ValleAR(ConfigValle(**base, speculative_k=K, speculative_ngram=cs.SPEC['ngram']),
                   params=plain.params, device='cuda')
    for model in (plain, spec):          # warm-up: the allocator, the builds
        model.generate_batch(tokens, pcs)
    for run, model in (('plain', plain), ('spec', spec), ('spec', spec), ('plain', plain)):
        clock = StageClock('cuda')
        model.generate_batch(tokens, pcs, clock=clock)
        dec = clock.times['decode'] * 1e3
        out = dict(tree=label, run=run, decode_ms=dec,
                   ms_per_token=dec / cs.SLICE['max_new'])
        if clock.counts:
            turns = clock.counts['ar_turns']
            out.update(turns=turns, ms_per_turn=dec / turns,
                       tokens=clock.counts['ar_tokens'])
        print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--tree', required=True, help='root of the checkout to time')
    ap.add_argument('--label', required=True)
    ap.add_argument('--decode-only', action='store_true',
                    help='the plain and speculative loops only, no kernel cases')
    args = ap.parse_args()
    root = Path(args.tree).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    import valle2_tpu_torch
    if not Path(valle2_tpu_torch.__file__).resolve().is_relative_to(root):
        raise SystemExit(f'valle2_tpu_torch came from {valle2_tpu_torch.__file__}, not {root}')
    if not args.decode_only:
        kernels(cs, args.label)
    decode(cs, args.label)
    return 0


if __name__ == '__main__':
    sys.exit(main())
