"""Where a pipeline step's time goes: one AR train step under torch.profiler,
solo and on a ('data', 'pipe') mesh of virtual ranks on one card, GPipe and
1F1B, at the 204M widths (d 1024, 16 heads, dff 4096, 16 layers), bf16,
dropout 0.1, b=16 x (128 + 512):

    python -m valle2_tpu_torch.probes.pipe_profile [--pipe 4] [--microbatches 8]

Each arm takes two warm-up steps, then one profiled step.  Prints one JSON
line per arm: the step's wall ms (host clock, ending in a synchronize), the
device ms (the sum of its kernels' times; a ``profiling.annotate`` range is
no kernel), the card's busy share of the wall, the kernel launches and the
aten ops the host issued, and the five kernels with the most device time.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

LARGE = dict(d_model=1024, n_heads=16, dim_feedforward=4096, num_layers=16)


def batch(b: int, frames: int, device) -> dict:
    """An AR training batch with every row full, tokens frames // 4 long."""
    rs = np.random.RandomState(0)
    tt = frames // 4
    data = {'tokens': rs.randint(0, 256, (b, tt)), 'tokens_lens': np.full(b, tt),
            'codes': rs.randint(0, 1024, (b, frames)), 'codes_lens': np.full(b, frames),
            'target': rs.randint(0, 1024, (b, frames))}
    return {k: torch.tensor(v, dtype=torch.int32, device=device) for k, v in data.items()}


def busy_ms(events, device_index: int) -> tuple[float, float]:
    """(the sum of the card's kernel times, the union of their intervals),
    in ms."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA and e.device_index == device_index
                   and not e.is_user_annotation)
    total = sum(z - a for a, z in spans)
    union, end = 0.0, None
    for a, z in spans:
        if end is None or a > end:
            union, end = union + z - a, z
        elif z > end:
            union, end = union + z - end, z
    return total / 1e3, union / 1e3


def profile_step(label: str, cfg, mesh, device, b: int, frames: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from valle2_tpu_torch import train as tt
    state = tt.init_state(cfg, 'ValleAR', device=device)
    if mesh is not None:
        state = tt.shard_state(mesh, state, cfg)
    data = batch(b, frames, device)
    step = tt.make_train_step(cfg, 'ValleAR', mesh)
    for _ in range(2):
        state, _m = step(state, data, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, data, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    device_ms, union_ms = busy_ms(events, torch.device(device).index or 0)
    ka = prof.key_averages()
    kernels = sorted(((e.self_device_time_total, e.count, e.key) for e in ka
                      if e.device_type == DeviceType.CUDA and not e.is_user_annotation),
                     reverse=True)[:5]
    out = dict(arm=label, wall_ms=1e3 * wall, device_ms=device_ms,
               busy_share=union_ms / (1e3 * wall), loss=float(metrics['loss']),
               launches=sum(e.count for e in ka if e.key in ('cudaLaunchKernel',
                                                             'cuLaunchKernelEx')),
               aten_ops=sum(e.count for e in ka if e.key.startswith('aten::')),
               top_kernels=[dict(name=k[:80], calls=n, device_ms=t / 1e3)
                            for t, n, k in kernels])
    del state, data
    return out


def main() -> None:
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.parallel import make_pp_mesh
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--pipe', type=int, default=4)
    ap.add_argument('--microbatches', type=int, default=8)
    ap.add_argument('--batch', type=int, default=16)
    ap.add_argument('--frames', type=int, default=512)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('pipe_profile needs a CUDA card')
    dev = torch.device('cuda:0')
    base = dict(LARGE, dropout=0.1, batch_size=args.batch, dtype='bfloat16')
    arms = [('solo', ConfigValle(**base), None)]
    mesh = make_pp_mesh(1, args.pipe, 1, ['cuda:0'] * args.pipe)
    for sched in ('gpipe', '1f1b'):
        arms.append((f'{sched}_pipe{args.pipe}_m{args.microbatches}',
                     ConfigValle(**base, mesh_pipe=args.pipe, pp_schedule=sched,
                                 pp_microbatches=args.microbatches), mesh))
    for label, cfg, on in arms:
        print(json.dumps(dict(profile_step(label, cfg, on, dev, args.batch, args.frames),
                              card=torch.cuda.get_device_name(0))), flush=True)


if __name__ == '__main__':
    main()
