"""Cold-start benchmark: what a RESTARTED serving process pays before its
first request, under each caching layer (``valle2_tpu/tools/coldstart_bench.py``).

Each invocation is ONE fresh process (that is what cold start means); run the
modes back to back and compare their JSON lines:

    python -m valle2_tpu_torch.tools.coldstart_bench compile   # kernel-build cache only
    python -m valle2_tpu_torch.tools.coldstart_bench aot       # + the AOT library dir
    python -m valle2_tpu_torch.tools.coldstart_bench warmup    # TTSServer.warmup()
    python -m valle2_tpu_torch.tools.coldstart_bench decompose-compile
    python -m valle2_tpu_torch.tools.coldstart_bench decompose-aot

Options: ``-c cfg.json`` (default: the serving config, bf16, 512 frames,
greedy), ``--device`` (default ``cuda``), ``--compile-cache DIR`` and
``--aot-cache DIR`` (default: ``$VALLE2_COMPILE_CACHE``, else
``valle2_tpu_torch/_build/``; ``$VALLE2_AOT_CACHE``, else ``_build/aot``).

What compiles in the port is nvcc (``kernels._build``): the first run of a
mode over an empty directory builds every library the program launches
(70-116 s on an H100 host); later fresh processes load them.  Every line
carries ``first_request_s`` (process start to the end of the first request)
and the fused pipeline's counters ``aot_compiles`` (nvcc runs),
``aot_disk_loads`` and ``aot_fallbacks`` (``aot.CachedJit``).  The
``decompose-*`` modes split the first request into ``compile_s`` (nvcc),
``load_s`` (loading the libraries) and ``first_exec_s`` (the rest of the
first call), from the loads recorded during it (``_build.record_loads``).
The JAX tool's ``programs`` modes time XLA programs and have no counterpart.
"""
from __future__ import annotations

import json
import sys
import time

_T_START = time.perf_counter()
MODES = ('compile', 'aot', 'warmup', 'decompose-compile', 'decompose-aot')


def _setup(args):
    import dataclasses

    from ..aot import enable_aot_cache
    from ..compile_cache import cache_dir, enable_compilation_cache
    from ..config import ConfigValle
    enable_compilation_cache(args.compile_cache)
    if 'aot' in args.mode:
        from pathlib import Path
        enable_aot_cache(args.aot_cache, fallback=str(Path(cache_dir()) / 'aot'))
    if args.config is not None:
        cfg = ConfigValle.from_json(args.config)
    else:
        cfg = ConfigValle(dtype='bfloat16', max_audio_len=512)
    beams = 1 if args.mode == 'warmup' else cfg.num_beams
    return dataclasses.replace(cfg, temperature=0.0, num_beams=beams)


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description='Cold start of a serving process')
    parser.add_argument('mode', choices=MODES)
    parser.add_argument('-c', '--config', default=None)
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--compile-cache', default=None)
    parser.add_argument('--aot-cache', default=None)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)

    import numpy as np
    import torch

    from ..kernels import _build
    from ..tts import ValleTTS
    cfg = _setup(args)
    dev = torch.device(args.device)
    tts = ValleTTS(cfg, device=dev)
    rs = np.random.RandomState(0)
    pt = rs.randint(0, 70, (12,))
    pc = rs.randint(0, 1024, (75, 8))
    text = 'hello world, this is a cold start measurement.'
    out: dict = {'mode': args.mode, 'device': str(dev)}

    def sync():
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)

    def counters() -> dict:
        cj = tts._fused_jit
        return dict(aot_compiles=cj.n_compiles, aot_disk_loads=cj.n_disk_loads,
                    aot_fallbacks=cj.n_fallbacks)

    def request():
        return tts.synthesize_fused(text, pt, pc,
                                    generator=torch.Generator(device=dev).manual_seed(0))

    t_init = time.perf_counter()
    out['init_s'] = t_init - _T_START
    if args.mode == 'warmup':
        from ..serve import TTSServer
        server = TTSServer(tts, max_batch=8)
        out['warmup_s'] = server.warmup(streams=True)
        with server:
            r = server.synthesize(text, pt, pc)
        sync()
        stats = server.stats()
        out.update(total_s=time.perf_counter() - _T_START,
                   **{k: stats[k] for k in ('aot_compiles', 'aot_disk_loads', 'aot_fallbacks')})
    elif args.mode in ('compile', 'aot'):
        r = request()
        sync()
        t_first = time.perf_counter()
        request()
        sync()
        out.update(first_call_s=t_first - t_init,
                   second_call_s=time.perf_counter() - t_first, **counters())
    else:
        with _build.record_loads() as events:
            r = request()
            sync()
        first = time.perf_counter() - t_init
        compile_s = sum(e['build_s'] for e in events)
        load_s = sum(e['load_s'] for e in events)
        out.update(compile_s=compile_s, load_s=load_s, first_exec_s=first - compile_s - load_s,
                   libraries={e['name']: e['how'] for e in events}, **counters())
    out['first_request_s'] = time.perf_counter() - _T_START if args.mode != 'warmup' \
        else out['total_s']
    out['codes_sum'] = int(np.asarray(r.codes).sum())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
