#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (valle2_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, one CUDA card

Phases, each printing one JSON line:

1. device   -- the card, and ``nvidia-smi``'s name and power limit.
2. build    -- compile every kernel from ``valle2_tpu_torch/csrc`` (one nvcc
               per source, all started together).
3. kernels  -- each kernel against its plain PyTorch version on the same
               inputs at the TTS slice's shapes, in float32 with TF32 off and
               in bfloat16, with CUDA-event times of both (median of 30).
4. greedy   -- the full-width AR model, float32 and TF32 off: greedy token
               IDs of 32 steps through both kernels equal the IDs through the
               plain versions.
5. main     -- the serving path: a seeded ValleTTS at the benchmarked config
               (bench.py: bfloat16, max_audio_len=512, ignore_eos, 4 beams)
               answers batch_synthesize for 3 requests, then one
               synthesize_fused.  Launch counts are zeroed just before and read
               just after; every waveform must be finite and gen_len*320 long.

Then one ``kernels`` JSON line, the raw ``nvidia-smi`` line, and last the
``{"ok": true, "device": ...}`` line.  Any failed check exits non-zero; there
is no CPU fallback.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SLICE = dict(b=3, h=4, hd=64, ttm=128, pm=257, max_new=512, L=8, d=256, dff=1024)
TOL = {  # max-abs tolerances of kernel against plain version, with their reason
    'float32': {'atol': 1e-4, 'rtol': 0.0},   # f32 sums in another order
    # bf16: the plain versions round every intermediate to bf16 (2^-8 relative)
    # where the kernels keep f32; p's rounding differs by tile order
    'bfloat16': {'atol': 5e-2, 'rtol': 2e-2},
}


def tol_str(dtype_name: str) -> str:
    """A tolerance as text: the kernels line carries only measured numbers."""
    t = TOL[dtype_name]
    return f"|err| <= {t['atol']:g} + {t['rtol']:g}*|plain|"


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f'chip_smoke: FAILED: {msg}', file=sys.stderr, flush=True)
    raise SystemExit(1)


def check_close(name: str, got, want, dtype_name: str) -> float:
    import torch
    tol = TOL[dtype_name]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = tol['atol'] + tol['rtol'] * want.abs()
    if not torch.isfinite(got).all():
        fail(f'{name} ({dtype_name}): non-finite output')
    if bool((err > bound).any()):
        fail(f'{name} ({dtype_name}): max |err| {err.max().item():.3e} over tolerance {tol}')
    return err.max().item()


def cuda_ms(fn, warmup: int = 5, reps: int = 30) -> float:
    """Median CUDA-event time of fn() in milliseconds."""
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


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this script needs a CUDA card')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    emit(phase='device', kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)
    return smi


def phase_build():
    from valle2_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    emit(phase='build', seconds=time.perf_counter() - t0,
         sources=[f'valle2_tpu_torch/csrc/{n}.cu' for n in _build.KERNEL_SOURCES])


def slice_lengths(device):
    """Per-item lengths like the main path's: tokens_lens and codes_lens
    (prompt frames + BOS) of 3 requests."""
    import torch
    tl = torch.tensor([112, 97, 81], dtype=torch.int32, device=device)
    cl = torch.tensor([151, 151, 151], dtype=torch.int32, device=device)
    return tl, cl


def phase_kernels(results: dict):
    import torch
    from valle2_tpu_torch.config import ConfigValle, precision_scope
    from valle2_tpu_torch.kernels import flash_attention as fa
    from valle2_tpu_torch.kernels import fused_decode as fd
    from valle2_tpu_torch.ops.transformer import KVCache, map_tree, transformer_init

    dev = torch.device('cuda')
    s = SLICE
    gen = torch.Generator().manual_seed(0)
    tl, cl = slice_lengths(dev)
    beams = 4
    rows = s['b'] * beams
    S = s['ttm'] + s['pm'] + s['max_new']
    index = s['ttm'] + s['pm'] + 100
    with precision_scope(ConfigValle(matmul_precision='highest')), torch.inference_mode():
        for dtype_name, dt in (('float32', torch.float32), ('bfloat16', torch.bfloat16)):
            # Flash prefill: (b, h, s, hd) with s = ttm + pm.
            s_pre = s['ttm'] + s['pm']
            q, k, v = (torch.randn(s['b'], s['h'], s_pre, s['hd'], generator=gen)
                       .to(dev, dt) for _ in range(3))
            meta = torch.stack([tl, s['ttm'] + cl], dim=1).contiguous()
            o, lse = fa.flash_attention(q, k, v, meta, s['ttm'], True)
            o_ref, lse_ref = fa.flash_attention_plain(q, k, v, meta, s['ttm'], True)
            torch.cuda.synchronize()
            err_o = check_close('flash o', o, o_ref, dtype_name)
            err_l = check_close('flash lse', lse, lse_ref, 'float32')
            ms = cuda_ms(lambda: fa.flash_attention(q, k, v, meta, s['ttm'], True))
            plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, meta, s['ttm'],
                                                                True))
            results[('flash_attention_fwd', dtype_name)] = dict(
                max_abs_err=max(err_o, err_l), ms=ms, plain_ms=plain_ms,
                tol=tol_str(dtype_name))
            emit(phase='kernels', kernel='flash_attention_fwd', dtype=dtype_name,
                 shape=[s['b'], s['h'], s_pre, s['hd']], err_o=err_o, err_lse=err_l,
                 ms=ms, plain_ms=plain_ms, tol=tol_str(dtype_name))

            # Fused decode step: cache (L, rows, S, d), 8 layers.
            p = transformer_init(gen, s['L'], s['d'], s['h'], s['dff'], adaptive_norm=False)
            p = map_tree(lambda a: a.to(dev, dt).contiguous(), p)
            ck = torch.randn(s['L'], rows, S, s['d'], generator=gen).to(dev, dt)
            cv = torch.randn(s['L'], rows, S, s['d'], generator=gen).to(dev, dt)
            x = torch.randn(rows, 1, s['d'], generator=gen).to(dev, dt)
            tl_f, pl_f = tl.repeat_interleave(beams), cl.repeat_interleave(beams)
            args = (tl_f, pl_f, s['ttm'], s['pm'])
            c_k, c_p = KVCache(ck.clone(), cv.clone()), KVCache(ck.clone(), cv.clone())
            y, _ = fd.fused_decode_step(p, x, s['h'], c_k, index, *args)
            y_ref, _ = fd.fused_decode_step_plain(p, x, s['h'], c_p, index, *args)
            torch.cuda.synchronize()
            err_y = check_close('fused y', y, y_ref, dtype_name)
            err_k = check_close('fused cache k', c_k.k, c_p.k, dtype_name)
            err_v = check_close('fused cache v', c_k.v, c_p.v, dtype_name)
            ms = cuda_ms(lambda: fd.fused_decode_step(p, x, s['h'], c_k, index, *args))
            plain_ms = cuda_ms(lambda: fd.fused_decode_step_plain(p, x, s['h'], c_p, index,
                                                                  *args))
            results[('fused_decode_step', dtype_name)] = dict(
                max_abs_err=max(err_y, err_k, err_v), ms=ms, plain_ms=plain_ms,
                tol=tol_str(dtype_name))
            emit(phase='kernels', kernel='fused_decode_step', dtype=dtype_name,
                 shape=dict(L=s['L'], rows=rows, S=S, d=s['d'], h=s['h'], dff=s['dff'],
                            index=index),
                 err_y=err_y, err_k=err_k, err_v=err_v, ms=ms, plain_ms=plain_ms,
                 tol=tol_str(dtype_name))


def make_requests(seed: int = 2):
    """3 requests as bench.py builds them: random prompt phonemes (48) and
    prompt codes (150 frames), different texts."""
    import numpy as np
    rs = np.random.RandomState(seed)
    texts = ['the quick brown fox jumps over the lazy dog.',
             'she sells sea shells by the sea shore.',
             'a port of the serving path to a new machine.']
    pts = [rs.randint(0, 256, (48,)).astype(np.int64) for _ in texts]
    pcs = [rs.randint(0, 1024, (150, 8)).astype(np.int64) for _ in texts]
    return texts, pts, pcs


def phase_greedy():
    import dataclasses

    import numpy as np
    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.data.frontend import PhonemeTokenizer
    from valle2_tpu_torch.models.ar import ValleAR

    cfg = ConfigValle(max_audio_len=32, ignore_eos=True, dropout=0.0, temperature=0.0,
                      kv_cache_dtype='float32', matmul_precision='highest')
    texts, pts, pcs = make_requests()
    tok = PhonemeTokenizer()
    tokens = [np.concatenate([pt, tok(t)]) for t, pt in zip(texts, pts)]
    kern = ValleAR(cfg, device='cuda')
    plain_cfg = dataclasses.replace(cfg, use_flash_attention=False, use_fused_decode=False)
    plain = ValleAR(plain_cfg, params=kern.params, device='cuda')
    got = kern.generate_batch(tokens, pcs)
    want = plain.generate_batch(tokens, pcs)
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            fail(f'greedy tokens through the kernels differ from the plain versions: '
                 f'{g.tolist()} vs {w.tolist()}')
    emit(phase='greedy', dtype='float32', steps=32, rows=len(texts) * cfg.num_beams,
         equal=True, first_tokens=[g[:8].tolist() for g in got])


def phase_main():
    import numpy as np
    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.kernels import flash_attention as fa
    from valle2_tpu_torch.kernels import fused_decode as fd
    from valle2_tpu_torch.tts import ValleTTS

    max_new = SLICE['max_new']
    cfg = ConfigValle(max_audio_len=max_new, ignore_eos=True, dropout=0.0,
                      dtype='bfloat16')
    tts = ValleTTS(cfg, device='cuda')
    texts, pts, pcs = make_requests()
    tts.batch_synthesize(texts, pts, pcs)               # warm-up: allocator, cuBLAS
    torch.cuda.synchronize()

    fa.COUNTER.reset()
    fd.COUNTER.reset()
    torch.cuda.reset_peak_memory_stats()
    batch = tts.batch_synthesize(texts, pts, pcs)
    single = tts.synthesize_fused(texts[0], pts[0], pcs[0])
    launches = {'flash_attention_fwd': fa.COUNTER.count, 'fused_decode_step': fd.COUNTER.count}

    for r in batch + [single]:
        n = len(r.codes)
        if n != max_new or r.waveform.shape != (n * 320,):
            fail(f'waveform of {r.waveform.shape} for gen_len {n}')
        if not np.isfinite(r.waveform).all():
            fail('non-finite waveform samples')
    for name, n in launches.items():
        if n <= 0:
            fail(f'the main path never launched {name}')
    t = batch[0].timings
    rows = len(texts) * cfg.num_beams
    emit(phase='main', requests=len(texts), max_audio_len=max_new, rows=rows,
         stage_s={k: t[k] for k in ('prefill', 'decode', 'nar', 'codec')},
         batch_wall_s=t['batched'], single_wall_s=single.timings['batched'],
         ar_tokens_per_s=len(texts) * max_new / t['decode'],
         ar_row_tokens_per_s=rows * max_new / t['decode'],
         decode_ms_per_step=1e3 * t['decode'] / max_new,
         rtf=batch[0].rtf, rtf_single=single.rtf,
         audio_s=sum(len(r.waveform) for r in batch) / 24000,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches)
    return launches


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import valle2_tpu_torch  # fails at once outside a checkout
    if Path(valle2_tpu_torch.__file__).resolve().parent != ROOT / 'valle2_tpu_torch':
        fail(f'valle2_tpu_torch was imported from {valle2_tpu_torch.__file__}, not from '
             f'the checkout that holds this script')

    smi = phase_device()
    phase_build()
    results: dict = {}
    phase_kernels(results)
    phase_greedy()
    launches = phase_main()
    kernels = []
    for name, src, replaces in (
            ('flash_attention_fwd', 'valle2_tpu_torch/csrc/flash_attention.cu',
             'valle2_tpu/kernels/flash_attention.py:290'),
            ('fused_decode_step', 'valle2_tpu_torch/csrc/fused_decode.cu',
             'valle2_tpu/kernels/fused_decode.py:706')):
        bf16 = results[(name, 'bfloat16')]
        f32 = results[(name, 'float32')]
        kernels.append(dict(
            name=name, route='cuda', source=src, replaces=replaces,
            launches=launches[name], max_abs_err=bf16['max_abs_err'], ms=bf16['ms'],
            plain_ms=bf16['plain_ms'], dtype='bfloat16', tol=bf16['tol'],
            f32=dict(max_abs_err=f32['max_abs_err'], ms=f32['ms'], plain_ms=f32['plain_ms'],
                     tol=f32['tol'])))
    emit(kernels=kernels)
    print(smi, flush=True)
    emit(ok=True, device={'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                          'count': torch.cuda.device_count()})
    return 0


if __name__ == '__main__':
    sys.exit(main())
