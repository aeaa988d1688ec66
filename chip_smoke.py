#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (valle2_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, one CUDA card

Phases, each printing JSON lines:

1. device    -- the card, and ``nvidia-smi``'s name and power limit.
2. build     -- compile every kernel from ``valle2_tpu_torch/csrc`` (one nvcc
                per source, all started together).
3. kernels   -- the serving kernels (flash forward #1, fused decode step #6)
                against their plain PyTorch versions at the TTS slice's
                shapes, in float32 with TF32 off and in bfloat16, with
                CUDA-event times of both (median of 30).
4. greedy    -- the full-width AR model, float32 and TF32 off: greedy token
                IDs of 32 steps through both kernels equal the IDs through the
                plain versions.
5. main      -- the serving path: a seeded ValleTTS at the benchmarked config
                (bench.py: bfloat16, max_audio_len=512, ignore_eos, 4 beams)
                answers batch_synthesize for 3 requests, then one
                synthesize_fused.  Launch counts are zeroed just before and read
                just after; every waveform must be finite and gen_len*320 long.
6. kernels   -- the training kernels: flash forward #1 (causal and
   (train)      bidirectional) and backward #3 at the AR/NAR bench shape
                (b=32, h=4, s=640), #4 + #5 at b=8, s=1280, against their
                plain versions in float32 (TF32 off) and bfloat16, with
                CUDA-event times, the time of PyTorch's
                scaled_dot_product_attention on the same inputs and mask as a
                yardstick (the port never calls it), and each kernel's bound.
7. grads     -- full width, float32, TF32 off, a synthetic batch of 4: AR and
                NAR (stage 3) loss and every parameter's grad through the
                kernels equal those through the plain bias route.
8. train     -- the training path: the bench configs (bench.py:248-332, AR
                then NAR, b=32 x 512 frames, bfloat16, dropout 0.1) through
                make_train_step, 2 warm-up steps then 10 timed ones, then 3 AR
                steps at b=8 x 1024 frames (s=1280).  Counts zeroed before,
                read after: #1, #3, #4 and #5 must all have launched.
9. fit       -- Trainer.fit on the synthetic loader at full width (AR, 20
                steps, checkpoints every 10), then a resumed fit to 25.
10. profile  -- torch.profiler over 3 bench train steps (AR, then NAR):
                device time by kernel group and the top kernels.

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
    # f32 sums in another order (and, in the fused backward, dq summed through
    # atomics in an order that changes from run to run)
    'float32': {'atol': 1e-4, 'rtol': 0.0},
    # bf16: the plain versions round every intermediate to bf16 (2^-8 relative)
    # where the kernels keep f32; p's rounding differs by tile order
    'bfloat16': {'atol': 5e-2, 'rtol': 2e-2},
}
# The training shapes: (b, tokens, frames, causal) per case; s = tokens + frames.
TRAIN_CASES = {
    'ar': (32, 128, 512, True),        # bench.py:248 bench_train
    'nar': (32, 128, 512, False),      # bench.py:291 bench_train_nar
    'ar_long': (8, 256, 1024, True),   # the 1024-frame bucket: s=1280 > 768
}
# The training path: (model, batch, frames, timed steps); tokens = frames // 4.
TRAIN_RUNS = (('ValleAR', 32, 512, 10), ('ValleNAR', 32, 512, 10), ('ValleAR', 8, 1024, 3))
# Kernel against plain route in the grads phase: the largest |grad difference|
# of a leaf over that leaf's largest |grad| (f32, TF32 off; sums in another
# order through 8 layers).
GRAD_RTOL = 1e-4
# One H100 SXM (NVIDIA's data sheet): HBM bytes/s and dense peaks by input type
# (f32 inputs with TF32 off run on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}


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


def bound(nbytes: float, flops: float, dtype_name: str) -> tuple[float, str]:
    """(ms, 'bytes' | 'operations'): the least time the card could take to
    move ``nbytes`` and do ``flops`` of ``dtype_name`` work."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def attend_mask(meta, s: int, tokens_total: int, causal: bool):
    """(b, 1, s, s) bool, True = attend: the kernels' mask, for the SDPA yardstick."""
    from valle2_tpu_torch.ops.masks import prefix_lm_attend
    attend = prefix_lm_attend(s, tokens_total, meta[:, 0], meta[:, 1], causal)
    return attend.expand(-1, s, s)[:, None]


def sdpa_ms(q, k, v, mask, do=None) -> float:
    """CUDA-event time of torch's scaled_dot_product_attention on the same
    inputs and mask: its forward, or with ``do`` its backward alone."""
    import torch
    import torch.nn.functional as F
    if do is None:
        return cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
    with torch.inference_mode(False), torch.enable_grad():
        qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        mask, do = mask.clone(), do.clone()
        out = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)
        return cuda_ms(lambda: torch.autograd.grad(out, (qq, kk, vv), do, retain_graph=True))


def reset_counters() -> None:
    from valle2_tpu_torch.kernels import flash_attention as fa
    from valle2_tpu_torch.kernels import fused_decode as fd
    for c in (fa.COUNTER, fa.BWD_FUSED_COUNTER, fa.BWD_DQ_COUNTER, fa.BWD_DKV_COUNTER,
              fd.COUNTER):
        c.reset()


def read_counters() -> dict:
    from valle2_tpu_torch.kernels import flash_attention as fa
    from valle2_tpu_torch.kernels import fused_decode as fd
    return {'flash_attention_fwd': fa.COUNTER.count,
            'flash_bwd_fused': fa.BWD_FUSED_COUNTER.count,
            'flash_bwd_dq': fa.BWD_DQ_COUNTER.count,
            'flash_bwd_dkv': fa.BWD_DKV_COUNTER.count,
            'fused_decode_step': fd.COUNTER.count}


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
    from valle2_tpu_torch.train import tree_leaves

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
            mask = attend_mask(meta, s_pre, s['ttm'], True)
            library_ms = sdpa_ms(q, k, v, mask)
            pairs = int(mask.sum()) * s['h']
            bound_ms, bound_by = bound(4 * q.numel() * q.element_size() + lse.numel() * 4,
                                       2 * 2 * s['hd'] * pairs, dtype_name)
            results[('flash_attention_fwd', dtype_name)] = dict(
                max_abs_err=max(err_o, err_l), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                tol=tol_str(dtype_name))
            emit(phase='kernels', kernel='flash_attention_fwd', dtype=dtype_name,
                 shape=[s['b'], s['h'], s_pre, s['hd']], err_o=err_o, err_lse=err_l,
                 ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=library_ms, tol=tol_str(dtype_name))

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
            # Bound: every weight, the valid cache slots of every row (source,
            # prompt, the steps so far and this one) read once; the new slot's
            # k, v and y written; the projections and attention as products.
            elt = x.element_size()
            w_bytes = sum(a.numel() * a.element_size() for a in tree_leaves(p))
            slots = int((tl_f + pl_f).sum()) + rows * (index - s['ttm'] - s['pm'] + 1)
            c_elt = ck.element_size()
            nbytes = (w_bytes + 2 * s['L'] * (slots + rows) * s['d'] * c_elt
                      + 2 * rows * s['d'] * elt)
            flops = (rows * s['L'] * 2 * (4 * s['d'] ** 2 + 2 * s['d'] * s['dff'])
                     + s['L'] * 2 * 2 * slots * s['d'])
            bound_ms, bound_by = bound(nbytes, flops, dtype_name)
            results[('fused_decode_step', dtype_name)] = dict(
                max_abs_err=max(err_y, err_k, err_v), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                tol=tol_str(dtype_name))
            emit(phase='kernels', kernel='fused_decode_step', dtype=dtype_name,
                 shape=dict(L=s['L'], rows=rows, S=S, d=s['d'], h=s['h'], dff=s['dff'],
                            index=index),
                 err_y=err_y, err_k=err_k, err_v=err_v, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, tol=tol_str(dtype_name))


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
    from valle2_tpu_torch.tts import ValleTTS

    max_new = SLICE['max_new']
    cfg = ConfigValle(max_audio_len=max_new, ignore_eos=True, dropout=0.0,
                      dtype='bfloat16')
    tts = ValleTTS(cfg, device='cuda')
    texts, pts, pcs = make_requests()
    tts.batch_synthesize(texts, pts, pcs)               # warm-up: allocator, cuBLAS
    torch.cuda.synchronize()

    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    batch = tts.batch_synthesize(texts, pts, pcs)
    single = tts.synthesize_fused(texts[0], pts[0], pcs[0])
    launches = read_counters()

    for r in batch + [single]:
        n = len(r.codes)
        if n != max_new or r.waveform.shape != (n * 320,):
            fail(f'waveform of {r.waveform.shape} for gen_len {n}')
        if not np.isfinite(r.waveform).all():
            fail('non-finite waveform samples')
    for name in ('flash_attention_fwd', 'fused_decode_step'):
        if launches[name] <= 0:
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


def train_meta(b: int, tokens: int, frames: int, device, seed: int = 0):
    """Per-row lengths like a training batch's: tokens_lens in [3/4, 1] of the
    token bucket and codes_lens (frames + BOS, capped at the bucket) in
    [3/4, 1] of the frame bucket; meta = [tokens_lens, tokens + codes_lens]."""
    import numpy as np
    import torch
    rs = np.random.RandomState(seed)
    tl = rs.randint(tokens * 3 // 4, tokens + 1, b)
    cl = rs.randint(frames * 3 // 4, frames + 1, b)
    return torch.tensor(np.stack([tl, tokens + cl], axis=1), dtype=torch.int32,
                        device=device)


def phase_train_kernels(results: dict):
    """Flash forward (#1, causal and bidirectional) and backward (#3; #4 + #5
    past FUSED_BWD_MAX_SEQ) at the training shapes against the plain versions."""
    import torch
    from valle2_tpu_torch.config import ConfigValle, precision_scope
    from valle2_tpu_torch.kernels import flash_attention as fa

    dev = torch.device('cuda')
    h, hd = SLICE['h'], SLICE['hd']
    gen = torch.Generator().manual_seed(1)
    with precision_scope(ConfigValle(matmul_precision='highest')), torch.no_grad():
        for case, (b, tt, frames, causal) in TRAIN_CASES.items():
            s = tt + frames
            meta = train_meta(b, tt, frames, dev)
            mask = attend_mask(meta, s, tt, causal)
            pairs = int(mask.sum()) * h
            for dtype_name, dt in (('float32', torch.float32), ('bfloat16', torch.bfloat16)):
                q, k, v, do = (torch.randn(b, h, s, hd, generator=gen).to(dev, dt)
                               for _ in range(4))
                o, lse = fa.flash_attention(q, k, v, meta, tt, causal)
                o_ref, lse_ref = fa.flash_attention_plain(q, k, v, meta, tt, causal)
                torch.cuda.synchronize()
                err_fwd = max(check_close(f'flash o ({case})', o, o_ref, dtype_name),
                              check_close(f'flash lse ({case})', lse, lse_ref, 'float32'))
                elt, n = q.element_size(), q.numel()
                fwd = dict(
                    max_abs_err=err_fwd,
                    ms=cuda_ms(lambda: fa.flash_attention(q, k, v, meta, tt, causal)),
                    plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, meta, tt,
                                                                      causal)),
                    library_ms=sdpa_ms(q, k, v, mask), tol=tol_str(dtype_name))
                fwd['bound_ms'], fwd['bound_by'] = bound(4 * n * elt + lse.numel() * 4,
                                                         2 * 2 * hd * pairs, dtype_name)
                results[('flash_attention_fwd', case, dtype_name)] = fwd

                args = (q, k, v, meta, o, lse, do, tt, causal)
                want = fa.flash_attention_bwd_plain(*args)
                plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(*args))
                library_ms = sdpa_ms(q, k, v, mask, do)
                in_bytes = 5 * n * elt + lse.numel() * 4     # q, k, v, o, dO, lse
                if fa.uses_fused_bwd(s):
                    got = fa.flash_bwd_fused(*args)
                    torch.cuda.synchronize()
                    errs = [check_close(f'{g} ({case}, fused)', x, w, dtype_name)
                            for g, x, w in zip(('dq', 'dk', 'dv'), got, want)]
                    kern = {'flash_bwd_fused': dict(
                        max_abs_err=max(errs), ms=cuda_ms(lambda: fa.flash_bwd_fused(*args)),
                        bound=bound(in_bytes + 3 * n * elt, 5 * 2 * hd * pairs, dtype_name))}
                else:
                    dq = fa.flash_bwd_dq(*args)
                    dk, dv = fa.flash_bwd_dkv(*args)
                    torch.cuda.synchronize()
                    kern = {
                        'flash_bwd_dq': dict(
                            max_abs_err=check_close(f'dq ({case})', dq, want[0], dtype_name),
                            ms=cuda_ms(lambda: fa.flash_bwd_dq(*args)),
                            bound=bound(in_bytes + n * elt, 3 * 2 * hd * pairs, dtype_name)),
                        'flash_bwd_dkv': dict(
                            max_abs_err=max(
                                check_close(f'dk ({case})', dk, want[1], dtype_name),
                                check_close(f'dv ({case})', dv, want[2], dtype_name)),
                            ms=cuda_ms(lambda: fa.flash_bwd_dkv(*args)),
                            bound=bound(in_bytes + 2 * n * elt, 4 * 2 * hd * pairs,
                                        dtype_name))}
                for name, r in kern.items():
                    r['bound_ms'], r['bound_by'] = r.pop('bound')
                    r.update(plain_ms=plain_ms, library_ms=library_ms, tol=tol_str(dtype_name))
                    results[(name, case, dtype_name)] = r
                emit(phase='kernels', path='train', case=case, dtype=dtype_name,
                     shape=[b, h, s, hd], causal=causal, attended_pairs=pairs,
                     flash_attention_fwd=fwd, **kern)
                del q, k, v, do, o, lse, o_ref, lse_ref, want, args


def synthetic_batch(model: str, cfg, n: int, device):
    """A collated batch of the first ``n`` synthetic items, on ``device``."""
    from valle2_tpu_torch.data import SyntheticValleDataset, get_collate
    from valle2_tpu_torch.data.prefetch import to_device
    ds = SyntheticValleDataset(cfg, size=n)
    return to_device(get_collate(model)(cfg)([ds[i] for i in range(n)]), device)


def phase_grads():
    """Loss and every grad through the kernels == through the plain bias
    route, full width, f32 with TF32 off: AR, and NAR at stage 3."""
    import dataclasses

    import torch
    from valle2_tpu_torch.config import ConfigValle, precision_scope
    from valle2_tpu_torch.kernels import flash_attention as fa
    from valle2_tpu_torch.models import ar as ar_mod
    from valle2_tpu_torch.models import nar as nar_mod
    from valle2_tpu_torch.train import init_state, tree_leaves

    dev = torch.device('cuda')
    kern_cfg = ConfigValle(dropout=0.0, matmul_precision='highest', use_flash_attention=True)
    plain_cfg = dataclasses.replace(kern_cfg, use_flash_attention=False)
    for model, loss in (('ValleAR', lambda p, c, bt: ar_mod.loss_fn(p, c, bt)),
                        ('ValleNAR', lambda p, c, bt: nar_mod.loss_at_stage(p, c, bt, 3))):
        params = init_state(kern_cfg, model, device=dev).params
        leaves = tree_leaves(params)
        batch = synthetic_batch(model, kern_cfg, 4, dev)
        out = {}
        for name, cfg in (('kernels', kern_cfg), ('plain', plain_cfg)):
            before = fa.BWD_FUSED_COUNTER.count + fa.BWD_DQ_COUNTER.count
            with precision_scope(cfg):
                value, _ = loss(params, cfg, batch)
                grads = torch.autograd.grad(value, leaves, allow_unused=True)
            launched = fa.BWD_FUSED_COUNTER.count + fa.BWD_DQ_COUNTER.count - before
            if (launched > 0) != (name == 'kernels'):
                fail(f'grads ({model}, {name}): {launched} backward kernel launches')
            out[name] = (float(value.detach()), [torch.zeros_like(p) if g is None else g
                                        for p, g in zip(leaves, grads)])
        (lk, gk), (lp, gp) = out['kernels'], out['plain']
        if not abs(lk - lp) <= 1e-5 * abs(lp):
            fail(f'grads ({model}): loss {lk} through the kernels, {lp} plain')
        worst = 0.0
        for i, (a, w) in enumerate(zip(gk, gp)):
            scale = float(w.abs().max())
            diff = float((a - w).abs().max())
            if not torch.isfinite(a).all() or diff > GRAD_RTOL * scale:
                fail(f'grads ({model}): leaf {i} {tuple(w.shape)} differs by {diff:.3e}, '
                     f'its max |grad| is {scale:.3e}')
            worst = max(worst, diff / scale if scale > 0 else 0.0)
        emit(phase='grads', model=model, dtype='float32', batch=list(batch['codes'].shape),
             loss_kernels=lk, loss_plain=lp, leaves=len(leaves),
             worst_leaf_rel_err=worst, tol=f'max|dg| <= {GRAD_RTOL:g}*max|g| per leaf, '
                                             'loss within 1e-5 relative')


def bench_data(model: str, b: int, frames: int, device):
    """bench.py's training batch: tokens frames//4 long, every row full."""
    import numpy as np
    import torch
    rs = np.random.RandomState(0)
    tt = frames // 4
    data = {'tokens': rs.randint(0, 256, (b, tt)), 'tokens_lens': np.full(b, tt),
            'codes_lens': np.full(b, frames)}
    if model == 'ValleNAR':
        data['codes'] = rs.randint(0, 1024, (b, frames, 8))
    else:
        data['codes'] = rs.randint(0, 1024, (b, frames))
        data['target'] = rs.randint(0, 1024, (b, frames))
    return {k: torch.tensor(v, dtype=torch.int32, device=device) for k, v in data.items()}


def phase_train(smi: str) -> dict:
    """The training path: the bench configs through make_train_step, then
    AR steps at s=1280.  Returns the launch counts of the path."""
    import math
    import time

    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.profiling import nar_train_step_flops, train_step_flops
    from valle2_tpu_torch.train import init_state, make_train_step

    dev = torch.device('cuda')
    for model, b, frames, _ in TRAIN_RUNS:   # warm-up: the allocator, cuBLAS, the kernels
        cfg = ConfigValle(dropout=0.1, batch_size=b, dtype='bfloat16')
        state = init_state(cfg, model, device=dev)
        step = make_train_step(cfg, model)
        data = bench_data(model, b, frames, dev)
        for _ in range(2):
            state, _m = step(state, data, 1)
    torch.cuda.synchronize()
    del state

    reset_counters()
    for model, b, frames, n in TRAIN_RUNS:
        cfg = ConfigValle(dropout=0.1, batch_size=b, dtype='bfloat16')
        state = init_state(cfg, model, device=dev)
        step = make_train_step(cfg, model)
        data = bench_data(model, b, frames, dev)
        losses = []
        for _ in range(2):
            state, m = step(state, data, 1)
            losses.append(m['loss'])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(n):
            state, m = step(state, data, 1)
            losses.append(m['loss'])
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / n
        losses = [float(x) for x in losses]
        if not all(math.isfinite(x) for x in losses):
            fail(f'train ({model}, b={b}x{frames}): non-finite loss {losses}')
        flops_fn = nar_train_step_flops if model == 'ValleNAR' else train_step_flops
        flops = flops_fn(cfg, b, frames // 4, frames)
        emit(phase='train', model=model, batch=b, frames=frames, s=frames // 4 + frames,
             dtype='bfloat16', steps=n, step_ms=1e3 * step_s, frames_per_s=b * frames / step_s,
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
             model_tflops=flops / step_s / 1e12,
             mfu_vs_bf16_dense_peak=flops / step_s / PEAK_FLOPS['bfloat16'],
             first_loss=losses[0], last_loss=losses[-1], card=smi)
        del state, data
    launches = read_counters()
    for name in ('flash_attention_fwd', 'flash_bwd_fused', 'flash_bwd_dq', 'flash_bwd_dkv'):
        if launches[name] <= 0:
            fail(f'the training path never launched {name}')
    emit(phase='train', launches=launches)
    return launches


def phase_fit():
    """Trainer.fit at full width through the synthetic loader, checkpoints
    every 10 steps, then a resumed fit."""
    import dataclasses
    import tempfile
    from pathlib import Path

    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.data import get_dataloaders
    from valle2_tpu_torch.train import Trainer, init_state

    dev = torch.device('cuda')
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg = ConfigValle(lr=1e-3, schedule='constant', max_steps=20, ckpt_every_n_steps=10,
                          batch_size=8, log_every_n_steps=10, dtype='bfloat16',
                          ckpt_path=tmp / 'ckpt', log_path=tmp / 'logs')

        def run(cfg, seed, resume):
            trainer = Trainer(cfg, 'ValleAR', device=dev)
            inner, seen = trainer.train_step, []

            def recording(state, batch, s):
                state_out, m = inner(state, batch, s)
                seen.append((state.step, m['loss']))
                return state_out, m
            trainer.train_step = recording
            train_loader, valid_loader = get_dataloaders('ValleAR', cfg, synthetic=True)
            state = trainer.fit(init_state(cfg, 'ValleAR', seed=seed, device=dev),
                                train_loader, valid_loader, resume=resume)
            return state, [(st, float(x)) for st, x in seen]

        state, seen = run(cfg, 0, False)
        losses = [x for _, x in seen]
        first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        if len(losses) != 20 or state.step != 20 or not last < first:
            fail(f'fit: {len(losses)} steps, mean loss of the first 5 {first}, of the last 5 '
                 f'{last}')
        ckpt = tmp / 'ckpt' / 'ValleAR'
        for d in ('step_10', 'step_20'):
            if not (ckpt / d / 'state.pt').exists():
                fail(f'fit: no checkpoint {d}')
        resumed, seen2 = run(dataclasses.replace(cfg, max_steps=25), 5, True)
        if resumed.step != 25 or seen2[0][0] != 20 or len(seen2) != 5:
            fail(f'fit: resume took steps {[st for st, _ in seen2]}, ended at {resumed.step}')
        emit(phase='fit', model='ValleAR', batch=cfg.batch_size, steps=len(losses),
             mean_loss_first5=first, mean_loss_last5=last,
             checkpoints=sorted(p.name for p in ckpt.glob('step_*')),
             resumed_from=seen2[0][0], resumed_to=resumed.step)


def phase_profile(smi: str, model: str = 'ValleAR', b: int = 32, frames: int = 512):
    """Where one bench train step's device time goes: torch.profiler over 3
    steps, kernel time by name, and the device's busy share of the wall time."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.train import init_state, make_train_step

    dev = torch.device('cuda')
    cfg = ConfigValle(dropout=0.1, batch_size=b, dtype='bfloat16')
    state = init_state(cfg, model, device=dev)
    step = make_train_step(cfg, model)
    data = bench_data(model, b, frames, dev)
    for _ in range(3):
        state, _m = step(state, data, 1)
    torch.cuda.synchronize()
    n = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, _m = step(state, data, 1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    groups = {'flash_fwd (#1)': ('flash_fwd',), 'flash_bwd (#3-#5)': ('flash_bwd',),
              'gemm (cuBLAS)': ('gemm', 'xmma', 'cutlass', 'nvjet'), 'adamw': ('adam',),
              'elementwise and reductions': ('elementwise', 'reduce_kernel')}
    by_group = dict.fromkeys([*groups, 'other'], 0.0)
    for e in kernels:
        ms = e.self_device_time_total / 1e3 / n
        name = e.key.lower()
        for g, pats in groups.items():
            if any(p in name for p in pats):
                by_group[g] += ms
                break
        else:
            by_group['other'] += ms
    device_ms = sum(by_group.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    emit(phase='profile', model=model, batch=b, frames=frames, dtype='bfloat16',
         profiled_wall_ms_per_step=1e3 * wall, device_ms_per_step=device_ms,
         device_busy_share=device_ms / (1e3 * wall), ms_per_step_by_group=by_group,
         top_kernels=[{'name': e.key[:90], 'calls_per_step': e.count / n,
                       'ms_per_step': e.self_device_time_total / 1e3 / n} for e in top],
         card=smi)


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
    serve = phase_main()
    phase_train_kernels(results)
    phase_grads()
    train = phase_train(smi)
    phase_fit()
    phase_profile(smi)
    phase_profile(smi, 'ValleNAR')
    keys = ('max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms', 'tol')
    kernels = []
    for name, src, replaces, shape_key, extra in (
            ('flash_attention_fwd', 'flash_attention.cu', 'flash_attention.py:290', 'ar',
             {'serve': None, 'nar': 'nar', 'ar_long': 'ar_long'}),
            ('flash_bwd_fused', 'flash_attention_bwd.cu', 'flash_attention.py:560', 'ar',
             {'nar': 'nar'}),
            ('flash_bwd_dq', 'flash_attention_bwd.cu', 'flash_attention.py:582', 'ar_long', {}),
            ('flash_bwd_dkv', 'flash_attention_bwd.cu', 'flash_attention.py:602', 'ar_long',
             {}),
            ('fused_decode_step', 'fused_decode.cu', 'fused_decode.py:706', None, {})):
        def pick(key, dtype_name):
            r = results[(name, dtype_name) if key is None else (name, key, dtype_name)]
            return {k: r[k] for k in keys}
        entry = dict(name=name, route='cuda', source=f'valle2_tpu_torch/csrc/{src}',
                     replaces=f'valle2_tpu/kernels/{replaces}',
                     launches=serve[name] + train[name],
                     launches_by_path={'serve': serve[name], 'train': train[name]},
                     dtype='bfloat16', case=shape_key or 'serve',
                     **pick(shape_key, 'bfloat16'), f32=pick(shape_key, 'float32'))
        for label, key in extra.items():
            entry[label] = dict(bf16=pick(key, 'bfloat16'), f32=pick(key, 'float32'))
        kernels.append(entry)
    emit(kernels=kernels)
    print(smi, flush=True)
    emit(ok=True, device={'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                          'count': torch.cuda.device_count()})
    return 0


if __name__ == '__main__':
    sys.exit(main())
