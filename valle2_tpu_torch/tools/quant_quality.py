"""Quantized-serving QUALITY on trained grammar weights
(``valle2_tpu/tools/quant_quality.py``).

Loads a run directory that ``tools.grammar_production`` wrote (its
``report.json`` and the AR's final checkpoint; a JAX run dir reaches the
port through ``scripts/orbax_to_torch.py``) and sweeps

    weight_dtype in {compute, int8 (W8A8), int4 (W4A16)}
  x kv_cache_dtype in {float32, bfloat16, int8}
  x fused decode in {on, off}

scoring every cell's GREEDY decode on the held-out split: exact match of
codebook 0 vs ground truth (v2) or realization validity via the parser (v3),
plus first-token-stream accuracy, the teacher-forced NLL of the cell's weight
layout and the measured decode wall-clock on the device.  "Fused on" is
``use_fused_decode=True``: the fused decode kernels (#6, #6a) on the card,
which raise where the stack does not fit them; "off" is the per-layer
decode step (``use_fused_decode=False``).  A cell that raises is recorded
with its error.  Output: the grid and a recommended serving config (the
fastest cell within a quality epsilon of the compute/float32/unfused
reference cell).

    python -m valle2_tpu_torch.tools.quant_quality --run-dir runs/grammar_torch
    python -m valle2_tpu_torch.tools.quant_quality --v3 --run-dir runs/grammar_v3_torch
    python -m valle2_tpu_torch.tools.quant_quality --run-dir DIR --limit 4 --device cpu

Writes ``--out`` (default ``<run-dir>/quant_quality.json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

REFERENCE_CELL = 'compute/float32/unfused'


def _truth_codes(token_ids, spec, speaker, v3: bool, seed: int = 777):
    """Ground-truth codes for one utterance: the deterministic v2 realization
    or a seeded v3 sample."""
    from ..data.grammar import sample_realization, synthesize_codes
    if v3:
        codes, _ = sample_realization(token_ids, spec, speaker,
                                      np.random.RandomState(seed))
        return codes
    return synthesize_codes(token_ids, spec, speaker)


def cell_nll(ar, sentences, spec, tok, prompt_text, speaker, v3: bool
             ) -> float:
    """Teacher-forced per-token NLL of held-out ground truth under this
    cell's WEIGHT layout (prompt-conditioned; the KV dtype is decode-only and
    does not enter).  int8/int4 perturb logits measurably even when every
    greedy argmax survives."""
    from ..data.grammar import _nll_batch, _score_nll

    cfg = ar.config
    p_toks = tok(prompt_text + ' ')
    pcodes = _truth_codes(p_toks, spec, speaker, v3)
    rows = []
    for si, s in enumerate(sentences):
        t = tok(s)
        c0 = np.concatenate([pcodes[0],
                             _truth_codes(t, spec, speaker, v3, 131 * si)[0]])
        rows.append({'tokens': np.concatenate([p_toks, t]).astype(np.int32),
                     'codes': np.concatenate([[cfg.bos_token], c0]).astype(np.int32),
                     'target': np.concatenate([c0, [cfg.eos_token]]).astype(np.int32),
                     'start': pcodes.shape[1]})
    batch = _nll_batch(rows, cfg.bucket_sizes, ar.device)
    sums = _score_nll(ar.decode_params, cfg, *batch)
    tokens_lens, codes_lens, starts = batch[3:]
    n = int((codes_lens - starts).sum())
    return float(sums.double().sum()) / n


def decode_cell(ar, sentences, spec, tok, prompt_text, speaker, v3: bool
                ) -> tuple[list[np.ndarray], float]:
    """The cell's greedy codebook-0 decode of ``sentences`` (a warm-up
    decode of one sentence first) and its wall seconds, the device
    synchronized."""
    from ..data.grammar import sample_realization, synthesize_codes

    p_toks = tok(prompt_text + ' ')
    if v3:
        rs = np.random.RandomState(777)
        pcodes_arr, _ = sample_realization(p_toks, spec, speaker, rs)
    else:
        pcodes_arr = synthesize_codes(p_toks, spec, speaker)
    pcodes = np.ascontiguousarray(pcodes_arr.T)
    batch_tokens = [np.concatenate([p_toks, tok(s)]) for s in sentences]
    batch_codes = [pcodes] * len(sentences)
    _ = ar.generate_batch(batch_tokens[:1], batch_codes[:1])
    if ar.device.type == 'cuda':
        torch.cuda.synchronize(ar.device)
    t0 = time.perf_counter()
    gen0 = [g.numpy() for g in ar.generate_batch(batch_tokens, batch_codes)]
    return gen0, time.perf_counter() - t0


def score_cell(ar, sentences, spec, tok, prompt_text, speaker, v3: bool
               ) -> dict:
    """Greedy-decode ``sentences`` through one serving configuration and
    score against the grammar ground truth."""
    from ..data.grammar import _token_acc, parse_codes0, synthesize_codes

    gen0, wall = decode_cell(ar, sentences, spec, tok, prompt_text, speaker, v3)
    token_lists = [tok(s) for s in sentences]
    n_tok = int(sum(len(g) for g in gen0))
    if v3:
        parses = [parse_codes0(g, t, spec, speaker)
                  for g, t in zip(gen0, token_lists)]
        quality = float(np.mean([p['valid'] for p in parses]))
        tokacc = float(np.mean([p['n_parsed'] / max(p['n_tokens'], 1)
                                for p in parses]))
    else:
        truth = [synthesize_codes(t, spec, speaker) for t in token_lists]
        quality = float(np.mean(
            [len(g) == tr.shape[1] and np.array_equal(g, tr[0])
             for g, tr in zip(gen0, truth)]))
        tokacc = float(np.mean([_token_acc(g, tr[0])
                                for g, tr in zip(gen0, truth)]))
    return {'quality': quality, 'token_acc': tokacc,
            'decode_wall_s': round(wall, 3),
            'tokens_per_s': round(n_tok / wall, 1) if wall > 0 else None}


def cells() -> list[tuple[str, str, bool]]:
    """(weight_dtype, kv_cache_dtype, use_fused_decode) of every grid cell."""
    return [(w, k, f)
            for w in ('compute', 'int8', 'int4')
            for k in ('float32', 'bfloat16', 'int8')
            for f in (True, False)]


def cell_name(w: str, k: str, fused: bool) -> str:
    return f'{w}/{k}/{"fused" if fused else "unfused"}'


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--run-dir', type=Path, default=None)
    p.add_argument('--v3', action='store_true')
    p.add_argument('--out', type=Path, default=None,
                   help='default <run-dir>/quant_quality.json')
    p.add_argument('--limit', type=int, default=0,
                   help='cap held-out sentences (a smoke run)')
    p.add_argument('--speaker', type=int, default=0)
    p.add_argument('--quality-eps', type=float, default=0.02,
                   help='recommended config = fastest cell within eps of '
                        'the reference cell quality')
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                   help='where every cell decodes (default: the CUDA card)')
    args = p.parse_args(argv)
    if args.run_dir is None:
        args.run_dir = Path('runs/grammar_v3_torch' if args.v3
                            else 'runs/grammar_torch')
    if args.out is None:
        args.out = args.run_dir / 'quant_quality.json'

    from ..config import ConfigValle
    from ..data.frontend import PhonemeTokenizer
    from ..data.grammar import (build_grammar_datasets, parse_grammar_dataset,
                                split_sentences)
    from ..models.ar import ValleAR

    report = json.loads((args.run_dir / 'report.json').read_text())
    cfg = ConfigValle.from_dict(report['config'])
    ckpt = report['runs']['ValleAR']['final_ckpt']
    _, _, spec = build_grammar_datasets(cfg)
    opts = parse_grammar_dataset(report['config']['dataset'])
    tok = PhonemeTokenizer(use_g2p=False)
    train_s, held_s = split_sentences(seed=int(opts['seed']),
                                      holdout_frac=opts['holdout'])
    if args.limit:
        held_s = held_s[:args.limit]

    # Greedy + single beam: quantization error shows up as flipped argmax.
    base = dataclasses.replace(cfg, temperature=0.0, num_beams=1)
    grid: dict[str, dict] = {}
    nll_by_weight: dict[str, float] = {}
    for w, k, f in cells():
        name = cell_name(w, k, f)
        try:
            m = ValleAR(dataclasses.replace(base, weight_dtype=w, kv_cache_dtype=k,
                                            use_fused_decode=f), device=args.device)
            m.load(ckpt)
            grid[name] = score_cell(m, held_s, spec, tok, train_s[0],
                                    args.speaker, args.v3)
            if w not in nll_by_weight:
                # Teacher-forced NLL depends only on the WEIGHT layout (KV
                # and the fused kernel are decode-side): one forward per
                # weight dtype.
                nll_by_weight[w] = cell_nll(m, held_s, spec, tok, train_s[0],
                                            args.speaker, args.v3)
            grid[name]['nll_per_token'] = round(nll_by_weight[w], 5)
            print(f'{name:32s} quality={grid[name]["quality"]:.3f} '
                  f'tok_acc={grid[name]["token_acc"]:.3f} '
                  f'nll={grid[name]["nll_per_token"]:.4f} '
                  f'wall={grid[name]["decode_wall_s"]}s', flush=True)
        except Exception as e:  # noqa: BLE001 — record per-cell failures
            grid[name] = {'error': f'{type(e).__name__}: {e}'}
            print(f'{name:32s} ERROR {type(e).__name__}: {e}', flush=True)

    ref_q = grid.get(REFERENCE_CELL, {}).get('quality')
    rec = None
    if ref_q is not None:
        ok_cells = [(n, c) for n, c in grid.items()
                    if c.get('quality') is not None
                    and c['quality'] >= ref_q - args.quality_eps
                    and c.get('tokens_per_s')]
        if ok_cells:
            rec = max(ok_cells, key=lambda nc: nc[1]['tokens_per_s'])[0]
    dev = torch.device(args.device)
    out = {'run_dir': str(args.run_dir), 'v3': args.v3,
           'n_sentences': len(held_s), 'speaker': args.speaker,
           'reference_cell': REFERENCE_CELL, 'reference_quality': ref_q,
           'recommended': rec, 'backend': dev.type, 'grid': grid}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps({'recommended': rec, 'reference_quality': ref_q},
                     indent=1))


if __name__ == '__main__':
    main()
