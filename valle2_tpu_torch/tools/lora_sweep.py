"""LoRA voice adaptation on a trained grammar base
(``valle2_tpu/tools/lora_sweep.py``).

Loads a run directory that ``tools.grammar_production`` wrote (v2
acoustics: 4 speakers), introduces a 5th held-out speaker (an offset never
seen in training), and races LoRA adapters (rank sweep 4/16/64) against a
full fine-tune on epochs-to-quality, trainable/adapter bytes and wall-clock,
training through the port's ``init_state`` / ``make_train_step`` on the
device.  The adapted voice then serves through the multi-voice path
(``ValleTTS.batch_synthesize(override_params=...)``) and per-voice held-out
exactness is checked: voice 4 through the adapter, voice 0 through the
untouched base.

    python -m valle2_tpu_torch.tools.lora_sweep --run-dir runs/grammar_torch
    python -m valle2_tpu_torch.tools.lora_sweep --run-dir DIR --smoke --device cpu

Writes ``--out`` (default ``<run-dir>/lora_sweep.json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

NEW_SPEAKER = 4
QUALITY_GATE = 0.95          # held-out exactness that counts as "adapted"


def _exactness(model, sentences, spec, tok, prompt_text, speaker) -> float:
    from ..data.grammar import synthesize_codes

    p_toks = tok(prompt_text + ' ')
    pcodes = np.ascontiguousarray(synthesize_codes(p_toks, spec, speaker).T)
    gen = model.generate_batch(
        [np.concatenate([p_toks, tok(s)]) for s in sentences],
        [pcodes] * len(sentences))
    truth = [synthesize_codes(tok(s), spec, speaker) for s in sentences]
    return float(np.mean([len(g) == t.shape[1] and np.array_equal(g.numpy(), t[0])
                          for g, t in zip(gen, truth)]))


def adapt(base_params, base_cfg, rank: int, train_ds, held_s, spec, tok,
          prompt_text: str, max_epochs: int, lr: float, seed: int = 0,
          device=None) -> tuple[dict, dict]:
    """Fine-tune for the new speaker on ``device`` (LoRA if rank>0, full if
    rank=0); evaluate held-out exactness after EVERY epoch ->
    epochs-to-quality.  Returns (the arm's record, the merged params)."""
    from .. import lora
    from ..config import resolve_device
    from ..data.collate import get_collate
    from ..data.dataset import DataLoader
    from ..data.prefetch import to_device
    from ..models.ar import ValleAR, param_count
    from ..ops.transformer import map_tree
    from ..train import init_state, make_train_step

    device = resolve_device(device)
    ft_cfg = dataclasses.replace(
        base_cfg, lora_rank=rank, lora_alpha=2.0 * rank if rank else 16.0,
        lr=lr, schedule='constant',
        lora_targets=('qkv', 'out', 'lin1', 'lin2', 'proj'))
    collate = get_collate('ValleAR')(ft_cfg)
    loader = DataLoader(train_ds, ft_cfg.batch_size, collate, shuffle=True,
                        seed=seed)
    state = init_state(ft_cfg, 'ValleAR', seed=seed, base_params=base_params,
                       device=device)
    step_fn = make_train_step(ft_cfg, 'ValleAR')
    t0 = time.time()
    curve, steps = [], 0
    epochs_to_gate = None
    serve_params = None
    for epoch in range(max_epochs):
        for batch in loader:
            state, m = step_fn(state, to_device(batch, device), seed + 1)
            steps += 1
        merged = map_tree(torch.Tensor.detach, lora.merged(state.params, ft_cfg))
        exact = _exactness(ValleAR(base_cfg, params=merged, device=device), held_s,
                           spec, tok, prompt_text, NEW_SPEAKER)
        curve.append({'epoch': epoch + 1, 'steps': steps,
                      'loss': float(m['loss']), 'exact_new_voice': exact})
        if exact >= QUALITY_GATE and epochs_to_gate is None:
            epochs_to_gate = epoch + 1
            serve_params = merged
            break
    if serve_params is None:
        serve_params = merged
    n_train = (lora.adapter_count(state.params['lora']) if rank
               else param_count(base_params))
    return {'rank': rank, 'trainable_params': int(n_train),
            'adapter_bytes': int(n_train) * 4,
            'epochs_to_gate': epochs_to_gate, 'steps': steps,
            'wall_s': round(time.time() - t0, 1),
            'final_exact_new_voice': curve[-1]['exact_new_voice'],
            'curve': curve}, serve_params


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--run-dir', type=Path, default=Path('runs/grammar_torch'))
    p.add_argument('--out', type=Path, default=None,
                   help='default <run-dir>/lora_sweep.json')
    p.add_argument('--ranks', default='4,16,64')
    p.add_argument('--full-ft', action='store_true', default=True)
    p.add_argument('--max-epochs', type=int, default=40)
    p.add_argument('--held', type=int, default=16,
                   help='held-out sentences per exactness eval (the eval '
                        'decodes this many EVERY epoch per arm)')
    p.add_argument('--smoke', action='store_true',
                   help='CPU-sized shapes: rank 4 only, few epochs, small eval')
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                   help='where the arms train and decode (default: the CUDA '
                        'card, under --smoke too)')
    args = p.parse_args(argv)
    if args.out is None:
        args.out = args.run_dir / 'lora_sweep.json'
    device = args.device

    from ..config import ConfigValle
    from ..data.frontend import PhonemeTokenizer
    from ..data.grammar import (GrammarDataset, build_grammar_datasets,
                                multispeaker_spec, parse_grammar_dataset,
                                split_sentences, synthesize_codes)
    from ..models.ar import ValleAR
    from ..models.nar import ValleNAR
    from ..tts import ValleTTS

    report = json.loads((args.run_dir / 'report.json').read_text())
    base_cfg = ConfigValle.from_dict(report['config'])
    base_cfg = dataclasses.replace(base_cfg, temperature=0.0, num_beams=1,
                                   dropout=0.0)
    ar = ValleAR(base_cfg, device=device)
    ar.load(report['runs']['ValleAR']['final_ckpt'])
    base_params = ar.params
    _, _, spec4 = build_grammar_datasets(base_cfg)
    # 5-speaker spec, same motif algebra: speakers 0-3 are bit-identical to
    # the training spec; speaker 4's offset (4*29=116) is NEW.
    spec5 = multispeaker_spec(
        NEW_SPEAKER + 1, num_audio_tokens=spec4.num_audio_tokens,
        num_quantizers=spec4.num_quantizers)
    opts = parse_grammar_dataset(report['config']['dataset'])
    tok = PhonemeTokenizer(use_g2p=False)
    train_s, held_s = split_sentences(seed=int(opts['seed']),
                                      holdout_frac=opts['holdout'])
    held_s = held_s[:max(args.held, 1)]
    if args.smoke:
        held_s = held_s[:4]
        args.ranks, args.max_epochs = '4', 3
    ranks = [int(r) for r in args.ranks.split(',')]
    train_ds = GrammarDataset(train_s, spec5, tok,
                              n_pairs=int(opts['pairs']),
                              speakers=(NEW_SPEAKER,))

    out: dict = {'run_dir': str(args.run_dir), 'quality_gate': QUALITY_GATE,
                 'new_speaker': NEW_SPEAKER, 'n_held': len(held_s),
                 'backend': ar.device.type, 'arms': {}}
    # Baselines: the base model on the new voice (should FAIL — the offset is
    # unseen) and on voice 0 (should stand at its trained exactness).
    out['base_exact_new_voice'] = _exactness(ar, held_s, spec5, tok,
                                             train_s[0], NEW_SPEAKER)
    out['base_exact_voice0'] = _exactness(ar, held_s, spec5, tok,
                                          train_s[0], 0)
    serve_views = {}
    arms = [(r, 3e-3) for r in ranks] + ([(0, 3e-4)] if args.full_ft else [])
    for rank, lr in arms:
        res, params = adapt(base_params, base_cfg, rank, train_ds, held_s,
                            spec5, tok, train_s[0], args.max_epochs, lr,
                            device=device)
        name = f'rank{rank}' if rank else 'full_ft'
        out['arms'][name] = res
        serve_views[name] = params
        print(f'{name}: exact={res["final_exact_new_voice"]:.3f} '
              f'epochs_to_gate={res["epochs_to_gate"]} '
              f'trainable={res["trainable_params"]:,} '
              f'wall={res["wall_s"]}s', flush=True)
        # Voice preservation: the MERGED weights on voice 0 (interference if
        # low) vs the base weights (multi-voice serving keeps per-voice
        # params, so interference is a quality note, not a serving bug).
        out['arms'][name]['merged_exact_voice0'] = _exactness(
            ValleAR(base_cfg, params=params, device=device), held_s, spec5, tok,
            train_s[0], 0)

    # Multi-voice serving: ONE ValleTTS, the new voice served through
    # override_params.
    pick = next((f'rank{r}' for r in ranks
                 if out['arms'][f'rank{r}']['final_exact_new_voice']
                 >= QUALITY_GATE), f'rank{ranks[-1]}')
    nar = ValleNAR(dataclasses.replace(base_cfg, norm='AdaptiveLayerNorm'), device=device)
    nar.load(report['runs']['ValleNAR']['final_ckpt'])
    tts = ValleTTS(base_cfg, ar=ar, nar=nar, tokenizer=tok, device=device)
    p_toks = tok(train_s[0] + ' ')
    texts = held_s[:4]
    voice_ar = ValleAR(base_cfg, params=serve_views[pick], device=device)
    serve_exact = {}
    for voice, params_over, spk in (('base', None, 0),
                                    ('adapted', voice_ar.decode_params,
                                     NEW_SPEAKER)):
        pcodes = np.ascontiguousarray(
            synthesize_codes(p_toks, spec5, spk).T)
        results = tts.batch_synthesize(
            texts, [p_toks] * len(texts), [pcodes] * len(texts),
            override_params=(params_over, None) if params_over is not None
            else None)
        truth = [synthesize_codes(tok(s), spec5, spk) for s in texts]
        serve_exact[voice] = float(np.mean(
            [r.codes.shape[0] >= t.shape[1]
             and np.array_equal(r.codes[:t.shape[1], 0], t[0])
             for r, t in zip(results, truth)]))
    out['serving'] = {'picked_arm': pick, 'per_voice_exact': serve_exact}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps({'arms': {k: {kk: v[kk] for kk in
                                   ('final_exact_new_voice', 'epochs_to_gate',
                                    'trainable_params', 'wall_s',
                                    'merged_exact_voice0')}
                               for k, v in out['arms'].items()},
                      'serving': out['serving'],
                      'base_exact_new_voice': out['base_exact_new_voice']},
                     indent=1))


if __name__ == '__main__':
    main()
