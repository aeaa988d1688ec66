"""Train the grammar models in the production configuration through the
train CLI, then evaluate them (``valle2_tpu/tools/grammar_production.py``).

It drives the real training CLI (``python -m valle2_tpu_torch.train -c cfg
-m Model``) as a subprocess at the reference-default scale (d_model=256, 8
layers, 4 heads, ffn 1024) or the 204M bench scale (d 1024, 16 layers, 16
heads, ffn 4096) with the production stack: bf16 compute over f32 master
params, the flash-attention kernels, bucketed collate, background device
prefetch, async checkpoints -- and a REAL mid-run interruption: the AR run
gets SIGTERM, checkpoints, exits cleanly, and a second ``--resume``
invocation continues it to the end.

Data is the compositional grammar as a first-class dataset
(``config.dataset = 'grammar://speakers=4,...'``): multi-speaker acoustics
whose per-speaker offset is recoverable ONLY from the cloning prompt, so the
held-out evaluation also measures prompt conditioning and best-of-N.

    python -m valle2_tpu_torch.tools.grammar_production [--v3] [--scale ref|204m]
    python -m valle2_tpu_torch.tools.grammar_production --smoke [--v3] --device cpu

``--device`` (default ``cuda``, ``--smoke`` included: ``--smoke`` sets only
the CPU-sized shapes) is where the CLI trains and the evaluation decodes.  Writes ``<run-dir>/report.json`` and
``--out`` (default ``<run-dir>/grammar_production.json``): loss curves,
held-out metrics, wall-clocks.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

_STEP_RE = re.compile(r'step (\d+) \| loss ([0-9.]+)')
_VALID_RE = re.compile(r'valid \| step (\d+) \| loss ([0-9.]+)')
_PACKAGE_PARENT = Path(__file__).resolve().parents[2]


def base_config(run_dir: Path, smoke: bool = False, v3: bool = False,
                scale: str = 'ref') -> dict:
    """Production-configuration hparams (the JAX tool's).  ``scale``: 'ref'
    = the reference default (d=256, 8L); '204m' = the d=1024/16L/16H bench
    configuration, remat off at its batch of 32 (a config file that sets
    ``remat: true`` reaches the CLI unchanged).  The kernel-build cache is
    ``$VALLE2_COMPILE_CACHE``, else the port's default build dir."""
    cfg = {
        # The grammar as a dataset: 4 speakers (offset recoverable only from
        # the prompt), same-voice sentence pairs teach prompt continuation.
        'dataset': 'grammar://speakers=4,pairs=540',
        # Reference-default scale.
        'd_model': 256, 'n_heads': 4, 'dim_feedforward': 1024, 'num_layers': 8,
        'norm': 'LayerNorm', 'dropout': 0.0,
        'vocab_size': 128, 'num_audio_tokens': 256, 'num_quantizers': 8,
        # Production stack.
        'dtype': 'bfloat16', 'param_dtype': 'float32',
        'use_flash_attention': 'auto', 'train_rng_impl': 'rbg',
        'prefetch_batches': 2, 'async_checkpoint': True,
        'preempt_checkpoint': True,
        'bucket_sizes': [32, 64, 96, 128],
        # Optimizer: warmup-cosine at a scale-appropriate lr.
        'lr': 1e-3, 'lr_warmup': 200, 'schedule': 'warmup_cosine',
        'betas': [0.9, 0.98], 'weight_decay': 0.01, 'gradient_clip_val': 1.0,
        'batch_size': 64, 'valid_batch_size': 64,
        'max_steps': 3000, 'log_every_n_steps': 50,
        'ckpt_every_n_steps': 500, 'keep_checkpoints': 3,
        # Generation (eval flips these per experiment).
        'max_audio_len': 96, 'temperature': 0.0, 'num_beams': 1,
        'ckpt_path': str(run_dir / 'checkpoints'),
        'log_path': str(run_dir / 'logs'),
    }
    if v3:
        # Grammar v3: K=3 renderings per phoneme with durations {2,3,4};
        # real=0 draws a fresh realization per (item, epoch), so the entropy
        # floor binds (a fixed realization set is jointly memorizable).
        cfg.update({'dataset': 'grammar://speakers=4,variants=3,real=0,'
                               'pairs=540',
                    'bucket_sizes': [64, 128, 192, 256],
                    'max_audio_len': 256, 'max_steps': 4000})
    if scale == '204m':
        # The bench scale: remat off (fits at this batch), flash on.
        cfg.update({'d_model': 1024, 'n_heads': 16, 'dim_feedforward': 4096,
                    'num_layers': 16, 'lr': 3e-4, 'lr_warmup': 300,
                    'batch_size': 32, 'valid_batch_size': 32,
                    'max_steps': 2500})
    elif scale != 'ref':
        raise ValueError(f"scale must be 'ref' or '204m', got {scale!r}")
    if smoke:
        cfg.update({'d_model': 32, 'n_heads': 2, 'dim_feedforward': 64,
                    'num_layers': 2, 'dtype': 'float32', 'max_steps': 30,
                    'lr': 2e-3, 'log_every_n_steps': 5,
                    'ckpt_every_n_steps': 10,
                    'dataset': 'grammar://speakers=2,pairs=64'
                               + (',variants=3,real=0' if v3 else ''),
                    'batch_size': 16, 'valid_batch_size': 16})
    return cfg


def _run_cli(cfg_path: Path, model: str, resume: bool = False,
             sigterm_after_step: int | None = None,
             timeout: float = 3600, device: str | None = None) -> dict:
    """Invoke the train CLI as a subprocess; parse its loss curves.

    ``sigterm_after_step``: once the live log shows an optimizer step >= this,
    send SIGTERM and expect a clean checkpoint-and-exit (train.py
    ``_PreemptGuard``).  Returns {'train': [(step, loss)...], 'valid': [...],
    'wall_s', 'rc', 'preempted_at'}.
    """
    import threading
    cmd = [sys.executable, '-m', 'valle2_tpu_torch.train', '-c', str(cfg_path),
           '-m', model] + (['--resume'] if resume else []) \
        + (['--device', device] if device else [])
    env = dict(os.environ)
    # The package this tool belongs to, ahead of whatever PYTHONPATH holds.
    env['PYTHONPATH'] = os.pathsep.join(filter(None, [str(_PACKAGE_PARENT),
                                                      env.get('PYTHONPATH')]))
    t0 = time.time()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    train_curve, valid_curve, lines = [], [], []
    preempted_at = None
    # A watchdog thread: `for line in proc.stdout` blocks in readline, so a
    # child that hangs silently would never reach a loop-body timeout check.
    timed_out = threading.Event()

    def _kill():
        timed_out.set()
        proc.kill()
    watchdog = threading.Timer(timeout, _kill)
    watchdog.start()
    try:
        assert proc.stdout is not None
        for line in proc.stdout:
            lines.append(line)
            if m := _STEP_RE.search(line):
                train_curve.append((int(m.group(1)), float(m.group(2))))
                if (sigterm_after_step is not None and preempted_at is None
                        and int(m.group(1)) >= sigterm_after_step):
                    preempted_at = int(m.group(1))
                    proc.send_signal(signal.SIGTERM)
            if m := _VALID_RE.search(line):
                valid_curve.append((int(m.group(1)), float(m.group(2))))
        rc = proc.wait()
    finally:
        watchdog.cancel()
    if timed_out.is_set():
        raise TimeoutError(f'{model} run exceeded {timeout}s; '
                           f'tail: {"".join(lines[-12:])}')
    if rc != 0:
        raise RuntimeError(f'{model} CLI exited {rc}; '
                           f'tail: {"".join(lines[-20:])}')
    return {'train': train_curve, 'valid': valid_curve,
            'wall_s': round(time.time() - t0, 1), 'rc': rc,
            'preempted_at': preempted_at}


def _latest_ckpt(run_dir: Path, model: str) -> Path:
    root = run_dir / 'checkpoints' / model
    steps = sorted((int(p.name.split('_')[1]), p) for p in root.glob('step_*')
                   if p.name.split('_')[1].isdigit())
    assert steps, f'no checkpoint for {model} under {root}'
    return steps[-1][1]


def train_all(run_dir: Path, smoke: bool = False, v3: bool = False,
              scale: str = 'ref', device: str | None = None) -> tuple[dict, dict]:
    """Three CLI runs (AR-TTS with SIGTERM+resume, NAR, ASR) -> (cfg, report)."""
    run_dir.mkdir(parents=True, exist_ok=True)
    cfg = base_config(run_dir, smoke=smoke, v3=v3, scale=scale)
    report: dict = {'config': cfg, 'runs': {}}

    # --- ValleAR (TTS): interrupt mid-run, then resume to completion. ---
    cfg_path = run_dir / 'ar.json'
    cfg_path.write_text(json.dumps(cfg, indent=1))
    interrupt_at = max(2, cfg['max_steps'] // 4)
    phase_a = _run_cli(cfg_path, 'ValleAR', sigterm_after_step=interrupt_at,
                       device=device)
    assert phase_a['preempted_at'] is not None, \
        'AR run finished before the preemption test could fire'
    ck = _latest_ckpt(run_dir, 'ValleAR')
    print(f'[grammar_production] AR preempted at step '
          f'~{phase_a["preempted_at"]}, checkpoint {ck.name}; resuming',
          flush=True)
    phase_b = _run_cli(cfg_path, 'ValleAR', resume=True, device=device)
    report['runs']['ValleAR'] = {
        'phase_a': phase_a, 'phase_b': phase_b,
        'wall_s': phase_a['wall_s'] + phase_b['wall_s'],
        'train': phase_a['train'] + phase_b['train'],
        'valid': phase_a['valid'] + phase_b['valid'],
        'final_ckpt': str(_latest_ckpt(run_dir, 'ValleAR'))}

    # --- ValleNAR and ValleASR: straight runs. ---
    nar_over = {'norm': 'AdaptiveLayerNorm',
                'max_steps': cfg['max_steps'] // 2}
    if v3:
        # Corruption training turns the NAR into a refiner (measured by
        # evaluate_nar_refinement), with the full step budget.
        nar_over['nar_corrupt_p'] = 0.3
        nar_over['max_steps'] = cfg['max_steps']
    for model, overrides in (
            ('ValleNAR', nar_over),
            ('ValleASR', {'direction': 'asr'})):
        mc = dict(cfg, **overrides)
        mc_path = run_dir / f'{model.lower()}.json'
        mc_path.write_text(json.dumps(mc, indent=1))
        res = _run_cli(mc_path, model, device=device)
        res['final_ckpt'] = str(_latest_ckpt(run_dir, model))
        report['runs'][model] = res
        report['runs'][model + '_config'] = overrides
    return cfg, report


def load_models(cfg: dict, report: dict, device=None):
    """(ar, nar, asr) of the run's final checkpoints on ``device``, each
    under the overrides its run trained with."""
    from ..config import ConfigValle
    from ..models.ar import ValleAR
    from ..models.nar import ValleNAR

    conf = ConfigValle.from_dict(cfg)

    def load(model, run_name, **over):
        m = model(dataclasses.replace(conf, **over), device=device)
        m.load(report['runs'][run_name]['final_ckpt'])
        return m

    nar_over = dict(report['runs'].get('ValleNAR_config', {}))
    nar_over.pop('max_steps', None)
    return (load(ValleAR, 'ValleAR'),
            load(ValleNAR, 'ValleNAR', norm='AdaptiveLayerNorm',
                 **{k: v for k, v in nar_over.items() if k == 'nar_corrupt_p'}),
            load(ValleAR, 'ValleASR', direction='asr'))


def evaluate(cfg: dict, report: dict, run_dir: Path,
             smoke: bool = False, v3: bool = False, device=None) -> dict:
    """Held-out closed loop + prompt-conditioning + best-of-N from the
    trained checkpoints, through the production (bf16 + flash + fused
    decode) path on ``device``.  ``v3``: the off-ceiling suite --
    validity/calibration temperature curve, best-of-N under validity,
    teacher-forced NLL vs the analytic floor, and NAR refinement of
    corrupted codebook-0 input."""
    from ..config import ConfigValle
    from ..data.frontend import PhonemeTokenizer
    from ..data.grammar import (build_grammar_datasets, evaluate_best_of_n,
                                evaluate_best_of_n_validity,
                                evaluate_closed_loop, evaluate_closed_loop_v3,
                                evaluate_nar_refinement, evaluate_nll,
                                evaluate_prompt_conditioning,
                                evaluate_prompt_conditioning_v3,
                                evaluate_temperature_curve, parse_grammar_dataset,
                                split_sentences)

    conf = ConfigValle.from_dict(cfg)
    _, _, spec = build_grammar_datasets(conf)
    opts = parse_grammar_dataset(cfg['dataset'])
    tok = PhonemeTokenizer(use_g2p=False)
    train_s, held_s = split_sentences(seed=int(opts['seed']),
                                      holdout_frac=opts['holdout'])
    if smoke:
        held_s = held_s[:4]
    ar, nar, asr = load_models(cfg, report, device)
    evals: dict = {}
    t0 = time.time()
    speakers = range(spec.num_speakers)
    if v3:
        held_eval = held_s[:6] if smoke else held_s
        # Closed loop per speaker under sampling (tau=1): TTS validity + NAR
        # consistency + ASR/text exactness.
        evals['closed_loop_v3'] = {
            s: evaluate_closed_loop_v3(ar, nar, asr, held_eval, spec, tok,
                                       prompt_text=train_s[0], speaker=s,
                                       temperature=1.0)
            for s in speakers}
        evals['temperature_curve'] = evaluate_temperature_curve(
            ar.params, ar.config, held_eval, spec, tok,
            prompt_text=train_s[0], speaker=0,
            temperatures=(0.0, 0.7, 1.0, 1.3),
            n_samples=1 if smoke else 2)
        evals['best_of_n_validity'] = evaluate_best_of_n_validity(
            ar.params, ar.config, held_eval, spec, tok,
            prompt_text=train_s[0], speaker=0, temperature=1.0,
            beams=(1, 4) if smoke else (1, 2, 4, 8))
        evals['nll'] = evaluate_nll(
            ar.params, ar.config, held_eval, spec, tok,
            prompt_text=train_s[0], speaker=0,
            realizations=2 if smoke else 4)
        evals['nar_refinement'] = evaluate_nar_refinement(
            nar, held_eval[:4] if smoke else held_eval, spec, tok,
            prompt_text=train_s[0], speaker=0,
            corrupt=(0.0, 0.2) if smoke else (0.0, 0.05, 0.15, 0.3))
        # Validity requires the PROMPT voice's offset: score it per (gen,
        # truth) pair.
        evals['prompt_conditioning_v3'] = evaluate_prompt_conditioning_v3(
            ar, held_eval, spec, tok, prompt_text=train_s[0])
    else:
        # Closed loop per speaker: the serving composition, every voice.
        evals['closed_loop'] = {
            s: {k: v for k, v in evaluate_closed_loop(
                ar, nar, asr, held_s, spec, tok, prompt_text=train_s[0],
                speaker=s).items() if k != 'texts'}
            for s in speakers}
        evals['prompt_conditioning'] = evaluate_prompt_conditioning(
            ar, held_s, spec, tok, prompt_text=train_s[0])
        evals['best_of_n'] = evaluate_best_of_n(
            ar.params, ar.config, held_s, spec, tok, prompt_text=train_s[0],
            temperature=0.7, beams=(1, 4), seed=0)
    evals['eval_wall_s'] = round(time.time() - t0, 1)
    evals['backend'] = ar.device.type
    return evals


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--run-dir', type=Path, default=None)
    p.add_argument('--smoke', action='store_true',
                   help='tiny CPU-sized run (a smoke test of the orchestration)')
    p.add_argument('--v3', action='store_true',
                   help='grammar v3: ambiguous acoustics, off-ceiling metrics '
                        '(validity/calibration/NLL-vs-floor/NAR refinement)')
    p.add_argument('--scale', default='ref', choices=('ref', '204m'),
                   help="model scale: 'ref' (d=256, the reference default) "
                        "or '204m' (d=1024/16L, the bench scale)")
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                   help='where the CLI trains and the evals decode (default: the '
                        'CUDA card, under --smoke too)')
    p.add_argument('--out', type=Path, default=None)
    p.add_argument('--eval-only', action='store_true',
                   help='reuse the checkpoints + report in --run-dir')
    args = p.parse_args(argv)
    suffix = '_204m' if args.scale == '204m' else ''
    if args.run_dir is None:
        args.run_dir = Path(('runs/grammar_v3_torch' if args.v3
                             else 'runs/grammar_torch') + suffix)
    if args.out is None:
        args.out = args.run_dir / 'grammar_production.json'
    device = args.device

    report_path = args.run_dir / 'report.json'
    if args.eval_only:
        report = json.loads(report_path.read_text())
        cfg = report['config']
    else:
        t0 = time.time()
        cfg, report = train_all(args.run_dir, smoke=args.smoke, v3=args.v3,
                                scale=args.scale, device=device)
        report['train_wall_s'] = round(time.time() - t0, 1)
        args.run_dir.mkdir(parents=True, exist_ok=True)
        report_path.write_text(json.dumps(report, indent=1))
    evals = evaluate(cfg, report, args.run_dir, smoke=args.smoke, v3=args.v3,
                     device=device)
    report['evals'] = evals
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    report_path.write_text(json.dumps(report, indent=1))

    if args.v3:
        cl0 = evals['closed_loop_v3'][0]
        print(json.dumps({
            'tts_validity_speaker0': cl0['tts_validity'],
            'text_exact_speaker0': cl0['text_exact'],
            'nll_excess_per_phoneme':
                evals['nll']['excess_nats_per_phoneme'],
            'nll_floor': evals['nll']['floor_per_phoneme'],
            'temperature_curve': [
                {'t': r['temperature'], 'validity': r['validity'],
                 'tv': r['tv_distance']}
                for r in evals['temperature_curve']],
            'best_of_n_delta':
                evals['best_of_n_validity']['best_of_n_delta'],
            'nar_refinement': evals['nar_refinement']['by_eps'],
            'prompt_match_validity':
                evals['prompt_conditioning_v3']['match_validity'],
            'prompt_mismatch_validity':
                evals['prompt_conditioning_v3']['mismatch_validity'],
            'train_wall_s': report.get('train_wall_s'),
        }, indent=1))
    else:
        pc = evals['prompt_conditioning']
        cl0 = evals['closed_loop'][0]
        print(json.dumps({
            'text_exact_speaker0': cl0['text_exact'],
            'tts_exact_speaker0': cl0['tts_exact'],
            'prompt_match_exact': pc['match_exact'],
            'prompt_mismatch_exact': pc['mismatch_exact'],
            'best_of_n': {k: v for k, v in evals['best_of_n'].items()
                          if k.startswith('beams') or k == 'best_of_n_delta'},
            'train_wall_s': report.get('train_wall_s'),
        }, indent=1))


if __name__ == '__main__':
    main()
