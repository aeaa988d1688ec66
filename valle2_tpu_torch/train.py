"""Training loop on one device: update step, AdamW, checkpoints, metrics.

PyTorch counterpart of ``valle2_tpu/train.py``.  One eager step does forward,
backward (through the flash attention kernels on the card), global-norm clip
and AdamW; ``grad_accum`` > 1 averages micro-batch grads and updates once per
``grad_accum`` micro-steps, as ``optax.MultiSteps`` does.  Checkpoints are
``torch.save`` files in ``<ckpt_path>/<model>/step_<N>/``; resume replays the
exact batch and dropout stream of an uninterrupted run.  Metrics go to
TensorBoard through tensorboardX where that package imports.  With
``config.lora_rank`` > 0 the run fine-tunes LoRA adapters (``lora.py``): the
params are ``{'base', 'lora'}``, the optimizer holds the adapters only, the
base stays bit-identical, and the step merges ``w + scale * A @ B`` inside its
forward, so autograd reaches A and B alone.

``config.dataset`` may name the grammar (``grammar://speakers=4,...``,
``data/grammar.py``) instead of ``--synthetic``; ``config.remat`` runs
each layer again in the backward instead of keeping its activations.

    python -m valle2_tpu_torch.train -c cfg.json -m ValleAR --synthetic [--resume]
                                     [--device cuda|cpu] [--profile DIR] [--debug-nans]
                                     [--compile-cache DIR] [--aot-cache DIR]

Parameters are updated in place (the JAX step returns new arrays): the
optimizer holds the leaf tensors, and ``TrainState`` carries them along.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import shutil
import signal
import threading
import time
from pathlib import Path
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from . import lora as lora_mod
from .aot import cached_jit, config_key
from .config import ConfigValle, precision_scope, resolve_device
from .data.dataset import get_dataloaders
from .data.prefetch import DevicePrefetcher, to_device
from .models import ar as ar_mod
from .models import nar as nar_mod
from .models.checkpoint import STATE_FILE, atomic_save, load_params, to_cpu
from .ops.transformer import map_tree
from .profiling import annotate, nan_checks_enabled

Params = dict[str, Any]
log = logging.getLogger('valle2_tpu_torch.train')

LOSS_FNS = {
    'ValleAR': ar_mod.loss_fn,
    'ValleASR': ar_mod.loss_fn,
    'ValleNAR': nar_mod.loss_fn,
}
INIT_FNS = {
    'ValleAR': ar_mod.init_params,
    'ValleASR': ar_mod.init_params,
    'ValleNAR': nar_mod.init_params,
}


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensor leaves of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every element (``optax.global_norm``)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def lr_schedule(config: ConfigValle) -> Callable[[int], float]:
    """Learning rate at an optimizer step.  'cosine_restarts': the reference's
    CosineAnnealingWarmRestarts(T_0=lr_warmup), stepped per optimizer step;
    'warmup_cosine': ``optax.warmup_cosine_decay_schedule(0, lr, lr_warmup,
    max(max_steps, lr_warmup + 1))``; 'constant'."""
    lr = config.lr
    if config.schedule == 'cosine_restarts':
        period = max(config.lr_warmup, 1)
        return lambda step: lr * 0.5 * (1.0 + math.cos(math.pi * (step % period) / period))
    if config.schedule == 'warmup_cosine':
        warmup = config.lr_warmup
        decay = max(config.max_steps, warmup + 1) - warmup

        def sched(step):
            if step < warmup:
                return lr * step / warmup
            t = min(step - warmup, decay)
            return lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))
        return sched
    return lambda step: lr


class Optimizer:
    """``optax.MultiSteps(chain(clip_by_global_norm(gradient_clip_val),
    adamw(lr_schedule, betas, eps=1e-8, weight_decay)), grad_accum)``.

    AdamW is ``torch.optim.AdamW`` over every leaf (optax's adamw is
    unmasked); its decoupled decay ``p *= 1 - lr*wd`` before the Adam step is
    optax's ``-lr*(adam + wd*p)``.  The clip scales by max_norm/norm only when
    norm >= max_norm, as optax does (no epsilon).  Micro-batch grads average
    as a running mean, the optax formula."""

    def __init__(self, params: Params, config: ConfigValle):
        self.leaves = tree_leaves(params)
        self.max_norm = config.gradient_clip_val
        self.schedule = lr_schedule(config)
        self.k = max(1, config.grad_accum)
        fused = bool(config.use_fused_adam) and self.leaves[0].device.type == 'cuda'
        self.adamw = torch.optim.AdamW(self.leaves, lr=config.lr, betas=config.betas,
                                       eps=1e-8, weight_decay=config.weight_decay,
                                       fused=True if fused else None)
        self.acc: list[torch.Tensor] | None = None
        self.mini_step = 0      # micro-batches accumulated towards the next update
        self.count = 0          # updates applied (the schedule's step)

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor]) -> bool:
        """Feed one micro-batch's grads (aligned with ``leaves``); returns
        True when this call applied an update."""
        if self.k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.k:
                return False
            grads, self.acc, self.mini_step = self.acc, None, 0
        norm = global_norm(grads)
        clip = norm < self.max_norm
        for p, g in zip(self.leaves, grads):
            p.grad = torch.where(clip, g, g / norm * self.max_norm)
        for group in self.adamw.param_groups:
            group['lr'] = self.schedule(self.count)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.count += 1
        return True

    def state_dict(self) -> dict:
        return {'adamw': self.adamw.state_dict(), 'acc': self.acc,
                'mini_step': self.mini_step, 'count': self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state['adamw'])
        acc = state['acc']
        self.acc = None if acc is None else [a.to(p.device) for a, p in zip(acc, self.leaves)]
        self.mini_step, self.count = int(state['mini_step']), int(state['count'])


class TrainState(NamedTuple):
    params: Params          # trained leaves require grad; the optimizer updates them in place
    opt_state: Optimizer
    step: int               # micro-steps taken (the dropout generator's step)


def init_state(config: ConfigValle, model_name: str, seed: int | None = None,
               base_params: Params | None = None, device=None) -> TrainState:
    """Fresh training state on ``device`` (the CUDA card by default): params
    from ``INIT_FNS`` with a generator seeded from ``seed`` (default
    ``config.seed``), or a copy of ``base_params``.

    ``config.lora_rank`` > 0: the params become ``{'base', 'lora'}`` (the
    base frozen, adapters from a generator derived from the seed) and the
    optimizer holds only the adapters; ``config.lora_base`` loads the weights
    being adapted (a params file or a trainer step dir) when ``base_params``
    is None."""
    device = resolve_device(device)
    seed = config.seed if seed is None else seed
    if base_params is None:
        base_params = INIT_FNS[model_name](torch.Generator().manual_seed(seed), config)
        if config.lora_rank > 0 and config.lora_base:
            base_params = load_params(config.lora_base, base_params)
    if config.lora_rank > 0:
        base = map_tree(lambda a: a.detach().to(device).clone(), base_params)
        gen = torch.Generator().manual_seed(
            int(np.random.SeedSequence([seed, 1]).generate_state(1, np.uint64)[0]))
        params = lora_mod.attach(base, config, gen)
        params['lora'] = map_tree(lambda a: a.requires_grad_(), params['lora'])
        return TrainState(params, Optimizer(params['lora'], config), 0)
    params = map_tree(lambda a: a.detach().to(device).clone().requires_grad_(), base_params)
    return TrainState(params, Optimizer(params, config), 0)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step's random draws (dropout masks, the NAR
    stage), seeded from (seed, step) like the JAX ``fold_in(rng, step)``."""
    device = torch.device(device)
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + step) % 2**63)


def _check_finite_grads(step: int, grads: list[torch.Tensor]) -> None:
    """``profiling.enable_nan_checks``: raise on a non-finite grad."""
    for i, g in enumerate(grads):
        if not bool(torch.isfinite(g).all()):
            raise FloatingPointError(f'train step {step}: the grad of trained leaf {i} '
                                     f'{tuple(g.shape)} is not finite')


def make_train_step(config: ConfigValle, model_name: str):
    """Build ``step(state, batch, seed) -> (state, metrics)``: forward,
    backward, clip and AdamW.  metrics are device tensors (read them only
    when logging, so the host does not wait on every step).  A LoRA state
    merges its adapters inside the forward.  Under
    ``profiling.enable_nan_checks`` a non-finite loss or grad raises
    ``FloatingPointError`` before the update.  The step is a
    ``aot.CachedJit``: its first call of each signature counts the kernel
    libraries it built or loaded."""
    loss_fn = LOSS_FNS[model_name]
    lora_mode = config.lora_rank > 0

    def step_fn(state: TrainState, batch: dict, seed: int):
        leaves = state.opt_state.leaves
        gen = step_generator(seed, state.step, leaves[0].device)
        checks = nan_checks_enabled()
        with annotate('train_step'), precision_scope(config):
            params = lora_mod.merged(state.params, config) if lora_mode else state.params
            loss, metrics = loss_fn(params, config, batch, gen)
            if checks and not bool(torch.isfinite(loss)):
                raise FloatingPointError(
                    f'train step {state.step}: the loss is {float(loss.detach())}')
            try:
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            except RuntimeError as exc:
                if checks and 'nan' in str(exc).lower():   # anomaly detection's report
                    raise FloatingPointError(f'train step {state.step}: {exc}') from exc
                raise
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        if checks:
            _check_finite_grads(state.step, grads)
        metrics = dict(metrics, grad_norm=global_norm(grads))
        state.opt_state.update(grads)
        return TrainState(state.params, state.opt_state, state.step + 1), metrics
    return cached_jit(step_fn, tag=f'train_step_{model_name}', extra_key=config_key(config))


def make_eval_step(config: ConfigValle, model_name: str):
    """``eval(params, batch, generator) -> metrics`` without dropout: the AR
    loss takes no generator; the NAR loss draws its stage from ``generator``
    with ``train=False``.  A LoRA state evaluates its merged weights."""
    loss_fn = LOSS_FNS[model_name]
    is_nar = model_name == 'ValleNAR'

    @torch.no_grad()
    def eval_fn(params: Params, batch: dict, generator: torch.Generator):
        if config.lora_rank > 0:
            params = lora_mod.merged(params, config)
        with precision_scope(config):
            if is_nar:
                _, metrics = loss_fn(params, config, batch, generator, train=False)
            else:
                _, metrics = loss_fn(params, config, batch, None)
        return metrics
    return eval_fn


class _PreemptGuard:
    """SIGTERM → request a clean stop: ``fit`` finishes the micro-step in
    flight, writes a checkpoint and returns; ``--resume`` continues from
    there.  Off the main thread (where ``signal.signal`` raises) it does
    nothing."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.requested = False
        self._prev = None
        self._installed = False

    def install(self) -> None:
        if not self.enabled:
            return
        try:
            self._prev = signal.signal(signal.SIGTERM, self._on_signal)
            self._installed = True
        except ValueError:      # not the main thread
            pass

    def uninstall(self) -> None:
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev)
            self._installed = False

    def _on_signal(self, signum, frame):
        self.requested = True


class Trainer:
    """Step-driven train loop (max_steps, log_every_n_steps, ckpt_every_n_steps)
    on one device."""

    def __init__(self, config: ConfigValle, model_name: str, device=None,
                 use_tensorboard: bool = True):
        self.config = config
        self.model_name = model_name
        self.device = resolve_device(device)
        self.train_step = make_train_step(config, model_name)
        self.eval_step = make_eval_step(config, model_name)
        self._writer_thread: threading.Thread | None = None
        self._writer_error: BaseException | None = None
        self.writer = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
                config.ensure_dirs()
                self.writer = SummaryWriter(str(Path(config.log_path) / model_name))
            except ImportError:
                pass

    # ---- checkpoints ----
    def _step_dir(self, opt_step: int) -> Path:
        return Path(self.config.ckpt_path).resolve() / self.model_name / f'step_{opt_step}'

    def save_checkpoint(self, state: TrainState, wait: bool = True) -> None:
        """Save {params, opt_state, step} to ``step_<optimizer step>/``.

        The device→host copy happens here; with ``config.async_checkpoint``
        the file is written on a background thread and ``wait=False`` (the
        loop's periodic saves) returns at once.  One write is in flight at a
        time, and a failed write raises at the next save or at
        ``finish_checkpoints``.  The step dir appears only once complete."""
        self.config.ensure_dirs()
        opt_step = state.step // max(1, self.config.grad_accum)
        path = self._step_dir(opt_step)
        item = {'params': to_cpu(state.params),
                'opt_state': to_cpu(state.opt_state.state_dict()), 'step': state.step}

        def write():
            tmp = path.with_name(f'{path.name}.tmp-{os.getpid()}')
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir(parents=True)
            atomic_save(item, tmp / STATE_FILE)
            if path.exists():
                shutil.rmtree(path)
            os.replace(tmp, path)

        if self.config.async_checkpoint:
            self.finish_checkpoints()

            def run():
                try:
                    write()
                except BaseException as exc:  # noqa: BLE001 — raised by finish_checkpoints
                    self._writer_error = exc
            self._writer_thread = threading.Thread(target=run, name='valle-ckpt')
            self._writer_thread.start()
            if wait:
                self.finish_checkpoints()
        else:
            write()
        in_flight = self.config.async_checkpoint and not wait
        log.info('Saved checkpoint at step %d → %s%s', opt_step, path,
                 ' (async, write in flight)' if in_flight else '')
        self._prune_checkpoints(keep_step=opt_step)

    def finish_checkpoints(self) -> None:
        """Block until the write in flight lands; raise its error, if any."""
        if self._writer_thread is not None:
            self._writer_thread.join()
            self._writer_thread = None
        if self._writer_error is not None:
            exc, self._writer_error = self._writer_error, None
            raise RuntimeError('checkpoint write failed') from exc

    def _prune_checkpoints(self, keep_step: int) -> None:
        """``config.keep_checkpoints = N > 0``: delete all but the newest N
        numeric ``step_*`` dirs, never the one just saved."""
        keep = int(self.config.keep_checkpoints)
        if keep <= 0:
            return
        for _, p in self._step_dirs()[:-keep]:
            if p.name == f'step_{keep_step}':
                continue
            shutil.rmtree(p, ignore_errors=True)
            log.info('Pruned checkpoint %s (keep_checkpoints=%d)', p, keep)

    def _step_dirs(self) -> list[tuple[int, Path]]:
        root = Path(self.config.ckpt_path) / self.model_name
        if not root.exists():
            return []
        # Only numeric step dirs: a write in flight or cut short leaves step_N.tmp-*.
        return sorted((int(p.name.split('_')[1]), p) for p in root.glob('step_*')
                      if p.name.split('_')[1].isdigit())

    def latest_checkpoint(self) -> Path | None:
        steps = self._step_dirs()
        return steps[-1][1] if steps else None

    @torch.no_grad()
    def restore_checkpoint(self, state: TrainState, path) -> TrainState:
        """Load a step dir into ``state``: params copied in place (the
        optimizer keeps its references), optimizer state, micro-step count."""
        item = torch.load(Path(path) / STATE_FILE, map_location='cpu', weights_only=True)
        for p, x in zip(tree_leaves(state.params), tree_leaves(item['params'])):
            p.copy_(x)
        state.opt_state.load_state_dict(item['opt_state'])
        return TrainState(state.params, state.opt_state, int(item['step']))

    # ---- loops ----
    def fit(self, state: TrainState, train_loader, valid_loader=None,
            resume: bool = False) -> TrainState:
        cfg = self.config
        if resume:
            latest = self.latest_checkpoint()
            if latest is not None:
                state = self.restore_checkpoint(state, latest)
                log.info('Resumed from %s (step %d)', latest, state.step)
        t_start = time.time()
        frames = 0
        # max_steps, log_every and ckpt_every count OPTIMIZER steps; state.step
        # counts micro-steps (it seeds each step's generator).
        accum = max(1, cfg.grad_accum)
        micro = state.step
        step = micro // accum
        # Resume replays the stream: the shuffle order is a function of (seed,
        # epoch) and each step's generator of (seed, step), so pinning the
        # epoch and skipping the batches already taken gives the same params.
        skip = 0
        if micro > 0 and hasattr(train_loader, 'set_epoch') and (
                per_epoch := len(train_loader)) > 0:
            train_loader.set_epoch(micro // per_epoch)
            skip = micro % per_epoch
            if skip:
                log.info('Resuming data stream: epoch %d, skipping %d batches',
                         micro // per_epoch, skip)
        guard = _PreemptGuard(enabled=cfg.preempt_checkpoint)
        guard.install()
        try:
            while step < cfg.max_steps and not guard.requested:
                served_any = False
                for batch in self._batches(train_loader, skip):
                    skip = 0
                    if step >= cfg.max_steps:
                        break
                    served_any = True
                    state, metrics = self.train_step(state, batch, cfg.seed)
                    frames += int(np.prod(batch['codes'].shape[:2]))
                    micro += 1
                    if guard.requested:
                        log.info('SIGTERM: checkpointing at step %d and exiting',
                                 micro // accum)
                        self.save_checkpoint(state, wait=True)
                        return state
                    if micro % accum:
                        continue           # mid-accumulation: no update applied
                    step += 1
                    if cfg.log_every_n_steps and (step % cfg.log_every_n_steps == 0
                                                  or step == 1):
                        m = {k: float(v) for k, v in metrics.items()}
                        elapsed = time.time() - t_start
                        log.info('step %d | loss %.4f | acc %.3f | %.0f frames/s', step,
                                 m['loss'], m.get('acc', 0.0), frames / max(elapsed, 1e-6))
                        if self.writer:
                            self.writer.add_scalar('train/loss', m['loss'], step)
                            for k, v in m.items():
                                if k != 'loss':
                                    self.writer.add_scalar(f'train/{k}', v, step)
                    if cfg.ckpt_every_n_steps and step % cfg.ckpt_every_n_steps == 0:
                        self.save_checkpoint(state, wait=False)
                if not served_any and step < cfg.max_steps:
                    raise RuntimeError('train loader produced no batches in a full epoch')
                if valid_loader is not None:
                    self.validate(state, valid_loader, step)
            self.save_checkpoint(state, wait=True)
            return state
        finally:
            guard.uninstall()
            self.finish_checkpoints()

    def _batches(self, loader, skip: int = 0):
        """Device batches; the first ``skip`` host batches are dropped before
        any copy.  With ``config.prefetch_batches`` > 0 iteration, collate and
        the copy run on a background thread (data/prefetch.py)."""
        def host():
            for i, batch in enumerate(loader):
                if i >= skip:
                    yield batch
        n = self.config.prefetch_batches
        place = lambda b: to_device(b, self.device)
        if n > 0:
            return iter(DevicePrefetcher(host(), size=n, place=place))
        return (place(b) for b in host())

    def validate(self, state: TrainState, valid_loader, step: int):
        """Mean eval loss over ``valid_loader``, weighted by each batch's
        ``n_valid`` (the trailing partial batch counts by its tokens)."""
        losses, weights = [], []
        for i, batch in enumerate(self._batches(valid_loader)):
            gen = step_generator(self.config.seed, i, self.device)
            metrics = self.eval_step(state.params, batch, gen)
            losses.append(float(metrics['loss']))
            weights.append(float(metrics.get('n_valid', 1.0)))
        if not losses:
            return None
        mean = float(np.average(losses, weights=weights) if sum(weights) > 0
                     else np.mean(losses))
        log.info('valid | step %d | loss %.4f', step, mean)
        if self.writer:
            self.writer.add_scalar('valid/loss', mean, step)
        return mean


def train(hparams_fp: Path | str, model_name: str, synthetic: bool = False,
          resume: bool = False, device=None, compile_cache: Path | None = None,
          aot_cache: Path | None = None) -> TrainState:
    """End-to-end training from a JSON config on ``device`` (the CUDA card
    by default).  The kernel-build cache and the AOT directory resolve from
    the arguments, the environment, then the config's fields."""
    config = ConfigValle.from_json(hparams_fp)
    from .aot import enable_aot_cache
    from .compile_cache import enable_compilation_cache
    enable_compilation_cache(compile_cache, fallback=config.compile_cache_dir)
    enable_aot_cache(aot_cache, fallback=config.aot_cache_dir)
    device = resolve_device(device)
    log.info('Training %s on %s with %s', model_name, device, config)
    state = init_state(config, model_name, device=device)
    train_loader, valid_loader = get_dataloaders(model_name, config, synthetic=synthetic)
    trainer = Trainer(config, model_name, device=device)
    return trainer.fit(state, train_loader, valid_loader, resume=resume)


def main(argv=None):
    parser = argparse.ArgumentParser(description='Train a VALL-E model (PyTorch/CUDA)')
    parser.add_argument('-c', '--config', type=Path, required=True)
    parser.add_argument('-m', '--model', type=str,
                        choices=['ValleAR', 'ValleNAR', 'ValleASR'], required=True)
    parser.add_argument('--synthetic', action='store_true',
                        help='Use synthetic data (no dataset download)')
    parser.add_argument('--resume', action='store_true')
    parser.add_argument('--device', type=str, default='cuda', choices=['cuda', 'cpu'],
                        help='Where the model trains (default: the CUDA card)')
    parser.add_argument('--profile', type=Path, default=None,
                        help='Write a torch.profiler trace of the run (host and card) '
                             'to DIR/trace.json')
    parser.add_argument('--debug-nans', action='store_true',
                        help='Anomaly detection, and FloatingPointError on the first '
                             'non-finite loss or grad')
    parser.add_argument('--compile-cache', type=Path, default=None,
                        help='Kernel-build cache dir: where the CUDA libraries are built '
                             'and found (also $VALLE2_COMPILE_CACHE / '
                             'config.compile_cache_dir; default valle2_tpu_torch/_build)')
    parser.add_argument('--aot-cache', type=Path, default=None,
                        help='AOT library dir, searched before the kernel-build cache and '
                             'filled after a build (also $VALLE2_AOT_CACHE / '
                             'config.aot_cache_dir)')
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format='%(asctime)s %(message)s')
    if args.debug_nans:
        from .profiling import enable_nan_checks
        enable_nan_checks()
    run = lambda: train(args.config, args.model, synthetic=args.synthetic,  # noqa: E731
                        resume=args.resume, device=args.device,
                        compile_cache=args.compile_cache, aot_cache=args.aot_cache)
    if args.profile is not None:
        from .profiling import trace
        with trace(args.profile):
            run()
    else:
        run()


if __name__ == '__main__':
    main()
