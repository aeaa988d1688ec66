"""Training loop: update step, AdamW, checkpoints, metrics, on one device,
over a ('data', 'model') mesh or over a ('data', 'pipe'[, 'model']) mesh.

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

On a mesh (``Trainer(mesh=)``, or ``mesh_data`` x ``mesh_model`` in the
config, ``parallel.training_mesh``) each data rank runs its rows of the
whole batch, tensor-parallel over its model ranks where the heads and the
FFN width divide them; ``MeshOptimizer`` sums the grads over 'data' in rank
order, clips by the global norm and steps AdamW on every rank (``zero1``:
each data rank its block of the moments).  The step equals the solo step:
the loss divides by the whole batch's count, and the dropout masks are the
solo step's cut by rows.  ``init_distributed`` (``$VALLE2_COORDINATOR``,
``$VALLE2_NUM_PROCS``, ``$VALLE2_PROC_ID``) spreads a mesh over processes.
With ``mesh_pipe`` > 1 the stack splits into stages over 'pipe' and the
step is ``parallel.pipeline``'s GPipe or ``parallel.pipeline_1f1b``'s 1F1B
(``pp_schedule``), ``pp_microbatches`` microbatches a data rank;
``MeshOptimizer`` also sums each leaf outside the stack over the stages.

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
from .ops.transformer import SP_SUMMED, map_tree
from .parallel import mesh as mesh_mod
from .parallel.mesh import Sharded, gather_params, sequence_parallel_spec, shard_params
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


class MeshOptimizer:
    """``Optimizer`` over the ranks of a mesh (JAX ``make_train_step`` on a
    ('data', 'model') mesh, ``make_pp_train_step`` on a ('data', 'pipe',
    'model') one).  Each local rank (i[, s], j) holds its trees' trained
    leaves and an AdamW over them (``use_fused_adam`` on the card).
    ``update`` takes every rank's grads and:

    1. completes them over 'model': a leaf cut over 'model' keeps its own
       grad; a replicated one takes model rank 0's (every rank carries it
       whole), or under sequence parallelism a norm's the rank-ordered sum
       (``ops.transformer.SP_SUMMED``);
    2. completes them over 'pipe': a leaf cut over 'pipe' (the stack) keeps
       its stage's grad; every other leaf takes the stage-ordered sum of the
       stages' grads (a stage that did not use it holds zeros), so every
       stage's copy takes the same update;
    3. sums them over 'data' in rank order (``Mesh.gather_data``, across
       processes too), so the result does not depend on how the ranks
       spread over processes or cards;
    4. accumulates ``grad_accum`` micro-batches (the optax running mean),
       clips by the GLOBAL norm (each cut leaf's blocks once) and steps.

    ``zero1`` (ZeRO-1, with a data axis > 1): rank (i, j)'s AdamW holds only
    data block i of each leaf ``mesh._zero1_extend`` cuts (its moments, a
    copy of its params), updates it, and the blocks are then gathered back
    into every data rank's leaf.  ``state_dict`` / ``load_state_dict`` speak
    ``Optimizer``'s format, whole tensors in leaf order, so a state saved on
    one mesh restores on another or on none."""

    def __init__(self, mesh, params: Sharded, config: ConfigValle, trained: str | None = None):
        self.mesh = mesh
        sub = (lambda t: t[trained]) if trained else (lambda t: t)
        self.ranks = [tree_leaves(sub(t)) for t in params]
        specs = sub(params.specs)
        self.tp = params.tp
        self.paths = [p for p, _ in mesh_mod._paths(specs)]
        self.specs = [sp for _, sp in mesh_mod._paths(specs)]
        sp_on = (params.tp and mesh.pipe == 1
                 and sequence_parallel_spec(config, mesh) is not None)
        self.rules = ['own' if 'model' in spec else
                      'sum' if sp_on and any(m in f'/{p}/' for m in SP_SUMMED) else 'first'
                      for p, spec in zip(self.paths, self.specs)]
        self.staged = ['pipe' in spec for spec in self.specs]
        self.zero1 = bool(config.zero1) and mesh.data > 1
        self.zspecs = [mesh_mod._zero1_extend(spec, mesh_mod.whole_shape(leaf, spec, mesh),
                                              mesh.data) if self.zero1 else spec
                       for spec, leaf in zip(self.specs, self.ranks[0])]
        self.max_norm = config.gradient_clip_val
        self.schedule = lr_schedule(config)
        self.k = max(1, config.grad_accum)
        self.masters = []
        for r, leaves in enumerate(self.ranks):
            i = (mesh.first + r) // mesh.group_size
            self.masters.append([self._block(leaf, z, i).detach().clone()
                                 if 'data' in z else leaf
                                 for leaf, z in zip(leaves, self.zspecs)])
        fused = bool(config.use_fused_adam) and self.ranks[0][0].device.type == 'cuda'
        self.adamw = [torch.optim.AdamW(m, lr=config.lr, betas=config.betas, eps=1e-8,
                                        weight_decay=config.weight_decay,
                                        fused=True if fused else None) for m in self.masters]
        self.acc: list | None = None        # per model rank: the running mean
        self.mini_step = 0
        self.count = 0
        self.micro_norm = None

    @property
    def leaves(self) -> list[torch.Tensor]:
        """Every local rank's trained leaves, rank-major (the step's autograd
        targets)."""
        return [leaf for leaves in self.ranks for leaf in leaves]

    def _block(self, t: torch.Tensor, zspec, i: int) -> torch.Tensor:
        """Data block ``i`` of a (model-cut) leaf along its ZeRO-1 axis."""
        axis = zspec.index('data')
        n = t.shape[axis] // self.mesh.data
        return t.narrow(axis, i * n, n)

    def _model_complete(self, grads: list[list[torch.Tensor]]) -> list[list[torch.Tensor]]:
        m = self.mesh.model
        out = [list(g) for g in grads]
        for base in range(0, len(grads), m):
            for k, rule in enumerate(self.rules):
                if rule == 'own':
                    continue
                g0 = grads[base][k]
                if rule == 'sum':
                    for j in range(1, m):
                        g0 = g0 + grads[base + j][k].to(g0.device)
                for j in range(m):
                    out[base + j][k] = g0.to(grads[base + j][k].device)
        return out

    def _pipe_complete(self, grads: list[list[torch.Tensor]]) -> list[list[torch.Tensor]]:
        """Every leaf outside the stack: the stage-ordered sum of the
        stages' grads on each stage's rank of the same model index."""
        p, m, g = self.mesh.pipe, self.mesh.model, self.mesh.group_size
        if p == 1:
            return grads
        out = [list(gs) for gs in grads]
        for base in range(0, len(grads), g):
            for k, staged in enumerate(self.staged):
                if staged:
                    continue
                for j in range(m):
                    total = grads[base + j][k]
                    for s in range(1, p):
                        total = total + grads[base + s * m + j][k].to(total.device)
                    for s in range(p):
                        out[base + s * m + j][k] = total.to(grads[base + s * m + j][k].device)
        return out

    def _data_reduce(self, grads: list[list[torch.Tensor]]) -> list[list[torch.Tensor]]:
        """Per rank of a data rank's group (model rank j, or stage and model
        rank), the rank-ordered sum over every data rank of its completed
        grads (flattened into one buffer)."""
        m, n_local = self.mesh.group_size, len(grads) // self.mesh.group_size
        shapes = [g.shape for g in grads[0]]
        sizes = [g.numel() for g in grads[0]]
        out = []
        for j in range(m):
            dev = grads[j][0].device
            flats = [torch.cat([g.reshape(-1).to(dev) for g in grads[li * m + j]])
                     for li in range(n_local)]
            every = self.mesh.gather_data(flats)
            acc = every[0]
            for f in every[1:]:
                acc = acc + f.to(dev)
            out.append([x.reshape(sh) for x, sh in zip(acc.split(sizes), shapes)])
        return out

    def _norm(self, red: list[list[torch.Tensor]]) -> torch.Tensor:
        """The global norm: each distinct block of a leaf once (every stage's
        of a leaf cut over 'pipe', every model rank's of one cut over
        'model')."""
        dev = red[0][0].device
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for k, (rule, staged) in enumerate(zip(self.rules, self.staged)):
            for c in range(len(red)):
                s, j = divmod(c, self.mesh.model)
                if (s and not staged) or (j and rule != 'own'):
                    continue
                total = total + red[c][k].float().square().sum().to(dev)
        return torch.sqrt(total)

    def _reduced(self, grads: list[torch.Tensor]) -> list[list[torch.Tensor]]:
        """Steps 1-3 of ``update``: per rank of a data rank's group, its
        leaves' grads completed over 'model' and 'pipe' and summed over
        'data'."""
        per = len(self.ranks[0])
        grads = [list(grads[r * per:(r + 1) * per]) for r in range(len(self.ranks))]
        return self._data_reduce(self._pipe_complete(self._model_complete(grads)))

    @torch.no_grad()
    def whole_grads(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """The grads ``update`` would apply before clipping (aligned with
        ``leaves``), as whole tensors in leaf order on the CPU: what a solo
        step's autograd gives."""
        red = self._reduced(grads)
        return self._whole([red[(self.mesh.first + r) % self.mesh.group_size]
                            for r in range(len(self.ranks))], self.specs)

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor]) -> bool:
        """Feed one micro-batch's grads (aligned with ``leaves``); returns
        True when this call applied an update."""
        red = self._reduced(grads)
        self.micro_norm = self._norm(red)
        if self.k > 1:
            if self.acc is None:
                self.acc = [[torch.zeros_like(g) for g in gs] for gs in red]
            for accs, gs in zip(self.acc, red):
                for a, g in zip(accs, gs):
                    a.add_((g - a) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.k:
                return False
            red, self.acc, self.mini_step = self.acc, None, 0
        norm = self.micro_norm if self.k == 1 else self._norm(red)
        clip = norm < self.max_norm
        mesh = self.mesh
        for r, masters in enumerate(self.masters):
            i, j = divmod(mesh.first + r, mesh.group_size)
            for leaf, master, z, g in zip(self.ranks[r], masters, self.zspecs, red[j]):
                g = g.to(master.device)
                g = torch.where(clip.to(g.device), g, g / norm.to(g.device) * self.max_norm)
                if 'data' in z:     # the block starts from the leaf (a restore writes there)
                    master.copy_(self._block(leaf, z, i))
                    g = self._block(g, z, i).contiguous()
                master.grad = g
        for opt in self.adamw:
            for group in opt.param_groups:
                group['lr'] = self.schedule(self.count)
            opt.step()
            opt.zero_grad(set_to_none=True)
        if self.zero1:
            self._gather_blocks()
        self.count += 1
        return True

    def _gather_blocks(self) -> None:
        """ZeRO-1's all-gather: every data rank's updated block of each cut
        leaf into every local data rank's leaf."""
        m = self.mesh.group_size
        n_local = len(self.ranks) // m
        for k, z in enumerate(self.zspecs):
            if 'data' not in z:
                continue
            for j in range(m):
                every = self.mesh.gather_data([self.masters[li * m + j][k]
                                               for li in range(n_local)])
                for li in range(n_local):
                    leaf = self.ranks[li * m + j][k]
                    for i, block in enumerate(every):
                        self._block(leaf, z, i).copy_(block)

    # ---- whole-tensor state (Optimizer's format) ----
    def _whole(self, per_rank: list[list[torch.Tensor]], specs: list) -> list[torch.Tensor]:
        """Whole tensors in leaf order from one block list per local rank
        placed by ``specs`` (a collective across processes)."""
        trees = mesh_mod._unzip({p: [blocks[k] for blocks in per_rank]
                                 for k, p in enumerate(self.paths)}, len(per_rank))
        spec_tree = mesh_mod._unzip({p: [sp] for p, sp in zip(self.paths, specs)}, 1)[0]
        whole = gather_params(self.mesh, Sharded(trees, spec_tree, self.tp))
        return tree_leaves(whole)

    def _cut(self, whole: list[torch.Tensor], zero1: bool) -> list[list[torch.Tensor]]:
        tree = mesh_mod._unzip({p: [w] for p, w in zip(self.paths, whole)}, 1)[0]
        placed = shard_params(self.mesh, tree, zero1=zero1 and self.zero1, tp=self.tp)
        return [tree_leaves(t) for t in placed]

    def state_dict(self) -> dict:
        states = [[opt.state.get(p, {}) for p in masters]
                  for opt, masters in zip(self.adamw, self.masters)]
        adamw = self.adamw[0].state_dict()
        if states[0] and states[0][0]:
            avg = self._whole([[s['exp_avg'] for s in st] for st in states], self.zspecs)
            sq = self._whole([[s['exp_avg_sq'] for s in st] for st in states], self.zspecs)
            adamw['state'] = {k: {'step': states[0][k]['step'], 'exp_avg': a, 'exp_avg_sq': q}
                              for k, (a, q) in enumerate(zip(avg, sq))}
        acc = None
        if self.acc is not None:
            acc = self._whole([self.acc[((self.mesh.first + r) % self.mesh.group_size)]
                               for r in range(len(self.ranks))], self.specs)
        return {'adamw': adamw, 'acc': acc, 'mini_step': self.mini_step, 'count': self.count}

    def load_state_dict(self, state: dict) -> None:
        saved = state['adamw']
        moments = saved.get('state', {})
        if moments:
            keys = sorted(moments)
            avg = self._cut([moments[k]['exp_avg'] for k in keys], True)
            sq = self._cut([moments[k]['exp_avg_sq'] for k in keys], True)
            for r, opt in enumerate(self.adamw):
                own = opt.state_dict()
                own['state'] = {k: {'step': moments[key]['step'].clone(),
                                    'exp_avg': avg[r][k], 'exp_avg_sq': sq[r][k]}
                                for k, key in enumerate(keys)}
                own['param_groups'] = [dict(g, params=o['params'])
                                       for g, o in zip(saved['param_groups'],
                                                       own['param_groups'])]
                opt.load_state_dict(own)
        acc = state['acc']
        self.acc = None
        if acc is not None:
            placed = self._cut(list(acc), False)
            self.acc = [placed[j] for j in range(self.mesh.group_size)]
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


def make_train_step(config: ConfigValle, model_name: str, mesh=None):
    """Build ``step(state, batch, seed) -> (state, metrics)``: forward,
    backward, clip and AdamW.  metrics are device tensors (read them only
    when logging, so the host does not wait on every step).  A LoRA state
    merges its adapters inside the forward.  Under
    ``profiling.enable_nan_checks`` a non-finite loss or grad raises
    ``FloatingPointError`` before the update.  The step is a
    ``aot.CachedJit``: its first call of each signature counts the kernel
    libraries it built or loaded.

    ``mesh`` (more than one rank): the state is a mesh state
    (``shard_state``), the batch the whole batch (every process holds it);
    each data rank runs its rows through the loss (``models.ar.mesh_rows``:
    flash per (data, model) shard, 5c under autograd) and ``MeshOptimizer``
    completes, sums and applies the grads (JAX ``make_train_step`` with a
    mesh).  The dropout masks are the solo step's, cut by rows, so the step
    equals the solo one.  A mesh with a 'pipe' axis takes the pipeline step
    of ``config.pp_schedule`` (``parallel.pipeline.make_pp_train_step``,
    ``parallel.pipeline_1f1b.make_pp_train_step_1f1b``; JAX ``Trainer``)."""
    loss_fn = LOSS_FNS[model_name]
    lora_mode = config.lora_rank > 0
    mesh = mesh if mesh is not None and mesh.size > 1 else None
    if mesh is not None and mesh.pipe > 1:
        if config.pp_schedule == '1f1b':
            from .parallel.pipeline_1f1b import make_pp_train_step_1f1b
            return make_pp_train_step_1f1b(config, model_name, mesh)
        from .parallel.pipeline import make_pp_train_step
        return make_pp_train_step(config, model_name, mesh)

    def step_fn(state: TrainState, batch: dict, seed: int):
        leaves = state.opt_state.leaves
        gen = step_generator(seed, state.step, leaves[0].device)
        checks = nan_checks_enabled()
        with annotate('train_step'), precision_scope(config):
            params = _merged(state.params, config) if lora_mode else state.params
            loss, metrics = (loss_fn(params, config, batch, gen) if mesh is None
                             else loss_fn(params, config, batch, gen, mesh=mesh))
            if checks and not bool(torch.isfinite(loss)):
                raise FloatingPointError(
                    f'train step {state.step}: the loss is {float(loss.detach())}')
            try:
                grads = (torch.autograd.grad(loss, leaves, allow_unused=True)
                         if loss.requires_grad else [None] * len(leaves))
            except RuntimeError as exc:
                if checks and 'nan' in str(exc).lower():   # anomaly detection's report
                    raise FloatingPointError(f'train step {state.step}: {exc}') from exc
                raise
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        if checks:
            _check_finite_grads(state.step, grads)
        if mesh is None:
            metrics = dict(metrics, grad_norm=global_norm(grads))
            state.opt_state.update(grads)
        else:
            state.opt_state.update(grads)
            metrics = dict(metrics, grad_norm=state.opt_state.micro_norm)
        return TrainState(state.params, state.opt_state, state.step + 1), metrics
    tag = f'train_step_{model_name}' + ('' if mesh is None else '_mesh')
    return cached_jit(step_fn, tag=tag, extra_key=config_key(config))


def _merged(params, config: ConfigValle):
    """A LoRA state's merged weights, per rank of a mesh state."""
    if isinstance(params, Sharded):
        return Sharded([lora_mod.merged(t, config) for t in params])
    return lora_mod.merged(params, config)


def mesh_tp(config: ConfigValle, mesh) -> bool:
    """Whether the stack splits over the mesh's model axis (heads and the
    FFN width divide it); otherwise it replicates there and JAX's flash
    route declines (the bias route runs)."""
    from .parallel import tp_divisible
    return mesh.model > 1 and tp_divisible(config.n_heads, config.dim_feedforward, mesh.model)


def shard_state(mesh, state: TrainState, config: ConfigValle) -> TrainState:
    """A one-device state (``init_state``, or restored) placed on ``mesh``
    (JAX ``Trainer.fit``'s ``shard_params`` / ``pp_shard_params`` of params
    and optimizer state): each rank's params under ``parallel.placement``
    (copies, the trained leaves requiring grad), a ``MeshOptimizer``
    carrying the optimizer state (ZeRO-1 cuts it over 'data')."""
    lora_mode = config.lora_rank > 0
    if mesh.pipe > 1:
        from .parallel.pipeline import pp_tp
        tp = pp_tp(config, mesh)
    elif lora_mode and mesh.model > 1:
        raise NotImplementedError('LoRA on a model axis takes the GSPMD path, which is not '
                                  f'ported ({mesh_mod.ITEM14}); LoRA runs on a data mesh '
                                  'or a pipe mesh')
    else:
        tp = mesh_tp(config, mesh)
    whole = map_tree(lambda a: a.detach(), state.params)
    params = shard_params(mesh, whole, tp=tp)
    for tree in params:
        map_tree(lambda a: a.requires_grad_(), tree['lora'] if lora_mode else tree)
    opt = MeshOptimizer(mesh, params, config, 'lora' if lora_mode else None)
    opt.load_state_dict(state.opt_state.state_dict())
    return TrainState(params, opt, state.step)


def gather_state(state: TrainState, device='cpu') -> Params:
    """The whole params of a state (a mesh state's gathered,
    ``parallel.gather_params``), on ``device``."""
    if isinstance(state.params, Sharded):
        return gather_params(state.opt_state.mesh, state.params, device)
    return map_tree(lambda a: a.detach().to(device), state.params)


def make_eval_step(config: ConfigValle, model_name: str, mesh=None):
    """``eval(params, batch, generator) -> metrics`` without dropout: the AR
    loss takes no generator; the NAR loss draws its stage from ``generator``
    with ``train=False``.  A LoRA state evaluates its merged weights.
    ``mesh``: params of a mesh state, the whole batch; a mesh with a 'pipe'
    axis evaluates through ``parallel.pipeline.make_pp_eval_step``."""
    loss_fn = LOSS_FNS[model_name]
    is_nar = model_name == 'ValleNAR'
    mesh = mesh if mesh is not None and mesh.size > 1 else None
    if mesh is not None and mesh.pipe > 1:
        from .parallel.pipeline import make_pp_eval_step
        return make_pp_eval_step(config, model_name, mesh)
    kw = {} if mesh is None else {'mesh': mesh}

    @torch.no_grad()
    def eval_fn(params: Params, batch: dict, generator: torch.Generator):
        if config.lora_rank > 0:
            params = _merged(params, config)
        with precision_scope(config):
            if is_nar:
                _, metrics = loss_fn(params, config, batch, generator, train=False, **kw)
            else:
                _, metrics = loss_fn(params, config, batch, None, **kw)
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
    on one device, or over a ('data', 'model') or ('data', 'pipe'[, 'model'])
    ``mesh`` (JAX ``Trainer(mesh=)``: ``fit`` places a one-device state with
    ``shard_state``, batches whose rows the data axis does not divide are
    dropped, checkpoints hold whole tensors, and only the primary process
    writes files).  On a pipe mesh the step is GPipe or 1F1B by
    ``config.pp_schedule`` and evaluation GPipe's forward; a stack that does
    not split into equal stages, or heads or an FFN width a model axis does
    not divide, raise ``ValueError``."""

    def __init__(self, config: ConfigValle, model_name: str, device=None,
                 use_tensorboard: bool = True, mesh=None):
        self.config = config
        self.model_name = model_name
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.device = mesh.devices[0] if mesh is not None else resolve_device(device)
        self.train_step = make_train_step(config, model_name, self.mesh)
        self.eval_step = make_eval_step(config, model_name, self.mesh)
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
        from .parallel import is_primary
        opt_step = state.step // max(1, self.config.grad_accum)
        path = self._step_dir(opt_step)
        # A mesh state gathers its whole tensors here (every process takes part).
        item = {'params': to_cpu(gather_state(state)),
                'opt_state': to_cpu(state.opt_state.state_dict()), 'step': state.step}
        if not is_primary():
            return
        self.config.ensure_dirs()

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
        optimizer keeps its references), optimizer state, micro-step count.
        The file holds whole tensors: a mesh state takes its ranks' blocks,
        whatever mesh (or none) wrote it."""
        item = torch.load(Path(path) / STATE_FILE, map_location='cpu', weights_only=True)
        if isinstance(state.params, Sharded):
            mesh = state.opt_state.mesh
            placed = shard_params(mesh, item['params'], tp=state.params.tp)
            pairs = [(p, x) for tree, whole in zip(state.params, placed)
                     for p, x in zip(tree_leaves(tree), tree_leaves(whole))]
        else:
            pairs = zip(tree_leaves(state.params), tree_leaves(item['params']))
        for p, x in pairs:
            p.copy_(x)
        state.opt_state.load_state_dict(item['opt_state'])
        return TrainState(state.params, state.opt_state, int(item['step']))

    # ---- loops ----
    def fit(self, state: TrainState, train_loader, valid_loader=None,
            resume: bool = False) -> TrainState:
        cfg = self.config
        if self.mesh is not None and not isinstance(state.params, Sharded):
            state = shard_state(self.mesh, state, cfg)
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
        place = self._place
        if n > 0:
            return iter(DevicePrefetcher(host(), size=n, place=place))
        return (b for b in map(place, host()) if b is not None)

    def _place(self, batch):
        """A host batch on the device (on a mesh the whole batch on its first
        device, where the step reads the global counts; each data rank takes
        its rows from there, ``parallel.shard_batch``), or None for a batch
        whose rows the data axis does not divide (dropped, JAX ``_place``)."""
        if self.mesh is not None:
            rows = int(next(iter(batch.values())).shape[0])
            if rows % self.mesh.data:
                log.info('Dropping %d-row batch (not divisible by data axis %d)', rows,
                         self.mesh.data)
                return None
        return to_device(batch, self.device)

    def validate(self, state: TrainState, valid_loader, step: int):
        """Mean eval loss over ``valid_loader``, weighted by each batch's
        ``n_valid`` (the trailing partial batch counts by its tokens); on a
        mesh the batches shard like training ones."""
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
    # Multi-process runs join their group first ($VALLE2_COORDINATOR, ...).
    from .parallel import init_distributed, is_primary, training_mesh
    from .parallel.mesh import process_info
    init_distributed()
    from .aot import enable_aot_cache
    from .compile_cache import enable_compilation_cache
    enable_compilation_cache(compile_cache, fallback=config.compile_cache_dir)
    enable_aot_cache(aot_cache, fallback=config.aot_cache_dir)
    device = resolve_device(device)
    # mesh_data x mesh_pipe x mesh_model from the config: over the cards, or
    # on another device as virtual ranks.
    ranks = config.mesh_data * config.mesh_pipe * config.mesh_model // process_info()[0]
    mesh = training_mesh(config, None if device.type == 'cuda' else [device] * ranks)
    if mesh is not None and mesh.pipe > 1:
        log.info('Mesh from config: %dx%dx%d (data x pipe x model), %s schedule',
                 config.mesh_data, config.mesh_pipe, config.mesh_model, config.pp_schedule)
    elif mesh is not None:
        log.info('Mesh from config: %dx%d (data x model)', config.mesh_data, config.mesh_model)
    if mesh is not None:
        device = mesh.devices[0]
    log.info('Training %s on %s with %s', model_name, device, config)
    state = init_state(config, model_name, device=device)
    train_loader, valid_loader = get_dataloaders(model_name, config, synthetic=synthetic)
    trainer = Trainer(config, model_name, device=device, mesh=mesh,
                      use_tensorboard=is_primary())
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
