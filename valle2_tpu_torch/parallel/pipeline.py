"""Pipeline parallelism (PP) over a ('data', 'pipe'[, 'model']) mesh
(``valle2_tpu/parallel/pipeline.py``): the stack's layers split into
``pipe`` contiguous stages, and microbatches stream through them.

Placement (``pp_placement``, JAX ``pp_param_specs`` / ``pp_opt_specs``): the
leading layer axis of every leaf under 'transformer' is cut over 'pipe', so
stage s holds layers [s L/P, (s+1) L/P) of the one stacked tree; every other
leaf (embeddings, the NAR's AdaLN rows, the heads) replicates on every
stage.  On a pipe x model mesh the stage's leaves are further cut by the
Megatron rule over 'model', with the qkv columns regrouped rank-major as
``mesh.shard_params`` does (gathered params and checkpoints keep the
canonical layout); a LoRA state keeps each stage whole over 'model' and
the step merges the adapters per stage, then cuts per model rank,
differentiably (``tp_slice_stage``, JAX's in-trace ``tp_slice_stage``).
ZeRO-1 cuts the moments over 'data' on the first free axis.

One process drives every rank.  A step is a schedule of units on one data
rank's ranks: the forward of stage s on microbatch m (``prep`` on stage 0:
the embeddings), the head and loss of a finished microbatch on the last
stage, and the backward of a stage on a microbatch, a vector-Jacobian
product from the cotangent of its output.  ``PipelineRun`` holds them;
``gpipe`` runs every forward in tick order (stage s takes microbatch t - s
at tick t), keeping each unit's autograd graph, then every backward in
tick order; ``pipeline_1f1b.one_f_one_b`` interleaves them and keeps only
stage inputs.  The head runs once, on the last stage's device, and its
backward seeds that stage's cotangent once; the grads of the leaves outside
the stack land on the stage that used them (embeddings on stage 0, heads on
the last, each stage's AdaLN rows on itself) and ``train.MeshOptimizer``
completes them with the stage-ordered sum over 'pipe'.  The loss divides by
the WHOLE batch's count of positions (the head's backward is seeded with
1 / count), so a step equals the solo step; each data rank takes its rows
(``mesh.data_rows``), and microbatch m of a data rank with b rows is rows
[m b/M, (m+1) b/M), where M is ``pp_microbatches`` clamped to the largest
divisor of b (``_gcd``).

Dropout (both schedules, every mesh): data rank i's microbatch m draws its
embedding-side masks (and the NAR's conditioning corruption) from a
generator seeded from (step seed, i, m), and global layer g's masks from one
seeded from (step seed, i, m, g) (``Draws``; the step seed is the step
generator's ``initial_seed()``).  So GPipe and 1F1B draw the same masks,
and 1F1B's recompute replays its forward's; neither equals the solo step's
draw at dropout > 0, as in the JAX package.  The NAR stage is the step
generator's first draw, as in the solo step.

Inside a stage the attention takes the bias route, as JAX's does (its flash
route declines under ``pp``): on a pipe x model mesh the row-parallel sums
run 5c under autograd (``ops.nn.psum_replicated_grad``).  The host issues a
tick's units without waiting on a card: activations move between stages
with ``non_blocking`` copies, and nothing in the tick loop reads a value
back (no ``.item()``).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from .mesh import (Mesh, Sharded, _map_paths, _param_spec, _paths, _zero1_extend, data_rows,
                   make_mesh, on_device, shard_decode_params, shard_params, tp_decode_specs,
                   tp_divisible, tp_permute_qkv)

Params = dict[str, Any]


def _gcd(b_local: int, m: int) -> int:
    """The largest divisor of ``b_local`` that is <= ``m`` (at least 1): the
    microbatch count for a data rank of ``b_local`` rows (JAX ``_gcd``; a
    validation batch need not divide ``pp_microbatches``)."""
    b_local, m = int(b_local), int(m)
    m = max(1, min(m, b_local))
    while b_local % m:
        m -= 1
    return m


def make_pp_mesh(data: int, pipe: int, model: int = 1, devices=None) -> Mesh:
    """A ('data', 'pipe'[, 'model']) mesh, rank (i, s, j) on ``devices[(i *
    pipe + s) * model + j]`` (JAX ``make_pp_mesh``'s reshape): batch rows
    over 'data', the layer stack over 'pipe', Megatron tensor parallelism
    within each stage over 'model'.  Default devices: the CUDA cards."""
    return make_mesh(data, model, devices, pipe=pipe)


def _in_stack(path: str) -> bool:
    return 'transformer' in path.split('/')


def pp_param_specs(params: Params) -> Params:
    """The spec tree of JAX ``pp_param_specs``: a leaf under 'transformer'
    cut over 'pipe' on its leading (layer) axis, every other leaf
    replicated."""
    def spec_for(path, leaf):
        ndim = leaf.dim()
        if _in_stack(path) and ndim >= 1:
            return ('pipe',) + (None,) * (ndim - 1)
        return (None,) * ndim
    return _map_paths(spec_for, params)


def pp_opt_specs(mesh: Mesh, tree: Params, zero1: bool = False) -> Params:
    """``pp_param_specs``, with ``zero1`` also cutting the first free axis
    the data size divides over 'data' (JAX ``pp_opt_specs``: apply to the
    optimizer state)."""
    return pp_placement(mesh, tree, zero1, tp=False)


def pp_placement(mesh: Mesh, params: Params, zero1: bool = False, tp: bool = True) -> Params:
    """The spec each leaf of ``params`` (or, with ``zero1``, of an
    optimizer-moment tree) is placed by on a pipe mesh: ``pp_param_specs``,
    with (``tp`` and a model axis > 1) the stack's Megatron cut over 'model'
    (``mesh._param_spec``'s rule, never the layer axis), then ZeRO-1's."""
    data = mesh.data if zero1 else 1
    base = dict(_paths(pp_param_specs(params)))

    def spec_for(path, leaf):
        spec = base[path]
        if tp and mesh.model > 1 and spec[:1] == ('pipe',):
            spec = ('pipe',) + tuple(_param_spec(path, leaf, mesh.model)[1:])
        return _zero1_extend(spec, tuple(leaf.shape), data)
    return _map_paths(spec_for, params)


def pp_shard_params(mesh: Mesh, params: Params, zero1: bool = False,
                    tp: bool = True) -> Sharded:
    """Each local rank's tree of ``params`` on a pipe mesh (JAX
    ``pp_shard_params``): ``mesh.shard_params`` under ``pp_placement``."""
    return shard_params(mesh, params, zero1=zero1, tp=tp)


def pp_tp(config, mesh: Mesh) -> bool:
    """Whether a pipe mesh's state is placed cut over 'model' (a model axis
    > 1 without LoRA); a LoRA state's stages stay whole over 'model' and the
    step cuts them after the merge (``tp_slice_stage``)."""
    return mesh.model > 1 and config.lora_rank <= 0


def check_pp(config, mesh: Mesh) -> None:
    """The compositions a pipe mesh refuses (JAX ``Trainer``): layers that
    do not split into equal stages, heads or an FFN width the model axis
    does not divide."""
    if config.num_layers % mesh.pipe:
        raise ValueError(f'num_layers={config.num_layers} must divide into '
                         f'mesh_pipe={mesh.pipe} equal stages')
    if mesh.model > 1 and not tp_divisible(config.n_heads, config.dim_feedforward, mesh.model):
        raise ValueError(f'mesh_model={mesh.model} must divide n_heads={config.n_heads} and '
                         f'dim_feedforward={config.dim_feedforward} (Megatron TP within each '
                         'pipeline stage)')


def tp_slice_stage(stack: Params, devices) -> list[Params]:
    """A stage's (merged) stack cut to each model rank's Megatron shard on
    its device, differentiably (JAX ``tp_slice_stage``): the qkv columns
    regrouped rank-major, qkv and lin1 by columns, out and lin2 by input
    rows, everything else whole.  The grads flow back to the whole stack:
    every model rank carries a replicated leaf's whole cotangent, so its
    grad is model rank 0's (``MeshOptimizer``'s 'first' rule) and the other
    ranks' copies are detached."""
    stack = tp_permute_qkv(stack, len(devices))
    specs = dict(_paths(tp_decode_specs(stack)))
    trees = shard_decode_params(stack, len(devices))

    def place(path, a, r, d):
        return (a if r == 0 or 'model' in specs[path] else a.detach()).to(d)
    return [_map_paths(lambda p, a, r=r, d=d: place(p, a, r, d), t)
            for r, (t, d) in enumerate(zip(trees, devices))]


# ---- the dropout rule ----

def _seed(base: int, *ids: int) -> int:
    state = np.random.SeedSequence([int(base), *map(int, ids)]).generate_state(1, np.uint64)
    return int(state[0]) & (2 ** 63 - 1)


class Draws:
    """The generators of data rank ``i``'s pipeline draws in one step (see
    the module docstring): ``prep(m, device)`` for microbatch m's embedding
    side, ``layer(g, m, device)`` for global layer g.  ``base`` None (no
    generator, evaluation) draws nothing; ``layers`` False (dropout 0) draws
    nothing in the stack."""

    def __init__(self, base: int | None, i: int, layers: bool = True):
        self.base, self.i, self.on_layers = base, i, layers and base is not None

    def prep(self, m: int, device) -> torch.Generator | None:
        if self.base is None:
            return None
        return torch.Generator(device=device).manual_seed(_seed(self.base, 0, self.i, m))

    def layer(self, g: int, m: int, device) -> torch.Generator | None:
        if not self.on_layers:
            return None
        return torch.Generator(device=device).manual_seed(_seed(self.base, 1, self.i, m, g))

    def layers(self, first: int, n: int, m: int, device) -> list | None:
        """Layers first .. first + n - 1's generators, or None."""
        if not self.on_layers:
            return None
        return [self.layer(first + k, m, device) for k in range(n)]


# ---- a stage ----

def stage_forward(stacks: list[Params], devices, x: torch.Tensor, n_heads: int,
                  bias: torch.Tensor | None = None, cond: torch.Tensor | None = None,
                  dropout_rate: float = 0.0, generators: list | None = None,
                  remat: bool = False) -> torch.Tensor:
    """One stage's layers on ``x`` (on the stage's first device): ``stacks``
    holds the stage's model ranks' trees (one tree: no TP), ``n_heads`` the
    global head count, ``generators`` one per layer or None.  The bias
    route; over several model ranks ``ops.transformer.transformer_mesh``
    (5c under autograd).  Returns y on the stage's first device."""
    from ..ops.transformer import transformer, transformer_mesh
    if len(stacks) == 1:
        return transformer(stacks[0], x, n_heads, bias, cond, dropout_rate=dropout_rate,
                           generator=generators, remat=remat)
    return transformer_mesh(stacks, x, n_heads // len(stacks), devices, bias, cond, None,
                            dropout_rate, generators, False, remat)


def pipeline_transformer(p: list[list[Params]], x: torch.Tensor, n_heads: int,
                         bias: torch.Tensor | None = None, cond: torch.Tensor | None = None,
                         *, devices, microbatches: int, dropout_rate: float = 0.0,
                         generators: Callable | None = None,
                         remat: bool = False) -> torch.Tensor:
    """The GPipe forward of one data rank, differentiable end to end (JAX
    ``pipeline_transformer``): ``p[s]`` is stage s's model ranks' stacks,
    ``devices[s]`` their devices; x (b, s, d) on stage 0's first device
    splits into ``microbatches`` row blocks, and at tick t stage s runs
    microbatch t - s.  ``bias`` (b or 1 rows) splits with x; ``cond`` (the
    AdaLN row) is copied to every stage, so its grad is the sum of the
    stages'.  ``generators(global layer, microbatch, device)`` gives a
    layer's dropout generator (None: no dropout).  Returns (b, s, d) on the
    last stage's first device."""
    from ..ops.transformer import num_layers_of
    n_st, m = len(p), int(microbatches)
    b = x.shape[0]
    if b % m:
        raise ValueError(f'pp_microbatches={m} must divide the batch {b}')
    mb = b // m
    layers = [num_layers_of(st[0]) for st in p]
    first = [sum(layers[:s]) for s in range(n_st)]
    xs = x.split(mb)
    biases = None if bias is None else bias.expand(b, *bias.shape[1:]).split(mb)
    conds = [None if cond is None else cond.to(devs[0]) for devs in devices]
    outs: dict = {}
    for t in range(m + n_st - 1):
        for s in range(n_st):
            i = t - s
            if not 0 <= i < m:
                continue
            dev = devices[s][0]
            inp = xs[i] if s == 0 else outs.pop((s - 1, i))
            gens = None if generators is None else [
                generators(first[s] + k, i, dev) for k in range(layers[s])]
            with on_device(dev):
                outs[(s, i)] = stage_forward(
                    p[s], devices[s], inp.to(dev, non_blocking=True), n_heads,
                    None if biases is None else biases[i].to(dev, non_blocking=True),
                    conds[s], dropout_rate, gens, remat)
    return torch.cat([outs[(n_st - 1, i)] for i in range(m)])


# ---- one step's pipeline ----

def pp_parts(model_name: str):
    """The model's ``pp_microbatch_parts`` (ValleASR uses the AR's, as in
    JAX's ``parts_fns``)."""
    from ..models import ar as ar_mod
    from ..models import nar as nar_mod
    return {'ValleAR': ar_mod.pp_microbatch_parts, 'ValleASR': ar_mod.pp_microbatch_parts,
            'ValleNAR': nar_mod.pp_microbatch_parts}[model_name]


class PipelineRun:
    """One step's pipeline over the local data ranks of a pipe ``mesh``:
    ``params`` the ranks' trees (``Sharded``), ``parts`` the model's
    ``pp_microbatch_parts`` of the whole ``batch`` (on the mesh's first
    device), ``generator`` the step's (None: no dropout, no corruption),
    ``microbatches`` the configured count (clamped per data rank, ``_gcd``),
    ``leaves`` each local rank's trained leaves (``MeshOptimizer.ranks``)
    for the hand-scheduled backward.

    ``connected`` runs the loss differentiably (the models' ``loss_fn(pp=)``,
    evaluation); ``gpipe`` and ``pipeline_1f1b.one_f_one_b`` run a train
    step's schedule, after which ``grads`` and ``metrics`` hold the result.
    ``ring_peak`` is the most stage inputs one stage held at once."""

    def __init__(self, config, mesh: Mesh, params, parts: dict, batch: dict,
                 generator=None, microbatches: int = 1, leaves: list | None = None):
        from ..lora import lora_scale
        self.config, self.mesh, self.params, self.parts = config, mesh, params, parts
        self.leaves = leaves
        self.P, self.mp, self.G = mesh.pipe, mesh.model, mesh.group_size
        self.lora = config.lora_rank > 0
        self.scale = lora_scale(config) if self.lora else None
        self.lp = config.num_layers // self.P
        valid = parts['valid']
        self.batch = dict(batch, valid=valid)
        self.n_valid = parts['n_valid'] if 'n_valid' in parts else valid.sum()
        self.denom = self.n_valid.clamp(min=1)
        self.inv = 1.0 / self.denom.float()
        rows = next(iter(batch.values())).shape[0]
        base = None if generator is None else generator.initial_seed()
        drop = generator is not None and config.dropout > 0.0
        self.drop = config.dropout if drop else 0.0
        self.ranks = []                 # (local k, data rank i, first row, M, rows a microbatch)
        self.draws = {}
        for k, i in enumerate(mesh.local_data):
            cut = data_rows(mesh, rows, i)
            n = cut.stop - cut.start
            if n == 0:
                continue
            m = _gcd(n, microbatches)
            self.ranks.append((k, i, cut.start, m, n // m))
            self.draws[k] = Draws(base, i, layers=drop)
        self._rows: dict = {}
        self._bias: dict = {}
        self._cast: dict = {}
        # what each unit differentiates against, aligned with ``leaves``: a
        # stack leaf's cast (``_cast_stack``) in place of the leaf
        self.inputs = None if leaves is None else [list(lv) for lv in leaves]
        self.inbox: dict = {}
        self.cts: dict = {}
        self.ring: dict = {}
        self.ring_peak = 0
        self.sums: dict = {}
        self.acc = None if leaves is None else [[None] * len(lv) for lv in leaves]

    # ---- the ranks' trees ----
    def _rank(self, k: int, s: int, j: int = 0) -> int:
        return k * self.G + s * self.mp + j

    def _tree(self, k: int, s: int, j: int = 0) -> Params:
        return self.params[self._rank(k, s, j)]

    def _top(self, tree: Params) -> Params:
        """A tree's leaves outside the stack, uncast (a LoRA state's merged)."""
        if not self.lora:
            return {k: v for k, v in tree.items() if k != 'transformer'}
        from ..lora import merge_lora
        base = {k: v for k, v in tree['base'].items() if k != 'transformer'}
        adapters = {k: v for k, v in tree['lora'].items() if k != 'transformer'}
        return merge_lora(base, adapters, self.scale) if adapters else base

    def _stacks(self, k: int, s: int, devices) -> list[Params]:
        """Stage s's model ranks' stacks in the compute dtype: differentiable
        from the ranks' leaves, or in a scheduled step their casts
        (``_cast_stack``)."""
        from ..ops.nn import cast_to_compute
        if not self.lora:
            if self.leaves is not None:
                return [self._cast_stack(self._rank(k, s, j)) for j in range(self.mp)]
            return [cast_to_compute(self._tree(k, s, j)['transformer'], self.config)
                    for j in range(self.mp)]
        from ..lora import merge_lora
        tree = self._tree(k, s)
        stack = tree['base']['transformer']
        if 'transformer' in tree['lora']:
            stack = merge_lora(stack, tree['lora']['transformer'], self.scale)
        stack = cast_to_compute(stack, self.config)
        return tp_slice_stage(stack, devices) if self.mp > 1 else [stack]

    def _cast_stack(self, r: int) -> Params:
        """Rank r's stack in the compute dtype, cast once a step: each cast
        of a trained leaf is a leaf of its own, which the units differentiate
        against (``inputs``) and whose grads ``_accumulate`` converts back to
        the master dtype, as the cast's backward would.  So the units share
        one copy, and no unit's graph holds its own."""
        got = self._cast.get(r)
        if got is None:
            from ..ops.transformer import map_tree
            cdtype, pdtype = self.config.torch_dtype, self.config.torch_param_dtype
            index = {id(leaf): n for n, leaf in enumerate(self.leaves[r])}

            def cast(a):
                if a.dtype != pdtype or cdtype == pdtype:
                    return a
                c = a.detach().to(cdtype)
                if id(a) in index:
                    c.requires_grad_()
                    self.inputs[r][index[id(a)]] = c
                return c
            got = self._cast[r] = map_tree(cast, self.params[r]['transformer'])
        return got

    def _bias_of(self, k: int, m: int, rows: dict, dev):
        """Microbatch m's attention bias on ``dev``, made once a step."""
        key = (k, m, str(dev))
        if key not in self._bias:
            self._bias[key] = self.parts['bias'](rows)
        return self._bias[key]

    def _rows_of(self, k: int, m: int, dev) -> dict:
        """Microbatch m's rows of local data rank k (the batch's keys and
        'valid') on ``dev``, moved once a step."""
        key = (k, m, str(dev))
        rows = self._rows.get(key)
        if rows is None:
            _, _, lo, _, mb = self._rank_info(k)
            lo += m * mb
            rows = self._rows[key] = {n: v[lo:lo + mb].to(dev, non_blocking=True)
                                      for n, v in self.batch.items()}
        return rows

    def _rank_info(self, k: int):
        return next(r for r in self.ranks if r[0] == k)

    # ---- units ----
    def _forward(self, k: int, i: int, s: int, m: int, x: torch.Tensor | None) -> torch.Tensor:
        """Stage s on microbatch m of data rank i (local k): ``x`` the input
        on the stage's first device, or (stage 0) None, the embeddings."""
        devs = self.mesh.stage(i, s)
        dev = devs[0]
        rows = self._rows_of(k, m, dev)
        parts = self.parts
        with on_device(dev):
            if s == 0:
                x = parts['prep'](self._top(self._tree(k, 0)), rows, self.draws[k].prep(m, dev))
            cond = parts['cond'](self._top(self._tree(k, s)), rows)
            return stage_forward(self._stacks(k, s, devs), devs, x, self.config.n_heads,
                                 self._bias_of(k, m, rows, dev), cond, self.drop,
                                 self.draws[k].layers(s * self.lp, self.lp, m, dev),
                                 self.config.remat)

    def _send(self, k: int, i: int, s: int, m: int, y: torch.Tensor) -> None:
        """Stage s's output of microbatch m to stage s + 1's inbox."""
        dev = self.mesh.stage(i, s + 1)[0]
        self.inbox[(k, s + 1, m)] = y.detach().to(dev, non_blocking=True)

    def _add_sums(self, k: int, nll, acc) -> None:
        got = self.sums.get(k)
        self.sums[k] = (nll, acc) if got is None else (got[0] + nll, got[1] + acc)

    def _head(self, k: int, m: int, y: torch.Tensor) -> torch.Tensor:
        """The head and the loss of microbatch m on the last stage and their
        backward: the head's grads accumulate, the loss sums add up, and the
        cotangent of y returns (the loss's 1 / count seeds it)."""
        tree = self._tree(k, self.P - 1)
        rows = self._rows_of(k, m, y.device)
        y_leaf = y.detach().requires_grad_()
        with torch.enable_grad(), on_device(y.device):
            nll, acc, _nv = self.parts['head_loss'](self._top(tree), y_leaf, rows)
        r = self._rank(k, self.P - 1)
        gs = torch.autograd.grad(nll, [*self.inputs[r], y_leaf],
                                 self.inv.to(y.device, non_blocking=True), allow_unused=True)
        self._accumulate(r, gs[:-1])
        self._add_sums(k, nll.detach(), acc)
        return gs[-1]

    def _vjp(self, k: int, s: int, y: torch.Tensor, x_leaf, ct) -> torch.Tensor | None:
        """Stage s's backward from the cotangent ``ct`` of its output: its
        ranks' leaves' grads accumulate; returns the input's cotangent."""
        rs = [self._rank(k, s, j) for j in range(self.mp)]
        inputs = [t for r in rs for t in self.inputs[r]]
        if x_leaf is not None:
            inputs.append(x_leaf)
        gs = torch.autograd.grad(y, inputs, ct, allow_unused=True)
        pos = 0
        for r in rs:
            n = len(self.leaves[r])
            self._accumulate(r, gs[pos:pos + n])
            pos += n
        return gs[-1] if x_leaf is not None else None

    def _accumulate(self, r: int, gs) -> None:
        acc, leaves = self.acc[r], self.leaves[r]
        for idx, g in enumerate(gs):
            if g is not None:
                g = g.to(leaves[idx].dtype)
                acc[idx] = g if acc[idx] is None else acc[idx] + g

    def _back(self, k: int, i: int, s: int, m: int, y, x_leaf) -> None:
        """The backward unit of stage s on microbatch m, its cotangent from
        ``cts``, the input's sent to stage s - 1."""
        dx = self._vjp(k, s, y, x_leaf, self.cts.pop((k, s, m)))
        if s > 0:
            dev = self.mesh.stage(i, s - 1)[0]
            self.cts[(k, s - 1, m)] = dx.to(dev, non_blocking=True)

    # ---- schedules ----
    def ticks(self, extra: int) -> range:
        return range(max(m for _, _, _, m, _ in self.ranks) + extra) if self.ranks else range(0)

    def gpipe(self) -> None:
        """GPipe: every forward unit in tick order (stage s takes microbatch
        t - s at tick t; the last stage's head right after its forward),
        each keeping its autograd graph, then every backward unit in tick
        order (stage s takes microbatch t - (P - 1 - s)).  Each stage
        accumulates its microbatches' grads in microbatch order, as
        ``one_f_one_b`` does, so the two schedules give the same grads."""
        P, saved = self.P, {}
        for t in self.ticks(P - 1):
            for k, i, _, n_mb, _ in self.ranks:
                for s in range(P):
                    m = t - s
                    if not 0 <= m < n_mb:
                        continue
                    x_leaf = None if s == 0 else self.inbox.pop((k, s, m)).requires_grad_()
                    with torch.enable_grad():
                        y = self._forward(k, i, s, m, x_leaf)
                    saved[(k, s, m)] = (y, x_leaf)
                    if s < P - 1:
                        self._send(k, i, s, m, y)
                    else:
                        self.cts[(k, s, m)] = self._head(k, m, y)
        for t in self.ticks(P - 1):
            for k, i, _, n_mb, _ in self.ranks:
                for s in reversed(range(P)):
                    m = t - (P - 1 - s)
                    if 0 <= m < n_mb:
                        self._back(k, i, s, m, *saved.pop((k, s, m)))

    def connected(self, head: Callable | None = None):
        """The loss of the local data ranks through ``pipeline_transformer``
        per data rank, differentiable end to end (the models' ``loss_fn(pp=)``
        and evaluation): (this process's share of the loss on the mesh's
        first device, metrics of the whole batch).  ``head(top, y, rows)``
        instead of the loss: the list of its results per microbatch in
        rank order (``ar.forward(pp=)``'s logits)."""
        outs, dev0 = [], self.mesh.devices[0]
        for k, i, _, n_mb, _ in self.ranks:
            stages = [self.mesh.stage(i, s) for s in range(self.P)]
            d0, d_last = stages[0][0], stages[-1][0]
            draws = self.draws[k]
            with on_device(d0):
                top0 = self._top(self._tree(k, 0))
                rows = [self._rows_of(k, m, d0) for m in range(n_mb)]
                x = torch.cat([self.parts['prep'](top0, r, draws.prep(m, d0))
                               for m, r in enumerate(rows)])
                biases = [self.parts['bias'](r) for r in rows]
                bias = None if biases[0] is None else torch.cat(biases)
                cond = self.parts['cond'](top0, rows[0])
            gens = None if not draws.on_layers else (
                lambda g, m, dev, draws=draws: draws.layer(g, m, dev))
            y = pipeline_transformer([self._stacks(k, s, stages[s]) for s in range(self.P)],
                                     x, self.config.n_heads, bias, cond, devices=stages,
                                     microbatches=n_mb, dropout_rate=self.drop,
                                     generators=gens, remat=self.config.remat)
            top = self._top(self._tree(k, self.P - 1))
            for m, y_m in enumerate(y.split(y.shape[0] // n_mb)):
                rows_m = self._rows_of(k, m, d_last)
                with on_device(d_last):
                    if head is not None:
                        outs.append(head(top, y_m, rows_m))
                        continue
                    nll, acc, _nv = self.parts['head_loss'](top, y_m, rows_m)
                self._add_sums(k, nll, acc)
        if head is not None:
            return outs
        loss = torch.zeros((), device=dev0)
        for _, nll_acc in sorted(self.sums.items()):
            loss = loss + nll_acc[0].to(dev0)
        return loss / self.denom.to(dev0), self.metrics()

    def metrics(self) -> dict:
        """{'loss', 'acc', 'n_valid'} of the whole batch (the data ranks'
        sums in rank order, across processes too) and the parts' extras."""
        dev0 = self.mesh.devices[0]
        local = []
        for k in range(len(self.mesh.local_data)):
            got = self.sums.get(k)
            local.append(torch.zeros(2, device=dev0) if got is None else
                         torch.stack([got[0].detach().float(), got[1].float()]).to(dev0))
        every = self.mesh.gather_data(local)
        total = every[0]
        for x in every[1:]:
            total = total + x.to(total.device)
        denom = self.denom.to(total.device)
        return {'loss': total[0] / denom, 'acc': total[1] / denom,
                'n_valid': self.n_valid.detach(), **self.parts['metrics']}

    def grads(self) -> list[torch.Tensor]:
        """Every local rank's accumulated grads, rank-major in leaf order
        (``MeshOptimizer.leaves``): zeros where a rank's leaf took none."""
        return [torch.zeros_like(leaf) if g is None else g
                for leaves, acc in zip(self.leaves, self.acc) for leaf, g in zip(leaves, acc)]


def pipelined_loss(parts: dict, params, config, batch: dict, generator, pp):
    """The models' ``loss_fn(..., pp=(mesh, microbatches))``: the loss of the
    whole batch over a pipe mesh (``PipelineRun.connected``), differentiable,
    and its metrics."""
    mesh, microbatches = pp
    return PipelineRun(config, mesh, params, parts, batch, generator,
                       microbatches).connected()


def _microbatches(config, microbatches) -> int:
    return int(microbatches) if microbatches is not None else max(1, int(config.pp_microbatches))


def make_pp_step(config, model_name: str, mesh: Mesh, schedule: Callable, tag: str,
                 microbatches: int | None = None):
    """``step(state, batch, seed) -> (state, metrics)`` on a pipe mesh with
    ``schedule(run)`` (``PipelineRun.gpipe`` or ``one_f_one_b``); the state
    is a mesh state (``train.shard_state``), the batch the whole batch on
    the mesh's first device.  ``MeshOptimizer`` completes the grads over
    'model', 'pipe' and 'data' and steps.  A ``aot.CachedJit``, as
    ``train.make_train_step``."""
    from ..aot import cached_jit, config_key
    from ..config import precision_scope
    from ..profiling import annotate, nan_checks_enabled
    from ..train import TrainState, _check_finite_grads, step_generator
    check_pp(config, mesh)
    parts_fn = pp_parts(model_name)
    m_cfg = _microbatches(config, microbatches)

    def step_fn(state: TrainState, batch: dict, seed: int):
        opt = state.opt_state
        gen = step_generator(seed, state.step, mesh.devices[0])
        with annotate('train_step'), precision_scope(config):
            run = PipelineRun(config, mesh, state.params, parts_fn(config, batch, gen), batch,
                              gen, m_cfg, leaves=opt.ranks)
            schedule(run)
        metrics = run.metrics()
        grads = run.grads()
        if nan_checks_enabled():
            if not bool(torch.isfinite(metrics['loss'])):
                raise FloatingPointError(
                    f'train step {state.step}: the loss is {float(metrics["loss"])}')
            _check_finite_grads(state.step, grads)
        opt.update(grads)
        metrics = dict(metrics, grad_norm=opt.micro_norm)
        return TrainState(state.params, opt, state.step + 1), metrics
    return cached_jit(step_fn, tag=f'train_step_{model_name}_{tag}',
                      extra_key=config_key(config))


def make_pp_train_step(config, model_name: str, mesh: Mesh, microbatches: int | None = None):
    """The GPipe train step (JAX ``make_pp_train_step``): DP x PP[ x TP],
    with ZeRO-1, LoRA, ``grad_accum`` and ``remat`` through
    ``MeshOptimizer`` and the stage forward."""
    return make_pp_step(config, model_name, mesh, PipelineRun.gpipe, 'gpipe', microbatches)


def make_pp_eval_step(config, model_name: str, mesh: Mesh, microbatches: int | None = None):
    """``eval(params, batch, generator) -> metrics`` on a pipe mesh (JAX
    ``make_pp_eval_step``; both schedules evaluate through it): the
    models' ``loss_fn(pp=)`` without grads and without dropout; the NAR
    draws its stage from ``generator``."""
    from ..config import precision_scope
    from ..train import LOSS_FNS
    check_pp(config, mesh)
    loss_fn = LOSS_FNS[model_name]
    pp = (mesh, _microbatches(config, microbatches))

    @torch.no_grad()
    def eval_fn(params, batch: dict, generator: torch.Generator):
        with precision_scope(config):
            if model_name == 'ValleNAR':
                _, metrics = loss_fn(params, config, batch, generator, train=False, pp=pp)
            else:
                _, metrics = loss_fn(params, config, batch, None, pp=pp)
        return metrics
    return eval_fn
