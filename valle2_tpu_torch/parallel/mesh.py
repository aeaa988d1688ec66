"""Device meshes and the sharding rules (``valle2_tpu/parallel/mesh.py``).

One process drives every rank it holds, as JAX's single controller drives a
``jax.shard_map``: a ``Mesh`` is a row-major ``data x model`` grid of
devices, rank (i, j) on ``devices[i * model + j]`` (JAX ``make_mesh``
reshapes the same way), a ``data x pipe x model`` grid, rank (i, s, j) on
``devices[(i * pipe + s) * model + j]`` (JAX ``make_pp_mesh``;
``parallel.pipeline``), or, from ``make_model_mesh``, a ('model',) line.

The rules say which slice of which leaf each rank holds:

- batch leaves: rows over 'data' (``data_rows``, the one row cut, which
  ``shard_batch``, ``data_shard_map`` and the training step's
  ``models.ar.mesh_rows`` share);
- params (``_param_spec``, the Megatron pairing on 'model', a dim cut only
  where it divides): the fused qkv and FFN lin1 (its bias too) by output
  columns, the attention output and FFN lin2 by input rows, the output heads
  by vocabulary; the rest replicates (so the 1025-wide AR head does);
- optimizer state under ZeRO-1 (``_zero1_extend``): additionally over
  'data', on the first free axis the data size divides;
- decode params (``tp_decode_specs``): the Megatron pairing, the LM head
  replicated.

``shard_params`` puts the slices on the ranks' devices.  The JAX package
leaves the math to GSPMD, which may cut the fused qkv columns anywhere; the
port's ranks run their local heads by hand (``ops.transformer``'s TP
stack), so the qkv columns are first regrouped rank-major
(``tp_permute_qkv``) and each rank's column slice is its heads' [q | k | v]
(``gather_params`` undoes it).  Where the heads or the FFN width do not
divide the model axis the stack replicates over it, as JAX's flash route
declines there.

Under a 'pipe' axis the stack's leading layer axis is cut over 'pipe'
(``pipeline.pp_placement``) and every other leaf replicates there.

A mesh may span processes (``parallel.distributed``): each process holds
the ranks of its own devices, whole model groups (whole pipe x model
groups: processes split a pipeline mesh along 'data' only), and the
data-axis collectives (``Mesh.gather_data``) cross processes in rank order.

Virtual ranks (several ranks on one device, ``devices=['cpu'] * n`` or
``['cuda:0'] * n``) run only where the caller lists them; by default a mesh
takes the CUDA cards.  Context meshes (CP), a pipe group across processes
and the GSPMD fallback for splits that do not divide are not ported
(ROADMAP.md queue 1 item 14).
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch

Params = dict[str, Any]
Spec = tuple

ITEM14 = 'ROADMAP.md queue 1 item 14'


def process_info() -> tuple[int, int]:
    """(processes, this process's index) of the ``torch.distributed`` group,
    or (1, 0) without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """The devices of this process's ranks in a ('data', 'model') or a
    ('data', 'pipe', 'model') grid, or of a ('model',) line.  ``devices``
    lists the local ranks row-major; with several processes, process p holds
    the global ranks ``first .. first + len(devices) - 1``.  Each rank has a
    CUDA stream (made at first use) for the phased twin of the fused TP
    steps (the persistent TP step runs one launch per card on that card's
    current stream, and uses none)."""

    def __init__(self, devices, data: int | None = None, processes: int = 1,
                 process: int = 0, pipe: int = 1):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError('a mesh needs at least one device')
        total = len(self.devices) * processes
        if data is None:
            if processes != 1 or pipe != 1:
                raise ValueError('a (\'model\',) mesh lives in one process')
            self.axis_names = ('model',)
            self.shape = {'model': total}
        elif pipe > 1:
            if total % (data * pipe):
                raise ValueError(f'{total} ranks do not form a data x pipe grid of '
                                 f'{data} x {pipe}')
            self.axis_names = ('data', 'pipe', 'model')
            self.shape = {'data': data, 'pipe': pipe, 'model': total // (data * pipe)}
        else:
            if total % data:
                raise ValueError(f'{total} ranks do not form a data axis of {data}')
            self.axis_names = ('data', 'model')
            self.shape = {'data': data, 'model': total // data}
        self.processes, self.process = processes, process
        self.first = process * len(self.devices)
        if len(self.devices) % self.group_size:
            if self.pipe > 1:
                raise NotImplementedError(
                    f'processes split a pipeline mesh along \'data\' only: {len(self.devices)} '
                    f'local ranks for pipe x model groups of {self.group_size} ({ITEM14})')
            raise ValueError(f'each process holds whole model groups: {len(self.devices)} '
                             f'local ranks for a model axis of {self.model}')
        self._streams = None
        self._replicas: dict[int, Mesh] = {}

    @property
    def size(self) -> int:
        """Ranks of the whole mesh (every process's)."""
        return self.data * self.group_size

    @property
    def data(self) -> int:
        return self.shape.get('data', 1)

    @property
    def pipe(self) -> int:
        return self.shape.get('pipe', 1)

    @property
    def model(self) -> int:
        return self.shape['model']

    @property
    def group_size(self) -> int:
        """Ranks of one data rank: pipe x model."""
        return self.pipe * self.model

    def coords(self, g: int) -> tuple[int, int, int]:
        """Global rank ``g``'s (data, pipe, model) coordinates."""
        i, c = divmod(g, self.group_size)
        return (i, *divmod(c, self.model))

    @property
    def local_data(self) -> range:
        """The data ranks this process holds."""
        return range(self.first // self.group_size,
                     (self.first + len(self.devices)) // self.group_size)

    def group(self, i: int) -> list[torch.device]:
        """The devices of data rank ``i``'s ranks (a local data rank): its
        model ranks, or under a 'pipe' axis its pipe x model ranks, row-major."""
        lo = (i - self.local_data.start) * self.group_size
        return self.devices[lo:lo + self.group_size]

    def stage(self, i: int, s: int) -> list[torch.device]:
        """The devices of pipeline stage ``s``'s model ranks of data rank ``i``."""
        return self.group(i)[s * self.model:(s + 1) * self.model]

    def replica(self, i: int) -> Mesh:
        """Data rank ``i``'s model ranks as a ('model',) mesh (made once, so
        its streams persist): the TP serving and training paths run there."""
        sub = self._replicas.get(i)
        if sub is None:
            sub = self._replicas[i] = Mesh(self.group(i))
        return sub

    def streams(self) -> list:
        """One ``torch.cuda.Stream`` per local rank, on the rank's card (virtual
        ranks on one card get a stream each, so the ranks' work runs under
        the cross-rank ordering of the phased TP step,
        ``kernels.fused_decode.fused_step_tp_phased``, not in issue order)."""
        if self._streams is None:
            self._streams = [torch.cuda.Stream(device=d) for d in self.devices]
        return self._streams

    def gather_data(self, local: list[torch.Tensor]) -> list[torch.Tensor]:
        """One same-shaped tensor per local data rank -> one per data rank of
        the mesh, in rank order (an ``all_gather`` over the processes; the
        local list itself in one process).  Remote entries land on the
        first local entry's device."""
        if self.processes == 1:
            return list(local)
        import torch.distributed as dist
        dev = local[0].device
        mine = torch.stack([t.to(dev) for t in local])
        parts = [torch.empty_like(mine) for _ in range(self.processes)]
        dist.all_gather(parts, mine.contiguous())
        return [t for part in parts for t in part.unbind(0)]

    def __repr__(self) -> str:
        axes = ', '.join(f'{k}={v}' for k, v in self.shape.items())
        return f"Mesh({axes}, devices={[str(d) for d in self.devices]})"


def _cards() -> list[torch.device]:
    return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]


def make_model_mesh(mp: int, devices=None) -> Mesh:
    """A ('model',) mesh of ``mp`` ranks over the first mp of ``devices``
    (default: every CUDA card).  Raises when fewer exist, as the JAX helper
    does; virtual ranks only where the caller lists a device more than once."""
    devices = _cards() if devices is None else list(devices)
    if mp < 1 or mp > len(devices):
        raise ValueError(f'model mesh size {mp} needs {mp} devices, have {len(devices)}')
    return Mesh(devices[:mp])


def make_mesh(data: int | None = None, model: int = 1, devices=None, pipe: int = 1) -> Mesh:
    """A ('data', 'model') mesh, rank (i, j) on ``devices[i * model + j]``
    (JAX ``make_mesh``), or with ``pipe`` > 1 a ('data', 'pipe', 'model')
    mesh, rank (i, s, j) on ``devices[(i * pipe + s) * model + j]`` (JAX
    ``make_pp_mesh``).  ``devices``: this process's devices (default: every
    CUDA card; under several processes on one host, this process's share of
    them, ``process_cards``).  ``data`` None takes every device.  Raises when
    too few exist."""
    procs, proc = process_info()
    group = model * pipe
    if devices is None:
        cards = _cards()
        if procs > 1:
            n = (data or len(cards) // group) * group // procs
            devices = process_cards(cards, n, procs, proc)
        else:
            devices = cards
    devices = list(devices)
    if data is None:
        data = len(devices) * procs // group
    need = data * group
    if data < 1 or model < 1 or pipe < 1 or need % procs or need // procs > len(devices):
        shape = f'{data}x{pipe}x{model}' if pipe > 1 else f'{data}x{model}'
        raise ValueError(f'mesh {shape} needs {need} devices, have {len(devices) * procs}')
    return Mesh(devices[:need // procs], data=data, processes=procs, process=proc, pipe=pipe)


def process_cards(cards: list, n: int, procs: int, proc: int) -> list:
    """Process ``proc``'s ``n`` cards of a host's ``cards`` shared by
    ``procs`` processes: the block ``[proc * per, proc * per + n)``, ``per`` =
    len(cards) // procs (its first card is the one ``init_distributed``
    makes current).  Raises where the block goes past the process's share:
    NCCL refuses two processes on one card."""
    per = len(cards) // procs
    if n < 1 or n > per:
        raise ValueError(f'{procs} processes of {n} ranks each need {procs * max(n, 1)} '
                         f'cards, have {len(cards)}')
    return cards[proc * per:proc * per + n]


def training_mesh(config, devices=None) -> Mesh | None:
    """The mesh a config asks for, ``mesh_data`` x ``mesh_model``, or with
    ``mesh_pipe`` > 1 ``mesh_data`` x ``mesh_pipe`` x ``mesh_model`` (JAX
    ``train.train``), or None for one device.  The context axis is not
    ported (the config refuses it, and refuses it beside a pipe axis with
    ``ValueError``, as JAX's ``train`` does)."""
    if config.mesh_ctx > 1:
        raise NotImplementedError(f'context meshes (CP) are not ported ({ITEM14})')
    if config.mesh_data * config.mesh_pipe * config.mesh_model <= 1:
        return None
    return make_mesh(config.mesh_data, config.mesh_model, devices, pipe=config.mesh_pipe)


def tp_divisible(n_heads: int, d_ff: int, mp: int) -> bool:
    """Whether heads and the FFN width split evenly over ``mp`` ranks."""
    return mp > 0 and n_heads % mp == 0 and d_ff % mp == 0


def tp_permute_qkv(tparams: Params, mp: int) -> Params:
    """Regroup the fused-qkv output columns [q | k | v] rank-major, [q_0 k_0
    v_0 | q_1 k_1 v_1 | ...], so that rank r's contiguous 1/mp column slice is
    its local fused qkv (heads [r h/mp, (r+1) h/mp)); the int8 'q' / 'scale'
    and int4 'q4' / 'scale4' leaves follow the same column order (int4 packs
    input rows, so its columns regroup like the dense ones).  Returns a new
    tree; every other leaf is shared.  ``inverse`` undoes it."""
    return _regroup_qkv(tparams, mp, False)


def tp_unpermute_qkv(tparams: Params, mp: int) -> Params:
    """The inverse of ``tp_permute_qkv``."""
    return _regroup_qkv(tparams, mp, True)


def _regroup_qkv(tparams: Params, mp: int, inverse: bool) -> Params:
    def perm_w(w):                        # (..., k, 3d) -> columns regrouped
        *lead, three_d = w.shape
        d = three_d // 3
        shape = (*lead, mp, 3, d // mp) if inverse else (*lead, 3, mp, d // mp)
        return w.reshape(shape).transpose(-3, -2).reshape(*lead, three_d)

    qkv = dict(tparams['attn']['qkv'])
    for key in ('w', 'q', 'q4', 'scale4', 'scale'):
        if key in qkv:
            qkv[key] = perm_w(qkv[key])
    return {**tparams, 'attn': {**tparams['attn'], 'qkv': qkv}}


# ---- the rules: a spec is one entry per dim, an axis name or None ----

# The Megatron rule of the JAX package's tp_decode_specs, by the leaf's path.
_COLUMN = ('qkv/w', 'qkv/q', 'qkv/q4', 'qkv/scale', 'qkv/scale4', 'lin1/w', 'lin1/q',
           'lin1/q4', 'lin1/scale', 'lin1/scale4', 'lin1/b')
_ROW = ('out/w', 'out/q', 'out/q4', 'out/scale4', 'lin2/w', 'lin2/q', 'lin2/q4',
        'lin2/scale4')
# The GSPMD rule of _param_spec: int8 and int4 row-parallel scales replicate.
_PARAM_COLUMN = ('qkv/w', 'lin1/w', 'lin1/b', 'qkv/q', 'lin1/q', 'qkv/scale', 'lin1/scale',
                 'qkv/q4', 'lin1/q4', 'qkv/scale4', 'lin1/scale4')
_PARAM_ROW = ('out/w', 'lin2/w', 'out/q', 'lin2/q', 'out/q4', 'lin2/q4')


def _paths(tree, prefix=''):
    """(joined path, leaf) pairs of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f'{prefix}/{k}' if prefix else str(k))
    else:
        yield prefix, tree


def _map_paths(fn, tree, prefix=''):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f'{prefix}/{k}' if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def _param_spec(path: str, leaf, model_size: int) -> Spec:
    """The 'model' cut of one param leaf by its path (JAX ``_param_spec``):
    column-parallel leaves on their last axis, row-parallel ones on the
    input rows, the output heads (``proj_layers``, ``proj/w``) on the
    vocabulary; only where ``model_size`` divides the dim."""
    shape = tuple(leaf.shape)
    ndim = len(shape)

    def dim_spec(axis_from_end: int) -> Spec:
        idx = ndim - axis_from_end
        if idx < 0 or shape[idx] % model_size != 0:
            return (None,) * ndim
        return tuple('model' if i == idx else None for i in range(ndim))

    if path.endswith(_PARAM_COLUMN):
        return dim_spec(1)
    if path.endswith(_PARAM_ROW):
        return dim_spec(2)
    if 'proj_layers' in path or path == 'proj/w':
        return dim_spec(1)
    return (None,) * ndim


def _zero1_extend(spec: Spec, shape, data_size: int) -> Spec:
    """ZeRO-1: also cut the first free axis ``data_size`` divides over
    'data' (AdamW is elementwise, so any axis would do; the first keeps the
    rule deterministic).  Leaves with none (norm scales, biases) stay."""
    if data_size <= 1:
        return spec
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    for i, dim in enumerate(shape):
        if spec[i] is None and dim >= data_size and dim % data_size == 0:
            return spec[:i] + ('data',) + spec[i + 1:]
    return spec


def param_sharding(mesh: Mesh, params: Params, zero1: bool = False) -> Params:
    """The spec of every leaf of a params (or, with ``zero1``, an
    optimizer-moment) tree under the rules (JAX ``param_sharding``)."""
    model_size = mesh.shape.get('model', 1)
    data_size = mesh.shape.get('data', 1) if zero1 else 1

    def spec_for(path, leaf):
        spec = _param_spec(path, leaf, model_size)
        return _zero1_extend(spec, tuple(leaf.shape), data_size) if zero1 else spec
    return _map_paths(spec_for, params)


def sequence_parallel_spec(config, mesh: Mesh | None) -> Spec | None:
    """Megatron sequence parallelism's residual-stream spec, or None: with
    ``config.sequence_parallel`` and a model axis > 1, (b, s, d) activations
    between blocks are rows over 'data' and the SEQUENCE over 'model'
    (JAX ``sequence_parallel_spec``).  The TP stack then keeps 1/mp of the
    sequence per rank for the norm, dropout and residual regions."""
    if mesh is None or not getattr(config, 'sequence_parallel', False):
        return None
    if mesh.shape.get('model', 1) <= 1:
        return None
    return ('data' if mesh.shape.get('data', 1) > 1 else None, 'model', None)


def tp_decode_specs(params: Params) -> Params:
    """The decode params' specs under manual tensor parallelism (JAX
    ``tp_decode_specs``): qkv / lin1 (their scales and lin1's bias) by
    columns, out / lin2 (and their int4 group scales) by input rows,
    everything else -- the LM head too -- replicated.  Assumes
    ``tp_permute_qkv`` regrouped the qkv columns."""
    def spec_for(path, leaf):
        ndim = leaf.dim()
        if path.endswith(_COLUMN):
            return (None,) * (ndim - 1) + ('model',)
        if path.endswith(_ROW):
            return (None,) * (ndim - 2) + ('model', None)
        return (None,) * ndim
    return _map_paths(spec_for, params)


# ---- placement ----

def _cut(value: torch.Tensor, spec: Spec, mesh: Mesh, coords) -> torch.Tensor:
    """The block of ``value`` under ``spec`` of the rank at ``coords`` =
    (data, pipe, model) (equal blocks: the rules only cut dims that divide)."""
    sizes = {'data': mesh.data, 'pipe': mesh.pipe, 'model': mesh.model}
    at = dict(zip(('data', 'pipe', 'model'), coords))
    for axis, name in enumerate(spec):
        if name is not None:
            value = torch.tensor_split(value, sizes[name], dim=axis)[at[name]]
    return value


def device_put_global(value: torch.Tensor, spec: Spec, mesh: Mesh) -> list[torch.Tensor]:
    """One block per local rank of ``value`` (every process holds the whole
    value), each contiguous on its rank's device: ``spec`` says which
    (JAX ``device_put_global``).  Blocks are copies, never shared between
    ranks, so that each rank's leaf takes its own grad."""
    out = []
    for r, dev in enumerate(mesh.devices):
        block = _cut(value, spec, mesh, mesh.coords(mesh.first + r))
        out.append(block.detach().to(dev, copy=True).contiguous())
    return out


def _unzip(leaves: dict, n: int) -> list:
    """{path: [block per rank]} -> one nested tree per rank."""
    trees = [dict() for _ in range(n)]
    for path, blocks in leaves.items():
        keys = path.split('/')
        for tree, block in zip(trees, blocks):
            node = tree
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = block
    return trees


def _tp_permuted(params: Params, mp: int) -> Params:
    """The tree with every transformer stack's qkv columns regrouped for
    ``mp`` ranks (the stacks of a model, or of the base of a LoRA state)."""
    if isinstance(params, dict) and 'attn' in params and 'qkv' in params.get('attn', {}):
        return tp_permute_qkv(params, mp)
    if isinstance(params, dict):
        return {k: _tp_permuted(v, mp) if isinstance(v, dict) else v
                for k, v in params.items()}
    return params


def _tp_unpermuted(params: Params, mp: int) -> Params:
    if isinstance(params, dict) and 'attn' in params and 'qkv' in params.get('attn', {}):
        return tp_unpermute_qkv(params, mp)
    if isinstance(params, dict):
        return {k: _tp_unpermuted(v, mp) if isinstance(v, dict) else v
                for k, v in params.items()}
    return params


def placement(mesh: Mesh, params: Params, zero1: bool = False, tp: bool = True) -> Params:
    """The spec ``shard_params`` places each leaf by: ``param_sharding``'s,
    with the 'model' cuts dropped where ``tp`` is False (the heads or the
    FFN width do not divide the model axis: the stack replicates over it,
    ZeRO-1 still cuts over 'data'); under a 'pipe' axis
    ``pipeline.pp_placement``'s."""
    if mesh.pipe > 1:
        from .pipeline import pp_placement
        return pp_placement(mesh, params, zero1, tp)
    specs = param_sharding(mesh, params, zero1=zero1)
    if tp:
        return specs
    return map_specs(lambda s: tuple(None if a == 'model' else a for a in s), specs)


def map_specs(fn, specs):
    """``fn`` over every spec of a specs tree."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


class Sharded(list):
    """One tree per local rank of a mesh (``shard_params``), with what placed
    them: ``specs`` (``placement``'s tree, of the whole leaves) and ``tp``
    (whether the 'model' cuts are live, the qkv columns regrouped)."""

    def __init__(self, trees, specs=None, tp: bool = False):
        super().__init__(trees)
        self.specs, self.tp = specs, tp


def shard_params(mesh: Mesh, params: Params, zero1: bool = False,
                 tp: bool = True) -> Sharded:
    """Each local rank's tree of ``params`` (a model's params, or with
    ``zero1`` an optimizer-moment tree) under ``placement``, on its device
    (JAX ``shard_params``).  Under TP the qkv columns are regrouped
    rank-major first (see the module docstring)."""
    specs = placement(mesh, params, zero1, tp)
    flat = dict(_paths(specs))
    tp = tp and mesh.model > 1
    if tp:
        params = _tp_permuted(params, mesh.model)
    leaves = {p: device_put_global(x, flat[p], mesh) for p, x in _paths(params)}
    return Sharded(_unzip(leaves, len(mesh.devices)), specs, tp)


def gather_params(mesh: Mesh, trees: Sharded, device='cpu', specs=None) -> Params:
    """The whole tree from the local ranks' trees (the inverse of
    ``shard_params``; ``specs`` overrides ``trees.specs``), on ``device``.
    Blocks cut over 'data' (ZeRO-1) come from every data rank, across
    processes too (then a collective: every process calls it)."""
    specs = dict(_paths(trees.specs if specs is None else specs))
    leaves = [dict(_paths(t)) for t in trees]
    out = {path: [_assemble(mesh, [lv[path] for lv in leaves], spec, device)]
           for path, spec in specs.items()}
    tree = _unzip(out, 1)[0]
    return _tp_unpermuted(tree, mesh.model) if trees.tp else tree


def whole_shape(block: torch.Tensor, spec: Spec, mesh: Mesh) -> tuple:
    """The whole leaf's shape from one rank's block under ``spec``."""
    spec = tuple(spec) + (None,) * (block.dim() - len(spec))
    sizes = {'data': mesh.data, 'pipe': mesh.pipe, 'model': mesh.model, None: 1}
    return tuple(n * sizes[a] for n, a in zip(block.shape, spec))


def _assemble(mesh: Mesh, blocks: list, spec: Spec, device) -> torch.Tensor:
    """One leaf from the local ranks' blocks under ``spec``, on ``device``
    (the data blocks cross processes from the blocks' own device: NCCL
    takes no CPU tensor)."""
    spec = tuple(spec) + (None,) * (blocks[0].dim() - len(spec))
    m_axis = spec.index('model') if 'model' in spec else None
    p_axis = spec.index('pipe') if 'pipe' in spec else None
    d_axis = spec.index('data') if 'data' in spec else None
    home = blocks[0].device
    rows = []
    for k in range(len(mesh.local_data)):
        grp = blocks[k * mesh.group_size:(k + 1) * mesh.group_size]
        stages = []
        for s in range(mesh.pipe if p_axis is not None else 1):
            st = grp[s * mesh.model:(s + 1) * mesh.model]
            stages.append(torch.cat([b.detach().to(home) for b in st], m_axis)
                          if m_axis is not None else st[0].detach())
        rows.append(torch.cat([t.to(home) for t in stages], p_axis)
                    if p_axis is not None else stages[0])
    if d_axis is None:
        return rows[0].to(device)
    rows = mesh.gather_data(rows)
    return torch.cat([r.to(device) for r in rows], d_axis)


def data_rows(mesh: Mesh, rows: int, i: int) -> slice:
    """Data rank ``i``'s rows of a batch of ``rows``: the one row cut over
    'data' (``torch.tensor_split``'s: where the data size does not divide,
    the first ``rows % data`` ranks take one row more)."""
    base, extra = divmod(rows, mesh.data)
    lo = i * base + min(i, extra)
    return slice(lo, lo + base + (i < extra))


def shard_batch(mesh: Mesh, batch: dict) -> list[dict]:
    """Each local data rank's rows of a batch (``data_rows``) on the data
    rank's first device (JAX ``shard_batch``; a data rank's model ranks take
    the same rows from there)."""
    out = []
    for i in mesh.local_data:
        dev = mesh.group(i)[0]
        out.append({k: v[data_rows(mesh, v.shape[0], i)].to(dev) for k, v in batch.items()})
    return out


class PerReplica(list):
    """One value per local data rank, for ``data_shard_map`` /
    ``tp_shard_map``: each replica gets its own entry instead of the value."""


def _replica_args(mesh: Mesh, args, sharded, k: int, i: int, dev):
    out = []
    for a_i, a in enumerate(args):
        if isinstance(a, PerReplica):
            out.append(a[k])
        elif a_i in sharded:
            out.append(a[data_rows(mesh, a.shape[0], i)].to(dev))
        else:
            out.append(a)
    return out


def data_shard_map(mesh: Mesh, fn, n_args: int, sharded: tuple[int, ...], n_out: int):
    """``fn`` per local data rank (JAX ``data_shard_map``): the ``sharded``
    args' rows (``data_rows``) put on the data rank's first device, a
    ``PerReplica`` arg's own entry, every other arg as it is; the ``n_out``
    outputs concatenated by rows on the mesh's first device, in rank order.
    The replicas run one after another (on one card, on its stream)."""
    def wrapped(*args):
        if len(args) != n_args:
            raise TypeError(f'expected {n_args} arguments, got {len(args)}')
        outs = [[] for _ in range(n_out)]
        for k, i in enumerate(mesh.local_data):
            dev = mesh.group(i)[0]
            with on_device(dev):
                res = fn(*_replica_args(mesh, args, sharded, k, i, dev))
            res = res if isinstance(res, tuple) else (res,)
            for o, r in zip(outs, res):
                o.append(r)
        first = mesh.devices[0]
        return tuple(torch.cat([r.to(first) for r in o]) for o in outs)
    return wrapped


def tp_shard_map(mesh: Mesh, fn, n_args: int, sharded: tuple[int, ...], n_out: int):
    """``fn(replica_mesh, trees, *args)`` per local data rank over its model
    ranks (JAX ``tp_shard_map``): arg 0 is one tree per local rank (placed
    by ``tp_decode_specs``), and the replica gets its model group's trees
    and its own ('model',) mesh; the other args as ``data_shard_map`` cuts
    them."""
    def per_replica(trees_and_mesh, *args):
        sub, trees = trees_and_mesh
        return fn(sub, trees, *args)
    inner = data_shard_map(mesh, per_replica, n_args, sharded, n_out)

    def wrapped(trees, *args):
        groups = PerReplica((mesh.replica(i), trees[k * mesh.model:(k + 1) * mesh.model])
                            for k, i in enumerate(mesh.local_data))
        return inner(groups, *args)
    return wrapped


def shard_decode_params(params: Params, mp: int) -> list[Params]:
    """Rank r's tree of a (qkv-permuted, ``tp_permute_qkv``) stack or model
    under ``tp_decode_specs``: qkv and lin1 (their scales and lin1's bias
    too) cut to the r-th 1/mp of their last axis, out and lin2 (and their
    int4 group scales) to the r-th 1/mp of their input rows (axis -2),
    everything else shared.  The int4 row split needs the ranked packing
    (``quantize_linear_int4_ranked``)."""
    specs = dict(_paths(tp_decode_specs(params)))

    def cut(path, a, r):
        spec = specs[path]
        if 'model' not in spec:
            return a
        axis = spec.index('model')
        n = a.shape[axis] // mp
        return a.narrow(axis, r * n, n).contiguous()
    return [_map_paths(lambda p, a, r=r: cut(p, a, r), params) for r in range(mp)]


def shard_stack(stack: Params, mesh: Mesh, dtype, int4: bool = False) -> list[Params]:
    """The ranks' trees of a float transformer stack on a ('model',)
    ``mesh``: the qkv columns regrouped rank-major, the Megatron split, float
    leaves in ``dtype``, contiguous, each tree on its rank's device.
    ``int4``: quantized first, with the ranked packing of the row-parallel
    linears (JAX ``ValleAR._tp_params``)."""
    from ..ops.transformer import map_tree
    from ..quantize import quantize_transformer
    mp = mesh.size
    if int4:
        stack = quantize_transformer(stack, bits=4, tp_mp=mp)
    trees = shard_decode_params(tp_permute_qkv(stack, mp), mp)

    def place(a, dev):
        return (a.to(dtype) if a.is_floating_point() else a).to(dev).contiguous()
    return [map_tree(lambda a, dev=dev: place(a, dev), tree)
            for tree, dev in zip(trees, mesh.devices)]


def on_device(device):
    """The context in which a rank's kernels launch: its card made current
    (a ctypes launcher takes the current device's streams), nothing on the CPU."""
    device = torch.device(device)
    if device.type == 'cuda':
        return torch.cuda.device(device)
    return contextlib.nullcontext()
