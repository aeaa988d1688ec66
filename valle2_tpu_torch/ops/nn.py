"""Core NN primitives as plain functions over dict parameters.

PyTorch counterpart of ``valle2_tpu/ops/nn.py``: the same parameter dicts and
layouts (linear weights stored (in, out), stacked per layer by the transformer),
so weights move between the two packages leaf by leaf.  Initializers follow the
torch defaults the JAX package reproduces (kaiming-uniform linear, N(0, 1)
embedding), drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..quantize import int4_matmul, int8_dot, int8_matmul

Params = dict[str, Any]


def _uniform(gen: torch.Generator, shape, bound: float, dtype) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2 - 1).mul_(
        bound).to(dtype)


def linear_init(gen: torch.Generator, in_dim: int, out_dim: int, use_bias: bool = True,
                dtype=torch.float32) -> Params:
    """torch nn.Linear default init, weight stored (in_dim, out_dim)."""
    bound = 1.0 / math.sqrt(in_dim)
    p: Params = {'w': _uniform(gen, (in_dim, out_dim), bound, dtype)}
    if use_bias:
        p['b'] = _uniform(gen, (out_dim,), bound, dtype)
    return p


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b``, or the quantized product of ``quantize.py``'s layouts:
    'q' (int8 W8A8) and 'q4' (int4 W4A16), the bias added after.  Mixed float
    dtypes promote to the wider one, as JAX promotes them (a bfloat16
    attention output from a bfloat16 KV cache meets float32 weights in the
    decode step)."""
    if 'q' in p:
        y = int8_matmul(x, p['q'], p['scale'])
    elif 'q4' in p:
        y = int4_matmul(x, p['q4'], p['scale4'])
    else:
        w = p['w']
        if x.dtype != w.dtype:
            wide = torch.promote_types(x.dtype, w.dtype)
            x, w = x.to(wide), w.to(wide)
        y = x @ w
    if 'b' in p:
        y = y + p['b']
    return y


def decode_logits(p: Params, x: torch.Tensor) -> torch.Tensor:
    """The decode loops' logits head, ``linear(p, x)`` in float32, with the
    same bits for a row whatever other rows share the batch.  On the card a
    float32 GEMM rounds as the kernel cuBLAS picks for the row count does
    (TF32 under the default precision), so a continuous-batching step's
    logits parted from the solo step's and a sampled session could draw
    another token; there the product runs in float64 (the products of
    float32 or bfloat16 inputs are exact) and rounds to float32 once.  On the
    CPU, and for quantized weights, it is ``linear``."""
    if x.device.type != 'cuda' or 'w' not in p:
        return linear(p, x).float()
    y = x.double() @ p['w'].double()
    if 'b' in p:
        y = y + p['b'].double()
    return y.float()


def linear_row_parallel(ps: list[Params], xs: list[torch.Tensor], reduce=None,
                        residual: list[torch.Tensor] | None = None,
                        seq: list[tuple[int, int]] | None = None) -> list[torch.Tensor]:
    """Row-parallel linear under tensor parallelism (JAX
    ``linear_row_parallel``): rank r's weight ``ps[r]`` holds a slice of the
    input features and ``xs[r]`` the matching slice of the input, so its
    product is a partial sum; the bias is added once, after the sum.  One
    output per rank, on its device, equal across ranks; with ``residual``
    (one tensor per rank), ``residual[r] + out`` instead, the caller's
    residual add.  int8 W8A8 (inference): the activation scale takes the
    amax over every rank's slice (the solo row's scale) and the ranks' int32
    products sum exactly; dense and int4 W4A16 (the ranked packing) sum
    their float32 partials through ``psum_replicated_grad``: the
    rank-ordered sum with the bias, the cast and the residual add in one
    epilogue (``kernels.tp_allreduce.tp_row_reduce``: on the card 5c, one
    launch a card), differentiable, or ``reduce`` (``tp_allreduce_plain``:
    the plain version's sum, the epilogue in torch ops; not differentiated).
    ``seq`` (sequence parallelism): rank r keeps the sequence slice
    ``seq[r]`` of the sum (``reduce_scatter_seq``), and ``residual[r]`` is
    that slice's."""
    if 'q' in ps[0]:
        x32s = [x.float() for x in xs]
        dev0 = xs[0].device
        amax = torch.stack([x.abs().amax(dim=-1, keepdim=True).to(dev0)
                            for x in x32s]).amax(dim=0)
        sx = amax.clamp(min=1e-8) / 127.0
        acc = None
        for p, x in zip(ps, x32s):
            part = int8_dot(torch.round(x / sx.to(x.device)).clamp(-127, 127), p['q'])
            acc = part.to(dev0) if acc is None else acc + part.to(dev0)
        ys = [(acc.to(x.device).float() * sx.to(x.device) * p['scale']).to(x.dtype)
              for p, x in zip(ps, xs)]
        return _row_parallel_epilogue(ps, xs, ys, residual)
    parts = []
    for p, x in zip(ps, xs):
        if 'q4' in p:
            parts.append(int4_matmul(x, p['q4'], p['scale4']).float())
        else:
            w = p['w']
            wide = torch.promote_types(x.dtype, w.dtype)
            parts.append((x.to(wide) @ w.to(wide)).float())
    biases = [p.get('b') for p in ps]
    if reduce is not None:
        return _row_parallel_epilogue(ps, xs, reduce(parts), residual)
    if seq is not None:
        outs = reduce_scatter_seq(parts, biases, xs[0].dtype, seq)
        return outs if residual is None else [r + o for r, o in zip(residual, outs)]
    return psum_replicated_grad(parts, biases, residual, xs[0].dtype)


def _row_parallel_epilogue(ps, xs, ys, residual):
    """The bias after the sum, the cast to the input's dtype, the residual."""
    out = []
    for r, (p, x, y) in enumerate(zip(ps, xs, ys)):
        if 'b' in p:
            y = y + p['b']
        y = y.to(x.dtype)
        out.append(y if residual is None else residual[r] + y)
    return out


def embedding_init(gen: torch.Generator, vocab_size: int, dim: int,
                   dtype=torch.float32) -> Params:
    """torch nn.Embedding default init: N(0, 1)."""
    return {'emb': torch.randn((vocab_size, dim), generator=gen).to(dtype)}


def embedding(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return p['emb'][ids]


def layernorm_init(dim: int, dtype=torch.float32) -> Params:
    return {'scale': torch.ones(dim, dtype=dtype), 'bias': torch.zeros(dim, dtype=dtype)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch nn.LayerNorm numerics (biased variance) with float32 statistics
    whatever the activation dtype, as the JAX package computes them."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p['scale'] + p['bias']).to(x.dtype)


def adaln_init(gen: torch.Generator, dim: int, dtype=torch.float32) -> Params:
    return {'proj': linear_init(gen, dim, 2 * dim, dtype=dtype),
            'ln': layernorm_init(dim, dtype)}


def adaln(p: Params, x: torch.Tensor, cond: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``weight * LN(x) + bias`` with (weight, bias) = split(proj(cond));
    ``cond`` is (1, d) or (b, d) and broadcasts over the sequence axis."""
    weight, bias = linear(p['proj'], cond).chunk(2, dim=-1)
    y = layernorm(p['ln'], x, eps)
    if cond.dim() == 2 and x.dim() == 3:
        weight, bias = weight[:, None, :], bias[:, None, :]
    return weight * y + bias


def ffn_init(gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.float32) -> Params:
    return {'lin1': linear_init(gen, d_model, d_ff, dtype=dtype),
            'lin2': linear_init(gen, d_ff, d_model, dtype=dtype)}


def cast_to_compute(params: Params, config) -> Params:
    """Differentiable mixed-precision cast: every leaf in the master
    ``param_dtype`` becomes the compute ``dtype`` (bf16 training); other leaves
    pass through.  Autograd of the cast returns the grads in the master dtype."""
    cdtype, pdtype = config.torch_dtype, config.torch_param_dtype
    if cdtype == pdtype:
        return params
    from .transformer import map_tree
    return map_tree(lambda a: a.to(cdtype) if a.dtype == pdtype else a, params)


class ShardDraw:
    """The random draws of a data rank's rows: every draw is the whole
    batch's, as the solo step makes it from ``generator`` (``rows`` of them),
    cut to rows [lo, hi).  Pass it where a generator goes (dropout, the
    NAR's corruption); a scalar draw (the NAR stage) uses ``generator``
    itself, so every data rank draws the same one."""

    def __init__(self, generator: torch.Generator, lo: int, hi: int, rows: int):
        self.generator, self.lo, self.hi, self.rows = generator, lo, hi, rows

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def cut(self, draw: torch.Tensor) -> torch.Tensor:
        return draw[self.lo:self.hi]

    def whole(self, shape) -> tuple:
        return (self.rows, *tuple(shape)[1:])


def base_generator(generator):
    """The ``torch.Generator`` behind ``generator`` (a ``ShardDraw`` or one)."""
    return generator.generator if isinstance(generator, ShardDraw) else generator


def uniform(shape, generator, device=None) -> torch.Tensor:
    """``torch.rand(shape)`` from ``generator`` on ``device`` (default: the
    generator's); a ``ShardDraw`` draws the whole batch's and cuts its rows."""
    if isinstance(generator, ShardDraw):
        draw = torch.rand(generator.whole(shape), generator=generator.generator,
                          device=generator.device)
        return generator.cut(draw).to(device or generator.device)
    return torch.rand(tuple(shape), generator=generator, device=device or generator.device)


def randint(low: int, high: int, shape, generator, device=None, dtype=torch.long):
    """``torch.randint`` as ``uniform`` draws (a ``ShardDraw`` cuts its rows)."""
    if isinstance(generator, ShardDraw):
        draw = torch.randint(low, high, generator.whole(shape), generator=generator.generator,
                             device=generator.device, dtype=dtype)
        return generator.cut(draw).to(device or generator.device)
    return torch.randint(low, high, tuple(shape), generator=generator,
                         device=device or generator.device, dtype=dtype)


def dropout_mask(shape, rate: float, generator, device=None) -> torch.Tensor:
    """The keep mask of an inverted dropout over ``shape``."""
    return uniform(shape, generator, device) < 1.0 - rate


def apply_dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """Inverted dropout drawn from ``generator`` (or a ``ShardDraw``);
    identity when it is None (deterministic / eval mode) or ``rate`` <= 0."""
    if generator is None or rate <= 0.0:
        return x
    return apply_dropout(x, dropout_mask(x.shape, rate, generator, x.device), rate)


def ffn(p: Params, x: torch.Tensor, dropout_rate: float = 0.0,
        generator: torch.Generator | None = None) -> torch.Tensor:
    """Linear → exact (erf) GELU → dropout → Linear."""
    h = dropout(F.gelu(linear(p['lin1'], x)), dropout_rate, generator)
    return linear(p['lin2'], h)


def ffn_tp(ps: list[Params], xs: list[torch.Tensor], reduce=None,
           residual: list[torch.Tensor] | None = None, dropout_rate: float = 0.0,
           generator=None, seq: list[tuple[int, int]] | None = None) -> list[torch.Tensor]:
    """``ffn`` under tensor parallelism: lin1 column-split (rank r's slice of
    the hidden width, its bias slice), lin2 row-split (``linear_row_parallel``
    with ``reduce``, ``residual`` and ``seq``).  The input enters the column
    region through ``column_input``; the hidden dropout draws the solo
    step's whole-width mask and cuts each rank's columns."""
    xs = column_input(xs, seq)
    hs = [F.gelu(linear(p['lin1'], x)) for p, x in zip(ps, xs)]
    if generator is not None and dropout_rate > 0.0:
        w = hs[0].shape[-1]
        keep = dropout_mask((*hs[0].shape[:-1], w * len(hs)), dropout_rate, generator)
        hs = [apply_dropout(h, keep[..., r * w:(r + 1) * w].to(h.device), dropout_rate)
              for r, h in enumerate(hs)]
    return linear_row_parallel([p['lin2'] for p in ps], hs, reduce, residual, seq)


# ---- Tensor parallelism under autograd (JAX ``psum_replicated_grad`` /
# ``identity_psum_grad``): one tensor per rank, one controller.  Every model
# rank carries the FULL cotangent of a replicated value: the row-parallel
# sum differentiates as the identity, the input of a column-parallel region
# sums its ranks' cotangents, and a replicated leaf's grad is any one
# rank's (they are equal). ----

def _sum_ranks(ts: list[torch.Tensor], dtype) -> list[torch.Tensor]:
    """The rank-ordered float32 sum of ``ts``, rounded to ``dtype`` once,
    on every rank's device."""
    dev = ts[0].device
    acc = ts[0].float()
    for t in ts[1:]:
        acc = acc + t.to(dev, torch.float32)
    acc = acc.to(dtype)
    return [acc.to(t.device) for t in ts]


class _RowReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mp: int, nb: int, dtype, *args):
        from ..kernels.tp_allreduce import tp_row_reduce
        parts, biases, residuals = args[:mp], args[mp:mp + nb], args[mp + nb:]
        ctx.mp, ctx.nb, ctx.nr = mp, nb, len(residuals)
        ctx.bias_dtypes = [b.dtype for b in biases]
        return tuple(tp_row_reduce(list(parts), list(biases) if nb else None,
                                   list(residuals) if residuals else None, dtype))

    @staticmethod
    def backward(ctx, *cts):
        gb = [ct.float().sum(dim=tuple(range(ct.dim() - 1))).to(dt)
              for ct, dt in zip(cts, ctx.bias_dtypes)]
        return (None, None, None, *[ct.float() for ct in cts], *gb,
                *(cts if ctx.nr else ()))


def psum_replicated_grad(partials: list[torch.Tensor], biases=None, residual=None,
                         dtype=torch.float32) -> list[torch.Tensor]:
    """The row-parallel sum (5c with its epilogue, ``tp_row_reduce``:
    round(x_r + round(s + b_r)) on rank r) whose backward is the identity:
    rank r's partial takes rank r's cotangent of the sum, a bias its row
    sum, a residual the cotangent itself."""
    biases = [] if biases is None or any(b is None for b in biases) else list(biases)
    residual = [] if residual is None else list(residual)
    return list(_RowReduce.apply(len(partials), len(biases), dtype, *partials, *biases,
                                 *residual))


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *xs):
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *cts):
        return tuple(_sum_ranks(list(cts), cts[0].dtype))


def identity_psum_grad(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """Megatron's *g*: identity forward; backward, every rank's input takes
    the rank-ordered sum of the ranks' cotangents (each carries only its
    local columns' share).  The input of a column-parallel region."""
    return list(_SumGrad.apply(*xs))


def seq_bounds(s: int, mp: int) -> list[tuple[int, int]]:
    """Rank r's [lo, hi) of a length-``s`` sequence over ``mp`` ranks
    (``torch.tensor_split``'s split: the first ``s % mp`` one longer)."""
    sizes = [len(c) for c in torch.arange(s).tensor_split(mp)]
    lo = [sum(sizes[:r]) for r in range(mp)]
    return [(a, a + n) for a, n in zip(lo, sizes)]


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, seq, *xs):
        ctx.seq = seq
        return tuple(torch.cat([x.to(dev) for x in xs], dim=1)
                     for dev in [x.device for x in xs])

    @staticmethod
    def backward(ctx, *cts):
        full = _sum_ranks(list(cts), cts[0].dtype)
        return (None, *[f[:, lo:hi] for f, (lo, hi) in zip(full, ctx.seq)])


class _SeqReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, seq, nb: int, dtype, *args):
        from ..kernels.tp_allreduce import tp_row_reduce
        mp = len(seq)
        parts, biases = args[:mp], args[mp:]
        ctx.seq, ctx.bias_dtypes = seq, [b.dtype for b in biases]
        full = tp_row_reduce(list(parts), list(biases) if nb else None, None, dtype)
        return tuple(f[:, lo:hi].contiguous() for f, (lo, hi) in zip(full, seq))

    @staticmethod
    def backward(ctx, *cts):
        full = [torch.cat([c.to(ct.device) for c in cts], dim=1) for ct in cts]
        gb = [f.float().sum(dim=tuple(range(f.dim() - 1))).to(dt)
              for f, dt in zip(full, ctx.bias_dtypes)]
        return (None, None, None, *[f.float() for f in full], *gb)


def all_gather_seq(xs: list[torch.Tensor], seq) -> list[torch.Tensor]:
    """Sequence parallelism's gather before a column-parallel region: rank
    r's slice ``seq[r]`` of each rank -> the whole sequence on every rank;
    the backward reduce-scatters (each slice takes the rank-ordered sum of
    the ranks' cotangents over its positions)."""
    return list(_SeqGather.apply(seq, *xs))


def reduce_scatter_seq(partials: list[torch.Tensor], biases, dtype, seq) -> list[torch.Tensor]:
    """Sequence parallelism's row-parallel sum: 5c's sum with the bias
    (``tp_row_reduce``), rank r keeping positions ``seq[r]``; the backward
    all-gathers the ranks' slices of the cotangent."""
    biases = [] if biases is None or any(b is None for b in biases) else list(biases)
    return list(_SeqReduceScatter.apply(seq, len(biases), dtype, *partials, *biases))


def column_input(xs: list[torch.Tensor], seq=None) -> list[torch.Tensor]:
    """How a column-parallel region's input enters it: the sequence
    all-gathered under ``seq``, else ``identity_psum_grad`` while autograd
    records (nothing to do in inference)."""
    if seq is not None:
        return all_gather_seq(xs, seq)
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return identity_psum_grad(xs)
    return xs


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, partial, x):
        ctx.partial = partial
        return tuple(x.to(d) if torch.device(d) != x.device else x.view_as(x) for d in devices)

    @staticmethod
    def backward(ctx, *cts):
        return None, None, _sum_ranks(list(cts), cts[0].dtype)[0] if ctx.partial else cts[0]


class _TakeFirst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *xs):
        ctx.devices = [x.device for x in xs]
        return xs[0].view_as(xs[0])

    @staticmethod
    def backward(ctx, ct):
        return tuple(ct.to(d) for d in ctx.devices)


def broadcast_replicated(x: torch.Tensor, devices, partial: bool = False) -> list[torch.Tensor]:
    """A replicated value onto every rank (the TP stack's input, the AdaLN
    condition); the backward takes rank 0's cotangent, which every rank
    carries whole, or with ``partial`` (each rank's use covers only its
    positions: sequence parallelism) the rank-ordered sum of the ranks'."""
    return list(_Broadcast.apply(list(devices), partial, x))


def take_replicated(xs: list[torch.Tensor]) -> torch.Tensor:
    """Rank 0's copy of a replicated value (the TP stack's output); the
    backward hands the cotangent to every rank."""
    return _TakeFirst.apply(*xs)


def sinusoidal_table(max_len: int, d_model: int, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """pe[pos, 2i] = sin(pos * exp(-2i ln(1e4)/d)), pe[pos, 2i+1] = cos(...)."""
    position = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                         * (-math.log(10000.0) / d_model))
    angles = position * div_term
    pe = torch.zeros((max_len, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angles)
    pe[:, 1::2] = torch.cos(angles)
    return pe.to(dtype)


def add_positional(pe: torch.Tensor, x: torch.Tensor, offset: int = 0,
                   dropout_rate: float = 0.0,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """x[..., t, :] += pe[offset + t], then dropout."""
    seq_len = x.shape[-2]
    return dropout(x + pe[offset:offset + seq_len].to(x.dtype), dropout_rate, generator)
