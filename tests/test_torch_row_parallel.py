"""5c's row-parallel epilogue (``kernels.tp_allreduce.tp_row_reduce``) on
virtual CPU ranks, at d=32, 2 layers, 4 heads.

The epilogue's plain version -- the rank-ordered float32 sum, the bias
added once, the cast to the compute dtype, then the caller's residual add --
is bit-equal to the composition it replaces (``linear_row_parallel`` with
the plain sum, then ``x + o``) in float32 and bfloat16, mp 1-4, with and
without a bias, dense and int4 W4A16 weights; and the TP prefill and the
NAR's stack (adaptive norm, a padding bias), which now carry both residual
adds inside the row-parallel sums, equal JAX's TP under ``jax.shard_map``
on ``make_model_mesh(2)`` (two programs in a module fixture) and the
port's solo stack.  The kernel itself is held bit for bit against this
plain version on the card (``tests/test_torch_cuda.py``).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch_port_helpers import to_np, to_torch
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu import parallel as jpar
from valle2_tpu.ops.transformer import transformer as j_transformer
from valle2_tpu.ops.transformer import transformer_init as j_transformer_init
from valle2_tpu.ops.transformer import transformer_prefill as j_prefill
from valle2_tpu_torch import quantize as tq
from valle2_tpu_torch.kernels import tp_allreduce as ta
from valle2_tpu_torch.ops.nn import ffn_tp, linear_row_parallel
from valle2_tpu_torch.ops.transformer import (transformer, transformer_prefill,
                                              transformer_prefill_tp, transformer_tp)
from valle2_tpu_torch.parallel import make_model_mesh, shard_stack

L, D, H, DFF = 2, 32, 4, 64
# The port against JAX's TP and its own solo stack: f32 sums over the
# ranks' slices, in other orders than one dot.
TOL_JAX = dict(atol=2e-5, rtol=2e-5)
TOL_SOLO = dict(atol=1e-5, rtol=1e-5)
DTYPES = {'f32': torch.float32, 'bf16': torch.bfloat16}


def rank_linears(mp: int, dtype, bias: bool, int4: bool, seed: int):
    """One (mp * 16, D) row-parallel linear cut over mp ranks (int4: the
    ranked packing), its input slices and a residual per rank."""
    gen = torch.Generator().manual_seed(seed)
    k = 16 * mp
    w = torch.randn(k, D, generator=gen) / k ** 0.5
    b = torch.randn(D, generator=gen).to(dtype) if bias else None
    if int4:
        full = tq.quantize_linear_int4_ranked({'w': w}, mp, group=16)
        ps = [{'q4': q, 'scale4': s}
              for q, s in zip(full['q4'].chunk(mp, dim=-2), full['scale4'].chunk(mp, dim=-2))]
    else:
        ps = [{'w': c.contiguous().to(dtype)} for c in w.chunk(mp, dim=0)]
    if bias:
        for p in ps:
            p['b'] = b
    x = torch.randn(3, 5, k, generator=gen).to(dtype)
    xs = [c.contiguous() for c in x.chunk(mp, dim=-1)]
    res = torch.randn(3, 5, D, generator=gen).to(dtype)
    return ps, xs, [res.clone() for _ in range(mp)]


@pytest.mark.parametrize('weights', ['dense', 'int4'])
@pytest.mark.parametrize('bias', [True, False], ids=['bias', 'no_bias'])
@pytest.mark.parametrize('dtype', sorted(DTYPES))
@pytest.mark.parametrize('mp', [1, 2, 3, 4])
def test_row_parallel_epilogue_equals_the_composition(mp, dtype, bias, weights):
    """``linear_row_parallel(..., residual=x)`` (the fused epilogue's plain
    version) == ``x + linear_row_parallel(..., reduce=tp_allreduce_plain)``
    bit for bit on every rank, and ``tp_row_reduce_plain`` is that
    composition on the partials."""
    dt = DTYPES[dtype]
    ps, xs, res = rank_linears(mp, dt, bias, weights == 'int4', seed=mp * 10 + bias)
    got = linear_row_parallel(ps, xs, residual=res)
    want = [x + o for x, o in zip(res, linear_row_parallel(ps, xs,
                                                           reduce=ta.tp_allreduce_plain))]
    assert all(g.dtype == dt for g in got)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert all(torch.equal(got[0], g) for g in got[1:])
    # the epilogue alone, on raw partials, with and without a residual
    gen = torch.Generator().manual_seed(mp)
    parts = [torch.randn(3, 5, D, generator=gen) * 10 ** (r - 1) for r in range(mp)]
    biases = [p.get('b') for p in ps]
    s = ta.tp_allreduce_plain(parts)[0]
    b = biases[0] if bias else None
    o = (s if b is None else s + b).to(dt)
    for got_r, want_r in ((ta.tp_row_reduce(parts, biases, res, dt), res[0] + o),
                          (ta.tp_row_reduce(parts, biases, None, dt), o)):
        assert all(torch.equal(g, want_r) for g in got_r)


def test_row_reduce_takes_the_plain_version_on_the_cpu():
    """CPU partials never reach the kernel (no launch counted); the bare
    ``tp_allreduce`` is the epilogue with no bias and no residual."""
    gen = torch.Generator().manual_seed(1)
    parts = [torch.randn(2, 3, D, generator=gen) for _ in range(3)]
    before = ta.COUNTER.count
    got = ta.tp_allreduce(parts)
    assert ta.COUNTER.count == before
    assert all(torch.equal(g, w) for g, w in zip(got, ta.tp_allreduce_plain(parts)))
    assert all(torch.equal(g, w) for g, w in zip(got, ta.tp_row_reduce(parts)))


def test_ffn_tp_residual_equals_the_add_after():
    ps, _, res = rank_linears(2, torch.float32, True, False, seed=3)
    gen = torch.Generator().manual_seed(4)
    layer = [{'lin1': {'w': torch.randn(D, 8, generator=gen), 'b': torch.randn(8, generator=gen)},
              'lin2': {'w': torch.randn(8, D, generator=gen), 'b': ps[0]['b']}} for _ in range(2)]
    xs = [torch.randn(3, 5, D, generator=gen)] * 2
    got = ffn_tp(layer, xs, residual=res)
    want = [x + f for x, f in zip(res, ffn_tp(layer, xs, reduce=ta.tp_allreduce_plain))]
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# --- the TP prefill and the NAR's stack against JAX's shard_map TP ---

@pytest.fixture(scope='module')
def jax_tp():
    """JAX's TP prefill (dense f32) and the NAR's adaptive-norm stack with a
    padding bias, under ``jax.shard_map`` on ``make_model_mesh(2)``."""
    mesh = jpar.make_model_mesh(2)
    rs = np.random.RandomState(21)
    x = rs.standard_normal((3, 6, D)).astype(np.float32)
    cond = rs.standard_normal((1, D)).astype(np.float32)
    valid = np.arange(6)[None, :] < np.asarray([6, 4, 5])[:, None]
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)[:, None, None, :]
    out = {'x': x, 'cond': cond, 'bias': bias}
    for name, adaptive in (('prefill', False), ('nar', True)):
        p = j_transformer_init(jax.random.key(22 + adaptive), L, D, H, DFF,
                               adaptive_norm=adaptive)
        pperm = jpar.tp_permute_qkv(p, 2)
        if adaptive:
            def run(p_sh, x_, c_, b_):
                return (j_transformer(p_sh, x_, H // 2, b_, c_, unroll=True, tp_axis='model'),)
            args = (pperm, x, cond, bias)
        else:
            def run(p_sh, x_):
                return (j_prefill(p_sh, x_, H // 2, 12, tp_axis='model')[0],)
            args = (pperm, x)
        fn = jax.shard_map(run, mesh=mesh,
                           in_specs=(jpar.tp_decode_specs(pperm),) + (P(),) * (len(args) - 1),
                           out_specs=(P(),), check_vma=False)
        out[name] = (to_torch(to_np(p)), np.asarray(jax.jit(fn)(*args)[0]))
    return out


def test_tp_prefill_equals_jax_and_solo(jax_tp):
    p, want = jax_tp['prefill']
    x = torch.from_numpy(jax_tp['x'])
    trees = shard_stack(p, make_model_mesh(2, ['cpu'] * 2), torch.float32)
    ys, _ = transformer_prefill_tp(trees, [x] * 2, H // 2, 12)
    assert torch.equal(ys[0], ys[1])
    np.testing.assert_allclose(ys[0].numpy(), want, **TOL_JAX)
    torch.testing.assert_close(ys[0], transformer_prefill(p, x, H, 12)[0], **TOL_SOLO)


def test_tp_nar_stack_equals_jax_and_solo(jax_tp):
    p, want = jax_tp['nar']
    x, cond, bias = (torch.from_numpy(jax_tp[k]) for k in ('x', 'cond', 'bias'))
    trees = shard_stack(p, make_model_mesh(2, ['cpu'] * 2), torch.float32)
    ys = transformer_tp(trees, [x] * 2, H // 2, bias, cond)
    assert torch.equal(ys[0], ys[1])
    np.testing.assert_allclose(ys[0].numpy(), want, **TOL_JAX)
    torch.testing.assert_close(ys[0], transformer(p, x, H, bias, cond), **TOL_SOLO)


def test_tp_stack_routes_both_residual_adds_through_the_epilogue(monkeypatch):
    """Every row-parallel sum of the TP stack goes through
    ``tp_row_reduce`` with the layer's residual: two a layer."""
    seen = []
    real = ta.tp_row_reduce

    def spy(parts, biases=None, residuals=None, dtype=torch.float32):
        seen.append(residuals is not None)
        return real(parts, biases, residuals, dtype)
    monkeypatch.setattr(ta, 'tp_row_reduce', spy)
    p = to_torch(to_np(j_transformer_init(jax.random.key(5), L, D, H, DFF,
                                          adaptive_norm=False)))
    trees = shard_stack(p, make_model_mesh(2, ['cpu'] * 2), torch.float32)
    x = torch.randn(2, 4, D, generator=torch.Generator().manual_seed(6))
    transformer_tp(trees, [x] * 2, H // 2)
    assert seen == [True] * (2 * L)
