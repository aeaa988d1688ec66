"""Tensor-parallel serving in the port on virtual CPU ranks (``valle2_tpu_torch.parallel``,
``kernels.tp_allreduce``, the models' ``mesh``), at d=32-64, 2 layers, 4 heads, mp 2
and 4 over ``['cpu'] * mp``.

The helpers equal the JAX package's (``tp_permute_qkv``, the ``tp_decode_specs``
split, ``tp_divisible``, the ranked int4 packing); the all-reduce's plain version is
the rank-ordered float32 sum bit for bit; the TP ops, fused steps, ``ValleAR`` and
``ValleTTS`` on a mesh equal the port's solo paths (greedy ids and codes exactly;
hidden states within 1e-5: f32 sums split over the ranks); and three JAX
``shard_map`` programs on ``make_model_mesh(2)``, computed once in a module fixture,
hold the port's TP fused decode and verify steps (the Pallas kernels in interpret
mode, as ``tests/test_tp_decode.py`` runs them) and its TP prefill and decode ops
(the XLA path, int8 W8A8 weights: the global amax and the int32 sums) to JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch_port_helpers import SMALL, to_np, to_torch
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu import parallel as jpar
from valle2_tpu.kernels import fused_decode as jfd
from valle2_tpu.ops.transformer import KVCache as JKVCache
from valle2_tpu.ops.transformer import transformer_decode_step as j_decode_step
from valle2_tpu.ops.transformer import transformer_init as j_transformer_init
from valle2_tpu.ops.transformer import transformer_prefill as j_prefill
from valle2_tpu_torch import quantize as tq
from valle2_tpu_torch.config import ConfigValle
from valle2_tpu_torch.kernels import fused_decode as fd
from valle2_tpu_torch.kernels import tp_allreduce as ta
from valle2_tpu_torch.models import ValleAR
from valle2_tpu_torch.models import ar as tar
from valle2_tpu_torch.ops.nn import linear, linear_row_parallel
from valle2_tpu_torch.ops.transformer import (KVCache, transformer_decode_step,
                                              transformer_decode_step_tp, transformer_init,
                                              transformer_prefill, transformer_prefill_tp)
from valle2_tpu_torch.parallel import (make_mesh, make_model_mesh, shard_decode_params,
                                       shard_stack, tp_divisible, tp_permute_qkv,
                                       training_mesh)
from valle2_tpu_torch.tts import ValleTTS

L, D, H, DFF = 2, 32, 4, 64
# TP against solo in float32: the row-parallel products sum over the ranks'
# slices, another order than the solo dot.
TOL_SOLO = dict(atol=1e-5, rtol=1e-5)
# The port against JAX's TP kernels: f32 sums in other orders (the Pallas
# kernel's one-dot projections and online softmax against per-head sdpa).
TOL_JAX = dict(atol=2e-5, rtol=2e-5)
MESH = {mp: make_model_mesh(mp, ['cpu'] * mp) for mp in (2, 4)}


def stack(seed=0, d=D, dff=DFF):
    return transformer_init(torch.Generator().manual_seed(seed), L, d, H, dff,
                            adaptive_norm=False)


def rank_caches(cache: KVCache, mp: int) -> list[KVCache]:
    """Rank r's slice (its local heads) of a standard (L, b, h, S, hd) cache,
    in the fused layout."""
    n = cache.k.shape[2] // mp
    return [fd.fused_cache_layout(KVCache(*(None if t is None else
                                            t[:, :, r * n:(r + 1) * n].clone()
                                            for t in cache))) for r in range(mp)]


def joined(caches: list[KVCache]) -> torch.Tensor:
    """The ranks' fused k caches side by side: the solo fused layout."""
    return torch.cat([c.k.float() for c in caches], dim=-1)


# --- helpers ---

@pytest.mark.parametrize('args', [(16, 4096, 4), (16, 4094, 4), (6, 4096, 4), (16, 4096, 0)])
def test_tp_divisible_equals_jax(args):
    assert tp_divisible(*args) == jpar.tp_divisible(*args)


def formats(p, fmt, mp):
    """The stack in a weight layout, dense 'w', int8 'q' or int4 'q4' (the
    ranked packing), for the port and as JAX arrays (the port's quantizers
    equal JAX's: test_torch_quantize.py and the ranked test below)."""
    if fmt != 'w':
        p = tq.quantize_transformer(p, bits=8 if fmt == 'q' else 4,
                                    tp_mp=mp if fmt == 'q4' else 1)
    return p, jax.tree.map(jnp.asarray, to_np(p))


@pytest.mark.parametrize('mp', [2, 4])
@pytest.mark.parametrize('fmt', ['w', 'q', 'q4'])
def test_permute_qkv_equals_jax(fmt, mp):
    tp, jp = formats(stack(1), fmt, mp)
    got, want = tp_permute_qkv(tp, mp), jpar.tp_permute_qkv(jp, mp)
    for key in want['attn']['qkv']:
        np.testing.assert_array_equal(got['attn']['qkv'][key].numpy(),
                                      np.asarray(want['attn']['qkv'][key]), err_msg=key)
    assert got['ffn'] is tp['ffn'] or got['ffn']['lin1'] is tp['ffn']['lin1']


@pytest.mark.parametrize('mp', [2, 4])
def test_shard_follows_the_jax_specs(mp):
    """Rank r's leaf is the r-th block of the JAX leaf along the axis its
    ``tp_decode_specs`` entry names 'model' (the whole leaf where none)."""
    for fmt in ('w', 'q', 'q4'):
        tp, jp = formats(stack(2), fmt, mp)
        jp = jpar.tp_permute_qkv(jp, mp)
        ranks = shard_decode_params(tp_permute_qkv(tp, mp), mp)
        specs = jpar.tp_decode_specs(jp)
        flat, _ = jax.tree_util.tree_flatten_with_path(jp)
        spec_of = dict(jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda s: isinstance(s, P))[0])
        for path, leaf in flat:
            keys = [k.key for k in path]
            spec, arr = spec_of[path], np.asarray(leaf)
            for r, tree in enumerate(ranks):
                got = tree
                for k in keys:
                    got = got[k]
                want = arr
                if 'model' in tuple(spec):
                    ax = tuple(spec).index('model') - len(spec)
                    n = arr.shape[ax] // mp
                    want = np.take(arr, np.arange(r * n, (r + 1) * n), axis=ax)
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f'{fmt} {keys}')


@pytest.mark.parametrize('mp', [2, 4])
def test_ranked_int4_packs_each_rank_and_round_trips(mp):
    """The ranked packing is each rank's input rows packed on their own
    (``quantize_linear_int4``, equal to JAX's in test_torch_quantize.py, as
    is the ranked packing itself); where in/mp is a multiple of the group
    (here 512/mp of 128 / mp) its dequantized weights equal the global
    quantization's."""
    w = torch.from_numpy(np.random.RandomState(mp).standard_normal((2, 512, 48))
                         .astype(np.float32))
    got = tq.quantize_linear_int4_ranked({'w': w}, mp, group=128 // mp)
    parts = [tq.quantize_linear_int4({'w': c}, group=128 // mp) for c in w.chunk(mp, dim=-2)]
    for k in ('q4', 'scale4'):
        assert torch.equal(got[k], torch.cat([pt[k] for pt in parts], dim=-2)), k
    glob = tq.quantize_linear_int4({'w': w}, group=128 // mp)
    assert torch.equal(tq.dequantize_linear_int4_ranked(got, mp)['w'],
                       tq.dequantize_linear_int4(glob)['w'])
    with pytest.raises(ValueError, match='even in/mp'):
        tq.quantize_linear_int4_ranked({'w': w[:, :6]}, 4)


@pytest.mark.parametrize('mp', [1, 2, 3, 4])
def test_tp_allreduce_plain_is_the_rank_ordered_sum(mp):
    rs = np.random.RandomState(mp)
    parts = [rs.standard_normal((3, 40)).astype(np.float32) * 10 ** rs.randint(-3, 4)
             for _ in range(mp)]
    want = np.zeros((3, 40), np.float32)
    for p in parts:
        want = (want + p).astype(np.float32)
    got = ta.tp_allreduce_plain([torch.from_numpy(p) for p in parts])
    assert len(got) == mp
    for g in got:
        assert g.dtype == torch.float32 and g.device.type == 'cpu'
        np.testing.assert_array_equal(g.numpy(), want)
    bf = ta.tp_allreduce_plain([torch.from_numpy(p).bfloat16() for p in parts])
    assert bf[0].dtype == torch.float32


def test_mesh_helpers():
    mesh = make_model_mesh(2, ['cpu'] * 3)
    assert mesh.size == 2 and mesh.shape == {'model': 2} and mesh.axis_names == ('model',)
    with pytest.raises(ValueError, match='needs 4 devices, have 3'):
        make_model_mesh(4, ['cpu'] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match='have 0'):
            make_model_mesh(1)           # the cards only: no virtual ranks by default
    grid = make_mesh(data=2, model=2, devices=['cpu'] * 4)     # the data axis is ported
    assert grid.shape == {'data': 2, 'model': 2} and grid.axis_names == ('data', 'model')
    assert training_mesh(ConfigValle(**CFG)) is None
    with pytest.raises(ValueError, match='needs 4 devices'):
        make_mesh(data=2, model=2, devices=['cpu'] * 3)
    assert make_mesh(model=2, devices=['cpu'] * 2).size == 2


def test_fit_error_reads_the_ranks_widths():
    assert fd.fit_error(256, 4, 1024, 'w', 2) is None
    assert 'split over 3' in fd.fit_error(256, 4, 1024, 'w', 3)
    assert 'split over 2' in fd.fit_error(256, 4, 1024, 'q', 2)
    assert fd.fit_error(256, 4, 8192, 'w', 1) is not None       # FFN2 input 8192 wide
    assert fd.fit_error(256, 4, 8192, 'w', 2) is None           # 4096 per rank
    cfg = ConfigValle(**SMALL, weight_dtype='int8', use_fused_decode=True)
    assert cfg.fused_decode_enabled('cpu') and not cfg.fused_decode_enabled('cpu', 2)


# --- ops ---

@pytest.mark.parametrize('fmt', ['w', 'q', 'q4'])
def test_linear_row_parallel_equals_solo(fmt):
    """Row-split out-projection over 2 ranks: int8 exactly the solo product
    (the global amax, int32 sums); dense and int4 (ranked, against the
    dequantized ranked weights) within TOL_SOLO; equal on both ranks."""
    p = stack(3)
    tp = {'w': p, 'q': tq.quantize_transformer(p, bits=8),
          'q4': tq.quantize_transformer(p, bits=4, tp_mp=2)}[fmt]
    solo = {k: v[0] for k, v in tp['attn']['out'].items()}
    if fmt == 'q4':
        solo = tq.dequantize_linear_int4_ranked(solo, 2)
    layer = [{k: v[0] for k, v in r['attn']['out'].items()} for r in shard_decode_params(tp, 2)]
    x = torch.randn(3, 5, D, generator=torch.Generator().manual_seed(4))
    got = linear_row_parallel(layer, list(x.chunk(2, dim=-1)))
    want = linear(solo, x)
    assert torch.equal(got[0], got[1])
    if fmt == 'q':
        assert torch.equal(got[0], want)
    else:
        torch.testing.assert_close(got[0], want, **TOL_SOLO)


@pytest.mark.parametrize('cache_dtype', [None, torch.int8], ids=['f32', 'int8'])
@pytest.mark.parametrize('mp', [2, 4])
def test_tp_prefill_and_decode_ops_equal_solo(mp, cache_dtype):
    p = stack(5)
    trees = shard_decode_params(tp_permute_qkv(p, mp), mp)
    gen = torch.Generator().manual_seed(6)
    x, steps = torch.randn(3, 6, D, generator=gen), torch.randn(3, 3, D, generator=gen)
    y0, cache = transformer_prefill(p, x, H, 12, cache_dtype=cache_dtype)
    ys0, caches = transformer_prefill_tp(trees, [x] * mp, H // mp, 12, cache_dtype=cache_dtype)
    torch.testing.assert_close(ys0[0], y0, **TOL_SOLO)
    for t in range(3):
        y, cache = transformer_decode_step(p, steps[:, t:t + 1], H, cache, 6 + t)
        ys, caches = transformer_decode_step_tp(trees, [steps[:, t:t + 1]] * mp, H // mp,
                                                caches, 6 + t)
        assert all(torch.equal(ys[0], yr) for yr in ys[1:])
        torch.testing.assert_close(ys[0], y, **TOL_SOLO)
    full = torch.cat([c.k for c in caches], dim=2)          # heads side by side
    if cache_dtype is None:
        torch.testing.assert_close(full, cache.k, **TOL_SOLO)
    else:
        assert int((full.int() - cache.k.int()).abs().max()) <= 1


# --- the fused steps' plain TP versions ---

def step_inputs(seed, rows, K=1, S=40, int8=False):
    gen = torch.Generator().manual_seed(seed)
    p = stack(seed)
    ck, cv = (torch.randn(L, rows, H, S, D // H, generator=gen) for _ in range(2))
    cache = KVCache(ck, cv)
    if int8:
        (kq, ks), (vq, vs) = (tq_kv(c) for c in (ck, cv))
        cache = KVCache(kq, vq, ks, vs)
    x = torch.randn(rows, K, D, generator=gen)
    tl = torch.tensor([6, 4, 5, 6][:rows], dtype=torch.int32)
    plen = torch.tensor([8, 6, 3, 7][:rows], dtype=torch.int32)
    return p, cache, x, tl, plen


def tq_kv(c):
    from valle2_tpu_torch.ops.transformer import quantize_kv
    return quantize_kv(c)


@pytest.mark.parametrize('case', ['decode', 'per_row_int8', 'chunked', 'verify'])
@pytest.mark.parametrize('mp', [2, 4])
def test_tp_fused_steps_equal_solo(mp, case):
    """``fused_decode_step`` / ``fused_verify_step`` with ``tp`` (their plain
    TP versions on the CPU) against the solo plain steps on the whole cache:
    y within TOL_SOLO and bit-equal on every rank, the ranks' caches the
    solo cache's heads."""
    verify = case == 'verify'
    rows = 3 if verify else 4
    p, cache, x, tl, plen = step_inputs(7, rows, 3 if verify else 1, int8=case == 'per_row_int8')
    ttm, pm = 6, 8
    index = ttm + pm + 5
    if case in ('per_row_int8', 'verify'):
        index = torch.tensor([ttm + pm + 5, ttm + pm + 2, ttm + pm + 9, ttm + pm + 1][:rows],
                             dtype=torch.int32)
    chunk = 8 if case == 'chunked' else None
    step = fd.fused_verify_step if verify else fd.fused_decode_step
    solo = fd.fused_cache_layout(KVCache(*(None if t is None else t.clone() for t in cache)))
    y, solo = step(p, x, H, solo, index, tl, plen, ttm, pm, chunk_override=chunk)
    trees = shard_decode_params(tp_permute_qkv(p, mp), mp)
    caches = rank_caches(cache, mp)
    ys, out = step(None, x, H // mp, None, index, tl, plen, ttm, pm, chunk_override=chunk,
                   tp=(MESH[mp], trees, caches))
    assert out is caches and all(torch.equal(ys[0], yr) for yr in ys[1:])
    torch.testing.assert_close(ys[0], y, **TOL_SOLO)
    if cache.k_scale is None:
        torch.testing.assert_close(joined(caches), solo.k, **TOL_SOLO)
    else:
        assert int((joined(caches) - solo.k.float()).abs().max()) <= 1


def test_tp_fused_step_checks_the_ranks():
    p, cache, x, tl, plen = step_inputs(8, 4)
    trees = shard_decode_params(tp_permute_qkv(p, 2), 2)
    with pytest.raises(ValueError, match='mesh has 2 ranks'):
        fd.fused_decode_step(None, x, 2, None, 19, tl, plen, 6, 8,
                             tp=(MESH[2], trees[:1], rank_caches(cache, 2)))


# --- the models ---

CFG = dict(SMALL, n_heads=H, d_model=D, dim_feedforward=DFF, num_audio_tokens=40,
           vocab_size=24, temperature=0.0, num_beams=2, max_audio_len=10,
           bucket_sizes=(16, 32))
MODES = {
    'plain': {}, 'fused': dict(use_fused_decode=True),
    'spec': dict(use_fused_decode=True, num_beams=1, speculative_k=3, speculative_ngram=2),
    'kv8': dict(use_fused_decode=True, kv_cache_dtype='int8'),
    'w8a8': dict(weight_dtype='int8', use_fused_decode=True), 'w4a16': dict(weight_dtype='int4'),
}


def requests(seed=1):
    rs = np.random.RandomState(seed)
    return ([rs.randint(0, 24, n) for n in (7, 5)],
            [rs.randint(0, 40, (n, 8)) for n in (6, 4)])


def ranked_dequant(params, mp):
    """The float params whose products a TP int4 decode computes: the
    row-parallel linears through the ranked packing, qkv and lin1 through
    the global one (JAX ``dequantize_linear_int4_ranked``)."""
    t = tq.quantize_transformer(params['transformer'], bits=4, tp_mp=mp)
    deq = {'qkv': tq.dequantize_linear_int4(t['attn']['qkv']),
           'out': tq.dequantize_linear_int4_ranked(t['attn']['out'], mp),
           'lin1': tq.dequantize_linear_int4(t['ffn']['lin1']),
           'lin2': tq.dequantize_linear_int4_ranked(t['ffn']['lin2'], mp)}
    tr = dict(params['transformer'], attn={'qkv': deq['qkv'], 'out': deq['out']},
              ffn={'lin1': deq['lin1'], 'lin2': deq['lin2']})
    return dict(params, transformer=tr)


@pytest.mark.parametrize('mode', sorted(MODES))
@pytest.mark.parametrize('mp', [2, 4])
def test_valle_ar_mesh_greedy_equals_solo(mp, mode):
    """``ValleAR(mesh=)`` (``generate_batch``, beams or speculative) gives the
    solo port's greedy ids: W8A8 through the plain TP path, W4A16 against a
    solo model on the weights the ranked packing dequantizes to."""
    cfg = ConfigValle(**dict(CFG, **MODES[mode]))
    base = ValleAR(cfg, device='cpu', seed=3)
    solo = base
    if mode == 'w4a16':
        solo = ValleAR(dataclasses.replace(cfg, weight_dtype='compute'),
                       params=ranked_dequant(base.params, mp), device='cpu')
    tp = ValleAR(cfg, params=base.params, device='cpu', mesh=MESH[mp])
    before = ta.COUNTER.count
    toks, pcs = requests()
    want, got = solo.generate_batch(toks, pcs), tp.generate_batch(toks, pcs)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    trees = tp._decode_tparams()[1]
    assert len(trees) == mp and trees[0]['attn']['qkv'][
        {'w8a8': 'q', 'w4a16': 'q4'}.get(mode, 'w')].shape[-1] == 3 * D // mp
    assert ta.COUNTER.count == before          # on the CPU: the plain sums only
    if mode == 'w8a8':
        assert not cfg.fused_decode_enabled('cpu', mp)


@pytest.fixture(scope='module')
def tts_parts():
    cfg = dataclasses.replace(ConfigValle(**SMALL), n_heads=H, temperature=0.0, num_beams=2,
                              max_audio_len=6, bucket_sizes=(16, 32), use_fused_decode=True)
    solo = ValleTTS(cfg, device='cpu')
    rs = np.random.RandomState(0)
    prompts = ([rs.randint(0, 24, 5), rs.randint(0, 24, 3)],
               [rs.randint(0, 40, (4, 8)), rs.randint(0, 40, (6, 8))])
    return cfg, solo, prompts


@pytest.mark.parametrize('mp', [2, 4])
def test_tts_mesh_equals_solo(tts_parts, mp):
    """``ValleTTS(mesh=)``: ``batch_synthesize`` (the AR and the NAR over the
    ranks, the codec on the first device), ``synthesize_fused`` and the
    staged ``synthesize`` give the solo pipeline's codes and waveforms."""
    cfg, solo, (pts, pcs) = tts_parts
    mesh = MESH[mp]
    tp = ValleTTS(cfg, ar=ValleAR(cfg, params=solo.ar.params, device='cpu', mesh=mesh),
                  nar=solo.nar, codec=solo.codec, mesh=mesh)
    texts = ['hello there', 'a b']
    for got, want in zip(tp.batch_synthesize(texts, pts, pcs),
                         solo.batch_synthesize(texts, pts, pcs)):
        np.testing.assert_array_equal(got.codes, want.codes)
        np.testing.assert_array_equal(got.waveform, want.waveform)
    got = tp.synthesize_fused(texts[0], pts[0], pcs[0])
    np.testing.assert_array_equal(got.codes, solo.synthesize_fused(texts[0], pts[0],
                                                                   pcs[0]).codes)
    np.testing.assert_array_equal(tp.synthesize(texts[1], pts[1], pcs[1]).codes,
                                  solo.synthesize(texts[1], pts[1], pcs[1]).codes)
    nar_trees = tp._mesh_trees()[2]
    assert tp._mesh_trees()[2] is nar_trees and len(nar_trees) == mp


def test_tts_mesh_int4_equals_dequantized_solo(tts_parts):
    cfg, solo, (pts, pcs) = tts_parts
    cfg4 = dataclasses.replace(cfg, weight_dtype='int4')
    tp = ValleTTS(cfg4, ar=ValleAR(cfg4, params=solo.ar.params, device='cpu', mesh=MESH[2]),
                  nar=solo.nar, codec=solo.codec, mesh=MESH[2])
    ref = ValleTTS(cfg, ar=ValleAR(cfg, params=ranked_dequant(solo.ar.params, 2),
                                   device='cpu'), nar=solo.nar, codec=solo.codec,
                   device='cpu')
    for got, want in zip(tp.batch_synthesize(['go'], pts[:1], pcs[:1]),
                         ref.batch_synthesize(['go'], pts[:1], pcs[:1])):
        np.testing.assert_array_equal(got.codes, want.codes)


def test_mesh_refusals():
    odd = ConfigValle(**dict(CFG, n_heads=2))
    with pytest.raises(NotImplementedError, match='queue 1 item 14'):
        ValleAR(odd, device='cpu', mesh=MESH[4])
    q8 = ConfigValle(**dict(CFG, weight_dtype='int8'))
    with pytest.raises(NotImplementedError, match='GSPMD'):
        ValleTTS(q8, mesh=MESH[2])
    model = ValleAR(ConfigValle(**dict(CFG, num_beams=1)), device='cpu', mesh=MESH[2])
    toks, pcs = requests()
    with pytest.raises(NotImplementedError, match='mesh'):
        tar.DecodeStream(model, toks[0], pcs[0])
    with pytest.raises(ValueError, match='first device'):
        ValleAR(ConfigValle(**CFG), device='meta', mesh=MESH[2])


# --- JAX shard_map references on make_model_mesh(2) (three programs) ---

TTM, PM = 6, 8


@pytest.fixture(scope='module')
def jax_refs():
    """The JAX TP fused decode step (per-row index) and verify step (Pallas
    in interpret mode) and the XLA TP prefill + decode ops (int8 W8A8
    weights) under ``jax.shard_map`` on ``make_model_mesh(2)``, with their
    inputs."""
    mesh = jpar.make_model_mesh(2)
    rs = np.random.RandomState(11)
    out = {}
    p = j_transformer_init(jax.random.key(12), L, D, H, DFF, adaptive_norm=False)
    pperm = jpar.tp_permute_qkv(p, 2)
    kv_in, kv_out = P(None, None, 'model', None, None), P(None, None, None, 'model')
    for name, rows, K in (('decode', 4, 1), ('verify', 3, 3)):
        S = 48
        ck, cv = (rs.standard_normal((L, rows, H, S, D // H)).astype(np.float32)
                  for _ in range(2))
        x = rs.standard_normal((rows, K, D)).astype(np.float32)
        tl = np.asarray([6, 4, 5, 6][:rows], np.int32)
        plen = np.asarray([8, 6, 3, 7][:rows], np.int32)
        index = np.asarray([TTM + PM + 5, TTM + PM + 2, TTM + PM + 9, TTM + PM + 1][:rows],
                           np.int32)
        kernel = jfd.fused_verify_step if K > 1 else jfd.fused_decode_step

        def body(p_sh, ck_, cv_, x_sh, tl_sh, pl_sh, idx_sh, kernel=kernel):
            fc = jfd.fused_cache_layout(JKVCache(ck_, cv_))
            my = jax.lax.axis_index('model')
            y, nc = kernel(p_sh, x_sh, H // 2, fc, idx_sh, tl_sh, pl_sh, TTM, PM,
                           tp=(my, jnp.int32(0), 2))
            return y, nc.k, nc.v

        fn = jax.shard_map(body, mesh=mesh,
                           in_specs=(jpar.tp_decode_specs(pperm), kv_in, kv_in,
                                     P(), P(), P(), P()),
                           out_specs=(P(), kv_out, kv_out), check_vma=False)
        y, k, v = jax.jit(fn)(pperm, ck, cv, x, tl, plen, index)
        out[name] = dict(inputs=(ck, cv, x, tl, plen, index), y=np.asarray(y),
                         k=np.asarray(k), v=np.asarray(v))

    q8 = jax.tree.map(jnp.asarray, to_np(tq.quantize_transformer(to_torch(to_np(p)), bits=8)))
    q8perm = jpar.tp_permute_qkv(q8, 2)
    x = rs.standard_normal((3, 6, D)).astype(np.float32)
    steps = rs.standard_normal((3, 3, D)).astype(np.float32)

    def run(p_sh, x_, steps_):
        y0, cache = j_prefill(p_sh, x_, H // 2, 12, tp_axis='model')
        ys = []
        for t in range(3):
            y, cache = j_decode_step(p_sh, steps_[:, t:t + 1], H // 2, cache,
                                                   jnp.int32(6 + t), tp_axis='model')
            ys.append(y[:, 0])
        return y0, jnp.stack(ys, axis=1)

    fn = jpar.tp_shard_map(mesh, run, n_args=3, sharded=(), n_out=2,
                           param_specs=jpar.tp_decode_specs(q8perm))
    y0, ys = jax.jit(fn)(q8perm, x, steps)
    out['ops'] = dict(inputs=(x, steps), y0=np.asarray(y0), ys=np.asarray(ys))
    out['params'] = to_torch(to_np(p))
    return out


@pytest.mark.parametrize('name', ['decode', 'verify'])
def test_tp_fused_steps_equal_jax_shard_map(jax_refs, name):
    """The port's TP fused step with a per-row index / verify block (plain
    TP versions on the CPU) against JAX's TP kernels under shard_map."""
    ref = jax_refs[name]
    ck, cv, x, tl, plen, index = (torch.from_numpy(a) for a in ref['inputs'])
    trees = shard_decode_params(tp_permute_qkv(jax_refs['params'], 2), 2)
    caches = rank_caches(KVCache(ck, cv), 2)
    step = fd.fused_verify_step if name == 'verify' else fd.fused_decode_step
    ys, caches = step(None, x, H // 2, None, index, tl, plen, TTM, PM,
                      tp=(MESH[2], trees, caches))
    np.testing.assert_allclose(ys[0].numpy(), ref['y'], **TOL_JAX)
    np.testing.assert_allclose(joined(caches).numpy(), ref['k'], **TOL_JAX)
    np.testing.assert_allclose(torch.cat([c.v for c in caches], dim=-1).numpy(), ref['v'],
                               **TOL_JAX)


def test_tp_ops_equal_jax_shard_map(jax_refs):
    """The port's TP prefill and decode ops with int8 W8A8 weights (the
    global amax over the ranks, the int32 sums) against JAX's XLA TP path."""
    x, steps = (torch.from_numpy(a) for a in jax_refs['ops']['inputs'])
    q8 = tq.quantize_transformer(jax_refs['params'], bits=8)
    trees = shard_stack(q8, MESH[2], torch.float32)
    ys0, caches = transformer_prefill_tp(trees, [x] * 2, H // 2, 12)
    np.testing.assert_allclose(ys0[0].numpy(), jax_refs['ops']['y0'], **TOL_JAX)
    got = []
    for t in range(3):
        ys, caches = transformer_decode_step_tp(trees, [steps[:, t:t + 1]] * 2, H // 2,
                                                caches, 6 + t)
        got.append(ys[0][:, 0])
    np.testing.assert_allclose(torch.stack(got, dim=1).numpy(), jax_refs['ops']['ys'],
                               **TOL_JAX)
