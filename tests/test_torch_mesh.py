"""The ('data', 'model') mesh of the port (``valle2_tpu_torch.parallel.mesh``), its
placement helpers, the tensor-parallel autograd pair (``ops.nn``), flash under a mesh
(``ops.attention``) and serving on the data axis (``ValleAR`` / ``ValleTTS`` with
``mesh``), on virtual CPU ranks at d=32, 2 layers, held to the JAX package's helpers and
its ``ValleAR`` on ``make_mesh`` over the 8 virtual CPU devices of ``tests/conftest.py``.

Tolerances: the helpers and specs equal JAX's exactly; greedy tokens and codes exactly
(JAX's decode on the same mesh, the port's solo decode); the TP ops' values and grads
within 1e-5 of the solo ops' (float32 sums over the ranks in another order).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import SMALL
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu import parallel as jpar
from valle2_tpu.config import ConfigValle as JConfig
from valle2_tpu.models import ar as jar
from valle2_tpu.models.convert import export_ar_state_dict
from valle2_tpu_torch.config import ConfigValle
from valle2_tpu_torch.kernels import tp_allreduce as ta
from valle2_tpu_torch.models import ValleAR
from valle2_tpu_torch.models import ar as tar
from valle2_tpu_torch.models.convert import load_ar_state_dict
from valle2_tpu_torch.ops import nn as tnn
from valle2_tpu_torch.ops.attention import flash_shard_mesh, mha, mha_init, mha_tp
from valle2_tpu_torch.ops.transformer import map_tree
from valle2_tpu_torch.parallel import (Mesh, PerReplica, data_rows, data_shard_map,
                                       device_put_global, make_mesh, sequence_parallel_spec,
                                       shard_batch, shard_decode_params, tp_decode_specs,
                                       tp_permute_qkv, tp_shard_map)
from valle2_tpu_torch.parallel import mesh as tmesh
from valle2_tpu_torch.tts import ValleTTS

TOL = dict(atol=1e-5, rtol=1e-5)


def mesh(data, model=1):
    return make_mesh(data, model, ['cpu'] * (data * model))


def leaves(tree, prefix=''):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f'{prefix}/{k}')
    else:
        yield prefix, tree


# ---- the mesh and the placement helpers ----

def test_make_mesh_is_row_major_and_checks_the_devices():
    """Rank (i, j) on devices[i * model + j] (JAX reshapes the same way);
    each data rank's model ranks form a ('model',) replica mesh made once."""
    devs = [f'cpu:{k}' for k in range(4)]
    m = make_mesh(2, 2, devs)
    assert m.shape == {'data': 2, 'model': 2} and m.size == 4
    assert [str(d) for d in m.group(1)] == ['cpu:2', 'cpu:3']
    sub = m.replica(1)
    assert sub is m.replica(1) and sub.axis_names == ('model',) and sub.size == 2
    assert list(m.local_data) == [0, 1]
    jm = jpar.make_mesh(data=2, model=2)
    assert jm.devices.shape == (2, 2) and dict(jm.shape) == m.shape
    assert make_mesh(None, 2, ['cpu'] * 6).shape == {'data': 3, 'model': 2}
    with pytest.raises(ValueError, match='needs 8 devices, have 4'):
        make_mesh(4, 2, ['cpu'] * 4)
    with pytest.raises(ValueError, match='whole model groups'):
        Mesh(['cpu'] * 2, data=1, processes=2)


def test_each_process_takes_its_own_cards(monkeypatch):
    """Under several processes of one host, make_mesh's default devices are
    process p's block of the cards (the first the one init_distributed makes
    current); a share past the process's cards raises instead of wrapping
    onto another process's card (NCCL refuses two processes on one card)."""
    from valle2_tpu_torch.parallel import distributed as tdist
    cards = [torch.device('cuda', k) for k in range(4)]
    monkeypatch.setattr(tmesh, '_cards', lambda: cards)
    monkeypatch.setattr(tmesh, 'process_info', lambda: (2, 1))
    m = make_mesh(4, 1)
    assert m.devices == cards[2:] and m.first == 2 and list(m.local_data) == [2, 3]
    assert make_mesh(2, 1).devices == cards[2:3]
    with pytest.raises(ValueError, match='need 8 cards, have 4'):
        make_mesh(4, 2)
    assert tmesh.process_cards(cards[:3], 1, 3, 2) == cards[2:3]
    with pytest.raises(ValueError, match='need 4 cards, have 3'):
        tmesh.process_cards(cards[:3], 2, 2, 1)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(ValueError, match='one process per card'):
        tdist.init_distributed('127.0.0.1:1', 2, 1, backend='nccl')


def test_batch_placement_and_specs_equal_jax():
    """shard_batch gives each data rank the rows JAX's shard_batch puts on
    its devices (data_rows, tensor_split's cut where the rows do not
    divide); device_put_global cuts each rank's block; sequence_parallel_spec
    and tp_decode_specs say what JAX's say."""
    batch = {'x': torch.arange(24.).reshape(8, 3), 'n': torch.arange(8)}
    m, jm = mesh(4, 2), jpar.make_mesh(data=4, model=2)
    parts = shard_batch(m, batch)
    assert len(parts) == 4
    js = jpar.shard_batch(jm, {k: v.numpy() for k, v in batch.items()})
    for k in batch:
        for shard in js[k].addressable_shards:
            i = shard.index[0].start // 2
            np.testing.assert_array_equal(np.asarray(shard.data), parts[i][k].numpy())
    for rows in (5, 7, 8, 3):
        want = [len(c) for c in torch.arange(rows).tensor_split(4)]
        cuts = [data_rows(m, rows, i) for i in range(4)]
        assert [c.stop - c.start for c in cuts] == want and cuts[-1].stop == rows
    blocks = device_put_global(batch['x'], ('data', None), m)
    assert torch.equal(blocks[7], batch['x'][6:8])
    assert blocks[6] is not blocks[7] and blocks[6].data_ptr() != blocks[7].data_ptr()
    for cfg_kw, mesh_args in ((dict(sequence_parallel=True), (2, 2)),
                              (dict(sequence_parallel=True), (4, 1)),
                              (dict(sequence_parallel=True), (1, 2)),
                              (dict(), (2, 2))):
        jspec = jpar.sequence_parallel_spec(JConfig(**cfg_kw),
                                            jpar.make_mesh(*mesh_args))
        spec = sequence_parallel_spec(ConfigValle(**cfg_kw), mesh(*mesh_args))
        assert spec == (None if jspec is None else tuple(jspec.spec))
    jcfg = JConfig(**SMALL)
    jp = jar.init_params(jax.random.key(0), jcfg)
    want = dict(leaves(jpar.tp_decode_specs(jp)))
    got = dict(leaves(tp_decode_specs(load_ar_state_dict(export_ar_state_dict(jp)))))
    for k, w in want.items():
        assert got[k] == tuple(w) + (None,) * (len(got[k]) - len(tuple(w))), k


def test_data_and_tp_shard_maps_run_each_replica_on_its_rows():
    """data_shard_map: each data rank gets its rows (and a PerReplica arg's
    own entry), the outputs come back by rows in rank order; tp_shard_map
    hands each data rank its model group and replica mesh."""
    m = mesh(2, 2)
    x = torch.arange(12.).reshape(6, 2)
    seen = []

    def body(x, scale, tag):
        seen.append(tag)
        return x * scale, x.sum(1, keepdim=True)
    y, s = data_shard_map(m, body, 3, (0,), 2)(x, PerReplica([1.0, 10.0]),
                                              PerReplica(['a', 'b']))
    assert seen == ['a', 'b']
    assert torch.equal(y, torch.cat([x[:3], x[3:] * 10.0]))
    assert torch.equal(s, x.sum(1, keepdim=True))

    def tp_body(sub, trees, x):
        assert sub.axis_names == ('model',) and len(trees) == 2
        return x + trees[0] + trees[1]
    trees = [torch.tensor(float(r)) for r in range(4)]
    got = tp_shard_map(m, tp_body, 2, (1,), 1)(trees, x)[0]
    assert torch.equal(got, torch.cat([x[:3] + 1.0, x[3:] + 5.0]))


# ---- the autograd pair and the TP ops under autograd ----

def test_identity_and_row_sum_transposes():
    """identity_psum_grad: identity forward, the rank-ordered sum of the
    cotangents backward; psum_replicated_grad: 5c's sum with its epilogue
    forward (its plain version here), the identity backward."""
    xs = [torch.randn(2, 3, requires_grad=True) for _ in range(3)]
    ys = tnn.identity_psum_grad(xs)
    assert all(torch.equal(x, y) for x, y in zip(xs, ys))
    cts = [torch.randn(2, 3) for _ in range(3)]
    grads = torch.autograd.grad(ys, xs, cts)
    assert all(torch.equal(g, (cts[0] + cts[1]) + cts[2]) for g in grads)
    parts = [torch.randn(2, 3, requires_grad=True) for _ in range(2)]
    bias = [torch.randn(3, requires_grad=True) for _ in range(2)]
    res = [torch.randn(2, 3, requires_grad=True) for _ in range(2)]
    before = ta.COUNTER.count
    outs = tnn.psum_replicated_grad(parts, bias, res, torch.float32)
    want = ta.tp_row_reduce_plain([p.detach() for p in parts], [b.detach() for b in bias],
                                  [r.detach() for r in res])
    assert all(torch.equal(o, w) for o, w in zip(outs, want))
    assert ta.COUNTER.count == before                  # the plain version on the CPU
    cts = [torch.randn(2, 3) for _ in range(2)]
    g = torch.autograd.grad(outs, parts + bias + res, cts)
    assert torch.equal(g[0], cts[0]) and torch.equal(g[1], cts[1])
    assert torch.allclose(g[2], cts[0].sum(0)) and torch.equal(g[4], cts[0])


@pytest.mark.parametrize('seq', [False, True], ids=['tp', 'sp'])
def test_row_parallel_and_ffn_tp_grads_equal_solo(seq):
    """linear_row_parallel and ffn_tp (dropout on: each rank takes its columns
    of the solo mask) under autograd: values, input and weight grads equal
    the solo ffn's within 1e-5; under sequence parallelism each rank holds
    its positions."""
    gen = torch.Generator().manual_seed(0)
    p = tnn.ffn_init(gen, 8, 16)
    x = torch.randn(2, 6, 8)
    ct = torch.randn(2, 6, 8)
    solo_p = map_tree(lambda a: a.clone().requires_grad_(), p)
    xs_ = x.clone().requires_grad_()
    y = tnn.ffn(solo_p, xs_, 0.3, torch.Generator().manual_seed(4))
    gw, gx = torch.autograd.grad(y, [solo_p['lin1']['w'], xs_], ct)
    mp = 2
    ranks = [{'lin1': {'w': p['lin1']['w'][:, r * 8:(r + 1) * 8].clone().requires_grad_(),
                       'b': p['lin1']['b'][r * 8:(r + 1) * 8].clone()},
              'lin2': {'w': p['lin2']['w'][r * 8:(r + 1) * 8].clone(),
                       'b': p['lin2']['b'].clone()}} for r in range(mp)]
    bounds = tnn.seq_bounds(6, mp) if seq else None
    xt = x.clone().requires_grad_()
    xs = [xt[:, lo:hi] for lo, hi in bounds] if seq else tnn.broadcast_replicated(xt, ['cpu'] * 2)
    ys = tnn.ffn_tp(ranks, xs, dropout_rate=0.3, generator=torch.Generator().manual_seed(4),
                    seq=bounds)
    got = torch.cat(ys, 1) if seq else tnn.take_replicated(ys)
    torch.testing.assert_close(got, y, **TOL)
    g = torch.autograd.grad(got, [ranks[0]['lin1']['w'], ranks[1]['lin1']['w'], xt], ct)
    torch.testing.assert_close(torch.cat(g[:2], -1), gw, **TOL)
    torch.testing.assert_close(g[2], gx, **TOL)


# ---- flash under a mesh ----

def test_flash_shard_mesh_decides_as_jax_does():
    """(batch, heads) against each mesh: flash or the plain route, as JAX
    decides."""
    from valle2_tpu.ops.attention import flash_shard_mesh as j_fsm
    for args in ((4, 1), (2, 2), (2, 4), (8, 1), (1, 1)):
        m, jm = mesh(*args), jpar.make_mesh(*args)
        for batch in (2, 3, 4):
            for heads in (2, 4):
                assert flash_shard_mesh(m, batch, heads) == j_fsm(jm, batch, heads)[1], \
                    (args, batch, heads)
    assert flash_shard_mesh(None, 3, 3)


def test_flash_per_shard_equals_unsharded_with_grads():
    """The path's flash per (data, model) shard on 2 x 2: each data rank's
    rows through mha_tp over its model ranks (each rank FlashAttention on its
    local heads, made contiguous; the output projection's partials summed)
    == mha with FlashAttention on the whole batch, outputs and the input's
    and qkv weight's grads within 1e-5 (the row-parallel sum adds in another
    order)."""
    gen = torch.Generator().manual_seed(0)
    p = mha_init(gen, 16, 4)
    x = torch.randn(4, 10, 16, generator=gen)
    meta = torch.tensor([[4, 10], [3, 8], [4, 9], [2, 10]], dtype=torch.int32)
    ct = torch.randn(4, 10, 16, generator=gen)
    whole_p = map_tree(lambda a: a.clone().requires_grad_(), p)
    xw = x.clone().requires_grad_()
    want = mha(whole_p, xw, 4, flash={'meta': meta, 'tokens_total': 4, 'causal': True})
    wg = torch.autograd.grad(want, [xw, whole_p['qkv']['w']], ct)
    m = mesh(2, 2)
    xs = x.clone().requires_grad_()
    outs, qkv_grads = [], []
    for i in m.local_data:
        cut = data_rows(m, 4, i)
        ranks = [map_tree(lambda a: a.clone().requires_grad_(), t['attn'])
                 for t in shard_decode_params(tp_permute_qkv({'attn': p}, 2), 2)]
        ys = mha_tp(ranks, tnn.broadcast_replicated(xs[cut], m.group(i)), 2,
                    flash={'meta': meta[cut], 'tokens_total': 4, 'causal': True})
        y = tnn.take_replicated(ys)
        outs.append(y)
        g = torch.autograd.grad(y, [r['qkv']['w'] for r in ranks], ct[cut], retain_graph=True)
        qkv_grads.append(torch.cat(g, -1))
    got = torch.cat(outs)
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(torch.autograd.grad(got, xs, ct)[0], wg[0], **TOL)
    perm = tp_permute_qkv({'attn': {'qkv': {'w': wg[1]}}}, 2)['attn']['qkv']['w']
    torch.testing.assert_close(qkv_grads[0] + qkv_grads[1], perm, **TOL)


# ---- serving on the data axis ----

DECODE = dict(SMALL, vocab_size=40, num_audio_tokens=50, max_audio_len=8, num_beams=2,
              temperature=0.0, bucket_sizes=(16,), use_fused_decode=False, norm='LayerNorm')


def prompts(n=5, seed=7):
    rs = np.random.RandomState(seed)
    return ([rs.randint(0, 40, (5 + i % 3,)) for i in range(n)],
            [rs.randint(0, 50, (4 + i % 2, 8)) for i in range(n)])


@pytest.fixture(scope='module')
def jax_decodes():
    """JAX ValleAR.generate_batch on make_mesh(4) and make_mesh(2, 2) for 5
    rows (padded to 8 / 6 by row 0), greedy, from seed-0 params."""
    jcfg = JConfig(**dict(DECODE, decode_attn_buckets=1))
    jp = jar.init_params(jax.random.key(0), jcfg)
    toks, pcs = prompts()
    out = {}
    for args in ((4, 1), (2, 2)):
        model = jar.ValleAR(jcfg, params=jp, mesh=jpar.make_mesh(*args))
        out[args] = [np.asarray(o) for o in model.generate_batch(toks, pcs,
                                                                   rng=jax.random.key(11))]
    return load_ar_state_dict(export_ar_state_dict(jp)), out


@pytest.mark.parametrize('args', [(4, 1), (2, 2)], ids=['data4', '2x2'])
def test_valle_ar_greedy_on_a_data_mesh_equals_jax_and_solo(jax_decodes, args):
    """ValleAR(mesh=) greedy batch decode on 5 rows (padded to a multiple of
    the data size, the pad dropped): each data rank decodes its rows, TP over
    its model ranks at 2 x 2; the ids equal JAX's on the same mesh and the
    solo decode's, row for row."""
    params, jax_out = jax_decodes
    cfg = ConfigValle(**DECODE)
    toks, pcs = prompts()
    got = ValleAR(cfg, params=params, device='cpu', mesh=mesh(*args)).generate_batch(toks,
                                                                                    pcs)
    solo = ValleAR(cfg, params=params, device='cpu').generate_batch(toks, pcs)
    assert len(got) == 5
    for g, s, j in zip(got, solo, jax_out[args]):
        np.testing.assert_array_equal(g.numpy(), s.numpy())
        np.testing.assert_array_equal(g.numpy(), j)


def test_sampled_decode_draws_per_data_rank():
    """A sampled decode at data=2: each data rank draws from its own
    generator (one draw of the caller's and its rank, ``replica_generators``),
    so its rows equal a solo decode of those rows from that generator."""
    cfg = ConfigValle(**dict(DECODE, temperature=1.0, num_beams=1))
    toks, pcs = prompts(4, seed=3)
    m = mesh(2)
    model = ValleAR(cfg, device='cpu', mesh=m)
    got = model.generate_batch(toks, pcs, generator=torch.Generator().manual_seed(5))
    gens = tar.replica_generators(torch.Generator().manual_seed(5), m)
    solo = ValleAR(cfg, params=model.params, device='cpu')
    for i, gen in enumerate(gens):
        want = solo.generate_batch(toks[2 * i:2 * i + 2], pcs[2 * i:2 * i + 2], generator=gen)
        for g, w in zip(got[2 * i:2 * i + 2], want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert not all(torch.equal(a, b) for a, b in zip(got[:2], got[2:]))


@pytest.fixture(scope='module')
def tts_solo():
    cfg = dataclasses.replace(ConfigValle(**SMALL), temperature=0.0, num_beams=2,
                              max_audio_len=6, bucket_sizes=(16, 32))
    solo = ValleTTS(cfg, device='cpu')
    rs = np.random.RandomState(0)
    pts = [rs.randint(0, 24, 3 + i) for i in range(3)]
    pcs = [rs.randint(0, 40, (4 + i, 8)) for i in range(3)]
    return cfg, solo, pts, pcs


@pytest.mark.parametrize('args', [(2, 1), (2, 2)], ids=['data2', '2x2'])
def test_tts_batch_synthesize_on_a_data_mesh_equals_solo(tts_solo, args):
    """ValleTTS(mesh=).batch_synthesize of 3 requests (padded to 4): each data
    rank runs the AR, the NAR and the codec on its rows (TP at 2 x 2); codes
    and waveforms equal the solo pipeline's."""
    cfg, solo, pts, pcs = tts_solo
    m = mesh(*args)
    tts = ValleTTS(cfg, ar=ValleAR(cfg, params=solo.ar.params, device='cpu', mesh=m),
                   nar=solo.nar, codec=solo.codec, mesh=m)
    texts = ['hello there', 'a b', 'so it goes']
    got, want = tts.batch_synthesize(texts, pts, pcs), solo.batch_synthesize(texts, pts, pcs)
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.codes, w.codes)
        np.testing.assert_array_equal(g.waveform, w.waveform)


def test_data_mesh_refusals():
    """int8 weights on a data mesh and the streams keep raising (the GSPMD
    fallback and a mesh-less stream, as in JAX)."""
    cfg = ConfigValle(**DECODE)
    with pytest.raises(NotImplementedError, match='queue 1 item 14'):
        ValleAR(dataclasses.replace(cfg, weight_dtype='int8'), device='cpu', mesh=mesh(2))
    with pytest.raises(NotImplementedError, match='queue 1 item 14'):
        ValleAR(dataclasses.replace(cfg, n_heads=2), device='cpu', mesh=mesh(1, 4))
    model = ValleAR(dataclasses.replace(cfg, num_beams=1), device='cpu', mesh=mesh(2))
    toks, pcs = prompts(1)
    with pytest.raises(NotImplementedError, match='mesh'):
        tar.DecodeStream(model, toks[0], pcs[0])
