"""Continuous batching in the port (``valle2_tpu_torch.models.continuous``)
against the JAX package (float32, 'highest', d=32, 2 layers, one beam): the
plain fused step with a per-row index against the Pallas kernel in interpret
mode (one case per cache format); the per-row step against the scalar step
and one-row steps, and a row frozen at slot S writing nothing; the joint
decoder's greedy IDs against JAX's ``ContinuousDecoder`` (XLA route) under
staggered joins and slot reuse, through the plain step, the fused layout,
its chunked branch and ``decode_unroll``; joint == the port's solo decode
(int4 weights, int8 cache), sampled joint == solo with the same generator
seed bit for bit, speculative joint == plain; the refusals.  The port of
``tests/test_continuous.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_spec_decode import compare_caches, tt
from torch_port_helpers import SMALL, close
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu.config import ConfigValle as JConfig
from valle2_tpu.kernels import fused_decode as jfd
from valle2_tpu.models import ValleAR as JValleAR
from valle2_tpu.models import ar as jar
from valle2_tpu.models.continuous import ContinuousDecoder as JContinuousDecoder
from valle2_tpu.models.convert import export_ar_state_dict
from valle2_tpu.ops.transformer import KVCache as JKVCache
from valle2_tpu.ops.transformer import quantize_kv as j_quantize_kv
from valle2_tpu.ops.transformer import transformer_init as j_transformer_init
from valle2_tpu_torch.config import ConfigValle
from valle2_tpu_torch.kernels import fused_decode as tfd
from valle2_tpu_torch.models import ValleAR
from valle2_tpu_torch.models.continuous import BatcherFull, ContinuousDecoder
from valle2_tpu_torch.models.convert import load_ar_state_dict
from valle2_tpu_torch.ops.transformer import KVCache, transformer_decode_step, transformer_init

TINY = dict(SMALL, max_audio_len=12, num_beams=1, temperature=0.0, bucket_sizes=(32, 64, 128))


def cfg(**kw) -> ConfigValle:
    return ConfigValle(**dict(TINY, **kw))


def prompts(n, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, 70, (rs.randint(4, 9),)),
             rs.randint(0, 1024, (rs.randint(3, 8), 8))) for _ in range(n)]


def gen(seed):
    return torch.Generator().manual_seed(seed)


def scenario(cb, ps, join_kw=lambda i: {}, first=5, step=4):
    """Three sessions on two rows: session 0 decodes ``first`` steps alone,
    session 1 joins mid-flight, session 0 finishes and is released, session
    2 reuses its row.  Returns each session's ids."""
    got = [[], [], []]
    s0 = cb.join(*ps[0], **join_kw(0))
    got[0].extend(cb.advance(first).get(s0, []))
    s1 = cb.join(*ps[1], **join_kw(1))
    while not cb.finished(s0):
        out = cb.advance(step)
        got[0].extend(out.get(s0, []))
        got[1].extend(out.get(s1, []))
    cb.release(s0)
    s2 = cb.join(*ps[2], **join_kw(2))
    assert s2 == s0                                   # the row is reused
    while not (cb.finished(s1) and cb.finished(s2)):
        out = cb.advance(step)
        got[1].extend(out.get(s1, []))
        got[2].extend(out.get(s2, []))
    return [np.asarray(g, np.int64) for g in got]


@pytest.fixture(scope='module')
def weights():
    """JAX AR params of the tiny config and their port copy."""
    jp = jar.init_params(jax.random.key(0), JConfig(**TINY))
    return jp, load_ar_state_dict(export_ar_state_dict(jp))


@pytest.fixture(scope='module')
def jax_ids(weights):
    """The JAX ContinuousDecoder's ids of ``scenario`` (XLA route, one
    compiled decoder for the module)."""
    jcfg = JConfig(**TINY)
    cb = JContinuousDecoder(JValleAR(jcfg, params=weights[0]), n_slots=2)
    return scenario(cb, prompts(3, seed=3))


# The Pallas cases: 3 rows at their own slots of one layer (the interpreted
# kernel unrolls its rows): the first generated slot, a middle one, S - 1.
PALLAS = dict(L=1, rows=3, h=2, hd=16, dff=64, S=40, ttm=6, pm=8, index=(14, 27, 39))
# The cache formats of a float32 model (a bfloat16 cache serves a bfloat16
# model, whose rounding differs between the packages: the card tests hold it).
CACHES = ('float32', 'int8')


def per_row_case(seed, cache_dtype):
    c = PALLAS
    d = c['h'] * c['hd']
    p = j_transformer_init(jax.random.key(seed), c['L'], d, c['h'], c['dff'],
                           adaptive_norm=False)
    rs = np.random.RandomState(seed)
    shape = (c['L'], c['rows'], c['h'], c['S'], c['hd'])
    kf, vf = (rs.standard_normal(shape).astype(np.float32) for _ in range(2))
    if cache_dtype == 'int8':
        (kq, ks), (vq, vs) = (j_quantize_kv(jnp.asarray(a)) for a in (kf, vf))
        cache = JKVCache(kq, vq, ks, vs)
    else:
        cache = JKVCache(jnp.asarray(kf), jnp.asarray(vf))
    x = rs.standard_normal((c['rows'], 1, d)).astype(np.float32)
    tl, plen = np.asarray([6, 0, 4], np.int32), np.asarray([8, 3, 1], np.int32)
    return p, cache, x, tl, plen


def torch_step_inputs(seed, rows, S, cache_dtype=torch.float32, fused=True):
    """Port-only inputs: a tiny stack, a random cache of ``rows`` rows (fused
    layout or per-head), x and the lengths; ttm 6, pm 8."""
    d, h = 32, 2
    g = gen(seed)
    p = transformer_init(g, 2, d, h, 64, adaptive_norm=False)
    kf, vf = (torch.randn((2, rows, h, S, d // h), generator=g) for _ in range(2))
    if cache_dtype == torch.int8:
        from valle2_tpu_torch.ops.transformer import quantize_kv
        (kq, ks), (vq, vs) = quantize_kv(kf), quantize_kv(vf)
        cache = KVCache(kq, vq, ks, vs)
    else:
        cache = KVCache(kf.to(cache_dtype), vf.to(cache_dtype))
    if fused:
        cache = tfd.fused_cache_layout(cache)
    x = torch.randn((rows, 1, d), generator=g)
    tl = torch.tensor([6, 0, 4, 5][:rows], dtype=torch.int32)
    pl = torch.tensor([8, 3, 1, 7][:rows], dtype=torch.int32)
    return p, cache, x, tl, pl


def plain_step(fused, p, x, cache, index, tl, pl, ttm=6, pm=8):
    """The port's per-row step on either layout (the fused plain version, or
    ``transformer_decode_step`` under the same mask)."""
    if fused:
        return tfd.fused_decode_step(p, x, 2, cache, index, tl, pl, ttm, pm)
    S = cache.k.shape[3]
    attend = tfd.verify_slot_mask(S, index, 1, tl, pl, ttm, pm)
    return transformer_decode_step(p, x, 2, cache, index, attend_mask=attend)


def row_cache(cache, rows):
    return KVCache(*(None if a is None else a[:, rows].clone() for a in cache))


class TestPerRowStep:
    @pytest.mark.parametrize('cache_dtype', CACHES)
    def test_plain_matches_pallas(self, cache_dtype):
        """fused_decode_step_plain with a (rows,) index == the Pallas kernel
        (interpret mode) with the same vector: y within 1e-4, the cache as
        ``compare_caches`` holds it; the CPU wrapper counts no launch."""
        c = PALLAS
        p, cache, x, tl, plen = per_row_case(len(cache_dtype), cache_dtype)
        index = np.asarray(c['index'], np.int32)
        yj, cj = jax.jit(jfd.fused_decode_step, static_argnums=(2, 7, 8))(
            p, jnp.asarray(x), c['h'], jfd.fused_cache_layout(cache), jnp.asarray(index),
            jnp.asarray(tl), jnp.asarray(plen), c['ttm'], c['pm'])
        tcache = tfd.fused_cache_layout(KVCache(*tt(tuple(cache))))
        before = (tfd.PLAIN_CALLS.count, tfd.PER_ROW_COUNTERS['fused_decode_step_per_row'].count)
        yt, ct = tfd.fused_decode_step(tt(p), torch.from_numpy(x), c['h'], tcache,
                                       torch.from_numpy(index), torch.from_numpy(tl),
                                       torch.from_numpy(plen), c['ttm'], c['pm'])
        assert (tfd.PLAIN_CALLS.count, tfd.PER_ROW_COUNTERS[
            'fused_decode_step_per_row'].count) == (before[0] + 1, before[1])
        close(yt, yj, atol=1e-4, rtol=1e-4)
        compare_caches(ct, cj)

    @pytest.mark.parametrize('cache_dtype', [torch.float32, torch.int8], ids=['f32', 'int8'])
    def test_vector_index_equals_scalar(self, cache_dtype):
        """Every row at the same slot: the vector index gives the scalar
        index's y and cache."""
        p, cache, x, tl, pl = torch_step_inputs(1, 3, 24, cache_dtype)
        c_s, c_v = row_cache(cache, slice(None)), row_cache(cache, slice(None))
        y_s, _ = plain_step(True, p, x, c_s, 17, tl, pl)
        y_v, _ = plain_step(True, p, x, c_v, torch.full((3,), 17, dtype=torch.int32), tl, pl)
        close(y_v, y_s, atol=1e-6)
        for a, b in zip(c_v, c_s):
            if a is not None:
                assert torch.equal(a, b)

    @pytest.mark.parametrize('fused', [True, False], ids=['fused', 'per_head'])
    def test_distinct_rows_equal_one_row_steps(self, fused):
        """Rows at different slots equal each row's own one-row step."""
        p, cache, x, tl, pl = torch_step_inputs(2, 3, 24, fused=fused)
        index = torch.tensor([14, 19, 23], dtype=torch.int32)
        joint = row_cache(cache, slice(None))
        y, _ = plain_step(fused, p, x, joint, index, tl, pl)
        for r in range(3):
            one = row_cache(cache, slice(r, r + 1))
            y_r, _ = plain_step(fused, p, x[r:r + 1], one, int(index[r]), tl[r:r + 1],
                                pl[r:r + 1])
            close(y[r], y_r[0], atol=1e-6)
            for a, b in zip(joint, one):
                if a is not None:
                    close(a[:, r].float(), b[:, 0].float(), atol=1e-6)

    @pytest.mark.parametrize('fused,cache_dtype', [(True, torch.float32), (False, torch.float32),
                                                   (True, torch.int8)],
                             ids=['fused', 'per_head', 'fused_int8'])
    def test_frozen_row_at_s_writes_nothing(self, fused, cache_dtype):
        """A row frozen at its budget sits at slot S: it writes nothing (the
        kernels' rule; JAX clamps the write to S - 1), and the live rows'
        outputs and cache rows equal their step without it."""
        S = 24
        p, cache, x, tl, pl = torch_step_inputs(3, 3, S, cache_dtype, fused)
        index = torch.tensor([15, S, S - 1], dtype=torch.int32)
        joint = row_cache(cache, slice(None))
        y, _ = plain_step(fused, p, x, joint, index, tl, pl)
        assert torch.isfinite(y).all()
        for a, b in zip(joint, cache):
            if a is not None:
                assert torch.equal(a[:, 1], b[:, 1])       # the frozen row's cache
        live = [0, 2]
        alone = row_cache(cache, live)
        y_live, _ = plain_step(fused, p, x[live], alone, index[live], tl[live], pl[live])
        close(y[live], y_live, atol=1e-6)
        for a, b in zip(joint, alone):
            if a is not None:
                assert torch.equal(a[:, live], b)


class TestContinuousDecoder:
    @pytest.mark.parametrize('over', [{}, {'use_fused_decode': True},
                                      {'use_fused_decode': True, 'decode_chunk': 32},
                                      {'decode_unroll': 3}],
                             ids=['plain', 'fused', 'fused_chunked', 'unroll3'])
    def test_greedy_ids_equal_jax(self, weights, jax_ids, over):
        """Staggered joins and a reused row: every session's ids == JAX's
        ContinuousDecoder's; the fused layout launches the per-row step (its
        plain version here) on every joint step."""
        model = ValleAR(cfg(**over), params=weights[1], device='cpu')
        cb = ContinuousDecoder(model, n_slots=2)
        assert cb._use_fused == bool(over.get('use_fused_decode'))
        before = tfd.PLAIN_CALLS.count
        got = scenario(cb, prompts(3, seed=3))
        for g, w in zip(got, jax_ids):
            np.testing.assert_array_equal(g, np.asarray(w))
        assert (tfd.PLAIN_CALLS.count > before) == cb._use_fused
        if over.get('decode_chunk'):
            assert cb._state.cache.k.shape[2] % 32 == 0

    @pytest.mark.parametrize('over', [{'weight_dtype': 'int4'}, {'kv_cache_dtype': 'int8'},
                                      {'kv_cache_dtype': 'int8', 'use_fused_decode': True}],
                             ids=['int4', 'kv8', 'fused_kv8'])
    def test_joint_equals_port_solo(self, weights, over):
        """Quantized weights (the shared quantized view) and an int8 cache
        (its scales inserted and written per row): joint ids == each
        session's solo decode."""
        model = ValleAR(cfg(**over), params=weights[1], device='cpu')
        ps = prompts(3, seed=11)
        want = [model.generate(t, c).numpy() for t, c in ps]
        cb = ContinuousDecoder(model, n_slots=2)
        if 'weight_dtype' in over:
            assert cb._ar.decode_params is model.decode_params
        for g, w in zip(scenario(cb, ps, first=3), want):
            np.testing.assert_array_equal(g, w)

    @pytest.mark.parametrize('fused', [False, True], ids=['plain', 'fused'])
    def test_sampled_equals_solo_bit_for_bit(self, weights, fused):
        """temperature 1, top_k 50: each row draws from its own generator only
        while live, so every session's tokens == its solo decode on a
        generator of the same seed, through joins and a reused row."""
        model = ValleAR(cfg(temperature=1.0, top_k=50, use_fused_decode=fused),
                        params=weights[1], device='cpu')
        ps = prompts(3, seed=21)
        want = [model.generate(t, c, generator=gen(100 + i)).numpy()
                for i, (t, c) in enumerate(ps)]
        cb = ContinuousDecoder(model, n_slots=2)
        got = scenario(cb, ps, join_kw=lambda i: {'generator': gen(100 + i)})
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def test_row_frozen_at_its_budget_beside_a_live_row(self, weights):
        """ignore_eos, fused layout, no chunk padding (S = ttm + pm + 12):
        session 0 reaches max_audio_len and stays in its row, stepping at slot
        S as a no-op while session 1 decodes on; its cache row no longer
        changes, and both equal their solo decodes."""
        model = ValleAR(cfg(use_fused_decode=True, ignore_eos=True), params=weights[1],
                        device='cpu')
        ps = prompts(2, seed=5)
        want = [model.generate(t, c).numpy() for t, c in ps]
        cb = ContinuousDecoder(model, n_slots=2)
        assert cb._state.cache.k.shape[2] == cb.ttm + cb.pm + cb.max_new
        s0 = cb.join(*ps[0])
        got0 = list(cb.advance(6).get(s0, []))
        s1 = cb.join(*ps[1])
        got1 = []
        frozen = None
        while not cb.finished(s1):
            out = cb.advance(4)
            got0.extend(out.get(s0, []))
            got1.extend(out.get(s1, []))
            if cb.finished(s0):
                row = cb._state.cache.k[:, s0].clone()
                if frozen is not None:
                    assert torch.equal(row, frozen)
                frozen = row
        assert int(cb._state.step[s0]) == cb.max_new and frozen is not None
        np.testing.assert_array_equal(np.asarray(got0), want[0])
        np.testing.assert_array_equal(np.asarray(got1), want[1])

    def test_batcher_full_and_geometry_errors(self, weights):
        model = ValleAR(cfg(), params=weights[1], device='cpu')
        cb = ContinuousDecoder(model, n_slots=1, ttm=16, pm=16)
        t, c = prompts(1)[0]
        cb.join(t, c)
        assert cb.free_slots() == 0
        with pytest.raises(BatcherFull):
            cb.join(t, c)
        cb2 = ContinuousDecoder(model, n_slots=1, ttm=4, pm=16)
        with pytest.raises(ValueError, match='exceed'):
            cb2.join(np.zeros(10, np.int64), c)
        with pytest.raises(ValueError, match='exceed'):
            ContinuousDecoder(model, n_slots=1, pm=4).join(t, np.zeros((6, 8), np.int64))
        assert cb2.free_slots() == 1                  # a refused join holds no row

    def test_requires_single_beam_and_slots(self, weights):
        with pytest.raises(ValueError, match='num_beams'):
            ContinuousDecoder(ValleAR(cfg(num_beams=2), params=weights[1], device='cpu'))
        with pytest.raises(ValueError, match='n_slots'):
            ContinuousDecoder(ValleAR(cfg(), params=weights[1], device='cpu'), n_slots=0)

    def test_advance_empty_release_idempotent(self, weights):
        cb = ContinuousDecoder(ValleAR(cfg(), params=weights[1], device='cpu'), n_slots=2)
        assert cb.advance(8) == {}
        t, c = prompts(1)[0]
        s = cb.join(t, c, start=False)
        assert cb.advance(8) == {}                    # a pending row is invisible
        cb.activate(s)
        assert len(cb.advance(2, tags=True)[s][1]) == 2
        cb.release(s)
        cb.release(s)
        assert cb.free_slots() == 2
        with pytest.raises(KeyError):
            cb.finished(s)


class TestSpeculative:
    @pytest.mark.parametrize('mode', ['greedy', 'sampled', 'fused'])
    def test_equals_solo(self, weights, mode):
        """speculative=True (K 4, ngram 1): greedy rows == the plain loop's
        solo decode (also through the fused layout's verify step); sampled
        rows == their solo speculative decode on a generator of the same
        seed, through joins and a reused row."""
        over = dict(temperature=1.0, top_k=50) if mode == 'sampled' else {}
        over['use_fused_decode'] = mode == 'fused'
        plain = ValleAR(cfg(**over), params=weights[1], device='cpu')
        spec = ValleAR(dataclasses.replace(plain.config, speculative_k=4,
                                           speculative_ngram=1), params=weights[1],
                       device='cpu')
        ps = prompts(3, seed=43)
        solo = spec if mode == 'sampled' else plain
        want = [solo.generate(t, c, generator=gen(300 + i)).numpy()
                for i, (t, c) in enumerate(ps)]
        cb = ContinuousDecoder(spec, n_slots=2, speculative=True)
        got = scenario(cb, ps, join_kw=lambda i: {'generator': gen(300 + i)}, first=2, step=1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def test_requires_k(self, weights):
        with pytest.raises(ValueError, match='speculative_k'):
            ContinuousDecoder(ValleAR(cfg(), params=weights[1], device='cpu'),
                              speculative=True)
