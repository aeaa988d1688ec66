"""The chunked cache of the fused decode and verify steps in the port against
the JAX package (float32, d=32, 2 layers): the chunk choice (``pick_chunk``,
``chunk_for``, the prefill's padding) over a grid of geometries with no
compile; the plain chunked #6 and #7 against the Pallas kernels in interpret
mode with ``chunk_override`` (S=48, chunk 16, a verify block straddling a
chunk boundary, a dense and an int8 cache) and against the port's unchunked
plain versions; the refusal of a cache length that is not a multiple; and
greedy IDs of a speculative config with ``decode_chunk`` set through the
fused layout, against JAX.  Modelled on ``tests/test_kernels.py``'s
``TestPickChunk`` and chunked cases."""

import itertools

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
from valle2_tpu.models.convert import export_ar_state_dict
from valle2_tpu.ops.transformer import KVCache as JKVCache
from valle2_tpu.ops.transformer import quantize_kv as j_quantize_kv
from valle2_tpu.ops.transformer import transformer_init as j_transformer_init
from valle2_tpu_torch.config import ConfigValle
from valle2_tpu_torch.kernels import fused_decode as tfd
from valle2_tpu_torch.models import ValleAR
from valle2_tpu_torch.models import ar as tar
from valle2_tpu_torch.models.convert import load_ar_state_dict
from valle2_tpu_torch.ops.attention import sdpa, sdpa_chunked
from valle2_tpu_torch.ops.transformer import KVCache, transformer_init

CACHE_DTYPES = {'float32': (jnp.float32, torch.float32),
                'bfloat16': (jnp.bfloat16, torch.bfloat16), 'int8': (jnp.int8, torch.int8)}
GRID = list(itertools.product((48, 728, 897, 1024, 1536, 1734, 4000), (1, 3, 4, 12),
                              ((256, 4), (1024, 16), (2048, 32))))


@pytest.fixture(autouse=True)
def no_env_chunk(monkeypatch):
    monkeypatch.delenv('VALLE2_FUSED_CHUNK', raising=False)


class TestChunkChoice:
    @pytest.mark.parametrize('forced', [None, 16, 256, 512, 2000])
    @pytest.mark.parametrize('cache', sorted(CACHE_DTYPES))
    def test_chunk_for_equals_jax(self, cache, forced):
        jdt, tdt = CACHE_DTYPES[cache]
        for seq, rows, (d, h) in GRID:
            assert tfd.chunk_for(seq, rows, d, h, tdt, forced) == \
                jfd.chunk_for(seq, rows, d, h, jdt, forced), (seq, rows, d, h)

    def test_pick_chunk_equals_jax_and_env_wins(self, monkeypatch):
        for seq, rows, (d, h) in GRID:
            for item, quant in ((4, False), (2, False), (1, True)):
                assert tfd.pick_chunk(seq, rows, d, h, item, quant) == \
                    jfd.pick_chunk(seq, rows, d, h, item, quant)
        assert tfd.pick_chunk(1734, 4, 1024, 16, 2, False) == 512    # 204M at 4 beams
        assert tfd.pick_chunk(728, 4, 256, 4, 2, False) == 728       # whole-S
        monkeypatch.setenv('VALLE2_FUSED_CHUNK', '256')
        assert tfd.env_chunk() == 256
        assert tfd.pick_chunk(1734, 4, 1024, 16, 2, False, forced=512) == 256
        assert tfd.BLOCK_BYTES_CAP == jfd.BLOCK_BYTES_CAP
        assert tfd.DEFAULT_CHUNK == jfd.DEFAULT_CHUNK

    @pytest.mark.parametrize('env', [None, '1900'])
    def test_padded_cache_len_is_jax_prefills_fixed_point(self, env, monkeypatch):
        """The prefill's padding equals JAX ``_decode_prefill``'s loop (ar.py
        :511-517) over the grid and forced chunks, a forced chunk inside the
        padding window included, and the chunk divides the result."""
        if env:
            monkeypatch.setenv('VALLE2_FUSED_CHUNK', env)
        for (seq, rows, (d, h)), forced in itertools.product(GRID + [(1800, 8, (1024, 16))],
                                                             (None, 256, 512)):
            for cache in CACHE_DTYPES:
                jdt, tdt = CACHE_DTYPES[cache]
                want = seq
                for _ in range(3):
                    c = jfd.chunk_for(want, rows, d, h, jdt, forced=forced)
                    if c >= want or want % c == 0:
                        break
                    want = -(-want // c) * c
                got = tfd.padded_cache_len(seq, rows, d, h, tdt, forced)
                assert got == want
                assert got % tfd.chunk_for(got, rows, d, h, tdt, forced) == 0


# The Pallas cases: 2 rows, 1 layer (the interpreted kernel unrolls its rows).
PALLAS = dict(L=1, rows=2, h=2, hd=16, dff=64, S=48, ttm=6, pm=8, chunk=16)


def pallas_case(seed, K, int8):
    c = PALLAS
    d = c['h'] * c['hd']
    p = j_transformer_init(jax.random.key(seed), c['L'], d, c['h'], c['dff'],
                           adaptive_norm=False)
    rs = np.random.RandomState(seed)
    shape = (c['L'], c['rows'], c['h'], c['S'], c['hd'])
    kf, vf = (rs.standard_normal(shape).astype(np.float32) for _ in range(2))
    if int8:
        (kq, ks), (vq, vs) = (j_quantize_kv(jnp.asarray(a)) for a in (kf, vf))
        cache = JKVCache(kq, vq, ks, vs)
    else:
        cache = JKVCache(jnp.asarray(kf), jnp.asarray(vf))
    x = rs.standard_normal((c['rows'], K, d)).astype(np.float32)
    tl, plen = np.asarray([6, 0], np.int32), np.asarray([8, 3], np.int32)
    return p, cache, x, tl, plen


class TestChunkedStepsAgainstPallas:
    """At most three interpret-mode runs: #6 dense, #7 dense and int8, chunk
    16 of S=48; row 0's verify block [14, 17) straddles the first boundary
    (tests/test_kernels.py:638-660).  Port y within 1e-4 of the kernel's, the
    cache as ``compare_caches`` holds it."""

    @pytest.mark.parametrize('case', ['decode_dense', 'verify_dense', 'verify_int8'])
    def test_plain_chunked_matches_pallas(self, case):
        c = PALLAS
        verify, int8 = case.startswith('verify'), case.endswith('int8')
        K = 3 if verify else 1
        p, cache, x, tl, plen = pallas_case(len(case), K, int8)
        h, ttm, pm, chunk = c['h'], c['ttm'], c['pm'], c['chunk']
        index = np.asarray([14, 30], np.int32) if verify else 35
        jargs = (jnp.asarray(tl), jnp.asarray(plen), ttm, pm)
        jstep = jax.jit(jfd.fused_verify_step if verify else jfd.fused_decode_step,
                        static_argnums=(2, 7, 8), static_argnames='chunk_override')
        yj, cj = jstep(p, jnp.asarray(x), h, jfd.fused_cache_layout(cache),
                       jnp.asarray(index), *jargs, chunk_override=chunk)
        tcache = tfd.fused_cache_layout(KVCache(*tt(tuple(cache))))
        tstep = tfd.fused_verify_step if verify else tfd.fused_decode_step
        before = tfd.PLAIN_CALLS.count
        yt, ct = tstep(tt(p), torch.from_numpy(x), h, tcache,
                       torch.from_numpy(index) if verify else index, torch.from_numpy(tl),
                       torch.from_numpy(plen), ttm, pm, chunk_override=chunk)
        assert tfd.PLAIN_CALLS.count == before + 1
        close(yt, yj, atol=1e-4, rtol=1e-4)
        compare_caches(ct, cj)


def clone(cache):
    return KVCache(*(None if a is None else a.clone() for a in cache))


def port_case(seed, rows, K, S, int8, L=2, h=2, hd=16, ttm=6, pm=8):
    """A port stack and fused cache (int8 through quantize_kv_rowmajor)."""
    gen = torch.Generator().manual_seed(seed)
    d = h * hd
    p = transformer_init(gen, L, d, h, 2 * d, adaptive_norm=False)
    ck, cv = (torch.randn(L, rows, S, d, generator=gen) for _ in range(2))
    if int8:
        (kq, ks), (vq, vs) = (tfd.quantize_kv_rowmajor(a, h) for a in (ck, cv))
        cache = KVCache(kq, vq, ks, vs)
    else:
        cache = KVCache(ck, cv)
    x = torch.randn(rows, K, d, generator=gen)
    tl = torch.tensor([0, 6, 3, 5][:rows], dtype=torch.int32)
    cl = torch.tensor([8, 1, 4, 7][:rows], dtype=torch.int32)
    return p, cache, x, tl, cl, ttm, pm


class TestChunkedPlainVersions:
    @pytest.mark.parametrize('int8', [False, True], ids=['dense', 'int8'])
    @pytest.mark.parametrize('index', [20, 32, 47], ids=['first_chunks', 'boundary', 'last'])
    @pytest.mark.parametrize('chunk', [8, 16])
    def test_decode_chunked_equals_unchunked(self, chunk, index, int8):
        """#6's plain version over chunks == over every slot at once (f32
        sums in another order), the index in an early chunk, on a boundary
        and at S - 1; the cache written alike."""
        p, cache, x, tl, cl, ttm, pm = port_case(index + chunk, 4, 1, 48, int8)
        caches = [clone(cache) for _ in range(2)]
        y_c, _ = tfd.fused_decode_step_plain(p, x, 2, caches[0], index, tl, cl, ttm, pm,
                                             chunk_override=chunk)
        y_w, _ = tfd.fused_decode_step_plain(p, x, 2, caches[1], index, tl, cl, ttm, pm)
        close(y_c, y_w.numpy(), atol=1e-5, rtol=1e-5)
        compare_caches(caches[0], [None if a is None else a.float().numpy()
                                   for a in caches[1]])

    @pytest.mark.parametrize('int8', [False, True], ids=['dense', 'int8'])
    @pytest.mark.parametrize('K', [1, 4])
    def test_verify_chunked_equals_unchunked(self, K, int8):
        """#7's plain version over chunks of 8: blocks straddling a
        boundary, starting on one and ending at S - 1."""
        S = 48
        p, cache, x, tl, cl, ttm, pm = port_case(K, 4, K, S, int8)
        index = torch.tensor([14, 22, 32, S - K], dtype=torch.int32)
        caches = [clone(cache) for _ in range(2)]
        y_c, _ = tfd.fused_verify_step_plain(p, x, 2, caches[0], index, tl, cl, ttm, pm,
                                             chunk_override=8)
        y_w, _ = tfd.fused_verify_step_plain(p, x, 2, caches[1], index, tl, cl, ttm, pm)
        close(y_c, y_w.numpy(), atol=1e-5, rtol=1e-5)
        compare_caches(caches[0], [None if a is None else a.float().numpy()
                                   for a in caches[1]])

    def test_cache_length_not_a_multiple_raises(self):
        p, cache, x, tl, cl, ttm, pm = port_case(0, 2, 1, 44, False)
        with pytest.raises(ValueError, match='multiple'):
            tfd.fused_decode_step(p, x, 2, cache, 20, tl, cl, ttm, pm, chunk_override=16)
        with pytest.raises(ValueError, match='multiple'):
            tfd.fused_verify_step(p, x, 2, cache, torch.tensor([14, 20], dtype=torch.int32),
                                  tl, cl, ttm, pm, chunk_override=16)
        with pytest.raises(ValueError, match='multiple'):
            jfd.fused_decode_step(tt_jax(p), jnp.asarray(x.numpy()), 2,
                                  JKVCache(*(jnp.asarray(a.numpy()) for a in cache[:2])),
                                  jnp.int32(20), jnp.asarray(tl.numpy()),
                                  jnp.asarray(cl.numpy()), ttm, pm, chunk_override=16)

    def test_empty_chunks_add_nothing(self):
        """sdpa_chunked == sdpa where whole chunks are masked: the first
        chunks (no source, no prompt), a middle one, and every chunk past the
        last attended slot; no NaN from an all-masked chunk."""
        gen = torch.Generator().manual_seed(3)
        q, k, v = (torch.randn(2, 2, 3, 16, generator=gen) for _ in range(3))
        k = torch.cat([k] * 16, dim=2)
        v = torch.cat([v] * 16, dim=2)                       # 48 slots
        slots = torch.arange(48)
        attend = torch.stack([(slots >= 16) & (slots < 20), (slots < 2) | (slots == 40)])
        attend = attend[:, None, None, :].expand(2, 1, 3, 48)
        want = sdpa(q, k, v, torch.where(attend, 0.0, -1e30))
        got = sdpa_chunked(q, k, v, attend, 8, 6)
        assert torch.isfinite(got).all()
        close(got, want.numpy(), atol=1e-6, rtol=1e-5)


def tt_jax(tree):
    """Port pytree → JAX arrays."""
    if isinstance(tree, dict):
        return {k: tt_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


SPEC = dict(SMALL, num_audio_tokens=96, vocab_size=24, temperature=0.0, num_beams=1,
            max_audio_len=16, bucket_sizes=(16, 32), ignore_eos=True)


@pytest.mark.parametrize('kw', [dict(speculative_k=4, speculative_ngram=3),
                                dict(decode_unroll=3)], ids=['spec_k4', 'unroll3'])
def test_greedy_ids_with_decode_chunk_equal_jax(kw):
    """A config with decode_chunk 8 through the fused layout (the plain
    chunked versions on the CPU; the cache padded to a multiple of 8): greedy
    IDs == JAX's on the same weights, with speculative decode and with
    decode_unroll 3 (the codes buffer and cache padded to whole turns)."""
    base = dict(SPEC, **kw)
    jp = jar.init_params(jax.random.key(0), JConfig(**base))
    rs = np.random.RandomState(5)
    toks = [rs.randint(0, 24, (3 + 2 * i,)) for i in range(3)]
    codes = [rs.randint(0, 96, (2 + i, 8)) for i in range(3)]
    want = JValleAR(JConfig(**base), params=jp).generate_batch(toks, codes, bucket=False,
                                                               rng=jax.random.key(0))
    cfg = ConfigValle(**dict(base, use_fused_decode=True, decode_chunk=8))
    model = ValleAR(cfg, params=load_ar_state_dict(export_ar_state_dict(jp)), device='cpu')
    before = tfd.PLAIN_CALLS.count
    got = model.generate_batch(toks, codes, bucket=False)
    assert tfd.PLAIN_CALLS.count > before
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    tokens = torch.zeros(3, 7, dtype=torch.long)
    lens = torch.tensor([7, 5, 3], dtype=torch.int32)
    pcodes = torch.zeros(3, 5, dtype=torch.long)
    plens = torch.tensor([5, 3, 2], dtype=torch.int32)
    with torch.inference_mode():
        state, _, _ = tar._decode_prefill(model.params, tokens, lens, pcodes, plens, cfg,
                                          tar.compute_params(model.params, cfg))
    slack = kw.get('speculative_k', 0)
    unroll = kw.get('decode_unroll', 1)
    max_new_pad = -(-cfg.max_audio_len // unroll) * unroll + slack
    assert state.codes.shape == (3, 5 + max_new_pad)
    assert state.cache.k.shape[2] == -(-(7 + 5 + max_new_pad) // 8) * 8
