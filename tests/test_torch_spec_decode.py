"""N-gram speculative decode in the port against the JAX package (float32,
'highest', d=32, 2 layers): ``_ngram_draft``, the q-block
``transformer_decode_step`` and ``fused_verify_step_plain`` (against the
Pallas verify kernel in interpret mode, as ``tests/test_kernels.py`` runs
it), greedy IDs of the speculative ``generate_batch`` (== the port's plain
loop == JAX's speculative decode), the sampled path's distribution, the
gate's refusals, ``synthesize_fused``, cloning and ASR under
``speculative_k``, and the config's kernel gates for head dims and widths.
Modelled on ``tests/test_spec_decode.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import SMALL, close
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu import quantize as jq
from valle2_tpu.config import ConfigValle as JConfig
from valle2_tpu.kernels import fused_decode as jfd
from valle2_tpu.models import ValleAR as JValleAR
from valle2_tpu.models import ar as jar
from valle2_tpu.models.convert import export_ar_state_dict
from valle2_tpu.ops.transformer import KVCache as JKVCache
from valle2_tpu.ops.transformer import quantize_kv as j_quantize_kv
from valle2_tpu.ops.transformer import transformer_decode_step as _j_decode_step
from valle2_tpu.ops.transformer import transformer_init as j_transformer_init
from valle2_tpu_torch import tts as ttts
from valle2_tpu_torch.codec import Encodec
from valle2_tpu_torch.config import ConfigValle
from valle2_tpu_torch.kernels import fused_decode as tfd
from valle2_tpu_torch.models import ValleAR
from valle2_tpu_torch.models import ar as tar
from valle2_tpu_torch.models.convert import load_ar_state_dict
from valle2_tpu_torch.ops.transformer import KVCache, transformer_decode_step

SPEC = dict(SMALL, num_audio_tokens=96, vocab_size=24, temperature=0.0, num_beams=1,
            max_audio_len=16, bucket_sizes=(16, 32))

# JAX's decode step as one compiled program (op-by-op dispatch compiles each op)
j_decode_step = jax.jit(_j_decode_step, static_argnums=2)
# The Pallas verify kernel (interpret mode) as one compiled program.
j_verify_step = jax.jit(jfd.fused_verify_step, static_argnums=(2, 7, 8))
j_ngram_draft = jax.jit(jar._ngram_draft, static_argnums=(2, 3))


def tt(tree):
    """JAX/numpy pytree → torch (float32 and int8 leaves)."""
    if isinstance(tree, dict):
        return {k: tt(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tt(v) for v in tree)
    if tree is None:
        return None
    a = np.asarray(tree)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def npy(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def assert_codes_near(got, want, frac=1e-2):
    """int8 codes within one step, on under ``frac`` of the entries (x / scale
    within rounding of a .5 boundary rounds to the neighbour when float32
    sums run in another order)."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < frac, (diff.max(), (diff > 0).mean())


@pytest.fixture(scope='module')
def weights():
    """JAX AR params of the TTS and ASR directions and their port copies."""
    out = {}
    for direction in ('tts', 'asr'):
        jp = jar.init_params(jax.random.key(0), JConfig(**dict(SPEC, direction=direction)))
        out[direction] = (jp, load_ar_state_dict(export_ar_state_dict(jp)))
    return out


def items(n, seed, src=24, tgt=96):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, src, (3 + 2 * i,)), rs.randint(0, tgt, (2 + i, 8)))
            for i in range(n)]


def with_eos_bias(jp, tp, eos, bias=1.5):
    """The same params with a bias on the EOS logit, so rows stop early at
    different steps (``linear`` adds 'b' where present)."""
    b = np.zeros(np.asarray(jp['proj']['w']).shape[1], np.float32)
    b[eos] = bias
    return ({**jp, 'proj': {**jp['proj'], 'b': jnp.asarray(b)}},
            {**tp, 'proj': {**tp['proj'], 'b': torch.from_numpy(b)}})


class TestNgramDraft:
    def test_draft_continues_latest_match(self):
        row = [[4, 1, 2, 3, 7, 7, 1, 2, 3, 9, 8, 5, 1, 2, 3, 0, 0]]
        got = tar._ngram_draft(torch.tensor(row), torch.tensor([15]), 3, 2,
                               torch.tensor([99]))
        assert got.tolist() == [[9, 8]]

    def test_no_match_falls_back(self):
        got = tar._ngram_draft(torch.tensor([[1, 2, 3, 4, 5, 6, 0, 0]]), torch.tensor([6]), 3,
                               3, torch.tensor([42]))
        assert got.tolist() == [[42, 42, 42]]

    @pytest.mark.parametrize('g,m', [(1, 1), (1, 3), (2, 3), (3, 3), (3, 5)])
    def test_equals_jax_on_seeded_buffers(self, g, m):
        """Small alphabets make matches, repeats and continuations that run
        past the written region; short rows (vlen <= g) and an all-distinct
        row take the fallback."""
        rs = np.random.RandomState(10 * g + m)
        codes = rs.randint(0, 4, (7, 30))
        codes[5] = np.arange(30)                       # no earlier match anywhere
        codes[6, :12] = 3                              # a constant run
        vlen = np.asarray([30, 17, 9, g, 2, 25, 12])
        fb = rs.randint(50, 60, (7,))
        want = j_ngram_draft(jnp.asarray(codes, jnp.int32), jnp.asarray(vlen), g, m,
                             jnp.asarray(fb, jnp.int32))
        got = tar._ngram_draft(torch.from_numpy(codes), torch.from_numpy(vlen), g, m,
                               torch.from_numpy(fb))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got.numpy()[5] == fb[5]).all()


VERIFY = dict(L=2, rows=3, h=2, hd=16, dff=64, S=48, ttm=6, pm=8, K=3)


def verify_case(variant, seed=0):
    """JAX weights and cache of one variant (codes from the JAX quantizers),
    a (rows, K, d) block and per-row start slots; row 2's block ends at the
    last slot."""
    c = VERIFY
    d = c['h'] * c['hd']
    p = j_transformer_init(jax.random.key(seed), c['L'], d, c['h'], c['dff'],
                           adaptive_norm=False)
    if variant in ('w8a8', 'w4a16'):
        p = jq.quantize_transformer(p, bits=8 if variant == 'w8a8' else 4)
    rs = np.random.RandomState(seed)
    shape = (c['L'], c['rows'], c['h'], c['S'], c['hd'])
    kf, vf = (rs.standard_normal(shape).astype(np.float32) for _ in range(2))
    if variant == 'kv8':
        (kq, ks), (vq, vs) = (j_quantize_kv(jnp.asarray(a)) for a in (kf, vf))
        cache = JKVCache(kq, vq, ks, vs)
    else:
        cache = JKVCache(jnp.asarray(kf), jnp.asarray(vf))
    x = rs.standard_normal((c['rows'], c['K'], d)).astype(np.float32)
    tl, plen = np.asarray([6, 4, 5], np.int32), np.asarray([8, 6, 3], np.int32)
    base = c['ttm'] + c['pm']
    index = np.asarray([base + 5, base + 2, c['S'] - c['K']], np.int32)
    return p, cache, x, tl, plen, index


def jax_attend(tl, plen, index, ttm, pm, S, K):
    """The speculative mask of JAX ar.py:759-762, per row and query."""
    slots = jnp.arange(S)[None, None, :]
    qi = jnp.arange(K)[None, :, None]
    base = (slots < tl[:, None, None]) | ((slots >= ttm) & (slots < ttm + plen[:, None, None]))
    return base | ((slots >= ttm + pm) & (slots <= jnp.asarray(index)[:, None, None] + qi))


def compare_caches(got, want):
    """Port cache against JAX's: float slots within 1e-5, int8 codes within
    one step on under 1%, bf16 scales within one bf16 step."""
    for g, w in zip(got, want):
        if g is None:
            assert w is None
        elif g.dtype == torch.int8:
            assert_codes_near(g.numpy(), w)
        elif g.dtype == torch.bfloat16:
            close(g.float(), np.asarray(w, np.float32), atol=0, rtol=2 ** -7)
        else:
            close(g, w, atol=1e-5)


class TestVerifyStep:
    @pytest.mark.parametrize('variant', ['dense', 'kv8', 'w8a8', 'w4a16'])
    def test_plain_matches_pallas_and_xla(self, variant):
        """fused_verify_step_plain == the Pallas verify kernel (interpret
        mode) and the port's q-block transformer_decode_step == JAX's: y
        within 1e-4, every written cache slot as ``compare_caches`` holds it;
        the CPU wrapper takes the plain version and counts no launch."""
        c = VERIFY
        p, cache, x, tl, plen, index = verify_case(variant, seed=len(variant))
        h, ttm, pm, S, K = c['h'], c['ttm'], c['pm'], c['S'], c['K']
        yj, cj = j_verify_step(p, jnp.asarray(x), h, jfd.fused_cache_layout(cache),
                               jnp.asarray(index), jnp.asarray(tl), jnp.asarray(plen), ttm, pm)
        yx, cx = j_decode_step(p, jnp.asarray(x), h, cache, jnp.asarray(index),
                               attend_mask=jax_attend(tl, plen, index, ttm, pm, S, K))
        tp = tt(p)
        tcache = tfd.fused_cache_layout(KVCache(*tt(tuple(cache))))
        assert tfd.variant(tp, tcache) == variant
        before = {v: n.count for v, n in tfd.VERIFY_COUNTERS.items()}
        yt, ct = tfd.fused_verify_step(tp, torch.from_numpy(x), h, tcache,
                                       torch.from_numpy(index), torch.from_numpy(tl),
                                       torch.from_numpy(plen), ttm, pm)
        assert {v: n.count for v, n in tfd.VERIFY_COUNTERS.items()} == before
        assert ct.k is tcache.k and yt.shape == (c['rows'], K, h * c['hd'])
        close(yt, yj, atol=1e-4, rtol=1e-4)
        compare_caches(ct, cj)
        # The q-block step on the standard layout, against JAX's.
        scache = KVCache(*tt(tuple(cache)))
        ys, cs = transformer_decode_step(
            tp, torch.from_numpy(x), h, scache, torch.from_numpy(index),
            attend_mask=tfd.verify_slot_mask(S, torch.from_numpy(index), K,
                                             torch.from_numpy(tl), torch.from_numpy(plen),
                                             ttm, pm))
        close(ys, yx, atol=1e-4, rtol=1e-4)
        compare_caches(cs, cx)

    def test_scalar_index_broadcasts(self):
        """One start slot for every row == the same slot per row, in the
        plain verify step and in the q-block decode step's default mask."""
        c = VERIFY
        p, cache, x, tl, plen, _ = verify_case('dense', seed=40)
        tp = tt(p)
        start = c['ttm'] + c['pm']
        outs = []
        for index in (start, torch.full((c['rows'],), start, dtype=torch.int32)):
            tcache = tfd.fused_cache_layout(KVCache(*tt(tuple(cache))))
            outs.append(tfd.fused_verify_step_plain(tp, torch.from_numpy(x), c['h'], tcache,
                                                    index, torch.from_numpy(tl),
                                                    torch.from_numpy(plen), c['ttm'],
                                                    c['pm']))
        assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1].k, outs[1][1].k)
        yj, _ = j_decode_step(p, jnp.asarray(x), c['h'], cache, jnp.int32(start))
        yt, _ = transformer_decode_step(tp, torch.from_numpy(x), c['h'],
                                        KVCache(*tt(tuple(cache))), start)
        close(yt, yj, atol=1e-4, rtol=1e-4)

    def test_single_token_step_unchanged(self):
        """A (b, 1, d) token at one scalar slot keeps the earlier path's
        results: the per-row form at the same slot is bit-identical."""
        c = VERIFY
        p, cache, x, tl, plen, _ = verify_case('dense', seed=41)
        tp = tt(p)
        slot = c['ttm'] + c['pm'] + 3
        mask = tfd.verify_slot_mask(c['S'], slot, 1, torch.from_numpy(tl),
                                    torch.from_numpy(plen), c['ttm'], c['pm'])
        outs = [transformer_decode_step(tp, torch.from_numpy(x[:, :1]), c['h'],
                                        KVCache(*tt(tuple(cache))), index, attend_mask=mask)
                for index in (slot, torch.full((c['rows'],), slot))]
        assert torch.equal(outs[0][0], outs[1][0])
        assert torch.equal(outs[0][1].k, outs[1][1].k)


# (config overrides, K, ngram, items seed): greedy parity cases
PARITY = {
    'fixed_k4_g3': (dict(ignore_eos=True), 4, 3, 0),
    'fixed_k2_g1': (dict(ignore_eos=True), 2, 1, 2),
    'fixed_k2_g3': (dict(ignore_eos=True), 2, 3, 2),
    'fixed_k4_g1': (dict(ignore_eos=True), 4, 1, 2),
    'eos_k4_g3': ({}, 4, 3, 1),
    'asr_k4_g3': (dict(direction='asr', ignore_eos=True), 4, 3, 14),
    'int8_k4_g3': (dict(ignore_eos=True, weight_dtype='int8'), 4, 3, 13),
    'int4_k4_g3': (dict(ignore_eos=True, weight_dtype='int4'), 4, 3, 14),
    'kv8_k4_g3': (dict(ignore_eos=True, kv_cache_dtype='int8'), 4, 3, 15),
}


class TestSpecParity:
    @pytest.mark.parametrize('case', sorted(PARITY))
    def test_greedy_ids_equal_plain_loop_and_jax(self, case, weights):
        """Greedy IDs of the port's speculative generate_batch, through the
        plain route and the fused layout (whose verify step takes its plain
        version on the CPU), == the port's plain loop == JAX's speculative
        generate_batch on the same weights."""
        over, k, g, seed = PARITY[case]
        direction = over.get('direction', 'tts')
        jp, tp = weights[direction]
        base = dict(SPEC, **over)
        asr = direction == 'asr'
        its = items(3 if not asr else 2, seed, src=96 if asr else 24, tgt=24 if asr else 96)
        toks, codes = [t for t, _ in its], [c for _, c in its]
        if case.startswith('eos'):
            jp, tp = with_eos_bias(jp, tp, ConfigValle(**base).eos_token)
        plain = ValleAR(ConfigValle(**base), params=tp, device='cpu')
        want = plain.generate_batch(toks, codes, bucket=False)
        spec_kw = dict(base, speculative_k=k, speculative_ngram=g)
        jwant = JValleAR(JConfig(**spec_kw), params=jp).generate_batch(
            toks, codes, bucket=False, rng=jax.random.key(0))
        for route in ({}, dict(use_fused_decode=True)):
            spec = ValleAR(ConfigValle(**dict(spec_kw, **route)), params=tp, device='cpu')
            got = spec.generate_batch(toks, codes, bucket=False)
            for gg, w, jw in zip(got, want, jwant):
                np.testing.assert_array_equal(gg.numpy(), w.numpy())
                np.testing.assert_array_equal(gg.numpy(), np.asarray(jw))
        lens = {len(w) for w in want}
        if case.startswith('eos'):
            assert any(n < base['max_audio_len'] for n in lens), 'no row stopped early'
        else:
            assert lens == {base['max_audio_len']}

    def test_logprob_statistics_match_the_plain_loop(self, weights):
        """sum_logprobs of the speculative decode == the plain loop's (they
        feed the beam pick), and both equal JAX's."""
        jp, tp = weights['tts']
        cfg = ConfigValle(**dict(SPEC, ignore_eos=True))
        its = items(2, 3)
        tok = [torch.as_tensor(t) for t, _ in its]
        cds = [torch.cat([torch.tensor([cfg.bos_token]), torch.as_tensor(c)[:, 0]])
               for _, c in its]
        ttm, pm = max(len(t) for t in tok), max(len(c) for c in cds)
        args = (torch.stack([torch.nn.functional.pad(t, (0, ttm - len(t))) for t in tok]),
                torch.tensor([len(t) for t in tok], dtype=torch.int32),
                torch.stack([torch.nn.functional.pad(c, (0, pm - len(c))) for c in cds]),
                torch.tensor([len(c) for c in cds], dtype=torch.int32))
        with torch.inference_mode():
            _, lp_plain, _ = tar._decode_fn(tp, *args, cfg)
            spec_cfg = dataclasses.replace(cfg, speculative_k=4)
            codes_spec, lp_spec, _ = tar._decode_fn(tp, *args, spec_cfg)
        assert codes_spec.shape == (2, 1, pm + cfg.max_audio_len)
        close(lp_spec, lp_plain.numpy(), atol=1e-5, rtol=1e-5)
        jcfg = JConfig(**dict(SPEC, ignore_eos=True, speculative_k=4))
        _, lp_j, _ = jax.jit(lambda *a: jar._decode_fn(jp, *a, jcfg))(
            *(jnp.asarray(a.numpy().astype(np.int32)) for a in args), jax.random.key(0))
        close(lp_spec, np.asarray(lp_j), atol=1e-5, rtol=1e-5)

    def test_repetitive_model_accepts_multi_token_blocks(self, weights):
        """A dominant-token model accepts whole blocks after the n-gram warm
        up: far fewer turns than tokens, counted on the StageClock."""
        _, tp = weights['tts']
        cfg = ConfigValle(**dict(SPEC, ignore_eos=True, speculative_k=4))
        b = torch.zeros(tp['proj']['w'].shape[1])
        b[7] = 50.0
        model = ValleAR(cfg, params={**tp, 'proj': {**tp['proj'], 'b': b}}, device='cpu')
        clock = ttts.StageClock('cpu')
        its = items(1, 4)
        out = model.generate_batch([its[0][0]], [its[0][1]], bucket=False, clock=clock)
        assert out[0].tolist() == [7] * cfg.max_audio_len
        assert clock.counts['ar_tokens'] == cfg.max_audio_len
        assert clock.counts['ar_turns'] <= 6, clock.counts


class TestSpecSampled:
    """temperature > 0: the same distribution as the plain sampler, not the
    same draws (PARITY.md deviation 4)."""

    def test_dominant_model_sampled_matches_greedy(self, weights):
        _, tp = weights['tts']
        cfg = ConfigValle(**dict(SPEC, ignore_eos=True, temperature=1.0, max_audio_len=12,
                                 speculative_k=4))
        b = torch.zeros(tp['proj']['w'].shape[1])
        b[5] = 50.0
        model = ValleAR(cfg, params={**tp, 'proj': {**tp['proj'], 'b': b}}, device='cpu')
        its = items(1, 7)
        out = model.generate_batch([its[0][0]], [its[0][1]], bucket=False)
        assert out[0].tolist() == [5] * 12

    def test_sampled_marginals_match_the_plain_sampler(self):
        """Per-position total-variation distance between the speculative and
        the plain sampler's marginals, 512 iid sequences each (one batch of
        identical prompts, diffuse random logits so the residual draw fires
        constantly): under 0.15, and at most max(0.08, 3x) the distance
        between two plain runs (the sampling noise at n = 512 over <= 10
        outcomes is ~0.05)."""
        kw = dict(SPEC, ignore_eos=True, temperature=1.0, max_audio_len=4,
                  num_audio_tokens=8, top_k=0)
        plain = ValleAR(ConfigValle(**kw), seed=3, device='cpu')
        spec = ValleAR(ConfigValle(**dict(kw, speculative_k=3, speculative_ngram=1)),
                       params=plain.params, device='cpu')
        rs = np.random.RandomState(8)
        t, c = rs.randint(0, 24, (4,)), rs.randint(0, 8, (3, 8))

        def marginals(model, seed, rows=512):
            """Per-position marginals; sampled EOS ids are stripped from the
            outputs, so rows pad back with EOS (both arms alike)."""
            gen = torch.Generator().manual_seed(seed)
            outs = model.generate_batch([t] * rows, [c] * rows, generator=gen, bucket=False)
            n, eos = model.config.max_audio_len, model.eos_token
            arr = np.stack([np.pad(o.numpy(), (0, n - len(o)), constant_values=eos)
                            for o in outs])
            return np.stack([np.bincount(arr[:, j], minlength=10) / rows for j in range(n)])
        m_plain, m_plain2, m_spec = (marginals(plain, 1), marginals(plain, 2),
                                     marginals(spec, 3))
        tv_noise = 0.5 * np.abs(m_plain - m_plain2).sum(axis=1)
        tv_spec = 0.5 * np.abs(m_spec - m_plain).sum(axis=1)
        assert tv_spec.max() < 0.15, (tv_spec, tv_noise)
        assert tv_spec.max() < max(0.08, 3.0 * tv_noise.max()), (tv_spec, tv_noise)

    def test_sampled_topk_filter_respected(self, weights):
        """top_k = 1 sampling == greedy: accept, residual and forced carry
        all honour the filter."""
        _, tp = weights['tts']
        base = dict(SPEC, ignore_eos=True, temperature=1.0, top_k=1)
        want = ValleAR(ConfigValle(**dict(base, temperature=0.0)), params=tp,
                       device='cpu').generate_batch(*zip(*items(2, 9)), bucket=False)
        got = ValleAR(ConfigValle(**dict(base, speculative_k=4)), params=tp,
                      device='cpu').generate_batch(*zip(*items(2, 9)), bucket=False)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


class TestSpecGate:
    def test_gate_refusals_match_jax(self):
        for kw, match in ((dict(speculative_k=1), 'speculative_k'),
                          (dict(speculative_k=4, num_beams=2), 'num_beams'),
                          (dict(speculative_k=4, speculative_ngram=0), 'ngram')):
            cfg = ConfigValle(**dict(SPEC, **kw))      # the config builds; the gate refuses
            with pytest.raises(ValueError, match=match):
                tar._spec_gate(cfg)
            with pytest.raises(ValueError, match=match):
                jar._spec_gate(JConfig(**dict(SPEC, **kw)))
            with pytest.raises(ValueError, match=match):
                ValleAR(cfg, device='cpu').generate_batch(*zip(*items(1, 0)), bucket=False)

    def test_gate_off_by_default_and_on_for_one_beam(self):
        assert not tar._spec_gate(ConfigValle(**SPEC))
        assert not tar._spec_enabled(ConfigValle())
        for kw in (dict(speculative_k=4), dict(speculative_k=2, temperature=1.0),
                   dict(speculative_k=4, use_fused_decode=True)):
            assert tar._spec_gate(ConfigValle(**dict(SPEC, **kw)))
            assert jar._spec_gate(JConfig(**dict(SPEC, **kw)))
        ConfigValle(speculative_k=4, num_beams=1)


class TestSpecPipeline:
    def test_synthesize_fused_with_spec_equals_plain(self):
        """synthesize_fused decodes through _decode_fn, so speculative_k
        applies inside it: greedy waveforms equal the plain config's."""
        base = ConfigValle(d_model=32, n_heads=2, dim_feedforward=64, num_layers=2,
                           max_audio_len=10, num_beams=1, dropout=0.0, temperature=0.0,
                           bucket_sizes=(16, 32), kv_cache_dtype='float32',
                           matmul_precision='highest')
        plain = ttts.ValleTTS(base, codec=Encodec(seed=3, device='cpu'), device='cpu')
        spec_cfg = dataclasses.replace(base, speculative_k=3)
        spec = ttts.ValleTTS(spec_cfg, ar=ValleAR(spec_cfg, params=plain.ar.params,
                                                  device='cpu'),
                             nar=plain.nar, codec=plain.codec, device='cpu')
        rs = np.random.RandomState(12)
        pt, pc = rs.randint(0, 70, (5,)), rs.randint(0, 1024, (6, 8))
        want = plain.synthesize_fused('hello there.', pt, pc)
        got = spec.synthesize_fused('hello there.', pt, pc)
        np.testing.assert_array_equal(got.codes, want.codes)
        np.testing.assert_array_equal(got.waveform, want.waveform)
        assert got.counts['ar_tokens'] == len(got.codes) and got.counts['ar_turns'] >= 1
        assert want.counts == {}

    def test_cloning_and_asr_run_under_spec(self):
        """ValleTTS.__call__ (cloning from audio) gives its plain config's
        codes under speculative_k; batched ASR gives the plain config's
        phonemes."""
        base = ConfigValle(**dict(SMALL, max_audio_len=4, num_beams=1, temperature=0.0))
        codec = Encodec(seed=3, device='cpu')
        ar = ValleAR(base, seed=0, device='cpu')
        asr_ar = ValleAR(dataclasses.replace(base, direction='asr'), seed=4, device='cpu')
        wav = (np.random.RandomState(5).randn(3200) * 0.3).astype(np.float32)
        outs = []
        for cfg in (base, dataclasses.replace(base, speculative_k=3)):
            tts = ttts.ValleTTS(cfg, ar=ValleAR(cfg, params=ar.params, device='cpu'),
                                codec=codec, device='cpu')
            called = tts('the dog ran home', wav, 16000, 'hello there')
            asr_cfg = dataclasses.replace(cfg, direction='asr')
            asr = ttts.ValleASRPipeline(asr_cfg, ar=ValleAR(asr_cfg, params=asr_ar.params,
                                                            device='cpu'),
                                        codec=codec, device='cpu')
            outs.append((called.codes, asr.batch_transcribe([wav, wav[:1600]], [24000] * 2,
                                                            output='phonemes')))
        np.testing.assert_array_equal(outs[0][0], outs[1][0])
        assert outs[0][1] == outs[1][1]


class TestKernelGates:
    """The config's 'auto' routes, decided from the shape before any launch."""

    @pytest.mark.parametrize('d,h,dff,weight_dtype,flash,fused', [
        (256, 4, 1024, 'compute', True, True),        # the serving model, hd 64
        (1024, 16, 4096, 'compute', True, True),      # the 204M geometry
        (1024, 16, 4096, 'int8', True, True),
        (64, 4, 256, 'compute', False, False),        # hd 16
        (384, 4, 1536, 'compute', False, True),       # hd 96: the fused step only
        (512, 4, 6144, 'compute', True, True),        # the widest 8-row tile
        (512, 4, 6144, 'int8', True, False),          # past the W8A8 tile
        (512, 4, 8192, 'int4', True, False),
    ])
    def test_auto_routes_by_shape(self, d, h, dff, weight_dtype, flash, fused):
        cfg = ConfigValle(d_model=d, n_heads=h, dim_feedforward=dff, weight_dtype=weight_dtype)
        assert cfg.flash_enabled('cuda') is flash
        assert cfg.fused_decode_enabled('cuda') is fused
        assert not cfg.flash_enabled('cpu') and not cfg.fused_decode_enabled('cpu')
        forced = dataclasses.replace(cfg, use_flash_attention=True, use_fused_decode=True)
        assert forced.flash_enabled('cuda') and forced.fused_decode_enabled('cuda')
        layout = tfd.LAYOUT_OF_WEIGHT_DTYPE[weight_dtype]
        reason = tfd.fit_error(d, h, dff, layout)
        assert (reason is None) is fused
        if d // h == 16:
            assert 'head dims' in reason

    def test_hd16_decodes_on_the_plain_route(self, weights):
        """An hd-16 model under 'auto' on the CPU runs its plain versions;
        the same entry point with the kernels forced takes their plain
        versions too on the CPU (the card refuses: tests/test_torch_cuda.py)."""
        _, tp = weights['tts']
        cfg = ConfigValle(**dict(SPEC, ignore_eos=True, speculative_k=4))
        assert cfg.head_dim == 16 and not cfg.fused_decode_enabled('cuda')
        got = ValleAR(cfg, params=tp, device='cpu').generate_batch(*zip(*items(2, 6)),
                                                                    bucket=False)
        assert all(len(g) == cfg.max_audio_len for g in got)
