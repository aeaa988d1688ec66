"""valle2_tpu_torch.ops against valle2_tpu.ops: same inputs (numpy seed), same
weights, float32, tolerance 1e-5 (the two frameworks sum in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import close, to_torch
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu import ops as jops
from valle2_tpu.kernels.flash_attention import _attend_block
from valle2_tpu_torch import ops as tops
from valle2_tpu_torch.ops import masks as tmasks

D, H, DFF, L = 32, 2, 64, 2


def rnd(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


# JAX references compiled whole (op-by-op dispatch compiles every op).
j_transformer = jax.jit(jops.transformer, static_argnums=2)
j_transformer_prefill = jax.jit(jops.transformer_prefill, static_argnums=(2, 3),
                                static_argnames='cache_dtype')
j_transformer_decode_step = jax.jit(jops.transformer_decode_step, static_argnums=2)
j_topk_sampling = jax.jit(jops.topk_sampling,
                          static_argnames=('top_k', 'tok_p', 'temperature'))
j_best_beam_index = jax.jit(jops.best_beam_index, static_argnums=(2, 3))


def stacked(adaptive):
    return jops.transformer_init(jax.random.key(0), L, D, H, DFF, adaptive_norm=adaptive)


class TestNN:
    def test_embedding_linear(self):
        p = jops.linear_init(jax.random.key(1), D, 3 * D)
        x = rnd(0, 4, 5, D)
        close(tops.linear(to_torch(p), t(x)), jops.linear(p, jnp.asarray(x)))
        e = jops.embedding_init(jax.random.key(2), 50, D)
        ids = np.random.RandomState(1).randint(0, 50, (3, 7))
        close(tops.embedding(to_torch(e), t(ids)), jops.embedding(e, jnp.asarray(ids)))

    def test_layernorm_adaln(self):
        x = rnd(3, 2, 6, D, scale=3.0) + 1.0
        ln = {'scale': rnd(4, D), 'bias': rnd(5, D)}
        close(tops.layernorm(to_torch(ln), t(x)), jops.layernorm(ln, jnp.asarray(x)))
        p = jops.adaln_init(jax.random.key(6), D)
        for cond in (rnd(7, 1, D), rnd(8, 2, D)):
            close(tops.adaln(to_torch(p), t(x), t(cond)),
                  jops.adaln(p, jnp.asarray(x), jnp.asarray(cond)))

    def test_ffn_erf_gelu(self):
        p = jops.ffn_init(jax.random.key(9), D, DFF)
        x = rnd(10, 2, 5, D, scale=2.0)
        close(tops.ffn(to_torch(p), t(x)), jops.ffn(p, jnp.asarray(x)))

    @pytest.mark.parametrize('offset', [0, 37])
    def test_positional(self, offset):
        pe_j = jops.sinusoidal_table(400, D)
        pe_t = tops.sinusoidal_table(400, D)
        close(pe_t, pe_j, atol=1e-5)
        x = rnd(11, 2, 9, D)
        close(tops.add_positional(pe_t, t(x), offset),
              jops.add_positional(pe_j, jnp.asarray(x), offset))


class TestMasks:
    def test_mask_to_bias(self):
        m = np.random.RandomState(0).rand(3, 11) > 0.5
        close(tmasks.mask_to_bias(t(m)), jops.mask_to_bias(jnp.asarray(m)), atol=0)

    @pytest.mark.parametrize('causal', [True, False])
    def test_prefix_lm_attend_matches_flash_formula(self, causal):
        s, tt = 23, 9
        tl = np.asarray([9, 4, 0], np.int32)
        ke = np.asarray([23, 15, 12], np.int32)
        got = tmasks.prefix_lm_attend(s, tt, t(tl), t(ke), causal)
        q_ids = jnp.arange(s)[None, :, None]
        k_ids = jnp.arange(s)[None, None, :]
        want = _attend_block(q_ids, k_ids, jnp.asarray(tl)[:, None, None],
                             jnp.asarray(ke)[:, None, None], tt, causal)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_prefix_lm_bias_is_ar_prefill_bias(self):
        """The no-flash AR prefill bias (ar.py:541-546)."""
        ttm, pm = 7, 6
        tl = np.asarray([7, 3], np.int32)
        cl = np.asarray([6, 2], np.int32)
        s = ttm + pm
        q_ids = jnp.arange(s)[None, :, None]
        k_ids = jnp.arange(s)[None, None, :]
        tlj, kej = jnp.asarray(tl)[:, None, None], jnp.asarray(ttm + cl)[:, None, None]
        attend = ((k_ids < tlj) | ((k_ids >= ttm) & (k_ids <= q_ids))) & (k_ids < kej)
        want = jnp.where(attend, 0.0, jnp.float32(-1e30))[:, None]
        close(tmasks.prefix_lm_bias(s, ttm, t(tl), t(ttm + cl)), want, atol=0)


class TestAttention:
    def test_qkv_sdpa_mha(self):
        p = jops.mha_init(jax.random.key(3), D, H)
        x = rnd(12, 2, 10, D)
        bias = np.where(np.random.RandomState(2).rand(2, 1, 10, 10) > 0.3, 0.0,
                        -1e30).astype(np.float32)
        from valle2_tpu.ops.attention import qkv_proj
        qj = qkv_proj(p, jnp.asarray(x), H)
        qt = tops.qkv_proj(to_torch(p), t(x), H)
        for a, b in zip(qt, qj):
            close(a, b)
        close(tops.sdpa(*qt, t(bias)), jops.sdpa(*qj, jnp.asarray(bias)))
        got, k, v = tops.mha(to_torch(p), t(x), H, t(bias), return_kv=True)
        want, kj, vj = jops.mha(p, jnp.asarray(x), H, jnp.asarray(bias), return_kv=True)
        close(got, want)
        close(k, kj)
        close(v, vj)

    def test_mha_flash_route_matches_bias_route(self):
        """The flash route (plain version on the CPU) equals the materialized
        prefix-LM bias route of the JAX mha."""
        p = jops.mha_init(jax.random.key(4), D, H)
        x = rnd(13, 2, 12, D)
        tl, ke, tt = np.asarray([5, 3], np.int32), np.asarray([12, 9], np.int32), 5
        flash = {'meta': t(np.stack([tl, ke], 1)), 'tokens_total': tt, 'causal': True}
        got = tops.mha(to_torch(p), t(x), H, flash=flash)
        bias = tmasks.prefix_lm_bias(12, tt, t(tl), t(ke)).numpy()
        close(got, jops.mha(p, jnp.asarray(x), H, jnp.asarray(bias)))


class TestSampling:
    @pytest.mark.parametrize('top_k,top_p', [(0, 1.0), (5, 1.0), (0, 0.7), (8, 0.5)])
    def test_filter(self, top_k, top_p):
        logits = rnd(14, 4, 40, scale=2.0)
        logits[0, :3] = logits[0, 3]                       # ties at the boundary
        close(tops.top_k_top_p_filter(t(logits), top_k, top_p),
              jops.top_k_top_p_filter(jnp.asarray(logits), top_k, top_p), atol=0)

    def test_greedy_sampling_and_beam_pick(self):
        logits = rnd(15, 5, 30, scale=3.0)
        s_t, lp_t = tops.topk_sampling(t(logits), top_k=7, tok_p=0.9, temperature=0.0)
        s_j, lp_j = j_topk_sampling(jax.random.key(0), jnp.asarray(logits), top_k=7,
                                    tok_p=0.9, temperature=0.0)
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
        close(lp_t, lp_j)
        codes = np.random.RandomState(3).randint(0, 6, (3, 4, 9))
        lp = rnd(16, 3, 4)
        want = [int(j_best_beam_index(jnp.asarray(c), jnp.asarray(l), 5, 1.3))
                for c, l in zip(codes, lp)]
        got = tops.best_beam_index(t(codes), t(lp), 5, 1.3)
        assert got.tolist() == want

    def test_categorical_draws_equal_torch_multinomial(self):
        probs = torch.softmax(t(rnd(22, 12, 40, scale=3.0)), dim=-1)
        g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
        for _ in range(4):
            want = torch.multinomial(probs, 1, generator=g1)[:, 0]
            assert torch.equal(tops.categorical(probs, g2), want)

    def test_sampled_draws_stay_in_the_filtered_set(self):
        logits = rnd(17, 64, 30, scale=3.0)
        gen = torch.Generator().manual_seed(0)
        s, lp = tops.topk_sampling(t(logits), top_k=4, tok_p=1.0, temperature=1.0,
                                   generator=gen)
        top4 = np.argsort(-logits, axis=1)[:, :4]
        assert all(int(si) in row for si, row in zip(s, top4))
        assert torch.isfinite(lp).all() and (lp <= 0).all()


class TestTransformer:
    @pytest.mark.parametrize('adaptive', [False, True])
    def test_transformer(self, adaptive):
        p = stacked(adaptive)
        x = rnd(18, 2, 9, D)
        cond = rnd(19, 1, D) if adaptive else None
        bias = np.where(np.random.RandomState(4).rand(2, 1, 1, 9) > 0.2, 0.0,
                        -1e30).astype(np.float32)
        want = j_transformer(p, jnp.asarray(x), H, jnp.asarray(bias),
                             None if cond is None else jnp.asarray(cond))
        got = tops.transformer(to_torch(p), t(x), H, t(bias),
                               None if cond is None else t(cond))
        close(got, want)

    @pytest.mark.parametrize('cache_dtype', ['float32', 'bfloat16'])
    def test_prefill_then_decode_step(self, cache_dtype):
        """A bfloat16 cache under a float32 model is the config default."""
        p = stacked(False)
        x = rnd(20, 2, 7, D)
        yj, cj = j_transformer_prefill(p, jnp.asarray(x), H, 12,
                                       cache_dtype=jnp.dtype(cache_dtype))
        yt, ct = tops.transformer_prefill(to_torch(p), t(x), H, 12,
                                          cache_dtype=getattr(torch, cache_dtype))
        assert ct.k.dtype == getattr(torch, cache_dtype)
        close(yt, yj)
        close(ct.k.float(), np.asarray(cj.k, np.float32))
        close(ct.v.float(), np.asarray(cj.v, np.float32))
        xs = rnd(21, 2, 1, D)
        attend = np.random.RandomState(5).rand(2, 12) > 0.3
        attend[:, 9] = True
        yj2, cj2 = j_transformer_decode_step(p, jnp.asarray(xs), H, cj, jnp.int32(9),
                                             attend_mask=jnp.asarray(attend))
        yt2, ct2 = tops.transformer_decode_step(to_torch(p), t(xs), H, ct, 9,
                                                attend_mask=t(attend))
        close(yt2, yj2)
        close(ct2.k.float(), np.asarray(cj2.k, np.float32))
        close(ct2.v.float(), np.asarray(cj2.v, np.float32))
