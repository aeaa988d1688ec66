"""Streaming and long-form synthesis in the port against the JAX package
(float32, 'highest', d=32, 2 layers, one beam): ``DecodeStream`` greedy IDs
(segmented, single advance, ``decode_unroll`` 2) equal JAX's; a sampled
stream is segment-invariant; ``synthesize_streaming`` with full lookahead
equals ``synthesize_fused``, its chunks cover every frame, its tokens are the
fused codes, and its waveforms equal JAX's within the port's waveform
tolerance; the NAR width buckets change nothing; arguments are checked at
call time; a params rebind reaches the stream; ``synthesize_longform`` in
both carry modes equals JAX's; the streaming model forces the 512-slot chunk
at ``max_audio_len >= 1024``.  The port of ``tests/test_streaming.py`` and
``tests/test_longform.py::TestLongform``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import SMALL, close, to_np
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu import tts as jtts
from valle2_tpu.codec import encodec as jenc
from valle2_tpu.config import ConfigValle as JConfig
from valle2_tpu.models import ValleAR as JValleAR
from valle2_tpu.models import ValleNAR as JValleNAR
from valle2_tpu.models import ar as jar
from valle2_tpu.models.convert import export_ar_state_dict, export_nar_state_dict
from valle2_tpu_torch import tts as ttts
from valle2_tpu_torch.codec import Encodec
from valle2_tpu_torch.config import ConfigValle
from valle2_tpu_torch.data.frontend import split_sentences
from valle2_tpu_torch.kernels import fused_decode as tfd
from valle2_tpu_torch.models import ValleAR, ValleNAR
from valle2_tpu_torch.models import ar as tar
from valle2_tpu_torch.models.convert import (codec_params_from_numpy, load_ar_state_dict,
                                             load_nar_state_dict)

TINY = dict(SMALL, max_audio_len=12, num_beams=1, temperature=0.0, bucket_sizes=(32, 64, 128))
WAV_ATOL = 1e-4          # the port's waveform tolerance against JAX (test_torch_tts.py)
TEXT2 = 'go on. stop now.'


def prompt(seed):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 70, (6,)), rs.randint(0, 1024, (7, 8))


def collect(stream):
    chunks = [np.asarray(c) for c in stream]
    return chunks, (np.concatenate(chunks) if chunks else np.zeros((0,), np.float32))


@pytest.fixture(scope='module')
def weights():
    """JAX AR, NAR and codec params and their port copies."""
    jcfg = JConfig(**TINY)
    jp_ar = jar.init_params(jax.random.key(0), jcfg)
    jnar = JValleNAR(jcfg, seed=1)
    codec = jenc.init_params(jax.random.key(3))
    tp = (load_ar_state_dict(export_ar_state_dict(jp_ar)),
          load_nar_state_dict(export_nar_state_dict(jnar.params)),
          codec_params_from_numpy(to_np({'decoder': codec['decoder'], 'rvq': codec['rvq']})))
    return (jp_ar, jnar.params, codec), tp


def port_tts(weights, **over) -> ttts.ValleTTS:
    cfg = ConfigValle(**dict(TINY, **over))
    ar_p, nar_p, codec_p = weights[1]
    return ttts.ValleTTS(cfg, ar=ValleAR(cfg, params=ar_p, device='cpu'),
                         nar=ValleNAR(cfg, params=nar_p, device='cpu'),
                         codec=Encodec(params=codec_p, device='cpu'), device='cpu')


@pytest.fixture(scope='module')
def jax_runs(weights):
    """Every JAX reference of the module from one JAX ValleTTS (one set of
    compiled programs): a segmented DecodeStream, streams with full and
    short lookahead, long-form in both carry modes."""
    jcfg = JConfig(**TINY)
    ar_p, nar_p, codec_p = weights[0]
    tts = jtts.ValleTTS(jcfg, ar=JValleAR(jcfg, params=ar_p), nar=JValleNAR(jcfg, params=nar_p),
                        codec=jenc.EncodecTPU(params=codec_p))
    rng = jax.random.key(0)
    tts._ensure_stream_models()
    toks, pc = prompt(1)
    stream = jar.DecodeStream(tts._stream_ar, toks, pc, rng=rng)
    ids = []
    while not stream.finished:
        ids.extend(stream.advance(3))
    pt, pc5 = prompt(5)
    out = {'ids': np.asarray(ids),
           'full': collect(tts.synthesize_streaming('hello.', pt, pc5, chunk_frames=4,
                                                    lookahead_frames=12, rng=rng))[0],
           'short': collect(tts.synthesize_streaming('go on.', pt, pc5, chunk_frames=3,
                                                     lookahead_frames=2, rng=rng))[0]}
    for carry in ('prompt', 'chain'):
        out[carry] = collect(tts.synthesize_longform(TEXT2, pt, pc5, carry=carry,
                                                     chunk_frames=3, lookahead_frames=2,
                                                     rng=rng))[0]
    return out


@pytest.fixture(scope='module')
def port(weights):
    return port_tts(weights)


@pytest.fixture(scope='module')
def port_longform(port):
    pt, pc = prompt(5)
    return {carry: collect(port.synthesize_longform(TEXT2, pt, pc, carry=carry, chunk_frames=3,
                                                    lookahead_frames=2))[0]
            for carry in ('prompt', 'chain')}


class TestDecodeStream:
    @pytest.mark.parametrize('unroll', [1, 2])
    def test_greedy_ids_equal_jax(self, weights, jax_runs, unroll):
        """Segments of 3 (rounded up to the unroll) and one advance of
        everything give JAX's DecodeStream IDs; steps_done stays a multiple
        of the unroll until the stream ends."""
        cfg = ConfigValle(**dict(TINY, decode_unroll=unroll))
        model = ValleAR(cfg, params=weights[1][0], device='cpu')
        toks, pc = prompt(1)
        stream = tar.DecodeStream(model, toks, pc)
        got = []
        while not stream.finished:
            got.extend(stream.advance(3))
            assert stream.steps_done % unroll == 0 or stream.finished
        np.testing.assert_array_equal(np.asarray(got), jax_runs['ids'])
        one = tar.DecodeStream(model, toks, pc).advance(10_000)
        np.testing.assert_array_equal(one, jax_runs['ids'])
        np.testing.assert_array_equal(model.generate(toks, pc).numpy(), jax_runs['ids'])

    @pytest.mark.parametrize('unroll', [1, 2])
    def test_sampled_stream_is_segment_invariant(self, weights, unroll):
        """temperature 1: the generator rides in the state, so segments of 2
        draw what one advance draws."""
        cfg = ConfigValle(**dict(TINY, temperature=1.0, decode_unroll=unroll))
        model = ValleAR(cfg, params=weights[1][0], device='cpu')
        toks, pc = prompt(2)
        one = tar.DecodeStream(model, toks, pc, torch.Generator().manual_seed(17)).advance(99)
        s2 = tar.DecodeStream(model, toks, pc, torch.Generator().manual_seed(17))
        many = []
        while not s2.finished:
            many.extend(s2.advance(2))
        np.testing.assert_array_equal(np.asarray(many), one)
        assert len(one) > 0

    def test_steps_follow_the_state_when_rows_finish(self, weights):
        """An EOS-biased model finishes early; the host finds it at its next
        check, so a segment may end short of its limit: steps_done is the
        state's step, the tokens are generate()'s, and nothing follows."""
        ar_p = weights[1][0]
        cfg = ConfigValle(**dict(TINY, max_audio_len=40))
        b = torch.zeros(ar_p['proj']['w'].shape[1])
        b[cfg.eos_token] = 3.0
        model = ValleAR(cfg, params={**ar_p, 'proj': {**ar_p['proj'], 'b': b}}, device='cpu')
        toks, pc = prompt(3)
        want = model.generate(toks, pc).numpy()
        stream = tar.DecodeStream(model, toks, pc)
        got = []
        while not stream.finished:
            got.extend(stream.advance(5))
            assert stream.steps_done == stream._state.step
        assert len(want) < cfg.max_audio_len
        np.testing.assert_array_equal(np.asarray(got), want)
        assert stream.advance(5).size == 0

    def test_requires_single_beam(self, weights):
        model = ValleAR(ConfigValle(**dict(TINY, num_beams=2)), params=weights[1][0],
                        device='cpu')
        with pytest.raises(ValueError, match='num_beams'):
            tar.DecodeStream(model, np.zeros((3,), np.int64), np.zeros((2, 8), np.int64))

    def test_fused_layout_with_a_forced_chunk(self, weights):
        """use_fused_decode with decode_chunk 8 on the CPU: the plain chunked
        step, a cache padded to a multiple of 8, the same greedy IDs."""
        cfg = ConfigValle(**dict(TINY, use_fused_decode=True, decode_chunk=8))
        model = ValleAR(cfg, params=weights[1][0], device='cpu')
        toks, pc = prompt(1)
        before = tfd.PLAIN_CALLS.count
        stream = tar.DecodeStream(model, toks, pc)
        got = []
        while not stream.finished:
            got.extend(stream.advance(5))
        assert stream._state.cache.k.shape[2] % 8 == 0
        assert tfd.PLAIN_CALLS.count - before == cfg.max_audio_len
        want = ValleAR(ConfigValle(**TINY), params=weights[1][0], device='cpu').generate(toks, pc)
        np.testing.assert_array_equal(np.asarray(got), want.numpy())


class TestStreamingSynthesis:
    def test_full_lookahead_equals_fused_and_jax(self, port, jax_runs):
        pt, pc = prompt(5)
        fused = port.synthesize_fused('hello.', pt, pc)
        chunks, total = collect(port.synthesize_streaming('hello.', pt, pc, chunk_frames=4,
                                                          lookahead_frames=12))
        assert len(chunks) == 1 == len(jax_runs['full'])
        close(total, fused.waveform, atol=1e-5)
        close(total, jax_runs['full'][0], atol=WAV_ATOL)

    def test_incremental_chunks_cover_all_frames_and_equal_jax(self, port, jax_runs):
        pt, pc = prompt(5)
        fused = port.synthesize_fused('go on.', pt, pc)
        stream = port.synthesize_streaming('go on.', pt, pc, chunk_frames=3,
                                           lookahead_frames=2)
        chunks, total = collect(stream)
        assert len(chunks) >= 2 and len(chunks) == len(jax_runs['short'])
        assert total.shape == (len(fused.codes) * 320,) and np.isfinite(total).all()
        for got, want in zip(chunks, jax_runs['short']):
            assert got.shape == want.shape
            close(got, want, atol=WAV_ATOL)
        # The timings: one chunk_s per chunk, the first audio after the
        # prefill, every stage on the clock.
        assert len(stream.chunk_s) == len(chunks) and stream.first_audio_s > 0
        assert set(stream.clock.times) == {'prefill', 'decode', 'nar_codec'}

    def test_streamed_tokens_match_fused_codes(self, port):
        """The stream's tokens are the fused pipeline's first codebook."""
        pt, pc = prompt(7)
        fused = port.synthesize_fused('yes.', pt, pc)
        model = port._ensure_stream_models()
        tokens = np.concatenate([pt, port.tokenizer('yes.')])
        stream = tar.DecodeStream(model, tokens, pc)
        ids = []
        while not stream.finished:
            ids.extend(stream.advance(3))
        np.testing.assert_array_equal(np.asarray(ids), fused.codes[:, 0])
        _, total = collect(port.synthesize_streaming('yes.', pt, pc, chunk_frames=3,
                                                     lookahead_frames=1))
        assert total.shape[0] == fused.codes.shape[0] * 320

    def test_output_invariant_to_nar_width_buckets(self, weights):
        """Narrow NAR widths (16, 32, 48) and the full width give the same
        audio: positions past the true length are masked (f32 sums in
        another order)."""
        narrow = port_tts(weights, max_audio_len=48, bucket_sizes=(16, 32))
        full = port_tts(weights, max_audio_len=48, bucket_sizes=(64, 128))
        assert ttts.stream_widths(narrow.config) == [16, 32, 48]
        assert ttts.stream_widths(full.config) == [48]
        pt, pc = prompt(4)
        a = collect(narrow.synthesize_streaming('a longer test sentence here.', pt, pc,
                                                chunk_frames=7, lookahead_frames=4))[1]
        b = collect(full.synthesize_streaming('a longer test sentence here.', pt, pc,
                                              chunk_frames=7, lookahead_frames=4))[1]
        assert len(a) > 0
        close(a, b, atol=1e-6)

    def test_validates_eagerly(self, port):
        pt, pc = prompt(8)
        with pytest.raises(ValueError, match='chunk_frames'):
            port.synthesize_streaming('x.', pt, pc, chunk_frames=0)
        with pytest.raises(ValueError, match='lookahead'):
            port.synthesize_streaming('x.', pt, pc, lookahead_frames=-1)

    def test_follows_params_rebind(self, weights):
        """tts.ar.params rebound (as load() does) reaches the streaming model."""
        tts = port_tts(weights)
        pt, pc = prompt(9)
        collect(tts.synthesize_streaming('a.', pt, pc))
        fresh = ValleAR(tts.config, seed=123, device='cpu')
        tts.ar.params = fresh.params
        got = collect(tts.synthesize_streaming('a.', pt, pc))[1]
        assert tts._stream_ar.params is fresh.params
        other = port_tts(weights)
        other.ar = ValleAR(other.config, params=fresh.params, device='cpu')
        np.testing.assert_array_equal(got, collect(other.synthesize_streaming('a.', pt, pc))[1])

    @pytest.mark.parametrize('max_len,chunk,want', [(1024, 0, 512), (2048, 0, 512),
                                                    (512, 0, 0), (1024, 256, 256)])
    def test_stream_model_forces_the_chunk(self, weights, max_len, chunk, want):
        """At max_audio_len >= 1024 the streaming model takes decode_chunk
        512 (an explicit one wins); one beam, the params shared."""
        tts = port_tts(weights, max_audio_len=max_len, decode_chunk=chunk, num_beams=4)
        model = tts._ensure_stream_models()
        assert model.config.decode_chunk == want and model.config.num_beams == 1
        assert model.params is tts.ar.params and tts._ensure_stream_models() is model


class TestLongform:
    def test_validates_eagerly(self, port):
        pt, pc = prompt(5)
        with pytest.raises(ValueError, match='carry'):
            port.synthesize_longform('x.', pt, pc, carry='loop')
        with pytest.raises(ValueError, match='chunk_frames'):
            port.synthesize_longform('x.', pt, pc, chunk_frames=0)
        with pytest.raises(ValueError, match='lookahead'):
            port.synthesize_longform('x.', pt, pc, lookahead_frames=-1)

    def test_empty_text_yields_nothing(self, port):
        pt, pc = prompt(5)
        assert list(port.synthesize_longform('  ', pt, pc)) == []

    @pytest.mark.parametrize('carry', ['prompt', 'chain'])
    def test_equals_jax(self, port_longform, jax_runs, carry):
        got, want = port_longform[carry], jax_runs[carry]
        assert len(got) == len(want) >= 2
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == np.float32
            close(g, w, atol=WAV_ATOL)

    def test_prompt_mode_is_per_sentence_streaming(self, port, port_longform):
        pt, pc = prompt(5)
        want = []
        for sent in split_sentences(TEXT2):
            want.extend(collect(port.synthesize_streaming(sent, pt, pc, chunk_frames=3,
                                                          lookahead_frames=2))[0])
        got = port_longform['prompt']
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def test_chain_conditions_on_the_previous_sentence(self, port_longform):
        """The first sentence's chunks are prompt mode's; the second's
        differ (another acoustic prompt)."""
        a, b = port_longform['prompt'], port_longform['chain']
        np.testing.assert_array_equal(a[0], b[0])
        assert not (len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b)))

    def test_chain_cap_falls_back_to_prompt_mode(self, port, port_longform):
        pt, pc = prompt(5)
        got = collect(port.synthesize_longform(TEXT2, pt, pc, carry='chain',
                                               max_chain_frames=0, chunk_frames=3,
                                               lookahead_frames=2))[0]
        want = port_longform['prompt']
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_config_takes_the_decode_features():
    cfg = ConfigValle(decode_chunk=512, decode_unroll=4)
    assert (cfg.decode_chunk, cfg.decode_unroll) == (512, 4)
    with pytest.raises(NotImplementedError, match='decode_attn_buckets'):
        ConfigValle(decode_attn_buckets=2)
    assert dataclasses.replace(cfg, num_beams=1).decode_chunk == 512
