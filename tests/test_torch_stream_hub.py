"""The port's StreamHub (``valle2_tpu_torch.stream_hub``) against the JAX
package's and against the port's solo streaming (float32, 'highest', d=32, 2
layers, one beam): the hub's waveforms within the port's waveform tolerance
of JAX's ``StreamHub`` (greedy, 2 concurrent sessions, batched NAR); hub
tokens == solo streaming's and waveforms within float32 round-off (batched
NAR) or equal (per-session refinement), sampled sessions with per-session
refinement equal solo streaming on the same generator seed bit for bit, the
speculative hub; full, close, a refine failure that frees the rows,
oversized prompts, refusals; drain, refusal while draining, long-form
pipelining and its truncation at a sentence boundary; the speculative turn
budget's EMA (host only).  The port of ``tests/test_stream_hub.py`` without
the server (``serve.py`` is not ported)."""

import threading
import time

import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import SMALL, close, to_np
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu import stream_hub as jhub
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
from valle2_tpu_torch.models import ValleAR, ValleNAR
from valle2_tpu_torch.models.convert import (codec_params_from_numpy, load_ar_state_dict,
                                             load_nar_state_dict)
from valle2_tpu_torch.stream_hub import HubDraining, HubFull, HubStopped, StreamHub

TINY = dict(SMALL, max_audio_len=12, num_beams=1, temperature=0.0, bucket_sizes=(32, 64, 128))
WAV_ATOL = 1e-4          # the port's waveform tolerance against JAX (test_torch_tts.py)
# The joint codec decode of a batched refinement sums in another order than a
# one-row decode: float32 round-off of samples of magnitude <= 1.
ROUNDOFF = 1e-6
TEXTS = ('hello there.', 'go on now.', 'stop that.')


def prompt(seed):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 70, (5,)), rs.randint(0, 1024, (6, 8))


def collect(chunks):
    out = [np.asarray(c) for c in chunks]
    return np.concatenate(out) if out else np.zeros((0,), np.float32)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def concurrently(fns, timeout=120):
    """Run each fn on its own thread; returns their results (an exception
    re-raised)."""
    res, errs = [None] * len(fns), []

    def run(i):
        try:
            res[i] = fns[i]()
        except Exception as e:      # noqa: BLE001 -- reported below
            errs.append(e)
    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not [t for t in threads if t.is_alive()], 'sessions hung'
    if errs:
        raise errs[0]
    return res


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
def port(weights):
    return port_tts(weights)


@pytest.fixture(scope='module')
def jax_hub_wavs(weights):
    """Two concurrent sessions through one JAX StreamHub (batched NAR):
    every JAX program of the module compiles once here."""
    jcfg = JConfig(**TINY)
    ar_p, nar_p, codec_p = weights[0]
    tts = jtts.ValleTTS(jcfg, ar=JValleAR(jcfg, params=ar_p), nar=JValleNAR(jcfg, params=nar_p),
                        codec=jenc.EncodecTPU(params=codec_p))
    hub = jhub.StreamHub(tts, n_slots=2, chunk_frames=4)
    try:
        return concurrently([lambda i=i: collect(hub.open(TEXTS[i], *prompt(i),
                                                          rng=jax.random.key(7)))
                             for i in range(2)])
    finally:
        hub.stop()


def solo_stream(tts, i, seed=7, **kw):
    return collect(tts.synthesize_streaming(TEXTS[i], *prompt(i), chunk_frames=4,
                                            generator=gen(seed), **kw))


class TestStreamHub:
    def test_waveforms_equal_jax(self, port, jax_hub_wavs):
        hub = StreamHub(port, n_slots=2, chunk_frames=4)
        try:
            got = concurrently([lambda i=i: collect(hub.open(TEXTS[i], *prompt(i),
                                                             generator=gen(7)))
                                for i in range(2)])
            for g, w in zip(got, jax_hub_wavs):
                assert g.shape == w.shape and len(g)
                close(g, w, atol=WAV_ATOL)
            assert hub.live_sessions() == 0 and not hub.errors
        finally:
            hub.stop()

    @pytest.mark.parametrize('batched', [True, False], ids=['batched_nar', 'per_session'])
    def test_equals_solo_streaming(self, port, batched):
        """Tokens (``codes_sink``) == the fused pipeline's first codebook;
        waveforms == solo streaming's on the same generator seed: to float32
        round-off through the batched refinement, exactly through each
        session's own."""
        want = [solo_stream(port, i) for i in range(2)]
        hub = StreamHub(port, n_slots=2, chunk_frames=4, batched_nar=batched)
        sinks = [[], []]
        try:
            got = concurrently([lambda i=i: collect(hub.open(
                TEXTS[i], *prompt(i), generator=gen(7), codes_sink=sinks[i]))
                for i in range(2)])
        finally:
            hub.stop()
        for i in range(2):
            fused = port.synthesize_fused(TEXTS[i], *prompt(i))
            np.testing.assert_array_equal(np.concatenate(sinks[i]), fused.codes[:, 0])
            assert got[i].shape == want[i].shape
            if batched:
                close(got[i], want[i], atol=ROUNDOFF)
            else:
                np.testing.assert_array_equal(got[i], want[i])

    def test_sampled_per_session_equals_solo(self, weights):
        """temperature 1: each session samples from its own generator, so with
        per-session refinement the waveform equals solo streaming's on a
        generator of the same seed, bit for bit."""
        tts = port_tts(weights, temperature=1.0, top_k=50)
        want = [solo_stream(tts, i, seed=40 + i) for i in range(2)]
        hub = StreamHub(tts, n_slots=2, chunk_frames=4, batched_nar=False)
        try:
            got = concurrently([lambda i=i: collect(hub.open(TEXTS[i], *prompt(i),
                                                             generator=gen(40 + i)))
                                for i in range(2)])
        finally:
            hub.stop()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def test_speculative_hub_equals_solo(self, weights):
        """speculative=True: verify turns commit the plain loop's tokens and
        emission counts tokens, so the waveforms are solo streaming's (which
        keeps the plain loop) to round-off; staggered sessions reuse a row."""
        tts = port_tts(weights, speculative_k=4, speculative_ngram=1)
        want = [solo_stream(tts, i) for i in range(3)]
        hub = StreamHub(tts, n_slots=2, chunk_frames=4, speculative=True)
        sem = threading.Semaphore(2)

        def run(i):
            with sem:
                time.sleep(0.01 * i)
                return collect(hub.open(TEXTS[i], *prompt(i), generator=gen(7)))
        try:
            got = concurrently([lambda i=i: run(i) for i in range(3)])
            assert hub.cb.free_slots() == 2
        finally:
            hub.stop()
        for g, w in zip(got, want):
            assert g.shape == w.shape
            close(g, w, atol=ROUNDOFF)

    def test_full_raises(self, port):
        hub = StreamHub(port, n_slots=1)
        try:
            hub.cb.join(*prompt(0))     # a row no hub session owns: never advanced
            with pytest.raises(HubFull):
                hub.open('hi.', *prompt(0))
        finally:
            hub.stop()

    def test_close_frees_row(self, port):
        hub = StreamHub(port, n_slots=1, chunk_frames=2)
        try:
            chunks = hub.open('one two.', *prompt(3), lookahead_frames=0)
            next(chunks)
            chunks.close()                  # the consumer leaves
            assert hub.live_sessions() == 0 and hub.cb.free_slots() == 1
            assert len(collect(hub.open('one two.', *prompt(3))))
        finally:
            hub.stop()

    def test_refine_failure_frees_rows(self, weights, monkeypatch):
        """A failing batched refinement ends the live sessions, keeps the
        error and releases their rows; the hub then serves again."""
        tts = port_tts(weights, max_audio_len=8, ignore_eos=True)
        hub = StreamHub(tts, n_slots=2, chunk_frames=3)
        try:
            def boom(*args):
                raise RuntimeError('injected device failure')
            monkeypatch.setattr(tts, '_nar_wav', boom)
            assert collect(hub.open('hello there.', *prompt(1), lookahead_frames=0)).size == 0
            deadline = time.time() + 10
            while hub.live_sessions() and time.time() < deadline:
                time.sleep(0.02)
            assert hub.live_sessions() == 0 and hub.cb.free_slots() == 2
            assert [str(e) for e in hub.errors] == ['injected device failure']
            monkeypatch.undo()
            assert len(collect(hub.open('hello there.', *prompt(1))))
        finally:
            hub.stop()

    def test_refusals(self, port, weights):
        hub = StreamHub(port, n_slots=1, ttm=8, pm=8)
        try:
            with pytest.raises(ValueError, match='exceed'):
                hub.open('word ' * 40, np.zeros((4,), np.int64), np.zeros((4, 8), np.int64))
            with pytest.raises(ValueError, match='lookahead'):
                hub.open('a.', *prompt(0), lookahead_frames=-1)
            assert hub.cb.free_slots() == 1
        finally:
            hub.stop()
        with pytest.raises(HubStopped):
            hub.open('a.', *prompt(0))
        with pytest.raises(ValueError, match='chunk_frames'):
            StreamHub(port, chunk_frames=0)
        with pytest.raises(ValueError, match='num_beams'):
            StreamHub(port_tts(weights, num_beams=2))
        with pytest.raises(ValueError, match='speculative_k'):
            StreamHub(port, speculative=True)


class TestHubDrain:
    def test_drain_finishes_live_session(self, port):
        want = solo_stream(port, 0)
        hub = StreamHub(port, n_slots=2, chunk_frames=4)
        try:
            got = {}
            chunks = hub.open(TEXTS[0], *prompt(0), generator=gen(7))
            t = threading.Thread(target=lambda: got.setdefault('w', collect(chunks)))
            t.start()
            hub.stop(drain=True)       # returns once the row finished
            t.join(timeout=60)
            assert not t.is_alive() and hub.live_sessions() == 0
            np.testing.assert_array_equal(got['w'].shape, want.shape)
            close(got['w'], want, atol=ROUNDOFF)
            with pytest.raises(HubStopped, match='stopped'):
                hub.open('more.', *prompt(0))
        finally:
            hub.stop()

    def test_open_refused_while_draining(self, port):
        hub = StreamHub(port, n_slots=1)
        try:
            hub._draining = True
            with pytest.raises(HubDraining, match='draining'):
                hub.open('hi there.', *prompt(0))
            with pytest.raises(HubDraining, match='draining'):
                collect(hub.open_longform('hi there. and more.', *prompt(0)))
        finally:
            hub._draining = False
            hub.stop()

    def test_longform_equals_synthesize_longform(self, port):
        """Sentences decode two at a time on the hub (the second prefetched
        while the first streams) and give synthesize_longform(carry='prompt')'s
        chunks on the same generator seed, to round-off."""
        text = 'go on. stop now.'
        want = [np.asarray(c) for c in port.synthesize_longform(
            text, *prompt(5), chunk_frames=3, lookahead_frames=2, generator=gen(3))]
        hub = StreamHub(port, n_slots=2, chunk_frames=3)
        try:
            got = [np.asarray(c) for c in hub.open_longform(
                text, *prompt(5), lookahead_frames=2, generator=gen(3))]
            assert hub.longform_prefetched >= 1 and hub.live_sessions() == 0
        finally:
            hub.stop()
        assert len(got) == len(want) >= 2
        for g, w in zip(got, want):
            assert g.shape == w.shape
            close(g, w, atol=ROUNDOFF)

    def test_longform_truncates_at_sentence_boundary(self, port):
        """One row: sentence 1 cannot prefetch while sentence 0 streams, so a
        drain that starts meanwhile ends the stream after sentence 0 (the
        long-form call's first sentence on the same generator seed)."""
        want = collect(port.synthesize_longform('hello there.', *prompt(4), chunk_frames=4,
                                                generator=gen(5)))
        hub = StreamHub(port, n_slots=1, chunk_frames=4)
        try:
            chunks = hub.open_longform('hello there. go on now.', *prompt(4),
                                       generator=gen(5))
            hub._draining = True       # before sentence 1 opens
            got = collect(chunks)
        finally:
            hub._draining = False
            hub.stop()
        assert got.shape == want.shape and len(got)
        close(got, want, atol=ROUNDOFF)


class TestAdaptiveVerifyTurns:
    """The speculative hub's turn budget per cycle (``_turns_for_cycle`` /
    ``_observe_acceptance``): about ``chunk_frames`` tokens per cycle for
    the fastest session, clamped to [1, chunk_frames]."""

    @staticmethod
    def bare_hub(chunk_frames=24, spec=True, ema=4.0):
        hub = StreamHub.__new__(StreamHub)     # host logic only: no decoder
        hub.chunk_frames, hub._spec, hub._accept_ema = chunk_frames, spec, ema
        return hub

    def test_plain_hub_uses_chunk_frames(self):
        assert self.bare_hub(spec=False)._turns_for_cycle() == 24

    @pytest.mark.parametrize('ema,turns', [(4.0, 6), (1.0, 24), (0.25, 24), (100.0, 1)])
    def test_turns_track_acceptance(self, ema, turns):
        assert self.bare_hub(ema=ema)._turns_for_cycle() == turns

    def test_never_exceeds_plain_token_budget(self):
        for ema in (0.0, 0.5, 1.0, 1.5, 2.0, 3.9, 4.0, 7.0, 1e6):
            assert 1 <= self.bare_hub(ema=ema)._turns_for_cycle() <= 24

    def test_ema_converges_to_observed_rate(self):
        hub = self.bare_hub(ema=4.0)
        out = {0: (object(), np.zeros(3), False), 1: (object(), np.zeros(3), False)}
        for _ in range(30):
            hub._observe_acceptance(out, turns=6)
        assert abs(hub._accept_ema - 0.5) < 1e-6
        assert hub._turns_for_cycle() == 24

    def test_ema_tracks_fastest_row(self):
        hub = self.bare_hub(ema=1.0)
        out = {0: (object(), np.zeros(24), False), 1: (object(), np.zeros(6), False)}
        for _ in range(30):
            hub._observe_acceptance(out, turns=6)
        assert abs(hub._accept_ema - 4.0) < 1e-6
        assert hub._turns_for_cycle() == 6

    def test_mid_advance_finishers_do_not_poison_ema(self):
        hub = self.bare_hub(ema=4.0)
        hub._observe_acceptance({0: (object(), np.zeros(8), True)}, turns=24)
        assert hub._accept_ema == 4.0
        hub._observe_acceptance({0: (object(), np.zeros(2), True),
                                 1: (object(), np.zeros(24), False)}, turns=6)
        assert abs(hub._accept_ema - 4.0) < 1e-6

    def test_empty_cycle_keeps_ema(self):
        hub = self.bare_hub(ema=2.5)
        hub._observe_acceptance({}, turns=10)
        assert hub._accept_ema == 2.5
        hub._spec = False
        hub._observe_acceptance({0: (object(), np.zeros(9), False)}, turns=3)
        assert hub._accept_ema == 2.5


class TestBatchedRefineWidth:
    """The batched refine (``_route_batched``, host logic with a stand-in
    ``_nar_wav``): each due session refines at the width its solo emitter
    picks, one ``_nar_wav`` per width due, never at a wider co-tenant's."""

    @staticmethod
    def route(lengths, widths=(4, 8, 12)):
        from types import SimpleNamespace

        from valle2_tpu_torch.stream_hub import HOP, _Session
        hub = StreamHub.__new__(StreamHub)     # host logic only: no decoder
        hub._lock, hub._widths, hub._by_slot = threading.Lock(), list(widths), {}
        hub._nar_gen = torch.Generator().manual_seed(0)
        hub._nar_tokens = hub._nar_tl = hub._nar_pcodes = hub._nar_pl = None
        hub.cb = SimpleNamespace(n_slots=len(lengths), release=lambda slot: None)
        calls = []

        def nar_wav(tok, tl, pc, pl, first, gen, seed):
            calls.append((first.shape[1], gen.tolist(), first.copy()))
            return np.full((first.shape[0], first.shape[1] * HOP), first.shape[1],
                           np.float32), None
        hub.tts = SimpleNamespace(_nar_wav=nar_wav)
        sessions, out = [], {}
        for slot, n in enumerate(lengths):
            sess = _Session(lookahead=0, max_new=max(widths))
            sess.slot = slot
            hub._by_slot[slot] = sess
            sessions.append(sess)
            out[slot] = (sess, np.arange(1, n + 1), False)
        hub._route_batched(out)
        return calls, sessions, HOP

    def test_sessions_of_two_widths_refine_apart(self):
        calls, sessions, hop = self.route([7, 3])
        assert sorted(w for w, _, _ in calls) == [4, 8]
        for width, gen, first in calls:
            slot = 0 if width == 8 else 1
            assert gen == [7, 1] if slot == 0 else gen == [1, 3]
            assert first[1 - slot].sum() == 0          # the other row rides idle
        for sess, width in zip(sessions, (8, 4)):
            chunk, done = sess.q.get_nowait()
            assert not done and chunk.shape == (sess.n * hop,) and (chunk == width).all()

    def test_one_width_one_refine(self):
        calls, sessions, _ = self.route([6, 5, 8])
        assert [(w, g) for w, g, _ in calls] == [(8, [6, 5, 8])]
