"""StreamHub: the continuous-batching driver of concurrent streaming TTS
(``valle2_tpu/stream_hub.py``).

Each streamed request through ``ValleTTS.synthesize_streaming`` runs its own
one-row ``DecodeStream``; N concurrent requests run N small decode loops.
The hub instead runs ONE ``models.continuous.ContinuousDecoder`` (rows =
``n_slots``) on a driver thread: a session joins a free row mid-flight, every
``advance`` moves all live sessions one chunk, and rows free when their
session ends.

**Batched NAR refinement** (default): the emissions of every session that
crossed its lookahead this cycle are refined in one ``ValleTTS._nar_wav``
over all ``n_slots`` rows per width due (per-row prompts kept on the device,
rewritten only on a join; rows not due ride along at length 1), instead of
one pass per session.  Each session refines at the width its solo emitter
picks, never at a wider co-tenant's: a wider pass reorders the float32 sums
and can flip a near-tied NAR argmax.  The NAR masks every position past a
row's lengths and rows are independent, and sessions insert frozen until
activation, so chunk cadence
and refinement depths match the solo streaming path: greedy AR tokens and
NAR codes equal solo streaming's, and the waveform agrees to float32
round-off (the joint codec decode sums in another order).  Sampled sessions
keep their own AR generators (solo-exact AR tokens); with
``batched_nar=False`` each session refines through its own ``_ChunkEmitter``
with its own seed, so a sampled waveform equals solo streaming's too, while
the batched default draws the NAR samples from the hub's generator.

A failure of a joint advance or refine ends every live session (their
streams stop) and frees the rows, as JAX's hub does; the hub keeps the
exception in ``errors`` and goes on serving new sessions.
"""

from __future__ import annotations

import queue
import threading
import time
from collections.abc import Iterator

import numpy as np
import torch

from .config import bucket_len
from .data.frontend import split_sentences
from .models.ar import default_generator
from .models.continuous import BatcherFull, ContinuousDecoder
from .tts import (HOP, StageClock, _ChunkEmitter, _draw_seed, _split_seed, _stream_chunks,
                  finalize_frames, stream_widths)
from .utils import log_warning

__all__ = ['StreamHub', 'HubFull', 'HubDraining', 'HubStopped']

HubFull = BatcherFull       # the serving layer's alias (HTTP 429)


class HubDraining(RuntimeError):
    """Raised by ``open`` / ``open_longform`` during ``stop(drain=True)``: the
    hub finishes its live sessions and accepts no new ones."""


class HubStopped(RuntimeError):
    """Raised by ``open`` / ``open_longform`` once the hub has stopped."""


def _check_lookahead(lookahead_frames: int) -> None:
    if int(lookahead_frames) < 0:
        raise ValueError(f'lookahead_frames must be >= 0, got {lookahead_frames}')


class _Session:
    __slots__ = ('slot', 'q', 'lookahead', 'buf', 'n', 'emitted', 'sink')

    def __init__(self, lookahead: int, max_new: int, sink: list | None = None):
        self.slot = -1
        self.q: queue.Queue = queue.Queue()
        self.lookahead = lookahead
        # Batched-NAR emission state (unused when batched_nar=False).
        self.buf = np.zeros((max_new,), np.int64)   # first-codebook tokens
        self.n = 0                                  # tokens received
        self.emitted = 0                            # frames already emitted
        self.sink = sink                            # optional token collector


class StreamHub:
    """One ContinuousDecoder and the driver thread that advances it.

    ``open()`` joins a session and returns a generator of waveform chunks
    with ``synthesize_streaming`` semantics; it raises ``HubFull`` when every
    row is busy.  ``chunk_frames``: the hub-wide advance per cycle; every
    live session receives audio each chunk.  ``ttm`` / ``pm``: the shared
    prompt geometry (``ContinuousDecoder``; a prompt that does not fit raises
    ValueError).  ``batched_nar``: one joint refinement per cycle (module
    docstring).  ``speculative``: the joint loop runs n-gram verify turns
    (needs ``config.speculative_k >= 2``); waveforms do not change, since
    greedy speculation commits the plain loop's tokens and emission counts
    tokens, but chunks arrive at turn granularity: the turns per cycle follow
    an EMA of the fastest row's accepted tokens per turn, so that a cycle
    delivers about ``chunk_frames`` tokens and never more.
    """

    def __init__(self, tts, n_slots: int = 4, chunk_frames: int = 25,
                 ttm: int | None = None, pm: int | None = None,
                 batched_nar: bool = True, speculative: bool = False):
        if int(chunk_frames) < 1:
            raise ValueError(f'chunk_frames must be >= 1, got {chunk_frames}')
        if tts.config.num_beams != 1:
            raise ValueError('streaming requires num_beams=1')
        self.tts = tts
        self.chunk_frames = int(chunk_frames)
        self.cb = ContinuousDecoder(tts._ensure_stream_models(), n_slots=n_slots, ttm=ttm,
                                    pm=pm, speculative=bool(speculative))
        self._spec = bool(speculative)
        self._accept_ema = float(tts.config.speculative_k or 1)
        self.batched_nar = bool(batched_nar)
        self._by_slot: dict[int, _Session] = {}
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._stopped = False
        self._draining = False
        #: Exceptions of failed joint advances / refines, oldest first.
        self.errors: list[BaseException] = []
        #: Sentences opened while an earlier one of the same long-form stream
        #: was still streaming (open_longform's pipelining).
        self.longform_prefetched = 0

        if self.batched_nar:
            config, dev = tts.config, tts.device
            # The solo emitter's width grid and prompt buckets: when a
            # session's own buckets equal the hub geometry, its refinement
            # runs at the solo path's shapes.
            self._widths = stream_widths(config)
            n = self.cb.n_slots
            self._nar_ttm = bucket_len(config.bucket_sizes, self.cb.ttm)
            self._nar_pm = bucket_len(config.bucket_sizes, max(1, self.cb.pm - 1))
            nq = config.num_quantizers
            # Per-slot prompts on the device, replaced (not written in place)
            # on a join, so a refine in flight keeps its snapshot.  Idle rows
            # keep tl = 1 and gen_len = 1: no row is ever fully masked.
            self._nar_tokens = torch.zeros((n, self._nar_ttm), dtype=torch.long, device=dev)
            self._nar_tl = torch.ones((n,), dtype=torch.int32, device=dev)
            self._nar_pcodes = torch.zeros((n, self._nar_pm, nq), dtype=torch.long, device=dev)
            self._nar_pl = torch.zeros((n,), dtype=torch.int32, device=dev)
            self._nar_gen = torch.Generator().manual_seed(config.seed)   # a seed per refine

        self._driver = threading.Thread(target=self._drive, daemon=True,
                                        name='valle2-stream-hub')
        self._driver.start()

    # -- public ------------------------------------------------------------

    def open(self, text: str, prompt_tokens, prompt_codes, lookahead_frames: int = 38,
             generator: torch.Generator | None = None, bucket: bool = True,
             codes_sink: list | None = None) -> Iterator[np.ndarray]:
        """Join the shared loop and return a generator of 24 kHz float32
        waveform chunks.  Validation, the prefill and the row insert happen at
        call time (bad arguments and HubFull raise at once).  ``generator``
        seeds the session as ``synthesize_streaming``'s does (one draw split
        into the AR and the NAR seeds), so a session equals that call's
        stream on the same generator.  ``codes_sink``: an optional list that
        the session's first-codebook token arrays are appended to as they
        arrive."""
        _check_lookahead(lookahead_frames)
        self._check_open()
        if generator is None:
            generator = default_generator(self.tts.config, self.tts.device)
        return self._open(text, prompt_tokens, prompt_codes, int(lookahead_frames),
                          _split_seed(_draw_seed(generator)), bucket, codes_sink)

    def open_longform(self, text: str, prompt_tokens, prompt_codes,
                      lookahead_frames: int = 38, generator: torch.Generator | None = None,
                      max_inflight: int = 2) -> Iterator[np.ndarray]:
        """Pipelined long-form synthesis through the shared loop, the
        counterpart of ``ValleTTS.synthesize_longform(carry='prompt')``: every
        sentence is conditioned on the original prompt, so up to
        ``max_inflight`` sentences decode at once, the later ones buffering
        while the earlier one streams.  Sentence i's seeds are the long-form
        call's (one draw of ``generator`` and i), so greedy output equals
        ``synthesize_longform(carry='prompt')`` on the same generator.

        A sentence whose prompt exceeds the hub geometry, or that finds every
        row busy when its turn comes, streams solo (the same waveform).  Only
        the FIRST sentence raises ``HubFull``.  A drain truncates the stream
        at a sentence boundary.  ``carry='chain'`` needs each sentence's
        refined codes before the next prefill and stays on the solo path."""
        _check_lookahead(lookahead_frames)
        if int(max_inflight) < 1:
            raise ValueError(f'max_inflight must be >= 1, got {max_inflight}')
        self._check_open()
        tts = self.tts
        if generator is None:
            generator = default_generator(tts.config, tts.device)
        base = _draw_seed(generator)
        pt = np.asarray(prompt_tokens, np.int64)
        pc = np.asarray(prompt_codes, np.int64).reshape(-1, tts.config.num_quantizers)
        sentences = split_sentences(text)
        if not sentences:
            return iter(())
        lookahead = int(lookahead_frames)

        def solo(i):
            tokens = np.concatenate([pt, tts.tokenizer(sentences[i])])
            stream, emitter = tts._seeded_stream(tokens, pc, _split_seed(base, i), lookahead)
            return _stream_chunks(stream, emitter, self.chunk_frames, StageClock(tts.device))

        drain = object()           # sentinel: the hub is draining

        def try_open(i):
            """Sentence i on the hub; None = no row free now (retried at the
            next sentence boundary); ``drain`` = stop opening sentences."""
            try:
                return self._open(sentences[i], pt, pc, lookahead, _split_seed(base, i),
                                  True, None)
            except HubDraining:
                return drain
            except HubFull:
                return None
            except ValueError as exc:
                if 'exceed' not in str(exc):
                    raise
                return solo(i)      # the prompt does not fit the hub geometry

        first = try_open(0)
        if first is drain:
            raise HubDraining('hub is draining: not accepting new sessions')
        if first is None:
            raise HubFull(f'all {self.cb.n_slots} hub rows busy')
        gens: dict[int, Iterator] = {0: first}

        def chunks():
            nxt = 1
            try:
                for i in range(len(sentences)):
                    gen_i = gens.pop(i, None)
                    if gen_i is None:
                        gen_i = try_open(i)
                        if gen_i is drain:
                            log_warning('long-form stream truncated at sentence %d/%d: hub '
                                        'draining', i, len(sentences))
                            return
                        gen_i = gen_i or solo(i)
                    gens[i] = gen_i     # visible to the cleanup below
                    while nxt < len(sentences) and nxt - i < max_inflight:
                        g = try_open(nxt)
                        if g is None or g is drain:
                            break           # no row free: retry at the next sentence
                        gens[nxt] = g
                        self.longform_prefetched += 1
                        nxt += 1
                    yield from gen_i
                    gens.pop(i, None)
            finally:
                for g in gens.values():     # the client left: free every row
                    g.close()
                gens.clear()

        return chunks()

    def live_sessions(self) -> int:
        with self._lock:
            return len(self._by_slot)

    def stop(self, drain: bool = False, timeout: float = 600.0) -> None:
        """Stop the driver thread.  ``drain=False``: live sessions end with
        their next chunk.  ``drain=True``: new opens are refused
        (``HubDraining``) while the driver advances until every live row
        finished (each bounded by its budget; ``timeout`` is the hard stop).
        Idempotent."""
        if drain:
            with self._wake:
                self._draining = True
                deadline = time.monotonic() + timeout
                while self._by_slot and not self._stopped:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._wake.wait(remaining)
        with self._wake:
            self._stopped = True
            self._wake.notify_all()
        self._driver.join(timeout=30)

    # -- internals ---------------------------------------------------------

    def _check_open(self) -> None:
        if self._stopped:
            raise HubStopped('hub is stopped')
        if self._draining:
            raise HubDraining('hub is draining: not accepting new sessions')

    def _open(self, text: str, prompt_tokens, prompt_codes, lookahead: int,
              seeds: tuple[int, int], bucket: bool, codes_sink) -> Iterator[np.ndarray]:
        """Join one utterance on its (AR, NAR) seeds; ``open``'s body."""
        self._check_open()
        tts = self.tts
        tokens = np.concatenate([np.asarray(prompt_tokens, np.int64),
                                 tts.tokenizer(text)])
        pcodes = np.asarray(prompt_codes, np.int64).reshape(-1, tts.config.num_quantizers)
        emitter = None
        if not self.batched_nar:
            emitter = _ChunkEmitter(tts, tokens, pcodes, lookahead, seeds[1], bucket)
        # The row stays invisible to the driver (join(start=False)) until the
        # session is registered: an advance in between could otherwise read
        # the previous occupant's finished row as this session's, or deliver
        # tokens that nobody routes.  The session rides as the advance tag.
        sess = _Session(lookahead, tts.config.max_audio_len, sink=codes_sink)
        sess.slot = slot = self.cb.join(tokens, pcodes, start=False,
                                        generator=tts._generator(seeds[0]), tag=sess)
        with self._wake:
            # A stop that landed during the prefill: register nothing the
            # (maybe exited) driver would never advance.
            if self._stopped or self._draining:
                self.cb.release(slot)
                if self._draining and not self._stopped:
                    raise HubDraining('hub is draining: not accepting new sessions')
                raise HubStopped('hub is stopped')
            self._by_slot[slot] = sess
            if emitter is None:
                self._write_nar_prompt(slot, tokens, pcodes)
            self._wake.notify_all()
        try:
            self.cb.activate(slot)
        except KeyError:
            # stop() landed between registration and activation: _fail_all
            # already ended this session and released its row.
            raise HubStopped('hub is stopped') from None

        def chunks():
            try:
                while True:
                    item, done = self._next(sess)
                    wavs = emitter.push(item, done) if emitter is not None else [item]
                    for wav in wavs:
                        if wav is not None and len(wav):
                            yield wav
                    if done:
                        return
            finally:
                self._abort(sess)

        return chunks()

    @staticmethod
    def _next(sess: _Session):
        # The driver feeds every live session each cycle; a long silence
        # means it died: fail the stream rather than hang its consumer.
        try:
            return sess.q.get(timeout=600.0)
        except queue.Empty:
            raise RuntimeError('stream hub driver stalled (no tokens for 600 s)') from None

    def _write_nar_prompt(self, slot: int, tokens: np.ndarray, pcodes: np.ndarray) -> None:
        """Replace slot ``slot``'s device prompt row (under the lock); the
        lengths were checked by ``cb.join`` against the same geometry."""
        dev = self.tts.device
        tok = np.zeros((self._nar_ttm,), np.int64)
        tok[:len(tokens)] = tokens
        pc = np.zeros(self._nar_pcodes.shape[1:], np.int64)
        pc[:len(pcodes)] = pcodes
        at = (torch.tensor([slot], device=dev),)
        self._nar_tokens = self._nar_tokens.index_put(at, torch.from_numpy(tok).to(dev)[None])
        self._nar_tl = self._nar_tl.index_put(
            at, torch.tensor([max(1, len(tokens))], dtype=torch.int32, device=dev))
        self._nar_pcodes = self._nar_pcodes.index_put(at, torch.from_numpy(pc).to(dev)[None])
        self._nar_pl = self._nar_pl.index_put(
            at, torch.tensor([len(pcodes)], dtype=torch.int32, device=dev))

    def _fail_all(self, error: BaseException | None = None) -> None:
        """End every live session (a stop, or a failed advance / refine) and
        release its row (under the lock): a transient failure must not leave
        every slot occupied."""
        if error is not None:
            self.errors.append(error)
        for slot, sess in self._by_slot.items():
            sess.q.put((None, True) if self.batched_nar else (np.zeros(0, np.int64), True))
            try:
                self.cb.release(slot)
            except Exception as e:          # noqa: BLE001 -- keep freeing the others
                log_warning('releasing slot %d after a failure failed (%s: %s)', slot,
                            type(e).__name__, e)
        self._by_slot.clear()
        self._wake.notify_all()             # wake a drain waiter

    def _drive(self) -> None:
        while True:
            with self._wake:
                while not self._by_slot and not self._stopped:
                    self._wake.wait()
                if self._stopped:
                    self._fail_all()
                    return
            turns = self._turns_for_cycle()
            try:
                # tags=True: each row comes back with the session that owned
                # it DURING the advance and its doneness read under the
                # batcher's lock, immune to a release and re-join of the slot.
                out = self.cb.advance(turns, tags=True)
            except Exception as e:          # noqa: BLE001 -- the driver must survive
                log_warning('stream hub advance failed (%s: %s): ending live sessions',
                            type(e).__name__, e)
                with self._lock:
                    self._fail_all(e)
                continue
            self._observe_acceptance(out, turns)
            if self.batched_nar:
                self._route_batched(out)
            else:
                self._route_tokens(out)

    def _turns_for_cycle(self) -> int:
        """The next cycle's advance: ``chunk_frames`` token steps, or, on the
        speculative loop, verify TURNS from the acceptance EMA so that the
        fastest row receives about ``chunk_frames`` tokens; in [1,
        chunk_frames]."""
        if not self._spec:
            return self.chunk_frames
        return max(1, min(self.chunk_frames,
                          round(self.chunk_frames / max(self._accept_ema, 1.0))))

    def _observe_acceptance(self, out: dict, turns: int) -> None:
        """Fold a cycle's tokens per turn into the EMA: the fastest row that
        stayed live through the whole advance (a row that finished mid-cycle
        ran an unknown number of turns)."""
        if not self._spec or not out:
            return
        rates = [len(t) / turns for (_s, t, done) in out.values() if not done]
        if rates:
            self._accept_ema = 0.5 * self._accept_ema + 0.5 * max(rates)

    def _route_tokens(self, out: dict) -> None:
        """batched_nar=False: deliver the raw tokens; the consumers refine."""
        with self._lock:
            for slot, (sess, toks, done) in out.items():
                if self._by_slot.get(slot) is not sess:
                    continue                # aborted between the advance and here
                if sess.sink is not None and len(toks):
                    sess.sink.append(np.asarray(toks, np.int64))
                sess.q.put((toks, done))
                if done:                    # free the row now
                    del self._by_slot[slot]
                    self.cb.release(slot)
            if not self._by_slot:
                self._wake.notify_all()     # wake a drain waiter

    def _route_batched(self, out: dict) -> None:
        """Refine every due session's prefix in one ``_nar_wav`` over all
        rows per width due (each session at its solo emitter's width), then
        deliver the newly final samples.  (1) Under the lock: fold
        the tokens into the sessions' buffers and take the prompts'
        snapshot; (2) the refine, unlocked (the buffers are the driver's
        alone, the prompts are replaced, not written); (3) under the lock:
        deliver, skipping a session aborted meanwhile."""
        n = self.cb.n_slots
        emits: list[tuple[_Session, int, bool]] = []
        finish_only: list[_Session] = []
        with self._lock:
            for slot, (sess, toks, done) in out.items():
                if self._by_slot.get(slot) is not sess:
                    continue
                if sess.sink is not None and len(toks):
                    sess.sink.append(np.asarray(toks, np.int64))
                sess.buf[sess.n:sess.n + len(toks)] = toks
                sess.n += len(toks)
                finalize = finalize_frames(sess.n, done, sess.lookahead)
                if finalize > sess.emitted:
                    emits.append((sess, finalize, done))
                elif done:
                    finish_only.append(sess)
            prompts = (self._nar_tokens, self._nar_tl, self._nar_pcodes, self._nar_pl)

        wavs: dict[int, np.ndarray] = {}
        if emits:
            # Each session refines at its own width, the one its solo
            # emitter picks: one refine per width that is due this cycle
            # (one in the steady state), never a co-tenant's wider one.
            by_width: dict[int, list[_Session]] = {}
            for sess, _, _ in emits:
                width = next(b for b in self._widths if b >= sess.n)
                by_width.setdefault(width, []).append(sess)
            seed = _draw_seed(self._nar_gen)
            try:
                for width, group in by_width.items():
                    first = np.zeros((n, width), np.int64)
                    gen = np.ones((n,), np.int32)   # idle rows: one valid slot
                    for sess in group:
                        first[sess.slot, :sess.n] = sess.buf[:sess.n]
                        gen[sess.slot] = sess.n
                    wav, _codes = self.tts._nar_wav(*prompts, first, gen, seed)
                    for sess in group:
                        wavs[sess.slot] = wav[sess.slot]
            except Exception as e:          # noqa: BLE001 -- the driver must survive
                log_warning('stream hub batched refine failed (%s: %s): ending live '
                            'sessions', type(e).__name__, e)
                with self._lock:
                    self._fail_all(e)
                return

        with self._lock:
            for sess, finalize, done in emits:
                if self._by_slot.get(sess.slot) is not sess:
                    continue                # aborted during the refine
                chunk = wavs[sess.slot][sess.emitted * HOP:finalize * HOP]
                sess.emitted = finalize
                sess.q.put((chunk, done))
            for sess in finish_only:
                if self._by_slot.get(sess.slot) is sess:
                    sess.q.put((None, True))
            for sess in finish_only + [s for s, _, d in emits if d]:
                if self._by_slot.get(sess.slot) is sess:
                    del self._by_slot[sess.slot]
                    self.cb.release(sess.slot)
            if not self._by_slot:
                self._wake.notify_all()     # wake a drain waiter

    def _abort(self, sess: _Session) -> None:
        """The session's generator closed (its consumer left, or it ended):
        free the row, unless the slot already went to another session."""
        with self._lock:
            if self._by_slot.get(sess.slot) is sess:
                del self._by_slot[sess.slot]
                self.cb.release(sess.slot)
            if not self._by_slot:
                self._wake.notify_all()     # wake a drain waiter
