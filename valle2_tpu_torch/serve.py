"""Dynamic-batching TTS serving layer (``valle2_tpu/serve.py``).

Design:

- ``TTSServer`` owns a request queue and one worker thread.  The worker pops
  the first pending request, waits up to ``max_wait_ms`` for more, pads the
  group to a power-of-two **batch bucket** (log2(max_batch)+1 batch shapes x
  the config's length buckets) and drives the whole group through
  ``ValleTTS.batch_synthesize``: one prefill, one decode loop, one NAR and one
  codec pass for the group.
- Per-request results are exact: the pipeline masks every row by its true
  lengths, so at temperature 0 a request's codes equal a solo
  ``synthesize_fused`` call's whatever it was batched with, and its waveform
  agrees to float32 round-off (the codec decodes at another batch size).
- ``serve_http`` exposes the server over stdlib HTTP (JSON in, WAV out).

Threading model: batches run on the worker thread; ``/stream`` sessions on
their HTTP handler threads (or, with ``cb_streams``, in the ``StreamHub``'s
driver thread), ``/transcribe`` on its handler thread.  Every thread launches
on the card's current stream: the persistent decode steps are cooperative
launches sized to the whole card (``kernels.fused_decode.step_grid``), and
two such grids cannot be resident at once, so no server thread gets a CUDA
stream of its own.  ``torch.inference_mode`` is per thread, so each entry
point enters it on the thread it runs on.  Padding rows repeat request 0 and
their outputs are dropped on the host.

TF32 is process-wide (``config.tf32_scope``): a server whose TTS and ASR
configs differ in ``matmul_precision`` runs both at the setting of the
newest open scope.  Give both the same setting.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout
from dataclasses import dataclass, field

import numpy as np
import torch

from .tts import TTSResult, ValleTTS, _split_seed
from .utils import log_info, pcm16, wav_pcm16_bytes


class ServerStopped(RuntimeError):
    """The server is stopped / shutting down (retryable: HTTP 503).  A
    DEDICATED type: catching plain RuntimeError would also swallow the
    RuntimeErrors that CUDA faults raise, misreporting them as retryable."""


class ServerOverloaded(RuntimeError):
    """Load shed: the request queue is full or all stream slots are busy
    (HTTP 429).  Accepting work beyond device throughput would only grow
    latency without bound — reject at the door instead."""


def _safe_set(fut: Future, *, result=None, exc=None) -> None:
    """Resolve a Future, tolerating a client cancel() racing the resolution
    (set_result/set_exception raise InvalidStateError on a cancelled future;
    the worker must survive that, not die)."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except Exception:      # noqa: BLE001 — cancelled/already-resolved: drop
        pass


@dataclass
class ServerStats:
    """Aggregate serving counters (monotonic since ``start``)."""
    requests: int = 0                  # served through the batched pipeline
    stream_requests: int = 0           # served through /stream
    asr_requests: int = 0              # served through /transcribe
    batches: int = 0
    errors: int = 0
    rejected: int = 0                  # load-shed at submit/stream time (429)
    audio_seconds: float = 0.0
    busy_seconds: float = 0.0          # wall time inside batch_synthesize
    # submit -> result per request; bounded window so a long-lived server's
    # stats stay O(1) memory and /stats stays cheap to percentile.
    latencies_ms: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=10000))

    def snapshot(self) -> dict:
        # Called on a COPY (TTSServer.stats) — sorting 10k floats here must
        # never run under the worker's stats lock.
        lat = sorted(self.latencies_ms)
        pct = lambda p: lat[min(len(lat) - 1, int(p * len(lat)))] if lat else 0.0
        return {
            'requests': self.requests,
            'stream_requests': self.stream_requests,
            'asr_requests': self.asr_requests,
            'batches': self.batches,
            'errors': self.errors,
            'rejected': self.rejected,
            'mean_batch_size': self.requests / max(self.batches, 1),
            'audio_seconds': self.audio_seconds,
            'busy_seconds': self.busy_seconds,
            'latency_ms_p50': pct(0.50),
            'latency_ms_p95': pct(0.95),
        }


# /stats keys that are monotonic counts (Prometheus counters, `_total`
# suffix); everything else is exposed as a gauge.
_PROM_COUNTERS = frozenset({'requests', 'stream_requests', 'asr_requests',
                            'batches', 'errors', 'rejected',
                            'audio_seconds', 'busy_seconds',
                            'aot_compiles', 'aot_disk_loads',
                            'aot_fallbacks', 'longform_prefetched'})

_PROM_HELP = {
    'requests': 'Requests served through the batched pipeline',
    'stream_requests': 'Requests served through /stream',
    'asr_requests': 'Requests served through /transcribe',
    'batches': 'Batched pipeline dispatches',
    'errors': 'Requests that ended in an error',
    'rejected': 'Requests load-shed with HTTP 429',
    'audio_seconds': 'Audio synthesized, in seconds',
    'busy_seconds': 'Wall time inside batch_synthesize, in seconds',
    'mean_batch_size': 'Served requests per dispatched batch',
    'latency_ms_p50': 'Submit-to-result latency p50 (bounded window), ms',
    'latency_ms_p95': 'Submit-to-result latency p95 (bounded window), ms',
    'queue_depth': 'Requests currently waiting in the batching queue',
    'queue_oldest_age_s': 'Age of the oldest queued request, seconds',
    'max_queue': 'Queue bound beyond which requests get HTTP 429',
    'aot_compiles': 'Fused-pipeline programs compiled (AOT cache misses)',
    'aot_disk_loads': 'Fused-pipeline executables deserialized from the '
                      'AOT cache (compilation skipped)',
    'aot_fallbacks': 'AOT entries that failed and fell back to plain jit',
    'stream_hub_slots': 'Continuous-batching rows configured (--cb-streams)',
    'stream_hub_live': 'Streaming sessions currently in the shared loop',
    'stream_hub_draining': 'Graceful shutdown in progress: finishing live '
                           'sessions, refusing new ones (503)',
    'longform_prefetched': 'Long-form sentences decoded concurrently with an '
                           'earlier one still streaming (hub pipelining)',
    'voices': 'Registered per-voice weight overrides (multi-voice serving)',
}


def stats_to_prometheus(stats: dict) -> str:
    """Render a ``TTSServer.stats()`` snapshot in the Prometheus text
    exposition format (0.0.4) for ``GET /metrics`` scrapes."""
    lines = []
    for key, value in stats.items():
        kind = 'counter' if key in _PROM_COUNTERS else 'gauge'
        name = f'valle2_{key}' + ('_total' if kind == 'counter' else '')
        if key in _PROM_HELP:
            lines.append(f'# HELP {name} {_PROM_HELP[key]}')
        lines.append(f'# TYPE {name} {kind}')
        lines.append(f'{name} {float(value):g}')
    return '\n'.join(lines) + '\n'


@dataclass
class _Request:
    text: str
    prompt_tokens: np.ndarray
    prompt_codes: np.ndarray
    future: Future
    t_submit: float
    voice: str | None = None           # registered voice name (None = default)


def _in_inference(chunks):
    """Iterate ``chunks`` with each step under ``torch.inference_mode`` on
    the consuming thread (the mode is thread-local)."""
    it = iter(chunks)
    while True:
        with torch.inference_mode():
            try:
                chunk = next(it)
            except StopIteration:
                return
        yield chunk


class TTSServer:
    """Dynamic-batching front end over a ``ValleTTS`` pipeline.

    Usage::

        server = TTSServer(tts, max_batch=8, max_wait_ms=10.0)
        with server:                       # starts the worker thread
            fut = server.submit('hello.', prompt_tokens, prompt_codes)
            result = fut.result()          # TTSResult

    ``max_wait_ms`` trades first-request latency for batching opportunity; 0
    adds no artificial wait (requests already queued while the worker was busy
    still coalesce into one batch).  ``seed`` (default ``tts.config.seed``)
    seeds every batch's generator with ``tts._split_seed(seed, batch index)``.
    """

    def __init__(self, tts: ValleTTS, max_batch: int = 8,
                 max_wait_ms: float = 10.0, seed: int | None = None,
                 max_queue: int = 256, max_streams: int = 1, asr=None,
                 cb_streams: int = 0, cb_geometry: tuple | None = None,
                 cb_speculative: bool = False):
        if int(max_batch) < 1:
            raise ValueError(f'max_batch must be >= 1, got {max_batch}')
        self.tts = tts
        # Optional ValleASRPipeline: enables transcribe() and POST /transcribe.
        self.asr = asr
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        # Load shedding: beyond this many queued requests, submit() raises
        # ServerOverloaded (HTTP 429) instead of growing latency without
        # bound.  0 disables the bound (NOT recommended in production).
        self.max_queue = int(max_queue)
        self.max_streams = int(max_streams)
        # Power-of-two batch buckets: log2(max_batch)+1 batch shapes.
        self.batch_buckets: list[int] = []
        b = 1
        while b < self.max_batch:
            self.batch_buckets.append(b)
            b *= 2
        self.batch_buckets.append(self.max_batch)
        self.seed = int(tts.config.seed if seed is None else seed)
        self._queue: queue.Queue = queue.Queue()
        self._stats = ServerStats()
        self._stats_lock = threading.Lock()
        # Makes submit's stopped-check + enqueue atomic vs stop's set + sentinel
        # put, so the stop sentinel is always the LAST item in the queue and no
        # request can be stranded behind it.
        self._submit_lock = threading.Lock()
        # Bounds concurrent solo streaming sessions (each owns its own
        # DecodeStream cache); batched requests keep flowing on the worker
        # thread meanwhile.  A caller past the bound gets ServerOverloaded
        # (HTTP 429), never an unbounded block holding an HTTP handler thread.
        self._stream_sem = threading.BoundedSemaphore(max(1, self.max_streams))
        # Continuous batching for /stream (stream_hub.py): cb_streams > 0 runs
        # up to that many concurrent sessions through ONE shared decode loop.
        # Sessions whose prompts exceed the hub's geometry (cb_geometry=(ttm,
        # pm), default smallest bucket) fall back to the solo path.
        self._hub = None
        if int(cb_streams) > 0:
            from .stream_hub import StreamHub
            ttm, pm = cb_geometry if cb_geometry else (None, None)
            # cb_speculative: hub sessions decode via n-gram verify turns
            # (requires config.speculative_k >= 2; greedy waveforms unchanged).
            self._hub = StreamHub(tts, n_slots=int(cb_streams), ttm=ttm,
                                  pm=pm, speculative=bool(cb_speculative))
        # Multi-voice serving: name → (ar_params_view | None, nar_params |
        # None, keepalive) weight overrides; requests are grouped by voice
        # inside each collected batch (register_voice / load_voice).
        self._voices: dict[str, tuple] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- voices ----------------------------------------------------------
    def register_voice(self, name: str, ar_params=None, nar_params=None
                       ) -> None:
        """Register merged DENSE weight trees as a named voice.

        ``ar_params``/``nar_params``: full params for the respective model
        (``None`` keeps the default model's for that stage), on the
        pipeline's device.  Under ``weight_dtype='int8'/'int4'`` the AR tree
        is quantized once here into the same view the default pipeline
        serves (``ValleAR.decode_params``).
        """
        if ar_params is None and nar_params is None:
            raise ValueError('register_voice needs ar_params and/or nar_params')
        ar_view = keep = None
        if ar_params is not None:
            from .models import ValleAR
            keep = ValleAR(self.tts.config, params=ar_params, device=self.tts.device)
            ar_view = keep.decode_params       # quantized view when configured
        self._voices[str(name)] = (ar_view, nar_params, keep)
        log_info('Registered voice %r (ar=%s, nar=%s)', name,
                 ar_params is not None, nar_params is not None)

    def load_voice(self, name: str, path) -> None:
        """Register a voice from a LoRA adapter file (``lora.save_adapters``,
        of either package).

        The file may hold one AR adapter tree, or ``{'ar': ..., 'nar': ...}``
        (either key optional).  Merge scale comes from the file's embedded
        ``scale`` (save with ``scale=lora_scale(config)``), falling back to
        this server's config lora_alpha/lora_rank."""
        from . import lora
        from .ops.transformer import map_tree
        tree, scale = lora.load_adapters_with_scale(path)
        tree = map_tree(lambda a: a.to(self.tts.device), tree)
        if set(tree) <= {'ar', 'nar'} and tree:
            ar_ad, nar_ad = tree.get('ar'), tree.get('nar')
        else:
            ar_ad, nar_ad = tree, None
        if scale is None:
            cfg = self.tts.config
            if cfg.lora_rank <= 0:
                raise ValueError(
                    f'{path} embeds no merge scale and the config sets no '
                    'lora_rank/lora_alpha — re-save with '
                    'lora.save_adapters(path, adapters, scale=alpha/rank)')
            scale = lora.lora_scale(cfg)
        with torch.no_grad():
            self.register_voice(
                name,
                lora.merge_lora(self.tts.ar.params, ar_ad, scale) if ar_ad else None,
                lora.merge_lora(self.tts.nar.params, nar_ad, scale) if nar_ad
                else None)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> 'TTSServer':
        assert self._thread is None, 'server already started'
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name='valle-tts-server')
        self._thread.start()
        return self

    def stop(self, drain: bool = True):
        """Stop the worker.  ``drain=True`` serves queued requests first AND
        lets live hub streaming sessions finish (new sessions get 503; each
        live one is bounded by its decode budget); otherwise queued requests
        fail with ServerStopped and live streams end with their next chunk."""
        self._drain = drain
        with self._submit_lock:
            self._stop.set()
            self._queue.put(None)         # wake the worker; always last in queue
        if self._hub is not None:
            self._hub.stop(drain=drain)
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        else:
            # Never started: sweep pre-queued requests on this thread so no
            # Future is stranded.
            self._final_sweep(0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- client API ----------------------------------------------------------
    def submit(self, text: str, prompt_tokens, prompt_codes,
               voice: str | None = None) -> Future:
        """Enqueue one synthesis request; returns a Future[TTSResult].

        Requests may be queued before ``start()`` — they are served as soon as
        the worker comes up.  ``voice``: serve with a registered voice's
        weights (register_voice / load_voice)."""
        if voice is not None and voice not in self._voices:
            raise ValueError(f'unknown voice {voice!r} '
                             f'(registered: {sorted(self._voices)})')
        req = _Request(text, np.asarray(prompt_tokens, np.int64),
                       np.asarray(prompt_codes, np.int64), Future(),
                       time.perf_counter(), voice=voice)
        with self._submit_lock:
            if self._stop.is_set():
                raise ServerStopped('server is stopped')
            if self.max_queue and self._queue.qsize() >= self.max_queue:
                # Only the worker pops concurrently, so qsize() can only
                # over-estimate here — rejection never lets the queue exceed
                # the bound.
                with self._stats_lock:
                    self._stats.rejected += 1
                raise ServerOverloaded(
                    f'request queue full ({self.max_queue}); retry later')
            self._queue.put(req)
        return req.future

    def synthesize(self, text: str, prompt_tokens, prompt_codes,
                   timeout: float | None = None,
                   voice: str | None = None) -> TTSResult:
        """Blocking convenience wrapper around ``submit``."""
        return self.submit(text, prompt_tokens, prompt_codes,
                           voice=voice).result(timeout)

    def stream(self, text: str, prompt_tokens, prompt_codes,
               chunk_frames: int = 75, lookahead_frames: int = 38,
               longform: bool = False, carry: str = 'prompt'):
        """Streaming synthesis: returns a generator of float32 waveform
        chunks produced while the decode runs (``ValleTTS.synthesize_streaming``
        semantics).  Requires ``num_beams == 1``.  Up to ``max_streams``
        solo sessions run concurrently; one more raises ServerOverloaded at
        first iteration instead of blocking the caller's thread.  Argument
        validation happens HERE, at call time.

        ``longform=True`` synthesizes sentence-segmented unbounded text
        (``ValleTTS.synthesize_longform``; ``carry`` picks 'prompt'/'chain').
        Under ``cb_streams``, single streams and prompt-mode long-form ride
        the hub (``StreamHub.open`` / ``open_longform``; a prompt beyond the
        hub geometry streams solo); carry='chain' always streams solo: a
        chained sentence needs its predecessor's refined codes first."""
        if self.tts.config.num_beams != 1:
            raise ValueError('streaming requires num_beams=1 '
                             f'(server config has {self.tts.config.num_beams})')
        if int(chunk_frames) < 1:
            # advance(0) makes no progress: an unvalidated 0 would spin forever.
            raise ValueError(f'chunk_frames must be >= 1, got {chunk_frames}')
        if int(lookahead_frames) < 0:
            raise ValueError(
                f'lookahead_frames must be >= 0, got {lookahead_frames}')
        if carry not in ('prompt', 'chain'):
            raise ValueError(f"carry must be 'prompt' or 'chain', got {carry!r}")
        if self._stop.is_set():
            raise ServerStopped('server is stopped')
        pt = np.asarray(prompt_tokens, np.int64)
        pc = np.asarray(prompt_codes, np.int64)

        if self._hub is not None and (not longform or carry == 'prompt'):
            # Continuous batching: join the shared loop.  chunk_frames is
            # hub-wide, so the per-request value is ignored here; lookahead
            # stays per session.  HubFull maps to 429 at CALL time.
            from .stream_hub import HubDraining, HubFull, HubStopped
            try:
                with torch.inference_mode():
                    if longform:
                        inner = self._hub.open_longform(
                            text, pt, pc, lookahead_frames=int(lookahead_frames))
                    else:
                        inner = self._hub.open(
                            text, pt, pc, lookahead_frames=int(lookahead_frames))
            except (HubDraining, HubStopped) as exc:   # shutdown: 503, retry
                raise ServerStopped(str(exc)) from None
            except HubFull:
                with self._stats_lock:
                    self._stats.rejected += 1
                raise ServerOverloaded(
                    f'all {self._hub.cb.n_slots} hub rows busy; retry later') from None
            except ValueError as exc:
                if 'exceed' not in str(exc):
                    raise
                inner = None         # prompt too big for the hub: solo path
            if inner is not None:
                return self._accounted_stream(inner)

        def gen():
            t0 = time.perf_counter()
            emitted = 0.0
            sr = self.tts.codec.sampling_rate
            # Bounded, near-non-blocking acquire: a stalled stream must never
            # pile up handler threads behind it (they get 429, not a hang).
            if not self._stream_sem.acquire(timeout=0.05):
                with self._stats_lock:
                    self._stats.rejected += 1
                raise ServerOverloaded(
                    f'all {self.max_streams} stream slots busy; retry later')
            try:
                with torch.inference_mode():
                    if longform:
                        inner = self.tts.synthesize_longform(
                            text, pt, pc, carry=carry,
                            chunk_frames=int(chunk_frames),
                            lookahead_frames=int(lookahead_frames))
                    else:
                        inner = self.tts.synthesize_streaming(
                            text, pt, pc, chunk_frames=int(chunk_frames),
                            lookahead_frames=int(lookahead_frames))
                for chunk in _in_inference(inner):
                    emitted += len(chunk) / sr
                    yield chunk
            except Exception:      # GeneratorExit (client gone) ≠ error
                with self._stats_lock:
                    self._stats.errors += 1
                raise
            finally:
                self._stream_sem.release()
                with self._stats_lock:
                    self._stats.stream_requests += 1
                    self._stats.audio_seconds += emitted
                    self._stats.latencies_ms.append(
                        (time.perf_counter() - t0) * 1e3)
        return gen()

    def _accounted_stream(self, inner):
        """Wrap a hub session generator with the same stats accounting the
        solo path does (no stream semaphore — the hub bounds its own rows)."""
        def gen():
            t0 = time.perf_counter()
            emitted = 0.0
            sr = self.tts.codec.sampling_rate
            try:
                for chunk in _in_inference(inner):
                    emitted += len(chunk) / sr
                    yield chunk
            except Exception:      # GeneratorExit (client gone) ≠ error
                with self._stats_lock:
                    self._stats.errors += 1
                raise
            finally:
                close = getattr(inner, 'close', None)
                if close is not None:
                    close()        # frees the hub row on client disconnect
                with self._stats_lock:
                    self._stats.stream_requests += 1
                    self._stats.audio_seconds += emitted
                    self._stats.latencies_ms.append(
                        (time.perf_counter() - t0) * 1e3)
        return gen()

    def transcribe(self, audio, sr: int) -> str:
        """ASR: waveform → English text (requires an ``asr`` pipeline).

        Runs on the caller's thread, on the card's current stream beside the
        batching worker's launches: an ASR decode is one batched loop
        already, so no queueing layer is needed at this request volume."""
        if self.asr is None:
            raise ValueError('server was built without an ASR pipeline '
                             '(pass asr=ValleASRPipeline(...))')
        if self._stop.is_set():
            raise ServerStopped('server is stopped')
        t0 = time.perf_counter()
        try:
            with torch.inference_mode():
                text = self.asr.transcribe(np.asarray(audio, np.float32), int(sr))
        except Exception:
            with self._stats_lock:
                self._stats.errors += 1
            raise
        with self._stats_lock:
            self._stats.asr_requests += 1
            self._stats.latencies_ms.append((time.perf_counter() - t0) * 1e3)
        return text

    def stats(self) -> dict:
        import dataclasses
        with self._stats_lock:             # only the copy happens under lock;
            snap = dataclasses.replace(    # the 10k-element sort runs outside
                self._stats,
                latencies_ms=collections.deque(self._stats.latencies_ms))
        out = snap.snapshot()
        # Live queue health (the two numbers a load balancer needs): depth and
        # the age of the oldest waiting request.  queue.Queue's deque+mutex are
        # stable stdlib internals; the sentinel (None) is skipped.
        now = time.perf_counter()
        with self._queue.mutex:
            pending = [r.t_submit for r in self._queue.queue if r is not None]
        out['queue_depth'] = len(pending)
        out['queue_oldest_age_s'] = (now - min(pending)) if pending else 0.0
        out['max_queue'] = self.max_queue
        out['voices'] = len(self._voices)  # registered weight overrides
        # The fused pipeline's kernel libraries through the caches (aot.py):
        # nvcc builds, loads from disk, entries rebuilt.  The /metrics help
        # texts keep the JAX package's words, so both servers' exports match.
        fused = getattr(self.tts, '_fused_jit', None)
        out['aot_compiles'] = fused.n_compiles if fused is not None else 0
        out['aot_disk_loads'] = fused.n_disk_loads if fused is not None else 0
        out['aot_fallbacks'] = fused.n_fallbacks if fused is not None else 0
        if self._hub is not None:
            out['stream_hub_slots'] = self._hub.cb.n_slots
            out['stream_hub_live'] = self._hub.live_sessions()
            out['stream_hub_draining'] = int(self._hub._draining)
            out['longform_prefetched'] = self._hub.longform_prefetched
        return out

    def warmup(self, all_lengths: bool = False, prompt_frames: int = 8,
               streams: bool = False) -> float:
        """Run every serving shape once before traffic, so that no request
        pays the first launch, which builds the CUDA kernels with nvcc
        (about 70-110 s on an H100) and warms the allocator and cuBLAS.

        Default: one dummy group per **batch bucket** at the smallest length
        buckets.  ``all_lengths=True`` covers every batch bucket x the
        DIAGONAL of the length buckets (token bucket == prompt bucket L for
        each L in ``bucket_sizes``).  ``streams=True`` also runs a solo
        stream and, with ``cb_streams``, a hub session (requires
        ``num_beams == 1``).  Runs on the caller's thread, before or after
        ``start()``.  Returns wall seconds spent."""
        t0 = time.perf_counter()
        nq = self.tts.config.num_quantizers
        pm_buckets = ([min(self.tts.config.bucket_sizes)] if not all_lengths
                      else list(self.tts.config.bucket_sizes))
        n_done = 0
        with torch.inference_mode():
            for pm in pm_buckets:
                # Lengths must LAND in bucket pm (bucket_len picks the smallest
                # bucket >= len), so all_lengths uses pm itself — for BOTH the
                # prompt codes and the token stream (the diagonal).
                pf = pm if all_lengths else min(max(int(prompt_frames), 1), pm)
                codes = np.zeros((pf, nq), np.int64)
                # batch_synthesize appends the tokenized text (a few ids) to the
                # prompt tokens; undershoot so the total stays inside bucket pm.
                n_tok = max(2, pm - 16) if all_lengths else 2
                tokens = np.zeros((n_tok,), np.int64)
                for b in self.batch_buckets:
                    self.tts.batch_synthesize(['warm up.'] * b, [tokens] * b,
                                              [codes] * b)
                    n_done += 1
            if streams:
                if self.tts.config.num_beams != 1:
                    raise ValueError('streams warmup requires num_beams=1')
                pf = min(max(int(prompt_frames), 1), pm_buckets[0])
                gen = self.tts.synthesize_streaming(
                    'warm up.', np.zeros((2,), np.int64), np.zeros((pf, nq), np.int64))
                next(gen, None)            # prefill + a segment + an emission
                n_done += 1
                if self._hub is not None:  # hub path: join + joint advance
                    gen = self._hub.open('warm up.', np.zeros((2,), np.int64),
                                         np.zeros((pf, nq), np.int64))
                    next(gen, None)
                    gen.close()
                    n_done += 1
        dt = time.perf_counter() - t0
        log_info('Warmup: %d pipeline shapes run in %.1f s', n_done, dt)
        return dt

    # -- worker --------------------------------------------------------------
    def _collect_batch(self) -> list[_Request]:
        """Block for the first request, then gather more until ``max_batch`` or
        the ``max_wait_ms`` deadline."""
        first = self._queue.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_ms / 1e3
        while len(batch) < self.max_batch:
            remain = deadline - time.perf_counter()
            try:
                # Past the deadline, still take whatever is already queued.
                req = (self._queue.get(timeout=remain) if remain > 0
                       else self._queue.get_nowait())
            except queue.Empty:
                break
            if req is None:               # stop sentinel: keep flag, finish batch
                self._queue.put(None)
                break
            batch.append(req)
        return batch

    def _serve_batch(self, batch: list[_Request], batch_idx: int):
        """Serve one collected batch — grouped by voice: every group is one
        ``batch_synthesize`` with that voice's weights (a voice-less batch
        behaves exactly as before grouping existed)."""
        groups: dict[str | None, list[_Request]] = {}
        for r in batch:
            groups.setdefault(r.voice, []).append(r)
        for gi, (voice, group) in enumerate(groups.items()):
            self._serve_group(group, batch_idx, gi, voice)

    def _serve_group(self, batch: list[_Request], batch_idx: int,
                     group_idx: int, voice: str | None):
        n = len(batch)
        bucket_n = next(b for b in self.batch_buckets if b >= n)
        # Pad with copies of request 0; padded rows' outputs are dropped.
        padded = batch + [batch[0]] * (bucket_n - n)
        # The group index joins the key ONLY for 2nd+ voice groups:
        # single-voice batches keep one stream of seeds.
        key = (batch_idx, group_idx) if group_idx else (batch_idx,)
        generator = self.tts._generator(_split_seed(self.seed, *key)[0])
        override = None
        if voice is not None:
            ar_view, nar_p, _keep = self._voices[voice]
            override = (ar_view, nar_p)
        t0 = time.perf_counter()
        try:
            results = self.tts.batch_synthesize(
                [r.text for r in padded],
                [r.prompt_tokens for r in padded],
                [r.prompt_codes for r in padded], generator=generator,
                override_params=override)
        except Exception as exc:          # noqa: BLE001 — fail the whole batch
            with self._stats_lock:
                self._stats.errors += n
            for r in batch:
                _safe_set(r.future, exc=exc)
            return
        busy = time.perf_counter() - t0
        now = time.perf_counter()
        secs = 0.0
        for r, res in zip(batch, results[:n]):
            secs += len(res.waveform) / self.tts.codec.sampling_rate
            _safe_set(r.future, result=res)
        with self._stats_lock:
            self._stats.requests += n
            self._stats.batches += 1
            self._stats.audio_seconds += secs
            self._stats.busy_seconds += busy
            self._stats.latencies_ms += [(now - r.t_submit) * 1e3 for r in batch]

    def _fail_batch(self, batch: list, exc: Exception):
        """Resolve a whole batch exceptionally AND account it — a failure the
        stats don't see is an outage monitoring can't."""
        for r in batch:
            _safe_set(r.future, exc=exc)
        now = time.perf_counter()
        with self._stats_lock:
            self._stats.errors += len(batch)
            self._stats.latencies_ms.extend(
                (now - r.t_submit) * 1e3 for r in batch)

    def _final_sweep(self, batch_idx: int):
        """Drain whatever is still queued: the sentinel is always last
        (submit/stop share a lock), so everything here arrived before stop.
        drain=True serves it in max_batch groups; drain=False fails it —
        either way no Future is ever stranded."""
        leftovers: list[_Request] = []
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                leftovers.append(req)
        drain = getattr(self, '_drain', True)
        for i in range(0, len(leftovers), self.max_batch):
            group = leftovers[i:i + self.max_batch]
            if drain:
                try:
                    self._serve_batch(group, batch_idx)
                except Exception as exc:   # noqa: BLE001
                    self._fail_batch(group, exc)
                batch_idx += 1
            else:
                for r in group:
                    _safe_set(r.future, exc=ServerStopped('server stopped'))

    def _worker(self):
        batch_idx = 0
        while not self._stop.is_set():
            batch = self._collect_batch()
            if not batch:                  # woke on the stop sentinel
                break
            try:
                self._serve_batch(batch, batch_idx)
            except Exception as exc:       # noqa: BLE001 — keep the worker alive
                self._fail_batch(batch, exc)
            batch_idx += 1
        self._final_sweep(batch_idx)


# ---------------------------------------------------------------------------
# HTTP front end (stdlib only)
# ---------------------------------------------------------------------------

def serve_http(server: TTSServer, host: str = '127.0.0.1', port: int = 8089,
               block: bool = True, request_timeout_s: float = 600.0):
    """Expose a running ``TTSServer`` over HTTP.

    - ``POST /synthesize`` — JSON body ``{"text": str, "prompt_tokens": [int],
      "prompt_codes": [[int]*nq], "voice": str (optional)}`` → ``audio/wav``
      (24 kHz mono PCM16).
    - ``POST /stream`` — the same body (plus ``chunk_frames``,
      ``lookahead_frames``, ``longform``, ``carry``) → chunked ``audio/L16``.
    - ``POST /transcribe`` — a WAV file or JSON ``{"audio": [float], "sr":
      int}`` → ``{"text": str}``.
    - ``GET /healthz`` → 200 ``ok``.
    - ``GET /stats`` → JSON serving counters.
    - ``GET /metrics`` → the same counters in Prometheus text format.

    ``request_timeout_s`` bounds how long a handler thread waits on the
    batching worker (a hung device otherwise pins handler threads forever);
    expiry returns 504.  ``port=0`` binds a free port; the bound one is
    ``httpd.server_address[1]`` and is logged.

    Returns the ``ThreadingHTTPServer`` (call ``.shutdown()`` to stop) when
    ``block=False``; otherwise serves until SIGTERM / SIGINT.
    """
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class TrackingHTTPServer(ThreadingHTTPServer):
        """ThreadingHTTPServer that records live handler threads, so a
        graceful shutdown can wait (bounded) for response DELIVERY — handler
        threads are daemons the interpreter kills at process exit, which
        would truncate already-computed (especially streamed) responses.
        Its listen backlog holds a burst of clients: at socketserver's
        default of 5, connects of 16 clients at once were reset under load."""

        request_queue_size = 128

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            import weakref
            self.handler_threads = weakref.WeakSet()

        def process_request_thread(self, request, client_address):
            self.handler_threads.add(threading.current_thread())
            super().process_request_thread(request, client_address)

    sr = server.tts.codec.sampling_rate

    class Handler(BaseHTTPRequestHandler):
        # Chunked transfer (POST /stream) requires HTTP/1.1 on the status line
        # — strict clients reject Transfer-Encoding on an HTTP/1.0 response.
        # Safe for the plain routes: _send always emits Content-Length.
        protocol_version = 'HTTP/1.1'

        def log_message(self, *args):      # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == '/healthz':
                self._send(200, b'ok', 'text/plain')
            elif self.path == '/stats':
                self._send(200, json.dumps(server.stats()).encode(),
                           'application/json')
            elif self.path == '/metrics':
                self._send(200, stats_to_prometheus(server.stats()).encode(),
                           'text/plain; version=0.0.4')
            else:
                self._send(404, b'not found', 'text/plain')

        def _do_transcribe(self):
            """ASR: body = a complete WAV file (any Content-Type) or JSON
            {'audio': [float...], 'sr': int} → {'text': ...}."""
            if server.asr is None:
                self._send(501, b'server not configured with an ASR pipeline',
                           'text/plain')
                return
            try:
                length = int(self.headers.get('Content-Length', 0))
                body = self.rfile.read(length)
                if body[:4] == b'RIFF':
                    from .utils import wav_bytes_to_float
                    audio, in_sr = wav_bytes_to_float(body)
                else:
                    payload = json.loads(body)
                    audio = np.asarray(payload['audio'], np.float32)
                    in_sr = int(payload['sr'])
            except Exception as exc:   # noqa: BLE001 — malformed request
                self._send(400, str(exc).encode(), 'text/plain')
                return
            try:
                text = server.transcribe(audio, in_sr)
            except ServerStopped as exc:
                self._send(503, str(exc).encode(), 'text/plain')
                return
            except Exception as exc:   # noqa: BLE001
                self._send(500, str(exc).encode(), 'text/plain')
                return
            self._send(200, json.dumps({'text': text}).encode(),
                       'application/json')

        def _do_stream(self, text, pt, pc, payload):
            """Chunked-transfer raw PCM16 (audio/L16) from the streaming path.
            The first chunk is produced BEFORE headers go out so setup errors
            still map to proper status codes; after that, a mid-stream failure
            truncates the chunked body (the client sees a short read)."""
            try:
                gen = server.stream(
                    text, pt, pc,
                    chunk_frames=int(payload.get('chunk_frames', 75)),
                    lookahead_frames=int(payload.get('lookahead_frames', 38)),
                    longform=bool(payload.get('longform', False)),
                    carry=str(payload.get('carry', 'prompt')))
                first = next(gen, None)
            except (KeyError, ValueError, TypeError) as exc:  # bad args/beams
                self._send(400, str(exc).encode(), 'text/plain')
                return
            except ServerOverloaded as exc:  # all stream slots busy
                self._send(429, str(exc).encode(), 'text/plain')
                return
            except ServerStopped as exc:
                self._send(503, str(exc).encode(), 'text/plain')
                return
            except Exception as exc:       # noqa: BLE001
                self._send(500, str(exc).encode(), 'text/plain')
                return
            self.send_response(200)
            self.send_header('Content-Type',
                             f'audio/L16; rate={sr}; channels=1')
            self.send_header('Transfer-Encoding', 'chunked')
            self.end_headers()

            def write_chunk(wave_chunk):
                # RFC 2586/3551: audio/L16 is NETWORK (big-endian) byte order.
                data = pcm16(wave_chunk, '>i2').tobytes()
                if data:
                    self.wfile.write(f'{len(data):x}\r\n'.encode())
                    self.wfile.write(data)
                    self.wfile.write(b'\r\n')

            try:
                if first is not None:
                    write_chunk(first)
                for chunk in gen:
                    write_chunk(chunk)
                self.wfile.write(b'0\r\n\r\n')
            except (BrokenPipeError, ConnectionResetError):
                pass                       # client went away mid-stream: fine
            finally:
                gen.close()                # releases the stream slot / hub row

        def do_POST(self):
            if self.path == '/transcribe':
                self._do_transcribe()
                return
            if self.path not in ('/synthesize', '/stream'):
                self._send(404, b'not found', 'text/plain')
                return
            try:
                length = int(self.headers.get('Content-Length', 0))
                payload = json.loads(self.rfile.read(length))
                text = payload['text']
                pt = np.asarray(payload['prompt_tokens'], np.int64)
                pc = np.asarray(payload['prompt_codes'], np.int64)
            except Exception as exc:       # noqa: BLE001 — malformed request
                self._send(400, str(exc).encode(), 'text/plain')
                return
            if self.path == '/stream':
                if payload.get('voice') is not None:
                    # Streaming runs through the shared DecodeStream/hub
                    # models, which hold the DEFAULT weights.
                    self._send(400, b'voice is not supported on /stream',
                               'text/plain')
                    return
                self._do_stream(text, pt, pc, payload)
                return
            try:
                result = server.synthesize(text, pt, pc,
                                           timeout=request_timeout_s,
                                           voice=payload.get('voice'))
            except ValueError as exc:      # unknown voice / bad request
                self._send(400, str(exc).encode(), 'text/plain')
                return
            except ServerOverloaded as exc:  # queue full: shed load
                self._send(429, str(exc).encode(), 'text/plain')
                return
            except ServerStopped as exc:   # retryable: shutting down
                self._send(503, str(exc).encode(), 'text/plain')
                return
            except (TimeoutError, FuturesTimeout) as exc:
                self._send(504, str(exc).encode() or b'timeout', 'text/plain')
                return
            except Exception as exc:       # noqa: BLE001 — server-side failure
                self._send(500, str(exc).encode(), 'text/plain')
                return
            self._send(200, wav_pcm16_bytes(result.waveform, sr), 'audio/wav')

    httpd = TrackingHTTPServer((host, port), Handler)
    log_info('TTS HTTP server on http://%s:%d', host, httpd.server_address[1])
    if block:
        # Graceful termination: SIGTERM/SIGINT stop the accept loop (from a
        # helper thread — httpd.shutdown() blocks until serve_forever returns,
        # so calling it inline in the handler would deadlock), serve_forever
        # returns, and the caller's ``with server:`` exit then DRAINS queued
        # requests before the process ends (TTSServer.stop(drain=True)).  The
        # signal module only allows handler installation on the main thread;
        # anywhere else keeps the default disposition.
        import signal

        def _graceful(signum, _frame):
            log_info('received %s — closing listener, draining in-flight '
                     'requests', signal.Signals(signum).name)
            threading.Thread(target=httpd.shutdown, daemon=True,
                             name='valle2-http-shutdown').start()

        installed: dict = {}
        try:
            for s in (signal.SIGTERM, signal.SIGINT):
                installed[s] = signal.signal(s, _graceful)
        except ValueError:                 # not the main thread
            installed.clear()
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()           # release the port during drain
            for s, prev in installed.items():
                signal.signal(s, prev)
    else:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def join_handler_threads(httpd, timeout: float = 60.0) -> bool:
    """Wait (bounded) for in-flight HTTP handler threads to finish DELIVERING
    their responses.  Call after the worker/hub have drained (their results
    are what the handlers are writing); returns False if some handler was
    still alive at the deadline.  No-op for servers not built by
    ``serve_http`` (no ``handler_threads`` attribute)."""
    deadline = time.monotonic() + timeout
    threads = list(getattr(httpd, 'handler_threads', ()))
    for t in threads:
        if t is threading.current_thread():
            continue
        t.join(max(0.0, deadline - time.monotonic()))
    return all(not t.is_alive() for t in threads
               if t is not threading.current_thread())


def main(argv=None):
    """CLI: serve TTS over HTTP with dynamic batching.

    python -m valle2_tpu_torch.serve -c cfg.json --port 8089 \\
        [--ar-ckpt PATH --nar-ckpt PATH --codec-ckpt FILE] \\
        [--max-batch 8 --max-wait-ms 10] [--device cuda|cpu] [--seed N] \\
        [--compile-cache DIR] [--aot-cache DIR]
    """
    import argparse
    from pathlib import Path

    from .codec import Encodec
    from .config import ConfigValle

    parser = argparse.ArgumentParser(description='VALL-E X serving (PyTorch/CUDA)')
    parser.add_argument('-c', '--config', type=Path, default=None)
    parser.add_argument('--host', type=str, default='127.0.0.1')
    parser.add_argument('--port', type=int, default=8089,
                        help='0 binds a free port (logged)')
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (default: the card; raises without one) or 'cpu'")
    parser.add_argument('--seed', type=int, default=None,
                        help='Seed of the model init and the batches (default: the config\'s)')
    parser.add_argument('--max-batch', type=int, default=8)
    parser.add_argument('--max-wait-ms', type=float, default=10.0)
    parser.add_argument('--max-queue', type=int, default=256,
                        help='Queued requests beyond this get HTTP 429 (0 = unbounded)')
    parser.add_argument('--max-streams', type=int, default=1,
                        help='Concurrent /stream sessions; extras get HTTP 429')
    parser.add_argument('--request-timeout-s', type=float, default=600.0,
                        help='Per-request wait bound on the batching worker (504 on expiry)')
    parser.add_argument('--drain-timeout-s', type=float, default=60.0,
                        help='On SIGTERM/SIGINT: grace window for in-flight '
                             'responses (incl. streams) to finish delivering '
                             'after the worker/hub drain')
    parser.add_argument('--warmup', action='store_true',
                        help='Run one pipeline shape per batch bucket before serving '
                             '(the first launch builds the CUDA kernels)')
    parser.add_argument('--warmup-streams', action='store_true',
                        help='Also run the streaming path (needs num_beams=1)')
    parser.add_argument('--warmup-all-lengths', action='store_true',
                        help='Warm every (batch bucket x length bucket) shape (slow, thorough)')
    parser.add_argument('--ar-ckpt', type=Path, default=None,
                        help='AR params file or trainer step dir')
    parser.add_argument('--nar-ckpt', type=Path, default=None,
                        help='NAR params file or trainer step dir')
    parser.add_argument('--codec-ckpt', type=Path, default=None,
                        help='Pretrained EnCodec torch checkpoint to convert')
    parser.add_argument('--asr', action='store_true',
                        help='Enable POST /transcribe (audio -> text).  TF32 is '
                             'process-wide: give the TTS and ASR configs the same '
                             'matmul_precision, or both run at the newer scope\'s')
    parser.add_argument('--asr-ckpt', type=Path, default=None,
                        help='ASR-direction AR checkpoint (implies --asr)')
    parser.add_argument('--cb-streams', type=int, default=0,
                        help='Continuous batching for /stream: run up to N '
                             'concurrent sessions through ONE shared decode '
                             'loop (stream_hub.py).  0 = off (each session '
                             'gets its own DecodeStream, bounded by '
                             '--max-streams).  Oversized prompts fall back to '
                             'the solo path automatically')
    parser.add_argument('--cb-geometry', type=int, nargs=2, default=None,
                        metavar=('TTM', 'PM'),
                        help='Hub prompt geometry: token / code slots per row '
                             '(default: smallest config bucket).  Prompts '
                             'beyond it use the solo path')
    parser.add_argument('--cb-spec', action='store_true',
                        help='Speculative continuous batching: hub sessions '
                             'decode via n-gram verify turns (requires '
                             'config.speculative_k >= 2; waveforms unchanged)')
    parser.add_argument('--voice', action='append', default=[],
                        metavar='NAME=ADAPTERS.npz',
                        help='Register a named voice from a LoRA adapter file '
                             '(lora.save_adapters; repeatable).  Requests '
                             'select it with "voice": NAME; the base weights '
                             'stay the default voice')
    parser.add_argument('--compile-cache', type=Path, default=None,
                        help='Kernel-build cache dir: the CUDA libraries are built and found '
                             'there, so a restarted server skips nvcc (also '
                             '$VALLE2_COMPILE_CACHE / config.compile_cache_dir; default '
                             'valle2_tpu_torch/_build)')
    parser.add_argument('--aot-cache', type=Path, default=None,
                        help='AOT library dir, searched before the kernel-build cache and '
                             'filled after a build: ship it with a deployment (also '
                             '$VALLE2_AOT_CACHE / config.aot_cache_dir).  /stats reports '
                             'the aot_* counters')
    args = parser.parse_args(argv)

    config = ConfigValle.from_json(args.config) if args.config else ConfigValle()
    from .aot import enable_aot_cache
    from .compile_cache import enable_compilation_cache
    enable_compilation_cache(args.compile_cache, fallback=config.compile_cache_dir)
    enable_aot_cache(args.aot_cache, fallback=config.aot_cache_dir)
    if args.seed is not None:
        config.seed = args.seed
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA card is available: pass --device cpu to serve on the CPU')
    codec = Encodec(checkpoint=str(args.codec_ckpt) if args.codec_ckpt else None,
                    decode_dtype=config.dtype, device=device)
    tts = ValleTTS(config, codec=codec, device=device)
    if args.ar_ckpt:
        tts.ar.load(args.ar_ckpt)
    if args.nar_ckpt:
        tts.nar.load(args.nar_ckpt)
    asr = None
    if args.asr or args.asr_ckpt:
        from .tts import ValleASRPipeline
        asr = ValleASRPipeline(config, codec=codec, device=device)
        if args.asr_ckpt:
            asr.ar.load(args.asr_ckpt)
    server = TTSServer(tts, max_batch=args.max_batch,
                       max_wait_ms=args.max_wait_ms,
                       max_queue=args.max_queue, max_streams=args.max_streams,
                       asr=asr, cb_streams=args.cb_streams,
                       cb_geometry=tuple(args.cb_geometry)
                       if args.cb_geometry else None,
                       cb_speculative=args.cb_spec)
    for spec in args.voice:
        name, _, path = spec.partition('=')
        if not path:
            parser.error(f'--voice expects NAME=ADAPTERS.npz, got {spec!r}')
        server.load_voice(name, path)
    if args.warmup or args.warmup_all_lengths or args.warmup_streams:
        # Before the port opens: the first real request must not pay the
        # kernels' build.
        server.warmup(all_lengths=args.warmup_all_lengths,
                      streams=args.warmup_streams)
    with server:
        httpd = serve_http(server, host=args.host, port=args.port,
                           request_timeout_s=args.request_timeout_s)
    # Worker queue and hub rows are drained; now wait (bounded) for handler
    # threads to finish WRITING those results to their sockets — they are
    # daemon threads the interpreter would otherwise kill at exit, cutting
    # streamed audio mid-response.
    if not join_handler_threads(httpd, timeout=args.drain_timeout_s):
        log_info('drain window (%.0fs) expired with responses still in '
                 'flight', args.drain_timeout_s)


if __name__ == '__main__':
    main()
