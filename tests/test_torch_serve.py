"""The port's serving layer (``valle2_tpu_torch.serve``) against solo synthesis
and against the JAX package's ``TTSServer`` (float32, d=32, 2 layers, the
weights of one JAX init carried by the state-dict converters): batched
requests == solo ``synthesize_fused`` (codes exact, waveform atol 2e-5: the
codec decodes at another batch size), one batch of 3 == JAX ``TTSServer``'s
codes (waveforms within the port's waveform tolerance against JAX, 1e-4,
``test_torch_tts.py``); padding to the batch bucket, drain / no-drain / stop
before start / submit after stop, a cancelled future, 16 submitting
threads, load shedding (429, 504); the HTTP routes (``/synthesize``,
``/healthz``, ``/stats``, ``/metrics`` == JAX ``stats_to_prometheus``,
``/stream`` solo, long-form and through the hub, the oversized-prompt
fallback, ``/transcribe``), ``warmup`` and the CLI in a subprocess.  PCM16
comparisons allow 1e-4 (the 16-bit step is 3.1e-5)."""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import wave
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_port_helpers import SMALL, close, make_requests, serving_tts, serving_weights
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu import serve as jserve
from valle2_tpu import tts as jtts
from valle2_tpu.codec import encodec as jenc
from valle2_tpu.config import ConfigValle as JConfig
from valle2_tpu.models import ValleAR as JValleAR
from valle2_tpu.models import ValleNAR as JValleNAR
from valle2_tpu_torch import tts as ttts
from valle2_tpu_torch.config import ConfigValle
from valle2_tpu_torch.serve import (ServerOverloaded, ServerStopped, TTSServer,
                                    join_handler_threads, serve_http, stats_to_prometheus)
from valle2_tpu_torch.utils import wav_pcm16_bytes

TINY = dict(SMALL, max_audio_len=12, num_beams=2, temperature=0.0, bucket_sizes=(32, 64, 128))
BATCH_ATOL = 2e-5        # batched vs solo waveform: the codec at another batch size
WAV_ATOL = 1e-4          # the port's waveform tolerance against JAX (test_torch_tts.py)
PCM_ATOL = 1e-4          # a PCM16 response against the float waveform
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope='module')
def weights():
    """JAX AR, NAR and codec params and their port copies."""
    return serving_weights(TINY)


def port_tts(weights, **over) -> ttts.ValleTTS:
    return serving_tts(weights, dict(TINY, **over))


@pytest.fixture(scope='module')
def tts(weights):
    return port_tts(weights)


@pytest.fixture(scope='module')
def tts1(weights):
    return port_tts(weights, num_beams=1)


@pytest.fixture(scope='module')
def solo(tts):
    """Solo synthesize_fused results, computed once per request."""
    cache = {}

    def get(req):
        key = (req[0], req[1].tobytes(), req[2].tobytes())
        if key not in cache:
            cache[key] = tts.synthesize_fused(*req)
        return cache[key]
    return get


def assert_matches(got, want, atol=BATCH_ATOL):
    np.testing.assert_array_equal(got.codes, want.codes)
    close(got.waveform, want.waveform, atol=atol)


def post(base, path, payload, timeout=120):
    data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    return urllib.request.urlopen(urllib.request.Request(f'{base}{path}', data=data),
                                  timeout=timeout)


def http_code(base, path, payload) -> int:
    try:
        return post(base, path, payload, timeout=60).status
    except urllib.error.HTTPError as e:
        return e.code


def body(req, **kw):
    text, pt, pc = req
    return dict(text=text, prompt_tokens=pt.tolist(), prompt_codes=pc.tolist(), **kw)


class HTTP:
    """``serve_http(server, port=0, block=False)`` for a with-block."""

    def __init__(self, server, **kw):
        self.httpd = serve_http(server, port=0, block=False, **kw)
        self.base = f'http://127.0.0.1:{self.httpd.server_address[1]}'

    def __enter__(self):
        return self.base

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()


def pcm_of(resp) -> np.ndarray:
    with wave.open(io.BytesIO(resp.read()), 'rb') as w:
        assert w.getframerate() == 24000
        return np.frombuffer(w.readframes(w.getnframes()), '<i2') / 32767.0


def collect(chunks) -> np.ndarray:
    out = [np.asarray(c) for c in chunks]
    return np.concatenate(out) if out else np.zeros((0,), np.float32)


# -- the batching server -----------------------------------------------------

def test_batched_requests_match_solo(tts, solo):
    """3 pre-queued requests serve as one padded batch whose rows equal solo
    synthesize_fused (codes exact)."""
    reqs = make_requests(3, seed=1)
    server = TTSServer(tts, max_batch=4, max_wait_ms=200.0)
    futs = [server.submit(*r) for r in reqs]
    with server:
        results = [f.result(timeout=120) for f in futs]
    stats = server.stats()
    assert stats['requests'] == 3 and stats['batches'] == 1
    assert stats['aot_compiles'] == stats['aot_disk_loads'] == stats['aot_fallbacks'] == 0
    for r, got in zip(reqs, results):
        assert_matches(got, solo(r))


def test_server_batch_matches_the_jax_server(weights, tts):
    """One batch of 3 requests through the port's TTSServer and through JAX
    ``TTSServer`` on the same weights: codes equal, waveforms within 1e-4."""
    reqs = make_requests(3, seed=1)
    jcfg = JConfig(**TINY)
    ar_p, nar_p, codec_p = weights[0]
    jt = jtts.ValleTTS(jcfg, ar=JValleAR(jcfg, params=ar_p), nar=JValleNAR(jcfg, params=nar_p),
                       codec=jenc.EncodecTPU(params=codec_p))
    jserver = jserve.TTSServer(jt, max_batch=4, max_wait_ms=200.0)
    jfuts = [jserver.submit(*r) for r in reqs]
    with jserver:
        want = [f.result(timeout=600) for f in jfuts]
    server = TTSServer(tts, max_batch=4, max_wait_ms=200.0)
    futs = [server.submit(*r) for r in reqs]
    with server:
        got = [f.result(timeout=120) for f in futs]
    assert jserver.stats()['batches'] == server.stats()['batches'] == 1
    for g, w in zip(got, want):
        assert_matches(g, w, atol=WAV_ATOL)


def test_padding_to_the_batch_bucket(tts, monkeypatch):
    """3 requests pad to the 4-bucket; outputs and counters ignore pad rows."""
    sizes = []
    real = tts.batch_synthesize
    monkeypatch.setattr(tts, 'batch_synthesize',
                        lambda texts, *a, **kw: sizes.append(len(texts)) or real(texts, *a, **kw))
    server = TTSServer(tts, max_batch=8, max_wait_ms=100.0)
    assert server.batch_buckets == [1, 2, 4, 8]
    futs = [server.submit(*r) for r in make_requests(3, seed=2)]
    with server:
        out = [f.result(timeout=120) for f in futs]
    assert sizes == [4] and len(out) == 3 and server.stats()['requests'] == 3
    assert TTSServer(tts, max_batch=6).batch_buckets == [1, 2, 4, 6]
    with pytest.raises(ValueError, match='max_batch'):
        TTSServer(tts, max_batch=0)


def test_sequential_requests_serve_alone_with_the_same_seed_stream(tts):
    """max_wait_ms=0: each request that arrives alone serves alone; the
    batches' generators follow the server's seed and batch index."""
    server = TTSServer(tts, max_batch=4, max_wait_ms=0.0, seed=11)
    r = make_requests(1, seed=3)[0]
    with server:
        a = server.synthesize(*r, timeout=120)
        b = server.synthesize(*r, timeout=120)
    np.testing.assert_array_equal(a.codes, b.codes)
    stats = server.stats()
    assert stats['batches'] == 2 and stats['requests'] == 2 and stats['latency_ms_p50'] > 0
    assert server.seed == 11 and TTSServer(tts).seed == tts.config.seed


def test_stop_drains_pending(tts):
    server = TTSServer(tts, max_batch=2, max_wait_ms=0.0)
    futs = [server.submit(*r) for r in make_requests(3, seed=4)]
    server.start()
    server.stop(drain=True)
    for f in futs:
        assert f.result(timeout=1).waveform.ndim == 1


def test_stop_without_drain_fails_pending(tts):
    """drain=False: queued-but-unserved requests get ServerStopped, never a
    stranded Future."""
    server = TTSServer(tts, max_batch=2, max_wait_ms=0.0)
    futs = [server.submit(*r) for r in make_requests(3, seed=14)]
    server.start()
    server.stop(drain=False)
    for f in futs:
        try:
            f.result(timeout=1)        # early ones may have been served
        except ServerStopped as exc:
            assert 'stopped' in str(exc)
    assert all(f.done() for f in futs)


def test_stop_before_start_resolves_queued(tts):
    server = TTSServer(tts, max_batch=2, max_wait_ms=0.0)
    futs = [server.submit(*r) for r in make_requests(2, seed=15)]
    server.stop(drain=True)
    for f in futs:
        assert f.result(timeout=1).waveform.ndim == 1    # served on this thread
    with pytest.raises(ServerStopped):
        server.submit(*make_requests(1, seed=16)[0])


def test_submit_after_stop_raises(tts):
    server = TTSServer(tts, max_batch=2)
    server.start()
    server.stop()
    with pytest.raises(ServerStopped):
        server.submit(*make_requests(1, seed=5)[0])


def test_cancelled_future_does_not_kill_the_worker(tts):
    server = TTSServer(tts, max_batch=2, max_wait_ms=0.0)
    fut = server.submit(*make_requests(1, seed=8)[0])   # queued before start
    assert fut.cancel()
    with server:
        res = server.synthesize(*make_requests(1, seed=9)[0], timeout=120)
    assert res.waveform.ndim == 1 and server.stats()['requests'] == 2


def test_sixteen_threads_submitting_at_once_all_served_exactly(tts, solo):
    """16 client threads at once, the interpreter switching threads often:
    every request served once, each equal to its solo run."""
    reqs = make_requests(16, seed=7)
    out, lock, start = {}, threading.Lock(), threading.Barrier(16)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with TTSServer(tts, max_batch=8, max_wait_ms=20.0) as server:
            def client(r):
                start.wait()
                res = server.synthesize(*r, timeout=120)
                with lock:
                    out[r[0]] = res
            threads = [threading.Thread(target=client, args=(r,)) for r in reqs]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert len(out) == 16
    for r in reqs:
        assert_matches(out[r[0]], solo(r))
    stats = server.stats()
    assert stats['requests'] == 16 and 2 <= stats['batches'] <= 16 and stats['errors'] == 0


def test_queue_full_rejects(tts):
    server = TTSServer(tts, max_batch=4, max_queue=2)   # worker not started
    reqs = make_requests(3, seed=20)
    f0, f1 = server.submit(*reqs[0]), server.submit(*reqs[1])
    with pytest.raises(ServerOverloaded, match='queue full'):
        server.submit(*reqs[2])
    stats = server.stats()
    assert stats['rejected'] == 1 and stats['queue_depth'] == 2 and stats['max_queue'] == 2
    assert stats['queue_oldest_age_s'] > 0.0
    with server:
        assert f0.result(timeout=120).waveform.ndim == 1
        assert f1.result(timeout=120).waveform.ndim == 1
    assert server.stats()['queue_depth'] == 0


def test_http_429_and_504_when_the_worker_stalls(tts):
    """Worker never started = a stalled card: the first request times out
    (504), the second is shed (429): no handler thread hangs."""
    server = TTSServer(tts, max_batch=4, max_queue=1)
    req = body(make_requests(1, seed=21)[0])
    codes = {}
    try:
        with HTTP(server, request_timeout_s=1.0) as base:
            t1 = threading.Thread(target=lambda: codes.update(
                first=http_code(base, '/synthesize', req)))
            t1.start()
            deadline = time.time() + 10
            while server.stats()['queue_depth'] < 1:
                assert time.time() < deadline, 'request never queued'
                time.sleep(0.01)
            codes['second'] = http_code(base, '/synthesize', req)
            t1.join(timeout=30)
    finally:
        server.stop(drain=False)
    assert codes == {'first': 504, 'second': 429}


# -- HTTP --------------------------------------------------------------------

def test_http_synthesize_healthz_stats_and_metrics(tts, solo):
    req = make_requests(1, seed=6)[0]
    with TTSServer(tts, max_batch=2, max_wait_ms=0.0) as server, HTTP(server) as base:
        assert urllib.request.urlopen(f'{base}/healthz').read() == b'ok'
        resp = post(base, '/synthesize', body(req))
        assert resp.headers['Content-Type'] == 'audio/wav'
        close(pcm_of(resp), solo(req).waveform, atol=PCM_ATOL)
        stats = json.loads(urllib.request.urlopen(f'{base}/stats').read())
        resp = urllib.request.urlopen(f'{base}/metrics')
        assert resp.headers['Content-Type'].startswith('text/plain')
        metrics = resp.read().decode()
        assert http_code(base, '/synthesize', b'{}') == 400      # malformed
        assert http_code(base, '/nothing', b'{}') == 404
    assert stats['requests'] == 1 and stats['voices'] == 0
    # The scrape is JAX's rendering of the same counters.
    assert metrics == jserve.stats_to_prometheus(stats)
    assert 'valle2_requests_total 1' in metrics.splitlines()


@pytest.mark.parametrize('stats', [
    {'requests': 3, 'errors': 0, 'latency_ms_p50': 12.5, 'queue_depth': 2},
    {k: i * 1.5 for i, k in enumerate(sorted(jserve._PROM_HELP))},
    {'unknown_gauge': 7, 'rejected': 1e-9}], ids=['few', 'every_key', 'no_help'])
def test_prometheus_text_equals_jax(stats):
    assert stats_to_prometheus(stats) == jserve.stats_to_prometheus(stats)


def test_stats_keys_and_metric_tables_equal_jax(tts):
    from valle2_tpu_torch import serve as tserve
    assert tserve._PROM_COUNTERS == jserve._PROM_COUNTERS
    assert tserve._PROM_HELP == jserve._PROM_HELP
    keys = set(TTSServer(tts).stats())
    assert keys == set(jserve.ServerStats().snapshot()) | {
        'queue_depth', 'queue_oldest_age_s', 'max_queue', 'voices', 'aot_compiles',
        'aot_disk_loads', 'aot_fallbacks'}


def test_http_stream_matches_the_direct_generator(tts1):
    req = make_requests(1, seed=10)[0]
    direct = collect(tts1.synthesize_streaming(*req, chunk_frames=5, lookahead_frames=3))
    with TTSServer(tts1, max_batch=2, max_wait_ms=0.0) as server, HTTP(server) as base:
        resp = post(base, '/stream', body(req, chunk_frames=5, lookahead_frames=3))
        assert resp.headers['Content-Type'].startswith('audio/L16')
        pcm = np.frombuffer(resp.read(), '>i2') / 32767.0   # urllib de-chunks
        assert http_code(base, '/stream', body(req, chunk_frames=0)) == 400
        with pytest.raises(ValueError, match='chunk_frames'):
            server.stream(*req, chunk_frames=0)                # at call time
        stats = server.stats()
    assert len(pcm) == len(direct) > 0
    close(pcm, direct, atol=PCM_ATOL)
    assert stats['stream_requests'] == 1 and stats['requests'] == 0 and stats['errors'] == 0
    assert abs(stats['audio_seconds'] - len(direct) / 24000) < 1e-9


def test_http_stream_longform_matches_the_direct_generator(tts1):
    _, pt, pc = make_requests(1, seed=14)[0]
    text = 'go on. stop now.'
    direct = collect(tts1.synthesize_longform(text, pt, pc, carry='chain', chunk_frames=5,
                                              lookahead_frames=3))
    with TTSServer(tts1, max_batch=2, max_wait_ms=0.0) as server, HTTP(server) as base:
        resp = post(base, '/stream', body((text, pt, pc), chunk_frames=5, lookahead_frames=3,
                                          longform=True, carry='chain'))
        pcm = np.frombuffer(resp.read(), '>i2') / 32767.0
        assert http_code(base, '/stream', body((text, pt, pc), longform=True,
                                               carry='sideways')) == 400
    assert len(pcm) == len(direct) > 0
    close(pcm, direct, atol=PCM_ATOL)


def test_stream_rejected_with_beams(tts):
    with TTSServer(tts, max_batch=2) as server, HTTP(server) as base:
        assert http_code(base, '/stream', body(make_requests(1, seed=11)[0])) == 400


def test_concurrent_streams_and_overflow(tts1):
    """max_streams=2: two sessions interleave; a third is rejected while they
    hold the slots, then succeeds after; interleaving changes no sample."""
    req = make_requests(1, seed=22)[0]
    want = collect(tts1.synthesize_streaming(*req, chunk_frames=4, lookahead_frames=2))
    kw = dict(chunk_frames=4, lookahead_frames=2)
    with TTSServer(tts1, max_batch=2, max_streams=2) as server:
        g1, g2 = server.stream(*req, **kw), server.stream(*req, **kw)
        c1, c2 = [next(g1)], [next(g2)]
        g3 = server.stream(*req, **kw)
        with pytest.raises(ServerOverloaded, match='stream slots'):
            next(g3)
        assert server.stats()['rejected'] == 1
        c1 += list(g1)
        c2 += list(g2)
        c3 = list(server.stream(*req, **kw))
    for chunks in (c1, c2, c3):
        np.testing.assert_array_equal(np.concatenate(chunks), want)
    assert server.stats()['stream_requests'] == 3


def test_stream_through_the_hub_fallback_and_429(tts1):
    """cb_streams: /stream joins the hub (== solo streaming at the hub's
    chunk cadence, to float32 round-off); a prompt beyond the hub geometry
    streams solo at its own cadence; a full hub is 429."""
    req = make_requests(1, seed=23)[0]
    with TTSServer(tts1, max_batch=2, cb_streams=1, cb_geometry=(32, 8)) as server, \
            HTTP(server) as base:
        chunk = server._hub.chunk_frames
        pcm = np.frombuffer(post(base, '/stream', body(req, lookahead_frames=3)).read(),
                            '>i2') / 32767.0
        big = (req[0], req[1], np.tile(req[2], (3, 1)))          # 12+ frames > pm
        big_pcm = np.frombuffer(post(base, '/stream', body(big, chunk_frames=5,
                                                           lookahead_frames=3)).read(),
                                '>i2') / 32767.0
        stats = server.stats()
        server._hub.cb.join(req[1], req[2])   # a row no session owns: the hub is full
        assert http_code(base, '/stream', body(req)) == 429
        assert server.stats()['rejected'] == 1
    assert stats['stream_hub_slots'] == 1 and stats['stream_requests'] == 2
    assert stats['stream_hub_live'] == 0 and stats['stream_hub_draining'] == 0
    want = collect(tts1.synthesize_streaming(*req, chunk_frames=chunk, lookahead_frames=3))
    close(pcm, want, atol=PCM_ATOL)
    want_big = collect(tts1.synthesize_streaming(*big, chunk_frames=5, lookahead_frames=3))
    assert len(big_pcm) == len(want_big) > 0
    close(big_pcm, want_big, atol=PCM_ATOL)


def test_transcribe_round_trip():
    """POST /transcribe with WAV bytes and with JSON audio: the JSON path
    gives the pipeline's own text; stats count all three."""
    from valle2_tpu_torch.tts import ValleASRPipeline
    cfg = ConfigValle(**dict(TINY, num_beams=1, vocab_size=70))
    asr = ValleASRPipeline(cfg, device='cpu')
    tts = ttts.ValleTTS(ConfigValle(**dict(TINY, num_beams=1)), codec=asr.codec, device='cpu')
    wav = (np.random.RandomState(31).randn(4800) * 0.1).astype(np.float32)
    want = asr.transcribe(wav, 24000)
    with TTSServer(tts, max_batch=2, asr=asr) as server, HTTP(server) as base:
        assert server.transcribe(wav, 24000) == want
        out = json.loads(post(base, '/transcribe', wav_pcm16_bytes(wav, 24000)).read())
        assert isinstance(out['text'], str)
        out2 = json.loads(post(base, '/transcribe', {'audio': wav.tolist(), 'sr': 24000}).read())
        assert http_code(base, '/transcribe', b'not json') == 400
    assert out2['text'] == want
    stats = server.stats()
    assert stats['asr_requests'] == 3 and stats['errors'] == 0


def test_transcribe_without_an_asr_pipeline_is_501(tts):
    with TTSServer(tts, max_batch=2) as server, HTTP(server) as base:
        with pytest.raises(ValueError, match='ASR'):
            server.transcribe(np.zeros(2400, np.float32), 24000)
        assert http_code(base, '/transcribe', b'RIFFxxxx') == 501


def test_warmup_runs_every_batch_bucket_and_the_streams(tts, tts1, monkeypatch):
    sizes = []
    for t in (tts, tts1):
        real = t.batch_synthesize
        monkeypatch.setattr(t, 'batch_synthesize', lambda texts, *a, real=real, **kw:
                            sizes.append(len(texts)) or real(texts, *a, **kw))
    assert TTSServer(tts, max_batch=4).warmup() >= 0.0
    assert sizes == [1, 2, 4]
    with pytest.raises(ValueError, match='num_beams'):
        TTSServer(tts, max_batch=2).warmup(streams=True)
    server = TTSServer(tts1, max_batch=2, cb_streams=1)
    try:
        server.warmup(all_lengths=True, streams=True)
        assert server._hub.live_sessions() == 0 and server._hub.cb.free_slots() == 1
    finally:
        server.stop()
    # [1, 2]: the refused call ran its batches before it looked at the streams
    assert sizes[3:] == [1, 2] + [1, 2] * len(tts1.config.bucket_sizes)


def test_cli_serves_and_drains_on_sigterm(tmp_path):
    """``python -m valle2_tpu_torch.serve --device cpu --port 0``: the
    logged port answers /synthesize, /stats and /metrics, and SIGTERM drains
    and exits 0."""
    cfg = dict(d_model=32, n_heads=2, dim_feedforward=64, num_layers=2, max_audio_len=6,
               num_beams=1, dropout=0.0, temperature=0.0, bucket_sizes=[32, 64])
    p = tmp_path / 'cfg.json'
    p.write_text(json.dumps(cfg))
    env = dict(os.environ, OMP_NUM_THREADS='1')
    proc = subprocess.Popen([sys.executable, '-m', 'valle2_tpu_torch.serve', '-c', str(p),
                             '--device', 'cpu', '--port', '0', '--seed', '3'],
                            cwd=ROOT, env=env, stderr=subprocess.PIPE, text=True)
    try:
        port, lines = None, []
        deadline = time.time() + 90
        while port is None and time.time() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            lines.append(line)
            if 'TTS HTTP server on http://' in line:
                port = int(line.rsplit(':', 1)[1])
        assert port is not None, ''.join(lines)
        base = f'http://127.0.0.1:{port}'
        resp = post(base, '/synthesize', body(make_requests(1, seed=40)[0]))
        assert resp.status == 200 and len(pcm_of(resp)) > 0
        assert json.loads(urllib.request.urlopen(f'{base}/stats').read())['requests'] == 1
        assert 'valle2_requests_total 1' in urllib.request.urlopen(f'{base}/metrics').read(
        ).decode().splitlines()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert 'SIGTERM' in proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_cli_asks_for_the_card_and_refuses_the_xla_caches(tmp_path, monkeypatch):
    """Without --device a card is needed; the cache flags, which refused
    before the port had its kernel-build caches, now point them
    (compile_cache.py, aot.py) before anything else runs."""
    from valle2_tpu_torch import serve
    from valle2_tpu_torch.kernels import _build
    monkeypatch.setattr(_build, '_state', dict(_build._state))     # restored after
    monkeypatch.setattr(serve, 'ValleTTS', lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError('stop after the caches')))
    p = tmp_path / 'cfg.json'
    p.write_text(json.dumps(dict(d_model=32, n_heads=2, dim_feedforward=64, num_layers=2)))
    with pytest.raises(RuntimeError, match='stop after the caches'):
        serve.main(['-c', str(p), '--device', 'cpu', '--aot-cache', str(tmp_path / 'aot'),
                    '--compile-cache', str(tmp_path / 'cc')])
    assert _build.aot_dir() == tmp_path / 'aot' and _build.build_dir() == tmp_path / 'cc'
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA card'):
            serve.main(['-c', str(p)])


def test_sigterm_returns_from_a_blocking_serve_and_drains(tts, solo):
    """SIGTERM while ``serve_http(block=True)`` runs: the accept loop stops,
    serve_http returns, the in-flight request still gets its 200, handler
    threads join, and the previous signal dispositions come back."""
    req = make_requests(1, seed=11)[0]
    prev = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    result = {}
    with TTSServer(tts, max_batch=2, max_wait_ms=0.0) as server:
        probe = serve_http(server, port=0, block=False)
        port = probe.server_address[1]
        probe.shutdown()
        probe.server_close()
        arrived = threading.Event()
        orig = server.synthesize

        def synthesize(*a, **kw):
            arrived.set()
            return orig(*a, **kw)
        server.synthesize = synthesize

        def client():
            deadline = time.monotonic() + 60
            while True:
                try:
                    resp = post(f'http://127.0.0.1:{port}', '/synthesize', body(req))
                    result['code'], result['pcm'] = resp.status, pcm_of(resp)
                    return
                except urllib.error.URLError as exc:
                    if time.monotonic() > deadline:
                        result['error'] = exc
                        return
                    time.sleep(0.02)
        t = threading.Thread(target=client)
        t.start()
        w = threading.Thread(target=lambda: arrived.wait(60) and signal.raise_signal(
            signal.SIGTERM))
        w.start()
        httpd = serve_http(server, port=port, block=True)      # returns on TERM
        t.join(timeout=120)
        w.join(timeout=60)
    assert join_handler_threads(httpd, timeout=60)
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == prev
    assert result.get('code') == 200, result.get('error')
    close(result['pcm'], solo(req).waveform, atol=PCM_ATOL)
