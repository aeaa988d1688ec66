"""Multi-voice serving in the port: per-voice weight overrides through one
``TTSServer`` (float32, d=32, 2 layers, weights of one JAX init): a mixed
batch's voice rows equal each voice run solo and its default rows the
voiceless pipeline (codes exact, waveforms atol 2e-5); a voice loaded from an
adapter file JAX wrote gives JAX ``TTSServer``'s codes on it (waveforms within
the port's tolerance against JAX, 1e-4); int8 and int4 voice views; a dense
voice on a ('model',) mesh of two virtual CPU ranks == the solo voice, each
voice split once; int4 on a mesh refused; and the voice errors (400)."""

import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import SMALL, close, make_requests, serving_tts, serving_weights, to_np
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu import lora as jlora
from valle2_tpu import serve as jserve
from valle2_tpu import tts as jtts
from valle2_tpu.codec import encodec as jenc
from valle2_tpu.config import ConfigValle as JConfig
from valle2_tpu.models import ValleAR as JValleAR
from valle2_tpu.models import ValleNAR as JValleNAR
from valle2_tpu_torch import lora
from valle2_tpu_torch import tts as ttts
from valle2_tpu_torch.config import ConfigValle
from valle2_tpu_torch.models import ValleAR
from valle2_tpu_torch.ops.transformer import map_tree
from valle2_tpu_torch.parallel import make_model_mesh
from valle2_tpu_torch.serve import TTSServer, serve_http

TINY = dict(SMALL, max_audio_len=12, num_beams=2, temperature=0.0, bucket_sizes=(32, 64, 128))
BATCH_ATOL = 2e-5        # batched vs solo waveform: the codec at another batch size
WAV_ATOL = 1e-4          # the port's waveform tolerance against JAX (test_torch_tts.py)


def columns(reqs):
    return [r[0] for r in reqs], [r[1] for r in reqs], [r[2] for r in reqs]


@pytest.fixture(scope='module')
def weights():
    """JAX AR, NAR and codec params and their port copies."""
    return serving_weights(TINY)


def port_tts(weights, mesh=None, **over) -> ttts.ValleTTS:
    return serving_tts(weights, dict(TINY, **over), mesh)


@pytest.fixture(scope='module')
def tts(weights):
    return port_tts(weights)


def perturbed(params, seed, eps=0.05):
    """A deterministically different weight tree (a stand-in voice)."""
    rs = np.random.RandomState(seed)
    return map_tree(lambda a: a + torch.from_numpy(
        eps * rs.standard_normal(tuple(a.shape))).to(a.dtype), params)


def assert_matches(got, want, atol=BATCH_ATOL):
    np.testing.assert_array_equal(got.codes, want.codes)
    close(got.waveform, want.waveform, atol=atol)


def test_mixed_voice_batch_matches_each_voice_solo(tts):
    voice_ar, voice_nar = perturbed(tts.ar.params, 1), perturbed(tts.nar.params, 2)
    server = TTSServer(tts, max_batch=8, max_wait_ms=200.0)
    server.register_voice('alt', ar_params=voice_ar)
    server.register_voice('both', ar_params=voice_ar, nar_params=voice_nar)
    reqs = make_requests(5, seed=3)
    voices = [None, 'alt', None, 'alt', 'both']
    futs = [server.submit(*r, voice=v) for r, v in zip(reqs, voices)]
    with server:
        results = [f.result(timeout=120) for f in futs]
    stats = server.stats()
    assert stats['requests'] == 5 and stats['voices'] == 2
    assert stats['batches'] == 3              # one collected batch, three voice groups
    overrides = {None: None, 'alt': (voice_ar, None), 'both': (voice_ar, voice_nar)}
    for r, v, got in zip(reqs, voices, results):
        want = tts.batch_synthesize(*columns([r]), override_params=overrides[v])[0]
        assert_matches(got, want)
    # The voices sound different from the base weights.
    assert not np.array_equal(results[1].codes, tts.synthesize_fused(*reqs[1]).codes)


def test_voice_from_a_jax_adapter_file_gives_the_jax_servers_codes(weights, tts, tmp_path):
    jcfg = JConfig(**TINY)
    ar_p, nar_p, codec_p = weights[0]
    adapters = jax.tree.map(lambda x: x + 0.1, jlora.lora_init(jax.random.key(0), ar_p, rank=2))
    jlora.save_adapters(tmp_path / 'v.npz', {'ar': adapters}, scale=2.0)
    reqs = make_requests(2, seed=4)

    jt = jtts.ValleTTS(jcfg, ar=JValleAR(jcfg, params=ar_p), nar=JValleNAR(jcfg, params=nar_p),
                       codec=jenc.EncodecTPU(params=codec_p))
    jserver = jserve.TTSServer(jt, max_batch=2, max_wait_ms=200.0)
    jserver.load_voice('v', tmp_path / 'v.npz')
    jfuts = [jserver.submit(*r, voice='v') for r in reqs]
    with jserver:
        want = [f.result(timeout=600) for f in jfuts]

    server = TTSServer(tts, max_batch=2, max_wait_ms=200.0)
    server.load_voice('v', tmp_path / 'v.npz')
    view, nar_view, _ = server._voices['v']
    assert nar_view is None                   # no NAR adapters in the file
    merged = dict(jax.tree_util.tree_flatten_with_path(
        to_np(jlora.merge_lora(ar_p, adapters, 2.0)))[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(to_np(view))[0]:
        close(leaf, merged[path], atol=1e-6)
    futs = [server.submit(*r, voice='v') for r in reqs]
    with server:
        got = [f.result(timeout=120) for f in futs]
    for g, w in zip(got, want):
        assert_matches(g, w, atol=WAV_ATOL)


def test_load_voice_nar_adapters_and_scale_fallback(tts, tmp_path):
    ad = map_tree(lambda a: a + 0.05, lora.lora_init(torch.Generator().manual_seed(0),
                                                      tts.nar.params, 2))
    lora.save_adapters(tmp_path / 'nar.npz', {'nar': ad})          # no scale inside
    with pytest.raises(ValueError, match='scale'):
        TTSServer(tts).load_voice('n', tmp_path / 'nar.npz')
    cfg = ConfigValle(**dict(TINY, lora_rank=2, lora_alpha=3.0))
    server = TTSServer(ttts.ValleTTS(cfg, ar=tts.ar, nar=tts.nar, codec=tts.codec,
                                     device='cpu'))
    server.load_voice('n', tmp_path / 'nar.npz')
    ar_view, nar_view, _ = server._voices['n']
    assert ar_view is None
    want = lora.merge_lora(tts.nar.params, ad, 1.5)
    for (k, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(to_np(nar_view))[0],
                              jax.tree_util.tree_flatten_with_path(to_np(want))[0]):
        np.testing.assert_array_equal(a, b, err_msg=str(k))


@pytest.mark.parametrize('weight_dtype', ['int8', 'int4'])
def test_quantized_voice_views(weights, weight_dtype):
    """Under int8 / int4 weights a voice is quantized once into the view the
    default pipeline serves, and its rows equal a pipeline built on the
    voice's weights."""
    qtts = port_tts(weights, weight_dtype=weight_dtype)
    voice_ar = perturbed(qtts.ar.params, 5)
    server = TTSServer(qtts, max_batch=2, max_wait_ms=200.0)
    server.register_voice('q', ar_params=voice_ar)
    view = server._voices['q'][0]
    assert set(view['transformer']) == set(qtts.ar.decode_params['transformer'])
    assert view['transformer'] is not voice_ar['transformer']      # the quantized stack
    reqs = make_requests(2, seed=6)
    futs = [server.submit(*r, voice='q') for r in reqs]
    with server:
        got = [f.result(timeout=120) for f in futs]
    own = ttts.ValleTTS(qtts.config, ar=ValleAR(qtts.config, params=voice_ar, device='cpu'),
                        nar=qtts.nar, codec=qtts.codec, device='cpu')
    for g, w in zip(got, own.batch_synthesize(*columns(reqs))):
        assert_matches(g, w)


def test_dense_voice_on_a_model_mesh_equals_the_solo_voice(weights, tts):
    """batch_synthesize on a ('model',) mesh of two virtual CPU ranks with
    and without voice overrides, in turns: each equals the unmeshed
    pipeline's; each override stack is split once."""
    mesh = make_model_mesh(2, devices=['cpu'] * 2)
    meshed = port_tts(weights, mesh=mesh)
    voice_ar, voice_nar = perturbed(tts.ar.params, 7), perturbed(tts.nar.params, 8)
    reqs = make_requests(2, seed=9)
    for override in (None, (voice_ar, None), None, (voice_ar, voice_nar), (voice_ar, None)):
        want = tts.batch_synthesize(*columns(reqs), override_params=override)
        got = meshed.batch_synthesize(*columns(reqs), override_params=override)
        for g, w in zip(got, want):
            assert_matches(g, w)
    # The default NAR stack, the voice's AR and the voice's NAR: one split each.
    assert len(meshed._mesh_cache) == 3


def test_int4_override_on_a_mesh_raises(weights):
    mesh = make_model_mesh(2, devices=['cpu'] * 2)
    meshed = port_tts(weights, mesh=mesh, weight_dtype='int4')
    voice = ValleAR(meshed.config, params=perturbed(meshed.ar.params, 1), device='cpu')
    with pytest.raises(NotImplementedError, match='int4'):
        meshed.batch_synthesize(*columns(make_requests(1)),
                                override_params=(voice.decode_params, None))


def test_voice_errors(tts, weights):
    """An unknown voice is a ValueError at submit and 400 over HTTP; a voice
    on /stream is 400; register_voice needs a tree."""
    server = TTSServer(tts, max_batch=2, max_wait_ms=0.0)
    server.register_voice('alt', ar_params=perturbed(tts.ar.params, 2))
    with pytest.raises(ValueError, match='unknown voice'):
        server.submit(*make_requests(1)[0], voice='nope')
    with pytest.raises(ValueError):
        server.register_voice('empty')
    text, pt, pc = make_requests(1, seed=7)[0]
    payload = dict(text=text, prompt_tokens=pt.tolist(), prompt_codes=pc.tolist())

    def code(path, **kw):
        try:
            return urllib.request.urlopen(urllib.request.Request(
                f'{base}{path}', data=json.dumps(dict(payload, **kw)).encode()),
                timeout=120).status
        except urllib.error.HTTPError as e:
            return e.code
    with server:
        httpd = serve_http(server, port=0, block=False)
        base = f'http://127.0.0.1:{httpd.server_address[1]}'
        try:
            assert code('/synthesize', voice='alt') == 200
            assert code('/synthesize', voice='ghost') == 400
            assert code('/stream', voice='alt') == 400
        finally:
            httpd.shutdown()
            httpd.server_close()
    assert server.stats()['requests'] == 1
