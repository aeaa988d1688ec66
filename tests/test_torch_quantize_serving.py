"""Quantized serving end to end in the port against the JAX package (float32,
greedy, d=32, 2 layers): ``ValleAR.decode_params`` (cached, re-quantized on a
rebind), greedy token IDs of ``generate_batch`` under int8 / int4 weights and
an int8 KV cache equal to JAX ``ValleAR.generate_batch``, ``batch_synthesize``
under int8 weights + int8 KV equal to JAX ``_fused_tts_fn`` on the JAX
quantized params, and the cloning and ASR entry points under quantized
configs on the CPU.  The kernel-level checks are in
``tests/test_torch_quantize.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import SMALL, close
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu import quantize as jq
from valle2_tpu import tts as jtts
from valle2_tpu.codec import encodec as jenc
from valle2_tpu.config import ConfigValle as JConfig
from valle2_tpu.models import ValleAR as JValleAR
from valle2_tpu.models import ar as jar
from valle2_tpu.models import nar as jnar
from valle2_tpu.models.convert import export_ar_state_dict, export_nar_state_dict
from valle2_tpu_torch import tts as ttts
from valle2_tpu_torch.codec import Encodec
from valle2_tpu_torch.config import ConfigValle
from valle2_tpu_torch.models import ValleAR, ValleNAR
from valle2_tpu_torch.models import ar as tar
from valle2_tpu_torch.models.convert import (codec_params_from_numpy, load_ar_state_dict,
                                             load_nar_state_dict)

GEN = dict(SMALL, max_audio_len=6, num_beams=2, temperature=0.0)


@pytest.fixture(scope='module')
def ar_weights():
    jp = jar.init_params(jax.random.key(0), JConfig(**GEN))
    return jp, load_ar_state_dict(export_ar_state_dict(jp))


def test_decode_params_cached_and_requantized(ar_weights, tmp_path):
    _, tp = ar_weights
    dense = ValleAR(ConfigValle(**GEN), params=tp, device='cpu')
    assert dense.decode_params is dense.params
    model = ValleAR(ConfigValle(**dict(GEN, weight_dtype='int4')), params=tp, device='cpu')
    first = model.decode_params
    assert first is model.decode_params and 'q4' in first['transformer']['attn']['qkv']
    assert first['proj'] is model.params['proj']   # embeddings and logits stay dense
    model.params['transformer'] = dict(model.params['transformer'])
    second = model.decode_params
    assert second is not first
    model.save(tmp_path / 'ar.pt')
    model.load(tmp_path / 'ar.pt')
    third = model.decode_params
    assert third is not second and third is model.decode_params
    assert torch.equal(third['transformer']['ffn']['lin2']['q4'],
                       first['transformer']['ffn']['lin2']['q4'])


QUANT_CONFIGS = {'int8': dict(weight_dtype='int8'), 'int4': dict(weight_dtype='int4'),
                 'kv8': dict(kv_cache_dtype='int8'),
                 'int8_kv8': dict(weight_dtype='int8', kv_cache_dtype='int8')}


@pytest.mark.parametrize('name', sorted(QUANT_CONFIGS))
def test_ar_greedy_quantized_equals_jax_generate_batch(name, ar_weights):
    """Greedy token IDs of ValleAR.generate_batch under each quantized config
    == JAX ValleAR.generate_batch (f32, 'highest'), through the dense and the
    fused-layout routes; batched == solo."""
    jp, tp = ar_weights
    kw = dict(GEN, **QUANT_CONFIGS[name])
    rs = np.random.RandomState(3)
    items = [(rs.randint(0, 256, (n,)), rs.randint(0, 1024, (m, 8)))
             for n, m in ((7, 4), (3, 9))]
    toks, codes = [t for t, _ in items], [c for _, c in items]
    want = JValleAR(JConfig(**kw), params=jp).generate_batch(toks, codes,
                                                              rng=jax.random.key(0))
    for route in ({}, dict(use_flash_attention=True, use_fused_decode=True)):
        model = ValleAR(ConfigValle(**dict(kw, **route)), params=tp, device='cpu')
        got = model.generate_batch(toks, codes)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert all(len(g) for g in got)
    np.testing.assert_array_equal(model.generate(toks[1], codes[1]).numpy(), got[1].numpy())


def test_batch_synthesize_int8_weights_int8_cache_equals_jax(ar_weights):
    """ValleTTS.batch_synthesize under int8 weights + int8 KV: codes equal JAX
    _fused_tts_fn on the JAX quantized decode params (what the JAX
    batch_synthesize passes), waveforms within 1e-4."""
    jp, tp = ar_weights
    kw = dict(GEN, max_audio_len=4, weight_dtype='int8', kv_cache_dtype='int8')
    jcfg = JConfig(**kw)
    jnar_p = jnar.init_params(jax.random.key(1), jcfg)
    full = jenc.init_params(jax.random.key(3))
    jcodec = {'decoder': full['decoder'], 'rvq': full['rvq']}
    tcfg = ConfigValle(**kw)
    tts = ttts.ValleTTS(
        tcfg, ar=ValleAR(tcfg, params=tp, device='cpu'),
        nar=ValleNAR(tcfg, params=load_nar_state_dict(export_nar_state_dict(jnar_p)),
                     device='cpu'),
        codec=Encodec(params=codec_params_from_numpy(jax.tree.map(np.asarray, full)),
                      device='cpu'),
        device='cpu')
    rs = np.random.RandomState(2)
    texts = ['hello there', 'a longer sentence']
    pts = [rs.randint(0, 256, (4,)), rs.randint(0, 256, (7,))]
    pcs = [rs.randint(0, 1024, (6, 8)), rs.randint(0, 1024, (3, 8))]
    got = tts.batch_synthesize(texts, pts, pcs, bucket=False)
    toks = [np.concatenate([pt, tts.tokenizer(t)]) for t, pt in zip(texts, pts)]
    ttm, pm = max(map(len, toks)), max(map(len, pcs))
    tokens = np.stack([np.pad(t, (0, ttm - len(t))) for t in toks]).astype(np.int32)
    pcodes = np.stack([np.pad(c, ((0, pm - len(c)), (0, 0))) for c in pcs]).astype(np.int32)
    lens = [np.asarray([len(a) for a in arrs], np.int32) for arrs in (toks, pcs)]
    wav_j, gl_j, codes_j = jax.jit(
        lambda a, n, c, *x: jtts._fused_tts_fn(a, n, c, *x, jax.random.key(0), jcfg))(
        jq.quantize_decode_params(jp, bits=8), jnar_p, jcodec,
        *(jnp.asarray(a) for a in (tokens, lens[0], pcodes, lens[1])))
    for i, r in enumerate(got):
        n = int(gl_j[i])
        assert n > 0 and r.waveform.shape == (n * 320,)
        np.testing.assert_array_equal(r.codes, np.asarray(codes_j)[i, :n])
        close(r.waveform, np.asarray(wav_j)[i, :n * 320], atol=1e-4)


@pytest.mark.parametrize('name', ['int8_kv8', 'int4'])
def test_entry_points_run_quantized_on_the_cpu(name, ar_weights):
    """synthesize (staged == fused), cloning through __call__ and batched ASR
    run under a quantized config on the CPU."""
    _, tp = ar_weights
    cfg = ConfigValle(**dict(GEN, max_audio_len=3, **QUANT_CONFIGS[name]))
    codec = Encodec(seed=3, device='cpu')
    tts = ttts.ValleTTS(cfg, ar=ValleAR(cfg, params=tp, device='cpu'), codec=codec,
                        device='cpu')
    wav = (np.random.RandomState(5).randn(3200) * 0.3).astype(np.float32)
    called = tts('the dog ran home', wav, 16000, 'hello there')
    tokens, codes = tts.prepare_prompt(wav, 16000, 'hello there')
    fused = tts.synthesize_fused('the dog ran home', tokens, codes)
    np.testing.assert_array_equal(called.codes, fused.codes)
    assert called.waveform.shape == (len(called.codes) * 320,)
    asr = ttts.ValleASRPipeline(dataclasses.replace(cfg, direction='asr'), codec=codec,
                                device='cpu')
    layout = {'int8_kv8': 'q', 'int4': 'q4'}[name]
    tparams = tar.compute_params(asr.ar.decode_params, asr.ar.config)
    assert tparams['ffn']['lin1'][layout].dtype == torch.int8
    batch = asr.batch_transcribe([wav, wav[:1600]], [24000, 24000], output='phonemes')
    assert batch == [asr.transcribe(a, 24000, output='phonemes') for a in (wav, wav[:1600])]
