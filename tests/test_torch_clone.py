"""Voice cloning from audio and ASR through the port's codec encoder, against
the JAX package on the same weights (float32, greedy, d=32, 2 layers):
``prepare_prompt`` tokens and codes, staged ``synthesize`` codes (and
waveform, atol 1e-4) and ``ValleASRPipeline.batch_transcribe`` phonemes are
exactly equal; within the port, staged == fused and batched == solo.  Also
the ``tts`` command line on the CPU.  The codec carries the weights of
``torch_encodec_mirror.EncodecMirror`` (seed 1)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_encodec_mirror import EncodecMirror
from torch_port_helpers import SMALL, close
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu import tts as jtts
from valle2_tpu.codec import EncodecTPU
from valle2_tpu.codec.convert import convert_state_dict as j_convert_state_dict
from valle2_tpu.config import ConfigValle as JConfig
from valle2_tpu.models import ValleAR as JValleAR
from valle2_tpu.models import ValleNAR as JValleNAR
from valle2_tpu.models import ar as jar
from valle2_tpu.models import nar as jnar
from valle2_tpu.models.convert import export_ar_state_dict, export_nar_state_dict
from valle2_tpu_torch import tts as ttts
from valle2_tpu_torch.codec import Encodec, convert_state_dict
from valle2_tpu_torch.config import ConfigValle
from valle2_tpu_torch.models import ValleAR, ValleNAR
from valle2_tpu_torch.models.convert import (codec_params_from_numpy, load_ar_state_dict,
                                             load_nar_state_dict)
from valle2_tpu_torch.utils import save_wav

GEN = dict(SMALL, max_audio_len=6, num_beams=2, temperature=0.0)
PROMPT_TEXT = 'hello there'
TEXT = 'the dog ran home'


def wave(seed: int, samples: int) -> np.ndarray:
    w = np.random.RandomState(seed).randn(samples).astype(np.float32)
    return 0.5 * w / np.abs(w).max()


@pytest.fixture(scope='module')
def codecs():
    sd = EncodecMirror(seed=1).numpy_state_dict()
    return (EncodecTPU(params=jax.tree.map(jnp.asarray, j_convert_state_dict(sd))),
            Encodec(params=codec_params_from_numpy(convert_state_dict(sd)), device='cpu'))


@pytest.fixture(scope='module')
def pipelines(codecs):
    jcodec, tcodec = codecs
    jcfg, tcfg = JConfig(**GEN), ConfigValle(**GEN)
    ar_p, nar_p = jar.init_params(jax.random.key(0), jcfg), jnar.init_params(
        jax.random.key(1), jcfg)
    jt = jtts.ValleTTS(jcfg, ar=JValleAR(jcfg, params=ar_p), nar=JValleNAR(jcfg, params=nar_p),
                       codec=jcodec)
    tt = ttts.ValleTTS(
        tcfg, ar=ValleAR(tcfg, params=load_ar_state_dict(export_ar_state_dict(ar_p)),
                         device='cpu'),
        nar=ValleNAR(tcfg, params=load_nar_state_dict(export_nar_state_dict(nar_p)),
                     device='cpu'),
        codec=tcodec, device='cpu')
    return jt, tt


def test_prepare_prompt_matches_jax(pipelines):
    jt, tt = pipelines
    audio = wave(3, 3200)                       # 16 kHz → 4800 samples at 24 kHz
    j_tokens, j_codes = jt.prepare_prompt(audio, 16000, PROMPT_TEXT)
    t_tokens, t_codes = tt.prepare_prompt(audio, 16000, PROMPT_TEXT)
    assert t_codes.shape == np.asarray(j_codes).shape == (15, 8)
    np.testing.assert_array_equal(t_tokens, j_tokens)
    np.testing.assert_array_equal(t_codes, j_codes)


def test_synthesize_greedy_matches_jax_and_fused(pipelines):
    jt, tt = pipelines
    tokens, codes = tt.prepare_prompt(wave(3, 3200), 16000, PROMPT_TEXT)
    want = jt.synthesize(TEXT, tokens, codes)
    got = tt.synthesize(TEXT, tokens, codes)
    assert len(got.codes) > 0 and got.codes.shape[1] == 8
    np.testing.assert_array_equal(got.codes, np.asarray(want.codes))
    close(got.waveform, np.asarray(want.waveform), atol=1e-4)
    assert got.waveform.shape == (len(got.codes) * 320,)
    assert set(got.timings) == {'frontend', 'ar_decode', 'nar_refine', 'codec_decode'}
    fused = tt.synthesize_fused(TEXT, tokens, codes)
    np.testing.assert_array_equal(fused.codes, got.codes)
    close(fused.waveform, got.waveform, atol=1e-5)
    called = tt(TEXT, wave(3, 3200), 16000, PROMPT_TEXT)
    np.testing.assert_array_equal(called.codes, got.codes)


@pytest.fixture(scope='module')
def asr_pipelines(codecs):
    jcodec, tcodec = codecs
    jcfg = JConfig(**dict(GEN, direction='asr'))
    ar_p = jar.init_params(jax.random.key(2), jcfg)
    tcfg = ConfigValle(**dict(GEN, direction='asr'))
    tar = ValleAR(tcfg, params=load_ar_state_dict(export_ar_state_dict(ar_p)), device='cpu')
    return (jtts.ValleASRPipeline(jcfg, ar=JValleAR(jcfg, params=ar_p), codec=jcodec),
            ttts.ValleASRPipeline(tcfg, ar=tar, codec=tcodec, device='cpu'))


def test_asr_batch_transcribe_matches_jax_and_solo(asr_pipelines):
    jasr, tasr = asr_pipelines
    audios, srs = [wave(4, 4800), wave(5, 2400)], [24000, 24000]
    want = jasr.batch_transcribe(audios, srs, output='phonemes')
    got = tasr.batch_transcribe(audios, srs, output='phonemes')
    assert got == want and any(len(p) for p in got)
    for audio, sr, batched in zip(audios, srs, got):
        assert tasr.transcribe(audio, sr, output='phonemes') == batched
    assert tasr.batch_transcribe(audios, srs) == jasr.batch_transcribe(audios, srs)
    with pytest.raises(ValueError, match='output'):
        tasr.batch_transcribe(audios, srs, output='ids')


def test_cli_synthesizes_and_transcribes(tmp_path, capsys, monkeypatch):
    cfg_path = tmp_path / 'cfg.json'
    cfg_path.write_text(json.dumps(dict(GEN, max_audio_len=3)))
    save_wav(tmp_path / 'prompt.wav', wave(6, 3200), 16000)
    out = tmp_path / 'out.wav'
    ttts.main(['-c', str(cfg_path), '--text', TEXT, '--prompt-wav',
               str(tmp_path / 'prompt.wav'), '--prompt-text', PROMPT_TEXT, '-o', str(out),
               '--seed', '3', '--device', 'cpu'])
    import wave as wave_mod
    with wave_mod.open(str(out), 'rb') as f:
        assert f.getframerate() == 24000 and f.getnframes() % 320 == 0
    ttts.main(['-c', str(cfg_path), '--transcribe', str(tmp_path / 'prompt.wav'),
               '--device', 'cpu'])
    assert capsys.readouterr().out.endswith('\n')
    # The cache flags point the kernel-build caches (they refused before
    # compile_cache.py and aot.py were ported).
    from valle2_tpu_torch.kernels import _build
    monkeypatch.setattr(_build, '_state', dict(_build._state))     # restored after
    ttts.main(['-c', str(cfg_path), '--transcribe', str(out), '--aot-cache',
               str(tmp_path / 'aot'), '--compile-cache', str(tmp_path / 'cc'),
               '--device', 'cpu'])
    assert _build.aot_dir() == tmp_path / 'aot' and _build.build_dir() == tmp_path / 'cc'
    assert torch.get_default_dtype() == torch.float32
