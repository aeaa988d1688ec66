"""The port's codec, frontend and whole TTS path against the JAX package:
codec decode waveform, phoneme IDs, and end-to-end greedy codes + waveform of
``_fused_tts_fn`` on the same weights (float32).  Also: the port imports no
JAX."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import SMALL, close, to_np

from valle2_tpu import tts as jtts
from valle2_tpu.codec import encodec as jenc
from valle2_tpu.config import ConfigValle as JConfig
from valle2_tpu.data.frontend import PhonemeTokenizer as JTokenizer
from valle2_tpu.models import ar as jar
from valle2_tpu.models import nar as jnar
from valle2_tpu.models.convert import export_ar_state_dict, export_nar_state_dict
from valle2_tpu_torch import tts as ttts
from valle2_tpu_torch.codec import encodec as tenc
from valle2_tpu_torch.config import ConfigValle
from valle2_tpu_torch.data.frontend import PhonemeTokenizer
from valle2_tpu_torch.models.convert import (codec_params_from_numpy, load_ar_state_dict,
                                             load_nar_state_dict)

GEN = dict(SMALL, max_audio_len=4, num_beams=2, temperature=0.0)


@pytest.fixture(scope='module')
def codec_params():
    full = jenc.init_params(jax.random.key(3))
    jp = {'decoder': full['decoder'], 'rvq': full['rvq']}
    return jp, codec_params_from_numpy(to_np(jp))


def test_codec_decode_matches_jax(codec_params):
    jp, tp = codec_params
    codes = np.random.RandomState(0).randint(0, 1024, (2, 8, 4))
    want = jax.jit(jenc.decode)(jp, jnp.asarray(codes))
    got = tenc.decode(tp, torch.from_numpy(codes))
    assert got.shape == (2, 4 * 320)
    close(got, want, atol=1e-4)
    codec = tenc.Encodec(params=tp, device='cpu')   # batch size changes the sum order
    close(codec.batch_decode(codes), got, atol=1e-6)
    close(codec.decode(codes[1]), got[1], atol=1e-6)


def test_phoneme_tokenizer_ids_identical():
    texts = ['The quick brown fox jumps over the lazy dog.',
             'It costs $3.50, or 12% more than in 1999!',
             'Zyxqv blorft, said Dr. Smith.']
    tj, tt = JTokenizer(), PhonemeTokenizer()
    assert tt.vocab_size == tj.vocab_size
    for text in texts:
        np.testing.assert_array_equal(tt(text), tj(text))


def test_end_to_end_greedy_matches_jax_fused_tts(codec_params):
    jcp, tcp = codec_params
    jcfg = JConfig(**GEN)
    jar_p = jar.init_params(jax.random.key(0), jcfg)
    jnar_p = jnar.init_params(jax.random.key(1), jcfg)
    rs = np.random.RandomState(9)
    tokens = rs.randint(0, 256, (2, 10)).astype(np.int32)
    tl = np.asarray([10, 6], np.int32)
    pcodes = rs.randint(0, 1024, (2, 5, 8)).astype(np.int32)
    pl = np.asarray([5, 3], np.int32)
    wav_j, gl_j, codes_j = jax.jit(
        lambda a, n, c, *x: jtts._fused_tts_fn(a, n, c, *x, jax.random.key(0), jcfg))(
        jar_p, jnar_p, jcp, *(jnp.asarray(a) for a in (tokens, tl, pcodes, pl)))
    tcfg = ConfigValle(**GEN)
    with torch.inference_mode():
        wav_t, gl_t, codes_t = ttts._fused_tts_fn(
            load_ar_state_dict(export_ar_state_dict(jar_p)),
            load_nar_state_dict(export_nar_state_dict(jnar_p)), tcp,
            *(torch.from_numpy(a).long() for a in (tokens, tl, pcodes, pl)), tcfg)
    gl_j, codes_j, wav_j = np.asarray(gl_j), np.asarray(codes_j), np.asarray(wav_j)
    np.testing.assert_array_equal(gl_t.numpy(), gl_j)
    for i in range(2):
        n = int(gl_j[i])
        np.testing.assert_array_equal(codes_t[i, :n].numpy(), codes_j[i, :n])
        close(wav_t[i, :n * 320], wav_j[i, :n * 320], atol=1e-4)


def test_batch_synthesize_lengths_and_batched_equals_solo(codec_params):
    _, tcp = codec_params
    cfg = ConfigValle(**dict(GEN, max_audio_len=5))
    tts = ttts.ValleTTS(cfg, codec=tenc.Encodec(params=tcp, device='cpu'), device='cpu')
    rs = np.random.RandomState(2)
    texts = ['hello there', 'a much longer sentence to say']
    pts = [rs.randint(0, 256, (4,)), rs.randint(0, 256, (7,))]
    pcs = [rs.randint(0, 1024, (6, 8)), rs.randint(0, 1024, (3, 8))]
    batched = tts.batch_synthesize(texts, pts, pcs)
    for i, r in enumerate(batched):
        assert r.waveform.shape == (len(r.codes) * 320,) and np.isfinite(r.waveform).all()
        assert set(r.timings) >= {'prefill', 'decode', 'nar', 'codec', 'batched'}
        solo = tts.synthesize_fused(texts[i], pts[i], pcs[i])
        np.testing.assert_array_equal(solo.codes, r.codes)
        close(solo.waveform, r.waveform, atol=1e-5)


def test_port_imports_no_jax():
    code = ('import sys, valle2_tpu_torch, valle2_tpu_torch.tts, '
            'valle2_tpu_torch.kernels.flash_attention, valle2_tpu_torch.kernels.fused_decode, '
            'valle2_tpu_torch.models.convert\n'
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", '
            '"valle2_tpu"))\n'
            'assert not bad, bad')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
