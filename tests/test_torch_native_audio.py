"""``valle2_tpu_torch/native/audio.py`` (ctypes over ``native/libvalle_audio.so``)
held to the JAX package's wrapper (``valle2_tpu/native/audio.py``) on the same
files and inputs: the cases of ``tests/test_native_audio.py``, each result
equal to the JAX wrapper's (the same C++ library: bit for bit), the port's
tensors on the caller's device, and the pure-PyTorch fallbacks within the
JAX fallbacks' tolerance of the native results."""

import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu import utils as jutils
from valle2_tpu.native import audio as jnative
from valle2_tpu_torch import utils
from valle2_tpu_torch.native import audio as native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason='libvalle_audio failed to build')


def np_(t: torch.Tensor) -> np.ndarray:
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
    return t.numpy()


class TestWavIO:
    def test_roundtrip_equals_jax_wrapper(self, tmp_path):
        wav = np.sin(np.linspace(0, 440 * 2 * np.pi, 16000)).astype(np.float32) * 0.7
        native.wav_write(tmp_path / 'a.wav', torch.from_numpy(wav), 16000)
        jnative.wav_write(tmp_path / 'b.wav', wav, 16000)
        assert (tmp_path / 'a.wav').read_bytes() == (tmp_path / 'b.wav').read_bytes()
        got, sr = native.wav_read(tmp_path / 'a.wav', device='cpu')
        want, jsr = jnative.wav_read(tmp_path / 'a.wav')
        assert sr == jsr == 16000
        np.testing.assert_array_equal(np_(got), want)
        np.testing.assert_allclose(np_(got), wav, atol=1.5 / 16384)   # 16-bit quantization

    def test_read_python_written_and_stereo(self, tmp_path):
        import wave
        rs = np.random.RandomState(0)
        wav = rs.uniform(-0.5, 0.5, 8000).astype(np.float32)
        utils.save_wav(tmp_path / 'n.wav', wav, 24000)
        got, sr = native.wav_read(tmp_path / 'n.wav', device='cpu')
        assert sr == 24000
        np.testing.assert_array_equal(np_(got), jnative.wav_read(tmp_path / 'n.wav')[0])
        stereo = (rs.uniform(-0.9, 0.9, (3000, 2)) * 32767).astype('<i2')
        with wave.open(str(tmp_path / 's.wav'), 'wb') as f:
            f.setnchannels(2)
            f.setsampwidth(2)
            f.setframerate(48000)
            f.writeframes(stereo.tobytes())
        got, sr = native.wav_read(tmp_path / 's.wav', device='cpu')
        assert sr == 48000 and got.shape == (3000, 2)
        np.testing.assert_array_equal(np_(got), jnative.wav_read(tmp_path / 's.wav')[0])

    def test_python_read_native_written(self, tmp_path):
        wav = np.random.RandomState(1).uniform(-0.9, 0.9, 4000).astype(np.float32)
        native.wav_write(tmp_path / 'x.wav', wav, 16000)
        got = np_(utils.load_audio(tmp_path / 'x.wav', target_sr=16000, device='cpu'))
        np.testing.assert_allclose(got, wav / np.abs(wav).max(), atol=2e-3)

    def test_read_missing_file_raises(self, tmp_path):
        with pytest.raises(IOError):
            native.wav_read(tmp_path / 'missing.wav', device='cpu')

    def test_write_refuses_multichannel(self, tmp_path):
        with pytest.raises(ValueError, match='mono'):
            native.wav_write(tmp_path / 'x.wav', np.zeros((10, 2), np.float32), 16000)


class TestDSP:
    def test_mono_mix(self):
        stereo = np.stack([np.ones(100), np.zeros(100)], axis=1).astype(np.float32)
        got = native.mono_mix(torch.from_numpy(stereo))
        np.testing.assert_array_equal(np_(got), jnative.mono_mix(stereo))
        np.testing.assert_allclose(np_(got), 0.5)

    def test_peak_normalize(self):
        x = np.asarray([0.1, -0.25, 0.2], np.float32)
        got = native.peak_normalize(x)
        np.testing.assert_array_equal(np_(got), jnative.peak_normalize(x))
        np.testing.assert_allclose(np_(got), [0.4, -1.0, 0.8], atol=1e-6)

    @pytest.mark.parametrize('sr_in,sr_out', [(22050, 24000), (16000, 24000),
                                              (48000, 24000), (24000, 16000)])
    def test_resample_equals_jax_wrapper_and_matches_lowpass(self, sr_in, sr_out):
        t = np.arange(int(sr_in * 0.25)) / sr_in
        x = (np.sin(2 * np.pi * 440 * t) + 0.3 * np.sin(2 * np.pi * 1200 * t)
             ).astype(np.float32)
        got = native.resample(torch.from_numpy(x), sr_in, sr_out)
        np.testing.assert_array_equal(np_(got), jnative.resample(x, sr_in, sr_out))
        want = np_(utils.resample(torch.from_numpy(x), sr_in, sr_out))
        np.testing.assert_allclose(want, np.asarray(jutils.resample(x, sr_in, sr_out)),
                                   atol=1e-5)
        assert got.shape == want.shape
        edge = 256                      # the filter's length at the edges
        np.testing.assert_allclose(np_(got)[edge:-edge], want[edge:-edge], atol=5e-3)

    def test_resample_identity(self):
        x = np.random.RandomState(2).randn(1000).astype(np.float32)
        np.testing.assert_array_equal(np_(native.resample(x, 16000, 16000)), x)

    def test_resample_preserves_tone_frequency(self):
        sr_in, sr_out = 16000, 24000
        x = np.sin(2 * np.pi * 440 * np.arange(sr_in) / sr_in).astype(np.float32)
        y = np_(native.resample(x, sr_in, sr_out))
        crossings = np.sum(np.diff(np.signbit(y[1000:-1000])) != 0)
        assert abs(crossings / 2 / ((len(y) - 2000) / sr_out) - 440) < 2.0


class TestLoadAudio:
    def test_end_to_end_load_equals_jax_wrapper(self, tmp_path):
        sr = 22050
        wav = (0.5 * np.sin(2 * np.pi * 220 * np.arange(sr) / sr)).astype(np.float32)
        native.wav_write(tmp_path / 'in.wav', wav, sr)
        out = native.load_audio(tmp_path / 'in.wav', target_sr=24000, device='cpu')
        np.testing.assert_array_equal(np_(out), jnative.load_audio(tmp_path / 'in.wav', 24000))
        assert abs(len(out) - 24000) <= 2
        assert abs(float(out.abs().max()) - 1.0) < 1e-5      # peak-normalized
        np.testing.assert_allclose(
            np_(out), np_(utils.load_audio(tmp_path / 'in.wav', 24000, device='cpu')),
            atol=5e-3)

    def test_default_device_is_the_card(self, tmp_path):
        native.wav_write(tmp_path / 'z.wav', np.zeros(100, np.float32), 16000)
        if torch.cuda.is_available():
            assert native.load_audio(tmp_path / 'z.wav').device.type == 'cuda'
        else:
            with pytest.raises(RuntimeError, match='device="cpu"'):
                native.load_audio(tmp_path / 'z.wav')


class TestFallback:
    def test_pure_pytorch_fallbacks_without_the_library(self, monkeypatch):
        """Where make or g++ is missing: mono_mix, peak_normalize and resample
        run in PyTorch (resample: ``utils.resample``), the WAV I/O raises."""
        rs = np.random.RandomState(3)
        x = rs.uniform(-0.5, 0.5, (800, 2)).astype(np.float32)
        natives = (native.mono_mix(x), native.peak_normalize(x[:, 0]),
                   native.resample(x[:, 0], 16000, 24000))
        monkeypatch.setattr(native, '_load', lambda: None)
        assert not native.available()
        np.testing.assert_allclose(np_(native.mono_mix(x)), np_(natives[0]), atol=1e-7)
        np.testing.assert_allclose(np_(native.peak_normalize(x[:, 0])), np_(natives[1]),
                                   atol=1e-7)
        y = np_(native.resample(x[:, 0], 16000, 24000))
        assert y.shape == natives[2].shape
        np.testing.assert_allclose(y[256:-256], np_(natives[2])[256:-256], atol=5e-3)
        with pytest.raises(RuntimeError, match='unavailable'):
            native.wav_read('x.wav', device='cpu')
