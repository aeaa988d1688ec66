"""Logging and audio utilities (``valle2_tpu/utils.py``).

The resampler, ``normalize_audio`` and ``load_audio`` run on tensors on any
device; the WAV helpers (``pcm16``, ``wav_pcm16_bytes``, ``save_wav``,
``wav_bytes_to_float``) are numpy, copied unchanged.

``resample`` gives the JAX package's samples in polyphase form.  JAX runs one
convolution over the input zero-stuffed by the up factor L (``lhs_dilation``),
padded by (half, half + M) and strided by the down factor M.  Output j there
sums ``x[i] * taps[i*L + half - j*M]`` over the inputs whose tap index falls
in the filter, so the port gathers just those (about len(taps) / L of them per
output) and skips the zeros: the same taps and the same terms, summed in
another order, with ``ceil(T * target / orig)`` samples out.
"""

from __future__ import annotations

import logging
import math
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from .config import resolve_device

logger = logging.getLogger('valle2_tpu_torch')
if not logger.handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(logging.Formatter(
        fmt='%(asctime)s :: %(levelname)s :: %(message)s', datefmt='%Y-%m-%d %H:%M:%S'))
    _handler.setLevel(logging.INFO)
    logger.addHandler(_handler)
    logger.setLevel(logging.INFO)
    logger.propagate = False


def log_debug(*args, **kwargs):
    logger.debug(*args, **kwargs)


def log_info(*args, **kwargs):
    logger.info(*args, **kwargs)


def log_warning(*args, **kwargs):
    logger.warning(*args, **kwargs)


def log_error(*args, **kwargs):
    logger.error(*args, **kwargs)


@lru_cache(maxsize=32)
def _sinc_kernel(l_up: int, m_down: int, width: int = 6) -> np.ndarray:
    """Hann-windowed sinc lowpass for rational L/M resampling (float32 taps)."""
    cutoff = 0.99 * 0.5 / max(l_up, m_down)
    half = width * max(l_up, m_down)
    n = np.arange(-half, half + 1, dtype=np.float64)
    taps = 2.0 * cutoff * np.sinc(2.0 * cutoff * n)
    window = 0.5 * (1.0 + np.cos(np.pi * n / half)) if half > 0 else np.ones_like(n)
    return (taps * window * l_up).astype(np.float32)


def resample(wav: torch.Tensor, orig_sr: int, target_sr: int) -> torch.Tensor:
    """Sinc resample of a (T,) or (B, T) waveform; ceil(T * target / orig) out."""
    if orig_sr == target_sr:
        return wav
    g = math.gcd(orig_sr, target_sr)
    l_up, m_down = target_sr // g, orig_sr // g
    taps = torch.from_numpy(_sinc_kernel(l_up, m_down)).to(wav.device)
    n_taps = taps.shape[0]
    half = (n_taps - 1) // 2
    squeeze = wav.dim() == 1
    x = (wav[None] if squeeze else wav).float()
    t = x.shape[-1]
    out_len = -(-t * l_up // m_down)
    # Output j reads inputs i = first[j] + p with tap index i*L + half - j*M.
    start = torch.arange(out_len, device=x.device) * m_down - half
    first = -torch.div(-start, l_up, rounding_mode='floor')          # ceil(start / L)
    i = first[:, None] + torch.arange((n_taps - 1) // l_up + 1, device=x.device)
    m = i * l_up - start[:, None]
    valid = (m < n_taps) & (i >= 0) & (i < t)
    w = torch.where(valid, taps[m.clamp(max=n_taps - 1)], 0.0)
    y = (x[:, i.clamp(0, t - 1)] * w).sum(-1)
    return y[0] if squeeze else y


def normalize_audio(audio, original_sr: int, target_sr: int = 16_000) -> torch.Tensor:
    """Mono-mix (channels, T), resample, peak-normalize to [-1, 1].  A tensor
    stays on its device; anything else becomes a CPU tensor."""
    audio = torch.as_tensor(audio, dtype=torch.float32)
    if audio.dim() > 1:
        audio = audio.mean(dim=0)
    audio = resample(audio, original_sr, target_sr)
    return audio / audio.abs().max().clamp(min=1e-9)


def load_audio(path: Path | str, target_sr: int = 16_000, device=None) -> torch.Tensor:
    """Load a WAV file (stdlib ``wave``) and normalize it on ``device`` (the
    card unless the caller names another)."""
    import wave

    with wave.open(str(path), 'rb') as f:
        sr = f.getframerate()
        n_ch = f.getnchannels()
        raw = f.readframes(f.getnframes())
        width = f.getsampwidth()
    dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
    pcm = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    if width == 1:
        pcm = pcm - 128.0
    pcm = pcm / float(np.iinfo(dtype).max if width > 1 else 127.0)
    if n_ch > 1:
        pcm = pcm.reshape(-1, n_ch).T
    return normalize_audio(torch.from_numpy(np.ascontiguousarray(pcm)).to(
        resolve_device(device)), sr, target_sr)


def pcm16(wav: np.ndarray, dtype: str = '<i2') -> np.ndarray:
    """Float waveform → 16-bit PCM samples (clip, round-to-nearest); ``dtype``
    selects byte order ('<i2' WAV, '>i2' network/audio-L16)."""
    return np.round(np.clip(np.asarray(wav), -1.0, 1.0) * 32767.0).astype(dtype)


def wav_pcm16_bytes(wav: np.ndarray, sr: int) -> bytes:
    """Mono float waveform → complete 16-bit WAV file bytes."""
    import io
    import wave

    pcm = pcm16(wav, '<i2')
    buf = io.BytesIO()
    with wave.open(buf, 'wb') as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())
    return buf.getvalue()


def save_wav(path: Path | str, wav: np.ndarray, sr: int) -> None:
    """Write a mono float waveform to a 16-bit WAV."""
    with open(path, 'wb') as f:
        f.write(wav_pcm16_bytes(wav, sr))


def wav_bytes_to_float(data: bytes) -> tuple[np.ndarray, int]:
    """Complete WAV file bytes → (mono float32 waveform in [-1, 1], sample
    rate).  Multi-channel input mixes down; 8/32-bit PCM is scaled by its
    own full range."""
    import io
    import wave

    with wave.open(io.BytesIO(data), 'rb') as f:
        sr = f.getframerate()
        n_ch = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(f.getnframes())
    if width == 2:
        pcm = np.frombuffer(raw, '<i2').astype(np.float32) / 32767.0
    elif width == 4:
        pcm = np.frombuffer(raw, '<i4').astype(np.float32) / 2147483647.0
    elif width == 1:
        pcm = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 127.0
    else:
        raise ValueError(f'unsupported WAV sample width {width}')
    if n_ch > 1:
        pcm = pcm.reshape(-1, n_ch).mean(axis=1)
    return pcm, sr
