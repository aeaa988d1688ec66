"""ctypes bindings over ``native/libvalle_audio.so``: WAV I/O and the audio
DSP of the data pipeline on the host (``valle2_tpu/native/audio.py``).

The library is the repo root's shared C++ (``native/valle_audio.cc``, no
dependency beyond libm), built on first use by ``native/Makefile`` with g++.
The build runs in a directory of its own and its output is renamed into
``native/``, so a concurrent loader never opens half a file.  Where ``make``
or the compiler is missing, ``mono_mix``, ``peak_normalize`` and ``resample``
fall back to the PyTorch versions (``resample`` to ``utils.resample``, the
same Hann-sinc design); ``wav_read`` and ``wav_write`` raise.  Check
``available()`` or just call the functions.

This is host code: each function takes a tensor (or anything
``torch.as_tensor`` takes) and returns float32 tensors on the input's device
(``wav_read`` and ``load_audio``: on ``device``, the CUDA card unless the
caller names another).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np
import torch

from ..config import resolve_device

NATIVE_DIR = Path(__file__).resolve().parents[2] / 'native'
LIB_PATH = NATIVE_DIR / 'libvalle_audio.so'
_lib: ctypes.CDLL | None = None
_tried = False
_lock = threading.Lock()


def _build() -> None:
    """``make`` the library in a scratch directory (the Makefile's own rule,
    its source found through VPATH), then rename it into ``native/``."""
    with tempfile.TemporaryDirectory(prefix='valle_audio_') as tmp:
        subprocess.run(['make', '-f', str(NATIVE_DIR / 'Makefile'), '-C', tmp,
                        f'VPATH={NATIVE_DIR}', 'libvalle_audio.so'],
                       check=True, capture_output=True, timeout=120)
        staged = LIB_PATH.with_name(f'{LIB_PATH.name}.{os.getpid()}.tmp')
        shutil.copyfile(Path(tmp) / 'libvalle_audio.so', staged)
        os.replace(staged, LIB_PATH)


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not LIB_PATH.exists():
                _build()
            lib = ctypes.CDLL(str(LIB_PATH))
        except (OSError, subprocess.SubprocessError):
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.valle_wav_read.restype = ctypes.c_int64
        lib.valle_wav_read.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64, i32p, i32p]
        lib.valle_wav_write.restype = ctypes.c_int32
        lib.valle_wav_write.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64, ctypes.c_int32]
        lib.valle_mono_mix.restype = None
        lib.valle_mono_mix.argtypes = [f32p, ctypes.c_int64, ctypes.c_int32, f32p]
        lib.valle_peak_normalize.restype = None
        lib.valle_peak_normalize.argtypes = [f32p, ctypes.c_int64]
        lib.valle_resample_out_len.restype = ctypes.c_int64
        lib.valle_resample_out_len.argtypes = [ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
        lib.valle_resample.restype = ctypes.c_int64
        lib.valle_resample.argtypes = [f32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                                       f32p, ctypes.c_int64]
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _host(x) -> tuple[np.ndarray, torch.device]:
    """(a contiguous float32 numpy copy on the host, the input's device)."""
    t = torch.as_tensor(x)
    return np.ascontiguousarray(t.detach().to('cpu', torch.float32).numpy()), t.device


def _out(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device)


def wav_read(path: str | Path, device=None) -> tuple[torch.Tensor, int]:
    """→ (float32 samples shaped (frames,) or (frames, channels) on
    ``device``, sample rate)."""
    lib = _load()
    if lib is None:
        raise RuntimeError('libvalle_audio unavailable')
    sr, ch = ctypes.c_int32(0), ctypes.c_int32(0)
    n = lib.valle_wav_read(str(path).encode(), None, 0, ctypes.byref(sr), ctypes.byref(ch))
    if n < 0:
        raise IOError(f'failed to parse WAV: {path}')
    buf = np.empty(n, np.float32)
    n2 = lib.valle_wav_read(str(path).encode(), _fptr(buf), n, ctypes.byref(sr),
                            ctypes.byref(ch))
    if n2 < 0:
        raise IOError(f'failed to read WAV data: {path}')
    buf = buf[:n2]
    if ch.value > 1:
        buf = buf.reshape(-1, ch.value)
    return _out(buf, resolve_device(device)), sr.value


def wav_write(path: str | Path, samples, sample_rate: int) -> None:
    """A mono float waveform (frames,) → a 16-bit PCM WAV.  The native
    writer writes one channel: a 2-D input raises rather than being written
    interleaved as mono."""
    lib = _load()
    if lib is None:
        raise RuntimeError('libvalle_audio unavailable')
    src, _ = _host(samples)
    if src.ndim != 1:
        raise ValueError(f'wav_write writes mono (frames,) samples, got shape {src.shape}')
    if lib.valle_wav_write(str(path).encode(), _fptr(src), src.size, sample_rate) != 0:
        raise IOError(f'failed to write WAV: {path}')


def mono_mix(interleaved) -> torch.Tensor:
    """(frames, channels) → (frames,), the channels' mean."""
    src, dev = _host(interleaved)
    if src.ndim == 1:
        return _out(src, dev)
    lib = _load()
    if lib is None:
        return torch.as_tensor(interleaved, dtype=torch.float32).mean(dim=1)
    frames, ch = src.shape
    out = np.empty(frames, np.float32)
    lib.valle_mono_mix(_fptr(src), frames, ch, _fptr(out))
    return _out(out, dev)


def peak_normalize(samples) -> torch.Tensor:
    """Samples scaled so that the largest |sample| is 1 (all-zero input
    unchanged)."""
    lib = _load()
    out, dev = _host(samples)
    if lib is None:
        t = torch.as_tensor(samples, dtype=torch.float32)
        peak = t.abs().max() if t.numel() else torch.zeros(())
        return t / peak if float(peak) > 0 else t.clone()
    out = out.copy()
    lib.valle_peak_normalize(_fptr(out), out.size)
    return _out(out, dev)


def resample(samples, sr_in: int, sr_out: int) -> torch.Tensor:
    """Polyphase Hann-sinc resample of a (T,) waveform to ``sr_out``."""
    lib = _load()
    src, dev = _host(samples)
    if lib is None:
        from .. import utils
        return utils.resample(torch.as_tensor(samples, dtype=torch.float32), sr_in, sr_out)
    n_out = lib.valle_resample_out_len(src.size, sr_in, sr_out)
    out = np.empty(n_out, np.float32)
    n = lib.valle_resample(_fptr(src), src.size, sr_in, sr_out, _fptr(out), n_out)
    return _out(out[:n], dev)


def load_audio(path: str | Path, target_sr: int = 16_000, device=None) -> torch.Tensor:
    """Native read → mono → resample → peak-normalize, on ``device``."""
    samples, sr = wav_read(path, device='cpu')
    mono = mono_mix(samples)
    if sr != target_sr:
        mono = resample(mono, sr, target_sr)
    return peak_normalize(mono).to(resolve_device(device))
