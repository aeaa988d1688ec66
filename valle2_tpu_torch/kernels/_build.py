"""Build and load the hand-written CUDA kernels in ``valle2_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use by
``nvcc`` (``-gencode arch=compute_90a,code=sm_90a``, Hopper) into
``valle2_tpu_torch/_build/<name>-<source hash>.so`` (git-ignored), then loaded
with ``ctypes``.  The file name carries a hash of the source, so an edited
kernel is rebuilt and a stale library is never loaded.  Nothing here runs at
import time: the CPU tests import every module without a CUDA toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / 'csrc'
BUILD_DIR = PKG_DIR / '_build'
KERNEL_SOURCES = ('flash_attention', 'flash_attention_bwd', 'fused_decode', 'gemm', 'rvq')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC')

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels build only where the CUDA '
                       'toolkit is installed')


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in [CSRC_DIR / f'{name}.cu', *sorted(CSRC_DIR.glob('*.cuh'))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f'{name}-{h.hexdigest()[:12]}.so'


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path) or
    None when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC_DIR / f'{name}.cu')]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for csrc/{name}.cu:\n{log}')
    os.replace(tmp, out)          # atomic: a concurrent loader never sees half a file


def build_all() -> None:
    """Compile every kernel source at once (one nvcc per source, all started
    together)."""
    with _lock:
        started = {n: _start(n) for n in KERNEL_SOURCES}
        for n, s in started.items():
            _finish(n, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
        return lib


def check(status: int, what: str) -> None:
    """Raise if a launcher returned a non-zero ``cudaError_t``."""
    if status != 0:
        raise RuntimeError(f'{what}: CUDA error {status} at launch')


class LaunchCounter:
    """A plain count of kernel launches, read by ``chip_smoke.py`` to show
    that the main path went through a kernel."""

    def __init__(self):
        self.count = 0

    def reset(self) -> None:
        self.count = 0
