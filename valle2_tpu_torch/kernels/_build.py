"""Build and load the hand-written CUDA kernels in ``valle2_tpu_torch/csrc``.

Each build has a plain C interface and is compiled on first use by ``nvcc``
(``-gencode arch=compute_90a,code=sm_90a``, Hopper) from one ``csrc/*.cu``
source (``BUILDS``: a source may be built several times with other defines)
into ``valle2_tpu_torch/_build/<name>-<source hash>.so`` (git-ignored), then
loaded with ``ctypes``.  The file name carries a hash of the source, the
headers and the flags, so an edited kernel is rebuilt and a stale library is
never loaded.  Nothing here runs at
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
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC')
# The fused decode step contracts no multiply-add on its own (every FMA is an
# explicit fmaf), so the persistent #6 and the phased kernels, which run the
# same device code from other call sites, round alike.
_FUSED = ('--fmad=false',)
# build name -> (source stem in csrc/, its own nvcc flags).  The persistent
# #6 and #7 (fused_step.cu) are built once per weight format, and the
# persistent TP step once per format it takes (dense, int4), so that the five
# compile in parallel beside the others.
BUILDS = {
    'flash_attention': ('flash_attention', ()),
    'flash_attention_bwd': ('flash_attention_bwd', ()),
    'fused_decode': ('fused_decode', _FUSED),
    **{f'fused_step_{fmt}': ('fused_step', (*_FUSED, f'-DVALLE2_STEP_WF={i}'))
       for i, fmt in enumerate(('dense', 'w8a8', 'w4a16'))},
    **{f'fused_step_tp_{fmt}': ('fused_step', (*_FUSED, f'-DVALLE2_STEP_WF={i}',
                                               '-DVALLE2_STEP_TP=1'))
       for i, fmt in ((0, 'dense'), (2, 'w4a16'))},
    'gemm': ('gemm', ()),
    'rvq': ('rvq', ()),
}
KERNEL_SOURCES = tuple(BUILDS)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels build only where the CUDA '
                       'toolkit is installed')


def _lib_path(name: str) -> Path:
    stem, flags = BUILDS[name]
    h = hashlib.sha256(' '.join((*NVCC_FLAGS, *flags)).encode())
    for src in [CSRC_DIR / f'{stem}.cu', *sorted(CSRC_DIR.glob('*.cuh'))]:
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
    stem, flags = BUILDS[name]
    cmd = [_nvcc(), *NVCC_FLAGS, *flags, '-o', str(tmp), str(CSRC_DIR / f'{stem}.cu')]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for csrc/{BUILDS[name][0]}.cu ({name}):\n{log}')
    os.replace(tmp, out)          # atomic: a concurrent loader never sees half a file


def build_all() -> None:
    """Compile every build at once (one nvcc per build, all started
    together)."""
    with _lock:
        started = {n: _start(n) for n in KERNEL_SOURCES}
        for n, s in started.items():
            _finish(n, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of build ``name`` (``BUILDS``), building it first if
    needed."""
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
