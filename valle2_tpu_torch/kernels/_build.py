"""Build and load the hand-written CUDA kernels in ``valle2_tpu_torch/csrc``.

Each build has a plain C interface and is compiled on first use by ``nvcc``
(``-gencode arch=compute_90a,code=sm_90a``, Hopper) from one ``csrc/*.cu``
source (``BUILDS``: a source may be built several times with other defines)
into ``<build dir>/<name>-<key>.so``, then loaded with ``ctypes``.  The build
directory is the kernel-build cache: ``valle2_tpu_torch/_build/``
(git-ignored) unless ``compile_cache.enable_compilation_cache`` names another,
which processes and hosts may share.  The key (``library_key``) hashes the
source, the headers, the flags, the nvcc release and the card's compute
capability, so an edited kernel is rebuilt and a library built by another
toolchain or for another card is never loaded.

``aot.enable_aot_cache`` adds a second directory, searched before the build
directory and filled after a build (a copy of each library).  ``load`` looks
in process memory, then the AOT directory, then the build directory, and
builds with nvcc only when neither holds the library.  An entry that exists
but does not load (a truncated or corrupt file) is rebuilt with nvcc and
replaced; no path falls back to a kernel's plain version.  Every load from
disk or build is reported to the recorders a thread has open
(``record_loads``), which is how ``aot.CachedJit`` counts a program's builds
and disk loads.  Nothing here runs at import time: the CPU tests import every
module without a CUDA toolchain.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import logging
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / 'csrc'
BUILD_DIR = PKG_DIR / '_build'      # the default build directory
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

log = logging.getLogger('valle2_tpu_torch')
_lock = threading.RLock()
_loaded: dict[str, ctypes.CDLL] = {}
_state: dict = {'build_dir': BUILD_DIR, 'aot_dir': None, 'log_builds': False,
                'toolchain': None, 'max_size_bytes': -1}
_local = threading.local()
_dlopen = ctypes.CDLL       # how a library file is loaded (tests replace it)


def _nvcc() -> str:
    for cand in (shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels build only where the CUDA '
                       'toolkit is installed')


def build_dir() -> Path:
    """Where libraries are built and found (the kernel-build cache)."""
    return _state['build_dir']


def set_build_dir(path=None, max_size_bytes: int = -1) -> None:
    """Point the kernel-build cache at ``path`` (None: the default
    ``valle2_tpu_torch/_build/``).  ``max_size_bytes`` > 0 bounds the
    directory's libraries, the least recently used removed first."""
    with _lock:
        _state['build_dir'] = BUILD_DIR if path is None else Path(path)
        _state['max_size_bytes'] = int(max_size_bytes)


def aot_dir() -> Path | None:
    return _state['aot_dir']


def set_aot_dir(path=None) -> None:
    """The directory searched before the build directory and filled after a
    build (None: none)."""
    with _lock:
        _state['aot_dir'] = None if path is None else Path(path)


def log_builds(enable: bool = True) -> None:
    """Log each nvcc build's name and seconds (``profiling.log_compiles``)."""
    _state['log_builds'] = bool(enable)


def toolchain() -> tuple[str, str]:
    """(the nvcc release line, the card's compute capability 'major.minor'),
    read once a process: the part of the key that differs between hosts."""
    if _state['toolchain'] is None:
        out = subprocess.run([_nvcc(), '--version'], capture_output=True, text=True,
                             check=True, timeout=60).stdout
        m = re.search(r'release [^\n]*', out)
        import torch
        cc = torch.cuda.get_device_capability() if torch.cuda.is_available() else None
        _state['toolchain'] = (m.group(0) if m else out.strip().splitlines()[-1],
                               'none' if cc is None else f'{cc[0]}.{cc[1]}')
    return _state['toolchain']


def library_key(name: str) -> str:
    """Hash of everything that shapes build ``name``'s library: the flags,
    the source, every header, the nvcc release and the compute capability."""
    stem, flags = BUILDS[name]
    h = hashlib.sha256(' '.join((*NVCC_FLAGS, *flags)).encode())
    for src in [CSRC_DIR / f'{stem}.cu', *sorted(CSRC_DIR.glob('*.cuh'))]:
        h.update(src.read_bytes())
    for part in toolchain():
        h.update(b'\0' + part.encode())
    return h.hexdigest()[:16]


def _lib_name(name: str) -> str:
    return f'{name}-{library_key(name)}.so'


def _lib_path(name: str) -> Path:
    """Build ``name``'s library path in the build directory."""
    return build_dir() / _lib_name(name)


@contextlib.contextmanager
def record_loads():
    """Collect, as a list of dicts, every library this thread loads from
    disk or builds while the context is open: ``name``, ``how`` ('disk',
    'compiled' or 'rebuilt': an entry that did not load, built anew),
    ``dir``, ``build_s`` and ``load_s``."""
    stack = getattr(_local, 'recorders', None)
    if stack is None:
        stack = _local.recorders = []
    events: list[dict] = []
    stack.append(events)
    try:
        yield events
    finally:
        stack.remove(events)


def _report(event: dict) -> None:
    for events in getattr(_local, 'recorders', ()):
        events.append(event)


def _start(name: str, out: Path | None = None):
    """Start nvcc for one build into ``out`` (default: its path in the build
    directory); returns (process, tmp path, final path, start time)."""
    out = _lib_path(name) if out is None else out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.{threading.get_ident()}.tmp')
    stem, flags = BUILDS[name]
    cmd = [_nvcc(), *NVCC_FLAGS, *flags, '-o', str(tmp), str(CSRC_DIR / f'{stem}.cu')]
    log_file = tempfile.TemporaryFile(mode='w+')   # a file, not a pipe: never fills
    proc = subprocess.Popen(cmd, stdout=log_file, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter(), log_file


def _finish(name: str, started) -> float:
    """Wait for a build started by ``_start``; returns its seconds."""
    proc, tmp, out, t0, log_file = started
    proc.wait()
    seconds = time.perf_counter() - t0
    log_file.seek(0)
    text = log_file.read()
    log_file.close()
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for csrc/{BUILDS[name][0]}.cu ({name}):\n{text}')
    os.replace(tmp, out)          # atomic: a concurrent loader never sees half a file
    if _state['log_builds']:
        log.info('nvcc built %s in %.1f s', name, seconds)
    _evict(out.parent)
    return seconds


def _evict(directory: Path) -> None:
    """Keep the build directory under ``max_size_bytes``: remove the least
    recently used libraries (never the newest)."""
    cap = _state['max_size_bytes']
    if cap <= 0 or directory != build_dir():
        return
    libs = sorted(directory.glob('*.so'), key=lambda p: p.stat().st_mtime)
    total = sum(p.stat().st_size for p in libs)
    for p in libs[:-1]:
        if total <= cap:
            break
        total -= p.stat().st_size
        p.unlink(missing_ok=True)


def _publish(path: Path) -> None:
    """Copy a library into the AOT directory, when one is set."""
    adir = aot_dir()
    if adir is None or path.parent == adir:
        return
    adir.mkdir(parents=True, exist_ok=True)
    dest = adir / path.name
    tmp = dest.with_suffix(f'.{os.getpid()}.tmp')
    shutil.copyfile(path, tmp)
    os.replace(tmp, dest)


def _open(name: str) -> tuple[ctypes.CDLL, dict]:
    """Load build ``name`` through the caches; returns (library, event)."""
    fname, rebuilt = _lib_name(name), False
    for d in (aot_dir(), build_dir()):
        if d is None or not (d / fname).exists():
            continue
        path, t0 = d / fname, time.perf_counter()
        try:
            lib = _dlopen(str(path))
        except OSError as exc:
            log.warning('kernel library %s did not load (%s): rebuilding it', path, exc)
            rebuilt = True
            break
        os.utime(path)            # recently used, for the size bound
        _publish(path)
        return lib, dict(name=name, how='disk', dir=str(d), build_s=0.0,
                         load_s=time.perf_counter() - t0)
    build_s = _finish(name, _start(name))
    path, t0 = _lib_path(name), time.perf_counter()
    lib = _dlopen(str(path))
    load_s = time.perf_counter() - t0
    _publish(path)
    return lib, dict(name=name, how='rebuilt' if rebuilt else 'compiled',
                     dir=str(build_dir()), build_s=build_s, load_s=load_s)


def build_all() -> dict[str, float]:
    """Compile every build not already in the AOT or build directory (one
    nvcc per build, all started together), and publish each to the AOT
    directory.  Returns each build's seconds, start to end of its nvcc."""
    with _lock:
        started = {}
        for n in KERNEL_SOURCES:
            fname = _lib_name(n)
            if not any(d is not None and (d / fname).exists()
                       for d in (aot_dir(), build_dir())):
                started[n] = _start(n)
        seconds = {}
        while len(seconds) < len(started):      # finish each as its nvcc ends
            for n, s in started.items():
                if n not in seconds and s[0].poll() is not None:
                    seconds[n] = _finish(n, s)
                    _publish(_lib_path(n))
            time.sleep(0.05)
        return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of build ``name`` (``BUILDS``), from process
    memory, the AOT directory or the build directory, building it first if
    none holds it."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        lib, event = _open(name)
        _loaded[name] = lib
    _report(event)
    return lib


def check(status: int, what: str) -> None:
    """Raise if a launcher returned a non-zero ``cudaError_t``."""
    if status != 0:
        raise RuntimeError(f'{what}: CUDA error {status} at launch')


COUNTERS: list = []    # every LaunchCounter made


class LaunchCounter:
    """A plain count of kernel launches, read by ``chip_smoke.py`` to show
    that the main path went through a kernel.  ``launches=False`` marks a
    count that is not a launch of its own (a subset of another counter's
    launches, or calls of a plain version): ``launches()`` leaves it out."""

    def __init__(self, launches: bool = True):
        self.count = 0
        self.launches = launches
        COUNTERS.append(self)

    def reset(self) -> None:
        self.count = 0


def launches() -> int:
    """Kernel launches counted so far, over every counter of a launch."""
    return sum(c.count for c in COUNTERS if c.launches)
