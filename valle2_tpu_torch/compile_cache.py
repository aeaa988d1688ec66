"""The kernel-build cache: where the port's CUDA libraries are built and
found (``valle2_tpu/compile_cache.py``).

What compiles in the port is nvcc: each kernel build (``kernels._build.BUILDS``)
is compiled on first use, 70-116 s for all of them on an H100 host, and
loaded with ctypes.  A restarted process, a re-run CLI or a resumed training
run finds the libraries already built in this directory and loads them
instead.  The directory is content-addressed: a library's name carries a hash
of its source, headers and flags, the nvcc release and the card's compute
capability (``_build.library_key``), so a directory shared between configs,
checkouts or hosts never serves a stale library; stale entries are simply
never hit, and ``max_size_bytes`` bounds the directory, least recently used
first.

Resolution order for the directory (first non-empty wins):

1. explicit ``cache_dir`` argument (CLI ``--compile-cache``),
2. ``$VALLE2_COMPILE_CACHE``,
3. the caller's fallback (entry points pass ``config.compile_cache_dir``).

Empty everywhere means the default, ``valle2_tpu_torch/_build/``.  Call it
before the first kernel launch of the process: a library already loaded
stays loaded.
"""

from __future__ import annotations

import os
from pathlib import Path

from .kernels import _build
from .utils import log_info

__all__ = ['enable_compilation_cache', 'resolve_cache_dir', 'cache_dir']

_ENV_VAR = 'VALLE2_COMPILE_CACHE'


def resolve_dir(env_var: str, cache_dir=None, fallback=None) -> str | None:
    """The first non-empty of ``cache_dir``, ``$env_var`` and ``fallback``,
    with ``~`` expanded; None when all are empty."""
    for candidate in (cache_dir, os.environ.get(env_var), fallback):
        if candidate is not None and str(candidate):
            return str(Path(candidate).expanduser())
    return None


def resolve_cache_dir(cache_dir: str | os.PathLike | None = None,
                      fallback: str | os.PathLike | None = None) -> str | None:
    """Apply the documented precedence; None when nothing names a directory
    (the default is then in use)."""
    return resolve_dir(_ENV_VAR, cache_dir, fallback)


def enable_compilation_cache(cache_dir: str | os.PathLike | None = None, *,
                             fallback: str | os.PathLike | None = None,
                             max_size_bytes: int = -1) -> str | None:
    """Point the kernel builds at the resolved directory; returns it, or None
    when nothing names one (the default directory is then in use).
    ``max_size_bytes``: bound the directory's libraries; -1 = unbounded."""
    path = resolve_cache_dir(cache_dir, fallback)
    if path is None:
        _build.set_build_dir(None, max_size_bytes)
        return None
    Path(path).mkdir(parents=True, exist_ok=True)
    _build.set_build_dir(path, max_size_bytes)
    log_info('Kernel-build cache: %s', path)
    return path


def cache_dir() -> str:
    """The directory the kernel builds use now."""
    return str(_build.build_dir())
