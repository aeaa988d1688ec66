"""The AOT library directory and the call sites that count a program's
builds (``valle2_tpu/aot.py``).

In the JAX package this layer serializes compiled executables, so that a
restarted process skips tracing and compiling.  The port compiles nothing
but its nvcc builds, so the two layers share one cache of built libraries
(``kernels._build``): the AOT directory (``enable_aot_cache``, CLI
``--aot-cache``, ``$VALLE2_AOT_CACHE``, ``config.aot_cache_dir``) is searched
before the kernel-build cache (``compile_cache.py``) and filled after a build,
so a fleet can ship a directory of finished libraries beside a build
directory of its own.

``cached_jit(fn, tag=...)`` wraps the same call sites as the JAX package
(the fused TTS call, a stream's NAR + codec emission, the train step).  On
the first call of each signature (``tag``, ``extra_key``, and the
structure, shapes, dtypes and devices of the arguments) it records the
libraries the program loads from disk or builds while it runs
(``_build.record_loads``) and counts them:

- ``n_compiles``: nvcc runs;
- ``n_disk_loads``: libraries loaded from the AOT or build directory;
- ``n_fallbacks``: entries that existed but did not load, rebuilt with nvcc
  and replaced (each also counts in ``n_compiles``).

A library already loaded by the process counts in none of them, and later
calls of a signature only run ``fn``.  Where the JAX package falls back to
plain jit when a cached executable fails, the port never falls back: a bad
library is rebuilt, and the kernels run.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
from pathlib import Path

import torch

from .compile_cache import resolve_dir
from .kernels import _build
from .utils import log_info

__all__ = ['enable_aot_cache', 'disable_aot_cache', 'aot_cache_dir', 'resolve_aot_dir',
           'cached_jit', 'CachedJit', 'config_key']

_ENV_VAR = 'VALLE2_AOT_CACHE'


def resolve_aot_dir(cache_dir: str | os.PathLike | None = None,
                    fallback: str | os.PathLike | None = None) -> str | None:
    """Same precedence as ``compile_cache.resolve_cache_dir``: explicit arg >
    $VALLE2_AOT_CACHE > fallback; empty everywhere = disabled."""
    return resolve_dir(_ENV_VAR, cache_dir, fallback)


def enable_aot_cache(cache_dir: str | os.PathLike | None = None, *,
                     fallback: str | os.PathLike | None = None) -> str | None:
    """Search the resolved directory before the kernel-build cache and fill
    it after each build; returns it (or None when disabled everywhere)."""
    d = resolve_aot_dir(cache_dir, fallback)
    if d is None:
        return None
    Path(d).mkdir(parents=True, exist_ok=True)
    _build.set_aot_dir(d)
    log_info('AOT library directory enabled at %s', d)
    return d


def disable_aot_cache() -> None:
    _build.set_aot_dir(None)


def aot_cache_dir() -> str | None:
    d = _build.aot_dir()
    return None if d is None else str(d)


def _sig(x, out: list) -> None:
    """Append the signature of one argument: structure, and each tensor's
    shape, dtype and device; a config by its fingerprint; scalars by value;
    any other object by its type."""
    if isinstance(x, torch.Tensor):
        out.append(f'T{tuple(x.shape)}|{x.dtype}|{x.device}')
    elif isinstance(x, dict):
        out.append('{')
        for k, v in x.items():
            out.append(repr(k))
            _sig(v, out)
        out.append('}')
    elif isinstance(x, (list, tuple)):
        out.append(f'{type(x).__name__}[')
        for v in x:
            _sig(v, out)
        out.append(']')
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        out.append(f'cfg:{config_key(x)}')
    elif x is None or isinstance(x, (bool, int, float, str)):
        out.append(repr(x))
    else:
        out.append(type(x).__qualname__)


class CachedJit:
    """``fn`` with its kernel libraries counted through the caches, per call
    signature (see the module docstring)."""

    def __init__(self, fn, *, tag: str, extra_key: str = ''):
        self._fn = fn
        self._tag = tag
        self._extra = extra_key
        self._seen: set[str] = set()
        self._lock = threading.Lock()
        self.n_compiles = 0
        self.n_disk_loads = 0
        self.n_fallbacks = 0

    def _key(self, args, kwargs) -> str:
        parts: list = [self._tag, self._extra]
        _sig(args, parts)
        _sig(kwargs, parts)
        return hashlib.sha256('\x00'.join(parts).encode()).hexdigest()[:24]

    def __call__(self, *args, **kwargs):
        key = self._key(args, kwargs)
        with self._lock:
            first = key not in self._seen
            self._seen.add(key)
        if not first:
            return self._fn(*args, **kwargs)
        with _build.record_loads() as events:
            out = self._fn(*args, **kwargs)
        with self._lock:
            for e in events:
                if e['how'] == 'disk':
                    self.n_disk_loads += 1
                else:
                    self.n_compiles += 1
                    self.n_fallbacks += e['how'] == 'rebuilt'
        return out


def cached_jit(fn, *, tag: str, extra_key: str = '') -> CachedJit:
    """``fn`` as a ``CachedJit``: ``tag`` names the program, ``extra_key``
    carries what its closure bakes in (pass the config fingerprint)."""
    return CachedJit(fn, tag=tag, extra_key=extra_key)


def config_key(config) -> str:
    """Stable fingerprint of a ConfigValle for ``extra_key``."""
    try:
        blob = json.dumps(dataclasses.asdict(config), sort_keys=True, default=str)
    except TypeError:
        blob = repr(config)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]
