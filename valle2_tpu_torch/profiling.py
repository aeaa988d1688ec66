"""Tracing, profiling and numerics-debugging hooks (``valle2_tpu/profiling.py``).

- ``trace(logdir)``: a ``torch.profiler`` trace of the host and the card,
  written as ``logdir/trace.json`` (Chrome / Perfetto format).  It compares
  the trace's records of the port's kernels (the ``__global__`` functions of
  ``csrc/``) with the launches the kernels' ``LaunchCounter``s counted in its
  window, and warns when the trace holds fewer: the profiler loses records
  late in long processes.
- ``annotate(name)``: a named range in the trace, as a context manager or a
  decorator.  The TTS pipeline's stages and the train step carry one.
- ``enable_nan_checks()``: autograd's anomaly detection, and a finite check
  of each train step's loss and grads that raises ``FloatingPointError``
  (the counterpart of ``jax_debug_nans``).
- ``log_compiles()``: logs each nvcc build with its seconds; those builds are
  what compiles in the port.
- ``memory_stats()``: the card's bytes in use, their peak and its memory.
- ``train_step_flops`` / ``nar_train_step_flops``: analytic matmul FLOPs of a
  train step; over its time and ``H100_PEAK_BF16_FLOPS`` they give the MFU.
"""

from __future__ import annotations

import contextlib
import functools
import json
import re
from pathlib import Path

import torch

from .kernels import _build
from .utils import log_info, log_warning

H100_PEAK_BF16_FLOPS = 989e12
"""Dense bf16 tensor-core peak of one NVIDIA H100 SXM (80 GB HBM3), FLOP/s."""

_NAN_CHECKS = {'on': False}


@functools.lru_cache(maxsize=1)
def kernel_names() -> frozenset:
    """The ``__global__`` function names of the port's CUDA sources."""
    pat = re.compile(r'__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(')
    names = set()
    for src in sorted(_build.CSRC_DIR.glob('*.cu*')):
        names.update(pat.findall(src.read_text()))
    return frozenset(names)


def _kernel_of(name: str) -> str | None:
    """The port's kernel a device record runs, or None."""
    for word in re.findall(r'\w+', name):
        if word in kernel_names():
            return word
    return None


class TraceStats:
    """What a ``trace`` window held, filled when it closes: ``path`` (the
    trace file), ``launches`` (counted by the kernels' ``LaunchCounter``s),
    ``kernel_records`` (the trace's device records of the port's kernels),
    ``by_kernel`` (those records by kernel name) and ``device_records`` (every
    device kernel record)."""

    def __init__(self, path: Path):
        self.path = path
        self.launches = 0
        self.kernel_records = 0
        self.device_records = 0
        self.by_kernel: dict[str, int] = {}


@contextlib.contextmanager
def trace(logdir: str | Path):
    """Capture a trace: ``with trace('logs/profile') as stats: step(...)``;
    writes ``logdir/trace.json`` and fills ``stats`` (``TraceStats``)."""
    from torch.profiler import ProfilerActivity, profile
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    stats = TraceStats(logdir / 'trace.json')
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    n0 = _build.launches()
    with profile(activities=activities) as prof:
        try:
            yield stats
        finally:
            if cuda:
                torch.cuda.synchronize()
    stats.launches = _build.launches() - n0
    prof.export_chrome_trace(str(stats.path))
    with open(stats.path) as f:
        events = json.load(f).get('traceEvents', [])
    for e in events:
        if e.get('cat') != 'kernel':
            continue
        stats.device_records += 1
        k = _kernel_of(e.get('name', ''))
        if k is not None:
            stats.kernel_records += 1
            stats.by_kernel[k] = stats.by_kernel.get(k, 0) + 1
    if stats.kernel_records < stats.launches:
        log_warning('trace %s holds %d records of the port\'s kernels for %d launches '
                    'counted: the profiler lost records', stats.path,
                    stats.kernel_records, stats.launches)
    log_info('Trace written to %s (%d kernel launches, %d of their records)', stats.path,
             stats.launches, stats.kernel_records)


def annotate(name: str):
    """A named range of the trace (``torch.profiler.record_function``),
    usable as a context manager or a decorator."""
    return torch.profiler.record_function(name)


def enable_nan_checks(enable: bool = True) -> None:
    """Autograd anomaly detection, and the train step's finite check of its
    loss and grads (``FloatingPointError`` on the first NaN or Inf)."""
    _NAN_CHECKS['on'] = bool(enable)
    torch.autograd.set_detect_anomaly(bool(enable))


def nan_checks_enabled() -> bool:
    return _NAN_CHECKS['on']


def log_compiles(enable: bool = True) -> None:
    """Log each nvcc build of a kernel library: its name and seconds."""
    _build.log_builds(enable)


def memory_stats(device=None) -> dict:
    """Bytes in use, their peak and the card's memory for ``device`` (default:
    the current card); zeros on the CPU."""
    dev = torch.device(device) if device is not None else (
        torch.device('cuda') if torch.cuda.is_available() else torch.device('cpu'))
    if dev.type != 'cuda':
        return {'bytes_in_use': 0, 'peak_bytes_in_use': 0, 'bytes_limit': 0}
    return {'bytes_in_use': torch.cuda.memory_allocated(dev),
            'peak_bytes_in_use': torch.cuda.max_memory_allocated(dev),
            'bytes_limit': torch.cuda.get_device_properties(dev).total_memory}


def train_step_flops(config, batch: int, tokens_len: int, codes_len: int) -> float:
    """Matmul FLOPs of one AR train step (fwd + bwd ≈ 3 × fwd): the fused QKV,
    output and FFN projections, the attention score and value products over
    the full s² (what the kernels compute before their block skip), and the
    output head.  Embedding gathers and elementwise ops are excluded."""
    s = tokens_len + codes_len
    d, layers, dff = config.d_model, config.num_layers, config.dim_feedforward
    mm_per_tok = layers * 2 * (4 * d * d + 2 * d * dff)
    attn_per_tok = layers * 4 * s * d
    head_per_code = 2 * d * (config.num_audio_tokens + 1)
    fwd = batch * (s * (mm_per_tok + attn_per_tok) + codes_len * head_per_code)
    return 3.0 * fwd


def nar_train_step_flops(config, batch: int, tokens_len: int, codes_len: int) -> float:
    """Matmul FLOPs of one NAR train step (fwd + bwd ≈ 3 × fwd): the AR
    accounting of the stack, plus the 8-way codebook-embedding reduction and
    the one-stage output head over the code positions."""
    s = tokens_len + codes_len
    d, layers, dff = config.d_model, config.num_layers, config.dim_feedforward
    nq = config.num_quantizers
    mm_per_tok = layers * 2 * (4 * d * d + 2 * d * dff)
    attn_per_tok = layers * 4 * s * d
    head_per_code = 2 * d * config.num_audio_tokens
    embed_reduce = 2 * codes_len * nq * d
    fwd = batch * (s * (mm_per_tok + attn_per_tok) + codes_len * head_per_code
                   + embed_reduce)
    return 3.0 * fwd
