"""valle2_tpu_torch — the VALL-E X framework ported to PyTorch and CUDA (Hopper).

A second package beside the JAX one (``valle2_tpu``), which stays the
reference.  It imports neither JAX nor ``valle2_tpu``.  Ported so far: the TTS
serving path (``tts.ValleTTS``, voice cloning from a prompt recording,
streaming and long-form synthesis) and ASR (``tts.ValleASRPipeline``) with
hand-written CUDA kernels for the AR prefill (``kernels.flash_attention``),
the AR token step (``kernels.fused_decode``) and the codec's RVQ encode
(``kernels.rvq``); continuous batching (``models.continuous``) and the
stream hub that serves concurrent streams through it (``stream_hub``);
audio datasets tokenized through the codec (``data.ValleDataset``); and
training (``train``) through the flash forward and backward kernels, with
LoRA fine-tuning (``lora``), on one device or over a ('data', 'model') mesh
(data parallel, ZeRO-1, Megatron tensor parallel, sequence parallel; over
several processes with ``parallel.init_distributed``); serving over a
('model',) or ('data', 'model') mesh of cards (``parallel``, the all-reduce
``kernels.tp_allreduce``); and the dynamic-batching HTTP server with
multi-voice serving (``serve``); checkpoints of the reference stack
(``models.convert``), native audio I/O (``native.audio``), traces and NaN
checks (``profiling``) and the kernel-build caches (``compile_cache``,
``aot``); see ROADMAP.md for what remains.
"""

from .config import ConfigValle, bucket_len

# User-facing classes resolve lazily (PEP 562), as in the JAX package: the
# config imports without the models.
_LAZY = {
    'ValleTTS': '.tts', 'ValleASRPipeline': '.tts', 'StreamHub': '.stream_hub',
    'TTSServer': '.serve', 'serve_http': '.serve',
    'ValleAR': '.models', 'ValleNAR': '.models', 'Trainer': '.train',
    'enable_aot_cache': '.aot', 'enable_compilation_cache': '.compile_cache',
}

__all__ = ['ConfigValle', 'bucket_len', *sorted(_LAZY)]


def __getattr__(name: str):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
    import importlib
    return getattr(importlib.import_module(target, __name__), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
