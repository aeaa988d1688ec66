"""Configuration for the PyTorch/CUDA port of the VALL-E framework.

Same fields, defaults, derived properties and loaders as ``valle2_tpu/config.py``,
so every JSON config written for the JAX package loads here unchanged.  The
port serves TTS (cloning from a prompt recording) and ASR, tokenizes audio
datasets and trains the AR, NAR and ASR models on one device so far (on
the synthetic or the ``grammar://`` dataset, ``remat`` checkpointing each
layer), and
serves with quantized weights (``weight_dtype='int8'`` W8A8 or ``'int4'``
W4A16, ``quantize.py``), an int8 KV cache (``kv_cache_dtype='int8'``) and
n-gram speculative decode (``speculative_k`` >= 2 with one beam), streams
(``DecodeStream``, ``synthesize_streaming``, ``synthesize_longform``) with
``decode_unroll`` and a chunked cache (``decode_chunk``, ``VALLE2_FUSED_CHUNK``),
and fine-tunes LoRA adapters (``lora_rank`` > 0, ``lora.py``; on one device:
the data and pipeline meshes it excludes in the JAX package are not ported)
(ROADMAP.md): a non-default value of a feature outside those paths raises
``NotImplementedError`` naming the ROADMAP item that will bring it, instead
of being silently ignored.  ``codec_ckpt`` reaches ``Encodec(checkpoint=...)``
in ``data.ValleDataset``, as in the JAX package.

Backend switches differ from the JAX package:

- ``use_flash_attention`` / ``use_fused_decode`` ``'auto'`` mean "on when the
  tensors live on a CUDA device and the kernels take the model's shape"
  (``flash_enabled`` / ``fused_decode_enabled`` take the device and read the
  head dim and widths from the config, before any launch); flash routes the
  AR prefill and the AR/NAR training losses, the fused step the decode and
  speculative verify loops.  Elsewhere the kernels' plain PyTorch versions
  run.  ``True`` sends every tensor to the kernels, which raise on a shape
  they do not take.
- ``train_rng_impl`` and ``train_scan_unroll`` are JAX compilation choices
  (the PRNG implementation, the layer scan's unroll) with no counterpart in
  an eager PyTorch step: accepted for config compatibility and not read.
- Entry points put their tensors on the CUDA card unless the caller asks for
  another device (``resolve_device``).
- ``matmul_precision='highest'`` is the parity switch: it turns TF32 off for
  both cuBLAS matmuls and cuDNN convolutions (``precision_scope``).  Any other
  value leaves TF32 on, the speed setting.  Codec encode ignores it and
  always runs with TF32 off (``tf32_scope(False)``): its codes feed an argmax.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Literal

import torch

# (field, default, ROADMAP.md item that ports it)
_NOT_YET = (
    ('decode_attn_buckets', 4, 'queue 1 item 2 (the rest of ops/, prefix buckets)'),
    ('zero1', False, 'queue 1 item 14 (parallelism, ZeRO-1)'),
    ('sequence_parallel', False, 'queue 1 item 14 (parallelism, sequence parallel)'),
    ('mesh_data', 1, 'queue 1 item 14 (parallelism)'),
    ('mesh_model', 1, 'queue 1 item 14 (parallelism)'),
    ('mesh_pipe', 1, 'queue 1 item 14 (parallelism)'),
    ('mesh_ctx', 1, 'queue 1 item 14 (parallelism)'),
    ('pp_microbatches', 1, 'queue 1 item 14 (parallelism, pipeline)'),
    ('pp_schedule', 'gpipe', 'queue 1 item 14 (parallelism, pipeline)'),
)

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}
_CACHE_DTYPES = dict(_DTYPES, int8=torch.int8)


@dataclass
class ConfigValle:
    # Data
    dataset: str = 'keithito/lj_speech'
    num_workers: int = 4

    # Input features
    vocab_size: int = 256
    num_audio_tokens: int = 1024
    num_quantizers: int = 8
    sampling_rate: int = 16000
    polling_factor: int = 320

    # Model
    d_model: int = 256
    n_heads: int = 4
    dim_feedforward: int = 1024
    dropout: float = 0.1
    activation: Literal['relu', 'gelu'] = 'relu'
    num_layers: int = 8
    norm: Literal['AdaptiveLayerNorm', 'LayerNorm'] = 'AdaptiveLayerNorm'

    # Optimizer
    lr: float = 1e-4
    lr_warmup: int = 1000
    betas: tuple = (0.9, 0.98)
    weight_decay: float = 0.1
    use_fused_adam: bool = True
    gradient_clip_val: float = 1.0
    grad_accum: int = 1

    # Generation
    max_audio_len: int = 1024
    num_beams: int = 4
    use_kv_cache: bool = True
    top_k: int = 50
    tok_p: float = 1.0
    temperature: float = 1.0
    length_penalty: float = 1.0

    # Training
    seed: int = 42
    batch_size: int = 4
    valid_batch_size: int = 1
    max_steps: int = 1000
    log_every_n_steps: int = 100
    ckpt_path: Path = Path('models/checkpoints')
    log_path: Path = Path('models/logs')

    # ---- additions of the JAX package (same names and defaults) ----
    dtype: str = field(default='float32', metadata={
        'help': 'Activation/compute dtype: float32 (parity) or bfloat16 (speed)'})
    param_dtype: str = 'float32'
    matmul_precision: str = field(default='default', metadata={
        'help': "'highest' turns TF32 off for matmul and cuDNN (parity runs)"})
    mask_loss_pads: bool = True
    use_flash_attention: bool | str = field(default='auto', metadata={
        'help': "CUDA flash-attention kernel for the AR prefill: True | False | "
                "'auto' (on when the tensors are on CUDA)"})
    remat: bool = False
    train_scan_unroll: int = 1            # JAX scan unroll: not read by the port
    train_rng_impl: Literal['threefry2x32', 'rbg'] = 'rbg'   # JAX PRNG: not read
    mesh_data: int = 1
    mesh_model: int = 1
    mesh_pipe: int = 1
    pp_microbatches: int = 1
    mesh_ctx: int = 1
    pp_schedule: Literal['gpipe', '1f1b'] = 'gpipe'
    bucket_sizes: tuple = (128, 256, 384, 512, 768, 1024)
    direction: Literal['tts', 'asr'] = 'tts'
    schedule: Literal['cosine_restarts', 'warmup_cosine', 'constant'] = 'cosine_restarts'
    ckpt_every_n_steps: int = 500
    ignore_eos: bool = field(default=False, metadata={
        'help': 'Decode exactly max_audio_len steps (benchmarking)'})
    kv_cache_dtype: str = field(default='bfloat16', metadata={
        'help': "Decode KV cache storage: 'float32' | 'bfloat16' | 'int8' "
                '(per-(slot, head) symmetric int8 with bfloat16 scales)'})
    codec_ckpt: str = ''
    codes_cache_dir: str = ''
    keep_checkpoints: int = 0
    async_checkpoint: bool = True
    preempt_checkpoint: bool = True
    compile_cache_dir: str = ''
    aot_cache_dir: str = ''
    prefetch_batches: int = 2
    weight_dtype: str = 'compute'
    decode_attn_buckets: int = field(default=4, metadata={
        'help': 'Accepted at its default only; the port reads the valid cache '
                'slots directly, so prefix buckets have nothing to save'})
    decode_unroll: int = field(default=1, metadata={
        'help': 'AR decode steps per loop turn (outputs identical for any value); '
                'a stream advances in multiples of it'})
    decode_chunk: int = field(default=0, metadata={
        'help': 'Fused-decode cache chunk in slots: 0 = auto (whole-S unless the '
                "TPU kernel's k+v block would pass 8 MB); a forced chunk splits the "
                'attention over the cache (kernels.fused_decode.chunk_for)'})
    zero1: bool = False
    sequence_parallel: bool = False
    speculative_k: int = 0
    speculative_ngram: int = 3
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: tuple = ('qkv', 'out', 'lin1', 'lin2')
    lora_base: str = ''
    nar_corrupt_p: float = 0.0
    use_fused_decode: bool | str = field(default='auto', metadata={
        'help': "CUDA fused whole-stack decode step: True | False | 'auto' (on "
                'when the tensors are on CUDA)'})

    def __post_init__(self):
        if self.dataset is None:
            raise ValueError('Dataset must be provided')
        if self.norm not in ('AdaptiveLayerNorm', 'LayerNorm'):
            raise ValueError('Normalization layer must be AdaptiveLayerNorm or LayerNorm')
        if self.activation not in ('relu', 'gelu'):
            raise ValueError('Activation function must be relu or gelu')
        if self.weight_dtype not in ('compute', 'int8', 'int4'):
            raise ValueError("weight_dtype must be 'compute', 'int8' or 'int4'")
        if self.pp_schedule not in ('gpipe', '1f1b'):
            raise ValueError("pp_schedule must be 'gpipe' or '1f1b', got "
                             f'{self.pp_schedule!r}')
        for name, default, item in _NOT_YET:
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f'{name}={getattr(self, name)!r} is not ported to PyTorch yet '
                    f'(ROADMAP.md {item})')
        for name, allowed in (('dtype', _DTYPES), ('param_dtype', _DTYPES),
                              ('kv_cache_dtype', _CACHE_DTYPES)):
            if getattr(self, name) not in allowed:
                raise ValueError(f'{name} must be one of {sorted(allowed)}, got '
                                 f'{getattr(self, name)!r}')
        self.ckpt_path = Path(self.ckpt_path)
        self.log_path = Path(self.log_path)
        self.betas = tuple(self.betas)
        self.bucket_sizes = tuple(self.bucket_sizes)
        self.lora_targets = tuple(self.lora_targets)

    # Derived properties — reference config.py:79-89.
    @property
    def quantization_factor(self) -> int:
        return self.sampling_rate // self.polling_factor

    @property
    def bos_token(self) -> int:
        return self.num_audio_tokens + 1

    @property
    def eos_token(self) -> int:
        return self.num_audio_tokens

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def torch_param_dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def torch_cache_dtype(self) -> torch.dtype:
        return _CACHE_DTYPES[self.kv_cache_dtype]

    def flash_enabled(self, device) -> bool:
        """Resolve ``use_flash_attention`` for tensors on ``device``: 'auto' is
        on for CUDA when the flash kernels take the head dim (32, 64 or 128);
        another head dim (16, 96, ...) takes the plain attention on the card,
        decided here from the config before any launch.  ``True`` always takes
        the kernels, which raise on another head dim.  (A method, not the JAX
        package's property: the answer depends on where the tensors live, not
        on a global backend.)"""
        if self.use_flash_attention == 'auto':
            from .kernels.flash_attention import HEAD_DIMS
            return (torch.device(device).type == 'cuda' and self.d_model % self.n_heads == 0
                    and self.head_dim in HEAD_DIMS)
        return bool(self.use_flash_attention)

    def fused_decode_enabled(self, device, mp: int = 1) -> bool:
        """Resolve ``use_fused_decode`` for tensors on ``device``: 'auto' is on
        for CUDA when the fused decode and verify kernels take the stack --
        head dim 32, 64, 96 or 128, projection inputs up to 6144 wide (5120
        under ``weight_dtype='int8'``; ``kernels.fused_decode.fit_error``), the
        counterpart of the JAX ``_fused_gate``'s fit check; another stack
        takes the plain step on the card, decided here before the loop.
        ``True`` always takes the kernels, which raise on such a stack.
        Unlike the JAX gate, 'highest' precision does not turn it off: the
        CUDA kernel computes in full f32 when the model is f32.  ``mp`` > 1:
        the tensor-parallel steps over mp ranks, the fit read at a rank's
        widths; int8 weights always take the plain tensor-parallel path
        (JAX ``_fused_gate`` with ``tp_mp``)."""
        if mp > 1 and self.weight_dtype == 'int8':
            return False
        if self.use_fused_decode == 'auto':
            from .kernels.fused_decode import LAYOUT_OF_WEIGHT_DTYPE, fit_error
            return torch.device(device).type == 'cuda' and fit_error(
                self.d_model, self.n_heads, self.dim_feedforward,
                LAYOUT_OF_WEIGHT_DTYPE[self.weight_dtype], mp) is None
        return bool(self.use_fused_decode)

    def ensure_dirs(self) -> None:
        """Create the checkpoint and log dirs (at trainer start, not here in
        the config, so that building a config touches no file)."""
        self.ckpt_path.mkdir(parents=True, exist_ok=True)
        self.log_path.mkdir(parents=True, exist_ok=True)

    @classmethod
    def from_dict(cls, hparams_dict: dict) -> 'ConfigValle':
        """Build from a dict; unknown keys are ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in hparams_dict.items() if k in names})

    @classmethod
    def from_json(cls, json_file) -> 'ConfigValle':
        with open(json_file, encoding='utf-8') as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d['ckpt_path'] = str(d['ckpt_path'])
        d['log_path'] = str(d['log_path'])
        return d


# The TF32 flags are process-wide, and the stream hub's threads open scopes
# that overlap in time (a join's prefill beside the driver's decode), so the
# open scopes are kept in one list: the flags follow the newest, and the
# settings from before the first come back when the last closes, in whatever
# order the threads close theirs.
_TF32_LOCK = threading.Lock()
_TF32_OPEN: list[tuple[object, bool]] = []   # (token, allow) per open scope, oldest first
_TF32_BEFORE: list[tuple[bool, bool]] = []


def _set_tf32(matmul: bool, cudnn: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


@contextlib.contextmanager
def tf32_scope(allow: bool):
    """TF32 on or off for both cuBLAS and cuDNN inside the scope; the previous
    settings are restored when the last open scope (of any thread) exits."""
    mine = (object(), allow)
    with _TF32_LOCK:
        if not _TF32_OPEN:
            _TF32_BEFORE[:] = [(torch.backends.cuda.matmul.allow_tf32,
                                torch.backends.cudnn.allow_tf32)]
        _TF32_OPEN.append(mine)
        _set_tf32(allow, allow)
    try:
        yield
    finally:
        with _TF32_LOCK:
            _TF32_OPEN.remove(mine)    # equal only to itself: its token is unique
            _set_tf32(*(2 * (_TF32_OPEN[-1][1],) if _TF32_OPEN else _TF32_BEFORE[0]))


def precision_scope(config: ConfigValle):
    """Counterpart of ``jax.default_matmul_precision(config.matmul_precision)``:
    'highest' turns TF32 off for cuBLAS and cuDNN inside the scope; any other
    value turns it on."""
    return tf32_scope(config.matmul_precision != 'highest')


def resolve_device(device=None) -> torch.device:
    """The device an entry point puts its tensors on: the CUDA card unless the
    caller names another.  Without a card, ``None`` raises instead of falling
    back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA card is available: pass device="cpu" to run on '
                               'the CPU')
        return torch.device('cuda')
    return torch.device(device)


def torch_dtype(name: str) -> torch.dtype:
    """'float32' | 'bfloat16' → the torch dtype."""
    return _DTYPES[name]


def bucket_len(bucket_sizes, n: int) -> int:
    """Smallest bucket >= n, or n itself when none fits (the JAX package's rule)."""
    for b in bucket_sizes:
        if n <= b:
            return b
    return n
