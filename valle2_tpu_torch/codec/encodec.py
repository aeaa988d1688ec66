"""EnCodec decode in PyTorch (``valle2_tpu/codec/encodec.py``, decode half).

Same shapes and layouts as the JAX ``EncodecTPU`` decode surface: codes
(n_q, F) or (B, n_q, F) → 24 kHz waveform (F*320 samples).  Weights come from
a seeded random init (the repo holds no trained checkpoint) or from
``models.convert.codec_params_from_numpy``.
"""

from __future__ import annotations

from typing import Any

import torch

from ..config import resolve_device, torch_dtype
from ..ops.transformer import map_tree
from . import rvq as _rvq
from . import seanet

Params = dict[str, Any]

SAMPLE_RATE = 24_000
NUM_QUANTIZERS = 8
CODEBOOK_SIZE = 1024
LATENT_DIM = 128
HOP = seanet.HOP


def init_params(gen: torch.Generator, dtype=torch.float32) -> Params:
    """Decoder + RVQ codebooks (the encoder is not ported yet)."""
    return {'decoder': seanet.decoder_init(gen, dtype),
            'rvq': _rvq.rvq_init(gen, NUM_QUANTIZERS, CODEBOOK_SIZE, LATENT_DIM, dtype)}


def decode(params: Params, codes: torch.Tensor) -> torch.Tensor:
    """(B, n_q, F) codes → (B, F*320) waveform."""
    latents = _rvq.rvq_decode(params['rvq'], codes)
    return seanet.decode(params['decoder'], latents)


class Encodec:
    """Decode side of the codec.  ``decode_dtype``: the waveform synthesis
    dtype (the TTS path follows the model's compute dtype, as in JAX)."""

    def __init__(self, params: Params | None = None, seed: int = 0,
                 decode_dtype: str = 'float32', device=None):
        self.device = resolve_device(device)
        if params is None:
            params = init_params(torch.Generator().manual_seed(seed))
        ddtype = torch_dtype(decode_dtype)
        self.params = map_tree(lambda a: a.to(self.device), params)
        self.dec_params = map_tree(lambda a: a.to(ddtype), self.params)

    @property
    def sampling_rate(self) -> int:
        return SAMPLE_RATE

    def decode(self, codes) -> torch.Tensor:
        """(n_q, F) codes → 1-D f32 waveform (F*320,)."""
        codes = torch.as_tensor(codes, dtype=torch.long, device=self.device)
        if codes.dim() != 2:
            raise ValueError(f'expected 2-D (n_q, F) codes, got {codes.dim()}-D')
        return self.batch_decode(codes[None])[0]

    def batch_decode(self, codes) -> torch.Tensor:
        """(B, n_q, F) codes → (B, F*320) f32 waveforms."""
        codes = torch.as_tensor(codes, dtype=torch.long, device=self.device)
        if codes.dim() != 3:
            raise ValueError(f'expected 3-D (B, n_q, F) codes, got {codes.dim()}-D')
        with torch.inference_mode():
            return decode(self.dec_params, codes).float()
