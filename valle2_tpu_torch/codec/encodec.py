"""EnCodec in PyTorch (``valle2_tpu/codec/encodec.py``): 24 kHz, 8 codebooks.

Same shapes and layouts as the JAX ``EncodecTPU``: encode (T,) or (B, T)
waveforms → codes (n_q, F) or (B, n_q, F) with F = ceil(T/320); decode the
reverse; embeddings (128, F) channel-first.  Encode runs the SEANet encoder,
then the residual VQ through ``kernels.rvq.rvq_encode_fused`` (the CUDA kernel
on the card, its plain version on the CPU).  Encode and embed always compute
in float32 with TF32 off for cuBLAS and cuDNN, whatever the caller's scope:
their codes feed an argmax and must match the reference exactly (the JAX
package runs them at ``precision='highest'``).  Weights come from a seeded
random init, an EnCodec checkpoint (``codec.convert``) or a params dict.
"""

from __future__ import annotations

import hashlib
from typing import Any

import numpy as np
import torch

from ..config import resolve_device, tf32_scope, torch_dtype
from ..kernels import rvq as _krvq
from ..ops.transformer import map_tree
from . import rvq as _rvq
from . import seanet
from .convert import load_torch_checkpoint

Params = dict[str, Any]

SAMPLE_RATE = 24_000
NUM_QUANTIZERS = 8
CODEBOOK_SIZE = 1024
LATENT_DIM = 128
HOP = seanet.HOP


def init_params(gen: torch.Generator, dtype=torch.float32) -> Params:
    """Encoder, decoder and RVQ codebooks, drawn in that order."""
    return {'encoder': seanet.encoder_init(gen, dtype),
            'decoder': seanet.decoder_init(gen, dtype),
            'rvq': _rvq.rvq_init(gen, NUM_QUANTIZERS, CODEBOOK_SIZE, LATENT_DIM, dtype)}


def encode(params: Params, wav: torch.Tensor, n_q: int = NUM_QUANTIZERS) -> torch.Tensor:
    """(B, T) waveform → (B, n_q, ceil(T/320)) int32 codes."""
    latents = seanet.encode(params['encoder'], wav).contiguous()
    return _krvq.rvq_encode_fused(params['rvq']['codebooks'], latents, n_q)


def decode(params: Params, codes: torch.Tensor) -> torch.Tensor:
    """(B, n_q, F) codes → (B, F*320) waveform."""
    latents = _rvq.rvq_decode(params['rvq'], codes)
    return seanet.decode(params['decoder'], latents)


def embed(params: Params, wav: torch.Tensor) -> torch.Tensor:
    """(B, T) waveform → (B, F, 128) pre-VQ latents."""
    return seanet.encode(params['encoder'], wav)


def _tree_items(tree, path: str = ''):
    """(path, leaf) pairs in ``jax.tree_util`` order and ``keystr`` form:
    dict keys sorted, list items in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_items(tree[k], f"{path}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_items(v, f'{path}[{i}]')
    else:
        yield path, tree


class Encodec:
    """The codec on one device.  ``decode_dtype``: the waveform synthesis
    dtype (the TTS path follows the model's compute dtype, as in JAX);
    encode stays float32."""

    def __init__(self, params: Params | None = None, checkpoint: str | None = None,
                 seed: int = 0, decode_dtype: str = 'float32', device=None):
        if params is not None and checkpoint is not None:
            raise ValueError('pass params OR checkpoint, not both (a silently ignored '
                             'checkpoint means garbage audio)')
        self.device = resolve_device(device)
        if checkpoint is not None:
            from ..models.convert import codec_params_from_numpy
            params = codec_params_from_numpy(load_torch_checkpoint(checkpoint))
        if params is None:
            params = init_params(torch.Generator().manual_seed(seed))
        self.params = map_tree(lambda a: a.to(self.device).contiguous(), params)
        ddtype = torch_dtype(decode_dtype)
        self.dec_params = map_tree(lambda a: a.to(ddtype),
                                   {k: self.params[k] for k in ('decoder', 'rvq')})

    @property
    def sampling_rate(self) -> int:
        return SAMPLE_RATE

    def fingerprint(self) -> str:
        """Hex identity of the ENCODE weights (encoder + RVQ codebooks): keys
        the codec-token disk cache (``data.dataset``).  The same bytes as the
        JAX package's fingerprint for the same weights."""
        h = hashlib.sha256()
        for path, leaf in _tree_items({'encoder': self.params['encoder'],
                                       'rvq': self.params['rvq']}):
            arr = leaf.detach().cpu().numpy()
            h.update(path.encode())
            h.update(str(arr.shape).encode())
            h.update(np.ascontiguousarray(arr).tobytes())
        return h.hexdigest()[:16]

    def _wav(self, audio, ndim: int) -> torch.Tensor:
        audio = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
        if audio.dim() != ndim:
            raise ValueError(f'expected a {ndim}-D audio tensor, got {audio.dim()}-D')
        return audio

    def encode(self, audio) -> torch.Tensor:
        """(T,) waveform → (n_q, ceil(T/320)) int32 codes on the device."""
        return self.batch_encode(self._wav(audio, 1)[None])[0]

    def batch_encode(self, audios) -> torch.Tensor:
        """(B, T) waveforms → (B, n_q, F) int32 codes on the device."""
        wav = self._wav(audios, 2)
        with torch.inference_mode(), tf32_scope(False):
            return encode(self.params, wav, NUM_QUANTIZERS)

    def get_embedding(self, audio) -> torch.Tensor:
        """(T,) waveform → (128, F) latents (channel-first)."""
        return self.batch_get_embedding(self._wav(audio, 1)[None])[0]

    def batch_get_embedding(self, audios) -> torch.Tensor:
        """(B, T) waveforms → (B, 128, F) latents."""
        wav = self._wav(audios, 2)
        with torch.inference_mode(), tf32_scope(False):
            return embed(self.params, wav).transpose(1, 2)

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

    def encode_decode(self, audio) -> torch.Tensor:
        return self.decode(self.encode(audio))
