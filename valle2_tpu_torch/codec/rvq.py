"""Residual VQ decode (8 × 1024 × 128 codebooks), ``valle2_tpu/codec/rvq.py``.

Decode is the sum of the codebook rows; encode (the nearest-codeword argmin,
and its Pallas kernel ``rvq_encode_fused``) waits for a later slice.
"""

from __future__ import annotations

from typing import Any

import torch

Params = dict[str, Any]


def rvq_init(gen: torch.Generator, num_quantizers: int = 8, codebook_size: int = 1024,
             dim: int = 128, dtype=torch.float32) -> Params:
    """Random U(-1, 1) codebooks; pretrained checkpoints overwrite these."""
    cb = torch.rand((num_quantizers, codebook_size, dim), generator=gen) * 2 - 1
    return {'codebooks': cb.to(dtype)}


def rvq_decode(p: Params, codes: torch.Tensor) -> torch.Tensor:
    """(B, n_q, T) codes → (B, T, D) latents (sum of codebook lookups)."""
    n_q = codes.shape[1]
    gathered = torch.stack([p['codebooks'][q][codes[:, q]] for q in range(n_q)], dim=1)
    return gathered.sum(dim=1)
