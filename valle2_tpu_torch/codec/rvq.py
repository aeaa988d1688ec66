"""Residual vector quantization (8 × 1024 × 128 codebooks), ``valle2_tpu/codec/rvq.py``.

Encode is the iterative nearest-codeword search on the residual, in the
expanded form ``argmax(2 x·c − |c|²)`` (|x|² is constant per frame) with the
first index on ties; decode is the sum of the codebook rows.  ``rvq_encode``
is the plain version of the CUDA kernel ``kernels.rvq.rvq_encode_fused``,
which the codec's encode goes through on the card.
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


def nearest_code(codebook: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """codebook (V, D), x (..., D) → int32 indices (...,) of the nearest row."""
    scores = 2.0 * (x @ codebook.T) - (codebook * codebook).sum(dim=-1)
    return scores.argmax(dim=-1).to(torch.int32)


def rvq_encode(p: Params, latents: torch.Tensor, n_q: int | None = None) -> torch.Tensor:
    """(B, T, D) latents → (B, n_q, T) int32 codes."""
    codebooks = p['codebooks'] if n_q is None else p['codebooks'][:n_q]
    residual, codes = latents, []
    for codebook in codebooks:
        idx = nearest_code(codebook, residual)
        residual = residual - codebook[idx.long()]
        codes.append(idx)
    return torch.stack(codes, dim=1)


def rvq_decode(p: Params, codes: torch.Tensor) -> torch.Tensor:
    """(B, n_q, T) codes → (B, T, D) latents (sum of codebook lookups)."""
    n_q = codes.shape[1]
    gathered = torch.stack([p['codebooks'][q][codes[:, q]] for q in range(n_q)], dim=1)
    return gathered.sum(dim=1)
