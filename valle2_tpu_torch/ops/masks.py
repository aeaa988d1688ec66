"""Masks for the VALL-E prefix-LM attention pattern (``valle2_tpu/ops/masks.py``).

Convention: bool masks are **True = masked**; additive biases use the finite
``NEG_INF`` so a fully masked row softmaxes to a uniform average, not NaN.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def mask_to_bias(mask: torch.Tensor | None, dtype=torch.float32) -> torch.Tensor | None:
    """Bool mask (True = masked) → additive bias (0 attend / NEG_INF masked)."""
    if mask is None:
        return None
    return torch.where(mask, torch.tensor(NEG_INF, dtype=dtype, device=mask.device),
                       torch.tensor(0.0, dtype=dtype, device=mask.device))


def prefix_lm_attend(s: int, tokens_total: int, tokens_lens: torch.Tensor,
                     kv_end: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """(b, s, s) bool, True = attend: the flash kernel's in-kernel mask
    ``((k < tokens_valid) | (k >= tokens_total & k <= q)) & (k < kv_end)``
    (``ar.py:541-546``; without ``k <= q`` for the bidirectional NAR block)."""
    dev = tokens_lens.device
    q_ids = torch.arange(s, device=dev)[None, :, None]
    k_ids = torch.arange(s, device=dev)[None, None, :]
    audio = k_ids >= tokens_total
    if causal:
        audio = audio & (k_ids <= q_ids)
    return ((k_ids < tokens_lens[:, None, None]) | audio) & (k_ids < kv_end[:, None, None])


def prefix_lm_bias(s: int, tokens_total: int, tokens_lens: torch.Tensor,
                   kv_end: torch.Tensor) -> torch.Tensor:
    """(b, 1, s, s) f32 additive bias of the causal ``prefix_lm_attend`` mask —
    the AR prefill's materialized path when flash is off."""
    attend = prefix_lm_attend(s, tokens_total, tokens_lens, kv_end, causal=True)
    return mask_to_bias(~attend)[:, None]
