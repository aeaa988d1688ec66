"""Sampling: top-k / top-p filtering, categorical sampling, best-of-N beam pick.

PyTorch counterpart of ``valle2_tpu/ops/sampling.py`` with the same semantics:
temperature scaling before filtering, ``temperature <= 0`` = greedy argmax,
top-k keeps ties with the k-th logit, top-p keeps every token tied with the
boundary logit, and the returned logprob is ``log_softmax`` of the FILTERED
logits at the chosen token.  Random draws come from an explicit
``torch.Generator`` on the logits' device; they cannot reproduce JAX's PRNG
bits, so sampled decode agrees with the JAX package in distribution only.
"""

from __future__ import annotations

import torch

from .masks import NEG_INF


def top_k_top_p_filter(logits: torch.Tensor, top_k: int = 0,
                       top_p: float = 1.0) -> torch.Tensor:
    """Filter a (..., vocab) logits tensor; filtered entries become NEG_INF."""
    vocab = logits.shape[-1]
    if 0 < top_k < vocab:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum_probs = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # Drop tokens whose PRECEDING cumulative mass already exceeds top_p.
        remove = cum_probs > top_p
        remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]], dim=-1)
        min_kept = torch.where(remove, torch.inf, sorted_logits).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < min_kept, NEG_INF, logits)
    return logits


def categorical(probs: torch.Tensor, generator: torch.Generator | None = None):
    """One draw per row of (..., vocab) probabilities: ``argmax(p / q)`` with
    q ~ Exp(1), the algorithm of ``torch.multinomial(probs, 1)`` and the same
    draws from the same generator state, without its validity checks, which
    copy two values to the host and so stall the decode loop on every token."""
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q, dim=-1)


def categorical_rows(probs: torch.Tensor, generators: list) -> torch.Tensor:
    """``categorical`` per row of (rows, vocab) probabilities, row r drawing
    from its own ``generators[r]``: the (1, vocab) draw a one-row
    ``categorical`` on that generator makes.  A row whose generator is None
    draws nothing (a frozen row; its pick is argmax(p) and is discarded)."""
    q = torch.ones_like(probs)
    for r, g in enumerate(generators):
        if g is not None:
            q[r:r + 1].exponential_(1, generator=g)
    return torch.argmax(probs / q, dim=-1)


def topk_sampling_rows(logits: torch.Tensor, generators: list, top_k: int = 50,
                       tok_p: float = 1.0, temperature: float = 1.0):
    """``topk_sampling`` with one generator per row (JAX ``one_row_sample``
    under ``vmap``, each continuous-batching row on its own rng chain): row r
    draws what ``topk_sampling`` of that row alone draws from
    ``generators[r]``, so a session's samples do not depend on its
    co-tenants.  Greedy draws nothing."""
    if temperature is None or temperature <= 0.0:
        return topk_sampling(logits, top_k, tok_p, temperature)
    filtered = top_k_top_p_filter(logits / temperature, top_k, tok_p)
    samples = categorical_rows(torch.softmax(filtered, dim=-1), generators)
    logprobs = torch.log_softmax(filtered, dim=-1)
    return samples, logprobs.gather(-1, samples[:, None])[:, 0]


def topk_sampling(logits: torch.Tensor, top_k: int = 50, tok_p: float = 1.0,
                  temperature: float = 1.0, generator: torch.Generator | None = None):
    """Sample one token per row from (b, vocab) logits → (samples, logprobs)."""
    if temperature is not None and temperature > 0.0:
        filtered = top_k_top_p_filter(logits / temperature, top_k, tok_p)
        probs = torch.softmax(filtered, dim=-1)
        samples = categorical(probs, generator)
    else:  # greedy: argmax is the exact temperature->0 limit
        filtered = top_k_top_p_filter(logits, top_k, tok_p)
        samples = torch.argmax(logits, dim=-1)
    logprobs = torch.log_softmax(filtered, dim=-1)
    return samples, logprobs.gather(-1, samples[:, None])[:, 0]


def best_beam_index(codes: torch.Tensor, sum_logprobs: torch.Tensor, stop_token: int,
                    length_penalty: float = 1.0) -> torch.Tensor:
    """Length-penalized best-of-N pick over the last axis pair: codes
    (..., beams, T) with stop-token padding, sum_logprobs (..., beams)."""
    length = (codes != stop_token).sum(dim=-1).to(sum_logprobs.dtype)
    return torch.argmax(sum_logprobs / length ** length_penalty, dim=-1)
