"""Analytic FLOP counts of a train step (``valle2_tpu/profiling.py:49-89``).

The model FLOP/s of a measured step over the card's peak is its MFU.  The
rest of the JAX module (device traces, NaN checks, memory stats) is not
ported yet (ROADMAP.md queue 1 item 13).
"""

from __future__ import annotations


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
