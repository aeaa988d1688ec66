"""ValleAR — autoregressive first-codebook codec LM, PyTorch/CUDA port.

Decode path of ``valle2_tpu/models/ar.py``: prefill the KV cache through the
prefix-LM flash kernel, then advance one token per step through the fused
whole-stack decode kernel, then the length-penalized best-of-N beam pick.
Where the JAX package runs the token loop as an on-device ``while_loop``, the
port runs a Python loop with one fused-step call per token.  Steps past a
row's EOS are exact no-ops (the sample is forced to EOS, the logprob sum and
the codes buffer do not change), so the loop asks the device whether every
row has finished only every ``FINISHED_CHECK_EVERY`` steps, instead of
syncing the host on every token, and returns the same tokens.

Training: ``forward`` and ``loss_fn`` (``valle2_tpu/models/ar.py:104-209``)
embed the source and target streams with their own sinusoidal positions, run
the prefix-LM stack (the flash route, or the materialized bias), project the
target block and take the masked cross-entropy.  The same functions train the
ASR direction (``config.direction='asr'``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..config import ConfigValle, bucket_len, precision_scope, resolve_device
from ..kernels.fused_decode import fused_cache_layout, fused_decode_step, slot_mask
from ..ops import (KVCache, add_positional, best_beam_index, build_pad_mask,
                   cast_to_compute, embedding, embedding_init, linear, linear_init,
                   prefix_lm_bias, sinusoidal_table, topk_sampling, transformer,
                   transformer_decode_step, transformer_init, transformer_prefill)
from ..ops.transformer import map_tree

Params = dict[str, Any]

MAX_POS = 5000               # sinusoidal table length (reference modules.py:56)
FINISHED_CHECK_EVERY = 16    # decode steps between host checks of all(finished)


def check_max_pos(token_hi: int, audio_hi: int, where: str) -> None:
    """Fail loudly when a position index could run past the sinusoidal table."""
    hi = max(int(token_hi), int(audio_hi))
    if hi > MAX_POS:
        raise ValueError(
            f'{where}: position budget {hi} exceeds the sinusoidal table '
            f'(MAX_POS={MAX_POS}); shorten the prompt/text or lower max_audio_len')


def _dims(config: ConfigValle) -> tuple[int, int]:
    """(source_vocab, target_vocab_with_specials) for the configured direction."""
    if config.direction == 'asr':
        return config.num_audio_tokens, config.vocab_size + 2
    return config.vocab_size, config.num_audio_tokens + 2


def _specials(config: ConfigValle) -> tuple[int, int]:
    """(eos, bos) of the target stream: the last two ids of the target vocab."""
    _, tgt_vocab = _dims(config)
    return tgt_vocab - 2, tgt_vocab - 1


def init_params(gen: torch.Generator, config: ConfigValle) -> Params:
    src_vocab, tgt_vocab = _dims(config)
    dtype = config.torch_param_dtype
    return {
        'tokens_emb': embedding_init(gen, src_vocab, config.d_model, dtype),
        'audio_emb': embedding_init(gen, tgt_vocab, config.d_model, dtype),
        'transformer': transformer_init(
            gen, config.num_layers, config.d_model, config.n_heads,
            config.dim_feedforward, adaptive_norm=False, dtype=dtype),
        # num_audio_tokens + 1 outputs (codes + EOS), bias-free
        'proj': linear_init(gen, config.d_model, tgt_vocab - 1, use_bias=False, dtype=dtype),
    }


def forward(params: Params, config: ConfigValle, tokens: torch.Tensor, codes: torch.Tensor,
            tokens_lens: torch.Tensor | None, codes_lens: torch.Tensor | None,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Logits over the target block: (b, codes_len, target_vocab - 1) f32.

    tokens: (b, Tt) source ids; codes: (b, Tc) BOS-prefixed target ids.
    ``generator``: dropout on (``config.dropout``), drawn in stream order:
    source positions, target positions, then the layers; None = no dropout.
    The flash route uses meta [tokens_lens, Tt + codes_lens], causal; the bias
    route the same mask materialized (prefix-LM pattern, target-pad and
    source-pad keys)."""
    dev = tokens.device
    pe = sinusoidal_table(MAX_POS, config.d_model, device=dev)
    drop = config.dropout if generator is not None else 0.0
    # Differentiable cast of the f32 master params to the compute dtype.
    params = cast_to_compute(params, config)
    x_tok = add_positional(pe, embedding(params['tokens_emb'], tokens), dropout_rate=drop,
                           generator=generator)
    x_aud = add_positional(pe, embedding(params['audio_emb'], codes), dropout_rate=drop,
                           generator=generator)
    b, tt = tokens.shape
    tc = codes.shape[1]
    tv = tokens_lens if tokens_lens is not None else torch.full((b,), tt, device=dev)
    ce = tt + codes_lens if codes_lens is not None else torch.full((b,), tt + tc, device=dev)
    bias, flash = None, None
    if config.flash_enabled(dev):
        flash = {'meta': torch.stack([tv.to(torch.int32), ce.to(torch.int32)], dim=1)
                 .contiguous(), 'tokens_total': tt, 'causal': True}
    else:
        bias = prefix_lm_bias(tt + tc, tt, tv, ce)
    x = torch.cat([x_tok, x_aud], dim=1).to(config.torch_dtype)
    y = transformer(params['transformer'], x, config.n_heads, bias, flash=flash,
                    dropout_rate=drop, generator=generator)
    return linear(params['proj'], y[:, tt:]).float()


def masked_ce(logits: torch.Tensor, target: torch.Tensor, valid: torch.Tensor):
    """(loss, acc, n_valid) of the cross-entropy over the ``valid`` positions
    (a mask that broadcasts against ``target``)."""
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, target[..., None])[..., 0]
    n_valid = valid.sum()
    denom = n_valid.clamp(min=1)
    loss = (nll * valid).sum() / denom
    acc = ((logits.argmax(-1) == target) & valid).sum() / denom
    return loss, acc, n_valid


def loss_fn(params: Params, config: ConfigValle, batch: dict[str, torch.Tensor],
            generator: torch.Generator | None = None):
    """Masked cross-entropy over the target stream.  Returns (loss, metrics)
    with metrics {'loss', 'acc', 'n_valid'} detached.

    ``config.mask_loss_pads``: True counts each row's true positions; False
    (the reference's mode) counts every position up to the batch's longest
    row, so bucket columns past it never count."""
    tokens, codes = batch['tokens'].long(), batch['codes'].long()
    codes_lens = batch.get('codes_lens')
    logits = forward(params, config, tokens, codes, batch.get('tokens_lens'), codes_lens,
                     generator)
    target = batch['target'].long()
    if codes_lens is not None:
        if config.mask_loss_pads:
            valid = ~build_pad_mask(codes_lens, target.shape[1])
        else:
            pos = torch.arange(target.shape[1], device=target.device)[None, :]
            valid = (pos < codes_lens.max()).expand(target.shape)
    else:
        valid = torch.ones_like(target, dtype=torch.bool)
    loss, acc, n_valid = masked_ce(logits, target, valid)
    return loss, {'loss': loss.detach(), 'acc': acc.detach(), 'n_valid': n_valid.detach()}


@dataclass
class DecodeState:
    step: int                  # tokens generated so far
    codes: torch.Tensor        # (rows, Pm + max_new) int64, EOS-filled pads/tail
    logits: torch.Tensor       # (rows, V+1) f32 logits for the next position
    cache: KVCache
    sum_logprobs: torch.Tensor  # (rows,) f32
    finished: torch.Tensor     # (rows,) bool: the row's previous token was EOS


def compute_params(params: Params, config: ConfigValle) -> Params:
    """The transformer weights in the decode compute dtype, contiguous (the
    layout the fused kernel reads)."""
    return map_tree(lambda a: a.to(config.torch_dtype).contiguous(), params['transformer'])


def _decode_prefill(params: Params, tokens: torch.Tensor, tokens_lens: torch.Tensor,
                    codes: torch.Tensor, codes_lens: torch.Tensor, config: ConfigValle,
                    tparams: Params):
    """Embed the prompt streams, fill the KV cache, tile to beams.

    Cache slot layout per item: [0, Ttm) source | [Ttm, Ttm+Pm) prompt codes |
    [Ttm+Pm, +max_new) generated; per-item lengths mask the padding, so batched
    results equal each item's solo decode.  Returns (DecodeState, tl_f, pl_f)."""
    eos, _ = _specials(config)
    beams, max_new = config.num_beams, config.max_audio_len
    b, ttm = tokens.shape
    pm = codes.shape[1]
    total_max = ttm + pm + max_new
    check_max_pos(ttm, pm + max_new, 'AR decode')
    dev = tokens.device
    pe = sinusoidal_table(MAX_POS, config.d_model, device=dev)

    x_tok = add_positional(pe, embedding(params['tokens_emb'], tokens))
    x_aud = add_positional(pe, embedding(params['audio_emb'], codes))
    kv_end = ttm + codes_lens
    bias, flash = None, None
    if config.flash_enabled(dev):
        flash = {'meta': torch.stack([tokens_lens, kv_end], dim=1).to(torch.int32)
                 .contiguous(), 'tokens_total': ttm, 'causal': True}
    else:
        bias = prefix_lm_bias(ttm + pm, ttm, tokens_lens, kv_end)
    x = torch.cat([x_tok, x_aud], dim=1).to(config.torch_dtype)
    y, cache = transformer_prefill(tparams, x, config.n_heads, total_max, bias,
                                   cache_dtype=config.torch_cache_dtype, flash=flash)
    # Logits at each item's last valid prompt position (ttm + p_len - 1).
    y_last = y[torch.arange(b, device=dev), (ttm + codes_lens - 1).long()]
    first_logits = linear(params['proj'], y_last.float())               # (B, V+1)

    cache = KVCache(cache.k.repeat_interleave(beams, dim=1),
                    cache.v.repeat_interleave(beams, dim=1))
    if config.fused_decode_enabled(dev):
        cache = fused_cache_layout(cache)    # the layout tells the loop which path
    rows = b * beams
    prompt_valid = torch.arange(pm, device=dev)[None, :] < codes_lens[:, None]
    codes_buf = torch.full((rows, pm + max_new), eos, dtype=torch.long, device=dev)
    codes_buf[:, :pm] = torch.where(prompt_valid, codes, eos).repeat_interleave(beams, 0)
    state = DecodeState(
        step=0, codes=codes_buf, logits=first_logits.repeat_interleave(beams, 0),
        cache=cache, sum_logprobs=torch.zeros(rows, dtype=torch.float32, device=dev),
        finished=torch.zeros(rows, dtype=torch.bool, device=dev))
    tl_f = tokens_lens.repeat_interleave(beams).to(torch.int32).contiguous()
    pl_f = codes_lens.repeat_interleave(beams).to(torch.int32).contiguous()
    return state, tl_f, pl_f


def _decode_advance(params: Params, tparams: Params, state: DecodeState,
                    tl_f: torch.Tensor, pl_f: torch.Tensor, config: ConfigValle,
                    ttm: int, pm: int, generator: torch.Generator | None) -> DecodeState:
    """Advance until ``max_audio_len`` tokens or every row finished."""
    eos, _ = _specials(config)
    max_new = config.max_audio_len
    use_fused = state.cache.k.dim() == 4
    dev = state.codes.device
    pe = sinusoidal_table(MAX_POS, config.d_model, device=dev)
    codes, logits, cache = state.codes, state.logits, state.cache
    sum_lp, finished = state.sum_logprobs, state.finished
    step = state.step
    pos0 = pl_f.long()
    while step < max_new:
        if (not config.ignore_eos and step % FINISHED_CHECK_EVERY == 0
                and bool(finished.all())):
            break
        samples, logprobs = topk_sampling(logits, top_k=config.top_k, tok_p=config.tok_p,
                                          temperature=config.temperature,
                                          generator=generator)
        sum_lp = sum_lp + logprobs * ~finished
        samples = torch.where(finished, eos, samples)
        if not config.ignore_eos:
            finished = finished | (samples == eos)
        codes[:, pm + step] = samples
        x = embedding(params['audio_emb'], samples[:, None]) + pe[pos0 + step][:, None]
        x = x.to(config.torch_dtype).contiguous()
        index = ttm + pm + step
        if use_fused:
            y, cache = fused_decode_step(tparams, x, config.n_heads, cache, index,
                                         tl_f, pl_f, ttm, pm)
        else:
            attend = slot_mask(cache.k.shape[3], index, tl_f, pl_f, ttm, pm)
            y, cache = transformer_decode_step(tparams, x, config.n_heads, cache, index,
                                               attend_mask=attend)
        logits = linear(params['proj'], y[:, 0].float())
        step += 1
    return DecodeState(step, codes, logits, cache, sum_lp, finished)


def _decode_fn(params: Params, tokens: torch.Tensor, tokens_lens: torch.Tensor,
               codes: torch.Tensor, codes_lens: torch.Tensor, config: ConfigValle,
               generator: torch.Generator | None = None, clock=None):
    """Batched decode with per-item lengths: prefill → token loop → beam pick.

    tokens: (B, Ttm) padded source ids; tokens_lens: (B,) true lengths.
    codes: (B, Pm) padded BOS-prefixed first-codebook prompts; codes_lens: (B,).
    ``clock``: optional ``StageClock`` that records 'prefill' and 'decode'.
    Returns (codes_buf (B, beams, Pm+max_new), sum_logprobs (B, beams), best (B,))."""
    eos, _ = _specials(config)
    beams, max_new = config.num_beams, config.max_audio_len
    b, ttm = tokens.shape
    pm = codes.shape[1]
    tparams = compute_params(params, config)
    state, tl_f, pl_f = _decode_prefill(params, tokens, tokens_lens, codes, codes_lens,
                                        config, tparams)
    if clock is not None:
        clock.mark('prefill')
    final = _decode_advance(params, tparams, state, tl_f, pl_f, config, ttm, pm,
                            generator)
    if clock is not None:
        clock.mark('decode')
    codes_out = final.codes.reshape(b, beams, pm + max_new)
    lp_out = final.sum_logprobs.reshape(b, beams)
    best = best_beam_index(codes_out, lp_out, eos, config.length_penalty)
    return codes_out, lp_out, best


def default_generator(config: ConfigValle, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(config.seed)


def move_tree(tree, device):
    return map_tree(lambda a: a.to(device), tree)


class ValleAR:
    """Holds config + params; the decode and training entry points mirror the
    JAX ValleAR."""

    def __init__(self, config: ConfigValle, params: Params | None = None,
                 seed: int | None = None, device=None):
        self.config = config
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator().manual_seed(config.seed if seed is None else seed)
            params = init_params(gen, config)
        self.params = move_tree(params, self.device)

    @property
    def eos_token(self) -> int:
        return _specials(self.config)[0]

    @property
    def bos_token(self) -> int:
        return _specials(self.config)[1]

    def training_step(self, batch: dict, generator: torch.Generator | None = None):
        """(loss, metrics) of ``loss_fn`` on the model's params."""
        with precision_scope(self.config):
            return loss_fn(self.params, self.config, batch, generator)

    def save(self, path) -> None:
        """Save the params to one file (``models.checkpoint.save_params``)."""
        from .checkpoint import save_params
        save_params(path, self.params)

    def load(self, path) -> None:
        """Load params from a params file or a trainer step dir."""
        from .checkpoint import load_params
        self.params = load_params(path, self.params)

    def generate(self, prompt_tokens, prompt_codes, target_tokens=None,
                 generator: torch.Generator | None = None, bucket: bool = True):
        """First-codebook codes for one utterance (prompt and EOS stripped).
        prompt_tokens: (Tt,) ids; prompt_codes: (Tp, num_quantizers) codes."""
        tokens = torch.as_tensor(prompt_tokens, dtype=torch.long).reshape(-1)
        if target_tokens is not None:
            tokens = torch.cat([tokens, torch.as_tensor(target_tokens,
                                                        dtype=torch.long).reshape(-1)])
        prompt_codes = torch.as_tensor(prompt_codes, dtype=torch.long)
        if prompt_codes.dim() != 2:
            raise ValueError('prompt codes must be 2-D (T, num_quantizers)')
        return self.generate_batch([tokens], [prompt_codes], generator=generator,
                                   bucket=bucket)[0]

    def generate_batch(self, tokens_list, prompt_codes_list,
                       generator: torch.Generator | None = None,
                       bucket: bool = True) -> list[torch.Tensor]:
        """Batched decode; per-item masks keep each result equal to its solo
        decode.  Returns a list of 1-D int64 CPU tensors."""
        cfg, dev = self.config, self.device
        tokens_list = [torch.as_tensor(t, dtype=torch.long).reshape(-1) for t in tokens_list]
        codes0_list = [torch.cat([torch.tensor([self.bos_token]),
                                  torch.as_tensor(c, dtype=torch.long)[:, 0]])
                       for c in prompt_codes_list]
        ttm = max(t.shape[0] for t in tokens_list)
        pm = max(c.shape[0] for c in codes0_list)
        if bucket:
            ttm, pm = bucket_len(cfg.bucket_sizes, ttm), bucket_len(cfg.bucket_sizes, pm)
        tokens = torch.stack([torch.nn.functional.pad(t, (0, ttm - t.shape[0]))
                              for t in tokens_list]).to(dev)
        codes = torch.stack([torch.nn.functional.pad(c, (0, pm - c.shape[0]))
                             for c in codes0_list]).to(dev)
        tokens_lens = torch.tensor([t.shape[0] for t in tokens_list], dtype=torch.int32,
                                   device=dev)
        codes_lens = torch.tensor([c.shape[0] for c in codes0_list], dtype=torch.int32,
                                  device=dev)
        if generator is None:
            generator = default_generator(cfg, dev)
        with torch.inference_mode(), precision_scope(cfg):
            codes_buf, _, best = _decode_fn(self.params, tokens, tokens_lens, codes,
                                            codes_lens, cfg, generator)
        codes_buf, best = codes_buf.cpu(), best.cpu()
        out = []
        for i in range(len(tokens_list)):
            row = codes_buf[i, int(best[i])][pm:]
            out.append(row[row != self.eos_token])
        return out
