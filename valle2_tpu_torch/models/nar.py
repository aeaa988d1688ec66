"""ValleNAR — non-autoregressive residual-codebook refiner, PyTorch port.

Decode path of ``valle2_tpu/models/nar.py``: seven refinement stages, each a
full bidirectional pass of the shared-weight transformer over
[tokens | acoustic prompt | target] with the per-stage AdaLN conditioning row
and output head; stage n adds embedding table n of the codes sampled at stage
n (bug Q5 of the reference fixed, as in the JAX package).  Attention is dense
with a key-padding bias: its three-range key mask does not fit the flash
kernel's two-scalar meta, and the JAX package has no Pallas kernel here.

Training (``loss_fn``) comes with the training slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any

import torch

from ..config import ConfigValle, bucket_len, precision_scope
from ..ops import (add_positional, categorical, embedding, embedding_init, linear,
                   linear_init, mask_to_bias, sinusoidal_table, transformer,
                   transformer_init)
from ..ops.transformer import map_tree
from .ar import MAX_POS, check_max_pos, default_generator, move_tree

Params = dict[str, Any]


def init_params(gen: torch.Generator, config: ConfigValle) -> Params:
    dtype = config.torch_param_dtype
    nq, d, v = config.num_quantizers, config.d_model, config.num_audio_tokens
    return {
        'tokens_emb': embedding_init(gen, config.vocab_size, d, dtype),
        # (nq, V, d): one table per residual codebook
        'codes_embs': torch.stack([embedding_init(gen, v, d, dtype)['emb']
                                   for _ in range(nq)]),
        # (nq-1, d): AdaLN stage conditioning rows
        'stage_embs': torch.stack([embedding_init(gen, 1, d, dtype)['emb'][0]
                                   for _ in range(nq - 1)]),
        'transformer': transformer_init(
            gen, config.num_layers, d, config.n_heads, config.dim_feedforward,
            adaptive_norm=(config.norm == 'AdaptiveLayerNorm'), dtype=dtype),
        # (nq-1, d, V): per-stage bias-free output heads
        'proj_layers': torch.stack([linear_init(gen, d, v, use_bias=False, dtype=dtype)['w']
                                    for _ in range(nq - 1)]),
    }


def _embed_codes_all(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(nq, V, d) tables + (..., T, nq) ids → (..., T, nq, d) per-quantizer embeddings."""
    return torch.stack([tables[q][codes[..., q]] for q in range(codes.shape[-1])], dim=-2)


def _generate_fn(params: Params, tokens: torch.Tensor, tokens_len: torch.Tensor,
                 prompt_codes: torch.Tensor, p_len: torch.Tensor,
                 first_layer: torch.Tensor, gen_len: torch.Tensor, config: ConfigValle,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """All refinement stages, batched over padded widths with true lengths.

    tokens: (B, Ttm), tokens_len (B,); prompt_codes: (B, Pm, nq), p_len (B,);
    first_layer: (B, Nm) stage-0 codes, gen_len (B,).  Returns (B, Nm, nq)
    codes (rows past each gen_len are don't-care)."""
    nq = config.num_quantizers
    dev = tokens.device
    pe = sinusoidal_table(MAX_POS, config.d_model, device=dev)
    dtype = config.torch_dtype
    tparams = map_tree(lambda a: a.to(dtype), params['transformer'])
    b, ttm = tokens.shape
    pm, nm = prompt_codes.shape[1], first_layer.shape[1]
    s_total = ttm + pm + nm
    check_max_pos(ttm, pm + nm, 'NAR refine')

    x_tok = add_positional(pe, embedding(params['tokens_emb'], tokens)).to(dtype)
    slots = torch.arange(s_total, device=dev)[None, :]
    valid = ((slots < tokens_len[:, None])
             | ((slots >= ttm) & (slots < ttm + p_len[:, None]))
             | ((slots >= ttm + pm) & (slots < ttm + pm + gen_len[:, None])))
    bias = mask_to_bias(~valid)[:, None, None, :]
    # Code positions per row: prompt slot i -> i; target slot j -> p_len + j.
    code_pos = torch.cat([torch.arange(pm, device=dev)[None].expand(b, pm),
                          p_len[:, None].long() + torch.arange(nm, device=dev)[None]], dim=1)
    pos_rows = pe[code_pos]                                           # (B, Pm+Nm, d)

    tables = params['codes_embs']
    emb_prompt = _embed_codes_all(tables, prompt_codes).sum(dim=2)
    emb_out = tables[0][first_layer]
    stages = [first_layer]
    for n in range(1, nq):
        codes_emb = torch.cat([emb_prompt, emb_out], dim=1) + pos_rows
        x = torch.cat([x_tok, codes_emb.to(dtype)], dim=1)
        cond = params['stage_embs'][n - 1:n].to(dtype)
        y = transformer(tparams, x, config.n_heads, bias, cond)[:, ttm + pm:]
        logits = linear({'w': params['proj_layers'][n - 1]}, y).float()   # (B, Nm, V)
        if config.temperature > 0.0:
            sampled = categorical(torch.softmax(logits / config.temperature, dim=-1),
                                  generator)
        else:
            sampled = torch.argmax(logits, dim=-1)
        emb_out = emb_out + tables[n][sampled]
        stages.append(sampled)
    return torch.stack(stages, dim=-1)


class ValleNAR:
    """Holds config + params; ``generate`` mirrors the JAX ValleNAR."""

    def __init__(self, config: ConfigValle, params: Params | None = None,
                 seed: int | None = None, device=None):
        self.config = config
        self.device = torch.device(device if device is not None else 'cpu')
        self.eos_token = config.num_audio_tokens
        self.bos_token = config.num_audio_tokens + 1
        if params is None:
            gen = torch.Generator().manual_seed(config.seed if seed is None else seed)
            params = init_params(gen, config)
        self.params = move_tree(params, self.device)

    def generate(self, prompt_tokens, prompt_codes, target_tokens, target_codes_first_layer,
                 generator: torch.Generator | None = None, bucket: bool = True):
        """Refine first-layer codes into all codebooks → (T, num_quantizers)."""
        cfg, dev = self.config, self.device
        tokens = torch.cat([torch.as_tensor(prompt_tokens, dtype=torch.long).reshape(-1),
                            torch.as_tensor(target_tokens, dtype=torch.long).reshape(-1)])
        prompt_codes = torch.as_tensor(prompt_codes, dtype=torch.long)
        first = torch.as_tensor(target_codes_first_layer, dtype=torch.long).reshape(-1)
        tl, pl, nl = tokens.shape[0], prompt_codes.shape[0], first.shape[0]
        if bucket:
            def extra(n):
                return bucket_len(cfg.bucket_sizes, n) - n
            tokens = torch.nn.functional.pad(tokens, (0, extra(tl)))
            prompt_codes = torch.nn.functional.pad(prompt_codes, (0, 0, 0, extra(pl)))
            first = torch.nn.functional.pad(first, (0, extra(nl)))
        if generator is None:
            generator = default_generator(cfg, dev)
        lens = [torch.tensor([n], dtype=torch.int32, device=dev) for n in (tl, pl, nl)]
        with torch.inference_mode(), precision_scope(cfg):
            out = _generate_fn(self.params, tokens[None].to(dev), lens[0],
                               prompt_codes[None].to(dev), lens[1], first[None].to(dev),
                               lens[2], cfg, generator)
        return out[0, :nl].cpu()
