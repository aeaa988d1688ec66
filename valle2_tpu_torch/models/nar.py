"""ValleNAR — non-autoregressive residual-codebook refiner, PyTorch port.

Decode path of ``valle2_tpu/models/nar.py``: seven refinement stages, each a
full bidirectional pass of the shared-weight transformer over
[tokens | acoustic prompt | target] with the per-stage AdaLN conditioning row
and output head; stage n adds embedding table n of the codes sampled at stage
n (bug Q5 of the reference fixed, as in the JAX package).  Attention is dense
with a key-padding bias: its three-range key mask does not fit the flash
kernel's two-scalar meta, and the JAX package has no Pallas kernel here.

Training (``valle2_tpu/models/nar.py:71-278``): a stage n in [1, 7] is drawn
per step; the input sums all codebook embeddings over the acoustic prefix
and those below n over the suffix; the loss is the cross-entropy on codebook
n over the suffix.  Attention is bidirectional over tokens and codes with
the padded keys masked: the flash route with meta [tokens_lens, Tt +
codes_lens], ``causal=False``, or the same key-padding bias.
"""

from __future__ import annotations

from typing import Any

import torch

from ..config import ConfigValle, bucket_len, precision_scope, resolve_device
from ..ops import (add_positional, build_pad_mask, cast_to_compute, categorical, embedding,
                   embedding_init, linear, linear_init, mask_to_bias, sinusoidal_table,
                   transformer, transformer_init)
from ..ops.nn import base_generator, randint, uniform
from ..ops.transformer import map_tree, transformer_tp
from .ar import (MAX_POS, check_max_pos, default_generator, masked_ce, mesh_loss, move_tree,
                 run_stack)

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


def prefix_length(config: ConfigValle, codes_len):
    """min(T // 3, 3 s of frames) of the batch's longest true length (the
    reference's rule, with its 50 frames a second)."""
    if isinstance(codes_len, int):
        return min(codes_len // 3, 3 * config.quantization_factor)
    return torch.clamp(codes_len // 3, max=3 * config.quantization_factor)


def prepare_audio_embedding(params: Params, codes: torch.Tensor, stage,
                            prefix_len) -> torch.Tensor:
    """Summed codebook embeddings: every quantizer over the prefix, those
    below ``stage`` over the suffix.  codes (b, T, nq) → (b, T, d), summed in
    the tables' dtype in quantizer order, as the JAX scan sums."""
    tables = params['codes_embs']
    b, t, nq = codes.shape
    pos = torch.arange(t, device=codes.device)
    in_prefix = pos < prefix_len
    acc = torch.zeros((b, t, tables.shape[-1]), dtype=tables.dtype, device=codes.device)
    for q in range(nq):
        w = torch.where(in_prefix, 1.0, (q < stage).to(torch.float32))
        acc = acc + tables[q][codes[:, :, q]] * w[None, :, None].to(tables.dtype)
    return acc


def corrupt_conditioning(codes: torch.Tensor, prefix_len, p: float,
                         generator: torch.Generator, v: int) -> torch.Tensor:
    """Replace a fraction ``p`` of the suffix's codebook-0 conditioning codes
    (positions >= prefix_len) with uniform random codes; the prefix and the
    other codebooks stay as they are.  Returns a new tensor."""
    b, t, _ = codes.shape
    dev = codes.device
    mask = uniform((b, t), generator, dev) < p
    mask = mask & (torch.arange(t, device=dev)[None, :] >= prefix_len)
    rand = randint(0, v, (b, t), generator, dev, codes.dtype)
    out = codes.clone()
    out[:, :, 0] = torch.where(mask, rand, codes[:, :, 0])
    return out


def forward_stage(params: Params, config: ConfigValle, x_tok: torch.Tensor,
                  codes_emb: torch.Tensor, stage: torch.Tensor, bias: torch.Tensor | None,
                  generator=None, flash: dict | None = None, group=None) -> torch.Tensor:
    """One stage's transformer pass → logits (b, T_codes, V) f32 for codebook
    ``stage`` (a (1,) long tensor: conditioning row and head gathered on the
    device); ``group``: the stack over a data rank's model ranks
    (``ar.run_stack``)."""
    pe = sinusoidal_table(MAX_POS, config.d_model, device=x_tok.device)
    drop = config.dropout if generator is not None else 0.0
    codes_emb = add_positional(pe, codes_emb, dropout_rate=drop, generator=generator)
    x = torch.cat([x_tok, codes_emb], dim=1).to(config.torch_dtype)
    cond = params['stage_embs'].index_select(0, stage - 1)                 # (1, d)
    y = run_stack(params, config, x, bias, cond, flash, drop, generator, group)
    head = params['proj_layers'].index_select(0, stage - 1)[0]             # (d, V)
    return (y[:, x_tok.shape[1]:] @ head).float()


def draw_stage(config: ConfigValle, generator: torch.Generator) -> torch.Tensor:
    """The step's stage, uniform in [1, nq - 1], as a (1,) long tensor on the
    generator's device (no host sync)."""
    generator = base_generator(generator)
    return torch.randint(1, config.num_quantizers, (1,), generator=generator,
                         device=generator.device)


def loss_fn(params: Params, config: ConfigValle, batch: dict[str, torch.Tensor],
            generator: torch.Generator, train: bool = True, mesh=None,
            pp: tuple | None = None):
    """Stage-sampled NAR loss: draws the stage from ``generator``, then
    ``loss_at_stage``.  ``train=False`` keeps the draw and turns dropout and
    conditioning corruption off (evaluation).  ``mesh`` / ``pp``: see
    ``loss_at_stage``; every data rank takes the one stage."""
    stage = draw_stage(config, generator)
    return loss_at_stage(params, config, batch, stage, generator if train else None, mesh, pp)


def loss_at_stage(params: Params, config: ConfigValle, batch: dict[str, torch.Tensor],
                  stage, generator: torch.Generator | None = None, mesh=None,
                  pp: tuple | None = None):
    """The NAR loss body at a given ``stage`` (int or (1,) tensor);
    ``generator`` None = no dropout and no corruption.  Returns (loss,
    metrics) with metrics {'loss', 'acc', 'stage', 'n_valid'} detached.
    ``mesh``: ``params`` is the ranks' trees; the acoustic prefix follows the
    WHOLE batch's longest row and the loss its count of positions
    (``ar.mesh_loss``).  ``pp`` = (a pipe mesh, microbatches): the same
    through the pipeline (``parallel.pipeline.pipelined_loss``; dropout and
    corruption by the pipeline's rule)."""
    if pp is not None:
        from ..parallel.pipeline import pipelined_loss
        return pipelined_loss(pp_microbatch_parts(config, batch, stage=stage), params, config,
                              batch, generator, pp)
    codes = batch['codes']
    b, t_codes, _ = codes.shape
    stage = torch.as_tensor(stage, dtype=torch.long, device=codes.device).reshape(1)
    # The acoustic prefix follows the batch's longest TRUE length, so the
    # objective does not move with the bucket the batch was padded to.
    prefix_len, valid = _loss_positions(config, batch)
    if mesh is not None:
        def rows_loss(p, rows, draws, valid_rows, denom, group, flash_ok):
            loss, acc, _ = _stage_rows(p, config, rows, stage.to(valid_rows.device), draws,
                                       prefix_len, valid_rows, denom, group, flash_ok)
            return loss, acc
        return mesh_loss(rows_loss, params, config, batch, generator, mesh,
                         valid.expand(b, t_codes), {'stage': stage[0]}, n_valid=valid.sum())
    loss, acc, n_valid = _stage_rows(params, config, batch, stage, generator, prefix_len, valid)
    return loss, {'loss': loss.detach(), 'acc': acc.detach(), 'stage': stage[0],
                  'n_valid': n_valid.detach()}


def _loss_positions(config: ConfigValle, batch: dict):
    """(prefix length, the positions the loss counts: (b, T), or without
    ``codes_lens`` (1, T), which counts one row as the JAX loss does) of the
    whole batch: the prefix from the longest TRUE row."""
    codes = batch['codes']
    codes_lens = batch.get('codes_lens')
    b, t_codes, _ = codes.shape
    max_true = codes_lens.max() if codes_lens is not None else t_codes
    prefix_len = prefix_length(config, max_true)
    pos = torch.arange(t_codes, device=codes.device)[None, :]
    valid = pos >= prefix_len
    if codes_lens is not None:
        if config.mask_loss_pads:
            valid = valid & (pos < codes_lens[:, None])
        else:
            valid = (valid & (pos < max_true)).expand(b, t_codes)
    return prefix_len, valid


def pp_microbatch_parts(config: ConfigValle, batch: dict, generator=None,
                        stage=None) -> dict:
    """``loss_at_stage`` cut into the pipeline's per-microbatch pieces (JAX
    ``pp_microbatch_parts``; the protocol of ``ar.pp_microbatch_parts``).
    The stage is ``stage``, or the first draw of ``generator`` (as
    ``loss_fn`` draws it); the prefix follows the whole batch's longest row;
    'cond'(top, rows) is the stage's AdaLN row of ``top`` on rows' device,
    so each pipeline stage's row takes its own grad; 'metrics' {'stage'}.
    ``prep`` draws the token dropout, the corruption of codebook 0 and the
    code dropout from its generator in ``loss_at_stage``'s order."""
    dev = batch['codes'].device
    if stage is None:
        stage = draw_stage(config, generator)
    stage = torch.as_tensor(stage, dtype=torch.long, device=dev).reshape(1)
    prefix_len, valid = _loss_positions(config, batch)
    t_tok = batch['tokens'].shape[1]

    def prep(top, rows, gen):
        p = cast_to_compute({'tokens_emb': top['tokens_emb'],
                             'codes_embs': top['codes_embs']}, config)
        codes = rows['codes'].long()
        d = codes.device
        pe = sinusoidal_table(MAX_POS, config.d_model, device=d)
        drop = config.dropout if gen is not None else 0.0
        x_tok = add_positional(pe, embedding(p['tokens_emb'], rows['tokens'].long()),
                               dropout_rate=drop, generator=gen)
        pl = prefix_len.to(d) if torch.is_tensor(prefix_len) else prefix_len
        if gen is not None and config.nar_corrupt_p > 0:
            codes = corrupt_conditioning(codes, pl, config.nar_corrupt_p, gen,
                                         config.num_audio_tokens)
        codes_emb = prepare_audio_embedding(p, codes, stage.to(d), pl)
        codes_emb = add_positional(pe, codes_emb, dropout_rate=drop, generator=gen)
        return torch.cat([x_tok, codes_emb], dim=1).to(config.torch_dtype)

    def bias(rows):
        codes_lens, tokens_lens = rows.get('codes_lens'), rows.get('tokens_lens')
        if codes_lens is None and tokens_lens is None:
            return None
        b, t_codes, _ = rows['codes'].shape
        pad = torch.zeros((b, t_tok + t_codes), dtype=torch.bool, device=rows['codes'].device)
        if codes_lens is not None:
            pad[:, t_tok:] |= build_pad_mask(codes_lens, t_codes)
        if tokens_lens is not None:
            pad[:, :t_tok] |= build_pad_mask(tokens_lens, t_tok)
        return mask_to_bias(pad)[:, None, None, :]

    def cond(top, rows):
        rows_stage = stage.to(rows['codes'].device)
        embs = cast_to_compute({'stage_embs': top['stage_embs']}, config)['stage_embs']
        return embs.index_select(0, rows_stage - 1)

    def head_loss(top, y, rows):
        heads = cast_to_compute({'proj_layers': top['proj_layers']}, config)['proj_layers']
        rows_stage = stage.to(y.device)
        logits = (y[:, t_tok:] @ heads.index_select(0, rows_stage - 1)[0]).float()
        target = rows['codes'].long().index_select(2, rows_stage)[..., 0]
        valid_rows = rows['valid']
        nll = -torch.log_softmax(logits, dim=-1).gather(-1, target[..., None])[..., 0]
        return ((nll * valid_rows).sum(),
                ((logits.argmax(-1) == target) & valid_rows).sum().float(), valid_rows.sum())

    return {'valid': valid.expand(batch['codes'].shape[:2]), 'n_valid': valid.sum(),
            'metrics': {'stage': stage[0]}, 'prep': prep, 'bias': bias, 'cond': cond,
            'head_loss': head_loss}


def _stage_rows(params: Params, config: ConfigValle, batch: dict, stage, generator,
                prefix_len, valid, denom=None, group=None, flash_ok: bool = True):
    """(loss, acc, n_valid) of ``loss_at_stage`` on one device's rows, the
    prefix and the counted positions given; ``group`` / ``flash_ok`` as in
    ``ar.mesh_rows``."""
    codes, tokens = batch['codes'].long(), batch['tokens'].long()
    codes_lens, tokens_lens = batch.get('codes_lens'), batch.get('tokens_lens')
    dev = codes.device
    b, t_codes, nq = codes.shape
    t_tok = tokens.shape[1]
    params = cast_to_compute(params, config)
    pe = sinusoidal_table(MAX_POS, config.d_model, device=dev)
    drop = config.dropout if generator is not None else 0.0
    x_tok = add_positional(pe, embedding(params['tokens_emb'], tokens), dropout_rate=drop,
                           generator=generator)
    cond_codes = codes
    if generator is not None and config.nar_corrupt_p > 0:
        cond_codes = corrupt_conditioning(codes, prefix_len, config.nar_corrupt_p, generator,
                                          config.num_audio_tokens)
    codes_emb = prepare_audio_embedding(params, cond_codes, stage, prefix_len)

    bias, flash = None, None
    if flash_ok and config.flash_enabled(dev):
        tv = tokens_lens if tokens_lens is not None else torch.full((b,), t_tok, device=dev)
        ce = (t_tok + codes_lens if codes_lens is not None
              else torch.full((b,), t_tok + t_codes, device=dev))
        flash = {'meta': torch.stack([tv.to(torch.int32), ce.to(torch.int32)], dim=1)
                 .contiguous(), 'tokens_total': t_tok, 'causal': False}
    elif codes_lens is not None or tokens_lens is not None:
        pad = torch.zeros((b, t_tok + t_codes), dtype=torch.bool, device=dev)
        if codes_lens is not None:
            pad[:, t_tok:] |= build_pad_mask(codes_lens, t_codes)
        if tokens_lens is not None:
            pad[:, :t_tok] |= build_pad_mask(tokens_lens, t_tok)
        bias = mask_to_bias(pad)[:, None, None, :]

    logits = forward_stage(params, config, x_tok, codes_emb, stage, bias, generator, flash,
                           group)
    target = codes.index_select(2, stage)[..., 0]
    return masked_ce(logits, target, valid, denom)


def _generate_fn(params: Params, tokens: torch.Tensor, tokens_len: torch.Tensor,
                 prompt_codes: torch.Tensor, p_len: torch.Tensor,
                 first_layer: torch.Tensor, gen_len: torch.Tensor, config: ConfigValle,
                 generator: torch.Generator | None = None, tp: tuple | None = None
                 ) -> torch.Tensor:
    """All refinement stages, batched over padded widths with true lengths.

    tokens: (B, Ttm), tokens_len (B,); prompt_codes: (B, Pm, nq), p_len (B,);
    first_layer: (B, Nm) stage-0 codes, gen_len (B,).  Returns (B, Nm, nq)
    codes (rows past each gen_len are don't-care).  ``tp`` = (mesh, the
    ranks' trees of the stack, ``parallel.shard_stack``): tensor parallelism
    (JAX ``tp``), each rank on its local heads; the embeddings, the AdaLN
    conditioning, the heads and sampling run once, on the mesh's first
    device."""
    nq = config.num_quantizers
    dev = tokens.device
    pe = sinusoidal_table(MAX_POS, config.d_model, device=dev)
    dtype = config.torch_dtype
    if tp is None:
        tparams = map_tree(lambda a: a.to(dtype), params['transformer'])

        def stack(x, cond):
            return transformer(tparams, x, config.n_heads, bias, cond)
    else:
        mesh, trees = tp

        def stack(x, cond):
            return transformer_tp(trees, [x.to(d) for d in mesh.devices],
                                  config.n_heads // mesh.size, bias, cond)[0]
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
        y = stack(x, cond)[:, ttm + pm:]
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
    """Holds config + params; ``generate`` and the training entry points
    mirror the JAX ValleNAR."""

    def __init__(self, config: ConfigValle, params: Params | None = None,
                 seed: int | None = None, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.eos_token = config.num_audio_tokens
        self.bos_token = config.num_audio_tokens + 1
        if params is None:
            gen = torch.Generator().manual_seed(config.seed if seed is None else seed)
            params = init_params(gen, config)
        self.params = move_tree(params, self.device)

    def training_step(self, batch: dict, generator: torch.Generator):
        """(loss, metrics) of ``loss_fn`` on the model's params."""
        with precision_scope(self.config):
            return loss_fn(self.params, self.config, batch, generator)

    def save(self, path) -> None:
        """Save the params to one file (``models.checkpoint.save_params``)."""
        from .checkpoint import save_params
        save_params(path, self.params)

    def load(self, path) -> None:
        """Load params from a params file or a trainer step dir (LoRA
        fine-tune states merge through this model's lora_* config)."""
        from .checkpoint import load_params
        self.params = load_params(path, self.params, config=self.config)

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
