"""ValleAR — autoregressive first-codebook codec LM, PyTorch/CUDA port.

Decode path of ``valle2_tpu/models/ar.py``: prefill the KV cache through the
prefix-LM flash kernel, then advance one token per step through the fused
whole-stack decode kernel, then the length-penalized best-of-N beam pick.
With ``speculative_k`` >= 2 and one beam the loop is instead the n-gram
(prompt-lookup) speculative decode of ``_decode_advance_spec``: each turn
verifies a block of K tokens per row through the fused verify kernel and
commits the accepted prefix (greedy: bit-identical tokens to the plain loop;
sampled: the same distribution, by rejection sampling).
``ValleAR`` decodes from ``decode_params``: the params, or their quantized
view under ``weight_dtype`` 'int8' / 'int4'; ``kv_cache_dtype='int8'`` keeps
an int8 cache with per-(slot, head) scales.
Where the JAX package runs the token loop as an on-device ``while_loop``, the
port runs a Python loop with one fused-step call per token.  Steps past a
row's EOS are exact no-ops (the sample is forced to EOS, the logprob sum and
the codes buffer do not change), so the loop asks the device whether every
row has finished only every ``FINISHED_CHECK_EVERY`` steps, instead of
syncing the host on every token, and returns the same tokens.
``DecodeStream`` (one beam) prefills once and then advances the same loop in
bounded segments: the sampler's generator, the EOS flags and the logprob sums
ride in ``DecodeState``, so segments return exactly the tokens of one full
decode.  A chunked cache (``decode_chunk``, or the automatic chunk of
``kernels.fused_decode.chunk_for``) pads the cache to a multiple of the
chunk and sends the fused steps through their chunked branch.
On a ('model',) mesh (``ValleAR(mesh=)``, JAX ``tp``) every rank holds its
Megatron split of the stack (``parallel.shard_stack``) and runs its local
heads through the prefill and the TP fused steps (or, for int8 weights, the
plain TP steps); the embeddings, the LM head, sampling and the beam pick run
once, on the mesh's first device, whose hidden state every rank shares.

Training: ``forward`` and ``loss_fn`` (``valle2_tpu/models/ar.py:104-209``)
embed the source and target streams with their own sinusoidal positions, run
the prefix-LM stack (the flash route, or the materialized bias), project the
target block and take the masked cross-entropy.  The same functions train the
ASR direction (``config.direction='asr'``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..config import ConfigValle, bucket_len, precision_scope, resolve_device
from ..kernels.fused_decode import (fused_cache_layout, fused_decode_step,
                                    fused_verify_step, padded_cache_len, verify_slot_mask)
from ..ops import (NEG_INF, KVCache, add_positional, best_beam_index, build_pad_mask,
                   cast_to_compute, categorical, decode_logits, embedding, embedding_init, linear,
                   linear_init, prefix_lm_bias, sinusoidal_table, top_k_top_p_filter,
                   topk_sampling, transformer, transformer_decode_step, transformer_init,
                   transformer_prefill)
from ..ops.transformer import (map_tree, transformer_decode_step_tp, transformer_mesh,
                               transformer_prefill_tp)
from ..parallel import shard_stack, tp_divisible
from ..quantize import quantize_decode_params

Params = dict[str, Any]

MAX_POS = 5000               # sinusoidal table length (reference modules.py:56)
FINISHED_CHECK_EVERY = 16    # decode steps between host checks of all(finished)
SPEC_CHECK_EVERY = 4         # speculative turns between host checks of all(finished)


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


def param_count(params: Params) -> int:
    """Elements over every tensor of a params tree."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return params.numel()


def forward(params: Params, config: ConfigValle, tokens: torch.Tensor, codes: torch.Tensor,
            tokens_lens: torch.Tensor | None, codes_lens: torch.Tensor | None,
            generator: torch.Generator | None = None, mesh=None,
            pp: tuple | None = None) -> torch.Tensor:
    """Logits over the target block: (b, codes_len, target_vocab - 1) f32.

    tokens: (b, Tt) source ids; codes: (b, Tc) BOS-prefixed target ids.
    ``generator``: dropout on (``config.dropout``), drawn in stream order:
    source positions, target positions, then the layers; None = no dropout.
    The flash route uses meta [tokens_lens, Tt + codes_lens], causal; the bias
    route the same mask materialized (prefix-LM pattern, target-pad and
    source-pad keys).  ``mesh``: ``params`` is the ranks' trees
    (``parallel.shard_params``) and each data rank runs its rows
    (``mesh_rows``); the logits come back by rows on the mesh's first device.
    ``pp`` = (a pipe mesh, microbatches): ``params`` is that mesh's ranks'
    trees, each data rank's rows run through its pipeline stages on the bias
    route (``parallel.pipeline``; dropout by the pipeline's rule), and the
    logits come back by rows on the mesh's first device."""
    if pp is not None:
        from ..parallel.pipeline import PipelineRun
        batch = {'tokens': tokens, 'codes': codes}
        batch.update({k: v for k, v in (('tokens_lens', tokens_lens),
                                        ('codes_lens', codes_lens)) if v is not None})
        parts = pp_microbatch_parts(config, batch)
        run = PipelineRun(config, pp[0], params, parts, batch, generator, pp[1])
        outs = run.connected(head=parts['logits'])
        return torch.cat([o.to(pp[0].devices[0]) for o in outs])
    if mesh is not None:
        batch = {'tokens': tokens, 'codes': codes}
        if tokens_lens is not None:
            batch['tokens_lens'] = tokens_lens
        if codes_lens is not None:
            batch['codes_lens'] = codes_lens
        outs = mesh_rows(lambda p, rows, draws, group, flash_ok: _forward(
            p, config, rows['tokens'], rows['codes'], rows.get('tokens_lens'),
            rows.get('codes_lens'), draws, group, flash_ok), params, config, batch, generator,
            mesh)
        return torch.cat([o.to(mesh.devices[0]) for o in outs])
    return _forward(params, config, tokens, codes, tokens_lens, codes_lens, generator)


def _forward(params: Params, config: ConfigValle, tokens, codes, tokens_lens, codes_lens,
             generator=None, group=None, flash_ok: bool = True) -> torch.Tensor:
    """``forward`` on one device's rows; ``group`` (``mesh_rows``) runs the
    stack over a data rank's model ranks, ``flash_ok`` False takes the
    bias route (``ops.attention.flash_shard_mesh`` declined)."""
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
    if flash_ok and config.flash_enabled(dev):
        flash = {'meta': torch.stack([tv.to(torch.int32), ce.to(torch.int32)], dim=1)
                 .contiguous(), 'tokens_total': tt, 'causal': True}
    else:
        bias = prefix_lm_bias(tt + tc, tt, tv, ce)
    x = torch.cat([x_tok, x_aud], dim=1).to(config.torch_dtype)
    y = run_stack(params, config, x, bias, None, flash, drop, generator, group)
    return linear(params['proj'], y[:, tt:]).float()


def run_stack(params: Params, config: ConfigValle, x, bias, cond, flash, drop: float,
              generator, group=None) -> torch.Tensor:
    """The transformer stack of a forward: ``params['transformer']`` on
    x's device, or with ``group`` = (the model ranks' trees, their devices,
    sequence parallel) over a data rank's model ranks
    (``ops.transformer.transformer_mesh``)."""
    if group is None:
        return transformer(params['transformer'], x, config.n_heads, bias, cond, flash=flash,
                           dropout_rate=drop, generator=generator, remat=config.remat)
    trees, devices, sp = group
    trees = [cast_to_compute(t['transformer'], config) for t in trees]
    return transformer_mesh(trees, x, config.n_heads // len(devices), devices, bias, cond,
                            flash, drop, generator, sp, config.remat)


def mesh_rows(rows_fn, params, config: ConfigValle, batch: dict, generator, mesh) -> list:
    """``rows_fn(p, rows, draws, group, flash_ok)`` on each local data
    rank's rows of ``batch`` (JAX's step under a ('data', 'model') mesh):
    ``params`` is the ranks' trees (``parallel.Sharded``); ``p`` the data
    rank's first model rank's tree, with any head cut over 'model'
    gathered; ``rows`` its rows on its device; ``draws`` an
    ``ops.ShardDraw`` of a fork of ``generator`` (every data rank draws
    what the solo step draws for the whole batch, then cuts its rows), or
    None; ``group`` the TP context (None without model ranks to split
    over); ``flash_ok`` whether the flash route runs
    (``ops.attention.flash_shard_mesh``, from the shapes).  Returns the
    results in local data rank order.  A data rank with no rows returns None.
    The rows are ``parallel.shard_batch``'s (the cut of ``parallel.data_rows``)."""
    from ..ops.attention import flash_shard_mesh
    from ..ops.nn import ShardDraw
    from ..parallel.mesh import data_rows, on_device, sequence_parallel_spec, shard_batch
    rows_total = next(iter(batch.values())).shape[0]
    flash_ok = flash_shard_mesh(mesh, rows_total, config.n_heads)
    tp = bool(getattr(params, 'tp', False))
    sp = tp and sequence_parallel_spec(config, mesh) is not None
    out = []
    for k, (i, rows) in enumerate(zip(mesh.local_data, shard_batch(mesh, batch))):
        devices = mesh.group(i)
        dev = devices[0]
        cut = data_rows(mesh, rows_total, i)
        if cut.stop == cut.start:
            out.append(None)
            continue
        trees = params[k * mesh.model:(k + 1) * mesh.model]
        draws = None
        if generator is not None:
            fork = torch.Generator(device=dev)
            fork.set_state(generator.get_state())
            draws = ShardDraw(fork, cut.start, cut.stop, rows_total)
        with on_device(dev):
            out.append(rows_fn(_replica_params(trees, getattr(params, 'specs', None)), rows,
                               draws, (trees, devices, sp) if tp else None, flash_ok))
    return out


def _replica_params(trees: list, specs) -> Params:
    """Rank 0's tree of a data rank's model ranks, with every leaf outside
    the stack that is cut over 'model' (the vocabulary of an output head)
    put back together on rank 0's device (differentiable: each rank's block
    takes its slice of the grad)."""
    from ..parallel.mesh import _map_paths, _paths
    if specs is None or len(trees) == 1:
        return trees[0]
    flat = dict(_paths(specs))
    blocks = [dict(_paths(t)) for t in trees]

    def leaf(path, a):
        spec = flat.get(path, ())
        if path.startswith('transformer/') or 'model' not in spec:
            return a
        return torch.cat([b[path].to(a.device) for b in blocks], spec.index('model'))
    return _map_paths(leaf, trees[0])


def mesh_loss(rows_loss, params, config: ConfigValle, batch: dict, generator, mesh,
              valid: torch.Tensor, metrics: dict | None = None, n_valid=None):
    """A loss over a mesh from ``rows_loss(p, rows, draws, valid_rows, denom,
    group, flash_ok) -> (loss, acc)`` per data rank (``mesh_rows``): each
    normalised by the GLOBAL count of ``valid`` (the whole batch's (b, T)
    mask), so the per-rank losses add up to the solo loss.  Returns (this
    process's sum of its data ranks' losses on the mesh's first device,
    metrics {'loss', 'acc', 'n_valid'} of the whole batch, summed over the
    data ranks in rank order, across processes too).  ``n_valid``
    overrides the count."""
    n_valid = valid.sum() if n_valid is None else n_valid
    denom = n_valid.clamp(min=1)
    dev0 = mesh.devices[0]
    outs = mesh_rows(lambda p, rows, draws, group, flash_ok: rows_loss(
        p, rows, draws, rows['valid'], denom.to(rows['valid'].device), group, flash_ok),
        params, config, dict(batch, valid=valid), generator, mesh)
    zero = torch.zeros((), device=dev0)
    losses = [zero if o is None else o[0].to(dev0) for o in outs]
    accs = [zero if o is None else o[1].detach().to(dev0) for o in outs]
    loss = losses[0]
    for x in losses[1:]:
        loss = loss + x
    both = mesh.gather_data([torch.stack([x.detach().float(), a.float()])
                             for x, a in zip(losses, accs)])
    total = both[0]
    for x in both[1:]:
        total = total + x
    out = {'loss': total[0], 'acc': total[1], 'n_valid': n_valid.detach()}
    return loss, dict(out, **(metrics or {}))


def loss_mask(config: ConfigValle, batch: dict) -> torch.Tensor:
    """The (b, T) positions the AR loss counts: ``config.mask_loss_pads``
    True counts each row's true positions; False (the reference's mode)
    every position up to the batch's longest row, so bucket columns past it
    never count."""
    target = batch['target']
    codes_lens = batch.get('codes_lens')
    if codes_lens is None:
        return torch.ones(target.shape, dtype=torch.bool, device=target.device)
    if config.mask_loss_pads:
        return ~build_pad_mask(codes_lens.to(target.device), target.shape[1])
    pos = torch.arange(target.shape[1], device=target.device)[None, :]
    return (pos < codes_lens.max().to(target.device)).expand(target.shape)


def masked_ce(logits: torch.Tensor, target: torch.Tensor, valid: torch.Tensor,
              denom: torch.Tensor | None = None):
    """(loss, acc, n_valid) of the cross-entropy over the ``valid`` positions
    (a mask that broadcasts against ``target``), divided by ``denom``
    (default: the count of valid positions, at least 1)."""
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, target[..., None])[..., 0]
    n_valid = valid.sum()
    denom = n_valid.clamp(min=1) if denom is None else denom
    loss = (nll * valid).sum() / denom
    acc = ((logits.argmax(-1) == target) & valid).sum() / denom
    return loss, acc, n_valid


def loss_fn(params: Params, config: ConfigValle, batch: dict[str, torch.Tensor],
            generator: torch.Generator | None = None, mesh=None, pp: tuple | None = None):
    """Masked cross-entropy over the target stream (``loss_mask``).  Returns
    (loss, metrics) with metrics {'loss', 'acc', 'n_valid'} detached.
    ``mesh``: ``params`` is the ranks' trees; the loss is this process's
    data ranks' share of the whole batch's (``mesh_loss``), the metrics the
    whole batch's.  ``pp`` = (a pipe mesh, microbatches): the same through
    the pipeline (``parallel.pipeline.pipelined_loss``)."""
    if pp is not None:
        from ..parallel.pipeline import pipelined_loss
        return pipelined_loss(pp_microbatch_parts(config, batch), params, config, batch,
                              generator, pp)
    valid = loss_mask(config, batch)
    if mesh is not None:
        def rows_loss(p, rows, draws, valid_rows, denom, group, flash_ok):
            logits = _forward(p, config, rows['tokens'].long(), rows['codes'].long(),
                              rows.get('tokens_lens'), rows.get('codes_lens'), draws, group,
                              flash_ok)
            loss, acc, _ = masked_ce(logits, rows['target'].long(), valid_rows,
                                     denom.to(logits.device))
            return loss, acc
        return mesh_loss(rows_loss, params, config, batch, generator, mesh, valid)
    tokens, codes = batch['tokens'].long(), batch['codes'].long()
    logits = forward(params, config, tokens, codes, batch.get('tokens_lens'),
                     batch.get('codes_lens'), generator)
    loss, acc, n_valid = masked_ce(logits, batch['target'].long(), valid)
    return loss, {'loss': loss.detach(), 'acc': acc.detach(), 'n_valid': n_valid.detach()}


def pp_microbatch_parts(config: ConfigValle, batch: dict, generator=None) -> dict:
    """``loss_fn`` cut into the pipeline's per-microbatch pieces (JAX
    ``pp_microbatch_parts``): the same math, so the pipeline can run the
    embeddings on stage 0, the stack over the stages and the head and its
    backward on the last stage.  ``batch``: the whole batch; ``generator``
    unused (the AR loss draws no scalar).  Returns:

    - 'valid': ``loss_mask`` of the whole batch (every position without a
      'target'), 'metrics': {};
    - 'prep'(top, rows, generator) -> x (mb, s, d) in the compute dtype: the
      rows' streams embedded with positions, dropout from ``generator``;
    - 'bias'(rows): the prefix-LM bias; 'cond'(top, rows): None;
    - 'logits'(top, y, rows) -> (mb, Tc, V) f32, the head on the target block;
    - 'head_loss'(top, y, rows) -> (nll_sum, acc_sum, n_valid) over
      ``rows['valid']``, UNNORMALISED (the pipeline divides by the whole
      batch's count).

    ``rows``: a microbatch's rows of the batch (and 'valid') on the device
    that uses them; ``top``: a tree's leaves outside the stack, uncast (the
    pieces cast what they use, so grads stay in the master dtype)."""
    del generator
    tt = batch['tokens'].shape[1]

    def prep(top, rows, gen):
        p = cast_to_compute({'tokens_emb': top['tokens_emb'], 'audio_emb': top['audio_emb']},
                            config)
        pe = sinusoidal_table(MAX_POS, config.d_model, device=rows['tokens'].device)
        drop = config.dropout if gen is not None else 0.0
        x_tok = add_positional(pe, embedding(p['tokens_emb'], rows['tokens'].long()),
                               dropout_rate=drop, generator=gen)
        x_aud = add_positional(pe, embedding(p['audio_emb'], rows['codes'].long()),
                               dropout_rate=drop, generator=gen)
        return torch.cat([x_tok, x_aud], dim=1).to(config.torch_dtype)

    def bias(rows):
        b, tc = rows['codes'].shape
        dev = rows['codes'].device
        tv = rows.get('tokens_lens')
        tv = tv if tv is not None else torch.full((b,), tt, device=dev)
        cl = rows.get('codes_lens')
        ce = tt + cl if cl is not None else torch.full((b,), tt + tc, device=dev)
        return prefix_lm_bias(tt + tc, tt, tv, ce)

    def logits(top, y, rows):
        proj = cast_to_compute({'proj': top['proj']}, config)['proj']
        return linear(proj, y[:, tt:]).float()

    def head_loss(top, y, rows):
        lg = logits(top, y, rows)
        target, valid = rows['target'].long(), rows['valid']
        nll = -torch.log_softmax(lg, dim=-1).gather(-1, target[..., None])[..., 0]
        return ((nll * valid).sum(), ((lg.argmax(-1) == target) & valid).sum().float(),
                valid.sum())

    valid = (loss_mask(config, batch) if 'target' in batch else
             torch.ones(batch['codes'].shape, dtype=torch.bool, device=batch['codes'].device))
    return {'valid': valid, 'metrics': {}, 'prep': prep, 'bias': bias,
            'cond': lambda top, rows: None, 'logits': logits, 'head_loss': head_loss}


@dataclass
class DecodeState:
    step: int | torch.Tensor   # tokens generated so far; per row (rows,) when speculative
    #                            or under continuous batching (models/continuous.py)
    codes: torch.Tensor        # (rows, Pm + max_new_pad) int64, EOS-filled pads/tail
    logits: torch.Tensor       # (rows, V+1) f32 logits for the next position
    cache: KVCache
    sum_logprobs: torch.Tensor  # (rows,) f32
    finished: torch.Tensor     # (rows,) bool: the row's previous token was EOS
    # The sampler's draws (JAX: the rng key); under continuous batching a
    # list of per-row generators (JAX: a (rows,) key vector).
    generator: torch.Generator | list | None = None


def compute_params(params: Params, config: ConfigValle) -> Params:
    """The transformer weights in the decode compute dtype, contiguous (the
    layout the fused kernel reads).  Float leaves cast, quantization scales
    included; the int8 codes of a quantized stack pass unchanged (JAX
    ``_to_compute``)."""
    def cast(a):
        return (a.to(config.torch_dtype) if a.is_floating_point() else a).contiguous()
    return map_tree(cast, params['transformer'])


def _spec_enabled(config: ConfigValle) -> bool:
    """True when the n-gram speculative decode path applies (see _spec_gate)."""
    return config.speculative_k >= 2 and config.num_beams == 1


def _spec_gate(config: ConfigValle) -> bool:
    """Validate and resolve the speculative-decoding request (JAX
    ``_spec_gate``): off at ``speculative_k`` 0; else single-beam only (a
    best-of-N pick needs N independent sequences), a block of at least two
    tokens and an n-gram of at least one.  The verify pass follows the fused
    gate like the plain loop: the fused verify kernel (#7) where the prefill
    chose the fused layout, else the q-block ``transformer_decode_step``."""
    k = config.speculative_k
    if k <= 0:
        return False
    if k < 2:
        raise ValueError('speculative_k must be >= 2: one model-guaranteed token plus at '
                         'least one draft per verify block')
    if config.num_beams != 1:
        raise ValueError('speculative decoding requires num_beams == 1')
    if config.speculative_ngram < 1:
        raise ValueError('speculative_ngram must be >= 1 (drafts continue a match strictly '
                         'after the buffer start; ngram 0 could draft the BOS slot)')
    return True


def _ngram_draft(codes: torch.Tensor, vlen: torch.Tensor, g: int, m: int,
                 fallback: torch.Tensor) -> torch.Tensor:
    """Prompt-lookup drafting (JAX ``_ngram_draft``): continue the most recent
    earlier occurrence of each row's last ``g`` tokens.  codes: (rows, T)
    token buffer (what lies past ``vlen`` is harmless: bad drafts are
    rejected); vlen: (rows,) valid lengths.  Returns (rows, m) drafts; a row
    with no match, or a continuation that runs past its written region,
    drafts ``fallback`` (token repetition) there.  Tensor ops on the
    buffer's device, no host sync."""
    rows, t = codes.shape
    dev = codes.device
    vlen = vlen.long()
    gi = torch.arange(g, device=dev)[None, :]
    last = codes.gather(1, (vlen[:, None] - g + gi).clamp(0, t - 1))          # (rows, g)
    nj = t - g + 1
    eq = torch.ones((rows, nj), dtype=torch.bool, device=dev)
    for i in range(g):
        eq &= codes[:, i:i + nj] == last[:, i:i + 1]
    j = torch.arange(nj, device=dev)[None, :]
    ok = eq & (j < vlen[:, None] - g)             # strictly before the suffix itself
    jstar = torch.where(ok, j, -1).amax(dim=1)                                # (rows,)
    di0 = jstar[:, None] + g + torch.arange(m, device=dev)[None, :]
    draft = codes.gather(1, di0.clamp(0, t - 1))
    draft = torch.where(di0 < vlen[:, None], draft, fallback[:, None])
    return torch.where((jstar >= 0)[:, None], draft, fallback[:, None])


def _decode_prefill(params: Params, tokens: torch.Tensor, tokens_lens: torch.Tensor,
                    codes: torch.Tensor, codes_lens: torch.Tensor, config: ConfigValle,
                    tparams: Params, generator: torch.Generator | None = None, mesh=None):
    """Embed the prompt streams, fill the KV cache, tile to beams.

    Cache slot layout per item: [0, Ttm) source | [Ttm, Ttm+Pm) prompt codes |
    [Ttm+Pm, +max_new_pad) generated; per-item lengths mask the padding, so
    batched results equal each item's solo decode.  max_new_pad is max_new
    rounded up to a multiple of ``decode_unroll`` (the last turn's overshoot
    steps are EOS no-ops), plus, under speculative decode, K slots of slack:
    a row writes its K-token block from its own step, up to max_new (JAX
    ar.py:483-491).  The fused layout pads the cache further to a multiple of
    its chunk (``padded_cache_len``, JAX ar.py:500-517).  Returns
    (DecodeState, tl_f, pl_f); the state carries ``generator``.
    ``mesh``: tensor parallelism (JAX ``tp``): ``tparams`` holds the ranks'
    trees (``parallel.shard_stack``), each rank prefills its local heads, and the
    state's cache is the list of the ranks' caches; everything outside the
    stack runs once, on the mesh's first device."""
    eos, _ = _specials(config)
    beams, max_new = config.num_beams, config.max_audio_len
    b, ttm = tokens.shape
    pm = codes.shape[1]
    unroll = max(1, config.decode_unroll)
    max_new_pad = -(-max_new // unroll) * unroll
    if _spec_enabled(config):
        max_new_pad += config.speculative_k
    total_max = ttm + pm + max_new_pad
    check_max_pos(ttm, pm + max_new_pad, 'AR decode')
    dev = tokens.device
    mp = 1 if mesh is None else mesh.size
    n_heads = config.n_heads // mp             # a rank's local heads
    use_fused = config.fused_decode_enabled(dev, mp)
    if use_fused:
        total_max = padded_cache_len(total_max, b * beams, config.d_model // mp, n_heads,
                                     config.torch_cache_dtype, config.decode_chunk or None)
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
    if mesh is None:
        y, cache = transformer_prefill(tparams, x, n_heads, total_max, bias,
                                       cache_dtype=config.torch_cache_dtype, flash=flash)
    else:
        ys, cache = transformer_prefill_tp(tparams, [x.to(d) for d in mesh.devices], n_heads,
                                           total_max, bias, cache_dtype=config.torch_cache_dtype,
                                           flash=flash)
        y = ys[0]
    # Logits at each item's last valid prompt position (ttm + p_len - 1).
    y_last = y[torch.arange(b, device=dev), (ttm + codes_lens - 1).long()]
    first_logits = decode_logits(params['proj'], y_last.float())        # (B, V+1)

    def tile(c):
        c = KVCache(*(None if a is None else a.repeat_interleave(beams, dim=1) for a in c))
        return fused_cache_layout(c) if use_fused else c   # the layout picks the path
    cache = tile(cache) if mesh is None else [tile(c) for c in cache]
    rows = b * beams
    prompt_valid = torch.arange(pm, device=dev)[None, :] < codes_lens[:, None]
    codes_buf = torch.full((rows, pm + max_new_pad), eos, dtype=torch.long, device=dev)
    codes_buf[:, :pm] = torch.where(prompt_valid, codes, eos).repeat_interleave(beams, 0)
    state = DecodeState(
        step=0, codes=codes_buf, logits=first_logits.repeat_interleave(beams, 0),
        cache=cache, sum_logprobs=torch.zeros(rows, dtype=torch.float32, device=dev),
        finished=torch.zeros(rows, dtype=torch.bool, device=dev), generator=generator)
    tl_f = tokens_lens.repeat_interleave(beams).to(torch.int32).contiguous()
    pl_f = codes_lens.repeat_interleave(beams).to(torch.int32).contiguous()
    return state, tl_f, pl_f


def _stack_step(tparams, x: torch.Tensor, config: ConfigValle, cache, index, tl_f, pl_f,
                ttm: int, pm: int, mesh, verify: bool):
    """One token (verify: one K-token block) through the stack: the fused
    kernel on the fused (4-D) cache layout, else the q-block
    ``transformer_decode_step``; on a ``mesh``, over its ranks (``tparams``
    and ``cache`` the ranks' lists).  Returns (y, cache), y on x's device."""
    cache0 = cache if mesh is None else cache[0]
    n_heads = config.n_heads // (1 if mesh is None else mesh.size)
    q_len = x.shape[1]
    if cache0.k.dim() == 4:
        step = fused_verify_step if verify else fused_decode_step
        kw = dict(chunk_override=config.decode_chunk or None)
        if mesh is None:
            return step(tparams, x, n_heads, cache, index, tl_f, pl_f, ttm, pm, **kw)
        ys, cache = step(None, x, n_heads, None, index, tl_f, pl_f, ttm, pm,
                         tp=(mesh, tparams, cache), **kw)
        return ys[0], cache
    attend = verify_slot_mask(cache0.k.shape[3], index, q_len, tl_f, pl_f, ttm, pm)
    if mesh is None:
        return transformer_decode_step(tparams, x, n_heads, cache, index, attend_mask=attend)
    ys, cache = transformer_decode_step_tp(tparams, [x.to(d) for d in mesh.devices], n_heads,
                                           cache, index, attend_mask=attend)
    return ys[0], cache


def _decode_advance(params: Params, tparams: Params, state: DecodeState,
                    tl_f: torch.Tensor, pl_f: torch.Tensor, config: ConfigValle,
                    ttm: int, pm: int, limit: int | None = None, mesh=None) -> DecodeState:
    """Advance ``state`` IN PLACE until ``state.step`` reaches ``limit``
    (default ``max_audio_len``) or every row finished, in turns of
    ``decode_unroll`` steps: the loop exits at the first multiple of the
    unroll >= ``limit``, and steps at or past ``max_audio_len`` are EOS
    no-ops (JAX ``_decode_advance``'s ``active`` guard).  The generator, EOS
    flags and logprob sums ride in the state, so N advances to partial
    limits give exactly the tokens of one advance to the full limit.
    ``all(finished)`` is read on the host at the first turn and then every
    ``FINISHED_CHECK_EVERY`` steps, so the loop may stop short of ``limit``:
    ``state.step`` says where.  ``mesh``: see ``_decode_prefill``."""
    eos, _ = _specials(config)
    max_new = config.max_audio_len
    limit = max_new if limit is None else limit
    unroll = max(1, config.decode_unroll)
    dev = state.codes.device
    pe = sinusoidal_table(MAX_POS, config.d_model, device=dev)
    codes, logits, cache = state.codes, state.logits, state.cache
    sum_lp, finished, generator = state.sum_logprobs, state.finished, state.generator
    step = state.step
    pos0 = pl_f.long()
    next_check = step
    while step < limit:
        if not config.ignore_eos and step >= next_check:
            if bool(finished.all()):
                break
            next_check = step + FINISHED_CHECK_EVERY
        for _ in range(unroll):
            active = step < max_new
            samples, logprobs = topk_sampling(logits, top_k=config.top_k, tok_p=config.tok_p,
                                              temperature=config.temperature,
                                              generator=generator)
            if active:
                sum_lp = sum_lp + logprobs * ~finished
                samples = torch.where(finished, eos, samples)
                if not config.ignore_eos:
                    finished = finished | (samples == eos)
            else:                       # past max_new: EOS, every row finished
                samples = torch.full_like(samples, eos)
                finished = torch.ones_like(finished)
            codes[:, pm + step] = samples
            x = embedding(params['audio_emb'], samples[:, None]) + pe[pos0 + step][:, None]
            x = x.to(config.torch_dtype).contiguous()
            y, cache = _stack_step(tparams, x, config, cache, ttm + pm + step, tl_f, pl_f,
                                   ttm, pm, mesh, verify=False)
            logits = decode_logits(params['proj'], y[:, 0].float())
            step += 1
    state.step, state.logits, state.cache = step, logits, cache
    state.sum_logprobs, state.finished = sum_lp, finished
    return state



def _decode_advance_spec(params: Params, tparams: Params, state: DecodeState,
                         tl_f: torch.Tensor, pl_f: torch.Tensor, config: ConfigValle,
                         ttm: int, pm: int, mesh=None):
    """N-gram (prompt-lookup) speculative decode loop (JAX
    ``_decode_advance_spec``), to ``max_audio_len`` tokens per row.

    Each turn verifies a K-token block per row in ONE pass: the token the
    carried logits give, then K-1 drafts from ``_ngram_draft``.  Greedy
    (temperature 0) accepts a draft iff it equals the model's own argmax
    there, so the committed tokens equal the plain loop's.  Sampled decode
    accepts draft d at position j with probability p_j(d) under the
    filtered, temperature-scaled distribution, and on the first rejection
    draws a replacement from p_j with d removed: the committed sequence is
    distributed as plain sampled decode (not bitwise: the draws differ).  The
    replacement's k/v is not in the cache, so it commits through a forced
    one-hot carry that the next turn's verify pass writes; its logprob counts
    in the turn that drew it.  Commits stop at a committed EOS and at the
    budget.  ``step`` becomes a per-row (rows,) tensor.

    The host checks ``all(finished)`` every ``SPEC_CHECK_EVERY`` turns only;
    a turn after every row finished writes EOS over EOS and cache slots no
    committed token reads, so the result is the same.  Returns (final state,
    turns): the number of turns in which some row was still decoding, a
    device scalar; mean accepted tokens per turn is sum(step) / (rows *
    turns).  ``mesh``: see ``_decode_prefill``."""
    eos, _ = _specials(config)
    max_new, k_blk = config.max_audio_len, config.speculative_k
    dev = state.codes.device
    rows = state.codes.shape[0]
    pe = sinusoidal_table(MAX_POS, config.d_model, device=dev)
    sampled = bool(config.temperature and config.temperature > 0.0)
    temp = float(config.temperature) if sampled else 1.0
    codes, logits, cache = state.codes, state.logits, state.cache
    sum_lp, finished, generator = state.sum_logprobs, state.finished, state.generator
    step = torch.zeros(rows, dtype=torch.long, device=dev)
    turns = torch.zeros((), dtype=torch.long, device=dev)
    blk = torch.arange(k_blk, device=dev)[None, :]
    row_ids = torch.arange(rows, device=dev)
    n = 0
    while not (n % SPEC_CHECK_EVERY == 0 and bool(finished.all())):
        n += 1
        alive = ~finished & (step < max_new)
        turns += alive.any()
        # The guaranteed token from the carried logits (a forced one-hot carry
        # resolves to its token with probability 1).
        t0, lp0 = topk_sampling(logits, top_k=config.top_k, tok_p=config.tok_p,
                                temperature=config.temperature, generator=generator)
        t0 = torch.where(alive, t0, eos)
        # Draft K-1 continuations from the history including t0.
        codes.scatter_(1, (pm + step)[:, None], t0[:, None])
        draft = _ngram_draft(codes, pm + step + 1, config.speculative_ngram, k_blk - 1, t0)
        block = torch.cat([t0[:, None], draft], dim=1)                       # (rows, K)

        # One K-token verify pass: writes all K slots of each row, in-block causal.
        x = embedding(params['audio_emb'], block) + pe[pl_f.long()[:, None] + step[:, None]
                                                       + blk]
        x = x.to(config.torch_dtype).contiguous()
        y, cache = _stack_step(tparams, x, config, cache, (ttm + pm + step).to(torch.int32),
                               tl_f, pl_f, ttm, pm, mesh, verify=True)
        flat3 = decode_logits(params['proj'], y.float())                     # (rows, K, V)
        vocab = flat3.shape[-1]

        if not sampled:
            g_tok, g_lp = topk_sampling(flat3.reshape(rows * k_blk, vocab), top_k=config.top_k,
                                        tok_p=config.tok_p, temperature=config.temperature,
                                        generator=generator)
            g_tok, g_lp = g_tok.reshape(rows, k_blk), g_lp.reshape(rows, k_blk)
            match = (block[:, 1:] == g_tok[:, :-1]).long()
            lp_blk = torch.cat([lp0[:, None], g_lp[:, :-1]], dim=1)
        else:
            # Accept d_j with probability p_j(d_j), position j scored by the
            # verify logits at j - 1.
            filt = top_k_top_p_filter(flat3 / temp, config.top_k, config.tok_p)
            logp = torch.log_softmax(filt, dim=-1)
            lp_draft = logp[:, :-1].gather(-1, block[:, 1:, None])[..., 0]    # (rows, K-1)
            u = torch.rand(lp_draft.shape, generator=generator, device=dev)
            match = (torch.log(u) < lp_draft).long()
            lp_blk = torch.cat([lp0[:, None], lp_draft], dim=1)
        c_acc = torch.cumprod(match, dim=1).sum(dim=1) + 1                     # 1..K

        # Commit length: the accepted run, cut at the first EOS and the budget.
        c = c_acc
        if not config.ignore_eos:
            is_eos = block == eos
            first_eos = is_eos.int().argmax(dim=1)
            c = torch.where(is_eos.any(dim=1), torch.minimum(c, first_eos + 1), c)
        c = torch.where(alive, torch.minimum(c, max_new - step), 0)
        take = blk < c[:, None]
        # Per-token logprobs as the plain loop sums them: block[0] scored by
        # the carried logits, block[j] by verify position j - 1.
        sum_lp = sum_lp + (lp_blk * take).sum(dim=1)
        codes.scatter_(1, pm + step[:, None] + blk, torch.where(take, block, eos))
        step_new = step + c
        finished = finished | (step_new >= max_new)
        if not config.ignore_eos:
            finished = finished | ((block == eos) & take).any(dim=1)
        ci = (c - 1).clamp(0, k_blk - 1)
        logits_next = torch.where((c > 0)[:, None], flat3[row_ids, ci], logits)

        if sampled:
            # Residual resample at the first rejected position (block index
            # c_acc, scored by verify logits c_acc - 1), committed next turn
            # through a forced one-hot carry when the commit ended by
            # rejection and the row goes on.
            prev = (c_acc - 1).clamp(0, k_blk - 1)
            d_rej = block[row_ids, c_acc.clamp(0, k_blk - 1)]
            vocab_ids = torch.arange(vocab, device=dev)[None, :]
            resid = torch.where(vocab_ids == d_rej[:, None], NEG_INF, filt[row_ids, prev])
            x_new = categorical(torch.softmax(resid, dim=-1), generator)
            lp_new = logp[row_ids, prev, x_new]
            do_force = alive & (c_acc < k_blk) & (c == c_acc) & ~finished
            sum_lp = sum_lp + torch.where(do_force, lp_new, 0.0)
            force_row = torch.where(vocab_ids == x_new[:, None], 0.0, NEG_INF)
            logits_next = torch.where(do_force[:, None], force_row, logits_next)
        step, logits = step_new, logits_next
    return DecodeState(step, codes, logits, cache, sum_lp, finished, generator), turns


def _decode_fn(params: Params, tokens: torch.Tensor, tokens_lens: torch.Tensor,
               codes: torch.Tensor, codes_lens: torch.Tensor, config: ConfigValle,
               generator: torch.Generator | None = None, clock=None, tp: tuple | None = None):
    """Batched decode with per-item lengths: prefill → token loop → beam pick.

    tokens: (B, Ttm) padded source ids; tokens_lens: (B,) true lengths.
    codes: (B, Pm) padded BOS-prefixed first-codebook prompts; codes_lens: (B,).
    ``clock``: optional ``StageClock`` that records 'prefill' and 'decode'
    (and under speculative decode the counts 'ar_turns' and 'ar_tokens', read
    after the decode's synchronize).  Routes to ``_decode_advance_spec`` when
    ``_spec_gate`` passes.  ``tp`` = (mesh, the ranks' trees,
    ``ValleAR._decode_tparams``): tensor parallelism (see ``_decode_prefill``).
    Returns (codes_buf (B, beams, Pm+max_new), sum_logprobs (B, beams), best (B,))."""
    eos, _ = _specials(config)
    beams, max_new = config.num_beams, config.max_audio_len
    b, ttm = tokens.shape
    pm = codes.shape[1]
    spec = _spec_gate(config)
    mesh, tparams = tp if tp is not None else (None, compute_params(params, config))
    state, tl_f, pl_f = _decode_prefill(params, tokens, tokens_lens, codes, codes_lens,
                                        config, tparams, generator, mesh)
    if clock is not None:
        clock.mark('prefill')
    if spec:
        final, turns = _decode_advance_spec(params, tparams, state, tl_f, pl_f, config, ttm,
                                            pm, mesh)
    else:
        final = _decode_advance(params, tparams, state, tl_f, pl_f, config, ttm, pm,
                                mesh=mesh)
    if clock is not None:
        clock.mark('decode')
        if spec:
            clock.count('ar_turns', int(turns))
            clock.count('ar_tokens', int(final.step.sum()))
    codes_out = final.codes[:, :pm + max_new].reshape(b, beams, pm + max_new)
    lp_out = final.sum_logprobs.reshape(b, beams)
    best = best_beam_index(codes_out, lp_out, eos, config.length_penalty)
    return codes_out, lp_out, best


def check_tp(config: ConfigValle, mp: int) -> None:
    """Raise unless the stack splits over ``mp`` tensor-parallel ranks: heads
    and the FFN width divisible, and under int4 an even per-rank width of
    both row-parallel inputs (the ranked packing).  The JAX package takes
    the GSPMD path for the rest, which is not ported."""
    int4_ok = config.weight_dtype != 'int4' or (
        (config.d_model // mp) % 2 == 0 and (config.dim_feedforward // mp) % 2 == 0)
    if not (tp_divisible(config.n_heads, config.dim_feedforward, mp) and int4_ok):
        raise NotImplementedError(
            f'n_heads={config.n_heads}, dim_feedforward={config.dim_feedforward} '
            f'({config.weight_dtype}) do not split over {mp} ranks: the GSPMD path for such '
            'splits is not ported (ROADMAP.md queue 1 item 14)')


def default_generator(config: ConfigValle, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(config.seed)


def move_tree(tree, device):
    return map_tree(lambda a: a.to(device), tree)


class ValleAR:
    """Holds config + params; the decode and training entry points mirror the
    JAX ValleAR."""

    def __init__(self, config: ConfigValle, params: Params | None = None,
                 seed: int | None = None, device=None, mesh=None):
        """``mesh``: a ``parallel.Mesh``: ``generate`` / ``generate_batch``
        decode over it (the params live on its first device, which
        ``device`` may name).  A ('model',) mesh decodes tensor-parallel over
        its ranks; a ('data', 'model') mesh pads the rows to a multiple of
        the data size and each data rank decodes its rows on its devices
        (JAX ``data_shard_map`` / ``tp_shard_map``), tensor-parallel over its
        model ranks where there are several."""
        self.config = config
        self.mesh = mesh
        if mesh is not None:
            if mesh.pipe > 1:
                raise ValueError('a pipeline mesh trains (parallel.pipeline); decode over a '
                                 '(\'data\', \'model\') or a (\'model\',) mesh')
            if mesh.model > 1:
                check_tp(config, mesh.model)
            if 'data' in mesh.axis_names and config.weight_dtype == 'int8':
                raise NotImplementedError('int8 weights on a data mesh take the GSPMD path, '
                                          'which is not ported (ROADMAP.md queue 1 item 14)')
            if mesh.processes > 1:
                raise NotImplementedError('serving on a mesh of several processes is not '
                                          'ported (ROADMAP.md queue 1 item 14)')
            if device is not None and torch.device(device) != mesh.devices[0]:
                raise ValueError(f'device {device} is not the mesh\'s first device '
                                 f'{mesh.devices[0]}')
            device = mesh.devices[0]
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator().manual_seed(config.seed if seed is None else seed)
            params = init_params(gen, config)
        self.params = move_tree(params, self.device)
        self._qdecode = self._qdecode_src = None
        self._tparams = self._tparams_src = None
        self._replicas_cache: dict = {}

    @property
    def data_mesh(self) -> bool:
        """Whether the mesh has a data axis (rows split over data ranks)."""
        return self.mesh is not None and 'data' in self.mesh.axis_names

    @property
    def decode_params(self) -> Params:
        """Params for the decode/serving paths: ``self.params``, or their view
        with a quantized transformer stack under ``config.weight_dtype``
        'int8' / 'int4' (``quantize.py``).  Quantized lazily and again whenever
        ``self.params`` or its 'transformer' entry is rebound (``load``
        rebinds); changing leaf tensors in place is not seen."""
        if self.config.weight_dtype not in ('int8', 'int4'):
            return self.params
        src = self._qdecode_src
        if not (src is not None and src[0] is self.params
                and src[1] is self.params['transformer']):
            bits = 8 if self.config.weight_dtype == 'int8' else 4
            self._qdecode = quantize_decode_params(self.params, bits=bits)
            self._qdecode_src = (self.params, self.params['transformer'])
        return self._qdecode

    def _decode_tparams(self) -> tuple[Params, Params]:
        """(``decode_params``, its transformer stack in the compute dtype),
        the cast kept until ``decode_params`` is rebound, so that a stream's
        segments do not cast the stack again."""
        p = self.decode_params
        src = self._tparams_src
        if not (src is not None and src[0] is p and src[1] is p['transformer']):
            # Under tensor parallelism int4 packs per rank, from the float stack.
            int4 = self.config.weight_dtype == 'int4'
            self._tparams = (compute_params(p, self.config)
                             if self.mesh is None or self.data_mesh
                             else shard_stack((self.params if int4 else p)['transformer'],
                                              self.mesh, self.config.torch_dtype, int4))
            self._tparams_src = (p, p['transformer'])
        return p, self._tparams

    def replicas(self, params: Params | None = None):
        """One (params, tp) per local data rank of a data mesh: the decode
        params (or ``params``) on the data rank's first device, and under a
        model axis its ('model',) mesh with the stack split over it (made
        once per params tree; int4 packs per rank from the float stack)."""
        from ..parallel import PerReplica
        p = self.decode_params if params is None else params
        hit = self._replicas_cache.get(id(p))
        if hit is not None and hit[0] is p:
            return hit[1]
        int4 = self.config.weight_dtype == 'int4' and params is None
        out = PerReplica()
        for i in self.mesh.local_data:
            sub = self.mesh.replica(i)
            dev = sub.devices[0]
            rp = p if dev == self.device else move_tree(p, dev)
            tp = None
            if sub.size > 1:
                src = (self.params if int4 else p)['transformer']
                tp = (sub, shard_stack(src, sub, self.config.torch_dtype, int4))
            out.append((rp, tp))
        self._replicas_cache[id(p)] = (p, out)
        return out

    def prefill(self, tokens: torch.Tensor, tokens_lens: torch.Tensor, codes: torch.Tensor,
                codes_lens: torch.Tensor, generator: torch.Generator):
        """The decode's prefill (JAX ``_prefill_jit``): ``_decode_prefill`` on
        the decode params.  Returns (DecodeState, tl_f, pl_f)."""
        self._solo_only('a decode stream')
        params, tparams = self._decode_tparams()
        with torch.inference_mode(), precision_scope(self.config):
            return _decode_prefill(params, tokens, tokens_lens, codes, codes_lens, self.config,
                                   tparams, generator)

    def advance(self, state: DecodeState, tl_f: torch.Tensor, pl_f: torch.Tensor, limit: int,
                ttm: int, pm: int) -> DecodeState:
        """One segment of the token loop (JAX ``_advance_jit``):
        ``_decode_advance`` to ``limit`` on the decode params.  Updates
        ``state`` in place (the cache and codes buffer too) and returns it."""
        self._solo_only('a decode stream')
        params, tparams = self._decode_tparams()
        with torch.inference_mode(), precision_scope(self.config):
            return _decode_advance(params, tparams, state, tl_f, pl_f, self.config, ttm, pm,
                                   limit)

    def _solo_only(self, what: str) -> None:
        """Streaming, continuous batching and the hub decode on one device:
        the JAX package has them on no mesh either."""
        if self.mesh is not None:
            raise NotImplementedError(f'{what} does not run on a mesh (nor in the JAX '
                                      'package): use a ValleAR without one')

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
        """Load params from a params file or a trainer step dir (LoRA
        fine-tune states merge through this model's lora_* config)."""
        from .checkpoint import load_params
        self.params = load_params(path, self.params, config=self.config)

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
                       bucket: bool = True, clock=None) -> list[torch.Tensor]:
        """Batched decode; per-item masks keep each result equal to its solo
        decode.  ``clock``: optional ``tts.StageClock`` (see ``_decode_fn``).
        Returns a list of 1-D int64 CPU tensors."""
        cfg, dev = self.config, self.device
        tokens_list = [torch.as_tensor(t, dtype=torch.long).reshape(-1) for t in tokens_list]
        codes0_list = [torch.cat([torch.tensor([self.bos_token]),
                                  torch.as_tensor(c, dtype=torch.long)[:, 0]])
                       for c in prompt_codes_list]
        bsz = len(tokens_list)
        if self.data_mesh:     # rows padded to a multiple of the data size (row 0 again)
            pad_rows = (-bsz) % self.mesh.data
            tokens_list = tokens_list + [tokens_list[0]] * pad_rows
            codes0_list = codes0_list + [codes0_list[0]] * pad_rows
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
            if self.data_mesh:
                codes_buf, best = self._data_decode(tokens, tokens_lens, codes, codes_lens,
                                                    generator, clock)
            else:
                params, tparams = self._decode_tparams() if self.mesh else (
                    self.decode_params, None)
                codes_buf, _, best = _decode_fn(
                    params, tokens, tokens_lens, codes, codes_lens, cfg, generator, clock,
                    None if self.mesh is None else (self.mesh, tparams))
        codes_buf, best = codes_buf.cpu(), best.cpu()
        out = []
        for i in range(bsz):
            row = codes_buf[i, int(best[i])][pm:]
            out.append(row[row != self.eos_token])
        return out

    def _data_decode(self, tokens, tokens_lens, codes, codes_lens, generator, clock):
        """``_decode_fn`` per data rank on its rows, each with its own
        generator (``replica_generators``): ``parallel.data_shard_map`` on a
        data-only mesh, ``parallel.tp_shard_map`` (tensor-parallel over the
        data rank's model ranks) under a model axis, as JAX ``ValleAR``
        picks.  Returns (codes_buf, best) of every row on the first device."""
        from ..parallel import PerReplica, data_shard_map, tp_shard_map
        cfg, mesh = self.config, self.mesh
        reps = self.replicas()
        rows = (tokens, tokens_lens, codes, codes_lens)
        gens = PerReplica(replica_generators(generator, mesh))
        if mesh.model == 1:
            def body(rep, tokens, tokens_lens, codes, codes_lens, gen):
                codes_buf, _, best = _decode_fn(rep[0], tokens, tokens_lens, codes,
                                                codes_lens, cfg, gen, clock, None)
                return codes_buf, best
            return data_shard_map(mesh, body, 6, (1, 2, 3, 4), 2)(reps, *rows, gens)

        def tp_body(sub, trees, params, tokens, tokens_lens, codes, codes_lens, gen):
            codes_buf, _, best = _decode_fn(params, tokens, tokens_lens, codes, codes_lens,
                                            cfg, gen, clock, (sub, trees))
            return codes_buf, best
        trees = [t for _, (_, group) in reps for t in group]
        return tp_shard_map(mesh, tp_body, 7, (2, 3, 4, 5), 2)(
            trees, PerReplica(p for p, _ in reps), *rows, gens)


def replica_generators(generator: torch.Generator, mesh) -> list[torch.Generator]:
    """One generator per local data rank of ``mesh``, on its first device,
    seeded from one draw of ``generator`` and the data rank (JAX folds the
    data index into the key): the data ranks sample apart, and greedy
    decodes do not read them."""
    base = int(torch.randint(0, 2 ** 62, (1,), generator=generator, device=generator.device))
    out = []
    for i in mesh.local_data:
        seed = int(np.random.SeedSequence([base, i]).generate_state(1, np.uint64)[0]) % 2 ** 63
        out.append(torch.Generator(device=mesh.group(i)[0]).manual_seed(seed))
    return out


class DecodeStream:
    """Incremental first-codebook decode (JAX ``DecodeStream``): prefill once,
    then ``advance(k)`` in bounded segments with the loop state (codes
    buffer, KV cache, generator, EOS and logprob statistics) held on the
    device between calls.  Segment boundaries are invisible: N partial
    advances give exactly the tokens of one full decode.  Needs
    ``num_beams == 1``: a best-of-N pick needs the finished sequences."""

    def __init__(self, model: ValleAR, tokens, prompt_codes,
                 generator: torch.Generator | None = None, bucket: bool = True):
        """tokens: (Tt,) source ids (prompt and target text); prompt_codes:
        (Tp, num_quantizers) acoustic prompt (may be empty)."""
        config = model.config
        if config.num_beams != 1:
            raise ValueError(f'streaming decode requires num_beams=1, got {config.num_beams}')
        self.model = model
        self.eos = model.eos_token
        self.max_new = config.max_audio_len
        dev = model.device
        tokens = torch.as_tensor(tokens, dtype=torch.long).reshape(-1)
        prompt_codes = torch.as_tensor(prompt_codes, dtype=torch.long).reshape(
            -1, config.num_quantizers)
        codes0 = torch.cat([torch.tensor([model.bos_token]), prompt_codes[:, 0]])
        ttm, pm = tokens.shape[0], codes0.shape[0]
        if bucket:
            ttm, pm = bucket_len(config.bucket_sizes, ttm), bucket_len(config.bucket_sizes, pm)
        tokens_pad = torch.nn.functional.pad(tokens, (0, ttm - tokens.shape[0]))[None].to(dev)
        codes_pad = torch.nn.functional.pad(codes0, (0, pm - codes0.shape[0]))[None].to(dev)
        if generator is None:
            generator = default_generator(config, dev)
        lens = torch.tensor([[tokens.shape[0]], [codes0.shape[0]]], dtype=torch.int32,
                            device=dev)
        self._state, self._tl, self._pl = model.prefill(tokens_pad, lens[0], codes_pad,
                                                        lens[1], generator)
        self._ttm, self._pm = ttm, pm
        self.steps_done = 0
        self.frames_done = 0          # valid (non-EOS) frames so far
        self.finished = False

    def advance(self, k: int) -> np.ndarray:
        """Advance by about ``k`` tokens; returns the newly generated
        first-codebook ids (EOS stripped).  ``k`` rounds up to a multiple of
        ``decode_unroll``.  Sets ``finished`` once every row hit EOS or
        ``max_audio_len`` was reached.  The loop may stop early where it
        finds every row finished, so ``steps_done`` follows the state's step,
        not the limit.  One small int row (the codes buffer and the finished
        flag) comes to the host per call."""
        if self.finished:
            return np.zeros((0,), np.int64)
        unroll = max(1, self.model.config.decode_unroll)
        k_eff = -(-int(k) // unroll) * unroll
        limit = min(self.steps_done + k_eff, self.max_new)
        state = self.model.advance(self._state, self._tl, self._pl, limit, self._ttm,
                                   self._pm)
        new_step = int(state.step)
        host = torch.cat([state.codes[0], state.finished.all().long()[None]]).cpu().numpy()
        row = host[self._pm + self.steps_done:self._pm + new_step]
        self.steps_done = new_step
        self.finished = bool(host[-1]) or new_step >= self.max_new
        out = row[row != self.eos]
        self.frames_done += len(out)
        return out
