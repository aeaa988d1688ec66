"""Continuous batching for the AR decode (``valle2_tpu/models/continuous.py``):
concurrent sessions share ONE batched decode loop, each row at its own depth.

N streaming sessions that each drive their own one-row ``DecodeStream`` run
N small decode loops back to back, each reading every weight once a token;
the joint loop (rows = ``n_slots``) reads the weights once a step for every
session.  Sessions JOIN a free row mid-flight (a one-row prefill, then an
insert into the joint state) and LEAVE when they finish.  The joint step is
the fused decode step with a (rows,) vector of per-row slots
(``kernels.fused_decode.fused_decode_step``'s per-row branch), or, off the
kernels' route, ``transformer_decode_step`` with the same per-row index.

Semantics (JAX's):

- Every row shares one geometry (ttm, pm, max_audio_len): prompts pad to it
  and per-row lengths mask the padding.
- Tokens equal each session's solo decode, greedy and sampled: each row
  samples from its own ``torch.Generator`` (given at ``join``), one
  (1, vocab) draw per step while the session is live, exactly the draws of
  its solo ``DecodeStream``.
- A finished, frozen or empty row is a no-op: its sample is forced to EOS,
  its step, statistics and carried logits do not change.  Its cache row
  still takes the frozen slot's k/v write, which only that row could read;
  a row frozen at its budget sits at slot S, where both the kernel and the
  plain step write nothing.

Where the JAX package runs ``advance`` as one on-device ``while_loop``, the
port runs a Python loop of steps that asks the device whether any row is
still active every ``FINISHED_CHECK_EVERY`` steps (speculative:
``SPEC_CHECK_EVERY`` turns); the steps in between are no-ops, so the tokens
are the same.  ``advance`` brings the steps, the finished flags and the codes
buffer to the host in one transfer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any

import numpy as np
import torch

from ..config import precision_scope
from ..kernels.fused_decode import (fused_cache_layout, fused_decode_step, fused_verify_step,
                                    padded_cache_len, verify_slot_mask)
from ..ops import (NEG_INF, KVCache, categorical_rows, decode_logits, embedding,
                   sinusoidal_table, top_k_top_p_filter, topk_sampling, topk_sampling_rows,
                   transformer_decode_step)
from .ar import (FINISHED_CHECK_EVERY, MAX_POS, SPEC_CHECK_EVERY, DecodeState, ValleAR, _dims,
                 _ngram_draft, _spec_gate, _specials, check_max_pos, default_generator)

Params = dict[str, Any]

__all__ = ['ContinuousDecoder', 'BatcherFull']


class BatcherFull(RuntimeError):
    """Raised by ``ContinuousDecoder.join`` when no slot is free."""


def _live_generators(state: DecodeState, draw: list[bool]) -> list:
    """Row r's generator where the host counts row r live, else None (a
    frozen or released row draws nothing)."""
    return [g if on else None for g, on in zip(state.generator, draw)]


def _position_rows(pe: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Sinusoidal rows at ``pos``, clamped to the table as ``jnp.take`` clamps
    (a frozen row may sit one past its last position)."""
    return pe[pos.clamp(max=pe.shape[0] - 1)]


def _cb_advance(params: Params, tparams: Params, state: DecodeState, tl_f: torch.Tensor,
                pl_f: torch.Tensor, k: int, config, ttm: int, pm: int,
                draw: list[bool]) -> DecodeState:
    """Advance every ACTIVE row by up to ``k`` tokens, IN PLACE (JAX
    ``_cb_advance``): ``_decode_advance``'s step with the step and the write
    slot per row.  ``state.step`` is a (rows,) tensor and ``state.generator``
    a list of per-row generators, of which the rows in ``draw`` sample."""
    eos, _ = _specials(config)
    max_new = config.max_audio_len
    use_fused = state.cache.k.dim() == 4
    dev = state.codes.device
    seq = state.cache.k.shape[2] if use_fused else state.cache.k.shape[3]
    pe = sinusoidal_table(MAX_POS, config.d_model, device=dev)
    cols = torch.arange(state.codes.shape[1], device=dev)[None, :]
    gens = _live_generators(state, draw)
    pos0 = pl_f.long()
    codes, logits, cache = state.codes, state.logits, state.cache
    step, sum_lp, finished = state.step, state.sum_logprobs, state.finished
    unroll = max(1, config.decode_unroll)
    n, next_check = 0, FINISHED_CHECK_EVERY
    while n < k:
        if n >= next_check:
            if not bool((~finished & (step < max_new)).any()):
                break
            next_check = n + FINISHED_CHECK_EVERY
        for _ in range(unroll):
            active = ~finished & (step < max_new)
            samples, logprobs = topk_sampling_rows(logits, gens, top_k=config.top_k,
                                                   tok_p=config.tok_p,
                                                   temperature=config.temperature)
            sum_lp = sum_lp + logprobs * active
            samples = torch.where(active, samples, eos)
            finished = finished | ~active
            if not config.ignore_eos:
                finished = finished | (samples == eos)
            codes = torch.where((cols == (pm + step)[:, None]) & active[:, None],
                                samples[:, None], codes)
            x = embedding(params['audio_emb'], samples[:, None]) \
                + _position_rows(pe, pos0 + step)[:, None]
            x = x.to(config.torch_dtype).contiguous()
            write_idx = (ttm + pm + step).to(torch.int32)
            if use_fused:
                y, cache = fused_decode_step(tparams, x, config.n_heads, cache, write_idx,
                                             tl_f, pl_f, ttm, pm,
                                             chunk_override=config.decode_chunk or None)
            else:
                attend = verify_slot_mask(seq, write_idx, 1, tl_f, pl_f, ttm, pm)
                y, cache = transformer_decode_step(tparams, x, config.n_heads, cache,
                                                   write_idx, attend_mask=attend)
            # A frozen row keeps its carried logits: a pending row's prefill
            # logits give its first token after activation.
            logits = torch.where(active[:, None],
                                 decode_logits(params['proj'], y[:, 0].float()), logits)
            step = step + active
        n += unroll
    state.step, state.codes, state.logits, state.cache = step, codes, logits, cache
    state.sum_logprobs, state.finished = sum_lp, finished
    return state


def _cb_advance_spec(params: Params, tparams: Params, state: DecodeState, tl_f: torch.Tensor,
                     pl_f: torch.Tensor, turns: int, config, ttm: int, pm: int,
                     draw: list[bool]) -> DecodeState:
    """Speculative continuous batching (JAX ``_cb_advance_spec``): up to
    ``turns`` verify turns for every ACTIVE row, IN PLACE, each committing
    1..K tokens through one K-token verify pass (``fused_verify_step`` at
    per-row start slots).  The turn is ``ar._decode_advance_spec``'s with
    per-row generators: a live row draws what its solo speculative decode
    draws per turn (its first token, then, sampled, the acceptance uniforms
    and the residual), so greedy rows commit the plain loop's tokens and
    sampled rows their solo speculative decode's.  Frozen rows commit
    nothing and keep their carried logits; their pass writes K slots of
    slack past their step."""
    eos, _ = _specials(config)
    max_new, k_blk = config.max_audio_len, config.speculative_k
    use_fused = state.cache.k.dim() == 4
    dev = state.codes.device
    rows = state.codes.shape[0]
    seq = state.cache.k.shape[2] if use_fused else state.cache.k.shape[3]
    pe = sinusoidal_table(MAX_POS, config.d_model, device=dev)
    sampled = bool(config.temperature and config.temperature > 0.0)
    temp = float(config.temperature) if sampled else 1.0
    gens = _live_generators(state, draw)
    codes, logits, cache = state.codes, state.logits, state.cache
    step, sum_lp, finished = state.step, state.sum_logprobs, state.finished
    blk = torch.arange(k_blk, device=dev)[None, :]
    row_ids = torch.arange(rows, device=dev)
    for n in range(turns):
        alive = ~finished & (step < max_new)
        if n and n % SPEC_CHECK_EVERY == 0 and not bool(alive.any()):
            break
        t0, lp0 = topk_sampling_rows(logits, gens, top_k=config.top_k, tok_p=config.tok_p,
                                     temperature=config.temperature)
        t0 = torch.where(alive, t0, eos)
        # A frozen row writes EOS over EOS: the buffer has K columns of slack.
        codes.scatter_(1, (pm + step)[:, None], t0[:, None])
        draft = _ngram_draft(codes, pm + step + 1, config.speculative_ngram, k_blk - 1, t0)
        block = torch.cat([t0[:, None], draft], dim=1)                        # (rows, K)

        x = embedding(params['audio_emb'], block) \
            + _position_rows(pe, pl_f.long()[:, None] + step[:, None] + blk)
        x = x.to(config.torch_dtype).contiguous()
        write_idx = (ttm + pm + step).to(torch.int32)
        if use_fused:
            y, cache = fused_verify_step(tparams, x, config.n_heads, cache, write_idx, tl_f,
                                         pl_f, ttm, pm,
                                         chunk_override=config.decode_chunk or None)
        else:
            attend = verify_slot_mask(seq, write_idx, k_blk, tl_f, pl_f, ttm, pm)
            y, cache = transformer_decode_step(tparams, x, config.n_heads, cache, write_idx,
                                               attend_mask=attend)
        flat3 = decode_logits(params['proj'], y.float())                      # (rows, K, V)
        vocab = flat3.shape[-1]
        if not sampled:
            g_tok, g_lp = topk_sampling(flat3.reshape(rows * k_blk, vocab), top_k=config.top_k,
                                        tok_p=config.tok_p, temperature=config.temperature)
            g_tok, g_lp = g_tok.reshape(rows, k_blk), g_lp.reshape(rows, k_blk)
            match = (block[:, 1:] == g_tok[:, :-1]).long()
            lp_blk = torch.cat([lp0[:, None], g_lp[:, :-1]], dim=1)
        else:
            filt = top_k_top_p_filter(flat3 / temp, config.top_k, config.tok_p)
            logp = torch.log_softmax(filt, dim=-1)
            lp_draft = logp[:, :-1].gather(-1, block[:, 1:, None])[..., 0]      # (rows, K-1)
            u = torch.ones_like(lp_draft)
            for r, g in enumerate(gens):
                if g is not None:
                    u[r:r + 1] = torch.rand((1, k_blk - 1), generator=g, device=dev)
            match = (torch.log(u) < lp_draft).long()
            lp_blk = torch.cat([lp0[:, None], lp_draft], dim=1)
        c_acc = torch.cumprod(match, dim=1).sum(dim=1) + 1                      # 1..K

        c = c_acc
        if not config.ignore_eos:
            is_eos = block == eos
            first_eos = is_eos.int().argmax(dim=1)
            c = torch.where(is_eos.any(dim=1), torch.minimum(c, first_eos + 1), c)
        c = torch.where(alive, torch.minimum(c, max_new - step), 0)
        take = blk < c[:, None]
        sum_lp = sum_lp + (lp_blk * take).sum(dim=1)
        codes.scatter_(1, pm + step[:, None] + blk, torch.where(take, block, eos))
        step_new = step + c
        finished = finished | (step_new >= max_new)
        if not config.ignore_eos:
            finished = finished | ((block == eos) & take).any(dim=1)
        ci = (c - 1).clamp(0, k_blk - 1)
        logits_next = torch.where((c > 0)[:, None], flat3[row_ids, ci], logits)

        if sampled:
            prev = (c_acc - 1).clamp(0, k_blk - 1)
            d_rej = block[row_ids, c_acc.clamp(0, k_blk - 1)]
            vocab_ids = torch.arange(vocab, device=dev)[None, :]
            resid = torch.where(vocab_ids == d_rej[:, None], NEG_INF, filt[row_ids, prev])
            x_new = categorical_rows(torch.softmax(resid, dim=-1), gens)
            lp_new = logp[row_ids, prev, x_new]
            do_force = alive & (c_acc < k_blk) & (c == c_acc) & ~finished
            sum_lp = sum_lp + torch.where(do_force, lp_new, 0.0)
            force_row = torch.where(vocab_ids == x_new[:, None], 0.0, NEG_INF)
            logits_next = torch.where(do_force[:, None], force_row, logits_next)
        step, logits = step_new, logits_next
    state.step, state.codes, state.logits, state.cache = step, codes, logits, cache
    state.sum_logprobs, state.finished = sum_lp, finished
    return state


def _cb_insert(state: DecodeState, tl_f: torch.Tensor, pl_f: torch.Tensor, row: DecodeState,
               row_tl: torch.Tensor, row_pl: torch.Tensor, slot: int) -> None:
    """Write a freshly prefilled one-row state into joint row ``slot``, in
    place.  The row's cache (already in the joint layout) may be shorter
    than the joint one (its chunk padding): it fills slots [0, S_row), and
    the slots past it are never attended.  The row adopts the session's own
    generator, and inserts FROZEN (finished) until ``activate``."""
    fused = state.cache.k.dim() == 4
    for joint, one in zip(state.cache, row.cache):
        if joint is None:
            continue
        if fused:                                   # (L, rows, S, d | h)
            joint[:, slot, :one.shape[2]] = one[:, 0]
        else:                                       # (L, rows, h, S, hd | 1)
            joint[:, slot, :, :one.shape[3]] = one[:, 0]
    state.codes[slot] = row.codes[0]
    state.logits[slot] = row.logits[0]
    state.step[slot] = 0
    state.sum_logprobs[slot] = 0.0
    state.finished[slot] = True
    state.generator[slot] = row.generator
    tl_f[slot] = row_tl[0]
    pl_f[slot] = row_pl[0]


class ContinuousDecoder:
    """Host-side slot manager over the continuous-batching decode loop (JAX
    ``ContinuousDecoder``).

    ``join`` prefills a session and claims a free row; ``advance(k)`` steps
    every live session up to ``k`` tokens and returns the newly generated
    first-codebook ids per slot; ``release`` frees a row.  Thread-safe: one
    lock around the device state (a hub drives it from a driver thread while
    request threads join); the prefill runs outside it.

    ``model``: a ValleAR whose params (and quantized view) are shared; a
    one-beam sibling config drives the loop.  The prefill runs unfused at
    rows = 1 and its cache row is converted to the joint layout on insert;
    the joint loop takes the fused decode kernels where the caller's
    ``use_fused_decode`` resolves to them on the model's device (at the
    joint geometry: rows = ``n_slots``, the cache padded to its chunk).
    ``ttm`` / ``pm``: the shared prompt geometry (token / code slots; default
    the smallest of ``config.bucket_sizes``); a longer prompt is refused at
    ``join``.  ``speculative``: the joint loop runs n-gram verify turns
    (``_cb_advance_spec``; needs ``config.speculative_k >= 2``), so
    ``advance(k)`` runs up to ``k`` TURNS of 1..K tokens each.
    """

    def __init__(self, model: ValleAR, n_slots: int = 4, ttm: int | None = None,
                 pm: int | None = None, speculative: bool = False):
        config = model.config
        if config.num_beams != 1:
            raise ValueError('continuous batching requires num_beams == 1')
        if n_slots < 1:
            raise ValueError(f'n_slots must be >= 1, got {n_slots}')
        self._spec = bool(speculative)
        if self._spec:
            cfg = dataclasses.replace(config, num_beams=1, use_fused_decode=False)
            if not _spec_gate(cfg):       # validates; False = k < 2 (off)
                raise ValueError('speculative=True requires config.speculative_k >= 2')
        else:
            # The plain joint loop: a spec config would make the one-row
            # prefill pad its cache K slots past the joint geometry.
            cfg = dataclasses.replace(config, num_beams=1, use_fused_decode=False,
                                      speculative_k=0)
        dev = model.device
        self._ar = ValleAR(cfg, params=model.params, device=dev)
        if config.weight_dtype in ('int8', 'int4'):     # share the quantized view
            self._ar._qdecode = model.decode_params
            self._ar._qdecode_src = (self._ar.params, self._ar.params['transformer'])
        self._ar._decode_tparams()     # cast once, before any thread asks for it
        self.config = cfg
        self.n_slots = n_slots
        self.ttm = int(ttm if ttm is not None else min(config.bucket_sizes))
        self.pm = int(pm if pm is not None else min(config.bucket_sizes))
        self.eos = self._ar.eos_token
        self.max_new = cfg.max_audio_len

        unroll = max(1, cfg.decode_unroll)
        max_new_pad = -(-self.max_new // unroll) * unroll
        if self._spec:
            max_new_pad += cfg.speculative_k    # the one-row prefill's slack
        total = self.ttm + self.pm + max_new_pad
        width = self.pm + max_new_pad
        check_max_pos(self.ttm, width, 'continuous-batching hub')
        cache_dtype = cfg.torch_cache_dtype
        self._use_fused = config.fused_decode_enabled(dev)
        L, h, d = cfg.num_layers, cfg.n_heads, cfg.d_model
        with self._scope():
            if self._use_fused:
                total = padded_cache_len(total, n_slots, d, h, cache_dtype,
                                         cfg.decode_chunk or None)
                shape, scale_shape = (L, n_slots, total, d), (L, n_slots, total, h)
            else:
                shape = (L, n_slots, h, total, d // h)
                scale_shape = (L, n_slots, h, total, 1)
            kv = [torch.zeros(shape, dtype=cache_dtype, device=dev) for _ in range(2)]
            if cache_dtype == torch.int8:
                kv += [torch.zeros(scale_shape, dtype=torch.bfloat16, device=dev)
                       for _ in range(2)]
            _, tgt_vocab = _dims(cfg)
            self._state = DecodeState(
                step=torch.zeros(n_slots, dtype=torch.long, device=dev),
                codes=torch.full((n_slots, width), self.eos, dtype=torch.long, device=dev),
                logits=torch.zeros((n_slots, tgt_vocab - 1), dtype=torch.float32, device=dev),
                cache=KVCache(*kv),
                sum_logprobs=torch.zeros(n_slots, dtype=torch.float32, device=dev),
                finished=torch.ones(n_slots, dtype=torch.bool, device=dev),
                generator=[None] * n_slots)
            self._tl = torch.zeros(n_slots, dtype=torch.int32, device=dev)
            self._pl = torch.zeros(n_slots, dtype=torch.int32, device=dev)
        self._lock = threading.Lock()
        # Host bookkeeping per slot: None = free; else a dict.
        self._sessions: list[dict | None] = [None] * n_slots

    @contextlib.contextmanager
    def _scope(self):
        """The decode's scope, entered on whichever thread touches the state:
        ``inference_mode`` is thread-local."""
        with torch.inference_mode(), precision_scope(self.config):
            yield

    # -- session lifecycle -------------------------------------------------

    def free_slots(self) -> int:
        with self._lock:
            return sum(s is None for s in self._sessions)

    def join(self, tokens, prompt_codes, start: bool = True,
             generator: torch.Generator | None = None, tag: Any = None) -> int:
        """Prefill a session (tokens: (Tt,) source ids incl. the target text;
        prompt_codes: (Tp, num_quantizers)) and claim a free slot.  Returns
        the slot id; raises BatcherFull when every row is occupied, and
        ValueError when the prompt exceeds the shared geometry.

        ``generator`` is this session's own sampler (default: seeded with
        ``config.seed`` on the model's device, as ``DecodeStream``'s): sampled
        rows draw exactly what a solo ``DecodeStream`` on the same generator
        would.  ``tag``: opaque caller identity returned by
        ``advance(tags=True)``.  The slot is pending (invisible to
        ``advance``, frozen on the device) until the insert lands and, with
        ``start=False``, until ``activate(slot)``."""
        cfg, dev = self.config, self._ar.device
        tokens = np.asarray(tokens, np.int64).reshape(-1)
        pcodes = np.asarray(prompt_codes, np.int64).reshape(-1, cfg.num_quantizers)
        codes0 = np.concatenate([[self._ar.bos_token], pcodes[:, 0]]).astype(np.int64)
        if len(tokens) > self.ttm:
            raise ValueError(f'prompt tokens ({len(tokens)}) exceed the batcher geometry '
                             f'ttm={self.ttm}')
        if len(codes0) > self.pm:
            raise ValueError(f'prompt codes ({len(codes0) - 1}) exceed the batcher geometry '
                             f'pm={self.pm - 1}')
        tokens_pad = torch.as_tensor(np.pad(tokens, (0, self.ttm - len(tokens))))[None].to(dev)
        codes_pad = torch.as_tensor(np.pad(codes0, (0, self.pm - len(codes0))))[None].to(dev)
        lens = torch.tensor([[len(tokens)], [len(codes0)]], dtype=torch.int32, device=dev)
        with self._lock:
            slot = next((i for i, s in enumerate(self._sessions) if s is None), None)
            if slot is None:
                raise BatcherFull(f'all {self.n_slots} slots busy')
            self._sessions[slot] = {'emitted': 0, 'finished': False, 'pending': True,
                                    'tag': tag}
        try:
            if generator is None:
                generator = default_generator(cfg, dev)
            row, row_tl, row_pl = self._ar.prefill(tokens_pad, lens[0], codes_pad, lens[1],
                                                   generator)
            with self._scope():
                if self._use_fused:
                    row.cache = fused_cache_layout(row.cache)
                with self._lock:
                    _cb_insert(self._state, self._tl, self._pl, row, row_tl, row_pl, slot)
        except BaseException:
            with self._lock:
                self._sessions[slot] = None
            raise
        if start:
            self.activate(slot)
        return slot

    def activate(self, slot: int) -> None:
        """Make a ``join(start=False)`` slot live: the row starts decoding at
        the next ``advance``, so the session's first delivery is that
        segment's."""
        with self._lock:
            sess = self._sessions[slot]
            if sess is None:
                raise KeyError(f'slot {slot} is not occupied')
            with self._scope():
                self._state.finished[slot] = False
            sess['pending'] = False

    def advance(self, k: int, tags: bool = False) -> dict:
        """One joint advance of up to ``k`` tokens for every live row
        (``speculative``: up to ``k`` verify turns).  Returns {slot: newly
        generated ids (EOS stripped)} for every live slot that produced
        tokens or just finished; with ``tags=True`` {slot: (tag, ids, done)},
        the join-time tag and the doneness read under the lock.  Empty when
        nothing is live."""
        with self._lock:
            live = [i for i, s in enumerate(self._sessions)
                    if s is not None and not s['finished'] and not s['pending']]
            if not live:
                return {}
            draw = [i in live for i in range(self.n_slots)]
            params, tparams = self._ar._decode_tparams()
            fn = _cb_advance_spec if self._spec else _cb_advance
            with self._scope():
                st = fn(params, tparams, self._state, self._tl, self._pl, int(k), self.config,
                        self.ttm, self.pm, draw)
                host = torch.cat([st.step[:, None], st.finished[:, None].long(), st.codes],
                                 dim=1).cpu().numpy()
            out: dict = {}
            for slot in live:
                sess = self._sessions[slot]
                steps = int(host[slot, 0])
                row = host[slot, 2 + self.pm + sess['emitted']:2 + self.pm + steps]
                sess['emitted'] = steps
                done = bool(host[slot, 1]) or steps >= self.max_new
                sess['finished'] = done
                new = row[row != self.eos]
                if len(new) or done:
                    out[slot] = (sess['tag'], new, done) if tags else new
            return out

    def finished(self, slot: int) -> bool:
        with self._lock:
            sess = self._sessions[slot]
            if sess is None:
                raise KeyError(f'slot {slot} is not occupied')
            return sess['finished']

    def release(self, slot: int) -> None:
        """Free a row (idempotent).  Safe mid-decode: the row is force-
        finished on the device; the host-side free happens even if that
        fails, so a dead device does not leak slots."""
        with self._lock:
            if self._sessions[slot] is None:
                return
            try:
                with self._scope():
                    self._state.finished[slot] = True
            finally:
                self._sessions[slot] = None
