"""The head-folded flash forward (#2) of valle2_tpu_torch against the JAX
package: the plain version against the Pallas ``_flash_fwd_folded``
(interpret mode on the CPU, as tests/test_kernels.py runs it), the fold
route's grads against ``jax.vjp``, the ``VALLE2_FLASH_FOLD`` rule, and a
2-layer AR and NAR train step with the variable set against the JAX step on
the same weights and batch.  Also the CUDA kernel's host side: its item
schedule (``fold_plan``, ``fold_items``) at chip_smoke.py's shapes and 1, 8
and 132 SMs, and its kv-tile bound against ``prefix_lm_attend``.  On the
CPU every wrapper takes its plain version; chip_smoke.py and
tests/test_torch_cuda.py hold the CUDA kernel #2 against it, and against
#1, on the card.  float32; tolerances as in tests/test_torch_kernels.py
(f32 sums in another order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import TRAIN, ar_batch, leaves, nar_batch, to_j, to_t
from torch_port_helpers import close
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu.config import ConfigValle as JConfig
from valle2_tpu.kernels.flash_attention import _flash_fwd_folded
from valle2_tpu.kernels.flash_attention import _fold_default as j_fold_default
from valle2_tpu.kernels.flash_attention import flash_attention as j_flash_attention
from valle2_tpu.kernels.flash_attention import reference_attention
from valle2_tpu.models import ar as jar
from valle2_tpu.models import nar as jnar
from valle2_tpu.models.convert import export_ar_state_dict, export_nar_state_dict
from valle2_tpu.train import init_state as j_init_state
from valle2_tpu.train import make_train_step as j_make_train_step
from valle2_tpu_torch import train as ttrain
from valle2_tpu_torch.config import ConfigValle
from valle2_tpu_torch.kernels import flash_attention as tflash
from valle2_tpu_torch.models import nar as tnar
from valle2_tpu_torch.models.convert import load_ar_state_dict, load_nar_state_dict

# The Pallas folded forward (interpret mode) as one compiled program.
j_flash_fwd_folded = jax.jit(_flash_fwd_folded, static_argnums=(4, 5, 6, 7))
j_reference_attention = jax.jit(reference_attention, static_argnums=(4, 5))
# 64-row folded blocks: every case spans two or more, several heads; the
# zero-source row sits where s is a multiple of 64 (the Pallas kernel pads s
# up to its block, and a row that sees no key averages the padding too).
FOLD_CASES = {
    # (b, h, s, hd, tokens_total, meta, causal)
    'causal_ragged': (2, 3, 100, 16, 30, [[30, 100], [12, 90]], True),
    'bidirectional': (2, 4, 96, 16, 24, [[20, 96], [24, 70]], False),
    'zero_source_row': (3, 2, 128, 32, 40, [[40, 128], [25, 100], [0, 64]], True),
    'zero_source_bidirectional': (2, 2, 128, 16, 32, [[0, 128], [32, 97]], False),
}
# (value of VALLE2_FLASH_FOLD or None for unset, what the JAX rule returns)
SPELLINGS = [(None, False), ('0', False), ('false', False), ('False', False),
             (' OFF ', False), ('no', False), ('', False), ('  ', False), ('1', True),
             ('true', True), ('yes', True), ('on', True), ('2', True), ('fold', True)]


def case_inputs(case):
    b, h, s, hd, tt, meta, causal = FOLD_CASES[case]
    rs = np.random.RandomState(sorted(FOLD_CASES).index(case) + 70)
    q, k, v, do = (rs.standard_normal((b, h, s, hd)).astype(np.float32) for _ in range(4))
    return (q, k, v, np.asarray(meta, np.int32)), do, tt, causal


@pytest.mark.parametrize('case', sorted(FOLD_CASES))
def test_plain_matches_pallas_folded_kernel(case):
    """o and lse of ``flash_attention(fold_heads=True)`` on CPU tensors (the
    plain version) == the Pallas folded forward on every query row that sees
    a key, and == the JAX ``reference_attention`` on every row.  A row that
    sees no key (a zero-source item's token rows) is the uniform average of
    v: over all s keys in the reference and the port, over the kv blocks the
    Pallas tile bound visits in the TPU kernel."""
    (q, k, v, meta), _, tt, causal = case_inputs(case)
    jin = [jnp.asarray(a) for a in (q, k, v, meta)]
    o_j, lse_j = j_flash_fwd_folded(*jin, tt, causal, 64, 64)
    o_t, lse_t = tflash.flash_attention(*(torch.from_numpy(a) for a in (q, k, v, meta)), tt,
                                        causal, fold_heads=True)
    assert o_t.shape == q.shape and lse_t.shape == q.shape[:3]
    sees = np.asarray(lse_j) > -1e29
    assert sees.mean() > 0.8
    close(o_t.numpy()[sees], np.asarray(o_j)[sees], atol=2e-5)
    close(lse_t, lse_j, atol=2e-5)
    close(o_t, j_reference_attention(*jin, tt, causal), atol=2e-5)


@functools.lru_cache(maxsize=None)
def jax_fold_vjp(case):
    """(dq, dk, dv) of jax.vjp of the JAX flash_attention(fold_heads=True)."""
    (q, k, v, meta), do, tt, causal = case_inputs(case)

    @jax.jit      # one compiled program: op-by-op dispatch compiles each op
    def grads_of(q_, k_, v_, do_):
        return jax.vjp(lambda a, b, c: j_flash_attention(a, b, c, jnp.asarray(meta), tt,
                                                         causal, fold_heads=True),
                       q_, k_, v_)[1](do_)
    return tuple(np.asarray(g) for g in grads_of(*(jnp.asarray(a) for a in (q, k, v, do))))


@pytest.mark.parametrize('case', ['causal_ragged', 'zero_source_bidirectional'])
def test_fold_route_grads_match_jax_vjp(case):
    """``FlashAttention.apply(..., fold=True)`` on the CPU: grads of q, k, v
    == jax.vjp of the folded JAX route (its backward is #3 on the folded
    forward's lse, as in the port)."""
    (q, k, v, meta), do, tt, causal = case_inputs(case)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = tflash.FlashAttention.apply(q, k, v, torch.from_numpy(meta), tt, causal, True)
    o.backward(torch.from_numpy(do))
    for g, w in zip((q.grad, k.grad, v.grad), jax_fold_vjp(case)):
        close(g, w, atol=2e-5)


@pytest.mark.parametrize('value,want', SPELLINGS, ids=[repr(v) for v, _ in SPELLINGS])
def test_fold_default_matches_jax(monkeypatch, value, want):
    if value is None:
        monkeypatch.delenv('VALLE2_FLASH_FOLD', raising=False)
    else:
        monkeypatch.setenv('VALLE2_FLASH_FOLD', value)
    assert j_fold_default(4, 385) is want
    assert tflash._fold_default(4, 385) is want


@pytest.mark.parametrize('fold_heads,env', [(True, None), (False, '1'), (None, '1'),
                                            (None, '0'), (None, None)])
def test_fold_heads_routes_and_cpu_launches_nothing(monkeypatch, fold_heads, env):
    """``fold_heads`` True takes #2's wrapper, False #1's, None follows the
    variable (read at call time); on CPU tensors neither launches."""
    if env is None:
        monkeypatch.delenv('VALLE2_FLASH_FOLD', raising=False)
    else:
        monkeypatch.setenv('VALLE2_FLASH_FOLD', env)
    folded = []
    real = tflash.flash_attention_folded
    monkeypatch.setattr(tflash, 'flash_attention_folded',
                        lambda *a: folded.append(1) or real(*a))
    (q, k, v, meta), _, tt, causal = case_inputs('causal_ragged')
    args = [torch.from_numpy(a) for a in (q, k, v, meta)]
    counts = (tflash.COUNTER.count, tflash.FOLD_COUNTER.count)
    o, lse = tflash.flash_attention(*args, tt, causal, fold_heads=fold_heads)
    assert (tflash.COUNTER.count, tflash.FOLD_COUNTER.count) == counts
    assert bool(folded) is (fold_heads if fold_heads is not None else env == '1')
    o_p, lse_p = tflash.flash_attention_plain(*args, tt, causal)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)


def spy_fold(monkeypatch) -> list:
    """Record the calls of the port's fold wrapper."""
    calls = []
    real = tflash.flash_attention_folded

    def spy(*a):
        calls.append(a[0].shape)
        return real(*a)
    monkeypatch.setattr(tflash, 'flash_attention_folded', spy)
    return calls


@pytest.mark.parametrize('model', ['ValleAR', 'ValleNAR'])
def test_train_step_with_fold_env_matches_jax(monkeypatch, model):
    """VALLE2_FLASH_FOLD=1, use_flash_attention=True on both sides: one train
    step of the port (the fold route, every layer) == a freshly traced JAX
    make_train_step (the Pallas folded forward, interpret mode) on the same
    weights and batch: loss, grad norm and every parameter, atol 1e-5.  The
    NAR port step takes the stage the JAX step drew."""
    monkeypatch.setenv('VALLE2_FLASH_FOLD', '1')
    calls = spy_fold(monkeypatch)
    kw = dict(TRAIN, use_flash_attention=True, lr=3e-3, lr_warmup=3)
    jcfg, cfg = JConfig(**kw), ConfigValle(**kw)
    init = (jar if model == 'ValleAR' else jnar).init_params
    jparams = jax.jit(lambda key: init(key, jcfg))(jax.random.key(0))   # one program
    jstate = j_init_state(jcfg, model, jax.random.key(0), base_params=jparams)
    export, load = ((export_ar_state_dict, load_ar_state_dict) if model == 'ValleAR'
                    else (export_nar_state_dict, load_nar_state_dict))
    tstate = ttrain.init_state(cfg, model, device='cpu',
                               base_params=load(export(jstate.params)))
    batch = ar_batch(21) if model == 'ValleAR' else nar_batch(5)
    jstate, jm = j_make_train_step(jcfg, model)(jstate, to_j(batch), jax.random.key(3))
    if model == 'ValleNAR':
        stage = int(jm['stage'])
        monkeypatch.setattr(tnar, 'draw_stage',
                            lambda c, g: torch.tensor([stage], device=g.device))
    tstate, tm = ttrain.make_train_step(cfg, model)(tstate, to_t(batch), 0)
    assert len(calls) == cfg.num_layers
    close(tm['loss'], jm['loss'], atol=1e-5)
    close(tm['grad_norm'], jm['grad_norm'], atol=1e-5, rtol=1e-5)
    want = dict(leaves(jstate.params))
    for key, val in leaves(tstate.params):
        close(val, want[key], atol=1e-5)


def chip_smoke_fold_cases():
    """chip_smoke.py's FOLD_CASES: (b, h, s, tokens_total, causal) of the
    fold's card shapes."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', Path(__file__).resolve().parent.parent / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FOLD_CASES


CARD_FOLD_CASES = chip_smoke_fold_cases()


@pytest.mark.parametrize('consumers', [1, 2], ids=['f32', 'bf16'])
@pytest.mark.parametrize('sms', [1, 8, 132])
@pytest.mark.parametrize('case', sorted(CARD_FOLD_CASES))
def test_fold_schedule_covers_every_head_once_heaviest_first(case, sms, consumers):
    """#2's item schedule (``fold_plan``, ``fold_items``, the kernel's
    ``fold_item``): the items, each with its group's heads, cover every
    (batch row, head, q-tile) exactly once; they go out heaviest first (their
    kv-tile count never rises along the order the kernel's counter hands
    them out in); the grid is min(items, slots); a group holds at least one
    head per consumer where h allows, and the makespan is no more than one
    block walking everything."""
    b, h, s, tt, causal = CARD_FOLD_CASES[case]
    plan = tflash.fold_plan(b, h, s, tt, causal, sms, consumers)
    q_tiles = -(-s // tflash.FOLD_BQ)
    assert plan.groups * plan.group_size == h and plan.group_size >= min(consumers, h)
    items = tflash.fold_items(b, s, plan.groups)
    assert len(items) == plan.items == b * q_tiles * plan.groups
    assert plan.grid == min(plan.items, sms)
    seen = set()
    for bb, qt, g in items:
        for hh in range(plan.group_size):
            key = (bb, g * plan.group_size + hh, qt)
            assert key not in seen
            seen.add(key)
    assert sorted(seen) == [(bb, hh, qt) for bb in range(b) for hh in range(h)
                            for qt in range(q_tiles)]
    work = [tflash.kv_tile_bound(qt, s, tt, s, causal) for _, qt, _ in items]
    assert work == sorted(work, reverse=True)
    per_head = -(-plan.group_size // consumers)
    assert 0 < plan.makespan <= per_head * sum(w + tflash.FOLD_HEAD_COST for w in work)


def test_fold_plan_splits_heads_only_as_far_as_needed():
    """At the 204M shape (b=16, h=16, s=640, causal) on 132 SMs, one bf16
    block each, the 160 (batch row, q-tile) pairs alone leave the second
    wave mostly idle: the plan splits the heads into 8 groups of 2, one head
    per consumer.  On one SM there is nothing to fill, and all 16 heads stay
    in one group; at the serving prefill (21 pairs) every group holds one
    head per consumer; in f32 (one consumer, three blocks an SM) each head
    is an item of its own."""
    plan = tflash.fold_plan(16, 16, 640, 128, True, 132, 2)
    assert (plan.groups, plan.group_size, plan.grid) == (8, 2, 132)
    assert tflash.fold_plan(16, 16, 640, 128, True, 1, 2).groups == 1
    serve = tflash.fold_plan(3, 4, 385, 128, True, 132, 2)
    assert (serve.groups, serve.items, serve.grid) == (2, 42, 42)
    assert tflash.fold_plan(16, 16, 640, 128, True, 396, 1).group_size == 1


@pytest.mark.parametrize('case', sorted(FOLD_CASES) + sorted(CARD_FOLD_CASES))
def test_kv_tile_bound_leaves_no_attended_key_past_it(case):
    """The kernel's kv-tile bound, mirrored in ``kv_tile_bound`` at #2's
    64-key tiles: no key that ``ops.masks.prefix_lm_attend`` lets a row of
    the q-tile see lies past it, and a batch row with tokens_valid == 0
    walks every tile (its rows average over all s keys)."""
    from valle2_tpu_torch.ops.masks import prefix_lm_attend
    if case in FOLD_CASES:
        b, _, s, _, tt, meta, causal = FOLD_CASES[case]
        meta = np.asarray(meta, np.int32)
    else:
        b, _, s, tt, causal = CARD_FOLD_CASES[case]
        rs = np.random.RandomState(len(case))
        meta = np.stack([rs.randint(1, tt + 1, b), rs.randint(tt + 1, s + 1, b)], 1)
        meta[-1, 0] = 0
        meta = meta.astype(np.int32)
    attend = prefix_lm_attend(s, tt, torch.from_numpy(meta[:, 0]),
                              torch.from_numpy(meta[:, 1]), causal)
    attend = attend.expand(b, s, s).numpy()
    bq, bk = tflash.FOLD_BQ, tflash.FOLD_BK
    for bb in range(b):
        for qt in range(-(-s // bq)):
            tv, kv_end = (int(x) for x in meta[bb])
            bound = tflash.kv_tile_bound(qt, s, tv, kv_end, causal)
            rows = attend[bb, qt * bq:(qt + 1) * bq]
            assert not rows[:, bound * bk:].any()
            if tv == 0:
                assert bound == -(-s // bk)
