"""Activation checkpointing (``ConfigValle.remat``) in valle2_tpu_torch: each
layer of the stack under ``torch.utils.checkpoint`` (non-reentrant), its
dropout masks replayed in the backward's recompute from the generator state
the layer started from.  The port's grads with remat equal its grads
without, bit for bit (AR, NAR with conditioning corruption, ASR, a LoRA
step; dropout 0.1, through the flash route's autograd function and the bias
route), the generator ends where it would without remat, the grads equal
JAX's ``remat=True`` grads at dropout 0, outputs under ``no_grad`` are
unchanged, and the train CLI runs with ``remat: true``.
"""

import dataclasses
import json
import warnings

import jax
import numpy as np
import pytest
import torch
from test_torch_train import (TRAIN, ar_batch, assert_grads_close, leaves, nar_batch,
                              port_grads, to_j, to_t, trainable)
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu.config import ConfigValle as JConfig
from valle2_tpu.models import ar as jar
from valle2_tpu.models import nar as jnar
from valle2_tpu.models.convert import export_ar_state_dict, export_nar_state_dict
from valle2_tpu_torch import train as ttrain
from valle2_tpu_torch.config import ConfigValle
from valle2_tpu_torch.models import ar as tar
from valle2_tpu_torch.models import nar as tnar
from valle2_tpu_torch.models.convert import load_ar_state_dict, load_nar_state_dict

DROP = dict(TRAIN, dropout=0.1)

# (model, config overrides, batch maker)
CASES = {
    'ar_flash': ('ValleAR', dict(use_flash_attention=True), lambda: ar_batch(1)),
    'ar_bias': ('ValleAR', dict(use_flash_attention=False), lambda: ar_batch(2)),
    'asr_flash': ('ValleASR', dict(use_flash_attention=True, direction='asr'),
                  lambda: ar_batch(3, 'asr')),
    'nar_corrupt_flash': ('ValleNAR', dict(use_flash_attention=True, nar_corrupt_p=0.3),
                          lambda: nar_batch(4)),
    'nar_corrupt_bias': ('ValleNAR', dict(use_flash_attention=False, nar_corrupt_p=0.3),
                         lambda: nar_batch(5)),
}


def loss_and_grads(model, cfg, batch, seed=7):
    """(loss, grads by leaf path, the generator's next three draws) of one
    seeded loss through a fresh state."""
    state = ttrain.init_state(cfg, model, seed=0, device='cpu')
    gen = ttrain.step_generator(seed, 0, 'cpu')
    loss, metrics = ttrain.LOSS_FNS[model](state.params, cfg, batch, gen)
    after_forward = torch.rand(3, generator=gen)
    grads = port_grads(state.params, loss)
    return loss.detach(), metrics, grads, after_forward, torch.rand(3, generator=gen)


@pytest.mark.parametrize('case', sorted(CASES))
def test_remat_grads_equal_plain_grads_bit_for_bit(case):
    """Dropout 0.1 (and the NAR's corruption draw): loss, metrics, every
    grad and the generator's next draws, after the forward and after the
    backward's recompute, are bit-equal with remat on and off."""
    model, over, make = CASES[case]
    cfg = ConfigValle(**dict(DROP, **over))
    batch = to_t(make())
    plain = loss_and_grads(model, cfg, batch)
    remat = loss_and_grads(model, dataclasses.replace(cfg, remat=True), batch)
    assert torch.equal(plain[0], remat[0])
    for k in plain[1]:
        assert torch.equal(torch.as_tensor(plain[1][k]), torch.as_tensor(remat[1][k])), k
    assert sorted(plain[2]) == sorted(remat[2])
    for k, g in plain[2].items():
        assert torch.equal(g, remat[2][k]), k
    assert torch.equal(plain[3], remat[3]) and torch.equal(plain[4], remat[4])
    assert any(float(g.abs().max()) > 0 for g in plain[2].values())


def test_remat_lora_train_step_bit_for_bit():
    """A LoRA fine-tune step (the adapters merged inside the forward) with
    remat equals the step without: metrics, the adapters after the update,
    the base untouched."""
    out = {}
    for remat in (False, True):
        cfg = ConfigValle(**dict(DROP, lora_rank=4, lr=3e-3, remat=remat))
        state = ttrain.init_state(cfg, 'ValleAR', seed=0, device='cpu')
        base = {k: v.clone() for k, v in leaves(state.params['base'])}
        step = ttrain.make_train_step(cfg, 'ValleAR')
        for i in range(2):
            state, m = step(state, to_t(ar_batch(20 + i)), 3)
        for k, v in leaves(state.params['base']):
            assert torch.equal(v, base[k])
        out[remat] = ({k: float(v) for k, v in m.items()},
                      {k: v.detach().clone() for k, v in leaves(state.params['lora'])})
    assert out[False][0] == out[True][0]
    assert sorted(out[False][1]) == sorted(out[True][1])
    for k, v in out[False][1].items():
        assert torch.equal(v, out[True][1][k]), k


@pytest.mark.parametrize('flash', [True, False], ids=['flash', 'bias'])
def test_remat_ar_grads_match_jax_remat(flash):
    """AR loss and grads with remat, dropout 0 == JAX ``remat=True``'s
    (jax.checkpoint of the scanned layer) on the same weights, to the train
    tests' tolerance."""
    kw = dict(TRAIN, use_flash_attention=flash, remat=True)
    jcfg, cfg = JConfig(**kw), ConfigValle(**kw)
    jp = jar.init_params(jax.random.key(0), jcfg)
    batch = ar_batch(6)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jar.loss_fn(p, jcfg, b, None), has_aux=True))(jp, to_j(batch))
    tp = trainable(load_ar_state_dict(export_ar_state_dict(jp)))
    loss, _ = tar.loss_fn(tp, cfg, to_t(batch))
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=1e-5)
    assert_grads_close(port_grads(tp, loss), jg)


def test_remat_nar_grads_match_jax_remat():
    """NAR loss_at_stage with remat, dropout 0 == JAX ``remat=True`` at the
    stage JAX drew (bidirectional flash route)."""
    kw = dict(TRAIN, use_flash_attention=True, remat=True)
    jcfg, cfg = JConfig(**kw), ConfigValle(**kw)
    jp = jnar.init_params(jax.random.key(2), jcfg)
    batch = nar_batch(7)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b, k: jnar.loss_fn(p, jcfg, b, k), has_aux=True))(
            jp, to_j(batch), jax.random.key(7))
    tp = trainable(load_nar_state_dict(export_nar_state_dict(jp)))
    loss, _ = tnar.loss_at_stage(tp, cfg, to_t(batch), int(jm['stage']))
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=1e-5)
    assert_grads_close(port_grads(tp, loss), jg)


@pytest.mark.parametrize('model', ['ValleAR', 'ValleNAR'])
def test_remat_no_grad_outputs_unchanged_and_quiet(model):
    """Under ``torch.no_grad`` remat changes nothing: the same loss as
    without, and no warning (no checkpoint is set up)."""
    cfg = ConfigValle(**DROP)
    batch = to_t(ar_batch(8) if model == 'ValleAR' else nar_batch(8))
    state = ttrain.init_state(cfg, model, seed=0, device='cpu')
    loss_fn = ttrain.LOSS_FNS[model]
    with torch.no_grad():
        want, _ = loss_fn(state.params, cfg, batch, ttrain.step_generator(1, 0, 'cpu'))
        with warnings.catch_warnings():
            warnings.simplefilter('error')
            got, _ = loss_fn(state.params, dataclasses.replace(cfg, remat=True), batch,
                             ttrain.step_generator(1, 0, 'cpu'))
    assert torch.equal(got, want)


def test_train_cli_runs_with_remat(tmp_path):
    """``python -m valle2_tpu_torch.train`` (its main) with a config that
    sets ``remat: true``: two synthetic AR steps on the CPU and a
    checkpoint."""
    cfg = dict(TRAIN, dropout=0.1, remat=True, max_steps=2, log_every_n_steps=1,
               ckpt_every_n_steps=0, ckpt_path=str(tmp_path / 'ckpt'),
               log_path=str(tmp_path / 'logs'), bucket_sizes=[128, 256, 384, 512])
    (tmp_path / 'cfg.json').write_text(json.dumps(cfg))
    ttrain.main(['-c', str(tmp_path / 'cfg.json'), '-m', 'ValleAR', '--synthetic',
                 '--device', 'cpu'])
    assert (tmp_path / 'ckpt' / 'ValleAR' / 'step_2' / 'state.pt').exists()


def test_remat_runs_each_layer_again_in_the_backward(monkeypatch):
    """Under remat the forward runs each layer once and the backward once
    more (the recompute); without remat the backward runs none."""
    import importlib
    tt = importlib.import_module('valle2_tpu_torch.ops.transformer')
    calls = []
    inner = tt.encoder_layer

    def counted(*args, **kw):
        calls.append(None)
        return inner(*args, **kw)
    monkeypatch.setattr(tt, 'encoder_layer', counted)
    batch = to_t(ar_batch(9))
    for remat, after_backward in ((False, 2), (True, 4)):
        cfg = ConfigValle(**dict(DROP, remat=remat))
        state = ttrain.init_state(cfg, 'ValleAR', seed=0, device='cpu')
        calls.clear()
        loss, _ = tar.loss_fn(state.params, cfg, batch, ttrain.step_generator(1, 0, 'cpu'))
        assert len(calls) == cfg.num_layers
        port_grads(state.params, loss)
        assert len(calls) == after_backward
