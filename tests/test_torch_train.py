"""The training slice of valle2_tpu_torch against valle2_tpu on the same
weights (carried by the state-dict converters) and the same numpy inputs:
AR, ASR and NAR losses and per-leaf grads, train steps through clip, AdamW,
the cosine-restarts schedule and grad accumulation, the collate and the
synthetic data stream, dropout, checkpoints, and Trainer.fit's resume.
Small config, float32 with matmul_precision='highest', dropout 0 for parity.
"""

import dataclasses
import json
import logging
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import SMALL, close
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu.config import ConfigValle as JConfig
from valle2_tpu.data import DataLoader as JDataLoader
from valle2_tpu.data import SyntheticValleDataset as JSynthetic
from valle2_tpu.data import get_collate as j_get_collate
from valle2_tpu.models import ar as jar
from valle2_tpu.models import nar as jnar
from valle2_tpu.models.convert import export_ar_state_dict, export_nar_state_dict
from valle2_tpu.train import init_state as j_init_state
from valle2_tpu.train import make_train_step as j_make_train_step
from valle2_tpu_torch import train as ttrain
from valle2_tpu_torch.config import ConfigValle
from valle2_tpu_torch.data import DataLoader, SyntheticValleDataset, get_collate
from valle2_tpu_torch.data.dataset import get_dataloaders
from valle2_tpu_torch.models import ar as tar
from valle2_tpu_torch.models import nar as tnar
from valle2_tpu_torch.models.checkpoint import load_params, save_params
from valle2_tpu_torch.models.convert import load_ar_state_dict, load_nar_state_dict
from valle2_tpu_torch.ops import dropout
from valle2_tpu_torch.ops.transformer import map_tree

TRAIN = dict(SMALL, batch_size=2, bucket_sizes=(16, 32, 64, 128))
ROOT = Path(__file__).resolve().parents[1]


def leaves(tree, prefix=''):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f'{prefix}/{k}')
    else:
        yield prefix, tree


def trainable(tp):
    return map_tree(lambda a: a.clone().requires_grad_(), tp)


def port_grads(tp, loss):
    paths, tensors = zip(*leaves(tp))
    grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    return {p: (torch.zeros_like(t) if g is None else g)
            for p, t, g in zip(paths, tensors, grads)}


def assert_grads_close(got: dict, jgrads):
    want = dict(leaves(jgrads))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        # per leaf: f32 sums in another order, relative to the leaf's scale
        close(got[k], w, atol=1e-5 * max(1.0, float(np.abs(w).max())), rtol=1e-4)


def ar_batch(seed, direction='tts'):
    """Two rows of different lengths: tokens (2, 6), BOS-prefixed targets (2, 10)."""
    rs = np.random.RandomState(seed)
    src, tgt = (256, 1026) if direction == 'tts' else (1024, 258)
    return {'tokens': rs.randint(0, src, (2, 6)).astype(np.int32),
            'tokens_lens': np.asarray([6, 4], np.int32),
            'codes': rs.randint(0, tgt, (2, 10)).astype(np.int32),
            'codes_lens': np.asarray([10, 7], np.int32),
            'target': rs.randint(0, tgt - 1, (2, 10)).astype(np.int32)}


def nar_batch(seed):
    rs = np.random.RandomState(seed)
    return {'tokens': rs.randint(0, 256, (2, 5)).astype(np.int32),
            'tokens_lens': np.asarray([5, 3], np.int32),
            'codes': rs.randint(0, 1024, (2, 12, 8)).astype(np.int32),
            'codes_lens': np.asarray([12, 8], np.int32)}


def to_t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


AR_CASES = {
    'flash_masked': dict(use_flash_attention=True, mask_loss_pads=True),
    'flash_unmasked': dict(use_flash_attention=True, mask_loss_pads=False),
    'bias_masked': dict(use_flash_attention=False, mask_loss_pads=True),
    'bias_unmasked': dict(use_flash_attention=False, mask_loss_pads=False),
    'asr_flash': dict(use_flash_attention=True, direction='asr'),
    'asr_bias': dict(use_flash_attention=False, direction='asr'),
}


@pytest.mark.parametrize('case', sorted(AR_CASES))
def test_ar_loss_and_grads_match_jax(case):
    """AR (and ASR) loss_fn: loss, acc, n_valid and every leaf's grad ==
    jax.value_and_grad of JAX ar.loss_fn (flash in Pallas interpret mode)."""
    kw = dict(TRAIN, **AR_CASES[case])
    jcfg, cfg = JConfig(**kw), ConfigValle(**kw)
    jp = jar.init_params(jax.random.key(0), jcfg)
    batch = ar_batch(1, cfg.direction)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jar.loss_fn(p, jcfg, b, None), has_aux=True))(jp, to_j(batch))
    tp = trainable(load_ar_state_dict(export_ar_state_dict(jp)))
    loss, m = tar.loss_fn(tp, cfg, to_t(batch))
    close(loss, jl, atol=1e-5)
    close(m['acc'], jm['acc'], atol=1e-6)
    assert int(m['n_valid']) == int(jm['n_valid'])
    assert_grads_close(port_grads(tp, loss), jg)


@pytest.mark.parametrize('seed', [1, 4])
@pytest.mark.parametrize('flash', [True, False], ids=['flash', 'bias'])
def test_nar_loss_and_grads_match_jax_at_its_stage(flash, seed):
    """NAR loss_at_stage at the stage JAX drew == JAX nar.loss_fn: loss,
    acc, n_valid and every leaf's grad (bidirectional flash or the bias)."""
    kw = dict(TRAIN, use_flash_attention=flash)
    jcfg, cfg = JConfig(**kw), ConfigValle(**kw)
    jp = jnar.init_params(jax.random.key(2), jcfg)
    batch = nar_batch(seed)
    key = jax.random.key(seed)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b, k: jnar.loss_fn(p, jcfg, b, k), has_aux=True))(jp, to_j(batch), key)
    stage = int(jm['stage'])
    tp = trainable(load_nar_state_dict(export_nar_state_dict(jp)))
    loss, m = tnar.loss_at_stage(tp, cfg, to_t(batch), stage)
    assert int(m['stage']) == stage
    close(loss, jl, atol=1e-5)
    close(m['acc'], jm['acc'], atol=1e-6)
    assert int(m['n_valid']) == int(jm['n_valid'])
    assert_grads_close(port_grads(tp, loss), jg)


def test_nar_stage_draw_is_uniform_over_refinement_stages():
    cfg = ConfigValle(**TRAIN)
    gen = torch.Generator().manual_seed(0)
    stages = [int(tnar.draw_stage(cfg, gen)) for _ in range(700)]
    assert set(stages) == set(range(1, 8))


@pytest.mark.parametrize('accum', [1, 2])
def test_ar_train_steps_match_jax(accum):
    """Train steps (global-norm clip active, AdamW, cosine restarts with a
    3-step period, grad_accum): params after three optimizer steps == JAX
    make_train_step's, atol 1e-5."""
    kw = dict(TRAIN, lr=3e-3, lr_warmup=3, gradient_clip_val=0.3, grad_accum=accum)
    jcfg, cfg = JConfig(**kw), ConfigValle(**kw)
    jstate = j_init_state(jcfg, 'ValleAR', jax.random.key(0))
    tstate = ttrain.init_state(cfg, 'ValleAR', device='cpu',
                               base_params=load_ar_state_dict(
                                   export_ar_state_dict(jstate.params)))
    jstep, tstep = j_make_train_step(jcfg, 'ValleAR'), ttrain.make_train_step(cfg, 'ValleAR')
    rng = jax.random.key(1)
    for i in range(3 * accum):
        batch = ar_batch(10 + i)
        jstate, jm = jstep(jstate, to_j(batch), rng)
        tstate, tm = tstep(tstate, to_t(batch), 0)
        close(tm['loss'], jm['loss'], atol=1e-5)
        close(tm['grad_norm'], jm['grad_norm'], atol=1e-5, rtol=1e-5)
        if i == 0:
            assert float(tm['grad_norm']) > cfg.gradient_clip_val   # the clip acts
    assert tstate.step == int(jstate.step) == 3 * accum
    assert tstate.opt_state.count == 3
    want = dict(leaves(jstate.params))
    for k, v in leaves(tstate.params):
        close(v, want[k], atol=1e-5)


@pytest.mark.parametrize('schedule', ['cosine_restarts', 'warmup_cosine', 'constant'])
def test_lr_schedule_matches_jax(schedule):
    from valle2_tpu.train import lr_schedule as j_lr_schedule
    kw = dict(TRAIN, lr=2e-3, lr_warmup=4, max_steps=10, schedule=schedule)
    jsched, tsched = j_lr_schedule(JConfig(**kw)), ttrain.lr_schedule(ConfigValle(**kw))
    for step in range(14):
        np.testing.assert_allclose(tsched(step), float(jsched(step)), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize('model', ['ValleAR', 'ValleNAR', 'ValleASR'])
def test_collate_and_synthetic_stream_identical_to_jax(model):
    """Two shuffled epochs of the synthetic loader, batch for batch, key for
    key, equal to the JAX package's; set_epoch replays an epoch."""
    kw = dict(TRAIN, direction='asr' if model == 'ValleASR' else 'tts')
    jcfg, cfg = JConfig(**kw), ConfigValle(**kw)
    jl = JDataLoader(JSynthetic(jcfg, size=7, min_frames=20, max_frames=90), 3,
                     j_get_collate(model)(jcfg), shuffle=True, seed=5)
    tl = DataLoader(SyntheticValleDataset(cfg, size=7, min_frames=20, max_frames=90), 3,
                    get_collate(model)(cfg), shuffle=True, seed=5)
    epochs = []
    for _ in range(2):
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        epochs.append(got)
    tl.set_epoch(1)
    for g, w in zip(list(tl), epochs[1]):
        np.testing.assert_array_equal(g['codes'], w['codes'])


def test_dropout_rate_and_mean():
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(0)
    y = dropout(x, 0.1, gen)
    assert abs(float((y == 0).float().mean()) - 0.1) < 0.005
    assert abs(float(y.mean()) - 1.0) < 0.01
    values = torch.unique(y)
    assert len(values) == 2 and float(values[0]) == 0.0
    assert float(values[1]) == pytest.approx(1 / 0.9)
    assert dropout(x, 0.1, None) is x and dropout(x, 0.0, gen) is x
    again = dropout(x, 0.1, torch.Generator().manual_seed(0))
    assert torch.equal(y, again)


def test_corrupt_conditioning_touches_only_suffix_codebook0():
    rs = np.random.RandomState(0)
    codes = torch.from_numpy(rs.randint(0, 1024, (4, 60, 8)))
    orig = codes.clone()
    out = tnar.corrupt_conditioning(codes, 20, 0.5, torch.Generator().manual_seed(1), 1024)
    assert torch.equal(out[:, :20], codes[:, :20])
    assert torch.equal(out[..., 1:], codes[..., 1:])
    changed = (out[:, 20:, 0] != codes[:, 20:, 0]).float().mean()
    assert 0.35 < float(changed) < 0.65
    assert torch.equal(codes, orig)                      # the input is not modified


def test_training_features_not_ported_raise_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        ConfigValle(mesh_ctx=2)
    # ported: the data axis (tests/test_torch_mesh_train.py) and the pipe axis
    # (tests/test_torch_pipeline.py)
    ConfigValle(mesh_data=2, mesh_model=2, zero1=True, sequence_parallel=True)
    ConfigValle(mesh_pipe=2, pp_microbatches=2, pp_schedule='1f1b')
    # JAX compilation choices: accepted, with no counterpart in the port
    ConfigValle(train_rng_impl='threefry2x32', train_scan_unroll=4)
    ConfigValle(lora_rank=4)      # ported: LoRA fine-tuning (tests/test_torch_lora.py)
    ConfigValle(remat=True)       # ported: activation checkpointing (test_torch_remat.py)
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        get_dataloaders('ValleAR', ConfigValle(**TRAIN))
    # ported: the grammar dataset (data/grammar.py, tests/test_torch_grammar.py)
    train, valid = get_dataloaders('ValleAR', ConfigValle(**dict(
        TRAIN, dataset='grammar://variants=3', vocab_size=128, num_audio_tokens=256)))
    batch = next(iter(train))
    assert batch['codes'].shape[0] == TRAIN['batch_size'] and len(valid) > 0


def tiny(tmp_path, **kw):
    base = dict(TRAIN, dropout=0.1, max_steps=4, log_every_n_steps=2, ckpt_every_n_steps=2,
                ckpt_path=tmp_path / 'ckpt', log_path=tmp_path / 'logs')
    base.update(kw)
    return ConfigValle(**base)


def tiny_loader(cfg, model='ValleAR'):
    ds = SyntheticValleDataset(cfg, size=6, min_frames=20, max_frames=50)
    return DataLoader(ds, cfg.batch_size, get_collate(model)(cfg), shuffle=True, seed=3)


@pytest.mark.parametrize('model', ['ValleAR', 'ValleNAR'])
def test_fit_resume_replays_params_bit_identically(tmp_path, model):
    """fit to 4 steps straight == fit to 2, then a resumed fit to 4 from a
    different init: same batches (across an epoch boundary), same dropout
    masks and NAR stages, same params bit for bit."""
    cfg = tiny(tmp_path / 'a')
    state = ttrain.Trainer(cfg, model, device='cpu', use_tensorboard=False).fit(
        ttrain.init_state(cfg, model, device='cpu'), tiny_loader(cfg, model))
    assert state.step == 4
    cfg2 = tiny(tmp_path / 'b', max_steps=2)
    ttrain.Trainer(cfg2, model, device='cpu', use_tensorboard=False).fit(
        ttrain.init_state(cfg2, model, device='cpu'), tiny_loader(cfg2, model))
    cfg3 = dataclasses.replace(cfg2, max_steps=4)
    trainer = ttrain.Trainer(cfg3, model, device='cpu', use_tensorboard=False)
    resumed = trainer.fit(ttrain.init_state(cfg3, model, seed=7, device='cpu'),
                          tiny_loader(cfg3, model), resume=True)
    assert resumed.step == 4
    assert [p.name for _, p in trainer._step_dirs()] == ['step_2', 'step_4']
    for (k, a), (_, b) in zip(leaves(state.params), leaves(resumed.params)):
        assert torch.equal(a, b), k


def test_checkpoint_roundtrip_and_retention(tmp_path):
    cfg = tiny(tmp_path, keep_checkpoints=2, async_checkpoint=False)
    trainer = ttrain.Trainer(cfg, 'ValleAR', device='cpu', use_tensorboard=False)
    state = ttrain.init_state(cfg, 'ValleAR', device='cpu')
    for step in (3, 5, 7):
        trainer.save_checkpoint(ttrain.TrainState(state.params, state.opt_state, step))
    assert [p.name for _, p in trainer._step_dirs()] == ['step_5', 'step_7']
    (trainer._step_dirs()[-1][1].parent / 'step_9.tmp-1').mkdir()   # a write cut short
    latest = trainer.latest_checkpoint()
    assert latest.name == 'step_7'
    fresh = ttrain.init_state(cfg, 'ValleAR', seed=9, device='cpu')
    restored = trainer.restore_checkpoint(fresh, latest)
    assert restored.step == 7
    for (k, a), (_, b) in zip(leaves(state.params), leaves(restored.params)):
        assert torch.equal(a, b), k
    # the model wrappers load a trainer step dir and a bare params file alike
    model = tar.ValleAR(cfg, seed=9, device='cpu')
    model.load(latest)
    save_params(tmp_path / 'params.pt', model.params)
    again = load_params(tmp_path / 'params.pt', tar.ValleAR(cfg, seed=3, device='cpu').params)
    for (k, a), (_, b) in zip(leaves(state.params), leaves(again)):
        assert torch.equal(a.detach(), b), k


def test_validate_weights_batches_by_token_count(tmp_path):
    cfg = tiny(tmp_path, valid_batch_size=2)
    trainer = ttrain.Trainer(cfg, 'ValleAR', device='cpu', use_tensorboard=False)
    state = ttrain.init_state(cfg, 'ValleAR', device='cpu')
    ds = SyntheticValleDataset(cfg, size=5, seed=1, min_frames=20, max_frames=50)
    loader = DataLoader(ds, 2, get_collate('ValleAR')(cfg), drop_last=False)
    metrics = [trainer.eval_step(state.params, to_t(b), None) for b in loader]
    assert len(metrics) == 3                                 # a partial batch last
    n = np.asarray([float(m['n_valid']) for m in metrics])
    want = float((np.asarray([float(m['loss']) for m in metrics]) * n).sum() / n.sum())
    np.testing.assert_allclose(trainer.validate(state, loader, 0), want, rtol=1e-6)


def test_train_cli_on_the_cpu(tmp_path):
    """The CLI's ``main`` in process (its module runs it under ``-m``); the
    package logger reports the steps."""
    cfg_file = tmp_path / 'cfg.json'
    cfg_file.write_text(json.dumps(dict(TRAIN, max_steps=2, log_every_n_steps=1,
                                        ckpt_path=str(tmp_path / 'ckpt'),
                                        log_path=str(tmp_path / 'logs'))))
    messages = []
    handler = logging.Handler()
    handler.emit = lambda record: messages.append(record.getMessage())
    logger = logging.getLogger('valle2_tpu_torch')
    logger.addHandler(handler)
    try:
        ttrain.main(['-c', str(cfg_file), '-m', 'ValleNAR', '--synthetic', '--device', 'cpu'])
    finally:
        logger.removeHandler(handler)
    assert any(m.startswith('step 2 | loss') for m in messages)
    assert (tmp_path / 'ckpt' / 'ValleNAR' / 'step_2' / 'state.pt').exists()


def test_training_modules_import_no_jax():
    code = ('import sys, valle2_tpu_torch.train, valle2_tpu_torch.data.prefetch, '
            'valle2_tpu_torch.models.checkpoint\n'
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", '
            '"valle2_tpu"))\n'
            'assert not bad, bad')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
