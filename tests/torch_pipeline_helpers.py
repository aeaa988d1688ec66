"""Shared pieces of the pipeline tests (``tests/test_torch_pipeline*.py``): the
small config, seeded batches, the JAX pipeline steps on the 8 virtual CPU devices
of ``tests/conftest.py`` and the port's steps on virtual CPU ranks."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_port_helpers import close

from valle2_tpu.config import ConfigValle as JConfig
from valle2_tpu.models.convert import export_ar_state_dict, export_nar_state_dict
from valle2_tpu.parallel import pipeline as jpipe
from valle2_tpu.parallel import pipeline_1f1b as jpipe_1f1b
from valle2_tpu.train import TrainState as JTrainState
from valle2_tpu.train import init_state as j_init_state
from valle2_tpu_torch import train as ttrain
from valle2_tpu_torch.models import nar as tnar
from valle2_tpu_torch.models.convert import load_ar_state_dict, load_nar_state_dict
from valle2_tpu_torch.parallel import make_pp_mesh
from valle2_tpu_torch.parallel.pipeline import PipelineRun
from valle2_tpu_torch.parallel.pipeline_1f1b import one_f_one_b

# d=32, 4 heads (2 a model rank), dff 64, 4 layers (1 or 2 a stage); f32 with
# TF32 off; lr 1e-3 with the clip acting
TRAIN = dict(d_model=32, n_heads=4, dim_feedforward=64, num_layers=4, dropout=0.0,
             vocab_size=40, num_audio_tokens=50, matmul_precision='highest',
             norm='LayerNorm', batch_size=8, lr=1e-3, gradient_clip_val=0.3,
             bucket_sizes=(16, 32, 64, 128))
NAR = dict(TRAIN, norm='AdaptiveLayerNorm')
TOL_PARAMS = 2e-5
TOL_LOSS = 2e-5
SCHEDULES = {'gpipe': PipelineRun.gpipe, '1f1b': one_f_one_b}


def pp_mesh(data, pipe, model=1):
    return make_pp_mesh(data, pipe, model, ['cpu'] * (data * pipe * model))


def leaves(tree, prefix=''):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f'{prefix}/{k}')
    else:
        yield prefix, tree


def assert_trees_close(got, want, atol=TOL_PARAMS):
    want, got = dict(leaves(want)), dict(leaves(got))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        close(got[k], np.asarray(w.detach() if torch.is_tensor(w) else w), atol=atol)


def ar_batch(seed=3, b=8):
    rs = np.random.RandomState(seed)
    return {'tokens': rs.randint(0, 40, (b, 10)).astype(np.int32),
            'tokens_lens': np.asarray([10, 8, 9, 10, 7, 10, 6, 10][:b], np.int32),
            'codes': rs.randint(0, 50, (b, 16)).astype(np.int32),
            'codes_lens': np.asarray([16, 12, 14, 16, 10, 16, 9, 13][:b], np.int32),
            'target': rs.randint(0, 50, (b, 16)).astype(np.int32)}


def nar_batch(seed=5, b=8):
    rs = np.random.RandomState(seed)
    return {'tokens': rs.randint(0, 40, (b, 10)).astype(np.int32),
            'tokens_lens': np.asarray([10, 7, 9, 10, 8, 10, 6, 9][:b], np.int32),
            'codes': rs.randint(0, 50, (b, 16, 8)).astype(np.int32),
            'codes_lens': np.asarray([16, 11, 14, 16, 12, 15, 9, 13][:b], np.int32)}


def to_t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_port(model, jparams):
    export, load = {'ValleAR': (export_ar_state_dict, load_ar_state_dict),
                    'ValleNAR': (export_nar_state_dict, load_nar_state_dict)}[model]
    return load(export(jparams))


def j_pp_step(kw, model, data, pipe, model_axis, batch, schedule='gpipe', rng=9):
    """One JAX pipeline step (``make_pp_train_step`` or ``_1f1b``) on
    ``make_pp_mesh(data, pipe, model_axis)`` from seed-0 params: (the params
    before and after in the port's layout, the metrics)."""
    jcfg = JConfig(**kw)
    js = j_init_state(jcfg, model, jax.random.key(0))
    before = to_port(model, js.params)
    jm = jpipe.make_pp_mesh(data, pipe, model_axis)
    js = JTrainState(jpipe.pp_shard_params(jm, js.params),
                     jpipe.pp_shard_params(jm, js.opt_state), js.step)
    make = (jpipe_1f1b.make_pp_train_step_1f1b if schedule == '1f1b'
            else jpipe.make_pp_train_step)
    js, metrics = make(jcfg, model, jm)(js, {k: jnp.asarray(v) for k, v in batch.items()},
                                        jax.random.key(rng))
    return before, to_port(model, jax.device_get(js.params)), \
        {k: np.asarray(v) for k, v in metrics.items()}


def port_state(cfg, model, params, on=None):
    state = ttrain.init_state(cfg, model, device='cpu', base_params=params)
    return state if on is None else ttrain.shard_state(on, state, cfg)


def port_step(cfg, model, params, batch, on=None, steps=1, seed=0):
    state = port_state(cfg, model, params, on)
    step = ttrain.make_train_step(cfg, model, on)
    for _ in range(steps):
        state, metrics = step(state, to_t(batch), seed)
    return state, metrics


def nar_at_stage(cfg, params, batch, stage, on=None, schedule='gpipe'):
    """One NAR step at a given stage: solo (``on`` None: ``loss_at_stage``
    and autograd) or through the pipeline on ``on`` with ``schedule``.
    Returns (the params after, the metrics)."""
    state = port_state(cfg, 'ValleNAR', params, on)
    opt, b = state.opt_state, to_t(batch)
    if on is None:
        loss, metrics = tnar.loss_at_stage(state.params, cfg, b, stage)
        opt.update(list(torch.autograd.grad(loss, opt.leaves)))
        return ttrain.gather_state(state), metrics
    run = PipelineRun(cfg, on, state.params, tnar.pp_microbatch_parts(cfg, b, stage=stage), b,
                      None, cfg.pp_microbatches, leaves=opt.ranks)
    SCHEDULES[schedule](run)
    opt.update(run.grads())
    return ttrain.gather_state(state), run.metrics()
