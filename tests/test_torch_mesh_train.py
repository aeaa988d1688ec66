"""Training over a ('data', 'model') mesh in the port (``valle2_tpu_torch.train`` with
``mesh``, ``parallel.mesh``'s rules, ZeRO-1, sequence parallelism) on virtual CPU ranks,
held to the JAX package's steps on ``make_mesh`` over the 8 virtual CPU devices of
``tests/conftest.py`` and to the port's solo step.

d=32, 2 layers, float32 with matmul_precision='highest'.  Tolerances: params after a
step within 2e-5 of JAX's and of the port's solo step, and losses within 2e-5 (JAX
``test_train.py``'s bounds for its mesh steps against its solo step): float32 sums
over the ranks run in another order (the per-row losses, the 5c partials, the
data-axis grad sum), and AdamW's first step, lr * g / (|g| + eps), turns a grad
near zero's last bits into up to 0.5% of lr.  Where the same mesh
runs both ways (ZeRO-1 against replicated, sequence parallel against not, a checkpoint
restored) the params are equal bit for bit or within 1e-6, as stated per case.
JAX's weights reach the port through ``models.convert``; the steps JAX takes on its
meshes are computed once in module fixtures.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import SMALL, close
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu import parallel as jpar
from valle2_tpu.config import ConfigValle as JConfig
from valle2_tpu.models.convert import export_ar_state_dict, export_nar_state_dict
from valle2_tpu.train import TrainState as JTrainState
from valle2_tpu.train import init_state as j_init_state
from valle2_tpu.train import make_eval_step as j_make_eval_step
from valle2_tpu.train import make_train_step as j_make_train_step
from valle2_tpu_torch import lora as tlora
from valle2_tpu_torch import train as ttrain
from valle2_tpu_torch.config import ConfigValle
from valle2_tpu_torch.models import nar as tnar
from valle2_tpu_torch.models.convert import load_ar_state_dict, load_nar_state_dict
from valle2_tpu_torch.ops.attention import flash_shard_mesh
from valle2_tpu_torch.parallel import (gather_params, make_mesh, param_sharding,
                                       shard_params, training_mesh)

# lr 1e-3 with the clip acting (grad norms ~1.4 against 0.3)
TRAIN = dict(SMALL, batch_size=4, bucket_sizes=(16, 32, 64, 128), lr=1e-3,
             gradient_clip_val=0.3)
TOL_PARAMS = 2e-5
TOL_LOSS = 2e-5


def mesh(data, model=1):
    return make_mesh(data, model, ['cpu'] * (data * model))


def leaves(tree, prefix=''):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f'{prefix}/{k}')
    else:
        yield prefix, tree


def assert_trees_close(got, want, atol=TOL_PARAMS):
    want = dict(leaves(want))
    got = dict(leaves(got))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        close(got[k], np.asarray(w.detach() if torch.is_tensor(w) else w), atol=atol)


def ar_batch(seed=11, b=4):
    rs = np.random.RandomState(seed)
    return {'tokens': rs.randint(0, 256, (b, 6)).astype(np.int32),
            'tokens_lens': np.asarray([6, 4, 5, 6, 3, 6, 6, 2][:b], np.int32),
            'codes': rs.randint(0, 1026, (b, 10)).astype(np.int32),
            'codes_lens': np.asarray([10, 7, 9, 10, 5, 8, 10, 4][:b], np.int32),
            'target': rs.randint(0, 1025, (b, 10)).astype(np.int32)}


def nar_batch(seed=13, b=4):
    rs = np.random.RandomState(seed)
    return {'tokens': rs.randint(0, 256, (b, 5)).astype(np.int32),
            'tokens_lens': np.asarray([5, 3, 5, 4][:b], np.int32),
            'codes': rs.randint(0, 1024, (b, 12, 8)).astype(np.int32),
            'codes_lens': np.asarray([12, 8, 11, 12][:b], np.int32)}


def to_t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


CONVERT = {'ValleAR': (export_ar_state_dict, load_ar_state_dict),
           'ValleNAR': (export_nar_state_dict, load_nar_state_dict)}


def to_port(model, jparams):
    export, load = CONVERT[model]
    return load(export(jparams))


def j_mesh_step(kw, model, data, model_axis, batch, rng=1):
    """JAX make_train_step on make_mesh(data, model) from seed-0 params:
    (the params before, the params after in the port's layout, metrics)."""
    jcfg = JConfig(**kw)
    js = j_init_state(jcfg, model, jax.random.key(0))
    before = to_port(model, js.params)
    jm = jpar.make_mesh(data=data, model=model_axis)
    js = JTrainState(jpar.shard_params(jm, js.params), jax.device_put(js.opt_state), js.step)
    js, metrics = j_make_train_step(jcfg, model, jm)(js, jpar.shard_batch(jm, to_j(batch)),
                                                    jax.random.key(rng))
    return before, to_port(model, js.params), {k: np.asarray(v) for k, v in metrics.items()}


def port_state(cfg, model, params, on=None):
    state = ttrain.init_state(cfg, model, device='cpu', base_params=params)
    return state if on is None else ttrain.shard_state(on, state, cfg)


def port_step(cfg, model, params, batch, on=None, steps=1, seed=0):
    state = port_state(cfg, model, params, on)
    step = ttrain.make_train_step(cfg, model, on)
    for _ in range(steps):
        state, metrics = step(state, to_t(batch), seed)
    return state, metrics


@pytest.fixture(scope='module')
def jax_steps():
    """The JAX mesh steps the port is held to (each compiled once)."""
    ar_kw = dict(TRAIN)
    flash_kw = dict(TRAIN, use_flash_attention=True)
    return {
        'ar_dp4': j_mesh_step(ar_kw, 'ValleAR', 4, 1, ar_batch()),
        'ar_flash_2x2': j_mesh_step(flash_kw, 'ValleAR', 2, 2, ar_batch()),
        'ar_heads_2x4': j_mesh_step(dict(flash_kw, batch_size=2), 'ValleAR', 2, 4,
                                    ar_batch(17, 2)),
        'nar_dp4': j_mesh_step(dict(TRAIN, norm='AdaptiveLayerNorm'), 'ValleNAR', 4, 1,
                               nar_batch()),
    }


# ---- the rules ----

@pytest.mark.parametrize('zero1', [False, True], ids=['params', 'zero1'])
@pytest.mark.parametrize('model', ['ValleAR', 'ValleNAR'])
def test_param_sharding_specs_equal_jax(model, zero1):
    """param_sharding at 4 x 2 == JAX's leaf by leaf (the Megatron rule, the
    1025-wide AR head replicated, the NAR heads by vocabulary; ZeRO-1's extra
    'data' cut), on the same params."""
    jcfg = JConfig(**TRAIN)
    init = {'ValleAR': __import__('valle2_tpu.models.ar', fromlist=['x']).init_params,
            'ValleNAR': __import__('valle2_tpu.models.nar', fromlist=['x']).init_params}[model]
    jp = init(jax.random.key(0), jcfg)
    want = jpar.param_sharding(jpar.make_mesh(data=4, model=2), jp, zero1=zero1)
    got = param_sharding(mesh(4, 2), to_port(model, jp), zero1=zero1)
    wl, gl = dict(leaves(want)), dict(leaves(got))
    assert sorted(wl) == sorted(gl)
    for k, w in wl.items():
        spec = tuple(w.spec) + (None,) * (len(gl[k]) - len(w.spec))
        assert gl[k] == spec, (k, gl[k], spec)
    if model == 'ValleAR':
        assert gl['/proj/w'][-1] is None                    # 1025 columns replicate
    else:
        assert gl['/proj_layers'][-1] == 'model'


def test_shard_and_gather_round_trip_with_the_qkv_regrouped():
    """shard_params cuts each rank's block (qkv regrouped rank-major: a rank's
    columns are its heads' [q | k | v]); gather_params restores the whole
    tree bit for bit, ZeRO-1 moments too."""
    cfg = ConfigValle(**dict(TRAIN, n_heads=4))
    params = port_state(cfg, 'ValleNAR', None).params
    on = mesh(2, 2)
    sharded = shard_params(on, params)
    d = cfg.d_model
    qkv = params['transformer']['attn']['qkv']['w']
    r1 = sharded[1]['transformer']['attn']['qkv']['w']          # rank (0, 1)
    assert r1.shape[-1] == 3 * d // 2
    assert torch.equal(r1[..., :d // 2], qkv[..., d // 2:d])    # its q heads
    assert torch.equal(r1[..., d // 2:d], qkv[..., d + d // 2:2 * d])   # its k heads
    assert_trees_close(gather_params(on, sharded), params, atol=0)
    z = shard_params(on, params, zero1=True)
    assert z[2]['transformer']['attn']['qkv']['w'].shape[0] == cfg.num_layers // 2
    assert_trees_close(gather_params(on, z), params, atol=0)


def test_config_fields_and_training_mesh():
    """The data-axis fields load (``training_mesh`` builds the grid); the
    context axis still raises naming the ROADMAP (the pipe axis is ported:
    tests/test_torch_pipeline.py)."""
    cfg = ConfigValle(**dict(TRAIN, mesh_data=2, mesh_model=2, zero1=True,
                             sequence_parallel=True))
    m = training_mesh(cfg, ['cpu'] * 4)
    assert m.shape == {'data': 2, 'model': 2} and m.size == 4
    with pytest.raises(NotImplementedError, match='ROADMAP.md queue 1 item 14'):
        ConfigValle(mesh_ctx=2)
    with pytest.raises(ValueError, match='mesh_data'):
        ConfigValle(mesh_data=0)


# ---- steps against JAX and the solo step ----

def test_ar_step_at_data4_equals_jax_and_solo(jax_steps):
    """One AR step at data=4 == JAX make_train_step on make_mesh(data=4) and
    == the port's solo step (params within 2e-5, loss within 2e-5)."""
    before, after, jm = jax_steps['ar_dp4']
    cfg = ConfigValle(**TRAIN)
    state, m = port_step(cfg, 'ValleAR', before, ar_batch(), mesh(4))
    close(m['loss'], jm['loss'], atol=TOL_LOSS)
    close(m['grad_norm'], jm['grad_norm'], atol=1e-5, rtol=1e-5)
    assert int(m['n_valid']) == int(jm['n_valid'])
    assert_trees_close(ttrain.gather_state(state), after)
    solo, _ = port_step(cfg, 'ValleAR', before, ar_batch())
    assert_trees_close(ttrain.gather_state(state), solo.params)


def test_nar_step_at_data4_equals_jax_and_solo(jax_steps):
    """One NAR step at data=4 at the stage JAX drew (the prefix from the
    whole batch's longest row) == JAX's mesh step, and the port's full mesh
    step == its solo step (params within 2e-5)."""
    before, after, jm = jax_steps['nar_dp4']
    cfg = ConfigValle(**dict(TRAIN, norm='AdaptiveLayerNorm'))
    on = mesh(4)
    state = port_state(cfg, 'ValleNAR', before, on)
    loss, m = tnar.loss_at_stage(state.params, cfg, to_t(nar_batch()), int(jm['stage']),
                                 mesh=on)
    close(m['loss'], jm['loss'], atol=TOL_LOSS)
    assert int(m['n_valid']) == int(jm['n_valid'])
    grads = torch.autograd.grad(loss, state.opt_state.leaves)
    state.opt_state.update(list(grads))
    assert_trees_close(ttrain.gather_state(state), after)
    mesh_state, mm = port_step(cfg, 'ValleNAR', before, nar_batch(), on, seed=5)
    solo, sm = port_step(cfg, 'ValleNAR', before, nar_batch(), seed=5)
    assert int(mm['stage']) == int(sm['stage'])
    close(mm['loss'], sm['loss'], atol=TOL_LOSS)
    assert_trees_close(ttrain.gather_state(mesh_state), solo.params)


def test_flash_step_on_2x2_equals_jax(jax_steps):
    """A 2 x 2 step on the flash route (rows over 'data', heads over 'model':
    each shard's kernel on its rows and local heads, 5c under autograd) ==
    JAX's shard_mapped flash step (loss within 2e-5, params within 2e-5)."""
    before, after, jm = jax_steps['ar_flash_2x2']
    cfg = ConfigValle(**dict(TRAIN, use_flash_attention=True))
    on = mesh(2, 2)
    assert flash_shard_mesh(on, 4, cfg.n_heads)
    state, m = port_step(cfg, 'ValleAR', before, ar_batch(), on)
    assert state.params.tp
    close(m['loss'], jm['loss'], atol=TOL_LOSS)
    assert_trees_close(ttrain.gather_state(state), after)


def test_heads_that_do_not_divide_take_the_plain_route(jax_steps):
    """model=4 over 2 heads: decided from the shapes, the flash route
    declines and the stack replicates over 'model' (every model rank holds
    the whole qkv); the step == JAX's GSPMD fallback step."""
    before, after, jm = jax_steps['ar_heads_2x4']
    cfg = ConfigValle(**dict(TRAIN, use_flash_attention=True, batch_size=2))
    on = mesh(2, 4)
    assert not flash_shard_mesh(on, 2, cfg.n_heads)
    state, m = port_step(cfg, 'ValleAR', before, ar_batch(17, 2), on)
    assert not state.params.tp
    assert state.params[3]['transformer']['attn']['qkv']['w'].shape[-1] == 3 * cfg.d_model
    close(m['loss'], jm['loss'], atol=TOL_LOSS)
    assert_trees_close(ttrain.gather_state(state), after)


def test_forward_on_a_mesh_equals_solo():
    """ar.forward with ``mesh`` (each data rank's rows, TP over 2 model
    ranks, the 1025-wide head replicated) gives the solo logits within
    1e-5."""
    from valle2_tpu_torch.models import ar as tar
    cfg = ConfigValle(**TRAIN)
    params = port_state(cfg, 'ValleAR', None).params
    on = mesh(2, 2)
    sharded = shard_params(on, params)
    b = to_t(ar_batch())
    args = (b['tokens'].long(), b['codes'].long(), b['tokens_lens'], b['codes_lens'])
    with torch.no_grad():
        want = tar.forward(params, cfg, *args)
        got = tar.forward(sharded, cfg, *args, mesh=on)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_nar_eval_on_data4_equals_jax():
    """NAR eval (bidirectional flash, AdaLN, no dropout) on data=4 == JAX's
    make_eval_step on make_mesh(data=4) at its stage (loss within 2e-5)."""
    kw = dict(TRAIN, use_flash_attention=True, norm='AdaptiveLayerNorm')
    jcfg, cfg = JConfig(**kw), ConfigValle(**kw)
    jp = j_init_state(jcfg, 'ValleNAR', jax.random.key(0)).params
    jm = jpar.make_mesh(data=4, model=1)
    want = j_make_eval_step(jcfg, 'ValleNAR', jm)(jax.device_put(jp),
                                                 jpar.shard_batch(jm, to_j(nar_batch())),
                                                 jax.random.key(3))
    on = mesh(4)
    params = port_state(cfg, 'ValleNAR', to_port('ValleNAR', jp), on).params
    with torch.no_grad():
        _, m = tnar.loss_at_stage(params, cfg, to_t(nar_batch()), int(want['stage']),
                                  mesh=on)
    close(m['loss'], np.asarray(want['loss']), atol=TOL_LOSS)
    close(m['acc'], np.asarray(want['acc']), atol=1e-6)


@pytest.mark.parametrize('model', ['ValleAR', 'ValleNAR'])
def test_dropout_step_at_data4_equals_solo(model):
    """Dropout 0.1 (and the NAR's corruption) at data=4: each data rank draws
    the solo step's whole-batch masks and cuts its rows, so two steps equal
    the port's solo steps (params within 2e-5)."""
    kw = dict(TRAIN, dropout=0.1, nar_corrupt_p=0.2 if model == 'ValleNAR' else 0.0,
              norm='AdaptiveLayerNorm' if model == 'ValleNAR' else 'LayerNorm')
    cfg = ConfigValle(**kw)
    batch = ar_batch() if model == 'ValleAR' else nar_batch()
    mesh_state, mm = port_step(cfg, model, None, batch, mesh(4), steps=2, seed=7)
    solo, sm = port_step(cfg, model, None, batch, steps=2, seed=7)
    close(mm['loss'], sm['loss'], atol=TOL_LOSS)
    assert_trees_close(ttrain.gather_state(mesh_state), solo.params)
    fresh = port_state(cfg, model, None).params
    moved = max(float((a - b).detach().abs().max()) for a, b in
                zip(ttrain.tree_leaves(solo.params), ttrain.tree_leaves(fresh)))
    assert moved > 1e-4


@pytest.mark.parametrize('model', ['ValleAR', 'ValleNAR'])
def test_sequence_parallel_at_2x2_equals_not(model):
    """sequence_parallel at 2 x 2 (each model rank keeps half the positions
    for the norm / dropout / residual regions, a reduce-scatter after each
    row-parallel sum, an all-gather before each column-parallel linear) ==
    the same mesh without it (params within 1e-6) and the solo step (2e-5),
    dropout on."""
    norm = 'AdaptiveLayerNorm' if model == 'ValleNAR' else 'LayerNorm'
    kw = dict(TRAIN, dropout=0.1, norm=norm)
    batch = ar_batch() if model == 'ValleAR' else nar_batch()
    sp, _ = port_step(ConfigValle(**dict(kw, sequence_parallel=True)), model, None, batch,
                      mesh(2, 2), steps=2, seed=3)
    plain, _ = port_step(ConfigValle(**kw), model, None, batch, mesh(2, 2), steps=2, seed=3)
    solo, _ = port_step(ConfigValle(**kw), model, None, batch, steps=2, seed=3)
    assert_trees_close(ttrain.gather_state(sp), ttrain.gather_state(plain), atol=1e-6)
    assert_trees_close(ttrain.gather_state(sp), solo.params)


def test_remat_on_2x2_equals_no_remat():
    """remat under tensor parallelism (each TP layer under the checkpoint,
    the recompute replaying the layer's dropout from a fork of the data
    rank's draws) == the same 2 x 2 step without remat, bit for bit."""
    kw = dict(TRAIN, dropout=0.1, n_heads=4, sequence_parallel=True)
    on = mesh(2, 2)
    with_remat, _ = port_step(ConfigValle(**dict(kw, remat=True)), 'ValleAR', None,
                              ar_batch(), on, seed=4)
    plain, _ = port_step(ConfigValle(**kw), 'ValleAR', None, ar_batch(), on, seed=4)
    assert_trees_close(ttrain.gather_state(with_remat), ttrain.gather_state(plain), atol=0)


# ---- ZeRO-1 ----

@pytest.mark.parametrize('accum', [1, 2])
def test_zero1_equals_replicated_and_holds_a_data_share(accum):
    """ZeRO-1 at data=2 x model=2: the params after two optimizer steps equal
    the replicated optimizer's bit for bit (AdamW is elementwise), each rank
    holds half the moments (every leaf but the tail has a free even axis),
    grad_accum=2 too."""
    kw = dict(TRAIN, grad_accum=accum, n_heads=4)
    on = mesh(2, 2)
    z, _ = port_step(ConfigValle(**dict(kw, zero1=True)), 'ValleAR', None, ar_batch(), on,
                     steps=2 * accum)
    r, _ = port_step(ConfigValle(**kw), 'ValleAR', None, ar_batch(), on, steps=2 * accum)
    assert_trees_close(ttrain.gather_state(z), ttrain.gather_state(r), atol=0)
    assert z.opt_state.count == r.opt_state.count == 2

    def moments(opt, rank):
        return sum(s['exp_avg'].numel() for s in opt.adamw[rank].state.values())
    assert all(2 * moments(z.opt_state, k) == moments(r.opt_state, k) for k in range(4))
    sd_z, sd_r = z.opt_state.state_dict(), r.opt_state.state_dict()
    for k, s in sd_r['adamw']['state'].items():
        assert torch.equal(sd_z['adamw']['state'][k]['exp_avg'], s['exp_avg'])


def test_zero1_state_crosses_a_checkpoint(tmp_path):
    """A ZeRO-1 state saved mid-accumulation (moments gathered to whole
    tensors) restores on the same mesh, re-cut, and the continued run equals
    the uninterrupted one bit for bit."""
    cfg = ConfigValle(**dict(TRAIN, zero1=True, grad_accum=2, ckpt_every_n_steps=0))
    cfg.ckpt_path = tmp_path / 'ckpt'
    on = mesh(2)
    step = ttrain.make_train_step(cfg, 'ValleAR', on)
    trainer = ttrain.Trainer(cfg, 'ValleAR', mesh=on, use_tensorboard=False)
    full = port_state(cfg, 'ValleAR', None, on)
    for i in range(5):
        full, _ = step(full, to_t(ar_batch(20 + i)), 0)
        if i == 2:
            trainer.save_checkpoint(full)
    resumed = port_state(cfg, 'ValleAR', None, on)
    resumed = trainer.restore_checkpoint(resumed, trainer.latest_checkpoint())
    assert resumed.step == 3 and resumed.opt_state.mini_step == 1
    for i in range(3, 5):
        resumed, _ = step(resumed, to_t(ar_batch(20 + i)), 0)
    assert_trees_close(ttrain.gather_state(resumed), ttrain.gather_state(full), atol=0)


def test_checkpoint_moves_across_meshes(tmp_path):
    """A state saved at data=2 restores bit for bit at data=4 and on no mesh
    (whole tensors in the file; the moments too), and a step from each equals
    the others' (params within 1e-6)."""
    cfg = ConfigValle(**dict(TRAIN, ckpt_every_n_steps=0))
    cfg.ckpt_path = tmp_path / 'ckpt'
    state, _ = port_step(cfg, 'ValleAR', None, ar_batch(), mesh(2), steps=2)
    ttrain.Trainer(cfg, 'ValleAR', mesh=mesh(2), use_tensorboard=False).save_checkpoint(state)
    saved = ttrain.gather_state(state)
    results = []
    for on in (mesh(4), None):
        trainer = ttrain.Trainer(cfg, 'ValleAR', device='cpu', mesh=on, use_tensorboard=False)
        fresh = port_state(dataclasses.replace(cfg, seed=9), 'ValleAR', None, on)
        restored = trainer.restore_checkpoint(fresh, trainer.latest_checkpoint())
        assert restored.step == 2
        assert_trees_close(ttrain.gather_state(restored), saved, atol=0)
        restored, _ = trainer.train_step(restored, to_t(ar_batch(5)), 0)
        results.append(ttrain.gather_state(restored))
    assert_trees_close(results[0], results[1], atol=1e-6)


# ---- the trainer ----

def test_fit_drops_a_batch_the_data_axis_does_not_divide(tmp_path, caplog):
    """Trainer.fit at data=2 skips a 3-row batch (logged) and trains on the
    others: the params equal a solo fit on the kept batches (within 2e-5)."""
    cfg = ConfigValle(**dict(TRAIN, max_steps=2, log_every_n_steps=0, ckpt_every_n_steps=0,
                             prefetch_batches=0, async_checkpoint=False))
    cfg.ckpt_path = tmp_path / 'ckpt'
    b0, b1, b2 = to_t(ar_batch(1)), to_t(ar_batch(2)), to_t(ar_batch(3))
    odd = {k: v[:3] for k, v in b1.items()}
    trainer = ttrain.Trainer(cfg, 'ValleAR', mesh=mesh(2), use_tensorboard=False)
    logger = logging.getLogger('valle2_tpu_torch')      # does not propagate to the root
    logger.addHandler(caplog.handler)
    try:
        got = trainer.fit(port_state(cfg, 'ValleAR', None), [b0, odd, b2])
    finally:
        logger.removeHandler(caplog.handler)
    assert 'Dropping 3-row batch' in caplog.text
    assert got.step == 2
    solo_cfg = dataclasses.replace(cfg, ckpt_path=tmp_path / 'solo')
    want = ttrain.Trainer(solo_cfg, 'ValleAR', device='cpu', use_tensorboard=False).fit(
        port_state(cfg, 'ValleAR', None), [b0, b2])
    assert_trees_close(ttrain.gather_state(got), want.params)
    valid = trainer.validate(got, [b0, b2], step=2)
    want_valid = ttrain.Trainer(solo_cfg, 'ValleAR', device='cpu',
                                use_tensorboard=False).validate(want, [b0, b2], step=2)
    assert abs(valid - want_valid) < TOL_LOSS


def test_train_from_a_config_with_mesh_data(tmp_path):
    """``train()`` builds the mesh from ``mesh_data`` x ``mesh_model`` (virtual
    ranks on the CPU) and runs two steps on the synthetic stream to a
    checkpoint."""
    import json
    cfg = dict(TRAIN, max_steps=2, log_every_n_steps=1, ckpt_every_n_steps=0,
               mesh_data=2, batch_size=4, ckpt_path=str(tmp_path / 'ckpt'),
               log_path=str(tmp_path / 'logs'), bucket_sizes=[32, 64, 128, 256])
    path = tmp_path / 'cfg.json'
    path.write_text(json.dumps(cfg))
    state = ttrain.train(path, 'ValleAR', synthetic=True, device='cpu')
    assert state.step == 2 and len(state.params) == 2
    assert (tmp_path / 'ckpt' / 'ValleAR' / 'step_2').exists()


def test_lora_on_data2_equals_jax_and_solo(tmp_path):
    """LoRA at data=2: the adapters train, the base stays bit-identical, and
    the step == JAX's LoRA step on make_mesh(data=2) from the same base and
    adapters (moved through an adapter file) and == the port's solo step."""
    kw = dict(TRAIN, lora_rank=2, mesh_data=2)
    jcfg, cfg = JConfig(**kw), ConfigValle(**kw)
    from valle2_tpu import lora as jlora
    js = j_init_state(jcfg, 'ValleAR', jax.random.key(0))
    jlora.save_adapters(tmp_path / 'a.npz', js.params['lora'])
    base = to_port('ValleAR', js.params['base'])
    jm = jpar.make_mesh(data=2, model=1)
    js = JTrainState(jpar.shard_params(jm, js.params), jpar.shard_params(jm, js.opt_state),
                     js.step)
    js, jmetrics = j_make_train_step(jcfg, 'ValleAR', jm)(
        js, jpar.shard_batch(jm, to_j(ar_batch())), jax.random.key(1))

    def start(on):
        state = ttrain.init_state(cfg, 'ValleAR', device='cpu', base_params=base)
        with torch.no_grad():
            for name, leaf in leaves(tlora.load_adapters(tmp_path / 'a.npz')):
                node = state.params['lora']
                for k in name.strip('/').split('/')[:-1]:
                    node = node[k]
                node[name.split('/')[-1]].copy_(leaf)
        return state if on is None else ttrain.shard_state(on, state, cfg)
    on = mesh(2)
    state, m = ttrain.make_train_step(cfg, 'ValleAR', on)(start(on), to_t(ar_batch()), 0)
    close(m['loss'], np.asarray(jmetrics['loss']), atol=TOL_LOSS)
    got = ttrain.gather_state(state)
    assert_trees_close(got['base'], base, atol=0)
    want = {k: np.asarray(v) for k, v in leaves(js.params['lora'])}
    for k, v in leaves(got['lora']):
        close(v, want[k], atol=TOL_PARAMS)
    solo, _ = ttrain.make_train_step(cfg, 'ValleAR')(start(None), to_t(ar_batch()), 0)
    assert_trees_close(got['lora'], solo.params['lora'])
    with pytest.raises(NotImplementedError, match='queue 1 item 14'):
        ttrain.shard_state(mesh(1, 2), start(None), cfg)
