"""Pipeline parallelism in the port (``valle2_tpu_torch.parallel.pipeline``: the
('data', 'pipe'[, 'model']) mesh, its placement, ``pipeline_transformer`` and the
GPipe step), on virtual CPU ranks, held to the JAX package's pipeline steps on
``make_pp_mesh`` over the 8 virtual CPU devices of ``tests/conftest.py`` and to the
port's solo step.  The 1F1B schedule is ``tests/test_torch_pipeline_1f1b.py``.

d=32, 4 heads, dff 64, 4 layers, float32 with matmul_precision='highest'.
Tolerances: params after a step within 2e-5 of JAX's and of the port's solo step,
losses within 2e-5 (the bounds of ``tests/test_torch_mesh_train.py``): the
microbatches' loss sums, the stages' grad sums and the data-axis sum run in another
order than the solo step's, and AdamW's first step, lr * g / (|g| + eps), turns a
grad near zero's last bits into up to 0.5% of lr.  Arms of the same mesh are equal
bit for bit or within 1e-6, as stated per case.  JAX's weights reach the port
through ``models.convert``; the JAX steps run once each, in a module fixture.
"""

import dataclasses
import json

import jax
import pytest
import torch
from torch_pipeline_helpers import (NAR, TOL_LOSS, TRAIN, ar_batch, assert_trees_close,
                                    j_pp_step, leaves, nar_at_stage, nar_batch, port_state,
                                    port_step, pp_mesh, to_port, to_t)
from torch_port_helpers import close
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu.config import ConfigValle as JConfig
from valle2_tpu.models import ar as jar
from valle2_tpu.models import nar as jnar
from valle2_tpu.parallel import pipeline as jpipe
from valle2_tpu_torch import train as ttrain
from valle2_tpu_torch.config import ConfigValle
from valle2_tpu_torch.models import ar as tar
from valle2_tpu_torch.ops.transformer import map_tree, transformer, transformer_init
from valle2_tpu_torch.parallel import (Mesh, gather_params, make_mesh, pipeline_transformer,
                                       pp_opt_specs, pp_param_specs, shard_params,
                                       training_mesh)
from valle2_tpu_torch.parallel.pipeline import PipelineRun, _gcd, pp_parts, tp_slice_stage


@pytest.fixture(scope='module')
def jax_steps():
    """The JAX GPipe steps the port is held to (each compiled once)."""
    pp = dict(TRAIN, mesh_pipe=4, pp_microbatches=2)
    return {
        'ar_2x4': j_pp_step(pp, 'ValleAR', 2, 4, 1, ar_batch()),
        'nar_2x4': j_pp_step(dict(NAR, mesh_pipe=4, pp_microbatches=2), 'ValleNAR', 2, 4, 1,
                             nar_batch()),
        'ar_2x2x2': j_pp_step(dict(pp, mesh_pipe=2), 'ValleAR', 2, 2, 2, ar_batch()),
    }


# ---- the mesh, the config, the rules ----

def test_config_and_training_mesh_build_the_pipe_axis():
    """mesh_pipe / pp_microbatches / pp_schedule load (and the schedule is
    checked); training_mesh builds the row-major data x pipe x model grid
    (rank (i, s, j) on devices[(i * pipe + s) * model + j]); mesh_ctx still
    raises naming the ROADMAP, and beside mesh_pipe raises ValueError."""
    cfg = ConfigValle(**dict(TRAIN, mesh_data=2, mesh_pipe=2, mesh_model=2,
                             pp_microbatches=4, pp_schedule='1f1b'))
    devs = [f'cpu:{k}' for k in range(8)]
    m = training_mesh(cfg, devs)
    assert m.axis_names == ('data', 'pipe', 'model')
    assert m.shape == {'data': 2, 'pipe': 2, 'model': 2} and m.size == 8
    assert m.stage(1, 0) == [torch.device('cpu:4'), torch.device('cpu:5')]
    assert m.coords(6) == (1, 1, 0)
    with pytest.raises(ValueError, match="'gpipe' or '1f1b'"):
        ConfigValle(pp_schedule='zero_bubble')
    with pytest.raises(NotImplementedError, match='ROADMAP.md queue 1 item 14'):
        ConfigValle(mesh_ctx=2)
    with pytest.raises(ValueError, match='exclusive'):
        ConfigValle(mesh_ctx=2, mesh_pipe=2)


def test_pipe_groups_do_not_span_processes():
    """Processes split a pipe mesh along 'data' only: a process holding part
    of a pipe x model group raises NotImplementedError naming item 14; whole
    groups form the mesh."""
    with pytest.raises(NotImplementedError, match='queue 1 item 14'):
        Mesh(['cpu'] * 2, data=1, processes=2, process=0, pipe=2)
    m = Mesh(['cpu'] * 4, data=2, processes=2, process=1, pipe=2)
    assert m.local_data == range(1, 2) and m.shape['model'] == 2


@pytest.mark.parametrize('zero1', [False, True], ids=['params', 'zero1'])
@pytest.mark.parametrize('model', ['ValleAR', 'ValleNAR'])
def test_pp_specs_equal_jax(model, zero1):
    """pp_param_specs / pp_opt_specs at data 2 x pipe 4 == JAX's leaf by leaf
    on the same params (the stack over 'pipe' on its layer axis, ZeRO-1's
    extra 'data' cut)."""
    jcfg = JConfig(**dict(TRAIN, norm='AdaptiveLayerNorm' if model == 'ValleNAR'
                          else 'LayerNorm'))
    init = {'ValleAR': jar.init_params, 'ValleNAR': jnar.init_params}[model]
    jp = init(jax.random.key(0), jcfg)
    jm = jpipe.make_pp_mesh(2, 4)
    want = (jpipe.pp_opt_specs(jm, jp, zero1=True) if zero1 else jpipe.pp_param_specs(jp))
    params = to_port(model, jp)
    got = pp_opt_specs(pp_mesh(2, 4), params, zero1=True) if zero1 else pp_param_specs(params)
    wl, gl = dict(leaves(want)), dict(leaves(got))
    assert sorted(wl) == sorted(gl)
    for k, w in wl.items():
        spec = tuple(getattr(w, 'spec', w))
        assert gl[k] == spec + (None,) * (len(gl[k]) - len(spec)), (k, gl[k], spec)
    assert gl['/transformer/attn/qkv/w'][0] == 'pipe'


def test_microbatch_clamp_is_jaxs():
    """_gcd == JAX's _gcd over a grid: the largest divisor of the rows that
    fits the configured count (6 rows at 4 -> 3, 7 rows -> 1)."""
    for b in range(1, 13):
        for m in range(1, 9):
            assert _gcd(b, m) == jpipe._gcd(b, m)
    assert _gcd(6, 4) == 3 and _gcd(7, 4) == 1


def test_placement_cuts_stages_and_megatron_and_gathers_back():
    """On data 2 x pipe 2 x model 2 each rank holds its stage's layers, its
    Megatron columns (the qkv regrouped rank-major) and whole leaves
    outside the stack; gather_params gives the whole tree bit for bit."""
    cfg = ConfigValle(**TRAIN)
    params = port_state(cfg, 'ValleAR', None).params
    on = pp_mesh(2, 2, 2)
    sharded = shard_params(on, params)
    assert on.coords(7) == (1, 1, 1)
    r = sharded[7]
    qkv = params['transformer']['attn']['qkv']['w']
    got = r['transformer']['attn']['qkv']['w']
    assert got.shape == (2, 32, 48)
    assert torch.equal(got[..., :16], qkv[2:, :, 16:32])            # its q heads
    assert torch.equal(r['audio_emb']['emb'], params['audio_emb']['emb'])
    assert_trees_close(gather_params(on, sharded), params, atol=0)


# ---- pipeline_transformer ----

@pytest.mark.parametrize('remat', [False, True], ids=['plain', 'remat'])
@pytest.mark.parametrize('microbatches', [1, 2, 4])
def test_pipeline_transformer_equals_the_solo_stack(microbatches, remat):
    """pipeline_transformer over 4 stages (one layer each; a bias per row)
    == the solo transformer within 1e-5, and its grads (x and every layer)
    within 1e-5, with and without remat; the 2 x 2 stage x model split too
    at M=2, there through ``transformer(pp=)``, the route JAX's
    ``transformer`` takes (the global head count)."""
    gen = torch.Generator().manual_seed(0)
    p = transformer_init(gen, 4, 32, 4, 64, adaptive_norm=False)
    x = torch.randn(8, 12, 32, generator=gen, requires_grad=True)
    bias = torch.randn(8, 1, 12, 12, generator=gen) * 0.1
    leaf = {k: v.requires_grad_() for k, v in leaves(p)}
    want = transformer(p, x, 4, bias)
    w_grads = torch.autograd.grad(want.square().sum(), [x, *leaf.values()])

    def stages(n, mp):
        per = 4 // n
        cut = [map_tree(lambda a, s=s: a[s * per:(s + 1) * per], p) for s in range(n)]
        devices = [['cpu'] * mp for _ in range(n)]
        return ([tp_slice_stage(c, d) if mp > 1 else [c] for c, d in zip(cut, devices)],
                devices)
    cases = [(4, 1)] + ([(2, 2)] if microbatches == 2 else [])
    for n, mp in cases:
        st, devices = stages(n, mp)
        if mp > 1:
            got = transformer(st, x, 4, bias, remat=remat, pp=(devices, microbatches))
        else:
            got = pipeline_transformer(st, x, 4, bias, devices=devices,
                                       microbatches=microbatches, remat=remat)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        g_grads = torch.autograd.grad(got.square().sum(), [x, *leaf.values()])
        for g, w in zip(g_grads, w_grads):
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


# ---- the GPipe step against JAX and the solo step ----

def test_gpipe_ar_step_at_2x4_equals_jax_and_solo(jax_steps):
    """One AR GPipe step at data 2 x pipe 4, M=2 == JAX make_pp_train_step
    on make_pp_mesh(2, 4) and == the port's solo step (params and loss
    within 2e-5)."""
    before, after, jm = jax_steps['ar_2x4']
    cfg = ConfigValle(**dict(TRAIN, mesh_pipe=4, pp_microbatches=2))
    state, m = port_step(cfg, 'ValleAR', before, ar_batch(), pp_mesh(2, 4))
    close(m['loss'], jm['loss'], atol=TOL_LOSS)
    close(m['acc'], jm['acc'], atol=1e-6)
    close(m['grad_norm'], jm['grad_norm'], atol=1e-5, rtol=1e-5)
    assert int(m['n_valid']) == int(jm['n_valid'])
    got = ttrain.gather_state(state)
    assert_trees_close(got, after)
    solo, sm = port_step(ConfigValle(**TRAIN), 'ValleAR', before, ar_batch())
    close(m['loss'], sm['loss'], atol=TOL_LOSS)
    assert_trees_close(got, solo.params)


def test_gpipe_nar_step_with_ragged_lengths_equals_jax_and_solo(jax_steps):
    """One NAR GPipe step at data 2 x pipe 4 with non-uniform lengths (the
    prefix from the whole batch's longest row) at the stage JAX drew ==
    JAX's step and == the solo step at that stage; the full port step's
    stage is the solo step's draw."""
    before, after, jm = jax_steps['nar_2x4']
    cfg = ConfigValle(**dict(NAR, mesh_pipe=4, pp_microbatches=2))
    stage = int(jm['stage'])
    got, m = nar_at_stage(cfg, before, nar_batch(), stage, pp_mesh(2, 4))
    close(m['loss'], jm['loss'], atol=TOL_LOSS)
    assert int(m['n_valid']) == int(jm['n_valid'])
    assert_trees_close(got, after)
    solo, sm = nar_at_stage(ConfigValle(**NAR), before, nar_batch(), stage)
    close(m['loss'], sm['loss'], atol=TOL_LOSS)
    assert_trees_close(got, solo)
    _, pm = port_step(cfg, 'ValleNAR', before, nar_batch(), pp_mesh(2, 4), seed=5)
    _, sm = port_step(ConfigValle(**NAR), 'ValleNAR', before, nar_batch(), seed=5)
    assert int(pm['stage']) == int(sm['stage'])
    close(pm['loss'], sm['loss'], atol=TOL_LOSS)


def test_gpipe_at_2x2x2_equals_jax_and_solo(jax_steps):
    """data 2 x pipe 2 x model 2 (Megatron TP inside each stage, 5c's plain
    version under autograd on the CPU) == JAX's step on make_pp_mesh(2, 2,
    2) and == the solo step (2e-5); the placement is TP's."""
    before, after, jm = jax_steps['ar_2x2x2']
    cfg = ConfigValle(**dict(TRAIN, mesh_pipe=2, pp_microbatches=2))
    state, m = port_step(cfg, 'ValleAR', before, ar_batch(), pp_mesh(2, 2, 2))
    assert state.params.tp
    close(m['loss'], jm['loss'], atol=TOL_LOSS)
    got = ttrain.gather_state(state)
    assert_trees_close(got, after)
    solo, _ = port_step(ConfigValle(**TRAIN), 'ValleAR', before, ar_batch())
    assert_trees_close(got, solo.params)


@pytest.mark.parametrize('grid', [(2, 2, 1), (1, 2, 2)], ids=['pipe', 'pipe_x_model'])
def test_lora_on_a_pipe_mesh_equals_solo(grid):
    """LoRA (rank 2) on data 2 x pipe 2, and on pipe 2 x model 2 (the
    adapters merged per stage, then the stage cut per model rank in the
    step): two GPipe steps == the solo LoRA steps (adapters within 2e-5),
    the base bit-identical."""
    kw = dict(TRAIN, lora_rank=2, mesh_pipe=2, pp_microbatches=2)
    cfg = ConfigValle(**kw)
    state, m = port_step(cfg, 'ValleAR', None, ar_batch(), pp_mesh(*grid), steps=2)
    solo, sm = port_step(cfg, 'ValleAR', None, ar_batch(), steps=2)
    got = ttrain.gather_state(state)
    close(m['loss'], sm['loss'], atol=TOL_LOSS)
    assert_trees_close(got['lora'], solo.params['lora'])
    assert_trees_close(got['base'], solo.params['base'], atol=0)
    moved = max(float(b.detach().abs().max()) for k, b in leaves(got['lora'])
                if k.endswith('lora_b'))
    assert moved > 1e-4


def test_zero1_is_placement_only():
    """ZeRO-1 at data 2 x pipe 2 x model 2: two steps equal the replicated
    optimizer's bit for bit, and each rank's moments are its masters' blocks,
    half of every leaf cut over 'data'."""
    kw = dict(TRAIN, mesh_pipe=2, pp_microbatches=2)
    z, _ = port_step(ConfigValle(**dict(kw, zero1=True)), 'ValleAR', None, ar_batch(),
                     pp_mesh(2, 2, 2), steps=2)
    r, _ = port_step(ConfigValle(**kw), 'ValleAR', None, ar_batch(), pp_mesh(2, 2, 2), steps=2)
    assert_trees_close(ttrain.gather_state(z), ttrain.gather_state(r), atol=0)

    opt = z.opt_state
    for k in range(8):
        held = sum(s['exp_avg'].numel() for s in opt.adamw[k].state.values())
        assert held == sum(m.numel() for m in opt.masters[k])
        for leaf, master, spec in zip(opt.ranks[k], opt.masters[k], opt.zspecs):
            assert 2 * master.numel() == leaf.numel() if 'data' in spec else master is leaf
    assert sum('data' in spec for spec in opt.zspecs) >= len(opt.zspecs) - 2


def test_grad_accum_equals_solo():
    """grad_accum 2 at data 2 x pipe 2: four micro-steps (two updates) ==
    the solo run's (2e-5)."""
    kw = dict(TRAIN, grad_accum=2, mesh_pipe=2, pp_microbatches=2)
    state, _ = port_step(ConfigValle(**kw), 'ValleAR', None, ar_batch(), pp_mesh(2, 2),
                         steps=4)
    solo, _ = port_step(ConfigValle(**kw), 'ValleAR', None, ar_batch(), steps=4)
    assert state.opt_state.count == solo.opt_state.count == 2
    assert_trees_close(ttrain.gather_state(state), solo.params)


def test_asr_step_takes_the_ar_parts():
    """ValleASR trains through the AR's pipeline parts (JAX ``parts_fns``): a
    GPipe step at pipe 2 == its solo step (params and loss within 2e-5)."""
    kw = dict(TRAIN, mesh_pipe=2, pp_microbatches=2)
    state, m = port_step(ConfigValle(**kw), 'ValleASR', None, ar_batch(), pp_mesh(1, 2))
    solo, sm = port_step(ConfigValle(**TRAIN), 'ValleASR', None, ar_batch())
    close(m['loss'], sm['loss'], atol=TOL_LOSS)
    assert_trees_close(ttrain.gather_state(state), solo.params)


@pytest.mark.parametrize('b', [8, 6], ids=['divides', 'clamped'])
@pytest.mark.parametrize('model', ['ValleAR', 'ValleNAR'])
def test_eval_step_equals_the_solo_eval(model, b):
    """The GPipe eval step (pp_microbatches 4) at data 2 x pipe 2 == the solo
    eval loss within 2e-5, also at 6 rows (3 a data rank: M clamps to 3)."""
    kw = dict(NAR if model == 'ValleNAR' else TRAIN, mesh_pipe=2, pp_microbatches=4)
    cfg = ConfigValle(**kw)
    batch = to_t((nar_batch if model == 'ValleNAR' else ar_batch)(b=b))
    on = pp_mesh(2, 2)
    params = port_state(cfg, model, None, on).params
    solo = port_state(cfg, model, None).params
    got = ttrain.make_eval_step(cfg, model, on)(params, batch, ttrain.step_generator(0, 3, 'cpu'))
    want = ttrain.make_eval_step(cfg, model)(solo, batch, ttrain.step_generator(0, 3, 'cpu'))
    close(got['loss'], want['loss'], atol=TOL_LOSS)
    close(got['acc'], want['acc'], atol=1e-6)


def test_loss_fn_through_the_pipeline_differentiates_to_the_step_grads():
    """ar.loss_fn(pp=) (pipeline_transformer, autograd end to end) gives the
    solo loss and, through MeshOptimizer.whole_grads, the GPipe step's grads
    within 1e-6; ar.forward(pp=) the solo logits within 1e-5."""
    cfg = ConfigValle(**dict(TRAIN, mesh_pipe=2, pp_microbatches=2))
    on = pp_mesh(2, 2)
    state = port_state(cfg, 'ValleAR', None, on)
    batch = to_t(ar_batch())
    loss, m = tar.loss_fn(state.params, cfg, batch, pp=(on, 2))
    opt = state.opt_state
    grads = torch.autograd.grad(loss, opt.leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(opt.leaves, grads)]
    whole = opt.whole_grads(grads)
    run = PipelineRun(cfg, on, state.params, pp_parts('ValleAR')(cfg, batch), batch, None, 2,
                      leaves=opt.ranks)
    run.gpipe()
    for g, w in zip(whole, opt.whole_grads(run.grads())):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=0)
    solo = port_state(cfg, 'ValleAR', None).params
    _, sm = tar.loss_fn(solo, cfg, batch)
    close(m['loss'], sm['loss'], atol=TOL_LOSS)
    args = (batch['tokens'].long(), batch['codes'].long(), batch['tokens_lens'],
            batch['codes_lens'])
    with torch.no_grad():
        torch.testing.assert_close(tar.forward(state.params, cfg, *args, pp=(on, 4)),
                                   tar.forward(solo, cfg, *args), atol=1e-5, rtol=1e-5)


# ---- checkpoints and the trainer ----

def test_checkpoint_moves_pp_to_solo_and_back(tmp_path):
    """A state saved at data 2 x pipe 2 x model 2 mid-run (whole tensors:
    params and moments in the canonical layout) restores bit for bit on no
    mesh and back on the pipe mesh, and a step from each restore == the
    others' within 1e-6."""
    cfg = ConfigValle(**dict(TRAIN, mesh_pipe=2, pp_microbatches=2, ckpt_every_n_steps=0))
    cfg.ckpt_path = tmp_path / 'ckpt'
    state, _ = port_step(cfg, 'ValleAR', None, ar_batch(), pp_mesh(2, 2, 2), steps=2)
    saved = ttrain.gather_state(state)
    ttrain.Trainer(cfg, 'ValleAR', mesh=pp_mesh(2, 2, 2),
                   use_tensorboard=False).save_checkpoint(state)
    results, path = [], tmp_path / 'ckpt' / 'ValleAR' / 'step_2'
    for on in (None, pp_mesh(2, 2, 2)):
        trainer = ttrain.Trainer(cfg, 'ValleAR', device='cpu', mesh=on, use_tensorboard=False)
        fresh = port_state(dataclasses.replace(cfg, seed=9), 'ValleAR', None, on)
        restored = trainer.restore_checkpoint(fresh, path)
        assert restored.step == 2
        assert_trees_close(ttrain.gather_state(restored), saved, atol=0)
        restored, _ = trainer.train_step(restored, to_t(ar_batch(5)), 0)
        results.append(ttrain.gather_state(restored))
        if on is None:          # solo -> pipe: save the solo restore, read it on the mesh
            cfg.ckpt_path = tmp_path / 'solo'
            trainer.save_checkpoint(restored)
    back = port_state(cfg, 'ValleAR', None, pp_mesh(2, 2, 2))
    back = ttrain.Trainer(cfg, 'ValleAR', mesh=pp_mesh(2, 2, 2), use_tensorboard=False) \
        .restore_checkpoint(back, tmp_path / 'solo' / 'ValleAR' / 'step_3')
    assert_trees_close(ttrain.gather_state(back), results[0], atol=0)
    assert_trees_close(results[0], results[1], atol=1e-6)


def test_fit_from_a_config_and_the_bad_compositions(tmp_path):
    """train() builds data 2 x pipe 2 from the config (virtual CPU ranks) and
    fits two GPipe steps to a checkpoint; the Trainer refuses a stack that
    does not split into equal stages and heads the model axis does not
    divide (ValueError), and serving refuses a pipe mesh."""
    cfg = dict(TRAIN, max_steps=2, log_every_n_steps=1, ckpt_every_n_steps=0, mesh_data=2,
               mesh_pipe=2, pp_microbatches=2, batch_size=4, bucket_sizes=[32, 64, 128, 256],
               ckpt_path=str(tmp_path / 'ckpt'), log_path=str(tmp_path / 'logs'))
    path = tmp_path / 'cfg.json'
    path.write_text(json.dumps(cfg))
    state = ttrain.train(path, 'ValleAR', synthetic=True, device='cpu')
    assert state.step == 2 and len(state.params) == 4
    assert state.opt_state.mesh.shape == {'data': 2, 'pipe': 2, 'model': 1}
    assert (tmp_path / 'ckpt' / 'ValleAR' / 'step_2').exists()
    with pytest.raises(ValueError, match='equal stages'):
        ttrain.Trainer(ConfigValle(**dict(TRAIN, num_layers=3)), 'ValleAR',
                       mesh=pp_mesh(1, 2), use_tensorboard=False)
    with pytest.raises(ValueError, match='Megatron TP within each pipeline stage'):
        ttrain.Trainer(ConfigValle(**dict(TRAIN, n_heads=2, d_model=32)), 'ValleAR',
                       mesh=pp_mesh(1, 2, 4), use_tensorboard=False)
    with pytest.raises(ValueError, match='pipeline mesh trains'):
        tar.ValleAR(ConfigValle(**TRAIN), device='cpu', mesh=pp_mesh(1, 2))
    with pytest.raises(NotImplementedError, match='GSPMD'):      # the data mesh still refuses
        ttrain.shard_state(make_mesh(1, 2, ['cpu'] * 2),
                           port_state(ConfigValle(**dict(TRAIN, lora_rank=2)), 'ValleAR',
                                      None), ConfigValle(**dict(TRAIN, lora_rank=2)))
