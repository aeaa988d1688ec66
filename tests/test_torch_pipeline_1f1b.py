"""The 1F1B pipeline schedule in the port (``valle2_tpu_torch.parallel.pipeline_1f1b``)
on virtual CPU ranks, held to the JAX package's ``make_pp_train_step_1f1b`` on
``make_pp_mesh`` over the 8 virtual CPU devices of ``tests/conftest.py``, to the
port's solo step and to its GPipe step; and the pipeline's dropout rule, which both
schedules share.

d=32, 4 heads, dff 64, 4 layers, float32 with matmul_precision='highest'.
Tolerances: params after a step and losses within 2e-5 of JAX's and of the port's
solo step (the bounds of ``tests/test_torch_mesh_train.py``; see
``tests/test_torch_pipeline.py``).  The port's two schedules accumulate each stage's
microbatches in the same order, so they are equal bit for bit.  JAX's weights reach
the port through ``models.convert``; the JAX steps run once each, in a module
fixture.
"""

import numpy as np
import pytest
import torch
from torch_pipeline_helpers import (NAR, SCHEDULES, TOL_LOSS, TRAIN, ar_batch,
                                    assert_trees_close, j_pp_step, nar_at_stage, nar_batch,
                                    port_state, port_step, pp_mesh, to_t)
from torch_pipeline_helpers import leaves as leaves_of
from torch_port_helpers import close
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu_torch import train as ttrain
from valle2_tpu_torch.config import ConfigValle
from valle2_tpu_torch.ops.transformer import map_tree, transformer_init
from valle2_tpu_torch.parallel import pipeline_transformer
from valle2_tpu_torch.parallel.pipeline import PipelineRun, pp_parts
from valle2_tpu_torch.parallel import pipeline_1f1b


@pytest.fixture(scope='module')
def jax_steps():
    """The JAX 1F1B steps the port is held to (each compiled once)."""
    pp = dict(TRAIN, mesh_pipe=4, pp_microbatches=2)
    return {
        'ar_2x4_m2': j_pp_step(pp, 'ValleAR', 2, 4, 1, ar_batch(), '1f1b'),
        'ar_2x4_m4': j_pp_step(dict(pp, pp_microbatches=4), 'ValleAR', 2, 4, 1, ar_batch(),
                               '1f1b'),
        'nar_2x4': j_pp_step(dict(NAR, mesh_pipe=4, pp_microbatches=2), 'ValleNAR', 2, 4, 1,
                             nar_batch(), '1f1b'),
        'ar_2x2x2': j_pp_step(dict(pp, mesh_pipe=2), 'ValleAR', 2, 2, 2, ar_batch(), '1f1b'),
    }


@pytest.mark.parametrize('microbatches', [2, 4])
def test_1f1b_ar_step_at_2x4_equals_jax_and_solo(jax_steps, microbatches):
    """One AR 1F1B step at data 2 x pipe 4, M = 2 and 4 == JAX
    make_pp_train_step_1f1b on make_pp_mesh(2, 4) and == the port's solo step
    (params and loss within 2e-5), and == the port's GPipe step bit for bit."""
    before, after, jm = jax_steps[f'ar_2x4_m{microbatches}']
    cfg = ConfigValle(**dict(TRAIN, mesh_pipe=4, pp_microbatches=microbatches,
                             pp_schedule='1f1b'))
    state, m = port_step(cfg, 'ValleAR', before, ar_batch(), pp_mesh(2, 4))
    close(m['loss'], jm['loss'], atol=TOL_LOSS)
    close(m['acc'], jm['acc'], atol=1e-6)
    close(m['grad_norm'], jm['grad_norm'], atol=1e-5, rtol=1e-5)
    got = ttrain.gather_state(state)
    assert_trees_close(got, after)
    solo, sm = port_step(ConfigValle(**TRAIN), 'ValleAR', before, ar_batch())
    close(m['loss'], sm['loss'], atol=TOL_LOSS)
    assert_trees_close(got, solo.params)
    gpipe, gm = port_step(ConfigValle(**dict(TRAIN, mesh_pipe=4, pp_microbatches=microbatches)),
                          'ValleAR', before, ar_batch(), pp_mesh(2, 4))
    assert float(gm['loss']) == float(m['loss'])
    assert_trees_close(ttrain.gather_state(gpipe), got, atol=0)


def test_1f1b_nar_step_equals_jax_and_solo(jax_steps):
    """One NAR 1F1B step at data 2 x pipe 4 with non-uniform lengths, at the
    stage JAX drew == JAX's 1F1B step and == the solo step at that stage
    (2e-5), and == the GPipe schedule bit for bit."""
    before, after, jm = jax_steps['nar_2x4']
    cfg = ConfigValle(**dict(NAR, mesh_pipe=4, pp_microbatches=2, pp_schedule='1f1b'))
    stage = int(jm['stage'])
    got, m = nar_at_stage(cfg, before, nar_batch(), stage, pp_mesh(2, 4), '1f1b')
    close(m['loss'], jm['loss'], atol=TOL_LOSS)
    assert int(m['n_valid']) == int(jm['n_valid'])
    assert_trees_close(got, after)
    solo, sm = nar_at_stage(ConfigValle(**NAR), before, nar_batch(), stage)
    close(m['loss'], sm['loss'], atol=TOL_LOSS)
    assert_trees_close(got, solo)
    gpipe, _ = nar_at_stage(cfg, before, nar_batch(), stage, pp_mesh(2, 4), 'gpipe')
    assert_trees_close(gpipe, got, atol=0)


def test_1f1b_at_2x2x2_equals_jax_and_solo(jax_steps):
    """data 2 x pipe 2 x model 2 with 1F1B (TP inside each stage, the stage
    forward recomputed under autograd through 5c's plain version) == JAX's
    1F1B step on make_pp_mesh(2, 2, 2) and == the solo step (2e-5)."""
    before, after, jm = jax_steps['ar_2x2x2']
    cfg = ConfigValle(**dict(TRAIN, mesh_pipe=2, pp_microbatches=2, pp_schedule='1f1b'))
    state, m = port_step(cfg, 'ValleAR', before, ar_batch(), pp_mesh(2, 2, 2))
    close(m['loss'], jm['loss'], atol=TOL_LOSS)
    got = ttrain.gather_state(state)
    assert_trees_close(got, after)
    solo, _ = port_step(ConfigValle(**TRAIN), 'ValleAR', before, ar_batch())
    assert_trees_close(got, solo.params)


def test_trainer_selects_1f1b(monkeypatch):
    """pp_schedule '1f1b' makes make_train_step (so the Trainer) run the 1F1B
    schedule, 'gpipe' the GPipe one."""
    ran = []
    monkeypatch.setattr(pipeline_1f1b, 'one_f_one_b',
                        lambda run, f=pipeline_1f1b.one_f_one_b: ran.append('1f1b') or f(run))
    monkeypatch.setattr(PipelineRun, 'gpipe',
                        lambda run, f=PipelineRun.gpipe: ran.append('gpipe') or f(run))
    for sched in ('gpipe', '1f1b'):
        cfg = ConfigValle(**dict(TRAIN, mesh_pipe=2, pp_schedule=sched))
        port_step(cfg, 'ValleAR', None, ar_batch(), pp_mesh(1, 2))
    assert ran == ['gpipe', '1f1b']


@pytest.mark.parametrize('pipe,microbatches', [(4, 2), (4, 8), (4, 16), (2, 8)])
def test_1f1b_holds_o_p_stage_inputs(pipe, microbatches):
    """A stage holds at most min(M, 2P - 3) saved inputs whatever M is (the
    first and last stages none; JAX's ring bound min(M, 2P)), and nothing is
    left over after the step."""
    cfg = ConfigValle(**dict(TRAIN, mesh_pipe=pipe))
    on = pp_mesh(1, pipe)
    state = port_state(cfg, 'ValleAR', None, on)
    batch = to_t(ar_batch())
    if microbatches == 16:
        batch = {k: torch.cat([v, v]) for k, v in batch.items()}
    run = PipelineRun(cfg, on, state.params, pp_parts('ValleAR')(cfg, batch), batch, None,
                      microbatches, leaves=state.opt_state.ranks)
    SCHEDULES['1f1b'](run)
    assert run.ring_peak == (min(microbatches, 2 * pipe - 3) if pipe > 2 else 0)
    assert run.ring_peak <= min(microbatches, 2 * pipe)
    assert not run.ring and not run.inbox and not run.cts


@pytest.mark.parametrize('grid', [(2, 2, 1), (1, 2, 2)], ids=['pipe', 'pipe_x_model'])
def test_1f1b_lora_equals_solo(grid):
    """LoRA (rank 2) with 1F1B on data 2 x pipe 2 and on pipe 2 x model 2: two
    steps == the solo LoRA steps (adapters within 2e-5), the base
    bit-identical."""
    kw = dict(TRAIN, lora_rank=2, mesh_pipe=2, pp_microbatches=2)
    state, m = port_step(ConfigValle(**dict(kw, pp_schedule='1f1b')), 'ValleAR', None,
                         ar_batch(), pp_mesh(*grid), steps=2)
    solo, sm = port_step(ConfigValle(**kw), 'ValleAR', None, ar_batch(), steps=2)
    got = ttrain.gather_state(state)
    close(m['loss'], sm['loss'], atol=TOL_LOSS)
    assert_trees_close(got['lora'], solo.params['lora'])
    assert_trees_close(got['base'], solo.params['base'], atol=0)


# ---- the dropout rule ----

@pytest.mark.parametrize('model', ['ValleAR', 'ValleNAR'])
def test_dropout_gpipe_equals_1f1b_and_repeats(model):
    """At dropout 0.1 (and the NAR's conditioning corruption) on data 2 x pipe
    2 x model 2, M=4: the GPipe and 1F1B steps are equal bit for bit (1F1B's
    recompute replays its forward's masks), a step repeats bit for bit at one
    seed, another seed moves it, and dropout moves it off the dropout-0 step."""
    kw = dict(NAR if model == 'ValleNAR' else TRAIN, dropout=0.1, mesh_pipe=2,
              pp_microbatches=4)
    batch = nar_batch() if model == 'ValleNAR' else ar_batch()
    on = pp_mesh(2, 2, 2)
    runs = {}
    for name, sched, seed in (('gpipe', 'gpipe', 0), ('1f1b', '1f1b', 0), ('again', '1f1b', 0),
                              ('seed', '1f1b', 1)):
        state, m = port_step(ConfigValle(**dict(kw, pp_schedule=sched)), model, None, batch,
                             on, seed=seed)
        runs[name] = (ttrain.gather_state(state), float(m['loss']))
    assert runs['gpipe'][1] == runs['1f1b'][1] == runs['again'][1]
    assert_trees_close(runs['gpipe'][0], runs['1f1b'][0], atol=0)
    assert_trees_close(runs['again'][0], runs['1f1b'][0], atol=0)
    assert runs['seed'][1] != runs['1f1b'][1]
    _, m0 = port_step(ConfigValle(**dict(kw, dropout=0.0)), model, None, batch, on)
    assert float(m0['loss']) != runs['1f1b'][1]


def test_dropout_masks_differ_across_microbatches():
    """The rule draws layer g of microbatch m from its own generator: two
    microbatches of identical rows come out of pipeline_transformer different
    at dropout 0.1 and equal at dropout 0; the draw is a function of (layer,
    microbatch) alone, so two calls agree."""
    gen = torch.Generator().manual_seed(0)
    p = transformer_init(gen, 2, 32, 4, 64, adaptive_norm=False)
    half = torch.randn(2, 6, 32, generator=gen)
    x = torch.cat([half, half])
    stages = [[map_tree(lambda a, s=s: a[s:s + 1], p)] for s in range(2)]
    devices = [['cpu'], ['cpu']]

    def gens(g, m, dev):
        return torch.Generator(device=dev).manual_seed(1000 * g + m)
    out = {}
    for rate in (0.0, 0.1):
        ys = [pipeline_transformer(stages, x, 4, devices=devices, microbatches=2,
                                   dropout_rate=rate, generators=gens) for _ in range(2)]
        assert torch.equal(ys[0], ys[1])
        out[rate] = ys[0]
    assert torch.equal(out[0.0][:2], out[0.0][2:])
    assert not torch.equal(out[0.1][:2], out[0.1][2:])
    assert np.isfinite(out[0.1].numpy()).all()


def test_bf16_step_casts_each_stage_once():
    """In bf16 (f32 masters) each rank's stack is cast once a step and the
    units differentiate against the casts: GPipe == 1F1B bit for bit at pipe
    2, M=4; the loss within bf16's reach of the solo step's, the masters stay
    float32 and move."""
    kw = dict(TRAIN, dtype='bfloat16', mesh_pipe=2, pp_microbatches=4)
    on = pp_mesh(1, 2)
    batch = to_t(ar_batch())
    runs = {}
    for sched in ('gpipe', '1f1b'):
        cfg = ConfigValle(**dict(kw, pp_schedule=sched))
        state = port_state(cfg, 'ValleAR', None, on)
        run = PipelineRun(cfg, on, state.params, pp_parts('ValleAR')(cfg, batch), batch, None,
                          4, leaves=state.opt_state.ranks)
        SCHEDULES[sched](run)
        assert sorted(run._cast) == [0, 1]
        assert all(t.dtype == torch.bfloat16 for t in run.inputs[1] if t.dim() == 3)
        runs[sched] = (float(run.metrics()['loss']), run.grads())
        assert all(g.dtype == torch.float32 for g in runs[sched][1])
    assert runs['gpipe'][0] == runs['1f1b'][0]
    assert all(torch.equal(a, b) for a, b in zip(runs['gpipe'][1], runs['1f1b'][1]))
    solo, sm = port_step(ConfigValle(**dict(TRAIN, dtype='bfloat16')), 'ValleAR', None,
                         ar_batch())
    close(runs['gpipe'][0], sm['loss'], atol=2e-2)
    state, _ = port_step(ConfigValle(**kw), 'ValleAR', None, ar_batch(), on)
    got = ttrain.gather_state(state)
    assert all(t.dtype == torch.float32 for _, t in leaves_of(got))
    before = port_state(ConfigValle(**kw), 'ValleAR', None).params
    assert max(float((a - b.detach()).abs().max()) for (_, a), (_, b) in
               zip(leaves_of(got), leaves_of(before))) > 1e-5
