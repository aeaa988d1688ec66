"""Checkpoints crossing into the port: the reference stack's torch files
(``valle2_tpu_torch/models/convert.py`` against ``valle2_tpu/models/convert.py``)
and the JAX package's orbax checkpoints (``scripts/orbax_to_torch.py``).

A file written by either package's ``save_torch_checkpoint`` loads in the
other bit for bit (raw, Lightning ``{'state_dict'}`` and ``model.``-prefixed
layouts); greedy ids of a loaded AR equal the JAX package's on the same file
(tiny size, float32, TF32 off); the model registry and ``param_count`` equal
JAX's.  The orbax script converts a JAX params checkpoint, a JAX trainer
step dir and a LoRA step dir; one port step resumed from the converted dir
matches one more JAX step (params atol 1e-5: float32 sums in another
order)."""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import SMALL, to_np
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu import models as jmodels
from valle2_tpu.config import ConfigValle as JConfig
from valle2_tpu.models import ar as jar
from valle2_tpu.models import checkpoint as jckpt
from valle2_tpu.models import convert as jconvert
from valle2_tpu.models import nar as jnar
from valle2_tpu import train as jtrain
from valle2_tpu_torch import models as tmodels
from valle2_tpu_torch import train as ttrain
from valle2_tpu_torch.config import ConfigValle
from valle2_tpu_torch.models import ar as tar
from valle2_tpu_torch.models import convert as tconvert
from valle2_tpu_torch.models import nar as tnar

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / 'scripts'))
import orbax_to_torch  # noqa: E402

CFG = dict(SMALL, max_audio_len=8, num_beams=1, temperature=0.0, batch_size=2,
           bucket_sizes=(16, 32, 64, 128))
STEP_ATOL = 1e-5


def leaves(tree, prefix=''):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f'{prefix}/{k}')
    else:
        yield prefix, tree


def assert_bit_equal(got, want):
    """Port tensors against JAX / numpy leaves at the same paths."""
    g, w = dict(leaves(got)), dict(leaves(to_np(want)))
    assert sorted(g) == sorted(w)
    for k in g:
        np.testing.assert_array_equal(g[k].detach().cpu().numpy(), np.asarray(w[k]), err_msg=k)


@pytest.fixture(scope='module')
def jparams():
    jcfg = JConfig(**CFG)
    return {'ValleAR': jar.init_params(jax.random.key(0), jcfg),
            'ValleNAR': jnar.init_params(jax.random.key(1), jcfg)}


@pytest.mark.parametrize('model', ['ValleAR', 'ValleNAR', 'ValleASR'])
@pytest.mark.parametrize('layout', ['lightning', 'prefixed', 'raw'])
def test_jax_written_checkpoint_loads_in_port_bit_equal(jparams, tmp_path, model, layout):
    p = jparams['ValleNAR' if model == 'ValleNAR' else 'ValleAR']
    path = tmp_path / 'ref.ckpt'
    jconvert.save_torch_checkpoint(str(path), p, model)
    if layout != 'lightning':
        sd = torch.load(path, weights_only=True)['state_dict']
        torch.save({'state_dict': {f'model.{k}': v for k, v in sd.items()}}
                   if layout == 'prefixed' else sd, path)
    got = tconvert.load_torch_checkpoint(path, model, num_layers=2)
    assert_bit_equal(got, p)


@pytest.mark.parametrize('model', ['ValleAR', 'ValleNAR'])
def test_port_written_checkpoint_loads_in_jax_bit_equal(jparams, tmp_path, model):
    cfg = ConfigValle(**CFG)
    tp = (tar if model == 'ValleAR' else tnar).init_params(torch.Generator().manual_seed(3), cfg)
    path = tmp_path / 'port.ckpt'
    tconvert.save_torch_checkpoint(path, tp, model)
    got = jconvert.load_torch_checkpoint(str(path), model, num_layers=2)
    assert_bit_equal(tp, got)
    # and the state dicts themselves: same names, shapes and values both ways
    want = (jconvert.export_nar_state_dict if model == 'ValleNAR'
            else jconvert.export_ar_state_dict)(got)
    have = (tconvert.export_nar_state_dict if model == 'ValleNAR'
            else tconvert.export_ar_state_dict)(tp)
    assert sorted(have) == sorted(want)
    for k in have:
        np.testing.assert_array_equal(have[k].numpy(), want[k], err_msg=k)


def test_convert_state_dict_refuses_a_layer_count_mismatch(jparams):
    sd = jconvert.export_ar_state_dict(jparams['ValleAR'])
    assert tconvert.convert_ar_state_dict(sd, 2)['transformer']['attn']['qkv']['w'].shape[0] == 2
    with pytest.raises(ValueError, match='layers'):
        tconvert.convert_ar_state_dict(sd, 3)
    with pytest.raises(ValueError, match='codebook'):
        tconvert.convert_nar_state_dict(jconvert.export_nar_state_dict(jparams['ValleNAR']),
                                        2, num_quantizers=4)


def test_greedy_ids_after_load_equal_jax(jparams, tmp_path):
    """A reference-format AR checkpoint written by JAX, loaded by both
    packages: greedy first-codebook ids are equal."""
    path = tmp_path / 'ar.ckpt'
    jconvert.save_torch_checkpoint(str(path), jparams['ValleAR'], 'ValleAR')
    rs = np.random.RandomState(7)
    pt, pc, tt = rs.randint(0, 60, (5,)), rs.randint(0, 1024, (6, 8)), rs.randint(0, 60, (4,))
    jcfg = JConfig(**CFG)
    want = np.asarray(jmodels.ValleAR(jcfg, params=jax.tree.map(
        jnp.asarray, jconvert.load_torch_checkpoint(str(path), 'ValleAR', num_layers=2))
    ).generate(pt, pc, tt))
    cfg = ConfigValle(**CFG)
    model = tmodels.ValleAR(cfg, params=tconvert.load_torch_checkpoint(
        path, 'ValleAR', num_layers=2), device='cpu')
    got = model.generate(pt, pc, tt).numpy()
    assert len(want) > 0
    np.testing.assert_array_equal(got, want)


def test_model_dict_and_param_count_match_jax(jparams):
    assert sorted(tmodels.MODEL_DICT) == sorted(jmodels.MODEL_DICT)
    assert tmodels.get_model_class('EncodecPip') is tmodels.MODEL_DICT['EncodecTPU']
    cfg = ConfigValle(**CFG)
    asr = tmodels.get_model_class('ValleASR')(cfg, device='cpu')
    assert asr.config.direction == 'asr'
    jasr = jmodels.get_model_class('ValleASR')(JConfig(**CFG))
    assert tar.param_count(asr.params) == jar.param_count(jasr.params)
    for model, mod, jmod in (('ValleAR', tar, jar), ('ValleNAR', tnar, jnar)):
        tp = mod.init_params(torch.Generator().manual_seed(0), cfg)
        assert tar.param_count(tp) == jar.param_count(jparams[model]), model


# ---- orbax (the JAX package's own checkpoints) → the port -------------------

def ar_batch(seed):
    rs = np.random.RandomState(seed)
    return {'tokens': rs.randint(0, 256, (2, 6)).astype(np.int32),
            'tokens_lens': np.asarray([6, 4], np.int32),
            'codes': rs.randint(0, 1026, (2, 10)).astype(np.int32),
            'codes_lens': np.asarray([10, 7], np.int32),
            'target': rs.randint(0, 1025, (2, 10)).astype(np.int32)}


def save_orbax(path, item):
    import orbax.checkpoint as ocp
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(Path(path).resolve(), item, force=True)


def test_orbax_params_checkpoint_converts(jparams, tmp_path):
    jckpt.save_params(tmp_path / 'jax_ar', jparams['ValleAR'])
    cfg = ConfigValle(**CFG)
    assert orbax_to_torch.convert(tmp_path / 'jax_ar', tmp_path / 'ar.pt', cfg,
                                  'ValleAR') == 'params'
    model = tmodels.ValleAR(cfg, device='cpu')
    model.load(tmp_path / 'ar.pt')
    assert_bit_equal(model.params, jparams['ValleAR'])


@pytest.fixture(scope='module')
def jax_runs(tmp_path_factory):
    """Per kind ('dense', 'lora'): a JAX trainer step dir after two steps
    (orbax, the Trainer's layout), and the params one more JAX step gives."""
    out = {}
    root = tmp_path_factory.mktemp('orbax')
    for kind, over in (('dense', {}), ('lora', dict(lora_rank=4, lora_alpha=8.0))):
        jcfg = JConfig(**dict(CFG, lr=3e-3, gradient_clip_val=100.0, **over))
        state = jtrain.init_state(jcfg, 'ValleAR', jax.random.key(0))
        if kind == 'lora':   # nonzero B, so the adapters take part from step 1
            state = state._replace(params={'base': state.params['base'], 'lora': jax.tree.map(
                lambda x: x + 0.05, state.params['lora'])})
        step = jtrain.make_train_step(jcfg, 'ValleAR')
        for i in range(2):
            state, _ = step(state, jax.tree.map(jnp.asarray, ar_batch(i)), jax.random.key(i))
        path = root / f'{kind}_step_2'
        save_orbax(path, {'params': state.params, 'opt_state': state.opt_state,
                          'step': state.step})
        state, _ = step(state, jax.tree.map(jnp.asarray, ar_batch(2)), jax.random.key(2))
        out[kind] = (path, to_np(state.params), over)
    return out


@pytest.mark.parametrize('kind', ['dense', 'lora'])
def test_orbax_trainer_step_dir_resumes_in_port(jax_runs, tmp_path, kind):
    src, want, over = jax_runs[kind]
    cfg = ConfigValle(**dict(CFG, lr=3e-3, gradient_clip_val=100.0, **over))
    dst = tmp_path / 'step_2'
    assert orbax_to_torch.convert(src, dst, cfg, 'ValleAR') == 'trainer'
    trainer = ttrain.Trainer(cfg, 'ValleAR', device='cpu', use_tensorboard=False)
    state = trainer.restore_checkpoint(ttrain.init_state(cfg, 'ValleAR', device='cpu'), dst)
    assert state.step == 2 and state.opt_state.count == 2
    batch = {k: torch.from_numpy(v) for k, v in ar_batch(2).items()}
    state, _ = trainer.train_step(state, batch, cfg.seed)
    got, w = dict(leaves(state.params)), dict(leaves(want))
    assert sorted(got) == sorted(w)
    for k in got:
        np.testing.assert_allclose(got[k].detach().numpy(), w[k], atol=STEP_ATOL, rtol=0,
                                   err_msg=k)


def test_orbax_script_refuses_grad_accum(jax_runs, tmp_path):
    src, _, _ = jax_runs['dense']
    cfg = ConfigValle(**dict(CFG, grad_accum=2))
    with pytest.raises(ValueError, match='MultiSteps'):
        orbax_to_torch.convert(src, tmp_path / 'x', cfg, 'ValleAR')


def test_orbax_script_command_line(jparams, tmp_path, capsys):
    jckpt.save_params(tmp_path / 'jax_nar', jparams['ValleNAR'])
    (tmp_path / 'cfg.json').write_text(json.dumps(
        {k: list(v) if isinstance(v, tuple) else v for k, v in CFG.items()}))
    assert orbax_to_torch.main([str(tmp_path / 'jax_nar'), str(tmp_path / 'nar.pt'),
                                '-c', str(tmp_path / 'cfg.json'), '-m', 'ValleNAR']) == 0
    assert '(params)' in capsys.readouterr().out
    model = tmodels.ValleNAR(ConfigValle(**CFG), device='cpu')
    model.load(tmp_path / 'nar.pt')
    assert_bit_equal(model.params, jparams['ValleNAR'])
