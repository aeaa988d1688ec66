"""LoRA in the port (``valle2_tpu_torch.lora`` and the trainer's LoRA mode)
against the JAX package's ``valle2_tpu/lora.py``: the merge on the same
adapters (atol 1e-6), attach starting exactly at the base, only target
weights changing, ``lora_init``'s targets, shapes and bound, adapter files
crossing between the packages both ways (bf16 too), one LoRA train step's
adapter grads and update against JAX's (per leaf atol 1e-5 x the leaf's
scale, rtol 1e-4: float32 sums in another order), the frozen base over three
steps, eval merging, and the trainer's checkpoint, resume and
``load_params`` of a LoRA step dir.  Small config, float32, dropout 0."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import SMALL, close, to_np, to_torch
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu import lora as jlora
from valle2_tpu.config import ConfigValle as JConfig
from valle2_tpu.models import ar as jar
from valle2_tpu.models import nar as jnar
from valle2_tpu.models.convert import export_ar_state_dict, export_nar_state_dict
from valle2_tpu.train import init_state as j_init_state
from valle2_tpu.train import make_train_step as j_make_train_step
from valle2_tpu_torch import lora
from valle2_tpu_torch import train as ttrain
from valle2_tpu_torch.config import ConfigValle
from valle2_tpu_torch.models import ValleAR
from valle2_tpu_torch.models import ar as tar
from valle2_tpu_torch.models import nar as tnar
from valle2_tpu_torch.models.convert import load_ar_state_dict, load_nar_state_dict

LORA = dict(SMALL, batch_size=2, bucket_sizes=(16, 32, 64, 128), lora_rank=4, lora_alpha=8.0,
            max_audio_len=8, num_beams=1)
MERGE_ATOL = 1e-6         # w + scale * A @ B in float32, the same products in another order


def leaves(tree, prefix=''):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f'{prefix}/{k}')
    else:
        yield prefix, tree


def assert_trees_equal(a, b):
    da, db = dict(leaves(a)), dict(leaves(b))
    assert sorted(da) == sorted(db)
    for k in da:
        assert torch.equal(da[k].detach(), db[k].detach()), k


def assert_leaves_close(got: dict, want):
    """Per leaf (``got`` flat, keyed by path): float32 sums in another
    order, relative to the leaf's scale."""
    want = dict(leaves(want))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        close(got[k], w, atol=1e-5 * max(1.0, float(np.abs(w).max())), rtol=1e-4)


def ar_batch(seed):
    rs = np.random.RandomState(seed)
    return {'tokens': rs.randint(0, 256, (2, 6)).astype(np.int32),
            'tokens_lens': np.asarray([6, 4], np.int32),
            'codes': rs.randint(0, 1026, (2, 10)).astype(np.int32),
            'codes_lens': np.asarray([10, 7], np.int32),
            'target': rs.randint(0, 1025, (2, 10)).astype(np.int32)}


def to_t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope='module')
def bases():
    """JAX AR and NAR params and their port copies."""
    jcfg = JConfig(**LORA)
    jp = {'ar': jar.init_params(jax.random.key(0), jcfg),
          'nar': jnar.init_params(jax.random.key(1), jcfg)}
    tp = {'ar': load_ar_state_dict(export_ar_state_dict(jp['ar'])),
          'nar': load_nar_state_dict(export_nar_state_dict(jp['nar']))}
    return jp, tp


def jax_adapters(jparams, rank=4, targets=lora.DEFAULT_TARGETS, shift=0.1):
    """JAX ``lora_init`` adapters with B made nonzero (every leaf + shift)."""
    ad = jlora.lora_init(jax.random.key(2), jparams, rank, targets=targets)
    return jax.tree.map(lambda x: x + shift, ad)


@pytest.mark.parametrize('model', ['ar', 'nar'])
def test_merge_lora_matches_jax_on_the_same_adapters(bases, model):
    jp, tp = bases
    jad = jax_adapters(jp[model], targets=('qkv', 'out', 'lin1', 'lin2', 'proj'))
    want = jlora.merge_lora(jp[model], jad, 2.0)
    got = lora.merge_lora(tp[model], to_torch(to_np(jad)), 2.0)
    want = dict(leaves(to_np(want)))
    for k, v in leaves(got):
        close(v, want[k], atol=MERGE_ATOL)
    # Non-target leaves are shared, not copied.
    assert got['tokens_emb']['emb'] is tp[model]['tokens_emb']['emb']
    assert got['transformer']['attn']['out']['b'] is tp[model]['transformer']['attn']['out']['b']


def test_attach_starts_exactly_at_the_base(bases):
    _, tp = bases
    cfg = ConfigValle(**LORA)
    state = lora.attach(tp['ar'], cfg, torch.Generator().manual_seed(1))
    assert lora.is_lora_state(state)
    merged = lora.merged(state, cfg)
    assert_trees_equal(merged, tp['ar'])              # B = 0: bit-identical
    batch = to_t(ar_batch(1))
    assert float(tar.loss_fn(merged, cfg, batch)[0]) == float(tar.loss_fn(tp['ar'], cfg, batch)[0])
    assert lora.merged(tp['ar'], cfg) is tp['ar']     # not a fine-tune state: passthrough


def test_merge_touches_only_target_weights(bases):
    _, tp = bases
    ad = lora.lora_init(torch.Generator().manual_seed(1), tp['ar'], 2, targets=('qkv',))
    ad = {'transformer': {'attn': {'qkv': {k: v + 0.1 for k, v in
                                           ad['transformer']['attn']['qkv'].items()}}}}
    merged = lora.merge_lora(tp['ar'], ad, 2.0)
    for k, v in leaves(merged):
        base = dict(leaves(tp['ar']))[k]
        if k == '/transformer/attn/qkv/w':
            a, b = ad['transformer']['attn']['qkv'].values()
            close(v, base + 2.0 * (a @ b), atol=MERGE_ATOL)
            assert not torch.equal(v, base)
        else:
            assert v is base, k


@pytest.mark.parametrize('targets', [lora.DEFAULT_TARGETS, ('qkv', 'proj')],
                         ids=['default', 'qkv_proj'])
@pytest.mark.parametrize('model', ['ar', 'nar'])
def test_init_targets_and_shapes_match_jax_and_a_lies_within_its_bound(bases, model, targets):
    jp, tp = bases
    want = {k: v.shape for k, v in leaves(jlora.lora_init(jax.random.key(0), jp[model], 3,
                                                          targets=targets))}
    got = lora.lora_init(torch.Generator().manual_seed(0), tp[model], 3, targets=targets)
    assert {k: tuple(v.shape) for k, v in leaves(got)} == want
    base = dict(leaves(tp[model]))
    for k, v in leaves(got):
        w = base[k.rsplit('/', 1)[0] + '/w']
        assert v.dtype == w.dtype and v.device == w.device
        if k.endswith('lora_b'):
            assert not v.any()
        else:
            bound = 1.0 / np.sqrt(w.shape[-2])
            assert float(v.abs().max()) <= bound and float(v.std()) > bound / 4
    assert lora.adapter_count(got) == sum(int(np.prod(s)) for s in want.values())
    with pytest.raises(ValueError):
        lora.lora_init(torch.Generator(), tp[model], 3, targets=('nope',))
    with pytest.raises(ValueError):
        lora.lora_init(torch.Generator(), tp[model], 0)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_adapter_files_cross_between_the_packages(bases, tmp_path, dtype):
    """A file JAX wrote loads in the port and one the port wrote loads in
    JAX: the trees and the scale equal both ways (a bf16 tree JAX wrote
    loads as bf16; the port writes bf16 leaves widened to float32, exact)."""
    jp, _ = bases
    jad = jax.tree.map(lambda x: x.astype(dtype), jax_adapters(jp['ar']))
    jlora.save_adapters(tmp_path / 'j.npz', {'ar': jad}, scale=2.5)
    tree, scale = lora.load_adapters_with_scale(tmp_path / 'j.npz')
    assert scale == 2.5
    want = dict(leaves({'ar': to_np(jax.tree.map(lambda x: x.astype(jnp.float32), jad))}))
    got = dict(leaves(tree))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(v.float().numpy(), want[k])

    lora.save_adapters(tmp_path / 't.npz', tree, scale=0.75)
    back, jscale = jlora.load_adapters_with_scale(tmp_path / 't.npz')
    assert jscale == 0.75
    for k, v in leaves(to_np(back)):
        np.testing.assert_array_equal(v.astype(np.float32), want[k])
    assert lora.load_adapters(tmp_path / 't.npz').keys() == {'ar'}
    lora.save_adapters(tmp_path / 'noscale.npz', tree)
    assert lora.load_adapters_with_scale(tmp_path / 'noscale.npz')[1] is None


@pytest.fixture(scope='module')
def jax_lora_step(bases):
    """One JAX LoRA train step (init_state + make_train_step) over the
    shared AR base: (the state before, after, metrics, the adapter grads)."""
    jp, _ = bases
    jcfg = JConfig(**dict(LORA, lr=3e-3, gradient_clip_val=100.0))
    # The step donates its state: it gets copies, never the shared base.
    state = j_init_state(jcfg, 'ValleAR', jax.random.key(0),
                         base_params=jax.tree.map(jnp.array, jp['ar']))
    lora0 = jax.tree.map(lambda x: x + 0.05, state.params['lora'])   # nonzero B
    state = state._replace(params={'base': state.params['base'], 'lora': lora0})
    batch = to_j(ar_batch(3))
    scale = jlora.lora_scale(jcfg)
    grads = jax.jit(jax.grad(lambda l: jar.loss_fn(
        jlora.merge_lora(jp['ar'], l, scale), jcfg, batch, None)[0]))(lora0)
    before = to_np(lora0)
    after, metrics = j_make_train_step(jcfg, 'ValleAR')(state, batch, jax.random.key(1))
    return before, to_np(after.params['lora']), to_np(metrics), to_np(grads)


def port_lora_state(tp, lora0, **over):
    cfg = ConfigValle(**dict(LORA, lr=3e-3, gradient_clip_val=100.0, **over))
    state = ttrain.init_state(cfg, 'ValleAR', base_params=tp['ar'], device='cpu')
    with torch.no_grad():
        want = dict(leaves(lora0))
        for k, p in leaves(state.params['lora']):
            p.copy_(torch.from_numpy(np.array(want[k])))
    return cfg, state


def test_lora_train_step_grads_and_update_match_jax(bases, jax_lora_step):
    """The adapter grads of the port's merged forward == jax.grad of JAX's
    LoRA loss on the same base and adapters; one port train step's loss,
    grad norm and adapters == JAX make_train_step's; the base is untouched."""
    _, tp = bases
    lora0, lora1, jm, jgrads = jax_lora_step
    cfg, state = port_lora_state(tp, lora0)
    batch = to_t(ar_batch(3))
    paths, tensors = zip(*leaves(state.params['lora']))
    loss, _ = tar.loss_fn(lora.merged(state.params, cfg), cfg, batch)
    grads = torch.autograd.grad(loss, tensors)
    assert_leaves_close(dict(zip(paths, grads)), jgrads)
    state, m = ttrain.make_train_step(cfg, 'ValleAR')(state, batch, 0)
    close(m['loss'], jm['loss'], atol=1e-5)
    close(m['grad_norm'], jm['grad_norm'], atol=1e-5, rtol=1e-5)
    assert_leaves_close(dict(leaves(state.params['lora'])), lora1)
    assert_trees_equal(state.params['base'], tp['ar'])


@pytest.mark.parametrize('model', ['ValleAR', 'ValleNAR'])
def test_base_unchanged_bit_for_bit_after_three_steps_and_adapters_move(bases, model):
    _, tp = bases
    cfg = ConfigValle(**dict(LORA, lr=3e-3))
    base = tp['ar' if model == 'ValleAR' else 'nar']
    state = ttrain.init_state(cfg, model, base_params=base, device='cpu')
    assert not any(p.requires_grad for _, p in leaves(state.params['base']))
    assert state.opt_state.leaves == [p for _, p in leaves(state.params['lora'])]
    lora0 = {k: v.detach().clone() for k, v in leaves(state.params['lora'])}
    step = ttrain.make_train_step(cfg, model)
    rs = np.random.RandomState(5)
    for _ in range(3):
        if model == 'ValleAR':
            batch = ar_batch(rs.randint(1000))
        else:
            batch = {'tokens': rs.randint(0, 256, (2, 5)).astype(np.int32),
                     'tokens_lens': np.asarray([5, 3], np.int32),
                     'codes': rs.randint(0, 1024, (2, 12, 8)).astype(np.int32),
                     'codes_lens': np.asarray([12, 8], np.int32)}
        state, m = step(state, to_t(batch), 0)
        assert np.isfinite(float(m['loss']))
    assert_trees_equal(state.params['base'], base)
    assert all(not torch.equal(v, lora0[k]) for k, v in leaves(state.params['lora'])
               if k.endswith('lora_b'))


def test_eval_step_merges(bases):
    _, tp = bases
    cfg = ConfigValle(**LORA)
    state = ttrain.init_state(cfg, 'ValleAR', base_params=tp['ar'], device='cpu')
    with torch.no_grad():
        for _, p in leaves(state.params['lora']):
            p.add_(0.05)
    batch = to_t(ar_batch(4))
    got = float(ttrain.make_eval_step(cfg, 'ValleAR')(state.params, batch, None)['loss'])
    with torch.no_grad():
        want = float(tar.loss_fn(lora.merged(state.params, cfg), cfg, batch)[0])
    assert got == want and want != float(tar.loss_fn(tp['ar'], cfg, batch)[0])
    nar_cfg = ConfigValle(**LORA)
    nstate = ttrain.init_state(nar_cfg, 'ValleNAR', base_params=tp['nar'], device='cpu')
    rs = np.random.RandomState(6)
    nbatch = to_t({'tokens': rs.randint(0, 256, (2, 5)), 'tokens_lens': np.asarray([5, 3]),
                   'codes': rs.randint(0, 1024, (2, 12, 8)), 'codes_lens': np.asarray([12, 8])})
    got = ttrain.make_eval_step(nar_cfg, 'ValleNAR')(nstate.params, nbatch,
                                                      torch.Generator().manual_seed(2))
    want = ttrain.make_eval_step(dataclasses.replace(nar_cfg, lora_rank=0), 'ValleNAR')(
        tp['nar'], nbatch, torch.Generator().manual_seed(2))
    assert float(got['loss']) == float(want['loss'])   # B = 0: the merge is the base


def tiny(tmp_path, **kw):
    from valle2_tpu_torch.data import DataLoader, SyntheticValleDataset, get_collate
    base = dict(LORA, max_steps=4, log_every_n_steps=2, ckpt_every_n_steps=2, lr=3e-3,
                ckpt_path=tmp_path / 'ckpt', log_path=tmp_path / 'logs')
    cfg = ConfigValle(**dict(base, **kw))
    ds = SyntheticValleDataset(cfg, size=6, min_frames=20, max_frames=50)
    return cfg, DataLoader(ds, cfg.batch_size, get_collate('ValleAR')(cfg), shuffle=True, seed=3)


def test_trainer_checkpoints_and_resumes_a_lora_state(tmp_path):
    """fit to 4 steps straight == fit to 2, then a resumed fit to 4: the
    checkpoint holds {'base', 'lora'} and the adapters' optimizer state."""
    cfg, loader = tiny(tmp_path / 'a')
    straight = ttrain.Trainer(cfg, 'ValleAR', device='cpu', use_tensorboard=False).fit(
        ttrain.init_state(cfg, 'ValleAR', device='cpu'), loader)
    cfg2, loader2 = tiny(tmp_path / 'b', max_steps=2)
    ttrain.Trainer(cfg2, 'ValleAR', device='cpu', use_tensorboard=False).fit(
        ttrain.init_state(cfg2, 'ValleAR', device='cpu'), loader2)
    item = torch.load(tmp_path / 'b' / 'ckpt' / 'ValleAR' / 'step_2' / 'state.pt',
                      weights_only=True)
    assert lora.is_lora_state(item['params'])
    cfg3 = dataclasses.replace(cfg2, max_steps=4)
    resumed = ttrain.Trainer(cfg3, 'ValleAR', device='cpu', use_tensorboard=False).fit(
        ttrain.init_state(cfg3, 'ValleAR', seed=7, device='cpu'), loader2, resume=True)
    assert resumed.step == straight.step == 4
    for (k, a), (_, b) in zip(leaves(straight.params), leaves(resumed.params)):
        assert torch.equal(a, b), k


def test_load_params_of_a_lora_trainer_dir_merges_with_the_config_and_raises_without(tmp_path):
    cfg, _ = tiny(tmp_path, lora_alpha=4.0)
    state = ttrain.init_state(cfg, 'ValleAR', device='cpu')
    with torch.no_grad():
        for _, p in leaves(state.params['lora']):
            p.add_(0.05)
    trainer = ttrain.Trainer(cfg, 'ValleAR', device='cpu', use_tensorboard=False)
    trainer.save_checkpoint(state)
    model = ValleAR(cfg, seed=3, device='cpu')
    model.load(trainer.latest_checkpoint())
    assert_trees_equal(model.params, lora.merged(state.params, cfg))
    out = model.generate(np.arange(5), np.zeros((4, 8), np.int64))
    assert out.ndim == 1 and len(out) <= cfg.max_audio_len
    plain = ValleAR(dataclasses.replace(cfg, lora_rank=0), seed=3, device='cpu')
    with pytest.raises(ValueError, match='LoRA'):
        plain.load(trainer.latest_checkpoint())


def test_lora_base_loads_the_weights_being_adapted(tmp_path):
    """A full training checkpoint as ``lora_base``: the fine-tune's base
    equals it bit for bit, and ``base_params`` wins over ``lora_base``."""
    cfg = ConfigValle(**dict(LORA, lora_rank=0, ckpt_path=tmp_path / 'ckpt',
                             log_path=tmp_path / 'logs'))
    state = ttrain.init_state(cfg, 'ValleAR', device='cpu')
    trainer = ttrain.Trainer(cfg, 'ValleAR', device='cpu', use_tensorboard=False)
    trainer.save_checkpoint(state)
    ft_cfg = dataclasses.replace(cfg, lora_rank=4, lora_base=str(trainer.latest_checkpoint()))
    ft = ttrain.init_state(ft_cfg, 'ValleAR', seed=5, device='cpu')
    assert_trees_equal(ft.params['base'], state.params)
    other = tnar.init_params(torch.Generator().manual_seed(0), cfg)
    mine = ttrain.init_state(ft_cfg, 'ValleNAR', base_params=other, device='cpu')
    assert_trees_equal(mine.params['base'], other)
