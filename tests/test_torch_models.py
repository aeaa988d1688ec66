"""valle2_tpu_torch.models against valle2_tpu.models on the same weights,
carried across by the state-dict converters: greedy AR token IDs equal to the
JAX ``_decode_fn``, batched == solo per item, NAR greedy codes equal to the
JAX ``_generate_fn``.  Small config, float32."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import SMALL, close
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu.config import ConfigValle as JConfig
from valle2_tpu.models import ar as jar
from valle2_tpu.models import nar as jnar
from valle2_tpu.models.convert import export_ar_state_dict, export_nar_state_dict
from valle2_tpu_torch.config import _NOT_YET as NOT_YET
from valle2_tpu_torch.config import ConfigValle
from valle2_tpu_torch.models import ar as tar
from valle2_tpu_torch.models import nar as tnar
from valle2_tpu_torch.models.convert import load_ar_state_dict, load_nar_state_dict

GEN = dict(SMALL, max_audio_len=8, num_beams=2, temperature=0.0)
EXAMPLES = Path(__file__).resolve().parents[1] / 'examples'


@pytest.fixture(scope='module')
def ar_weights():
    cfg = JConfig(**GEN)
    jp = jar.init_params(jax.random.key(0), cfg)
    return jp, load_ar_state_dict(export_ar_state_dict(jp))


@pytest.fixture(scope='module')
def nar_weights():
    cfg = JConfig(**GEN)
    jp = jnar.init_params(jax.random.key(1), cfg)
    return jp, load_nar_state_dict(export_nar_state_dict(jp))


def leaves(tree, prefix=''):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f'{prefix}/{k}')
    else:
        yield prefix, tree


@pytest.mark.parametrize('model', ['ar', 'nar'])
def test_weights_carried_across_exactly(model, ar_weights, nar_weights):
    jp, tp = ar_weights if model == 'ar' else nar_weights
    want = dict(leaves(jp))
    got = dict(leaves(tp))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def decode_inputs(seed=7):
    """Two items of different lengths, padded: tokens (2, 9), BOS-prefixed
    first-codebook prompts (2, 6)."""
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, 256, (2, 9)).astype(np.int32)
    tl = np.asarray([9, 5], np.int32)
    codes = rs.randint(0, 1024, (2, 6)).astype(np.int32)
    codes[:, 0] = 1025                                         # BOS
    cl = np.asarray([6, 3], np.int32)
    return tokens, tl, codes, cl


ROUTES = {
    'dense': dict(use_flash_attention=False, use_fused_decode=False),
    # the flash prefill route and the fused cache layout / decode-step route,
    # taken on the CPU by their plain versions
    'kernel_routes': dict(use_flash_attention=True, use_fused_decode=True),
    # the config default: a bfloat16 KV cache under a float32 model
    'bf16_cache': dict(kv_cache_dtype='bfloat16'),
}


@pytest.mark.parametrize('route', sorted(ROUTES))
def test_ar_greedy_tokens_equal_jax_decode_fn(route, ar_weights):
    jp, tp = ar_weights
    tokens, tl, codes, cl = decode_inputs()
    gen = dict(GEN, **{k: v for k, v in ROUTES[route].items() if k == 'kv_cache_dtype'})
    jcfg = JConfig(**gen)
    want_codes, want_lp, want_best = jax.jit(
        lambda p, *a: jar._decode_fn(p, *a, jax.random.key(0), jcfg))(
        jp, *(jnp.asarray(a) for a in (tokens, tl, codes, cl)))
    tcfg = ConfigValle(**dict(GEN, **ROUTES[route]))
    with torch.inference_mode():
        got_codes, got_lp, got_best = tar._decode_fn(
            tp, *(torch.from_numpy(a).long() for a in (tokens, tl, codes, cl)), tcfg)
    np.testing.assert_array_equal(got_codes.numpy(), np.asarray(want_codes))
    np.testing.assert_array_equal(got_best.numpy(), np.asarray(want_best))
    close(got_lp, want_lp, atol=1e-4)


def test_ar_batched_equals_solo(ar_weights):
    _, tp = ar_weights
    cfg = ConfigValle(**dict(GEN, max_audio_len=6, ignore_eos=False))
    model = tar.ValleAR(cfg, params=tp, device='cpu')
    rs = np.random.RandomState(3)
    items = [(rs.randint(0, 256, (n,)), rs.randint(0, 1024, (m, 8)))
             for n, m in ((7, 4), (3, 9), (11, 2))]
    batched = model.generate_batch([t for t, _ in items], [c for _, c in items])
    for (tok, cod), got in zip(items, batched):
        solo = model.generate(tok, cod)
        np.testing.assert_array_equal(got.numpy(), solo.numpy())


def test_nar_greedy_codes_equal_jax_generate_fn(nar_weights):
    jp, tp = nar_weights
    rs = np.random.RandomState(4)
    b, ttm, pm, nm = 2, 8, 5, 7
    tokens = rs.randint(0, 256, (b, ttm)).astype(np.int32)
    tl = np.asarray([8, 6], np.int32)
    pcodes = rs.randint(0, 1024, (b, pm, 8)).astype(np.int32)
    pl = np.asarray([5, 3], np.int32)
    first = rs.randint(0, 1024, (b, nm)).astype(np.int32)
    gl = np.asarray([7, 4], np.int32)
    jcfg = JConfig(**GEN)
    want = jax.jit(lambda p, *a: jnar._generate_fn(p, *a, jax.random.key(0), jcfg))(
        jp, *(jnp.asarray(a) for a in (tokens, tl, pcodes, pl, first, gl)))
    with torch.inference_mode():
        got = tnar._generate_fn(tp, *(torch.from_numpy(a).long()
                                      for a in (tokens, tl, pcodes, pl, first, gl)),
                                ConfigValle(**GEN))
    want = np.asarray(want)
    for i in range(b):      # rows past gen_len are don't-care in both packages
        np.testing.assert_array_equal(got[i, :gl[i]].numpy(), want[i, :gl[i]])


def test_nar_generate_wrapper_matches_batched_fn(nar_weights):
    _, tp = nar_weights
    cfg = ConfigValle(**GEN)
    model = tnar.ValleNAR(cfg, params=tp, device='cpu')
    rs = np.random.RandomState(5)
    tok, tgt = rs.randint(0, 256, (6,)), rs.randint(0, 256, (3,))
    pc, first = rs.randint(0, 1024, (5, 8)), rs.randint(0, 1024, (7,))
    unbucketed = model.generate(tok, pc, tgt, first, bucket=False)
    bucketed = model.generate(tok, pc, tgt, first)
    assert unbucketed.shape == (7, 8)
    np.testing.assert_array_equal(unbucketed.numpy(), bucketed.numpy())
    np.testing.assert_array_equal(unbucketed[:, 0].numpy(), first)


@pytest.mark.parametrize('example', sorted(p.name for p in EXAMPLES.glob('train_*.json')))
def test_example_configs_load_alike(example):
    """Every example config loads into both packages with equal fields, or
    the port refuses it for a feature it has not ported yet."""
    want = dataclasses.asdict(JConfig.from_json(EXAMPLES / example))
    unported = [f for f, default, _ in NOT_YET if want[f] != default]
    if unported:
        with pytest.raises(NotImplementedError, match='ROADMAP.md'):
            ConfigValle.from_json(EXAMPLES / example)
        return
    got = dataclasses.asdict(ConfigValle.from_json(EXAMPLES / example))
    assert {k: str(v) for k, v in got.items()} == {k: str(v) for k, v in want.items()}


def test_unported_features_raise_naming_the_roadmap_item():
    for field, value in (('decode_attn_buckets', 2), ('mesh_ctx', 2)):
        with pytest.raises(NotImplementedError, match='ROADMAP.md'):
            ConfigValle(**{field: value})
    ConfigValle(zero1=True, mesh_model=2)              # ported with the data axis
    ConfigValle(mesh_pipe=2, pp_microbatches=4, pp_schedule='1f1b')   # ported: PP
    ConfigValle(decode_unroll=2, decode_chunk=128)     # ported with streaming
    ConfigValle(lora_rank=4, lora_alpha=8.0)           # ported with lora.py
    ConfigValle(remat=True)                            # ported: activation checkpointing
    cfg = dataclasses.asdict(ConfigValle())
    jfields = {f.name for f in dataclasses.fields(JConfig)}
    assert set(cfg) == jfields
    jdefault = dataclasses.asdict(JConfig())
    assert {k: str(v) for k, v in cfg.items()} == {k: str(v) for k, v in jdefault.items()}


@pytest.mark.parametrize('entry', ['ValleAR', 'ValleNAR', 'ValleTTS', 'Encodec'])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """device=None means the CUDA card; without one the entry point raises
    instead of falling back to the CPU."""
    from valle2_tpu_torch.codec.encodec import Encodec
    from valle2_tpu_torch.tts import ValleTTS
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = ConfigValle(**GEN)
    build = {'ValleAR': lambda: tar.ValleAR(cfg), 'ValleNAR': lambda: tnar.ValleNAR(cfg),
             'ValleTTS': lambda: ValleTTS(cfg), 'Encodec': lambda: Encodec()}[entry]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build()
