"""The grammar testbed of valle2_tpu_torch (``data/grammar.py``) against the
JAX package's: the numpy core and the datasets equal exactly on the same
seeds, ``get_dataloaders('grammar://...')`` batches equal, the greedy
evaluations equal JAX's on the same weights (carried by the state-dict
converters), ``evaluate_nll`` within 1e-4 nats, the sampled evaluations are
deterministic under a seed (their draws cannot match JAX's PRNG), and a few
``train_grammar_model`` epochs give JAX's losses at dropout 0.
Small models: d=32, 2 layers, float32 with matmul_precision='highest'.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu.config import ConfigValle as JConfig
from valle2_tpu.data import dataset as jdataset
from valle2_tpu.data import grammar as jg
from valle2_tpu.models import ar as jar
from valle2_tpu.models import nar as jnar
from valle2_tpu.models.convert import export_ar_state_dict, export_nar_state_dict
from valle2_tpu_torch.config import ConfigValle
from valle2_tpu_torch.data import dataset as tdataset
from valle2_tpu_torch.data import grammar as tg
from valle2_tpu_torch.models import ValleAR, ValleNAR
from valle2_tpu_torch.models.convert import load_ar_state_dict, load_nar_state_dict

MODEL = dict(d_model=32, n_heads=2, dim_feedforward=64, num_layers=2, vocab_size=128,
             num_audio_tokens=256, dropout=0.0, temperature=0.0, num_beams=1,
             max_audio_len=12, bucket_sizes=(32, 64, 96, 128), kv_cache_dtype='float32',
             matmul_precision='highest', norm='LayerNorm', seed=3)
NLL_ATOL = 1e-4      # nats per phoneme / token: f32 sums in another order


def same(got, want, where=''):
    """Deep equality of numpy / python results, dtypes of arrays included."""
    if dataclasses.is_dataclass(want):
        assert dataclasses.asdict(got) == dataclasses.asdict(want), where
    elif isinstance(want, dict):
        assert sorted(map(str, got)) == sorted(map(str, want)), where
        for k in want:
            same(got[k], want[k], f'{where}/{k}')
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f'{where}[{i}]')
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


def _items(ds, epochs=(0,)):
    out = []
    for e in epochs:
        ds.set_epoch(e)
        out.append([ds[i] for i in range(len(ds))])
    return out


def _tok(m):
    return m.PhonemeTokenizer(use_g2p=False)


# case -> fn(grammar module, tokenizer) -> a result compared between packages
NUMPY_CASES = {
    'all_sentences': lambda m, tok: m.all_sentences(),
    'split_seed0': lambda m, tok: m.split_sentences(),
    'split_seed5_holdout0.2': lambda m, tok: m.split_sentences(5, 0.2),
    'multispeaker_spec': lambda m, tok: m.multispeaker_spec(4, num_audio_tokens=512),
    'ambiguous_spec': lambda m, tok: m.ambiguous_spec(3, 2),
    'speaker_offset': lambda m, tok: [m.speaker_offset(m.multispeaker_spec(4), s)
                                      for s in range(4)],
    'synthesize_codes_v1': lambda m, tok: m.synthesize_codes(tok('the big dog ran.'),
                                                             m.GrammarSpec()),
    'synthesize_codes_speaker3': lambda m, tok: m.synthesize_codes(
        tok('the old cat fell.'), m.multispeaker_spec(4), speaker=3),
    'variant_probs_entropy': lambda m, tok: [
        (m.variant_probs(s), m.variant_entropy(s)) for s in (
            m.ambiguous_spec(1, 3), m.ambiguous_spec(1, 2),
            m.GrammarSpec(num_variants=3, variant_weights=(1.0, 2.0, 5.0)))],
    'variant_duration_motif': lambda m, tok: [
        (m.variant_duration(m.ambiguous_spec(2, 3), t, k),
         m.variant_motif(m.ambiguous_spec(2, 3), t, k, 1))
        for t in (0, 7, 40) for k in range(3)],
    'sample_variants': lambda m, tok: m.sample_variants(
        tok('the lazy bird spoke.'), m.ambiguous_spec(1, 3), np.random.RandomState(4)),
    'realize_codes': lambda m, tok: m.realize_codes(
        tok('the new road stood.'), np.arange(len(tok('the new road stood.'))) % 3,
        m.ambiguous_spec(3, 3), 2),
    'sample_realization_info': lambda m, tok: [
        (c, v, m.realization_info_nats(v, m.ambiguous_spec(2, 3)))
        for c, v in [m.sample_realization(tok('the good star played.'),
                                          m.ambiguous_spec(2, 3), 1,
                                          np.random.RandomState(9))]],
    'parse_codes0': lambda m, tok: [
        m.parse_codes0(c0, tok('the small tree jumped.'), m.ambiguous_spec(2, 3), spk)
        for c0 in _parse_inputs(m, tok) for spk in (0, 1)],
    'parse_grammar_dataset': lambda m, tok: [
        m.parse_grammar_dataset(n) for n in (
            'grammar', 'grammar://speakers=4,pairs=300,holdout=0.2,seed=3',
            'grammar://variants=3,real=0')],
    'build_grammar_datasets': lambda m, tok: [
        (spec, a.items, b.items) for a, b, spec in [
            m.build_grammar_datasets(_config(m, 'grammar://speakers=2,pairs=6,seed=2'))]],
    'dataset_pairs_speakers': lambda m, tok: _items(m.GrammarDataset(
        m.split_sentences()[1], m.multispeaker_spec(3), tok, n_pairs=5, pair_seed=4,
        speakers=(0, 2))),
    'dataset_realizations': lambda m, tok: _items(m.GrammarDataset(
        m.split_sentences()[1][:6], m.ambiguous_spec(2, 3), tok, realizations=2,
        realize_seed=8)),
    'dataset_dynamic_epochs': lambda m, tok: _items(m.GrammarDataset(
        m.split_sentences()[1][:6], m.ambiguous_spec(2, 3), tok, realizations=0,
        realize_seed=8), epochs=(0, 1, 0, 5)),
}


def _parse_inputs(m, tok):
    """A valid rendering, one with a corrupted symbol, one cut short and one
    with a trailing symbol, in speaker 1's voice."""
    spec = m.ambiguous_spec(2, 3)
    codes, _ = m.sample_realization(tok('the small tree jumped.'), spec, 1,
                                    np.random.RandomState(2))
    c0 = codes[0]
    bad = c0.copy()
    bad[5] = (bad[5] + 1) % spec.num_audio_tokens
    return [c0, bad, c0[:-2], np.concatenate([c0, c0[:1]])]


def _config(m, dataset):
    cfg = JConfig if m is jg else ConfigValle
    return cfg(**dict(MODEL, dataset=dataset))


@pytest.mark.parametrize('case', sorted(NUMPY_CASES))
def test_numpy_core_equals_jax(case):
    fn = NUMPY_CASES[case]
    same(fn(tg, _tok(tg)), fn(jg, _tok(jg)), case)


def test_unknown_option_and_bad_speaker_raise_alike():
    for m in (tg, jg):
        with pytest.raises(ValueError, match='unknown grammar dataset option'):
            m.parse_grammar_dataset('grammar://v3')
        with pytest.raises(ValueError, match='out of range'):
            m.speaker_offset(m.multispeaker_spec(2), 2)
        with pytest.raises(ValueError, match='exceeds the code vocabulary'):
            m.build_grammar_datasets(_config(m, 'grammar://variants=3').__class__(
                **dict(MODEL, dataset='grammar://variants=3', num_audio_tokens=128)))


@pytest.mark.parametrize('dataset,model', [
    ('grammar://speakers=2,pairs=8', 'ValleAR'), ('grammar://speakers=2,pairs=8', 'ValleNAR'),
    ('grammar://speakers=2,pairs=8', 'ValleASR'), ('grammar://variants=3,real=0,pairs=4',
                                                   'ValleAR')])
def test_get_dataloaders_grammar_batches_equal_jax(dataset, model):
    """Two shuffled epochs of the train loader and the valid loader, batch
    for batch and key for key (dynamic realizations follow the epoch)."""
    kw = dict(MODEL, dataset=dataset, batch_size=16, valid_batch_size=16,
              direction='asr' if model == 'ValleASR' else 'tts')
    got = tdataset.get_dataloaders(model, ConfigValle(**kw))
    want = jdataset.get_dataloaders(model, JConfig(**kw))
    for tl, jl in zip(got, want):
        for _ in range(2):
            g, w = list(tl), list(jl)
            assert len(g) == len(w) > 0
            same(g, w, f'{dataset} {model}')


# --- the evaluations on the same weights ----------------------------------

@pytest.fixture(scope='module')
def models():
    """(JAX models, port models on the CPU) -- AR TTS, NAR and ASR of one
    seeded JAX init each -- with the v2 (4 speakers) and v3 (2 speakers x 3
    variants) specs and the train / held-out sentences."""
    jcfg = JConfig(**MODEL)
    cfgs = {'ar': jcfg, 'nar': dataclasses.replace(jcfg, norm='AdaptiveLayerNorm'),
            'asr': dataclasses.replace(jcfg, direction='asr')}
    jp = {'ar': jar.init_params(jax.random.key(0), cfgs['ar']),
          'nar': jnar.init_params(jax.random.key(1), cfgs['nar']),
          'asr': jar.init_params(jax.random.key(2), cfgs['asr'])}
    jm = (jar.ValleAR(cfgs['ar'], params=jp['ar']),
          jnar.ValleNAR(cfgs['nar'], params=jp['nar']),
          jar.ValleAR(cfgs['asr'], params=jp['asr']))
    tcfgs = {k: ConfigValle(**dataclasses.asdict(c)) for k, c in cfgs.items()}
    tm = (ValleAR(tcfgs['ar'], params=load_ar_state_dict(export_ar_state_dict(jp['ar'])),
                  device='cpu'),
          ValleNAR(tcfgs['nar'], params=load_nar_state_dict(export_nar_state_dict(jp['nar'])),
                   device='cpu'),
          ValleAR(tcfgs['asr'], params=load_ar_state_dict(export_ar_state_dict(jp['asr'])),
                  device='cpu'))
    train_s, held_s = jg.split_sentences()
    return dict(jax=jm, port=tm, train=train_s, held=held_s[:3],
                v2=jg.multispeaker_spec(4), v3=jg.ambiguous_spec(2, 3))


# name -> fn(grammar module, (ar, nar, asr), fixture) -> result
GREEDY_EVALS = {
    'closed_loop_prompted_speaker2': lambda m, ms, f: m.evaluate_closed_loop(
        *ms, f['held'], f['v2'], _tok(m), prompt_text=f['train'][0], speaker=2),
    'prompt_conditioning': lambda m, ms, f: m.evaluate_prompt_conditioning(
        ms[0], f['held'], f['v2'], _tok(m), prompt_text=f['train'][1], speakers=(0, 3)),
    'prompt_conditioning_v3': lambda m, ms, f: m.evaluate_prompt_conditioning_v3(
        ms[0], f['held'], f['v3'], _tok(m), prompt_text=f['train'][0]),
    'closed_loop_v3_greedy': lambda m, ms, f: m.evaluate_closed_loop_v3(
        *ms, f['held'], f['v3'], _tok(m), prompt_text=f['train'][0], speaker=1),
    'nar_refinement': lambda m, ms, f: m.evaluate_nar_refinement(
        ms[1], f['held'], f['v3'], _tok(m), prompt_text=f['train'][0],
        corrupt=(0.0, 0.3)),
    'temperature_curve_greedy': lambda m, ms, f: m.evaluate_temperature_curve(
        ms[0].params, ms[0].config, f['held'], f['v3'], _tok(m),
        prompt_text=f['train'][0], temperatures=(0.0,)),
    'best_of_n_greedy_beams': lambda m, ms, f: m.evaluate_best_of_n(
        ms[0].params, ms[0].config, f['held'], f['v2'], _tok(m),
        prompt_text=f['train'][0], temperature=0.0, beams=(1, 2)),
}


@pytest.mark.parametrize('name', sorted(GREEDY_EVALS))
def test_greedy_evaluations_equal_jax(models, name):
    fn = GREEDY_EVALS[name]
    same(fn(tg, models['port'], models), fn(jg, models['jax'], models), name)


def test_evaluate_nll_within_tolerance_of_jax(models):
    args = dict(sentences=models['held'], spec=models['v3'], prompt_text=models['train'][0],
                speaker=1, realizations=2, seed=4)
    jm, tm = models['jax'][0], models['port'][0]
    want = jg.evaluate_nll(jm.params, jm.config, tokenizer=_tok(jg), **args)
    got = tg.evaluate_nll(tm.params, tm.config, tokenizer=_tok(tg), **args)
    assert got['n_rows'] == want['n_rows'] == 6
    assert got['floor_per_phoneme'] == want['floor_per_phoneme']
    for k in ('nll_per_phoneme', 'nll_per_token', 'excess_nats_per_phoneme'):
        np.testing.assert_allclose(got[k], want[k], atol=NLL_ATOL, rtol=0, err_msg=k)


def test_greedy_chunked_decode_equals_one_batch(models):
    """``_generate_chunked``: a row's greedy output does not depend on the
    chunk it lands in (per-length masking)."""
    ar = models['port'][0]
    tok = _tok(tg)
    pcodes = tg.synthesize_codes(tok(models['train'][0] + ' '), models['v2']).T
    tokens = [np.concatenate([tok(models['train'][0] + ' '), tok(s)])
              for s in models['held']]
    whole = tg._generate_chunked(ar, tokens, [pcodes] * 3)
    for rows in (1, 2):
        parts = tg._generate_chunked(ar, tokens, [pcodes] * 3, max_rows=rows)
        assert all(torch.equal(a, b) for a, b in zip(whole, parts))


SAMPLED_EVALS = {
    'temperature_curve': lambda ms, f, seed: tg.evaluate_temperature_curve(
        ms[0].params, ms[0].config, f['held'], f['v3'], prompt_text=f['train'][0],
        temperatures=(0.7, 1.3), n_samples=2, seed=seed),
    'best_of_n_validity': lambda ms, f, seed: tg.evaluate_best_of_n_validity(
        ms[0].params, ms[0].config, f['held'], f['v3'], prompt_text=f['train'][0],
        temperature=1.0, beams=(1, 3), seed=seed),
    'best_of_n_sampled': lambda ms, f, seed: tg.evaluate_best_of_n(
        ms[0].params, ms[0].config, f['held'], f['v2'], prompt_text=f['train'][0],
        temperature=0.7, beams=(1, 4), seed=seed),
    'closed_loop_v3_sampled': lambda ms, f, seed: tg.evaluate_closed_loop_v3(
        *ms, f['held'], f['v3'], prompt_text=f['train'][0], temperature=1.0, seed=seed),
}


@pytest.mark.parametrize('name', sorted(SAMPLED_EVALS))
def test_sampled_evaluations_are_deterministic_under_a_seed(models, name):
    """The same seed gives the same result twice; the sampled decodes run
    (their samples cannot be JAX's: ``torch.Generator`` draws)."""
    fn = SAMPLED_EVALS[name]
    first = fn(models['port'], models, 5)
    same(fn(models['port'], models, 5), first, name)


def test_sampled_decode_draws_follow_the_seed(models):
    """Chunk ci of a sampled ``_generate_chunked`` draws from (seed, ci):
    two seeds give different samples, one seed the same."""
    ar = models['port'][0]
    model = ValleAR(dataclasses.replace(ar.config, temperature=1.5, top_k=256),
                    params=ar.params, device='cpu')
    tokens = [_tok(tg)(s) for s in models['held']]
    empty = [np.zeros((0, 8), np.int32)] * 3
    a = tg._generate_chunked(model, tokens, empty, seed=1)
    b = tg._generate_chunked(model, tokens, empty, seed=1)
    c = tg._generate_chunked(model, tokens, empty, seed=2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, c))


def test_train_grammar_model_losses_equal_jax():
    """Two epochs of ``train_grammar_model`` (AR) from the same JAX-init
    weights (dropout 0): per-epoch train and valid losses == the JAX
    package's."""
    model = 'ValleAR'
    kw = dict(MODEL, batch_size=4)
    jcfg, cfg = JConfig(**kw), ConfigValle(**kw)
    train_s, held_s = jg.split_sentences()
    spec = jg.multispeaker_spec(2)
    jtrain = jg.GrammarDataset(train_s[:6], spec, _tok(jg))
    jheld = jg.GrammarDataset(held_s[:3], spec, _tok(jg))
    ttrain = tg.GrammarDataset(train_s[:6], spec, _tok(tg))
    theld = tg.GrammarDataset(held_s[:3], spec, _tok(tg))
    jp = jar.init_params(jax.random.key(4), jcfg)
    tp = load_ar_state_dict(export_ar_state_dict(jp))     # before JAX's step donates jp
    _, want = jg.train_grammar_model(model, jcfg, jtrain, jheld, max_epochs=2,
                                     loss_target=0.0, base_params=jp)
    _, got = tg.train_grammar_model(model, cfg, ttrain, theld, max_epochs=2, loss_target=0.0,
                                    base_params=tp, device='cpu')
    assert len(got['train_loss']) == len(want['train_loss']) == 2
    for k in ('train_loss', 'valid_loss'):
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)


def test_train_grammar_model_nar_and_lora_run(models):
    """The NAR (its stage drawn from the step's generator) trains; a LoRA
    fine-tune from ``base_params`` returns the {'base', 'lora'} state with
    the base unchanged."""
    tok = _tok(tg)
    spec = tg.multispeaker_spec(2)
    ds = tg.GrammarDataset(models['train'][:6], spec, tok)
    nar_cfg = ConfigValle(**dict(MODEL, norm='AdaptiveLayerNorm', batch_size=4))
    _, curves = tg.train_grammar_model('ValleNAR', nar_cfg, ds, max_epochs=2,
                                       loss_target=0.0, device='cpu')
    assert len(curves['train_loss']) == 2 and all(np.isfinite(curves['train_loss']))
    base = models['port'][0].params
    lora_cfg = ConfigValle(**dict(MODEL, batch_size=4, lora_rank=2))
    params, _ = tg.train_grammar_model('ValleAR', lora_cfg, ds, max_epochs=1,
                                       base_params=base, device='cpu')
    assert set(params) == {'base', 'lora'}
    assert torch.equal(params['base']['proj']['w'], base['proj']['w'])
