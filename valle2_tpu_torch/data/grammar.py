"""Synthetic compositional grammar with deterministic 'acoustics' -- the
generalization testbed (``valle2_tpu/data/grammar.py``).

The numpy core is a copy of the JAX package's: the same grammar, split,
motif algebra, v2 speakers, v3 variants and datasets, so both packages
build the same items from the same seeds.  The evaluations run the port's
models (``ValleAR.generate_batch``, ``ValleNAR.generate``, ``ar.forward``)
on their device; ``train_grammar_model`` trains through the port's
``init_state`` / ``make_train_step`` / ``make_eval_step`` on ``device``
(the CUDA card by default).

Construction:

- **Grammar**: ``the <adj> <noun> <verb>.`` over lexicon words -- |adj| x
  |noun| x |verb| compositional sentences.  A held-out split removes whole
  *combinations* while every individual word stays in training, so held-out
  success requires composition, not recall.
- **Acoustics**: each phoneme id maps to a fixed ``motif_len``-token first-
  codebook motif (affine in the id, injective mod the code vocab), and
  residual codebook q is a fixed pointwise shift of codebook 0.  The
  text->codes mapping is exactly compositional, so exact match on held-out
  sentences is a meaningful metric (v3: realization validity).
- **Closed loop**: TTS (AR tokens->codes0, NAR codes0->codes1..7) and ASR
  (codes0->tokens) train on the train split; evaluation synthesizes held-out
  sentences with the TTS stack and transcribes the *synthesized* codes with
  the ASR stack back to text.

Randomness: sampled decodes draw from ``torch.Generator``s seeded from the
evaluation's ``seed`` (the JAX package's ``jax.random.key(seed)``), so a
fixed seed gives the same result twice, but not JAX's samples.  Greedy
evaluations are functions of the weights alone and equal the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .frontend import PhonemeTokenizer

ADJECTIVES = ['good', 'old', 'new', 'big', 'small', 'quick', 'lazy', 'happy',
              'green', 'white']
NOUNS = ['dog', 'cat', 'bird', 'man', 'tree', 'house', 'road', 'river',
         'book', 'star']
VERBS = ['ran', 'fell', 'spoke', 'stood', 'played', 'jumped']


@dataclass(frozen=True)
class GrammarSpec:
    """Deterministic acoustics parameters (all mappings derive from these).

    v2 (``num_speakers`` > 1): each speaker adds a constant offset to
    codebook 0 — the same text has ``num_speakers`` distinct correct
    realizations, and the ONLY place the offset appears at inference time is
    the cloning prompt's codes.  A model that ignores ``prompt_codes``
    therefore CANNOT score: exact match requires recovering the speaker from
    the prompt (the reference's generate contract — prompt-conditioned
    continuation, valle_ar.py:92-129 — made falsifiable)."""
    num_audio_tokens: int = 256      # code vocabulary V (motifs are mod V)
    motif_len: int = 2               # codec frames per phoneme token
    stage_shift: int = 41            # codebook q = (codebook 0 + q*shift) % V
    num_quantizers: int = 8          # must match the model config's
    muls: tuple = (37, 53, 71, 89)   # motif position multipliers (mod V)
    adds: tuple = (11, 29, 43, 57)   # motif position offsets
    num_speakers: int = 1            # v2: distinct acoustic realizations
    speaker_stride: int = 29         # speaker s offset = (s * stride) % V
    # v3 (``num_variants`` > 1): each phoneme has K valid motif RENDERINGS
    # drawn from a known distribution, with per-variant durations in
    # {2, 3, 4} — the text→codes mapping becomes one-to-MANY, so exact match
    # stops being the right metric and quality machinery (temperature,
    # best-of-N, NAR refinement) gets a measurable response surface at
    # convergence.  K = 1 preserves v1/v2 exactly.
    num_variants: int = 1
    variant_weights: tuple = ()      # () => 2^(K-1-k) / (2^K - 1)


def multispeaker_spec(num_speakers: int, **kw) -> GrammarSpec:
    """A ``GrammarSpec`` whose multi-speaker acoustics keep BOTH directions
    well-defined:

    - TTS: codebook-0 motifs stay injective per speaker (``muls[0]`` coprime
      with V).
    - ASR: the within-motif difference ``(muls[1]-muls[0])·t + const`` is
      speaker-INVARIANT, and with ``muls=(37, 54)`` the difference multiplier
      17 is coprime with V=256 — so the phoneme id is recoverable from any
      speaker's codes without knowing the speaker, and transcription is a
      function (no cross-speaker collisions).

    The v1 default ``muls=(37, 53)`` has difference multiplier 16 (gcd 16
    with 256): distinct (token, speaker) pairs could collide onto one motif,
    making multi-speaker ASR ill-posed — hence the dedicated factory."""
    spec = GrammarSpec(num_speakers=num_speakers, muls=(37, 54, 71, 89), **kw)
    v = spec.num_audio_tokens
    d = (spec.muls[1] - spec.muls[0]) % v
    assert np.gcd(spec.muls[0], v) == 1 and np.gcd(d, v) == 1, \
        f'multi-speaker spec needs muls[0] and muls[1]-muls[0] coprime with {v}'
    return spec


def speaker_offset(spec: GrammarSpec, speaker: int) -> int:
    if not 0 <= speaker < max(spec.num_speakers, 1):
        raise ValueError(f'speaker {speaker} out of range '
                         f'[0, {spec.num_speakers})')
    return (speaker * spec.speaker_stride) % spec.num_audio_tokens


def all_sentences() -> list[str]:
    return [f'the {a} {n} {v}.' for a in ADJECTIVES for n in NOUNS
            for v in VERBS]


def split_sentences(seed: int = 0, holdout_frac: float = 0.1
                    ) -> tuple[list[str], list[str]]:
    """Shuffled train/held-out split of the full combination set.  Every word
    appears in many training combinations (each adjective in |N|x|V|=60, etc.),
    so a 10% holdout cannot orphan a word — asserted anyway."""
    sents = all_sentences()
    rs = np.random.RandomState(seed)
    order = rs.permutation(len(sents))
    n_hold = max(1, int(len(sents) * holdout_frac))
    held = [sents[i] for i in order[:n_hold]]
    train = [sents[i] for i in order[n_hold:]]
    train_words = set(w for s in train for w in s.rstrip('.').split())
    held_words = set(w for s in held for w in s.rstrip('.').split())
    assert held_words <= train_words, 'holdout orphaned a word'
    return train, held


def synthesize_codes(token_ids: np.ndarray, spec: GrammarSpec,
                     speaker: int = 0) -> np.ndarray:
    """Phoneme ids (Tt,) → ground-truth codes (8, Tt*motif_len) for ``speaker``.

    Codebook 0: per token t, motif [(muls[0]·t+adds[0]+o) % V, ...] with the
    per-speaker offset o = speaker·stride (0 for the v1 single-speaker case);
    muls coprime with V so distinct ids get distinct motifs per speaker.
    Codebook q: (codebook0 + q*stage_shift) % V (pointwise, stage-separable
    and speaker-transparent — the offset rides through codebook 0).
    """
    v = spec.num_audio_tokens
    muls = tuple(spec.muls)[:spec.motif_len]
    adds = tuple(spec.adds)[:spec.motif_len]
    off = speaker_offset(spec, speaker)
    t = np.asarray(token_ids, np.int64)
    code0 = np.stack([(m * t + a + off) % v for m, a in zip(muls, adds)],
                     axis=1).reshape(-1)                      # (Tt*motif,)
    q = np.arange(spec.num_quantizers)[:, None]
    return ((code0[None, :] + q * spec.stage_shift) % v).astype(np.int32)


# ---------------------------------------------------------------------------
# v3: ambiguous acoustics — K valid renderings per phoneme
# ---------------------------------------------------------------------------
#
# Construction (all deterministic given the spec):
#
# - Variant symbol p of phoneme t, variant k, speaker s:
#       (muls[p] * (K*t + k) + adds[p] + offset(s)) % V,  p in [0, dur)
#   With muls[0] odd and K*vocab <= V the FIRST symbol is injective in
#   (t, k) per speaker, so a code stream parses unambiguously against its
#   text; with muls[1]-muls[0] odd the within-motif difference recovers
#   (K*t + k) without knowing the speaker (ASR stays well-posed), and with
#   muls[2]-muls[1] odd any single corrupted symbol inside a motif of
#   duration >= 2 is recoverable from its neighbours — the redundancy the
#   NAR-refinement experiment relies on.
# - Duration of (t, k): 2 + (t*7 + k*5) % 3 in {2, 3, 4}.  For fixed t the
#   K <= 3 variants get pairwise-DISTINCT durations, so alignment is not
#   fixed.
# - Variant distribution: P(k) proportional to 2^(K-1-k) (known, non-uniform)
#   => per-phoneme entropy H(spec) nats is the analytic NLL floor a perfectly
#   calibrated model attains and no model beats.

def variant_probs(spec: GrammarSpec) -> np.ndarray:
    """Known sampling distribution over the K variants."""
    k = spec.num_variants
    if spec.variant_weights:
        w = np.asarray(spec.variant_weights, np.float64)
        assert len(w) == k and (w > 0).all()
    else:
        w = 2.0 ** np.arange(k - 1, -1, -1)
    return w / w.sum()


def variant_entropy(spec: GrammarSpec) -> float:
    """Per-phoneme entropy (nats) — the analytic held-out NLL floor."""
    p = variant_probs(spec)
    return float(-(p * np.log(p)).sum())


def variant_duration(spec: GrammarSpec, t, k):
    """Codec frames for phoneme t rendered as variant k (vectorized)."""
    return 2 + (np.asarray(t) * 7 + np.asarray(k) * 5) % 3


def variant_motif(spec: GrammarSpec, t: int, k: int, speaker: int = 0
                  ) -> np.ndarray:
    """Codebook-0 symbols (dur,) of phoneme ``t`` rendered as variant ``k``."""
    v = spec.num_audio_tokens
    off = speaker_offset(spec, speaker)
    d = int(variant_duration(spec, t, k))
    base = spec.num_variants * int(t) + int(k)
    return np.asarray([(spec.muls[p] * base + spec.adds[p] + off) % v
                       for p in range(d)], np.int32)


def ambiguous_spec(num_speakers: int = 1, num_variants: int = 3,
                   **kw) -> GrammarSpec:
    """v3 spec factory: multi-speaker-safe muls (37, 54, 71, 89) — muls[0]
    odd (parse injectivity), muls[1]-muls[0] = 17 odd (speaker-invariant
    ASR recovery), muls[2]-muls[1] = 17 odd (corruption redundancy)."""
    spec = GrammarSpec(num_speakers=num_speakers, num_variants=num_variants,
                       muls=(37, 54, 71, 89), **kw)
    v = spec.num_audio_tokens
    assert np.gcd(spec.muls[0], v) == 1
    assert np.gcd((spec.muls[1] - spec.muls[0]) % v, v) == 1
    assert np.gcd((spec.muls[2] - spec.muls[1]) % v, v) == 1
    assert 1 <= num_variants <= 3, 'durations are distinct only for K <= 3'
    return spec


def sample_variants(token_ids: np.ndarray, spec: GrammarSpec,
                    rng: np.random.RandomState) -> np.ndarray:
    """One variant index per phoneme, i.i.d. from the known distribution."""
    return rng.choice(spec.num_variants, size=len(token_ids),
                      p=variant_probs(spec)).astype(np.int32)


def realize_codes(token_ids: np.ndarray, variants: np.ndarray,
                  spec: GrammarSpec, speaker: int = 0) -> np.ndarray:
    """(token_ids, variants) → ground-truth codes (nq, T).  Residual codebook
    q remains (codebook0 + q*stage_shift) % V — pointwise in the TRUE
    codebook 0, so NAR targets are well-defined even when the NAR's
    conditioning input is corrupted."""
    v = spec.num_audio_tokens
    code0 = np.concatenate(
        [variant_motif(spec, int(t), int(k), speaker)
         for t, k in zip(token_ids, variants)]) if len(token_ids) else \
        np.zeros((0,), np.int32)
    q = np.arange(spec.num_quantizers)[:, None]
    return ((code0[None, :] + q * spec.stage_shift) % v).astype(np.int32)


def sample_realization(token_ids: np.ndarray, spec: GrammarSpec,
                       speaker: int, rng: np.random.RandomState
                       ) -> tuple[np.ndarray, np.ndarray]:
    """→ (codes (nq, T), variants (n,)) — one draw from the realization
    distribution of (text, speaker)."""
    variants = sample_variants(token_ids, spec, rng)
    return realize_codes(token_ids, variants, spec, speaker), variants


def realization_info_nats(variants: np.ndarray, spec: GrammarSpec) -> float:
    """-ln P(realization): the information content a perfectly calibrated
    model pays in NLL for this exact rendering."""
    p = variant_probs(spec)
    return float(-np.log(p[np.asarray(variants, np.int64)]).sum())


def parse_codes0(codes0: np.ndarray, token_ids: np.ndarray, spec: GrammarSpec,
                 speaker: int = 0) -> dict:
    """Parse a generated codebook-0 stream against its text: is it one of the
    enumerable valid renderings?  (The v3 quality metric — realization
    VALIDITY replaces exact match.)

    Walks phoneme by phoneme: the first symbol of each motif identifies the
    variant (injective in (t, k) given the speaker); the variant fixes the
    duration and remaining symbols.  Valid iff every motif verifies and the
    stream ends exactly at the last motif boundary.  Returns {valid,
    variants (parsed so far), n_parsed, n_tokens, consumed}.
    """
    v = spec.num_audio_tokens
    off = speaker_offset(spec, speaker)
    codes0 = np.asarray(codes0)
    pos, variants = 0, []
    for t in np.asarray(token_ids, np.int64):
        if pos >= len(codes0):
            break
        first = int(codes0[pos])
        match = None
        for k in range(spec.num_variants):
            base = spec.num_variants * int(t) + k
            if (spec.muls[0] * base + spec.adds[0] + off) % v == first:
                match = k
                break
        if match is None:
            break
        d = int(variant_duration(spec, t, match))
        want = variant_motif(spec, int(t), match, speaker)
        if pos + d > len(codes0) or not np.array_equal(codes0[pos:pos + d],
                                                       want):
            break
        variants.append(match)
        pos += d
    ok = len(variants) == len(token_ids) and pos == len(codes0)
    return {'valid': ok, 'variants': np.asarray(variants, np.int32),
            'n_parsed': len(variants), 'n_tokens': len(token_ids),
            'consumed': pos}


def parse_grammar_dataset(name: str) -> dict:
    """``'grammar'`` or ``'grammar://speakers=4,pairs=300,holdout=0.1,seed=0'``
    → options dict.  The URI form makes the grammar a first-class
    ``config.dataset`` value, so the production train CLI
    (``python -m valle2_tpu_torch.train -c cfg.json -m ValleAR``) drives grammar
    training through the full data path — collate buckets, prefetch,
    checkpoints — with no bespoke harness."""
    opts: dict = {'speakers': 1, 'pairs': 0, 'holdout': 0.1, 'seed': 0,
                  'variants': 1, 'real': 1}
    rest = name[len('grammar'):].lstrip(':/')
    for kv in filter(None, rest.split(',')):
        k, _, v = kv.partition('=')
        if k not in opts:
            raise ValueError(f'unknown grammar dataset option {k!r} '
                             f'(have {sorted(opts)})')
        opts[k] = float(v) if k == 'holdout' else int(v)
    return opts


def build_grammar_datasets(config) -> tuple['GrammarDataset', 'GrammarDataset',
                                            GrammarSpec]:
    """(train, held-out, spec) for a ``grammar...`` config.dataset value.
    The spec derives from the config (code vocab, quantizers) so model and
    ground truth can never misalign; speakers > 1 selects the ASR-well-posed
    multi-speaker motif parameters."""
    opts = parse_grammar_dataset(str(config.dataset))
    kw = dict(num_audio_tokens=config.num_audio_tokens,
              num_quantizers=config.num_quantizers)
    n_spk, n_var = int(opts['speakers']), int(opts['variants'])
    if n_var > 1:
        spec = ambiguous_spec(n_spk, n_var, **kw)
    else:
        spec = multispeaker_spec(n_spk, **kw) if n_spk > 1 \
            else GrammarSpec(**kw)
    tokz = PhonemeTokenizer(use_g2p=False)
    if tokz.vocab_size > config.vocab_size:
        raise ValueError(f'grammar tokenizer vocab {tokz.vocab_size} exceeds '
                         f'config.vocab_size {config.vocab_size}')
    if n_var * tokz.vocab_size > config.num_audio_tokens:
        raise ValueError(
            f'{n_var} variants x vocab {tokz.vocab_size} exceeds the code '
            f'vocabulary {config.num_audio_tokens}: motifs would collide')
    train_s, held = split_sentences(seed=int(opts['seed']),
                                    holdout_frac=opts['holdout'])
    train_ds = GrammarDataset(train_s, spec, tokz, n_pairs=int(opts['pairs']),
                              pair_seed=int(opts['seed']),
                              realizations=int(opts['real']))
    valid_ds = GrammarDataset(held, spec, tokz,
                              realize_seed=int(opts['seed']) + 104729)
    return train_ds, valid_ds, spec


class GrammarDataset:
    """Dataset of grammar sentences in the standard item contract
    ({'codes': (nq, T), 'tokens': (Tt,)}) — drops into get_collate/DataLoader.

    ``n_pairs`` appends that many two-sentence concatenations (still fully
    compositional): they teach the continuation-after-prompt layout that
    cloning-prompt inference uses — a model trained only on single short
    sentences has never seen a code position past one sentence's length and
    EOSes immediately after a prompt."""

    def __init__(self, sentences: list[str], spec: GrammarSpec,
                 tokenizer: PhonemeTokenizer | None = None,
                 n_pairs: int = 0, pair_seed: int = 0,
                 speakers: tuple[int, ...] | None = None,
                 realizations: int = 1, realize_seed: int = 0):
        self.spec = spec
        self.tokenizer = tokenizer or PhonemeTokenizer(use_g2p=False)
        # v2: every text realized once PER SPEAKER; pairs keep prompt and
        # continuation in the SAME voice — the exact supervision cloning
        # needs (the offset is constant across a training pair, so the model
        # learns to carry the prompt's offset into the continuation).
        # v3 (spec.num_variants > 1): each (text, speaker) appears as
        # ``realizations`` independent draws from the known variant
        # distribution — the supervision a model needs to CALIBRATE to it.
        spk = tuple(speakers) if speakers is not None \
            else tuple(range(max(spec.num_speakers, 1)))
        texts = list(sentences)
        if n_pairs:
            rs = np.random.RandomState(pair_seed)
            for _ in range(n_pairs):
                i, j = rs.randint(len(sentences), size=2)
                texts.append(sentences[i] + ' ' + sentences[j])
        self.items = []
        ambiguous = spec.num_variants > 1
        # realizations == 0 (and ambiguous): DYNAMIC mode — every epoch
        # draws a FRESH realization per item (a deterministic function of
        # (realize_seed, item, epoch) via set_epoch, so resume replays the
        # exact stream).  Any fixed realization set is jointly memorizable
        # by a big model (identify which of R realizations from the first
        # motifs, predict the rest — measured: d=256 drove train loss to
        # 0.04, 8x BELOW the entropy floor, and held-out calibration
        # suffered); a fresh draw per epoch makes the floor binding.
        self.dynamic = ambiguous and int(realizations) == 0
        self._realize_seed = realize_seed
        self._epoch = 0
        n_real = 1 if self.dynamic else (
            max(int(realizations), 1) if ambiguous else 1)
        for si, s in enumerate(texts):
            toks = self.tokenizer(s)
            for sp in spk:
                for r in range(n_real):
                    if ambiguous and not self.dynamic:
                        rs = np.random.RandomState(
                            realize_seed + 9973 * si + 131 * sp + r)
                        codes, variants = sample_realization(toks, spec, sp, rs)
                    elif ambiguous:
                        codes, variants = None, None      # drawn per epoch
                    else:
                        codes, variants = synthesize_codes(toks, spec, sp), None
                    self.items.append({'tokens': toks, 'codes': codes,
                                       'text': s, 'speaker': sp,
                                       'variants': variants})

    def set_epoch(self, epoch: int) -> None:
        """Dynamic-realization epoch pin (called by ``DataLoader._batches``)."""
        self._epoch = int(epoch)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        it = self.items[i]
        if self.dynamic:
            rs = np.random.RandomState(
                (self._realize_seed + 9973 * i + 2654435761 * self._epoch)
                % (2**31 - 1))
            codes, _ = sample_realization(it['tokens'], self.spec, it['speaker'],
                                          rs)
            return {'tokens': it['tokens'], 'codes': codes}
        return {'tokens': it['tokens'], 'codes': it['codes']}




# ---------------------------------------------------------------------------
# Closed-loop evaluation (the port's models, on their device)
# ---------------------------------------------------------------------------

def _token_acc(got: np.ndarray, want: np.ndarray) -> float:
    """Positional accuracy with length mismatch counted as error."""
    n = max(len(got), len(want))
    if n == 0:
        return 1.0
    m = min(len(got), len(want))
    return float((np.asarray(got[:m]) == np.asarray(want[:m])).sum()) / n


def _np(t) -> np.ndarray:
    """A decode's CPU tensor as a numpy array."""
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _device_of(params) -> torch.device:
    """The device a params tree lives on (its first tensor leaf's)."""
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


def _derived_seed(seed: int, *path: int) -> int:
    """A generator seed for sub-stream ``path`` of ``seed`` (the JAX
    package's ``jax.random.fold_in``)."""
    return int(np.random.SeedSequence([seed, *path]).generate_state(1, np.uint64)[0]
               % 2**63)


def _seeded(seed: int | None, device, *path: int) -> torch.Generator | None:
    """``torch.Generator`` on ``device`` for sub-stream ``path`` of ``seed``;
    None for None (the model's default generator, seeded from its config)."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(_derived_seed(seed, *path))


def _model_like(params, config):
    """A ``ValleAR`` of ``config`` over ``params``, on their device."""
    from ..models.ar import ValleAR
    return ValleAR(config, params=params, device=_device_of(params))


def evaluate_closed_loop(ar_tts, nar, ar_asr, sentences: list[str],
                         spec: GrammarSpec,
                         tokenizer: PhonemeTokenizer | None = None,
                         prompt_text: str | None = None,
                         speaker: int = 0) -> dict:
    """text -> AR -> NAR -> (synthesized codes) -> ASR -> text on ``sentences``.

    ``prompt_text`` (a TRAIN-split sentence) plays the cloning prompt: its
    ground-truth codes form the acoustic prefix, the serving composition and
    the layout the NAR trains on.  ``None`` evaluates promptless.
    ``speaker`` realizes prompt AND ground truth in that voice.

    All decodes are greedy and batched (``generate_batch``).  Returns:
    tts_token_acc / tts_exact (codebook 0 vs ground truth), nar_token_acc
    (stages 1..7 on the SYNTHESIZED codes vs the shift rule applied to them),
    asr_token_acc / asr_exact (transcribed phoneme ids vs the input ids),
    text_exact (final round-trip string equality), n, texts.
    """
    tok = tokenizer or PhonemeTokenizer(use_g2p=False)
    nq = ar_tts.config.num_quantizers
    assert nq == spec.num_quantizers, \
        f'model num_quantizers {nq} != GrammarSpec.num_quantizers ' \
        f'{spec.num_quantizers} — ground truth and model codes would misalign'
    empty = np.zeros((0, nq), np.int32)
    token_lists = [tok(s) for s in sentences]
    truth = [synthesize_codes(t, spec, speaker) for t in token_lists]
    if prompt_text is not None:
        # Trailing space: tok(prompt + ' ') + tok(target) == tok(prompt ' ' target),
        # the exact stream a training pair produces.
        p_toks = tok(prompt_text + ' ')
        pcodes = np.ascontiguousarray(
            synthesize_codes(p_toks, spec, speaker).T)       # (Tp, nq)
    else:
        p_toks = np.zeros((0,), np.int32)
        pcodes = empty

    gen0 = [_np(g) for g in ar_tts.generate_batch(
        [np.concatenate([p_toks, t]) for t in token_lists],
        [pcodes] * len(sentences))]
    tts_acc = [_token_acc(g, tr[0]) for g, tr in zip(gen0, truth)]
    tts_exact = [len(g) == tr.shape[1] and np.array_equal(g, tr[0])
                 for g, tr in zip(gen0, truth)]

    # NAR refinement over the SYNTHESIZED first layer (the serving composition).
    nar_accs = []
    for t, g in zip(token_lists, gen0):
        if len(g) == 0:
            nar_accs.append(0.0)
            continue
        codes = _np(nar.generate(p_toks, pcodes, t, g))              # (T, nq)
        want = ((g[None, :] + np.arange(nq)[:, None] * spec.stage_shift)
                % spec.num_audio_tokens)                          # (nq, T)
        nar_accs.append(_token_acc(codes[:, 1:].T.reshape(-1), want[1:].reshape(-1)))

    # ASR on the synthesized codes — the closed loop's second half.
    asr_out = [_np(o) for o in ar_asr.generate_batch(
        [g for g in gen0], [empty] * len(sentences))]
    asr_acc = [_token_acc(o, t) for o, t in zip(asr_out, token_lists)]
    asr_exact = [len(o) == len(t) and np.array_equal(o, t)
                 for o, t in zip(asr_out, token_lists)]
    texts = [tok.to_text(o) for o in asr_out]
    text_exact = [got == want.rstrip('.').strip() or got == want
                  for got, want in zip(texts, sentences)]

    return {
        'n': len(sentences),
        'tts_token_acc': float(np.mean(tts_acc)),
        'tts_exact': float(np.mean(tts_exact)),
        'nar_token_acc': float(np.mean(nar_accs)),
        'asr_token_acc': float(np.mean(asr_acc)),
        'asr_exact': float(np.mean(asr_exact)),
        'text_exact': float(np.mean(text_exact)),
        'texts': texts,
    }


def evaluate_prompt_conditioning(ar_tts, sentences: list[str],
                                 spec: GrammarSpec,
                                 tokenizer: PhonemeTokenizer | None = None,
                                 prompt_text: str | None = None,
                                 speakers: tuple[int, ...] | None = None,
                                 generator: torch.Generator | None = None) -> dict:
    """Does the output depend on the cloning prompt?

    For every speaker s: synthesize all ``sentences`` with the prompt realized
    in voice s, then score the generated codebook-0 stream against the ground
    truth of EVERY voice s'.  A prompt-conditioned model is exact on the
    diagonal (s' = s) and wrong off it.  ``generator``: the decodes' draws
    (JAX ``rng``); None = the model's default.  Returns the diagonal /
    off-diagonal exact rates + the full matrix.
    """
    tok = tokenizer or PhonemeTokenizer(use_g2p=False)
    spk = tuple(speakers) if speakers is not None \
        else tuple(range(max(spec.num_speakers, 1)))
    prompt_text = prompt_text if prompt_text is not None else sentences[0]
    p_toks = tok(prompt_text + ' ')
    token_lists = [tok(s) for s in sentences]
    n_spk = len(spk)
    exact = np.zeros((n_spk, n_spk))
    tokacc = np.zeros((n_spk, n_spk))
    for i, s_gen in enumerate(spk):
        pcodes = np.ascontiguousarray(
            synthesize_codes(p_toks, spec, s_gen).T)         # (Tp, nq)
        gen0 = [_np(g) for g in ar_tts.generate_batch(
            [np.concatenate([p_toks, t]) for t in token_lists],
            [pcodes] * len(sentences), generator=generator)]
        for j, s_truth in enumerate(spk):
            truth = [synthesize_codes(t, spec, s_truth) for t in token_lists]
            exact[i, j] = float(np.mean(
                [len(g) == tr.shape[1] and np.array_equal(g, tr[0])
                 for g, tr in zip(gen0, truth)]))
            tokacc[i, j] = float(np.mean(
                [_token_acc(g, tr[0]) for g, tr in zip(gen0, truth)]))
    diag = np.eye(n_spk, dtype=bool)
    return {
        'n': len(sentences), 'speakers': list(spk),
        'match_exact': float(exact[diag].mean()),
        'mismatch_exact': float(exact[~diag].mean()) if n_spk > 1 else None,
        'match_token_acc': float(tokacc[diag].mean()),
        'mismatch_token_acc': float(tokacc[~diag].mean()) if n_spk > 1 else None,
        'exact_matrix': exact.tolist(),
    }


def evaluate_best_of_n(params, config, sentences: list[str], spec: GrammarSpec,
                       tokenizer: PhonemeTokenizer | None = None,
                       prompt_text: str | None = None, speaker: int = 0,
                       temperature: float = 0.7,
                       beams: tuple[int, ...] = (1, 4), seed: int = 0) -> dict:
    """Does best-of-N sampling buy quality?

    Samples every sentence at ``temperature`` under each beam count (same
    params on their device, same prompt voice, the config's top_k), scoring
    exact match of the SELECTED beam (length-penalized mean logprob).  A
    sampled beam is either the one correct realization or it is wrong, so
    best-of-N wins exactly when the selector picks a correct beam some single
    sample missed.
    """
    import dataclasses

    tok = tokenizer or PhonemeTokenizer(use_g2p=False)
    prompt_text = prompt_text if prompt_text is not None else sentences[0]
    p_toks = tok(prompt_text + ' ')
    pcodes = np.ascontiguousarray(synthesize_codes(p_toks, spec, speaker).T)
    token_lists = [tok(s) for s in sentences]
    truth = [synthesize_codes(t, spec, speaker) for t in token_lists]
    out: dict = {'n': len(sentences), 'temperature': temperature,
                 'speaker': speaker}
    for nb in beams:
        model = _model_like(params, dataclasses.replace(
            config, num_beams=nb, temperature=temperature))
        gen0 = [_np(g) for g in model.generate_batch(
            [np.concatenate([p_toks, t]) for t in token_lists],
            [pcodes] * len(sentences), generator=_seeded(seed, model.device))]
        out[f'beams_{nb}_exact'] = float(np.mean(
            [len(g) == tr.shape[1] and np.array_equal(g, tr[0])
             for g, tr in zip(gen0, truth)]))
        out[f'beams_{nb}_token_acc'] = float(np.mean(
            [_token_acc(g, tr[0]) for g, tr in zip(gen0, truth)]))
    if len(beams) >= 2:
        out['best_of_n_delta'] = (out[f'beams_{beams[-1]}_exact']
                                  - out[f'beams_{beams[0]}_exact'])
    return out


# ---------------------------------------------------------------------------
# v3 evaluation: off-ceiling metrics with a response surface at convergence
# ---------------------------------------------------------------------------

#: Decode-row budget for the eval harnesses: sentences x num_beams rows per
#: dispatch.  Chunking keeps every dispatch under the budget with identical
#: per-row outputs (per-length masking); only the sampling draws differ per
#: chunk.
MAX_EVAL_DECODE_ROWS = 128


def _generate_chunked(model, tokens_list, codes_list, seed: int | None = None,
                      max_rows: int = MAX_EVAL_DECODE_ROWS) -> list:
    """``model.generate_batch`` over chunks of at most ``max_rows`` decode
    rows; chunk ci draws from a generator seeded from (``seed``, ci) (JAX
    ``fold_in(rng, ci)``), or from the model's default with ``seed`` None."""
    nb = max(1, model.config.num_beams)
    per = max(1, max_rows // nb)
    out = []
    for ci, i in enumerate(range(0, len(tokens_list), per)):
        out.extend(model.generate_batch(tokens_list[i:i + per], codes_list[i:i + per],
                                        generator=_seeded(seed, model.device, ci)))
    return out


def evaluate_validity(params, config, sentences: list[str], spec: GrammarSpec,
                      tokenizer: PhonemeTokenizer | None = None,
                      prompt_text: str | None = None, speaker: int = 0,
                      temperature: float = 1.0, num_beams: int = 1,
                      n_samples: int = 1, seed: int = 0) -> dict:
    """Sample every sentence at ``temperature`` (best-of-``num_beams``) and
    score realization VALIDITY: does the output parse as one of the
    enumerable valid renderings of the text in the prompt's voice?

    Also reports: ``parse_frac`` (phonemes parsed before first failure),
    ``tv_distance`` (total variation between the sampled variant
    distribution over parsed motifs and the known ground-truth distribution
    -- the calibration measure), and ``info_per_phoneme`` of valid outputs.
    """
    import dataclasses

    tok = tokenizer or PhonemeTokenizer(use_g2p=False)
    prompt_text = prompt_text if prompt_text is not None else sentences[0]
    p_toks = tok(prompt_text + ' ')
    rs = np.random.RandomState(seed + 777)
    pcodes_arr, _ = sample_realization(p_toks, spec, speaker, rs)
    pcodes = np.ascontiguousarray(pcodes_arr.T)                    # (Tp, nq)
    token_lists = [tok(s) for s in sentences]
    model = _model_like(params, dataclasses.replace(
        config, num_beams=num_beams, temperature=temperature))
    valid, frac, infos, counts = [], [], [], np.zeros(spec.num_variants)
    for r in range(n_samples):
        gen0 = [_np(g) for g in _generate_chunked(
            model, [np.concatenate([p_toks, t]) for t in token_lists],
            [pcodes] * len(sentences), seed=seed + r)]
        for t, g in zip(token_lists, gen0):
            p = parse_codes0(g, t, spec, speaker)
            valid.append(float(p['valid']))
            frac.append(p['n_parsed'] / max(p['n_tokens'], 1))
            for k in p['variants']:
                counts[k] += 1
            if p['valid']:
                infos.append(realization_info_nats(p['variants'], spec)
                             / len(t))
    emp = counts / counts.sum() if counts.sum() else counts
    tv = 0.5 * float(np.abs(emp - variant_probs(spec)).sum())
    return {'n': len(sentences) * n_samples, 'temperature': temperature,
            'num_beams': num_beams, 'validity': float(np.mean(valid)),
            'parse_frac': float(np.mean(frac)), 'tv_distance': tv,
            'info_per_phoneme': float(np.mean(infos)) if infos else None,
            'entropy_floor': variant_entropy(spec)}


def evaluate_temperature_curve(params, config, sentences, spec,
                               tokenizer=None, prompt_text=None, speaker=0,
                               temperatures=(0.0, 0.7, 1.0, 1.3),
                               n_samples: int = 1, seed: int = 0) -> list[dict]:
    """validity/calibration as a function of temperature -- the v3 response
    curve (greedy is always-valid but maximally miscalibrated, tv -> 0 near
    tau=1 for a calibrated model, validity degrades as tau grows)."""
    return [evaluate_validity(params, config, sentences, spec, tokenizer,
                              prompt_text, speaker, temperature=t,
                              n_samples=n_samples, seed=seed)
            for t in temperatures]


def evaluate_best_of_n_validity(params, config, sentences, spec,
                                tokenizer=None, prompt_text=None, speaker=0,
                                temperature: float = 1.0,
                                beams: tuple = (1, 2, 4, 8),
                                n_samples: int = 1, seed: int = 0) -> dict:
    """Best-of-N under the v3 validity metric: the likelihood selector
    should both raise validity and pull info/phoneme below the entropy
    floor."""
    out: dict = {'temperature': temperature, 'beams': list(beams)}
    for nb in beams:
        r = evaluate_validity(params, config, sentences, spec, tokenizer,
                              prompt_text, speaker, temperature=temperature,
                              num_beams=nb, n_samples=n_samples, seed=seed)
        out[f'beams_{nb}'] = {k: r[k] for k in
                              ('validity', 'tv_distance', 'info_per_phoneme')}
    out['best_of_n_delta'] = (out[f'beams_{beams[-1]}']['validity']
                              - out[f'beams_{beams[0]}']['validity'])
    return out


def evaluate_prompt_conditioning_v3(ar_tts, sentences: list[str],
                                    spec: GrammarSpec,
                                    tokenizer: PhonemeTokenizer | None = None,
                                    prompt_text: str | None = None,
                                    speakers: tuple[int, ...] | None = None,
                                    seed: int = 0) -> dict:
    """Prompt-conditioning matrix under v3 ambiguity: generate with the
    prompt realized in voice s, PARSE against every voice s'.  Validity
    requires the speaker offset, which appears ONLY in the prompt codes."""
    tok = tokenizer or PhonemeTokenizer(use_g2p=False)
    spk = tuple(speakers) if speakers is not None \
        else tuple(range(max(spec.num_speakers, 1)))
    prompt_text = prompt_text if prompt_text is not None else sentences[0]
    p_toks = tok(prompt_text + ' ')
    token_lists = [tok(s) for s in sentences]
    n_spk = len(spk)
    validity = np.zeros((n_spk, n_spk))
    for i, s_gen in enumerate(spk):
        rs = np.random.RandomState(seed + 777 + s_gen)
        pcodes_arr, _ = sample_realization(p_toks, spec, s_gen, rs)
        pcodes = np.ascontiguousarray(pcodes_arr.T)
        gen0 = [_np(g) for g in _generate_chunked(
            ar_tts, [np.concatenate([p_toks, t]) for t in token_lists],
            [pcodes] * len(sentences), seed=seed)]
        for j, s_truth in enumerate(spk):
            validity[i, j] = float(np.mean(
                [float(parse_codes0(g, t, spec, s_truth)['valid'])
                 for g, t in zip(gen0, token_lists)]))
    diag = np.eye(n_spk, dtype=bool)
    return {'n': len(sentences), 'speakers': list(spk),
            'match_validity': float(validity[diag].mean()),
            'mismatch_validity': float(validity[~diag].mean())
            if n_spk > 1 else None,
            'validity_matrix': validity.tolist()}


def _score_nll(params, config, tokens, codes, target, tokens_lens, codes_lens,
              starts) -> torch.Tensor:
    """Teacher-forced NLL per row of ``ar.forward`` (no dropout) over the
    target positions [start, codes_len): (rows,) float32 (the JAX package's
    jitted ``score``).  Inputs are tensors on the params' device."""
    from ..config import precision_scope
    from ..models import ar as ar_mod

    with torch.no_grad(), precision_scope(config):
        logits = ar_mod.forward(params, config, tokens, codes, tokens_lens, codes_lens,
                                None)
        lp = torch.log_softmax(logits, dim=-1)
        nll = -lp.gather(-1, target[..., None].long())[..., 0]
        pos = torch.arange(target.shape[1], device=target.device)[None, :]
        valid = (pos >= starts[:, None]) & (pos < codes_lens[:, None])
        return torch.sum(nll * valid, dim=1)


def _nll_batch(rows: list[dict], bucket_sizes, device) -> tuple:
    """(tokens, codes, target, tokens_lens, codes_lens, starts) tensors on
    ``device`` from rows of {'tokens', 'codes', 'target', 'start'}, padded to
    the buckets of their longest row."""
    from ..config import bucket_len

    tw = bucket_len(bucket_sizes, max(len(r['tokens']) for r in rows))
    cw = bucket_len(bucket_sizes, max(len(r['codes']) for r in rows))

    def stack(key, w):
        return torch.from_numpy(np.stack([np.pad(np.asarray(r[key], np.int32),
                                                 (0, w - len(r[key]))) for r in rows]))

    def lens(values):
        return torch.tensor(values, dtype=torch.int32)

    out = (stack('tokens', tw), stack('codes', cw), stack('target', cw),
           lens([len(r['tokens']) for r in rows]), lens([len(r['codes']) for r in rows]),
           lens([r['start'] for r in rows]))
    return tuple(t.to(device) for t in out)


def evaluate_nll(params, config, sentences: list[str], spec: GrammarSpec,
                 tokenizer: PhonemeTokenizer | None = None,
                 prompt_text: str | None = None, speaker: int = 0,
                 realizations: int = 4, seed: int = 0) -> dict:
    """Teacher-forced NLL of held-out realizations vs the ANALYTIC floor.

    Each rendering's information content is known exactly
    (``realization_info_nats``): ``excess_nats_per_phoneme`` = mean(model
    NLL - true information content)/phonemes >= 0, with equality iff the
    model reproduces the variant distribution.  Scoring is
    prompt-conditioned: the prompt realization is given, NLL counts only
    target positions + EOS.  Runs on the params' device.
    """
    tok = tokenizer or PhonemeTokenizer(use_g2p=False)
    prompt_text = prompt_text if prompt_text is not None else sentences[0]
    p_toks = tok(prompt_text + ' ')
    rows = []
    for si, s in enumerate(sentences):
        t = tok(s)
        full_t = np.concatenate([p_toks, t]).astype(np.int32)
        for r in range(realizations):
            rs = np.random.RandomState(seed + 131 * si + r)
            pcodes, _ = sample_realization(p_toks, spec, speaker, rs)
            codes, var = sample_realization(t, spec, speaker, rs)
            c0 = np.concatenate([pcodes[0], codes[0]])
            rows.append({
                'tokens': full_t,
                'codes': np.concatenate([[config.bos_token], c0]).astype(np.int32),
                'target': np.concatenate([c0, [config.eos_token]]).astype(np.int32),
                'start': pcodes.shape[1],
                'info': realization_info_nats(var, spec),
                'n_phon': len(t)})
    batch = _nll_batch(rows, config.bucket_sizes, _device_of(params))
    sums = _score_nll(params, config, *batch).double().cpu().numpy()
    info = np.asarray([r['info'] for r in rows])
    n_phon = np.asarray([r['n_phon'] for r in rows], np.float64)
    n_codes = np.asarray([len(r['target']) - r['start'] for r in rows],
                         np.float64)
    return {'n_rows': len(rows),
            'nll_per_phoneme': float((sums / n_phon).mean()),
            'nll_per_token': float((sums / n_codes).mean()),
            'floor_per_phoneme': variant_entropy(spec),
            'excess_nats_per_phoneme': float(((sums - info) / n_phon).mean())}


def evaluate_nar_refinement(nar, sentences: list[str], spec: GrammarSpec,
                            tokenizer: PhonemeTokenizer | None = None,
                            prompt_text: str | None = None, speaker: int = 0,
                            corrupt: tuple = (0.0, 0.05, 0.15, 0.3),
                            seed: int = 0) -> dict:
    """Is the NAR a REFINER or a pointwise code-shifter?  Corrupt a fraction
    eps of the conditioning codebook-0 stream (uniform random symbols) and
    score stages 1..7 against the TRUE stages of the uncorrupted
    realization.  A pointwise model follows the corruption (acc ~ 1-eps); a
    model that exploits the motif redundancy + text alignment recovers the
    truth and beats that baseline -- the gain is the refinement
    measurement."""
    tok = tokenizer or PhonemeTokenizer(use_g2p=False)
    prompt_text = prompt_text if prompt_text is not None else sentences[0]
    p_toks = tok(prompt_text + ' ')
    rs = np.random.RandomState(seed + 777)
    pcodes_arr, _ = sample_realization(p_toks, spec, speaker, rs)
    pcodes = np.ascontiguousarray(pcodes_arr.T)                    # (Tp, nq)
    nq, v = spec.num_quantizers, spec.num_audio_tokens
    out: dict = {'corrupt': list(corrupt), 'n': len(sentences), 'by_eps': {}}
    for eps in corrupt:
        accs, base = [], []
        for si, s in enumerate(sentences):
            t = tok(s)
            rs = np.random.RandomState(seed + 131 * si)
            codes, _ = sample_realization(t, spec, speaker, rs)     # (nq, T)
            c0 = codes[0].copy()
            mask = rs.rand(len(c0)) < eps
            c0[mask] = rs.randint(0, v, mask.sum())
            got = _np(nar.generate(p_toks, pcodes, t, c0))          # (T, nq)
            accs.append(float((got[:, 1:].T == codes[1:]).mean()))
            follow = (c0[None, :] + np.arange(1, nq)[:, None]
                      * spec.stage_shift) % v
            base.append(float((follow == codes[1:]).mean()))
        out['by_eps'][str(eps)] = {
            'nar_acc': float(np.mean(accs)),
            'follow_baseline': float(np.mean(base)),
            'refinement_gain': float(np.mean(accs) - np.mean(base))}
    return out


def evaluate_closed_loop_v3(ar_tts, nar, ar_asr, sentences: list[str],
                            spec: GrammarSpec,
                            tokenizer: PhonemeTokenizer | None = None,
                            prompt_text: str | None = None, speaker: int = 0,
                            temperature: float | None = None,
                            seed: int = 0) -> dict:
    """text -> AR (sampled) -> NAR -> ASR -> text under v3 ambiguity.

    TTS is scored by VALIDITY (parse), the NAR by consistency with the
    sampled realization (a valid c0 IS a true realization, so its stages are
    its pointwise shift), and ASR/text by exactness."""
    import dataclasses

    from ..models.ar import ValleAR

    tok = tokenizer or PhonemeTokenizer(use_g2p=False)
    prompt_text = prompt_text if prompt_text is not None else sentences[0]
    p_toks = tok(prompt_text + ' ')
    rs = np.random.RandomState(seed + 777)
    pcodes_arr, _ = sample_realization(p_toks, spec, speaker, rs)
    pcodes = np.ascontiguousarray(pcodes_arr.T)
    token_lists = [tok(s) for s in sentences]
    nq = spec.num_quantizers
    empty = np.zeros((0, nq), np.int32)
    model = ar_tts if temperature is None else ValleAR(
        dataclasses.replace(ar_tts.config, temperature=temperature),
        params=ar_tts.params, device=ar_tts.device)
    gen0 = [_np(g) for g in _generate_chunked(
        model, [np.concatenate([p_toks, t]) for t in token_lists],
        [pcodes] * len(sentences), seed=seed)]
    parses = [parse_codes0(g, t, spec, speaker)
              for g, t in zip(gen0, token_lists)]
    tts_valid = [float(p['valid']) for p in parses]

    nar_accs = []
    for t, g in zip(token_lists, gen0):
        if len(g) == 0:
            nar_accs.append(0.0)
            continue
        codes = _np(nar.generate(p_toks, pcodes, t, g))             # (T, nq)
        want = ((g[None, :] + np.arange(nq)[:, None] * spec.stage_shift)
                % spec.num_audio_tokens)
        nar_accs.append(_token_acc(codes[:, 1:].T.reshape(-1),
                                   want[1:].reshape(-1)))

    asr_out = [_np(o) for o in _generate_chunked(
        ar_asr, [g for g in gen0], [empty] * len(sentences))]
    asr_exact = [len(o) == len(t) and np.array_equal(o, t)
                 for o, t in zip(asr_out, token_lists)]
    texts = [tok.to_text(o) for o in asr_out]
    text_exact = [got == want.rstrip('.').strip() or got == want
                  for got, want in zip(texts, sentences)]
    return {'n': len(sentences),
            'tts_validity': float(np.mean(tts_valid)),
            'tts_parse_frac': float(np.mean(
                [p['n_parsed'] / max(p['n_tokens'], 1) for p in parses])),
            'nar_token_acc': float(np.mean(nar_accs)),
            'asr_exact': float(np.mean(asr_exact)),
            'text_exact': float(np.mean(text_exact))}


def default_config(spec: GrammarSpec, tokenizer: PhonemeTokenizer, **kw):
    """The grammar experiment's model scale (tiny: the task is compositional,
    not capacity-bound)."""
    from ..config import ConfigValle
    base = dict(d_model=64, n_heads=2, dim_feedforward=128, num_layers=2,
                vocab_size=tokenizer.vocab_size,
                num_audio_tokens=spec.num_audio_tokens,
                dropout=0.0, temperature=0.0, num_beams=1, max_audio_len=64,
                norm='AdaptiveLayerNorm', bucket_sizes=(32, 64, 96), lr=2e-3,
                schedule='constant', batch_size=32)
    base.update(kw)
    return ConfigValle(**base)


def train_grammar_model(model_name: str, config, train_ds: GrammarDataset,
                        valid_ds: GrammarDataset | None = None,
                        max_epochs: int = 60, loss_target: float = 5e-3,
                        seed: int = 0, base_params=None, device=None):
    """Train one model on the grammar through the port's data path
    (``get_collate`` -> ``DataLoader`` -> ``make_train_step``) on ``device``
    (the CUDA card by default).  Returns (params, curves) where curves =
    {'train_loss': [...per epoch], 'valid_loss': [...]}; each step's draws
    come from ``step_generator(seed + 1, step)``.

    ``base_params``: start from these weights (with ``config.lora_rank > 0``
    this is a LoRA fine-tune -- the returned params are the ``{'base',
    'lora'}`` state; merge via ``lora.merged`` to serve)."""
    from ..config import resolve_device
    from ..train import init_state, make_eval_step, make_train_step, step_generator
    from .collate import get_collate
    from .dataset import DataLoader
    from .prefetch import to_device

    device = resolve_device(device)
    collate = get_collate(model_name)(config)
    loader = DataLoader(train_ds, config.batch_size, collate, shuffle=True,
                        seed=seed)
    valid_batch = None
    if valid_ds is not None:
        vloader = DataLoader(valid_ds, min(len(valid_ds), 64), collate,
                             shuffle=False, drop_last=False)
        valid_batch = to_device(next(iter(vloader)), device)
    state = init_state(config, model_name, seed=seed, base_params=base_params,
                       device=device)
    step_fn = make_train_step(config, model_name)
    eval_fn = make_eval_step(config, model_name)
    curves: dict[str, list[float]] = {'train_loss': [], 'valid_loss': []}
    for epoch in range(max_epochs):
        m = None
        for batch in loader:
            state, m = step_fn(state, to_device(batch, device), seed + 1)
        if m is None:
            # drop_last + a dataset smaller than batch_size yields ZERO
            # batches — fail with the cause, not a NoneType crash.
            raise ValueError(
                f'train dataset ({len(train_ds)} items) produced no batches '
                f'at batch_size={config.batch_size}; shrink batch_size or '
                f'grow the grammar')
        curves['train_loss'].append(float(m['loss']))
        if valid_batch is not None:
            vm = eval_fn(state.params, valid_batch,
                         step_generator(seed + 1, epoch, device))
            curves['valid_loss'].append(float(vm['loss']))
        if curves['train_loss'][-1] < loss_target:
            break
    return state.params, curves
