"""One-command gate for pretrained artifacts (``valle2_tpu/tools/verify_pretrained.py``).

The repo holds no real checkpoint: every parity test runs on seeded weights.
On the day a real one is at hand, this tool is the drop-in gate::

    python -m valle2_tpu_torch.tools.verify_pretrained --codec encodec_24khz.th \\
        [--ar ar.ckpt --nar nar.ckpt -c config.json] [--device cuda|cpu]

It loads the torch EnCodec checkpoint into the port's ``codec.Encodec``
(``codec/convert.py``), loads the SAME state dict into an independent torch
implementation, and runs the sweep of token-ID parity on every stride
boundary and the embedding / decode / round-trip numerics, printing pass or
fail per stage and exiting 1 on any failure.

The torch reference is, in order of preference:

1. the pip ``encodec`` package (the reference's own dependency), when it
   imports;
2. the torch mirror of the repo's tests (``tests/torch_encodec_mirror.py``:
   the real state-dict naming, weight-norm reparametrization, exact
   padding), which loads the same checkpoint file.

``--ar`` / ``--nar`` load reference-trained VALL-E checkpoints through
``models.convert.load_torch_checkpoint`` and run a greedy decode on the
device; with ``norm='LayerNorm'`` configs the AR's greedy ids are also held
to ``tests/torch_reference_modules.ReferenceShapedValleAR`` loading the same
state dict, step by step.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

from ..config import resolve_device

# Every stride boundary (319/320/321 around one hop, 1600 stride-5, 7777
# coprime, 16000 = the reference's 50-frame anchor) plus multi-seed audio at
# 2400 samples.
ENCODE_SWEEP = [(0, 319), (0, 320), (0, 321), (0, 1600), (0, 7777), (0, 16000),
                (1, 2400), (2, 2400), (3, 2400), (4, 2400)]
TESTS_DIR = Path(__file__).resolve().parents[2] / 'tests'


def _wav(seed: int, samples: int) -> np.ndarray:
    wav = np.random.RandomState(100 + seed).randn(samples).astype(np.float32)
    return wav / np.abs(wav).max()


def _load_state_dict(path: str):
    obj = torch.load(path, map_location='cpu', weights_only=True)
    sd = obj.get('best_state', obj) if isinstance(obj, dict) else obj
    if hasattr(sd, 'state_dict'):
        sd = sd.state_dict()
    return sd


def _tests_on_path() -> None:
    if str(TESTS_DIR) not in sys.path:
        sys.path.insert(0, str(TESTS_DIR))


class _PipReference:
    """The pip ``encodec`` package at 24 kHz / 6 kbps, loading ``sd``."""

    def __init__(self, sd):
        from encodec import EncodecModel
        model = EncodecModel.encodec_model_24khz(pretrained=False)
        model.set_target_bandwidth(6.0)
        model.load_state_dict(sd)
        self.model = model.eval()

    @torch.no_grad()
    def encode(self, wav: np.ndarray) -> np.ndarray:
        frames = self.model.encode(torch.from_numpy(wav)[None, None])
        return torch.cat([f[0] for f in frames], dim=-1)[0].numpy()

    @torch.no_grad()
    def decode(self, codes: np.ndarray) -> np.ndarray:
        return self.model.decode([(torch.from_numpy(codes)[None], None)])[0, 0].numpy()

    @torch.no_grad()
    def get_embedding(self, wav: np.ndarray) -> np.ndarray:
        return self.model.encoder(torch.from_numpy(wav)[None, None])[0].numpy()


class _MirrorReference:
    """``tests/torch_encodec_mirror.EncodecMirror`` loading the same checkpoint."""

    def __init__(self, sd):
        _tests_on_path()
        from torch_encodec_mirror import EncodecMirror
        mirror = EncodecMirror(seed=0)
        mirror.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()})
        self.model = mirror.eval()

    def encode(self, wav):
        return self.model.encode(torch.from_numpy(wav)[None])[0].numpy()

    def decode(self, codes):
        return self.model.decode(torch.from_numpy(codes)[None])[0].numpy()

    def get_embedding(self, wav):
        return self.model.get_embedding(torch.from_numpy(wav)[None])[0].numpy()


def _references(sd) -> list[tuple[str, object]]:
    refs: list[tuple[str, object]] = []
    try:
        refs.append(('pip-encodec', _PipReference(sd)))
    except ImportError:
        pass
    refs.append(('torch-mirror', _MirrorReference(sd)))
    return refs


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _max_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max()) if got.shape == want.shape else np.inf


def verify_codec(checkpoint: str, verbose: bool = True, device=None) -> dict[str, bool]:
    """Run the codec gate for one checkpoint on ``device`` (the CUDA card by
    default).  Returns {stage: passed}; all True == drop-in ready."""
    from ..codec import Encodec
    codec = Encodec(checkpoint=checkpoint, device=resolve_device(device))
    sd = _load_state_dict(checkpoint)
    results: dict[str, bool] = {}

    def report(stage: str, ok: bool, detail: str = ''):
        results[stage] = ok
        if verbose:
            print(f'[{"PASS" if ok else "FAIL"}] {stage}' + (f'  ({detail})' if detail else ''))

    def close(stage: str, got, want):
        scale = max(1.0, float(np.abs(want).max()))
        err = _max_err(_np(got), want)
        report(stage, err <= 1e-4 * scale + 1e-4, f'max abs err {err:.2e}')

    for ref_name, ref in _references(sd):
        ok, worst = True, ''
        for seed, samples in ENCODE_SWEEP:
            wav = _wav(seed, samples)
            want = ref.encode(wav)
            got = _np(codec.encode(wav))
            if got.shape != want.shape or not np.array_equal(got, want):
                ok = False
                n_bad = int((got != want).sum()) if got.shape == want.shape else -1
                worst = f'len={samples}: {n_bad} mismatched token ids'
                break
        report(f'encode-token-parity[{ref_name}]', ok, worst)
        wav = _wav(0, 4800)
        close(f'embedding-parity[{ref_name}]', codec.get_embedding(wav), ref.get_embedding(wav))
        codes = np.random.RandomState(200).randint(0, 1024, (8, 15)).astype(np.int64)
        close(f'decode-waveform-parity[{ref_name}]', codec.decode(codes), ref.decode(codes))
        wav = _wav(0, 3200)
        close(f'roundtrip-parity[{ref_name}]', codec.encode_decode(wav),
              ref.decode(ref.encode(wav)))
    return results


def _reference_greedy(sd, cfg, tokens: np.ndarray, codes0: np.ndarray) -> list[int] | None:
    """Greedy ids of ``ReferenceShapedValleAR`` (the tests' torch modules with
    the reference's state-dict surface) loading ``sd``: one full forward a
    step.  None where the modules are not at hand."""
    _tests_on_path()
    try:
        from torch_reference_modules import ReferenceShapedValleAR
    except ImportError:
        return None
    ref = ReferenceShapedValleAR(cfg)
    ref.load_state_dict({k.removeprefix('model.'): v for k, v in sd.items()})
    eos, bos = cfg.num_audio_tokens, cfg.num_audio_tokens + 1
    codes, out = [bos, *map(int, codes0)], []
    tok = torch.as_tensor(tokens, dtype=torch.long)[None]
    for _ in range(cfg.max_audio_len):
        nxt = int(torch.argmax(ref.forward_logits(tok, torch.tensor([codes]))[0, -1]))
        if nxt == eos:
            break
        codes.append(nxt)
        out.append(nxt)
    return out


def verify_valle(checkpoint: str, model_name: str, config, device=None) -> dict[str, bool]:
    """Load a reference-trained VALL-E checkpoint and gate it: a greedy decode
    on ``device`` (in range), plus for AR LayerNorm configs greedy ids ==
    ``ReferenceShapedValleAR`` on the same state dict."""
    from ..config import precision_scope
    from ..models import ValleAR, ValleNAR
    from ..models.convert import load_torch_checkpoint

    dev = resolve_device(device)
    results: dict[str, bool] = {}
    params = load_torch_checkpoint(checkpoint, model_name, num_layers=config.num_layers,
                                   num_quantizers=config.num_quantizers, device=dev)
    # Greedy, f32 everywhere, the KV cache too: bf16 noise flips near-tie
    # argmaxes and breaks token-exactness against the step-by-step reference.
    cfg = dataclasses.replace(config, temperature=0.0, num_beams=1,
                              max_audio_len=min(config.max_audio_len, 16),
                              matmul_precision='highest', dtype='float32',
                              kv_cache_dtype='float32', dropout=0.0)
    rs = np.random.RandomState(0)
    pt = rs.randint(0, cfg.vocab_size - 8, (5,))
    pc = rs.randint(0, cfg.num_audio_tokens, (6, cfg.num_quantizers))
    gen = torch.Generator(device=dev).manual_seed(0)
    if model_name == 'ValleNAR':
        model = ValleNAR(cfg, params=params, device=dev)
        first = rs.randint(0, cfg.num_audio_tokens, (8,))
        out = _np(model.generate(pt, pc, pt[:2], first, generator=gen))
        results['nar-decode-finite'] = bool((out >= 0).all()
                                            and (out < cfg.num_audio_tokens).all())
        return results
    model = ValleAR(cfg, params=params, device=dev)
    out = _np(model.generate(pt, pc, pt[:2], generator=gen))
    results['ar-decode-finite'] = bool((out >= 0).all())
    if cfg.norm == 'LayerNorm':
        sd = torch.load(checkpoint, map_location='cpu', weights_only=True)
        sd = sd.get('state_dict', sd)
        with precision_scope(cfg):
            want = _reference_greedy(sd, cfg, np.concatenate([pt, pt[:2]]), pc[:, 0])
        if want is not None:
            results['ar-greedy-parity[torch-reference]'] = [int(c) for c in out] == want
    return results


_G2P_SENTENCES = (
    'the quick brown fox jumps over the lazy dog.',
    'hello world, this is a test of the speech frontend.',
    'she said they would go home tomorrow morning.',
    'i have 3 cats and $2.50 in my pocket.',
    'the president spoke about education and health.',
)


def verify_frontend(sentences=_G2P_SENTENCES, verbose: bool = True) -> dict:
    """The bundled frontend against the real ``g2p_en`` when it imports:
    {'available': bool, 'vocab_identical': bool, 'phoneme_agreement': float}.
    The symbol → id layout must match exactly (or trained checkpoints do not
    carry over); the fallback's letter-to-sound rules are approximate, so
    agreement is reported, not required."""
    from ..data.frontend import PHONEMES, PUNCTUATION, PhonemeTokenizer
    try:
        from g2p_en import G2p
    except Exception:
        if verbose:
            print('[SKIP] g2p_en not importable: the frontend gate needs it installed')
        return {'available': False}
    g2p = G2p()
    vocab_ok = list(g2p.phonemes) == PHONEMES[:len(list(g2p.phonemes))] \
        and PUNCTUATION == [' ', ',', '.']
    ours = PhonemeTokenizer(use_g2p=False)
    agree = total = 0
    for s in sentences:
        a, b = list(g2p(s)), ours.phonemize(s)
        total += max(len(a), len(b))
        agree += sum(x == y for x, y in zip(a, b))
    out = {'available': True, 'vocab_identical': bool(vocab_ok),
           'phoneme_agreement': agree / max(total, 1)}
    if verbose:
        print(f'[{"PASS" if vocab_ok else "FAIL"}] frontend vocab layout identical to g2p_en')
        print(f'[INFO] fallback-vs-g2p_en phoneme agreement: {out["phoneme_agreement"]:.1%}')
    return out


def main(argv=None) -> int:
    import argparse

    from ..config import ConfigValle
    parser = argparse.ArgumentParser(
        description='Verify pretrained artifacts loaded by the port against their torch '
                    'reference')
    parser.add_argument('--codec', type=Path, default=None,
                        help='EnCodec torch checkpoint (.th)')
    parser.add_argument('--ar', type=Path, default=None,
                        help='Reference-trained ValleAR checkpoint')
    parser.add_argument('--nar', type=Path, default=None,
                        help='Reference-trained ValleNAR checkpoint')
    parser.add_argument('-c', '--config', type=Path, default=None)
    parser.add_argument('--frontend', action='store_true',
                        help='Also cross-check the phoneme frontend against a real g2p_en '
                             'install (skips when absent)')
    parser.add_argument('--device', type=str, default='cuda', help="'cuda' or 'cpu'")
    args = parser.parse_args(argv)
    if not (args.codec or args.ar or args.nar or args.frontend):
        parser.error('nothing to verify: pass --codec, --ar/--nar, or --frontend')
    config = ConfigValle.from_json(args.config) if args.config else ConfigValle()

    results: dict[str, bool] = {}
    if args.codec:
        results.update(verify_codec(str(args.codec), device=args.device))
    if args.ar:
        results.update(verify_valle(str(args.ar), 'ValleAR', config, device=args.device))
    if args.nar:
        results.update(verify_valle(str(args.nar), 'ValleNAR', config, device=args.device))
    if args.frontend:
        fr = verify_frontend()
        if fr.get('available'):
            results['frontend-vocab-layout[g2p_en]'] = fr['vocab_identical']
    for stage, ok in results.items():
        print(f'{stage}: {"PASS" if ok else "FAIL"}')
    n_fail = sum(not ok for ok in results.values())
    print(f'{len(results) - n_fail}/{len(results)} stages passed')
    return 1 if n_fail else 0


if __name__ == '__main__':
    sys.exit(main())
