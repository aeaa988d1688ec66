"""End-to-end TTS (text + cloning prompt → 24 kHz waveform) on PyTorch/CUDA.

Port of the serving path of ``valle2_tpu/tts.py``: ``_fused_tts_fn`` runs the
AR first-codebook decode (flash prefill, fused decode steps, best-of-N pick),
the NAR 7-stage refinement and the codec decode over padded batches with true
lengths.  ``ValleTTS.batch_synthesize`` / ``synthesize_fused`` are its entry
points.  The cloning prompt enters as codec codes: ``prepare_prompt`` needs the
codec encoder, which waits for a later slice (ROADMAP.md), as do streaming,
long-form synthesis and meshes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .codec import Encodec
from .codec import encodec as codec_mod
from .config import ConfigValle, bucket_len, precision_scope, resolve_device
from .data.frontend import PhonemeTokenizer
from .models import ValleAR, ValleNAR
from .models import ar as ar_mod
from .models import nar as nar_mod


class StageClock:
    """Wall time per pipeline stage.  ``mark`` synchronizes the device first,
    so each stage's time includes its queued device work."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.times: dict[str, float] = {}
        self._last = self._now()

    def _now(self) -> float:
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def mark(self, stage: str) -> None:
        now = self._now()
        self.times[stage] = self.times.get(stage, 0.0) + now - self._last
        self._last = now


def _fused_tts_fn(ar_params, nar_params, codec_dec_params, tokens, tokens_lens,
                  prompt_codes, p_lens, config: ConfigValle,
                  generator: torch.Generator | None = None, clock: StageClock | None = None):
    """tokens: (B, Ttm), true lens tokens_lens (B,); prompt_codes: (B, Pm, nq),
    true lens p_lens (B,).  Returns (waveforms (B, max_new*320) f32,
    gen_lens (B,), codes (B, max_new, nq)); slice wav[i, :gen_lens[i]*320]."""
    eos, bos = config.eos_token, config.bos_token
    max_new = config.max_audio_len
    b, pm = prompt_codes.shape[0], prompt_codes.shape[1]
    dev = tokens.device

    # AR first-codebook decode (BOS-prefixed prompts; valid length p_len + 1).
    codes0 = torch.cat([torch.full((b, 1), bos, dtype=torch.long, device=dev),
                        prompt_codes[:, :, 0]], dim=1)
    codes_buf, _, best = ar_mod._decode_fn(ar_params, tokens, tokens_lens, codes0,
                                           p_lens + 1, config, generator, clock)
    rows = codes_buf[torch.arange(b, device=dev), best]             # (B, Pm+1+max_new)
    gen_region = rows[:, pm + 1:]
    is_eos = gen_region == eos
    gen_lens = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1),
                           torch.full_like(best, max_new))
    first_layer = torch.where(is_eos, 0, gen_region)                # in-vocab past EOS

    codes = nar_mod._generate_fn(nar_params, tokens, tokens_lens, prompt_codes, p_lens,
                                 first_layer, gen_lens, config, generator)
    if clock is not None:
        clock.mark('nar')
    # The codec is causal: frames past gen_len cannot change earlier samples.
    wavs = codec_mod.decode(codec_dec_params, codes.transpose(1, 2)).float()
    if clock is not None:
        clock.mark('codec')
    return wavs, gen_lens, codes


@dataclass
class TTSResult:
    waveform: np.ndarray            # (T,) float32 @ 24 kHz
    codes: np.ndarray               # (frames, num_quantizers)
    rtf: float                      # wall-clock / audio-seconds
    timings: dict[str, float]


class ValleTTS:
    """text (+ cloning prompt codes) → waveform, on one device."""

    def __init__(self, config: ConfigValle, ar: ValleAR | None = None,
                 nar: ValleNAR | None = None, codec: Encodec | None = None,
                 tokenizer: PhonemeTokenizer | None = None, device=None, mesh=None):
        if mesh is not None:
            raise NotImplementedError('meshes are not ported to PyTorch yet (ROADMAP.md '
                                      'queue 1 item 14, parallelism)')
        self.config = config
        self.device = resolve_device(device)
        self.ar = ar if ar is not None else ValleAR(config, device=self.device)
        self.nar = nar if nar is not None else ValleNAR(config, device=self.device)
        self.codec = codec if codec is not None else Encodec(decode_dtype=config.dtype,
                                                             device=self.device)
        self.tokenizer = tokenizer if tokenizer is not None else PhonemeTokenizer()

    def batch_synthesize(self, texts: list, prompt_tokens_list: list,
                         prompt_codes_list: list, generator: torch.Generator | None = None,
                         bucket: bool = True) -> list[TTSResult]:
        """B utterances through the whole pipeline together; per-length masks
        keep each item's greedy output equal to its solo synthesis.  Every
        result carries the batch's aggregate RTF and its per-stage times."""
        if not texts:
            return []
        cfg, dev = self.config, self.device
        t0 = time.perf_counter()
        tokens_list = [np.concatenate([np.asarray(pt, np.int64), self.tokenizer(text)])
                       for text, pt in zip(texts, prompt_tokens_list)]
        codes_list = [np.asarray(c, np.int64) for c in prompt_codes_list]
        ttm = max(len(t) for t in tokens_list)
        pm = max(len(c) for c in codes_list)
        if bucket:
            ttm, pm = bucket_len(cfg.bucket_sizes, ttm), bucket_len(cfg.bucket_sizes, pm)
        tokens = np.stack([np.pad(t, (0, ttm - len(t))) for t in tokens_list])
        codes = np.stack([np.pad(c, ((0, pm - len(c)), (0, 0))) for c in codes_list])

        def to_dev(a, dtype):
            return torch.as_tensor(a, dtype=dtype).to(dev)
        tokens_lens = to_dev([len(t) for t in tokens_list], torch.int32)
        p_lens = to_dev([len(c) for c in codes_list], torch.int32)
        if generator is None:
            generator = ar_mod.default_generator(cfg, dev)
        clock = StageClock(dev)
        with torch.inference_mode(), precision_scope(cfg):
            wavs, gen_lens, out_codes = _fused_tts_fn(
                self.ar.params, self.nar.params, self.codec.dec_params,
                to_dev(tokens, torch.long), tokens_lens, to_dev(codes, torch.long), p_lens,
                cfg, generator, clock)
        wavs, gen_lens, out_codes = wavs.cpu().numpy(), gen_lens.cpu().numpy(), \
            out_codes.cpu().numpy()
        wall = time.perf_counter() - t0
        results, total_secs = [], 0.0
        timings = dict(clock.times, batched=wall)
        for i in range(len(texts)):
            n = int(gen_lens[i])
            wav = wavs[i, :n * codec_mod.HOP]
            total_secs += len(wav) / self.codec.sampling_rate
            results.append(TTSResult(wav, out_codes[i, :n], 0.0, timings))
        rtf = wall / max(total_secs, 1e-9)
        for r in results:
            r.rtf = rtf
        return results

    def synthesize_fused(self, text: str, prompt_tokens, prompt_codes,
                         generator: torch.Generator | None = None,
                         bucket: bool = True) -> TTSResult:
        """One utterance through ``batch_synthesize``."""
        return self.batch_synthesize([text], [prompt_tokens], [prompt_codes],
                                     generator=generator, bucket=bucket)[0]
