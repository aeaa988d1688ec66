"""End-to-end VALL-E X pipelines on PyTorch/CUDA (``valle2_tpu/tts.py``).

TTS (text + cloning prompt → 24 kHz waveform): ``prepare_prompt`` resamples
the prompt recording and encodes it through the codec (the RVQ-encode
kernel), then ``_fused_tts_fn`` runs the AR first-codebook decode (flash
prefill, fused decode steps, best-of-N pick), the NAR 7-stage refinement and
the codec decode over padded batches with true lengths
(``batch_synthesize`` / ``synthesize_fused``), or ``synthesize`` runs the
same stages one model call at a time.  ``synthesize_streaming`` yields the
waveform in chunks while a one-beam ``DecodeStream`` decodes in segments
(each emission refines the frames so far through the NAR and the codec at a
bucketed width), and ``synthesize_longform`` streams unbounded text sentence
by sentence; ``stream_hub.StreamHub`` serves concurrent streams through one
continuous-batching decode loop (``models.continuous``) and refines their
emissions in one batched ``_nar_wav``.  ASR (``ValleASRPipeline``): audio →
codec encode → the direction-swapped AR decode over the phoneme vocabulary,
batched.  ``main`` is the command line of both; ``serve.py`` serves them
over HTTP.  On a ('model',) mesh (``parallel.make_model_mesh``) the AR and the
NAR of ``batch_synthesize`` run tensor-parallel; on a ('data', 'model') mesh
(``parallel.make_mesh``) each data rank runs the pipeline on its rows,
tensor-parallel over its model ranks.  Not ported yet (ROADMAP.md): the
GSPMD fallback (queue 1 item 14).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from .aot import cached_jit, config_key
from .codec import Encodec
from .codec import encodec as codec_mod
from .config import ConfigValle, bucket_len, precision_scope, resolve_device
from .data.frontend import PhonemeTokenizer, split_sentences
from .models import ValleAR, ValleNAR
from .models import ar as ar_mod
from .models import nar as nar_mod
from .parallel import shard_stack
from .profiling import annotate
from .utils import normalize_audio


class StageClock:
    """Wall time per pipeline stage.  ``mark`` synchronizes the device first,
    so each stage's time includes its queued device work.  ``count`` adds to
    a named count of the run (the speculative decode's turns and tokens)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.times: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._last = self._now()

    def count(self, name: str, n: int) -> None:
        self.counts[name] = self.counts.get(name, 0) + int(n)

    def _now(self) -> float:
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def mark(self, stage: str) -> None:
        now = self._now()
        self.times[stage] = self.times.get(stage, 0.0) + now - self._last
        self._last = now

    def skip(self) -> None:
        """Start the next stage now: the time since the last mark counts in
        no stage (a stream's consumer between two chunks)."""
        self._last = self._now()


def _fused_tts_fn(ar_params, nar_params, codec_dec_params, tokens, tokens_lens,
                  prompt_codes, p_lens, config: ConfigValle,
                  generator: torch.Generator | None = None, clock: StageClock | None = None,
                  tp: tuple | None = None):
    """tokens: (B, Ttm), true lens tokens_lens (B,); prompt_codes: (B, Pm, nq),
    true lens p_lens (B,).  Returns (waveforms (B, max_new*320) f32,
    gen_lens (B,), codes (B, max_new, nq)); slice wav[i, :gen_lens[i]*320].
    ``tp`` = (mesh, the AR's rank trees, the NAR's): the AR and the NAR
    tensor-parallel over the mesh's ranks; the codec decodes once, on the
    first device."""
    ar_tp = nar_tp = None
    if tp is not None:
        ar_tp, nar_tp = (tp[0], tp[1]), (tp[0], tp[2])
    eos, bos = config.eos_token, config.bos_token
    max_new = config.max_audio_len
    b, pm = prompt_codes.shape[0], prompt_codes.shape[1]
    dev = tokens.device

    # AR first-codebook decode (BOS-prefixed prompts; valid length p_len + 1).
    codes0 = torch.cat([torch.full((b, 1), bos, dtype=torch.long, device=dev),
                        prompt_codes[:, :, 0]], dim=1)
    with annotate('ar_decode'):
        codes_buf, _, best = ar_mod._decode_fn(ar_params, tokens, tokens_lens, codes0,
                                               p_lens + 1, config, generator, clock, ar_tp)
    rows = codes_buf[torch.arange(b, device=dev), best]             # (B, Pm+1+max_new)
    gen_region = rows[:, pm + 1:]
    is_eos = gen_region == eos
    gen_lens = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1),
                           torch.full_like(best, max_new))
    first_layer = torch.where(is_eos, 0, gen_region)                # in-vocab past EOS

    with annotate('nar_refine'):
        codes = nar_mod._generate_fn(nar_params, tokens, tokens_lens, prompt_codes, p_lens,
                                     first_layer, gen_lens, config, generator, nar_tp)
    if clock is not None:
        clock.mark('nar')
    # The codec is causal: frames past gen_len cannot change earlier samples.
    with annotate('codec_decode'):
        wavs = codec_mod.decode(codec_dec_params, codes.transpose(1, 2)).float()
    if clock is not None:
        clock.mark('codec')
    return wavs, gen_lens, codes


def _nar_wav_fn(nar_params, codec_dec_params, tokens, tokens_lens, pcodes, p_lens,
                first_layer, gen_lens, config: ConfigValle, generator: torch.Generator):
    """A stream emission's refinement (JAX ``_nar_wav``): the NAR stages over
    the first-codebook buffers, then the codec decode.  Returns (waveforms
    (rows, width * HOP), codes (rows, width, nq)) on the device."""
    codes = nar_mod._generate_fn(nar_params, tokens, tokens_lens, pcodes, p_lens,
                                 first_layer, gen_lens, config, generator)
    return codec_mod.decode(codec_dec_params, codes.transpose(1, 2)).float(), codes


@dataclass
class TTSResult:
    waveform: np.ndarray            # (T,) float32 @ 24 kHz
    codes: np.ndarray               # (frames, num_quantizers)
    rtf: float                      # wall-clock / audio-seconds
    timings: dict[str, float]
    counts: dict[str, int] = dataclasses.field(default_factory=dict)   # StageClock.counts


class AudioStream:
    """The waveform chunks of one streamed request (24 kHz float32 numpy
    arrays), as an iterator, with their timings: ``clock``, a StageClock of
    'prefill', 'decode' (the AR segments) and 'nar_codec' (the emissions'
    NAR and codec passes); ``first_audio_s``, the wall time from the call to
    the first chunk; ``chunk_s``, the wall time spent producing each chunk
    (inside ``next``)."""

    def __init__(self, chunks, clock: StageClock, t0: float):
        self._chunks, self.clock, self._t0 = chunks, clock, t0
        self.first_audio_s: float | None = None
        self.chunk_s: list[float] = []

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        t = time.perf_counter()
        wav = next(self._chunks)
        now = time.perf_counter()
        self.chunk_s.append(now - t)
        if self.first_audio_s is None:
            self.first_audio_s = now - self._t0
        return wav


def _draw_seed(generator: torch.Generator) -> int:
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator, device=generator.device))


def _split_seed(base: int, *key: int) -> tuple[int, int]:
    """(AR seed, NAR seed) from ``base`` and ``key``: the port's
    ``jax.random.split`` (and, with a sentence index as the key,
    ``fold_in``), so that what one key's decode draws does not depend on
    another's."""
    ar_seed, nar_seed = np.random.SeedSequence([base, *key]).generate_state(2, np.uint64)
    return int(ar_seed), int(nar_seed)


class ValleTTS:
    """text (+ cloning prompt codes) → waveform, on one device or
    tensor-parallel over a ('model',) mesh."""

    def __init__(self, config: ConfigValle, ar: ValleAR | None = None,
                 nar: ValleNAR | None = None, codec: Encodec | None = None,
                 tokenizer: PhonemeTokenizer | None = None, device=None, mesh=None):
        """``mesh``: a ``parallel.Mesh``: ``batch_synthesize`` (and so
        ``synthesize_fused``) runs over it.  On a ('model',) mesh the AR and
        the NAR run tensor-parallel over its ranks (JAX ``ValleTTS`` on a
        ('model',) mesh); the codec, the prompt encode and everything
        outside the two stacks run on its first device, as do streaming and
        the hub (on no mesh in the JAX package either).  A ('data', 'model')
        mesh pads the rows to a multiple of the data size and each data rank
        runs the whole pipeline on its rows on its devices, tensor-parallel
        over its model ranks where there are several, with its own generator
        (``ar.replica_generators``).  int8 weights and splits that do not
        divide take the JAX package's GSPMD path, which is not ported, and
        raise."""
        self.config = config
        self.mesh = mesh
        if mesh is not None:
            if mesh.pipe > 1:
                raise ValueError('a pipeline mesh trains (parallel.pipeline); serve over a '
                                 '(\'data\', \'model\') or a (\'model\',) mesh')
            if config.weight_dtype == 'int8':
                raise NotImplementedError('int8 weights on a mesh take the GSPMD path, which '
                                          'is not ported (ROADMAP.md queue 1 item 14)')
            if mesh.model > 1:
                ar_mod.check_tp(config, mesh.model)
            if ar is not None and ar.mesh is not mesh:
                raise ValueError('the AR model must be on the pipeline\'s mesh')
            device = mesh.devices[0] if device is None else device
        self.device = resolve_device(device)
        self._mesh_cache: dict[int, tuple] = {}
        self._replica_cache: dict[tuple, tuple] = {}
        self.ar = ar if ar is not None else ValleAR(config, device=self.device, mesh=mesh)
        self.nar = nar if nar is not None else ValleNAR(config, device=self.device)
        self.codec = codec if codec is not None else Encodec(decode_dtype=config.dtype,
                                                             device=self.device)
        self.tokenizer = tokenizer if tokenizer is not None else PhonemeTokenizer()
        self._stream_lock = threading.Lock()
        self._stream_ar: ValleAR | None = None
        # The fused pipeline and a stream's emission as aot.CachedJit call
        # sites: their first call of each signature counts the kernel
        # libraries built or loaded (TTSServer.stats()'s aot_* counters).
        self._fused_jit = cached_jit(_fused_tts_fn, tag='tts_fused',
                                     extra_key=config_key(config))
        self._nar_wav_jit = cached_jit(_nar_wav_fn, tag='tts_stream_narwav',
                                       extra_key=config_key(config))

    def _mesh_trees(self, ar_view=None, nar_params=None):
        """(mesh, the AR's rank trees, the NAR's), or None without a mesh:
        the default model's, or those of ``batch_synthesize``'s override
        trees (JAX ``_mesh_params``)."""
        if self.mesh is None:
            return None
        ar_trees = self.ar._decode_tparams()[1] if ar_view is None \
            else self._split_stack(ar_view['transformer'])
        return self.mesh, ar_trees, self._split_stack(
            (self.nar.params if nar_params is None else nar_params)['transformer'])

    def _split_stack(self, stack):
        """``stack``'s rank trees, split once per stack: the cache is keyed
        by identity and holds the source, so its id stays live, and a server
        alternating a handful of voices splits each only once."""
        hit = self._mesh_cache.get(id(stack))
        if hit is None:
            hit = self._mesh_cache[id(stack)] = (
                stack, shard_stack(stack, self.mesh, self.config.torch_dtype))
        return hit[1]

    def _replica_trees(self, i: int, nar_params, o_ar):
        """Data rank ``i``'s NAR params and codec decoder on its first
        device, and its TP context (its ('model',) mesh, the AR's and the
        NAR's rank trees) or None; made once per params tree."""
        key = (i, id(nar_params), id(o_ar))
        hit = self._replica_cache.get(key)
        if hit is not None and hit[0] is nar_params and hit[1] is o_ar:
            return hit[2]
        sub = self.mesh.replica(i)
        dev = sub.devices[0]
        nar = nar_params if dev == self.device else ar_mod.move_tree(nar_params, dev)
        codec = self.codec.dec_params if dev == self.device else \
            ar_mod.move_tree(self.codec.dec_params, dev)
        tp = None
        if sub.size > 1:
            ar_view = self.ar.replicas(o_ar)[i - self.mesh.local_data.start]
            tp = (sub, ar_view[1][1],
                  shard_stack(nar_params['transformer'], sub, self.config.torch_dtype))
        out = (nar, codec, tp)
        self._replica_cache[key] = (nar_params, o_ar, out)
        return out

    def _data_synthesize(self, o_ar, o_nar, args, generator, clock):
        """``_fused_tts_fn`` per data rank on its rows, each with its own
        generator: ``parallel.data_shard_map`` on a data-only mesh,
        ``parallel.tp_shard_map`` (the AR's and the NAR's rank trees per
        model rank) under a model axis, as JAX ``ValleTTS`` picks.  Returns
        (waveforms, gen_lens, codes) of every row on the first device."""
        from .parallel import PerReplica, data_shard_map, tp_shard_map
        cfg, mesh = self.config, self.mesh
        ar_reps = self.ar.replicas(o_ar)
        nar_params = self.nar.params if o_nar is None else o_nar
        reps, trees = PerReplica(), []
        for k, i in enumerate(mesh.local_data):
            nar, codec, tp = self._replica_trees(i, nar_params, o_ar)
            reps.append((ar_reps[k][0], nar, codec))
            if tp is not None:
                trees.extend(zip(tp[1], tp[2]))
        gens = PerReplica(ar_mod.replica_generators(generator, mesh))
        if mesh.model == 1:
            def body(rep, tokens, tokens_lens, codes, p_lens, gen):
                ar_p, nar_p, codec_p = rep
                return self._fused_jit(ar_p, nar_p, codec_p, tokens, tokens_lens, codes,
                                       p_lens, cfg, gen, clock, None)
            return data_shard_map(mesh, body, 6, (1, 2, 3, 4), 3)(reps, *args, gens)

        def tp_body(sub, group, rep, tokens, tokens_lens, codes, p_lens, gen):
            ar_p, nar_p, codec_p = rep
            tp = (sub, [a for a, _ in group], [n for _, n in group])
            return self._fused_jit(ar_p, nar_p, codec_p, tokens, tokens_lens, codes, p_lens,
                                   cfg, gen, clock, tp)
        return tp_shard_map(mesh, tp_body, 7, (2, 3, 4, 5), 3)(trees, reps, *args, gens)

    def prepare_prompt(self, prompt_audio, prompt_sr: int, prompt_text: str
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Cloning prompt → (prompt_tokens, prompt_codes (T, nq)): the audio
        (on the model's device) resampled to 24 kHz and encoded."""
        with annotate('prompt_encode'):
            audio = torch.as_tensor(prompt_audio, dtype=torch.float32, device=self.device)
            wav = normalize_audio(audio, prompt_sr, self.codec.sampling_rate)
            codes = self.codec.encode(wav).cpu().numpy().T
        return self.tokenizer(prompt_text), codes

    def batch_synthesize(self, texts: list, prompt_tokens_list: list,
                         prompt_codes_list: list, generator: torch.Generator | None = None,
                         bucket: bool = True,
                         override_params: tuple | None = None) -> list[TTSResult]:
        """B utterances through the whole pipeline together; per-length masks
        keep each item's greedy output equal to its solo synthesis.  Every
        result carries the batch's aggregate RTF and its per-stage times.

        ``override_params``: optional ``(ar_params, nar_params)`` to run this
        batch with other weights (multi-voice serving: LoRA fine-tunes merged
        per voice); a ``None`` entry keeps the default model's.  Pass the AR
        as a ``ValleAR(...).decode_params`` view under ``weight_dtype``
        'int8' / 'int4'.  On a mesh the override's stacks are split over the
        ranks once per tree; int4 there packs per rank from the default
        model's float stack, so an override raises."""
        if not texts:
            return []
        if override_params is not None and self.mesh is not None \
                and self.config.weight_dtype == 'int4':
            raise NotImplementedError(
                'override_params with int4 weights under manual TP is not '
                'supported — register the voice on its own ValleTTS/mesh')
        cfg, dev = self.config, self.device
        t0 = time.perf_counter()
        tokens_list = [np.concatenate([np.asarray(pt, np.int64), self.tokenizer(text)])
                       for text, pt in zip(texts, prompt_tokens_list)]
        codes_list = [np.asarray(c, np.int64) for c in prompt_codes_list]
        data_mesh = self.mesh is not None and 'data' in self.mesh.axis_names
        if data_mesh:          # rows padded to a multiple of the data size (row 0 again)
            pad_rows = (-len(texts)) % self.mesh.data
            tokens_list = tokens_list + [tokens_list[0]] * pad_rows
            codes_list = codes_list + [codes_list[0]] * pad_rows
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
        o_ar, o_nar = override_params if override_params is not None else (None, None)
        with torch.inference_mode(), precision_scope(cfg):
            # The AR decodes from its (possibly quantized) decode params; the
            # NAR and the codec stay in full precision, as in the JAX package.
            args = (to_dev(tokens, torch.long), tokens_lens, to_dev(codes, torch.long), p_lens)
            if data_mesh:
                wavs, gen_lens, out_codes = self._data_synthesize(o_ar, o_nar, args,
                                                                  generator, clock)
            else:
                wavs, gen_lens, out_codes = self._fused_jit(
                    self.ar.decode_params if o_ar is None else o_ar,
                    self.nar.params if o_nar is None else o_nar, self.codec.dec_params,
                    *args, cfg, generator, clock, self._mesh_trees(o_ar, o_nar))
        wavs, gen_lens, out_codes = wavs.cpu().numpy(), gen_lens.cpu().numpy(), \
            out_codes.cpu().numpy()
        wall = time.perf_counter() - t0
        results, total_secs = [], 0.0
        timings = dict(clock.times, batched=wall)
        for i in range(len(texts)):
            n = int(gen_lens[i])
            wav = wavs[i, :n * codec_mod.HOP]
            total_secs += len(wav) / self.codec.sampling_rate
            results.append(TTSResult(wav, out_codes[i, :n], 0.0, timings,
                                     dict(clock.counts)))
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

    def synthesize_streaming(self, text: str, prompt_tokens, prompt_codes,
                             chunk_frames: int = 75, lookahead_frames: int = 38,
                             generator: torch.Generator | None = None,
                             bucket: bool = True) -> AudioStream:
        """24 kHz waveform chunks while the AR decode runs (JAX
        ``synthesize_streaming``).  A one-beam ``DecodeStream`` advances
        ``chunk_frames`` tokens per segment; its tokens equal one unsegmented
        decode's.  A frame is emitted once the stream is ``lookahead_frames``
        past it, refined by a NAR pass over the frames so far and decoded by
        the codec (causal: emitted samples are exact given their codes); the
        NAR is bidirectional, so the lookahead bounds how much later context
        an emitted frame has seen.  With ``lookahead_frames >=
        max_audio_len`` there is one emission, ``synthesize_fused``'s
        waveform.  The prefill and the argument checks run at call time; the
        returned ``AudioStream`` decodes as it is iterated."""
        _check_stream_args(chunk_frames, lookahead_frames)
        t0 = time.perf_counter()
        clock = StageClock(self.device)
        if generator is None:
            generator = ar_mod.default_generator(self.config, self.device)
        seeds = _split_seed(_draw_seed(generator))
        tokens = np.concatenate([np.asarray(prompt_tokens, np.int64), self.tokenizer(text)])
        pcodes = np.asarray(prompt_codes, np.int64).reshape(-1, self.config.num_quantizers)
        stream, emitter = self._seeded_stream(tokens, pcodes, seeds, lookahead_frames, bucket)
        clock.mark('prefill')
        return AudioStream(_stream_chunks(stream, emitter, chunk_frames, clock), clock, t0)

    def synthesize_longform(self, text: str, prompt_tokens, prompt_codes,
                            carry: str = 'prompt', max_chain_frames: int = 450,
                            chunk_frames: int = 75, lookahead_frames: int = 38,
                            generator: torch.Generator | None = None,
                            bucket: bool = True) -> AudioStream:
        """24 kHz waveform chunks for text of any length (JAX
        ``synthesize_longform``): the text is split into sentences
        (``data.frontend.split_sentences``) and each is streamed as by
        ``synthesize_streaming``, so no decode passes ``max_audio_len``.
        carry='prompt': every sentence is conditioned on the original prompt
        (greedy: each sentence equals ``synthesize_streaming`` of it alone).
        carry='chain': sentence i+1 is conditioned on the original prompt
        followed by sentence i's text and its final refined codes, or on the
        original prompt alone where those would pass ``max_chain_frames``.
        Sentence i's generators derive from one draw of ``generator`` and i,
        not from what earlier sentences drew."""
        if carry not in ('prompt', 'chain'):
            raise ValueError(f"carry must be 'prompt' or 'chain', got {carry!r}")
        _check_stream_args(chunk_frames, lookahead_frames)
        t0 = time.perf_counter()
        clock = StageClock(self.device)
        sentences = split_sentences(text)
        if generator is None:
            generator = ar_mod.default_generator(self.config, self.device)
        base = _draw_seed(generator)
        nq = self.config.num_quantizers
        base_tokens = np.asarray(prompt_tokens, np.int64)
        base_codes = np.asarray(prompt_codes, np.int64).reshape(-1, nq)

        def chunks():
            cur_tokens, cur_codes = base_tokens, base_codes
            for i, sent in enumerate(sentences):
                sent_tokens = self.tokenizer(sent)
                tokens = np.concatenate([cur_tokens, sent_tokens])
                stream, emitter = self._seeded_stream(tokens, cur_codes, _split_seed(base, i),
                                                      lookahead_frames, bucket)
                clock.mark('prefill')
                yield from _stream_chunks(stream, emitter, chunk_frames, clock)
                if carry == 'chain' and emitter.last_codes is not None:
                    chained = np.concatenate([base_codes, emitter.last_codes])
                    if len(chained) <= max_chain_frames:
                        cur_tokens = np.concatenate([base_tokens, sent_tokens])
                        cur_codes = chained
                    else:
                        cur_tokens, cur_codes = base_tokens, base_codes

        return AudioStream(chunks(), clock, t0)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _seeded_stream(self, tokens, pcodes, seeds: tuple[int, int], lookahead_frames: int,
                       bucket: bool = True):
        """One utterance's ``DecodeStream`` (prefilled now, sampling from
        ``seeds[0]``) and its ``_ChunkEmitter`` (refining with ``seeds[1]``):
        what a stream and each sentence of a long-form stream run."""
        stream = ar_mod.DecodeStream(self._ensure_stream_models(), tokens, pcodes,
                                     self._generator(seeds[0]), bucket)
        return stream, _ChunkEmitter(self, tokens, pcodes, lookahead_frames, seeds[1], bucket)

    def _ensure_stream_models(self) -> ValleAR:
        """The streaming AR model, made once under a lock: a one-beam sibling
        of ``self.ar`` sharing its params (rebound here whenever ``self.ar``'s
        are, so ``tts.ar.load()`` reaches streams) and, under ``weight_dtype``
        int8 / int4, its quantized view.  At ``max_audio_len >= 1024`` it
        forces the cache chunk to 512 slots, so the early steps of a stream
        read the occupied chunks only; an explicit ``decode_chunk`` wins."""
        with self._stream_lock:
            if self._stream_ar is None:
                chunk = self.config.decode_chunk
                if chunk == 0 and self.config.max_audio_len >= 1024:
                    chunk = 512
                cfg1 = dataclasses.replace(self.config, num_beams=1, decode_chunk=chunk)
                self._stream_ar = ValleAR(cfg1, params=self.ar.params, device=self.device)
            model = self._stream_ar
            if model.params is not self.ar.params:
                model.params = self.ar.params
            if self.config.weight_dtype in ('int8', 'int4'):
                model._qdecode = self.ar.decode_params
                model._qdecode_src = (model.params, model.params['transformer'])
        return model

    def _nar_wav(self, tokens, tokens_lens, pcodes, p_lens, first_layer: np.ndarray,
                 gen_lens, seed: int) -> tuple[np.ndarray, np.ndarray]:
        """Emissions' refinement (JAX ``_nar_wav_jit``): the NAR stages over
        the (rows, width) first-codebook buffers with true lengths
        ``gen_lens`` (rows,), then the codec decode at that width; one row for
        a stream's emission, every slot of a hub for its batched one.  tokens
        (rows, Ttm), pcodes (rows, Pm, nq) and their lengths are on the
        device.  Returns (waveforms (rows, width * HOP), codes (rows, width,
        nq))."""
        dev = self.device
        first = torch.as_tensor(first_layer, dtype=torch.long).to(dev)
        gen = torch.as_tensor(np.asarray(gen_lens), dtype=torch.int32).to(dev)
        with torch.inference_mode(), precision_scope(self.config):
            wav, codes = self._nar_wav_jit(self.nar.params, self.codec.dec_params, tokens,
                                           tokens_lens, pcodes, p_lens, first, gen,
                                           self.config, self._generator(seed))
        return wav.cpu().numpy(), codes.cpu().numpy()

    def synthesize(self, text: str, prompt_tokens, prompt_codes,
                   generator: torch.Generator | None = None) -> TTSResult:
        """The staged pipeline, one model call per stage: AR decode, NAR
        refinement, codec decode.  prompt_codes: (T, num_quantizers) from
        ``prepare_prompt``.  Greedy codes equal ``synthesize_fused``'s."""
        if generator is None:
            generator = ar_mod.default_generator(self.config, self.device)
        clock = StageClock(self.device)
        with annotate('frontend'):
            target_tokens = self.tokenizer(text)
        clock.mark('frontend')
        with annotate('ar_decode'):
            first_layer = self.ar.generate(prompt_tokens, prompt_codes, target_tokens,
                                           generator=generator)
        clock.mark('ar_decode')
        with annotate('nar_refine'):
            codes = self.nar.generate(prompt_tokens, prompt_codes, target_tokens, first_layer,
                                      generator=generator).numpy()
        clock.mark('nar_refine')
        with annotate('codec_decode'):
            wav = self.codec.decode(codes.T).cpu().numpy()
        clock.mark('codec_decode')
        rtf = sum(clock.times.values()) / max(len(wav) / self.codec.sampling_rate, 1e-9)
        return TTSResult(wav, codes, rtf, clock.times)

    def __call__(self, text: str, prompt_audio, prompt_sr: int, prompt_text: str,
                 generator: torch.Generator | None = None) -> TTSResult:
        tokens, codes = self.prepare_prompt(prompt_audio, prompt_sr, prompt_text)
        return self.synthesize(text, tokens, codes, generator)


HOP = codec_mod.HOP   # EnCodec-24kHz samples per codec frame


def _check_stream_args(chunk_frames: int, lookahead_frames: int) -> None:
    """At call time: a generator that checked them at its first step would
    spin forever on chunk_frames 0."""
    if int(chunk_frames) < 1:
        raise ValueError(f'chunk_frames must be >= 1, got {chunk_frames}')
    if int(lookahead_frames) < 0:
        raise ValueError(f'lookahead_frames must be >= 0, got {lookahead_frames}')


def stream_widths(config: ConfigValle) -> list[int]:
    """The NAR widths of a stream's emissions: ``bucket_sizes`` below
    ``max_audio_len``, then doublings, ending at ``max_audio_len``."""
    max_new = config.max_audio_len
    widths = [b for b in config.bucket_sizes if b < max_new]
    w = widths[-1] if widths else 0
    while w < max_new:
        w = max_new if w == 0 else min(w * 2, max_new)
        widths.append(w)
    return widths


def finalize_frames(n: int, done: bool, lookahead: int) -> int:
    """Frames safe to emit: every frame once the stream ended, else those
    ``lookahead`` frames behind the newest."""
    return n if done else max(0, n - lookahead)


def _stream_chunks(stream, emitter: _ChunkEmitter, chunk_frames: int, clock: StageClock):
    """Advance ``stream`` by ``chunk_frames`` a segment and yield what each
    segment lets ``emitter`` finalize, until the stream ends."""
    while True:
        new = stream.advance(chunk_frames)
        clock.mark('decode')
        wavs = emitter.push(new, stream.finished)
        clock.mark('nar_codec')
        for wav in wavs:
            yield wav
            clock.skip()
        if stream.finished:
            return


class _ChunkEmitter:
    """A stream's emission state (JAX ``_ChunkEmitter``): gathers the AR
    first-codebook tokens and, once the stream is ``lookahead_frames`` past a
    frame, refines the prefix through the NAR and the codec at the smallest
    of ``stream_widths`` that holds it (positions past the true length are
    masked, so a narrow pass gives the full-width pass's frames) and returns
    the newly finalized samples.  Every pass draws from a generator seeded
    with ``nar_seed`` anew, as JAX passes the same key to each."""

    def __init__(self, tts: ValleTTS, tokens, pcodes, lookahead_frames: int, nar_seed: int,
                 bucket: bool = True):
        config, dev = tts.config, tts.device
        self._tts = tts
        self._lookahead = int(lookahead_frames)
        self._seed = nar_seed
        ttm, pm = len(tokens), len(pcodes)
        if bucket:
            ttm, pm = bucket_len(config.bucket_sizes, ttm), bucket_len(config.bucket_sizes, pm)
        self._tokens = torch.as_tensor(np.pad(tokens, (0, ttm - len(tokens)))[None]).to(dev)
        self._pcodes = torch.as_tensor(
            np.pad(pcodes, ((0, pm - len(pcodes)), (0, 0)))[None]).to(dev)
        self._lens = torch.tensor([[len(tokens)], [len(pcodes)]], dtype=torch.int32, device=dev)
        self._widths = stream_widths(config)
        self._buf = np.zeros((config.max_audio_len,), np.int64)
        self._n = 0
        self._emitted = 0
        #: The last refinement's codes (n_generated, num_quantizers): the full
        #: context's once the stream ended; None before the first emission.
        self.last_codes: np.ndarray | None = None

    def push(self, new, done: bool) -> list[np.ndarray]:
        """Feed the newly decoded tokens and the stream's end flag; returns
        the waveform chunks (none or one) this push finalizes."""
        self._buf[self._n:self._n + len(new)] = new
        self._n += len(new)
        finalize = finalize_frames(self._n, done, self._lookahead)
        if finalize <= self._emitted:
            return []
        width = next(b for b in self._widths if b >= self._n)
        wav, codes = self._tts._nar_wav(self._tokens, self._lens[0], self._pcodes,
                                        self._lens[1], self._buf[None, :width], [self._n],
                                        self._seed)
        out = wav[0, self._emitted * HOP:finalize * HOP]
        self.last_codes = codes[0, :self._n]
        self._emitted = finalize
        return [out]


class ValleASRPipeline:
    """audio → codec tokens → phoneme transcription (direction-swapped AR
    model): the source stream is the first-codebook codes, the target stream
    the phonemes with BOS/EOS at vocab_size + 1 / vocab_size."""

    def __init__(self, config: ConfigValle, ar: ValleAR | None = None,
                 codec: Encodec | None = None, tokenizer: PhonemeTokenizer | None = None,
                 device=None):
        if config.direction != 'asr':
            config = dataclasses.replace(config, direction='asr')
        self.config = config
        self.device = resolve_device(device)
        self.ar = ar if ar is not None else ValleAR(config, device=self.device)
        self.codec = codec if codec is not None else Encodec(device=self.device)
        self.tokenizer = tokenizer if tokenizer is not None else PhonemeTokenizer()

    def transcribe(self, audio, sr: int, generator: torch.Generator | None = None,
                   output: str = 'text'):
        """One utterance → English text (``output='phonemes'``: the ARPAbet
        symbol list)."""
        return self.batch_transcribe([audio], [sr], generator, output=output)[0]

    def batch_transcribe(self, audios: list, srs: list[int],
                         generator: torch.Generator | None = None, output: str = 'text'):
        """All utterances' codec tokens decode through one batched AR loop;
        per-item masks keep each result equal to its solo decode.
        ``output='text'`` inverts the phonemes to words through the bundled
        lexicon; ``output='phonemes'`` returns the ARPAbet symbol lists."""
        if output not in ('text', 'phonemes'):
            raise ValueError(f"output must be 'text' or 'phonemes', got {output!r}")
        tokens_list, codes_list = [], []
        for audio, sr in zip(audios, srs):
            audio = torch.as_tensor(audio, dtype=torch.float32, device=self.codec.device)
            wav = normalize_audio(audio, sr, self.codec.sampling_rate)
            tokens_list.append(self.codec.encode(wav)[0].cpu())    # first codebook
            codes_list.append(np.zeros((0, self.config.num_quantizers), np.int64))
        outs = self.ar.generate_batch(tokens_list, codes_list, generator=generator)
        convert = self.tokenizer.decode if output == 'phonemes' else self.tokenizer.to_text
        return [convert(ids.numpy()) for ids in outs]


def main(argv=None):
    """CLI: synthesize speech or transcribe audio.

    TTS:  python -m valle2_tpu_torch.tts -c cfg.json --text "..." \\
            --prompt-wav p.wav --prompt-text "..." -o out.wav \\
            [--ar-ckpt PATH --nar-ckpt PATH --codec-ckpt FILE] [--device cuda|cpu] \\
            [--compile-cache DIR] [--aot-cache DIR]
    ASR:  python -m valle2_tpu_torch.tts -c cfg.json --transcribe in.wav
    """
    import argparse
    from pathlib import Path

    from .utils import load_audio, log_info, save_wav

    parser = argparse.ArgumentParser(description='VALL-E X synthesis/transcription '
                                                 '(PyTorch/CUDA)')
    parser.add_argument('-c', '--config', type=Path, default=None)
    parser.add_argument('--text', type=str, help='Text to synthesize')
    parser.add_argument('--prompt-wav', type=Path, help='Cloning prompt audio (wav)')
    parser.add_argument('--prompt-text', type=str, default='',
                        help='Transcript of the prompt audio')
    parser.add_argument('-o', '--output', type=Path, default=Path('out.wav'))
    parser.add_argument('--transcribe', type=Path, default=None,
                        help='ASR mode: audio file to transcribe')
    parser.add_argument('--ar-ckpt', type=Path, default=None,
                        help='AR params file or trainer step dir')
    parser.add_argument('--nar-ckpt', type=Path, default=None,
                        help='NAR params file or trainer step dir')
    parser.add_argument('--codec-ckpt', type=Path, default=None,
                        help='Pretrained EnCodec torch checkpoint to convert')
    parser.add_argument('--seed', type=int, default=None)
    parser.add_argument('--device', type=str, default='cuda', help="'cuda' or 'cpu'")
    parser.add_argument('--compile-cache', type=Path, default=None,
                        help='Kernel-build cache dir: the CUDA libraries are built and found '
                             'there, so a re-run skips nvcc (also $VALLE2_COMPILE_CACHE / '
                             'config.compile_cache_dir; default valle2_tpu_torch/_build)')
    parser.add_argument('--aot-cache', type=Path, default=None,
                        help='AOT library dir, searched before the kernel-build cache and '
                             'filled after a build (also $VALLE2_AOT_CACHE / '
                             'config.aot_cache_dir)')
    args = parser.parse_args(argv)

    config = ConfigValle.from_json(args.config) if args.config else ConfigValle()
    from .aot import enable_aot_cache
    from .compile_cache import enable_compilation_cache
    enable_compilation_cache(args.compile_cache, fallback=config.compile_cache_dir)
    enable_aot_cache(args.aot_cache, fallback=config.aot_cache_dir)
    if args.seed is not None:
        config.seed = args.seed
    device = torch.device(args.device)
    codec = Encodec(checkpoint=str(args.codec_ckpt) if args.codec_ckpt else None,
                    decode_dtype=config.dtype, device=device)

    if args.transcribe is not None:
        asr = ValleASRPipeline(config, codec=codec, device=device)
        if args.ar_ckpt:
            asr.ar.load(args.ar_ckpt)
        wav = load_audio(args.transcribe, target_sr=codec.sampling_rate, device=device)
        print(asr.transcribe(wav, codec.sampling_rate))
        return

    if not (args.text and args.prompt_wav):
        parser.error('--text and --prompt-wav are required for TTS')
    tts = ValleTTS(config, codec=codec, device=device)
    if args.ar_ckpt:
        tts.ar.load(args.ar_ckpt)
    if args.nar_ckpt:
        tts.nar.load(args.nar_ckpt)
    prompt = load_audio(args.prompt_wav, target_sr=codec.sampling_rate, device=device)
    tokens, codes = tts.prepare_prompt(prompt, codec.sampling_rate, args.prompt_text)
    result = tts.synthesize_fused(args.text, tokens, codes)
    save_wav(args.output, result.waveform, codec.sampling_rate)
    log_info('Wrote %s (%.2f s audio, RTF %.4f)', args.output,
             len(result.waveform) / codec.sampling_rate, result.rtf)


if __name__ == '__main__':
    main()
