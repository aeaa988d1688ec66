"""Datasets and loaders for training (``valle2_tpu/data/dataset.py``).

``ValleDataset`` tokenizes any sequence of ``{'audio': {'array',
'sampling_rate'}, 'text'}`` items: phonemes through the frontend, audio
through the codec (length-bucketed batches on the codec's device, the
RVQ-encode kernel on the card), with a persistent npz disk cache keyed by the
dataset, the codec weights and the frontend version -- the JAX package's
file format and key, so either package reads the other's cache.
``SyntheticValleDataset`` and ``DataLoader`` are copies of the JAX package's,
with the same item streams and resume semantics: an item is a pure function
of (seed, index), and the shuffle order of (seed, epoch), so a resumed run
that pins its epoch and skips the batches it already took replays the exact
stream of an uninterrupted one.  ``get_dataloaders`` raises for a HF dataset
name (``datasets.load_dataset`` needs a download) and for ``grammar://``
(``data/grammar.py`` is not ported yet).
"""

from __future__ import annotations

import hashlib
import queue
import threading
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from ..codec import Encodec
from ..codec.encodec import HOP
from ..config import ConfigValle
from ..utils import log_info, normalize_audio
from .collate import get_collate
from .frontend import FRONTEND_VERSION, PhonemeTokenizer


class ValleDataset:
    """Items of an in-memory audio dataset as {'codes': (nq, T), 'tokens': (Tt,)}."""

    def __init__(self, dataset, config: ConfigValle, codec: Encodec | None = None,
                 device=None):
        self.dataset = dataset
        self.config = config
        self.codec = codec if codec is not None else Encodec(
            checkpoint=config.codec_ckpt or None, device=device)
        self.tokenizer = PhonemeTokenizer()
        self.sym2idx = self.tokenizer.sym2idx
        self._cache: dict[int, dict[str, np.ndarray]] = {}

    def _tokenize(self, text: str) -> np.ndarray:
        return self.tokenizer(text)

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        if idx not in self._cache:
            wav, text = self._load_wav(idx)
            self._cache[idx] = {'codes': self.codec.encode(wav).cpu().numpy(),
                                'tokens': self._tokenize(text)}
        return self._cache[idx]

    def _load_wav(self, idx: int) -> tuple[np.ndarray, str]:
        """Item ``idx``'s audio, mono, resampled to 24 kHz and peak-normalized
        on the codec's device, as numpy, and its transcript."""
        item = self.dataset[idx]
        audio = torch.as_tensor(np.asarray(item['audio']['array'], np.float32),
                                device=self.codec.device)
        wav = normalize_audio(audio, item['audio']['sampling_rate'], self.codec.sampling_rate)
        return wav.cpu().numpy(), item['text']

    def _cache_key(self) -> str:
        """Fingerprint of (dataset identity, codec weights, frontend version):
        any of the three changing invalidates the disk cache.  A plain
        sequence is probed at up to 16 evenly spaced items (transcript,
        length, rate, the first and last 64 samples, the sum)."""
        h = hashlib.sha256()
        h.update(f'frontend-v{FRONTEND_VERSION};'.encode())
        h.update(self.codec.fingerprint().encode())
        n = len(self.dataset)
        h.update(str(n).encode())
        hf_fp = getattr(self.dataset, '_fingerprint', None)
        if hf_fp:
            h.update(str(hf_fp).encode())
        else:
            probes = sorted(set(np.linspace(0, n - 1, min(n, 16), dtype=int)) if n else [])
            for idx in probes:
                item = self.dataset[idx]
                audio = np.asarray(item['audio']['array'], np.float32)
                h.update(item['text'].encode())
                h.update(str(len(audio)).encode())
                h.update(str(item['audio']['sampling_rate']).encode())
                h.update(np.ascontiguousarray(audio[:64]).tobytes())
                h.update(np.ascontiguousarray(audio[-64:]).tobytes())
                h.update(np.float64(audio.sum()).tobytes())
        return h.hexdigest()[:24]

    def _cache_file(self, cache_dir) -> Path:
        return Path(cache_dir) / f'codes-{self._cache_key()}.npz'

    def _load_disk_cache(self, cache_dir) -> bool:
        """Fill ``_cache`` from disk; True iff every item was covered (a
        partial, stale or unreadable file is ignored)."""
        path = self._cache_file(cache_dir)
        if not path.exists():
            return False
        try:
            with np.load(path) as z:
                n = int(z['n_items'])
                if n != len(self.dataset):
                    return False
                loaded = {idx: {'codes': z[f'codes_{idx}'].astype(np.int32),
                                'tokens': z[f'tokens_{idx}'].astype(np.int32)}
                          for idx in range(n)}
        except Exception:   # noqa: BLE001 — a corrupt or truncated file: recompute
            log_info('Ignoring unreadable codes cache %s', path)
            return False
        self._cache.update(loaded)
        log_info('Loaded %d precomputed codec items from %s', len(loaded), path)
        return True

    def _save_disk_cache(self, cache_dir) -> None:
        """Write every item as int16 arrays to one npz, atomically (tmp +
        rename)."""
        path = self._cache_file(cache_dir)
        Path(cache_dir).mkdir(parents=True, exist_ok=True)
        arrays: dict[str, np.ndarray] = {'n_items': np.asarray(len(self.dataset))}
        for idx, item in self._cache.items():
            arrays[f'codes_{idx}'] = item['codes'].astype(np.int16)
            arrays[f'tokens_{idx}'] = item['tokens'].astype(np.int16)
        tmp = path.with_suffix('.tmp.npz')
        np.savez(tmp, **arrays)
        tmp.replace(path)
        log_info('Saved codec-token cache (%d items) → %s', len(self._cache), path)

    def precompute_codes(self, batch_size: int = 16,
                         length_buckets: tuple[int, ...] = (2, 4, 8, 12, 16, 24),
                         cache_dir=None) -> None:
        """Tokenize the whole dataset through the codec in length-bucketed
        batches: audio is zero-padded to whole-second buckets (audio past the
        largest gets its own hop-aligned width), encoded with
        ``batch_encode``, and each item's codes are cut back to its true frame
        count.  The codec's strided convs reflect-pad at the sequence end, so
        the padding can change the last ~2 frames of an item that is not
        hop-aligned against its solo ``encode``; one run uses one path.
        Waveforms are loaded per batch (two passes over the dataset).

        ``cache_dir``: a matching disk cache loads every item and encodes
        nothing; otherwise the codes are computed and the cache rewritten."""
        if cache_dir is not None and self._load_disk_cache(cache_dir):
            return
        sr = self.codec.sampling_rate
        groups: dict[int, list[int]] = {}
        for idx in range(len(self.dataset)):
            if idx in self._cache:
                continue
            wav, _ = self._load_wav(idx)                # pass 1: lengths only
            secs = len(wav) / sr
            bucket = next((b for b in length_buckets if secs <= b), None)
            width = -(-len(wav) // HOP) * HOP if bucket is None else int(bucket * sr)
            groups.setdefault(width, []).append(idx)

        for width, idxs in groups.items():
            for start in range(0, len(idxs), batch_size):
                chunk = idxs[start:start + batch_size]
                padded = np.zeros((len(chunk), width), np.float32)
                lens, toks = [], []
                for i, idx in enumerate(chunk):         # pass 2: load within the batch
                    wav, text = self._load_wav(idx)
                    padded[i, :min(len(wav), width)] = wav[:width]
                    lens.append(min(len(wav), width))
                    toks.append(self._tokenize(text))
                batch_codes = self.codec.batch_encode(padded).cpu().numpy()
                for i, idx in enumerate(chunk):
                    n_frames = -(-lens[i] // HOP)
                    self._cache[idx] = {'codes': batch_codes[i, :, :n_frames].copy(),
                                        'tokens': toks[i]}
        log_info('Precomputed codec tokens for %d items', len(self._cache))
        if cache_dir is not None:
            self._save_disk_cache(cache_dir)


class SyntheticValleDataset:
    """Deterministic synthetic items with LJSpeech-like length statistics."""

    def __init__(self, config: ConfigValle, size: int = 256, seed: int = 0,
                 min_frames: int = 60, max_frames: int = 400):
        self.config = config
        self.size = size
        self.seed = seed
        self.min_frames = min_frames
        self.max_frames = max_frames

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        rs = np.random.RandomState(self.seed * 100003 + idx)
        t_codes = rs.randint(self.min_frames, self.max_frames)
        t_tokens = max(4, t_codes // 6)                    # codes_len > tokens_len
        return {
            'codes': rs.randint(0, self.config.num_audio_tokens,
                                (self.config.num_quantizers, t_codes)).astype(np.int32),
            'tokens': rs.randint(0, self.config.vocab_size,
                                 (t_tokens,)).astype(np.int32),
        }


class DataLoader:
    """Minimal shuffling batcher with one background thread of collate."""

    def __init__(self, dataset, batch_size: int, collate_fn, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Pin the NEXT iteration's shuffle epoch: the order is a pure
        function of ``seed + epoch``, so a resumed run replays its stream."""
        self._epoch = int(epoch)

    def _batches(self) -> Iterator[dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        if hasattr(self.dataset, 'set_epoch'):
            self.dataset.set_epoch(self._epoch)
        self._epoch += 1
        for start in range(0, len(order) - (self.batch_size - 1 if self.drop_last else 0),
                           self.batch_size):
            idxs = order[start:start + self.batch_size]
            yield self.collate_fn([self.dataset[int(i)] for i in idxs])

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        """Iterate with one batch of collate running ahead on a thread; a
        dataset or collate error is raised here, and abandoning the pass stops
        the thread."""
        q: queue.Queue = queue.Queue(maxsize=2)
        sentinel = object()
        stop = threading.Event()

        def put_stoppable(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch in self._batches():
                    if not put_stoppable((batch, None)):
                        return
            except BaseException as exc:   # noqa: BLE001 — re-raised in the consumer
                put_stoppable((None, exc))
                return
            put_stoppable((sentinel, None))

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item, exc = q.get()
                if exc is not None:
                    raise exc
                if item is sentinel:
                    return
                yield item
        finally:
            stop.set()          # unblocks the producer; wait for it to leave
            thread.join()


def get_dataloaders(model_name: str, config: ConfigValle,
                    synthetic: bool = False) -> tuple[DataLoader, DataLoader]:
    """Train/valid loaders over the synthetic dataset (the HF and grammar
    datasets raise; ``ValleDataset`` serves in-memory audio items)."""
    if not synthetic:
        if str(config.dataset) == 'grammar' or str(config.dataset).startswith('grammar://'):
            raise NotImplementedError(
                'the grammar dataset is not ported to PyTorch yet (ROADMAP.md queue 1 '
                'item 9, data/grammar.py)')
        raise NotImplementedError(
            f'the HF dataset {config.dataset!r} needs datasets.load_dataset, which '
            'downloads it (ROADMAP.md queue 1 item 9); build a ValleDataset over the '
            'items in memory, or pass synthetic=True')
    collate = get_collate(model_name)(config)
    train_ds = SyntheticValleDataset(config, size=max(8 * config.batch_size, 64))
    valid_ds = SyntheticValleDataset(config, size=max(2 * config.valid_batch_size, 8), seed=1)
    train = DataLoader(train_ds, config.batch_size, collate, shuffle=True, seed=config.seed)
    # Validation keeps the trailing partial batch (torch DataLoader default).
    valid = DataLoader(valid_ds, config.valid_batch_size, collate, shuffle=False,
                       drop_last=False)
    return train, valid
