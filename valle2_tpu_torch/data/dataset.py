"""Datasets and loaders for training (``valle2_tpu/data/dataset.py``).

``SyntheticValleDataset`` and ``DataLoader`` are copies of the JAX package's,
with the same item streams and resume semantics: an item is a pure function
of (seed, index), and the shuffle order of (seed, epoch), so a resumed run
that pins its epoch and skips the batches it already took replays the exact
stream of an uninterrupted one.  The HF (``load_dataset`` + codec encode) and
``grammar://`` datasets need the codec encoder and ``data/grammar.py``, which
are not ported yet; ``get_dataloaders`` raises for them.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from ..config import ConfigValle
from .collate import get_collate


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
    """Train/valid loaders; only the synthetic dataset is ported so far."""
    if not synthetic:
        if str(config.dataset) == 'grammar' or str(config.dataset).startswith('grammar://'):
            raise NotImplementedError(
                'the grammar dataset is not ported to PyTorch yet (ROADMAP.md queue 1 '
                'item 9, data/grammar.py)')
        raise NotImplementedError(
            f'the HF dataset {config.dataset!r} needs the codec encoder, which is not '
            'ported to PyTorch yet (ROADMAP.md queue 1 item 6); pass synthetic=True')
    collate = get_collate(model_name)(config)
    train_ds = SyntheticValleDataset(config, size=max(8 * config.batch_size, 64))
    valid_ds = SyntheticValleDataset(config, size=max(2 * config.valid_batch_size, 8), seed=1)
    train = DataLoader(train_ds, config.batch_size, collate, shuffle=True, seed=config.seed)
    # Validation keeps the trailing partial batch (torch DataLoader default).
    valid = DataLoader(valid_ds, config.valid_batch_size, collate, shuffle=False,
                       drop_last=False)
    return train, valid
