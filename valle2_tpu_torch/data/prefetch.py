"""Background-thread device prefetch for training (``valle2_tpu/data/prefetch.py``).

``DevicePrefetcher`` runs the dataset iteration, the collate and the
host→device copy on a thread that stays ``size`` batches ahead of the step
loop.  ``place`` maps a host batch to device tensors (``to_device`` copies
from pinned host memory with ``non_blocking=True``); it may return None to
drop a batch, which then never reaches the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable

import numpy as np
import torch

_SENTINEL = object()


def to_device(batch: dict, device) -> dict:
    """numpy batch → tensors on ``device``; on CUDA each array is copied from
    pinned host memory without blocking the host."""
    device = torch.device(device)
    out = {}
    for k, a in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == 'cuda':
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class DevicePrefetcher:
    """Iterate ``loader`` on a background thread, ``size`` placed batches ahead.

    Re-iterable (each ``iter()`` is a fresh pass and thread); a loader error
    is re-raised in the consumer; abandoning the iterator stops the thread."""

    def __init__(self, loader: Iterable, size: int = 2,
                 place: Callable[[Any], Any] | None = None):
        assert size >= 1
        self.loader = loader
        self.size = size
        self.place = place

    def __iter__(self):
        q: queue.Queue = queue.Queue(self.size)
        stop = threading.Event()

        def put_stoppable(item) -> bool:
            """Blocking put that gives up once the consumer has left."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch in self.loader:
                    if self.place is not None:
                        batch = self.place(batch)
                        if batch is None:
                            continue
                    if not put_stoppable((batch, None)):
                        return
            except BaseException as exc:  # noqa: BLE001 — re-raised in the consumer
                put_stoppable((None, exc))
                return
            put_stoppable((_SENTINEL, None))

        thread = threading.Thread(target=producer, daemon=True, name='valle-prefetch')
        thread.start()
        try:
            while True:
                item, exc = q.get()
                if exc is not None:
                    raise exc
                if item is _SENTINEL:
                    return
                yield item
        finally:
            stop.set()          # unblocks the producer; wait for it to leave
            thread.join()
