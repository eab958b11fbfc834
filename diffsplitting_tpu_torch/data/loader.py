"""A numpy batcher with background prefetch.

Counterpart: diffsplitting_tpu/data/loader.py (`NumpyLoader`). Samples are
dicts / tuples of numpy arrays; batches are stacked on a new leading axis. A
background thread keeps `prefetch` batches ready, so host-side patch
extraction overlaps the device's steps. The shuffle draws from
`np.random.default_rng(seed)` as the JAX loader does, so the batch order is
the same for the same seed.

Dataset exceptions reach the consumer (forwarded through the queue and
re-raised); abandoning an iteration early (validation's item cap) tells the
worker to exit instead of leaving it blocked on a full queue.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


def _collate(samples):
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([s[k] for s in samples], axis=0) for k in first}
    if isinstance(first, (tuple, list)):
        return tuple(np.stack([s[i] for s in samples], axis=0) for i in range(len(first)))
    return np.stack(samples, axis=0)


class _ExcItem:
    def __init__(self, exc):
        self.exc = exc


class NumpyLoader:
    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        data_len: Optional[int] = None,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)
        n = len(dataset)
        if data_len is not None and data_len > 0:
            n = min(n, int(data_len))
        self._n = n

    def __len__(self):
        if self.drop_last:
            return self._n // self.batch_size
        return (self._n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        order = np.arange(self._n)
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, self._n, self.batch_size):
            idx = order[start: start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield idx

    def __iter__(self) -> Iterator:
        if self.prefetch <= 0:
            for idx in self._batch_indices():
                yield _collate([self.dataset[int(i)] for i in idx])
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            """Bounded put that gives up when the consumer went away."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for idx in self._batch_indices():
                    if stop.is_set():
                        return
                    if not put(_collate([self.dataset[int(i)] for i in idx])):
                        return
            except BaseException as e:  # forwarded to the consumer, which re-raises it
                put(_ExcItem(e))
                return
            put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, _ExcItem):
                    raise item.exc
                yield item
        finally:
            stop.set()
            t.join(timeout=5)
