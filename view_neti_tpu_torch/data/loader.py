"""A prefetching loader: a background thread keeps a small queue of ready
host batches while the card runs the step (view_neti_tpu/data/loader.py).

The producer just runs DataLoader's iterator, so the batch stream, mode 3's
scene draws (group_size) and the start_batch fast-forward are those of the
DataLoader; the consumer moves each batch to the card. `prepare` (a
callable) post-processes each batch inside the thread: the Coach packs and
pins its host tensors there, so that their copy to the card does not hold
up the loop.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

from view_neti_tpu_torch.data.dataset import (DataLoader,
                                              TextualInversionDataset)


class PrefetchLoader:
    """DataLoader with a background prefetch queue of DEPTH batches."""

    DEPTH = 2

    def __init__(self, dataset: TextualInversionDataset, batch_size: int,
                 seed: int = 0, start_batch: int = 0,
                 prepare: Optional[Callable] = None,
                 group_size: Optional[int] = None):
        self.inner = DataLoader(dataset, batch_size, seed=seed,
                                start_batch=start_batch,
                                group_size=group_size)
        self.dataset = dataset
        self.prepare = prepare
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None

    def _produce(self):
        try:
            for batch in self.inner:
                if self._stop.is_set():
                    return
                if self.prepare is not None:
                    batch = self.prepare(batch)
                self._q.put(batch)
        except BaseException as e:   # re-raised in the consumer
            self._error = e
        finally:
            self._q.put(None)

    def __iter__(self) -> Iterator:
        self._stop.clear()
        self._q = queue.Queue(maxsize=self.DEPTH)
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()
        while True:
            batch = self._q.get()
            if batch is None:
                break
            yield batch
        if self._error is not None:
            raise self._error

    def close(self):
        """Stop the producer and wait for it."""
        self._stop.set()
        if self._q is not None:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
        if self._thread is not None:
            self._thread.join(timeout=10)
