"""Host-sharded prefetch loader and length bucketing (the port's
``repro/data/loader.py``).

``HostShardedLoader(make_iter)`` runs ``make_iter(shard, n_shards)`` on a
background thread, a few batches ahead of the consumer, and yields its
batches in the order the iterator gives them, each array as a CPU tensor
(in pinned memory with ``pin_memory=True``, so that the copy to the card
can be ``non_blocking``). One process is one host here: ``shard`` picks
this host's slice of the data, as the JAX loader's does. An error in the
iterator is raised in the consumer; ``close()`` stops the thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, List, Sequence

import numpy as np
import torch

_END = object()


class _Failed:
    def __init__(self, error: BaseException):
        self.error = error


class HostShardedLoader:
    """Wraps a batch iterator factory with host sharding and prefetch.

    ``make_iter(shard, n_shards)`` must return an iterator of dict batches
    of numpy arrays whose leading dim is the per-host batch. Usable as a
    context manager (``close()`` on exit).
    """

    def __init__(
        self,
        make_iter: Callable[[int, int], Iterator[Dict[str, np.ndarray]]],
        *,
        shard: int = 0,
        n_shards: int = 1,
        prefetch: int = 2,
        pin_memory: bool = False,
    ):
        self.shard = shard
        self.n_shards = n_shards
        self.pin_memory = pin_memory
        self._it = make_iter(shard, n_shards)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(target=self._fill, daemon=True,
                                        name="HostShardedLoader")
        self._thread.start()

    def _tensors(self, batch: Dict[str, np.ndarray]
                 ) -> Dict[str, torch.Tensor]:
        out = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in batch.items()}
        if self.pin_memory:
            out = {k: t.pin_memory() for k, t in out.items()}
        return out

    def _put(self, item) -> bool:
        """Queue ``item`` unless the loader is closed meanwhile."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def _fill(self) -> None:
        try:
            for batch in self._it:
                if self._stop.is_set() or not self._put(self._tensors(batch)):
                    return
        except BaseException as e:   # raised again in the consumer
            self._put(_Failed(e))
            return
        self._put(_END)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is _END:
            self._done = True
            raise StopIteration
        if isinstance(item, _Failed):
            self._done = True
            raise item.error
        return item

    def close(self) -> None:
        """Stop the prefetch thread and drop the batches it queued."""
        self._stop.set()
        self._done = True
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)

    def __enter__(self) -> "HostShardedLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def length_bucket(
    lengths: Sequence[int],
    boundaries: Sequence[int],
) -> List[List[int]]:
    """Group example indices into length buckets (minimizes padding).

    Returns one list of indices per bucket; bucket i holds lengths in
    (boundaries[i-1], boundaries[i]], the last one those past every
    boundary.
    """
    buckets: List[List[int]] = [[] for _ in range(len(boundaries) + 1)]
    for idx, ln in enumerate(lengths):
        for bi, bound in enumerate(boundaries):
            if ln <= bound:
                buckets[bi].append(idx)
                break
        else:
            buckets[-1].append(idx)
    return buckets
