"""Batch loading and sequence-length bucketing.

numpy copies of the JAX package's ``data/loader.py`` (``shard_for_host``,
``BatchLoader`` with ``plan``/``materialize``, ``PrefetchIterator``,
``eligible_buckets``/``select_bucket``) and ``data/agnews.py::
bucket_length``: the epoch batch stream is a pure function of
(n, seed, epoch) and equals the JAX loader's bitwise, and serving bins
requests into the same lengths.  One process: ``process_index`` 0 of
``process_count`` 1 unless the caller says otherwise.
"""

from __future__ import annotations

import queue
import threading
from typing import (Dict, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np


def bucket_length(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (last bucket truncates)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def eligible_buckets(buckets: Sequence[int],
                     max_len: Optional[int] = None) -> Tuple[int, ...]:
    """The bucket lengths in play at ``max_len``: the configured set
    capped at max_len, falling back to (max_len,) when none fit."""
    out = tuple(sorted({int(b) for b in buckets
                        if max_len is None or b <= max_len}))
    return out or (int(max_len),)


def select_bucket(n: int, buckets: Sequence[int],
                  max_len: Optional[int] = None) -> int:
    """The padded length a sequence of ``n`` real tokens runs at: the
    smallest eligible bucket >= n (the last one truncates)."""
    return bucket_length(int(n), list(eligible_buckets(buckets, max_len)))


def shard_for_host(n: int, epoch: int, seed: int = 0, shuffle: bool = True,
                   process_index: int = 0, process_count: int = 1,
                   pad: bool = False):
    """The (seed, epoch) global permutation sliced to this process's
    contiguous shard; pad=False truncates to whole processes (training),
    pad=True ceil-divides with repeated samples marked invalid (eval) and
    returns ``(indices, valid)``."""
    pi, pc = process_index, process_count
    order = (np.random.default_rng((seed, epoch)).permutation(n) if shuffle
             else np.arange(n))
    if pad:
        per = -(-n // pc)
        extra = per * pc - n
        padded = np.concatenate(
            [order, order[np.arange(extra, dtype=np.intp) % max(n, 1)]])
        valid = np.concatenate(
            [np.ones(n, np.bool_), np.zeros(extra, np.bool_)])
        sl = slice(pi * per, (pi + 1) * per)
        return padded[sl], valid[sl]
    per = n // pc
    return order[pi * per:(pi + 1) * per]


class BatchLoader:
    """Dict batches from an ``encode_batch``-style text dataset (the image
    datasets come with the ResNet slice).  Training (``pad_last=False``)
    drops the trailing partial batch; eval (``pad_last=True``) pads it and
    every batch carries a float ``valid`` mask.  ``start`` is the first
    entry of the plan that iteration yields: a mid-epoch resume skips the
    already-trained batches without building them."""

    def __init__(self, data, batch_size: int, epoch: int = 0, seed: int = 0,
                 shuffle: bool = True, max_len: int = 512,
                 pad_last: bool = False, process_index: int = 0,
                 process_count: int = 1, start: int = 0):
        self.data = data
        self.batch_size = batch_size
        self.epoch = epoch
        self.seed = seed
        self.shuffle = shuffle
        self.max_len = max_len
        self.pad_last = pad_last
        self.start = start
        self._pi, self._pc = process_index, process_count
        self._n = len(data)

    def __len__(self) -> int:
        if self.pad_last:
            per = -(-self._n // self._pc)
            return -(-per // self.batch_size)
        return (self._n // self._pc) // self.batch_size

    def plan(self) -> List[Tuple[np.ndarray, Optional[np.ndarray]]]:
        """The epoch's batch schedule: [(indices[bs], valid | None)]."""
        bs = self.batch_size
        out: List[Tuple[np.ndarray, Optional[np.ndarray]]] = []
        if self.pad_last:
            idx, validity = shard_for_host(self._n, self.epoch, self.seed,
                                           self.shuffle, self._pi, self._pc,
                                           pad=True)
            validity = validity.astype(np.float32)
            full = (len(idx) // bs) * bs
            for start in range(0, full, bs):
                out.append((idx[start:start + bs],
                            validity[start:start + bs]))
            tail = len(idx) - full
            if tail:
                pad = idx[np.zeros(bs - tail, np.intp)]
                valid = np.concatenate(
                    [validity[full:], np.zeros(bs - tail, np.float32)])
                out.append((np.concatenate([idx[full:], pad]), valid))
            return out
        idx = shard_for_host(self._n, self.epoch, self.seed, self.shuffle,
                             self._pi, self._pc)
        full = (len(idx) // bs) * bs
        for start in range(0, full, bs):
            out.append((idx[start:start + bs], None))
        return out

    def materialize(self, entry: Tuple[np.ndarray, Optional[np.ndarray]]
                    ) -> Dict[str, np.ndarray]:
        batch_idx, valid = entry
        batch = dict(self.data.encode_batch(batch_idx, self.max_len))
        if valid is not None:
            batch["valid"] = valid
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for entry in self.plan()[self.start:]:
            yield self.materialize(entry)


class PrefetchIterator:
    """A background thread keeps a bounded queue of ready batches.
    ``close`` cancels the worker, drains the queue and joins it."""

    _DONE = object()
    _PUT_POLL_S = 0.2

    def __init__(self, iterable: Iterable, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._cancel = threading.Event()
        self._done = False

        def worker():
            try:
                for item in iterable:
                    if not self._put(item):
                        return
            except BaseException as e:  # re-raised in the consumer
                self._err = e
            finally:
                self._put(self._DONE)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def _put(self, item) -> bool:
        while not self._cancel.is_set():
            try:
                self._q.put(item, timeout=self._PUT_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def close(self) -> None:
        self._cancel.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._t.join(timeout=5.0)
        self._done = True

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        item = self._q.get()
        if item is self._DONE:
            self._done = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
