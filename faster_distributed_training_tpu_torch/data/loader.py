"""Batch loading and sequence-length bucketing.

numpy copies of the JAX package's ``data/loader.py`` (``shard_for_host``,
``BatchLoader`` with ``plan``/``materialize`` for text and image
datasets, ``ParallelBatchIterator`` in place of both its iterators,
``eligible_buckets``/``select_bucket``) and ``data/agnews.py::
bucket_length``: the epoch batch stream is a pure function of
(n, seed, epoch) and equals the JAX loader's bitwise, and serving bins
requests into the same lengths.  One process: ``process_index`` 0 of
``process_count`` 1 unless the caller says otherwise; under a data mesh
each process loads its contiguous shard of the (seed, epoch) permutation
in local batches, and global batch b is the ranks' b-th local batches in
rank order (``pod_epoch_order``), the JAX package's multi-host contract.
``verify_host_shards`` / ``verify_host_shards_global`` check it under
``--debug``.
"""

from __future__ import annotations

import collections
from typing import Deque, Dict, Iterator, List, Optional, Sequence, Tuple

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


def dataset_len(data) -> int:
    """Sample count of a text dataset (``encode_batch``) or an image
    ``(x, y)`` pair."""
    return len(data) if hasattr(data, "encode_batch") else len(data[0])


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


def pod_epoch_order(n: int, epoch: int, seed: int = 0, shuffle: bool = True,
                    process_count: int = 1,
                    local_batch_size: int = 1) -> np.ndarray:
    """The global batch stream of ``process_count`` processes as one flat
    int32 index array: entry ``b * (pc * lbs) + pi * lbs + j`` is process
    ``pi``'s ``j``-th sample of global batch ``b``.  One process: the
    ``shard_for_host`` order truncated to whole batches."""
    pc, lbs = int(process_count), int(local_batch_size)
    per = n // pc
    steps = per // lbs
    order = (np.random.default_rng((seed, epoch)).permutation(n) if shuffle
             else np.arange(n))
    shards = order[: per * pc].reshape(pc, per)[:, : steps * lbs]
    return np.ascontiguousarray(
        shards.reshape(pc, steps, lbs).transpose(1, 0, 2).reshape(-1)
        .astype(np.int32))


def verify_host_shards(n: int, epoch: int, seed: int = 0,
                       shuffle: bool = True, process_count: int = 1) -> None:
    """The sharding algebra, for every process of ``process_count``: the
    shards are pairwise disjoint and tile the first ``(n // pc) * pc``
    entries of one global permutation.  Raises AssertionError (with the
    JAX package's messages) otherwise."""
    pc = int(process_count)
    shards = [shard_for_host(n, epoch, seed, shuffle, pi, pc)
              for pi in range(pc)]
    allidx = np.concatenate(shards)
    if len(np.unique(allidx)) != len(allidx):
        raise AssertionError(
            f"host shards overlap (epoch {epoch}, {pc} processes): "
            f"{len(allidx) - len(np.unique(allidx))} duplicated samples")
    per = n // pc
    if len(allidx) != per * pc:
        raise AssertionError(
            f"host shards mis-sized: {len(allidx)} != {per * pc}")
    full = (np.random.default_rng((seed, epoch)).permutation(n) if shuffle
            else np.arange(n))
    if not np.array_equal(np.sort(allidx), np.sort(full[:per * pc])):
        raise AssertionError("host shards do not tile the global permutation")


def check_shard_digests(digests: np.ndarray) -> None:
    """Every process's ``[n, process_count, seed, epoch, shard_hash]``
    row: raises when they disagree on the sharding inputs, or when two
    non-empty shards are byte-identical (every rank loading the same
    slice)."""
    digests = np.asarray(digests)
    for col, what in ((0, "dataset size n"), (1, "process_count"),
                      (2, "seed"), (3, "epoch")):
        if not (digests[:, col] == digests[0, col]).all():
            raise AssertionError(
                f"hosts disagree on {what}: {digests[:, col].tolist()} — "
                f"each host is drawing from a different permutation")
    per = int(digests[0, 0]) // max(int(digests[0, 1]), 1)
    if digests.shape[0] > 1 and per > 0:
        hashes = digests[:, 4]
        if len(np.unique(hashes)) != len(hashes):
            raise AssertionError(
                "two hosts hold identical data shards — every rank is "
                "loading the same slice (DistributedSampler-forgotten bug)")


def verify_host_shards_global(n: int, epoch: int, seed: int = 0,
                              shuffle: bool = True, process_index: int = 0,
                              process_count: int = 1, group=None) -> None:
    """Across processes (collective: every rank of ``group``, the data
    group, calls it): each one's sharding inputs and a 64-bit hash of its
    real shard, gathered and checked by ``check_shard_digests``."""
    import hashlib

    from faster_distributed_training_tpu_torch.parallel.collectives import (
        all_gather_across_processes)

    shard = shard_for_host(n, epoch, seed, shuffle, process_index,
                           process_count)
    shard_hash = int.from_bytes(
        hashlib.sha1(np.ascontiguousarray(shard).tobytes()).digest()[:8],
        "little", signed=True)
    digest = np.asarray([n, process_count, seed, epoch, shard_hash],
                        dtype=np.int64)
    check_shard_digests(all_gather_across_processes(digest, group))


class BatchLoader:
    """Dict batches from an ``encode_batch``-style text dataset, or from
    an image ``(x, y)`` pair as ``{"image": x[idx], "label": y[idx]}``
    (NHWC uint8 images, int32 labels).  Training (``pad_last=False``)
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
        self.is_text = hasattr(data, "encode_batch")
        self._n = dataset_len(data)

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
        if self.is_text:
            batch = dict(self.data.encode_batch(batch_idx, self.max_len))
        else:
            x, y = self.data
            batch = {"image": x[batch_idx], "label": y[batch_idx]}
        if valid is not None:
            batch["valid"] = valid
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for entry in self.plan()[self.start:]:
            yield self.materialize(entry)


class ParallelBatchIterator:
    """Background prefetch of a loader's batches (``--workers`` and
    ``--prefetch_depth``): ``max(1, workers)`` threads materialize them
    from construction on, at most ``depth`` in flight, and they are
    yielded strictly in plan order (from the loader's ``start``).  A
    worker's exception is raised at its batch.  ``close`` cancels the
    batches not yet started and joins the threads; running out of
    batches closes too."""

    def __init__(self, loader: BatchLoader, workers: int = 1,
                 depth: int = 2):
        from concurrent.futures import ThreadPoolExecutor

        self._loader = loader
        self._workers = max(int(workers), 1)
        self._depth = max(int(depth), self._workers)
        self._plan = iter(loader.plan()[loader.start:])
        self._pending: Deque = collections.deque()
        self._ex = ThreadPoolExecutor(max_workers=self._workers)
        self._fill()

    def _fill(self) -> None:
        while len(self._pending) < self._depth:
            entry = next(self._plan, None)
            if entry is None:
                return
            self._pending.append(self._ex.submit(self._loader.materialize,
                                                 entry))

    def close(self) -> None:
        self._plan = iter(())
        for fut in self._pending:
            fut.cancel()
        self._pending.clear()
        self._ex.shutdown(wait=True, cancel_futures=True)

    def __iter__(self) -> "ParallelBatchIterator":
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if not self._pending:
            self.close()
            raise StopIteration
        try:
            batch = self._pending.popleft().result()
        except BaseException:
            self.close()
            raise
        self._fill()
        return batch
