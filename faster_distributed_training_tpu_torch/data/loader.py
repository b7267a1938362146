"""Sequence-length bucketing shared by serving (and, later, training).

Copies of ``faster_distributed_training_tpu/data/loader.py::
eligible_buckets`` / ``select_bucket`` and ``data/agnews.py::
bucket_length``, so the port bins requests into the same lengths.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple


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
