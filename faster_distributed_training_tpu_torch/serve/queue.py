"""Serving request queue: ragged requests binned into training buckets.

Port of ``faster_distributed_training_tpu/serve/queue.py``.  A request
arrives as a ragged 1-D int32 token array; ``submit`` bins it by
:func:`data.loader.select_bucket`, so every request runs at one of the
configured padded lengths: a 65-token request on (64, 128) buckets
spills to 128, and one longer than the largest bucket runs truncated.
``submit(tokens, max_new_tokens=N)`` makes a generation request
(:class:`GenRequest`, the decode tier's) instead of a logits request;
both kinds share the one queue and the one bucket rule.

One FIFO per bucket.  :meth:`take_cell` is the continuous-batching drain
the scheduler loop calls: a bucket whose oldest request has crossed the
latency deadline dispatches first (partial if under-full — deadline
beats fullness, so no bucket starves), then any bucket holding a full
batch.  :meth:`take_one` is the same policy at batch 1, the decode
scheduler's slot-granular drain.  Submitters never block on a dispatch.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from faster_distributed_training_tpu_torch.data.loader import (
    eligible_buckets, select_bucket)


class ServeRequest:
    """One in-flight request: token ids in, a logits row out.

    ``wait`` blocks the SUBMITTER (never the serving threads) until the
    scheduler fulfills or fails the request.  ``raw_len`` keeps the
    pre-truncation length."""

    _ids = itertools.count()

    def __init__(self, tokens: np.ndarray, bucket: int, raw_len: int,
                 t_submit: float):
        self.id = next(self._ids)
        self.tokens = tokens          # 1-D int32, already <= bucket long
        self.bucket = int(bucket)
        self.raw_len = int(raw_len)
        self.t_submit = float(t_submit)
        self.t_done: Optional[float] = None
        self.replica: str = ""
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self._event = threading.Event()

    def fulfill(self, logits_row: np.ndarray, replica: str,
                t_done: float) -> None:
        self.result = logits_row
        self.replica = replica
        self.t_done = t_done
        self._event.set()

    def fail(self, exc: BaseException) -> None:
        self.error = exc
        self.t_done = time.monotonic()
        self._event.set()

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.id} not served within "
                               f"{timeout}s")
        if self.error is not None:
            raise self.error
        return self.result

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def latency_ms(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return (self.t_done - self.t_submit) * 1e3


class GenRequest(ServeRequest):
    """A generation request: prompt token ids in, at most ``max_new``
    generated token ids out (``result``, int32; the first is the token
    sampled off the prefill logits).  ``out`` collects tokens as decode
    steps complete and ``t_first`` stamps the first one (TTFT)."""

    def __init__(self, tokens: np.ndarray, bucket: int, raw_len: int,
                 t_submit: float, max_new: int):
        super().__init__(tokens, bucket, raw_len, t_submit)
        self.max_new = int(max_new)
        self.out: List[int] = []
        self.t_first: Optional[float] = None

    def push_token(self, token: int, now: float) -> None:
        if self.t_first is None:
            self.t_first = now
        self.out.append(int(token))

    def ttft_ms(self) -> Optional[float]:
        if self.t_first is None:
            return None
        return (self.t_first - self.t_submit) * 1e3


class RequestQueue:
    """Thread-safe bucket-binned request queue (one FIFO per bucket)."""

    def __init__(self, buckets: Sequence[int],
                 max_len: Optional[int] = None,
                 clock=time.monotonic):
        self.buckets: Tuple[int, ...] = eligible_buckets(buckets, max_len)
        self._clock = clock
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._fifos: Dict[int, List[ServeRequest]] = {
            b: [] for b in self.buckets}
        self._closed = False
        self.submitted = 0

    def submit(self, tokens, max_new_tokens: Optional[int] = None,
               req_id: Optional[int] = None) -> ServeRequest:
        """Bin a ragged token array into its bucket FIFO; returns the
        handle the submitter waits on.  Over-long requests run truncated
        at the largest bucket (raw_len records it), never rejected.
        ``max_new_tokens`` makes it a :class:`GenRequest`; ``req_id``
        overrides the auto id (the decode front door passes the parent's
        id over the wire, so a generation retried on another worker
        samples the same stream)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        raw_len = len(tokens)
        bucket = select_bucket(max(raw_len, 1), self.buckets)
        if max_new_tokens is not None:
            req: ServeRequest = GenRequest(tokens[:bucket], bucket, raw_len,
                                           self._clock(),
                                           max_new=max_new_tokens)
        else:
            req = ServeRequest(tokens[:bucket], bucket, raw_len,
                               self._clock())
        if req_id is not None:
            req.id = int(req_id)
        with self._cond:
            if self._closed:
                raise RuntimeError("RequestQueue is closed")
            self._fifos[bucket].append(req)
            self.submitted += 1
            self._cond.notify_all()
        return req

    def pending(self) -> int:
        with self._lock:
            return sum(len(f) for f in self._fifos.values())

    def take_cell(self, batch_size: int, max_delay_s: float,
                  timeout_s: float = 0.05
                  ) -> Optional[Tuple[int, List[ServeRequest]]]:
        """One (bucket, requests) dispatch cell, or None after
        ``timeout_s`` with nothing dispatchable.

        Policy (continuous batching):
          1. any bucket whose OLDEST request has waited past
             ``max_delay_s`` dispatches first (oldest head first, up to
             batch_size);
          2. else any bucket holding >= batch_size requests dispatches a
             full FIFO batch (smallest such bucket first);
          3. else wait (bounded by ``timeout_s`` and by the earliest
             upcoming deadline) and re-check.
        """
        deadline = self._clock() + max(timeout_s, 0.0)
        with self._cond:
            while True:
                cell = self._pick_locked(batch_size, max_delay_s)
                if cell is not None:
                    return cell
                if self._closed:
                    return None
                now = self._clock()
                wait = deadline - now
                oldest = self._oldest_locked()
                if oldest is not None:
                    wait = min(wait, oldest + max_delay_s - now)
                if wait <= 0:
                    return None
                self._cond.wait(wait)

    def take_one(self, max_delay_s: float, timeout_s: float = 0.05
                 ) -> Optional[Tuple[int, ServeRequest]]:
        """One (bucket, request), or None: take_cell's policy at batch 1,
        so a deadline-expired bucket's head still beats the smallest
        non-empty bucket (rule 1 before rule 2)."""
        cell = self.take_cell(1, max_delay_s, timeout_s=timeout_s)
        if cell is None:
            return None
        bucket, reqs = cell
        return bucket, reqs[0]

    def _oldest_locked(self) -> Optional[float]:
        ts = [f[0].t_submit for f in self._fifos.values() if f]
        return min(ts) if ts else None

    def _pick_locked(self, batch_size: int, max_delay_s: float
                     ) -> Optional[Tuple[int, List[ServeRequest]]]:
        now = self._clock()
        expired = [(self._fifos[b][0].t_submit, b)
                   for b in self.buckets
                   if self._fifos[b]
                   and now - self._fifos[b][0].t_submit >= max_delay_s]
        if expired:                                  # rule 1: deadline
            _, b = min(expired)
            fifo = self._fifos[b]
            cell, self._fifos[b] = fifo[:batch_size], fifo[batch_size:]
            return b, cell
        for b in self.buckets:                       # rule 2: full batch
            if len(self._fifos[b]) >= batch_size:
                fifo = self._fifos[b]
                cell, self._fifos[b] = fifo[:batch_size], fifo[batch_size:]
                return b, cell
        return None

    def close(self) -> None:
        """No further submits; blocked take_cell callers wake and drain
        what remains (the scheduler keeps calling until pending()==0)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
