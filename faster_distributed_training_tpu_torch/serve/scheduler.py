"""Batch scheduler: queue cells -> padded batches -> replica dispatch.

Port of ``faster_distributed_training_tpu/serve/scheduler.py``.  The
scheduler thread is the serving tier's control loop.  Each tick it
(1) runs the replica heartbeat monitor, (2) retries work parked while no
replica was live, and (3) drains one (bucket, requests) cell from the
queue — deadline-expired buckets first (partial if under-full), then
full batches (queue.take_cell's policy; ``max_delay_ms`` trades latency
against batch fullness).  Partial cells pad to the engine batch size
with copies of a real row (serve/engine.pad_batch) whose output rows are
DROPPED here, so a pad row never reaches a response.

Completion runs on the REPLICA worker thread (scatter logits rows to
requests, stamp latency); the scheduler thread never blocks on a device.
Work rescued from a detached replica re-enters through
:meth:`_redispatch` with a bounded attempt budget — a batch that fails
on every replica fails its requests with the last error instead of
cycling forever.  Telemetry events come with the telemetry slice.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import numpy as np

from faster_distributed_training_tpu_torch.serve.engine import pad_batch
from faster_distributed_training_tpu_torch.serve.queue import (
    RequestQueue, ServeRequest)
from faster_distributed_training_tpu_torch.serve.replicas import ReplicaSet
from faster_distributed_training_tpu_torch.train.metrics import percentiles


class _Work:
    """One assembled batch in flight.  ``claim`` is the ONE-SHOT
    completion gate: a batch re-dispatched off a presumed-hung replica
    may race its original — whichever finishes first claims, the loser
    drops (identical logits either way)."""

    def __init__(self, bucket: int, requests: List[ServeRequest],
                 batch: dict, n_real: int, on_done: Callable,
                 max_attempts: int):
        self.bucket = int(bucket)
        self.requests = requests
        self.batch = batch             # fresh numpy — safe to re-upload
        self.n_real = int(n_real)
        self.t_created = time.monotonic()
        self.attempts = 0
        self.max_attempts = int(max_attempts)
        # retry backoff gate: a rescued batch parks until this clock
        # (monotonic) instead of hammering a replica set mid-respawn
        self.not_before = 0.0
        self.last_error: Optional[BaseException] = None
        self._on_done = on_done
        self._claim_lock = threading.Lock()
        self._claimed = False

    @property
    def claimed(self) -> bool:
        return self._claimed

    def claim(self) -> bool:
        with self._claim_lock:
            if self._claimed:
                return False
            self._claimed = True
            return True

    def complete(self, logits, replica) -> None:
        self._on_done(self, np.asarray(logits), replica)

    def note_failure(self, exc: BaseException) -> None:
        self.last_error = exc

    def fail_all(self, exc: BaseException) -> bool:
        """Fail every request (first claimer only); True when this call
        won the claim — failure counters key off that so a rescue/expiry
        race can never double-count."""
        if not self.claim():
            return False
        for req in self.requests:
            req.fail(exc)
        return True


class BatchScheduler:
    """Continuous-batching control loop over one queue + one replica
    set.  ``batch_size`` is the compiled batch dimension every cell
    pads to; ``max_delay_ms`` bounds how long a partial batch may wait
    for company."""

    def __init__(self, queue: RequestQueue, replicas: ReplicaSet,
                 batch_size: int, max_delay_ms: float = 20.0,
                 request_deadline_s: Optional[float] = None,
                 retry_backoff_s: float = 0.05,
                 retry_backoff_cap_s: float = 2.0,
                 log: Callable[[str], None] = print):
        self.queue = queue
        self.replicas = replicas
        self.batch_size = int(batch_size)
        self.max_delay_s = float(max_delay_ms) / 1e3
        # per-request deadline (None = wait forever): work whose oldest request has been in the system
        # longer than this fails with TimeoutError at its next dispatch
        # or parked-retry tick — a dead/respawning engine process makes
        # callers wait a BOUNDED time, never forever
        self.request_deadline_s = (None if request_deadline_s is None
                                   or request_deadline_s <= 0
                                   else float(request_deadline_s))
        # rescue backoff: attempt k re-enters dispatch after
        # backoff·2^(k-1) (capped) parked seconds, so a batch bounced
        # off a replica set mid-respawn gives the respawn room to warm
        self.retry_backoff_s = float(retry_backoff_s)
        self.retry_backoff_cap_s = float(retry_backoff_cap_s)
        self._log = log
        self._lock = threading.Lock()
        self._parked: List[_Work] = []   # work with no live replica yet
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        # latency/throughput bookkeeping (summary())
        self.latencies_ms: List[float] = []
        self.completed_requests = 0
        self.completed_batches = 0
        self.padded_rows = 0
        self.request_retries = 0     # re-dispatches after replica loss
        self.request_timeouts = 0    # requests failed by the deadline
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self.replicas.requeue = self._redispatch
        self.replicas.start_all()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="fdt-serve-scheduler")
        self._thread.start()

    def close(self, drain_s: float = 5.0) -> None:
        """Stop accepting, drain what is pending (bounded), stop the
        loop and the replicas."""
        self.queue.close()
        deadline = time.monotonic() + drain_s
        while time.monotonic() < deadline:
            busy = (self.queue.pending() or self._parked
                    or any(r.load() for r in self.replicas.replicas))
            if not busy:
                break
            time.sleep(0.01)
        self._closed = True
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self.replicas.close()

    # -- the control loop --------------------------------------------------

    def _loop(self) -> None:
        while not self._closed:
            self.replicas.monitor()
            self._retry_parked()
            cell = self.queue.take_cell(self.batch_size, self.max_delay_s,
                                        timeout_s=0.05)
            if cell is None:
                continue
            bucket, requests = cell
            batch, n_real = self._assemble(bucket, requests)
            work = _Work(bucket, requests, batch, n_real,
                         on_done=self._on_done,
                         max_attempts=max(len(self.replicas.replicas),
                                          1) + 1)
            self._dispatch(work)

    def _assemble(self, bucket: int, requests: List[ServeRequest]):
        """Cell -> engine payload (batch, n_real): pad to the engine's
        batch dimension."""
        return pad_batch(requests, bucket, self.batch_size)

    def _expire(self, work: _Work) -> bool:
        """Deadline check: True when the work was failed for age.  The
        clock starts at batch assembly (``t_created``) — queue wait
        before assembly is bounded separately by ``max_delay_ms``."""
        if self.request_deadline_s is None:
            return False
        age = time.monotonic() - work.t_created
        if age <= self.request_deadline_s:
            return False
        err: BaseException = TimeoutError(
            f"request deadline exceeded ({age:.1f}s > "
            f"{self.request_deadline_s:.1f}s, {work.attempts} dispatch "
            f"attempt(s), last error: {work.last_error!r})")
        if work.fail_all(err):
            with self._lock:
                self.request_timeouts += work.n_real
            self._log(f"[serve] batch (bucket {work.bucket}, "
                      f"{work.n_real} requests) TIMED OUT: {err}")
        return True

    def _dispatch(self, work: _Work) -> None:
        if self._expire(work):
            return
        work.attempts += 1
        if work.attempts > work.max_attempts:
            err = work.last_error or RuntimeError(
                "batch exhausted its dispatch attempts")
            self._log(f"[serve] batch (bucket {work.bucket}, "
                      f"{work.n_real} requests) FAILED after "
                      f"{work.attempts - 1} attempts: {err!r}")
            work.fail_all(err)
            return
        if not self.replicas.dispatch(work):
            with self._lock:
                self._parked.append(work)

    def _redispatch(self, work: _Work) -> None:
        """Requeue sink for the replica set: rescued / failed work
        re-enters dispatch (unless something already completed it).
        A RETRY (attempt >= 1, i.e. an engine died or errored
        mid-request) is counted and parks through the bounded
        exponential backoff instead of re-entering immediately."""
        if work.claimed:
            return
        if work.attempts >= 1:
            with self._lock:
                self.request_retries += 1
            if self.retry_backoff_s > 0:
                work.not_before = time.monotonic() + min(
                    self.retry_backoff_s * 2.0 ** (work.attempts - 1),
                    self.retry_backoff_cap_s)
                with self._lock:
                    self._parked.append(work)
                return
        self._dispatch(work)

    def _retry_parked(self) -> None:
        now = time.monotonic()
        with self._lock:
            parked, self._parked = self._parked, []
        for work in parked:
            if work.claimed:
                continue
            if self._expire(work):
                continue
            if work.not_before > now:
                with self._lock:
                    self._parked.append(work)
                continue
            if work.not_before:
                # backoff elapsed: this re-entry is a true dispatch
                # attempt (budget-counted), not a no-replica park loop
                work.not_before = 0.0
                self._dispatch(work)
                continue
            if not self.replicas.dispatch(work):
                with self._lock:
                    self._parked.append(work)

    # -- completion (replica worker thread) --------------------------------

    def _on_done(self, work: _Work, logits: np.ndarray, replica) -> None:
        now = time.monotonic()
        # pad rows [n_real:] are DROPPED here — the only consumer of the
        # logits is this scatter, so a masked pad row cannot reach any
        # response
        for i, req in enumerate(work.requests):
            req.fulfill(logits[i], replica.name, now)
        with self._lock:
            self.completed_batches += 1
            self.completed_requests += work.n_real
            self.padded_rows += self.batch_size - work.n_real
            for req in work.requests:
                self.latencies_ms.append(req.latency_ms())
                t0 = req.t_submit
                self._t_first = t0 if self._t_first is None \
                    else min(self._t_first, t0)
            self._t_last = now if self._t_last is None \
                else max(self._t_last, now)

    # -- reporting ---------------------------------------------------------

    def summary(self) -> dict:
        """p50/p99 request latency + throughput over everything served
        so far (nearest-rank percentiles, train.metrics.percentiles)."""
        with self._lock:
            lats = list(self.latencies_ms)
            n = self.completed_requests
            wall = ((self._t_last - self._t_first)
                    if (self._t_first is not None
                        and self._t_last is not None
                        and self._t_last > self._t_first) else 0.0)
            out = {"requests": n, "batches": self.completed_batches,
                   "padded_rows": self.padded_rows,
                   "request_retries": self.request_retries,
                   "request_timeouts": self.request_timeouts}
        pct = percentiles(lats, qs=(50, 99))
        out["p50_ms"] = pct.get(50, 0.0)
        out["p99_ms"] = pct.get(99, 0.0)
        out["qps"] = round(n / wall, 2) if wall else 0.0
        return out
