"""Replica-level resilience: N independent predict workers, one queue.

Port of ``faster_distributed_training_tpu/serve/replicas.py`` (framework
free, unchanged in substance).  Each :class:`Replica` owns an
:class:`~serve.engine.InferenceEngine` (its own card under the
replicated-per-card layout) and a worker thread draining a private
inbox.  The :class:`ReplicaSet` dispatches assembled batches to the
least-loaded LIVE replica and watches liveness: every worker-loop tick
touches a heartbeat timestamp, and a replica silent past
``heartbeat_timeout_s`` is presumed wedged (hung kernel, dead thread)
and DETACHED: its queued and in-flight work is re-dispatched to the
survivors, so one dead replica never stalls the queue.  A detached
replica re-admits (``readmit``) without draining the others.

Failure seams for tests: ``Replica.fail_next`` raises inside the worker
on its next batch; ``Replica.hang_s`` blocks the worker mid-batch so
only the heartbeat monitor can act.

The heartbeat timeout must exceed the worst-case single predict call —
which is why the engines run a warm-up batch per bucket (kernel builds,
cuBLAS handles, allocator growth) BEFORE the queue opens.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import Callable, List, Optional

_POLL_S = 0.05


class Replica:
    """One serving worker: engine + inbox + heartbeat."""

    def __init__(self, name: str, engine,
                 log: Callable[[str], None] = print):
        self.name = name
        self.engine = engine
        self._log = log
        self.inbox: "queue_mod.Queue" = queue_mod.Queue()
        self.alive = False
        self.last_beat = time.monotonic()
        self.busy_with = None          # the work item mid-predict
        self.served_batches = 0
        self.served_requests = 0
        self.failures = 0
        self.detached_at: Optional[float] = None
        # fault seams (tests/smoke): an exception to raise on the next
        # batch, and/or seconds to hang mid-batch
        self.fail_next: Optional[BaseException] = None
        self.hang_s: float = 0.0
        self._set: Optional["ReplicaSet"] = None
        self._token = 0                # bumped on detach: stale workers exit
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._token += 1
        self.alive = True
        self.detached_at = None
        # a fresh worker starts with no in-flight work — the previous
        # incarnation's marker was rescued at detach and a stale thread
        # is no longer allowed to clear the new worker's (token guard)
        self.busy_with = None
        self.last_beat = time.monotonic()
        self._thread = threading.Thread(target=self._worker,
                                        args=(self._token,), daemon=True,
                                        name=f"fdt-serve-{self.name}")
        self._thread.start()

    def stop(self) -> None:
        self.alive = False
        self._token += 1

    def load(self) -> int:
        return self.inbox.qsize() + (1 if self.busy_with is not None else 0)

    def stale(self, now: float, timeout_s: float) -> bool:
        return self.alive and (now - self.last_beat) > timeout_s

    def submit(self, work) -> None:
        self.inbox.put(work)

    # -- the worker --------------------------------------------------------

    def _worker(self, token: int) -> None:
        while token == self._token:
            self.last_beat = time.monotonic()
            try:
                work = self.inbox.get(timeout=_POLL_S)
            except queue_mod.Empty:
                continue
            if token != self._token:
                # detached between get() and here: hand the work back
                if self._set is not None:
                    self._set.requeue(work)
                return
            self.busy_with = work
            self.last_beat = time.monotonic()
            try:
                if self.hang_s:
                    # hang seam: the worker wedges mid-batch; only the
                    # heartbeat monitor can detach it
                    time.sleep(self.hang_s)
                if self.fail_next is not None:
                    exc, self.fail_next = self.fail_next, None
                    raise exc
                logits = self.engine.predict_batch(work.batch)
            except BaseException as e:
                self.failures += 1
                # token-guarded: a STALE thread (detached + re-admitted
                # while it was wedged in predict) must neither clear the
                # new worker's in-flight marker — a later detach would
                # then find nothing to rescue and that batch would
                # strand — nor report a replica failure that would
                # detach the healthy new incarnation; its own work was
                # already rescued at detach time
                if token == self._token:
                    self.busy_with = None
                    if self._set is not None:
                        self._set.replica_failed(self, work, e)
                    else:
                        work.fail_all(e)
                return
            if token == self._token:
                self.busy_with = None
            self.last_beat = time.monotonic()
            if work.claim():
                self.served_batches += 1
                self.served_requests += work.n_real
                work.complete(logits, self)
            # an unclaimable work means a monitor already re-dispatched
            # it (this worker was presumed hung) — the late result drops

    def stats(self) -> dict:
        return {"name": self.name, "alive": self.alive,
                "served_batches": self.served_batches,
                "served_requests": self.served_requests,
                "failures": self.failures, "load": self.load()}


class ReplicaSet:
    """Least-loaded dispatch + heartbeat watchdog + re-admission over N
    replicas.  ``requeue`` (set by the scheduler at start) receives
    every work item rescued from a detached replica."""

    def __init__(self, replicas: List[Replica],
                 heartbeat_timeout_s: float = 5.0,
                 readmit_after_s: float = 0.0,
                 log: Callable[[str], None] = print):
        self.replicas = list(replicas)
        for r in self.replicas:
            r._set = self
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        # 0 = manual re-admission only; > 0 = a detached replica is
        # automatically re-admitted after this many seconds (the
        # restarted-process stand-in for tests/smokes)
        self.readmit_after_s = float(readmit_after_s)
        self._log = log
        self._lock = threading.Lock()
        self.requeue: Callable = lambda work: work.fail_all(
            RuntimeError("no requeue sink attached"))
        self.replica_failures = 0
        self.replica_readmissions = 0

    # -- lifecycle ---------------------------------------------------------

    def start_all(self) -> None:
        for r in self.replicas:
            if not r.alive:
                r.start()

    def close(self) -> None:
        for r in self.replicas:
            r.stop()

    def live(self) -> List[Replica]:
        return [r for r in self.replicas if r.alive]

    # -- dispatch ----------------------------------------------------------

    def dispatch(self, work) -> bool:
        """Hand ``work`` to the least-loaded live replica; False when
        none is live (the scheduler parks and retries — requests WAIT
        for a re-admission rather than failing)."""
        with self._lock:
            live = self.live()
            if not live:
                return False
            r = min(live, key=lambda r: r.load())
            r.submit(work)
            return True

    # -- liveness ----------------------------------------------------------

    def monitor(self, now: Optional[float] = None) -> None:
        """One watchdog tick (the scheduler loop calls this every
        iteration): detach heartbeat-stale replicas, auto-readmit timed
        detached ones."""
        now = time.monotonic() if now is None else now
        for r in self.replicas:
            if r.stale(now, self.heartbeat_timeout_s):
                self.detach(r, reason=f"heartbeat silent "
                            f"{now - r.last_beat:.1f}s > "
                            f"{self.heartbeat_timeout_s}s")
            elif (not r.alive and self.readmit_after_s
                    and r.detached_at is not None
                    and now - r.detached_at >= self.readmit_after_s):
                self.readmit(r)

    def detach(self, r: Replica, reason: str = "") -> None:
        """Mark ``r`` dead, bump its worker token (a late-returning
        thread exits instead of completing), and rescue its queued +
        in-flight work onto the survivors.  Never blocks on the wedged
        thread itself."""
        with self._lock:
            if not r.alive:
                return
            r.stop()
            r.detached_at = time.monotonic()
            self.replica_failures += 1
            rescued = []
            inflight = r.busy_with
            if inflight is not None and not inflight.claimed:
                # re-dispatch without claiming: completion is one-shot
                # (work.claim()), so whichever of {the hung call, the
                # retry} finishes FIRST fulfills the requests and the
                # loser's result drops — both compute identical logits
                # (same program, same batch), so the race is benign
                rescued.append(inflight)
            while True:
                try:
                    rescued.append(r.inbox.get_nowait())
                except queue_mod.Empty:
                    break
        self._log(f"[serve] replica {r.name} DETACHED ({reason}); "
                  f"{len(rescued)} batch(es) re-dispatched to "
                  f"{len(self.live())} survivor(s)")
        for work in rescued:
            self.requeue(work)

    def replica_failed(self, r: Replica, work, exc: BaseException) -> None:
        """Worker-thread error path: the replica is detached, the failed
        work re-dispatched (bounded by the work's own attempt budget,
        scheduler.py), and everything still queued in its inbox rescued
        onto the survivors — the worker thread is gone, nothing else
        would ever drain it."""
        self._log(f"[serve] replica {r.name} worker error: {exc!r}")
        with self._lock:
            was_alive = r.alive
            if was_alive:
                r.stop()
                r.detached_at = time.monotonic()
                self.replica_failures += 1
            rescued = []
            while True:
                try:
                    rescued.append(r.inbox.get_nowait())
                except queue_mod.Empty:
                    break
        if was_alive:
            self._log(f"[serve] replica {r.name} DETACHED (worker error); "
                      f"{len(rescued)} queued batch(es) re-dispatched")
        work.note_failure(exc)
        self.requeue(work)
        for w in rescued:
            self.requeue(w)

    def readmit(self, r: Replica) -> None:
        """Re-admit a detached replica: fresh worker thread, fresh
        heartbeat — the others were never drained."""
        with self._lock:
            if r.alive:
                return
            r.start()
            if not r.alive:
                # a process-backed replica whose respawn was not ready
                # (serve/decode/frontend.ProcReplica): start() re-armed
                # its detach timer instead of raising; the monitor tries
                # again, and this is no re-admission
                return
            self.replica_readmissions += 1
        self._log(f"[serve] replica {r.name} RE-ADMITTED "
                  f"({len(self.live())} live)")

    def stats(self) -> dict:
        return {"replicas": [r.stats() for r in self.replicas],
                "replica_failures": self.replica_failures,
                "replica_readmissions": self.replica_readmissions}
