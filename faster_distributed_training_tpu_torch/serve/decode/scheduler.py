"""DecodeScheduler: slot-granular continuous batching over one engine.

Port of ``faster_distributed_training_tpu/serve/decode/scheduler.py``.
The classifier scheduler batches whole requests; a generation batch
lives for many steps and its members finish at different times, so this
loop schedules at slot granularity, between every decode step:

  1. ADMIT: while a cache slot is free and the queue holds work, take ONE
     request (``queue.take_one``: the deadline-first rule at batch 1),
     prefill it and copy its K/V into the running batch; with a batch
     running the poll does not block;
  2. STEP: one decode step over the whole slot batch (the engine picks
     the page count covering the longest live slot);
  3. RECLAIM: a request that reached its token budget, or the cache's or
     the position table's end, is fulfilled and its slot freed.

With a recorder, each admission is one ``decode_admit`` record, each
step one ``decode_step`` and each reclaimed slot one ``slot_evict`` (JAX
``serve/decode/scheduler.py:106, 139, 176``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from faster_distributed_training_tpu_torch.serve.decode.engine import (
    DecodeEngine)
from faster_distributed_training_tpu_torch.serve.queue import (GenRequest,
                                                               RequestQueue)
from faster_distributed_training_tpu_torch.train.metrics import percentiles


class DecodeScheduler:
    """One engine and one queue: a slot-granular generation loop."""

    def __init__(self, queue: RequestQueue, engine: DecodeEngine,
                 max_delay_ms: float = 20.0, max_new_tokens: int = 32,
                 recorder=None, name: str = "decode0"):
        self.queue = queue
        # a telemetry.TelemetryRecorder, or None
        self.recorder = recorder
        self.engine = engine
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.max_new_tokens = int(max_new_tokens)
        self.name = name
        self._slots: Dict[int, GenRequest] = {}
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # bookkeeping for summary()
        self.completed_requests = 0
        self.generated_tokens = 0
        self.ttft_ms: List[float] = []
        self.total_ms: List[float] = []
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"fdt-{self.name}")
        self._thread.start()

    def close(self, drain_s: float = 30.0) -> None:
        """Finish what is in flight (bounded; the caller closes the queue
        first) and stop the loop.  A request still holding a slot past
        the bound fails."""
        deadline = time.monotonic() + drain_s
        while time.monotonic() < deadline:
            with self._lock:
                busy = bool(self._slots) or self.queue.pending()
            if not busy:
                break
            time.sleep(0.01)
        self._closed = True
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        with self._lock:
            stranded = list(self._slots.items())
            self._slots.clear()
        for slot, req in stranded:
            self.engine.cache.evict(slot)
            req.fail(RuntimeError(f"decode drain timed out with request "
                                  f"{req.id} still in slot {slot}"))

    # -- the loop ----------------------------------------------------------

    def _loop(self) -> None:
        while not self._closed:
            running = self.engine.active_count() > 0
            self._admit(block=not running)
            if self.engine.active_count() == 0:
                continue
            t0 = time.monotonic()
            tokens, pages = self.engine.step()
            if self.recorder is not None:
                self.recorder.record_event(
                    "decode_step", replica=self.name, pages=pages,
                    active=len(self._slots),
                    batch=self.engine.batch_size,
                    step_ms=round((time.monotonic() - t0) * 1e3, 3))
            self._reclaim(tokens)

    def _admit(self, block: bool) -> None:
        """Fill free slots from the queue: with a running batch the poll
        does not block the step loop; an idle engine waits the take_cell
        bound."""
        first = True
        while self.engine.cache.free_slot() is not None:
            timeout = 0.05 if (block and first) else 0.0
            first = False
            got = self.queue.take_one(self.max_delay_s, timeout_s=timeout)
            if got is None:
                return
            bucket, req = got
            if not isinstance(req, GenRequest):
                req.fail(TypeError(
                    "DecodeScheduler serves GenRequests (queue."
                    "submit(tokens, max_new_tokens=...)); got a plain "
                    "logits request"))
                continue
            now = time.monotonic()
            slot, f_tok = self.engine.admit(req.tokens, bucket, req.id)
            req.push_token(f_tok, time.monotonic())
            with self._lock:
                self._slots[slot] = req
                if self._t_first is None:
                    self._t_first = now
            if self.recorder is not None:
                self.recorder.record_event(
                    "decode_admit", replica=self.name, slot=slot,
                    bucket=bucket, len=req.raw_len,
                    queue_ms=round((now - req.t_submit) * 1e3, 3))
            # a 1-token budget is met by the prefill's token alone
            self._maybe_finish(slot, req)

    def _reclaim(self, tokens: np.ndarray) -> None:
        now = time.monotonic()
        for slot, req in list(self._slots.items()):
            if not self.engine.cache.active[slot]:
                continue
            req.push_token(int(tokens[slot]), now)
            self._maybe_finish(slot, req)

    def _maybe_finish(self, slot: int, req: GenRequest) -> None:
        budget = min(req.max_new, self.max_new_tokens)
        done = len(req.out) >= budget
        reason = "budget"
        if not done and self.engine.cache.headroom(slot) <= 0:
            done = True
            reason = "capacity"
        if not done:
            return
        n = len(req.out)
        self.engine.cache.evict(slot)
        with self._lock:
            self._slots.pop(slot, None)
            self.completed_requests += 1
            self.generated_tokens += n
            self.ttft_ms.append(req.ttft_ms())
            self._t_last = time.monotonic()
        req.fulfill(np.asarray(req.out, np.int32), self.name,
                    time.monotonic())
        with self._lock:
            self.total_ms.append(req.latency_ms())
        if self.recorder is not None:
            self.recorder.record_event(
                "slot_evict", replica=self.name, slot=slot, tokens=n,
                reason=reason)

    # -- reporting ---------------------------------------------------------

    def summary(self) -> dict:
        """TTFT and latency p50/p99 (nearest rank,
        ``train.metrics.percentiles``) and generated tokens a second."""
        with self._lock:
            ttft = list(self.ttft_ms)
            total = list(self.total_ms)
            n = self.completed_requests
            toks = self.generated_tokens
            wall = ((self._t_last - self._t_first)
                    if (self._t_first is not None
                        and self._t_last is not None
                        and self._t_last > self._t_first) else 0.0)
        pt = percentiles(ttft, qs=(50, 99))
        pl = percentiles(total, qs=(50, 99))
        return {"requests": n, "tokens": toks,
                "steps": self.engine.steps,
                "prefills": self.engine.prefills,
                "ttft_p50_ms": pt.get(50, 0.0),
                "ttft_p99_ms": pt.get(99, 0.0),
                "latency_p50_ms": pl.get(50, 0.0),
                "latency_p99_ms": pl.get(99, 0.0),
                "tokens_per_sec": round(toks / wall, 2) if wall else 0.0}
