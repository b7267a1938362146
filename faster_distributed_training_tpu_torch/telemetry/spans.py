"""Spans: one name, two surfaces (the JAX package's
``telemetry/spans.py``).

``with spans.span("restore"):`` labels the block ``fdt/restore`` in any
profiler trace being captured (``torch.profiler.record_function``: the
name shows on the host timeline and, through the profiler's correlation,
beside the kernels the block launched) and as an NVTX range on a card,
and records the block's host wall time into the installed
:class:`~faster_distributed_training_tpu_torch.telemetry.recorder.
TelemetryRecorder` (``set_recorder``) as a ``span`` record, with the
``step`` attribute when given.  The recorder is process-global, not
threaded through constructors: the seams live in modules that predate
it (the checkpoint writer thread, the resident upload) and cost two
clock reads when no recorder is installed.  Spans may open on any
thread (the checkpoint writer's do); :func:`active_spans` lists the ones
open right now, on every thread, for the flight dump.

A ``record_function`` opened on a thread the profiler was not started
on (``ckpt_commit``, on the writer thread; ``stream_refill``, on the
window's producer) reaches the trace only when the profiler follows that
thread; its host time is in the JSONL either way.

Names in use (append-only):

  ``h2d_upload``            the resident split's upload (once a run)
  ``epoch_reshard``         the epoch order's upload / the sharded view's
                            re-shard
  ``stream_refill``         a stream window refill (disk read + H2D)
  ``ckpt_snapshot``         the blocking device-to-host copy of a save
  ``ckpt_commit``           the background serialization and commit
  ``ckpt_sync_save``        a blocking save
  ``restore``               the manager's restore walk
  ``rendezvous``            a pod's restore-agreement barrier
  ``eval``                  an epoch's eval pass
  ``first_dispatch_compile`` a program's first dispatch (the port's
                            "compile": ``train/dispatch.py``)
  ``serve_warmup``, ``decode_warmup``  the serving engines' warm-up
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator, List, Optional

_ACTIVE = None   # the installed recorder, or None

# spans open right now, any thread: {token: {name, t0, step, thread}}
_OPEN: dict = {}
_OPEN_LOCK = threading.Lock()


def active_spans() -> List[dict]:
    """[{name, elapsed_ms, step?, thread}] of every span open right now
    (the flight dump's; empty when none is)."""
    now = time.monotonic()
    with _OPEN_LOCK:
        out = []
        for info in _OPEN.values():
            rec = {"name": info["name"],
                   "elapsed_ms": round((now - info["t0"]) * 1e3, 3),
                   "thread": info["thread"]}
            if info["step"] is not None:
                rec["step"] = info["step"]
            out.append(rec)
        return out


def set_recorder(recorder) -> Optional[object]:
    """Install ``recorder`` as the process's span sink; returns the one
    it replaces."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, recorder
    return prev


def get_recorder():
    return _ACTIVE


@contextlib.contextmanager
def span(name: str, step: Optional[int] = None) -> Iterator[None]:
    """``fdt/<name>`` around the block: a profiler label, an NVTX range
    on a card, and its host wall time to the recorder.  A block that
    raises still records its time."""
    import torch

    t0 = time.monotonic()
    token = object()
    with _OPEN_LOCK:
        _OPEN[token] = {"name": name, "t0": t0, "step": step,
                        "thread": threading.current_thread().name}
    label = f"fdt/{name}"
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(label)
    try:
        with torch.profiler.record_function(label):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
        with _OPEN_LOCK:
            _OPEN.pop(token, None)
        rec = _ACTIVE
        if rec is not None:
            rec.record_span(name, (time.monotonic() - t0) * 1e3, step=step)
