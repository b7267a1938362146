"""Spans: one name, two surfaces (the JAX package's
``telemetry/spans.py``, its ``span`` and ``set_recorder``).

``with spans.span("restore"):`` labels the block ``fdt/restore`` in any
profiler trace being captured (``torch.profiler.record_function``: the
name shows on the host timeline and, through the profiler's correlation,
beside the kernels the block launched) and as an NVTX range on a card.
When a recorder is installed (``set_recorder``: none is ported yet, the
seam holds ``None``) the block's host wall time also goes to it as
``record_span(name, ms, step=...)``.  Spans may open on any thread (the
checkpoint writer's do).

Names in use: ``ckpt_snapshot`` (the blocking device-to-host copy of a
save), ``ckpt_commit`` (the background serialization and commit),
``ckpt_sync_save`` (a blocking save), ``restore`` (the manager's restore
walk), ``rendezvous`` (a pod's restore-agreement barrier).
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

_ACTIVE = None   # the installed recorder, or None


def set_recorder(recorder) -> Optional[object]:
    """Install ``recorder`` as the process's span sink; returns the one
    it replaces."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, recorder
    return prev


@contextlib.contextmanager
def span(name: str, **attrs) -> Iterator[None]:
    """``fdt/<name>`` around the block: a profiler label, an NVTX range
    on a card, and (with a recorder) its host wall time.  A block that
    raises still records its time."""
    import torch

    t0 = time.monotonic()
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
        rec = _ACTIVE
        if rec is not None:
            rec.record_span(name, (time.monotonic() - t0) * 1e3,
                            step=attrs.get("step"))
