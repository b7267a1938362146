"""Profiling: torch.profiler traces and the card's memory (the JAX
package's ``utils/profiling.py``).

``--profile_steps A:B`` (:class:`StepWindowProfiler`) starts and stops a
``torch.profiler`` capture (the CPU activity, and the CUDA activity on a
card) around global train steps A..B, at dispatch boundaries, and writes
a Chrome trace to ``<telemetry_dir>/trace_steps_A_B/trace.json``;
``--profile`` (:func:`trace_profile`) captures the whole run into
``<telemetry_dir>/profile/trace.json``.  View either in Perfetto or
``chrome://tracing``.  A capture on a card that recorded no device
activity is counted and logged (``device_events`` is 0), never passed
off as a full trace; the smoke fails on it.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Iterator, Optional, Tuple

TRACE_FILE = "trace.json"


def parse_profile_steps(spec: str) -> Optional[Tuple[int, int]]:
    """``--profile_steps A:B`` -> (A, B), None for "".  Steps are
    1-indexed global train steps (the checkpointed step counter), A <= B
    inclusive; a malformed spec raises ValueError at config time, not at
    step A."""
    if not spec:
        return None
    a, sep, b = str(spec).partition(":")
    try:
        lo, hi = int(a), int(b)
    except ValueError:
        lo = hi = 0
    if not sep or lo < 1 or hi < lo:
        raise ValueError(
            f"bad --profile_steps {spec!r}; want 'A:B' with 1 <= A <= B "
            f"(1-indexed global train steps, inclusive)")
    return lo, hi


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", None)
                 or getattr(evt, "self_cuda_time_total", 0.0) or 0.0)


class TorchTrace:
    """One ``torch.profiler`` capture written to ``<log_dir>/trace.json``:
    ``start(log_dir)``, then ``stop()``, which exports the trace and
    returns the number of device events (kernels, copies) it holds, or
    None without a card."""

    def __init__(self):
        self.prof = None
        self.log_dir: Optional[str] = None
        self.cuda = False

    def start(self, log_dir: str) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else [])
        self.log_dir = log_dir
        self.prof = profile(activities=acts)
        self.prof.start()

    def stop(self) -> Optional[int]:
        prof, self.prof = self.prof, None
        prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.log_dir, TRACE_FILE))
        if not self.cuda:
            return None
        return sum(e.count for e in prof.key_averages() if _device_us(e) > 0)


class StepWindowProfiler:
    """Windowed capture: start and stop the profiler around a global-step
    range mid-run (``--profile_steps A:B``).  The window quantizes to
    dispatch boundaries: under K steps a dispatch the trace covers the
    dispatches that hold steps A..B.  A run resumed past B never starts;
    resumed inside the window, it captures the rest.  The close of the
    window runs ``fence`` first (one readback of the last dispatch's
    loss: the card's work of the window lands in the trace); nothing
    else reads the card.

    ``start_fn(log_dir)`` / ``stop_fn()`` are the seam (default a
    :class:`TorchTrace`; ``stop_fn`` may return the device events
    captured, kept in ``device_events``).  A profiler that fails to start
    logs and disables itself; one that captured no device activity on a
    card is logged (``device_events`` 0)."""

    def __init__(self, log_dir: str, start_step: int, stop_step: int,
                 start_fn: Optional[Callable[[str], None]] = None,
                 stop_fn: Optional[Callable[[], Optional[int]]] = None,
                 log: Callable[[str], None] = print):
        self.log_dir = log_dir
        self.a = int(start_step)
        self.b = int(stop_step)
        if start_fn is None or stop_fn is None:
            trace = TorchTrace()
            start_fn = start_fn or trace.start
            stop_fn = stop_fn or trace.stop
        self._start = start_fn
        self._stop = stop_fn
        self._log = log
        self.active = False
        self.done = False
        self.started_at: Optional[int] = None
        self.stopped_at: Optional[int] = None
        self.device_events: Optional[int] = None

    def before_dispatch(self, completed_steps: int, n_steps: int = 1
                        ) -> None:
        """Called with the global steps completed so far, before a
        dispatch that runs steps ``completed + 1 .. completed + n``."""
        if self.done or self.active:
            return
        if completed_steps >= self.b:
            self.done = True       # resumed past the window: never start
            return
        if completed_steps + n_steps >= self.a:
            try:
                self._start(self.log_dir)
            except Exception as e:
                self._log(f"[profile] could not start the step-window "
                          f"trace ({e!r}); --profile_steps disabled for "
                          f"this run")
                self.done = True
                return
            self.active = True
            self.started_at = completed_steps
            self._log(f"[profile] trace started before step "
                      f"{completed_steps + 1} (window {self.a}:{self.b}) "
                      f"-> {self.log_dir}")

    def after_dispatch(self, completed_steps: int,
                       fence: Optional[Callable[[], None]] = None) -> None:
        """Called after a dispatch with the new completed-step count;
        ``fence`` runs before the stop, once, when the window closes."""
        if not self.active or completed_steps < self.b:
            return
        if fence is not None:
            fence()
        self._finish(completed_steps)

    def close(self) -> None:
        """The run's end: stop a trace still open (the run ended before
        step B), so the capture is never lost."""
        if self.active:
            self._finish(None)

    def _finish(self, completed_steps: Optional[int]) -> None:
        self.active = False
        self.done = True
        self.stopped_at = completed_steps
        self.device_events = self._stop()
        at = (f"after step {completed_steps}" if completed_steps is not None
              else "at run end (window unfinished)")
        self._log(f"[profile] trace stopped {at} -> {self.log_dir}"
                  + ("" if self.device_events is None else
                     f" ({self.device_events} device events)"))
        if self.device_events == 0:
            self._log("[profile] WARNING: the trace holds no device "
                      "activity (the CUDA activity was not captured)")


@contextlib.contextmanager
def trace_profile(log_dir: Optional[str],
                  log: Callable[[str], None] = print) -> Iterator[None]:
    """``with trace_profile(dir):`` captures a whole-run trace into
    ``<dir>/trace.json`` when ``dir`` is set; a no-op otherwise."""
    if not log_dir:
        yield
        return
    trace = TorchTrace()
    trace.start(log_dir)
    try:
        yield
    finally:
        n = trace.stop()
        log(f"[profile] whole-run trace -> {os.path.join(log_dir, TRACE_FILE)}"
            + ("" if n is None else f" ({n} device events)"))
        if n == 0:
            log("[profile] WARNING: the trace holds no device activity")


def peak_memory_bytes(device=None) -> Optional[int]:
    """The card's peak allocated bytes since the last reset
    (``torch.cuda.max_memory_allocated``), or None off a card (the CPU,
    as the JAX function's CPU backend)."""
    import torch

    dev = _card(device)
    if dev is None:
        return None
    return int(torch.cuda.max_memory_allocated(dev))


def memory_watermarks(device=None) -> Optional[dict]:
    """{"peak_bytes", "bytes_in_use"} of the card (the allocator's peak
    and current allocated bytes), or None off a card: the epoch's
    ``memory`` event."""
    import torch

    dev = _card(device)
    if dev is None:
        return None
    return {"peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
            "bytes_in_use": int(torch.cuda.memory_allocated(dev))}


def compiled_memory_bytes(variant: dict) -> Optional[int]:
    """A program's static peak from its row of the program table
    (``telemetry.programs``, a variant of ``summary()``): temp + argument
    + output - alias (state updated in place is both an argument and an
    output), or None when the row has no memory fields (the CPU) or the
    sum is not positive (JAX ``compiled_memory_bytes``)."""
    if "temp_bytes" not in variant:
        return None
    total = sum(int(variant.get(f, 0) or 0) for f in (
        "temp_bytes", "argument_bytes", "output_bytes"))
    total -= int(variant.get("alias_bytes", 0) or 0)
    return total if total > 0 else None


def _card(device):
    import torch

    if device is None:
        return torch.device("cuda") if torch.cuda.is_available() else None
    dev = torch.device(device)
    return dev if dev.type == "cuda" else None
