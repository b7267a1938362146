"""Preemption: SIGTERM / SIGINT -> an agreed emergency save (the JAX
package's ``resilience/preemption.py``).

The handler only sets a flag (Python runs signal handlers on the main
thread, between bytecodes: touching the card or the filesystem there
could deadlock on a lock the interrupted code holds); the train loop
polls it at dispatch boundaries.  Across processes (torch.distributed,
every rank of the run) the emergency save is collective, so every rank
must enter it at the same step: :meth:`should_stop` reduces the local
flag with a MAX over the run's process group
(``parallel.collectives.all_gather_across_processes``) each time the
step crosses a multiple of ``sync_every``, and returns False between
them on every rank, the ranks that saw the signal included.  One
process (an fs-simulated pod host too): the local flag."""

from __future__ import annotations

import signal
import threading
from typing import Callable, Optional, Tuple

import numpy as np

_DEFAULT_SIGNALS: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)


class PreemptionHandler:
    def __init__(self, signals: Tuple[int, ...] = _DEFAULT_SIGNALS,
                 sync_every: int = 1, log: Callable[[str], None] = print):
        self._signals = tuple(signals)
        self._sync_every = max(int(sync_every), 1)
        self._log = log
        self._flag = threading.Event()
        self._old = {}
        self._installed = False
        self._last_polled = 0

    def _on_signal(self, signum, frame) -> None:
        if not self._flag.is_set():
            self._log(f"[preempt] received signal {signum}; will emergency-"
                      f"save at the next step boundary")
        self._flag.set()

    def install(self) -> "PreemptionHandler":
        """Idempotent; off the main thread (where CPython refuses
        ``signal.signal``) it logs that preemption awareness is off."""
        if self._installed:
            return self
        try:
            for s in self._signals:
                self._old[s] = signal.signal(s, self._on_signal)
            self._installed = True
        except ValueError as e:
            self._log(f"[preempt] could not install signal handlers ({e}); "
                      f"preemption awareness disabled in this context")
            self._old.clear()
        return self

    def uninstall(self) -> None:
        for s, h in self._old.items():
            try:
                signal.signal(s, h)
            except (ValueError, TypeError):
                pass
        self._old.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc) -> Optional[bool]:
        self.uninstall()
        return None

    def seen(self) -> bool:
        """This process's flag (no collective)."""
        return self._flag.is_set()

    def should_stop(self, step: int) -> bool:
        """The agreed stop decision, polled once a dispatch.  Across
        processes: at a poll whose step crossed a ``sync_every`` boundary
        since the last one every rank gathers every flag and ORs them;
        between such polls False everywhere.  The ranks see the same
        step sequence, so they cross the same boundaries."""
        import torch.distributed as dist

        if not dist.is_initialized() or dist.get_world_size() == 1:
            return self._flag.is_set()
        from faster_distributed_training_tpu_torch.parallel.collectives \
            import all_gather_across_processes

        prev, self._last_polled = self._last_polled, step
        if step // self._sync_every <= prev // self._sync_every:
            return False
        bits = all_gather_across_processes(
            np.int32(1 if self._flag.is_set() else 0))
        return bool(np.asarray(bits).max() > 0)
