"""The supervisor: bounded restarts with backoff, no futile loops (the
JAX package's ``resilience/supervisor.py``).

``cli.run_training`` hands it an ``attempt(restart_index)`` closure
(restore the newest valid checkpoint, then ``Trainer.fit``) and a
``progress()`` of the global step.  The first restart is immediate and
the backoff doubles from the second (``backoff_base * 2^k``, capped); at
most ``max_restarts`` restarts; two failures in a row at the same step
with the same exception type are deterministic and re-raise at once
(a :class:`PeerFailure` or a :class:`LossSpike` never counts as one: a
peer failure's step is where it was observed, and a spike's replay skips
the quarantined batches); :class:`Preempted` passes through (the
emergency save landed, the platform owns the restart).  With a pod
``coordinator`` every attempt enters through ``begin_attempt`` (all
hosts restart into one generation), every failure is published with
``record_failure`` before the backoff, and a completed run writes its
``EXIT`` marker.  The flight recorder's dump on a failure waits for the
port's telemetry."""

from __future__ import annotations

import time
from typing import Any, Callable, Optional, Tuple

from faster_distributed_training_tpu_torch.resilience import Preempted
from faster_distributed_training_tpu_torch.resilience.coordinator import (
    PeerFailure)
from faster_distributed_training_tpu_torch.resilience.sentinel import LossSpike


class Supervisor:
    def __init__(self, max_restarts: int = 3, backoff_base: float = 1.0,
                 backoff_cap: float = 30.0, goodput=None,
                 sleep: Callable[[float], None] = time.sleep,
                 log: Callable[[str], None] = print, coordinator=None):
        self.max_restarts = int(max_restarts)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self._goodput = goodput
        self._sleep = sleep
        self._log = log
        self._coordinator = coordinator

    def run(self, attempt: Callable[[int], Any],
            progress: Callable[[], Optional[int]]) -> Any:
        """attempt(restart_index) runs one training attempt (index 0 is
        the first run; the closure re-restores on every call so attempt
        k resumes from whatever checkpoint is newest AFTER failure k-1).
        progress() reports the global step reached, read after a failure
        for the deterministic-crash check."""
        # (step-or-None, exception type) of the previous failure: the
        # deterministic-crash check needs BOTH to call a replay futile
        last_fail: Optional[Tuple[Optional[int], type]] = None
        restarts = 0
        while True:
            try:
                if self._coordinator is not None:
                    self._coordinator.begin_attempt()
                result = attempt(restarts)
                if self._coordinator is not None:
                    # durably mark this host DONE so a peer restarting
                    # AFTER our exit fails its restore barrier fast
                    # ("pod already finished") instead of waiting out
                    # the full gather timeout for a host that is gone
                    self._coordinator.record_completion()
                return result
            except Preempted:
                raise                       # clean shutdown, never retried
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                step = progress()
                if self._coordinator is not None:
                    # publish to the pod BEFORE the backoff so the peers'
                    # next poll observes it while this host sleeps
                    self._coordinator.record_failure(e, step=step)
                # the flight dump before the restart replaces the
                # evidence (a no-op with telemetry off; one an exception)
                from faster_distributed_training_tpu_torch.telemetry import (
                    flight)
                flight.emergency_dump("supervisor_failure", exc=e,
                                      step=step)
                # PeerFailure never participates in the deterministic-
                # crash check: its step is the OBSERVATION point (poll-
                # boundary-quantized, typically the restored step), not
                # the fault point, so two observations at one step carry
                # no replay-determinism signal — and short-circuiting
                # here would make a survivor give up on a flapping peer
                # with retry budget remaining, breaking the "the pod
                # exhausts every host's budget together" contract.
                # LossSpike is exempt for the inverse reason: the spike
                # QUARANTINED its batches before raising, so the replay
                # is a DIFFERENT program of work — a second spike at the
                # same step is a new batch spiking, not evidence that
                # retrying is futile (resilience/sentinel.py).
                transient_peer = isinstance(e, (PeerFailure, LossSpike))
                if not transient_peer and last_fail == (step, type(e)):
                    self._log(
                        f"[supervisor] step {step} failed twice in a row "
                        f"with {type(e).__name__} — the crash is "
                        f"deterministic (reproduces on replay from the "
                        f"same checkpoint); re-raising instead of looping")
                    raise
                restarts += 1
                if restarts > self.max_restarts:
                    self._log(f"[supervisor] giving up after "
                              f"{self.max_restarts} restarts "
                              f"(last failure at step {step}: {e!r})")
                    raise
                # first restart immediate, backoff from the second: one
                # transient failure recovers at restore speed, and only a
                # host that keeps dying pays the exponential ramp
                delay = (0.0 if restarts == 1
                         else min(self.backoff_cap,
                                  self.backoff_base * 2.0 ** (restarts - 2)))
                self._log(f"[supervisor] attempt {restarts - 1} failed at "
                          f"step {step} ({e!r}); restarting from the newest "
                          f"valid checkpoint "
                          + ("immediately" if delay == 0
                             else f"in {delay:.1f}s")
                          + f" ({restarts}/{self.max_restarts})")
                if self._goodput:
                    self._goodput.count("restarts")
                if delay > 0:
                    if self._goodput:
                        with self._goodput.timed("restart_backoff_s"):
                            self._sleep(delay)
                    else:
                        self._sleep(delay)
                if not transient_peer:
                    # a PeerFailure neither records NOR clears the pair:
                    # an own-crash recurring at one step with a peer
                    # incident in between is still deterministic
                    last_fail = (step, type(e))
