"""Goodput/badput accounting — how much wall time actually trained (a
copy of the JAX package's ``resilience/goodput.py``; pure host code).

The methodology mirrors Google's ML Goodput accounting: total wall time
splits into PRODUCTIVE time (steps that contributed to the final model)
and BADPUT categories — checkpoint-save blocking, emergency preemption
saves, restore time, supervisor restart backoff, and progress lost to a
rollback (steps re-run because the newest checkpoint predated the
crash).  Everything here is host-side bookkeeping: a few float adds per
event, nothing per-step on the hot path.

Consumed by: the Trainer (epoch ``[goodput]`` log line via
``train/metrics.py:attach_goodput``) and ``cli.run_training`` (summary
in the result dict).  The compile, warm-spare and slice counters are
kept so the summary's keys equal the JAX package's; the port's paths
that feed them are not ported yet and leave them at 0."""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Dict, Optional

# badput wall-time segments (seconds); anything not in a segment while
# the clock runs is counted productive.  detect_s = failure-to-observed
# latency (a peer's FAIL marker / heartbeat staleness, the pod
# coordinator's time-to-detect MTTR component; own-crash restarts cost
# ~0 detection).  readmission_hold_s = a survivor's parked time while a
# failed slice restarts and rejoins.
_SEGMENTS = ("checkpoint_blocking_s", "emergency_save_s", "restore_s",
             "restart_backoff_s", "rollback_lost_s", "detect_s",
             "readmission_hold_s")
# event counters (peer_failures / step_timeouts / restart_generations:
# pod-coordinated restarts, resilience/coordinator.py;
# slice_readmissions / pod_fallback_restarts: slice-granular
# recovery — completed re-admissions vs holds/rejoins that degraded to
# the whole-pod protocol; warm_spare_claims / warm_spare_swaps:
# warm-spare slices — seats claimed vs swaps completed through release;
# skipped_steps / rollbacks / quarantined_batches / quarantined_shards:
# the anomaly sentinel — optimizer updates skipped by the in-graph
# non-finite guard, loss-spike rollbacks, batch positions durably
# quarantined by them, and CRC-failed stream shards remapped away
# (resilience/sentinel.py))
_COUNTERS = ("saves", "skipped_saves", "save_failures", "shard_writes",
             "restores", "restarts", "preemptions", "steps",
             "peer_failures", "step_timeouts", "restart_generations",
             "slice_readmissions", "pod_fallback_restarts",
             "warm_spare_claims", "warm_spare_swaps",
             "skipped_steps", "rollbacks", "quarantined_batches",
             "quarantined_shards")


class GoodputTracker:
    """Accumulates badput segments + event counters against a wall clock
    started at :meth:`start` (idempotent — the first caller wins, so the
    supervisor's clock spans every retry)."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._t0: Optional[float] = None
        self._seg: Dict[str, float] = {k: 0.0 for k in _SEGMENTS}
        self._cnt: Dict[str, int] = {k: 0 for k in _COUNTERS}
        # restore_s accrued BEFORE the first restart (a --resume/auto-
        # resume start) is not recovery work — snapshotted when the
        # first restart lands so the MTTR numerator excludes it
        self._restore_pre_restart: Optional[float] = None
        # program-acquisition (trace + compile-or-deserialize) seconds,
        # fed by the compile observatory (telemetry/programs.py) when
        # wired.  Tracked BESIDE the badput segments, not among them:
        # reclassifying compile as badput would shift every run's
        # goodput_pct — this exists to SPLIT restart MTTR into its
        # compile vs restore components (the ROADMAP "compile-dominated
        # on real hardware" half that restore_s alone can't see), so
        # only the post-restart share enters the MTTR numerator, same
        # pre/post-restart snapshot idiom as restore_s.
        self._compile_s = 0.0
        self._compile_pre_restart: Optional[float] = None
        # warm-spare swap wall time (claim -> release), also tracked
        # BESIDE the segments rather than among them: the swap window
        # CONTAINS a restore (already a badput segment) and the
        # catch-up training steps — counting it as a segment too would
        # double-bill badput and understate the spare's goodput_pct
        self._swap_s = 0.0
        # optional (counter, total) feed — the telemetry recorder
        # installs itself here so restarts/preemptions/peer
        # failures land in the run's JSONL stream AS THEY HAPPEN, not
        # only in the epoch-end snapshot.  `steps` is excluded: it ticks
        # every dispatch and the per-dispatch step records already carry
        # that information.
        self._event_sink: Optional[Callable[[str, int], None]] = None

    def set_event_sink(self, sink: Optional[Callable[[str, int], None]]
                       ) -> None:
        self._event_sink = sink

    def start(self) -> "GoodputTracker":
        if self._t0 is None:
            self._t0 = self._clock()
        return self

    def add(self, segment: str, seconds: float) -> None:
        if segment not in self._seg:
            raise KeyError(f"unknown badput segment {segment!r}; "
                           f"want one of {_SEGMENTS}")
        self._seg[segment] += float(seconds)

    def add_compile(self, seconds: float) -> None:
        """Program-acquisition seconds (compile OR cache deserialize) —
        the observatory's feed for the restart-MTTR compile split."""
        self._compile_s += float(seconds)

    def add_warm_spare_swap(self, seconds: float) -> None:
        """Warm-spare swap wall time (coordinator claim -> release) —
        published in the summary, never summed into badput (the window
        overlaps the restore segment and productive catch-up steps)."""
        self._swap_s += float(seconds)

    def count(self, counter: str, n: int = 1) -> None:
        if counter not in self._cnt:
            raise KeyError(f"unknown counter {counter!r}; "
                           f"want one of {_COUNTERS}")
        if counter == "restarts" and self._restore_pre_restart is None:
            self._restore_pre_restart = self._seg["restore_s"]
            self._compile_pre_restart = self._compile_s
        self._cnt[counter] += n
        if self._event_sink is not None and counter != "steps":
            try:
                self._event_sink(counter, self._cnt[counter])
            except Exception:
                pass  # observability must never fail accounting

    @contextmanager
    def timed(self, segment: str):
        t0 = self._clock()
        try:
            yield
        finally:
            self.add(segment, self._clock() - t0)

    def summary(self) -> Dict[str, float]:
        """One flat dict: wall/badput/productive seconds, goodput %, and
        the event counters.  Safe to call before start() (all zeros)."""
        total = (self._clock() - self._t0) if self._t0 is not None else 0.0
        badput = sum(self._seg.values())
        productive = max(total - badput, 0.0)
        out: Dict[str, float] = {
            "wall_s": round(total, 3),
            "productive_s": round(productive, 3),
            "badput_s": round(badput, 3),
            "goodput_pct": round(100.0 * productive / total, 2) if total
            else 100.0,
        }
        for k, v in self._seg.items():
            out[k] = round(v, 3)
        out.update(self._cnt)
        out["compile_s"] = round(self._compile_s, 3)
        out["warm_spare_swap_s"] = round(self._swap_s, 3)
        if self._cnt["steps"]:
            out["productive_step_ms"] = round(
                productive / self._cnt["steps"] * 1e3, 3)
        if self._cnt["restarts"]:
            # mean time-to-recover per restart: detection latency (peer
            # marker/staleness observation) + supervisor backoff +
            # checkpoint restore + program re-acquisition (recompile or
            # cache deserialize — the compile-dominated component
            # real-hardware MTTR was blind to), with the compile and
            # restore halves published as restart_mttr_compile_s /
            # restart_mttr_restore_s so the executable cache's win is a
            # readable split.  Rollback replay cost is deliberately
            # separate (rollback_lost_s): it scales with checkpoint
            # cadence, not with recovery machinery.  Only restore/
            # compile time spent AFTER the first restart counts — the
            # restore (and first-compile) a resumed run starts from is
            # startup, not recovery, and would otherwise inflate the
            # headline.
            restarts = self._cnt["restarts"]
            recovery_restore = (self._seg["restore_s"]
                                - (self._restore_pre_restart or 0.0))
            recovery_compile = (self._compile_s
                                - (self._compile_pre_restart or 0.0))
            out["restart_mttr_restore_s"] = round(
                recovery_restore / restarts, 3)
            out["restart_mttr_compile_s"] = round(
                recovery_compile / restarts, 3)
            out["restart_mttr_s"] = round(
                (self._seg["detect_s"] + self._seg["restart_backoff_s"]
                 + recovery_restore + recovery_compile) / restarts, 3)
        return out
