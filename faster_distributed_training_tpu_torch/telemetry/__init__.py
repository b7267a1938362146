"""Run telemetry of the port (the JAX package's ``telemetry/``).

Every training run, not only a benchmark, records itself:

  * ``recorder``  :class:`TelemetryRecorder`, a host-side ring of one
    record a dispatch (step, wall ms, examples/s, data-wait ms,
    checkpoint-blocking ms, K, epoch) plus events, written as JSONL to
    ``<telemetry_dir>/host_<pi>.jsonl`` by a background writer, and the
    run manifest (:func:`write_manifest`: config, mesh, torch and CUDA
    versions, the card);
  * ``spans``     ``with spans.span("restore"):`` records the block's host
    wall time and labels it ``fdt/restore`` in a profiler trace;
  * ``aggregate`` process 0 folds the hosts' JSONL into pod step-time
    percentiles at each epoch's end (marker files) and flags stragglers
    in a ``[telemetry]`` line and ``pod_summary.json``;
  * ``flight``    the crash flight recorder;
  * ``programs``  the program table (:class:`ProgramObservatory`: CUDA
    graphs, eager programs' first dispatches and kernel libraries, with
    the retrace detector; merged into the manifest's ``compile`` at
    close), the train state's bytes a card (the ``memory`` event) and the
    placement-drift guard;
  * windowed profiler capture beside it: ``--profile_steps A:B``
    (``utils/profiling.StepWindowProfiler``).

``--no_telemetry`` or ``FDT_TELEMETRY=0`` turns it all off:
:func:`build_telemetry` returns None and the Trainer's loop does no
telemetry work.  ``FDT_PROGRAM_OBS=0`` turns off the program table alone
(and the executable cache that rides it).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

from faster_distributed_training_tpu_torch.telemetry import flight  # noqa: F401
from faster_distributed_training_tpu_torch.telemetry import programs  # noqa: F401
from faster_distributed_training_tpu_torch.telemetry import spans  # noqa: F401
from faster_distributed_training_tpu_torch.telemetry.aggregate import (  # noqa: F401,E501
    SUMMARY, RunFold, aggregate_run, pod_epoch_aggregate,
    publish_epoch_marker, read_host_records, span_breakdown, step_time_ms)
from faster_distributed_training_tpu_torch.telemetry.programs import (  # noqa: F401,E501
    ProgramObservatory, observatory_enabled, state_bytes_table)
from faster_distributed_training_tpu_torch.telemetry.recorder import (  # noqa: F401,E501
    ENV_KILL, MANIFEST, SCHEMA_VERSION, TELEMETRY_SCHEMA, TelemetryRecorder,
    _write_json_atomic, update_manifest, write_manifest)


def resolve_telemetry_dir(cfg) -> str:
    """The run's telemetry directory: ``--telemetry_dir`` when set, else
    ``<checkpoint_dir>/telemetry`` (beside the checkpoints, so the hosts
    of a pod that share a checkpoint filesystem share it too)."""
    explicit = getattr(cfg, "telemetry_dir", "") or ""
    if explicit:
        return explicit
    return os.path.join(getattr(cfg, "checkpoint_dir", "."), "telemetry")


def enabled(cfg) -> bool:
    """Telemetry is on unless ``--no_telemetry`` or ``FDT_TELEMETRY=0``."""
    return (os.environ.get(ENV_KILL, "1") != "0"
            and bool(getattr(cfg, "telemetry", True)))


def build_observatory(cfg, recorder=None, log: Callable[[str], None] = print
                      ) -> Optional[ProgramObservatory]:
    """A ProgramObservatory writing to ``recorder``, with the executable
    cache ``--executable_cache`` asks for armed on it through the run's
    storage backend (``--storage_backend``); None under
    ``FDT_PROGRAM_OBS=0``."""
    if not observatory_enabled():
        return None
    from faster_distributed_training_tpu_torch.resilience.executable_cache \
        import build_executable_cache
    from faster_distributed_training_tpu_torch.resilience.storage import (
        build_backend)

    obs = ProgramObservatory(recorder=recorder, log=log)
    backend = build_backend(getattr(cfg, "storage_backend", "posix"),
                            getattr(cfg, "checkpoint_dir", "."),
                            log=lambda _line: None)
    obs.executable_cache = build_executable_cache(cfg, backend=backend,
                                                  log=log)
    return obs


class RunTelemetry:
    """The recorder, the program table (``observatory``: a
    ProgramObservatory, None under ``FDT_PROGRAM_OBS=0``) and the pod
    fold's policy: the Trainer writes to ``self.recorder``; this object
    owns the epoch boundary and the lifecycle."""

    def __init__(self, recorder: TelemetryRecorder,
                 straggler_ratio: float = 2.0,
                 aggregate_wait_s: float = 2.0,
                 log: Callable[[str], None] = print,
                 observatory: Optional[ProgramObservatory] = None):
        self.recorder = recorder
        self.observatory = observatory
        self.directory = recorder.directory
        self.pi, self.pc = recorder.pi, recorder.pc
        self.straggler_ratio = float(straggler_ratio)
        self.aggregate_wait_s = float(aggregate_wait_s)
        self._log = log
        self._closed = False
        # process 0's incremental fold: an epoch parses only new tails
        self._fold = RunFold(self.directory) if self.pi == 0 else None
        # epoch markers older than this are a reused directory's residue
        self._created_t = time.time()

    def end_epoch(self, epoch: int) -> Optional[dict]:
        """The epoch boundary: flush this host's records to disk, publish
        its marker and (process 0) fold every host into the
        ``[telemetry]`` line and ``pod_summary.json``, waiting at most
        ``aggregate_wait_s`` for the peers' markers."""
        self.recorder.flush(wait=True)
        publish_epoch_marker(self.directory, epoch, self.pi)
        return pod_epoch_aggregate(
            self.directory, epoch, self.pi, self.pc,
            straggler_ratio=self.straggler_ratio, log=self._log,
            wait_s=self.aggregate_wait_s if self.pc > 1 else 0.0,
            fold=self._fold, newer_than=self._created_t)

    def close(self) -> None:
        """Process 0 merges the program table into the manifest
        (``compile``), then the tail is flushed and the writer joined;
        process 0 then refreshes ``pod_summary.json`` from the whole
        directory (a write that fails is logged)."""
        if self._closed:
            return
        self._closed = True
        if self.observatory is not None and self.pi == 0:
            try:
                update_manifest(self.directory,
                                {"compile": self.observatory.summary()},
                                log=self._log)
            except Exception as e:      # a report, not the run's outcome
                self._log(f"[telemetry] could not merge the program table "
                          f"into {MANIFEST}: {e!r}")
        self.recorder.close()
        if self.pi == 0:
            summary = aggregate_run(self.directory,
                                    straggler_ratio=self.straggler_ratio)
            if summary.get("hosts"):
                try:
                    _write_json_atomic(
                        os.path.join(self.directory, SUMMARY), summary)
                except OSError as e:
                    self._log(f"[telemetry] could not write {SUMMARY}: "
                              f"{e!r}")


def build_telemetry(cfg, log: Callable[[str], None] = print
                    ) -> Optional[RunTelemetry]:
    """RunTelemetry for a TrainConfig (its program table armed with the
    executable cache ``--executable_cache`` asks for), or None when it is
    off (``--no_telemetry`` / ``FDT_TELEMETRY=0``)."""
    if not enabled(cfg):
        return None
    recorder = TelemetryRecorder(
        resolve_telemetry_dir(cfg),
        step_every=int(getattr(cfg, "telemetry_every", 1) or 1), log=log)
    return RunTelemetry(
        recorder,
        straggler_ratio=float(getattr(cfg, "straggler_ratio", 2.0) or 2.0),
        aggregate_wait_s=float(getattr(cfg, "aggregate_grace_s", 2.0) or 0.0),
        log=log, observatory=build_observatory(cfg, recorder, log))
