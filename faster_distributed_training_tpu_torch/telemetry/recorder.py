"""Run-scoped telemetry: per-dispatch records and the run manifest as
JSONL (the JAX package's ``telemetry/recorder.py``).

A :class:`TelemetryRecorder` buffers one small host-side record per
dispatch (step, wall ms, examples/s, data-wait ms, checkpoint-blocking
ms, K, epoch) plus span, epoch and goodput events, and one background
writer appends them as JSONL to ``<telemetry_dir>/host_<pi>.jsonl``: the
step thread only appends to a list under a lock.  A run manifest
(config, mesh, torch and CUDA versions, the card's name) is written once
at startup (:func:`write_manifest`), so a telemetry directory describes
itself.

The hot-path cost per dispatch is a few ``time.monotonic`` reads, one
dict and one lock-guarded append; JSON encoding and file IO run on the
writer thread.  Nothing reads a device tensor.  The buffer is bounded:
at ``capacity`` records it goes to the writer as one batch, and when the
writer is more than ``_MAX_PENDING_BATCHES`` batches behind (a wedged
filesystem) new batches are dropped and counted (``dropped_records``)
rather than queued.  A batch the writer fails to write (any exception,
not only an ``OSError``) is logged and counted the same way.  At
``close`` the count goes out as one ``flush_stats`` record and a log
line, so a lost record is never silent.  ``FDT_TELEMETRY=0`` turns the
whole subsystem off (``telemetry.build_telemetry``).

Schema (append-only: fields may be added, never renamed; consumers
ignore unknown fields).  One JSON object a line, discriminated by
``"kind"``; :data:`TELEMETRY_SCHEMA` is the registry, kept equal to the
JAX package's so that its ``scripts/telemetry_report.py`` and
``scripts/check_telemetry_schema.py`` read and lint the port's stream:

  ``run_start``  {t, process_index, process_count, schema}
  ``step``       {step, epoch, n, k, wall_ms, dispatch_ms, data_ms,
                  block_ms, examples, ex_s, compile?}: step = the global
                 step after the dispatch; n = the step in the epoch;
                 wall_ms = host wall since the previous record (data wait
                 + dispatch + resilience hooks); dispatch_ms = the
                 dispatch call alone (host time: the card may still be
                 running it); compile=true marks a program's first
                 dispatch (``train/dispatch.py`` says what that is in
                 the port), which the folds leave out of percentiles
  ``span``       {name, dur_ms, step?}          (telemetry/spans.py)
  ``epoch``      {epoch, steps, trained_steps, loss?, accuracy?, wall_s,
                  ex_s, peak_mem_bytes?, eval_loss?, eval_accuracy?,
                  perplexity?, eval_perplexity?}
  ``goodput``    {... GoodputTracker.summary() ...}  (an epoch's snapshot)
  ``goodput_event`` {counter, total}
  ``rollback``   {epoch, restored_epoch, step}
  ``flush_stats`` {dropped_records}              (at close, when any
                  record was dropped or failed to write)
  ``memory``     {scope, ...}: scope "state", the state's bytes per card
                 (telemetry/programs.py); scope "epoch", the card's
                 memory watermarks; scope "sharding_drift", the
                 placement-drift guard (train/loop.py)
  ``flight``     {path, reason}                  (telemetry/flight.py)
  ``serve_batch`` / ``serve_request``            (serve/scheduler.py)
  ``stream_refill`` / ``stream_stall``           (data/stream/window.py)
  ``decode_admit`` / ``decode_step`` / ``slot_evict``
                                                 (serve/decode/scheduler.py)
  ``pp_bubble`` / ``pp_stage``                   (cli.run_training, pp)

  ``program``    {name, variant, lowerings, compile_ms, lower_ms,
                  fingerprint, cache, cache_method, cache_source, avals,
                  argument_bytes?, output_bytes?, temp_bytes?,
                  generated_code_bytes?, alias_bytes?}
                 (telemetry/programs.py: a CUDA graph, an eager program's
                 first dispatch or a kernel library)
  ``retrace``    {name, reason, lowerings, avals, prev_avals}

Registered and not emitted by the port yet: ``spare`` (warm spares).

The host file is opened in append mode: a supervised relaunch of the
same run (same checkpoint_dir) continues the same story.  A fresh run
wants a fresh directory, like the checkpoint directory; the epoch fold's
markers are time-scoped (telemetry/aggregate.py) so a reused directory's
residue cannot satisfy it.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional

SCHEMA_VERSION = 1
ENV_KILL = "FDT_TELEMETRY"
MANIFEST = "manifest.json"

# kind -> the complete set of fields its records may carry; append-only.
# A kind mapped to None is open: its fields come from a runtime dict
# ("goodput" = GoodputTracker.summary()'s keys).
TELEMETRY_SCHEMA: Dict[str, Optional[frozenset]] = {
    "run_start": frozenset({"t", "process_index", "process_count",
                            "schema"}),
    "step": frozenset({"step", "epoch", "n", "k", "wall_ms",
                       "dispatch_ms", "data_ms", "block_ms", "examples",
                       "ex_s", "compile"}),
    "span": frozenset({"name", "dur_ms", "step"}),
    "epoch": frozenset({"epoch", "steps", "trained_steps", "loss",
                        "accuracy", "wall_s", "ex_s", "peak_mem_bytes",
                        "eval_loss", "eval_accuracy", "perplexity",
                        "eval_perplexity"}),
    "goodput": None,
    "goodput_event": frozenset({"counter", "total"}),
    "rollback": frozenset({"epoch", "restored_epoch", "step"}),
    "flush_stats": frozenset({"dropped_records"}),
    "program": frozenset({"name", "variant", "lowerings", "compile_ms",
                          "lower_ms", "fingerprint", "cache",
                          "cache_method", "cache_source", "avals",
                          "argument_bytes", "output_bytes", "temp_bytes",
                          "generated_code_bytes", "alias_bytes"}),
    "retrace": frozenset({"name", "reason", "lowerings", "avals",
                          "prev_avals"}),
    "memory": frozenset({"scope", "epoch", "step",
                         "params_bytes_per_chip", "params_leaves",
                         "opt_state_bytes_per_chip", "opt_state_leaves",
                         "batch_stats_bytes_per_chip",
                         "batch_stats_leaves", "total_bytes_per_chip",
                         "top_leaves", "opt_state_tiers", "pp_residency",
                         "peak_bytes",
                         "bytes_in_use", "expected", "got",
                         "changed_leaves"}),
    "flight": frozenset({"path", "reason"}),
    "serve_batch": frozenset({"bucket", "size", "real", "pad", "replica",
                              "dispatch_ms", "attempts"}),
    "serve_request": frozenset({"bucket", "len", "queue_ms", "total_ms",
                                "replica"}),
    "stream_refill": frozenset({"epoch", "base", "batches", "bytes",
                                "read_ms", "h2d_ms"}),
    "stream_stall": frozenset({"epoch", "step", "wait_ms"}),
    "spare": frozenset({"event", "spare", "seat", "slice", "generation",
                        "step"}),
    "decode_admit": frozenset({"replica", "slot", "bucket", "len",
                               "queue_ms"}),
    "decode_step": frozenset({"replica", "pages", "active", "batch",
                              "step_ms"}),
    "slot_evict": frozenset({"replica", "slot", "tokens", "reason"}),
    "pp_bubble": frozenset({"n_stages", "n_microbatches", "n_ticks",
                            "schedule", "bubble_pct"}),
    "pp_stage": frozenset({"stage", "layers", "idle_ticks",
                           "active_ticks"}),
}
# kinds no longer emitted (none)
RETIRED_KINDS: frozenset = frozenset()

# the writer's backlog bound, in batches: past it the recorder drops
_MAX_PENDING_BATCHES = 4


def _write_json_atomic(path: str, obj) -> None:
    """``obj`` as JSON at ``path`` through a temporary file, fsync and
    rename: a reader never sees a torn manifest or summary."""
    tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, default=str)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def device_facts(device=None) -> dict:
    """The manifest's device keys: ``backend`` ("cuda" / "cpu"),
    ``device_kind`` (``torch.cuda.get_device_name``, or "cpu"),
    ``device_count``, the torch and CUDA versions."""
    import torch

    dev = torch.device(device if device is not None
                       else ("cuda" if torch.cuda.is_available() else "cpu"))
    out = {"torch_version": torch.__version__,
           "cuda_version": torch.version.cuda or ""}
    if dev.type == "cuda":
        out["backend"] = "cuda"
        out["device_kind"] = torch.cuda.get_device_name(
            dev.index if dev.index is not None else 0)
        out["device_count"] = torch.cuda.device_count()
    else:
        out["backend"] = "cpu"
        out["device_kind"] = "cpu"
        out["device_count"] = 1
    return out


def write_manifest(directory: str, cfg=None, mesh: Optional[dict] = None,
                   extra: Optional[dict] = None, device=None,
                   process_count: int = 1) -> str:
    """``<directory>/manifest.json``, written once at startup (process 0):
    what a reader needs to interpret the host JSONL files without the
    process that wrote them: the config, the mesh (``{axis: size}``), the
    torch and CUDA versions, the card's name and count, the process
    count.  It has no ``jax_version`` or ``jaxlib_version`` (the JAX
    report prints "?" for them).  Returns the path."""
    import dataclasses

    man: dict = {"schema": SCHEMA_VERSION,
                 "unix_time": round(time.time(), 3)}
    man.update(device_facts(device))
    man["process_count"] = int(process_count)
    if mesh is not None:
        man["mesh"] = {str(k): int(v) for k, v in dict(mesh).items()}
    if cfg is not None:
        man["config"] = (dataclasses.asdict(cfg)
                         if dataclasses.is_dataclass(cfg) else dict(cfg))
    if extra:
        man.update(extra)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, MANIFEST)
    _write_json_atomic(path, man)
    return path


def update_manifest(directory: str, extra: dict,
                    log: Callable[[str], None] = print) -> Optional[str]:
    """Merge ``extra`` into the manifest (an atomic rewrite): serving and
    decode add their sections beside a training run's and never replace
    it.  A missing or unreadable manifest gets a fresh one holding
    ``extra``.  Returns the path, or None when the write failed (logged:
    a full disk at shutdown must not mask the run's own outcome)."""
    path = os.path.join(directory, MANIFEST)
    man: dict = {}
    try:
        with open(path) as f:
            man = json.load(f)
    except (OSError, ValueError):
        pass
    man.update(extra)
    try:
        os.makedirs(directory, exist_ok=True)
        _write_json_atomic(path, man)
    except OSError as e:
        log(f"[telemetry] could not update {path}: {e!r}")
        return None
    return path


class TelemetryRecorder:
    """Host-side ring of telemetry records, written as JSONL by one
    background writer into an append-mode file.

    ``process_index`` / ``process_count`` default to the pod identity
    (``FDT_POD_INDEX`` / ``FDT_POD_COUNT``, else the torch.distributed
    rank and world; ``resilience.coordinator.pod_identity``); explicit
    values let two recorders in one process act as a two-host pod that
    shares a directory.  ``clock`` gives ``run_start``'s wall time."""

    def __init__(self, directory: str,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 capacity: int = 256,
                 step_every: int = 1,
                 recent: int = 256,
                 log: Callable[[str], None] = print,
                 clock: Callable[[], float] = time.time):
        if process_index is None or process_count is None:
            from faster_distributed_training_tpu_torch.resilience.coordinator \
                import pod_identity
            pi, pc, _sim = pod_identity()
            process_index = pi if process_index is None else process_index
            process_count = pc if process_count is None else process_count
        self.pi = int(process_index)
        self.pc = int(process_count)
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.path = os.path.join(self.directory, f"host_{self.pi:05d}.jsonl")
        self.capacity = max(int(capacity), 1)
        # --telemetry_every N keeps every Nth step record; sampling drops
        # whole records (the kept ones carry their true step numbers),
        # never a compile-marked one, and never an event
        self.step_every = max(int(step_every or 1), 1)
        self._steps_seen = 0
        self._log = log
        self._lock = threading.Lock()
        self._buf: list = []
        # the flight recorder's ring: the last ``recent`` records, flushed
        # or not (telemetry/flight.py dumps it at a failure)
        self._recent: collections.deque = collections.deque(
            maxlen=max(int(recent), 1))
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending = 0
        self.dropped_records = 0
        # batches the writer failed to write (their records are counted
        # in dropped_records too)
        self.write_failures = 0
        self._closed = False
        self.record_event("run_start", t=round(clock(), 3),
                          process_index=self.pi, process_count=self.pc,
                          schema=SCHEMA_VERSION)

    # -- recording (hot path) ---------------------------------------------

    def record_step(self, step: int, epoch: int, n: int, k: int,
                    wall_ms: float, dispatch_ms: float, examples: int,
                    data_ms: float = 0.0, block_ms: float = 0.0,
                    compile_: bool = False) -> None:
        self._steps_seen += 1
        if (self.step_every > 1 and not compile_
                and self._steps_seen % self.step_every):
            return
        rec = {"kind": "step", "step": int(step), "epoch": int(epoch),
               "n": int(n), "k": int(k), "wall_ms": round(wall_ms, 3),
               "dispatch_ms": round(dispatch_ms, 3),
               "data_ms": round(data_ms, 3), "block_ms": round(block_ms, 3),
               "examples": int(examples),
               "ex_s": round(examples / max(wall_ms / 1e3, 1e-9), 1)}
        if compile_:
            rec["compile"] = True
        self._append(rec)

    def next_step_kept(self) -> bool:
        """Whether the next ``record_step`` will be kept by the
        ``--telemetry_every`` cadence (compile-marked ones are kept
        regardless): the Trainer asks before a dispatch, so a sampled-out
        dispatch takes none of its telemetry-only clock reads."""
        return (self.step_every <= 1
                or (self._steps_seen + 1) % self.step_every == 0)

    def record_span(self, name: str, dur_ms: float,
                    step: Optional[int] = None) -> None:
        rec = {"kind": "span", "name": str(name),
               "dur_ms": round(dur_ms, 3)}
        if step is not None:
            rec["step"] = int(step)
        self._append(rec)

    def record_event(self, kind: str, **fields) -> None:
        self._append({"kind": str(kind), **fields})

    def goodput_event_sink(self, counter: str, total: int) -> None:
        """``GoodputTracker.set_event_sink``'s sink: restart, preemption
        and peer-failure counters land in the stream as they happen."""
        self.record_event("goodput_event", counter=str(counter),
                          total=int(total))

    def _append(self, rec: dict) -> None:
        with self._lock:
            if self._closed:
                return
            self._buf.append(rec)
            self._recent.append(rec)
            if len(self._buf) >= self.capacity:
                self._flush_locked()

    def recent_records(self) -> list:
        """The ring (newest last): the flight dump's payload."""
        with self._lock:
            return list(self._recent)

    # -- flushing (background) --------------------------------------------

    def _flush_locked(self, wait: bool = False):
        if not self._buf:
            return None
        batch, self._buf = self._buf, []
        if self._pending >= _MAX_PENDING_BATCHES and not wait:
            # the writer is wedged: drop, don't queue
            self.dropped_records += len(batch)
            return None
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="fdt-telem")
        self._pending += 1
        return self._pool.submit(self._write_batch, batch)

    def _write_batch(self, batch: list) -> None:
        try:
            with open(self.path, "a") as f:
                for rec in batch:
                    f.write(json.dumps(rec, default=str))
                    f.write("\n")
        except Exception as e:
            with self._lock:
                self.dropped_records += len(batch)
                self.write_failures += 1
            self._log(f"[telemetry] could not append {len(batch)} records "
                      f"to {self.path}: {e!r}")
        finally:
            with self._lock:
                self._pending -= 1

    def flush(self, wait: bool = False) -> None:
        """Hand the buffer to the writer; ``wait=True`` blocks until it
        is on disk (an epoch boundary flush-waits before it publishes its
        marker, so process 0 folds a whole epoch)."""
        with self._lock:
            fut = self._flush_locked(wait=wait)
        if wait and fut is not None:
            fut.result()

    def close(self) -> None:
        """Flush what is left (with a ``flush_stats`` record when anything
        was dropped), join the writer, and log the count of records lost."""
        with self._lock:
            if self._closed:
                return
            if self.dropped_records:
                self._buf.append({"kind": "flush_stats",
                                  "dropped_records": self.dropped_records})
            fut = self._flush_locked(wait=True)
            self._closed = True
        if fut is not None:
            fut.result()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self.dropped_records:
            self._log(f"[telemetry] {self.dropped_records} record(s) dropped "
                      f"or not written ({self.write_failures} failed "
                      f"write(s)); the count is the flush_stats record of "
                      f"{self.path}")
