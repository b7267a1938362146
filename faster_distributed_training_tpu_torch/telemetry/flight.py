"""The crash flight recorder: a process that fails leaves its forensics
behind (the JAX package's ``telemetry/flight.py``).

The JSONL stream holds what the writer flushed before the process died;
the most telling records are often the unflushed tail.  At a failure
this module writes, durably, what the process knows about itself:

  * the recorder's ring of recent records, flushed or not;
  * the spans open right now, on any thread (a process that dies inside
    ``restore`` or ``ckpt_commit`` names the phase, with its elapsed ms);
  * the goodput snapshot, the program table (the active observatory's
    ``summary()``, under ``programs``), the exception with its traceback,
    and the count of dropped records.

The dump goes through the resilience bundle's storage backend when it has
one (``<telemetry_dir>/flight_<pi>_<ms>.json``: on a pod the shared
medium is where the survivors read it), else to a posix file.  The
callers are the failure seams: the supervisor's failure branch
(``resilience/supervisor.py``), the watchdog's abort
(``resilience/coordinator.py``, from a side thread with a bounded join so
a wedged filesystem cannot hold back the kill), and ``cli.run_training``'s
unhandled exception, which re-raises.  One exception makes one dump,
however many seams it passes.

A dump that fails is logged and counted (:data:`failures`), never raised:
the flight recorder must not take the run down with it.

Read the dumps with ``read_flights`` or ``python
scripts/telemetry_report.py <dir> --flight``.
"""

from __future__ import annotations

import json
import os
import time
import traceback
from typing import Callable, List, Optional, Tuple

from faster_distributed_training_tpu_torch.telemetry import programs

FLIGHT_PREFIX = "flight_"

# the process's dump target (cli.run_training installs it beside the span
# recorder and gives the previous one back at its end); None: every dump
# is a no-op
_CONFIG: Optional[dict] = None
# the mark a dumped exception carries (one dump an incident)
_DUMPED_ATTR = "_fdt_flight_dumped"
# dumps that failed to write, this process
failures = 0


def configure(directory: Optional[str], backend=None, goodput=None,
              log: Callable[[str], None] = print) -> Optional[dict]:
    """Install the dump target (None disables).  Returns the previous
    configuration, for ``restore``."""
    global _CONFIG
    prev = _CONFIG
    _CONFIG = (None if directory is None
               else {"directory": directory, "backend": backend,
                     "goodput": goodput, "log": log})
    return prev


def restore(prev: Optional[dict]) -> None:
    global _CONFIG
    _CONFIG = prev


def configured() -> bool:
    return _CONFIG is not None


def emergency_dump(reason: str, exc: Optional[BaseException] = None,
                   step: Optional[int] = None,
                   extra: Optional[dict] = None) -> Optional[str]:
    """Write the flight dump; returns its path, or None (not configured,
    an exception already dumped, or a write that failed: logged and
    counted in ``failures``)."""
    global failures
    cfg = _CONFIG
    if cfg is None:
        return None
    if exc is not None:
        if getattr(exc, _DUMPED_ATTR, False):
            return None
        try:
            setattr(exc, _DUMPED_ATTR, True)
        except (AttributeError, TypeError):
            pass    # an exception without a __dict__: dumped every time
    log = cfg.get("log") or (lambda *_: None)
    try:
        payload = build_payload(reason, exc=exc, step=step,
                                goodput=cfg.get("goodput"), extra=extra)
        path = os.path.join(
            cfg["directory"],
            f"{FLIGHT_PREFIX}{payload['process_index']:05d}_"
            f"{int(payload['unix_time'] * 1e3)}.json")
        backend = cfg.get("backend")
        if backend is not None:
            backend.put_json(path, payload)
        else:
            from faster_distributed_training_tpu_torch.telemetry.recorder \
                import _write_json_atomic
            os.makedirs(cfg["directory"], exist_ok=True)
            _write_json_atomic(path, payload)
    except Exception as e:
        failures += 1
        log(f"[flight] could not write the flight dump ({e!r}; {failures} "
            f"failed this process): the JSONL stream, as far as it was "
            f"flushed, is the remaining record")
        return None
    log(f"[flight] {reason}: flight dump written to {path}")
    from faster_distributed_training_tpu_torch.telemetry import spans
    rec = spans.get_recorder()
    if rec is not None:
        rec.record_event("flight", path=path, reason=str(reason))
        rec.flush(wait=False)
    return path


def build_payload(reason: str, exc: Optional[BaseException] = None,
                  step: Optional[int] = None, goodput=None,
                  extra: Optional[dict] = None) -> dict:
    """The dump itself, from the process's telemetry state (the span
    recorder and the open spans); no side effect."""
    from faster_distributed_training_tpu_torch.telemetry import spans

    rec = spans.get_recorder()
    payload: dict = {"schema": 1, "reason": str(reason),
                     "unix_time": round(time.time(), 3)}
    if rec is not None:
        payload["process_index"] = rec.pi
    else:
        from faster_distributed_training_tpu_torch.resilience.coordinator \
            import pod_identity
        payload["process_index"] = pod_identity()[0]
    if step is not None:
        payload["step"] = int(step)
    if exc is not None:
        payload["exception"] = {
            "type": type(exc).__name__,
            "message": str(exc)[:2000],
            "traceback": "".join(traceback.format_exception(
                type(exc), exc, exc.__traceback__))[-8000:]}
    payload["active_spans"] = spans.active_spans()
    if rec is not None:
        payload["recent_records"] = rec.recent_records()
        payload["dropped_records"] = rec.dropped_records
    if goodput is not None:
        payload["goodput"] = goodput.summary()
    obs = programs.get_observatory()
    if obs is not None:
        payload["programs"] = obs.summary()
    if extra:
        payload.update(extra)
    return payload


def read_flights(directory: str, backend=None) -> List[Tuple[str, dict]]:
    """[(path, payload)] of every readable flight dump in ``directory``:
    posix files, or the keys under it of ``backend`` (the storage backend
    that wrote them)."""
    import glob

    out = []
    if backend is not None:
        for key in sorted(backend.list_prefix(directory)):
            name = os.path.basename(key)
            if not (name.startswith(FLIGHT_PREFIX)
                    and name.endswith(".json")):
                continue
            got = backend.read_json(key)
            if got is not None:
                out.append((key, got))
        return out
    for path in sorted(glob.glob(os.path.join(directory,
                                              FLIGHT_PREFIX + "*.json"))):
        try:
            with open(path) as f:
                out.append((path, json.load(f)))
        except (OSError, ValueError):
            continue
    return out
