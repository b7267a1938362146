"""The pod fold and stragglers over per-host telemetry (the JAX
package's ``telemetry/aggregate.py``, line for line).

Each host writes its own ``host_<pi>.jsonl`` (recorder.py); process 0
folds them into run-level step-time percentiles at each epoch's end and
flags stragglers.  The transport is marker files, which every host of a
pod (processes of a torch.distributed group on a shared checkpoint
filesystem, or an ``FDT_POD_INDEX``-simulated pod) reaches without a
collective: after flushing epoch ``e`` a host atomically writes
``epoch_<e>_host_<pi>.done``; process 0 waits for the markers at most
``--aggregate_grace_s`` seconds (the fold is observability: it goes on
with the hosts that reported rather than stall training on a slow peer,
and records the missing ones in ``pod_summary.json``) and logs:

    [telemetry] epoch 3: pod step p50=101.2ms p95=110.4ms p99=121.0ms
        over 1536 steps, 2/2 hosts
    [telemetry] straggler: host 1 p95=312.4ms > 2.0x pod median p95
        104.1ms

Straggler rule: a host whose step-time p95 exceeds ``straggler_ratio``
times the pod's low median of host p95s (``statistics.median_low``, so a
2-host pod can flag its slow half).

Step time (:func:`step_time_ms`, the one definition every fold uses):
``dispatch_ms / k`` of the step records not marked ``compile``; data
wait and checkpoint blocking are separate fields and left out.

Markers are time-scoped: process 0 honours one only when it is newer
than this run's telemetry (``newer_than``), so a reused directory's
residue cannot satisfy the barrier.  The JSONL files append across
relaunches of the same run; a fresh run wants a fresh directory.

:class:`RunFold` is process 0's incremental fold (byte offsets a host,
only complete lines, a file that shrank re-read from 0);
:func:`aggregate_run` is the stateless whole-directory fold (the report
script, the run's end, the tests).
"""

from __future__ import annotations

import glob
import json
import os
import re
import statistics
import time
from typing import Callable, Dict, List, Optional

from faster_distributed_training_tpu_torch.train.metrics import percentiles

_HOST_FILE = re.compile(r"^host_(?P<pi>\d{5})\.jsonl$")
SUMMARY = "pod_summary.json"


def _epoch_marker(directory: str, epoch: int, pi: int) -> str:
    return os.path.join(directory, f"epoch_{epoch:04d}_host_{pi:05d}.done")


def publish_epoch_marker(directory: str, epoch: int, pi: int) -> None:
    """Durably announce that host ``pi`` has flushed its records through
    epoch ``epoch`` (written AFTER a flush(wait=True)).  Carries a wall
    timestamp so the aggregator can ignore a previous attempt's residue
    in a reused directory (time-scoping, the r10 EXIT-marker idiom)."""
    from faster_distributed_training_tpu_torch.telemetry.recorder import (
        _write_json_atomic)
    _write_json_atomic(_epoch_marker(directory, epoch, pi),
                       {"epoch": int(epoch),
                        "unix_time": round(time.time(), 3)})


def step_time_ms(rec: dict, upto_epoch: Optional[int] = None
                 ) -> Optional[float]:
    """Per-train-step time of one JSONL record, or None when the record
    doesn't contribute (non-step kinds, compile records, epochs past
    ``upto_epoch``).  THE step-time definition — every consumer
    (per-host stats, pooled percentiles, incremental fold, report
    script) goes through here so they can never disagree."""
    if rec.get("kind") != "step" or rec.get("compile"):
        return None
    if upto_epoch is not None and rec.get("epoch", 0) > upto_epoch:
        return None
    return rec["dispatch_ms"] / max(rec.get("k", 1), 1)


def read_host_records(directory: str) -> Dict[int, List[dict]]:
    """{process_index: [records]} from every ``host_*.jsonl`` present.
    Torn trailing lines (a host mid-append) are skipped, not fatal —
    the stream is advisory, the next aggregation sees them whole."""
    out: Dict[int, List[dict]] = {}
    for path in sorted(glob.glob(os.path.join(directory, "host_*.jsonl"))):
        m = _HOST_FILE.match(os.path.basename(path))
        if not m:
            continue
        recs = []
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        recs.append(json.loads(line))
                    except ValueError:
                        continue
        except OSError:
            continue
        out[int(m.group("pi"))] = recs
    return out


# -- per-host reductions (shared by the stateless and incremental paths) --

def _new_fold() -> dict:
    return {"steps": 0, "records": 0, "per_step_ms": [],
            "ex_s_sum": 0.0, "ex_s_n": 0,
            "data_ms_total": 0.0, "block_ms_total": 0.0}


def _accumulate(fold: dict, rec: dict,
                upto_epoch: Optional[int] = None) -> None:
    t = step_time_ms(rec, upto_epoch=upto_epoch)
    if t is None:
        return
    fold["per_step_ms"].append(t)
    fold["steps"] += int(rec.get("k", 1))
    fold["records"] += 1
    if rec.get("ex_s"):
        fold["ex_s_sum"] += float(rec["ex_s"])
        fold["ex_s_n"] += 1
    fold["data_ms_total"] += float(rec.get("data_ms", 0.0))
    fold["block_ms_total"] += float(rec.get("block_ms", 0.0))


def _host_stats(fold: dict) -> dict:
    stats = {"steps": fold["steps"], "records": fold["records"]}
    stats.update({f"step_ms_p{q}": v
                  for q, v in percentiles(fold["per_step_ms"]).items()})
    if fold["ex_s_n"]:
        stats["ex_s_mean"] = round(fold["ex_s_sum"] / fold["ex_s_n"], 1)
    stats["data_ms_total"] = round(fold["data_ms_total"], 1)
    stats["block_ms_total"] = round(fold["block_ms_total"], 1)
    return stats


def span_breakdown(records: List[dict]) -> Dict[str, dict]:
    """{span name: {count, total_ms, mean_ms}} over one host's stream."""
    out: Dict[str, dict] = {}
    for r in records:
        if r.get("kind") != "span":
            continue
        s = out.setdefault(r.get("name", "?"),
                           {"count": 0, "total_ms": 0.0})
        s["count"] += 1
        s["total_ms"] += float(r.get("dur_ms", 0.0))
    for s in out.values():
        s["total_ms"] = round(s["total_ms"], 3)
        s["mean_ms"] = round(s["total_ms"] / s["count"], 3)
    return out


def aggregate_folds(folds: Dict[int, dict],
                    straggler_ratio: float = 2.0) -> dict:
    """One summary from per-host folds: per-host and pooled p50/p95/p99
    per-step dispatch times + the straggler table (module docstring)."""
    folds = {pi: f for pi, f in folds.items() if f["records"]}
    per_host = {pi: _host_stats(f) for pi, f in sorted(folds.items())}
    out: dict = {"hosts": {str(pi): st for pi, st in per_host.items()},
                 "host_count": len(per_host),
                 "straggler_ratio": float(straggler_ratio),
                 "stragglers": []}
    pooled: List[float] = []
    for f in folds.values():
        pooled.extend(f["per_step_ms"])
    if pooled:
        out["pod"] = {"steps": sum(st["steps"]
                                   for st in per_host.values()),
                      **{f"step_ms_p{q}": v
                         for q, v in percentiles(pooled).items()}}
    if len(per_host) > 1:
        p95s = [st["step_ms_p95"] for st in per_host.values()]
        median_p95 = statistics.median_low(p95s)
        out["pod_median_host_p95_ms"] = median_p95
        for pi, st in per_host.items():
            if median_p95 > 0 and st["step_ms_p95"] > (straggler_ratio
                                                       * median_p95):
                out["stragglers"].append(
                    {"host": pi, "step_ms_p95": st["step_ms_p95"],
                     "pod_median_p95_ms": median_p95,
                     "ratio": round(st["step_ms_p95"] / median_p95, 2)})
    return out


def aggregate_run(directory: str, straggler_ratio: float = 2.0,
                  upto_epoch: Optional[int] = None) -> dict:
    """Stateless whole-directory fold (the report script, run end,
    tests); the per-epoch in-run path uses :class:`RunFold` instead."""
    folds: Dict[int, dict] = {}
    for pi, recs in read_host_records(directory).items():
        fold = _new_fold()
        for r in recs:
            _accumulate(fold, r, upto_epoch=upto_epoch)
        folds[pi] = fold
    return aggregate_folds(folds, straggler_ratio=straggler_ratio)


class RunFold:
    """Process 0's incremental run-level fold: remembers a byte offset
    into each host's JSONL and the accumulated reductions, so each
    epoch-end fold parses only the tail appended since the previous one
    (re-parsing every file from 0 each epoch is quadratic over the
    run).  Only COMPLETE lines are consumed — a host caught mid-append
    contributes that line next time.  A file that SHRANK (a relaunch
    replaced it) resets that host's state and re-reads from 0."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        self._offsets: Dict[int, int] = {}
        self._folds: Dict[int, dict] = {}

    def _consume(self) -> None:
        for path in sorted(glob.glob(os.path.join(self.directory,
                                                  "host_*.jsonl"))):
            m = _HOST_FILE.match(os.path.basename(path))
            if not m:
                continue
            pi = int(m.group("pi"))
            off = self._offsets.get(pi, 0)
            try:
                if os.path.getsize(path) < off:
                    off = 0
                    self._folds[pi] = _new_fold()
                with open(path, "rb") as f:
                    f.seek(off)
                    chunk = f.read()
            except OSError:
                continue
            cut = chunk.rfind(b"\n") + 1
            if not cut:
                continue
            fold = self._folds.setdefault(pi, _new_fold())
            for line in chunk[:cut].splitlines():
                if not line.strip():
                    continue
                try:
                    _accumulate(fold, json.loads(line))
                except ValueError:
                    continue
            self._offsets[pi] = off + cut

    def summary(self, straggler_ratio: float = 2.0) -> dict:
        self._consume()
        return aggregate_folds(self._folds,
                               straggler_ratio=straggler_ratio)


def pod_epoch_aggregate(directory: str, epoch: int, pi: int, pc: int,
                        straggler_ratio: float = 2.0,
                        log: Callable[[str], None] = print,
                        wait_s: float = 2.0,
                        fold: Optional[RunFold] = None,
                        newer_than: Optional[float] = None
                        ) -> Optional[dict]:
    """Process 0's epoch-end fold: wait (bounded) for every host's epoch
    marker, aggregate whatever reported, log the ``[telemetry]`` pod
    line + any straggler flags, and refresh ``pod_summary.json``.
    ``fold`` (a :class:`RunFold`) makes the parse incremental;
    ``newer_than`` (unix time) time-scopes the markers so a reused
    directory's residue can't satisfy the barrier.  Non-zero hosts
    return immediately (their work was the flush + marker the caller
    already did)."""
    if pi != 0:
        return None

    def _marker_fresh(p: int) -> bool:
        got = None
        try:
            with open(_epoch_marker(directory, epoch, p)) as f:
                got = json.load(f)
        except (OSError, ValueError):
            return False
        return (newer_than is None
                or got.get("unix_time", 0.0) > newer_than)

    deadline = time.monotonic() + max(wait_s, 0.0)
    want = set(range(pc))
    while True:
        have = {p for p in want if _marker_fresh(p)}
        if have >= want or time.monotonic() >= deadline:
            break
        time.sleep(0.05)
    if fold is not None:
        summary = fold.summary(straggler_ratio=straggler_ratio)
    else:
        summary = aggregate_run(directory, straggler_ratio=straggler_ratio,
                                upto_epoch=epoch)
    summary["epoch"] = int(epoch)
    summary["hosts_reported"] = sorted(have)
    # skipped hosts land in pod_summary.json, not just the log line — a
    # postmortem reading only the committed summary must see that the
    # fold was partial (and what grace it waited); --aggregate_grace_s
    # sizes the wait for slow CI hosts
    summary["hosts_missing"] = sorted(want - have)
    summary["grace_s"] = round(max(wait_s, 0.0), 3)
    pod = summary.get("pod")
    if pod:
        log(f"[telemetry] epoch {epoch}: pod step "
            f"p50={pod['step_ms_p50']:.1f}ms "
            f"p95={pod['step_ms_p95']:.1f}ms "
            f"p99={pod['step_ms_p99']:.1f}ms over {pod['steps']} steps, "
            f"{len(have)}/{pc} hosts")
    if len(have) < pc:
        log(f"[telemetry] epoch {epoch}: host(s) "
            f"{sorted(want - have)} had not flushed within "
            f"{wait_s:.1f}s — aggregated without them")
    for s in summary["stragglers"]:
        log(f"[telemetry] straggler: host {s['host']} "
            f"p95={s['step_ms_p95']:.1f}ms > {straggler_ratio:.1f}x pod "
            f"median p95 {s['pod_median_p95_ms']:.1f}ms "
            f"({s['ratio']:.2f}x)")
    try:
        from faster_distributed_training_tpu_torch.telemetry.recorder import (
            _write_json_atomic)
        _write_json_atomic(os.path.join(directory, SUMMARY), summary)
    except OSError as e:
        log(f"[telemetry] could not write {SUMMARY}: {e!r}")
    return summary
