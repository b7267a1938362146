"""The port's crash flight recorder (``faster_distributed_training_tpu_torch/
telemetry/flight.py``) against the JAX package's
(``telemetry/flight.py``).

  * ``build_payload``: the same keys, ring and open spans as JAX's for the
    same records, exception and step (the compile observatory's
    ``programs`` entry aside: it is JAX's only, with an observatory set);
  * a dump through the port's ``FakeObjectStoreBackend`` (no rename, no
    posix file) read back by ``read_flights``; one exception makes one
    dump; a dump that fails is logged and counted, never raised; posix
    dumps and torn files (JAX ``tests/test_programs.py::
    TestFlightRecorder``);
  * the three dump sites: the supervisor's failure branch, the watchdog's
    abort (a bounded join: a wedged dump cannot hold back the abort) and
    ``cli.run_training``'s unhandled exception, which re-raises; the
    last two against JAX's same run (``FDT_FAULT_DIE_AT_STEP`` on the tiny
    next-token LM, JAX ``tests/test_programs.py::TestFlightEndToEnd``),
    and JAX's report renders the port's dump.
"""

import glob
import importlib.util
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from faster_distributed_training_tpu import cli as jcli
from faster_distributed_training_tpu.config import TrainConfig as JConfig
from faster_distributed_training_tpu.resilience.goodput import (
    GoodputTracker as JGoodput)
from faster_distributed_training_tpu.telemetry import flight as jflight
from faster_distributed_training_tpu.telemetry import spans as jspans
from faster_distributed_training_tpu.telemetry.recorder import (
    TelemetryRecorder as JRecorder)
from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.resilience import (
    FakeObjectStoreBackend, GoodputTracker, InjectedFault, Supervisor,
    faults)
from faster_distributed_training_tpu_torch.resilience import coordinator
from faster_distributed_training_tpu_torch.resilience.storage import (
    MemoryMedium)
from faster_distributed_training_tpu_torch.telemetry import flight, spans
from faster_distributed_training_tpu_torch.telemetry.recorder import (
    TelemetryRecorder)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SILENT = lambda *_: None                                 # noqa: E731


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: under the suite's parallel workers torch's
    thread-a-core default oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def sinks(tmp_path):
    """A recorder installed as each package's span sink (process 3 of 4),
    the flight target of each in its own directory; both restored
    after."""
    out = {}
    prev = []
    for name, (R, sp, fl) in (("jax", (JRecorder, jspans, jflight)),
                              ("port", (TelemetryRecorder, spans, flight))):
        d = str(tmp_path / name)
        rec = R(d, process_index=3, process_count=4, log=_SILENT)
        prev.append((sp, sp.set_recorder(rec), fl,
                     fl.configure(d, log=_SILENT)))
        out[name] = rec
    yield out
    for sp, p_rec, fl, p_cfg in prev:
        sp.set_recorder(p_rec)
        fl.restore(p_cfg)
    for rec in out.values():
        rec.close()


def _records(rec):
    rec.record_step(6, 0, 6, 1, 10.0, 9.0, 8)
    rec.record_span("ckpt_snapshot", 3.5, step=6)
    rec.record_event("goodput_event", counter="restarts", total=1)


def _raised(msg):
    try:
        raise RuntimeError(msg)
    except RuntimeError as e:
        return e


def test_build_payload_equals_jax(sinks):
    """JAX ``build_payload``: the same keys, reason, step, exception type
    and message, ring (run_start's wall time aside), open spans and
    dropped count; goodput's summary keys."""
    got = {}
    for name, (sp, fl) in (("jax", (jspans, jflight)),
                           ("port", (spans, flight))):
        _records(sinks[name])
        exc = _raised("boom")
        gp = GoodputTracker() if name == "port" else JGoodput()
        gp.start()
        gp.count("restarts")
        with sp.span("restore", step=12):
            got[name] = fl.build_payload("supervisor_failure", exc=exc,
                                         step=6, goodput=gp,
                                         extra={"watchdog_reason": "x"})
    p, j = got["port"], got["jax"]
    assert set(p) == set(j) - {"programs"}
    for key in ("schema", "reason", "step", "process_index",
                "dropped_records", "watchdog_reason"):
        assert p[key] == j[key], key
    assert {k: p["exception"][k] for k in ("type", "message")} == {
        k: j["exception"][k] for k in ("type", "message")}
    assert "boom" in p["exception"]["traceback"]
    strip = lambda ring: [{k: v for k, v in r.items() if k != "t"}  # noqa
                          for r in ring]
    assert strip(p["recent_records"]) == strip(j["recent_records"])
    assert [(s["name"], s["step"]) for s in p["active_spans"]] == [
        (s["name"], s["step"]) for s in j["active_spans"]] == [
        ("restore", 12)]
    assert set(p["goodput"]) == set(j["goodput"])


def test_dump_through_the_fake_object_store(sinks, tmp_path):
    """A dump through ``FakeObjectStoreBackend`` lands as an object (no
    posix file), is read back by ``read_flights(dir, backend)``, and
    the stream records a ``flight`` event; one exception, one dump (JAX
    ``test_dump_payload_and_dedupe``)."""
    backend = FakeObjectStoreBackend(MemoryMedium())
    d = str(tmp_path / "obj")
    prev = flight.configure(d, backend=backend, log=_SILENT)
    try:
        rec = sinks["port"]
        _records(rec)
        exc = _raised("boom")
        path = flight.emergency_dump("test_reason", exc=exc, step=6)
        assert path is not None
        assert os.path.basename(path).startswith("flight_00003_")
        assert not os.path.exists(path) and backend.exists(path)
        assert flight.emergency_dump("again", exc=exc) is None
        time.sleep(0.01)            # a name a millisecond
        path2 = flight.emergency_dump("other", exc=_raised("boom2"))
        got = flight.read_flights(d, backend=backend)
        assert [p for p, _ in got] == sorted([path, path2])
        payload = dict(got)[path]
        assert payload["reason"] == "test_reason" and payload["step"] == 6
        assert payload["exception"]["type"] == "RuntimeError"
        assert [r["kind"] for r in payload["recent_records"]] == [
            "run_start", "step", "span", "goodput_event"]
        assert [e["path"] for e in rec.recent_records()
                if e["kind"] == "flight"] == [path, path2]
    finally:
        flight.restore(prev)


def test_a_failed_dump_is_logged_and_counted(tmp_path, monkeypatch):
    """A backend that refuses the write: ``emergency_dump`` returns None,
    counts the failure and logs it (JAX logs it), never raises."""
    backend = FakeObjectStoreBackend(MemoryMedium())
    backend.fail_puts("flight_", count=1)
    lines = []
    monkeypatch.setattr(flight, "failures", 0)
    prev = flight.configure(str(tmp_path), backend=backend,
                            log=lines.append)
    try:
        assert flight.emergency_dump("r", exc=_raised("x")) is None
        assert flight.failures == 1
        assert any("could not write the flight dump" in x for x in lines)
        assert flight.emergency_dump("r", exc=_raised("y")) is not None
    finally:
        flight.restore(prev)


def test_posix_dumps_unconfigured_and_torn_files(tmp_path):
    """JAX ``test_unconfigured_is_noop`` / ``test_read_flights_skips_torn_
    files``: unconfigured is a no-op; posix dumps are read, torn files
    skipped."""
    prev = flight.configure(None)
    try:
        assert not flight.configured()
        assert flight.emergency_dump("x", exc=RuntimeError("y")) is None
    finally:
        flight.restore(prev)
    (tmp_path / "flight_00000_1.json").write_text(json.dumps({"reason": "r"}))
    (tmp_path / "flight_00000_2.json").write_text("{torn")
    for mod in (flight, jflight):
        assert [os.path.basename(p) for p, _ in mod.read_flights(
            str(tmp_path))] == ["flight_00000_1.json"]


def test_supervisor_failure_dumps_once(sinks):
    """JAX ``resilience/supervisor.py:115-126``: an attempt that fails
    leaves one ``supervisor_failure`` dump naming it; the retry
    succeeds."""
    calls = []

    def attempt(i):
        calls.append(i)
        if i == 0:
            raise InjectedFault("injected crash at global step 6")
        return "done"

    sup = Supervisor(max_restarts=2, sleep=lambda s: None, log=_SILENT)
    assert sup.run(attempt, progress=lambda: 6) == "done"
    got = flight.read_flights(sinks["port"].directory)
    assert len(got) == 1 and calls == [0, 1]
    payload = got[0][1]
    assert payload["reason"] == "supervisor_failure"
    assert payload["step"] == 6
    assert payload["exception"]["type"] == "InjectedFault"


def test_watchdog_abort_dumps_within_its_bound(sinks, tmp_path,
                                               monkeypatch):
    """JAX ``resilience/coordinator.py:1325-1340``: the watchdog's abort
    writes a ``watchdog_abort`` dump (with the reason) before the abort;
    a dump that hangs is abandoned after the bounded join and the abort
    still comes."""
    aborted = []
    co = coordinator.PodCoordinator(
        str(tmp_path / "pod"), process_index=0, process_count=1,
        step_timeout_s=1.0, log=_SILENT, abort_fn=aborted.append)
    co._step = 9
    co._escalate_hang()
    got = flight.read_flights(sinks["port"].directory)
    assert len(got) == 1 and len(aborted) == 1
    assert got[0][1]["reason"] == "watchdog_abort"
    assert got[0][1]["step"] == 9
    assert "no step progress" in got[0][1]["watchdog_reason"]
    wedged = threading.Event()
    monkeypatch.setattr(coordinator, "FLIGHT_JOIN_S", 0.2)
    monkeypatch.setattr(flight, "emergency_dump",
                        lambda *a, **k: wedged.wait(30))
    lines = []
    co2 = coordinator.PodCoordinator(
        str(tmp_path / "pod2"), process_index=0, process_count=1,
        step_timeout_s=1.0, log=lines.append, abort_fn=aborted.append)
    t0 = time.monotonic()
    co2._escalate_hang()
    assert time.monotonic() - t0 < 5.0 and len(aborted) == 2
    assert any("did not finish" in x for x in lines)
    wedged.set()


E2E = dict(model="transformer", dataset="synthetic", num_classes=4,
           batch_size=8, seq_len=32, n_layers=2, d_model=64, d_ff=128,
           n_heads=4, epochs=1, subset_stride=128, precision="fp32",
           plot=False, log_every=0, task="lm", dropout_impl="none",
           prefetch_depth=0)


def test_unhandled_exception_dump_matches_jax(tmp_path, monkeypatch):
    """JAX ``cli.py:1262-1272``: ``FDT_FAULT_DIE_AT_STEP=3`` without
    ``--supervise`` escapes ``run_training`` (re-raised) after one
    ``unhandled_exception`` dump; the port's and JAX's dumps name the
    same reason, step and exception, their rings hold the same step
    records, and JAX's report renders the port's."""
    monkeypatch.setenv(faults.ENV_DIE, "3")
    got = {}
    for name, (run, C, exc_t) in (
            ("jax", (jcli.run_training, JConfig, Exception)),
            ("port", (cli.run_training, TrainConfig, InjectedFault))):
        kw = dict(checkpoint_dir=str(tmp_path / name), **E2E)
        if name == "jax":
            kw.update(donate=False, mesh_shape=(1,))
        else:
            kw.update(device="cpu")
        with pytest.raises(exc_t, match="injected crash"):
            run(C(**kw), log=_SILENT)
        files = glob.glob(str(tmp_path / name / "telemetry" / "flight_*"))
        assert len(files) == 1, files
        got[name] = json.load(open(files[0]))
    p, j = got["port"], got["jax"]
    for key in ("reason", "step", "process_index"):
        assert p[key] == j[key], key
    assert p["reason"] == "unhandled_exception" and p["step"] == 3
    assert (p["exception"]["type"], p["exception"]["message"]) == (
        j["exception"]["type"], j["exception"]["message"])
    steps = lambda pl: [(r["step"], bool(r.get("compile")))  # noqa: E731
                        for r in pl["recent_records"] if r["kind"] == "step"]
    assert steps(p) == steps(j) == [(1, True), (2, False)]
    spec = importlib.util.spec_from_file_location(
        "telemetry_report", os.path.join(ROOT, "scripts",
                                         "telemetry_report.py"))
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    rep = report.run(str(tmp_path / "port" / "telemetry"), with_flight=True)
    text = report.render(rep)
    assert "FLIGHT" in text and "InjectedFault" in text
    assert np.isfinite(rep["summary"]["pod"]["step_ms_p50"])
