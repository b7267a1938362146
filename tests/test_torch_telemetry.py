"""The port's run record (``faster_distributed_training_tpu_torch/
telemetry/``) against the JAX package's (``telemetry/``) and its
consumers (``scripts/telemetry_report.py``,
``scripts/check_telemetry_schema.py``).

  * the recorder: one sequence of ``record_step`` / ``record_span`` /
    ``record_event`` / ``flush`` calls writes byte-identical JSONL in both
    packages, the wall clock injected into both (JAX
    ``TelemetryRecorder``); a full ring flushes in the background; a
    writer that raises is logged and counted in ``flush_stats``; the kill
    switch and ``--no_telemetry`` (JAX ``build_telemetry``);
    ``TELEMETRY_SCHEMA`` equals JAX's;
  * spans: host time reaches the recorder with the ``step`` attribute;
    ``active_spans`` shows a span while it is open, on any thread (JAX
    ``telemetry/spans.py``);
  * the folds (``aggregate_run``, ``span_breakdown``, ``RunFold``,
    ``pod_epoch_aggregate`` with stale markers) on
    ``tests/fixtures/telemetry/`` equal JAX's; JAX's report script reads
    the port's run directory as it reads JAX's;
  * the schema lint: JAX's ``scan_emissions`` over the port's package
    finds every emitted kind and field registered; registered and never
    emitted is exactly ``spare`` (warm spares, ROADMAP item 10);
  * end to end, a 2-layer next-token LM on the CPU against JAX's run of
    the same config and data: the same kinds and counts of records, step
    numbers and compile marks, the epoch loss within 1e-5,
    ``--telemetry_every 3`` keeping the same steps, ``--no_telemetry``
    writing nothing, and no added host read of a tensor;
  * the pipeline's ``pp_bubble`` / ``pp_stage`` at pp=2 and the pod fold
    at dp=2, on two gloo ranks (``tests/torch_dist_worker.py``, the grace
    bounded) against JAX's spec and JAX's fold of the same records;
  * serving: ``serve_batch`` / ``serve_request`` from both packages'
    ``BatchScheduler`` on the same requests; ``decode_admit`` /
    ``decode_step`` / ``slot_evict`` from both packages'
    ``DecodeScheduler`` under one admission plan.
"""

import collections
import importlib.util
import json
import os
import shutil
import sys
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from faster_distributed_training_tpu import cli as jcli
from faster_distributed_training_tpu import telemetry as jtel
from faster_distributed_training_tpu.config import TrainConfig as JConfig
from faster_distributed_training_tpu.telemetry import recorder as jrec
from faster_distributed_training_tpu.telemetry import spans as jspans
from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch import telemetry as tel
from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.telemetry import recorder as prec
from faster_distributed_training_tpu_torch.telemetry import spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "telemetry")
T0 = 1700000123.456789
_SILENT = lambda *_: None                                 # noqa: E731


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: under the suite's parallel workers torch's
    thread-a-core default oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _jax_recorder(d, monkeypatch, **kw):
    """JAX ``TelemetryRecorder`` with its wall clock at ``T0``."""
    monkeypatch.setattr(jrec, "time", types.SimpleNamespace(
        time=lambda: T0, monotonic=time.monotonic))
    return jrec.TelemetryRecorder(d, process_index=0, process_count=1,
                                  log=_SILENT, **kw)


def _port_recorder(d, **kw):
    return prec.TelemetryRecorder(d, process_index=0, process_count=1,
                                  log=_SILENT, clock=lambda: T0, **kw)


def _calls(rec):
    """One sequence of every recording call, a flush mid-way."""
    rec.record_step(1, 0, 1, 1, 2500.4567, 2499.12345, 64, data_ms=0.5004,
                    block_ms=0.0, compile_=True)
    rec.record_span("first_dispatch_compile", 2499.12345, step=1)
    for i in range(2, 9):
        rec.record_step(i, 0, i, 4, 100.0 + i / 7, 99.0 + i / 3, 256,
                        data_ms=0.25 * i, block_ms=0.125 * (i % 2))
    rec.flush(wait=True)
    rec.record_span("eval", 12.3456789, step=8)
    rec.record_span("restore", 1.0)
    rec.record_event("epoch", epoch=0, steps=8, trained_steps=8,
                     loss=1.2345678901234567, accuracy=0.25, wall_s=3.25)
    rec.goodput_event_sink("restarts", 1)
    rec.record_event("memory", scope="epoch", epoch=0, peak_bytes=123,
                     bytes_in_use=45)
    rec.close()


@pytest.mark.parametrize("step_every", [1, 3])
@pytest.mark.parametrize("capacity", [256, 3])
def test_recorder_writes_jax_bytes(tmp_path, monkeypatch, step_every,
                                   capacity):
    """JAX ``TelemetryRecorder``: the same calls (at ``--telemetry_every``
    1 and 3, a ring of 256 and of 3) give byte-identical JSONL."""
    files = {}
    for name in ("jax", "port"):
        d = str(tmp_path / name)
        kw = dict(step_every=step_every, capacity=capacity)
        rec = (_jax_recorder(d, monkeypatch, **kw) if name == "jax"
               else _port_recorder(d, **kw))
        _calls(rec)
        with open(rec.path, "rb") as f:
            files[name] = f.read()
    assert files["port"] == files["jax"]
    assert files["port"].count(b'"kind": "step"') == (
        8 if step_every == 1 else 3)


def test_schema_registry_equals_jax():
    """The registry, the retired kinds and the constants are JAX's."""
    assert prec.TELEMETRY_SCHEMA == jrec.TELEMETRY_SCHEMA
    assert prec.RETIRED_KINDS == jrec.RETIRED_KINDS
    assert (prec.SCHEMA_VERSION, prec.ENV_KILL, prec.MANIFEST) == (
        jrec.SCHEMA_VERSION, jrec.ENV_KILL, jrec.MANIFEST)
    from faster_distributed_training_tpu.telemetry import programs as jprog
    from faster_distributed_training_tpu_torch.telemetry import programs
    assert programs.STATE_MEMORY_FIELDS == jprog.STATE_MEMORY_FIELDS


def test_full_ring_flushes_in_background(tmp_path):
    """JAX ``test_capacity_triggers_background_flush``: two full rings
    reach the disk with no explicit flush."""
    rec = _port_recorder(str(tmp_path), capacity=8)
    for i in range(20):
        rec.record_step(i + 1, 0, i + 1, 1, 1.0, 1.0, 4)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if os.path.exists(rec.path) and len(_read(rec.path)) >= 16:
            break
        time.sleep(0.02)
    assert len(_read(rec.path)) >= 16
    rec.close()
    assert [r["step"] for r in _read(rec.path) if r["kind"] == "step"] == \
        list(range(1, 21))
    assert rec.dropped_records == 0


def test_a_writer_that_raises_is_counted_in_flush_stats(tmp_path,
                                                        monkeypatch):
    """JAX's writer counts an ``OSError`` only; the port's counts any
    exception of the writer thread, logs it and closes with the
    ``flush_stats`` record JAX's schema has."""
    lines = []
    rec = prec.TelemetryRecorder(str(tmp_path), process_index=0,
                                 process_count=1, log=lines.append)
    real = prec.json.dumps
    fails = [1]

    def dumps(obj, **kw):
        if fails[0]:
            fails[0] = 0
            raise RuntimeError("encoder failure")
        return real(obj, **kw)
    monkeypatch.setattr(prec.json, "dumps", dumps)
    rec.record_step(1, 0, 1, 1, 1.0, 1.0, 4)
    rec.record_step(2, 0, 2, 1, 1.0, 1.0, 4)
    rec.flush(wait=True)            # run_start + 2 steps: one failed batch
    rec.record_step(3, 0, 3, 1, 1.0, 1.0, 4)
    rec.close()
    recs = _read(rec.path)
    assert rec.dropped_records == 3 and rec.write_failures == 1
    assert [r["kind"] for r in recs] == ["step", "flush_stats"]
    assert recs[-1] == {"kind": "flush_stats", "dropped_records": 3}
    assert any("encoder failure" in x for x in lines)
    assert any("3 record(s) dropped" in x for x in lines)
    assert set(recs[-1]) - {"kind"} <= prec.TELEMETRY_SCHEMA["flush_stats"]


def test_kill_switch_and_flag_match_jax(tmp_path, monkeypatch):
    """JAX ``build_telemetry``: ``FDT_TELEMETRY=0`` and ``--no_telemetry``
    give None; otherwise the directory ``<checkpoint_dir>/telemetry``,
    ``--telemetry_every`` and ``--aggregate_grace_s`` wired alike."""
    kw = dict(checkpoint_dir=str(tmp_path), telemetry_every=4,
              aggregate_grace_s=0.5, straggler_ratio=3.0)
    pcfg, jcfg = TrainConfig(**kw), JConfig(**kw)
    monkeypatch.setenv("FDT_TELEMETRY", "0")
    assert tel.build_telemetry(pcfg) is None
    assert jtel.build_telemetry(jcfg) is None
    monkeypatch.delenv("FDT_TELEMETRY")
    assert tel.build_telemetry(pcfg.replace(telemetry=False)) is None
    assert jtel.build_telemetry(jcfg.replace(telemetry=False)) is None
    got = tel.build_telemetry(pcfg, log=_SILENT)
    want = jtel.build_telemetry(jcfg, log=_SILENT)
    try:
        for attr in ("directory", "pi", "pc", "straggler_ratio",
                     "aggregate_wait_s"):
            assert getattr(got, attr) == getattr(want, attr), attr
        assert got.recorder.step_every == want.recorder.step_every == 4
        assert tel.resolve_telemetry_dir(pcfg.replace(
            telemetry_dir="/x")) == "/x"
    finally:
        got.close()
        want.close()


# -- spans -----------------------------------------------------------------


def test_span_host_time_reaches_the_recorder(tmp_path):
    """JAX ``test_span_records_to_active_recorder``: a span's host time
    and ``step`` go to the installed recorder, a span that raises still
    records; nothing without a recorder."""
    rec = _port_recorder(str(tmp_path))
    prev = spans.set_recorder(rec)
    try:
        assert spans.get_recorder() is rec
        with spans.span("restore", step=7):
            time.sleep(0.01)
        with pytest.raises(RuntimeError):
            with spans.span("rendezvous"):
                raise RuntimeError("mid-span failure")
    finally:
        spans.set_recorder(prev)
    rec.close()
    got = [r for r in _read(rec.path) if r["kind"] == "span"]
    assert [r["name"] for r in got] == ["restore", "rendezvous"]
    assert got[0]["dur_ms"] >= 10.0 and got[0]["step"] == 7
    assert "step" not in got[1]
    with spans.span("eval"):
        pass                    # no recorder: no record, no error


def test_active_spans_show_open_spans_on_any_thread():
    """JAX ``active_spans``: a span open on another thread shows with its
    name, elapsed ms, step and thread, and is gone once closed; the
    records have JAX's keys."""
    opened, release = threading.Event(), threading.Event()

    def hold(mod):
        with mod.span("ckpt_commit", step=4):
            opened.set()
            release.wait(10)

    got = {}
    for name, mod in (("jax", jspans), ("port", spans)):
        opened.clear()
        release.clear()
        t = threading.Thread(target=hold, args=(mod,), name="writer")
        t.start()
        assert opened.wait(10)
        with mod.span("restore"):
            got[name] = mod.active_spans()
        release.set()
        t.join(10)
        assert mod.active_spans() == []
    for name in ("jax", "port"):
        rows = sorted(got[name], key=lambda r: r["name"])
        assert [r["name"] for r in rows] == ["ckpt_commit", "restore"]
        assert rows[0]["step"] == 4 and rows[0]["thread"] == "writer"
        assert rows[1]["thread"] == threading.current_thread().name
    strip = lambda rows: sorted(  # noqa: E731
        (tuple(sorted(k for k in r if k != "elapsed_ms")), r["name"])
        for r in rows)
    assert strip(got["port"]) == strip(got["jax"])


# -- the folds and the report ------------------------------------------------


def test_folds_of_the_fixture_equal_jax():
    """JAX ``aggregate_run`` (whole directory and up to an epoch),
    ``span_breakdown`` and ``read_host_records`` on the recorded
    fixture."""
    for ratio in (2.0, 5.0):
        assert tel.aggregate_run(FIXTURE, straggler_ratio=ratio) == \
            jtel.aggregate_run(FIXTURE, straggler_ratio=ratio)
    assert tel.aggregate_run(FIXTURE, upto_epoch=0) == \
        jtel.aggregate_run(FIXTURE, upto_epoch=0)
    hosts = tel.read_host_records(FIXTURE)
    assert hosts == jtel.read_host_records(FIXTURE)
    recs = hosts[0] + hosts[1]
    assert tel.span_breakdown(recs) == jtel.span_breakdown(recs)
    assert [tel.step_time_ms(r) for r in recs] == [
        jtel.step_time_ms(r) for r in recs]


def test_runfold_incremental_and_truncated_equal_jax(tmp_path):
    """JAX ``RunFold``: the fixture's hosts appended in two parts (a fold
    between), then host 1's file truncated and rewritten: each fold of the
    port's equals JAX's."""
    d = tmp_path / "run"
    d.mkdir()
    lines = {pi: open(os.path.join(FIXTURE, f"host_{pi:05d}.jsonl")).read(
    ).splitlines(keepends=True) for pi in (0, 1)}
    folds = (tel.RunFold(str(d)), jtel.RunFold(str(d)))

    def write(pi, part, mode="a"):
        with open(d / f"host_{pi:05d}.jsonl", mode) as f:
            f.writelines(part)

    for pi in (0, 1):
        write(pi, lines[pi][:10])
    # a torn last line is left for the next fold
    with open(d / "host_00000.jsonl", "a") as f:
        f.write(lines[0][10][:20])
    a, b = (f.summary() for f in folds)
    assert a == b
    with open(d / "host_00000.jsonl", "a") as f:
        f.write(lines[0][10][20:])
    write(0, lines[0][11:])
    write(1, lines[1][10:])
    a, b = (f.summary(straggler_ratio=2.0) for f in folds)
    assert a == b == jtel.aggregate_run(str(d))
    write(1, lines[1][:5], mode="w")          # a relaunch replaced it
    a, b = (f.summary() for f in folds)
    assert a == b and a["hosts"]["1"]["records"] == 3


def test_pod_epoch_aggregate_equals_jax_with_stale_markers(tmp_path):
    """JAX ``pod_epoch_aggregate``: on copies of the fixture with both
    hosts' epoch-0 markers, markers older than the run ignored (a bounded
    wait, then the fold without them), newer ones honoured; the same
    summary, ``pod_summary.json`` and log lines; non-zero hosts fold
    nothing."""
    out = {}
    for name, mod in (("jax", jtel), ("port", tel)):
        d = str(tmp_path / name)
        shutil.copytree(FIXTURE, d)
        for pi in (0, 1):
            mod.publish_epoch_marker(d, 0, pi)
        got = []
        for newer in (time.time() + 60.0, time.time() - 60.0):
            lines = []
            s = mod.pod_epoch_aggregate(d, 0, pi=0, pc=2, log=lines.append,
                                        wait_s=0.1, newer_than=newer)
            disk = json.load(open(os.path.join(d, "pod_summary.json")))
            got.append((s, lines, disk))
        assert mod.pod_epoch_aggregate(d, 0, pi=1, pc=2) is None
        out[name] = got
    assert out["port"] == out["jax"]
    stale, fresh = out["port"]
    assert stale[0]["hosts_reported"] == [] and stale[0]["hosts_missing"] \
        == [0, 1]
    assert fresh[0]["hosts_reported"] == [0, 1]
    assert any("straggler: host 1" in x for x in fresh[1])


def test_jax_report_reads_the_port_run_directory(tmp_path, monkeypatch):
    """JAX's ``scripts/telemetry_report.py::run`` on a directory the
    port's recorder and manifest wrote and on one JAX's wrote from the
    same records: the same percentiles, stragglers, span table and
    throughput curve; the port's manifest has no JAX versions (the
    report renders them "?")."""
    report = _script("telemetry_report")
    dirs = {}
    for name in ("jax", "port"):
        d = str(tmp_path / name)
        for pi, recs in tel.read_host_records(FIXTURE).items():
            rec = (jrec.TelemetryRecorder(d, process_index=pi,
                                          process_count=2, log=_SILENT)
                   if name == "jax" else
                   prec.TelemetryRecorder(d, process_index=pi,
                                          process_count=2, log=_SILENT))
            for r in recs[1:]:
                rec.record_event(**r)
            rec.close()
        if name == "jax":
            jrec.write_manifest(d, cfg=JConfig(), extra={"workload": "t"})
        else:
            prec.write_manifest(d, cfg=TrainConfig(), mesh={"dp": 2},
                                device="cpu", process_count=2,
                                extra={"workload": "t"})
        dirs[name] = report.run(d, with_flight=True)
    got, want = dirs["port"], dirs["jax"]
    for key in ("summary", "spans", "throughput_curve", "goodput",
                "flights"):
        assert got[key] == want[key], key
    man = got["manifest"]
    for key in ("workload", "device_count", "device_kind", "backend",
                "mesh", "process_count", "config"):
        assert key in man, key
    assert man["backend"] == "cpu" and man["torch_version"]
    assert "jax_version" not in man and "jaxlib_version" not in man
    text = report.render(got)
    assert "jax ? / jaxlib ?" in text and "span breakdown" in text


def test_schema_lint_of_the_port_package():
    """JAX ``scripts/check_telemetry_schema.py::scan_emissions`` over the
    port's package: every emitted kind registered, every closed kind's
    fields registered and resolvable; registered and never emitted:
    ``spare`` (warm spares, ROADMAP item 10)."""
    lint = _script("check_telemetry_schema")
    pkg = os.path.join(ROOT, "faster_distributed_training_tpu_torch")
    paths = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(pkg)
                   for f in fs if f.endswith(".py"))
    emitted = set()
    for em in lint.scan_emissions(paths):
        emitted.add(em.kind)
        allowed = prec.TELEMETRY_SCHEMA[em.kind]
        if allowed is None:
            continue
        assert em.fields <= allowed, (em.where, em.fields - allowed)
        assert not em.unresolved, em.where
    assert set(prec.TELEMETRY_SCHEMA) - emitted == {"spare"}


# -- end to end ------------------------------------------------------------

E2E = dict(model="transformer", dataset="synthetic", num_classes=4,
           batch_size=8, seq_len=32, n_layers=2, d_model=64, d_ff=128,
           n_heads=4, epochs=2, subset_stride=128, precision="fp32",
           plot=False, log_every=0, task="lm", dropout_impl="none",
           prefetch_depth=0, checkpoint_every=2, checkpoint_async=False)


def _jcfg(tmp, **kw):
    # one device: the suite's virtual CPU devices would make a dp mesh
    return JConfig(checkpoint_dir=str(tmp), donate=False, mesh_shape=(1,),
                   **dict(E2E, **kw))


def _pcfg(tmp, **kw):
    return TrainConfig(checkpoint_dir=str(tmp), device="cpu",
                       **dict(E2E, **kw))


@pytest.fixture(scope="module")
def init(tmp_path_factory):
    """JAX's initial parameters (its run_training at zero epochs)."""
    root = tmp_path_factory.mktemp("init")
    j0 = jcli.run_training(_jcfg(root, epochs=0, telemetry=False),
                           log=_SILENT)
    return jax.tree_util.tree_map(np.asarray, j0["state"].params)


def _profile(recs):
    """The kinds and their counts, the set of program names, the span
    names and counts, and the step records' (step, epoch, n, k, compile).
    Programs are compared by name, not by count, and retraces not at all:
    under the suite's 64-bit types JAX lowers ``train:host:k1`` a second
    time after its first step (a ``duplicate-avals`` retrace, its state's
    avals moving), which the port's eager step has no counterpart of.
    The port's ``lib:*`` rows are left out: JAX has no kernel libraries,
    and whether this process loads one first depends on the tests run
    before it."""
    kinds = collections.Counter(r["kind"] for r in recs
                                if r["kind"] not in ("program", "retrace"))
    programs = {r["name"] for r in recs if r["kind"] == "program"
                and not r["name"].startswith("lib:")}
    names = collections.Counter(r["name"] for r in recs
                                if r["kind"] == "span")
    steps = [(r["step"], r["epoch"], r["n"], r["k"], bool(r.get("compile")))
             for r in recs if r["kind"] == "step"]
    return kinds, names, steps, programs


@pytest.fixture(scope="module")
def e2e(init, tmp_path_factory):
    """JAX's run and the port's from the same parameters, telemetry on."""
    root = tmp_path_factory.mktemp("e2e")
    jout = jcli.run_training(_jcfg(root / "jax"), log=_SILENT)
    lines = []
    pout = cli.run_training(_pcfg(root / "port"), params=init,
                            log=lines.append)
    return jout, pout, lines


def test_run_record_matches_jax_end_to_end(e2e):
    """JAX ``test_run_emits_valid_stream_matching_summary``: the same
    kinds and counts of records, span names, step numbers and compile
    marks; the epoch events' loss within 1e-5 of JAX's and equal to the
    run's history; the manifest, ``pod_summary.json`` and the
    ``[telemetry]`` lines."""
    jout, pout, lines = e2e
    jrecs = _read(os.path.join(jout["telemetry_dir"], "host_00000.jsonl"))
    precs = _read(os.path.join(pout["telemetry_dir"], "host_00000.jsonl"))
    assert _profile(precs) == _profile(jrecs)
    jep = [r for r in jrecs if r["kind"] == "epoch"]
    pep = [r for r in precs if r["kind"] == "epoch"]
    for a, b in zip(pep, jep):
        assert (a["epoch"], a["steps"], a["trained_steps"]) == (
            b["epoch"], b["steps"], b["trained_steps"])
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=0, atol=1e-5)
        assert a["loss"] == pout["history"]["train_loss"][a["epoch"]]
    mem = [r for r in precs if r["kind"] == "memory"]
    assert mem[0]["scope"] == "state" and mem[0]["params_leaves"] > 0
    assert mem[0]["opt_state_tiers"].keys() == {"replicated"}
    td = pout["telemetry_dir"]
    assert sorted(os.listdir(td)) == [
        "epoch_0000_host_00000.done", "epoch_0001_host_00000.done",
        "host_00000.jsonl", "manifest.json", "pod_summary.json"]
    man = json.load(open(os.path.join(td, "manifest.json")))
    assert man["workload"] == "transformer" and man["steps_per_epoch"] == 4
    assert man["mesh"] == {"dp": 1} and man["backend"] == "cpu"
    assert json.load(open(os.path.join(td, "pod_summary.json"))) == \
        tel.aggregate_run(td)
    assert sum("[telemetry] epoch" in x for x in lines) == 2
    assert any(x.startswith("[telemetry] recording to") for x in lines)


def test_telemetry_every_3_keeps_jax_steps(init, tmp_path):
    """``--telemetry_every 3``: the port keeps the step records JAX's run
    keeps (the compile-marked first among them)."""
    jout = jcli.run_training(_jcfg(tmp_path / "jax", telemetry_every=3,
                                   checkpoint_every=0), log=_SILENT)
    pout = cli.run_training(_pcfg(tmp_path / "port", telemetry_every=3,
                                  checkpoint_every=0),
                            params=init, log=_SILENT)
    got, want = (_profile(_read(os.path.join(o["telemetry_dir"],
                                             "host_00000.jsonl")))[2]
                 for o in (pout, jout))
    assert got == want and len(got) < 8 and got[0][-1]


_HOST_READS = ("__bool__", "__int__", "__float__", "__index__", "item",
               "tolist", "numpy")


def test_no_telemetry_writes_nothing_and_adds_no_host_read(init, tmp_path,
                                                           monkeypatch):
    """``--no_telemetry`` and ``FDT_TELEMETRY=0`` write no telemetry
    directory; telemetry on reads a tensor on the host no more often than
    off, over a whole run (the manner of
    ``test_torch_sentinel.py::test_guard_adds_no_host_read_at_k1``)."""
    reads = {}
    for mode in ("on", "off", "env"):
        n = [0]
        real = {m: getattr(torch.Tensor, m) for m in _HOST_READS}

        def wrap(f):
            def read(self, *a, **kw):
                n[0] += 1
                return f(self, *a, **kw)
            return read
        if mode == "env":
            monkeypatch.setenv("FDT_TELEMETRY", "0")
        for m, f in real.items():
            setattr(torch.Tensor, m, wrap(f))
        try:
            out = cli.run_training(
                _pcfg(tmp_path / mode, telemetry=mode == "on",
                      checkpoint_every=0), params=init, log=_SILENT)
        finally:
            for m, f in real.items():
                setattr(torch.Tensor, m, f)
        reads[mode] = n[0]
        assert int(out["state"].step) == 8
        assert ("telemetry_dir" in out) == (mode == "on")
        assert os.path.exists(tmp_path / mode / "telemetry") == (
            mode == "on")
    assert reads["on"] == reads["off"] == reads["env"]


# -- two gloo ranks ------------------------------------------------------------


def test_pod_fold_at_dp2_and_pipeline_events_at_pp2(tmp_path):
    """Two gloo ranks (``tests/torch_dist_worker.py``): at dp=2 both
    hosts' records land in one directory, rank 0's epoch lines and the
    final ``pod_summary.json`` equal JAX's folds of the same records
    (``pod_epoch_aggregate`` up to each epoch, ``aggregate_run``), the
    grace bounded at 30 s; at pp=2 the ``pp_bubble`` / ``pp_stage``
    events equal what JAX's ``run_training`` records for its spec (JAX
    ``cli.py:1097-1117``)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_dist_worker as w
    from faster_distributed_training_tpu.parallel.mesh import (
        make_mesh as j_mesh)
    from faster_distributed_training_tpu.parallel.pipeline import (
        build_pipeline_spec as jspec, stage_idle_ticks as jidle)

    base = ["--device", "cpu", "--dataset", "synthetic", "--epoch", "2",
            "--n_layers", "2", "--d_model", "32", "--n_heads", "2",
            "--d_ff", "64", "--seq_len", "32", "--subset_stride", "128",
            "--bs", "8", "--precision", "fp32", "--no_plot",
            "--log_every", "0", "--aggregate_grace_s", "30"]
    dp = base + ["--mesh", "dp=2", "--checkpoint_dir", str(tmp_path / "dp")]
    pp = base + ["--mesh", "pp=2", "--checkpoint_dir", str(tmp_path / "pp")]
    res = w.launch("many", 2, str(tmp_path / "grp"), timeout=240.0, cases={
        "dp": ("cli_logged", {"argv": dp}),
        "pp": ("cli_logged", {"argv": pp})})
    td = res[0]["dp"]["telemetry_dir"]
    assert res[1]["dp"]["telemetry_dir"] == td and res[1]["dp"]["lines"] \
        == []
    assert sorted(tel.read_host_records(td)) == [0, 1]
    epoch_lines = [x for x in res[0]["dp"]["lines"]
                   if x.startswith("[telemetry] epoch")]
    assert len(epoch_lines) == 2
    for e, line in enumerate(epoch_lines):
        copy = str(tmp_path / f"fold{e}")
        shutil.copytree(td, copy)
        want = []
        jtel.pod_epoch_aggregate(copy, e, pi=0, pc=2, log=want.append,
                                 wait_s=0.0)
        assert [line] == want
    assert json.load(open(os.path.join(td, "pod_summary.json"))) == \
        jtel.aggregate_run(td)
    # the pipeline's schedule events, rank 0's stream
    recs = tel.read_host_records(res[0]["pp"]["telemetry_dir"])[0]
    got = [{k: v for k, v in r.items() if k != "kind"} for r in recs
           if r["kind"] in ("pp_bubble", "pp_stage")]
    jc = JConfig(model="transformer", n_layers=2, batch_size=8,
                 mesh_axes=("pp",), mesh_shape=(2,))
    spec = jspec(jc, j_mesh(("pp",), (2,), jax.devices()[:2]))
    want = [{"n_stages": spec.n_stages,
             "n_microbatches": spec.n_microbatches,
             "n_ticks": spec.n_ticks, "schedule": spec.schedule,
             "bubble_pct": round(spec.bubble_pct, 3)}] + [
        {"stage": s, "layers": [f"layer_{i}" for i in
                                spec.stage_layers[s]],
         "idle_ticks": idle,
         "active_ticks": spec.n_microbatches
         * (spec.n_virtual // spec.n_stages)}
        for s, idle in enumerate(jidle(spec))]
    assert got == want


# -- serving -----------------------------------------------------------------


class _Stub:
    """An engine that answers every batch with zeros (the schedulers'
    bookkeeping is what is compared)."""

    def __init__(self, name):
        self.name = name

    def predict_batch(self, batch):
        return np.zeros((len(next(iter(batch.values()))), 4), np.float32)


class _Sink:
    def __init__(self):
        self.events = []
        self.lock = threading.Lock()

    def record_event(self, kind, **fields):
        with self.lock:
            self.events.append((kind, fields))


_TIMES = ("dispatch_ms", "queue_ms", "total_ms", "step_ms")


def _untimed(events):
    return sorted((k, tuple(sorted((f, v) for f, v in fs.items()
                                   if f not in _TIMES)))
                  for k, fs in events)


def test_serve_events_equal_jax():
    """JAX ``serve/scheduler.py:291-305``: both packages'
    ``BatchScheduler`` over the same ragged requests record the same
    ``serve_batch`` and ``serve_request`` events (times aside)."""
    from faster_distributed_training_tpu.serve import (
        BatchScheduler as JSched, Replica as JRep, ReplicaSet as JSet,
        RequestQueue as JQueue)
    from faster_distributed_training_tpu_torch.serve import (
        BatchScheduler, Replica, ReplicaSet, RequestQueue)

    requests = cli.synth_requests(11, 100, (16, 32, 64), seed=5)
    got = {}
    for name, (Q, S, R, RS) in (("jax", (JQueue, JSched, JRep, JSet)),
                                ("port", (RequestQueue, BatchScheduler,
                                          Replica, ReplicaSet))):
        q = Q((16, 32, 64), max_len=64)
        sink = _Sink()
        rset = RS([R("replica0", _Stub("replica0"), log=_SILENT)],
                  heartbeat_timeout_s=30.0, log=_SILENT)
        handles = [q.submit(t) for t in requests]
        sched = S(q, rset, batch_size=4, max_delay_ms=5.0, recorder=sink,
                  log=_SILENT)
        sched.start()
        try:
            for h in handles:
                h.wait(timeout=60.0)
        finally:
            sched.close()
        got[name] = sink.events
    assert _untimed(got["port"]) == _untimed(got["jax"])
    kinds = collections.Counter(k for k, _ in got["port"])
    assert kinds["serve_request"] == 11 and kinds["serve_batch"] >= 3


def test_decode_events_equal_jax():
    """JAX ``serve/decode/scheduler.py:106, 139, 176``: both packages'
    ``DecodeScheduler`` over one admission plan (every prompt queued
    before the loop starts, one bucket, two slots) record the same
    ``decode_admit``, ``decode_step`` and ``slot_evict`` events in the
    same order (times aside); a budget of 40 tokens meets the cache's
    end (``capacity``)."""
    import jax.numpy as jnp
    from faster_distributed_training_tpu.serve import (
        RequestQueue as JQueue)
    from faster_distributed_training_tpu.serve.decode import (
        DecodeEngine as JEngine, DecodeScheduler as JSched)
    from faster_distributed_training_tpu.serve.engine import (
        ServingState as JState)
    from faster_distributed_training_tpu_torch.serve import (
        RequestQueue, load_serving_state)
    from faster_distributed_training_tpu_torch.serve.decode import (
        DecodeEngine, DecodeScheduler)

    small = dict(model="transformer", task="lm", dataset="synthetic",
                 num_classes=4, n_layers=2, d_model=64, n_heads=4,
                 d_ff=128, seq_len=16, seq_buckets=(8, 16),
                 precision="fp32", decode_page=4, decode_batch_size=2,
                 telemetry=False, plot=False, device="cpu")
    jcfg, pcfg = JConfig(**small), TrainConfig(**small)
    jmodel = jcli.build_model(jcfg, vocab_size=100, serving=True)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 16), jnp.int32),
        train=False)["params"])
    model, _, _ = load_serving_state(pcfg, "cpu", params=params,
                                     log=_SILENT)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 100, size=n).astype(np.int32)
               for n in (3, 6, 5, 8, 4)]
    budgets = (3, 5, 2, 40, 4)
    engines = {
        "jax": lambda: JEngine(jmodel, JState({"model": params}, {}),
                               (8, 16), batch_size=2, page=4, log=_SILENT),
        "port": lambda: DecodeEngine(model, (8, 16), batch_size=2, page=4)}
    got = {}
    for name, (Q, S) in (("jax", (JQueue, JSched)),
                         ("port", (RequestQueue, DecodeScheduler))):
        eng = engines[name]()
        eng.warmup()
        q = Q((8, 16), max_len=16)
        handles = [q.submit(p, max_new_tokens=b)
                   for p, b in zip(prompts, budgets)]
        sink = _Sink()
        kw = {"log": _SILENT} if name == "jax" else {}
        sched = S(q, eng, max_delay_ms=1.0, max_new_tokens=64,
                  recorder=sink, name="decode0", **kw)
        sched.start()
        try:
            for h in handles:
                h.wait(timeout=120.0)
        finally:
            q.close()
            sched.close()
        got[name] = [(k, tuple(sorted((f, v) for f, v in fs.items()
                                      if f not in _TIMES)))
                     for k, fs in sink.events]
    assert got["port"] == got["jax"]
    evicts = [dict(fs) for k, fs in got["port"] if k == "slot_evict"]
    assert len(evicts) == 5
    assert sorted(e["reason"] for e in evicts).count("capacity") == 1
