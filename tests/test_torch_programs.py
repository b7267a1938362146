"""The port's program table and placement-drift guard
(``faster_distributed_training_tpu_torch/telemetry/programs.py``, the
Trainer's ``_check_sharding_drift``) against the JAX package's
(``telemetry/programs.py``, ``train/loop.py``).

  * the retrace detector: the decisions, reasons and avals of JAX
    ``ProgramObservatory._detect_retrace`` on the same signature
    sequences (a duplicate, a dtype leak, a Python scalar meeting a
    tensor, a flood past 8 variants, legitimate shape variants);
  * the tiny Transformer of JAX ``tests/test_programs.py::_tiny_cfg`` at
    K=1 and K=4 (8 steps an epoch): the same program names and lowerings
    as JAX's observatory (``["eval", "train:host:k1"]``,
    ``["eval", "train:host:k4"]``), no retrace; the port's ``lib:*`` rows
    are left out (JAX has no kernel libraries, and whether this process
    loads one first depends on the tests before);
  * the manifest's ``compile`` table equals the ``program`` events; JAX's
    ``scripts/telemetry_report.py`` prints the port's "compiled programs";
    goodput's ``compile_s`` equals the table's acquisition total within
    1 ms; ``FDT_PROGRAM_OBS=0`` gives no table, no cache and a state
    bitwise the observed run's; the flight payload carries ``programs``;
  * the dispatch's path in the name (JAX ``Trainer._fused_step``'s
    ``train:{program_key}:k{K}``): ``train:resident:k4`` and
    ``train:stream:k2`` (the window's ``program_key``);
  * serving: the ``{name}:predict:L{bucket}`` names of JAX
    ``InferenceEngine.compile_bucket`` for the same buckets; decode: the
    ``:prefill:L`` / ``:decode:P`` names of JAX ``DecodeEngine.warmup``
    (JAX observes no ``:insert:`` program: its engine passes it no name);
  * the drift guard (JAX ``_check_sharding_drift``): a clean run's
    fingerprint is stable over its epochs; a planted drift (a leaf's
    stride, or its dtype, changed at an epoch's end) gives one warning,
    one ``sharding_drift`` event naming the leaf under ``--debug`` and a
    re-anchor; a resume gives no false drift; the storage address joins
    the descriptor only while a captured graph reads the state.
"""

import dataclasses
import importlib.util
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_distributed_training_tpu import cli as jcli
from faster_distributed_training_tpu.config import TrainConfig as JConfig
from faster_distributed_training_tpu.serve.decode import (
    DecodeEngine as JDecodeEngine)
from faster_distributed_training_tpu.serve.engine import (
    InferenceEngine as JInferenceEngine, ServingState as JServingState)
from faster_distributed_training_tpu.telemetry import programs as jprograms
from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.data.stream import (
    synthetic_corpus, write_lm_corpus)
from faster_distributed_training_tpu_torch.serve import (
    InferenceEngine, load_serving_state)
from faster_distributed_training_tpu_torch.serve.decode import DecodeEngine
from faster_distributed_training_tpu_torch.telemetry import flight, programs
from faster_distributed_training_tpu_torch.train import loop as loop_mod
from faster_distributed_training_tpu_torch.train.state import state_leaves

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


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the retrace detector ------------------------------------------------

def _f32(*shape):
    return np.zeros(shape, np.float32)


# (name, [args tuple a lowering], argnums): JAX's leaves are numpy, the
# port's torch tensors of the same shapes and dtypes (Python scalars as
# they are)
SEQUENCES = {
    "duplicate": ([(_f32(4),), (_f32(4),)], (0,)),
    "dtype_leak": ([(_f32(4),), (np.zeros(4, np.int32),)], (0,)),
    "scalar_vs_tensor": ([(_f32(4), 1.0), (_f32(4), np.asarray(1.0))],
                         (0, 1)),
    "flood": ([(_f32(i),) for i in range(1, 11)], (0,)),
    "shape_variants": ([({"x": _f32(2, 8)},), ({"x": _f32(2, 16)},),
                        ({"x": _f32(2, 32)},)], (0,)),
}


def _torch_leaf(x):
    return torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else x


def _to_torch(args):
    return tuple(({k: _torch_leaf(v) for k, v in a.items()}
                  if isinstance(a, dict) else _torch_leaf(a)) for a in args)


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_retrace_decisions_equal_jax(case):
    """JAX ``ProgramObservatory._detect_retrace``: the same reasons at the
    same lowerings, the same avals texts, one warning a detection."""
    seq, argnums = SEQUENCES[case]
    jobs = jprograms.ProgramObservatory(log=_SILENT)
    pobs = programs.ProgramObservatory(log=_SILENT)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        for args in seq:
            jobs._record("p", jprograms.args_signature(args, argnums), 0.0,
                         0.0, "", "off", "none", None)
    with warnings.catch_warnings(record=True) as pw:
        warnings.simplefilter("always")
        for args in seq:
            pobs.observe("p", programs.args_signature(_to_torch(args),
                                                      argnums))
    assert pobs.retraces == jobs.retraces
    assert len(pw) == len(jw) == len(jobs.retraces)
    assert [v["avals"] for v in pobs.summary()["programs"][0]["variants"]] \
        == [v["avals"] for v in jobs.summary()["programs"][0]["variants"]]
    if case == "shape_variants":
        assert pobs.retraces == []
    else:
        assert len(pobs.retraces) == 1


# -- the tiny Transformer at K=1 and K=4 ---------------------------------

TINY = dict(model="transformer", dataset="synthetic", num_classes=4,
            batch_size=8, seq_len=16, n_layers=1, d_model=16, d_ff=32,
            n_heads=2, epochs=2, subset_stride=64, optimizer="sgd",
            precision="fp32", plot=False, workers=0, log_every=0)


def _jcfg(tmp, **kw):
    """JAX ``tests/test_programs.py::_tiny_cfg``."""
    return JConfig(donate=False, checkpoint_dir=str(tmp), **dict(TINY, **kw))


def _pcfg(tmp, **kw):
    return TrainConfig(device="cpu", checkpoint_dir=str(tmp),
                       **dict(TINY, **kw))


def _programs(recs):
    """{name: lowerings} of a stream's ``program`` events, ``lib:*``
    aside."""
    out = {}
    for r in recs:
        if r["kind"] == "program" and not r["name"].startswith("lib:"):
            out[r["name"]] = max(out.get(r["name"], 0), r["lowerings"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{K: (JAX's {name: lowerings}, its retraces, the port's result, its
    records, its manifest)}; the port's runs keep a checkpoint cadence
    (a resilience bundle, so goodput exists)."""
    out = {}
    for k in (1, 4):
        root = tmp_path_factory.mktemp(f"k{k}")
        j = jcli.run_training(_jcfg(root / "jax", steps_per_dispatch=k),
                              log=_SILENT)
        jrecs = _read(os.path.join(j["telemetry_dir"], "host_00000.jsonl"))
        p = cli.run_training(_pcfg(root / "port", steps_per_dispatch=k,
                                   checkpoint_every=4), log=_SILENT)
        td = p["telemetry_dir"]
        with open(os.path.join(td, "manifest.json")) as f:
            man = json.load(f)
        out[k] = (_programs(jrecs),
                  [r for r in jrecs if r["kind"] == "retrace"], p,
                  _read(os.path.join(td, "host_00000.jsonl")), man)
    return out


@pytest.mark.parametrize("k", [1, 4])
def test_tiny_program_set_equals_jax(runs, k):
    """JAX ``TestProgramSetPin``: the same names, each lowered once; no
    retrace in either package."""
    jprogs, jretraces, _out, recs, _man = runs[k]
    assert jprogs == {"eval": 1, f"train:host:k{k}": 1}
    assert _programs(recs) == jprogs
    assert jretraces == [] and [r for r in recs
                                if r["kind"] == "retrace"] == []
    for r in recs:
        if r["kind"] == "program":
            assert r["compile_ms"] >= 0 and r["lower_ms"] >= 0
            assert len(r["fingerprint"]) == 16
            if not r["name"].startswith("lib:"):
                assert (r["cache"], r["cache_method"],
                        r["cache_source"]) == ("off", "none", "compiled")
                # no pool on the CPU: the memory fields are left out
                assert "temp_bytes" not in r
    if k == 4:
        # a captured graph's warm-up is its lower_ms; nothing is captured
        # on the CPU, where the key's first step stands for it
        fused = [r for r in recs if r.get("name") == "train:host:k4"]
        assert fused[0]["lower_ms"] > 0 and fused[0]["compile_ms"] == 0


def test_manifest_table_equals_the_program_events(runs):
    """The manifest's ``compile`` (JAX ``RunTelemetry.close``) holds each
    ``program`` event as a variant."""
    for k in (1, 4):
        _j, _r, _out, recs, man = runs[k]
        events = [r for r in recs if r["kind"] == "program"]
        table = man["compile"]
        assert table["retraces"] == []
        rows = {(p["name"], v["variant"]): v for p in table["programs"]
                for v in p["variants"]}
        assert len(rows) == len(events)
        for ev in events:
            v = rows[(ev["name"], ev["variant"])]
            for key in ("compile_ms", "lower_ms", "fingerprint", "cache",
                        "cache_method", "cache_source", "avals"):
                assert v[key] == ev[key], key
        assert table["total_compile_ms"] == pytest.approx(
            sum(e["compile_ms"] for e in events), abs=0.1)


def test_goodput_compile_equals_the_acquisition_total(runs):
    """JAX ``observe_compile``'s goodput feed: ``compile_s`` is the
    table's acquisition total (lower + compile), within 1 ms."""
    for k in (1, 4):
        _j, _r, out, _recs, man = runs[k]
        total = man["compile"]["total_acquisition_ms"]
        assert out["goodput_compile_s"] > 0
        assert abs(out["goodput_compile_s"] * 1e3 - total) <= 1.0


def test_jax_report_prints_the_port_programs(runs):
    """JAX's ``scripts/telemetry_report.py`` renders the port directory's
    "compiled programs" lines."""
    report = _script("telemetry_report")
    _j, _r, out, _recs, _man = runs[4]
    text = report.render(report.run(out["telemetry_dir"]))
    assert "compiled programs" in text
    assert "train:host:k4" in text and "eval" in text


def test_kill_switch_gives_no_table_and_the_same_state(runs, tmp_path,
                                                       monkeypatch):
    """``FDT_PROGRAM_OBS=0`` (JAX's kill switch): no ``program`` event, no
    ``compile`` table, no executable cache even under
    ``--executable_cache on``, and the final state bitwise the observed
    run's."""
    monkeypatch.setenv("FDT_PROGRAM_OBS", "0")
    out = cli.run_training(_pcfg(tmp_path, steps_per_dispatch=4,
                                 checkpoint_every=4,
                                 executable_cache="on"), log=_SILENT)
    recs = _read(os.path.join(out["telemetry_dir"], "host_00000.jsonl"))
    assert [r for r in recs if r["kind"] in ("program", "retrace")] == []
    with open(os.path.join(out["telemetry_dir"], "manifest.json")) as f:
        assert "compile" not in json.load(f)
    assert not os.path.exists(tmp_path / "_exec_cache")
    want = state_leaves(runs[4][2]["state"])
    got = state_leaves(out["state"])
    assert want.keys() == got.keys()
    for key in want:
        assert torch.equal(want[key], got[key]), key


def test_flight_payload_carries_the_program_table():
    """JAX ``flight.py:171-173``: the active observatory's table."""
    obs = programs.ProgramObservatory(log=_SILENT)
    obs.observe("eval", programs.args_signature((torch.zeros(2, 3),), (0,)),
                compile_ms=1.5)
    prev = programs.set_observatory(obs)
    try:
        payload = flight.build_payload("test")
    finally:
        programs.set_observatory(prev)
    assert payload["programs"] == obs.summary()
    assert payload["programs"]["programs"][0]["name"] == "eval"
    assert "programs" not in flight.build_payload("test")


@pytest.mark.parametrize("path", ["resident", "stream"])
def test_device_data_paths_name_their_programs(tmp_path, path):
    """JAX ``Trainer._fused_step``: the graph key's program is
    ``train:{program_key}:k{K}``, the resident split's ``resident`` and
    the stream window's ``stream``; one lowering, no retrace."""
    if path == "stream":
        texts = synthetic_corpus(40, seed=3, words_per_doc=(25, 50))
        write_lm_corpus(str(tmp_path / "c"), texts, seq_len=16,
                        rows_per_shard=16, val_fraction=0.15,
                        data_dir=str(tmp_path / "dd"), log=_SILENT)
        cfg = _pcfg(tmp_path / "ck", task="lm", dataset="stream",
                    stream_dir=str(tmp_path / "c"), data_path="stream",
                    steps_per_dispatch=2, stream_window=4, epochs=1,
                    subset_stride=1)
        want = "train:stream:k2"
    else:
        cfg = _pcfg(tmp_path, data_path="resident", steps_per_dispatch=4,
                    epochs=1)
        want = "train:resident:k4"
    out = cli.run_training(cfg, log=_SILENT)
    recs = _read(os.path.join(out["telemetry_dir"], "host_00000.jsonl"))
    assert _programs(recs) == {"eval": 1, want: 1}
    assert [r for r in recs if r["kind"] == "retrace"] == []


# -- serving and decode -----------------------------------------------------

VOCAB = 100
SERVE = dict(model="transformer", dataset="synthetic", num_classes=4,
             n_layers=1, d_model=32, n_heads=2, d_ff=64, seq_len=32,
             precision="fp32", telemetry=False, plot=False, device="cpu")


def _observed(fn):
    """Sorted program names an observatory records while ``fn`` runs
    (both packages' process-global observatories installed)."""
    jobs = jprograms.ProgramObservatory(log=_SILENT)
    pobs = programs.ProgramObservatory(log=_SILENT)
    jprev = jprograms.set_observatory(jobs)
    pprev = programs.set_observatory(pobs)
    try:
        fn()
    finally:
        jprograms.set_observatory(jprev)
        programs.set_observatory(pprev)
    strip = [n for n in pobs.programs if not n.startswith("lib:")]
    return sorted(jobs.programs), sorted(strip), pobs


def test_serving_predict_names_equal_jax():
    """JAX ``InferenceEngine.compile_bucket``: one
    ``{name}:predict:L{bucket}`` a bucket, the same names."""
    buckets = (16, 32)
    jcfg = JConfig(**SERVE)
    jmodel = jcli.build_model(jcfg, vocab_size=VOCAB, serving=True)
    z = jnp.zeros((2, 16), jnp.int32)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), z, mask=z + 1, train=False)["params"])
    model, _, _ = load_serving_state(TrainConfig(**SERVE), "cpu",
                                     params={"params": {"model": params}},
                                     log=_SILENT)

    def warm():
        JInferenceEngine(jmodel.apply, JServingState({"model": params}, {}),
                         4, buckets, name="replica0", log=_SILENT).warmup()
        InferenceEngine(model, 4, buckets, "cpu", name="replica0").warmup()
    jnames, pnames, pobs = _observed(warm)
    assert pnames == jnames == ["replica0:predict:L16",
                                "replica0:predict:L32"]
    assert pobs.retraces == []


def test_decode_names_equal_jax():
    """JAX ``DecodeEngine.warmup``: ``:prefill:L{bucket}`` a bucket and
    ``:decode:P{pages}`` a page count, the same names (JAX's
    ``:insert:L{bucket}`` is unobserved there too)."""
    cfg = dict(SERVE, task="lm", seq_len=16, seq_buckets=(8, 16))
    jcfg = JConfig(**cfg)
    jmodel = jcli.build_model(jcfg, vocab_size=VOCAB, serving=True)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 16), jnp.int32),
        train=False)["params"])
    model, _, _ = load_serving_state(TrainConfig(**cfg), "cpu",
                                     params=params, log=_SILENT)
    engines = []

    def warm():
        JDecodeEngine(jmodel, JServingState({"model": params}, {}), (8, 16),
                      batch_size=2, page=4, log=_SILENT).warmup()
        eng = DecodeEngine(model, (8, 16), batch_size=2, page=4)
        eng.warmup()
        engines.append(eng)
    jnames, pnames, pobs = _observed(warm)
    assert not [n for n in jnames if ":insert:" in n]
    assert pnames == jnames
    assert sorted(n for n in pnames if ":decode:P" in n) == [
        f"serve:decode:P{p}" for p in range(1, engines[0].max_pages + 1)]
    assert engines[0].captures == 0 and pobs.retraces == []


# -- the drift guard ----------------------------------------------------------

def _drift_events(out):
    recs = _read(os.path.join(out["telemetry_dir"], "host_00000.jsonl"))
    return [r for r in recs if r["kind"] == "memory"
            and r["scope"] == "sharding_drift"]


def test_clean_run_fingerprint_is_stable(tmp_path):
    """Three epochs of a clean run (``--debug``): no drift, no warning."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = cli.run_training(_pcfg(tmp_path, epochs=3, debug=True),
                               log=_SILENT)
    assert _drift_events(out) == []
    assert not [x for x in w if "DRIFT" in str(x.message)]
    assert out["trainer"]._sharding_expect == programs.sharding_fingerprint(
        out["state"])


@pytest.mark.parametrize("plant", ["stride", "dtype"])
def test_planted_drift_warns_once_and_reanchors(tmp_path, monkeypatch,
                                                plant):
    """A leaf re-laid (its stride) or re-typed at epoch 0's end: one
    warning, one ``[memory] WARNING`` line, one ``sharding_drift`` event
    naming it under ``--debug``; the guard re-anchors, so epoch 1's check
    is silent."""
    real = loop_mod.Trainer._check_sharding_drift
    leaf = ("params/layers.0.ffn.Dense_0.weight" if plant == "stride"
            else "batch_stats/drift_probe")

    def planted(self, state, epoch):
        if epoch == 0:
            if plant == "stride":
                p = dict(state.model.named_parameters())[leaf[7:]]
                p.data = p.data.t().contiguous().t()
            else:
                state.model.register_buffer("drift_probe",
                                            torch.zeros(3, dtype=torch.float64))
        return real(self, state, epoch)

    if plant == "dtype":
        # the probe buffer exists (fp32) from the first dispatch on
        real_obs = loop_mod.Trainer._observe_state

        def probe(self, state):
            if "drift_probe" not in dict(state.model.named_buffers()):
                state.model.register_buffer("drift_probe", torch.zeros(3))
            return real_obs(self, state)
        monkeypatch.setattr(loop_mod.Trainer, "_observe_state", probe)
    monkeypatch.setattr(loop_mod.Trainer, "_check_sharding_drift", planted)
    lines = []
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = cli.run_training(_pcfg(tmp_path, epochs=2, debug=True),
                               log=lines.append)
    drifts = [x for x in w if "DRIFT" in str(x.message)]
    assert len(drifts) == 1 and "epoch 0" in str(drifts[0].message)
    assert sum("[memory] WARNING" in x for x in lines) == 1
    ev = _drift_events(out)
    assert len(ev) == 1 and ev[0]["epoch"] == 0
    assert ev[0]["changed_leaves"] == [leaf]
    assert ev[0]["expected"] != ev[0]["got"]
    assert out["trainer"]._sharding_expect == ev[0]["got"]


def test_resume_gives_no_false_drift(tmp_path):
    """A run that resumes from its step checkpoints (a restore: JAX
    re-anchors after it) checks its epochs without a drift."""
    cfg = _pcfg(tmp_path, epochs=1, checkpoint_every=4, debug=True)
    cli.run_training(cfg, log=_SILENT)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = cli.run_training(dataclasses.replace(cfg, epochs=3,
                                                   resume=True),
                               log=_SILENT)
    assert int(out["state"].step) == 24
    assert _drift_events(out) == []
    assert not [x for x in w if "DRIFT" in str(x.message)]


def test_storage_address_joins_the_descriptor_only_with_graphs(tmp_path):
    """``sharding_table(state, addresses=True)``: a leaf whose storage is
    swapped (not copied into) moves the fingerprint only where a captured
    graph reads the state; a copy into the live tensor moves nothing."""
    out = cli.run_training(_pcfg(tmp_path, epochs=1), log=_SILENT)
    state = out["state"]
    before = (programs.sharding_fingerprint(state),
              programs.sharding_fingerprint(state, addresses=True))
    p = next(iter(state.model.parameters()))
    with torch.no_grad():
        p.copy_(p + 1)
    assert (programs.sharding_fingerprint(state),
            programs.sharding_fingerprint(state, addresses=True)) == before
    p.data = p.data.clone()
    assert programs.sharding_fingerprint(state) == before[0]
    assert programs.sharding_fingerprint(state, addresses=True) != before[1]
    table = programs.sharding_table(state, addresses=True)
    assert all("|@" in d for d in table.values())
    assert "|@" not in "".join(programs.sharding_table(state).values())
