"""The port's anomaly sentinel (``resilience/sentinel.py`` and the
in-graph guard of ``train/steps.py``) against the JAX package's.

  * ``SpikeDetector`` verdicts on one loss series; ``QuarantineLedger``
    JSON bytes; ``Sentinel.plan``; ``host_finite`` (JAX
    ``resilience/sentinel.py``);
  * ``--sentinel none`` leaves the step as it was: the guard's verdict is
    never computed and the state is bitwise a guarded run's without a
    bad step, at K=1 and K=4;
  * ``--sentinel guard`` with ``FDT_FAULT_NAN_AT_STEP=2``: step 2 is
    skipped (``bad_steps`` 1, the step count still advances), K=4 is
    bitwise K=1 (the NaN compares the device step inside the dispatch),
    and the run is within loss 1e-5 / leaves 1e-4 of JAX's same run
    (JAX ``tests/test_sentinel.py:230-340``); at K=1 the guard reads
    the device on the host no more often than ``none`` (the skip a device
    select, the optimizer's count on the device), and reading that count
    every few steps leaves the run bitwise the same;
  * a loss spike under ``--sentinel full --supervise`` rolls back,
    quarantines the batch position in the ledger JAX writes and replays
    deterministically (JAX ``tests/test_sentinel.py:344-437``);
  * a corrupt stream shard is quarantined and the run completes (JAX
    ``tests/test_sentinel.py:463``).

The end-to-end runs are the tiny next-token LM of
``tests/test_torch_resilience.py`` (no dropout; JAX's initial parameters
handed to the port).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from faster_distributed_training_tpu import cli as jcli
from faster_distributed_training_tpu.config import TrainConfig as JConfig
from faster_distributed_training_tpu.resilience import sentinel as j_sentinel
from faster_distributed_training_tpu.resilience import storage as j_storage
from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.interop import (flatten,
                                                           params_to_jax)
from faster_distributed_training_tpu_torch.resilience import faults
from faster_distributed_training_tpu_torch.resilience import sentinel
from faster_distributed_training_tpu_torch.resilience import storage
from faster_distributed_training_tpu_torch.train import steps as tsteps


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: under the suite's parallel workers torch's
    thread-a-core default oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- host pieces --------------------------------------------------------------


def _series():
    rng = np.random.default_rng(7)
    base = 3.0 - 0.01 * np.arange(60) + rng.normal(0, 0.02, 60)
    base[[12, 30, 31, 45]] *= [40.0, 6.0, 1.2, 1e4]
    base[20] = np.nan
    return [float(x) for x in base] + [3.0] * 8


def test_spike_detector_verdicts_equal_jax():
    """JAX ``SpikeDetector.observe`` on one series (spikes, a NaN, a flat
    tail), at two windows and thresholds, then after a reset."""
    for window, threshold in ((32, 8.0), (8, 3.0)):
        verdicts = []
        for mod in (j_sentinel, sentinel):
            d = mod.SpikeDetector(window=window, threshold=threshold)
            v = [d.observe(x) for x in _series()]
            d.reset()
            v += [d.observe(x) for x in _series()[:10]]
            verdicts.append(v)
        assert verdicts[1] == verdicts[0]
        assert any(verdicts[1])


def test_quarantine_ledger_json_bytes_equal_jax(tmp_path):
    """The same additions through both ledgers on the posix backend: the
    same ``ledger.json`` bytes, and each reloads the other's."""
    out = {}
    for name, mod, smod in (("jax", j_sentinel, j_storage),
                            ("port", sentinel, storage)):
        key = str(tmp_path / name / "quarantine" / "ledger.json")
        led = mod.QuarantineLedger(backend=smod.PosixBackend(), key=key)
        led.add_batches(2, [5, 1])
        led.add_batches(0, [3])
        led.add_shard(4)
        led.add_batches(2, [1, 9])
        with open(key, "rb") as f:
            out[name] = f.read()
    assert out["port"] == out["jax"]
    assert json.loads(out["port"]) == {"version": 1, "batches": {
        "0": [3], "2": [1, 5, 9]}, "shards": [4]}
    led = sentinel.QuarantineLedger(
        backend=storage.PosixBackend(),
        key=str(tmp_path / "jax" / "quarantine" / "ledger.json"))
    assert led.batches_for(2) == {1, 5, 9} and led.shards() == {4}


def test_plan_and_observe_equal_jax():
    """``Sentinel.plan`` segments around quarantined positions, and
    ``observe``'s quarantine on a spike (JAX's)."""
    got = []
    for mod in (j_sentinel, sentinel):
        s = mod.Sentinel("full", window=8, threshold=3.0, log=lambda *_: None)
        plans = [s.plan(0, 0, 4)]
        s.ledger.add_batches(0, [1, 2, 6])
        plans += [s.plan(0, 0, 4), s.plan(0, 4, 4), s.plan(0, 1, 2),
                  s.plan(1, 0, 4)]
        for i in range(8):
            s.observe(0, 8 + i, 1, 2.0 + 0.01 * i, 10 + i)
        with pytest.raises(mod.LossSpike) as e:
            s.observe(0, 16, 2, 500.0, 20)
        got.append((plans, e.value.positions, sorted(s.ledger.batches_for(0))))
    assert got[1] == got[0]


def test_host_finite_reads_a_tensor():
    assert sentinel.host_finite(torch.tensor(1.5))
    assert not sentinel.host_finite(torch.tensor(float("nan")))
    assert not sentinel.host_finite(float("inf"))
    assert not sentinel.host_finite(None)
    assert not sentinel.host_finite(torch.ones(2))    # not a scalar


def test_sentinel_mode_is_checked():
    with pytest.raises(ValueError, match="guard/full"):
        sentinel.Sentinel("none")


# -- the guard end to end -------------------------------------------------------

E2E = dict(model="transformer", dataset="synthetic", num_classes=4,
           batch_size=8, seq_len=32, n_layers=2, d_model=64, d_ff=128,
           n_heads=4, epochs=2, subset_stride=128, precision="fp32",
           plot=False, log_every=0, task="lm", dropout_impl="none",
           telemetry=False, prefetch_depth=0)


def _jcfg(tmp, **kw):
    return JConfig(checkpoint_dir=str(tmp), donate=False, mesh_shape=(1,),
                   **dict(E2E, **kw))


def _pcfg(tmp, **kw):
    return TrainConfig(checkpoint_dir=str(tmp), device="cpu",
                       **dict(E2E, **kw))


@pytest.fixture(scope="module")
def init(tmp_path_factory):
    root = tmp_path_factory.mktemp("init")
    j0 = jcli.run_training(_jcfg(root, epochs=0), log=lambda *_: None)
    return jax.tree_util.tree_map(np.asarray, j0["state"].params)


def _leaves(out):
    st = out["state"]
    flat = {f"model/{k}": v.clone() for k, v in st.model.state_dict().items()}
    for part in ("v", "z", "s"):
        for k, v in st.opt_state.get(part, {}).items():
            flat[f"opt/{part}/{k}"] = v.clone()
    flat["opt_step"] = torch.tensor(st.opt_state["step"])
    flat["step"] = torch.tensor(int(st.step))
    return flat


def _assert_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("k", [1, 4])
def test_sentinel_none_leaves_the_step_unchanged(init, tmp_path,
                                                 monkeypatch, k):
    """``--sentinel none`` never computes the verdict and adds no metric;
    a guarded run without a bad step ends bitwise the same."""
    real = tsteps.sentinel_ok
    monkeypatch.setattr(tsteps, "sentinel_ok", lambda *a, **kw: (
        _ for _ in ()).throw(AssertionError("verdict under none")))
    none = cli.run_training(_pcfg(tmp_path / "none", epochs=1,
                                  steps_per_dispatch=k),
                            params=init, log=lambda *_: None)
    assert "goodput_skipped_steps" not in none
    monkeypatch.setattr(tsteps, "sentinel_ok", real)
    guard = cli.run_training(_pcfg(tmp_path / "guard", sentinel="guard",
                                   epochs=1, steps_per_dispatch=k),
                             params=init, log=lambda *_: None)
    assert guard["goodput_skipped_steps"] == 0
    _assert_equal(_leaves(none), _leaves(guard))


def test_guard_skips_the_nan_step_at_k1_and_k4_like_jax(init, tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv(faults.ENV_NAN, "2")
    jout = jcli.run_training(_jcfg(tmp_path / "jax", sentinel="guard"),
                             log=lambda *_: None)
    runs = {k: cli.run_training(_pcfg(tmp_path / f"k{k}", sentinel="guard",
                                      steps_per_dispatch=k),
                                params=init, log=lambda *_: None)
            for k in (1, 4)}
    for k, out in runs.items():
        assert int(out["state"].step) == 8, k
        assert out["state"].opt_state["step"] == 7, k   # one update skipped
        assert out["goodput_skipped_steps"] == 1, k
        assert all(torch.isfinite(v).all()
                   for v in out["state"].model.state_dict().values()
                   if v.is_floating_point())
    assert jout["goodput_skipped_steps"] == 1
    _assert_equal(_leaves(runs[1]), _leaves(runs[4]))
    want = flatten(jax.tree_util.tree_map(
        np.asarray, jout["state"].params["model"]))
    got = flatten(params_to_jax(runs[1]["state"].model.state_dict(), 4))
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4,
                                   err_msg=key)
    np.testing.assert_allclose(runs[1]["history"]["train_loss"],
                               jout["history"]["train_loss"], rtol=0,
                               atol=1e-5)


_HOST_READS = ("__bool__", "__int__", "__float__", "__index__", "item",
               "tolist")


def _counting_steps(monkeypatch, reads: list, real_make) -> None:
    """``real_make``'s steps count the tensor reads on the host they
    make, one entry of ``reads`` a step."""

    def make(cfg):
        step = real_make(cfg)

        def counted(*a, **kw):
            n = [0]
            real = {m: getattr(torch.Tensor, m) for m in _HOST_READS}

            def wrap(f):
                def read(self, *args, **kwargs):
                    n[0] += 1
                    return f(self, *args, **kwargs)
                return read
            for m, f in real.items():
                setattr(torch.Tensor, m, wrap(f))
            try:
                return step(*a, **kw)
            finally:
                for m, f in real.items():
                    setattr(torch.Tensor, m, f)
                reads.append(n[0])
        return counted
    monkeypatch.setattr(tsteps, "make_train_step", make)


def test_guard_adds_no_host_read_at_k1(init, tmp_path, monkeypatch):
    """JAX's guard is a select inside the step program
    (``train/steps.py::_sentinel_ok``, ``_tree_where``).  At K=1 the
    port's guarded step skips by a device select too, its optimizer
    scalars indexed by the applied count on the device: a step reads
    the device on the host no more often than under ``none``, and the
    count, read at the epoch's end, leaves the skipped step out."""
    reads, real_make = {}, tsteps.make_train_step
    for mode in ("none", "guard"):
        reads[mode] = []
        _counting_steps(monkeypatch, reads[mode], real_make)
        if mode == "guard":
            monkeypatch.setenv(faults.ENV_NAN, "2")
        out = cli.run_training(_pcfg(tmp_path / mode, sentinel=mode,
                                     epochs=1),
                               params=init, log=lambda *_: None)
        assert int(out["state"].step) == 4
    assert len(reads["guard"]) == len(reads["none"]) == 4
    assert reads["guard"] == reads["none"]
    assert out["goodput_skipped_steps"] == 1
    assert out["state"].opt_state["step"] == 3


@pytest.mark.parametrize("k", [1, 4])
def test_applied_count_settles_and_refills_bitwise(init, tmp_path,
                                                   monkeypatch, k):
    """The applied count read back and its scalar table refilled every
    few steps (rather than every 64) leaves a guarded run with its NaN
    step bitwise the same: the table's rows are the host schedule at
    each count the run can reach."""
    from faster_distributed_training_tpu_torch.train import dispatch

    monkeypatch.setenv(faults.ENV_NAN, "2")
    wide = cli.run_training(_pcfg(tmp_path / "wide", sentinel="guard",
                                  steps_per_dispatch=k),
                            params=init, log=lambda *_: None)
    monkeypatch.setattr(tsteps, "SETTLE_EVERY", 3)
    monkeypatch.setattr(dispatch, "SETTLE_DISPATCHES", 1)
    narrow = cli.run_training(_pcfg(tmp_path / "narrow", sentinel="guard",
                                    steps_per_dispatch=k),
                              params=init, log=lambda *_: None)
    assert narrow["state"].opt_state["step"] == 7
    _assert_equal(_leaves(wide), _leaves(narrow))


def _spiked(tmp, params, **env):
    """``--sentinel full --supervise --checkpoint_every 2`` over 3 epochs of
    4 steps with the spike arm at step 10 (9 observations before it):
    epoch 2 position 1 spikes, the run rolls back to the step-8
    checkpoint and replays epoch 2 without it: 11 steps."""
    kw = dict(epochs=3, sentinel="full", supervise=True, checkpoint_every=2,
              checkpoint_async=False)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        if params is None:
            return jcli.run_training(_jcfg(tmp, **kw), log=lambda *_: None)
        return cli.run_training(_pcfg(tmp, **kw), params=params,
                                log=lambda *_: None)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_spike_rolls_back_quarantines_and_replays_deterministically(
        init, tmp_path):
    env = {faults.ENV_SPIKE: "10"}
    jout = _spiked(tmp_path / "jax", None, **env)
    a = _spiked(tmp_path / "a", init, **env)
    b = _spiked(tmp_path / "b", init, **env)
    for out in (a, jout):
        assert out["goodput_rollbacks"] == 1
        assert out["goodput_quarantined_batches"] == 1
        assert out["goodput_restores"] == 1
        assert int(out["state"].step) == 11
    ledger = "quarantine/ledger.json"
    assert ((tmp_path / "a" / ledger).read_bytes()
            == (tmp_path / "jax" / ledger).read_bytes())
    assert json.loads((tmp_path / "a" / ledger).read_text())["batches"] == {
        "2": [1]}
    _assert_equal(_leaves(a), _leaves(b))


def test_corrupt_stream_shard_is_quarantined_and_the_run_completes(
        tmp_path, monkeypatch):
    """``FDT_FAULT_CORRUPT_SHARD=1``: shard 1 fails its checksum at first
    touch, its rows remap to a healthy shard, the ledger and the counter
    record it, and every step runs."""
    from faster_distributed_training_tpu_torch.data.stream import (
        ShardedStreamDataset)
    from faster_distributed_training_tpu_torch.data.stream.format import (
        synthetic_corpus, write_lm_corpus)

    d = str(tmp_path / "corpus")
    write_lm_corpus(d, synthetic_corpus(40, seed=3, words_per_doc=(25, 50)),
                    seq_len=16, rows_per_shard=16, val_fraction=0.15,
                    data_dir=str(tmp_path / "data"), log=lambda *_: None)
    train = ShardedStreamDataset(os.path.join(d, "train"))
    assert len(train.manifest["shards"]) > 1
    cfg = TrainConfig(model="transformer", dataset="stream", task="lm",
                      stream_dir=d, batch_size=8, seq_len=16, n_layers=1,
                      d_model=32, d_ff=64, n_heads=2, epochs=1,
                      precision="fp32", plot=False, prefetch_depth=0,
                      log_every=0, sentinel="guard", device="cpu",
                      telemetry=False, checkpoint_dir=str(tmp_path / "ck"))
    monkeypatch.setenv(faults.ENV_CORRUPT, "1")
    with pytest.warns(UserWarning, match="CRC mismatch"):
        out = cli.run_training(cfg, log=lambda *_: None)
    assert out["goodput_quarantined_shards"] == 1
    assert int(out["state"].step) == train.n // 8
    doc = json.loads((tmp_path / "ck" / "quarantine" / "ledger.json")
                     .read_text())
    assert doc["shards"] == [1]
