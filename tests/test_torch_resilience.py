"""The port's resilience (``faster_distributed_training_tpu_torch/
resilience/``) against the JAX package's (``resilience/``).

  * storage: the same operations through both packages'
    ``PosixBackend`` and ``FakeObjectStoreBackend`` leave byte-identical
    trees and object maps (JAX ``resilience/storage.py``);
  * goodput: ``GoodputTracker.summary()`` keys and values for one scripted
    sequence on a fake clock (JAX ``resilience/goodput.py``);
  * ``FaultPlan`` and ``Supervisor``: their decisions on the cases of JAX
    ``tests/test_resilience.py:183-395``, scenario by scenario;
  * the manager: step and clock cadence, an in-flight save skipped and
    not queued, keep-K, a corrupt newest checkpoint falling back, the
    sharded form on the fake object store, ``peek_latest``;
  * preemption: SIGTERM sets the flag only;
  * end to end on a tiny next-token LM (2 layers, d_model 64, no dropout,
    so both packages' runs are a function of the initial parameters and
    the data order alone; JAX's initial parameters are handed to the
    port): ``--supervise --checkpoint_every 2`` with
    ``FDT_FAULT_DIE_AT_STEP=3`` ends bitwise the port's uninterrupted run
    and within loss 1e-5 / leaves 1e-4 of JAX's same run, with equal
    goodput counters (restarts, saves, restores, steps) and committed
    steps (JAX ``tests/test_resilience.py:499-571``); SIGTERM at step 5
    gives ``Preempted`` and an emergency save at JAX's step, and the same
    command relaunched ends bitwise the uninterrupted run; a corrupt
    newest checkpoint falls back to the previous one; ``--auto_recover``
    rolls a NaN epoch back; an fsdp=2 sharded commit over two gloo ranks
    restores at dp=1; at tp=2 over two gloo ranks a write slower than a
    step makes both ranks skip the same cadence ticks.

Saves run with ``--sync_checkpoint`` where a committed set is compared:
an asynchronous save skips a tick while the previous one writes, which
depends on the machine's timing in either package.
"""

import json
import os
import signal
import time

import jax
import numpy as np
import pytest
import torch

from faster_distributed_training_tpu import cli as jcli
from faster_distributed_training_tpu.config import TrainConfig as JConfig
from faster_distributed_training_tpu.resilience import faults as j_faults
from faster_distributed_training_tpu.resilience import goodput as j_goodput
from faster_distributed_training_tpu.resilience import storage as j_storage
from faster_distributed_training_tpu.resilience import (
    supervisor as j_supervisor)
from faster_distributed_training_tpu.resilience import Preempted as JPreempted
from faster_distributed_training_tpu.resilience.coordinator import (
    PeerFailure as JPeerFailure)
from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.interop import (flatten,
                                                           params_to_jax)
from faster_distributed_training_tpu_torch.resilience import (
    AsyncCheckpointManager, FaultPlan, GoodputTracker, InjectedFault,
    Preempted, PreemptionHandler, Supervisor, build_resilience,
    corrupt_newest_checkpoint)
from faster_distributed_training_tpu_torch.resilience import faults
from faster_distributed_training_tpu_torch.resilience import goodput
from faster_distributed_training_tpu_torch.resilience import storage
from faster_distributed_training_tpu_torch.resilience.coordinator import (
    PeerFailure)
from faster_distributed_training_tpu_torch.train import checkpoint as ckpt


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: under the suite's parallel workers torch's
    thread-a-core default oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- storage ------------------------------------------------------------------


def _storage_ops(mod, backend, root):
    """One sequence of every write, read, list and delete."""
    k = lambda *p: os.path.join(root, *p)  # noqa: E731
    backend.put_bytes(k("a", "x.bin"), b"\x00\x01payload")
    backend.put_json(k("a", "m.json"), {"step": 3, "kind": "crash"})
    backend.put_stream(k("b", "s.bin"), lambda f: f.write(b"streamed" * 7))
    created = [backend.create_if_absent(k("a", "COMMIT"), b"first"),
               backend.create_if_absent(k("a", "COMMIT"), b"second")]
    backend.put_bytes(k("c", "d", "deep.bin"), b"deep")
    backend.delete(k("b", "s.bin"))
    gone = backend.delete_prefix(k("c"))
    return {"created": created, "gone": gone,
            "read": backend.read_bytes(k("a", "x.bin"), start=1, length=4),
            "json": backend.read_json(k("a", "m.json")),
            "entries": backend.list_entries(root),
            "listed": [os.path.relpath(p, root)
                       for p in sorted(backend.list_prefix(k("a")))],
            "exists": [backend.exists(k("a", "COMMIT")),
                       backend.exists(k("b", "s.bin"))]}


def _tree(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_posix_backend_leaves_the_tree_jax_leaves(tmp_path):
    """JAX ``PosixBackend``: the same operations, the same results and a
    byte-identical file tree."""
    got = {}
    for name, mod in (("jax", j_storage), ("port", storage)):
        root = str(tmp_path / name)
        got[name] = (_storage_ops(mod, mod.PosixBackend(), root),
                     _tree(root))
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("medium", ["memory", "file"])
def test_fake_object_store_leaves_the_object_map_jax_leaves(tmp_path,
                                                            medium):
    """JAX ``FakeObjectStoreBackend`` over a ``MemoryMedium`` (its object
    map) and a ``FileMedium`` (its rename-free files on disk): the same
    results, object map and operation counts."""
    got = {}
    for name, mod in (("jax", j_storage), ("port", storage)):
        root = str(tmp_path / name / "run")
        med = (mod.MemoryMedium() if medium == "memory"
               else mod.FileMedium(str(tmp_path / name / "_objects")))
        b = mod.FakeObjectStoreBackend(med, root=root)
        ops = _storage_ops(mod, b, root)
        objects = {n: med.get(n)[0] for n in med.list()}
        files = (sorted(os.listdir(med.root)) if medium == "file" else None)
        got[name] = (ops, objects, dict(b.counts), files)
    assert got["port"] == got["jax"]


def test_build_backend_kinds(tmp_path):
    assert storage.build_backend("posix", str(tmp_path)).kind == "posix"
    b = storage.build_backend("fake_object_store", str(tmp_path),
                              log=lambda *_: None)
    assert b.kind == "fake_object_store"
    with pytest.raises(ValueError, match="storage_backend"):
        storage.build_backend("nfs://x", str(tmp_path))


# -- goodput ------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _goodput_script(mod):
    clock = _Clock()
    g = mod.GoodputTracker(clock=clock).start()
    clock.t += 2.0
    g.count("steps", 8)
    with g.timed("checkpoint_blocking_s"):
        clock.t += 0.25
    g.count("saves")
    g.add("restore_s", 0.5)            # a --resume start: not recovery
    g.count("restarts")
    g.add("detect_s", 0.125)
    with g.timed("restore_s"):
        clock.t += 0.75
    g.count("restores")
    g.add("restart_backoff_s", 1.0)
    g.count("skipped_steps", 2)
    g.count("steps", 4)
    clock.t += 3.0
    with pytest.raises(KeyError):
        g.count("bogus")
    return g.summary()


def test_goodput_summary_equals_jax():
    """JAX ``GoodputTracker.summary``: the same keys and values for one
    scripted sequence (MTTR excludes the pre-restart restore)."""
    want = _goodput_script(j_goodput)
    got = _goodput_script(goodput)
    assert got == want
    assert got["restart_mttr_s"] == round(0.125 + 1.0 + 0.75, 3)


# -- FaultPlan and Supervisor -----------------------------------------------------


def _fault_decisions(mod, InjectedFaultCls):
    out = []
    out.append(mod.FaultPlan.from_env({}) is None)
    plan = mod.FaultPlan.from_env({mod.ENV_DIE: "5"})
    out.append((plan.die_at, plan.sigterm_at))
    try:
        mod.FaultPlan.from_env({mod.ENV_DIE: "soon"})
    except ValueError as e:
        out.append(str(e))
    plan = mod.FaultPlan(die_at=3)
    fired = []
    for s in (1, 2, 3, 3, 4):
        try:
            plan.on_step(s)
            fired.append(None)
        except InjectedFaultCls as e:
            fired.append(str(e))
    out.append(fired)
    plan = mod.FaultPlan(data_at=2)
    got = []
    try:
        for x in plan.wrap_data(iter(range(5))):
            got.append(x)
    except InjectedFaultCls as e:
        got.append(str(e))
    out.append(got)
    env = {mod.ENV_DIE: "5", mod.ENV_HOST: "1"}
    out.append([mod.FaultPlan.from_env(env, process_index=0) is None,
                mod.FaultPlan.from_env(env, process_index=1).die_at,
                mod.FaultPlan.from_env(dict(env, FDT_POD_INDEX="1",
                                            FDT_POD_COUNT="2")).die_at,
                mod.FaultPlan.from_env(dict(env, FDT_POD_INDEX="0",
                                            FDT_POD_COUNT="2")) is None])
    plan = mod.FaultPlan(spike_at=4)
    out.append([plan.perturb_loss(s, 2.0) for s in (3, 4, 5)])
    out.append(mod.graph_nan_at({mod.ENV_NAN: "2"}))
    return out


def test_fault_plan_decisions_equal_jax():
    """JAX ``tests/test_resilience.py::TestFaultPlan``'s cases: env
    parsing, die and data once, host scoping, the spike arm."""
    assert (_fault_decisions(faults, InjectedFault)
            == _fault_decisions(j_faults, j_faults.InjectedFault))


def test_hang_blocks_until_released_then_fires_once():
    import threading

    plan = FaultPlan.from_env({faults.ENV_HANG: "3"})
    plan.on_step(2)
    t = threading.Timer(0.15, plan.hang_release.set)
    t.start()
    t0 = time.monotonic()
    plan.on_step(3)
    assert time.monotonic() - t0 >= 0.1
    t.join()
    t0 = time.monotonic()
    plan.on_step(3)
    assert time.monotonic() - t0 < 0.1


def _raise(e):
    raise e


class _Coord:
    def __init__(self, events):
        self.events = events

    def begin_attempt(self):
        self.events.append("begin")

    def record_failure(self, e, step=None):
        self.events.append("fail")

    def record_completion(self, step=None):
        self.events.append("done")


# (name, max_restarts, backoff_cap, attempt(i, pkg), progress values)
def _scenarios(pkg):
    P = pkg["Preempted"]
    PF = pkg["PeerFailure"]
    two = iter([RuntimeError("boom 0"), RuntimeError("boom 1")])
    types = iter([OSError("storage flake"), RuntimeError("peer died")])
    mix = iter([RuntimeError("bad batch"), PF("peer"),
                RuntimeError("bad batch")])
    return {
        "recovers_then_returns": (3, 30.0, lambda i: (
            _raise(next(two)) if i < 2 else "done"), [3, 7]),
        "first_restart_immediate": (4, 0.6, lambda i: _raise(
            RuntimeError("x")), [1, 2, 3, 4, 5]),
        "deterministic_reraises": (10, 30.0, lambda i: _raise(
            RuntimeError("boom")), [5] * 5),
        "same_step_other_type": (5, 30.0, lambda i: (
            _raise(e) if (e := next(types, None)) is not None else "done"),
            [5] * 5),
        "peer_failure_never_deterministic": (3, 30.0, lambda i: _raise(
            PF("host 1 flapping")), [5] * 5),
        "peer_failure_transparent": (10, 30.0, lambda i: _raise(next(mix)),
                                     [5] * 5),
        "progress_none_twice": (10, 30.0, lambda i: _raise(
            RuntimeError("init")), [None] * 5),
        "bounded": (2, 0.3, lambda i: _raise(RuntimeError("x")),
                    [1, 2, 3, 4]),
        "preempted_passes": (5, 30.0, lambda i: _raise(P("p")), [1]),
    }


@pytest.mark.parametrize("name", list(_scenarios({
    "Preempted": Preempted, "PeerFailure": PeerFailure})))
def test_supervisor_decisions_equal_jax(name):
    """JAX ``tests/test_resilience.py::TestSupervisor``'s cases: the
    attempts made, the backoff sleeps, what is raised in the end and the
    coordinator's events."""
    outcomes = []
    for pkg, sup_cls in (({"Preempted": JPreempted,
                           "PeerFailure": JPeerFailure},
                          j_supervisor.Supervisor),
                         ({"Preempted": Preempted,
                           "PeerFailure": PeerFailure}, Supervisor)):
        max_restarts, cap, attempt, prog = _scenarios(pkg)[name]
        sleeps, calls, events = [], [], []
        sup = sup_cls(max_restarts=max_restarts, backoff_base=0.25,
                      backoff_cap=cap, sleep=sleeps.append,
                      log=lambda *_: None, coordinator=_Coord(events))
        it = iter(prog)

        def tracked(i, attempt=attempt):
            calls.append(i)
            return attempt(i)
        try:
            result = ("returned", sup.run(tracked, lambda: next(it)))
        except Exception as e:
            result = ("raised", type(e).__name__, str(e))
        outcomes.append((result, sleeps, calls, events))
    assert outcomes[1] == outcomes[0]


# -- the manager --------------------------------------------------------------


def _tiny_state(seed=0):
    cfg = TrainConfig(model="transformer", device="cpu", n_layers=1,
                      d_model=32, n_heads=2,
                      d_ff=64, seq_len=16, precision="fp32")
    model = cli.build_model(cfg, vocab_size=50, device="cpu")
    model.init_weights(torch.Generator().manual_seed(seed))
    from faster_distributed_training_tpu_torch.optim import build_optimizer
    from faster_distributed_training_tpu_torch.train.state import (
        create_train_state)
    tx, _ = build_optimizer(cfg, steps_per_epoch=4)
    return create_train_state(model, tx, seed=seed)


def _bump(state, step):
    """A stand-in for a train step: every leaf moves in place."""
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(0.01 * step)
        for t in state.opt_state["v"].values():
            t.add_(1.0)
    state.step = step
    state.opt_state["step"] = step


def _leaves(state):
    flat = {f"model/{k}": v.clone() for k, v in state.model.state_dict().items()}
    for k, v in state.opt_state["v"].items():
        flat[f"v/{k}"] = v.clone()
    flat["step"] = torch.tensor(state.step)
    flat["opt_step"] = torch.tensor(state.opt_state["step"])
    return flat


def _assert_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _run_saves(mgr, n, wait=True):
    state, snaps = _tiny_state(), {}
    for step in range(1, n + 1):
        _bump(state, step)
        if mgr.maybe_save(state, step, epoch=0, step_in_epoch=step):
            snaps[step] = _leaves(state)
            if wait:
                mgr.wait()
    mgr.wait()
    return state, snaps


def test_step_cadence_keep_and_bitwise_restore(tmp_path):
    """Saves every 2 steps, keep 2: steps 4 and 6 stay; the restore of the
    newest equals the state at step 6 bitwise (the snapshot was taken
    before the next step moved the live tensors)."""
    g = GoodputTracker().start()
    mgr = AsyncCheckpointManager(str(tmp_path), prefix="transformer",
                                 every_steps=2, keep=2, goodput=g,
                                 log=lambda *_: None)
    state, snaps = _run_saves(mgr, 7)
    assert mgr.committed_steps() == [4, 6]
    _bump(state, 99)
    restored, meta = mgr.restore_latest(state)
    assert meta["step"] == 6 and meta["step_in_epoch"] == 6
    _assert_equal(_leaves(restored), snaps[6])
    s = g.summary()
    assert s["saves"] == 3 and s["restores"] == 1
    mgr.close()


def test_clock_cadence(tmp_path):
    now = [0.0]
    mgr = AsyncCheckpointManager(str(tmp_path), every_secs=5.0,
                                 clock=lambda: now[0], log=lambda *_: None)
    assert not mgr.should_save(1)
    now[0] = 5.0
    assert mgr.should_save(2)


def test_inflight_save_skips_not_queues(tmp_path, monkeypatch):
    """A tick that finds the previous write running is counted as skipped
    and consumed, never queued (JAX ``test_inflight_save_skips_not_
    queues``): the writes are held until released."""
    import threading

    gate = threading.Event()
    real = ckpt.write_payload

    def slow(*a, **k):
        gate.wait(10)
        return real(*a, **k)
    monkeypatch.setattr(ckpt, "write_payload", slow)
    g = GoodputTracker().start()
    mgr = AsyncCheckpointManager(str(tmp_path), every_steps=1, goodput=g,
                                 log=lambda *_: None)
    state = _tiny_state()
    took = []
    for step in range(1, 5):
        _bump(state, step)
        took.append(mgr.maybe_save(state, step))
    gate.set()
    mgr.wait()
    s = g.summary()
    assert took == [True, False, False, False]
    assert s["saves"] == 1 and s["skipped_saves"] == 3
    assert mgr.committed_steps() == [1]
    mgr.close()


@pytest.mark.parametrize("mode", ["truncate", "unmark"])
def test_corrupt_newest_falls_back_to_the_previous(tmp_path, mode):
    mgr = AsyncCheckpointManager(str(tmp_path), prefix="transformer",
                                 every_steps=2, keep=3, log=lambda *_: None)
    state, snaps = _run_saves(mgr, 4)
    assert mgr.committed_steps() == [2, 4]
    hit = corrupt_newest_checkpoint(str(tmp_path), prefix="transformer",
                                    mode=mode)
    assert hit.endswith("transformer_step_000000004")
    restored, meta = mgr.restore_latest(state)
    assert meta["step"] == 2
    _assert_equal(_leaves(restored), snaps[2])
    mgr.close()


def test_sharded_form_on_the_fake_object_store(tmp_path, monkeypatch):
    """A backend without rename forces the sharded two-phase form: the
    blocks, the manifest, DONE, then COMMIT, with no rename issued; the
    restore reassembles the state bitwise; ``peek_latest`` reads it
    without the barriers."""
    def no_rename(*a, **k):
        raise AssertionError("a rename on the object store path")
    b = storage.FakeObjectStoreBackend(root=str(tmp_path))
    mgr = AsyncCheckpointManager(str(tmp_path), prefix="transformer",
                                 every_steps=2, backend=b,
                                 log=lambda *_: None)
    monkeypatch.setattr(os, "replace", no_rename)
    monkeypatch.setattr(os, "rename", no_rename)
    state, snaps = _run_saves(mgr, 4)
    assert mgr.committed_steps() == [2, 4]
    keys = sorted(k for k in b.medium.list()
                  if k.startswith("transformer_step_000000004"))
    assert keys == ["transformer_step_000000004/COMMIT",
                    "transformer_step_000000004/meta.json",
                    "transformer_step_000000004/shards/host_00000.DONE",
                    "transformer_step_000000004/shards/host_00000.json",
                    "transformer_step_000000004/shards/host_00000.pt"]
    _bump(state, 50)
    restored, meta = mgr.peek_latest(state)
    assert meta["step"] == 4
    _assert_equal(_leaves(restored), snaps[4])
    assert not os.listdir(tmp_path)      # nothing landed on the filesystem
    mgr.close()


def test_two_managers_commit_one_sharded_checkpoint(tmp_path):
    """An fs-simulated two-host pod: host 0 writes every block, host 1 an
    empty set, and only the commit after both DONE markers makes it
    restorable."""
    b = storage.PosixBackend()
    mk = lambda pi: AsyncCheckpointManager(  # noqa: E731
        str(tmp_path), prefix="transformer", every_steps=1, keep=3,
        process_index=pi, process_count=2, backend=b,
        shard_owner=(lambda key: pi == 0), log=lambda *_: None)
    m0, m1 = mk(0), mk(1)
    state = _tiny_state()
    _bump(state, 1)
    want = _leaves(state)
    m1.save(state, 1)
    m0.save(state, 1)
    m0.wait(), m1.wait()
    assert m0.committed_steps() == [1]
    path = os.path.join(str(tmp_path), "transformer_step_000000001",
                        "shards")
    assert json.load(open(os.path.join(path, "host_00001.json")))[
        "blocks"] == []
    fresh = _tiny_state(seed=1)
    restored, meta = ckpt.restore_checkpoint(
        str(tmp_path), "transformer_step_000000001", fresh)
    _assert_equal(_leaves(restored), want)
    m0.close(), m1.close()


def test_sigterm_only_sets_the_flag():
    with PreemptionHandler(log=lambda *_: None) as h:
        assert not h.seen() and not h.should_stop(1)
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5.0
        while not h.seen() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert h.seen() and h.should_stop(2)


def test_resilience_is_off_by_default_and_slices_raise(monkeypatch):
    assert build_resilience(TrainConfig(), log=lambda *_: None) is None
    monkeypatch.setenv("FDT_SLICE_COUNT", "2")
    with pytest.raises(NotImplementedError, match="FDT_SLICE_COUNT"):
        build_resilience(TrainConfig(), log=lambda *_: None)


# -- end to end ---------------------------------------------------------------

E2E = dict(model="transformer", dataset="synthetic", num_classes=4,
           batch_size=8, seq_len=32, n_layers=2, d_model=64, d_ff=128,
           n_heads=4, epochs=2, subset_stride=128, precision="fp32",
           plot=False, log_every=0, task="lm", dropout_impl="none",
           telemetry=False, prefetch_depth=0)


def _jcfg(tmp, **kw):
    # one device: the suite's virtual CPU devices would make a dp mesh
    # (and scale the learning rate by it)
    return JConfig(checkpoint_dir=str(tmp), donate=False, mesh_shape=(1,),
                   **dict(E2E, **kw))


def _pcfg(tmp, **kw):
    return TrainConfig(checkpoint_dir=str(tmp), device="cpu",
                       **dict(E2E, **kw))


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """JAX's initial parameters (its run_training at zero epochs) and the
    port's uninterrupted run from them (4 steps an epoch, 8 steps)."""
    root = tmp_path_factory.mktemp("e2e")
    j0 = jcli.run_training(_jcfg(root / "j0", epochs=0), log=lambda *_: None)
    params = jax.tree_util.tree_map(np.asarray, j0["state"].params)
    straight = cli.run_training(_pcfg(root / "straight"), params=params,
                                log=lambda *_: None)
    return {"params": params, "straight": straight}


def _model_leaves(out):
    return {k: v.clone() for k, v in out["state"].model.state_dict().items()}


def _compare_to_jax(port, jax_out):
    want = flatten(jax.tree_util.tree_map(
        np.asarray, jax_out["state"].params["model"]))
    got = flatten(params_to_jax(port["state"].model.state_dict(), 4))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(port["history"]["train_loss"],
                               jax_out["history"]["train_loss"], rtol=0,
                               atol=1e-5)


def _committed(tmp):
    return sorted(n for n in os.listdir(tmp) if n.startswith(
        "transformer_step_") and os.path.exists(os.path.join(tmp, n,
                                                             "COMMIT")))


def test_supervised_die_run_is_bitwise_and_matches_jax(e2e, tmp_path,
                                                       monkeypatch):
    """JAX ``test_killed_run_resumes_bitwise_equal``: killed after step 3,
    restored from step 2, the run ends bitwise the uninterrupted one, and
    JAX's same run ends within tolerance with the same counters and
    committed steps."""
    monkeypatch.setenv(faults.ENV_DIE, "3")
    kw = dict(supervise=True, checkpoint_every=2, checkpoint_async=False)
    jout = jcli.run_training(_jcfg(tmp_path / "jax", **kw),
                             log=lambda *_: None)
    logs = []
    got = cli.run_training(_pcfg(tmp_path / "port", **kw),
                           params=e2e["params"], log=logs.append)
    assert int(got["state"].step) == 8 and not got["preempted"]
    assert any("restored step-cadence checkpoint: step 2" in x for x in logs)
    a, b = _model_leaves(e2e["straight"]), _model_leaves(got)
    _assert_equal(a, b)
    _compare_to_jax(got, jout)
    for key in ("goodput_restarts", "goodput_saves", "goodput_restores",
                "goodput_steps"):
        assert got[key] == jout[key], key
    assert got["goodput_restarts"] == got["goodput_restores"] == 1
    assert _committed(tmp_path / "port") == _committed(tmp_path / "jax")


def test_sigterm_emergency_save_then_relaunch_bitwise(e2e, tmp_path,
                                                      monkeypatch):
    """JAX ``test_sigterm_emergency_save_then_resume``: SIGTERM after
    step 5 (the cadence is past the run): ``Preempted``, the emergency
    checkpoint at JAX's step, and the same command relaunched (no
    --resume) ends bitwise the uninterrupted run."""
    kw = dict(checkpoint_every=1000)
    monkeypatch.setenv(faults.ENV_SIGTERM, "5")
    jfirst = jcli.run_training(_jcfg(tmp_path / "jax", **kw),
                               log=lambda *_: None)
    first = cli.run_training(_pcfg(tmp_path / "port", **kw),
                             params=e2e["params"], log=lambda *_: None)
    monkeypatch.delenv(faults.ENV_SIGTERM)
    assert first["preempted"] and jfirst["preempted"]
    assert first["goodput_preemptions"] == 1
    assert int(first["state"].step) == int(jfirst["state"].step) == 5
    assert (_committed(tmp_path / "port") == _committed(tmp_path / "jax")
            == ["transformer_step_000000005"])
    second = cli.run_training(_pcfg(tmp_path / "port", **kw),
                              params=e2e["params"], log=lambda *_: None)
    assert not second["preempted"] and second["goodput_restores"] == 1
    assert int(second["state"].step) == 8
    _assert_equal(_model_leaves(e2e["straight"]), _model_leaves(second))


def test_relaunch_falls_back_past_a_corrupt_newest(e2e, tmp_path):
    """Saves at 2, 4, 6, 8; the step-8 file truncated: the relaunch
    restores step 6, replays 7 and 8, and ends bitwise the uninterrupted
    run."""
    kw = dict(checkpoint_every=2, checkpoint_async=False)
    cli.run_training(_pcfg(tmp_path, **kw), params=e2e["params"],
                     log=lambda *_: None)
    assert corrupt_newest_checkpoint(str(tmp_path), "transformer").endswith(
        "_step_000000008")
    logs = []
    again = cli.run_training(_pcfg(tmp_path, **kw), params=e2e["params"],
                             log=logs.append)
    assert any("failed to restore" in x for x in logs)
    assert any("restored step-cadence checkpoint: step 6" in x
               for x in logs)
    _assert_equal(_model_leaves(e2e["straight"]), _model_leaves(again))


def test_auto_recover_rolls_a_nan_epoch_back(e2e, tmp_path, monkeypatch):
    """``--auto_recover`` (JAX ``train/loop.py``'s rolling last-good
    snapshot): the NaN fault at step 5 poisons epoch 1, which rolls back
    to the snapshot after epoch 0 (step 4).  The fault compares the
    device step, so each retry re-poisons step 5, as in JAX: two
    recoveries over epochs 1 and 2, the state finite at step 4;
    ``--max_recoveries 1`` gives up at the second."""
    monkeypatch.setenv(faults.ENV_NAN, "5")
    logs = []
    out = cli.run_training(_pcfg(tmp_path / "a", epochs=3, auto_recover=True),
                           params=e2e["params"], log=logs.append)
    assert [x for x in logs if x.startswith("[recover]")] == [
        f"[recover] non-finite loss at epoch {e}; restored last-good state "
        f"from epoch 0, retrying" for e in (1, 2)]
    assert out["trainer"].recoveries == 2 and int(out["state"].step) == 4
    assert all(torch.isfinite(v).all()
               for v in out["state"].model.state_dict().values()
               if v.is_floating_point())
    with pytest.raises(RuntimeError, match="diverged 2 times in a row"):
        cli.run_training(_pcfg(tmp_path / "b", epochs=3, auto_recover=True,
                               max_recoveries=1),
                         params=e2e["params"], log=lambda *_: None)


def test_fsdp_sharded_commit_restores_at_dp1(tmp_path):
    """fsdp=2 over two gloo ranks writes the sharded form (each rank its
    slice of every sharded parameter and optimizer leaf, rank 0 the whole
    leaves and the commit); a one-process run restores it and
    finishes."""
    import torch_dist_worker as W

    ck = tmp_path / "ck"
    argv = ["--dataset", "synthetic", "--epoch", "1", "--device", "cpu",
            "--n_layers", "1", "--d_model", "32", "--n_heads", "2",
            "--d_ff", "64", "--seq_len", "32", "--subset_stride", "128",
            "--bs", "8", "--precision", "fp32", "--log_every", "0",
            "--no_telemetry", "--no_plot", "--checkpoint_every", "2",
            "--sync_checkpoint", "--checkpoint_dir", str(ck)]
    outs = W.launch("cli_argv", 2, str(tmp_path / "group"), timeout=240,
                    argv=argv + ["--fsdp"])
    assert [o["step"] for o in outs] == [4, 4]
    shards = ck / "transformer_step_000000004" / "shards"
    m0 = json.load(open(shards / "host_00000.json"))["blocks"]
    m1 = json.load(open(shards / "host_00001.json"))["blocks"]
    sliced = [b for b in m1 if b["region"] is not None]
    # fsdp: the parameters rest sliced too; rank 1 writes slices only
    assert {b["key"].split("/")[0] for b in sliced} == {"model", "opt_state"}
    assert all(b["region"] is not None for b in m1)
    assert len(m0) > len(m1)
    out = cli.main(argv + ["--epoch", "2"],
                   defaults=cli.TRANSFORMER_DEFAULTS)
    assert int(out["state"].step) == 8 and out["goodput_restores"] == 1


def test_tp_async_skip_is_taken_by_every_rank(tmp_path):
    """--mesh tp=2 over two gloo ranks writes the single file (rank 0,
    after the tp gather); with a write slower than a step, the cadence
    tick that finds it in flight is skipped on both ranks alike (JAX
    ``AsyncCheckpointManager.save``'s skip), where a rank that did not
    skip would enter the gather alone and hang the group."""
    import torch_dist_worker as W

    ck = tmp_path / "ck"
    argv = ["--dataset", "synthetic", "--epoch", "1", "--device", "cpu",
            "--n_layers", "1", "--d_model", "32", "--n_heads", "4",
            "--d_ff", "64", "--seq_len", "16", "--subset_stride", "128",
            "--bs", "8", "--precision", "fp32", "--log_every", "0",
            "--no_telemetry", "--no_plot", "--mesh", "tp=2",
            "--checkpoint_every", "1", "--checkpoint_dir", str(ck)]
    outs = W.launch("cli_argv", 2, str(tmp_path / "group"), timeout=120,
                    argv=argv, slow_write_s=1.0)
    assert [o["step"] for o in outs] == [4, 4]
    skipped = [o["goodput_skipped_saves"] for o in outs]
    assert skipped[0] == skipped[1] > 0
    assert outs[0]["goodput_saves"] >= 1
