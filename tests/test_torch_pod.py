"""The port's pod coordinator (``resilience/coordinator.py``, the
whole-pod part) against the JAX package's.

  * two port coordinators on one directory converge on one generation
    after a failure, and the marker names and JSON keys equal those two
    JAX coordinators leave in the same sequence;
  * a port coordinator and a JAX coordinator share one ``_pod`` directory
    as hosts 0 and 1: each sees the other's failure, both enter the same
    generations, and their restore-agreement barrier returns the same
    steps on both;
  * a two-process fs-simulated pod (``FDT_POD_INDEX`` / ``FDT_POD_COUNT``)
    training the tiny Transformer: a die on host 1 (``FDT_FAULT_HOST=1``)
    restarts both hosts into generation 1, restored at one step, and they
    end with equal states; a hang on host 1 under ``--step_timeout_s`` is
    escalated by its watchdog (FAIL marker of kind ``hang``, SIGKILL) and
    host 0 restarts on it.

Every subprocess runs under its own timeout.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from faster_distributed_training_tpu.resilience import coordinator as j_coord
from faster_distributed_training_tpu_torch.resilience import coordinator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _markers(gen_dir):
    """name -> sorted JSON keys of every marker in a generation dir."""
    out = {}
    for n in sorted(os.listdir(gen_dir)):
        with open(os.path.join(gen_dir, n)) as f:
            out[n] = sorted(json.load(f))
    return out


def _pair(mod, root, **kw):
    return [mod.PodCoordinator(str(root), process_index=pi, process_count=2,
                               sync_every=1, peer_timeout_s=60.0,
                               hb_interval_s=60.0, log=lambda *_: None, **kw)
            for pi in (0, 1)]


def _converge(mod, root):
    """begin, a failure on host 1 seen by host 0, begin again."""
    c0, c1 = _pair(mod, root)
    gens = [c0.begin_attempt(), c1.begin_attempt()]
    c0.check(1)
    c1.record_failure(RuntimeError("boom"), step=3)
    try:
        c0.check(2)
        seen = None
    except mod.PeerFailure as e:
        seen = str(e).split(" (")[0]
    marks = _markers(os.path.join(str(root), "gen_000000"))
    gens += [c1.begin_attempt(), c0.begin_attempt()]
    marks1 = _markers(os.path.join(str(root), "gen_000001"))
    c0.record_completion(step=8)
    with open(os.path.join(str(root), "EXIT_00000")) as f:
        exit_keys = sorted(json.load(f))
    c0.close(), c1.close()
    return gens, seen, marks, marks1, exit_keys


def test_two_coordinators_converge_like_jax(tmp_path):
    got = _converge(coordinator, tmp_path / "port")
    want = _converge(j_coord, tmp_path / "jax")
    assert got == want
    gens, seen, marks, marks1, _ = got
    assert gens == [0, 0, 1, 1]
    assert seen == "host(s) [1] failed in generation 0"
    assert marks == {"FAIL_00001": ["kind", "reason", "step", "unix_time"],
                     "HB_00000": ["step", "unix_time"],
                     "HB_00001": ["step", "unix_time"]}


def test_port_and_jax_hosts_share_one_pod_directory(tmp_path):
    root = str(tmp_path / "_pod")
    kw = dict(process_count=2, sync_every=1, peer_timeout_s=60.0,
              hb_interval_s=60.0, gather_timeout_s=20.0, log=lambda *_: None)
    port = coordinator.PodCoordinator(root, process_index=0, **kw)
    jaxh = j_coord.PodCoordinator(root, process_index=1, **kw)
    assert (port.begin_attempt(), jaxh.begin_attempt()) == (0, 0)
    jaxh.record_failure(RuntimeError("jax host died"), step=5)
    with pytest.raises(coordinator.PeerFailure, match=r"host\(s\) \[1\]"):
        port.check(5)
    assert (port.begin_attempt(), jaxh.begin_attempt()) == (1, 1)
    port.record_failure(RuntimeError("port host died"), step=7)
    with pytest.raises(j_coord.PeerFailure, match=r"host\(s\) \[0\]"):
        jaxh.check(7)
    assert (jaxh.begin_attempt(), port.begin_attempt()) == (2, 2)
    # the restore barrier: both enter, both see both steps
    out = {}
    # a daemon: a barrier that never returns fails this test, and cannot
    # keep the worker process from exiting
    t = threading.Thread(target=lambda: out.setdefault(
        "jax", jaxh.gather_restored_step(6, phase="agree").tolist()),
        daemon=True)
    t.start()
    out["port"] = port.gather_restored_step(6, phase="agree").tolist()
    t.join(30)
    assert not t.is_alive(), "the JAX host's restore barrier hung past 30 s"
    assert out == {"port": [6, 6], "jax": [6, 6]}
    port.close(), jaxh.close()


def test_stale_heartbeat_is_a_peer_failure(tmp_path):
    c0, _c1 = _pair(coordinator, tmp_path)
    c0.peer_timeout_s = 0.2
    c0.begin_attempt()
    time.sleep(0.4)
    with pytest.raises(coordinator.PeerFailure, match="heartbeat-stale"):
        c0.check(1)
    c0.close()


def test_local_hang_escalates_through_the_watchdog(tmp_path):
    """The watchdog thread writes this host's FAIL marker (kind hang) and
    calls the abort; with the abort intercepted, the next check raises
    ``StepTimeout``."""
    aborted = threading.Event()
    c = coordinator.PodCoordinator(
        str(tmp_path), process_index=0, process_count=1, step_timeout_s=0.3,
        hb_interval_s=0.1, log=lambda *_: None,
        abort_fn=lambda reason: aborted.set())
    c.begin_attempt()
    with c.watch_steps():
        assert aborted.wait(5.0)
    with open(tmp_path / "gen_000000" / "FAIL_00000") as f:
        assert json.load(f)["kind"] == "hang"
    with pytest.raises(coordinator.StepTimeout):
        c.check(1)
    c.close()


# -- a two-process fs-simulated pod -------------------------------------------

HOST = r"""
import hashlib, json, sys
import torch
from faster_distributed_training_tpu_torch import cli
out = cli.main(sys.argv[1:], defaults=cli.TRANSFORMER_DEFAULTS)
res = out["resilience"]
h = hashlib.sha256()
for k, v in sorted(out["state"].model.state_dict().items()):
    h.update(k.encode()); h.update(v.detach().cpu().numpy().tobytes())
print("RESULT " + json.dumps({
    "step": int(out["state"].step), "digest": h.hexdigest(),
    "generation": res.coordinator.generation,
    "restarts": out["goodput_restarts"],
    "restores": out["goodput_restores"]}), flush=True)
"""

ARGV = ["--dataset", "synthetic", "--epoch", "2", "--device", "cpu",
        "--n_layers", "1", "--d_model", "32", "--n_heads", "2",
        "--d_ff", "64", "--seq_len", "32", "--subset_stride", "128",
        "--bs", "8", "--precision", "fp32", "--log_every", "0",
        "--no_telemetry", "--no_plot", "--supervise",
        "--checkpoint_every", "2", "--preempt_sync_every", "1",
        "--peer_timeout_s", "20", "--commit_timeout_s", "5"]


def _host(pi, ckpt, extra_env=None, argv=()):
    env = dict(os.environ, FDT_POD_INDEX=str(pi), FDT_POD_COUNT="2",
               PYTHONPATH=REPO, OMP_NUM_THREADS="1", **(extra_env or {}))
    env.pop("JAX_PLATFORMS", None)
    return subprocess.Popen(
        [sys.executable, "-c", HOST] + ARGV + ["--checkpoint_dir", str(ckpt)]
        + list(argv), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _result(proc, timeout):
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    lines = [x for x in out.splitlines() if x.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, out[-4000:]
    return json.loads(lines[-1][len("RESULT "):]), out


def test_die_on_host_1_restarts_the_pod_into_generation_1(tmp_path):
    env = {"FDT_FAULT_HOST": "1", "FDT_FAULT_DIE_AT_STEP": "3"}
    procs = [_host(pi, tmp_path, env) for pi in (0, 1)]
    (r0, log0), (r1, log1) = [_result(p, 150) for p in procs]
    assert r0["step"] == r1["step"] == 8
    assert r0["generation"] == r1["generation"] == 1
    assert r0["digest"] == r1["digest"]
    assert r1["restarts"] == 1 and r0["restarts"] == 1
    assert "InjectedFault" in log1 and "PeerFailure" in log0
    for log in (log0, log1):
        assert "entering generation 1" in log
    fail = json.load(open(tmp_path / "_pod" / "gen_000000" / "FAIL_00001"))
    assert fail["kind"] == "crash"


def test_hang_on_host_1_is_escalated_by_its_watchdog(tmp_path):
    env = {"FDT_FAULT_HOST": "1", "FDT_FAULT_HANG_AT_STEP": "3"}
    # 24 steps: host 0 is still training when host 1's marker lands
    argv = ["--step_timeout_s", "4", "--epoch", "6"]
    procs = [_host(pi, tmp_path, env, argv) for pi in (0, 1)]
    try:
        procs[1].wait(timeout=120)
        assert procs[1].returncode == -signal.SIGKILL
        fail = json.load(open(tmp_path / "_pod" / "gen_000000" /
                              "FAIL_00001"))
        assert fail["kind"] == "hang" and "no step progress" in fail["reason"]
        # host 0 sees the marker and abandons its attempt
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not os.path.exists(
                tmp_path / "_pod" / "gen_000000" / "FAIL_00000"):
            time.sleep(0.2)
        peer = json.load(open(tmp_path / "_pod" / "gen_000000" /
                              "FAIL_00000"))
        assert peer["kind"] == "peer"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()
