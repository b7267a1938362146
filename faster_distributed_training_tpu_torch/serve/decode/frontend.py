"""The decode front door: replicas as processes behind a socket RPC.

Port of ``faster_distributed_training_tpu/serve/decode/frontend.py``.
Each decode replica runs in an OS process of its own behind a localhost
TCP socket speaking length-framed JSON:

  frame   := 4-byte big-endian length || utf-8 JSON object
  request := {"op": "generate", "id": int, "tokens": [int],
              "max_new": int}
           | {"op": "ping"} | {"op": "stop"}
  reply   := {"id": int, "tokens": [int], "ttft_ms": float}
           | {"ok": 1, ...} | {"error": str}

Liveness: every worker touches an ``HB_<name>`` marker file from a
daemon thread, and the parent's :class:`ProcReplica` adds the marker's
age and the process's exit to the ``Replica.stale`` predicate the
``ReplicaSet`` watchdog polls.  A SIGKILLed or wedged worker is detached
like a wedged thread: its in-flight generations go to the survivors
(sampling is deterministic per (seed, request), so the retry returns the
same tokens), and re-admission respawns the process, which loads the
checkpoint and captures its graphs again.

The parent's control loop is :class:`GenScheduler`: the classifier
``BatchScheduler`` with cells of one request whose wire payload is the
work (token-granular batching happens inside each worker's
``DecodeScheduler``).  Dispatch, parking, the attempt budget and the
rescue from a detached replica are inherited.

Worker processes run on ``cfg.device``; several may share one card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from faster_distributed_training_tpu_torch.serve.queue import (GenRequest,
                                                               RequestQueue)
from faster_distributed_training_tpu_torch.serve.replicas import (Replica,
                                                                  ReplicaSet)
from faster_distributed_training_tpu_torch.serve.scheduler import (
    BatchScheduler)

_HB_PERIOD_S = 0.3


# -- wire protocol ---------------------------------------------------------

def send_msg(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode("utf-8")
    sock.sendall(struct.pack(">I", len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def recv_msg(sock: socket.socket) -> Optional[dict]:
    head = _recv_exact(sock, 4)
    if head is None:
        return None
    (length,) = struct.unpack(">I", head)
    body = _recv_exact(sock, length)
    if body is None:
        return None
    return json.loads(body.decode("utf-8"))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def load_cfg(path: str):
    """The TrainConfig back from the JSON the parent wrote (JSON turned
    its tuples into lists: they are turned back)."""
    from faster_distributed_training_tpu_torch.config import TrainConfig
    with open(path) as f:
        d = json.load(f)
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in d.items() if k in names}
    return TrainConfig(**kw)


# -- the worker process ----------------------------------------------------

def _touch_forever(path: str, stop: threading.Event) -> None:
    while not stop.is_set():
        try:
            with open(path, "w") as f:
                f.write(str(time.time()))
        except OSError:
            pass
        stop.wait(_HB_PERIOD_S)


def worker_main(argv: Optional[List[str]] = None) -> int:
    """One decode worker process: load the checkpoint onto
    ``cfg.device``, warm the engine (prefills and the decode graphs),
    then serve generate / ping frames until "stop"."""
    import argparse

    from faster_distributed_training_tpu_torch.cli import resolve_device
    from faster_distributed_training_tpu_torch.models.decode import (
        SamplingCfg)
    from faster_distributed_training_tpu_torch.serve.decode.engine import (
        DecodeEngine)
    from faster_distributed_training_tpu_torch.serve.decode.scheduler \
        import DecodeScheduler
    from faster_distributed_training_tpu_torch.serve.engine import (
        load_serving_state)
    from faster_distributed_training_tpu_torch.telemetry import (
        TelemetryRecorder, build_observatory, enabled, programs,
        resolve_telemetry_dir, spans, update_manifest)

    p = argparse.ArgumentParser(prog="fdt-decode-worker")
    p.add_argument("--cfg", required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--name", default="worker0")
    p.add_argument("--hb_dir", default="")
    args = p.parse_args(argv)
    cfg = load_cfg(args.cfg)
    name = args.name

    def log(m):
        print(f"[{name}] {m}", flush=True)

    hb_stop = threading.Event()
    if args.hb_dir:
        os.makedirs(args.hb_dir, exist_ok=True)
        threading.Thread(
            target=_touch_forever,
            args=(os.path.join(args.hb_dir, f"HB_{name}"), hb_stop),
            daemon=True).start()

    # the worker's own telemetry directory (the front door sets
    # telemetry_dir per worker): one file a process, and the worker's own
    # program table and executable cache
    recorder = obs = prev_obs = None
    if enabled(cfg):
        tdir = resolve_telemetry_dir(cfg)
        recorder = TelemetryRecorder(tdir, process_index=0, process_count=1,
                                     log=log)
        update_manifest(tdir, {"decode_worker": {
            "name": name, "port": args.port,
            "config": dataclasses.asdict(cfg)}}, log=log)
        spans.set_recorder(recorder)
        obs = build_observatory(cfg, recorder, log)
        prev_obs = programs.set_observatory(obs)
    model, _sstate, _meta = load_serving_state(
        cfg, resolve_device(cfg.device), log=log)
    q = RequestQueue(cfg.seq_buckets, max_len=cfg.seq_len)
    engine = DecodeEngine(
        model, q.buckets, batch_size=cfg.decode_batch_size,
        page=cfg.decode_page, max_pages=cfg.decode_max_pages,
        sampling=SamplingCfg(method=cfg.decode_sample,
                             temperature=cfg.decode_temperature,
                             top_k=cfg.decode_top_k, seed=cfg.seed),
        name=name)
    with spans.span("decode_warmup"):
        warm_s = engine.warmup()
    log(f"decode engine warmed in {warm_s:.2f}s on {engine.device} "
        f"({len(engine.buckets)} prefill bucket(s), {engine.captures} "
        f"decode graph(s))")
    sched = DecodeScheduler(q, engine, max_delay_ms=cfg.serve_max_delay_ms,
                            max_new_tokens=cfg.decode_max_new_tokens,
                            recorder=recorder, name=name)
    sched.start()

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", args.port))
    srv.listen(16)
    log(f"serving on 127.0.0.1:{args.port}")
    stopping = threading.Event()

    def handle(conn: socket.socket) -> None:
        try:
            while True:
                msg = recv_msg(conn)
                if msg is None:
                    return
                op = msg.get("op")
                if op == "ping":
                    send_msg(conn, {"ok": 1, "name": name})
                elif op == "stop":
                    send_msg(conn, {"ok": 1})
                    stopping.set()
                    return
                elif op == "generate":
                    try:
                        # the parent's request id keys the sampling
                        # stream, so a retry elsewhere returns the same
                        # tokens
                        req = q.submit(np.asarray(msg["tokens"], np.int32),
                                       max_new_tokens=int(msg["max_new"]),
                                       req_id=msg.get("id"))
                        out = req.wait(timeout=300.0)
                        send_msg(conn, {"id": msg.get("id"),
                                        "tokens": np.asarray(out).tolist(),
                                        "ttft_ms": req.ttft_ms()})
                    except BaseException as e:
                        send_msg(conn, {"id": msg.get("id"),
                                        "error": repr(e)})
                else:
                    send_msg(conn, {"error": f"unknown op {op!r}"})
        except OSError:
            pass
        finally:
            conn.close()

    srv.settimeout(0.2)
    try:
        while not stopping.is_set():
            try:
                conn, _addr = srv.accept()
            except socket.timeout:
                continue
            threading.Thread(target=handle, args=(conn,),
                             daemon=True).start()
    finally:
        srv.close()
        q.close()
        sched.close(drain_s=5.0)
        hb_stop.set()
        if recorder is not None:
            spans.set_recorder(None)
            if obs is not None:
                programs.set_observatory(prev_obs)
                update_manifest(recorder.directory,
                                {"decode_compile": obs.summary()}, log=log)
            recorder.close()
        log("worker stopped")
    return 0


# -- the parent side -------------------------------------------------------

class WorkerClient:
    """An engine-shaped socket client, ``predict_batch(payload) -> int32
    tokens``: one persistent connection, reconnected with a bounded retry
    (a respawned worker may still be warming: the retry window is the
    readiness budget).  A socket error mid-call raises; the Replica
    worker turns that into detach and re-dispatch."""

    def __init__(self, port: int, connect_timeout_s: float = 120.0,
                 call_timeout_s: float = 300.0):
        self.port = int(port)
        self.connect_timeout_s = float(connect_timeout_s)
        self.call_timeout_s = float(call_timeout_s)
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        deadline = time.monotonic() + self.connect_timeout_s
        last: Optional[BaseException] = None
        while time.monotonic() < deadline:
            try:
                s = socket.create_connection(("127.0.0.1", self.port),
                                             timeout=2.0)
                s.settimeout(self.call_timeout_s)
                return s
            except OSError as e:
                last = e
                time.sleep(0.2)
        raise ConnectionError(
            f"worker on port {self.port} not reachable within "
            f"{self.connect_timeout_s}s") from last

    def _call(self, msg: dict) -> dict:
        with self._lock:
            if self._sock is None:
                self._sock = self._connect()
            try:
                send_msg(self._sock, msg)
                reply = recv_msg(self._sock)
            except OSError:
                self.drop()
                raise
            if reply is None:
                self.drop()
                raise ConnectionError(
                    f"worker on port {self.port} closed the connection")
            return reply

    def drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def ping(self) -> dict:
        return self._call({"op": "ping"})

    def stop(self) -> None:
        try:
            self._call({"op": "stop"})
        except (OSError, ConnectionError):
            pass

    def predict_batch(self, payload: dict) -> np.ndarray:
        reply = self._call({"op": "generate", **payload})
        if "error" in reply:
            raise RuntimeError(f"worker generate failed: "
                               f"{reply['error']}")
        return np.asarray(reply["tokens"], np.int32)


class ProcReplica(Replica):
    """A Replica whose engine lives in another process.  ``start`` (the
    first admission and every re-admission) makes sure the process runs
    and answers its ping before the worker thread starts; ``stale`` adds
    the process's exit and a marker file that stopped moving."""

    def __init__(self, name: str, spawn: Callable[[], subprocess.Popen],
                 client: WorkerClient, hb_path: str,
                 marker_timeout_s: float = 5.0,
                 log: Callable[[str], None] = print):
        super().__init__(name, client, log=log)
        self._spawn = spawn
        self.client = client
        self.hb_path = hb_path
        self.marker_timeout_s = float(marker_timeout_s)
        self.proc: Optional[subprocess.Popen] = None
        self.respawns = 0

    def proc_alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def ensure_proc(self) -> None:
        if not self.proc_alive():
            if self.proc is not None:
                self.respawns += 1
            self.proc = self._spawn()

    def start(self) -> None:
        """Runs under the ReplicaSet's lock.  A readiness failure does
        not raise (the caller is the watchdog): the replica stays
        detached with a fresh ``detached_at``, and the auto re-admission
        timer tries again."""
        try:
            self.ensure_proc()
            self.client.drop()
            self.client.ping()      # blocks (bounded) until ready
        except (OSError, ConnectionError, RuntimeError) as e:
            self._log(f"[serve] replica {self.name} respawn not ready: "
                      f"{e!r}; will retry")
            self.alive = False
            self.detached_at = time.monotonic()
            return
        super().start()

    def stale(self, now: float, timeout_s: float) -> bool:
        if super().stale(now, timeout_s):
            return True
        if not self.alive:
            return False
        if not self.proc_alive():
            return True
        try:
            age = time.time() - os.path.getmtime(self.hb_path)
        except OSError:
            return False            # not written yet (still starting)
        return age > self.marker_timeout_s

    def kill(self) -> None:
        """The fault seam of smokes and tests: SIGKILL the worker."""
        if self.proc is not None:
            self.proc.kill()


class GenScheduler(BatchScheduler):
    """BatchScheduler at slot granularity: cells of ONE request, the wire
    payload as the work's batch, the generated tokens as its result."""

    def __init__(self, queue: RequestQueue, replicas: ReplicaSet,
                 max_delay_ms: float = 20.0,
                 request_deadline_s: Optional[float] = None,
                 log: Callable[[str], None] = print):
        super().__init__(queue, replicas, batch_size=1,
                         max_delay_ms=max_delay_ms,
                         request_deadline_s=request_deadline_s, log=log)

    def summary(self) -> dict:
        """The front door's counters under their decode names: a
        generation re-dispatched because its worker died or failed is a
        decode_request_retry; one past its deadline a
        decode_request_timeout."""
        out = super().summary()
        out["decode_request_retries"] = out.pop("request_retries", 0)
        out["decode_request_timeouts"] = out.pop("request_timeouts", 0)
        return out

    def _assemble(self, bucket: int, requests):
        req = requests[0]
        if not isinstance(req, GenRequest):
            raise TypeError("the decode front door serves GenRequests "
                            "(queue.submit(tokens, max_new_tokens=...))")
        return {"id": req.id, "tokens": np.asarray(req.tokens).tolist(),
                "max_new": req.max_new}, 1

    def _on_done(self, work, tokens: np.ndarray, replica) -> None:
        now = time.monotonic()
        req = work.requests[0]
        req.fulfill(np.asarray(tokens, np.int32), replica.name, now)
        with self._lock:
            self.completed_batches += 1
            self.completed_requests += 1
            self.latencies_ms.append(req.latency_ms())
            t0 = req.t_submit
            self._t_first = t0 if self._t_first is None \
                else min(self._t_first, t0)
            self._t_last = now if self._t_last is None \
                else max(self._t_last, now)


class FrontDoor:
    """The parent's assembly: N worker processes, a queue and a
    GenScheduler.  ``cfg`` is the serving TrainConfig (its
    ``checkpoint_dir`` holds the ``.npz`` to serve); each worker logs to
    ``<run_dir>/<name>.log`` and records its telemetry in its own
    directory (``telemetry_dir=<run_dir>/telemetry_<name>``: one file a
    process, JAX ``frontend.py:497``)."""

    def __init__(self, cfg, n_workers: int = 2, run_dir: str = "",
                 heartbeat_timeout_s: float = 60.0,
                 marker_timeout_s: float = 5.0,
                 readmit_after_s: float = 1.0,
                 log: Callable[[str], None] = print):
        self.cfg = cfg
        self.run_dir = run_dir or os.path.join(cfg.checkpoint_dir,
                                               "frontdoor")
        os.makedirs(self.run_dir, exist_ok=True)
        self._log = log
        self.queue = RequestQueue(cfg.seq_buckets, max_len=cfg.seq_len)
        self.replicas: List[ProcReplica] = []
        hb_dir = os.path.join(self.run_dir, "hb")
        # the repository root on the child's PYTHONPATH: `-m` resolves
        # from sys.path, and the parent may run from any directory
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        env = dict(os.environ)
        env["PYTHONPATH"] = pkg_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        for i in range(int(n_workers)):
            name = f"decode{i}"
            port = free_port()
            cfg_path = os.path.join(self.run_dir, f"cfg_{name}.json")
            worker_cfg = cfg.replace(telemetry_dir=os.path.join(
                self.run_dir, f"telemetry_{name}"))
            with open(cfg_path, "w") as f:
                json.dump(dataclasses.asdict(worker_cfg), f)
            cmd = (sys.executable, "-m",
                   "faster_distributed_training_tpu_torch.serve.decode"
                   ".worker", "--cfg", cfg_path, "--port", str(port),
                   "--name", name, "--hb_dir", hb_dir)
            log_path = os.path.join(self.run_dir, f"{name}.log")

            def spawn(_cmd=cmd, _log=log_path) -> subprocess.Popen:
                # a log file of its own, not the parent's stdout: a child
                # never holds a parent-side pipe open
                logf = open(_log, "ab")
                try:
                    return subprocess.Popen(list(_cmd), stdout=logf,
                                            stderr=subprocess.STDOUT,
                                            env=env)
                finally:
                    logf.close()

            self.replicas.append(ProcReplica(
                name, spawn, WorkerClient(port),
                hb_path=os.path.join(hb_dir, f"HB_{name}"),
                marker_timeout_s=marker_timeout_s, log=log))
        self.rset = ReplicaSet(self.replicas,
                               heartbeat_timeout_s=heartbeat_timeout_s,
                               readmit_after_s=readmit_after_s, log=log)
        self.sched = GenScheduler(
            self.queue, self.rset, max_delay_ms=cfg.serve_max_delay_ms,
            request_deadline_s=float(cfg.decode_deadline_s or 0.0) or None,
            log=log)

    def start(self) -> None:
        # every process first, so their warmups overlap; each start()
        # then blocks on its own readiness ping
        for r in self.replicas:
            r.ensure_proc()
        self.sched.start()

    def submit(self, tokens, max_new: int) -> GenRequest:
        req = self.queue.submit(tokens, max_new_tokens=max_new)
        assert isinstance(req, GenRequest)
        return req

    def close(self) -> None:
        """Drain, stop every worker, and kill any that outlive 5 s."""
        self.sched.close()
        for r in self.replicas:
            if r.proc_alive():
                r.client.stop()
        deadline = time.monotonic() + 5.0
        for r in self.replicas:
            if r.proc is None:
                continue
            while r.proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if r.proc.poll() is None:
                r.proc.kill()
                r.proc.wait()
