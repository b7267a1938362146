"""Pod-coordinated restarts and the health watchdog (the whole-pod part
of the JAX package's ``resilience/coordinator.py``).

A crash on one host leaves its peers blocked in the next collective,
where nothing can observe that the peer died.  Two pieces, both on the
shared checkpoint storage (the one medium every host reaches without a
working collective), close that gap:

  * the restart protocol (:class:`PodCoordinator`): a generation
    directory ``_pod/gen_<g>/``.  A host that fails writes ``FAIL_<pi>``
    there; every host polls the markers (``check``, at the preemption
    cadence), abandons its attempt with :class:`PeerFailure` and re-enters
    the supervisor, whose next attempt computes the same generation on
    every host (1 + the newest generation holding a FAIL marker).  The
    restore then agrees on one checkpoint step across the hosts
    (``gather_restored_step`` on an fs-simulated pod);
  * the watchdog: a thread writes ``HB_<pi>`` with the step every
    ``hb_interval_s``; ``check`` calls a peer whose heartbeat is older
    than ``peer_timeout_s`` dead; and inside ``watch_steps`` a step that
    makes no progress for ``step_timeout_s`` is escalated by the thread:
    it writes this host's FAIL marker (kind ``hang``) and kills the
    process (SIGKILL: the main thread may be stuck inside a CUDA or gloo
    call where nothing softer is sure to run).

Detection and restore times feed the goodput tracker (``detect_s``,
``restore_s``, ``restart_backoff_s`` -> ``restart_mttr_s``).  Marker names
and JSON keys are the JAX package's, so a port host and a JAX host can
share one ``_pod`` directory.

``pod_identity`` reads ``FDT_POD_INDEX`` / ``FDT_POD_COUNT`` (an
fs-simulated pod: each process trains the whole state alone, only the
restart coordination and the checkpoint commit run across processes),
else the torch.distributed rank and world.  Slices
(``FDT_SLICE_COUNT`` > 1, elastic re-admission) and warm spares
(``FDT_SLICE_SPARE``) are not ported yet and raise NotImplementedError."""

from __future__ import annotations

import contextlib
import os
import re
import signal
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from faster_distributed_training_tpu_torch.resilience import storage as storage_mod
from faster_distributed_training_tpu_torch.telemetry import spans

ENV_POD_INDEX = "FDT_POD_INDEX"
ENV_POD_COUNT = "FDT_POD_COUNT"
ENV_SLICE_COUNT = "FDT_SLICE_COUNT"
ENV_SLICE_SPARE = "FDT_SLICE_SPARE"

_GEN_DIR = re.compile(r"^gen_(?P<gen>\d{6})$")
# strict: the atomic writer stages `FAIL_<pi>.tmp<pid>` beside a marker
_FAIL = re.compile(r"^FAIL_(?P<pi>\d{5})$")


class PeerFailure(RuntimeError):
    """A peer failed (FAIL marker) or went heartbeat-stale: this attempt
    is abandoned so the pod restarts together.  Restartable."""


class StepTimeout(RuntimeError):
    """This host's own step made no progress for ``step_timeout_s`` and
    the watchdog escalated.  Raised by ``check`` when an intercepted
    abort let the hang go (tests); in a run the abort kills the
    process first."""


def refuse_unported(env=os.environ) -> None:
    """The slice and spare seams the port has not reached raise, naming
    themselves."""
    raw = env.get(ENV_SLICE_COUNT)
    if raw not in (None, "") and int(raw) > 1:
        raise NotImplementedError(
            f"not ported yet: {ENV_SLICE_COUNT}={raw} (slice-granular "
            f"elastic re-admission)")
    if env.get(ENV_SLICE_SPARE) not in (None, ""):
        raise NotImplementedError(
            f"not ported yet: {ENV_SLICE_SPARE} (warm spares)")


def pod_identity(env=os.environ) -> Tuple[int, int, bool]:
    """(process_index, process_count, simulated): ``FDT_POD_INDEX`` /
    ``FDT_POD_COUNT`` when set (simulated), else the torch.distributed
    rank and world (1 process without a group)."""
    refuse_unported(env)
    if env.get(ENV_POD_COUNT):
        return (int(env.get(ENV_POD_INDEX, "0")), int(env[ENV_POD_COUNT]),
                True)
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), False
    return 0, 1, False


class PodCoordinator:
    """Owns ``<directory>/gen_<g>/`` and this host's markers in it.

    The supervisor calls :meth:`begin_attempt` before every attempt (the
    heartbeat thread starts on the first) and :meth:`record_failure` when
    one dies; the loop calls :meth:`check` once a dispatch and arms the
    step watchdog with :meth:`watch_steps` around an epoch's dispatches
    (never eval or restore) and suspends it with :meth:`pause_watch`
    around a blocking save.  ``abort_fn`` is the escalation seam (default
    SIGKILL); tests pass one that releases the hang."""

    def __init__(self, directory: str, process_index: Optional[int] = None,
                 process_count: Optional[int] = None, sync_every: int = 8,
                 peer_timeout_s: float = 60.0, step_timeout_s: float = 0.0,
                 hb_interval_s: float = 2.0, gather_timeout_s: float = 120.0,
                 goodput=None, log: Callable[[str], None] = print,
                 abort_fn: Optional[Callable[[str], None]] = None,
                 backend: Optional[storage_mod.StorageBackend] = None):
        if process_index is None or process_count is None:
            pi, pc, _sim = pod_identity()
            process_index = pi if process_index is None else process_index
            process_count = pc if process_count is None else process_count
        self.directory = os.path.abspath(directory)
        self.pi = int(process_index)
        self.pc = int(process_count)
        self.backend = backend if backend is not None \
            else storage_mod.posix_backend()
        self.sync_every = max(int(sync_every), 1)
        self.peer_timeout_s = float(peer_timeout_s)
        self.step_timeout_s = float(step_timeout_s)
        self.hb_interval_s = float(hb_interval_s)
        self.gather_timeout_s = float(gather_timeout_s)
        self._goodput = goodput
        self._log = log
        self._abort = abort_fn or self._default_abort
        # EXIT markers older than this coordinator are a previous run's
        self._created_t = time.time()
        self._gen: Optional[int] = None
        self._gen_dir: Optional[str] = None
        self._attempt_wall_t = time.time()
        self._last_polled = -1
        # shared with the watchdog thread, which only reads them
        self._step = 0
        self._progress_t = time.monotonic()
        self._watching = False
        self._escalated = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- marker paths ------------------------------------------------------

    def _gen_path(self, gen: int) -> str:
        return os.path.join(self.directory, f"gen_{gen:06d}")

    @staticmethod
    def _marker_name(kind: str, pi: int) -> str:
        return f"{kind}_{pi:05d}"

    def _marker(self, kind: str, pi: int, gen_dir: Optional[str] = None
                ) -> str:
        return os.path.join(gen_dir or self._require_gen(),
                            self._marker_name(kind, pi))

    def _require_gen(self) -> str:
        if self._gen_dir is None:
            self.begin_attempt()
        return self._gen_dir

    @property
    def generation(self) -> Optional[int]:
        return self._gen

    def _generations(self) -> List[Tuple[int, str]]:
        gens = set()
        for name in self.backend.list_entries(self.directory):
            m = _GEN_DIR.match(name)
            if m:
                gens.add(int(m.group("gen")))
        return [(g, self._gen_path(g)) for g in sorted(gens)]

    def _failures(self, gen_dir: str) -> Dict[int, dict]:
        out = {}
        for n in self.backend.list_entries(gen_dir):
            m = _FAIL.match(n)
            if m:
                out[int(m.group("pi"))] = self.backend.read_json(
                    os.path.join(gen_dir, n)) or {}
        return out

    # -- the restart protocol ----------------------------------------------

    def begin_attempt(self) -> int:
        """Enter the pod's current generation: 1 + the newest generation
        holding a FAIL marker (0 on a clean directory), never below the
        one this host is in.  Every host computes it from the same
        storage, so hosts that restarted for different reasons converge
        on one generation."""
        g = 0
        for gen, d in self._generations():
            if self._failures(d):
                g = gen + 1
        if self._gen is not None:
            if g > self._gen and self._goodput is not None:
                self._goodput.count("restart_generations", g - self._gen)
            g = max(g, self._gen)
        changed = g != self._gen
        self._gen = g
        self._gen_dir = self._gen_path(g)
        self.backend.ensure_dir(self._gen_dir)
        # an attempting host is not done: drop our completion marker
        self.backend.delete(
            os.path.join(self.directory, self._marker_name("EXIT", self.pi)))
        self._attempt_wall_t = time.time()
        self._last_polled = -1
        self._escalated = False
        self._progress_t = time.monotonic()
        self._write_heartbeat()
        if changed:
            self._log(f"[pod] host {self.pi}/{self.pc} entering generation "
                      f"{g}")
        self._ensure_thread()
        self._prune_generations()
        return g

    def record_failure(self, exc: BaseException,
                       step: Optional[int] = None) -> None:
        """Publish this host's failure durably (best effort: a failing
        storage must not mask the original exception)."""
        kind = ("hang" if isinstance(exc, StepTimeout)
                else "peer" if isinstance(exc, PeerFailure) else "crash")
        try:
            self._write_fail(kind, f"{type(exc).__name__}: {exc}", step)
        except OSError as e:
            self._log(f"[pod] host {self.pi}: could not write FAIL marker "
                      f"({e!r}) — peers will detect via heartbeat staleness")

    def record_completion(self, step: Optional[int] = None) -> None:
        """``EXIT_<pi>`` at the directory's root: this host finished the
        run.  The staleness check ignores an exited peer, and a restore
        barrier waiting for one fails fast."""
        try:
            self.backend.put_json(
                os.path.join(self.directory,
                             self._marker_name("EXIT", self.pi)),
                {"step": self._step if step is None else int(step),
                 "unix_time": round(time.time(), 3)})
        except OSError as e:
            self._log(f"[pod] host {self.pi}: could not write EXIT marker "
                      f"({e!r}) — a later-restarting peer will wait out "
                      f"its restore barrier instead of failing fast")

    def _exited_peers(self) -> List[int]:
        """Peers that completed this run (EXIT markers newer than this
        coordinator)."""
        out = []
        for pi in range(self.pc):
            if pi == self.pi:
                continue
            got = self.backend.read_json(
                os.path.join(self.directory, self._marker_name("EXIT", pi)))
            if got is not None and got.get("unix_time", 0.0) > self._created_t:
                out.append(pi)
        return out

    def _write_fail(self, kind: str, reason: str,
                    step: Optional[int] = None) -> None:
        self.backend.put_json(self._marker("FAIL", self.pi), {
            "kind": kind, "reason": reason[:500],
            "step": self._step if step is None else int(step),
            "unix_time": round(time.time(), 3)})

    def check(self, step: int) -> None:
        """Main-thread poll, once a dispatch: feeds the step clock and, when
        the step crossed a ``sync_every`` boundary since the last poll (or
        right after a local escalation), raises :class:`PeerFailure` /
        :class:`StepTimeout` for a failed or stale peer / our own hang."""
        self._step = int(step)
        self._progress_t = time.monotonic()
        prev, self._last_polled = self._last_polled, step
        if not self._escalated and prev >= 0 \
                and step // self.sync_every <= prev // self.sync_every:
            return
        self._raise_observed_failures()

    def _raise_observed_failures(self) -> None:
        gen_dir = self._require_gen()
        fails = self._failures(gen_dir)
        now = time.time()
        own = fails.pop(self.pi, None)
        if fails:
            peers = sorted(fails)
            newest = max((f.get("unix_time", now) for f in fails.values()),
                         default=now)
            detect = max(now - newest, 0.0)
            if self._goodput is not None:
                self._goodput.count("peer_failures")
                self._goodput.add("detect_s", detect)
            raise PeerFailure(
                f"host(s) {peers} failed in generation {self._gen} "
                f"({fails[peers[0]].get('kind', '?')}: "
                f"{fails[peers[0]].get('reason', '?')}); abandoning this "
                f"attempt so the pod restarts together "
                f"(observed {detect:.2f}s after the marker landed)")
        if own is not None:
            raise StepTimeout(
                f"host {self.pi}: step watchdog escalated "
                f"({own.get('reason', 'no step progress')}); restarting")
        stale = self._stale_peers(now)
        if stale:
            _pi0, age = stale[0]
            if self._goodput is not None:
                self._goodput.count("peer_failures")
                # a silent death is seen no faster than the staleness
                # threshold: the whole silence is the detection latency
                self._goodput.add("detect_s", age)
            raise PeerFailure(
                f"host(s) {[p for p, _ in stale]} heartbeat-stale "
                f"(oldest {age:.1f}s > peer_timeout_s="
                f"{self.peer_timeout_s:.0f}) in generation {self._gen} — "
                f"treating as dead and restarting the pod")

    def _stale_peers(self, now: float) -> List[Tuple[int, float]]:
        """[(peer, silence)] past the timeout; a missing heartbeat ages
        from this attempt's start."""
        if self.pc <= 1 or self.peer_timeout_s <= 0:
            return []
        gen_dir = self._require_gen()
        exited = set(self._exited_peers())
        out = []
        for pi in range(self.pc):
            if pi == self.pi or pi in exited:
                continue
            try:
                t = self.backend.mtime(self._marker("HB", pi, gen_dir))
            except OSError:
                t = self._attempt_wall_t
            age = now - t
            if age > self.peer_timeout_s:
                out.append((pi, age))
        return out

    def gather_restored_step(self, step: int,
                             phase: str = "agree") -> np.ndarray:
        """Every host's restored step (-1: none), through marker files: the
        restore's agreement barrier on an fs-simulated pod, where each
        host is one process alone.  Every host blocks until all joined; a
        FAIL marker, an exited peer or ``gather_timeout_s`` raises
        :class:`PeerFailure`.  ``phase`` names the barrier (``enter``
        before the walk: ``RENTER_<pi>``; ``agree`` after it:
        ``RESTORE_<pi>``)."""
        with spans.span("rendezvous"):
            return self._gather_restored_step(step, phase)

    def _gather_restored_step(self, step: int, phase: str) -> np.ndarray:
        gen_dir = self._require_gen()
        kind = "RESTORE" if phase == "agree" else f"R{phase.upper()}"
        self.backend.put_json(self._marker(kind, self.pi), {"step": int(step)})
        deadline = time.monotonic() + self.gather_timeout_s
        while True:
            vals = []
            for pi in range(self.pc):
                got = self.backend.read_json(self._marker(kind, pi, gen_dir))
                if got is None:
                    break
                vals.append(got["step"])
            else:
                return np.asarray(vals, np.int32)
            fails = {p for p in self._failures(gen_dir) if p != self.pi}
            if fails:
                raise PeerFailure(
                    f"host(s) {sorted(fails)} failed while this host was "
                    f"waiting in the restore-agreement barrier "
                    f"(generation {self._gen})")
            done = [p for p in self._exited_peers()
                    if self.backend.read_json(
                        self._marker(kind, p, gen_dir)) is None]
            if done:
                raise PeerFailure(
                    f"host(s) {done} already completed the run (EXIT "
                    f"marker) and can never join the generation "
                    f"{self._gen} restore barrier")
            if time.monotonic() > deadline:
                raise PeerFailure(
                    f"restore-agreement barrier timed out after "
                    f"{self.gather_timeout_s:.0f}s in generation "
                    f"{self._gen}: {self.pc - len(vals)} host(s) never "
                    f"joined")
            time.sleep(0.05)

    # -- the watchdog ------------------------------------------------------

    @contextlib.contextmanager
    def watch_steps(self):
        """Arm the no-progress escalation around an epoch's dispatches
        (heartbeats run regardless).  ``step_timeout_s`` must exceed the
        longest legitimate dispatch: the first one builds the kernels and
        captures the graph."""
        self._progress_t = time.monotonic()
        self._watching = True
        try:
            yield
        finally:
            self._watching = False

    @contextlib.contextmanager
    def pause_watch(self):
        """Suspend the escalation around blocking work on the step
        thread (a save that drains a previous write, the emergency
        save); the step clock restarts fresh after it."""
        was = self._watching
        self._watching = False
        try:
            yield
        finally:
            self._progress_t = time.monotonic()
            self._watching = was

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._watchdog_body, name=f"fdt-pod-wd-{self.pi}",
                daemon=True)
            self._thread.start()

    def _watchdog_body(self) -> None:
        while not self._stop.wait(self.hb_interval_s):
            try:
                self._write_heartbeat()
            except OSError:
                pass
            if (self._watching and not self._escalated
                    and self.step_timeout_s > 0
                    and time.monotonic() - self._progress_t
                    > self.step_timeout_s):
                self._escalate_hang()

    def _write_heartbeat(self) -> None:
        if self._gen_dir is None:
            return
        self.backend.put_json(self._marker("HB", self.pi),
                              {"step": self._step,
                               "unix_time": round(time.time(), 3)})

    def _escalate_hang(self) -> None:
        """On the watchdog thread: the main thread made no step progress
        for ``step_timeout_s``.  The FAIL marker first (the peers restart
        even if the abort is instant), then the abort."""
        self._escalated = True
        stuck = time.monotonic() - self._progress_t
        reason = (f"no step progress for {stuck:.1f}s "
                  f"(> step_timeout_s={self.step_timeout_s:.0f}) "
                  f"at step {self._step}")
        try:
            self._write_fail("hang", reason)
        except OSError:
            pass
        if self._goodput is not None:
            self._goodput.count("step_timeouts")
        self._log(f"[pod] host {self.pi}: WATCHDOG: {reason}; FAIL marker "
                  f"written, aborting so the pod converges on a restart")
        self._abort(reason)

    @staticmethod
    def _default_abort(reason: str) -> None:
        # SIGKILL: the main thread may be inside a CUDA or gloo call
        # holding locks that interpreter teardown would deadlock on
        os.kill(os.getpid(), signal.SIGKILL)

    # -- housekeeping ------------------------------------------------------

    def _prune_generations(self, keep: int = 3) -> None:
        """Host 0 removes all but the newest ``keep`` generations."""
        if self.pi != 0 or self._gen is None:
            return
        for gen, d in self._generations():
            if gen <= self._gen - keep:
                self.backend.delete_prefix(d)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.hb_interval_s + 5.0)
            self._thread = None
