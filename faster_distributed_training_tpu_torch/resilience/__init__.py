"""Resilience for training (the JAX package's ``resilience/``): the
asynchronous, cadence-driven checkpoint manager on a storage backend
(``manager``, ``storage``), preemption (``preemption``), the supervisor's
bounded restarts (``supervisor``), fault injection (``faults``), goodput
accounting (``goodput``), the anomaly sentinel (``sentinel``) and the pod
coordinator's whole-pod restart and watchdog (``coordinator``).

``Resilience`` bundles them for the Trainer; ``build_resilience`` builds
the bundle from a TrainConfig.  ``executable_cache`` holds the built
kernel libraries for a fresh host (``ExecutableCache``,
``build_executable_cache``; the program table carries it).
Slice-granular re-admission and warm spares are not ported yet: their
seams raise NotImplementedError naming themselves."""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional


class Preempted(Exception):
    """Raised by the train loop after the agreed preemption decision and
    its emergency save: a clean stop, not a failure (the supervisor
    re-raises it; the platform owns the restart).  Carries the state."""

    def __init__(self, message: str, state=None, step: Optional[int] = None):
        super().__init__(message)
        self.state = state
        self.step = step


# storage first: train/checkpoint.py imports it, and the manager imports
# train/checkpoint.py
from faster_distributed_training_tpu_torch.resilience import storage  # noqa: E402,F401,E501
from faster_distributed_training_tpu_torch.resilience.storage import (  # noqa: E402,F401,E501
    FakeObjectStoreBackend, PosixBackend, StorageBackend, build_backend)
from faster_distributed_training_tpu_torch.resilience.goodput import (  # noqa: E402,F401,E501
    GoodputTracker)
from faster_distributed_training_tpu_torch.resilience.sentinel import (  # noqa: E402,F401,E501
    LossSpike, QuarantineLedger, Sentinel, SpikeDetector, host_finite)
from faster_distributed_training_tpu_torch.resilience.coordinator import (  # noqa: E402,F401,E501
    PeerFailure, PodCoordinator, StepTimeout, pod_identity)
from faster_distributed_training_tpu_torch.resilience.manager import (  # noqa: E402,F401,E501
    AsyncCheckpointManager, RestoreDivergence)
from faster_distributed_training_tpu_torch.resilience.preemption import (  # noqa: E402,F401,E501
    PreemptionHandler)
from faster_distributed_training_tpu_torch.resilience.supervisor import (  # noqa: E402,F401,E501
    Supervisor)
from faster_distributed_training_tpu_torch.resilience.faults import (  # noqa: E402,F401,E501
    FaultPlan, InjectedFault, corrupt_newest_checkpoint)
from faster_distributed_training_tpu_torch.resilience.executable_cache import (  # noqa: E402,F401,E501
    ExecutableCache, build_executable_cache)


@dataclasses.dataclass
class Resilience:
    """What the Trainer consumes (``train/loop.py``); any piece may be
    None, ``goodput`` always exists.  ``pod_*``: the identity the bundle
    was built for (on an fs-simulated pod only host 0 writes the shared
    epoch checkpoint: every host computes the same whole state)."""

    manager: Optional[AsyncCheckpointManager] = None
    preemption: Optional[PreemptionHandler] = None
    faults: Optional[FaultPlan] = None
    goodput: GoodputTracker = dataclasses.field(default_factory=GoodputTracker)
    coordinator: Optional[PodCoordinator] = None
    pod_index: int = 0
    pod_count: int = 1
    pod_simulated: bool = False
    sentinel: Optional[Sentinel] = None
    # the storage backend of every durable write (the flight dump's too)
    backend: Optional[StorageBackend] = None

    def close(self) -> None:
        if self.manager is not None:
            self.manager.close()
        if self.preemption is not None:
            self.preemption.uninstall()
        if self.coordinator is not None:
            self.coordinator.close()


def _sim_shard_owner(pi: int):
    """An fs-simulated pod's block owners: host 0 writes every block,
    the others none (each host holds the same whole state; the commit
    still waits for every host's DONE)."""
    if pi == 0:
        return lambda key: True
    return lambda key: False


def build_resilience(cfg, log: Callable[[str], None] = print,
                     clock: Optional[Callable[[], float]] = None
                     ) -> Optional[Resilience]:
    """The bundle for ``cfg``, or None when every knob is off (the loop
    then does no new work).  On with a checkpoint cadence
    (``--checkpoint_every`` / ``--checkpoint_every_secs``: the manager and
    the preemption handler), ``--supervise``, an armed ``FDT_FAULT_*``
    plan or ``--sentinel guard|full``.  With ``--supervise`` on a pod
    (several processes, or the ``FDT_POD_INDEX`` / ``FDT_POD_COUNT``
    simulation), or when ``--step_timeout_s`` arms the hang watchdog,
    the bundle grows a ``PodCoordinator`` under ``<checkpoint_dir>/_pod``.
    ``--storage_backend`` picks the medium of every durable write.
    ``clock``: the manager's cadence clock."""
    import time

    pi, pc, simulated = pod_identity()
    faults = FaultPlan.from_env(process_index=pi)
    cadence = bool(cfg.checkpoint_every or cfg.checkpoint_every_secs)
    step_timeout = float(cfg.step_timeout_s or 0.0)
    sentinel_mode = str(cfg.sentinel or "none")
    if sentinel_mode not in ("none", "guard", "full"):
        raise ValueError(f"--sentinel must be none, guard or full, got "
                         f"{sentinel_mode!r}")
    if step_timeout > 0 and not cfg.supervise:
        log("[resilience] WARNING: --step_timeout_s has no effect without "
            "--supervise — the hang watchdog lives on the pod coordinator, "
            "which only the supervised path builds; a wedged dispatch "
            "will block forever")
    if not (cadence or cfg.supervise or faults is not None
            or sentinel_mode != "none"):
        return None
    backend = build_backend(cfg.storage_backend, cfg.checkpoint_dir, log=log)
    goodput = GoodputTracker()
    peer_timeout = float(cfg.peer_timeout_s)
    coordinator = None
    if cfg.supervise and (pc > 1 or step_timeout > 0):
        coordinator = PodCoordinator(
            os.path.join(cfg.checkpoint_dir, "_pod"),
            process_index=pi, process_count=pc,
            sync_every=cfg.preempt_sync_every,
            peer_timeout_s=peer_timeout, step_timeout_s=step_timeout,
            backend=backend, goodput=goodput, log=log)
    # the commit barrier gives up after O(peer detection) when a
    # coordinator watches the peers, else after 600 s
    commit_timeout = float(cfg.commit_timeout_s or 0.0)
    if commit_timeout <= 0:
        commit_timeout = (max(2.0 * peer_timeout, 10.0)
                          if coordinator is not None and pc > 1 else 600.0)
    elif coordinator is not None and pc > 1 and commit_timeout < peer_timeout:
        log(f"[resilience] WARNING: --commit_timeout_s "
            f"{commit_timeout:.0f} is below --peer_timeout_s "
            f"{peer_timeout:.0f} — the commit barrier gives up on a "
            f"slow-but-live peer before the watchdog could even call it "
            f"dead (inverted ordering: expect spurious counted "
            f"save_failures)")
    manager = None
    if cadence:
        kw = {"commit_timeout_s": commit_timeout}
        if simulated and pc > 1:
            kw.update(process_index=pi, process_count=pc,
                      shard_owner=_sim_shard_owner(pi))
            if coordinator is not None:
                kw["step_gather_fn"] = coordinator.gather_restored_step
        manager = AsyncCheckpointManager(
            cfg.checkpoint_dir,
            prefix="transformer" if cfg.model == "transformer" else "resnet",
            every_steps=cfg.checkpoint_every,
            every_secs=cfg.checkpoint_every_secs, keep=cfg.checkpoint_keep,
            async_save=cfg.checkpoint_async, backend=backend,
            goodput=goodput, log=log, clock=clock or time.monotonic, **kw)
    preemption = PreemptionHandler(sync_every=cfg.preempt_sync_every,
                                   log=log).install()
    sentinel = None
    if sentinel_mode != "none":
        if sentinel_mode == "full" and not (cfg.supervise and cadence):
            log("[resilience] WARNING: --sentinel full without --supervise "
                "+ --checkpoint_every: a detected loss spike quarantines "
                "its batches durably but the run then ABORTS instead of "
                "rolling back in-process (the next start replays with the "
                "quarantine applied); add --supervise and a checkpoint "
                "cadence for automatic rollback-and-skip")
        sentinel = Sentinel(sentinel_mode, backend=backend, goodput=goodput,
                            window=int(cfg.spike_window),
                            threshold=float(cfg.spike_threshold),
                            log=log, root=cfg.checkpoint_dir)
    return Resilience(manager=manager, preemption=preemption,
                      faults=faults, goodput=goodput,
                      coordinator=coordinator, pod_index=pi, pod_count=pc,
                      pod_simulated=simulated, sentinel=sentinel,
                      backend=backend)
