"""Deterministic fault injection (the JAX package's
``resilience/faults.py``): faults armed through environment variables,
fired at exact host step or batch counters, never at random.

  * ``FDT_FAULT_DIE_AT_STEP=N``      — raise :class:`InjectedFault` after
    global step N (a crash the supervisor recovers);
  * ``FDT_FAULT_SIGTERM_AT_STEP=N``  — a real SIGTERM to this process
    after step N (the preemption handler and the emergency save, signal
    delivery included);
  * ``FDT_FAULT_DATA_AT_BATCH=K``    — raise from inside the data
    iterator at batch K of an epoch (``wrap_data``);
  * ``FDT_FAULT_HANG_AT_STEP=N``     — block forever at step N (a wedged
    kernel or a collective stuck on a dead peer): only the pod
    coordinator's step watchdog clears it;
  * ``FDT_FAULT_NAN_AT_STEP=N``      — multiply the loss the gradients
    are taken of by NaN where the DEVICE step counter equals N
    (:func:`graph_nan_at` -> ``train/steps.py``).  The comparison runs on
    the card, inside a captured K-step graph too, so a replay of step N
    re-poisons it every time: the sentinel's skip is what moves past it;
  * ``FDT_FAULT_LOSS_SPIKE_AT_STEP=N`` — multiply the loss the sentinel
    observes (not the device's) by 1e4 once at step >= N;
  * ``FDT_FAULT_CORRUPT_SHARD=S``    — overwrite bytes inside stream
    shard S of the train split at startup, size unchanged, so only its
    checksum catches it;
  * ``FDT_FAULT_HOST=P``             — scope every armed fault to the
    process with pod index P (``coordinator.pod_identity``);
  * ``FDT_FAULT_SLICE=S``            — the slice scope: slices are not
    ported yet, so it raises NotImplementedError naming itself.

Die, SIGTERM, data, hang and spike fire once a process, so the step a
supervisor restart replays succeeds.  ``corrupt_newest_checkpoint``
damages a committed step checkpoint for the fallback tests."""

from __future__ import annotations

import json
import os
import signal
import threading
from typing import Iterable, Iterator, Optional

ENV_DIE = "FDT_FAULT_DIE_AT_STEP"
ENV_SIGTERM = "FDT_FAULT_SIGTERM_AT_STEP"
ENV_DATA = "FDT_FAULT_DATA_AT_BATCH"
ENV_HANG = "FDT_FAULT_HANG_AT_STEP"
ENV_NAN = "FDT_FAULT_NAN_AT_STEP"
ENV_SPIKE = "FDT_FAULT_LOSS_SPIKE_AT_STEP"
ENV_CORRUPT = "FDT_FAULT_CORRUPT_SHARD"
ENV_HOST = "FDT_FAULT_HOST"
ENV_SLICE = "FDT_FAULT_SLICE"


class InjectedFault(RuntimeError):
    """A deliberately injected failure: a crash like any other, recovered
    by the same path."""


def _env_int(env, key: str) -> Optional[int]:
    raw = env.get(key)
    if raw in (None, ""):
        return None
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"malformed {key}={raw!r}: want an integer step")


class FaultPlan:
    def __init__(self, die_at: Optional[int] = None,
                 sigterm_at: Optional[int] = None,
                 data_at: Optional[int] = None,
                 hang_at: Optional[int] = None,
                 nan_at: Optional[int] = None,
                 spike_at: Optional[int] = None,
                 corrupt_shard: Optional[int] = None):
        self.die_at = die_at
        self.sigterm_at = sigterm_at
        self.data_at = data_at
        self.hang_at = hang_at
        self.nan_at = nan_at
        self.spike_at = spike_at
        self.corrupt_shard = corrupt_shard
        self._die_fired = False
        self._sigterm_fired = False
        self._data_fired = False
        self._hang_fired = False
        self._spike_fired = False
        # set by a test's watchdog abort so the process survives a hang;
        # in a run the watchdog kills the process instead
        self.hang_release = threading.Event()

    @classmethod
    def from_env(cls, env=os.environ,
                 process_index: Optional[int] = None
                 ) -> Optional["FaultPlan"]:
        """The armed plan, or None when no ``FDT_FAULT_*`` is set.  With
        ``FDT_FAULT_HOST`` only the process of that pod index gets it
        (``process_index`` defaults to ``coordinator.pod_identity``)."""
        if env.get(ENV_SLICE) not in (None, ""):
            raise NotImplementedError(
                f"not ported yet: {ENV_SLICE} (slice-granular recovery)")
        die = _env_int(env, ENV_DIE)
        sig = _env_int(env, ENV_SIGTERM)
        data = _env_int(env, ENV_DATA)
        hang = _env_int(env, ENV_HANG)
        nan = _env_int(env, ENV_NAN)
        spike = _env_int(env, ENV_SPIKE)
        corrupt = _env_int(env, ENV_CORRUPT)
        if all(v is None for v in (die, sig, data, hang, nan, spike,
                                   corrupt)):
            return None
        host = _env_int(env, ENV_HOST)
        if host is not None:
            if process_index is None:
                from faster_distributed_training_tpu_torch.resilience \
                    .coordinator import pod_identity
                process_index = pod_identity(env)[0]
            if int(process_index) != host:
                return None
        return cls(die_at=die, sigterm_at=sig, data_at=data, hang_at=hang,
                   nan_at=nan, spike_at=spike, corrupt_shard=corrupt)

    def on_step(self, step: int) -> None:
        """After each dispatch, at the global step it reached."""
        if (self.sigterm_at is not None and step >= self.sigterm_at
                and not self._sigterm_fired):
            self._sigterm_fired = True
            os.kill(os.getpid(), signal.SIGTERM)
        if (self.hang_at is not None and step >= self.hang_at
                and not self._hang_fired):
            self._hang_fired = True
            self.hang_release.wait()
        if (self.die_at is not None and step >= self.die_at
                and not self._die_fired):
            self._die_fired = True
            raise InjectedFault(f"injected crash at global step {step}")

    def perturb_loss(self, step: int, loss: float) -> float:
        """The spike arm: the loss the sentinel observes, x 1e4 once at
        step >= ``spike_at``."""
        if (self.spike_at is not None and step >= self.spike_at
                and not self._spike_fired):
            self._spike_fired = True
            return float(loss) * 1e4
        return loss

    def wrap_data(self, iterable: Iterable) -> Iterator:
        """The data arm: batches until index ``data_at``, then a raise
        from inside the iterator."""
        if self.data_at is None:
            yield from iterable
            return
        for i, item in enumerate(iterable):
            if i >= self.data_at and not self._data_fired:
                self._data_fired = True
                raise InjectedFault(
                    f"injected data-iterator failure at batch {i}")
            yield item


def graph_nan_at(env=os.environ) -> Optional[int]:
    """The ``FDT_FAULT_NAN_AT_STEP`` step for ``train/steps.py`` (read when
    the step is built, scoped by ``FDT_FAULT_HOST``), or None."""
    plan = FaultPlan.from_env(env)
    return plan.nan_at if plan is not None else None


def corrupt_stream_shard(split_dir: str, index: int = 0) -> Optional[str]:
    """Overwrite bytes in the middle of stream shard ``index``'s largest
    leaf file under ``split_dir`` (``data/stream/format.py``'s manifest),
    size unchanged: only the shard's checksum catches it.  A fixed
    pattern, so doing it twice is doing it once.  Returns the path, or
    None without a manifest."""
    mpath = os.path.join(split_dir, "manifest.json")
    if not os.path.isfile(mpath):
        return None
    with open(mpath) as f:
        manifest = json.load(f)
    shards = manifest.get("shards") or []
    if not 0 <= int(index) < len(shards):
        raise ValueError(f"{ENV_CORRUPT}={index}: split {split_dir} has "
                         f"{len(shards)} shard(s)")
    files = shards[int(index)]["files"]
    leaf = max(files, key=lambda k: int(files[k]["bytes"]))
    path = os.path.join(split_dir, files[leaf]["file"])
    size = os.path.getsize(path)
    pattern = b"\xde\xad\xbe\xef" * 16
    # past the .npy header, short of the end: data bytes
    off = min(max(size // 2, 128), max(size - len(pattern), 0))
    with open(path, "r+b") as f:
        f.seek(off)
        f.write(pattern[:max(size - off, 1)])
        f.flush()
        os.fsync(f.fileno())
    return path


def apply_corrupt_shard_fault(stream_dir: str, env=os.environ,
                              log=print) -> Optional[str]:
    """Fire ``FDT_FAULT_CORRUPT_SHARD`` (when armed for this process) on
    ``<stream_dir>/train``, before the dataset opens."""
    plan = FaultPlan.from_env(env)
    if plan is None or plan.corrupt_shard is None:
        return None
    path = corrupt_stream_shard(os.path.join(stream_dir, "train"),
                                plan.corrupt_shard)
    if path is not None:
        log(f"[faults] corrupted stream shard {plan.corrupt_shard}: {path}")
    return path


def corrupt_newest_checkpoint(directory: str, prefix: str = "ckpt",
                              mode: str = "truncate") -> Optional[str]:
    """Damage the newest committed ``<prefix>_step_*`` checkpoint under
    ``directory`` (the port's ``<name>/state.pt`` layout, or a sharded
    one's ``shards/``); returns its path, None when there is none.
    ``truncate`` halves the largest file (the COMMIT marker stays: the
    restore must fail and fall back); ``unmark`` deletes the COMMIT
    marker (a half-written checkpoint)."""
    from faster_distributed_training_tpu_torch.resilience.manager import (
        AsyncCheckpointManager)
    from faster_distributed_training_tpu_torch.train import checkpoint as ckpt

    mgr = AsyncCheckpointManager(directory, prefix=prefix,
                                 log=lambda *_: None)
    newest = mgr.latest_valid()
    if newest is None:
        return None
    path = os.path.join(directory, newest[1])
    if mode == "unmark":
        p = os.path.join(path, ckpt._COMMIT)
        if os.path.exists(p):
            os.remove(p)
        return path
    if mode != "truncate":
        raise ValueError(f"unknown corruption mode {mode!r}")
    largest, size = None, -1
    for root, _dirs, files in os.walk(path):
        for f in files:
            p = os.path.join(root, f)
            s = os.path.getsize(p)
            if s > size:
                largest, size = p, s
    if largest is None:
        raise RuntimeError(f"no data files under {path}")
    with open(largest, "r+b") as f:
        f.truncate(max(size // 2, 1))
    return path
