"""The cadence-driven, asynchronous checkpoint manager (the JAX package's
``resilience/manager.py``), on the port's ``train/checkpoint.py``.

  * when: every ``every_steps`` steps (crossing a multiple, so a K-step
    dispatch's boundaries count) and/or every ``every_secs`` of wall
    clock, whichever comes first.  Across processes (torch.distributed)
    rank 0's clock decides for every rank, as the port's loop always
    did: a save is collective and the ranks' clocks differ.  On an
    fs-simulated pod (one process a host, no collective) the clock
    cadence is off, as in the JAX package;
  * off the critical path: a blocking snapshot (every leaf copied to
    host buffers, pinned on a card, and the copies finished before
    ``maybe_save`` returns: the next step updates the live tensors in
    place, a captured graph's among them), then the serialization and
    the commit on one background worker.  A cadence tick that finds the
    previous save still writing is skipped and counted, never queued, so
    the host buffers are reused only once the write that read them is
    done; across processes every rank skips alike (the writer's bit,
    MAXed over the group);
  * retention: the newest ``keep`` committed checkpoints stay; older
    ones, and uncommitted residue older than the newest committed, go;
  * restore: ``restore_latest`` walks the committed checkpoints newest
    first and falls past one that fails to load; the hosts of a pod then
    agree on the step they restored (``RestoreDivergence`` otherwise).

The form: one process on posix writes the single file (``state.pt``;
under a mesh with tp, the gathered state, written by rank 0); several
processes, or a storage backend without rename, write the sharded
two-phase form (``checkpoint.shard_blocks`` / ``write_host_shards`` /
``commit_sharded_checkpoint``), whose tick drains the previous write
rather than skipping (a skip would depend on each host's write time and
starve the commit barrier).  Checkpoints are the series
``<prefix>_step`` of ``train/checkpoint.py`` (``<prefix>_step_<step:09d>``),
listed and walked by its functions."""

from __future__ import annotations

import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from faster_distributed_training_tpu_torch.resilience import storage as storage_mod
from faster_distributed_training_tpu_torch.telemetry import spans
from faster_distributed_training_tpu_torch.train import checkpoint as ckpt


class RestoreDivergence(RuntimeError):
    """The hosts of a pod restored different checkpoint steps."""


def _world() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class HostBuffers:
    """Host copies of a snapshot's tensors, by key, reused across saves
    (pinned for card tensors).  ``copy`` enqueues every copy, then waits
    for the card once."""

    def __init__(self):
        self._bufs: Dict[str, torch.Tensor] = {}

    def _buf(self, key: str, t: torch.Tensor) -> torch.Tensor:
        buf = self._bufs.get(key)
        if (buf is None or buf.shape != t.shape or buf.dtype != t.dtype
                or buf.stride() != t.stride()):
            buf = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                      device="cpu", pin_memory=t.is_cuda)
            self._bufs[key] = buf
        return buf

    def copy(self, tree: Any, prefix: str = "") -> Any:
        cuda = []
        out = self._copy(tree, prefix, cuda)
        for dev in set(cuda):
            torch.cuda.current_stream(dev).synchronize()
        return out

    def _copy(self, tree: Any, key: str, cuda: list) -> Any:
        if torch.is_tensor(tree):
            t = tree.detach()
            buf = self._buf(key, t)
            buf.copy_(t, non_blocking=t.is_cuda)
            if t.is_cuda:
                cuda.append(t.device)
            return buf
        if isinstance(tree, dict):
            return {k: self._copy(v, f"{key}/{k}", cuda)
                    for k, v in tree.items()}
        return tree

    @property
    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self._bufs.values())


class AsyncCheckpointManager:
    """Owns ``<directory>/<prefix>_step_<N>``.  ``process_index`` /
    ``process_count`` default to the torch.distributed rank and world;
    with an fs-simulated pod they are the pod identity, ``shard_owner``
    picks the blocks this host writes and ``step_gather_fn`` is the
    coordinator's restore barrier.  ``force_sharded`` takes the sharded
    form in one process.  ``clock``: the wall clock of the cadence."""

    def __init__(self, directory: str, prefix: str = "ckpt",
                 every_steps: int = 0, every_secs: float = 0.0,
                 keep: int = 3, async_save: bool = True,
                 goodput=None, log: Callable[[str], None] = print,
                 force_sharded: bool = False,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 shard_owner: Optional[Callable[[str], bool]] = None,
                 commit_timeout_s: float = 600.0,
                 step_gather_fn: Optional[Callable] = None,
                 backend: Optional[storage_mod.StorageBackend] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.directory = os.path.abspath(directory)
        self.prefix = prefix
        self._series = f"{prefix}_step"
        self.every_steps = int(every_steps)
        self.every_secs = float(every_secs)
        rank, world = _world()
        self._pi = rank if process_index is None else int(process_index)
        self._pc = world if process_count is None else int(process_count)
        # several processes with one group between them (rank 0's clock
        # is shared) or not (an fs-simulated pod: no clock cadence)
        self._group_world = world
        self.backend = backend if backend is not None \
            else storage_mod.posix_backend()
        self._force_sharded = (bool(force_sharded)
                               or self.backend.kind != "posix")
        self._shard_owner = shard_owner
        self._commit_timeout_s = float(commit_timeout_s)
        self._step_gather_fn = step_gather_fn
        self._clock = clock
        if self.every_secs and self._pc > 1 and world == 1:
            self.every_secs = 0.0
            if self._pi == 0:
                log("[ckpt] --checkpoint_every_secs needs one clock for the "
                    "pod; the hosts of an fs-simulated pod share none: "
                    "disabled — use the step cadence (--checkpoint_every)")
        self.keep = max(int(keep), 1)
        self.async_save = bool(async_save)
        self._goodput = goodput
        self._log = log if self._pi == 0 else (lambda *_: None)
        self._last_save_t = clock()
        self._last_save_step: Optional[int] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._inflight: Optional[Future] = None
        self._inflight_path: Optional[str] = None
        self._skip_logged = False
        self.buffers = HostBuffers()
        # for reports: (step, seconds) of every blocking snapshot, the
        # bytes the last one copied, the last background commit's seconds
        self.snapshots: List[Tuple[int, float]] = []
        self.last_snapshot_bytes = 0
        self.last_commit_s: Optional[float] = None
        self.backend.ensure_dir(self.directory)

    # -- cadence ----------------------------------------------------------

    def _clock_due(self) -> bool:
        due = self._clock() - self._last_save_t >= self.every_secs
        if self._group_world > 1:
            from faster_distributed_training_tpu_torch.parallel.collectives \
                import all_gather_across_processes
            due = bool(all_gather_across_processes(np.int8(due))[0])
        return due

    def should_save(self, step: int) -> bool:
        """The step term fires when ``step`` crossed a multiple of
        ``every_steps`` since the last save (a K-step dispatch's
        boundaries included); the clock term when ``every_secs`` passed
        (rank 0's clock, under a group).  Every rank returns the same."""
        if step <= 0 or step == self._last_save_step:
            return False
        if self.every_steps:
            anchor = self._last_save_step or 0
            if anchor > step:
                # the step moved back (an auto-recover rollback): the
                # replay is checkpointable at once
                anchor = 0
            if step // self.every_steps > anchor // self.every_steps:
                return True
        if self.every_secs:
            return self._clock_due()
        return False

    # -- saving -----------------------------------------------------------

    def maybe_save(self, state, step: int, epoch: int = 0,
                   step_in_epoch: int = 0, best_acc: float = 0.0) -> bool:
        if not self.should_save(step):
            return False
        return self.save(state, step, epoch=epoch,
                         step_in_epoch=step_in_epoch, best_acc=best_acc)

    def _sharded(self, state) -> bool:
        """The sharded form for this save: a backend without rename, or
        several processes (one with a tp layout gathers into the single
        file: its head cut has no block form yet)."""
        pl = getattr(state, "placement", None)
        tp = pl is not None and pl.tp is not None
        if self._force_sharded:
            if tp:
                raise NotImplementedError(
                    "not ported yet: a sharded checkpoint (a storage backend "
                    "other than posix) of a --mesh tp layout")
            return True
        return self._pc > 1 and not tp

    def save(self, state, step: int, epoch: int = 0, step_in_epoch: int = 0,
             best_acc: float = 0.0, sync: bool = False,
             segment: str = "checkpoint_blocking_s") -> bool:
        """Checkpoint ``state`` at ``step``.  Asynchronous unless ``sync``
        (the emergency save) or ``async_save`` is off: then it waits for
        any write in flight and returns once committed."""
        meta = {"step": int(step), "epoch": int(epoch),
                "step_in_epoch": int(step_in_epoch),
                "best_acc": float(best_acc)}
        name = self._name(step)
        path = os.path.join(self.directory, name)
        if not (self.async_save or sync):
            sync = True
        if self._sharded(state):
            ok = self._save_sharded(state, step, meta, path, segment)
            if sync:
                self._drain_inflight()
            return ok
        if sync:
            self._drain_inflight()
            t0 = time.monotonic()
            with spans.span("ckpt_sync_save", step=step):
                with ckpt._whole(state):
                    if ckpt.is_writer(state):
                        ckpt.write_payload(path, ckpt._to_cpu(
                            ckpt.state_payload(state)), meta)
                if state.placement is not None:
                    state.placement.barrier()
            if ckpt.is_writer(state):
                self._prune()
            self._record_save(step, time.monotonic() - t0, segment)
            if self._goodput and ckpt.is_writer(state):
                self._goodput.count("saves")
            return True
        if self._busy():
            if self._goodput:
                self._goodput.count("skipped_saves")
            # consume the tick: the crossing rule would fire every step
            # while the write runs
            self._last_save_step = step
            if not self._skip_logged:
                self._skip_logged = True
                self._log(f"[ckpt] step {step}: previous async save still "
                          f"in flight; skipping cadence ticks until it "
                          f"commits")
            return False
        self._finalize_inflight()
        t0 = time.monotonic()
        writer = ckpt.is_writer(state)
        with spans.span("ckpt_snapshot", step=step):
            with ckpt._whole(state):
                snapshot = (self.buffers.copy(ckpt.state_payload(state), "p")
                            if writer else None)
        blocking = time.monotonic() - t0
        self.snapshots.append((step, blocking))
        self.last_snapshot_bytes = self.buffers.nbytes
        if writer:
            self._submit(path, self._write_payload_bg, path, snapshot, meta,
                         step)
        self._record_save(step, blocking, segment)
        return True

    def _busy(self) -> bool:
        """Whether a write is in flight, decided for every rank of the
        group alike: only the writer has one, and a rank that did not
        skip would enter the gather of ``_whole`` alone."""
        busy = self._inflight is not None and not self._inflight.done()
        if self._group_world > 1:
            from faster_distributed_training_tpu_torch.parallel.collectives \
                import all_gather_across_processes
            busy = bool(all_gather_across_processes(np.int8(busy)).max())
        return busy

    def _submit(self, path: str, fn, *args) -> None:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="fdt-ckpt")
        self._inflight_path = path
        self._skip_logged = False
        self._inflight = self._pool.submit(fn, *args)

    def _write_payload_bg(self, path: str, payload: dict, meta: dict,
                          step: int) -> None:
        t0 = time.monotonic()
        with spans.span("ckpt_commit", step=step):
            ckpt.write_payload(path, payload, meta)
        self.last_commit_s = time.monotonic() - t0

    def _save_sharded(self, state, step: int, meta: dict, path: str,
                      segment: str) -> bool:
        """Drain the previous write (every host takes every tick), copy
        this process's blocks to host, then write them and (process 0)
        commit in the background."""
        t0 = time.monotonic()
        if self._inflight is not None and not self._inflight.done():
            self._log(f"[ckpt] step {step}: waiting for the previous "
                      f"sharded save to finish (slow writer) — the tick "
                      f"is taken on every host to keep the pod's commit "
                      f"barrier aligned")
        self._drain_inflight()
        with spans.span("ckpt_snapshot", step=step):
            blocks, scalars = ckpt.shard_blocks(state, self._shard_owner)
            host = self.buffers.copy({f"b{i}": t for i, (_k, _r, _w, t)
                                      in enumerate(blocks)}, "s")
            blocks = [(k, r, w, host[f"b{i}"])
                      for i, (k, r, w, _t) in enumerate(blocks)]
        blocking = time.monotonic() - t0
        self.snapshots.append((step, blocking))
        self.last_snapshot_bytes = self.buffers.nbytes
        self._submit(path, self._write_shards_and_commit, path, blocks,
                     scalars, meta)
        self._record_save(step, blocking, segment)
        return True

    def _write_shards_and_commit(self, path: str, blocks: list,
                                 scalars: dict, meta: dict) -> None:
        t0 = time.monotonic()
        with spans.span("ckpt_commit", step=meta.get("step")):
            ckpt.write_host_shards(path, self._pi, blocks, scalars,
                                   backend=self.backend)
            if self._pi == 0:
                ckpt.commit_sharded_checkpoint(
                    path, meta, n_hosts=self._pc,
                    timeout_s=self._commit_timeout_s, backend=self.backend)
        self.last_commit_s = time.monotonic() - t0

    def _record_save(self, step: int, blocking_s: float,
                     segment: str = "checkpoint_blocking_s") -> None:
        """The cadence anchors and the blocking seconds (into ``segment``:
        the emergency save bills ``emergency_save_s``), at initiation;
        ``saves`` counts commits only."""
        self._last_save_t = self._clock()
        self._last_save_step = step
        if self._goodput:
            self._goodput.add(segment, blocking_s)

    def _name(self, step: int) -> str:
        return ckpt.series_name(self._series, step)

    def _finalize_inflight(self) -> None:
        """Reap a finished background save: its error is logged and
        counted (training goes on), a success counted and pruned."""
        fut, self._inflight = self._inflight, None
        self._inflight_path = None
        if fut is None:
            return
        try:
            fut.result()
        except Exception as e:
            if self._goodput:
                self._goodput.count("save_failures")
            self._log(f"[ckpt] background save failed: {e!r} — training "
                      f"continues; the previous checkpoint remains newest")
            return
        if self._goodput:
            self._goodput.count("shard_writes" if self._pi != 0 else "saves")
        self._prune()

    def _drain_inflight(self) -> None:
        if self._inflight is not None:
            try:
                self._inflight.result()
            except Exception:
                pass
            self._finalize_inflight()

    def wait(self) -> None:
        """Block until no save is in flight."""
        self._drain_inflight()

    def close(self) -> None:
        self._drain_inflight()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # -- discovery / restore ----------------------------------------------

    def _entries(self) -> List[Tuple[int, str]]:
        """(step, name) of every entry of the series, committed or not."""
        return ckpt.series_members(self.directory, self._series,
                                   committed=False, backend=self.backend)

    def _committed(self, name: str) -> bool:
        return ckpt.is_committed(os.path.join(self.directory, name),
                                 backend=self.backend)

    def _committed_entries(self) -> List[Tuple[int, str]]:
        return ckpt.series_members(self.directory, self._series,
                                   backend=self.backend)

    def committed_steps(self) -> List[int]:
        return [s for s, _n in self._committed_entries()]

    def latest_valid(self) -> Optional[Tuple[int, str]]:
        """The newest committed (step, name)."""
        committed = self._committed_entries()
        return committed[-1] if committed else None

    def restore_latest(self, state, newer_than: int = -1
                       ) -> Optional[Tuple[Any, dict]]:
        """(state, meta) from the newest checkpoint after step
        ``newer_than`` that is committed AND loads (a corrupt newest
        falls back to the previous one, ``checkpoint.restore_newest``),
        copied into the live ``state``; None when nothing restores.
        Every host joins the rendezvous before the walk and the step
        agreement after it."""
        with spans.span("restore"):
            return self._restore_latest(state, newer_than)

    def peek_latest(self, state) -> Optional[Tuple[Any, dict]]:
        """The same walk without the barriers, the residue sweep, the
        cadence anchor or goodput (a read-only look)."""
        got = ckpt.restore_newest(self.directory, self._series, state,
                                  backend=self.backend, log=self._log)
        return None if got is None else got[:2]

    def _restore_latest(self, state, newer_than: int
                        ) -> Optional[Tuple[Any, dict]]:
        self._drain_inflight()
        # no host walks before every host drained its write: the newest
        # COMMIT is then the same in every walk
        self._gather(0, "enter")
        t0 = time.monotonic()
        got = ckpt.restore_newest(self.directory, self._series, state,
                                  backend=self.backend,
                                  newer_than=newer_than, log=self._log)
        result, restored_step = (None, -1) if got is None else (got[:2],
                                                                got[2])
        if self._pi == 0:
            # uncommitted residue (a crashed sharded save's DONE markers
            # would let a later commit mix two attempts' shards): the
            # peers wait in the agreement below, so nothing is writing
            for _s, n in self._entries():
                if not self._committed(n):
                    self.backend.delete_prefix(
                        os.path.join(self.directory, n))
        steps = self._gather(restored_step, "agree")
        if int(steps.min()) != int(steps.max()):
            raise RestoreDivergence(
                f"hosts restored different checkpoint steps "
                f"{sorted(set(int(s) for s in steps))} (-1 = none) — a "
                f"per-host read failure made one host fall back while its "
                f"peers took the newest; refusing to resume divergent")
        if result is None:
            return None
        if self._goodput:
            self._goodput.count("restores")
            self._goodput.add("restore_s", time.monotonic() - t0)
        self._last_save_step = restored_step
        return result

    def _gather(self, step: int, phase: str) -> np.ndarray:
        """Every host's ``step``: the coordinator's marker barrier on an
        fs-simulated pod, the process group's all-gather otherwise."""
        if self._step_gather_fn is not None:
            return np.asarray(self._step_gather_fn(step, phase=phase))
        from faster_distributed_training_tpu_torch.parallel.collectives \
            import all_gather_across_processes
        return all_gather_across_processes(np.int32(step)).reshape(-1)

    # -- retention --------------------------------------------------------

    def _prune(self) -> None:
        """Process 0: keep the newest ``keep`` committed checkpoints;
        remove older ones and uncommitted residue older than the newest
        committed (never the one being written)."""
        if self._pi != 0:
            return
        entries = self._entries()
        committed = self._committed_entries()
        doomed = [n for _s, n in committed[:-self.keep]]
        if committed:
            newest = committed[-1][0]
            doomed += [n for s, n in entries
                       if s < newest and not self._committed(n)
                       and os.path.join(self.directory, n)
                       != self._inflight_path]
        for n in doomed:
            self.backend.delete_prefix(os.path.join(self.directory, n))
