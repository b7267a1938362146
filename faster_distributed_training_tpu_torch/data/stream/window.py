"""A fixed window of batches on the card over an on-disk stream dataset
(``--data_path stream``): the JAX package's ``data/stream/window.py``
(``DiskStreamSource``, ``_EpochWindow``).

The train split stays on disk (``reader.py``'s mmaps); the card holds a
window of ``W`` batches in two slots, allocated once per leaf as ``[2, W,
local_bs, ...]``.  While the dispatches train from one slot, a producer
thread refills the other: it gathers the next ``W`` batches from disk
(``host_buffer``), writes them into pinned staging (allocated once per
leaf) and copies them into the idle slot with ``copy_(non_blocking=
True)`` on a side CUDA stream of its own.  Three events order the
streams:

  * a refill of slot s waits (on the side stream) on ``released[s]``,
    recorded on the dispatch stream after the last dispatch that read s;
  * the copy records ``filled[s]``, and the producer hands the slot over
    only once that event has completed (so the pinned staging is free
    for the next refill, and the consumer's wait in ``buffer_for`` is
    the whole stall);
  * the dispatch stream waits on ``filled[s]`` before the first replay
    that reads s.

The dispatch reads the window as ``arrays[leaf]``, a ``[2W, local_bs,
...]`` view of the slots, at row ``slot * W + (n - base)``, which the
loop hands it as a device scalar: one captured CUDA graph a dispatch
length serves both slots (the program key "stream", JAX's
``program_key``).  No buffer is allocated per refill, so the graph's
addresses stay valid; the card holds 2 slots (JAX's window has a third
buffer in flight).

Batch order is ``loader.pod_epoch_order`` (the host loader's and both
resident layouts'), and process ``pi`` of ``pc`` reads only its
``local_bs`` rows of each global batch.  A mid-epoch resume is a seek:
``epoch_window(epoch, start_step)`` starts the refills there, and a
batch's contents are a function of its index alone.  The producer runs
on ``data.loader.ParallelBatchIterator`` (one thread, depth 1): a window
is closed on every exit of the epoch, normal or not, and ``close``
cancels, drains and joins the thread.

At a slot swap the consumer first waits for the dispatch stream to reach
the end of the window it read (one host sync a window), so that what
``buffer_for`` then waits for the refill is the time the card would sit
idle for data: ``stall_s`` over the epoch's wall is ``stream_stall_pct``.
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from faster_distributed_training_tpu_torch.data.loader import (
    ParallelBatchIterator, pod_epoch_order)
from faster_distributed_training_tpu_torch.telemetry import spans


class DiskStreamSource:
    """The run's stream source: the reader, the window's geometry, its
    two slots on ``device`` and their staging.  ``batch_major``: the
    dispatch reads ``arrays`` on a leading batch axis (as the sharded
    resident view); ``process_index`` / ``process_count`` are the
    simulation seam of the tests (one process builds any simulated
    rank's buffers)."""

    batch_major = True
    program_key = "stream"

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 device="cpu", shuffle: bool = True, window_batches: int = 8,
                 steps_per_dispatch: int = 1, max_len: int = 512,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.pc, self.pi = int(process_count), int(process_index)
        self.batch_size = int(batch_size)          # the global batch
        if self.batch_size % self.pc:
            raise ValueError(f"global batch {self.batch_size} not divisible "
                             f"by {self.pc} processes")
        self.local_bs = self.batch_size // self.pc
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        self.max_len = int(max_len)
        self.n = len(dataset)
        self.is_text = bool(getattr(dataset, "is_text", False))
        self.seq_len = (min(int(getattr(dataset, "seq_len", 0) or 0),
                            self.max_len) if self.is_text else 0)
        self.steps_per_epoch = (self.n // self.pc) // self.local_bs
        if self.steps_per_epoch < 1:
            raise ValueError(
                f"stream dataset ({self.n} samples / {self.pc} hosts) "
                f"smaller than one local batch ({self.local_bs}): nothing "
                f"to train on")
        k = max(int(steps_per_dispatch or 1), 1)
        w = max(int(window_batches or 1), 1)
        if w % k:
            rounded = -(-w // k) * k
            warnings.warn(
                f"stream window of {w} batches is not a multiple of "
                f"steps_per_dispatch={k}; rounding up to {rounded} so "
                f"buffer boundaries stay dispatch-aligned (a mid-group "
                f"boundary would change the K-grouping between a resumed "
                f"and an uninterrupted run)", stacklevel=2)
            w = rounded
        self.window = w
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda and self.device.index is None:
            # the producer thread makes this card current
            self.device = torch.device("cuda", torch.cuda.current_device())
        # the leaves a batch carries: the text flavor's encode_batch
        # leaves (what the host and resident paths feed the same step),
        # or the image flavor's stored ones
        if self.is_text:
            spec = {k: (np.dtype(np.int32), (self.seq_len,))
                    for k in ("tokens", "token_types", "mask")}
            spec["label"] = (np.dtype(np.int32), ())
        else:
            spec = {k: (np.dtype(v["dtype"]), tuple(v["shape"]))
                    for k, v in dataset.leaf_spec.items()}
        shape = (self.window, self.local_bs)
        self.slots: Dict[str, torch.Tensor] = {
            k: torch.zeros((2,) + shape + s, dtype=_torch_dtype(dt),
                           device=self.device) for k, (dt, s) in spec.items()}
        # what the dispatch reads: [2W, local_bs, ...] views of the slots
        self.arrays = {k: t.view((2 * self.window,) + t.shape[2:])
                       for k, t in self.slots.items()}
        self.device_bytes = sum(t.numel() * t.element_size()
                                for t in self.slots.values())
        self.staging: Dict[str, torch.Tensor] = {}
        self.copy_stream = None
        if self.cuda:
            self.staging = {k: torch.empty(t.shape[1:], dtype=t.dtype,
                                           pin_memory=True)
                            for k, t in self.slots.items()}
            self.copy_stream = torch.cuda.Stream(self.device)
            self.released = [torch.cuda.Event(), torch.cuda.Event()]
            self.filled = [torch.cuda.Event(enable_timing=True)
                           for _ in range(2)]
            self._copy_start = torch.cuda.Event(enable_timing=True)
        self.pinned_bytes = sum(t.numel() * t.element_size()
                                for t in self.staging.values())
        # the card's window, 2 slots, plus its pinned staging on the host
        self.nbytes = self.device_bytes + self.pinned_bytes
        # the batch range each slot holds (None while it is refilled),
        # and whether the dispatches may still read it
        self.slot_range: List[Optional[Tuple[int, int]]] = [None, None]
        self.in_use = [False, False]
        self.refills = 0
        self.read_s = 0.0            # host_buffer: the disk gather
        self.h2d_s = 0.0             # staging + copy, host wall
        self.h2d_device_ms = 0.0     # the copies on the side stream
        self.h2d_bytes = 0

    def epoch_order(self, epoch: int) -> np.ndarray:
        """The epoch's global batch stream (``pod_epoch_order``): entry
        ``b * bs + pi * lbs + j`` is process pi's j-th sample of global
        batch b."""
        return pod_epoch_order(self.n, epoch, self.seed, self.shuffle,
                               self.pc, self.local_bs)

    def host_buffer(self, order: np.ndarray, base: int, hi: int
                    ) -> Dict[str, np.ndarray]:
        """This process's rows of global batches [base, hi) as host arrays
        ``[window, local_bs, ...]``, a pure function of (order, range);
        past ``hi - base`` the window is zero (never read: the loop stops
        at ``steps_per_epoch``)."""
        nb = hi - base
        idx = order.reshape(-1, self.pc, self.local_bs)[base:hi, self.pi]
        rows = self._rows(idx.reshape(-1))
        out = {}
        for k, v in rows.items():
            v = v.reshape((nb, self.local_bs) + v.shape[1:])
            if nb < self.window:
                v = np.concatenate(
                    [v, np.zeros((self.window - nb,) + v.shape[1:],
                                 v.dtype)])
            out[k] = np.ascontiguousarray(v)
        return out

    def _rows(self, flat_idx: np.ndarray) -> Dict[str, np.ndarray]:
        # text through encode_batch (the leaves every data path feeds the
        # step, byte for byte); images as stored
        if self.is_text:
            return dict(self.dataset.encode_batch(flat_idx, self.max_len))
        return self.dataset.gather(flat_idx)

    def _upload(self, host: Dict[str, np.ndarray], slot: int) -> None:
        """``host`` into ``slot``: on the card through the pinned staging
        on the side stream, after the slot's release, returning once the
        copy has completed."""
        if not self.cuda:
            for k, v in host.items():
                self.slots[k][slot].copy_(torch.from_numpy(v))
            return
        torch.cuda.set_device(self.device)
        for k, v in host.items():
            # the previous copy from the staging has completed (its event
            # was waited for before that refill returned)
            self.staging[k].numpy()[...] = v
        side = self.copy_stream
        with torch.cuda.stream(side):
            side.wait_event(self.released[slot])
            self._copy_start.record(side)
            for k, t in self.staging.items():
                self.slots[k][slot].copy_(t, non_blocking=True)
            self.filled[slot].record(side)
        self.filled[slot].synchronize()
        self.h2d_device_ms += self._copy_start.elapsed_time(
            self.filled[slot])

    def release(self, slot: int) -> None:
        """The dispatch stream has queued its last read of ``slot``."""
        self.in_use[slot] = False
        if self.cuda:
            self.released[slot].record(torch.cuda.current_stream(
                self.device))

    def acquire(self, slot: int) -> None:
        """The dispatch stream waits for ``slot``'s refill."""
        self.in_use[slot] = True
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_event(
                self.filled[slot])

    def epoch_window(self, epoch: int, start_step: int = 0
                     ) -> "_EpochWindow":
        return _EpochWindow(self, epoch, start_step)


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(1, dt)).dtype


class _Refills:
    """The epoch's refills as a loader for ``ParallelBatchIterator``:
    ``plan()`` lists (index, base, hi), ``materialize`` refills slot
    ``index % 2``."""

    start = 0

    def __init__(self, win: "_EpochWindow", order: np.ndarray):
        self.win, self.order = win, order
        src = win.src
        bases = range(win.start_step, src.steps_per_epoch, src.window)
        self._plan = [(i, b, min(b + src.window, src.steps_per_epoch))
                      for i, b in enumerate(bases)]

    def plan(self):
        return self._plan

    def materialize(self, entry) -> Tuple[int, int, int]:
        i, base, hi = entry
        win, src = self.win, self.win.src
        slot = i % 2
        if src.in_use[slot]:
            raise RuntimeError(
                f"stream window: refill of slot {slot} while batches "
                f"[{base}, {hi}) are read from it")
        src.slot_range[slot] = None
        t0 = time.monotonic()
        with spans.span("stream_refill"):
            host = src.host_buffer(self.order, base, hi)
            t1 = time.monotonic()
            src._upload(host, slot)
        t2 = time.monotonic()
        nbytes = int(sum(v.nbytes for v in host.values()))
        src.read_s += t1 - t0
        src.h2d_s += t2 - t1
        src.h2d_bytes += nbytes
        src.refills += 1
        win.refills += 1
        rec = spans.get_recorder()
        if rec is not None:
            rec.record_event(
                "stream_refill", epoch=win.epoch, base=base,
                batches=hi - base, bytes=nbytes,
                read_ms=round((t1 - t0) * 1e3, 3),
                h2d_ms=round((t2 - t1) * 1e3, 3))
        src.slot_range[slot] = (base, hi)
        return base, hi, slot


class _EpochWindow:
    """One epoch's refill stream (module docstring): ``buffer_for(n)``
    returns ``(base, hi, slot)``, the slot holding batch n."""

    def __init__(self, src: DiskStreamSource, epoch: int,
                 start_step: int = 0):
        self.src = src
        self.epoch = int(epoch)
        self.start_step = int(start_step)
        self.stall_s = 0.0
        self.stalls = 0
        self.refills = 0
        # the last swap's wait for a refill (seconds)
        self.last_wait = 0.0
        self.closed = False
        self._cur: Optional[Tuple[int, int, int]] = None
        self._it = ParallelBatchIterator(
            _Refills(self, src.epoch_order(epoch)), workers=1, depth=1)

    def buffer_for(self, n: int) -> Tuple[int, int, int]:
        """The slot covering batch ``n`` as ``(base, hi, slot)``.  Past the
        current slot the consumer releases it, waits for the dispatch
        stream to finish reading it, then waits for the refill of the
        next: that last wait is the stall."""
        cur = self._cur
        self.last_wait = 0.0
        if cur is not None and cur[0] <= n < cur[1]:
            return cur
        src = self.src
        if cur is not None:
            src.release(cur[2])
            if src.cuda:
                src.released[cur[2]].synchronize()
        t0 = time.monotonic()
        try:
            nxt = next(self._it)
        except StopIteration:
            raise RuntimeError(
                f"stream window exhausted at batch {n} (epoch "
                f"{self.epoch}: {src.steps_per_epoch} steps from "
                f"{self.start_step}): consumer and producer ranges "
                f"disagree") from None
        wait = time.monotonic() - t0
        base, hi, slot = nxt
        if src.slot_range[slot] != (base, hi):
            raise RuntimeError(
                f"stream window: slot {slot} handed out for [{base}, {hi}) "
                f"holds {src.slot_range[slot]}")
        if base > n or n >= hi:
            raise RuntimeError(
                f"stream window skew: batch {n} requested, buffer "
                f"[{base}, {hi}) arrived: the consumer must advance "
                f"monotonically from start_step")
        src.acquire(slot)
        self.last_wait = wait
        self.stall_s += wait
        self.stalls += 1
        rec = spans.get_recorder()
        if rec is not None:
            rec.record_event("stream_stall", epoch=self.epoch, step=n,
                             wait_ms=round(wait * 1e3, 3))
        self._cur = nxt
        return nxt

    def close(self) -> None:
        """Cancel, drain and join the producer (idempotent); the slot in
        use is released for the next epoch's refills."""
        if self.closed:
            return
        self.closed = True
        self._it.close()
        if self._cur is not None:
            self.src.release(self._cur[2])
        self._cur = None
