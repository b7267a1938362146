"""K training steps a dispatch (``--steps_per_dispatch K``): the JAX
package's ``train/steps.py::make_fused_train_step`` and
``_reduce_scanned_metrics``.

JAX runs K steps in one device program (``lax.scan`` over the one-step
body: the body compiles once and runs K times).  Here the one-step body
is captured once as a CUDA graph and replayed K times a dispatch.  The
body reads everything that changes from step to step from device tables
by slot ``cursor``, which the graph advances itself:

  * the batch: slot ``cursor`` of the staged ``[K, B, ...]`` host batches
    (``--data_path host``: K loader batches stacked, text padded to the
    group's widest bucket, uploaded in one pinned copy a leaf), the
    gather ``arrays[order[(start + cursor) * B : ...]]`` from the
    replicated device-resident split (``--data_path resident``), or, from
    a batch-major source (``batch_major``: the sharded resident view
    ``[steps, local_bs, ...]`` of ``--resident_layout sharded``, the
    stream window ``[2W, local_bs, ...]`` of ``--data_path stream``), row
    ``arrays[start + cursor]`` of its leading axis, with no order gather;
  * the draws: the dropout seeds ``[K, n_sites]``, the mixup lambda and
    permutation, the image crop and flip, computed on the host by the
    K=1 functions of (run seed, global step) and uploaded once a
    dispatch;
  * the optimizer's scalars (lr, or MADGRAD's lr sqrt(k + 1)), a table
    of the host schedule indexed by the optimizer steps applied since
    the host last read their count (``train.state.AppliedCount``: a step
    skipped under fp16 or by the sentinel's guard applies none, and the
    host reads the count once every ``SETTLE_DISPATCHES`` dispatches, or
    when something reads the optimizer's count, rather than once a
    dispatch);
  * the global step (``FDT_FAULT_NAN_AT_STEP`` armed: the NaN fault
    compares it on the device).

The step writes its metrics into ``[K]`` slots; after the replays they
are reduced on the device as ``_reduce_scanned_metrics`` does (loss
mean, ``loss_total`` sum, ``correct``, ``total``, the last loss scale).
Every value the body reads is the one the K=1 step computes, rounded to
the same fp32, so K steps a dispatch are bitwise K=1's.

The graph is keyed by (data path, batch shape) and all graphs share one
memory pool.  Before its capture the body runs eagerly on the capture
stream once, as that dispatch's real step (the warm-up: cuDNN's
autotuning, the classifier kernel's ticket buffer and the cached
constants happen there).  A capture that fails, or a host sync inside it,
raises; nothing re-runs eagerly in its place.  NGD's factor refreshes
(``eigh``: host syncs) run eagerly in their slot, from the same tables.
A kernel wrapper's ``launches`` counts its calls, the capture's among
them; a replay makes no Python call and adds nothing there (``replays``
counts the replays; the kernels a replay runs are seen on the device,
by a profiler).  On the CPU (the tests) the same body runs in a Python
loop over the same tables.

The port's "compile", the moment the telemetry marks ``compile`` on a
step record (JAX marks a program's first execution): a dispatch that
met a graph key for the first time (its warm-up step ran eagerly) or
captured that key's graph.  ``builds`` counts such dispatches; the
Trainer compares it before and after each dispatch.  A key first met in
a one-step dispatch captures in its next, so that one is marked too; on
the CPU, where nothing is captured, only a key's first dispatch is.

Each graph key is a program of the table (``telemetry/programs.py``),
``train:{path}:k{K}`` (``host``, ``resident`` or ``stream``), recorded
with the active observatory at its capture: ``lower_ms`` its warm-up
step, ``compile_ms`` the capture, ``temp_bytes`` the graph pool's
reserved growth over both, ``replays`` in the table's summary.  Where nothing is
captured (the CPU, gloo) the key's first step is its ``lower_ms``.

Under a data mesh (dp) the body is the data-parallel step: its
collectives (the gradient and metric all-reduces, BatchNorm's and the
amaxes') are captured in the graph with the rest, NCCL's collectives
being capturable; the draws are the global batch's, and the resident
split is gathered at this rank's rows of each global batch (a
batch-major source holds this rank's rows only).  gloo cannot capture its
collectives: under a gloo group on the card (two ranks sharing one card)
the body runs eagerly in its loop, as on the CPU, and the dispatch says
so once.  fsdp, zero1 and the host tiers run K=1 only (the cli raises).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.telemetry import programs
from faster_distributed_training_tpu_torch.train import steps as train_steps
from faster_distributed_training_tpu_torch.train.state import (
    AppliedCount, TrainState)
from faster_distributed_training_tpu_torch.train.steps import (
    StepDraws, image_draws, mixup_alpha, step_draws)

Metrics = Dict[str, torch.Tensor]

# dispatches between two reads of the applied count (fp16, the guard)
SETTLE_DISPATCHES = 16


def stack_host_batches(group: List[Dict[str, np.ndarray]]
                       ) -> Dict[str, np.ndarray]:
    """K host batches -> one dict with a leading K axis a leaf; text
    batches bucketed to different widths are right-padded to the group's
    widest with 0 (JAX ``train/loop.py::_stack_host_batches``)."""
    out = {}
    for key in group[0]:
        arrs = [np.asarray(b[key]) for b in group]
        if any(a.shape != arrs[0].shape for a in arrs):
            tgt = tuple(max(a.shape[d] for a in arrs)
                        for d in range(arrs[0].ndim))
            arrs = [np.pad(a, [(0, t - s) for s, t in zip(a.shape, tgt)])
                    for a in arrs]
        out[key] = np.stack(arrs)
    return out


def reduce_metrics(ms: Dict[str, torch.Tensor]) -> Metrics:
    """Per-step metrics stacked [k] -> one dict on the device (JAX
    ``_reduce_scanned_metrics``): the mean loss, the exact ``loss_total``
    (the LM's token-weighted sum, else the sum of loss * total),
    ``correct`` and ``total`` summed, the last ``loss_scale``."""
    out = {"loss": ms["loss"].mean(),
           "loss_total": (ms["loss_total"].sum() if "loss_total" in ms
                          else (ms["loss"] * ms["total"]).sum()),
           "correct": ms["correct"].sum(), "total": ms["total"].sum()}
    if "loss_scale" in ms:
        out["loss_scale"] = ms["loss_scale"][-1].clone()
    if "bad_steps" in ms:
        # the sentinel's verdicts, one 0/1 a step
        out["bad_steps"] = ms["bad_steps"].sum()
    return out


def _slot(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row ``idx`` (a one-element device index) of ``t``, by
    ``index_select``: indexing with a 0-dim tensor would read it on the
    host."""
    return t.index_select(0, idx)[0]


class FusedDispatch:
    """The K-step dispatch of one run: ``run(state, kk, batches=None,
    start=0)`` trains ``kk <= K`` steps (host batches, or the resident
    split from step-in-epoch ``start``; from a batch-major source, its row
    ``start``) and returns the reduced metrics.  ``resident``: the
    device-side source, a ``data.device_resident.DeviceResidentData``,
    a ``ShardedDeviceResidentData`` or a ``data.stream.DiskStreamSource``,
    or None (the host path)."""

    def __init__(self, cfg: TrainConfig, k: int, device, resident=None,
                 log: Callable[[str], None] = print, group=None):
        if k < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {k}")
        self.cfg, self.k, self.log = cfg, int(k), log
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.resident = resident
        self.batch_major = bool(getattr(resident, "batch_major", False))
        self.key = (getattr(resident, "program_key", "resident"),)
        # this rank's rows of a global batch: (count, first)
        world = 1 if group is None else group.world
        self.rows = (cfg.batch_size // world,
                     0 if group is None else group.origin(
                         cfg.batch_size // world))
        self.image = cfg.model != "transformer"
        self.fp16 = cfg.precision == "fp16"
        # a step the sentinel's guard skips applies no optimizer update
        self.guard = (cfg.sentinel or "none") != "none"
        from faster_distributed_training_tpu_torch.resilience.faults import (
            graph_nan_at)
        # the NaN fault compares the device step: a table of the steps
        self.step_table = graph_nan_at() is not None
        self.alpha = mixup_alpha(cfg)
        # looked up when built: a wrapper set on train.steps then is used
        self.step_fn = train_steps.make_train_step(cfg)
        dev = self.device
        self.cursor = torch.zeros((), dtype=torch.int64, device=dev)
        # the optimizer steps applied: the body's scalars are its row
        self.count = AppliedCount(max(train_steps.SETTLE_EVERY,
                                      SETTLE_DISPATCHES * self.k), dev,
                                  skips=self.fp16 or self.guard)
        self.start = torch.zeros((), dtype=torch.int64, device=dev)
        self.tables: Dict[str, torch.Tensor] = {}
        self.staged: Dict[tuple, Dict[str, torch.Tensor]] = {}
        self.metric_buf: Dict[str, torch.Tensor] = {}
        self.order_buf: Optional[torch.Tensor] = None
        self.order_epoch: Optional[int] = None
        self.graphs: Dict[tuple, "torch.cuda.CUDAGraph"] = {}
        self.replays: Dict[tuple, int] = {}
        # seconds spent capturing graphs (a restore copies into the
        # tensors they read, so an in-process restart captures none)
        self.capture_s = 0.0
        self.eager_steps = 0
        # dispatches that built a program: a key's first, or a capture
        self.builds = 0
        self._seen: set = set()
        self._warm: set = set()
        # the program table: a warm-up's stopwatch and ms until its key's
        # capture; the keys recorded without a capture
        self._warm_watch: Dict[tuple, tuple] = {}
        self._timed: set = set()
        self._told_ngd = False
        # gloo's collectives run on the host: nothing to capture
        import torch.distributed as dist

        self.capture = self.cuda and not (
            group is not None and getattr(group, "live", False)
            and dist.get_backend(group.group) == "gloo")
        if self.cuda and not self.capture:
            log("[dispatch] gloo collectives cannot be captured in a CUDA "
                "graph: the step body runs eagerly in its loop on the card")
        self.stream = torch.cuda.Stream(dev) if self.cuda else None
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None

    # -- host tables ----------------------------------------------------
    def _host_tables(self, state: TrainState, kk: int,
                     draws: Optional[List[StepDraws]] = None
                     ) -> Dict[str, np.ndarray]:
        """The draws of the next ``kk`` steps, as the K=1 step computes
        them (or ``draws``), stacked [kk, ...]."""
        B, g0 = self.cfg.batch_size, int(state.step)
        if draws is None and self.image:
            draws = [image_draws(state.seed, g0 + j, B, self.cfg.alpha)
                     for j in range(kk)]
        elif draws is None:
            n = state.model.n_dropout_sites()
            draws = [step_draws(state.seed, g0 + j, B, n, self.alpha)
                     for j in range(kk)]
        tab = {"lam": np.array([d.lam for d in draws], np.float32),
               "perm": np.stack([np.asarray(d.perm, np.int64)
                                 for d in draws])}
        if self.image:
            tab["crop"] = np.stack([np.asarray(d.crop, np.int64)
                                    for d in draws])
            tab["flip"] = np.stack([np.asarray(d.flip, np.bool_)
                                    for d in draws])
        else:
            tab["seeds"] = np.array([list(d.seeds) for d in draws],
                                    np.int64).reshape(kk, -1)
        if self.step_table:
            tab["step"] = np.arange(g0, g0 + kk, dtype=np.int64)
        return tab

    def _upload(self, host: Dict[str, np.ndarray], dst: Dict[str, torch.Tensor]
                ) -> None:
        """Copy each host table into slots [0, kk) of its [K, ...] device
        buffer (allocated at first use): one pinned, asynchronous copy a
        leaf."""
        for name, arr in host.items():
            if name not in dst:
                dst[name] = torch.zeros((self.k,) + arr.shape[1:],
                                        dtype=torch.from_numpy(arr[:1]).dtype,
                                        device=self.device)
            src = torch.from_numpy(np.ascontiguousarray(arr))
            if self.cuda:
                src = src.pin_memory()
            dst[name][:arr.shape[0]].copy_(src, non_blocking=self.cuda)

    # -- the one-step body ---------------------------------------------------
    def _batch(self, key: tuple, slot: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.resident is None:
            return {n: _slot(t, slot) for n, t in self.staged[key].items()}
        if self.batch_major:
            row = (self.start + slot).reshape(1)
            out = {n: _slot(t, row) for n, t in self.resident.arrays.items()}
            out["label"] = out["label"].long()
            return out
        B = self.cfg.batch_size
        n, r0 = self.rows
        pos = ((self.start + slot) * B + r0
               + torch.arange(n, device=self.device))
        rows = self.order_buf.index_select(0, pos).long()
        out = {n: t.index_select(0, rows)
               for n, t in self.resident.arrays.items()}
        out["label"] = out["label"].long()
        return out

    def _body(self, state: TrainState, key: tuple) -> None:
        """One training step reading slot ``cursor`` of every table; its
        metrics go to their slots; ``cursor`` (and the applied optimizer
        steps, ``count.applied``) advance on the device."""
        slot = self.cursor.reshape(1)
        tab = self.tables
        draws = StepDraws(
            seeds=_slot(tab["seeds"], slot) if "seeds" in tab else (),
            lam=_slot(tab["lam"], slot), perm=_slot(tab["perm"], slot),
            crop=_slot(tab["crop"], slot) if self.image else None,
            flip=_slot(tab["flip"], slot) if self.image else None,
            step=_slot(tab["step"], slot) if "step" in tab else None)
        state, m = self.step_fn(state, self._batch(key, slot), draws,
                                self.count.scalars())
        finite = m.pop("finite", None)
        for name, v in m.items():
            if name not in self.metric_buf:
                self.metric_buf[name] = torch.zeros(
                    self.k, dtype=torch.float32, device=self.device)
            self.metric_buf[name].index_copy_(
                0, slot, v.detach().reshape(1).to(torch.float32))
        self.count.applied.add_(1 if finite is None
                                else finite.to(torch.int64))
        self.cursor.add_(1)

    # -- counters the body's host code would otherwise move --------------
    @staticmethod
    def _set_counters(state: TrainState, step: int, opt_step: int,
                      ngd_t: Optional[int]) -> None:
        state.step = step
        state.opt_state["step"] = opt_step
        if ngd_t is not None:
            state.opt_state["ngd"]["t"] = ngd_t

    def _capture(self, state: TrainState, key: tuple) -> float:
        """Capture the body on the dispatch stream (it runs nothing);
        returns the capture's ms."""
        t0 = time.monotonic()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            self._body(state, key)
        took = time.monotonic() - t0
        self.capture_s += took
        self.graphs[key] = graph
        self.replays[key] = 0
        return took * 1e3

    def _observe(self, obs, state: TrainState, key: tuple,
                 watch: programs.Stopwatch, lower_ms: float,
                 compile_ms: float) -> None:
        """Key ``key``'s row of the program table: what the body reads
        from outside its pool (the state, the tables, the staged batch or
        the resident arrays), its metric buffers, the state it updates in
        place."""
        if self.resident is None:
            data = self.staged[key]
            sig = programs.args_signature((data,), (0,))
        else:
            data = (self.resident.arrays, self.order_buf)
            sig = programs.args_signature(
                (self.resident.arrays, self.order_buf, self.start),
                (0, 1, 2))
        alias = programs.state_bytes(state)
        obs.observe(f"train:{key[0]}:k{self.k}", sig, lower_ms, compile_ms,
                    mem=watch.memory(
                        argument=alias + programs.tensor_bytes(self.tables,
                                                               data),
                        output=programs.tensor_bytes(self.metric_buf),
                        alias=alias),
                    replays=((lambda: self.replays.get(key, 0))
                             if self.capture else None))

    # -- a dispatch -----------------------------------------------------------
    def set_epoch(self, epoch: int) -> None:
        """The replicated resident split's epoch order into the persistent
        buffer a captured graph reads; the sharded view re-sharded in
        place (a collective: every rank calls it at the epoch's start).
        The stream window needs neither (the loop refills it)."""
        if self.resident is None or self.order_epoch == epoch:
            return
        self.order_epoch = epoch
        if self.batch_major:
            if hasattr(self.resident, "epoch_arrays"):
                self.resident.epoch_arrays(epoch)
            return
        order = self.resident.epoch_order(epoch)
        if self.order_buf is None:
            self.order_buf = torch.empty_like(order)
        self.order_buf.copy_(order)

    def run(self, state: TrainState, kk: int, batches=None, start: int = 0,
            draws: Optional[List[StepDraws]] = None) -> Metrics:
        """``kk`` steps from ``state`` (updated in place): ``batches``, a
        list of kk host batches (host path), or the resident split from
        step-in-epoch ``start`` of the epoch ``set_epoch`` selected (a
        batch-major source: from its row ``start``).
        ``draws``: the kk steps' draws, in place of (run seed, step)'s
        (the parity tests hand in another package's)."""
        if not 1 <= kk <= self.k:
            raise ValueError(f"a dispatch runs 1..{self.k} steps, not {kk}")
        if self.cuda:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.stream):
                out = self._run(state, kk, batches, start, draws)
            torch.cuda.current_stream(self.device).wait_stream(self.stream)
            return out
        return self._run(state, kk, batches, start, draws)

    def _run(self, state: TrainState, kk: int, batches, start: int,
             draws) -> Metrics:
        ngd = "ngd" in state.opt_state
        if ngd and (self.fp16 or self.guard):
            raise NotImplementedError(
                "not ported yet: "
                + ("--precision fp16" if self.fp16 else "--sentinel "
                   + self.cfg.sentinel)
                + " with NGD and --steps_per_dispatch > 1 (the "
                "factor-refresh gate would depend on the device's skipped "
                "steps)")
        count = self.count
        if state.applied is not count:
            # the steps another count holds are read into the host count
            # first
            if state.applied is not None:
                state.applied.settle(state)
            count.discard()
            state.applied = count
        count.reserve(state, kk)
        g0, c0 = int(state.step), int(state.opt_state["step"])
        t0 = int(state.opt_state["ngd"]["t"]) if ngd else None
        self._upload(self._host_tables(state, kk, draws), self.tables)
        if self.resident is None:
            stacked = stack_host_batches(batches)
            stacked["label"] = stacked["label"].astype(np.int64)
            key = ("host",) + tuple((n, a.shape[1:])
                                    for n, a in sorted(stacked.items()))
            self._upload(stacked, self.staged.setdefault(key, {}))
        else:
            key = self.key
            self.start.fill_(int(start))
        self.cursor.zero_()
        built = key not in self._seen
        self._seen.add(key)
        obs = programs.get_observatory()
        for j in range(kk):
            self._set_counters(state, g0 + j, c0 + j,
                               None if t0 is None else t0 + j)
            eager = not self.capture or state.tx.updating(state.opt_state)
            if eager and self.capture and not self._told_ngd:
                self.log("[dispatch] NGD factor refreshes (eigh, host "
                         "syncs) run eagerly in their slot of the "
                         "dispatch; the other steps replay the captured "
                         "step graph")
                self._told_ngd = True
            warm = False
            if not eager and key not in self.graphs and key not in self._warm:
                # the warm-up: this slot's real step, eagerly
                self._warm.add(key)
                eager = warm = True
            if eager:
                # the program's row: at the capture after a warm-up, or
                # (nothing captured) at the key's first step
                first = (obs is not None and not self.capture
                         and key not in self._timed)
                watch = None
                if obs is not None and (warm or first):
                    watch = programs.Stopwatch(
                        self.device, self.pool if self.capture else None)
                self._body(state, key)
                self.eager_steps += 1
                if watch is not None and warm:
                    self._warm_watch[key] = (watch, watch.ms())
                elif watch is not None:
                    self._timed.add(key)
                    self._observe(obs, state, key, watch, watch.ms(), 0.0)
                continue
            if key not in self.graphs:
                capture_ms = self._capture(state, key)
                built = True
                if obs is not None:
                    watch, warm_ms = self._warm_watch.pop(
                        key, (programs.Stopwatch(self.device, self.pool),
                              0.0))
                    self._observe(obs, state, key, watch, warm_ms,
                                  capture_ms)
                self._set_counters(state, g0 + j, c0 + j,
                                   None if t0 is None else t0 + j)
            self.graphs[key].replay()
            self.replays[key] += 1
        self.builds += built
        self._set_counters(state, g0 + kk, c0,
                           None if t0 is None else t0 + kk)
        # skipped steps (fp16 overflow, the sentinel's guard) applied no
        # update: the host count waits for the device's (``settle``)
        count.advance(state, kk)
        return reduce_metrics({n: b[:kk] for n, b in self.metric_buf.items()})
