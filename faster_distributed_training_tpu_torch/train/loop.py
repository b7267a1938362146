"""The Trainer's K=1 host loop (the JAX package's ``train/loop.py``):
``run_epoch``, ``evaluate``, ``fit`` with the best-accuracy epoch
checkpoint, step-cadence checkpoints (``--checkpoint_every`` steps and/or
``--checkpoint_every_secs`` of wall clock, whichever fires first; named
by global step, the newest ``--checkpoint_keep`` committed ones kept,
older ones removed only after the new one commits) and ``maybe_resume``
(the newer of the epoch checkpoint and the newest committed step one).  A mid-epoch resume starts the epoch's loader at the
first batch the checkpoint had not trained: the loader's order is a pure
function of (seed, epoch) and the step draws of (seed, step), so the
remainder replays exactly, and the skipped batches are never built.
Log lines follow the JAX format.

``--steps_per_dispatch K > 1`` (or ``--data_path resident``, at any K)
trains through ``train.dispatch.FusedDispatch``: ``_run_epoch_fused_host``
groups K loader batches into one dispatch, ``_run_epoch_resident``
gathers them from the device-resident split (a mid-epoch resume is a
seek: no host batch is built).  An epoch tail shorter than K runs fewer
steps on the same graph.  Checkpoints land on dispatch boundaries (the
cli rounds ``--checkpoint_every`` up to a multiple of K), and the live
log line reads the loss at a dispatch boundary.  K=1 on the host path is
the one-step loop above, unchanged.

Under a data mesh (``state.placement``) every rank runs this loop on its
rows; the step's and the eval's metrics come back summed over the ranks,
the eval pass runs with the parameters whole (``Placement.materialized``),
rank 0 writes the checkpoints (``train.checkpoint``), and the caller
logs on rank 0 only."""

from __future__ import annotations

import contextlib
import itertools
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.parallel.collectives import (
    all_gather_across_processes)
from faster_distributed_training_tpu_torch.train import checkpoint as ckpt
from faster_distributed_training_tpu_torch.train.metrics import (
    MetricAccumulator, perplexity)
from faster_distributed_training_tpu_torch.train.state import TrainState
from faster_distributed_training_tpu_torch.train.steps import to_device

# the wall clock of the --checkpoint_every_secs cadence
cadence_clock = time.monotonic

LoaderFn = Callable[[int], Iterable]
# (epoch, first batch) -> that epoch's batches from the first one on
TrainLoaderFn = Callable[[int, int], Iterable]


def _finite(x) -> bool:
    return x is not None and x == x and abs(x) != float("inf")


class Trainer:
    def __init__(self, cfg: TrainConfig, train_step, eval_step, device,
                 log: Callable[[str], None] = print, dispatch=None):
        self.cfg = cfg
        self.train_step = train_step
        self.eval_step = eval_step
        self.device = torch.device(device)
        self.log = log
        # a train.dispatch.FusedDispatch: K steps a dispatch (its
        # resident split, when it has one, replaces the train loader)
        self.dispatch = dispatch
        self.best_acc = 0.0
        self.global_step = 0
        self._last_save_t = cadence_clock()
        self.history: Dict[str, list] = {
            "train_acc": [], "train_loss": [], "test_acc": [],
            "test_loss": [], "epoch_time": [], "peak_mem_bytes": []}
        if cfg.task == "lm":
            # the LM's headline: perplexity of the token-weighted epoch
            # loss; "accuracy" is next-token accuracy
            self.history["train_ppl"] = []
            self.history["test_ppl"] = []

    def _step_ckpt_name(self, ckpt_name: str) -> str:
        """The step checkpoints' series name."""
        return ckpt_name + "_step"

    def _cadence_due(self, state: TrainState) -> bool:
        cfg = self.cfg
        if cfg.checkpoint_every and self.global_step % cfg.checkpoint_every == 0:
            return True
        return self._clock_due(state)

    def _clock_due(self, state: TrainState) -> bool:
        """Whether ``--checkpoint_every_secs`` has passed since the last
        save.  Under a mesh rank 0's clock decides for every rank: a save
        is collective, and the ranks' clocks differ."""
        cfg = self.cfg
        if not cfg.checkpoint_every_secs:
            return False
        due = cadence_clock() - self._last_save_t >= cfg.checkpoint_every_secs
        pl = state.placement
        if pl is not None and pl.group.live:
            due = bool(all_gather_across_processes(np.int8(due))[0])
        return due

    def _save_step(self, state: TrainState, ckpt_name: str, epoch: int,
                   step_in_epoch: int) -> None:
        """One step checkpoint, named by the global step; then the series
        is pruned to the newest --checkpoint_keep committed members."""
        cfg = self.cfg
        series = self._step_ckpt_name(ckpt_name)
        ckpt.save_checkpoint(cfg.checkpoint_dir,
                             ckpt.series_member(series, self.global_step),
                             state, epoch, self.best_acc,
                             step_in_epoch=step_in_epoch)
        self._last_save_t = cadence_clock()
        if ckpt.is_writer(state):
            ckpt.prune_series(cfg.checkpoint_dir, series,
                              cfg.checkpoint_keep)

    def run_epoch(self, state: TrainState, loader: Iterable, epoch: int = 0,
                  start_step: int = 0, ckpt_name: str = "ckpt") -> tuple:
        """One epoch over ``loader``, which starts at batch ``start_step``
        of the epoch (a mid-epoch resume)."""
        cfg = self.cfg
        acc = MetricAccumulator()
        t0 = time.monotonic()
        closer = getattr(loader, "close", None)
        if start_step:
            self.log(f"[resume] epoch {epoch}: skipped {start_step} "
                     f"already-trained batches")
        n = start_step
        last_t, last_n = t0, n
        metrics = None
        log_every = int(cfg.log_every or 0)
        try:
            for batch in loader:
                state, metrics = self.train_step(
                    state, to_device(batch, self.device))
                acc.add(metrics)
                n += 1
                self.global_step += 1
                if log_every and n % log_every == 0:
                    now = time.monotonic()
                    loss = float(metrics["loss"])
                    acc_now = (float(metrics["correct"])
                               / float(metrics["total"]))
                    exs = ((n - last_n) * cfg.batch_size
                           / max(now - last_t, 1e-9))
                    self.log(f"[epoch {epoch}] step {n}: loss={loss:.4f} "
                             f"acc={acc_now:.4f} {exs:.0f} ex/s")
                    last_t, last_n = now, n
                if self._cadence_due(state):
                    self._save_step(state, ckpt_name, epoch, n)
        finally:
            if closer is not None:
                closer()
        if metrics is not None:
            float(metrics["loss"])     # the card finishes the epoch here
        elapsed = time.monotonic() - t0
        return state, acc.summary(), elapsed

    def _dispatch_done(self, state: TrainState, acc: MetricAccumulator,
                       metrics, epoch: int, n: int, kk: int, last: tuple,
                       ckpt_name: str) -> tuple:
        """After a dispatch of kk steps ending at batch n: accumulate, log
        when a ``--log_every`` boundary was crossed, and save when the
        step cadence came due (a boundary crossed, or the clock)."""
        cfg = self.cfg
        acc.add(metrics)
        before = self.global_step
        self.global_step += kk
        log_every = int(cfg.log_every or 0)
        if log_every and n // log_every > (n - kk) // log_every:
            last_t, last_n = last
            now = time.monotonic()
            loss = float(metrics["loss"])
            acc_now = float(metrics["correct"]) / max(
                float(metrics["total"]), 1e-9)
            exs = ((n - last_n) * cfg.batch_size / max(now - last_t, 1e-9))
            self.log(f"[epoch {epoch}] step {n}: loss={loss:.4f} "
                     f"acc={acc_now:.4f} {exs:.0f} ex/s (K={kk} fused)")
            last = (now, n)
        every = int(cfg.checkpoint_every or 0)
        if (every and self.global_step // every > before // every) or (
                self._clock_due(state)):
            self._save_step(state, ckpt_name, epoch, n)
        return last

    def _run_epoch_fused_host(self, state: TrainState, loader: Iterable,
                              epoch: int, start_step: int = 0,
                              ckpt_name: str = "ckpt") -> tuple:
        """K>1 on the host data path (JAX ``_run_epoch_fused_host``): K
        loader batches a dispatch, stacked and staged in one pinned copy
        a leaf; the loader starts at ``start_step`` (a mid-epoch resume,
        a whole number of dispatches)."""
        acc = MetricAccumulator()
        t0 = time.monotonic()
        closer = getattr(loader, "close", None)
        if start_step:
            self.log(f"[resume] epoch {epoch}: skipped {start_step} "
                     f"already-trained batches")
        n, last, metrics = start_step, (t0, start_step), None
        it = iter(loader)
        try:
            while True:
                group = list(itertools.islice(it, self.dispatch.k))
                if not group:
                    break
                kk = len(group)
                metrics = self.dispatch.run(state, kk, batches=group)
                n += kk
                last = self._dispatch_done(state, acc, metrics, epoch, n,
                                           kk, last, ckpt_name)
        finally:
            if closer is not None:
                closer()
        if metrics is not None:
            float(metrics["loss"])     # the card finishes the epoch here
        return state, acc.summary(), time.monotonic() - t0

    def _run_epoch_resident(self, state: TrainState, epoch: int,
                            start_step: int = 0,
                            ckpt_name: str = "ckpt") -> tuple:
        """The resident split (JAX ``_run_epoch_resident``): the epoch
        order uploads once, each dispatch gathers its K batches on the
        device; a mid-epoch resume seeks to ``start_step``."""
        disp = self.dispatch
        acc = MetricAccumulator()
        t0 = time.monotonic()
        disp.set_epoch(epoch)
        n_steps = disp.resident.steps_per_epoch
        if start_step:
            self.log(f"[resume] epoch {epoch}: seeking to batch "
                     f"{start_step} (device-resident order, no host "
                     f"replay)")
        n, last, metrics = start_step, (t0, start_step), None
        while n < n_steps:
            kk = min(disp.k, n_steps - n)
            metrics = disp.run(state, kk, start=n)
            n += kk
            last = self._dispatch_done(state, acc, metrics, epoch, n, kk,
                                       last, ckpt_name)
        if metrics is not None:
            float(metrics["loss"])
        return state, acc.summary(), time.monotonic() - t0

    def evaluate(self, state: TrainState, loader: Iterable
                 ) -> Dict[str, float]:
        acc = MetricAccumulator()
        t0 = time.monotonic()
        pl = state.placement
        with (contextlib.nullcontext() if pl is None
              else pl.materialized(state)):
            for batch in loader:
                acc.add(self.eval_step(state, to_device(batch,
                                                        self.device)))
        summary = acc.summary()
        elapsed = time.monotonic() - t0
        total = summary.get("total_sum")
        if total:
            self.log(f"[eval] {total:.0f} samples in {elapsed:.1f}s "
                     f"({total / max(elapsed, 1e-9):.0f} ex/s)")
        return summary

    def fit(self, state: TrainState, train_loader: TrainLoaderFn,
            eval_loader: LoaderFn, ckpt_name: str = "ckpt",
            start_epoch: int = 0, start_step_in_epoch: int = 0
            ) -> TrainState:
        cfg = self.cfg
        self.global_step = int(state.step)
        self._last_save_t = cadence_clock()
        epoch = start_epoch
        resume_step = start_step_in_epoch
        cuda = self.device.type == "cuda"
        while epoch < cfg.epochs:
            if cuda:
                torch.cuda.reset_peak_memory_stats(self.device)
            disp = self.dispatch
            if disp is not None and disp.resident is not None:
                state, train_m, elapsed = self._run_epoch_resident(
                    state, epoch, resume_step, ckpt_name)
            elif disp is not None:
                state, train_m, elapsed = self._run_epoch_fused_host(
                    state, train_loader(epoch, resume_step), epoch,
                    resume_step, ckpt_name)
            else:
                state, train_m, elapsed = self.run_epoch(
                    state, train_loader(epoch, resume_step), epoch,
                    start_step=resume_step, ckpt_name=ckpt_name)
            resumed_mid_epoch, resume_step = resume_step, 0
            if "loss" not in train_m:
                if not resumed_mid_epoch:
                    raise RuntimeError(
                        f"epoch {epoch} produced no batches — dataset too "
                        f"small for batch_size={cfg.batch_size}?")
                self.log(f"[resume] epoch {epoch} was already fully trained "
                         f"at checkpoint time; running its eval and "
                         f"continuing")
            test_m = self.evaluate(state, eval_loader(epoch))
            if cfg.task == "lm":
                for m, key in ((train_m, "train_ppl"), (test_m, "test_ppl")):
                    if _finite(m.get("loss")):
                        m["perplexity"] = perplexity(m["loss"])
                    self.history[key].append(m.get("perplexity", 0.0))
            peak = (torch.cuda.max_memory_allocated(self.device) if cuda
                    else None)
            self.history["train_acc"].append(train_m.get("accuracy", 0.0))
            self.history["train_loss"].append(train_m.get("loss", 0.0))
            self.history["test_acc"].append(test_m.get("accuracy", 0.0))
            self.history["test_loss"].append(test_m.get("loss", 0.0))
            self.history["epoch_time"].append(elapsed)
            self.history["peak_mem_bytes"].append(peak)
            self.log(
                f"epoch {epoch}: train_loss={train_m.get('loss', 0):.4f} "
                f"train_acc={train_m.get('accuracy', 0):.4f} "
                f"test_loss={test_m.get('loss', 0):.4f} "
                f"test_acc={test_m.get('accuracy', 0):.4f} "
                f"time={elapsed:.1f}s"
                + (f" test_ppl={test_m['perplexity']:.2f}"
                   if "perplexity" in test_m else "")
                + (f" peak_mem={peak / 1e6:.0f}MB" if peak else ""))
            if not _finite(train_m.get("loss", 0.0)):
                self.log(f"[warn] non-finite train loss at epoch {epoch} "
                         f"(--auto_recover is not ported yet)")
            if test_m.get("accuracy", 0.0) > self.best_acc:
                self.best_acc = test_m["accuracy"]
                ckpt.save_checkpoint(cfg.checkpoint_dir, ckpt_name, state,
                                     epoch, self.best_acc)
            epoch += 1
        return state

    def maybe_resume(self, state: TrainState, ckpt_name: str = "ckpt"
                     ) -> tuple:
        """--resume: restore the newer of the best-accuracy epoch
        checkpoint and the newest committed step checkpoint.  Returns
        (state, start epoch, start step in that epoch)."""
        if not self.cfg.resume:
            return state, 0, 0
        d = self.cfg.checkpoint_dir
        best: Optional[tuple] = None
        for name in (ckpt_name, ckpt.resolve(d, self._step_ckpt_name(
                ckpt_name))):
            meta = ckpt.read_meta(d, name)
            if meta and (best is None or meta["step"] > best[1]["step"]):
                best = (name, meta)
        if best is None:
            return state, 0, 0
        name, meta = best
        state, meta = ckpt.restore_checkpoint(d, name, state)
        self.best_acc = float(meta.get("best_acc", 0.0))
        if name == ckpt_name:
            self.log(f"resumed from epoch {meta['epoch']} "
                     f"(best_acc={self.best_acc:.4f})")
            return state, int(meta["epoch"]) + 1, 0
        self.log(f"[resume] restored step-cadence checkpoint: step "
                 f"{meta['step']} (epoch {meta['epoch']}, batch "
                 f"{meta['step_in_epoch']})")
        return state, int(meta["epoch"]), int(meta["step_in_epoch"])
