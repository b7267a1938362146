"""The Trainer's K=1 host loop (the JAX package's ``train/loop.py``):
``run_epoch``, ``evaluate``, ``fit`` with the best-accuracy epoch
checkpoint, and ``maybe_resume`` (with ``--resume``, the epoch
checkpoint; the cli then restores a newer step checkpoint).  A
mid-epoch resume starts the epoch's loader at the first batch the
checkpoint had not trained: the
loader's order is a pure function of (seed, epoch) and the step draws of
(seed, step), so the remainder replays exactly, and the skipped batches
are never built.  Log lines follow the JAX format.

Resilience (``resilience.Resilience``, built by the cli whenever a
checkpoint cadence, ``--supervise``, a fault or ``--sentinel`` asks for
it) runs after every dispatch in hazard order (``_resilience_hooks``):
injected faults, the sentinel's spike observation (``--sentinel full``:
one readback of the dispatch's loss), the pod coordinator's check, the
agreed preemption decision with its emergency save, then the manager's
cadence save (``--checkpoint_every`` steps and/or
``--checkpoint_every_secs``, whichever fires first; named by global
step, the newest ``--checkpoint_keep`` kept).  Every epoch loop skips
the batch positions the sentinel quarantined; ``fit`` counts the guard's
skipped steps, keeps ``--auto_recover``'s rolling last-good snapshot and
rolls back to it after a non-finite epoch, and logs a ``[goodput]``
line an epoch.

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

import torch

from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.resilience.sentinel import (
    host_finite)
from faster_distributed_training_tpu_torch.train import checkpoint as ckpt
from faster_distributed_training_tpu_torch.train.metrics import (
    MetricAccumulator, format_goodput, perplexity)
from faster_distributed_training_tpu_torch.train.state import (TrainState,
                                                              settle)
from faster_distributed_training_tpu_torch.train.steps import to_device

# the wall clock of the --checkpoint_every_secs cadence
cadence_clock = time.monotonic

LoaderFn = Callable[[int], Iterable]
# (epoch, first batch) -> that epoch's batches from the first one on
TrainLoaderFn = Callable[[int, int], Iterable]


class Trainer:
    def __init__(self, cfg: TrainConfig, train_step, eval_step, device,
                 log: Callable[[str], None] = print, dispatch=None,
                 resilience=None):
        self.cfg = cfg
        self.train_step = train_step
        self.eval_step = eval_step
        self.device = torch.device(device)
        self.log = log
        # a train.dispatch.FusedDispatch: K steps a dispatch (its
        # resident split, when it has one, replaces the train loader)
        self.dispatch = dispatch
        # a resilience.Resilience bundle, or None (no per-dispatch work)
        self.resilience = resilience
        self.best_acc = 0.0
        self.global_step = 0
        self.recoveries = 0
        # the last emergency save's seconds (None: none yet)
        self.emergency_save_s: Optional[float] = None
        self.history: Dict[str, list] = {
            "train_acc": [], "train_loss": [], "test_acc": [],
            "test_loss": [], "epoch_time": [], "peak_mem_bytes": []}
        if cfg.task == "lm":
            # the LM's headline: perplexity of the token-weighted epoch
            # loss; "accuracy" is next-token accuracy
            self.history["train_ppl"] = []
            self.history["test_ppl"] = []

    def _resilience_hooks(self, state: TrainState, epoch: int,
                          step_in_epoch: int, n_steps: int = 1,
                          metrics=None, group=None) -> None:
        """After a dispatch of ``n_steps`` (JAX ``_resilience_hooks``), in
        hazard order: injected faults; the sentinel's spike observation
        (``--sentinel full``: the dispatch's loss read once; ``group`` is
        the (start, count) of epoch positions it covered); the pod
        coordinator's check; the agreed preemption decision, whose
        emergency save commits before ``Preempted`` is raised; the
        manager's cadence save."""
        from faster_distributed_training_tpu_torch.resilience import (
            Preempted)

        res = self.resilience
        step = self.global_step
        res.goodput.count("steps", n_steps)
        if res.faults is not None:
            res.faults.on_step(step)
        sent = res.sentinel
        if (sent is not None and sent.mode == "full" and metrics is not None
                and group is not None):
            loss = float(metrics["loss"])
            if res.faults is not None:
                loss = res.faults.perturb_loss(step, loss)
            sent.observe(epoch, group[0], group[1], loss, step)
        if res.coordinator is not None:
            res.coordinator.check(step)
        with (res.coordinator.pause_watch() if res.coordinator is not None
              else contextlib.nullcontext()):
            if res.preemption is not None and res.preemption.should_stop(
                    step):
                res.goodput.count("preemptions")
                if res.manager is not None:
                    t0 = time.monotonic()
                    res.manager.save(state, step, epoch=epoch,
                                     step_in_epoch=step_in_epoch,
                                     best_acc=self.best_acc, sync=True,
                                     segment="emergency_save_s")
                    self.emergency_save_s = time.monotonic() - t0
                    self.log(f"[preempt] emergency checkpoint committed at "
                             f"step {step} (epoch {epoch}); exiting cleanly")
                else:
                    self.log(f"[preempt] no checkpoint manager configured — "
                             f"exiting at step {step} WITHOUT an emergency "
                             f"save (set --checkpoint_every to get one)")
                raise Preempted(f"preempted at step {step}", state=state,
                                step=step)
            if res.manager is not None:
                res.manager.maybe_save(state, step, epoch=epoch,
                                       step_in_epoch=step_in_epoch,
                                       best_acc=self.best_acc)

    def _save_epoch_checkpoint(self, name: str, state: TrainState,
                               epoch: int) -> None:
        """An epoch checkpoint (best accuracy, or ``--auto_recover``'s
        rolling last-good), timed into goodput with a resilience bundle.
        On an fs-simulated pod host 0 writes it alone: every host holds
        the same whole state."""
        res = self.resilience
        if (res is not None and res.pod_simulated and res.pod_count > 1
                and res.pod_index != 0):
            return
        if res is None:
            ckpt.save_checkpoint(self.cfg.checkpoint_dir, name, state, epoch,
                                 self.best_acc)
            return
        with res.goodput.timed("checkpoint_blocking_s"):
            ckpt.save_checkpoint(self.cfg.checkpoint_dir, name, state, epoch,
                                 self.best_acc)
        res.goodput.count("saves")

    def run_epoch(self, state: TrainState, loader: Iterable, epoch: int = 0,
                  start_step: int = 0) -> tuple:
        """One epoch over ``loader``, which starts at batch ``start_step``
        of the epoch (a mid-epoch resume)."""
        cfg = self.cfg
        acc = MetricAccumulator()
        t0 = time.monotonic()
        res = self.resilience
        sent = res.sentinel if res is not None else None
        closer = getattr(loader, "close", None)
        if res is not None and res.faults is not None:
            loader = res.faults.wrap_data(loader)
        if start_step:
            self.log(f"[resume] epoch {epoch}: skipped {start_step} "
                     f"already-trained batches")
        n = start_step
        last_t, last_n = t0, n
        metrics = None
        log_every = int(cfg.log_every or 0)
        try:
            for batch in loader:
                if sent is not None and sent.quarantined(epoch, n):
                    # built, never trained: the replay is the epoch that
                    # never saw this batch
                    n += 1
                    continue
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
                if res is not None:
                    self._resilience_hooks(state, epoch, n, 1, metrics,
                                           (n - 1, 1))
        finally:
            if closer is not None:
                closer()
        if metrics is not None:
            float(metrics["loss"])     # the card finishes the epoch here
        elapsed = time.monotonic() - t0
        return state, acc.summary(), elapsed

    def _dispatch_done(self, state: TrainState, acc: MetricAccumulator,
                       metrics, epoch: int, n: int, kk: int, last: tuple,
                       group: tuple) -> tuple:
        """After a dispatch of kk steps ending at batch n (it covered the
        epoch positions ``group``: (start, count)): accumulate, log when a
        ``--log_every`` boundary was crossed, then the resilience
        hooks."""
        cfg = self.cfg
        acc.add(metrics)
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
        if self.resilience is not None:
            self._resilience_hooks(state, epoch, n, kk, metrics, group)
        return last

    def _run_epoch_fused_host(self, state: TrainState, loader: Iterable,
                              epoch: int, start_step: int = 0) -> tuple:
        """K>1 on the host data path (JAX ``_run_epoch_fused_host``): K
        loader batches a dispatch, stacked and staged in one pinned copy
        a leaf; the loader starts at ``start_step`` (a mid-epoch resume,
        a whole number of dispatches)."""
        acc = MetricAccumulator()
        t0 = time.monotonic()
        res = self.resilience
        sent = res.sentinel if res is not None else None
        closer = getattr(loader, "close", None)
        if res is not None and res.faults is not None:
            loader = res.faults.wrap_data(loader)
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
                full = len(group)
                if sent is not None:
                    # quarantined positions leave the group; the cursor
                    # still moves by the whole group
                    group = [b for j, b in enumerate(group)
                             if not sent.quarantined(epoch, n + j)]
                    if not group:
                        n += full
                        continue
                kk = len(group)
                metrics = self.dispatch.run(state, kk, batches=group)
                n += full
                last = self._dispatch_done(state, acc, metrics, epoch, n,
                                           kk, last, (n - full, full))
        finally:
            if closer is not None:
                closer()
        if metrics is not None:
            float(metrics["loss"])     # the card finishes the epoch here
        return state, acc.summary(), time.monotonic() - t0

    def _run_epoch_resident(self, state: TrainState, epoch: int,
                            start_step: int = 0) -> tuple:
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
        res = self.resilience
        sent = res.sentinel if res is not None else None
        n, last, metrics = start_step, (t0, start_step), None
        while n < n_steps:
            kk = min(disp.k, n_steps - n)
            # the dispatch's positions without the quarantined ones: one
            # dispatch a contiguous run of them
            segs = sent.plan(epoch, n, kk) if sent is not None else [(n, kk)]
            if not segs:
                n += kk
                continue
            for s0, length in segs[:-1]:
                acc.add(disp.run(state, length, start=s0))
                self.global_step += length
            s0, length = segs[-1]
            metrics = disp.run(state, length, start=s0)
            n += kk
            last = self._dispatch_done(state, acc, metrics, epoch, n, length,
                                       last, (n - kk, kk))
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
        res = self.resilience
        self.global_step = int(state.step)
        # a supervisor restart re-enters fit from the restored epoch: the
        # history of the epochs it replays goes
        for series in self.history.values():
            del series[start_epoch:]
        if res is not None:
            res.goodput.start()
        recover_name = ckpt_name + "_last"
        failures = 0
        if cfg.auto_recover:
            # the rolling last-good snapshot (separate from the best-
            # accuracy checkpoint), written now so one always exists:
            # a non-finite epoch has poisoned the live state
            self._save_epoch_checkpoint(recover_name, state, start_epoch - 1)
        epoch = start_epoch
        resume_step = start_step_in_epoch
        cuda = self.device.type == "cuda"
        while epoch < cfg.epochs:
            if cuda:
                torch.cuda.reset_peak_memory_stats(self.device)
            disp = self.dispatch
            # the hang watchdog runs around the dispatches only
            with (res.coordinator.watch_steps()
                  if res is not None and res.coordinator is not None
                  else contextlib.nullcontext()):
                if disp is not None and disp.resident is not None:
                    state, train_m, elapsed = self._run_epoch_resident(
                        state, epoch, resume_step)
                elif disp is not None:
                    state, train_m, elapsed = self._run_epoch_fused_host(
                        state, train_loader(epoch, resume_step), epoch,
                        resume_step)
                else:
                    state, train_m, elapsed = self.run_epoch(
                        state, train_loader(epoch, resume_step), epoch,
                        start_step=resume_step)
            resumed_mid_epoch, resume_step = resume_step, 0
            # the optimizer's count, exact at every epoch's end
            settle(state)
            if res is not None:
                # the guard's skipped steps, read with the epoch's sums
                bad = train_m.get("bad_steps_sum")
                if bad:
                    res.goodput.count("skipped_steps", int(round(bad)))
            if "loss" not in train_m:
                if not resumed_mid_epoch:
                    raise RuntimeError(
                        f"epoch {epoch} produced no batches — dataset too "
                        f"small for batch_size={cfg.batch_size}?")
                self.log(f"[resume] epoch {epoch} was already fully trained "
                         f"at checkpoint time; running its eval and "
                         f"continuing")
            if ("loss" in train_m and cfg.auto_recover
                    and not host_finite(train_m.get("loss"))):
                failures += 1
                if failures > cfg.max_recoveries:
                    raise RuntimeError(
                        f"training diverged {failures} times in a row "
                        f"(epoch {epoch}); giving up")
                state, meta = ckpt.restore_checkpoint(
                    cfg.checkpoint_dir, recover_name, state)
                self.global_step = int(state.step)
                self.log(f"[recover] non-finite loss at epoch {epoch}; "
                         f"restored last-good state from epoch "
                         f"{meta.get('epoch')}, retrying")
                self.recoveries += 1
                # the retry takes the next epoch's order; the restored
                # step puts the schedule back where the snapshot was
                epoch += 1
                continue
            failures = 0
            if cfg.auto_recover:
                self._save_epoch_checkpoint(recover_name, state, epoch)
            test_m = self.evaluate(state, eval_loader(epoch))
            if cfg.task == "lm":
                for m, key in ((train_m, "train_ppl"), (test_m, "test_ppl")):
                    if host_finite(m.get("loss")):
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
            if test_m.get("accuracy", 0.0) > self.best_acc:
                self.best_acc = test_m["accuracy"]
                self._save_epoch_checkpoint(ckpt_name, state, epoch)
            if res is not None:
                self.log("[goodput] " + format_goodput(res.goodput))
            epoch += 1
        if res is not None and res.manager is not None:
            # no uncommitted newest checkpoint after a clean exit
            res.manager.wait()
        return state

    def maybe_resume(self, state: TrainState, ckpt_name: str = "ckpt"
                     ) -> tuple:
        """--resume: restore the best-accuracy epoch checkpoint when there
        is one (JAX ``Trainer.maybe_resume``; the step checkpoints are
        the cli's, through ``checkpoint.restore_newest``).  Returns
        (state, start epoch)."""
        d = self.cfg.checkpoint_dir
        if not (self.cfg.resume and ckpt.has_checkpoint(d, ckpt_name)):
            return state, 0
        state, meta = ckpt.restore_checkpoint(d, ckpt_name, state)
        self.best_acc = float(meta.get("best_acc", 0.0))
        self.log(f"resumed from epoch {meta['epoch']} "
                 f"(best_acc={self.best_acc:.4f})")
        return state, int(meta["epoch"]) + 1
