"""The Trainer's K=1 host loop (the JAX package's ``train/loop.py``):
``run_epoch``, ``evaluate``, ``fit`` with the best-accuracy epoch
checkpoint, step-cadence checkpoints (``--checkpoint_every``) and
``maybe_resume``.  A mid-epoch resume starts the epoch's loader at the
first batch the checkpoint had not trained: the loader's order is a pure
function of (seed, epoch) and the step draws of (seed, step), so the
remainder replays exactly, and the skipped batches are never built.
Log lines follow the JAX format."""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional

import torch

from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.train import checkpoint as ckpt
from faster_distributed_training_tpu_torch.train.metrics import (
    MetricAccumulator, perplexity)
from faster_distributed_training_tpu_torch.train.state import TrainState
from faster_distributed_training_tpu_torch.train.steps import to_device

LoaderFn = Callable[[int], Iterable]
# (epoch, first batch) -> that epoch's batches from the first one on
TrainLoaderFn = Callable[[int, int], Iterable]


def _finite(x) -> bool:
    return x is not None and x == x and abs(x) != float("inf")


class Trainer:
    def __init__(self, cfg: TrainConfig, train_step, eval_step, device,
                 log: Callable[[str], None] = print):
        self.cfg = cfg
        self.train_step = train_step
        self.eval_step = eval_step
        self.device = torch.device(device)
        self.log = log
        self.best_acc = 0.0
        self.global_step = 0
        self.history: Dict[str, list] = {
            "train_acc": [], "train_loss": [], "test_acc": [],
            "test_loss": [], "epoch_time": [], "peak_mem_bytes": []}
        if cfg.task == "lm":
            # the LM's headline: perplexity of the token-weighted epoch
            # loss; "accuracy" is next-token accuracy
            self.history["train_ppl"] = []
            self.history["test_ppl"] = []

    def _step_ckpt_name(self, ckpt_name: str) -> str:
        return ckpt_name + "_step"

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
                if cfg.checkpoint_every and (self.global_step
                                             % cfg.checkpoint_every == 0):
                    ckpt.save_checkpoint(cfg.checkpoint_dir,
                                         self._step_ckpt_name(ckpt_name),
                                         state, epoch, self.best_acc,
                                         step_in_epoch=n)
        finally:
            if closer is not None:
                closer()
        if metrics is not None:
            float(metrics["loss"])     # the card finishes the epoch here
        elapsed = time.monotonic() - t0
        return state, acc.summary(), elapsed

    def evaluate(self, state: TrainState, loader: Iterable
                 ) -> Dict[str, float]:
        acc = MetricAccumulator()
        t0 = time.monotonic()
        for batch in loader:
            acc.add(self.eval_step(state, to_device(batch, self.device)))
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
        epoch = start_epoch
        resume_step = start_step_in_epoch
        cuda = self.device.type == "cuda"
        while epoch < cfg.epochs:
            if cuda:
                torch.cuda.reset_peak_memory_stats(self.device)
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
        checkpoint and the step-cadence one.  Returns (state, start
        epoch, start step in that epoch)."""
        if not self.cfg.resume:
            return state, 0, 0
        d = self.cfg.checkpoint_dir
        best: Optional[tuple] = None
        for name in (ckpt_name, self._step_ckpt_name(ckpt_name)):
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
