"""The train and eval steps of the transformer classification path.

Counterparts of the JAX package's ``train/steps.py::make_train_step``
(the transformer branch) and ``make_eval_step``: in-forward mixup, the
training forward with hash dropout, the mixup criterion, backward,
global-norm clip, the optimizer update and the mixup-weighted accuracy.
PyTorch runs eagerly, so there is no compile step; the step returns its
metrics as device scalars and never waits on the card.

Under ``--quant`` the training forward rolls every amax history once (the
JAX step's mutable ``batch_stats``); the eval step's forward does not.

Randomness is explicit.  A ``StepDraws`` holds one u32 seed per dropout
site in the model's call order, the mixup lambda and the permutation.
The fused FFN (``--ffn_impl pallas``) takes its two seeds as one (hidden,
connection) pair where the flax FFN takes its hidden and connection
seeds, so the count is the same on both branches.  In a run they come
from generators seeded by (run seed, step) — numpy for lambda and the
permutation, a ``torch.Generator`` for the seeds — so a resumed run
redraws identical values.  They are not the JAX package's
threefry bits; the parity tests hand both packages the same draws, and
every dropout mask is bitwise equal given its seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.train.losses import (
    cross_entropy, per_sample_cross_entropy)
from faster_distributed_training_tpu_torch.train.mixup import (
    mixup_criterion, sample_lam)
from faster_distributed_training_tpu_torch.train.state import TrainState

Metrics = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class StepDraws:
    seeds: Sequence[int]   # one u32 per active dropout site, in call order
    lam: float             # mixup lambda
    perm: np.ndarray       # mixup partner index per row


def mixup_alpha(cfg: TrainConfig) -> float:
    """The model's Beta parameter (the JAX build_model's rule)."""
    return cfg.alpha if cfg.alpha > 0 else 0.99


def step_draws(seed: int, step: int, batch_size: int, n_seeds: int,
               alpha: float) -> StepDraws:
    """The draws of global step ``step`` of a run seeded ``seed``."""
    rng = np.random.default_rng((int(seed), int(step)))
    lam = sample_lam(rng, alpha)
    perm = rng.permutation(batch_size)
    word = np.random.SeedSequence((int(seed), int(step), 1)).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(word >> np.uint64(1)))
    seeds = torch.randint(0, 1 << 32, (n_seeds,), generator=gen,
                          dtype=torch.int64).tolist()
    return StepDraws(seeds=tuple(seeds), lam=lam, perm=perm)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host numpy batch -> tensors on ``device`` (pinned, asynchronous
    copies to a card).  Token ids and masks stay int32; labels go long."""
    dev = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        if k == "label":
            t = t.long()
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out[k] = t
    return out


def loss_and_grads(model, batch: Dict[str, torch.Tensor], draws: StepDraws):
    """The training forward with ``draws``, the mixup criterion and the
    gradients of every parameter.  Returns (loss, grads by name, logits,
    y_b, lam)."""
    y = batch["label"]
    logits, index, lam = model(batch["tokens"],
                               token_types=batch.get("token_types"),
                               mask=batch.get("mask"), train=True,
                               draws=draws)
    lam = lam.to(logits.device)
    y_b = y[index]
    loss = mixup_criterion(cross_entropy, logits, y, y_b, lam)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss, dict(zip(params, grads)), logits, y_b, lam


def make_train_step(cfg: TrainConfig) -> Callable[..., Tuple[TrainState,
                                                             Metrics]]:
    """``step(state, batch, draws=None) -> (state, metrics)``; ``batch``
    holds device tensors (``to_device``).  Without ``draws`` the step
    derives them from (state.seed, state.step).  Updates the state in
    place and advances its step."""
    alpha = mixup_alpha(cfg)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             draws: StepDraws = None) -> Tuple[TrainState, Metrics]:
        y = batch["label"]
        B = y.shape[0]
        if draws is None:
            draws = step_draws(state.seed, state.step, B,
                               state.model.n_dropout_sites(), alpha)
        loss, grads, logits, y_b, lam = loss_and_grads(state.model, batch,
                                                       draws)
        state.tx.update(grads, state.opt_state, state.params())
        state.step += 1
        with torch.no_grad():
            pred = logits.argmax(dim=-1)
            correct = (lam * (pred == y).sum()
                       + (1.0 - lam) * (pred == y_b).sum())
        return state, {"loss": loss.detach().float(),
                       "correct": correct.float(),
                       "total": torch.tensor(float(B))}

    return step


def make_eval_step(cfg: TrainConfig) -> Callable[[TrainState, Dict],
                                                 Metrics]:
    """Eval: deterministic forward (no dropout, no mixup); a padded final
    batch's ``valid`` mask keeps its pad rows out of every sum."""

    @torch.no_grad()
    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Metrics:
        logits = state.model(batch["tokens"],
                             token_types=batch.get("token_types"),
                             mask=batch.get("mask"), train=False)
        y = batch["label"]
        hit = (logits.argmax(dim=-1) == y).float()
        losses = per_sample_cross_entropy(logits, y)
        valid = batch.get("valid")
        if valid is None:
            loss_total, correct = losses.sum(), hit.sum()
            total = torch.tensor(float(y.shape[0]))
        else:
            valid = valid.float()
            loss_total = (losses * valid).sum()
            correct = (hit * valid).sum()
            total = valid.sum()
        return {"loss": loss_total / torch.clamp(total.to(loss_total.device),
                                                 min=1.0),
                "loss_total": loss_total, "correct": correct,
                "total": total}

    return step
