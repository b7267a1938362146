"""Optimizer + schedule pairing (the JAX package's ``optim/builder.py``):
the reference's get_optimizer selection behind one function (MADGRAD,
MirrorMADGRAD, NGD and SGD), with global-norm gradient clipping before
the update."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.optim import schedules
from faster_distributed_training_tpu_torch.optim.madgrad import (
    madgrad, mirror_madgrad)
from faster_distributed_training_tpu_torch.optim.ngd import (NGD,
                                                             NGDHyperParams)

Tensors = Dict[str, torch.Tensor]


def global_norm(grads: Tensors, shards=None) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf (optax.global_norm).
    ``shards``: (names, sum_over_shards[, elsewhere]) when the leaves of
    ``names`` are this rank's slices of sharded gradients (fsdp, zero1,
    ZeRO over tp, and under tp the rank's tp shards) or, under pp, this
    stage's own leaves: their sums of squares are all-reduced over the
    shard group (pp) before the whole leaves' join, so a replicated leaf
    counts once; the leaves of ``elsewhere`` (under pp without residency,
    the other stages' leaves this rank also holds) count on their own
    stage, not here."""
    if not shards or not shards[0]:
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in grads.values()))
    names, sum_over_shards = shards[:2]
    skip = shards[2] if len(shards) > 2 else ()
    sq = {n: torch.sum(torch.square(g.float())) for n, g in grads.items()
          if n not in skip}
    part = sum_over_shards(torch.stack([sq[n] for n in sq if n in names]
                                       ).sum())
    return torch.sqrt(part + sum(v for n, v in sq.items() if n not in names))


def clip_by_global_norm(grads: Tensors, max_norm: float,
                        shards=None) -> Tensors:
    """optax.clip_by_global_norm: leaves unchanged when the global norm is
    below max_norm, else (g / norm) * max_norm.  Decided on the device
    (no host sync)."""
    norm = global_norm(grads, shards)
    keep = norm < max_norm
    return {n: torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm)
            for n, g in grads.items()}


class Optimizer:
    """clip_by_global_norm (when ``clip_norm``) chained before the inner
    update, as the JAX package chains them with ``optax.chain``.
    ``shards``: the sharded leaves and their reduction (``global_norm``),
    set by a sharded placement."""

    def __init__(self, inner, clip_norm: Optional[float] = None):
        self.inner = inner
        self.clip_norm = clip_norm
        self.shards = None

    def init(self, params: Tensors) -> dict:
        return self.inner.init(params)

    def host_scalars(self, step: int) -> Dict[str, float]:
        """The inner optimizer's per-step scalars at optimizer step
        ``step`` (lr, or MADGRAD's lr sqrt(k + 1))."""
        return self.inner.host_scalars(step)

    def updating(self, state: dict) -> bool:
        """Whether the next update syncs with the host (NGD's factor
        refresh); a dispatch runs such a step eagerly."""
        return bool(getattr(self.inner, "updating", lambda s: False)(state))

    def update(self, grads: Tensors, state: dict, params: Tensors,
               scalars: Optional[Dict[str, torch.Tensor]] = None) -> dict:
        if self.clip_norm:
            grads = clip_by_global_norm(grads, self.clip_norm, self.shards)
        return self.inner.update(grads, state, params, scalars)


def _default_schedule(optimizer: str, cfg: TrainConfig) -> str:
    if cfg.model == "transformer":
        return "onecycle"
    if cfg.subset_stride > 1 and optimizer == "ngd":
        return "step"
    if optimizer == "ngd":
        return "multistep"
    return "cosine"


def build_optimizer(cfg: TrainConfig, steps_per_epoch: int,
                    lr_scale: float = 1.0, layouts=None
                    ) -> Tuple[Optimizer, schedules.Schedule]:
    """(optimizer, schedule).  ``lr_scale`` is the data-parallel world
    size (1 on one card); ``layouts`` maps a parameter name to its
    permutation into the JAX layout, the axis order NGD preconditions in
    (``optim.ngd.layouts_of``)."""
    base_lr = cfg.lr * lr_scale
    name = cfg.optimizer or ("ngd" if cfg.use_ngd else
                             ("mirror_madgrad" if cfg.model == "transformer"
                              else "madgrad"))
    sched_name = cfg.schedule or _default_schedule(name, cfg)
    if sched_name == "multistep":
        schedule = schedules.multistep(base_lr, (10, 20), cfg.gamma,
                                       steps_per_epoch)
    elif sched_name == "cosine":
        schedule = schedules.cosine_annealing(base_lr, 200, steps_per_epoch)
    elif sched_name == "onecycle":
        schedule = schedules.one_cycle(base_lr, cfg.epochs, steps_per_epoch)
    elif sched_name == "step":
        schedule = schedules.step_decay(base_lr, 2, cfg.gamma,
                                        steps_per_epoch)
    elif sched_name == "constant":
        schedule = schedules.constant(base_lr)
    else:
        raise ValueError(f"unknown schedule {sched_name!r}")
    if name == "madgrad":
        inner = madgrad(schedule, cfg.momentum, cfg.weight_decay)
    elif name == "mirror_madgrad":
        inner = mirror_madgrad(schedule, cfg.momentum, cfg.weight_decay)
    elif name == "ngd":
        inner = NGD(schedule, momentum=cfg.momentum,
                    weight_decay=cfg.weight_decay, use_ngd=True,
                    hp=NGDHyperParams(alpha=cfg.ngd_alpha, rank=cfg.ngd_rank,
                                      update_period=cfg.ngd_update_period,
                                      eta=cfg.ngd_eta,
                                      max_dim=cfg.ngd_max_dim),
                    layouts=layouts)
    elif name == "sgd":
        inner = NGD(schedule, momentum=cfg.momentum,
                    weight_decay=cfg.weight_decay, use_ngd=False)
    elif name == "adamw":
        raise NotImplementedError("not ported yet: --optimizer adamw")
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    return Optimizer(inner, cfg.clip_norm or None), schedule
