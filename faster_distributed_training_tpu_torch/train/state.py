"""TrainState: everything needed to continue a run bit-exactly (the JAX
package's ``train/state.py``) — the model (fp32 parameters and, for a
ResNet, the BN running statistics as buffers), trainable leaves outside
the model (``extra``: the meta / attn mixup lambda, JAX's
``params["mixup_lambda"]``), the optimizer and its state (NGD's factors
and counter among them), the fp16 loss scale, the step count and the run
seed the per-step draws derive from.  Under a data mesh ``placement``
(``parallel.placement.Placement``) says where the leaves rest between
steps and runs the step's collectives; None on one process.  ``applied``
(``AppliedCount``) holds the optimizer steps a run applied since the
host last read them: ``settle`` brings the optimizer's count up to
date before anything reads it."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

import torch
from torch import nn

from faster_distributed_training_tpu_torch.train.amp import (
    LossScaleState, fresh_loss_scale)


class AppliedCount:
    """The optimizer steps applied since the host last read the count,
    kept on the device (``applied``).  A step that the sentinel's guard
    or fp16's overflow check skips applies no update, so the optimizer's
    count (a host int) must not advance for it; reading each step's
    verdict on the host would stall the card.  So the steps take their
    scalars (the lr, MADGRAD's lr sqrt(k + 1)) from a device table of the
    host schedule at ``base``, ``base + 1``, ... indexed by ``applied``,
    while the host count rests at ``base``.  ``settle`` reads ``applied``
    once, moves the host count on and retires the table: when its
    ``span`` steps are used up, and before anything reads the
    optimizer's count (a checkpoint, ``state_leaves``, the end of an
    epoch).  With ``skips`` off every step applies: the host count is
    kept exact and settling reads nothing."""

    def __init__(self, span: int, device, skips: bool = True):
        self.span = int(span)
        self.skips = bool(skips)
        self.device = torch.device(device)
        self.applied = torch.zeros((), dtype=torch.int64, device=device)
        self.steps = 0                    # steps run since ``base``
        self.base: Optional[int] = None   # None: no table
        self.table: Dict[str, torch.Tensor] = {}

    def _host_count(self) -> int:
        return self.base + (0 if self.skips else self.steps)

    def reserve(self, state: "TrainState", n: int) -> None:
        """Room for ``n`` more steps in the table: settled and refilled
        from the host schedule when it is used up (a count set from
        elsewhere, a restore's, retires it unread)."""
        if (self.base is not None
                and int(state.opt_state["step"]) != self._host_count()):
            self.discard()
        if self.base is not None and self.steps + n <= self.span:
            return
        if n > self.span:
            raise ValueError(f"{n} steps exceed the table's {self.span}")
        self.settle(state)
        base = int(state.opt_state["step"])
        sc = [state.tx.host_scalars(base + i) for i in range(self.span)]
        for name in sc[0]:
            src = torch.from_numpy(np.array([s[name] for s in sc],
                                            np.float32))
            cuda = self.device.type == "cuda"
            if name not in self.table:
                self.table[name] = torch.empty(self.span, dtype=torch.float32,
                                               device=self.device)
            # in place: a captured graph reads this tensor
            self.table[name].copy_(src.pin_memory() if cuda else src,
                                   non_blocking=cuda)
        self.base = base

    def scalars(self) -> Dict[str, torch.Tensor]:
        """This step's scalars: row ``applied`` of the table, read on the
        device (``index_select``: a 0-dim index would be read on the
        host)."""
        idx = self.applied.reshape(1)
        return {n: t.index_select(0, idx)[0] for n, t in self.table.items()}

    def advance(self, state: "TrainState", n: int) -> None:
        """After ``n`` steps ran (``applied`` moved on the device): the
        host count back at ``base``, or exact without skips."""
        self.steps += n
        state.opt_state["step"] = self._host_count()

    def settle(self, state: "TrainState") -> None:
        """The host count made exact (one read of ``applied`` when steps
        may have been skipped); the table retires."""
        if self.base is not None and self.steps:
            n = int(self.applied) if self.skips else self.steps
            state.opt_state["step"] = self.base + n
        self.discard()

    def discard(self) -> None:
        self.applied.zero_()
        self.steps = 0
        self.base = None


def settle(state: "TrainState") -> None:
    """The optimizer's host count made exact (``AppliedCount.settle``)."""
    if state.applied is not None:
        state.applied.settle(state)


@dataclass
class TrainState:
    model: nn.Module
    tx: object          # optim.Optimizer: init(params) / update(g, s, p)
    opt_state: dict
    step: int = 0
    seed: int = 0
    extra: Dict[str, torch.Tensor] = field(default_factory=dict)
    loss_scale: Optional[LossScaleState] = None
    placement: Optional[object] = None
    applied: Optional[AppliedCount] = None

    def params(self) -> Dict[str, torch.Tensor]:
        """The trainable leaves by name: the model's (its state_dict
        keys), then ``extra``'s."""
        return {**dict(self.model.named_parameters()), **self.extra}


def create_train_state(model: nn.Module, tx, seed: int = 0,
                       extra: Optional[Dict[str, torch.Tensor]] = None
                       ) -> TrainState:
    extra = {n: nn.Parameter(t) for n, t in (extra or {}).items()}
    params = {**dict(model.named_parameters()), **extra}
    device = next(model.parameters()).device
    return TrainState(model=model, tx=tx, opt_state=tx.init(params),
                      step=0, seed=int(seed), extra=extra,
                      loss_scale=fresh_loss_scale(device=device))


def state_leaves(state: TrainState) -> Dict[str, torch.Tensor]:
    """Every tensor of the state by path: the model's parameters and
    buffers, the extra leaves, the optimizer state (host counters as
    0-d tensors) and the loss scale."""
    settle(state)
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"extra/{k}": v.detach() for k, v in state.extra.items()})

    def walk(prefix: str, tree: dict) -> None:
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(f"{prefix}/{k}", v)
            else:
                out[f"{prefix}/{k}"] = (v if torch.is_tensor(v)
                                        else torch.tensor(v))
    walk("opt", state.opt_state)
    if state.loss_scale is not None:
        out["loss_scale/scale"] = state.loss_scale.scale
        out["loss_scale/growth_count"] = state.loss_scale.growth_count
    return out
