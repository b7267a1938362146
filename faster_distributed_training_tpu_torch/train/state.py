"""TrainState: everything needed to continue a run bit-exactly (the JAX
package's ``train/state.py``) — the model (fp32 parameters and, for a
ResNet, the BN running statistics as buffers), trainable leaves outside
the model (``extra``: the meta / attn mixup lambda, JAX's
``params["mixup_lambda"]``), the optimizer and its state (NGD's factors
and counter among them), the fp16 loss scale, the step count and the run
seed the per-step draws derive from.  Under a data mesh ``placement``
(``parallel.placement.Placement``) says where the leaves rest between
steps and runs the step's collectives; None on one process."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch import nn

from faster_distributed_training_tpu_torch.train.amp import (
    LossScaleState, fresh_loss_scale)


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
