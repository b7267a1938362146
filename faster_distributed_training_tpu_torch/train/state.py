"""TrainState: everything needed to continue a run bit-exactly — the
model (fp32 parameters), the optimizer and its state, the step count and
the run seed the per-step draws derive from (the JAX package's
``train/state.py``; no loss scale: fp16 is not ported)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
from torch import nn


@dataclass
class TrainState:
    model: nn.Module
    tx: object          # optim.Optimizer: init(params) / update(g, s, p)
    opt_state: dict
    step: int = 0
    seed: int = 0

    def params(self) -> Dict[str, torch.Tensor]:
        """The trainable leaves by name (the model's state_dict keys)."""
        return dict(self.model.named_parameters())


def create_train_state(model: nn.Module, tx, seed: int = 0) -> TrainState:
    return TrainState(model=model, tx=tx,
                      opt_state=tx.init(dict(model.named_parameters())),
                      step=0, seed=int(seed))
