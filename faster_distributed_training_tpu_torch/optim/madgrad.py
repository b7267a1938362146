"""MADGRAD and MirrorMADGRAD (the JAX package's ``optim/madgrad.py``).

Per step k (0-based), with lr lambda, momentum c_m, eps:
    lamb_k = lr_k * sqrt(k + 1)
    v_{k+1} = v_k + lamb_k * g^2                   (dual average of squares)
    MADGRAD:       s_{k+1} = s_k + lamb_k * g
                   z_{k+1} = x_0 - s_{k+1} / (v_{k+1}^{1/3} + eps)
    MirrorMADGRAD: z_{k+1} = z_k - lamb_k * g / (v_{k+1}^{1/3} + eps)
    x_{k+1} = x_k + c (z_{k+1} - x_k),  c = 1 - c_m

Weight decay is L2 on the gradient (g + wd * x).  State is a dict of
per-parameter tensors keyed by parameter name plus the step count.  The
update works in place on the parameters and the state tensors (the JAX
version returns new arrays; in place saves a copy of every parameter).
``lamb_k`` is a Python float of the host count, or, under a K-step
dispatch, a 0-dim fp32 tensor on the device (``scalars["lamb"]``, the
same value rounded to fp32, as the Python float is rounded where it
multiplies an fp32 tensor: the update is bitwise the same).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Union

import torch

Tensors = Dict[str, torch.Tensor]


class Madgrad:
    def __init__(self, learning_rate: Union[float, Callable[[int], float]],
                 momentum: float = 0.9, weight_decay: float = 0.0,
                 eps: float = 1e-6, mirror: bool = False):
        if not 0.0 <= momentum < 1.0:
            raise ValueError(f"momentum {momentum} must be in [0, 1)")
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.eps = eps
        self.mirror = mirror

    def init(self, params: Tensors) -> dict:
        state = {"step": 0,
                 "v": {n: torch.zeros_like(p) for n, p in params.items()},
                 "z": {n: p.detach().clone() for n, p in params.items()}}
        if not self.mirror:
            state["s"] = {n: torch.zeros_like(p) for n, p in params.items()}
        return state

    def lr(self, step: int) -> float:
        lr = self.learning_rate
        return float(lr(step) if callable(lr) else lr)

    def host_scalars(self, step: int) -> Dict[str, float]:
        """The per-step scalars of optimizer step ``step``, as the host
        computes them (a dispatch uploads them as a table)."""
        return {"lamb": self.lr(step) * math.sqrt(step + 1.0)}

    @torch.no_grad()
    def update(self, grads: Tensors, state: dict, params: Tensors,
               scalars: Optional[Dict[str, torch.Tensor]] = None) -> dict:
        """Apply one step to ``params`` in place; returns ``state``
        (updated in place, step advanced).  ``scalars``: the step's
        device scalars (a dispatch), else the host count's."""
        k = state["step"]
        lamb = (scalars["lamb"] if scalars is not None
                else self.host_scalars(k)["lamb"])
        ck = 1.0 - self.momentum
        for name, p in params.items():
            g = grads[name]
            if self.weight_decay:
                g = g + self.weight_decay * p
            v = state["v"][name]
            v.add_(g * lamb * g)
            denom = v.pow(1.0 / 3.0) + self.eps
            z = state["z"][name]
            if self.mirror:
                z.sub_(g * lamb / denom)
                target = z
            else:
                s = state["s"][name]
                s.add_(g * lamb)
                target = z - s / denom
            p.add_(ck * (target - p))
        state["step"] = k + 1
        return state


def madgrad(learning_rate, momentum: float = 0.9, weight_decay: float = 0.0,
            eps: float = 1e-6) -> Madgrad:
    return Madgrad(learning_rate, momentum, weight_decay, eps, mirror=False)


def mirror_madgrad(learning_rate, momentum: float = 0.9,
                   weight_decay: float = 0.0, eps: float = 1e-6) -> Madgrad:
    return Madgrad(learning_rate, momentum, weight_decay, eps, mirror=True)
