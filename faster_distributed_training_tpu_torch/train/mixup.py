"""Mixup pieces of the transformer path, copies of the JAX package's
``train/mixup.py``.  The transformer mixes its pooled sentence embedding
inside the forward (``models/transformer.py``); the lambda and the
permutation are explicit draws (``train.steps.StepDraws``), so here is
only the sampler of those draws and the paired criterion."""

from __future__ import annotations

from typing import Callable

import numpy as np


def sample_lam(rng: np.random.Generator, alpha: float) -> float:
    """lambda ~ Beta(alpha, alpha) when alpha > 0, else alpha itself."""
    if alpha > 0:
        return float(np.float32(rng.beta(alpha, alpha)))
    return float(alpha)


def mixup_criterion(criterion: Callable, pred, y_a, y_b, lam):
    """lam * CE(pred, y_a) + (1 - lam) * CE(pred, y_b)."""
    return lam * criterion(pred, y_a) + (1.0 - lam) * criterion(pred, y_b)
