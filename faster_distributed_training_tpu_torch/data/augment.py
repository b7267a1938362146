"""Batched CIFAR augmentation on the device (the JAX package's
``data/augment.py``): train = normalize, pad 4 with zeros, random crop
back to 32, random horizontal flip; eval = normalize.

The draws are explicit: per-sample crop offsets ``(n, 2)`` in [0, 8]
and flip bits ``(n,)`` come from the step's ``StepDraws``.  The order is
JAX's: normalize first, then pad, so padded pixels are 0 in normalized
space (not the mean).  Images are NHWC, as the loader gives them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from faster_distributed_training_tpu_torch.data.cifar10 import (CIFAR10_MEAN,
                                                                CIFAR10_STD)


_CONSTANTS = {}


def _constants(mean, std, device) -> torch.Tensor:
    """[255, mean, std] as fp32 (3, C) on ``device``; on a card uploaded
    once and kept (a captured step graph reads it where it lies)."""
    c = torch.tensor(np.stack([np.full_like(mean, 255.0), mean, std])
                     .astype(np.float32))
    if device.type != "cuda":
        return c
    key = (str(device), c.numpy().tobytes())
    if key not in _CONSTANTS:
        _CONSTANTS[key] = c.to(device)
    return _CONSTANTS[key]


def normalize(x: torch.Tensor, mean=CIFAR10_MEAN, std=CIFAR10_STD
              ) -> torch.Tensor:
    """uint8 NHWC -> normalized float32.  The constants live on the card
    from the first call: the step never waits for them.  255 is a tensor
    too: CUDA divides by a Python scalar as a multiply by its reciprocal,
    which rounds differently from JAX's division."""
    c = _constants(mean, std, x.device)
    return (x.float() / c[0] - c[1]) / c[2]


def random_crop(x: torch.Tensor, offsets: torch.Tensor, padding: int = 4
                ) -> torch.Tensor:
    """Crop each sample of the zero-padded batch at its (row, col)
    offset back to the input size."""
    n, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    off = offsets.to(x.device, torch.long)
    rows = off[:, 0, None] + torch.arange(h, device=x.device)
    cols = off[:, 1, None] + torch.arange(w, device=x.device)
    return xp[torch.arange(n, device=x.device)[:, None, None],
              rows[:, :, None], cols[:, None, :]]


def random_flip(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Flip the samples whose bit is set, left to right."""
    keep = flip.to(x.device, torch.bool).reshape(-1, 1, 1, 1)
    return torch.where(keep, x.flip(2), x)


def augment_batch(x: torch.Tensor, offsets: torch.Tensor = None,
                  flip: torch.Tensor = None, train: bool = True,
                  padding: int = 4) -> torch.Tensor:
    """The train pipeline (normalize, crop, flip) or eval (normalize)."""
    x = normalize(x)
    if not train:
        return x
    return random_flip(random_crop(x, offsets, padding), flip)
