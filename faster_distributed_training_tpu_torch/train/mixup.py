"""The mixup family (the JAX package's ``train/mixup.py``).

The transformer mixes its pooled sentence embedding inside the forward
(``models/transformer.py``); images are mixed here, before the forward:
static mixup with one Beta(alpha, alpha) lambda a batch (``mixup_data``,
with the ``intra_only`` same-class variant), the learnable per-sample
lambda (``meta_mixup_apply``) and the learnable per-pixel lambda map
(``attn_mixup_apply``).  Lambda and the permutation are explicit draws
(``train.steps.StepDraws``); the meta and attn lambdas are trainable
leaves the caller owns and optimizes beside the model's.  Images are
NHWC.

The permutation is over the global batch, as in the JAX step.  Under a
data mesh (``parallel.collectives.current()``) each rank mixes its own
rows ``[b0, b0 + B)`` with partners gathered from every rank (images
and labels carry no gradient), and the learnable lambdas, global-batch
leaves, are read at the rank's rows (their gradient flows there only).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from faster_distributed_training_tpu_torch.parallel import collectives

Mixed = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def sample_lam(rng: np.random.Generator, alpha: float) -> float:
    """lambda ~ Beta(alpha, alpha) when alpha > 0, else alpha itself."""
    if alpha > 0:
        return float(np.float32(rng.beta(alpha, alpha)))
    return float(alpha)


def _partners(x: torch.Tensor, y: torch.Tensor, perm: torch.Tensor):
    """(x, y of each row's partner, b0): ``perm`` indexes the global
    batch, whose rows ``[b0, b0 + B)`` are this rank's ``x``, ``y``."""
    group = collectives.current()
    B = x.shape[0]
    b0 = 0 if group is None else group.origin(B)
    idx = perm[b0:b0 + B]
    if group is not None:
        x, y = group.gather(x), group.gather(y)
    return x[idx], y[idx], b0


def mixup_data(x: torch.Tensor, y: torch.Tensor, lam: float,
               perm: torch.Tensor, intra_only: bool = False) -> Mixed:
    """(mixed_x, y_a, y_b, lam): lam x + (1 - lam) x[perm]; with
    ``intra_only`` a sample whose partner has its class stays unmixed.
    ``lam`` is a float32 value: a host float, which multiplies as a host
    scalar (no copy to the card) and comes back as a host 0-d tensor, or
    a 0-d fp32 tensor on x's device (a dispatch's table slot), the same
    fp32 arithmetic, returned as it is."""
    x_b, y_b, _ = _partners(x, y, perm)
    mixed = lam * x + (1.0 - lam) * x_b
    if intra_only:
        same = (y == y_b).reshape((-1,) + (1,) * (x.dim() - 1))
        mixed = torch.where(same, x, mixed)
    if not torch.is_tensor(lam):
        lam = torch.tensor(lam, dtype=torch.float32)
    return mixed, y, y_b, lam


def init_meta_lambda(generator: torch.Generator, batch_size: int
                     ) -> torch.Tensor:
    """The pre-sigmoid per-sample lambda, U[0, 1): (batch, 1, 1, 1)."""
    return torch.rand((batch_size, 1, 1, 1), generator=generator)


def init_attn_lambda(generator: torch.Generator, batch_size: int,
                     height: int, width: int, channels: int = 3
                     ) -> torch.Tensor:
    """The pre-sigmoid per-pixel lambda map, U[0, 1), NHWC."""
    return torch.rand((batch_size, height, width, channels),
                      generator=generator)


def meta_mixup_apply(lam_param: torch.Tensor, perm: torch.Tensor,
                     x: torch.Tensor, y: torch.Tensor) -> Mixed:
    """Learnable mixup: lam = sigmoid(lam_param) per sample; gradients
    flow through the mixed input into ``lam_param``."""
    x_b, y_b, b0 = _partners(x, y, perm)
    lam = torch.sigmoid(lam_param[b0:b0 + x.shape[0]]).to(x.dtype)
    mixed = lam * x + (1.0 - lam) * x_b
    return mixed, y, y_b, lam.reshape(x.shape[0])


def attn_mixup_apply(lam_param: torch.Tensor, perm: torch.Tensor,
                     x: torch.Tensor, y: torch.Tensor) -> Mixed:
    """Attention-map mixup: a per-pixel sigmoid map mixes the images;
    each sample's loss weight is the map's mean square (the JAX
    package's normalized ``lam_scale``, in [0, 1])."""
    x_b, y_b, b0 = _partners(x, y, perm)
    lam_map = torch.sigmoid(lam_param[b0:b0 + x.shape[0]]).to(x.dtype)
    mixed = lam_map * x + (1.0 - lam_map) * x_b
    lam_scale = torch.square(lam_map.reshape(x.shape[0], -1)).mean(dim=1)
    return mixed, y, y_b, lam_scale


def mixup_criterion(criterion: Callable, pred, y_a, y_b, lam):
    """lam * CE(pred, y_a) + (1 - lam) * CE(pred, y_b)."""
    return lam * criterion(pred, y_a) + (1.0 - lam) * criterion(pred, y_b)


def mixup_criterion_meta(per_sample_criterion: Callable, pred, y_a, y_b,
                         lam: torch.Tensor) -> torch.Tensor:
    """The per-sample-lambda criterion: mean of lam CE_a + (1 - lam)
    CE_b, with lam shaped (batch,)."""
    losses = (lam * per_sample_criterion(pred, y_a)
              + (1.0 - lam) * per_sample_criterion(pred, y_b))
    return losses.mean()
