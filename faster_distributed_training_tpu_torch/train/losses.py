"""Cross-entropy losses, copies of the JAX package's ``train/losses.py``
(the reference uses ``nn.CrossEntropyLoss`` throughout)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def per_sample_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                             label_smoothing: float = 0.0) -> torch.Tensor:
    """(batch,) fp32 losses: logsumexp(logits) - logits[label], or the
    smoothed-target form (optax.smooth_labels: one_hot * (1 - a) + a / n)."""
    logits = logits.float()
    logp = F.log_softmax(logits, dim=-1)
    if label_smoothing:
        n = logits.shape[-1]
        targets = (F.one_hot(labels.long(), n).float() * (1.0 - label_smoothing)
                   + label_smoothing / n)
        return -(targets * logp).sum(dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean-reduced CE, matching torch's default reduction."""
    return per_sample_cross_entropy(logits, labels, label_smoothing).mean()
