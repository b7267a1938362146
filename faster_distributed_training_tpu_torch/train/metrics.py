"""Metric helpers, copied from the JAX package's ``train/metrics.py``:
``percentiles``, ``perplexity`` and ``MetricAccumulator`` (device scalars
summed, one host sync per epoch)."""

from __future__ import annotations

import math
from typing import Dict, Iterable, List

import torch


def percentiles(values: Iterable[float],
                qs: Iterable[int] = (50, 95, 99)) -> Dict[int, float]:
    """Nearest-rank percentiles of host floats — {q: value}, {} when
    empty.  Nearest-rank, not interpolated: a reported p99 is a value
    that actually happened."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return {}
    out = {}
    for q in qs:
        idx = max(0, min(len(vals) - 1,
                         math.ceil(q / 100.0 * len(vals)) - 1))
        out[int(q)] = round(vals[idx], 3)
    return out


def perplexity(loss: float, cap: float = 30.0) -> float:
    """exp of a per-token cross-entropy, the LM's headline metric, with
    the exponent capped so an early or diverged loss reports a large
    finite value (exp(30) ~ 1e13) instead of inf."""
    return float(math.exp(min(float(loss), cap)))


def _column(values) -> torch.Tensor:
    """fp64 CPU vector of scalars that may live on the card: stacked where
    they are, then moved once."""
    ts = [x.detach().double().reshape(()) if torch.is_tensor(x)
          else torch.tensor(float(x), dtype=torch.float64) for x in values]
    dev = next((t.device for t in ts if t.device.type != "cpu"),
               torch.device("cpu"))
    return torch.stack([t.to(dev) for t in ts]).cpu()


class MetricAccumulator:
    """Per-step metric dicts (tensors or floats) summed once at the end."""

    def __init__(self):
        self._sums: Dict[str, List] = {}

    def add(self, metrics) -> None:
        for k, v in metrics.items():
            self._sums.setdefault(k, []).append(v)

    def summary(self) -> Dict[str, float]:
        """One device -> host transfer for the whole epoch."""
        vals = {k: _column(v) for k, v in self._sums.items()}
        n_steps = max((len(v) for v in vals.values()), default=0)
        out = {k + "_sum": float(arr.sum()) for k, arr in vals.items()}
        if "loss_total" in vals and "total" in vals and float(
                vals["total"].sum()):
            out["loss"] = float(vals["loss_total"].sum()
                                / vals["total"].sum())
        elif "loss" in vals and n_steps:
            out["loss"] = float(vals["loss"].mean())
        if "correct" in vals and "total" in vals:
            total = float(vals["total"].sum())
            out["accuracy"] = (float(vals["correct"].sum()) / total
                               if total else 0.0)
        return out
