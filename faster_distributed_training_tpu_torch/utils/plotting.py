"""Accuracy / time curves as PNGs (the JAX package's ``utils/plotting.py``,
copied)."""

from __future__ import annotations

from typing import Sequence


def draw_graph(data: Sequence[float], ylabel: str, title: str,
               path: str) -> str:
    """Save a single-curve PNG (epoch on x)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(range(len(data)), data)
    ax.set_xlabel("epoch")
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
