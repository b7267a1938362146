"""Synthetic AG-News-shaped text data (a copy of the JAX package's
``data/synthetic.py::synthetic_agnews``; same numpy draws, so both
packages see the same tokens and labels).  Labels are learnable: every
token is congruent to the label modulo num_classes."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def synthetic_agnews(n: int = 512, seed: int = 0, vocab: int = 30522,
                     num_classes: int = 4, max_len: int = 128):
    """An AGNewsDataset-compatible object with random token sequences."""
    rng = np.random.default_rng(seed)

    class _Synthetic:
        buckets = (64, 128, 256, 512)

        def __init__(self):
            self._labels = rng.integers(0, num_classes, n).astype(np.int32)
            self._lens = rng.integers(8, max_len, n)
            self._tokens = [
                1000 + (rng.integers(0, (vocab - 1000) // num_classes,
                                     size=ln) * num_classes
                        + self._labels[i])
                for i, ln in enumerate(self._lens)]

        def __len__(self):
            return n

        def num_classes(self):
            return num_classes

        def vocab_size(self):
            return vocab

        def encode_batch(self, indices: Sequence[int], max_len: int = 512
                         ) -> Dict[str, np.ndarray]:
            from faster_distributed_training_tpu_torch.data.loader import (
                select_bucket)
            seqs = [self._tokens[i][:max_len - 2] for i in indices]
            longest = max(len(s) + 2 for s in seqs)
            L = select_bucket(longest, self.buckets, max_len)
            tokens = np.zeros((len(seqs), L), np.int32)
            mask = np.zeros((len(seqs), L), np.int32)
            for i, s in enumerate(seqs):
                row = [101] + list(s) + [102]
                tokens[i, :len(row)] = row
                mask[i, :len(row)] = 1
            return {"tokens": tokens,
                    "token_types": np.zeros_like(tokens),
                    "mask": mask,
                    "label": self._labels[np.asarray(indices)]}

    return _Synthetic()
