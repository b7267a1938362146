"""Synthetic datasets, copies of the JAX package's ``data/synthetic.py``:
CIFAR-shaped images (``synthetic_cifar``) and AG-News-shaped text
(``synthetic_agnews``).  Same numpy draws, so both packages see the same
bytes.  Labels are learnable: class k images are noise around a fixed
class prototype, and every token is congruent to its label modulo
num_classes."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def synthetic_cifar(n: int = 1024, seed: int = 0, num_classes: int = 10,
                    signal: float = 0.6, noise_std: float = 40.0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(NHWC uint8 images, int32 labels).  The prototypes come from a
    fixed rng, independent of ``seed``: the train (seed 0) and test
    (seed 1) splits share the class structure, so test accuracy
    measures generalization."""
    rng = np.random.default_rng(seed)
    proto_rng = np.random.default_rng(20260101)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    prototypes = proto_rng.integers(0, 256, size=(num_classes, 32, 32, 3))
    noise = rng.normal(0, noise_std, size=(n, 32, 32, 3))
    x = np.clip(prototypes[labels] * signal + noise + 50,
                0, 255).astype(np.uint8)
    return x, labels


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
