"""CIFAR-10 from its pickled batches, with MD5 checks, as NHWC uint8
(the JAX package's ``data/cifar10.py``).

The batches are read from ``<data_dir>/cifar-10-batches-py/``; nothing
is downloaded.  When a file is missing or its MD5 does not match,
``load_cifar10`` raises and ``cli.load_dataset`` falls back to
``synthetic_cifar`` as the JAX entry point does.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Dict, Tuple

import numpy as np

BASE = "cifar-10-batches-py"
TRAIN_FILES = {
    "data_batch_1": "c99cafc152244af753f735de768cd75f",
    "data_batch_2": "d4bba439e000b95fd0a9bffe97cbabec",
    "data_batch_3": "54ebc095f3ab1f0389bbae665268c751",
    "data_batch_4": "634d18415352ddfa80567beed471001a",
    "data_batch_5": "482c414d41f54cd18b22e5b47cb7c3cb",
}
TEST_FILES = {"test_batch": "40351d587109b95175f43aff81a1287e"}

# the reference's normalize constants
CIFAR10_MEAN = np.asarray([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.asarray([0.2023, 0.1994, 0.2010], np.float32)


def check_integrity(path: str, md5: str) -> bool:
    """The file exists and its MD5 is ``md5``."""
    if not os.path.isfile(path):
        return False
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest() == md5


def _load_batches(root: str, files: Dict[str, str], verify: bool
                  ) -> Tuple[np.ndarray, np.ndarray]:
    images, labels = [], []
    for name, md5 in files.items():
        path = os.path.join(root, BASE, name)
        if verify and not check_integrity(path, md5):
            raise RuntimeError(f"corrupt or missing CIFAR batch: {path}")
        with open(path, "rb") as f:
            entry = pickle.load(f, encoding="latin1")
        images.append(entry["data"])
        labels.extend(entry.get("labels", entry.get("fine_labels")))
    # (N, 3072) row-major CHW -> NHWC uint8
    x = np.vstack(images).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(x), np.asarray(labels, np.int32)


def load_cifar10(data_dir: str, train: bool = True, verify: bool = True
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(images NHWC uint8, labels int32) of a split; raises when a batch
    file is missing or corrupt."""
    return _load_batches(data_dir, TRAIN_FILES if train else TEST_FILES,
                         verify)
