"""The AG News text-classification dataset (the JAX package's
``data/agnews.py``, its Python path).

``<data_dir>/ag_news/{train,test}.csv`` rows are (class, title,
description) with 1-indexed classes, shifted to 0-based; the text is the
row's fields joined by spaces and cleaned by ``data.text.clean_text_py``
(HTML entities, tags, URLs and gensim's stopwords).  The tokenizer comes
from ``data.text._resolve_tokenizer`` (a real ``vocab.txt``, else the
WordPiece vocab trained on the train split and cached beside the CSVs,
else the hash tokenizer).  ``encode_batch`` pads to the smallest
eligible bucket (``data.loader.select_bucket``), as the JAX Python path
does; the JAX package's native C++ encoder returns the same ids and is not
ported.  Nothing here downloads: a missing CSV raises
``FileNotFoundError``, and ``cli.load_dataset`` falls back to the
synthetic split as the JAX one does.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from faster_distributed_training_tpu_torch.data.loader import select_bucket
from faster_distributed_training_tpu_torch.data.text import (
    HashTokenizer, _resolve_tokenizer, clean_text_py)


class AGNewsDataset:
    """Map-style dataset over the AG News CSV (class,title,description)."""

    def __init__(self, data_dir: str, train: bool = True,
                 buckets: Sequence[int] = (64, 128, 256, 512),
                 tokenizer=None, subset_stride: int = 1):
        path = os.path.join(data_dir, "ag_news",
                            "train.csv" if train else "test.csv")
        self.buckets = tuple(buckets)
        self.samples: List[Tuple[str, int]] = []
        # isfile: a stray directory at the CSV path is "missing" too
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"AG News CSV not found at {path}; use data.synthetic."
                f"synthetic_agnews for offline runs")
        with open(path, newline="", encoding="utf-8") as f:
            for i, row in enumerate(csv.reader(f)):
                if subset_stride > 1 and i % subset_stride:
                    continue
                label = int(row[0]) - 1          # 1-indexed -> 0-based
                self.samples.append((clean_text_py(" ".join(row[1:])),
                                     label))
        self.tokenizer = tokenizer
        if self.tokenizer is None:
            self.tokenizer = _resolve_tokenizer(
                data_dir, [t for t, _ in self.samples])

    @classmethod
    def from_samples(cls, samples: Sequence[Tuple[str, int]],
                     buckets: Sequence[int] = (64, 128, 256, 512),
                     tokenizer=None, data_dir: str = "",
                     clean: bool = True) -> "AGNewsDataset":
        """The same pipeline (clean, tokenize, bucket) over in-memory
        (text, label) pairs; ``data_dir=""`` keeps a corpus-trained vocab
        in memory only."""
        self = cls.__new__(cls)
        self.buckets = tuple(buckets)
        self.samples = [((clean_text_py(t) if clean else t), int(lab))
                        for t, lab in samples]
        self.tokenizer = tokenizer
        if self.tokenizer is None:
            self.tokenizer = _resolve_tokenizer(
                data_dir, [t for t, _ in self.samples])
        return self

    def __len__(self) -> int:
        return len(self.samples)

    def num_classes(self) -> int:
        return 4

    def vocab_size(self) -> int:
        return getattr(self.tokenizer, "vocab_size", 30522)

    def encode_batch(self, indices: Sequence[int], max_len: int = 512
                     ) -> Dict[str, np.ndarray]:
        """Tokenize and pad to the bucketed length (static shapes)."""
        texts = [self.samples[i][0] for i in indices]
        labels = np.asarray([self.samples[i][1] for i in indices], np.int32)
        tk = self.tokenizer
        if isinstance(tk, HashTokenizer):
            encoded = [tk.encode(t, max_len) for t in texts]
            pad_id = tk.pad_id
        else:
            encoded = [tk.encode(t, truncation=True, max_length=max_len)
                       for t in texts]
            pad_id = tk.pad_token_id
        longest = max(len(e) for e in encoded)
        L = select_bucket(longest, self.buckets, max_len)
        tokens = np.full((len(encoded), L), pad_id, np.int32)
        mask = np.zeros((len(encoded), L), np.int32)
        for i, e in enumerate(encoded):
            e = e[:L]
            tokens[i, :len(e)] = e
            mask[i, :len(e)] = 1
        return {"tokens": tokens, "token_types": np.zeros_like(tokens),
                "mask": mask, "label": labels}
