"""The AG News text-classification dataset (the JAX package's
``data/agnews.py``, its Python path).

``<data_dir>/ag_news/{train,test}.csv`` rows are (class, title,
description) with 1-indexed classes, shifted to 0-based; the text is the
row's fields joined by spaces and cleaned by ``data.text.clean_text``
(HTML entities, tags, URLs and gensim's stopwords).  The tokenizer comes
from ``data.text._resolve_tokenizer`` (a real ``vocab.txt``, else the
WordPiece vocab trained on the train split and cached beside the CSVs,
else the hash tokenizer).  ``encode_batch`` pads to the smallest
eligible bucket (``data.loader.select_bucket``); the WordPiece and hash
tokenizers encode a batch in the native host library
(``runtime/native_lib.py``) when it is loaded, with the same bytes as the
Python path, which runs otherwise (and for text outside the cleaned
ASCII alphabet).  Nothing here downloads: a missing CSV raises
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
    HashTokenizer, _resolve_tokenizer, clean_text)


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
                self.samples.append((clean_text(" ".join(row[1:])),
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
        self.samples = [((clean_text(t) if clean else t), int(lab))
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

    def _bucketed_native(self, tokens_full: np.ndarray, lens: np.ndarray,
                         labels: np.ndarray, max_len: int
                         ) -> Dict[str, np.ndarray]:
        """A native encoder's [n, max_len] ids cut to the bucket of the
        longest row, the mask from the true lengths."""
        L = select_bucket(int(lens.max()), self.buckets, max_len)
        tokens = np.ascontiguousarray(tokens_full[:, :L])
        mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
        return {"tokens": tokens, "token_types": np.zeros_like(tokens),
                "mask": mask, "label": labels}

    def encode_batch(self, indices: Sequence[int], max_len: int = 512
                     ) -> Dict[str, np.ndarray]:
        """Tokenize and pad to the bucketed length (static shapes)."""
        from faster_distributed_training_tpu_torch.data.wordpiece import (
            WordPieceTokenizer)
        from faster_distributed_training_tpu_torch.runtime import native_lib

        texts = [self.samples[i][0] for i in indices]
        labels = np.asarray([self.samples[i][1] for i in indices], np.int32)
        tk = self.tokenizer
        native = None
        if isinstance(tk, WordPieceTokenizer):
            handle = tk.native_handle()
            if handle is not None:
                native = native_lib.wp_encode_batch(
                    handle, texts, max_len, tk.cls_id, tk.sep_id,
                    tk.unk_id, tk.pad_token_id)
        elif isinstance(tk, HashTokenizer):
            native = native_lib.encode_batch(
                texts, max_len, tk.vocab_size, tk.pad_id, tk.cls_id,
                tk.sep_id, tk._reserved)
        if native is not None:
            return self._bucketed_native(*native, labels, max_len)
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
