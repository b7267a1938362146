"""On-disk sharded dataset format, a copy of the JAX package's
``data/stream/format.py`` (the two packages read and write each other's
directories).

A dataset directory holds ``shard_<i>.<leaf>.npy`` files, one raw
``.npy`` per leaf per shard over a contiguous row range, and
``manifest.json``, written last as the commit marker.  The manifest
records n, each leaf's dtype and row shape, the shard row table, each
file's byte size and its checksum (``crc32c`` with ``crc_alg``: CRC32C
where ``google_crc32c`` is installed, else zlib's CRC32), which the
reader re-derives on first touch of a shard.

``write_lm_corpus`` writes the next-token LM workload's corpus: cleaned
documents, a tokenizer from the ladder of ``data.text``, a document-level
train/test split from ``seed``, each split's token stream packed into
``[n, seq_len]`` int32 rows with no padding.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

MANIFEST = "manifest.json"
FORMAT = "fdt-stream-v1"


def _checksum_alg() -> str:
    """CRC32C when google_crc32c is installed, else zlib's CRC32; the
    manifest records which signed each file."""
    try:
        import google_crc32c  # noqa: F401
    except ImportError:
        return "crc32"
    return "crc32c"


CRC_ALG = _checksum_alg()


def checksum_file(path: str, alg: str = CRC_ALG) -> Optional[int]:
    """Chunked file checksum under ``alg``; None when ``alg`` cannot be
    computed here (the reader then skips that file's check)."""
    if alg == "crc32c":
        try:
            import google_crc32c
        except ImportError:
            return None
        crc = 0
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                crc = google_crc32c.extend(crc, chunk)
        return int(crc)
    if alg == "crc32":
        import zlib
        crc = 0
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                crc = zlib.crc32(chunk, crc)
        return crc & 0xFFFFFFFF
    return None


def _write_npy_atomic(path: str, arr: np.ndarray) -> Tuple[int, int]:
    """np.save through a temporary name and ``os.replace``; returns (byte
    size, checksum of the bytes the file holds)."""
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())
    crc = checksum_file(tmp)
    os.replace(tmp, path)
    return os.path.getsize(path), int(crc or 0)


def write_stream_dataset(directory: str,
                         chunks: Iterable[Dict[str, np.ndarray]],
                         rows_per_shard: int = 4096,
                         meta: Optional[dict] = None) -> dict:
    """Write ``chunks`` (dicts of arrays with one leading row count) as a
    sharded dataset under ``directory``, manifest last.  Every chunk must
    carry the same leaves, dtypes and row shapes.  Returns the manifest."""
    rows_per_shard = int(rows_per_shard)
    if rows_per_shard < 1:
        raise ValueError(f"rows_per_shard must be >= 1, got {rows_per_shard}")
    os.makedirs(directory, exist_ok=True)
    spec: Optional[Dict[str, dict]] = None
    pending: Dict[str, List[np.ndarray]] = {}
    pending_rows = 0
    shards: List[dict] = []
    n = 0

    def flush(final: bool) -> None:
        nonlocal pending, pending_rows
        while pending_rows and (pending_rows >= rows_per_shard or final):
            take = min(pending_rows, rows_per_shard)
            idx = len(shards)
            files = {}
            rest: Dict[str, List[np.ndarray]] = {}
            for leaf, parts in pending.items():
                arr = np.concatenate(parts) if len(parts) > 1 else parts[0]
                cut, remainder = arr[:take], arr[take:]
                fname = f"shard_{idx:05d}.{leaf}.npy"
                size, crc = _write_npy_atomic(
                    os.path.join(directory, fname),
                    np.ascontiguousarray(cut))
                files[leaf] = {"file": fname, "bytes": size,
                               "crc32c": crc, "crc_alg": CRC_ALG}
                rest[leaf] = [remainder] if len(remainder) else []
            shards.append({"rows": take, "files": files})
            pending = rest
            pending_rows -= take

    for chunk in chunks:
        if not chunk:
            continue
        got = {k: {"dtype": np.asarray(v).dtype.str,
                   "shape": list(np.asarray(v).shape[1:])}
               for k, v in chunk.items()}
        if spec is None:
            spec = got
        elif got != spec:
            raise ValueError(f"stream writer: chunk leaf spec {got} != "
                             f"first chunk's {spec}")
        counts = {k: len(np.asarray(v)) for k, v in chunk.items()}
        rows = set(counts.values())
        if len(rows) != 1:
            raise ValueError(f"stream writer: chunk leaves disagree on row "
                             f"count: {counts}")
        r = rows.pop()
        for k, v in chunk.items():
            pending.setdefault(k, []).append(np.asarray(v))
        pending_rows += r
        n += r
        flush(final=False)
    flush(final=True)
    if spec is None or n == 0:
        raise ValueError("stream writer: no rows written (empty chunk "
                         "iterable)")
    manifest = {"format": FORMAT, "n": int(n), "leaves": spec,
                "shards": shards, "rows_per_shard": rows_per_shard}
    if meta:
        manifest.update(meta)
    tmp = os.path.join(directory, f"{MANIFEST}.tmp{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(directory, MANIFEST))
    return manifest


def write_array_dataset(directory: str, arrays: Dict[str, np.ndarray],
                        rows_per_shard: int = 4096,
                        meta: Optional[dict] = None) -> dict:
    """One in-memory dict of whole arrays -> shards."""
    return write_stream_dataset(directory, [arrays],
                                rows_per_shard=rows_per_shard, meta=meta)


def _encode_doc(tokenizer, text: str) -> List[int]:
    """A whole document's ids through either tokenizer interface (the
    WordPiece ``encode(text, truncation=, max_length=)`` or the hash
    tokenizer's ``encode(text, max_len)``)."""
    try:
        return list(tokenizer.encode(text, truncation=True,
                                     max_length=1_000_000))
    except TypeError:
        return list(tokenizer.encode(text, 1_000_000))


def pack_lm_rows(texts: Sequence[str], tokenizer, seq_len: int,
                 chunk_docs: int = 512) -> Iterable[Dict[str, np.ndarray]]:
    """Tokenize ``texts`` doc by doc (each keeps its CLS/SEP), concatenate
    the ids and cut the stream into packed ``[*, seq_len]`` int32 rows; the
    trailing partial row is dropped.  Yields chunk dicts for
    ``write_stream_dataset``."""
    seq_len = int(seq_len)
    if seq_len < 2:
        raise ValueError(f"seq_len must be >= 2 for next-token prediction, "
                         f"got {seq_len}")
    carry: List[int] = []
    buf: List[np.ndarray] = []
    for i, text in enumerate(texts):
        carry.extend(_encode_doc(tokenizer, text))
        full = len(carry) // seq_len
        if full:
            rows = np.asarray(carry[: full * seq_len],
                              np.int32).reshape(full, seq_len)
            buf.append(rows)
            carry = carry[full * seq_len:]
        if buf and (i + 1) % chunk_docs == 0:
            yield {"tokens": np.concatenate(buf)}
            buf = []
    if buf:
        yield {"tokens": np.concatenate(buf)}


def write_lm_corpus(out_dir: str, texts: Sequence[str], seq_len: int,
                    tokenizer=None, data_dir: str = "",
                    val_fraction: float = 0.1, rows_per_shard: int = 2048,
                    seed: int = 0, clean: bool = True, log=print) -> dict:
    """Shard a text corpus for the next-token LM workload into
    ``<out_dir>/train`` and ``<out_dir>/test``.  Returns {"train":
    manifest, "test": manifest, "vocab_size": V}."""
    from faster_distributed_training_tpu_torch.data.text import (
        _resolve_tokenizer, clean_text)

    docs = [clean_text(t) if clean else str(t) for t in texts]
    docs = [d for d in docs if d.strip()]
    if len(docs) < 2:
        raise ValueError(f"LM corpus needs >= 2 non-empty documents, got "
                         f"{len(docs)}")
    if tokenizer is None:
        tokenizer = _resolve_tokenizer(data_dir, docs, log=log)
    order = np.random.default_rng(seed).permutation(len(docs))
    n_test = max(1, int(round(len(docs) * float(val_fraction))))
    test_docs = [docs[i] for i in order[:n_test]]
    train_docs = [docs[i] for i in order[n_test:]]
    vocab = int(getattr(tokenizer, "vocab_size", 30522))
    meta = {"content": "lm", "seq_len": int(seq_len), "vocab_size": vocab,
            "tokenizer": type(tokenizer).__name__}
    out = {"vocab_size": vocab}
    for split, split_docs in (("train", train_docs), ("test", test_docs)):
        out[split] = write_stream_dataset(
            os.path.join(out_dir, split),
            pack_lm_rows(split_docs, tokenizer, seq_len),
            rows_per_shard=rows_per_shard,
            meta={**meta, "split": split, "docs": len(split_docs)})
    return out


def synthetic_corpus(n_docs: int = 256, seed: int = 0,
                     words_per_doc: Tuple[int, int] = (30, 120),
                     vocab_words: int = 600) -> List[str]:
    """Deterministic pseudo-text: word-like strings drawn zipf-ish from a
    fixed fake vocabulary (the JAX package's numpy draws)."""
    rng = np.random.default_rng(seed)
    syll = ["ka", "ro", "mi", "ten", "lu", "za", "por", "eni", "sta", "vel",
            "dor", "ashi", "qu", "ber", "on", "tra", "ix", "mel", "gra", "un"]
    words = ["".join(syll[j % len(syll)]
                     for j in rng.integers(0, len(syll), size=ln))
             for ln in rng.integers(2, 5, size=vocab_words)]
    ranks = np.arange(1, vocab_words + 1, dtype=np.float64)
    p = (1.0 / ranks) / np.sum(1.0 / ranks)
    docs = []
    for _ in range(int(n_docs)):
        k = int(rng.integers(*words_per_doc))
        docs.append(" ".join(words[i]
                             for i in rng.choice(vocab_words, size=k, p=p)))
    return docs
