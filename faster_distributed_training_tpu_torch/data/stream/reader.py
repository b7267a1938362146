"""Memory-mapped reader over the sharded stream format, a copy of the JAX
package's ``data/stream/reader.py``.

``ShardedStreamDataset`` opens every shard leaf with ``np.load(mmap_mode=
"r")`` and gathers rows straight from the page cache.  At open it checks
each file's size and header against the manifest; on the first gather
that touches a shard it re-derives the shard's checksums, and a shard
that fails is quarantined (a warning, and its rows remapped onto the
first healthy shard, the same way on every process).  The text flavor (a
``tokens`` leaf) speaks the host text pipeline's ``encode_batch``.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from faster_distributed_training_tpu_torch.data.stream.format import (
    FORMAT, MANIFEST, checksum_file)


class ShardedStreamDataset:
    """Random row access over a committed stream-format directory."""

    def __init__(self, directory: str):
        self.directory = str(directory)
        mpath = os.path.join(self.directory, MANIFEST)
        if not os.path.isfile(mpath):
            raise FileNotFoundError(
                f"no {MANIFEST} in {self.directory}: not a committed stream "
                f"dataset (the manifest is written last; re-run the shard "
                f"writer, python -m faster_distributed_training_tpu_torch."
                f"data.stream.shard)")
        with open(mpath) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format") != FORMAT:
            raise ValueError(f"{mpath}: format "
                             f"{self.manifest.get('format')!r} != {FORMAT!r}")
        self.n = int(self.manifest["n"])
        self.leaf_spec: Dict[str, dict] = dict(self.manifest["leaves"])
        shards = self.manifest["shards"]
        rows = np.asarray([int(s["rows"]) for s in shards], np.int64)
        if int(rows.sum()) != self.n:
            raise ValueError(f"{mpath}: shard rows sum {int(rows.sum())} "
                             f"!= n {self.n} (torn manifest?)")
        # shard s covers global rows [starts[s], starts[s] + rows[s])
        self._starts = np.concatenate([[0], np.cumsum(rows)[:-1]])
        self._rows = rows
        # expected (path, alg, crc) per shard, verified on first touch
        self._crc: Dict[int, List[tuple]] = {}
        self._crc_checked = [False] * len(shards)
        self._bad_shards: set = set()
        # called as on_quarantine(shard index, path) when a shard fails
        # its checksum (the resilience sentinel's ledger and counters)
        self.on_quarantine: Optional[Callable[[int, str], None]] = None
        for si, s in enumerate(shards):
            for leaf, info in s["files"].items():
                if "crc32c" in info:
                    self._crc.setdefault(si, []).append(
                        (os.path.join(self.directory, info["file"]),
                         info.get("crc_alg", "crc32c"),
                         int(info["crc32c"])))
        self._mmaps: Dict[str, List[np.ndarray]] = {}
        for leaf, spec in self.leaf_spec.items():
            maps = []
            for s in shards:
                info = s["files"][leaf]
                path = os.path.join(self.directory, info["file"])
                size = os.path.getsize(path) if os.path.isfile(path) else -1
                if size != int(info["bytes"]):
                    raise ValueError(
                        f"{path}: {size} bytes on disk != {info['bytes']} "
                        f"in the manifest (truncated or torn shard file)")
                m = np.load(path, mmap_mode="r")
                want = (int(s["rows"]),) + tuple(spec["shape"])
                if m.shape != want or m.dtype.str != spec["dtype"]:
                    raise ValueError(
                        f"{path}: leaf {leaf!r} shard is "
                        f"{m.dtype}{m.shape}, manifest says "
                        f"{spec['dtype']}{want}")
                maps.append(m)
            self._mmaps[leaf] = maps
        self.is_text = "tokens" in self.leaf_spec
        self.seq_len = int(self.manifest.get("seq_len") or 0)
        self.nbytes_on_disk = sum(int(f["bytes"]) for s in shards
                                  for f in s["files"].values())

    def __len__(self) -> int:
        return self.n

    def vocab_size(self) -> int:
        return int(self.manifest.get("vocab_size") or 30522)

    def num_classes(self) -> int:
        return int(self.manifest.get("num_classes") or 0)

    def _verify_shard(self, s: int) -> None:
        """First-touch checksum verification of shard ``s`` (all leaves);
        a mismatch quarantines the shard and never raises."""
        if self._crc_checked[s]:
            return
        self._crc_checked[s] = True
        for path, alg, want in self._crc.get(s, ()):
            got = checksum_file(path, alg)
            if got is None or got == want:
                # None: the algorithm is not computable here
                continue
            self._bad_shards.add(s)
            msg = (f"stream shard {s} CRC mismatch ({path}: {alg} "
                   f"{got:#010x} != manifest {want:#010x}); shard "
                   f"quarantined, rows remapped to a healthy shard")
            warnings.warn(msg, stacklevel=3)
            if self.on_quarantine is not None:
                self.on_quarantine(s, path)
            break

    def _screen(self, idx: np.ndarray, shard_of: np.ndarray):
        """Verify every shard ``idx`` touches; remap rows of quarantined
        shards onto the first healthy one (position kept modulo its row
        count).  Loops because a remap target needs verifying too."""
        while True:
            for s in np.unique(shard_of):
                self._verify_shard(int(s))
            if not self._bad_shards:
                return idx, shard_of
            bad = np.isin(shard_of, sorted(self._bad_shards))
            if not bad.any():
                return idx, shard_of
            good = next((g for g in range(len(self._rows))
                         if g not in self._bad_shards), None)
            if good is None:
                raise RuntimeError(
                    f"{self.directory}: every stream shard failed its CRC "
                    f"check; nothing left to serve")
            off = idx[bad] - self._starts[shard_of[bad]]
            idx = idx.copy()
            idx[bad] = self._starts[good] + off % self._rows[good]
            shard_of = np.searchsorted(self._starts, idx,
                                       side="right") - 1

    def gather(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """Rows at global ``indices`` (any order, repeats allowed) as
        compact host arrays, one fancy-index per touched shard per leaf."""
        idx = np.asarray(indices, np.int64).reshape(-1)
        if idx.size and (idx.min() < 0 or idx.max() >= self.n):
            raise IndexError(f"stream gather index out of range [0, {self.n})")
        shard_of = np.searchsorted(self._starts, idx, side="right") - 1
        if self._crc and idx.size:
            idx, shard_of = self._screen(idx, shard_of)
        out: Dict[str, np.ndarray] = {}
        for leaf, spec in self.leaf_spec.items():
            dst = np.empty((idx.size,) + tuple(spec["shape"]),
                           np.dtype(spec["dtype"]))
            for s in np.unique(shard_of):
                sel = shard_of == s
                dst[sel] = self._mmaps[leaf][int(s)][idx[sel]
                                                     - self._starts[int(s)]]
            out[leaf] = dst
        return out

    def encode_batch(self, indices: Sequence[int], max_len: int = 512
                     ) -> Dict[str, np.ndarray]:
        """The host text pipeline's batch over pre-tokenized packed rows:
        a gather truncated to ``max_len`` columns, an all-ones mask and
        zero token types and labels."""
        if not self.is_text:
            raise ValueError("encode_batch needs the text flavor (a "
                             "'tokens' leaf)")
        rows = self.gather(indices)
        tokens = rows["tokens"]
        if max_len and max_len < tokens.shape[1]:
            tokens = np.ascontiguousarray(tokens[:, :max_len])
        out = {"tokens": tokens,
               "token_types": np.zeros_like(tokens),
               "mask": np.ones_like(tokens)}
        out["label"] = (rows["label"] if "label" in rows
                        else np.zeros(len(tokens), np.int32))
        return out


class _LazyShardRows:
    """Concatenation view over one leaf's per-shard mmaps (the image
    flavor's adapter): ``len()``, fancy and sliced row indexing and
    ``np.asarray`` without concatenating the shards in host memory."""

    def __init__(self, ds: "ShardedStreamDataset", leaf: str):
        self._ds = ds
        self._leaf = leaf
        spec = ds.leaf_spec[leaf]
        self.dtype = np.dtype(spec["dtype"])
        self.shape = (ds.n,) + tuple(spec["shape"])

    def __len__(self) -> int:
        return self._ds.n

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            idx = np.arange(*idx.indices(self._ds.n))
        idx = np.asarray(idx)
        if idx.ndim == 0:
            return self._ds.gather(idx.reshape(1))[self._leaf][0]
        return self._ds.gather(idx)[self._leaf]

    def __array__(self, dtype=None):
        out = self._ds.gather(np.arange(self._ds.n))[self._leaf]
        return out.astype(dtype) if dtype is not None else out


def open_stream_split(stream_dir: str, train: bool):
    """``--dataset stream``'s split: the reader itself for the text
    flavor, an ``(image, label)`` pair (the mmaps, or lazy views over
    several shards) for the image flavor.  ``<stream_dir>/{train,test}``."""
    ds = ShardedStreamDataset(
        os.path.join(stream_dir, "train" if train else "test"))
    if ds.is_text:
        return ds
    if "image" not in ds.leaf_spec or "label" not in ds.leaf_spec:
        raise ValueError(f"{ds.directory}: non-text stream dataset needs "
                         f"'image'+'label' leaves, has "
                         f"{sorted(ds.leaf_spec)}")
    img = ds._mmaps["image"]
    lab = ds._mmaps["label"]
    if len(img) == 1:
        return (img[0], lab[0])
    return (_LazyShardRows(ds, "image"), _LazyShardRows(ds, "label"))
