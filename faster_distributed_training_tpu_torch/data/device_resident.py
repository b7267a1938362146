"""The train split resident on the card (``--data_path resident``): the
JAX package's ``data/device_resident.py`` (``DeviceResidentData``,
``build_device_resident``), single-card layout.

The split is uploaded once as compact dtypes (uint8 NHWC images and int32
labels; text pre-encoded at the one bucket covering the split's longest
row), and a K-step dispatch (``train.dispatch``) gathers each batch from
it on the device, ``arrays[order[start + i * B : ...]]``: no batch bytes
leave the host after the upload.  The epoch order is the host loader's
exactly, ``shard_for_host(n, epoch, seed)`` truncated to whole batches,
uploaded once an epoch as int32.

Text batches equal the host loader's modulo trailing padding: the host
pads each batch to its own bucket, the resident split to the widest.
Under a data mesh every rank holds the whole split (the replicated
layout) and the epoch order is the global one of ``process_count``
processes (``data.loader.pod_epoch_order``): a rank gathers its rows of
each global batch, the rows its host loader would load.
``--resident_layout sharded`` (per-process row shards and an epoch
re-shard) is not ported.
"""

from __future__ import annotations

import zlib
from typing import Dict, Tuple

import numpy as np
import torch

from faster_distributed_training_tpu_torch.data.loader import (
    dataset_len, pod_epoch_order)


def _encode_split(data, max_len: int) -> Tuple[Dict[str, np.ndarray], bool,
                                               int, int]:
    """(host arrays, is_text, seq_len, n): the whole split as compact host
    numpy, uint8 NHWC images and int32 labels, or the text split encoded
    at one bucket length (``encode_batch`` over every row picks the bucket
    covering the longest)."""
    is_text = hasattr(data, "encode_batch")
    n = dataset_len(data)
    if is_text:
        host = {k: np.asarray(v) for k, v in
                data.encode_batch(np.arange(n), max_len).items()}
        return host, True, int(host["tokens"].shape[1]), n
    x, y = data
    return {"image": np.asarray(x), "label": np.asarray(y)}, False, 0, n


def _checksums(host: Dict[str, np.ndarray]) -> Dict[str, int]:
    """CRC32 of each leaf's bytes as encoded on the host."""
    return {k: zlib.crc32(np.ascontiguousarray(v).tobytes()) & 0xFFFFFFFF
            for k, v in host.items()}


class DeviceResidentData:
    """The train split as device tensors with a leading sample axis
    (``arrays``: ``image`` uint8 + ``label`` int32, or ``tokens`` /
    ``token_types`` / ``mask`` / ``label`` int32) and the epoch order
    (``epoch_order``).  ``checksum=True`` keeps the encoded leaves' CRC32
    for ``verify_upload``."""

    def __init__(self, data, batch_size: int, seed: int = 0,
                 max_len: int = 512, device="cuda", shuffle: bool = True,
                 checksum: bool = False, process_count: int = 1):
        self.batch_size = int(batch_size)     # the global batch
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        self.device = torch.device(device)
        self.process_count = int(process_count)
        self.local_batch = self.batch_size // self.process_count
        self.n = dataset_len(data)
        self.steps_per_epoch = ((self.n // self.process_count)
                                // self.local_batch)
        if self.steps_per_epoch < 1:
            raise ValueError(
                f"dataset ({self.n} samples) smaller than one batch "
                f"({self.batch_size}): nothing to train on")
        host, self.is_text, self.seq_len, _ = _encode_split(data, max_len)
        self.upload_checksums = _checksums(host) if checksum else {}
        self.nbytes = sum(a.nbytes for a in host.values())
        self.arrays: Dict[str, torch.Tensor] = {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
            for k, v in host.items()}

    def host_order(self, epoch: int) -> np.ndarray:
        """The epoch's global sample order on the host, int32, whole
        batches: global batch b is ``[b * B, (b + 1) * B)``, rank r's rows
        of it ``r * Bl`` on."""
        return pod_epoch_order(self.n, epoch, self.seed, self.shuffle,
                               self.process_count, self.local_batch)

    def epoch_order(self, epoch: int) -> torch.Tensor:
        """The epoch's order on the device: ``BatchLoader.plan()``'s
        indices for the same (seed, epoch), concatenated, drop-last."""
        return torch.from_numpy(self.host_order(epoch)).to(self.device)

    def verify_upload(self) -> bool:
        """Read the resident tensors back and compare their CRC32 with
        the encode-time ones; raises on a mismatch.  False when built
        without checksums."""
        if not self.upload_checksums:
            return False
        for k, want in self.upload_checksums.items():
            got = zlib.crc32(self.arrays[k].cpu().numpy().tobytes()
                             ) & 0xFFFFFFFF
            if got != want:
                raise RuntimeError(
                    f"device-resident upload integrity failure: leaf {k!r} "
                    f"reads back with CRC32 {got:#010x} != {want:#010x} "
                    f"computed at encode time")
        return True


def build_device_resident(cfg, train_ds, device, process_count: int = 1):
    """None (the host path) unless ``--data_path resident``; then the
    replicated layout, every rank's card holding the whole split.
    ``--resident_layout sharded`` raises (the per-process row-sharded
    layout is not ported)."""
    if getattr(cfg, "data_path", "host") != "resident":
        return None
    layout = getattr(cfg, "resident_layout", "auto") or "auto"
    if layout == "sharded":
        raise NotImplementedError(
            "not ported yet: --resident_layout sharded (the per-process "
            "sharded layout)")
    if layout not in ("auto", "replicated"):
        raise ValueError(f"--resident_layout must be auto, replicated or "
                         f"sharded, got {layout!r}")
    return DeviceResidentData(
        train_ds, cfg.batch_size, seed=cfg.seed, max_len=cfg.seq_len,
        device=device, process_count=process_count,
        checksum=(getattr(cfg, "sentinel", "none") or "none") != "none")
