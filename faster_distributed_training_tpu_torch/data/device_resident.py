"""The train split resident on the card (``--data_path resident``): the
JAX package's ``data/device_resident.py`` (``DeviceResidentData``,
``ShardedDeviceResidentData``, ``build_device_resident``).

The split is uploaded once as compact dtypes (uint8 NHWC images and int32
labels; text pre-encoded at the one bucket covering the split's longest
row), and a K-step dispatch (``train.dispatch``) gathers each batch from
it on the device, ``arrays[order[start + i * B : ...]]``: no batch bytes
leave the host after the upload.  The epoch order is the host loader's
exactly, ``shard_for_host(n, epoch, seed)`` truncated to whole batches,
uploaded once an epoch as int32.

Text batches equal the host loader's modulo trailing padding: the host
pads each batch to its own bucket, the resident split to the widest.
Two layouts (``--resident_layout``):

  * ``DeviceResidentData`` (``replicated``): every rank holds the whole
    split, and the epoch order is the global one of ``process_count``
    processes (``data.loader.pod_epoch_order``): a rank gathers its rows
    of each global batch, the rows its host loader would load.
  * ``ShardedDeviceResidentData`` (``sharded``; ``auto`` under a data
    mesh of more than one process): each rank holds its contiguous row
    range of the split, ceil(n / pc) rows, and once an epoch builds its
    batch-major view ``[steps, local_bs, ...]`` of that epoch's
    ``pod_epoch_order`` by one exchange (``all_to_all_single`` with
    split sizes, every leaf packed into one byte row).  The view is
    allocated once and rewritten in place (a captured CUDA graph holds
    its address; the peak stays at the shards plus one view), and the
    dispatch reads row ``n`` of it: no gather through an order, no batch
    bytes across ranks between epochs.  Its first re-shard is the
    program table's ``epoch_reshard`` row (``telemetry/programs.py``).
"""

from __future__ import annotations

import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from faster_distributed_training_tpu_torch.data.loader import (
    dataset_len, pod_epoch_order)
from faster_distributed_training_tpu_torch.telemetry import programs, spans


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

    batch_major = False

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
        with spans.span("h2d_upload"):
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
        # the replicated layout's one device work an epoch
        with spans.span("epoch_reshard"):
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


class ShardedDeviceResidentData:
    """Per-rank row shards and a per-epoch batch-major view (module
    docstring).  ``shards``: this rank's rows, one ``[rows, ...]`` tensor
    a leaf (views of one packed ``[rows, row_bytes]`` uint8 tensor);
    ``arrays``: the view, ``[steps, local_bs, ...]`` a leaf, which
    ``epoch_arrays(epoch)`` rewrites.  ``group``: the data group the
    exchange runs over (``process_index`` / ``process_count`` default to
    its rank and size, and are the simulation seam of the tests, which
    route ``send_buffer``'s chunks themselves and call ``receive``)."""

    batch_major = True

    def __init__(self, data, batch_size: int, seed: int = 0,
                 max_len: int = 512, device="cuda", shuffle: bool = True,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 checksum: bool = False, group=None):
        self.group = group
        live = group is not None and getattr(group, "live", False)
        self.pc = int(process_count if process_count is not None
                      else group.world if live else 1)
        self.pi = int(process_index if process_index is not None
                      else group.rank if live else 0)
        self.batch_size = int(batch_size)          # the global batch
        if self.batch_size % self.pc:
            raise ValueError(f"global batch {self.batch_size} not divisible "
                             f"by {self.pc} processes")
        self.local_bs = self.batch_size // self.pc
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        self.device = torch.device(device)
        host, self.is_text, self.seq_len, self.n = _encode_split(data,
                                                                 max_len)
        self.steps_per_epoch = (self.n // self.pc) // self.local_bs
        if self.steps_per_epoch < 1:
            raise ValueError(
                f"dataset ({self.n} samples / {self.pc} hosts) smaller "
                f"than one local batch ({self.local_bs}): nothing to train "
                f"on")
        # this rank's contiguous rows, zero-padded to ceil(n / pc) (pad
        # rows are never referenced: the order's values are < n)
        self.rows = -(-self.n // self.pc)
        lo = self.pi * self.rows
        local = {}
        for k, v in host.items():
            part = v[min(lo, self.n):min(lo + self.rows, self.n)]
            if len(part) < self.rows:
                part = np.concatenate(
                    [part, np.zeros((self.rows - len(part),) + v.shape[1:],
                                    v.dtype)])
            local[k] = np.ascontiguousarray(part)
        self.upload_checksums = _checksums(local) if checksum else {}
        # every leaf's row packed into one byte row, widest items first
        # so each leaf's offset is aligned to its item size
        self._layout = []
        off = 0
        for k in sorted(local, key=lambda k: (-local[k].dtype.itemsize, k)):
            v = local[k]
            nb = int(v[0].nbytes) if len(v) else 0
            self._layout.append((k, off, nb, v.dtype, v.shape[1:]))
            off += nb
        self.row_bytes = -(-off // 8) * 8
        packed = np.zeros((self.rows, self.row_bytes), np.uint8)
        for k, o, nb, _dt, _sh in self._layout:
            packed[:, o:o + nb] = local[k].reshape(self.rows, -1).view(
                np.uint8)
        with spans.span("h2d_upload"):
            self._packed = torch.from_numpy(packed).to(self.device)
        self.shards = self._leaves(self._packed, (self.rows,))
        steps, lbs = self.steps_per_epoch, self.local_bs
        self._view = torch.zeros((steps * lbs, self.row_bytes),
                                 dtype=torch.uint8, device=self.device)
        self.arrays = self._leaves(self._view, (steps, lbs))
        self.nbytes = int(self._packed.numel())          # at rest a rank
        self.view_bytes = int(self._view.numel())
        self.epoch: Optional[int] = None
        self.reshard_ms: List[float] = []

    def _leaves(self, packed: torch.Tensor, lead: tuple
                ) -> Dict[str, torch.Tensor]:
        """Each leaf's view of a packed ``[rows, row_bytes]`` tensor."""
        out = {}
        for k, o, nb, dt, sh in self._layout:
            tdt = torch.from_numpy(np.zeros(1, dt)).dtype
            out[k] = packed[:, o:o + nb].view(tdt).view(lead + tuple(sh))
        return out

    def epoch_order(self, epoch: int) -> np.ndarray:
        """The epoch's global batch stream (``pod_epoch_order``)."""
        return pod_epoch_order(self.n, epoch, self.seed, self.shuffle,
                               self.pc, self.local_bs)

    def plan(self, epoch: int) -> dict:
        """The exchange of ``epoch``, a pure function of (n, seed, epoch,
        pc, local_bs, pi): ``send_idx`` (this rank's local rows for rank
        0, then 1, ...: each in the order of its view), ``send_sizes``,
        ``recv_sizes`` (from each rank) and ``perm`` (the view row each
        received row goes to)."""
        order = self.epoch_order(epoch).reshape(-1, self.pc, self.local_bs)
        send_idx, send_sizes = [], []
        for d in range(self.pc):
            need = order[:, d].reshape(-1).astype(np.int64)
            mine = need[need // self.rows == self.pi] - self.pi * self.rows
            send_idx.append(mine)
            send_sizes.append(len(mine))
        owner = order[:, self.pi].reshape(-1).astype(np.int64) // self.rows
        from_src = [np.nonzero(owner == s)[0] for s in range(self.pc)]
        return {"send_idx": np.concatenate(send_idx),
                "send_sizes": send_sizes,
                "recv_sizes": [len(p) for p in from_src],
                "perm": np.concatenate(from_src)}

    def send_buffer(self, epoch: int) -> Tuple[torch.Tensor, List[int],
                                               List[int]]:
        """(packed rows to send, send sizes, receive sizes) of ``epoch``."""
        p = self.plan(epoch)
        idx = torch.from_numpy(p["send_idx"]).to(self.device)
        return (self._packed.index_select(0, idx), p["send_sizes"],
                p["recv_sizes"])

    def receive(self, epoch: int, recv: torch.Tensor) -> None:
        """The exchanged rows into the view, in place."""
        perm = torch.from_numpy(self.plan(epoch)["perm"]).to(self.device)
        self._view.index_copy_(0, perm, recv.to(self.device))
        self.epoch = int(epoch)

    def _exchange(self, send: torch.Tensor, send_sizes: List[int],
                  recv_sizes: List[int]) -> torch.Tensor:
        """One ``all_to_all_single`` over the data group (gloo moves card
        tensors through the host)."""
        if self.pc == 1:
            return send
        import torch.distributed as dist

        grp = self.group.group if self.group is not None else None
        host = send.is_cuda and dist.get_backend(grp) == "gloo"
        src = send.cpu() if host else send
        out = torch.empty((sum(recv_sizes), self.row_bytes),
                          dtype=torch.uint8, device=src.device)
        dist.all_to_all_single(out, src, output_split_sizes=recv_sizes,
                               input_split_sizes=send_sizes, group=grp)
        return out

    def epoch_arrays(self, epoch: int) -> Dict[str, torch.Tensor]:
        """The view ``[steps, local_bs, ...]`` of ``epoch``, re-sharded in
        place once (a collective: every rank calls it)."""
        if self.epoch != epoch:
            t0 = time.monotonic()
            obs = programs.get_observatory() if not self.reshard_ms else None
            watch = programs.Stopwatch(self.device) if obs else None
            with spans.span("epoch_reshard"):
                send, ss, rs = self.send_buffer(epoch)
                self.receive(epoch, self._exchange(send, ss, rs))
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            self.reshard_ms.append((time.monotonic() - t0) * 1e3)
            if watch is not None:
                # the first re-shard is the program's acquisition
                obs.observe("epoch_reshard",
                            programs.args_signature((self.shards,), (0,)),
                            compile_ms=watch.ms(), mem=watch.memory(
                                argument=self.nbytes,
                                output=self.view_bytes))
        return self.arrays

    def verify_upload(self) -> bool:
        """This rank's shards read back against their encode-time CRC32s;
        raises on a mismatch.  False when built without checksums."""
        if not self.upload_checksums:
            return False
        for k, want in self.upload_checksums.items():
            got = zlib.crc32(self.shards[k].cpu().numpy().tobytes()
                             ) & 0xFFFFFFFF
            if got != want:
                raise RuntimeError(
                    f"device-resident upload integrity failure: leaf {k!r} "
                    f"of rank {self.pi}'s shard reads back with CRC32 "
                    f"{got:#010x} != {want:#010x} computed at encode time")
        return True


def build_device_resident(cfg, train_ds, device, process_count: int = 1,
                          group=None):
    """None (the host path) unless ``--data_path resident``; then the
    layout of ``--resident_layout`` (JAX ``build_device_resident``):
    ``sharded``, or ``auto`` over more than one process, gives
    ``ShardedDeviceResidentData`` over the data ``group``;
    ``replicated``, or ``auto`` in one process, ``DeviceResidentData``
    (which the port keeps at any process count: every rank's card then
    holds the whole split)."""
    if getattr(cfg, "data_path", "host") != "resident":
        return None
    layout = getattr(cfg, "resident_layout", "auto") or "auto"
    if layout not in ("auto", "replicated", "sharded"):
        raise ValueError(f"--resident_layout must be auto, replicated or "
                         f"sharded, got {layout!r}")
    checksum = (getattr(cfg, "sentinel", "none") or "none") != "none"
    if layout == "sharded" or (layout == "auto" and process_count > 1):
        return ShardedDeviceResidentData(
            train_ds, cfg.batch_size, seed=cfg.seed, max_len=cfg.seq_len,
            device=device, process_count=process_count, checksum=checksum,
            group=group)
    return DeviceResidentData(
        train_ds, cfg.batch_size, seed=cfg.seed, max_len=cfg.seq_len,
        device=device, process_count=process_count, checksum=checksum)
