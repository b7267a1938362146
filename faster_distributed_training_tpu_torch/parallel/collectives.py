"""Collectives of the data-parallel step (the JAX package's
``parallel/collectives.py``, and the reductions XLA inserts for a
global-batch program).

In JAX one program sees the global batch; here each process sees its
rows, so every place where the JAX program reads the global batch is a
collective of the process group: the gradient all-reduce, the BatchNorm
statistics, the quantizers' amaxes, the mixup partners and the metrics.
``DataGroup`` is the run's data-parallel world (rank r holds global rows
``[r * Bl, (r + 1) * Bl)``); without a process group every method is
the identity, so one process runs exactly the single-card code.

The ops deep in the model (BatchNorm, the quantizers, the mixups) reach
the group of the step that calls them through ``DataGroup.active()``, a
``with`` block around the step's forward and backward on the calling
thread (the backward runs there too, ``train.steps._grads``);
``current()`` is None outside one.

Under tensor parallelism (``--mesh tp=N``) the data group holds one rank
of each tp group, and ``TensorGroup`` is the rank's tp group: the two
Megatron autograd pairs around every sharded sublayer (``copy_in``:
identity forward, SUM backward, where a replicated activation enters a
column-parallel GEMM; ``reduce_out``: SUM forward, identity backward,
after a row-parallel GEMM) and the MAX of the quantizers' amaxes over
the shards; ``all_gather`` over its group rebuilds a leaf from its
shards (``Placement``).  The model holds its
TensorGroup (no thread-local: the shapes of its shards depend on it).

Under pipeline parallelism (``--mesh pp=P``) the data group holds the
ranks of one stage (those of every data index), and ``PipeGroup`` is the
rank's pipeline group: the ranks of its data index, one a stage.

Under sequence parallelism (``--mesh sp=S``) the data group again holds
one rank of each sp group, and ``SequenceGroup`` is the rank's sp group
(``DataGroup.seq``): the rank holds the positions ``[r * L/S, (r + 1) *
L/S)`` of its data shard's rows.  Its collectives are autograd pairs:
the ring rotation (a send / receive pair, backward the reverse
rotation), the tiled all-to-all that swaps a sequence shard for a head
shard (backward the inverse swap), the broadcast of sp rank 0's rows
(the CLS row; backward a SUM to rank 0), and the all-gather of the key
mask, SUM and MAX.  The model holds its SequenceGroup, as it holds its
TensorGroup; the activation and gradient amaxes MAX over it too
(``all_max_``).  gloo moves card tensors through the host (the card's
two-rank checks run gloo: NCCL refuses two ranks on one card).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

_ACTIVE = threading.local()


def current() -> Optional["DataGroup"]:
    """The DataGroup of the step running on this thread, or None."""
    return getattr(_ACTIVE, "group", None)


class DataGroup:
    """The data-parallel process group of a run: ``group`` (None: the
    default group; no group initialized: one process), its ``rank`` and
    ``world``."""

    def __init__(self, group=None, seq: Optional["SequenceGroup"] = None,
                 pipe: Optional["PipeGroup"] = None):
        self.live = dist.is_initialized()
        self.group = group
        self.rank = dist.get_rank(group) if self.live else 0
        self.world = dist.get_world_size(group) if self.live else 1
        # the rank's sp group (None without sp): the amaxes, the gradient
        # SUM and the metrics reduce over it too
        self.seq = seq if seq is not None and seq.live else None
        # the rank's pipeline group (None without pp): the group holds
        # the ranks of this rank's stage
        self.pipe = pipe if pipe is not None and pipe.live else None

    @contextlib.contextmanager
    def active(self):
        """Make this the group the model's collectives use on this
        thread, for the ``with`` block."""
        prev = current()
        _ACTIVE.group = self
        try:
            yield self
        finally:
            _ACTIVE.group = prev

    def origin(self, local_rows: int) -> int:
        """The global index of this rank's first row."""
        return self.rank * int(local_rows)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM all-reduce in place."""
        if self.live:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def max_(self, t: torch.Tensor) -> torch.Tensor:
        """MAX all-reduce in place."""
        if self.live:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over ranks of ``t`` (a new tensor; differentiable:
        the backward is the same mean of the cotangents)."""
        if not self.live:
            return t
        return _Mean.apply(t, self)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along dim 0, in rank order (no
        gradient)."""
        if not self.live:
            return t
        return torch.cat(all_gather(t.detach(), self.world, self.group))

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """``gather`` with a gradient: the cotangents of every rank's
        gathered rows are summed back onto the rank that owns them."""
        if not self.live:
            return t
        return _GatherRows.apply(t, self)


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group: DataGroup):
        ctx.group = group
        out = t.detach().clone()
        return group.sum_(out) / group.world

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        return ctx.group.sum_(g) / ctx.group.world, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group: DataGroup):
        ctx.group, ctx.rows = group, t.shape[0]
        return group.gather(t)

    @staticmethod
    def backward(ctx, g):
        g = ctx.group.sum_(g.contiguous().clone())
        r0 = ctx.group.origin(ctx.rows)
        return g[r0:r0 + ctx.rows], None


class TensorGroup:
    """A rank's tensor-parallel group: ``group`` (a process group; None:
    collectives are the identity, for the per-shard math of one process),
    this rank's index ``rank`` in it and its ``size``."""

    def __init__(self, group=None, rank: int = 0, size: int = 1):
        self.group, self.rank, self.size = group, int(rank), int(size)
        self.live = group is not None and self.size > 1

    def part(self, n: int) -> int:
        """This rank's share of ``n`` (``n`` must divide)."""
        if n % self.size:
            raise ValueError(f"{n} does not divide over tp={self.size}")
        return n // self.size

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM all-reduce in place."""
        if self.live:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def max_(self, t: torch.Tensor) -> torch.Tensor:
        """MAX all-reduce in place (the amaxes of sharded operands)."""
        if self.live:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """Identity forward, SUM of the cotangents over the group
        backward: a replicated tensor entering this rank's shard of a
        computation."""
        return _CopyIn.apply(x, self) if self.live else x

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        """SUM over the group forward (a new tensor), identity backward:
        the partial products of a row-parallel GEMM recombined."""
        return _ReduceOut.apply(x, self) if self.live else x


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group: TensorGroup):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.sum_(g.clone(
            memory_format=torch.contiguous_format)), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group: TensorGroup):
        return group.sum_(x.detach().clone(
            memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


class SequenceGroup:
    """A rank's sequence-parallel group: ``group`` (a process group; None
    with ``size`` 1: one shard, every collective the identity), this
    rank's index ``rank`` in it (its positions start at ``rank * L/S``)
    and its ``size``.  The four primitives (``_rotate``, ``_all_to_all``,
    ``_all_gather``, ``_all_reduce``) are the only places that talk to
    the group; the differentiable collectives are built on them."""

    def __init__(self, group=None, rank: int = 0, size: int = 1):
        self.group, self.rank, self.size = group, int(rank), int(size)
        self.live = self.size > 1

    def part(self, n: int) -> int:
        """This rank's share of ``n`` (``n`` must divide)."""
        if n % self.size:
            raise ValueError(f"{n} does not divide over sp={self.size}")
        return n // self.size

    # -- primitives ----------------------------------------------------------
    def _host(self, t: torch.Tensor) -> bool:
        """Whether ``t`` travels through the host (gloo and a card)."""
        return t.is_cuda and dist.get_backend(self.group) == "gloo"

    def _peer(self, i: int) -> int:
        """The global rank of sp index ``i``."""
        return dist.get_global_rank(self.group, i % self.size)

    def _rotate(self, t: torch.Tensor, shift: int) -> torch.Tensor:
        """``t`` sent to sp index ``rank + shift``; returns what sp index
        ``rank - shift`` sent."""
        src = t.contiguous()
        host = self._host(src)
        if host:
            src = src.cpu()
        got = torch.empty_like(src)
        ops = [dist.P2POp(dist.isend, src, self._peer(self.rank + shift),
                          self.group),
               dist.P2POp(dist.irecv, got, self._peer(self.rank - shift),
                          self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return got.to(t.device) if host else got

    def _all_to_all(self, chunks: list) -> list:
        """Chunk ``j`` (all of one shape) sent to sp index ``j``; returns
        the chunks every index sent here, in index order.  One
        ``all_to_all_single`` on the stacked chunks: gloo has no list
        all-to-all in every torch release, the single-tensor one it has."""
        dev = chunks[0].device
        send = torch.stack(chunks)
        host = self._host(send)
        if host:
            send = send.cpu()
        got = torch.empty_like(send)
        dist.all_to_all_single(got, send, group=self.group)
        return list((got.to(dev) if host else got).unbind(0))

    def _all_gather(self, t: torch.Tensor) -> list:
        return all_gather(t, self.size, self.group)

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        dist.all_reduce(t, op=op, group=self.group)
        return t

    # -- collectives -----------------------------------------------------------
    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM all-reduce in place."""
        return self._all_reduce(t, dist.ReduceOp.SUM) if self.live else t

    def max_(self, t: torch.Tensor) -> torch.Tensor:
        """MAX all-reduce in place (the amaxes of a sequence shard)."""
        return self._all_reduce(t, dist.ReduceOp.MAX) if self.live else t

    def rotate(self, t: torch.Tensor) -> torch.Tensor:
        """The ring step: ``t`` moves to the next sp index and this rank
        gets the previous one's (backward: the cotangents rotate back)."""
        return _Rotate.apply(t, self, 1) if self.live else t

    def swap(self, x: torch.Tensor, split: int, concat: int
             ) -> torch.Tensor:
        """The tiled all-to-all: ``x`` cut in ``size`` chunks along dim
        ``split``, chunk ``j`` to sp index ``j``, the chunks received
        concatenated along ``concat`` in index order (JAX's
        ``all_to_all(split_axis, concat_axis, tiled=True)``).  Backward:
        the inverse swap."""
        return _Swap.apply(x, self, split, concat) if self.live else x

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every index's ``t`` concatenated along ``dim`` in index order
        (no gradient: the key mask)."""
        if not self.live:
            return t
        return torch.cat(self._all_gather(t.detach()), dim=dim)

    def broadcast0(self, x: torch.Tensor) -> torch.Tensor:
        """sp index 0's ``x`` on every rank (the others' ``x`` is not
        read); backward: the cotangents SUMmed onto index 0."""
        return _Broadcast0.apply(x, self) if self.live else x


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group: SequenceGroup, shift: int):
        ctx.group, ctx.shift = group, shift
        return group._rotate(t.detach(), shift)

    @staticmethod
    def backward(ctx, g):
        return ctx.group._rotate(g, -ctx.shift), None, None


def _swap(group: SequenceGroup, x: torch.Tensor, split: int,
          concat: int) -> torch.Tensor:
    n = x.shape[split]
    if n % group.size:
        raise ValueError(f"dim {split} of {tuple(x.shape)} does not divide "
                         f"over sp={group.size}")
    chunks = list(torch.split(x, n // group.size, dim=split))
    return torch.cat(group._all_to_all(chunks), dim=concat)


class _Swap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group: SequenceGroup, split: int, concat: int):
        ctx.group, ctx.dims = group, (split, concat)
        return _swap(group, x.detach(), split, concat)

    @staticmethod
    def backward(ctx, g):
        split, concat = ctx.dims
        return _swap(ctx.group, g, concat, split), None, None, None


class _Broadcast0(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group: SequenceGroup):
        ctx.group = group
        out = (x.detach().clone(memory_format=torch.contiguous_format)
               if group.rank == 0 else torch.zeros_like(
                   x, memory_format=torch.contiguous_format))
        return group.sum_(out)

    @staticmethod
    def backward(ctx, g):
        g = ctx.group.sum_(g.clone(memory_format=torch.contiguous_format))
        return (g if ctx.group.rank == 0 else torch.zeros_like(g)), None


class PipeGroup:
    """A rank's pipeline group: the ranks of its data index, one a pp
    stage (``ranks[s]``: the global rank of stage s), ``group`` their
    process group, this rank's ``stage`` and the ``size`` S.  It moves a
    microbatch's activation or cotangent between the ranks of
    neighbouring chunks (``exchange``), SUMs over pp (a shared leaf's
    gradient, the clip's norm parts) and broadcasts a stage's values (the
    last stage's metrics, a stage-owned leaf for a checkpoint).  Under
    gloo a card's tensors travel through the host, as ``SequenceGroup``'s
    do."""

    def __init__(self, group=None, stage: int = 0, size: int = 1,
                 ranks=None):
        self.group, self.stage, self.size = group, int(stage), int(size)
        self.ranks = list(ranks) if ranks is not None else [0]
        self.live = group is not None and self.size > 1

    def _host(self, t: torch.Tensor) -> bool:
        return t.is_cuda and dist.get_backend(self.group) == "gloo"

    def exchange(self, sends, recvs, shape, dtype, device) -> list:
        """One tick's hops, posted together: ``sends`` (stage, tensor,
        tag), ``recvs`` (stage, tag) of a ``shape`` / ``dtype`` tensor;
        returns the received tensors on ``device`` in ``recvs``' order.
        Both ends of a pair post in the same order with the same tags."""
        ops, bufs, outs = [], [], []
        for stage, t, tag in sends:
            src = t.contiguous()
            if self._host(src):
                src = src.cpu()
            bufs.append(src)
            ops.append(dist.P2POp(dist.isend, src, self.ranks[stage],
                                  self.group, tag))
        host = (torch.device(device).type == "cuda"
                and dist.get_backend(self.group) == "gloo")
        for stage, tag in recvs:
            buf = torch.empty(shape, dtype=dtype,
                              device="cpu" if host else device)
            outs.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, self.ranks[stage],
                                  self.group, tag))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return [o.to(device) for o in outs] if host else outs

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM all-reduce over pp in place."""
        if self.live:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor, stage: int) -> torch.Tensor:
        """Stage ``stage``'s ``t`` on every rank of the group, in place."""
        if not self.live:
            return t
        if self._host(t):
            buf = t.detach().cpu()
            dist.broadcast(buf, self.ranks[stage], group=self.group)
            with torch.no_grad():
                t.copy_(buf)
            return t
        dist.broadcast(t, self.ranks[stage], group=self.group)
        return t


def all_gather(t: torch.Tensor, world: int, group=None) -> list:
    """Every rank's ``t`` (equal shapes), in rank order.  gloo gathers
    host tensors only: a card's tensor is staged through the host."""
    src = t.contiguous()
    host = src.is_cuda and dist.get_backend(group) == "gloo"
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts] if host else parts


def all_max_(t: torch.Tensor) -> torch.Tensor:
    """MAX all-reduce in place over the active step's group and its sp
    group (the identity outside a step or in one process): the
    quantizers' amaxes."""
    g = current()
    if g is None:
        return t
    g.max_(t)
    return t if g.seq is None else g.seq.max_(t)


def _comm_device(group=None) -> torch.device:
    """Where a host value travels: the current card under NCCL, else the
    CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_across_processes(value, group=None) -> np.ndarray:
    """A host scalar/array from every process stacked on a new leading
    axis ``[world, ...]``, dtype-preserving: the bytes travel as uint8,
    so int64 and fp64 values survive whole.  One process: the value with
    the axis added."""
    arr = np.asarray(value)
    if not dist.is_initialized():
        return arr[None]
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    dev = _comm_device(group)
    t = torch.from_numpy(flat.copy()).to(dev)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    g = torch.stack(parts).cpu().numpy()
    return g.view(arr.dtype).reshape((g.shape[0],) + arr.shape)


def all_sum_across_processes(value, group=None) -> np.ndarray:
    """SUM of a host scalar/array across processes (the value itself in
    one process)."""
    if not dist.is_initialized():
        return np.asarray(value)
    return all_gather_across_processes(value, group).sum(axis=0)


def all_reduce_metrics(metrics: Dict[str, float], group=None
                       ) -> Dict[str, float]:
    """SUM a dict of per-process counters across processes with one
    collective: the values packed into one float64 vector (exact to
    2^53), gathered, summed on the host and unpacked; scalars come back
    as floats."""
    if not dist.is_initialized() or not metrics:
        return dict(metrics)
    parts = [np.ravel(np.asarray(metrics[k], np.float64)) for k in metrics]
    summed = all_gather_across_processes(np.concatenate(parts),
                                         group).sum(axis=0)
    out, off = {}, 0
    for k, p in zip(metrics, parts):
        v = summed[off:off + p.size]
        off += p.size
        out[k] = float(v[0]) if p.size == 1 else v
    return out
