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

    def __init__(self, group=None):
        self.live = dist.is_initialized()
        self.group = group
        self.rank = dist.get_rank(group) if self.live else 0
        self.world = dist.get_world_size(group) if self.live else 1

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
    """MAX all-reduce in place over the active step's group (the identity
    outside a step or in one process): the quantizers' amaxes."""
    g = current()
    return t if g is None else g.max_(t)


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
