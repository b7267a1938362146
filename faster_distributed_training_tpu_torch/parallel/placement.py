"""Where the training state and the batches live under a data mesh (the
JAX package's ``parallel/placement.py``), and the collectives around the
step that XLA inserts for JAX.

The reference's distribution strategies, as JAX maps them onto shardings
and this module onto one process a rank:

  * dp: the batch split over the ranks, the state replicated; the
    gradients SUM all-reduced and divided by the world (DDP's mean);
  * fsdp (ZeRO-3): the parameters and the optimizer state sharded by
    ``sharding.fsdp_partition_params``; before a forward the parameters
    are all-gathered, the gradients are reduced and each rank updates
    its own shard, and between steps only the shard stays;
  * zero1: the optimizer state alone sharded; each rank updates its
    shard of every parameter and the slices are all-gathered after;
  * tp (``--mesh tp=N``): each rank's model holds its tp shards of the
    weights (``sharding.tp_cut``; the data group is then one rank of
    each tp group), and unless ``--no_zero_opt`` (JAX's ZeRO over
    tp) the optimizer mirrors of the replicated parameters are sharded
    over the tp group by ``sharding.zero_opt_dims``: each rank updates
    its slice and the slices are all-gathered after, zero1's machinery
    over tp.  ``whole()`` gathers the tp shards too, so a checkpoint
    holds whole leaves at any mesh;
  * sp (``--mesh sp=S``): each rank of an sp group runs its positions of
    its data shard's rows with the whole state, replicated over sp as in
    JAX (whose ZeRO overlay rolls over tp or pp, never sp); the gradients
    are SUMmed over sp (each rank's is its positions' part) and MEANed
    over dp in one all-reduce over the run, and the metrics summed over
    both;
  * pp (``--mesh pp=P``): each rank runs its stage's layers
    (``parallel.pipeline``); the data group holds the ranks of its stage
    and ``pipe`` its pipeline group.  Under residency (the default) a
    stage-owned leaf, its optimizer mirrors and its amax histories live
    on their stage only (``sharding.pp_stage_homes``; the other ranks
    hold empty tensors in their place) and the shared leaves (the
    embeddings, the head) on every stage; ``--no_pp_residency`` keeps
    every leaf on every rank.  A stage-owned leaf's gradient is MEANed
    over the stage's data group; a shared leaf's is SUMmed over pp (stage
    0's lookup part and, under a tied head, the last stage's) and then
    MEANed over dp; without residency every gradient is SUMmed over pp
    (zero off its stage), so every rank updates every leaf alike.  The
    clip's norm sums each stage's own leaves' squares over pp and counts
    the shared ones once.  ``whole()`` gathers every stage-owned leaf from
    its stage;
  * ``--host_offload``: the parameters (their shards) and the optimizer
    state rest in pinned host memory between steps; ``--offload_opt_state``
    the optimizer leaves ``offload_opt_leaf`` picks.  They are copied to
    the card on a side stream before use, updated on the card and copied
    back, so the numbers are the resident run's bit for bit.  On the CPU
    the tier is host memory too: the leaves are parked in separate
    buffers and copied back, the same path.

The reduce-scatter of the gradients is an all-reduce followed by the
rank's slice (gloo has no reduce-scatter, and NCCL's cuts dim 0 only):
every rank then holds the whole reduced gradient, and the global norm
of a sharded update is summed over the shards (``optim.builder``).
Ranks are row-major over the mesh: rank r holds global rows
``[r * Bl, (r + 1) * Bl)`` of every batch.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from faster_distributed_training_tpu_torch.parallel.collectives import (
    DataGroup, all_gather)
from faster_distributed_training_tpu_torch.parallel.mesh import (DATA_AXES,
                                                                 axis_size)
from faster_distributed_training_tpu_torch.parallel.sharding import (
    apply_tp_rules, bucketed_grad_reduce, fsdp_partition_params,
    offload_opt_leaf, pp_stage_homes, tp_shard, tp_unshard, zero_opt_dims)

# the metrics summed over ranks (the loss is then divided by the world)
_SUMMED = ("loss", "loss_total", "correct", "total")


def data_axes(mesh) -> tuple:
    """The mesh's data axes (dp, fsdp) that it has."""
    if mesh is None:
        return ()
    return tuple(a for a in DATA_AXES if a in (mesh.mesh_dim_names or ()))


def dp_size(mesh) -> int:
    """The number of batch shards: the product of the data axes."""
    n = 1
    for a in data_axes(mesh):
        n *= axis_size(mesh, a)
    return max(n, 1)


def make_put_batch(group: DataGroup, device, stacked: bool = False
                   ) -> Callable[[Dict[str, Any]], Dict[str, torch.Tensor]]:
    """put(batch): a GLOBAL host batch -> this rank's rows of it as
    tensors on ``device`` (``train.steps.to_device``).  ``stacked``: the
    leaves carry a leading K (steps a dispatch) axis, split below it."""
    from faster_distributed_training_tpu_torch.train.steps import to_device

    def put(batch):
        out = {}
        for k, v in batch.items():
            v = np.asarray(v)
            ax = 1 if stacked else 0
            if v.ndim > ax:
                rows = v.shape[ax] // group.world
                r0 = group.origin(rows)
                v = np.take(v, np.arange(r0, r0 + rows), axis=ax)
            out[k] = v
        return to_device(out, device)

    return put


def _opt_items(tree, path=()):
    """(path, parent dict, key, tensor) of every tensor of an optimizer
    state tree."""
    for k, v in tree.items():
        if torch.is_tensor(v):
            yield path + (k,), tree, k, v
        elif isinstance(v, dict):
            yield from _opt_items(v, path + (k,))


class Placement:
    """The state's layout under ``cfg``'s mesh strategy and the
    collectives of the step.  Built once a run; ``shard_state`` takes the
    whole state to its resting layout, ``unpark`` / ``park`` bracket
    every use of the parameters (a train step, an eval pass), and
    ``unshard`` brings the whole state back (a checkpoint)."""

    def __init__(self, cfg, mesh, device, group: Optional[DataGroup] = None,
                 tp=None):
        self.group = group if group is not None else DataGroup()
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.fsdp = bool(cfg.fsdp)
        self.zero1 = bool(cfg.zero1) and not self.fsdp
        self.tp = tp if tp is not None and tp.size > 1 else None
        self.zero_tp = (self.tp is not None and bool(cfg.zero_opt)
                        and not (self.fsdp or self.zero1))
        axis = None
        if self.fsdp:
            axis = "fsdp"
        elif self.zero1:
            # JAX's zero1 axis: fsdp when the mesh splits it, else dp
            axis = "fsdp" if axis_size(mesh, "fsdp") > 1 else "dp"
        self.shard_pg, self.n, self.r = None, 1, 0
        if self.zero_tp:
            self.shard_pg, self.n, self.r = (self.tp.group, self.tp.size,
                                             self.tp.rank)
        elif axis is not None and mesh is not None and axis in (
                mesh.mesh_dim_names or ()):
            self.shard_pg = mesh.get_group(axis)
            self.n = axis_size(mesh, axis)
            self.r = mesh.get_local_rank(axis)
        # the one writer of the blocks this rank holds in a sharded
        # checkpoint: coordinate 0 on every mesh axis but the shard axis
        # (its blocks differ by rank) and pp (its stages hold different
        # leaves)
        self.replica0 = mesh is None or all(
            mesh.get_local_rank(ax) == 0
            for ax in (mesh.mesh_dim_names or ())
            if ax != "pp" and not (ax == axis and self.sharding_axis(axis)))
        self.cuts: Dict[str, Optional[str]] = {}   # name -> tp cut
        self._whole: Dict[str, tuple] = {}        # name -> whole shape
        self.heads = 0
        self.tp_whole = False
        self.offload_params = bool(cfg.host_offload)
        self.offload_opt = ("all" if cfg.host_offload else
                            "big" if cfg.offload_opt_state else None)
        self.bucket_bytes = (int(cfg.overlap_bucket_mb) << 20
                             if cfg.overlap_grad_reduce else 0)
        self.dims: Dict[str, Optional[int]] = {}
        self.layout: Dict[str, tuple] = {}      # name -> (shape, stride)
        self.rest: Dict[str, torch.Tensor] = {}  # parked parameter storage
        self.host: Dict[Any, torch.Tensor] = {}  # persistent host buffers
        self.parked_opt: Dict[tuple, torch.Tensor] = {}
        self.parked = False
        self.sharded = False
        self.side = (torch.cuda.Stream(self.device) if self.cuda and (
            self.offload_params or self.offload_opt) else None)
        # pp: the pipeline group, the spec, residency and each leaf's stage
        # (None: shared), with the whole shapes of the stage-owned leaves
        self.pipe = self.group.pipe
        self.spec = None
        if self.pipe is not None:
            from faster_distributed_training_tpu_torch.parallel.pipeline import (
                build_pipeline_spec)
            self.spec = build_pipeline_spec(cfg, mesh)
        self.residency = self.pipe is not None and bool(cfg.pp_residency)
        self.homes: Dict[str, Optional[int]] = {}
        self.pp_shapes: Dict[str, tuple] = {}
        # the last step's waits at the stage boundary, in seconds
        self.pp_wait: list = []

    # -- the layout ---------------------------------------------------------
    def sharding_axis(self, axis) -> bool:
        """Whether ``axis`` is the mesh axis this rank's optimizer (and
        fsdp parameter) shards are cut along."""
        return axis is not None and self.n > 1 and not self.zero_tp

    @property
    def sharding(self) -> bool:
        return (self.fsdp or self.zero1 or self.zero_tp) and self.n > 1

    def _plan(self, params) -> None:
        """Each parameter's layout and shard dim (from the whole
        parameters: under tp, the rank's tp shards)."""
        self.layout = {k: (tuple(p.shape), tuple(p.stride()))
                       for k, p in params.items()}
        if self.tp is not None:
            self.cuts = apply_tp_rules(params)
        if self.zero_tp:
            self.dims = zero_opt_dims(params, self.cuts, self.n)
        else:
            self.dims = (fsdp_partition_params(params, self.n)
                         if self.sharding else {k: None for k in params})

    def table(self, state) -> Dict[str, dict]:
        """Every parameter and optimizer leaf by path: the dim it shards
        on (None: whole) and whether it rests in host memory."""
        params = state.params()
        if not self.layout:
            self._plan(params)
        out = {f"params/{k}": {"dim": self.dims[k] if self.fsdp else None,
                               "host": self.offload_params,
                               "tp": self.cuts.get(k)}
               for k in params}
        for path, _, k, t in _opt_items(state.opt_state):
            mirror = self._mirror_any(k, t)
            out["opt/" + "/".join(path)] = {
                "dim": self.dims[k] if mirror else None,
                "host": self._offloads_opt(self._full_shape(k, t)),
                "tp": self.cuts.get(k) if mirror else None}
        return out

    def _full_shape(self, k: str, t: torch.Tensor) -> tuple:
        """The whole shape of optimizer leaf ``t`` of key ``k``."""
        return self.layout[k][0] if self._mirror_any(k, t) else tuple(
            t.shape)

    def _offloads_opt(self, shape) -> bool:
        return self.offload_opt == "all" or (
            self.offload_opt == "big" and offload_opt_leaf(shape))

    def _cut(self, t: torch.Tensor, d: int) -> torch.Tensor:
        """This rank's slice of ``t`` along ``d`` (a view)."""
        c = t.shape[d] // self.n
        return t.narrow(d, self.r * c, c)

    def _gather_dim(self, shard: torch.Tensor, d: int,
                    out: torch.Tensor) -> torch.Tensor:
        """The shards of every rank of the shard group, concatenated along
        ``d`` into ``out``."""
        parts = all_gather(shard, self.n, self.shard_pg)
        out.copy_(torch.cat(parts, dim=d))
        return out

    def shard_state(self, state) -> None:
        """Take a whole, resident state to its resting layout: under tp
        the whole leaves (after ``unshard``) cut to the rank's tp shards,
        the optimizer leaves of sharded parameters cut to this rank's
        slice, then ``park``."""
        if self.tp_whole:
            self._tp_cut(state)
        params = state.params()
        self._plan(params)
        if self.sharding:
            for _, parent, k, t in list(_opt_items(state.opt_state)):
                d = self.dims.get(k)
                if d is not None and tuple(t.shape) == self.layout[k][0]:
                    parent[k] = self._cut(t, d).clone()
        if self.sharding or self.tp is not None:
            # the global norm sums the shards' squares over the group
            state.tx.shards = (self.sharded_names(), self.sum_over_shards)
        if self.pipe is not None:
            self._pp_plan(state)
            stage = self.pipe.stage
            mine = {k for k, h in self.homes.items() if h == stage}
            others = {k for k, h in self.homes.items()
                      if h is not None and h != stage}
            # this stage's leaves' squares SUMmed over pp; the shared
            # leaves once; the other stages' (held without residency)
            # counted on their own stage
            state.tx.shards = (mine, self.pipe.sum_, others)
            if self.residency:
                self._pp_drop(state)
        self.sharded = True
        self.park(state)

    def unshard(self, state) -> None:
        """Back to the whole state on the card: ``unpark``, then every
        sharded optimizer leaf all-gathered whole, and under tp every
        tp-cut parameter and its optimizer mirrors gathered whole (the
        model's parameters then hold whole tensors: for a checkpoint, not
        a forward)."""
        self.unpark(state)
        if self.sharding and self.sharded:
            for _, parent, k, t in list(_opt_items(state.opt_state)):
                d = self.dims.get(k)
                if (d is not None and self._mirror_any(k, t)
                        and tuple(t.shape) != self.layout[k][0]):
                    full = torch.empty(self.layout[k][0], dtype=t.dtype,
                                       device=t.device)
                    parent[k] = self._gather_dim(t, d, full)
        if self.tp is not None and self.sharded and not self.tp_whole:
            self._tp_gather(state)
        if self.pipe is not None and self.sharded:
            self._pp_gather(state)
        self.sharded = False

    def _tp_leaves(self, state):
        """(setter, name, tensor) of every tp-cut parameter and optimizer
        mirror of one."""
        for k, p in state.params().items():
            if self.cuts.get(k) is not None:
                yield (lambda t, p=p: setattr(p, "data", t)), k, p.data
        for _, parent, k, t in list(_opt_items(state.opt_state)):
            if self.cuts.get(k) is not None and k in self.layout and tuple(
                    t.shape) in (self.layout[k][0], self._whole[k]):
                yield (lambda v, parent=parent, k=k:
                       parent.__setitem__(k, v)), k, t

    def _tp_gather(self, state) -> None:
        """Every tp-cut leaf all-gathered whole over the tp group."""
        self._whole = {k: state.model.whole_shape(k, self.layout[k][0])
                       for k in self.cuts if self.cuts[k] is not None}
        self.heads = int(getattr(state.model, "h", 0))
        with torch.no_grad():
            for put, k, t in list(self._tp_leaves(state)):
                parts = all_gather(t.contiguous(), self.tp.size,
                                   self.tp.group)
                cut = self.cuts[k]
                put(tp_unshard(parts, cut, self.heads, None if cut == "heads"
                               else self._whole[k][cut == "cols"]))
        self.tp_whole = True

    def _tp_cut(self, state) -> None:
        """Every whole tp-cut leaf cut back to this rank's shard."""
        with torch.no_grad():
            for put, k, t in list(self._tp_leaves(state)):
                if tuple(t.shape) == self._whole[k]:
                    put(tp_shard(t, self.cuts[k], self.tp.rank, self.tp.size,
                                 self.heads))
        self.tp_whole = False

    # -- pipeline residency -------------------------------------------------
    def _pp_leaves(self, state):
        """(setter, name, tensor) of every stage-owned leaf: parameters,
        persistent buffers (the amax histories) and optimizer mirrors."""
        params = dict(state.model.named_parameters())
        for k, t in state.model.state_dict(keep_vars=True).items():
            if self.homes.get(k) is None:
                continue
            if k in params:
                yield (lambda v, p=params[k]: setattr(p, "data", v)), k, t
            else:
                mod, _, attr = k.rpartition(".")
                owner = state.model.get_submodule(mod)
                yield (lambda v, o=owner, a=attr: setattr(o, a, v)), k, t
        for _, parent, k, t in list(_opt_items(state.opt_state)):
            if self.homes.get(k) is not None and tuple(t.shape) in (
                    self.pp_shapes[k], (0,)):
                yield (lambda v, parent=parent, k=k:
                       parent.__setitem__(k, v)), k, t

    def _pp_plan(self, state) -> None:
        """Each leaf's stage and the stage-owned leaves' whole shapes
        (from the whole state)."""
        sd = state.model.state_dict()
        self.homes = pp_stage_homes(list(sd), self.spec)
        self.pp_shapes = {k: tuple(v.shape) for k, v in sd.items()
                          if self.homes[k] is not None}

    def own(self, name: str) -> bool:
        """Whether this rank holds leaf ``name``."""
        home = self.homes.get(name)
        return (not self.residency or home is None
                or home == self.pipe.stage)

    def _pp_drop(self, state) -> None:
        """Residency: every other stage's leaves replaced by empty
        tensors."""
        with torch.no_grad():
            for put, k, t in list(self._pp_leaves(state)):
                if not self.own(k):
                    put(torch.empty(0, dtype=t.dtype, device=t.device))

    def _pp_gather(self, state) -> None:
        """Every stage-owned leaf broadcast whole from its stage (without
        residency too: the other stages' amax histories are stale)."""
        with torch.no_grad():
            for put, k, t in sorted(self._pp_leaves(state),
                                    key=lambda x: x[1]):
                whole = t.detach() if tuple(t.shape) == self.pp_shapes[
                    k] else torch.empty(self.pp_shapes[k], dtype=t.dtype,
                                        device=t.device)
                self.pipe.broadcast_(whole, self.homes[k])
                if whole is not t:
                    put(whole)

    def resident_bytes(self, state) -> int:
        """The bytes this rank holds between steps: parameters, persistent
        buffers and optimizer tensors."""
        n = sum(t.numel() * t.element_size()
                for t in state.model.state_dict().values())
        n += sum(t.numel() * t.element_size()
                 for _, _, _, t in _opt_items(state.opt_state))
        return int(n)

    @contextlib.contextmanager
    def whole(self, state):
        """The whole state resident for the ``with`` block (every rank
        enters: the gathers are collective), then the resting layout."""
        self.unshard(state)
        try:
            yield state
        finally:
            self.shard_state(state)

    @contextlib.contextmanager
    def materialized(self, state):
        """The parameters whole on the card for the ``with`` block (an
        eval pass), then parked."""
        self.unpark(state)
        try:
            yield state
        finally:
            self.park(state)

    # -- the host tier ------------------------------------------------------
    def _to_host(self, key, t: torch.Tensor) -> torch.Tensor:
        """``t`` copied into its persistent host buffer (pinned, on the
        side stream, on a card; a plain copy on the CPU)."""
        buf = self.host.get(key)
        if buf is None or buf.shape != t.shape:
            buf = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                      device="cpu", pin_memory=self.cuda)
            self.host[key] = buf
        if not self.cuda:
            return buf.copy_(t)
        self.side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.side):
            buf.copy_(t, non_blocking=True)
        t.record_stream(self.side)
        return buf

    def _to_device(self, buf: torch.Tensor) -> torch.Tensor:
        """A host buffer back on the card (side stream; the compute stream
        waits for it)."""
        if not self.cuda:
            return buf.clone()
        cur = torch.cuda.current_stream(self.device)
        self.side.wait_stream(cur)
        with torch.cuda.stream(self.side):
            t = torch.empty_strided(buf.shape, buf.stride(), dtype=buf.dtype,
                                    device=self.device)
            t.copy_(buf, non_blocking=True)
        cur.wait_stream(self.side)
        t.record_stream(cur)
        return t

    def park(self, state) -> None:
        """The resting layout: an fsdp parameter keeps only its shard, an
        offloaded one (or its shard) moves to the host; the offloaded
        optimizer leaves move to the host."""
        if self.parked or not self.sharded:
            return
        for k, p in state.params().items():
            d = self.dims.get(k) if self.fsdp else None
            if d is None and not self.offload_params:
                continue
            rest = p.data if d is None else self._cut(p.data, d).clone()
            if self.offload_params:
                rest = self._to_host(("param", k), rest)
            self.rest[k] = rest
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        if self.offload_opt:
            for path, parent, k, t in list(_opt_items(state.opt_state)):
                if self._offloads_opt(self._full_shape(k, t)):
                    parent[k] = self._to_host(("opt",) + path, t)
                    self.parked_opt[path] = parent[k]
        self.parked = True

    def _mirror_any(self, k: str, t: torch.Tensor) -> bool:
        """Whether ``t`` is a (possibly sliced) optimizer mirror of
        parameter ``k``."""
        if k not in self.layout:
            return False
        full = self.layout[k][0]
        d = self.dims.get(k)
        if tuple(t.shape) == full:
            return True
        return d is not None and tuple(t.shape) == tuple(
            s // self.n if i == d else s for i, s in enumerate(full))

    def unpark(self, state) -> None:
        """Everything parked back on the card, the fsdp parameters
        all-gathered whole."""
        if not self.parked:
            return
        if self.parked_opt:
            for path, parent, k, t in list(_opt_items(state.opt_state)):
                if path in self.parked_opt:
                    parent[k] = self._to_device(t)
            self.parked_opt.clear()
        for k, p in state.params().items():
            if k not in self.rest:
                continue
            rest = self.rest.pop(k)
            if self.offload_params:
                rest = self._to_device(rest)
            d = self.dims.get(k) if self.fsdp else None
            if d is not None:
                shape, stride = self.layout[k]
                full = torch.empty_strided(shape, stride, dtype=rest.dtype,
                                           device=rest.device)
                rest = self._gather_dim(rest, d, full)
            p.data = rest
        self.parked = False

    # -- the step's collectives --------------------------------------------
    def reduce_grads(self, grads: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The mean over the data ranks of every gradient: one SUM
        all-reduce a flat bucket (``--overlap_grad_reduce``: asynchronous
        buckets of ``--overlap_bucket_mb``), then / world.  Under sp the
        all-reduce spans the run (dp x sp; sp has no tp beside it), so
        each gradient is SUMmed over sp before the mean over dp."""
        g = self.group
        if not g.live:
            return grads
        if self.pipe is not None:
            # pp: the shared leaves (every leaf without residency) SUMmed
            # over pp first, then everything MEANed over the stage's data
            # group
            over = {k: v for k, v in grads.items()
                    if not self.residency or self.homes.get(k) is None}
            grads = {**grads, **bucketed_grad_reduce(
                over, self.pipe.group, self.bucket_bytes)}
            return bucketed_grad_reduce(grads, g.group, self.bucket_bytes,
                                        g.world)
        return bucketed_grad_reduce(grads, None if g.seq else g.group,
                                    self.bucket_bytes, g.world)

    def local(self, grads: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        """The reduced gradients cut to this rank's shard of each sharded
        parameter (the update's half of the reduce-scatter)."""
        if self.residency:
            return {k: v for k, v in grads.items() if self.own(k)}
        if not self.sharding:
            return grads
        return {k: (v if self.dims.get(k) is None else
                    self._cut(v, self.dims[k])) for k, v in grads.items()}

    def update_views(self, state) -> Dict[str, torch.Tensor]:
        """The parameters the optimizer updates in place: this rank's
        slice (a view) of each sharded one, the others whole; under pp
        residency the leaves this rank holds."""
        params = state.params()
        if self.residency:
            return {k: p for k, p in params.items() if self.own(k)}
        if not self.sharding:
            return params
        return {k: (p if self.dims.get(k) is None else
                    self._cut(p.data, self.dims[k]))
                for k, p in params.items()}

    def after_update(self, state) -> None:
        """zero1 and ZeRO over tp: every rank's updated slices all-gathered
        into the whole parameters (fsdp keeps its slice: ``park`` takes
        it)."""
        if not ((self.zero1 or self.zero_tp) and self.sharding):
            return
        with torch.no_grad():
            for k, p in state.params().items():
                d = self.dims.get(k)
                if d is not None:
                    self._gather_dim(self._cut(p.data, d), d, p.data)

    def sharded_names(self) -> set:
        """The parameters whose update this rank holds a slice of: its
        shard (fsdp, zero1, ZeRO over tp) or its tp shard."""
        names = {k for k, c in self.cuts.items() if c is not None}
        if self.sharding:
            names |= {k for k, d in self.dims.items() if d is not None}
        return names

    def sum_over_shards(self, t: torch.Tensor) -> torch.Tensor:
        """SUM all-reduce over the shard group (in place): the tp group
        under tp."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM,
                        group=self.tp.group if self.tp is not None
                        else self.shard_pg)
        return t

    def reduce_metrics(self, metrics: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """The step's metrics over the global batch: the sums of every
        rank's ``loss``, ``loss_total``, ``correct`` and ``total`` in one
        all-reduce (under sp, over the sp group too), the loss divided by
        the data world; under pp the last stage's, broadcast to every
        stage."""
        g = self.group
        keys = [k for k in _SUMMED if k in metrics]
        if not g.live or not keys:
            return metrics
        dev = metrics[keys[0]].device
        vec = g.sum_(torch.stack([metrics[k].detach().to(dev).float()
                                  .reshape(()) for k in keys]))
        if g.seq is not None:
            g.seq.sum_(vec)
        if self.pipe is not None:
            self.pipe.broadcast_(vec, self.pipe.size - 1)
        out = dict(metrics)
        for i, k in enumerate(keys):
            out[k] = vec[i] / g.world if k == "loss" else vec[i]
        return out

    def barrier(self) -> None:
        """Every rank of the run (the data and the tp groups) waits."""
        if self.group.live:
            dist.barrier()


def train_state_shardings(state, placement: Placement) -> Dict[str, dict]:
    """The layout table of ``state`` under ``placement`` (every leaf's
    shard dim and host tier)."""
    return placement.table(state)


def shard_train_state(state, placement: Placement):
    """Place a whole, resident ``state`` by ``placement``'s table."""
    placement.shard_state(state)
    return state
