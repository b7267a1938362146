"""The process group and the mesh (the JAX package's
``parallel/mesh.py``).

JAX runs one SPMD program over a ``Mesh`` of devices; the port runs one
process per card, joined by ``torch.distributed`` (NCCL on the card,
gloo under ``--device cpu``), and the mesh is a ``DeviceMesh`` over the
ranks.  The port reaches the data axes, ``dp`` (batch split, state
replicated) and ``fsdp`` (batch split, parameters and optimizer state
sharded), ``tp`` (Megatron tensor parallelism: heads, the FFN's hidden
columns and the vocabulary split over the ranks of a tp group), ``sp``
(sequence parallelism: the positions of every row split over the ranks
of an sp group, the state replicated) and ``pp`` (pipeline parallelism:
the encoder's layers staged over the ranks of a pipeline group, one
process a stage; ``parallel.pipeline``).

``AXIS_ALIASES`` is the one alias table: ``--mesh data=2`` and ``--mesh
dp=2`` are the same mesh.  The model axes are laid out innermost
whatever place ``--mesh`` names them in, tp inside sp, and pp outermost
(the JAX package's policy, ``_AXIS_SPEED``: tp on the fastest links,
then sp; pp, whose stage boundary moves one activation a tick, on the
slowest; the data axes keep their order), so the ranks of a tp or sp
group are adjacent (``r = data_rank * n + model_rank``) and a pipeline
group's are ``data * model`` apart (``r = pp_rank * (data * model) +
...``).  With the batch split over every data axis, data rank d holds
the global rows ``[d * Bl, (d + 1) * Bl)`` (JAX's ``batch_spec`` order)
on every rank of its tp or sp group and on every stage.
``mesh_groups`` gives a rank its data group (the gradient reduce, the
BatchNorm and amax collectives, the mixup partners, the metrics), its tp
group and, as the data group's ``seq``, its sp group, or as its
``pipe``, its pipeline group.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# canonical name <- accepted spellings; unknown names pass through
AXIS_ALIASES = {
    "dp": "dp", "data": "dp", "batch": "dp",
    "fsdp": "fsdp", "zero": "fsdp", "zero3": "fsdp",
    "tp": "tp", "model": "tp", "mp": "tp", "tensor": "tp",
    "sp": "sp", "seq": "sp", "sequence": "sp", "context": "sp",
    "pp": "pp", "pipe": "pp", "pipeline": "pp", "stage": "pp",
}
DATA_AXES = ("dp", "fsdp")
# the model axes, laid out innermost (adjacent ranks) in this order from
# the inside: the fastest of the JAX package's _AXIS_SPEED, whose
# per-layer collectives want the fastest links
INNER_AXES = ("tp", "sp")
# laid out outermost: the slowest (JAX's _AXIS_SPEED pp: -1)
OUTER_AXES = ("pp",)
# the process group's timeout: a rank that never arrives fails the run
# instead of hanging it
PG_TIMEOUT = timedelta(minutes=10)


def canonical_axis(name: str) -> str:
    """Canonical spelling of a mesh-axis name (AXIS_ALIASES)."""
    return AXIS_ALIASES.get(str(name).strip().lower(), str(name).strip())


def canonical_axes(axes: Sequence[str]) -> Tuple[str, ...]:
    out = tuple(canonical_axis(a) for a in axes)
    if len(set(out)) != len(out):
        raise ValueError(f"mesh axes {tuple(axes)} collapse to duplicate "
                         f"canonical names {out} (see AXIS_ALIASES)")
    return out


def parse_mesh(spec: str) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """'dp=4,tp=2' -> (('dp','tp'), (4,2)).  Empty -> ((), ()).  Axis
    names are canonicalized through AXIS_ALIASES."""
    if not spec:
        return (), ()
    axes, sizes = [], []
    for part in spec.split(","):
        name, _, size = part.partition("=")
        name = name.strip()
        if not name or not size:
            raise ValueError(f"bad mesh spec {spec!r}; want 'axis=size,...'")
        axes.append(name)
        sizes.append(int(size))
    return canonical_axes(axes), tuple(sizes)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    axes: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        if os.environ.get(n):
            return int(os.environ[n])
    return None


def initialize_distributed(device_type: str = "cuda",
                           timeout: timedelta = PG_TIMEOUT) -> bool:
    """Join the run's process group once (the JAX ``initialize_distributed``
    and the reference's ``init_process_group``).  torchrun's ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``
    are read first; else JAX's ``FDT_COORDINATOR`` (host:port),
    ``FDT_NUM_PROCESSES`` and ``FDT_PROCESS_ID``.  NCCL with the card
    ``cuda:LOCAL_RANK`` made current, gloo for ``device_type="cpu"``.
    Returns False (and joins nothing) without either set of variables or
    when a group already exists."""
    if dist.is_initialized():
        return False
    world = _env_int("WORLD_SIZE", "FDT_NUM_PROCESSES")
    rank = _env_int("RANK", "FDT_PROCESS_ID")
    if world is None:
        return False
    rank = rank or 0
    if os.environ.get("MASTER_ADDR"):
        init = (f"tcp://{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
    elif os.environ.get("FDT_COORDINATOR"):
        init = f"tcp://{os.environ['FDT_COORDINATOR']}"
    else:
        raise ValueError("a distributed run needs MASTER_ADDR/MASTER_PORT "
                         "(torchrun) or FDT_COORDINATOR=host:port")
    backend = "gloo" if device_type == "cpu" else "nccl"
    kw = {}
    if backend == "nccl":
        local = _env_int("LOCAL_RANK") or 0
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, timeout=timeout, **kw)
    return True


def local_device(device_type: str) -> torch.device:
    """The rank's device: ``cuda:LOCAL_RANK`` in a group over NCCL (the
    current card otherwise), the CPU for ``cpu``."""
    if device_type == "cpu":
        return torch.device("cpu")
    local = _env_int("LOCAL_RANK")
    return torch.device("cuda", torch.cuda.current_device()
                        if local is None else local)


def ordered_axes(axes: Sequence[str], shape: Sequence[int]
                 ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """``(axes, shape)`` with tp moved innermost (last) and sp next to it,
    pp outermost (first), the other axes in their order."""
    rank = {a: len(INNER_AXES) - i for i, a in enumerate(INNER_AXES)}
    rank.update({a: -1 for a in OUTER_AXES})
    order = sorted(range(len(axes)), key=lambda i: (rank.get(axes[i], 0),
                                                     i))
    return (tuple(axes[i] for i in order),
            tuple(int(shape[i]) for i in order))


def make_mesh(axes: Sequence[str] = ("dp",), shape: Sequence[int] = (),
              device_type: str = "cuda"):
    """The ``DeviceMesh`` of the run's process group, its axes ordered by
    ``ordered_axes`` (tp, then sp, innermost; pp outermost), or None
    without a group (one process: no collective anywhere).  Empty
    ``shape`` puts every rank on the first axis.  The mesh's size must
    equal the world size."""
    axes = canonical_axes(axes)
    shape = tuple(int(s) for s in shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not shape:
        shape = (world,) + (1,) * (len(axes) - 1)
    if len(shape) != len(axes):
        raise ValueError(f"mesh axes {axes} vs shape {shape} rank mismatch")
    axes, shape = ordered_axes(axes, shape)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {dict(zip(axes, shape))} needs "
                         f"{int(np.prod(shape))} processes, the run has "
                         f"{world} (launch one process a rank: torchrun "
                         f"--nproc_per_node, or --distributed)")
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu" if device_type == "cpu" else "cuda",
                            shape, mesh_dim_names=axes)


def axis_size(mesh, name: str) -> int:
    """Size of canonical axis ``name`` in ``mesh`` (1 when absent/None)."""
    if mesh is None:
        return 1
    name = canonical_axis(name)
    names = mesh.mesh_dim_names or ()
    return int(mesh.size(names.index(name))) if name in names else 1


def tp_size(mesh) -> int:
    return axis_size(mesh, "tp")


def mesh_groups(mesh):
    """``(DataGroup, TensorGroup or None)`` of this rank (collective: every
    rank calls it once a mesh, as it builds every rank's subgroups).
    Without a model axis the data group is the world, as a data mesh had
    it; with tp or sp above 1 (the model axis, ``n``) the data group
    holds the ranks of this rank's model index (``r % n``: one a data
    rank), and the ``n`` adjacent ranks of its data rank form its tp
    group or, as the data group's ``seq``, its sp group.  With pp above 1
    (P stages of ``w = world / P`` ranks) the data group holds the ranks
    of this rank's stage (``r // w``), and the ranks of its data index
    (``r % w``, one a stage) form its pipeline group, the data group's
    ``pipe``."""
    from faster_distributed_training_tpu_torch.parallel.collectives import (
        DataGroup, PipeGroup, SequenceGroup, TensorGroup)

    tp, sp, pp = tp_size(mesh), sp_size(mesh), pp_size(mesh)
    if tp > 1 and sp > 1:
        raise NotImplementedError(f"not ported yet: --mesh sp={sp} with "
                                  f"tp={tp}")
    n = max(tp, sp)
    if pp > 1 and n > 1:
        raise NotImplementedError(
            f"not ported yet: --mesh pp={pp} with "
            + (f"tp={tp}" if tp > 1 else f"sp={sp}"))
    world, rank = dist.get_world_size(), dist.get_rank()
    if pp > 1:
        w = world // pp
        data_pg, _ = dist.new_subgroups_by_enumeration(
            [list(range(s * w, (s + 1) * w)) for s in range(pp)])
        ranks = [list(range(d, world, w)) for d in range(w)]
        pipe_pg, _ = dist.new_subgroups_by_enumeration(ranks)
        pipe = PipeGroup(pipe_pg, rank // w, pp, ranks[rank % w])
        if dist.get_backend(pipe_pg) == "nccl":
            # a first collective over the group, so that the first
            # batched send / receive is not (NCCL wants every rank of
            # the group in that call)
            dist.all_reduce(torch.zeros(1, device="cuda"), group=pipe_pg)
        return DataGroup(data_pg, pipe=pipe), None
    if n <= 1:
        return DataGroup(), None
    data_pg, _ = dist.new_subgroups_by_enumeration(
        [list(range(t, world, n)) for t in range(n)])
    model_pg, _ = dist.new_subgroups_by_enumeration(
        [list(range(d * n, (d + 1) * n)) for d in range(world // n)])
    if tp > 1:
        return DataGroup(data_pg), TensorGroup(model_pg, rank % tp, tp)
    return DataGroup(data_pg, SequenceGroup(model_pg, rank % sp, sp)), None


def sp_size(mesh) -> int:
    return axis_size(mesh, "sp")


def seq_parallel_axis(mesh: Tuple[Sequence[str], Sequence[int]]
                      ) -> Tuple[Optional[str], int]:
    """(axis name, size) sequence parallelism runs over (JAX
    ``seq_parallel_axis``): a dedicated sp axis above 1, else the tp axis
    above 1 (JAX's Megatron-style sequence parallelism rides the
    tensor-parallel group), else (None, 1).  ``mesh``: ``(axes, shape)``
    as ``--mesh`` gives them."""
    sizes = dict(zip(canonical_axes(mesh[0]), (int(s) for s in mesh[1])))
    for name in ("sp", "tp"):
        if sizes.get(name, 1) > 1:
            return name, int(sizes[name])
    return None, 1


def pp_size(mesh) -> int:
    return axis_size(mesh, "pp")


def local_batch_slice(global_batch: int, world: int, rank: int
                      ) -> Tuple[int, int]:
    """(per-process batch, this process's row offset): each process loads
    only its rows of the global batch (the DistributedSampler of the
    reference)."""
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{world} processes")
    per = global_batch // world
    return per, per * rank
