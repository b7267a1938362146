"""The train state's bytes on each card (the JAX package's
``telemetry/programs.py``, its HBM attribution: ``STATE_MEMORY_FIELDS``,
``leaf_bytes_per_chip``, ``leaf_tier`` and ``state_bytes_table``).

``state_bytes_table(state)`` splits the bytes this rank holds between
``params`` (the trainable leaves: the model's parameters and ``extra``),
``opt_state`` (the optimizer's tensors) and ``batch_stats`` (the model's
buffers: BatchNorm's running statistics, the ``--quant`` amax
histories), names the largest leaves, and gives each optimizer leaf its
tier from ``parallel/placement.py``: ``replicated`` (a whole copy on
every rank), ``sharded`` (cut over fsdp, zero1 or tp) or ``offloaded``
(parked in pinned host memory between steps).  The Trainer emits it once,
after the run's first dispatch, as the ``memory`` event of scope
``state``.

The JAX module's compile observatory (lowerings, HLO fingerprints,
retraces, ``memory_analysis``) and its sharding-drift guard have no torch
counterpart line for line; the port's program table is a table of CUDA
graphs, which comes with a later slice.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# the state table's fields (the schema lint resolves the
# record_event("memory", **state_bytes_table(...)) splat through them)
STATE_MEMORY_FIELDS = (
    "scope", "params_bytes_per_chip", "params_leaves",
    "opt_state_bytes_per_chip", "opt_state_leaves",
    "batch_stats_bytes_per_chip", "batch_stats_leaves",
    "total_bytes_per_chip", "top_leaves", "opt_state_tiers",
    "pp_residency")


def leaf_bytes_per_chip(leaf) -> int:
    """Bytes this rank holds for ``leaf``: a tensor's storage as it rests
    (a shard when it is cut), 0 for a host scalar."""
    if torch.is_tensor(leaf):
        return int(leaf.numel() * leaf.element_size())
    return 0


def leaf_tier(entry) -> str:
    """The tier of one leaf from its entry of ``Placement.table`` (None:
    no placement, one process): ``offloaded`` (in host memory between
    steps), ``sharded`` (cut along a dim, or a tp cut) or
    ``replicated``."""
    if entry is None:
        return "replicated"
    if entry.get("host"):
        return "offloaded"
    if entry.get("dim") is not None or entry.get("tp") is not None:
        return "sharded"
    return "replicated"


def _opt_tensors(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _opt_tensors(v, path + (str(k),))
        elif torch.is_tensor(v):
            yield path + (str(k),), v


def _rest(state, name: str, p: torch.Tensor):
    """The storage a parameter rests in between steps: the placement's
    parked copy when it has one, else the parameter."""
    pl = state.placement
    rest = getattr(pl, "rest", None) if pl is not None else None
    if rest and name in rest:
        return rest[name]
    return p.detach()


def state_bytes_table(state, top: int = 5) -> dict:
    """This rank's bytes of a ``TrainState`` split params / opt_state /
    batch_stats, with the ``top`` largest leaves and their tiers, the
    optimizer leaves by tier, and the pp residency (the leaves a stage
    owns and their bytes; zeros off pp or with ``--no_pp_residency``)."""
    pl = state.placement
    table = pl.table(state) if pl is not None else {}
    homes = getattr(pl, "homes", {}) if pl is not None else {}
    residency = bool(getattr(pl, "residency", False))
    groups: Dict[str, List[Tuple[str, object, object, bool]]] = {
        "params": [], "opt_state": [], "batch_stats": []}
    for name, p in state.params().items():
        groups["params"].append(
            (name, _rest(state, name, p), table.get(f"params/{name}"),
             residency and homes.get(name) is not None))
    for path, t in _opt_tensors(state.opt_state):
        key = "/".join(path)
        groups["opt_state"].append(
            (key, t, table.get(f"opt/{key}"),
             residency and homes.get(path[-1]) is not None))
    for name, b in state.model.named_buffers():
        groups["batch_stats"].append(
            (name, b, None, residency and homes.get(name) is not None))
    out: dict = {"scope": "state"}
    sized = []
    total = 0
    tiers: Dict[str, Dict[str, int]] = {}
    ppres: Dict[str, Dict[str, int]] = {}
    for group, leaves in groups.items():
        b = pp_leaves = pp_bytes = 0
        for name, t, entry, staged in leaves:
            n = leaf_bytes_per_chip(t)
            b += n
            tier = leaf_tier(entry)
            sized.append((n, f"{group}/{name}", tier))
            if staged:
                pp_leaves += 1
                pp_bytes += n
            if group == "opt_state":
                agg = tiers.setdefault(tier, {"leaves": 0,
                                              "bytes_per_chip": 0})
                agg["leaves"] += 1
                agg["bytes_per_chip"] += n
        out[f"{group}_bytes_per_chip"] = b
        out[f"{group}_leaves"] = len(leaves)
        ppres[group] = {"leaves": pp_leaves, "bytes_per_chip": pp_bytes}
        total += b
    out["total_bytes_per_chip"] = total
    out["top_leaves"] = [
        {"path": p, "bytes_per_chip": n, "tier": t}
        for n, p, t in sorted(sized, reverse=True)[:top]]
    out["opt_state_tiers"] = tiers
    out["pp_residency"] = ppres
    return out
