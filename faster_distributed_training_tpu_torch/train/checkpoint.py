"""The port's own checkpoints of the whole train state.

``<checkpoint_dir>/<name>/`` holds ``state.pt`` (the model's state dict —
parameters and buffers: the amax histories under ``--quant``, a ResNet's
BN running statistics — the trainable leaves outside the model (the
mixup lambda), the optimizer state (NGD's factors and its counter), the
fp16 loss scale, step and seed, saved with ``torch.save`` and read back
with ``weights_only=True``), ``meta.json`` (epoch, step_in_epoch,
best_acc, step) and a ``COMMIT`` marker.  Each file is written to a
temporary name and renamed; the marker is removed first and written
last, so its presence means everything before it is complete — the idiom
of the JAX package's ``train/checkpoint.py::save_pytree_checkpoint``.
Step-cadence checkpoints form a series named by global step,
``<name>_<step:09d>`` (``series_name``), which ``restore_newest`` walks
newest first (the resilience manager's restore and ``--resume``'s);
reading a series by its name
(``read_meta(d, "transformer_step")``) reads its newest committed member.
Under a mesh (``state.placement``) every rank gathers the whole state
(the collectives of ``Placement.whole``: the fsdp / zero shards and the
tp shards), rank 0 of the run writes it, and all wait for the write;
every rank restores the whole state and takes its own layout again.  A
checkpoint is the same file at any mesh, so a dp=2, fsdp=2 or tp=2 run
resumes at dp=1 and the other way round (the JAX package's interchange
contract).

The sharded form (the JAX package's two-phase commit, which the
resilience manager writes across processes and on a non-posix storage
backend): ``<name>/shards/host_<pi>.pt`` holds the blocks process ``pi``
owns (``shard_blocks``: a whole leaf, or its fsdp / zero1 slice; each
block written by exactly one process), ``host_<pi>.json`` their manifest
(leaf, region of the whole leaf, whole shape, and the host counters)
and ``host_<pi>.DONE`` lands last; process 0 writes ``meta.json`` and
``COMMIT`` once every ``DONE`` is there (``commit_sharded_checkpoint``).
``restore_checkpoint`` reads either form: the blocks are reassembled
into the whole state, which every rank takes into its own layout.
Every write goes through a ``resilience.storage`` backend.
Reading the JAX package's Orbax checkpoints is not ported yet.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from faster_distributed_training_tpu_torch.resilience import storage
from faster_distributed_training_tpu_torch.train.state import (TrainState,
                                                              settle)

_STATE = "state.pt"
_META = "meta.json"
_COMMIT = "COMMIT"
_SHARDS = "shards"


def _backend(backend) -> "storage.StorageBackend":
    return backend if backend is not None else storage.posix_backend()


def ckpt_dir(checkpoint_dir: str, name: str) -> str:
    return os.path.join(os.path.abspath(checkpoint_dir), name)


def has_checkpoint(checkpoint_dir: str, name: str, backend=None) -> bool:
    return is_committed(ckpt_dir(checkpoint_dir, name), backend)


def is_committed(path: str, backend=None) -> bool:
    """Whether ``path`` holds a complete checkpoint (its COMMIT marker,
    written last)."""
    return _backend(backend).exists(os.path.join(path, _COMMIT))


def series_name(series: str, step: int) -> str:
    """The name of the series' member at global step ``step``."""
    return f"{series}_{int(step):09d}"


def series_members(checkpoint_dir: str, series: str,
                   committed: bool = True, backend=None
                   ) -> List[Tuple[int, str]]:
    """(step, name) of the series' members, oldest first; with
    ``committed`` only those whose COMMIT marker is written."""
    pat = re.compile(re.escape(series) + r"_(\d{9})$")
    out = []
    for name in _backend(backend).list_entries(
            os.path.abspath(checkpoint_dir)):
        m = pat.match(name)
        if m and (not committed
                  or has_checkpoint(checkpoint_dir, name, backend)):
            out.append((int(m.group(1)), name))
    return sorted(out)


def restore_newest(checkpoint_dir: str, series: str, state: TrainState,
                   backend=None, newer_than: int = -1,
                   log: Callable[[str], None] = print
                   ) -> Optional[Tuple[TrainState, Dict[str, Any], int]]:
    """The series' newest committed member after step ``newer_than``
    that loads, restored into ``state`` (one that fails to load is
    logged and the walk falls back to the one before): (state, meta,
    step), or None."""
    for step, name in reversed(series_members(checkpoint_dir, series,
                                              backend=backend)):
        if step <= newer_than:
            break
        try:
            got, meta = restore_checkpoint(checkpoint_dir, name, state,
                                           backend=backend)
            return got, meta, step
        except Exception as e:
            log(f"[ckpt] checkpoint {name} is committed but failed to "
                f"restore ({e!r}); falling back to the previous one")
    return None


def resolve(checkpoint_dir: str, name: str) -> str:
    """``name`` itself when it is a committed checkpoint, else the newest
    committed member of the series ``name`` (``name`` when there is
    none)."""
    if has_checkpoint(checkpoint_dir, name):
        return name
    members = series_members(checkpoint_dir, name)
    return members[-1][1] if members else name


def _replace_atomically(path: str, write) -> None:
    storage.posix_backend().put_stream(path, write)


def _write_json(path: str, obj: dict) -> None:
    _replace_atomically(path, lambda f: f.write(json.dumps(obj).encode()))


def _to_cpu(tree: Any) -> Any:
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def _whole(state: TrainState):
    """The whole state for a ``with`` block (collective under a mesh)."""
    pl = state.placement
    return contextlib.nullcontext() if pl is None else pl.whole(state)


def is_writer(state: TrainState) -> bool:
    """Whether this process writes the run's files (rank 0 of the run)."""
    import torch.distributed as dist

    pl = state.placement
    return pl is None or not dist.is_initialized() or dist.get_rank() == 0


def save_checkpoint(checkpoint_dir: str, name: str, state: TrainState,
                    epoch: int, best_acc: float, step_in_epoch: int = 0
                    ) -> str:
    """Overwrite ``<checkpoint_dir>/<name>`` with the full state (under a
    mesh: gathered, written by rank 0; every rank returns after the
    write)."""
    path = ckpt_dir(checkpoint_dir, name)
    with _whole(state):
        if is_writer(state):
            _write(path, state, epoch, best_acc, step_in_epoch)
    if state.placement is not None:
        state.placement.barrier()
    return path


def state_payload(state: TrainState) -> Dict[str, Any]:
    """The state as ``state.pt`` holds it, the live tensors themselves
    (no copy): model state dict, extra leaves, optimizer state, loss
    scale, step and seed (the optimizer's count settled first)."""
    settle(state)
    ls = state.loss_scale
    return {"model": state.model.state_dict(), "extra": dict(state.extra),
            "opt_state": state.opt_state,
            "loss_scale": {"scale": ls.scale,
                           "growth_count": ls.growth_count},
            "step": int(state.step), "seed": int(state.seed)}


def _meta(state_step: int, epoch: int, best_acc: float,
          step_in_epoch: int) -> Dict[str, Any]:
    return {"epoch": int(epoch), "step_in_epoch": int(step_in_epoch),
            "best_acc": float(best_acc), "step": int(state_step)}


def _write(path: str, state: TrainState, epoch: int, best_acc: float,
           step_in_epoch: int) -> None:
    write_payload(path, _to_cpu(state_payload(state)),
                  _meta(state.step, epoch, best_acc, step_in_epoch))


def write_payload(path: str, payload: Dict[str, Any],
                  meta: Dict[str, Any]) -> None:
    """One single-file checkpoint of a host ``payload`` (posix): the
    COMMIT marker removed first, ``state.pt`` and ``meta.json`` written
    atomically, the marker last."""
    os.makedirs(path, exist_ok=True)
    commit = os.path.join(path, _COMMIT)
    if os.path.exists(commit):
        os.remove(commit)
    _replace_atomically(os.path.join(path, _STATE),
                        lambda f: torch.save(payload, f))
    _write_json(os.path.join(path, _META), meta)
    _write_json(commit, {"committed_unix_time": round(time.time(), 3)})


# -- the sharded form ----------------------------------------------------


def _flat(payload: Dict[str, Any]) -> Tuple[Dict[str, torch.Tensor],
                                           Dict[str, int]]:
    """(tensors, host counters) of a payload by path: ``model/<k>``,
    ``extra/<k>``, ``opt_state/<a>/<b>``, ``loss_scale/<k>``; the
    counters ``step``, ``seed`` and the optimizer's host ints."""
    tensors, scalars = {}, {"step": int(payload["step"]),
                            "seed": int(payload["seed"])}

    def walk(prefix, tree):
        for k, v in tree.items():
            if "/" in str(k):
                raise ValueError(f"checkpoint leaf name {k!r} holds a '/'")
            key = f"{prefix}/{k}"
            if isinstance(v, dict):
                walk(key, v)
            elif torch.is_tensor(v):
                tensors[key] = v
            else:
                scalars[key] = v
    for section in ("model", "extra", "opt_state", "loss_scale"):
        walk(section, payload[section])
    return tensors, scalars


def _unflat(tensors: Dict[str, torch.Tensor],
            scalars: Dict[str, Any]) -> Dict[str, Any]:
    """The payload of ``_flat``'s two dicts."""
    out: Dict[str, Any] = {"model": {}, "extra": {}, "opt_state": {},
                           "loss_scale": {}}
    for key, v in list(tensors.items()) + list(scalars.items()):
        if key in ("step", "seed"):
            out[key] = int(v)
            continue
        *parents, leaf = key.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def shard_blocks(state: TrainState, owner: Optional[Callable[[str], bool]]
                 = None) -> Tuple[List[tuple], Dict[str, Any]]:
    """This process's blocks of the state as it rests (nothing is
    gathered): ``[(key, region, whole shape, tensor)]`` and the host
    counters.  ``region`` is ``[[start, stop], ...]`` of the whole leaf,
    None for the whole leaf.  Under a placement a rank holds the fsdp /
    zero1 slices of its shard, a stage under pp residency its own
    leaves; each block has exactly one writer: the rank at coordinate 0
    on the other axes (``Placement.replica0``), shard rank 0 for a leaf
    every shard rank holds whole, the leaf's home stage under pp (stage 0
    for a shared one).  ``owner(key)`` narrows it further (on an
    fs-simulated pod host 0 writes everything, the others nothing)."""
    pl = state.placement
    tensors, scalars = _flat(state_payload(state))
    if pl is not None and pl.parked:
        # an fsdp or offloaded parameter rests in pl.rest (its slice or a
        # host copy) while the module holds an empty tensor
        for k, t in pl.rest.items():
            tensors[("extra/" if k in state.extra else "model/") + k] = t
    blocks = []
    for key, t in tensors.items():
        if owner is not None and not owner(key):
            continue
        if pl is None:
            blocks.append((key, None, tuple(t.shape), t))
            continue
        section, rest = key.split("/", 1)
        name = rest.rsplit("/", 1)[-1] if section == "opt_state" else rest
        if pl.pipe is not None:
            home = pl.homes.get(name)
            if pl.pipe.stage != (0 if home is None else home):
                continue
        if not pl.replica0:
            continue
        d = pl.dims.get(name) if pl.sharding else None
        if (d is not None and name in pl.layout
                and (section == "opt_state" or pl.fsdp)
                and tuple(t.shape) != pl.layout[name][0]):
            whole = pl.layout[name][0]
            c = whole[d] // pl.n
            region = [[0, n] for n in whole]
            region[d] = [pl.r * c, (pl.r + 1) * c]
            blocks.append((key, region, tuple(whole), t))
        elif not (pl.sharding and pl.r != 0):
            blocks.append((key, None, tuple(t.shape), t))
    return blocks, scalars


def write_host_shards(path: str, process_index: int, blocks: List[tuple],
                      scalars: Dict[str, Any], backend=None) -> None:
    """Phase 1 of the sharded save: this process's blocks
    (``host_<pi>.pt``), their manifest (``host_<pi>.json``) and, last,
    its ``host_<pi>.DONE`` marker.  An older DONE of this process is
    removed first, so a commit never takes a half-written attempt."""
    b = _backend(backend)
    d = os.path.join(path, _SHARDS)
    b.ensure_dir(d)
    stem = os.path.join(d, f"host_{process_index:05d}")
    b.delete(stem + ".DONE")
    data = {f"b{i}": t for i, (_k, _r, _w, t) in enumerate(blocks)}
    b.put_stream(stem + ".pt", lambda f: torch.save(data, f))
    b.put_json(stem + ".json", {
        "blocks": [{"key": k, "region": r, "whole": list(w),
                    "dtype": str(t.dtype).replace("torch.", "")}
                   for k, r, w, t in blocks],
        "scalars": scalars})
    b.put_json(stem + ".DONE", {"blocks": len(blocks)})


def commit_sharded_checkpoint(path: str, meta: Dict[str, Any], n_hosts: int,
                              timeout_s: float = 600.0, poll_s: float = 0.05,
                              backend=None) -> None:
    """Phase 2 (process 0): wait for every host's DONE marker, then write
    ``meta.json`` and the COMMIT marker (a put-if-absent create).  A host
    that never finishes within ``timeout_s`` raises TimeoutError and
    leaves the checkpoint uncommitted."""
    b = _backend(backend)
    d = os.path.join(path, _SHARDS)
    want = [os.path.join(d, f"host_{pi:05d}.DONE") for pi in range(n_hosts)]
    deadline = time.monotonic() + timeout_s
    while True:
        missing = [w for w in want if not b.exists(w)]
        if not missing:
            break
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"sharded-checkpoint commit barrier timed out after "
                f"{timeout_s:.0f}s: {len(missing)}/{n_hosts} host DONE "
                f"markers missing under {path} — leaving it uncommitted")
        time.sleep(poll_s)
    b.put_json(os.path.join(path, _META), meta)
    b.create_if_absent(
        os.path.join(path, _COMMIT),
        json.dumps({"committed_unix_time": round(time.time(), 3),
                    "sharded_hosts": int(n_hosts)}).encode("utf-8"))


def is_sharded_checkpoint(path: str, backend=None) -> bool:
    return _backend(backend).any_prefix(os.path.join(path, _SHARDS))


def _read_sharded(path: str, backend=None) -> Dict[str, Any]:
    """The whole payload of a sharded checkpoint: every host's blocks
    placed into their whole leaves; a leaf the blocks do not cover
    exactly raises (the manager's walk then falls back past it)."""
    b = _backend(backend)
    d = os.path.join(path, _SHARDS)
    manifests = sorted(k for k in b.list_prefix(os.path.join(d, "host_"))
                       if k.endswith(".json"))
    if not manifests:
        raise ValueError(f"no shard manifests under {d}")
    whole: Dict[str, torch.Tensor] = {}
    covered: Dict[str, torch.Tensor] = {}
    scalars: Dict[str, Any] = {}
    for jf in manifests:
        man = b.read_json(jf)
        if man is None:
            raise ValueError(f"unreadable shard manifest {jf}")
        scalars.update(man["scalars"])
        data = torch.load(io.BytesIO(b.read_bytes(jf[:-len(".json")]
                                                  + ".pt")),
                          map_location="cpu", weights_only=True)
        for i, e in enumerate(man["blocks"]):
            key, shape = e["key"], tuple(e["whole"])
            blk = data[f"b{i}"]
            if key not in whole:
                whole[key] = torch.empty(shape, dtype=blk.dtype)
                covered[key] = torch.zeros(shape, dtype=torch.bool)
            sl = (tuple(slice(lo, hi) for lo, hi in e["region"])
                  if e["region"] is not None else ...)
            whole[key][sl] = blk
            if bool(covered[key][sl].any()):
                raise ValueError(f"sharded checkpoint leaf {key}: blocks "
                                 f"overlap")
            covered[key][sl] = True
    for key, m in covered.items():
        if not bool(m.all()):
            raise ValueError(f"sharded checkpoint leaf {key} incomplete: "
                             f"{int((~m).sum())} of {m.numel()} elements "
                             f"missing from the host shard files")
    return _unflat(whole, scalars)


def read_meta(checkpoint_dir: str, name: str, backend=None
              ) -> Dict[str, Any]:
    """meta.json of a committed checkpoint ({} when there is none)."""
    if backend is None:
        name = resolve(checkpoint_dir, name)
    if not has_checkpoint(checkpoint_dir, name, backend):
        return {}
    return _backend(backend).read_json(
        os.path.join(ckpt_dir(checkpoint_dir, name), _META)) or {}


def _copy_into(dst: Any, src: Any, where: str) -> Any:
    if torch.is_tensor(dst):
        if dst.shape != src.shape:
            raise ValueError(f"checkpoint {where}: shape {tuple(src.shape)} "
                             f"!= {tuple(dst.shape)}")
        dst.copy_(src)
        return dst
    if isinstance(dst, dict):
        if dst.keys() != src.keys():
            raise ValueError(f"checkpoint {where}: keys differ")
        return {k: _copy_into(dst[k], src[k], f"{where}/{k}") for k in dst}
    return src


def restore_checkpoint(checkpoint_dir: str, name: str, state: TrainState,
                       backend=None) -> Tuple[TrainState, Dict[str, Any]]:
    """Restore into ``state`` in place: every leaf is copied into the
    live tensor (a captured CUDA graph keeps pointing at it), whichever
    form the checkpoint has (single file or sharded).  Returns (state,
    meta)."""
    if backend is None:
        name = resolve(checkpoint_dir, name)
    if not has_checkpoint(checkpoint_dir, name, backend):
        raise FileNotFoundError(f"no committed checkpoint {name!r} under "
                                f"{checkpoint_dir}")
    path = ckpt_dir(checkpoint_dir, name)
    if is_sharded_checkpoint(path, backend):
        payload = _read_sharded(path, backend)
    else:
        payload = torch.load(os.path.join(path, _STATE), map_location="cpu",
                             weights_only=True)
    apply_payload(state, payload)
    return state, read_meta(checkpoint_dir, name, backend)


def apply_payload(state: TrainState, payload: Dict[str, Any]) -> None:
    """Copy a host payload into the live state (collective under a
    mesh: the whole state is gathered, filled, and cut back).  The
    optimizer steps applied since the count was last read are the
    replaced state's: they go unread."""
    if state.applied is not None:
        state.applied.discard()
    with torch.no_grad(), _whole(state):
        state.model.load_state_dict(payload["model"])
        state.opt_state = _copy_into(state.opt_state, payload["opt_state"],
                                     "opt_state")
        _copy_into(dict(state.extra), payload["extra"], "extra")
        ls = state.loss_scale
        _copy_into({"scale": ls.scale, "growth_count": ls.growth_count},
                   payload["loss_scale"], "loss_scale")
    state.step = int(payload["step"])
    state.seed = int(payload["seed"])
