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
``<name>_<step:09d>`` (``series_member``); reading a series by its name
(``read_meta(d, "transformer_step")``) reads its newest committed member.
Under a mesh (``state.placement``) every rank gathers the whole state
(the collectives of ``Placement.whole``: the fsdp / zero shards and the
tp shards), rank 0 of the run writes it, and all wait for the write;
every rank restores the whole state and takes its own layout again.  A
checkpoint is the same file at any mesh, so a dp=2, fsdp=2 or tp=2 run
resumes at dp=1 and the other way round (the JAX package's interchange
contract).
Reading the JAX package's Orbax checkpoints is not ported yet.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import time
from typing import Any, Dict, List, Tuple

import torch

from faster_distributed_training_tpu_torch.train.state import TrainState

_STATE = "state.pt"
_META = "meta.json"
_COMMIT = "COMMIT"


def ckpt_dir(checkpoint_dir: str, name: str) -> str:
    return os.path.join(os.path.abspath(checkpoint_dir), name)


def has_checkpoint(checkpoint_dir: str, name: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir(checkpoint_dir, name),
                                       _COMMIT))


def series_member(series: str, step: int) -> str:
    """The name of a step-cadence checkpoint: the series and the global
    step."""
    return f"{series}_{int(step):09d}"


def series_members(checkpoint_dir: str, series: str,
                   committed: bool = True) -> List[Tuple[int, str]]:
    """(step, name) of the series' members, oldest first; with
    ``committed`` only those whose COMMIT marker is written."""
    root = os.path.abspath(checkpoint_dir)
    if not os.path.isdir(root):
        return []
    pat = re.compile(re.escape(series) + r"_(\d{9})$")
    out = []
    for name in os.listdir(root):
        m = pat.match(name)
        if m and (not committed or has_checkpoint(checkpoint_dir, name)):
            out.append((int(m.group(1)), name))
    return sorted(out)


def resolve(checkpoint_dir: str, name: str) -> str:
    """``name`` itself when it is a committed checkpoint, else the newest
    committed member of the series ``name`` (``name`` when there is
    none)."""
    if has_checkpoint(checkpoint_dir, name):
        return name
    members = series_members(checkpoint_dir, name)
    return members[-1][1] if members else name


def prune_series(checkpoint_dir: str, series: str, keep: int) -> List[str]:
    """Keep the newest ``keep`` committed members of the series; remove
    older committed ones and any uncommitted residue older than the
    newest committed member.  Returns the names removed."""
    committed = series_members(checkpoint_dir, series)
    doomed = [n for _, n in committed[:-max(int(keep), 1)]]
    if committed:
        newest = committed[-1][0]
        doomed += [n for s, n in series_members(checkpoint_dir, series,
                                                committed=False)
                   if s < newest and not has_checkpoint(checkpoint_dir, n)]
    for n in doomed:
        shutil.rmtree(ckpt_dir(checkpoint_dir, n), ignore_errors=True)
    return doomed


def _replace_atomically(path: str, write) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


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


def _write(path: str, state: TrainState, epoch: int, best_acc: float,
           step_in_epoch: int) -> None:
    os.makedirs(path, exist_ok=True)
    commit = os.path.join(path, _COMMIT)
    if os.path.exists(commit):
        os.remove(commit)
    ls = state.loss_scale
    payload = {"model": _to_cpu(state.model.state_dict()),
               "extra": _to_cpu(dict(state.extra)),
               "opt_state": _to_cpu(state.opt_state),
               "loss_scale": _to_cpu({"scale": ls.scale,
                                      "growth_count": ls.growth_count}),
               "step": int(state.step), "seed": int(state.seed)}
    _replace_atomically(os.path.join(path, _STATE),
                        lambda f: torch.save(payload, f))
    _write_json(os.path.join(path, _META),
                {"epoch": int(epoch), "step_in_epoch": int(step_in_epoch),
                 "best_acc": float(best_acc), "step": int(state.step)})
    _write_json(commit, {"committed_unix_time": round(time.time(), 3)})


def read_meta(checkpoint_dir: str, name: str) -> Dict[str, Any]:
    """meta.json of a committed checkpoint ({} when there is none)."""
    name = resolve(checkpoint_dir, name)
    if not has_checkpoint(checkpoint_dir, name):
        return {}
    with open(os.path.join(ckpt_dir(checkpoint_dir, name), _META)) as f:
        return json.load(f)


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


def restore_checkpoint(checkpoint_dir: str, name: str, state: TrainState
                       ) -> Tuple[TrainState, Dict[str, Any]]:
    """Restore into ``state`` in place (tensors stay on their devices).
    Returns (state, meta)."""
    name = resolve(checkpoint_dir, name)
    if not has_checkpoint(checkpoint_dir, name):
        raise FileNotFoundError(f"no committed checkpoint {name!r} under "
                                f"{checkpoint_dir}")
    path = ckpt_dir(checkpoint_dir, name)
    payload = torch.load(os.path.join(path, _STATE), map_location="cpu",
                         weights_only=True)
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
    return state, read_meta(checkpoint_dir, name)
