"""Activation checkpointing for ``--remat`` (the JAX package's ``nn.remat``
of an encoder layer or a residual block), on non-reentrant
``torch.utils.checkpoint``.

Two differences from ``nn.remat`` need handling here.  A flax replay runs
on the forward's variables and its ``batch_stats`` writes are dropped;
torch's replay re-runs the module, in-place buffer updates included.  So
a region's forward context snapshots its ``--quant`` amax histories, and
its replay context puts those pre-step values back (the replay quantizes
at the forward's scales), skips every roll and every BatchNorm
running-statistics update (``replaying()``), then restores the rolled
values: each history rolls once a step and each running statistic
updates once, as without remat.  And torch's selective checkpointing
sees aten ops, not the flash kernel's ``autograd.Function``: the
``attn_out`` policy stashes the attention context in the region's frame
during the forward and hands it back in the replay
(``stashed_attention``), so the flash forward is not re-run there.

The replay must also run the forward's convolution algorithms; the
train step runs every backward on the calling thread for that
(``train.steps._grads``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

_LOCAL = threading.local()


class Frame:
    """One checkpointed region: its amax histories, their pre-step
    snapshot, and the attention contexts its forward stashed."""

    def __init__(self, module: torch.nn.Module):
        self.hists = [b for n, b in module.named_buffers()
                      if "amax_history" in n]
        self.snap: List[torch.Tensor] = []
        self.stash: List[torch.Tensor] = []
        self.cursor = 0


def replaying() -> bool:
    """True inside a checkpoint's replay (the backward's recompute)."""
    return getattr(_LOCAL, "replay", 0) > 0


def current_frame() -> Optional[Frame]:
    return getattr(_LOCAL, "frame", None)


@contextlib.contextmanager
def _forward_ctx(frame: Frame):
    frame.snap = [h.detach().clone() for h in frame.hists]
    frame.stash.clear()
    prev = current_frame()
    _LOCAL.frame = frame
    try:
        yield
    finally:
        _LOCAL.frame = prev


@contextlib.contextmanager
def _replay_ctx(frame: Frame):
    with torch.no_grad():
        rolled = [h.clone() for h in frame.hists]
        for h, s in zip(frame.hists, frame.snap):
            h.copy_(s)
    prev = current_frame()
    _LOCAL.frame = frame
    _LOCAL.replay = getattr(_LOCAL, "replay", 0) + 1
    frame.cursor = 0
    try:
        yield
    finally:
        _LOCAL.replay -= 1
        _LOCAL.frame = prev
        with torch.no_grad():
            for h, r in zip(frame.hists, rolled):
                h.copy_(r)


@contextlib.contextmanager
def _both(a, b):
    with a, b:
        yield


_MATMULS = None


def _dots_policy(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: the outputs of matmuls
    without batch dimensions are saved, everything else is recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy

    global _MATMULS
    if _MATMULS is None:
        aten = torch.ops.aten
        _MATMULS = {aten.mm.default, aten.addmm.default}
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn: Callable, module: torch.nn.Module, *args, dots: bool = False):
    """``fn(*args)`` checkpointed: activations inside are recomputed in
    the backward (non-reentrant), with ``module``'s amax histories and
    running statistics guarded as the module docstring says.  ``dots``
    saves the matmul outputs (selective checkpointing)."""
    frame = Frame(module)

    def contexts():
        fwd, rec = _forward_ctx(frame), _replay_ctx(frame)
        if not dots:
            return fwd, rec
        from torch.utils.checkpoint import (
            create_selective_checkpoint_contexts)
        sac_fwd, sac_rec = create_selective_checkpoint_contexts(_dots_policy)
        # ours outermost: the history snapshot and restore stay outside
        # the caching mode, which matches the replay's ops to the forward's
        return _both(fwd, sac_fwd), _both(rec, sac_rec)

    # the port draws no torch RNG (its randomness is explicit), so the
    # replay needs no RNG state: none is read, and none set in a capture
    return checkpoint(fn, *args, use_reentrant=False, context_fn=contexts,
                      preserve_rng_state=False)


class _Stashed(torch.autograd.Function):
    """The replay's stand-in for the flash Function: it saves the same
    residual (the fused projection) and returns the context the forward
    stashed, so the original node's recompute backward gets its qkv and
    no kernel runs here."""

    @staticmethod
    def forward(ctx, qkv, stashed):
        ctx.save_for_backward(qkv)
        return stashed.clone()

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("the replay's attention stand-in is never "
                           "differentiated: the original node is")


def stashed_attention(qkv: torch.Tensor, attend: Callable[[], torch.Tensor]
                      ) -> torch.Tensor:
    """The attention context under ``attn_out``: in the region's forward
    ``attend()`` runs and its result is stashed; in the replay the stash
    comes back through ``_Stashed``.  Outside a region, ``attend()``."""
    frame = current_frame()
    if frame is None:
        return attend()
    if not replaying():
        ctx = attend()
        frame.stash.append(ctx.detach())
        return ctx
    ctx = _Stashed.apply(qkv, frame.stash[frame.cursor])
    frame.cursor += 1
    return ctx
