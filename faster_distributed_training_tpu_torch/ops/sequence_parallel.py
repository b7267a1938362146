"""The scaffolding both sequence-parallel attention strategies share (ring,
``ops/ring_attention.py``; Ulysses, ``ops/ulysses_attention.py``): the
JAX package's ``ops/sequence_parallel.py``.

JAX wraps each strategy's body in a ``shard_map`` over the mesh: batch
over the data axes, sequence over the sp axis, the key-padding mask
normalized to a [B, L] keep-mask sharded like the sequence, and each
body handed its GLOBAL [B_loc, H, 1, 1] (batch, head) dropout stream
index.  Here a process already holds its shard (the batch rows of its
data rank, the positions of its sp index), so the wrapper is that
normalization, and the index is ``global_bh`` of ``b0``, the rank's first
global batch row (the group, ``parallel.collectives.SequenceGroup``,
carries the sp index).  Heads are never split over tp inside sp in the
port (sp with tp raises), so a rank holds every head.

The body runs on this rank's shards with the signature
``body(q, k, v, sp, key_mask=None, causal=False, dropout_rate=0.0,
dropout_seed=None, b0=0)`` and builds its stream index from ``b0``
(Ulysses hands the flash kernels ``b0`` and its head origin instead of
an index tensor).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from faster_distributed_training_tpu_torch.parallel.mesh import DATA_AXES


def batch_axes(axes) -> Tuple[str, ...]:
    """The data axes (dp, fsdp) among ``axes`` (a ``DeviceMesh``'s names or
    ``--mesh``'s canonical axes), in that order: the axes the batch is
    split over."""
    names = getattr(axes, "mesh_dim_names", axes) or ()
    return tuple(a for a in DATA_AXES if a in names)


def global_bh(b_loc: int, h: int, b0: int = 0, device=None
              ) -> torch.Tensor:
    """[b_loc, h, 1, 1] global ``b * H + h`` of a rank whose rows start at
    global row ``b0`` (JAX ``sp_self_attention``'s ``global_bh``)."""
    return ((torch.arange(b_loc, dtype=torch.int64, device=device)
             + int(b0))[:, None] * h
            + torch.arange(h, dtype=torch.int64, device=device)[None, :]
            )[:, :, None, None]


def key_mask_shard(mask: Optional[torch.Tensor], b: int
                   ) -> Optional[torch.Tensor]:
    """A key-padding mask ([B, L_loc] or [B, 1, 1, L_loc], 0 masked) as the
    [B, L_loc] keep-mask of this rank's keys; None stays None."""
    if mask is None:
        return None
    return mask.reshape(b, mask.shape[-1])


def sp_self_attention(body: Callable, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, mask: Optional[torch.Tensor], sp,
                      b0: int = 0, causal: bool = False,
                      dropout_rate: float = 0.0, dropout_seed=None
                      ) -> torch.Tensor:
    """This rank's [B_loc, H, L_loc, D] in and out: ``body`` on the rank's
    shards with the key mask normalized (``key_mask_shard``) and the
    rank's batch origin ``b0`` (its dropout streams' global rows).
    ``sp``: the rank's ``SequenceGroup`` (None: one shard)."""
    return body(q, k, v, sp, key_mask=key_mask_shard(mask, q.shape[0]),
                causal=causal, dropout_rate=dropout_rate,
                dropout_seed=dropout_seed, b0=b0)
