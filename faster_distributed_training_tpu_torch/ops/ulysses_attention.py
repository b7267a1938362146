"""Ulysses sequence parallelism: an all-to-all swaps the sequence shard for
a head shard (the JAX package's ``ops/ulysses_attention.py``, the
DeepSpeed-Ulysses construction).

The projections arrive sequence-sharded over the sp group; one tiled
all-to-all (``SequenceGroup.swap``, whose backward is the inverse swap)
re-shards them from [L/sp positions, every head] to [every position,
H/sp heads], so each rank computes ordinary full-length attention for
heads ``j·H/sp … (j+1)·H/sp`` (j its sp index); a second all-to-all swaps
the context back.  The key mask is all-gathered, since every rank then
needs every key's.  Unlike the ring this needs H % sp == 0, and moves
each tensor twice whatever sp is, with no collective inside the
attention.

The port swaps the fused [B, L/sp, 3, H, D] projection in one all-to-all
(the three JAX swaps of q, k and v in one message), which leaves it in
the fused [B, L, 3, H/sp, D] layout the flash Function takes.  The inner
attention is JAX's ``blockwise_attention``, the XLA twin of its flash
kernel (the same online softmax and hash stream): on the card the
port's flash kernels (TPU rows 1 / 4, and 2 / 3 past the k-blocked
envelope) at the operands ``b0``, ``h0 = j·H/sp`` and ``h_glob = H``
(the port's one-card route, flash wherever the head dim fits), on the
CPU ``ops.attention.blockwise_attention`` with the same global (b, h)
index.  Either way the dropout mask is the one-card mask for the same
seed.
"""

from __future__ import annotations

from typing import Optional

import torch

from faster_distributed_training_tpu_torch.ops.attention import (
    blockwise_attention)
from faster_distributed_training_tpu_torch.ops.sequence_parallel import (
    global_bh, key_mask_shard)


def ulysses_attention(qkv: torch.Tensor, sp,
                      key_mask: Optional[torch.Tensor] = None,
                      causal: bool = False, dropout_rate: float = 0.0,
                      dropout_seed=None, b0: int = 0,
                      save_stats: Optional[bool] = None) -> torch.Tensor:
    """The Ulysses body on this rank's fused projection qkv [B, L_loc, 3,
    H, D] (positions ``[j·L_loc, (j+1)·L_loc)``); ``sp`` the rank's
    ``SequenceGroup`` (None: one shard); ``key_mask`` [B, L_loc] (0
    masked) or None; ``b0`` the rank's first global batch row;
    ``save_stats`` the flash backward's route (the model's).  Returns the
    context [B, H, L_loc, D]."""
    from faster_distributed_training_tpu_torch.ops.flash_attention import (
        flash_attention_qkv)

    B, _, _, H, _ = qkv.shape
    n = 1 if sp is None else sp.size
    if H % n:
        raise ValueError(f"Ulysses needs heads ({H}) divisible by the sp "
                         f"group's size ({n}); use ring attention otherwise")
    j = 0 if sp is None else sp.rank
    h_loc = H // n
    # sequence-sharded [B, L/sp, 3, H, D] -> head-sharded [B, L, 3, H/sp, D]
    qkv_h = qkv if sp is None else sp.swap(qkv, split=3, concat=1)
    mask4 = None
    if key_mask is not None:
        # every key's mask: the rank attends over the whole sequence now
        full = key_mask if sp is None else sp.gather(key_mask, dim=1)
        mask4 = (full != 0)[:, None, None, :]
    if qkv.is_cuda:
        if causal:
            raise NotImplementedError(
                "causal Ulysses attention on the card: the flash kernels "
                "take a key-padding mask only")
        ctx = flash_attention_qkv(qkv_h, mask4, dropout_rate, dropout_seed,
                                  save_stats=save_stats, b0=b0,
                                  h0=j * h_loc, h_glob=H)
    else:
        q, k, v = (qkv_h[:, :, i].transpose(1, 2) for i in range(3))
        # this rank's post-swap heads of the global (b, h) index
        bh = global_bh(B, H, b0, qkv.device)[:, j * h_loc:(j + 1) * h_loc]
        ctx = blockwise_attention(q, k, v, mask=mask4,
                                  block_k=min(512, q.shape[2]),
                                  causal=causal, dropout_rate=dropout_rate,
                                  dropout_seed=dropout_seed, dropout_bh=bh)
    # head-sharded [B, H/sp, L, D] -> sequence-sharded [B, H, L/sp, D]
    return ctx if sp is None else sp.swap(ctx, split=2, concat=1)


def ulysses_self_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mask: Optional[torch.Tensor],
                           sp, b0: int = 0, causal: bool = False,
                           dropout_rate: float = 0.0, dropout_seed=None,
                           save_stats: Optional[bool] = None
                           ) -> torch.Tensor:
    """Ulysses on this rank's [B_loc, H, L_loc, D] shards (JAX
    ``ulysses_self_attention`` seen from one device): q, k and v packed
    into the fused layout, then ``ulysses_attention``.  ``mask`` None,
    [B, L_loc] or [B, 1, 1, L_loc] (0 masked)."""
    qkv = torch.stack([t.transpose(1, 2) for t in (q, k, v)], dim=2)
    return ulysses_attention(qkv, sp, key_mask_shard(mask, q.shape[0]),
                             causal, dropout_rate, dropout_seed, b0,
                             save_stats)
