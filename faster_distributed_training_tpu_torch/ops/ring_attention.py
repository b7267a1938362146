"""Ring attention: sequence parallelism over an sp group (the JAX
package's ``ops/ring_attention.py``).

Each rank holds the queries, keys and values of its L/sp positions.  The
K/V shard (and its key bias) rotates around the ring sp times while the
rank accumulates online-softmax statistics for its resident queries
(``ops.attention.online_block_update``), so attention memory a rank is
O(L · L/sp) and the math is dense attention's.  The rotation is the
``SequenceGroup.rotate`` autograd pair (a send / receive; its backward
rotates the cotangents back), so the backward is ring-parallel too and
the K/V gradients land on the ranks that own K/V.  Each step's block
math is checkpointed (``torch.utils.checkpoint``, JAX's
``jax.checkpoint`` on the scan body): the backward recomputes a step's
scores, so the residuals are the step's inputs, one K/V shard a step.

Plain torch, as in JAX (``torch.matmul`` on the blocks; JAX runs no
Pallas kernel here).  Dropout addresses the GLOBAL (b, h, q, k)
coordinates (``q_pos = idx · L + pos``, ``k_pos = src · L + pos``), so
the mask is the one-card mask for the same seed.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from faster_distributed_training_tpu_torch.ops.attention import (
    NEG_INF, dropout_keep, finalize, init_carry, mask_to_bias,
    online_block_update)
from faster_distributed_training_tpu_torch.ops.sequence_parallel import (
    global_bh, sp_self_attention)


def _ring_step(q, k_cur, v_cur, b_cur, m, l, acc, q_pos, k_pos, scale,
               causal, dropout_rate, seed, bh):
    """One ring step: the resident queries against the K/V shard that
    arrived, with its key bias, the causal bias and the dropout keep
    factors at the global positions."""
    bias = b_cur[:, None, None, :]                    # [B, 1, 1, L]
    if causal:
        bias = bias + torch.where(k_pos[None, :] <= q_pos[:, None], 0.0,
                                  NEG_INF)[None, None]
    keep = None
    if dropout_rate > 0.0:
        keep = dropout_keep(seed, bh, q_pos[None, None, :, None],
                            k_pos[None, None, None, :], dropout_rate
                            ).to(q.device)
    return online_block_update(q, k_cur, v_cur, bias, m, l, acc, scale,
                               keep_blk=keep)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sp,
                   key_bias: Optional[torch.Tensor] = None,
                   causal: bool = False, dropout_rate: float = 0.0,
                   dropout_seed=None,
                   dropout_bh: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """The ring body on this rank's shards: q / k / v [B, H, L_loc, D],
    ``key_bias`` [B, L_loc] the additive bias of this rank's keys (0 keep,
    NEG_INF drop) or None; ``sp`` the rank's ``SequenceGroup`` (None: one
    shard).  ``dropout_bh``: the [B, H, 1, 1] global (b, h) stream index
    (default the local one).  Returns [B, H, L_loc, D]."""
    B, H, L, D = q.shape
    n = 1 if sp is None else sp.size
    idx = 0 if sp is None else sp.rank
    scale = 1.0 / math.sqrt(D)
    if key_bias is None:
        key_bias = torch.zeros((B, L), dtype=torch.float32, device=q.device)
    pos = torch.arange(L, device=q.device)
    bh = global_bh(B, H, 0, q.device) if dropout_bh is None else dropout_bh
    seed = 0 if dropout_seed is None else dropout_seed
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    m, l, acc = init_carry(q)
    kv, b_cur, src = torch.stack([k, v]), key_bias.float(), idx
    for step in range(n):
        if step:
            # the next shard from the previous rank: K and V as one message
            kv, b_cur = sp.rotate(kv), sp.rotate(b_cur)
            src = (src - 1) % n
        args = (q, kv[0], kv[1], b_cur, m, l, acc, idx * L + pos,
                src * L + pos, scale, causal, dropout_rate, seed, bh)
        if grad:
            m, l, acc = checkpoint(_ring_step, *args, use_reentrant=False)
        else:
            m, l, acc = _ring_step(*args)
    return finalize(m, l, acc, q.dtype)


def _ring_body(q, k, v, sp, key_mask=None, causal=False, dropout_rate=0.0,
               dropout_seed=None, b0: int = 0):
    """``sp_self_attention``'s body: the rank's keep-mask as an additive
    bias (elementwise, so per shard == global), the global (b, h) index
    of its rows."""
    key_bias = None if key_mask is None else mask_to_bias(key_mask)
    bh = (global_bh(q.shape[0], q.shape[1], b0, q.device)
          if dropout_rate > 0.0 else None)
    return ring_attention(q, k, v, sp, key_bias=key_bias, causal=causal,
                          dropout_rate=dropout_rate,
                          dropout_seed=dropout_seed, dropout_bh=bh)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor], sp, b0: int = 0,
                        causal: bool = False, dropout_rate: float = 0.0,
                        dropout_seed=None) -> torch.Tensor:
    """Ring attention on this rank's [B_loc, H, L_loc, D] shards (JAX
    ``ring_self_attention`` seen from one device): ``mask`` None, [B,
    L_loc] or [B, 1, 1, L_loc] (0 masked), ``b0`` the rank's first global
    batch row."""
    return sp_self_attention(_ring_body, q, k, v, mask, sp, b0=b0,
                             causal=causal, dropout_rate=dropout_rate,
                             dropout_seed=dropout_seed)
