"""One-position attention against a padded KV cache.

Port of ``faster_distributed_training_tpu/ops/cached_attention.py``.  The
decode step (``models/decode.py``) computes one query position a slot;
the keys and values live in the paged cache (``serve/decode/cache.py``),
whose columns past each slot's length hold garbage.  This is the eval
dense attention (``models.transformer.dense_attention``) at query length
1, masked by per-slot lengths instead of a materialized mask: the same
NEG_INF, the same fp32 softmax cast back to the compute dtype.

A masked column's score is NEG_INF (-1e9), so after the softmax's max
subtraction its exponential is an exact fp32 0: it adds exact zeros to
the normalizer and to probs . v, and the garbage never shows.

Plain PyTorch, as the JAX package has no Pallas kernel here (decode reads
the cache, a bandwidth-bound dot); on the card the decode step's CUDA
graph replays these launches.  A hand decode-attention kernel is later
performance work.
"""

from __future__ import annotations

import math

import torch

from faster_distributed_training_tpu_torch.ops.attention import NEG_INF


def cached_attention(q: torch.Tensor, kcache: torch.Tensor,
                     vcache: torch.Tensor, lengths: torch.Tensor
                     ) -> torch.Tensor:
    """Attention of one query position over the first ``lengths[b]``
    cache columns of each slot.

    q:       [B, h, 1, d_k]  the current position's query
    kcache:  [B, h, C, d_k]  keys; columns >= lengths[b] are garbage
    vcache:  [B, h, C, d_k]
    lengths: [B] integer     valid columns a slot, the current position
                             (already written) included
    returns: [B, h, 1, d_k]
    """
    d_k = q.shape[-1]
    C = kcache.shape[2]
    scores = torch.matmul(q, kcache.transpose(-1, -2)) / math.sqrt(d_k)
    valid = (torch.arange(C, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.matmul(probs, vcache)
