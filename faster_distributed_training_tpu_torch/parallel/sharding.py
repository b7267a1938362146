"""The data-axis sharding rules (the data-parallel part of the JAX
package's ``parallel/sharding.py``).

  * ``fsdp_partition_params``: ZeRO-3's rule, each leaf sharded on its
    largest dim the shard count divides, leaves under 1024 elements
    kept whole (JAX's rule on the same shapes);
  * ``zero1_opt_specs``: ZeRO-1, the optimizer state alone sharded by
    that rule over a data axis;
  * ``offload_opt_leaf``: which optimizer leaves join the host tier
    under ``--offload_opt_state`` (64 Ki elements and up);
  * ``bucketed_grad_reduce``: the gradient SUM all-reduce on flat
    same-dtype buckets (one a dtype; ``--overlap_bucket_mb`` each under
    ``--overlap_grad_reduce``, each launched asynchronously as soon as it
    is packed, so one bucket's transfer overlaps the packing and launch
    of the next: DDP's bucketing).  One collective a bucket, not one a
    leaf: a per-leaf all-reduce cost the record 21 ms of host time a
    step at world 1 on an H100 (NCCL).

The tp rules, the pp residency rules and ZeRO over tp belong to the next
slice.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# elements below this stay whole under fsdp / zero1: sharding a
# bias-sized leaf only adds collective latency
FSDP_MIN_SIZE = 1024
# elements below this stay on the card under --offload_opt_state:
# streaming a bias-sized slot costs more latency than the memory it frees
OFFLOAD_MIN_ELEMENTS = 65536


def shard_dim(shape: Sequence[int], n: int,
              min_size: int = FSDP_MIN_SIZE) -> Optional[int]:
    """The dim a leaf of ``shape`` shards on over ``n`` ranks: the largest
    dim ``n`` divides (the first of equals), or None (``n`` 1, a scalar,
    fewer than ``min_size`` elements, or no dim divisible)."""
    shape = tuple(int(d) for d in shape)
    if n <= 1 or not shape or int(np.prod(shape)) < min_size:
        return None
    best, best_dim = None, 0
    for i, d in enumerate(shape):
        if d % n == 0 and d > best_dim:
            best, best_dim = i, d
    return best


def fsdp_partition_params(params: Mapping[str, torch.Tensor], n: int,
                          min_size: int = FSDP_MIN_SIZE
                          ) -> Dict[str, Optional[int]]:
    """name -> the dim each parameter shards on over ``n`` ranks (None:
    replicated)."""
    return {k: shard_dim(tuple(p.shape), n, min_size)
            for k, p in params.items()}


def zero1_opt_specs(opt_state, n: int) -> dict:
    """The optimizer-state tree with each tensor leaf replaced by the dim
    it shards on (None: replicated); host counters map to None."""
    if torch.is_tensor(opt_state):
        return shard_dim(tuple(opt_state.shape), n)
    if isinstance(opt_state, dict):
        return {k: zero1_opt_specs(v, n) for k, v in opt_state.items()}
    return None


def offload_opt_leaf(shape) -> bool:
    """Whether an optimizer-state leaf parks in host memory under
    ``--offload_opt_state``: the big slots amortize the copies, small
    ones stay on the card."""
    shape = tuple(shape)
    return bool(shape) and int(np.prod(shape)) >= OFFLOAD_MIN_ELEMENTS


def bucketed_grad_reduce(grads: Dict[str, torch.Tensor], group=None,
                         bucket_bytes: int = 4 << 20, divide: int = 1
                         ) -> Dict[str, torch.Tensor]:
    """The SUM all-reduce of every gradient over ``group``, divided by
    ``divide`` (the world, for the mean), in buckets: same-dtype leaves
    are packed, in order, into flat vectors of about ``bucket_bytes``
    (0: one bucket a dtype); each bucket's all-reduce is launched
    asynchronously when it is full, and all are waited for at the end.
    Returns views of the buckets.  Elementwise the sums of one all-reduce
    a leaf (a ring may add a bucket's elements in another order)."""
    if not dist.is_initialized():
        return dict(grads)
    out = dict(grads)
    by_dtype: Dict[torch.dtype, list] = {}
    for k, g in grads.items():
        by_dtype.setdefault(g.dtype, []).append(k)
    pending = []

    def flush(names):
        if not names:
            return
        vec = torch.cat([grads[k].reshape(-1) for k in names])
        pending.append((names, vec, dist.all_reduce(
            vec, op=dist.ReduceOp.SUM, group=group, async_op=True)))

    for dtype, names in by_dtype.items():
        item = torch.empty((), dtype=dtype).element_size()
        bucket, used = [], 0
        for k in names:
            bucket.append(k)
            used += grads[k].numel() * item
            if bucket_bytes and used >= bucket_bytes:
                flush(bucket)
                bucket, used = [], 0
        flush(bucket)
    for names, vec, work in pending:
        work.wait()
        if divide != 1:
            vec.div_(divide)
        off = 0
        for k in names:
            n = grads[k].numel()
            out[k] = vec[off:off + n].view(grads[k].shape)
            off += n
    return out
