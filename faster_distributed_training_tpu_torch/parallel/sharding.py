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

And the tensor-parallel rules (the JAX package's ``_TP_RULES``,
``tensor_parallel_rules``, ``apply_tp_rules`` and the ZeRO-over-tp
opt-state classification, ``classify_opt_state_leaf``):

  * ``_TP_RULES`` is JAX's table, regexes on the JAX parameter paths:
    the fused qkv kernel and bias on the head axis, the out kernel on its
    input rows, the FFN's ``Dense_0`` kernel and bias on d_ff and
    ``Dense_1`` on its d_ff rows, the token embedding on its vocab rows;
  * ``tp_cut`` maps a port parameter (``nn.Linear`` layout, ``[out, in]``)
    through its JAX path (``jax_param_path``) to how its tp shard is cut:
    ``rows`` (dim 0, contiguous), ``cols`` (dim 1, contiguous) or
    ``heads`` (the fused qkv's rows ``{i*H*D + (h0 + j)*D + k}``, not
    contiguous); None replicates it;
  * ``zero_opt_dims``: ZeRO over tp (on unless ``--no_zero_opt``): an
    optimizer leaf mirroring a tp-cut parameter is this rank's shard
    already; one mirroring a replicated parameter shards its largest
    dim tp divides, counted in the JAX layout's axis order (1024
    elements and up); scalars stay whole.

And the pp residency rules (``PP_RESIDENCY_RULES`` and
``REPLICATED_PP_PARAMS`` by JAX's leaf roles; ``pp_stage_homes`` for the
port's leaves):

  * a stage-owned leaf (under ``layer_{i}``, ``pipeline.param_stage_home``)
    lives on its stage only, and so do its optimizer mirrors and its
    amax histories; ``shared_embed`` and ``shared_head`` leaves are
    replicated over pp; a leaf no rule knows raises;
  * JAX shards each stage-owned leaf over pp on its largest free axis
    (its ``classify_pp_param_leaf``: one SPMD program holds a 1/P slice
    of every layer on each stage's chips, and keeps the leaves too small
    or indivisible for that replicated).  The port runs one process a
    stage and holds the whole layers of its stage, small leaves
    included: the same bytes a rank for an even split (S stages of L/S
    layers each), with no gather at use;
  * ``--no_pp_residency``: every rank holds every leaf.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

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


def memory_order(t: torch.Tensor) -> Tuple[int, ...]:
    """The permutation of ``t``'s dims by falling stride: ``t.permute`` of
    it is contiguous when ``t`` is dense (a channels_last tensor, say),
    so its flattening keeps ``t``'s memory order.  The identity for a
    contiguous tensor (and for one that is not dense)."""
    order = tuple(sorted(range(t.dim()), key=lambda d: (-t.stride(d), d)))
    return order if t.permute(order).is_contiguous() else tuple(
        range(t.dim()))


def bucketed_grad_reduce(grads: Dict[str, torch.Tensor], group=None,
                         bucket_bytes: int = 4 << 20, divide: int = 1
                         ) -> Dict[str, torch.Tensor]:
    """The SUM all-reduce of every gradient over ``group``, divided by
    ``divide`` (the world, for the mean), in buckets: same-dtype leaves
    are packed, in order, into flat vectors of about ``bucket_bytes``
    (0: one bucket a dtype); each bucket's all-reduce is launched
    asynchronously when it is full, and all are waited for at the end.
    Returns views of the buckets with each gradient's memory layout (a
    channels_last conv gradient stays channels_last: a reduction over a
    leaf, the clip's global norm among them, adds its elements in memory
    order, so a layout changed here would change its rounding from the
    run without a group).  Elementwise the sums of one all-reduce a leaf
    (a ring may add a bucket's elements in another order)."""
    if not dist.is_initialized():
        return dict(grads)
    out = dict(grads)
    by_dtype: Dict[torch.dtype, list] = {}
    for k, g in grads.items():
        by_dtype.setdefault(g.dtype, []).append(k)
    pending = []
    order = {k: memory_order(g) for k, g in grads.items()}

    def flush(names):
        if not names:
            return
        vec = torch.cat([grads[k].permute(order[k]).reshape(-1)
                         for k in names])
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
            g, o = grads[k], order[k]
            n = g.numel()
            out[k] = vec[off:off + n].view([g.shape[d] for d in o]).permute(
                tuple(int(d) for d in np.argsort(o)))
            off += n
    return out


# -- tensor parallelism -------------------------------------------------------

# the JAX package's _TP_RULES (parallel/sharding.py): a regex on the
# lowercased JAX parameter path and the PartitionSpec as a tuple
_TP_RULES = (
    (r".*(attn|attention).*/qkv/kernel", (None, None, "tp", None)),
    (r".*(attn|attention).*/qkv/bias", (None, "tp", None)),
    (r".*(attn|attention).*/(query|key|value)/kernel", (None, "tp")),
    (r".*(attn|attention).*/(query|key|value)/bias", ("tp",)),
    (r".*(attn|attention).*/out/kernel", ("tp", None)),
    (r".*(ffn|mlp).*/(dense_0|fc1|wi)/kernel", (None, "tp")),
    (r".*(ffn|mlp).*/(dense_0|fc1|wi)/bias", ("tp",)),
    (r".*(ffn|mlp).*/(dense_1|fc2|wo)/kernel", ("tp", None)),
    (r".*token_embedding", ("tp", None)),
)
# elements below this stay whole under ZeRO over tp (JAX's ZERO_MIN_SIZE)
ZERO_MIN_SIZE = 1024


def tensor_parallel_rules(flat_name: str) -> tuple:
    """A '/'-joined JAX parameter path -> its tp spec (() if no rule
    hits)."""
    low = flat_name.lower()
    for pat, spec in _TP_RULES:
        if re.match(pat, low):
            return spec
    return ()


def jax_param_path(name: str) -> str:
    """The JAX path of a port parameter or buffer: ``embeddings.x`` ->
    ``Embeddings_0/x``, ``layers.i.`` -> ``layer_i/``, ``.weight`` ->
    ``/kernel`` (``interop``'s mapping)."""
    parts = name.split(".")
    if parts[0] == "embeddings":
        parts[0] = "Embeddings_0"
    elif parts[0] == "layers":
        parts[:2] = [f"layer_{parts[1]}"]
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(parts)


def _linear_weight(name: str) -> bool:
    """An ``nn.Linear`` weight: the JAX kernel transposed."""
    return name.endswith(".weight")


def tp_cut(name: str) -> Optional[str]:
    """How the tp shard of port parameter ``name`` is cut ("rows", "cols"
    or "heads"),
    from its JAX spec: the qkv kernel's and bias's head axis -> heads; a
    Linear weight's JAX dim i -> port dim 1 - i (cols, rows); a bias or
    the token table's dim 0 -> rows.  None: replicated."""
    spec = tensor_parallel_rules(jax_param_path(name))
    if "tp" not in spec:
        return None
    i = spec.index("tp")
    if len(spec) > 2:
        return "heads"
    if _linear_weight(name):
        return ("cols", "rows")[i]
    return "rows"


def apply_tp_rules(names) -> Dict[str, Optional[str]]:
    """name -> ``tp_cut`` of every parameter name."""
    return {k: tp_cut(k) for k in names}


def tp_shard(t: torch.Tensor, cut: Optional[str], rank: int, n: int,
             heads: int = 0) -> torch.Tensor:
    """This rank's tp shard of the whole leaf ``t`` (a copy; ``t``
    itself for a replicated one).  ``heads``: the head count (qkv).  A
    rows / cols cut takes ceil(size / n) of the dim, the last shards'
    tail past the whole leaf zeros (the token table at a vocabulary tp
    does not divide)."""
    if cut is None or n <= 1:
        return t
    if cut == "heads":
        hl = heads // n
        v = t.reshape((3, heads, -1) + tuple(t.shape[1:]))
        return v[:, rank * hl:(rank + 1) * hl].reshape(
            (-1,) + tuple(t.shape[1:])).clone()
    d = 0 if cut == "rows" else 1
    size = t.shape[d]
    c = -(-size // n)
    a = min(rank * c, size)
    part = t.narrow(d, a, min(a + c, size) - a)
    if part.shape[d] == c:
        return part.clone()
    shape = list(t.shape)
    shape[d] = c
    out = t.new_zeros(shape)
    out.narrow(d, 0, part.shape[d]).copy_(part)
    return out


def tp_unshard(parts: Sequence[torch.Tensor], cut: Optional[str],
               heads: int = 0, size: Optional[int] = None) -> torch.Tensor:
    """The whole leaf from every rank's shard, in rank order (the inverse
    of ``tp_shard``); ``size``: the whole leaf's extent on a rows / cols
    cut (the padding past it dropped)."""
    if cut is None or len(parts) <= 1:
        return parts[0]
    if cut == "heads":
        hl = heads // len(parts)
        rest = tuple(parts[0].shape[1:])
        return torch.cat([p.reshape((3, hl, -1) + rest) for p in parts],
                         dim=1).reshape((-1,) + rest)
    d = 0 if cut == "rows" else 1
    whole = torch.cat(list(parts), dim=d)
    return whole if size is None else whole.narrow(d, 0, size)


def _jax_order(name: str, ndim: int) -> list:
    """The port axes of leaf ``name`` in the JAX layout's order."""
    return list(range(ndim))[::-1] if (
        _linear_weight(name) and ndim == 2) else list(range(ndim))


def classify_opt_state_leaf(name: str, shape, cut: Optional[str], n: int,
                            min_size: int = ZERO_MIN_SIZE
                            ) -> Tuple[str, object]:
    """(rule or replicated class, how it shards) for an optimizer leaf of
    ``shape`` mirroring parameter ``name`` (JAX's
    ``classify_opt_state_leaf``, its param_mirror rule): the parameter's
    tp cut when it has one; else the largest dim ``n`` divides in the
    JAX layout's axis order (the first of equals), as a port dim; else
    a replicated class (scalar, small, indivisible)."""
    shape = tuple(int(d) for d in shape)
    if not shape:
        return "scalar", None
    if cut is not None:
        return "param_mirror", cut
    if int(np.prod(shape)) < min_size:
        return "small", None
    order = _jax_order(name, len(shape))
    best, best_dim = None, 0
    for port_dim in order:
        d = shape[port_dim]
        if d % n == 0 and d > best_dim:
            best, best_dim = port_dim, d
    if best is None:
        return "indivisible", None
    return "param_mirror", best


def zero_opt_dims(params: Mapping[str, torch.Tensor], cuts: Mapping[str,
                  Optional[str]], n: int) -> Dict[str, Optional[int]]:
    """name -> the dim ZeRO over tp cuts the optimizer mirrors of each
    replicated parameter on (None: whole, or tp-cut already)."""
    out = {}
    for k, p in params.items():
        rule, how = classify_opt_state_leaf(k, tuple(p.shape), cuts.get(k),
                                            n)
        out[k] = how if isinstance(how, int) else None
    return out


# -- pipeline residency ---------------------------------------------------------

# the port's residency by JAX's leaf roles (pipeline.param_stage_home),
# each with its reason; the rule table (pipeline.pipeline_rules) shows them
PP_RESIDENCY_RULES: Dict[str, str] = {
    "stage_owned":
        "param or amax history under layer_{i} (pipeline.param_stage_home "
        "maps i to its stage): the whole leaf lives on its stage's ranks "
        "only, and so do its optimizer mirrors; a checkpoint gathers it "
        "from its stage",
}
REPLICATED_PP_PARAMS: Dict[str, str] = {
    "shared_embed":
        "embedding tables (token/pos/segment): read by stage 0's input "
        "and (tied LM head) by the last stage's logits, so every rank "
        "holds them; their gradient is SUMmed over pp",
    "shared_head":
        "ln_final / pooler / classifier / lm_head: applied by the last "
        "stage on the reassembled local batch; every rank holds them and "
        "their gradient is SUMmed over pp (zero off the last stage)",
}


def pp_stage_homes(names, spec) -> Dict[str, Optional[int]]:
    """name -> the stage a port leaf (a parameter or a buffer) lives on
    under residency (None: replicated over pp, a shared role), by
    ``pipeline.param_stage_home`` of its JAX path; a leaf no rule knows
    raises."""
    from faster_distributed_training_tpu_torch.parallel.pipeline import (
        param_stage_home)

    out = {}
    for k in names:
        role, stage = param_stage_home(spec, jax_param_path(k))
        if role == "unknown":
            raise ValueError(f"pp residency: no rule places leaf {k!r} "
                             f"({jax_param_path(k)})")
        out[k] = stage if role == "stage_owned" else None
    return out
