"""The fused FFN sublayer run per tensor-parallel shard (the JAX
package's ``parallel/kernel_shard.py::fused_ffn_sublayer_tp``).

JAX runs each Pallas kernel per shard under ``shard_map`` on operands the
tp rules lay out; here each process is one tp rank and holds its shards
of the weights itself (``parallel.sharding.tp_cut``), so every kernel
already runs on a shard.  The other two routes need no module of their
own: the flash kernels (TPU rows 1-5) take the rank's head origin as
launch operands (``MultiheadAttention``: ``h0``, ``h_glob = H``), and a
quantized site (row 9) contracts its shard in ``QuantDense`` (a
row-parallel site SUMs its partial products over tp).  What this module
adds is the fused FFN's Megatron tile: row 8 in its ``partial`` mode on
w1's d_ff/tp rows and w2's d_ff/tp columns (the hidden dropout at the
global columns ``c0 = rank * d_ff/tp`` of ``dff_glob = d_ff``), its fp32
products SUMmed over tp (one all-reduce, ``collectives.TensorGroup``),
then b2, the connection dropout at the global rows and the residual on
every rank.  JAX ends with the sequence split over tp (a reduce-scatter,
then an all-gather at the next sublayer's entry); the all-reduce gives
each rank the same numbers and needs no divisibility of the sequence.
"""

from __future__ import annotations

from typing import Optional

import torch

from faster_distributed_training_tpu_torch.parallel.collectives import (
    TensorGroup)


def fused_ffn_sublayer_tp(h, ln_scale, ln_bias, w1, b1, w2, b2, hid_seed,
                          out_seed, tp: TensorGroup, rate_hidden: float = 0.0,
                          rate_conn: float = 0.0, eps: float = 1e-6,
                          b0: int = 0, quant_fmt: Optional[str] = None,
                          quant_scales=None, grad_fmt: Optional[str] = None):
    """The Megatron column-then-row fused-FFN sublayer of a tp rank.  h:
    the replicated [B, L, d]; w1 [d_ff/tp, d] and b1 this rank's d_ff
    rows, w2 [d, d_ff/tp] its d_ff columns; ln and b2 whole.  Returns
    ``out`` [B, L, d] (every rank the same), or ``(out, amax2)`` under
    quant, amax2 the tile's [amax_f, amax_a] (amax_f the same on every tp
    rank, amax_a of the rank's d_ff columns: their MAX over the data
    ranks and tp is the global pair).  Differentiable: h, the LN
    parameters, w1, b1, w2 and b2."""
    from faster_distributed_training_tpu_torch.ops.dropout import (
        guard_index_ceiling, keep_factor_rows)
    from faster_distributed_training_tpu_torch.ops.fused_ffn import (
        _global_rows, ffn_core_generalized)

    if h.dim() != 3:
        raise ValueError(f"fused_ffn_sublayer_tp expects (B, L, d) "
                         f"activations, got shape {tuple(h.shape)}")
    B, L, d = h.shape
    dff_loc = w1.shape[0]
    d_ff = dff_loc * tp.size
    if rate_hidden > 0.0 or rate_conn > 0.0:
        width = max(d_ff if rate_hidden > 0.0 else 0,
                    d if rate_conn > 0.0 else 0)
        guard_index_ceiling((int(b0) + B) * L * width,
                            site="fused FFN dropout (tp-sharded)")
    # the replicated inputs of the rank's tile: their cotangents (the
    # tile's share of each) are summed over tp
    h_in, lns, lnb = (tp.copy_in(t) for t in (h, ln_scale, ln_bias))
    part, amax2 = ffn_core_generalized(
        h_in, lns, lnb, w1, b1, w2, b2, hid_seed, out_seed, b0, 0,
        tp.rank * dff_loc, rate_hidden, 0.0, eps, L, L, dff_glob=d_ff,
        quant_fmt=quant_fmt, quant_scales=quant_scales, grad_fmt=grad_fmt,
        grad_tp=tp if quant_fmt is not None else None, partial=True)
    # the tile's one collective: the row-parallel GEMM2 products (fp32)
    f2 = tp.reduce_out(part) + b2.float()
    if rate_conn > 0.0:
        grows = _global_rows(torch.arange(B * L, device=h.device), b0, 0, L,
                             L)
        f2 = f2 * keep_factor_rows(out_seed, grows, d, rate_conn).reshape(
            B, L, d)
    out = (h.float() + f2).to(h.dtype)
    return out if quant_fmt is None else (out, amax2)
