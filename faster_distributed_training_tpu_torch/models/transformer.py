"""Transformer encoder for text classification and next-token LM: eval
and train forwards.

PyTorch counterpart of ``faster_distributed_training_tpu/models/
transformer.py`` on the classification path: BERT-style token + position
+ segment embeddings (fp32 island) plus the additive sinusoidal encoding
(``x = emb + dropout(emb + pe)``, the reference's quirk), six pre-LN
encoder layers (fused-qkv attention, exact-GELU FFN), a final LayerNorm,
the tanh CLS pooler and the fused-MLP classifier.  With ``lm_head``
(``--task lm``) the final LayerNorm feeds a next-token head instead of the
pooler and classifier: tied to the token table by default, or a Dense of
its own (``--untie_lm_head``), as in the JAX model; ``causal``
(``--lm_causal``) adds the next-token mask to attention.

Attention routes to ``ops.flash_attention`` (the Hopper kernels on CUDA,
their plain versions on CPU; training goes through the autograd Function
``flash_attention_qkv``) or to the dense O(L²) softmax.  Embedding tables
and LayerNorm parameters stay fp32; the GEMM weights live in
``param_dtype`` and are cast to the compute ``dtype`` at use (a no-op when
the two agree, as in the serving build).

Under a ``QuantPolicy`` (``train.amp``) the qkv, out and FFN projections
are ``ops.quant.QuantDense`` (int8/fp8 GEMMs at delayed per-tensor
scales, amax histories as persistent buffers under the same module names
as the JAX ``batch_stats`` tree).  ``ffn_impl="pallas"`` runs each pre-LN
FFN sublayer through ``ops.fused_ffn`` (one kernel per call, recompute
backward; under a policy the quantized generalized core, whose amaxes
roll the FFN histories); its parameters and buffers keep the flax
branch's ``state_dict`` keys, so a checkpoint loads into either branch.

``remat=True`` (``--remat``) checkpoints by ``remat_policy`` (the JAX
model's ``REMAT_POLICIES``): ``layer`` the whole ``EncoderLayer``, ``ffn``
the FFN sublayer only (the flax FFN or the fused kernel's call),
``attn_out`` the whole layer with the attention context saved (the flash
forward is not replayed), ``dots`` the whole layer with the matmul
outputs saved and the elementwise chains replayed.  Under ``layer``,
``attn_out`` and ``dots`` flash attention keeps input-only residuals
(``save_stats=False``: the recompute backward, TPU row 5's route), as in
the JAX model; ``ffn`` keeps the saved-stats backward.  Each layer's
region draws its dropout seeds from a stream that restarts at the
region's first seed each time the region runs, so the replay reuses the
forward's seeds.

Under sequence parallelism (``sp``, a ``parallel.collectives.SequenceGroup``
of size above 1: ``--mesh sp=S``) each rank runs its L/S positions of
every row (positions ``[s0, s0 + L/S)``, ``s0`` = its sp index · L/S)
with the whole weights (JAX's sequence-sharded residual stream,
``models/transformer.py:585-606``): the position tables at ``s0``, the
LayerNorms, the FFN (the fused kernel at the sequence offsets ``s0``,
``l_loc``, ``l_glob``) and every dropout site at the global rows;
attention alone crosses the shards, through ``ops.ring_attention`` or
``ops.ulysses_attention`` (``attention_impl`` ``ring`` / ``ulysses``).
The CLS row lives on sp index 0: it is broadcast to every rank
(``SequenceGroup.broadcast0``, backward a SUM onto index 0), and the
pooler, the mixup and the classifier run replicated on each.

Under tensor parallelism (``tp``, a ``parallel.collectives.TensorGroup``
of size above 1: ``--mesh tp=N``) each rank holds its shards of the
weights (``parallel.sharding.tp_cut``) and runs the Megatron layout
(JAX's ``_TP_RULES`` and ``parallel/kernel_shard.py``): the token table
on its ceil(V/tp) vocab rows (a masked local lookup, then a SUM over
tp); per layer the qkv projection column-parallel on H/tp heads (the
flash kernels or the dense softmax at the head origin ``h0``), the out
projection row-parallel (one SUM), the FFN column then row (the flax
branch's hidden dropout at the global columns, one SUM; the fused branch
row 8's ``partial`` tile, one SUM); the LayerNorms, the pooler, the
classifier and the other embeddings replicated.  Where a replicated
activation enters a rank's shard, its cotangent is summed over tp
(``TensorGroup.copy_in``), so every replicated parameter's gradient
comes out the same on every rank.

``train=True`` runs the training forward: hash dropout at every site of
the JAX model (encodings; per layer the attention probabilities, the
attention connection, the FFN hidden and the FFN connection; the pooler)
and the in-forward sentence-embedding mixup, returning
``(logits, index, lam)``.  Its randomness is explicit: ``draws`` carries
one u32 seed per active dropout site in that call order, the mixup
lambda and the permutation (``train.steps.StepDraws``).
"""

from __future__ import annotations

import math
from typing import Callable, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from faster_distributed_training_tpu_torch.models.remat import (
    remat, replaying, stashed_attention)
from faster_distributed_training_tpu_torch.ops.attention import (
    NEG_INF, dense_attention_reference)
from faster_distributed_training_tpu_torch.ops.dropout import hash_dropout
from faster_distributed_training_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_qkv)
from faster_distributed_training_tpu_torch.ops.fused_ffn import (
    ffn_core_generalized, fused_ffn_sublayer)
from faster_distributed_training_tpu_torch.ops.fused_mlp import (
    fused_mlp, mlp_reference)
from faster_distributed_training_tpu_torch.ops.layernorm import (
    torch_layernorm, torch_layernorm_f32)
from faster_distributed_training_tpu_torch.ops.quant import (
    QuantDense, quant_enabled, scale_from_history, tensor_amax,
    update_amax_history)
from faster_distributed_training_tpu_torch.ops.ring_attention import (
    ring_self_attention)
from faster_distributed_training_tpu_torch.ops.ulysses_attention import (
    ulysses_attention)
from faster_distributed_training_tpu_torch.parallel import (collectives,
                                                            kernel_shard)
from faster_distributed_training_tpu_torch.parallel.collectives import (
    TensorGroup, all_max_)
from faster_distributed_training_tpu_torch.parallel.pipeline import (
    current_tick)
from faster_distributed_training_tpu_torch.parallel.sharding import (
    tp_cut, tp_shard)


def _tp(tp):
    """The TensorGroup a module shards over, or None (one shard)."""
    return tp if tp is not None and tp.size > 1 else None


def _sp(sp):
    """The SequenceGroup a module's positions are split over, or None."""
    return sp if sp is not None and sp.size > 1 else None


def _dense(d_in: int, d_out: int, quant, dtype, param_dtype, tp=None,
           tp_dim: Optional[int] = None) -> nn.Module:
    """nn.Linear, or its quantized twin under a QuantPolicy; under tp the
    caller passes the rank's shard's features, and ``tp_dim`` the JAX
    kernel dim the site's rule shards (QuantDense's role)."""
    if quant is None:
        return nn.Linear(d_in, d_out, dtype=param_dtype)
    return QuantDense(d_in, d_out, fmt=quant.fmt,
                      amax_history_len=quant.amax_history_len,
                      margin=quant.margin, frozen_scales=quant.frozen_scales,
                      grad_fmt=quant.grad_fmt, dtype=dtype,
                      param_dtype=param_dtype, tp=tp, tp_dim=tp_dim)


def _project(x: torch.Tensor, layer: nn.Module, dtype, train: bool,
             tp=None) -> torch.Tensor:
    """A projection; with ``tp`` a row-parallel one: the partial product
    of the rank's input columns SUMmed over tp, then the whole bias."""
    if isinstance(layer, QuantDense):
        return layer(x, train)
    if tp is None:
        return _linear(x, layer, dtype)
    return tp.reduce_out(F.linear(x, layer.weight.to(dtype))
                         ) + layer.bias.to(dtype)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    return F.linear(x, layer.weight.to(dtype), layer.bias.to(dtype))


class SeedStream:
    """A training forward's dropout seeds (``draws.seeds``: Python ints
    or a 1-D device tensor), drawn in site order by ``next``, and ``b0``,
    the global index of the batch's first row (``draws.b0``: a
    data-parallel rank's origin), which every site's stream adds; under
    sp, ``s0`` and ``l_glob``: the rank's first position and the whole
    sequence length (0: the rows hold every position)."""

    def __init__(self, seeds, pos: int = 0, b0: int = 0, s0: int = 0,
                 l_glob: int = 0):
        self.seeds, self.pos, self.b0 = seeds, pos, int(b0)
        self.s0, self.l_glob = int(s0), int(l_glob)

    def __iter__(self):
        return self

    def __next__(self):
        self.pos += 1
        return self.seeds[self.pos - 1]


def _remat_seeded(fn: Callable, module: nn.Module, x: torch.Tensor,
                  seeds: SeedStream, dots: bool = False) -> torch.Tensor:
    """``remat`` of ``fn(x, seeds)``: every run of the region (the
    forward, then the replay) draws from the same first seed, and
    ``seeds`` moves past the ones the forward drew."""
    start = seeds.pos
    own = SeedStream(seeds.seeds, start, seeds.b0, seeds.s0, seeds.l_glob)

    def region(y):
        own.pos = start
        return fn(y, own)
    out = remat(region, module, x, dots=dots)
    seeds.pos = own.pos
    return out


def _origin(seeds) -> int:
    """The batch origin a seed stream carries (0 for a plain iterator of
    seeds, or none)."""
    return getattr(seeds, "b0", 0)


def _seq(seeds) -> tuple:
    """(s0, l_glob) of a seed stream's rows ((0, 0): every position)."""
    return getattr(seeds, "s0", 0), getattr(seeds, "l_glob", 0)


def _dropout(x: torch.Tensor, rate: float, train: bool,
             seeds: Optional[SeedStream]) -> torch.Tensor:
    """One FastDropout site: draws its seed only when it is active.  Its
    stream addresses the global batch: element 0 of batch row 0 is
    global element ``b0 * (elements a row)``; an sp rank's [B, L/S, d]
    shard draws the words of its global positions."""
    if not train or rate <= 0.0:
        return x
    s0, l_glob = _seq(seeds) if x.dim() == 3 else (0, 0)
    row = (l_glob * x.shape[-1] if l_glob else int(np.prod(x.shape[1:])))
    return hash_dropout(x, next(seeds), rate, offset=_origin(seeds) * row,
                        s0=s0, l_glob=l_glob)


class TorchLayerNorm(nn.Module):
    """The reference's LayerNorm: unbiased std, eps added to the std,
    computed in fp32 and cast to the compute dtype.  The saved-stats
    Function runs only where autograd will need its residuals; eval and
    serving take the plain form."""

    def __init__(self, d: int, eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ln = (torch_layernorm if torch.is_grad_enabled() and (
            x.requires_grad or self.scale.requires_grad)
            else torch_layernorm_f32)
        return ln(x.float(), self.scale.float(), self.bias.float(),
                  self.eps).to(self.dtype)


def sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    """Static sin/cos table (the JAX package's, built on the host)."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len)[:, None]
    scale = np.exp(np.arange(0, d_model, 2) * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * scale)
    pe[:, 1::2] = np.cos(position * scale)
    return pe


class _Lookup(torch.autograd.Function):
    """``table[idx]`` whose backward sums the cotangent rows of each index
    in a fixed order: a stable sort of the indices, an fp64 running sum
    over the sorted rows, and each index's total as the difference across
    its run, written once to its row.  Bitwise the same from launch to
    launch on the card, where ``F.embedding``'s backward was not for
    repeated indices (``chip_smoke.py`` holds two identical training steps
    bitwise equal)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return F.embedding(idx, table)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        flat = idx.reshape(-1)
        n = flat.numel()
        srt, perm = torch.sort(flat, stable=True)
        # running sums along the last dimension ([d, n]: torch's fast scan)
        run = torch.cumsum(g.reshape(n, -1)[perm].double().t().contiguous(),
                           dim=1)
        first = torch.ones_like(flat, dtype=torch.bool)
        first[1:] = srt[1:] != srt[:-1]
        last = torch.ones_like(first)
        last[:-1] = first[1:]
        pos = torch.arange(n, device=flat.device)
        start = torch.where(first, pos, 0).cummax(0).values
        before = run.index_select(1, (start - 1).clamp(min=0))
        before.mul_((start > 0).to(before.dtype))
        run.sub_(before)
        del before
        # each run's last row carries its total; every other row goes to a
        # spare row past the table, dropped below
        rows = torch.where(last, srt, ctx.n_rows)
        out = torch.zeros(ctx.n_rows + 1, g.shape[-1], dtype=g.dtype,
                          device=g.device)
        out.index_put_((rows,), run.t().to(g.dtype))
        return out[:ctx.n_rows], None


class Embeddings(nn.Module):
    """token + learned-position + segment embeddings scaled by
    sqrt(d_model); tables and the sum stay fp32.  Under tp the token
    table holds the rank's vocab rows ``[v0, v0 + ceil(V/tp))``: the tokens
    outside look up zeros, and the SUM over tp (each token found on one
    rank: exact) is the whole lookup; its identity backward leaves each
    rank's cotangents to its own rows."""

    def __init__(self, d_model: int, vocab: int, maxlen: int, tp=None):
        super().__init__()
        self.d_model = d_model
        self.tp = _tp(tp)
        self.vocab = vocab
        # a rank's ceil(V/tp) rows: past V the last shards hold padding,
        # never looked up (zero gradient), dropped when gathered whole
        rows = vocab if self.tp is None else -(-vocab // self.tp.size)
        self.v0 = 0 if self.tp is None else self.tp.rank * rows
        self.token_embedding = nn.Parameter(torch.empty(rows, d_model))
        self.pos_embedding = nn.Parameter(torch.empty(maxlen, d_model))
        self.segment_embedding = nn.Parameter(torch.empty(3, d_model))

    def _tokens(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return _Lookup.apply(self.token_embedding, x).float()
        rows = self.token_embedding.shape[0]
        local = x.long() - self.v0
        mine = (local >= 0) & (local < rows)
        # another rank's token reads row 0 and is zeroed (its cotangent
        # too: row 0 gains exact zeros)
        part = _Lookup.apply(self.token_embedding,
                             torch.where(mine, local, 0)).float()
        return self.tp.reduce_out(part * mine[..., None])

    def forward(self, x: torch.Tensor, token_types: torch.Tensor,
                s0: int = 0) -> torch.Tensor:
        """x: token ids [B, L]; under sp the rank's positions ``[s0, s0 +
        L)`` (the position table's rows there)."""
        L = x.shape[1]
        tokens = self._tokens(x)
        positions = self.pos_embedding[None, s0:s0 + L, :].float()
        segments = _Lookup.apply(self.segment_embedding,
                                 token_types[:, :L]).float()
        return (tokens + positions + segments) * math.sqrt(self.d_model)


def dense_attention(q, k, v, mask):
    """Eval ScaledDotProduct: scores in the compute dtype, masked with
    NEG_INF, fp32 softmax cast back, probabilities . v."""
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores.masked_fill(mask == 0, NEG_INF)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


class MultiheadAttention(nn.Module):
    """Fused qkv projection (one d_model -> 3*d_model GEMM laid out
    (3, h, d_k) like the JAX kernel), flash or dense context with
    attention-probability hash dropout in training, output projection.
    Under tp: the rank's H/tp heads (qkv column-parallel, its rows
    ``{i*H*d_k + (h0 + j)*d_k + k}``), the context of those heads, the
    out projection row-parallel on the matching d_model/tp inputs.
    ``ring`` / ``ulysses``: the rank's positions of a sequence split over
    ``sp`` (a ``SequenceGroup``; None: one shard), its queries attending
    over every rank's keys."""

    def __init__(self, h: int, d_model: int, dropout: float = 0.1,
                 dtype=torch.float32, param_dtype=torch.float32,
                 attention_impl: str = "dense", quant=None, tp=None,
                 sp=None):
        super().__init__()
        if attention_impl not in ("dense", "flash", "ring", "ulysses"):
            raise ValueError(f"attention_impl {attention_impl!r}: the port "
                             f"has 'dense', 'flash', 'ring' and 'ulysses'")
        # the flash backward's route (None: FDT_FLASH_SAVE_STATS decides)
        # and whether an attn_out region stashes the context
        self.save_stats: Optional[bool] = None
        self.stash_context = False
        self.h = h
        self.d_model = d_model
        self.dropout = dropout
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.tp = _tp(tp)
        self.sp = _sp(sp)
        # the rank's heads [h0, h0 + h_loc) of h
        self.h_loc = h if self.tp is None else self.tp.part(h)
        self.h0 = 0 if self.tp is None else self.tp.rank * self.h_loc
        d_loc = d_model // h * self.h_loc
        self.qkv = _dense(d_model, 3 * d_loc, quant, dtype, param_dtype,
                          self.tp, 2)
        self.out = _dense(d_loc, d_model, quant, dtype, param_dtype,
                          self.tp, 0)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                train: bool = False,
                seeds: Optional[Iterator[int]] = None) -> torch.Tensor:
        B, L, _ = x.shape
        d_k = self.d_model // self.h
        tp = self.tp
        if tp is not None:
            x = tp.copy_in(x)
        qkv = _project(x, self.qkv, self.dtype, train).view(
            B, L, 3, self.h_loc, d_k)
        # [B, h, L, d_k] strided views of the fused projection: the flash
        # kernels read them (and write their gradient) in place
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        rate = self.dropout if train else 0.0
        seed = next(seeds) if rate > 0.0 else None
        if self.attention_impl == "ring":
            ctx = ring_self_attention(q, k, v, mask, self.sp,
                                      b0=_origin(seeds), dropout_rate=rate,
                                      dropout_seed=seed)
        elif self.attention_impl == "ulysses":
            ctx = ulysses_attention(
                qkv, self.sp, None if mask is None else mask.reshape(B, L),
                dropout_rate=rate, dropout_seed=seed, b0=_origin(seeds),
                save_stats=self.save_stats)
        elif self.attention_impl == "flash":
            # the dropout stream addresses the global (b, h): the batch
            # origin b0, the head origin h0 of h (h0 = 0 without tp)
            org = dict(b0=_origin(seeds), h0=self.h0, h_glob=self.h)
            if train and self.stash_context:
                ctx = stashed_attention(qkv, lambda: flash_attention_qkv(
                    qkv, mask, rate, seed, save_stats=self.save_stats,
                    **org))
            elif train:
                ctx = flash_attention_qkv(qkv, mask, rate, seed,
                                          save_stats=self.save_stats, **org)
            else:
                ctx = flash_attention(q, k, v, mask=mask)
        elif rate > 0.0:
            # dense with the hash engine: softmax, then the same keep mask
            # the flash kernels apply
            ctx = dense_attention_reference(q, k, v, mask, rate,
                                            dropout_seed=seed,
                                            b0=_origin(seeds), h0=self.h0,
                                            h_glob=self.h)
        else:
            ctx = dense_attention(q, k, v, mask)
        ctx = ctx.transpose(1, 2).reshape(B, L, self.h_loc * d_k)
        return _project(ctx, self.out, self.dtype, train, tp)


class PositionalWiseFFN(nn.Module):
    """Linear -> exact (erf) GELU -> dropout -> Linear.  Under tp: Dense_0
    column-parallel on the rank's d_ff/tp hidden columns ``[c0, c0 +
    d_ff/tp)``, whose dropout draws the words of the global columns,
    Dense_1 row-parallel (one SUM)."""

    def __init__(self, d_model: int, d_ff: int, dropout: float = 0.1,
                 dtype=torch.float32, param_dtype=torch.float32, quant=None,
                 tp=None):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.tp = _tp(tp)
        self.d_ff = d_ff
        dff_loc = d_ff if self.tp is None else self.tp.part(d_ff)
        self.c0 = 0 if self.tp is None else self.tp.rank * dff_loc
        self.Dense_0 = _dense(d_model, dff_loc, quant, dtype, param_dtype,
                              self.tp, 1)
        self.Dense_1 = _dense(dff_loc, d_model, quant, dtype, param_dtype,
                              self.tp, 0)

    def forward(self, x: torch.Tensor, train: bool = False,
                seeds: Optional[Iterator[int]] = None) -> torch.Tensor:
        tp = self.tp
        if tp is not None:
            x = tp.copy_in(x)
        h = F.gelu(_project(x, self.Dense_0, self.dtype, train),
                   approximate="none")
        if tp is None:
            h = _dropout(h, self.dropout, train, seeds)
        elif train and self.dropout > 0.0:
            # the global [B, L, d_ff] stream's words at this rank's columns
            h = hash_dropout(h, next(seeds), self.dropout,
                             offset=_origin(seeds) * h.shape[1] * self.d_ff,
                             col0=self.c0, cols_glob=self.d_ff)
        return _project(h, self.Dense_1, self.dtype, train, tp)


class EncoderLayer(nn.Module):
    """Pre-LN attention sublayer then pre-LN FFN sublayer, each with its
    connection dropout.  ``ffn_impl="pallas"`` runs the FFN sublayer (LN,
    both GEMMs, GELU, both dropout sites, residual) in the fused kernel,
    reading the parameters of ``ln_ffn`` and ``ffn`` in place."""

    def __init__(self, h: int, d_model: int, d_ff: int,
                 dropout_connection_attention: float = 0.1,
                 dropout_connection_ffn: float = 0.1,
                 dropout_attention: float = 0.1, dropout_ffn: float = 0.1,
                 dtype=torch.float32, param_dtype=torch.float32,
                 attention_impl: str = "dense", ffn_impl: str = "flax",
                 quant=None, remat_ffn: bool = False, tp=None, sp=None):
        super().__init__()
        if ffn_impl not in ("flax", "pallas"):
            raise ValueError(f"ffn_impl {ffn_impl!r}: the port has 'flax' "
                             f"and 'pallas'")
        self.tp = _tp(tp)
        self.remat_ffn = remat_ffn
        self.dtype = dtype
        self.ffn_impl = ffn_impl
        self.quant = quant
        self.drop_attn_conn = dropout_connection_attention
        self.drop_ffn_conn = dropout_connection_ffn
        self.ln_attn = TorchLayerNorm(d_model, dtype=dtype)
        self.attn = MultiheadAttention(h, d_model, dropout_attention, dtype,
                                       param_dtype, attention_impl, quant,
                                       tp, sp)
        self.ln_ffn = TorchLayerNorm(d_model, dtype=dtype)
        self.ffn = PositionalWiseFFN(d_model, d_ff, dropout_ffn, dtype,
                                     param_dtype, quant, tp)

    def forward(self, h: torch.Tensor, mask: Optional[torch.Tensor],
                train: bool = False,
                seeds: Optional[Iterator[int]] = None) -> torch.Tensor:
        a = self.attn(self.ln_attn(h), mask, train, seeds)
        h = h + _dropout(a, self.drop_attn_conn, train, seeds)
        if self.remat_ffn and train:
            return self._remat_ffn(h, seeds)
        if self.ffn_impl == "pallas":
            return self._fused_ffn(h, train, seeds)
        f = self.ffn(self.ln_ffn(h), train, seeds)
        return h + _dropout(f, self.drop_ffn_conn, train, seeds)

    def n_seeds(self) -> int:
        """Seeds one training forward of the layer draws: one a site whose
        rate is above 0 (the fused FFN's pair: two when either is)."""
        n = int(self.attn.dropout > 0.0) + int(self.drop_attn_conn > 0.0)
        if self.ffn_impl == "pallas":
            return n + (2 if (self.ffn.dropout > 0.0
                              or self.drop_ffn_conn > 0.0) else 0)
        return n + int(self.ffn.dropout > 0.0) + int(self.drop_ffn_conn > 0.0)

    def _remat_ffn(self, h: torch.Tensor, seeds: SeedStream
                   ) -> torch.Tensor:
        """``--remat_policy ffn``: the FFN module (flax branch) or the
        fused sublayer's call checkpointed."""
        if self.ffn_impl == "pallas":
            return _remat_seeded(lambda x, s: self._fused_ffn(x, True, s),
                                 self.ffn, h, seeds)
        f = _remat_seeded(lambda x, s: self.ffn(x, True, s), self.ffn,
                          self.ln_ffn(h), seeds)
        return h + _dropout(f, self.drop_ffn_conn, True, seeds)

    def _fused_ffn(self, h: torch.Tensor, train: bool,
                   seeds: Optional[Iterator[int]]) -> torch.Tensor:
        """The JAX EncoderLayer's ``ffn_impl="pallas"`` branch: one fused
        sublayer; with active dropout its two seeds are one (hid, out)
        pair, drawn where the flax branch draws the FFN-hidden and
        FFN-connection seeds."""
        r_h, r_c = self.ffn.dropout, self.drop_ffn_conn
        b0 = _origin(seeds)
        # the rows' sequence offsets (an sp rank's positions s0.. of
        # l_glob; (0, L) otherwise)
        seq = int(h.shape[-2])
        s0, l_glob = _seq(seeds)
        l_glob = l_glob or seq
        if train and (r_h > 0.0 or r_c > 0.0):
            hid_seed, out_seed = next(seeds), next(seeds)
        else:
            hid_seed = out_seed = 0
            r_h = r_c = 0.0
        fmt = self.quant.fmt if (self.quant is not None
                                 and quant_enabled()) else None
        d0, d1, dt, tp = self.ffn.Dense_0, self.ffn.Dense_1, self.dtype, \
            self.tp
        w1, b1 = d0.weight.to(dt), d0.bias.to(dt)
        w2, b2 = d1.weight.to(dt), d1.bias.to(dt)
        ln = self.ln_ffn
        args = (h, ln.scale, ln.bias, w1, b1, w2, b2, hid_seed, out_seed)
        quant = {}
        # a staged forward's cadence: the pre-step scales for every
        # microbatch, one roll a step
        cad = (current_tick() if train and fmt is not None
               and not self.quant.frozen_scales else None)
        if fmt is not None:
            hists = (d0.amax_history_x, d0.amax_history_w,
                     d1.amax_history_x, d1.amax_history_w)
            pre = hists if cad is None else tuple(
                cad.amax_pre((id(self), i), t) for i, t in enumerate(hists))
            quant = dict(quant_fmt=fmt, quant_scales=tuple(
                scale_from_history(t, fmt, self.quant.margin)
                for t in pre), grad_fmt=self.quant.grad_fmt)
        if tp is not None:
            # row 8's partial tile on the rank's d_ff shard, one SUM
            res = kernel_shard.fused_ffn_sublayer_tp(
                *args, tp, r_h, r_c, ln.eps, b0, **quant)
        elif fmt is None:
            # FDT_QUANT=0 keeps the state allocated but runs the plain
            # kernel (the QuantDense contract)
            return fused_ffn_sublayer(*args, r_h, r_c, ln.eps, b0=b0, s0=s0,
                                      l_glob=l_glob)
        else:
            res = ffn_core_generalized(
                *args, b0, s0, 0, r_h, r_c, ln.eps, seq, l_glob,
                dff_glob=w1.shape[0], **quant)
        if fmt is None:
            return res
        out, amax2 = res
        if train and not self.quant.frozen_scales and not replaying():
            # roll as QuantDense would: x-side amaxes from the kernel (LN
            # output, post-dropout activation; over the global batch (and
            # under sp every position) and, under tp, the rank's columns
            # MAXed with the others'), w-side
            # from the cast weights (their shards' MAX over tp; never in a
            # --remat replay: once a step)
            g = tp if tp is not None else TensorGroup()
            with torch.no_grad():
                amax2 = g.max_(all_max_(amax2.clone()))
                for i, (hist, amax) in enumerate(zip(hists, (
                        amax2[0], g.max_(tensor_amax(w1)), amax2[1],
                        g.max_(tensor_amax(w2))))):
                    if cad is not None:
                        cad.amax_push((id(self), i), hist, amax)
                    else:
                        hist.copy_(update_amax_history(hist, amax))
        return out


# the JAX model's --remat_policy values
REMAT_POLICIES = ("layer", "ffn", "attn_out", "dots")


class Transformer(nn.Module):
    """The classifier encoder; ``forward`` returns fp32 logits [B, n_class]
    at eval and ``(logits, index, lam)`` in training.  With ``lm_head``
    the next-token LM: fp32 logits [B, L, vocab] in both."""

    def __init__(self, n_class: int, vocab: int = 30522, n_layers: int = 6,
                 h: int = 8, d_model: int = 512, d_ff: int = 1024,
                 d_hidden: int = 1024, maxlen: int = 512,
                 dropout_encodings: float = 0.1,
                 dropout_connection_attention: float = 0.1,
                 dropout_connection_ffn: float = 0.1,
                 dropout_attention: float = 0.1, dropout_ffn: float = 0.1,
                 dropout_pooler: float = 0.1,
                 dtype=torch.float32, param_dtype=torch.float32,
                 attention_impl: str = "dense", ffn_impl: str = "flax",
                 quant=None, lm_head: bool = False,
                 tie_lm_head: bool = False, mlp_impl: str = "fused",
                 remat: bool = False, remat_policy: str = "attn_out",
                 causal: bool = False, tp=None, sp=None):
        super().__init__()
        # --lm_causal: every query attends to the keys at or before its
        # position (attention_mask)
        self.causal = causal
        self.tp = _tp(tp)
        self.sp = _sp(sp)
        if remat and remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r} not in "
                             f"{REMAT_POLICIES}")
        # the whole-layer policy, or None (no remat, or ffn: per layer)
        self.remat_layer = (remat_policy if remat and remat_policy != "ffn"
                            else None)
        self.h = h
        # "naive": the classifier MLP as plain autograd of its plain
        # version (the JAX --mlp_impl naive arm); else the kernel's Function
        self.mlp_impl = mlp_impl
        self.dtype = dtype
        self.drop_enc = dropout_encodings
        self.drop_pool = dropout_pooler
        self.lm = lm_head
        self.tie_lm_head = lm_head and tie_lm_head
        self.embeddings = Embeddings(d_model, vocab, maxlen, self.tp)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_table(maxlen, d_model)),
            persistent=False)
        self.layers = nn.ModuleList(
            EncoderLayer(h, d_model, d_ff, dropout_connection_attention,
                         dropout_connection_ffn, dropout_attention,
                         dropout_ffn, dtype, param_dtype, attention_impl,
                         ffn_impl, quant,
                         remat_ffn=remat and remat_policy == "ffn",
                         tp=self.tp, sp=self.sp)
            for _ in range(n_layers))
        if self.remat_layer is not None:
            # attention inside a checkpointed layer keeps input-only
            # residuals (the JAX model's flash_save_stats)
            for layer in self.layers:
                layer.attn.save_stats = False
                layer.attn.stash_context = (self.remat_layer == "attn_out"
                                            and attention_impl == "flash")
        self.ln_final = TorchLayerNorm(d_model, dtype=dtype)
        if lm_head:
            # the next-token head: tied to the token table, or a Dense of
            # its own; no pooler, no classifier
            if not tie_lm_head:
                self.lm_head = nn.Linear(d_model, vocab, dtype=param_dtype)
            return
        self.pooler = nn.Linear(d_model, d_model, dtype=param_dtype)
        # classifier weights in (out, in) layout, biases as row vectors —
        # the JAX parameter shapes
        self.cls_w1 = nn.Parameter(torch.empty(d_hidden, d_model,
                                               dtype=param_dtype))
        self.cls_b1 = nn.Parameter(torch.zeros(1, d_hidden,
                                               dtype=param_dtype))
        self.cls_w2 = nn.Parameter(torch.empty(n_class, d_hidden,
                                               dtype=param_dtype))
        self.cls_b2 = nn.Parameter(torch.zeros(1, n_class,
                                               dtype=param_dtype))

    def seed_positions(self) -> dict:
        """Where each piece's seeds start in a training forward's draws
        (the sites draw only when active): ``layers[i]`` layer i's first,
        ``head`` the pooler's (after the encodings and every layer)."""
        pos, starts = int(self.drop_enc > 0.0), []
        for layer in self.layers:
            starts.append(pos)
            pos += layer.n_seeds()
        return {"layers": starts, "head": pos}

    def n_dropout_sites(self) -> int:
        """Seeds one training forward draws (every site active): the
        encodings, four a layer and, on the classifier, the pooler."""
        return (1 if self.lm else 2) + 4 * len(self.layers)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Transformer":
        """The JAX package's initialisation drawn from ``generator``:
        Xavier-uniform for every matrix (the fused qkv kernel at the
        per-projection bound sqrt(3/d_model)), zero biases, unit LN
        scales.  Under tp each sharded leaf is drawn whole, in the same
        order, and cut to the rank's shard: the same weights as one
        card's."""
        def xavier(t, fan_in, fan_out):
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            t.uniform_(-bound, bound, generator=generator)

        for name, p in self.named_parameters():
            t = p if self.tp is None else torch.empty(
                self.whole_shape(name, p.shape), dtype=p.dtype,
                device=p.device)
            if name.endswith("qkv.weight"):
                bound = math.sqrt(3.0 / t.shape[1])
                t.uniform_(-bound, bound, generator=generator)
            elif name.endswith("scale"):
                t.fill_(1.0)
            elif t.dim() == 1 or name in ("cls_b1", "cls_b2"):
                t.zero_()
            else:
                xavier(t, t.shape[1], t.shape[0])
            if t is not p:
                p.copy_(tp_shard(t, tp_cut(name), self.tp.rank,
                                 self.tp.size, self.h))
        return self

    def whole_shape(self, name: str, shape) -> tuple:
        """The whole shape of parameter ``name`` whose tp shard has
        ``shape``."""
        cut, shape = tp_cut(name), list(shape)
        if self.tp is not None and cut is not None:
            shape[1 if cut == "cols" else 0] *= self.tp.size
        if name == "embeddings.token_embedding":
            shape[0] = self.embeddings.vocab     # the padding dropped
        return tuple(shape)

    @torch.no_grad()
    def seed_amax_histories(self, batch_size: int, seq_len: int,
                            draws) -> bool:
        """Under --quant, fresh (all-zero) amax histories would quantize
        the first step at scale 1, rounding every weight below 0.5 to
        zero.  The JAX package's init runs one training forward on a zero
        batch of the run's shape, which rolls each history once; this is
        that forward.  Returns whether it ran (histories present and all
        zero)."""
        hists = [b for n, b in self.named_buffers() if "amax_history" in n]
        if not hists or any(bool(h.any()) for h in hists):
            return False
        dev = self.embeddings.token_embedding.device
        # under sp the rank's positions of the batch
        n = 1 if self.sp is None else self.sp.size
        tokens = torch.zeros((batch_size, seq_len // n), dtype=torch.long,
                             device=dev)
        self(tokens, train=True, draws=draws)
        return True

    def _lm_logits(self, h: torch.Tensor) -> torch.Tensor:
        """fp32 next-token logits [B, L, vocab].  Tied: h . E^T on the raw
        fp32 token table, both operands rounded to the compute dtype and
        the product summed in fp32 (the JAX dot's
        ``preferred_element_type``), so the logits never pass through
        bf16.  Untied: the ``lm_head`` Dense in the compute dtype, cast
        to fp32 after (flax's Dense rounds its output to that dtype)."""
        if not self.tie_lm_head:
            return _linear(h, self.lm_head, self.dtype).float()
        table = self.embeddings.token_embedding.to(self.dtype)
        return torch.matmul(h.to(self.dtype).float(), table.float().t())

    def forward(self, x: torch.Tensor,
                token_types: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                train: bool = False, draws=None):
        """Eval: fp32 logits.  ``train=True``: ``(logits, index, lam)``
        with the randomness of ``draws`` (``seeds``, ``lam``, ``perm``).
        With the LM head, fp32 logits [B, L, vocab] either way (no
        mixup; ``draws.lam`` and ``draws.perm`` go unused).  The pieces a
        pipeline stage runs alone: ``embed`` (stage 0), ``run_layers`` (a
        chunk of layers on a microbatch) and ``head`` (the last stage)."""
        if train and draws is None:
            raise ValueError("the training forward takes its randomness "
                             "explicitly: pass draws (train.steps."
                             "StepDraws)")
        seeds = self.seed_stream(draws, x.shape[1]) if train else None
        h = self.embed(x, token_types, train, seeds)
        h = self.run_layers(h, self.attention_mask(mask, x), train, seeds)
        return self.head(h, train, draws, seeds)

    def seed_stream(self, draws, L: int, pos: int = 0, b0: int = 0
                    ) -> SeedStream:
        """A training forward's seeds from ``pos`` on, at the batch origin
        ``draws.b0 + b0``; under sp at this rank's positions (``L`` of
        them)."""
        s0, l_glob = ((self.sp.rank * L, self.sp.size * L)
                      if self.sp is not None else (0, 0))
        return SeedStream(draws.seeds, pos=pos, b0=draws.b0 + b0, s0=s0,
                          l_glob=l_glob)

    def attention_mask(self, mask: Optional[torch.Tensor],
                       x: Optional[torch.Tensor] = None
                       ) -> Optional[torch.Tensor]:
        """A [B, L] key mask as [B, 1, 1, L]; anything else unchanged.
        With ``causal`` (the JAX model's ``models/transformer.py:851-857``)
        the [1, 1, L, L] lower triangle, L the length of the tokens ``x``
        [B, L] (of the key mask without them), alone or times the key
        mask: the [B, 1, L, L] joint mask."""
        if mask is not None and mask.dim() == 2:
            mask = mask[:, None, None, :]
        if self.causal:
            ref = mask if x is None else x
            L = ref.shape[-1]
            cm = torch.tril(torch.ones((L, L), dtype=torch.int32,
                                       device=ref.device))[None, None]
            mask = cm if mask is None else mask * cm
        return mask

    def embed(self, x: torch.Tensor, token_types: Optional[torch.Tensor],
              train: bool, seeds: Optional[SeedStream]) -> torch.Tensor:
        """The encoder input: the embeddings plus their encodings dropout
        (``emb + dropout(emb + pe)``), in the compute dtype.  Under sp x
        holds this rank's positions [s0, s0 + L) of l_glob."""
        L = x.shape[1]
        s0 = self.sp.rank * L if self.sp is not None else 0
        if token_types is None:
            token_types = torch.zeros_like(x)
        embeddings = self.embeddings(x, token_types, s0)
        encodings = _dropout(embeddings + self.pe[None, s0:s0 + L, :],
                             self.drop_enc, train, seeds)
        return (embeddings + encodings).to(self.dtype)

    def run_layers(self, h: torch.Tensor, mask: Optional[torch.Tensor],
                   train: bool, seeds: Optional[SeedStream],
                   layers: Optional[tuple] = None) -> torch.Tensor:
        """Encoder layers ``layers`` (indices; every layer when None) on
        ``h`` with the [B, 1, 1, L] key ``mask``, drawing from ``seeds``
        in order."""
        for i in (range(len(self.layers)) if layers is None else layers):
            layer = self.layers[i]
            if train and self.remat_layer is not None:
                h = _remat_seeded(
                    lambda x, s, lyr=layer: lyr(x, mask, True, s), layer, h,
                    seeds, dots=self.remat_layer == "dots")
            else:
                h = layer(h, mask, train, seeds)
        return h

    def head(self, h: torch.Tensor, train: bool, draws,
             seeds: Optional[SeedStream]):
        """ln_final, then the LM logits, or the pooler, the mixup (in
        training) and the classifier, on the encoder output ``h``;
        ``seeds`` at the pooler's seed."""
        h = self.ln_final(h)
        if self.lm:
            return self._lm_logits(h)
        cls = h[:, 0, :]
        if self.sp is not None:
            # the CLS row is sp index 0's: every rank runs the head on it
            cls = self.sp.broadcast0(cls)
        pooled = torch.tanh(_linear(cls, self.pooler, self.dtype))
        pooled = _dropout(pooled, self.drop_pool, train, seeds)
        dt = self.dtype

        mlp = mlp_reference if self.mlp_impl == "naive" else fused_mlp

        def classify(z):
            return mlp(z.to(dt), self.cls_w1.to(dt), self.cls_b1.to(dt),
                       self.cls_w2.to(dt), self.cls_b2.to(dt)).float()

        if not train:
            return classify(pooled)
        # in-forward sentence-embedding mixup (the JAX model's
        # models/transformer.py:1077-1088), lambda cast to the compute
        # dtype as there.  The permutation is over the global batch: this
        # rank's rows take their partners from every rank's pooled rows
        # (gathered; the partners' cotangents go back to their ranks)
        lam = (draws.lam if torch.is_tensor(draws.lam)
               else torch.tensor(draws.lam, dtype=torch.float32))
        index = (draws.perm.to(pooled.device, torch.long)
                 if torch.is_tensor(draws.perm) else
                 torch.as_tensor(np.array(draws.perm), dtype=torch.long,
                                 device=pooled.device))
        index = index[draws.b0:draws.b0 + pooled.shape[0]]
        group = collectives.current()
        partners = pooled if group is None else group.gather_rows(pooled)
        mixed = (lam.to(pooled.device, pooled.dtype) * pooled
                 + (1.0 - lam).to(pooled.device, pooled.dtype)
                 * partners[index])
        return classify(mixed), index, lam
