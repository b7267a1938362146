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
its own (``--untie_lm_head``), as in the JAX model.

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
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from faster_distributed_training_tpu_torch.ops.attention import (
    NEG_INF, dense_attention_reference)
from faster_distributed_training_tpu_torch.ops.dropout import hash_dropout
from faster_distributed_training_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_qkv)
from faster_distributed_training_tpu_torch.ops.fused_ffn import (
    ffn_core_generalized, fused_ffn_sublayer)
from faster_distributed_training_tpu_torch.ops.fused_mlp import fused_mlp
from faster_distributed_training_tpu_torch.ops.layernorm import (
    torch_layernorm, torch_layernorm_f32)
from faster_distributed_training_tpu_torch.ops.quant import (
    QuantDense, quant_enabled, scale_from_history, tensor_amax,
    update_amax_history)


def _dense(d_in: int, d_out: int, quant, dtype, param_dtype) -> nn.Module:
    """nn.Linear, or its quantized twin under a QuantPolicy."""
    if quant is None:
        return nn.Linear(d_in, d_out, dtype=param_dtype)
    return QuantDense(d_in, d_out, fmt=quant.fmt,
                      amax_history_len=quant.amax_history_len,
                      margin=quant.margin, frozen_scales=quant.frozen_scales,
                      grad_fmt=quant.grad_fmt, dtype=dtype,
                      param_dtype=param_dtype)


def _project(x: torch.Tensor, layer: nn.Module, dtype, train: bool
             ) -> torch.Tensor:
    if isinstance(layer, QuantDense):
        return layer(x, train)
    return _linear(x, layer, dtype)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    return F.linear(x, layer.weight.to(dtype), layer.bias.to(dtype))


def _dropout(x: torch.Tensor, rate: float, train: bool,
             seeds: Optional[Iterator[int]]) -> torch.Tensor:
    """One FastDropout site: draws its seed only when it is active."""
    if not train or rate <= 0.0:
        return x
    return hash_dropout(x, next(seeds), rate)


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


class Embeddings(nn.Module):
    """token + learned-position + segment embeddings scaled by
    sqrt(d_model); tables and the sum stay fp32."""

    def __init__(self, d_model: int, vocab: int, maxlen: int):
        super().__init__()
        self.d_model = d_model
        self.token_embedding = nn.Parameter(torch.empty(vocab, d_model))
        self.pos_embedding = nn.Parameter(torch.empty(maxlen, d_model))
        self.segment_embedding = nn.Parameter(torch.empty(3, d_model))

    def forward(self, x: torch.Tensor, token_types: torch.Tensor
                ) -> torch.Tensor:
        L = x.shape[1]
        tokens = F.embedding(x, self.token_embedding).float()
        positions = self.pos_embedding[None, :L, :].float()
        segments = F.embedding(token_types[:, :L],
                               self.segment_embedding).float()
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
    attention-probability hash dropout in training, output projection."""

    def __init__(self, h: int, d_model: int, dropout: float = 0.1,
                 dtype=torch.float32, param_dtype=torch.float32,
                 attention_impl: str = "dense", quant=None):
        super().__init__()
        if attention_impl not in ("dense", "flash"):
            raise ValueError(f"attention_impl {attention_impl!r}: the port "
                             f"has 'dense' and 'flash'")
        self.h = h
        self.d_model = d_model
        self.dropout = dropout
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.qkv = _dense(d_model, 3 * d_model, quant, dtype, param_dtype)
        self.out = _dense(d_model, d_model, quant, dtype, param_dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                train: bool = False,
                seeds: Optional[Iterator[int]] = None) -> torch.Tensor:
        B, L, _ = x.shape
        d_k = self.d_model // self.h
        qkv = _project(x, self.qkv, self.dtype, train).view(B, L, 3, self.h,
                                                            d_k)
        # [B, h, L, d_k] strided views of the fused projection: the flash
        # kernels read them (and write their gradient) in place
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        rate = self.dropout if train else 0.0
        seed = next(seeds) if rate > 0.0 else None
        if self.attention_impl == "flash":
            if train:
                ctx = flash_attention_qkv(qkv, mask, rate, seed)
            else:
                ctx = flash_attention(q, k, v, mask=mask)
        elif rate > 0.0:
            # dense with the hash engine: softmax, then the same keep mask
            # the flash kernels apply
            ctx = dense_attention_reference(q, k, v, mask, rate,
                                            dropout_seed=seed)
        else:
            ctx = dense_attention(q, k, v, mask)
        ctx = ctx.transpose(1, 2).reshape(B, L, self.d_model)
        return _project(ctx, self.out, self.dtype, train)


class PositionalWiseFFN(nn.Module):
    """Linear -> exact (erf) GELU -> dropout -> Linear."""

    def __init__(self, d_model: int, d_ff: int, dropout: float = 0.1,
                 dtype=torch.float32, param_dtype=torch.float32, quant=None):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.Dense_0 = _dense(d_model, d_ff, quant, dtype, param_dtype)
        self.Dense_1 = _dense(d_ff, d_model, quant, dtype, param_dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                seeds: Optional[Iterator[int]] = None) -> torch.Tensor:
        h = F.gelu(_project(x, self.Dense_0, self.dtype, train),
                   approximate="none")
        h = _dropout(h, self.dropout, train, seeds)
        return _project(h, self.Dense_1, self.dtype, train)


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
                 quant=None):
        super().__init__()
        if ffn_impl not in ("flax", "pallas"):
            raise ValueError(f"ffn_impl {ffn_impl!r}: the port has 'flax' "
                             f"and 'pallas'")
        self.dtype = dtype
        self.ffn_impl = ffn_impl
        self.quant = quant
        self.drop_attn_conn = dropout_connection_attention
        self.drop_ffn_conn = dropout_connection_ffn
        self.ln_attn = TorchLayerNorm(d_model, dtype=dtype)
        self.attn = MultiheadAttention(h, d_model, dropout_attention, dtype,
                                       param_dtype, attention_impl, quant)
        self.ln_ffn = TorchLayerNorm(d_model, dtype=dtype)
        self.ffn = PositionalWiseFFN(d_model, d_ff, dropout_ffn, dtype,
                                     param_dtype, quant)

    def forward(self, h: torch.Tensor, mask: Optional[torch.Tensor],
                train: bool = False,
                seeds: Optional[Iterator[int]] = None) -> torch.Tensor:
        a = self.attn(self.ln_attn(h), mask, train, seeds)
        h = h + _dropout(a, self.drop_attn_conn, train, seeds)
        if self.ffn_impl == "pallas":
            return self._fused_ffn(h, train, seeds)
        f = self.ffn(self.ln_ffn(h), train, seeds)
        return h + _dropout(f, self.drop_ffn_conn, train, seeds)

    def _fused_ffn(self, h: torch.Tensor, train: bool,
                   seeds: Optional[Iterator[int]]) -> torch.Tensor:
        """The JAX EncoderLayer's ``ffn_impl="pallas"`` branch: one fused
        sublayer; with active dropout its two seeds are one (hid, out)
        pair, drawn where the flax branch draws the FFN-hidden and
        FFN-connection seeds."""
        r_h, r_c = self.ffn.dropout, self.drop_ffn_conn
        if train and (r_h > 0.0 or r_c > 0.0):
            hid_seed, out_seed = next(seeds), next(seeds)
        else:
            hid_seed = out_seed = 0
            r_h = r_c = 0.0
        d0, d1, dt = self.ffn.Dense_0, self.ffn.Dense_1, self.dtype
        w1, b1 = d0.weight.to(dt), d0.bias.to(dt)
        w2, b2 = d1.weight.to(dt), d1.bias.to(dt)
        ln = self.ln_ffn
        fmt = self.quant.fmt if (self.quant is not None
                                 and quant_enabled()) else None
        if fmt is None:
            # FDT_QUANT=0 keeps the state allocated but runs the plain
            # kernel (the QuantDense contract)
            return fused_ffn_sublayer(h, ln.scale, ln.bias, w1, b1, w2, b2,
                                      hid_seed, out_seed, r_h, r_c, ln.eps)
        hists = (d0.amax_history_x, d0.amax_history_w, d1.amax_history_x,
                 d1.amax_history_w)
        scales = tuple(scale_from_history(t, fmt, self.quant.margin)
                       for t in hists)
        out, amax2 = ffn_core_generalized(
            h, ln.scale, ln.bias, w1, b1, w2, b2, hid_seed, out_seed, 0, 0,
            0, r_h, r_c, ln.eps, 1, 1, dff_glob=w1.shape[0], quant_fmt=fmt,
            quant_scales=scales, grad_fmt=self.quant.grad_fmt)
        if train and not self.quant.frozen_scales:
            # roll as QuantDense would: x-side amaxes from the kernel (LN
            # output, post-dropout activation), w-side from the cast weights
            with torch.no_grad():
                for hist, amax in zip(hists, (amax2[0], tensor_amax(w1),
                                              amax2[1], tensor_amax(w2))):
                    hist.copy_(update_amax_history(hist, amax))
        return out


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
                 tie_lm_head: bool = False):
        super().__init__()
        self.h = h
        self.dtype = dtype
        self.drop_enc = dropout_encodings
        self.drop_pool = dropout_pooler
        self.lm = lm_head
        self.tie_lm_head = lm_head and tie_lm_head
        self.embeddings = Embeddings(d_model, vocab, maxlen)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_table(maxlen, d_model)),
            persistent=False)
        self.layers = nn.ModuleList(
            EncoderLayer(h, d_model, d_ff, dropout_connection_attention,
                         dropout_connection_ffn, dropout_attention,
                         dropout_ffn, dtype, param_dtype, attention_impl,
                         ffn_impl, quant)
            for _ in range(n_layers))
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

    def n_dropout_sites(self) -> int:
        """Seeds one training forward draws (every site active): the
        encodings, four a layer and, on the classifier, the pooler."""
        return (1 if self.lm else 2) + 4 * len(self.layers)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Transformer":
        """The JAX package's initialisation drawn from ``generator``:
        Xavier-uniform for every matrix (the fused qkv kernel at the
        per-projection bound sqrt(3/d_model)), zero biases, unit LN
        scales."""
        def xavier(t, fan_in, fan_out):
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            t.uniform_(-bound, bound, generator=generator)

        for name, p in self.named_parameters():
            if name.endswith("qkv.weight"):
                bound = math.sqrt(3.0 / p.shape[1])
                p.uniform_(-bound, bound, generator=generator)
            elif name.endswith("scale"):
                p.fill_(1.0)
            elif p.dim() == 1 or name in ("cls_b1", "cls_b2"):
                p.zero_()
            else:
                xavier(p, p.shape[1], p.shape[0])
        return self

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
        tokens = torch.zeros((batch_size, seq_len), dtype=torch.long,
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
        mixup; ``draws.lam`` and ``draws.perm`` go unused)."""
        if train and draws is None:
            raise ValueError("the training forward takes its randomness "
                             "explicitly: pass draws (train.steps."
                             "StepDraws)")
        seeds = iter(draws.seeds) if train else None
        L = x.shape[1]
        if token_types is None:
            token_types = torch.zeros_like(x)
        embeddings = self.embeddings(x, token_types)
        encodings = _dropout(embeddings + self.pe[None, :L, :],
                             self.drop_enc, train, seeds)
        h = (embeddings + encodings).to(self.dtype)
        if mask is not None and mask.dim() == 2:
            mask = mask[:, None, None, :]
        for layer in self.layers:
            h = layer(h, mask, train, seeds)
        h = self.ln_final(h)
        if self.lm:
            return self._lm_logits(h)
        pooled = torch.tanh(_linear(h[:, 0, :], self.pooler, self.dtype))
        pooled = _dropout(pooled, self.drop_pool, train, seeds)
        dt = self.dtype

        def classify(z):
            return fused_mlp(z.to(dt), self.cls_w1.to(dt), self.cls_b1.to(dt),
                             self.cls_w2.to(dt), self.cls_b2.to(dt)).float()

        if not train:
            return classify(pooled)
        # in-forward sentence-embedding mixup (the JAX model's
        # models/transformer.py:1077-1088), lambda cast to the compute
        # dtype as there
        lam = torch.tensor(draws.lam, dtype=torch.float32)
        index = torch.as_tensor(np.array(draws.perm), dtype=torch.long,
                                device=pooled.device)
        mixed = (lam.to(pooled.device, pooled.dtype) * pooled
                 + (1.0 - lam).to(pooled.device, pooled.dtype)
                 * pooled[index])
        return classify(mixed), index, lam
