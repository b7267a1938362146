"""Transformer encoder for text classification: eval and train forwards.

PyTorch counterpart of ``faster_distributed_training_tpu/models/
transformer.py`` on the classification path: BERT-style token + position
+ segment embeddings (fp32 island) plus the additive sinusoidal encoding
(``x = emb + dropout(emb + pe)``, the reference's quirk), six pre-LN
encoder layers (fused-qkv attention, exact-GELU FFN), a final LayerNorm,
the tanh CLS pooler and the fused-MLP classifier.

Attention routes to ``ops.flash_attention`` (the Hopper kernels on CUDA,
their plain versions on CPU; training goes through the autograd Function
``flash_attention_qkv``) or to the dense O(L²) softmax.  Embedding tables
and LayerNorm parameters stay fp32; the GEMM weights live in
``param_dtype`` and are cast to the compute ``dtype`` at use (a no-op when
the two agree, as in the serving build).

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
from faster_distributed_training_tpu_torch.ops.fused_mlp import fused_mlp
from faster_distributed_training_tpu_torch.ops.layernorm import (
    torch_layernorm, torch_layernorm_f32)


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
                 attention_impl: str = "dense"):
        super().__init__()
        if attention_impl not in ("dense", "flash"):
            raise ValueError(f"attention_impl {attention_impl!r}: the port "
                             f"has 'dense' and 'flash'")
        self.h = h
        self.d_model = d_model
        self.dropout = dropout
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.qkv = nn.Linear(d_model, 3 * d_model, dtype=param_dtype)
        self.out = nn.Linear(d_model, d_model, dtype=param_dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                train: bool = False,
                seeds: Optional[Iterator[int]] = None) -> torch.Tensor:
        B, L, _ = x.shape
        d_k = self.d_model // self.h
        qkv = _linear(x, self.qkv, self.dtype).view(B, L, 3, self.h, d_k)
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
        return _linear(ctx, self.out, self.dtype)


class PositionalWiseFFN(nn.Module):
    """Linear -> exact (erf) GELU -> dropout -> Linear."""

    def __init__(self, d_model: int, d_ff: int, dropout: float = 0.1,
                 dtype=torch.float32, param_dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.Dense_0 = nn.Linear(d_model, d_ff, dtype=param_dtype)
        self.Dense_1 = nn.Linear(d_ff, d_model, dtype=param_dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                seeds: Optional[Iterator[int]] = None) -> torch.Tensor:
        h = F.gelu(_linear(x, self.Dense_0, self.dtype), approximate="none")
        h = _dropout(h, self.dropout, train, seeds)
        return _linear(h, self.Dense_1, self.dtype)


class EncoderLayer(nn.Module):
    """Pre-LN attention sublayer then pre-LN FFN sublayer, each with its
    connection dropout."""

    def __init__(self, h: int, d_model: int, d_ff: int,
                 dropout_connection_attention: float = 0.1,
                 dropout_connection_ffn: float = 0.1,
                 dropout_attention: float = 0.1, dropout_ffn: float = 0.1,
                 dtype=torch.float32, param_dtype=torch.float32,
                 attention_impl: str = "dense"):
        super().__init__()
        self.drop_attn_conn = dropout_connection_attention
        self.drop_ffn_conn = dropout_connection_ffn
        self.ln_attn = TorchLayerNorm(d_model, dtype=dtype)
        self.attn = MultiheadAttention(h, d_model, dropout_attention, dtype,
                                       param_dtype, attention_impl)
        self.ln_ffn = TorchLayerNorm(d_model, dtype=dtype)
        self.ffn = PositionalWiseFFN(d_model, d_ff, dropout_ffn, dtype,
                                     param_dtype)

    def forward(self, h: torch.Tensor, mask: Optional[torch.Tensor],
                train: bool = False,
                seeds: Optional[Iterator[int]] = None) -> torch.Tensor:
        a = self.attn(self.ln_attn(h), mask, train, seeds)
        h = h + _dropout(a, self.drop_attn_conn, train, seeds)
        f = self.ffn(self.ln_ffn(h), train, seeds)
        return h + _dropout(f, self.drop_ffn_conn, train, seeds)


class Transformer(nn.Module):
    """The classifier encoder; ``forward`` returns fp32 logits [B, n_class]
    at eval and ``(logits, index, lam)`` in training."""

    def __init__(self, n_class: int, vocab: int = 30522, n_layers: int = 6,
                 h: int = 8, d_model: int = 512, d_ff: int = 1024,
                 d_hidden: int = 1024, maxlen: int = 512,
                 dropout_encodings: float = 0.1,
                 dropout_connection_attention: float = 0.1,
                 dropout_connection_ffn: float = 0.1,
                 dropout_attention: float = 0.1, dropout_ffn: float = 0.1,
                 dropout_pooler: float = 0.1,
                 dtype=torch.float32, param_dtype=torch.float32,
                 attention_impl: str = "dense"):
        super().__init__()
        self.h = h
        self.dtype = dtype
        self.drop_enc = dropout_encodings
        self.drop_pool = dropout_pooler
        self.embeddings = Embeddings(d_model, vocab, maxlen)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_table(maxlen, d_model)),
            persistent=False)
        self.layers = nn.ModuleList(
            EncoderLayer(h, d_model, d_ff, dropout_connection_attention,
                         dropout_connection_ffn, dropout_attention,
                         dropout_ffn, dtype, param_dtype, attention_impl)
            for _ in range(n_layers))
        self.ln_final = TorchLayerNorm(d_model, dtype=dtype)
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
        """Seeds one training forward draws (every site active)."""
        return 2 + 4 * len(self.layers)

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

    def forward(self, x: torch.Tensor,
                token_types: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                train: bool = False, draws=None):
        """Eval: fp32 logits.  ``train=True``: ``(logits, index, lam)``
        with the randomness of ``draws`` (``seeds``, ``lam``, ``perm``)."""
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
