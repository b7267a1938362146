"""Decode-mode transformer: prefill (a whole prompt, K/V out) and the
decode step (one position a slot against the KV cache), computed from the
parameters of the port's own ``Transformer``.

Port of ``faster_distributed_training_tpu/models/decode.py``.  The eval
forward of the LM is split so the serving tier controls the shapes: the
decode step writes column ``pos`` of each slot's cache in place and
attends over a static ``window`` of columns (one CUDA graph a page count,
``serve/decode/engine.py``), with per-slot positions and request ids as
tensors.  Nothing here copies a weight: every helper reads the module's
own parameters (``embeddings``, ``layers[i].{ln_attn, attn.qkv, attn.out,
ln_ffn, ffn}``, ``ln_final`` and the tied token table or the untied
``lm_head``).

Decode serving imposes a causal mask: prefill runs the prompt under
:func:`causal_mask` and the cache only ever shows columns up to the
query's.  An LM trained without ``--lm_causal`` trained bidirectional, so
its generation is self-consistent but not its training conditional.

The envelope (:func:`decode_spec`): an LM head, tied or untied; the fused
qkv layout; no quantization.  ``attention_impl`` and ``ffn_impl`` gate
nothing: this module computes the dense attention and the plain FFN
whatever the model was built with, as the JAX mirror does.

Sampling: ``greedy`` is argmax (its first maximum, as ``jnp.argmax``).
``topk`` draws from the temperature-scaled top-k logits as
``jax.random.categorical`` does, ``argmax(v / T + g)`` with Gumbel noise
``g``.  The port has no threefry: ``g`` comes from the murmur3 hash of
(seed, request id, absolute position, rank within the top k)
(:func:`gumbel_noise`), so a request's stream is deterministic per
(seed, request) and independent of its slot, its admission order and
the replica serving it, the JAX package's contract with other bits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from faster_distributed_training_tpu_torch.models.transformer import (
    _linear, dense_attention)
from faster_distributed_training_tpu_torch.ops.attention import _M32, _fmix32
from faster_distributed_training_tpu_torch.ops.cached_attention import (
    cached_attention)

# the JAX package's refusals, word for word
NOT_AN_LM = ("decode serving needs an LM checkpoint (--task lm); this "
             "model has the classifier head — there is nothing to "
             "generate from")
QUANTIZED = ("decode serving supports unquantized checkpoints only "
             "(the QuantDense decode mirror is not implemented); "
             "serve with --quant none")
UNFUSED = ("decode serving reads the fused-QKV param layout; the "
           "unfused ablation arm's query/key/value tree is not "
           "mirrored")
# keeps the sampling stream apart from the attention dropout's, which
# chains the same finalizer from a bare seed
_GUMBEL_SALT = 0x6A09E667


@dataclasses.dataclass(frozen=True)
class DecodeSpec:
    """The model geometry a decode step closes over."""
    n_layers: int
    h: int
    d_model: int
    d_ff: int
    vocab: int
    maxlen: int
    tied: bool
    dtype: torch.dtype = torch.float32

    @property
    def d_k(self) -> int:
        return self.d_model // self.h


@dataclasses.dataclass(frozen=True)
class SamplingCfg:
    """The sampling rule, fixed for an engine (its graphs close over it):
    ``greedy`` ignores the rest; ``topk`` draws from the
    temperature-scaled ``top_k`` best logits (``top_k`` <= 0: the whole
    vocabulary) with the noise of :func:`gumbel_noise` under ``seed``."""
    method: str = "greedy"
    temperature: float = 1.0
    top_k: int = 40
    seed: int = 0


def decode_spec(model) -> DecodeSpec:
    """The decode geometry of a built ``Transformer``; a model outside
    the envelope raises the JAX package's ValueError (the port builds
    only the fused qkv layout: ``--tricks off`` raises ``UNFUSED`` in
    ``cli.run_decode_serving``)."""
    if not getattr(model, "lm", False):
        raise ValueError(NOT_AN_LM)
    if any(getattr(layer, "quant", None) is not None
           for layer in model.layers):
        raise ValueError(QUANTIZED)
    emb = model.embeddings
    return DecodeSpec(n_layers=len(model.layers), h=int(model.h),
                      d_model=int(emb.d_model),
                      d_ff=int(model.layers[0].ffn.d_ff),
                      vocab=int(emb.vocab),
                      maxlen=int(emb.pos_embedding.shape[0]),
                      tied=bool(model.tie_lm_head), dtype=model.dtype)


def causal_mask(L: int, device=None) -> torch.Tensor:
    """The [1, 1, L, L] lower-triangular mask decode serving imposes
    (int32, 0 = masked); the same tensor drives prefill and the
    cacheless reference the tests hold decode against."""
    return torch.tril(torch.ones((L, L), dtype=torch.int32,
                                 device=device))[None, None]


def _embed(model, tokens: torch.Tensor, positions: torch.Tensor,
           spec: DecodeSpec) -> torch.Tensor:
    """The encoder input at eval, with the reference's encoding quirk:
    the model adds dropout(emb + pe) back onto emb, so at eval h0 =
    2·emb + pe (written so, as the JAX mirror writes it).  Token types
    are all zero on the serving path: the segment term is row 0."""
    e = model.embeddings
    tok = e.token_embedding[tokens].float()
    pos = e.pos_embedding[positions].float()
    seg = e.segment_embedding[0].float()
    emb = (tok + pos + seg) * math.sqrt(spec.d_model)
    return (2.0 * emb + model.pe[positions]).to(spec.dtype)


def gumbel_noise(seed: int, req_ids: torch.Tensor, positions: torch.Tensor,
                 k: int) -> torch.Tensor:
    """fp32 Gumbel noise [B, k] for the top-k draw of each row: element
    (b, r) hashes (seed, req_ids[b], positions[b], r) through murmur3's
    finalizer, takes 24 bits as a uniform u in (0, 1) and returns
    -log(-log(u))."""
    salted = _fmix32(torch.tensor((int(seed) ^ _GUMBEL_SALT) & _M32,
                                  dtype=torch.int64))
    h = _fmix32(int(salted) ^ (req_ids.to(torch.int64) & _M32))
    h = _fmix32(h ^ (positions.to(torch.int64) & _M32))
    rank = torch.arange(k, dtype=torch.int64, device=req_ids.device)
    h = _fmix32(h[:, None] ^ rank[None, :])
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def select_topk(vals: torch.Tensor, idx: torch.Tensor, gumbel: torch.Tensor,
                temperature: float) -> torch.Tensor:
    """The top-k draw given its noise: ``idx[argmax(vals / T + g)]`` a
    row (``jax.random.categorical`` over the scaled logits)."""
    choice = torch.argmax(vals.float() / float(temperature) + gumbel,
                          dim=-1)
    return idx.gather(-1, choice[:, None])[:, 0]


def sample_tokens(logits: torch.Tensor, sampling: SamplingCfg,
                  req_ids: torch.Tensor, positions: torch.Tensor
                  ) -> torch.Tensor:
    """[B, V] fp32 logits -> [B] int64 token ids.  ``positions``: the
    absolute position of the token being generated (prefill: the prompt
    length; a decode step: pos + 1), which keeps a request's stream
    independent of when it was admitted."""
    if sampling.method == "greedy":
        return torch.argmax(logits, dim=-1)
    if sampling.method != "topk":
        raise ValueError(f"unknown sampling method {sampling.method!r} "
                         f"(greedy | topk)")
    V = logits.shape[-1]
    k = V if sampling.top_k <= 0 else min(int(sampling.top_k), V)
    vals, idx = torch.topk(logits, k, dim=-1)
    return select_topk(vals, idx, gumbel_noise(sampling.seed, req_ids,
                                               positions, k),
                       sampling.temperature)


def _attn_in(layer, h: torch.Tensor, spec: DecodeSpec) -> torch.Tensor:
    """The pre-LN fused qkv projection: [B, L, 3, h, d_k]."""
    B, L, _ = h.shape
    qkv = _linear(layer.ln_attn(h), layer.attn.qkv, spec.dtype)
    return qkv.view(B, L, 3, spec.h, spec.d_k)


def _attn_out_ffn(layer, h: torch.Tensor, ctx: torch.Tensor,
                  spec: DecodeSpec) -> torch.Tensor:
    """The rest of a layer: the out projection's residual, then the
    pre-LN plain FFN's."""
    B, L = h.shape[:2]
    ctx = ctx.transpose(1, 2).reshape(B, L, spec.d_model)
    h = h + _linear(ctx, layer.attn.out, spec.dtype)
    return h + layer.ffn(layer.ln_ffn(h))


def prefill(model, spec: DecodeSpec, sampling: SamplingCfg,
            tokens: torch.Tensor, length: torch.Tensor,
            req_ids: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    """The causal forward over a [B, L] prompt bucket (int64 ids).

    Returns (k, v, logits, first): every layer's keys and values stacked
    [n_layers, B, h, L, d_k] (columns >= length[b] come from pad tokens;
    the cache's length mask never shows them and causality keeps the real
    positions independent of them), the fp32 logits at the last real
    position [B, V] and the token sampled from them (the first generated
    one, at absolute position ``length``)."""
    B, L = tokens.shape
    dev = tokens.device
    positions = torch.arange(L, device=dev)[None, :].expand(B, L)
    h = _embed(model, tokens, positions, spec)
    mask = causal_mask(L, dev)
    ks, vs = [], []
    for layer in model.layers:
        qkv = _attn_in(layer, h, spec)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        ks.append(k)
        vs.append(v)
        h = _attn_out_ffn(layer, h, dense_attention(q, k, v, mask), spec)
    h = model.ln_final(h)
    h_last = h[torch.arange(B, device=dev), length - 1]
    logits = model._lm_logits(h_last)
    first = sample_tokens(logits, sampling, req_ids, length)
    return torch.stack(ks), torch.stack(vs), logits, first


def decode_step(model, spec: DecodeSpec, sampling: SamplingCfg, window: int,
                kcache: torch.Tensor, vcache: torch.Tensor,
                token: torch.Tensor, pos: torch.Tensor, active: torch.Tensor,
                req_ids: torch.Tensor) -> torch.Tensor:
    """One decode step over the whole slot batch; returns the next token
    of every slot [B] (int64), sampled at absolute position pos + 1, 0
    where the slot is not active.

    kcache / vcache: [n_layers, B, h, C, d_k], written in place (column
    ``pos[b]`` of slot b, every layer); only the first ``window`` columns
    (static: pages · page) enter the attention, so a step costs what the
    longest live slot needs, not the allocation.  token [B]: the token at
    ``pos``; pos [B]: its absolute position; active [B] bool: a free slot
    runs the same math on dummy operands and its token is dropped;
    req_ids [B]: the sampling stream of each slot's request."""
    B = token.shape[0]
    h = _embed(model, token, pos, spec)[:, None, :]
    rows = torch.arange(B, device=token.device)
    lengths = pos + 1
    for i, layer in enumerate(model.layers):
        qkv = _attn_in(layer, h, spec)
        q = qkv[:, :, 0].transpose(1, 2)               # [B, h, 1, d_k]
        kc, vc = kcache[i], vcache[i]
        kc[rows, :, pos] = qkv[:, 0, 1]
        vc[rows, :, pos] = qkv[:, 0, 2]
        ctx = cached_attention(q, kc[:, :, :window], vc[:, :, :window],
                               lengths)
        h = _attn_out_ffn(layer, h, ctx, spec)
    logits = model._lm_logits(model.ln_final(h[:, 0]))
    nxt = sample_tokens(logits, sampling, req_ids, pos + 1)
    return torch.where(active, nxt, torch.zeros_like(nxt))
