"""Attention numerics shared by every attention path of the port.

PyTorch counterpart of ``faster_distributed_training_tpu/ops/attention.py``:
the additive mask convention, the stateless hash dropout, the dense
O(L²) reference and the blockwise (online-softmax) formulation.

Mask convention: mask == 0 is masked out, broadcastable to
[B, H, Lq, Lk] (typically a [B, 1, 1, Lk] padding mask).  Masked scores
get an additive NEG_INF (-1e9) in fp32, never -inf, so a fully masked
row comes out as the mean of V rather than NaN.  Softmax statistics are
fp32 whatever the input dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e9

_M32 = 0xFFFFFFFF


def mask_to_bias(mask: Optional[torch.Tensor],
                 dtype=torch.float32) -> Optional[torch.Tensor]:
    """mask (...==0 masked) -> additive bias (0 keep, NEG_INF drop)."""
    if mask is None:
        return None
    zero = torch.zeros((), dtype=dtype, device=mask.device)
    return torch.where(mask == 0, torch.full_like(zero, NEG_INF), zero)


# ------------------------------------------------- stateless hash dropout
# The keep decision for score element (bh, q, k) is murmur3's 32-bit
# finalizer chained over (seed ^ bh, q, k): a pure function of indices,
# so a kernel and its plain version regenerate the identical mask with
# no mask tensor.  CPU torch has no uint32 shift, so the hash runs in
# int64 masked to 32 bits; the CUDA kernels use uint32_t.  Both give
# the JAX package's bits exactly.

def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    x = x ^ (x >> 16)
    return x


def keep_threshold(rate: float) -> int:
    """uint32 keep threshold: a hash below it keeps the element."""
    return min(int((1.0 - rate) * 4294967296.0), 4294967295)


def keep_scale(rate: float) -> float:
    """The fp32 survivor scale 1/(1-rate), rounded as JAX rounds it."""
    return float(torch.tensor(1.0, dtype=torch.float32)
                 / torch.tensor(1.0 - rate, dtype=torch.float32))


def seed_u32(seed):
    """A dropout seed as a uint32 value: a Python int masked to 32 bits,
    or an integer tensor (any device) masked in int64, never read back
    to the host (``int()`` on a card's tensor would wait for the card)."""
    if torch.is_tensor(seed):
        if seed.dtype not in (torch.int32, torch.int64) or seed.numel() != 1:
            raise TypeError(f"a dropout seed tensor holds one int32 or int64, "
                            f"got {seed.dtype} {tuple(seed.shape)}")
        return seed.reshape(()).to(torch.int64) & _M32
    return int(seed) & _M32


def seed_operand(seed, device) -> torch.Tensor:
    """The seed as the CUDA kernels read it: a u32 at the address of an
    integer tensor on ``device`` (an int64's low word).  A tensor there
    passes through, so the kernel reads whatever it holds when it runs (a
    replayed graph sees the slot of that step); a Python int is uploaded
    as an int64."""
    if torch.is_tensor(seed):
        seed_u32(seed)
        if seed.device != torch.device(device):
            raise ValueError(f"dropout seed on {seed.device}, kernel on "
                             f"{device}")
        return seed
    return torch.tensor(int(seed) & _M32, dtype=torch.int64, device=device)


def dropout_keep(seed, bh, q_idx, k_idx, rate: float) -> torch.Tensor:
    """fp32 keep/(1-rate) factor, broadcast over bh/q_idx/k_idx.

    seed: a uint32 value (python int or one-element integer tensor); bh / q_idx /
    k_idx: integer index tensors broadcastable to the score block's
    shape (GLOBAL indices); rate: python float in [0, 1)."""
    def u32(v):
        v = torch.as_tensor(v)
        return v.to(torch.int64) & _M32

    h = _fmix32(u32(seed) ^ u32(bh))
    h = _fmix32(h ^ u32(q_idx))
    h = _fmix32(h ^ u32(k_idx))
    keep = (h < keep_threshold(rate)).to(torch.float32)
    return keep * keep_scale(rate)


def bh_index(B: int, H: int, device=None, b0: int = 0, h0: int = 0,
             h_glob: Optional[int] = None) -> torch.Tensor:
    """[B,H,1,1] flattened batch*head index — the dropout stream id every
    attention path agrees on: ``(b0 + b) * h_glob + h0 + h``.  ``b0`` is
    the global index of batch row 0 (a data-parallel rank's first row),
    ``h0`` of head 0 and ``h_glob`` the global head count (a tp rank's
    head shard; default H)."""
    hg = H if h_glob is None else int(h_glob)
    return ((torch.arange(B, dtype=torch.int64, device=device) + int(b0))
            [:, None] * hg + int(h0)
            + torch.arange(H, dtype=torch.int64, device=device)[None, :]
            )[:, :, None, None]


def _scores(q, k, mask):
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    bias = mask_to_bias(mask)
    return s if bias is None else s + bias


def dense_attention_reference(q, k, v, mask=None, dropout_rate: float = 0.0,
                              dropout_seed=None, dropout_bh=None, b0: int = 0,
                              h0: int = 0, h_glob: Optional[int] = None):
    """O(L²) reference: fp32 scores, fp32 softmax, then hash dropout
    (softmax first, then drop and rescale), probabilities cast to v's
    dtype for the value product.  q/k/v [B, H, L, D]; ``b0`` the global
    index of batch row 0, ``h0`` of head 0 and ``h_glob`` the global head
    count (``bh_index``)."""
    B, H, Lq, _ = q.shape
    Lk = k.shape[2]
    p = torch.softmax(_scores(q, k, mask), dim=-1)
    if dropout_rate > 0.0:
        seed = 0 if dropout_seed is None else dropout_seed
        bh = (bh_index(B, H, q.device, b0, h0, h_glob) if dropout_bh is None
              else dropout_bh)
        p = p * dropout_keep(
            seed, bh,
            torch.arange(Lq, device=q.device)[None, None, :, None],
            torch.arange(Lk, device=q.device)[None, None, None, :],
            dropout_rate).to(p.device)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def online_block_update(q, k_blk, v_blk, bias_blk, m, l, acc,
                        scale: float, keep_blk=None):
    """One online-softmax accumulation step (JAX ``online_block_update``).

    q [..., Lq, D], k_blk / v_blk [..., Bk, D], bias_blk broadcastable to
    [..., Lq, Bk] (or None); m / l [..., Lq] the fp32 running max and
    normalizer, acc [..., Lq, D] the fp32 running numerator.  keep_blk:
    the pre-scaled dropout factor (``dropout_keep``), applied to the value
    product only, never to the normalizer (softmax, then dropout).
    Returns the updated (m, l, acc)."""
    s = torch.matmul(q.float(), k_blk.float().transpose(-1, -2)) * scale
    if bias_blk is not None:
        s = s + bias_blk.float()
    m_new = torch.maximum(m, s.amax(dim=-1))
    # exp(NEG_INF - m_new) underflows to 0: fully masked columns drop out
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = p if keep_blk is None else p * keep_blk
    acc_new = acc * corr[..., None] + torch.matmul(
        pv.to(v_blk.dtype).float(), v_blk.float())
    return m_new, l_new, acc_new


def finalize(m, l, acc, dtype) -> torch.Tensor:
    """acc / l, a fully masked row (l 0) protected, in ``dtype``."""
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(dtype)


def init_carry(q):
    """The fp32 (m, l, acc) an online softmax over q's rows starts from:
    -inf, 0 and 0."""
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    return (torch.full(q.shape[:-1], -math.inf, device=q.device),
            torch.zeros(q.shape[:-1], device=q.device), acc)


def blockwise_attention(q, k, v, mask=None, block_k: int = 128,
                        causal: bool = False, dropout_rate: float = 0.0,
                        dropout_seed=None, dropout_bh=None):
    """Streaming attention over key blocks with running (max, sum,
    accumulator) statistics (``online_block_update``); numerically equal
    to the dense softmax.

    q [B,H,Lq,D], k/v [B,H,Lk,D], mask broadcastable to [B,H,Lq,Lk].
    causal=True applies the lower-triangular constraint per key block
    (query i sees keys <= i; Lq == Lk self-attention).  Dropout applies
    to the value product only; the normalizer sums every probability.
    ``dropout_bh``: the [B, H, 1, 1] global (b, h) stream index (default
    the local ``bh_index``)."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    bias = mask_to_bias(mask)
    if bias is not None:
        bias = torch.broadcast_to(bias, (B,) + bias.shape[1:3] + (Lk,))
    bh = bh_index(B, H, q.device) if dropout_bh is None else dropout_bh
    seed = 0 if dropout_seed is None else dropout_seed
    q_pos = torch.arange(Lq, device=q.device)
    m, l, acc = init_carry(q)
    for k0 in range(0, Lk, block_k):
        k1 = min(k0 + block_k, Lk)
        k_pos = torch.arange(k0, k1, device=q.device)
        blk = None if bias is None else bias[..., k0:k1]
        if causal:
            cb = torch.where(k_pos[None, :] <= q_pos[:, None], 0.0, NEG_INF)
            blk = cb if blk is None else blk + cb
        keep = None
        if dropout_rate > 0.0:
            keep = dropout_keep(seed, bh, q_pos[None, None, :, None],
                                k_pos[None, None, None, :],
                                dropout_rate).to(q.device)
        m, l, acc = online_block_update(q, k[:, :, k0:k1], v[:, :, k0:k1],
                                        blk, m, l, acc, scale, keep)
    return finalize(m, l, acc, q.dtype)
