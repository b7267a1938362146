"""Flash attention: the Hopper kernels, their plain versions and autograd.

Counterpart of ``faster_distributed_training_tpu/ops/flash_attention.py``:
the monolithic forward ``_flash_fwd_pallas`` and the two backward kernels
``_flash_bwd_pallas_stats`` (saved stats) and ``_flash_bwd_pallas``
(recompute), and the long-context pair ``_flash_fwd_kblocked`` /
``_flash_bwd_kblocked`` that JAX takes once Lk*D outgrows the TPU's
VMEM envelopes.  The two pairs compute one function and differ only in
how they fit VMEM; the port's kernels stream K/V (forward) and loop over
q and k tiles (backward) with O(tile) shared memory at any length, so
the same two kernels serve both pairs and no routing switch is copied.
``flash_attention`` takes [B, H, L, D] tensors and a key-padding mask,
and computes

    s   = q.k^T / sqrt(D) + bias      (fp32; bias is NEG_INF at masked keys)
    p   = exp(s - max_row s)           (fp32)
    l   = max(sum_row p, 1e-30)        (undropped p)
    out = ((p * keep) cast to v's dtype . v) / l
    lse = max_row s + log(l)           (with emit_lse)

with ``keep`` the stateless hash dropout of ``ops.attention.dropout_keep``
over (seed, b*H + h, q row, k column).  The backward (``flash_attention_bwd``)
rebuilds p = exp((s - lse) - lse_lo) from the forward's lse and its
low-order tail lse_lo = (m - lse) + log l (``flash_attention_stats``), and
regenerates the keep mask from the seed:

    pt = p * keep,   dp = (dO.v^T) * keep,   delta = sum_d dO * out
    ds = p * (dp - delta) * scale
    dv = pt^T.dO,    dk = ds^T.q,    dq = ds.k

with pt cast to dO's dtype and ds to q/k's dtype as the operands of their
products (bf16 tensor-core operands on the card; no-ops in fp32).  The
tail matters at a fully masked row: there m is near -1e9, fp32 steps by 64,
and log l vanishes from the rounded lse, so p = exp(s - lse) alone (what
JAX's saved-stats kernel computes) comes out l times too large; with the
tail the row gets the dense VJP's mean-of-V gradient.  The
recompute route (``flash_attention_bwd_recompute``, what JAX's
``_flash_bwd_pallas`` computes with input-only residuals) re-runs the
forward kernel with ``emit_lse`` and then the same backward kernels.

For CUDA tensors the wrappers launch ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu``; for CPU tensors they run the plain versions beside
them (``flash_attention_reference``, ``flash_attention_stats_reference``,
``flash_attention_bwd_reference``,
``flash_attention_bwd_recompute_reference``), the same math over whole rows
with the same rounding points; their ``q_chunk`` walks the q rows a chunk
at a time so a long sequence's [B, H, Lq, Lk] temporaries fit.  There is
no fallback: any other device, or a CUDA input the kernels do not take,
raises.  ``flash_attention_qkv`` is
the ``torch.autograd.Function`` the model trains through: it takes the
fused [B, L, 3, H, D] projection and returns its gradient as one buffer of
that layout.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional

import torch

from faster_distributed_training_tpu_torch.ops import _build
from faster_distributed_training_tpu_torch.ops.attention import (
    bh_index, dropout_keep, keep_scale, keep_threshold, mask_to_bias)

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def key_bias_from_mask(mask, B: int, Lk: int) -> Optional[torch.Tensor]:
    """[B, Lk] fp32 additive key bias from a key-padding mask
    ([B, 1, 1, Lk], [B, Lk] or anything broadcastable to [B, Lk])."""
    if mask is None:
        return None
    kb = mask
    if kb.dim() == 4:
        kb = kb.reshape(kb.shape[0], kb.shape[-1])
    kb = torch.broadcast_to(kb, (B, Lk))
    return mask_to_bias(kb).contiguous()


def _seed_int(dropout_seed) -> int:
    return 0 if dropout_seed is None else int(dropout_seed) & 0xFFFFFFFF


def _keep(q, Lk, dropout_rate, dropout_seed, q0: int = 0) -> torch.Tensor:
    """The keep factors of q rows q0 .. q0 + Lq (q holds those rows)."""
    B, H, Lq, _ = q.shape
    return dropout_keep(
        _seed_int(dropout_seed), bh_index(B, H, q.device),
        torch.arange(q0, q0 + Lq, device=q.device)[None, None, :, None],
        torch.arange(Lk, device=q.device)[None, None, None, :], dropout_rate)


def _row_chunks(Lq: int, q_chunk: Optional[int]):
    """[(start, stop)] of the q-row chunks a plain version walks: one
    chunk of all rows unless ``q_chunk`` is given."""
    step = int(q_chunk) if q_chunk else Lq
    return [(a, min(a + step, Lq)) for a in range(0, Lq, step)]


def _scores(q, k, mask):
    """fp32 s = q.k^T / sqrt(D) + key bias."""
    B, _, _, D = q.shape
    Lk = k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
        1.0 / math.sqrt(D))
    bias = key_bias_from_mask(mask, B, Lk)
    if bias is not None:
        s = s + bias[:, None, None, :]
    return s


def _stats_rows(q, k, v, mask, dropout_rate, dropout_seed, q0):
    """(out, lse, lse_lo) of the q rows q0 .. q0 + Lq that ``q`` holds."""
    s = _scores(q, k, mask)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    if dropout_rate > 0.0:
        p = p * _keep(q, k.shape[2], dropout_rate, dropout_seed, q0)
    out = (torch.matmul(p.to(v.dtype).float(), v.float()) / l).to(q.dtype)
    log_l = torch.log(l)
    lse = m + log_l
    return out, lse[..., 0], ((m - lse) + log_l)[..., 0]


def flash_attention_stats_reference(q, k, v, mask=None,
                                    dropout_rate: float = 0.0,
                                    dropout_seed=None,
                                    q_chunk: Optional[int] = None):
    """Plain version of :func:`flash_attention_stats`: (out, lse, lse_lo),
    lse = m + log l rounded to fp32 and lse_lo = (m - lse) + log l, its
    low-order tail.  Rows are independent, so ``q_chunk`` rows at a time
    give the same values."""
    parts = [_stats_rows(q[:, :, a:b], k, v, mask, dropout_rate,
                         dropout_seed, a)
             for a, b in _row_chunks(q.shape[2], q_chunk)]
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(t, dim=2) for t in zip(*parts))


def flash_attention_reference(q, k, v, mask=None, dropout_rate: float = 0.0,
                              dropout_seed=None, emit_lse: bool = False,
                              q_chunk: Optional[int] = None):
    """Plain PyTorch version of the forward kernel: whole-row softmax, the
    same rounding points (fp32 scores and statistics, p cast to v's dtype
    before the value product, division by l last).  ``q_chunk`` walks the
    q rows that many at a time, so the [B, H, Lq, Lk] temporaries of a
    long sequence fit in memory; the values do not change."""
    out, lse, _ = flash_attention_stats_reference(
        q, k, v, mask, dropout_rate, dropout_seed, q_chunk)
    return (out, lse) if emit_lse else out


def _bwd_rows(q, k, v, out, lse, dout, mask, dropout_rate, dropout_seed,
              lse_lo, q0):
    """fp32 (dq, dk, dv) of the q rows q0 .. q0 + Lq that ``q`` holds: dq
    of those rows, dk and dv summed over them only."""
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    s = _scores(q, k, mask) - lse.float()[..., None]
    if lse_lo is not None:
        s = s - lse_lo.float()[..., None]
    p = torch.exp(s)
    g = dout.float()
    dp = torch.matmul(g, v.float().transpose(-1, -2))
    pt = p
    if dropout_rate > 0.0:
        keep = _keep(q, k.shape[2], dropout_rate, dropout_seed, q0)
        pt = p * keep
        dp = dp * keep
    delta = (g * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dv = torch.matmul(pt.to(dout.dtype).float().transpose(-1, -2), g)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    dq = torch.matmul(ds.to(k.dtype).float(), k.float())
    return dq, dk, dv


def flash_attention_bwd_reference(q, k, v, out, lse, dout, mask=None,
                                  dropout_rate: float = 0.0,
                                  dropout_seed=None, lse_lo=None,
                                  q_chunk: Optional[int] = None):
    """Plain PyTorch version of the saved-stats backward kernels (JAX's
    ``_flash_bwd_pallas_stats``): (dq, dk, dv) in q/k/v's dtypes from the
    forward's out [B, H, Lq, D], fp32 lse [B, H, Lq] and, optionally, the
    lse's low-order tail (without it a fully masked row, whose lse rounds
    at -1e9, comes out unnormalized, as in the TPU kernel).  ``q_chunk``
    walks the q rows that many at a time: dq is the same, dk and dv are
    fp32 sums over the chunks (another order of the same sum)."""
    dq_parts, dk, dv = [], None, None
    for a, b in _row_chunks(q.shape[2], q_chunk):
        dq_c, dk_c, dv_c = _bwd_rows(
            q[:, :, a:b], k, v, out[:, :, a:b], lse[:, :, a:b],
            dout[:, :, a:b], mask, dropout_rate, dropout_seed,
            None if lse_lo is None else lse_lo[:, :, a:b], a)
        dq_parts.append(dq_c)
        dk = dk_c if dk is None else dk + dk_c
        dv = dv_c if dv is None else dv + dv_c
    dq = dq_parts[0] if len(dq_parts) == 1 else torch.cat(dq_parts, dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_recompute_reference(q, k, v, dout, mask=None,
                                            dropout_rate: float = 0.0,
                                            dropout_seed=None,
                                            q_chunk: Optional[int] = None):
    """Plain PyTorch version of the recompute route (JAX's
    ``_flash_bwd_pallas``, residuals = inputs only): the forward's out and
    lse rebuilt, then the saved-stats backward."""
    out, lse, lse_lo = flash_attention_stats_reference(
        q, k, v, mask, dropout_rate, dropout_seed, q_chunk)
    return flash_attention_bwd_reference(q, k, v, out, lse, dout, mask,
                                         dropout_rate, dropout_seed, lse_lo,
                                         q_chunk)


def save_stats_enabled(save_stats: Optional[bool] = None) -> bool:
    """Saved-(out, lse) backward, default on; ``FDT_FLASH_SAVE_STATS=0``
    selects the recompute route (JAX's ``_save_stats_enabled``).  An
    explicit ``save_stats`` overrides the environment."""
    if save_stats is not None:
        return bool(save_stats)
    return os.environ.get("FDT_FLASH_SAVE_STATS", "1") != "0"


def _fwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_fwd")
    if lib.fdt_flash_fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        u, f = ctypes.c_uint, ctypes.c_float
        lib.fdt_flash_fwd.argtypes = (
            [p] * 7 + [i] * 6 + [ll] * 12 + [f, i, u, u, u, i, u, f, p])
        lib.fdt_flash_fwd.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_bwd")
    if lib.fdt_flash_bwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        u, f = ctypes.c_uint, ctypes.c_float
        lib.fdt_flash_bwd.argtypes = (
            [p] * 11 + [i] * 6 + [ll] * 21 + [f, i, u, u, u, i, u, f, p])
        lib.fdt_flash_bwd.restype = ctypes.c_int
        lib.fdt_flash_bwd_max_head_dim.argtypes = [i]
        lib.fdt_flash_bwd_max_head_dim.restype = ctypes.c_int
    return lib


def _check_inputs(q, k, v):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes [B, H, L, D] tensors")
    B, H, _, D = q.shape
    if k.shape[:2] != (B, H) or v.shape != k.shape or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / "
                         f"v {tuple(v.shape)} do not line up")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel head dim {D} not in "
                         f"{HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous "
                             f"(stride {t.stride(3)})")


def _on_card(q, what: str) -> bool:
    """True for CUDA tensors, False for CPU ones (the plain version);
    any other device raises."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda (kernel) or cpu (plain "
                         f"version), not {q.device}")
    return True


def _strides(t):
    return t.stride(0), t.stride(1), t.stride(2)


def _dropout_args(dropout_rate, dropout_seed, H):
    rate = float(dropout_rate)
    return (int(rate > 0.0), _seed_int(dropout_seed), 0, 0, H,
            keep_threshold(rate), keep_scale(rate) if rate > 0.0 else 1.0)


def _launch_fwd(q, k, v, mask, dropout_rate, dropout_seed, emit_lse: int):
    """The forward kernel; emit_lse 0: out, 1: (out, lse), 2: (out, lse,
    lse_lo).  Counts one forward launch."""
    _check_inputs(q, k, v)
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    bias = key_bias_from_mask(mask, B, Lk)
    if bias is not None:
        bias = bias.to(q.device)
    out = torch.empty((B, Lq, H, D), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    stats = (torch.empty((emit_lse, B, H, Lq), dtype=torch.float32,
                         device=q.device) if emit_lse else None)
    lib = _fwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fdt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if stats is None else stats[0].data_ptr(),
            stats[1].data_ptr() if emit_lse == 2 else None,
            _DTYPES[q.dtype], B, H, Lq, Lk, D,
            *_strides(q), *_strides(k), *_strides(v), *_strides(out),
            1.0 / math.sqrt(D), *_dropout_args(dropout_rate, dropout_seed, H),
            stream)
    _build.check(lib, err, "flash_fwd launch")
    flash_attention.launches += 1
    return (out,) + (tuple(stats) if emit_lse else ())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    dropout_rate: float = 0.0, dropout_seed=None,
                    emit_lse: bool = False):
    """The forward kernel.  q/k/v [B, H, L, D] (any strides over B, H and
    L; D contiguous); mask: None or a key-padding mask (mask == 0 masked);
    dropout_seed: a uint32 (python int or integer tensor).  Returns out
    [B, H, Lq, D] (a view of a [B, Lq, H, D] buffer on CUDA) and, with
    emit_lse, the fp32 row lse [B, H, Lq].  No autograd: training goes
    through :func:`flash_attention_qkv`."""
    if not _on_card(q, "flash_attention"):
        return flash_attention_reference(q, k, v, mask, dropout_rate,
                                         dropout_seed, emit_lse)
    got = _launch_fwd(q, k, v, mask, dropout_rate, dropout_seed,
                      int(bool(emit_lse)))
    return got if emit_lse else got[0]


def flash_attention_stats(q, k, v, mask=None, dropout_rate: float = 0.0,
                          dropout_seed=None):
    """The forward with everything the saved-stats backward takes:
    (out, lse, lse_lo), lse_lo being the low-order tail of the lse.  Its
    launches count here (the forwards a backward will use: training's and
    the recompute route's) and in ``flash_attention.launches`` (every
    forward kernel launch)."""
    if not _on_card(q, "flash_attention"):
        return flash_attention_stats_reference(q, k, v, mask, dropout_rate,
                                               dropout_seed)
    got = _launch_fwd(q, k, v, mask, dropout_rate, dropout_seed, 2)
    flash_attention_stats.launches += 1
    return got


flash_attention.launches = 0
flash_attention_stats.launches = 0


def _launch_bwd(q, k, v, out, lse, dout, mask, dropout_rate, dropout_seed,
                lse_lo, grads):
    """The dkdv + dq kernel pair of csrc/flash_bwd.cu (no launch count)."""
    _check_inputs(q, k, v)
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    lib = _bwd_lib()
    max_d = lib.fdt_flash_bwd_max_head_dim(_DTYPES[q.dtype])
    if D > max_d:
        raise ValueError(f"flash_attention backward kernel takes head dim "
                         f"<= {max_d} for {q.dtype}, got {D}")
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not "
                         f"match q {tuple(q.shape)} {q.dtype}")
    if dout.stride(3) != 1:
        dout = dout.contiguous()
    delta = (dout.float() * out.float()).sum(dim=-1).contiguous()
    lse = lse.float().contiguous()
    if lse_lo is not None:
        lse_lo = lse_lo.float().contiguous()
    bias = key_bias_from_mask(mask, B, Lk)
    if bias is not None:
        bias = bias.to(q.device)
    dq, dk, dv = grads if grads is not None else (
        torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    for name, t, like in (("dq", dq, q), ("dk", dk, k), ("dv", dv, v)):
        if (t.shape != like.shape or t.dtype != like.dtype
                or t.device != q.device or t.stride(3) != 1):
            raise ValueError(f"{name} buffer must be {tuple(like.shape)} "
                             f"{like.dtype} on {q.device}, D contiguous")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fdt_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), None if lse_lo is None else lse_lo.data_ptr(),
            delta.data_ptr(),
            None if bias is None else bias.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPES[q.dtype], B, H, Lq, Lk, D,
            *_strides(q), *_strides(k), *_strides(v), *_strides(dout),
            *_strides(dq), *_strides(dk), *_strides(dv),
            1.0 / math.sqrt(D), *_dropout_args(dropout_rate, dropout_seed, H),
            stream)
    _build.check(lib, err, "flash_bwd launch")
    return dq, dk, dv


def _fill(grads, got):
    if grads is None:
        return got
    for dst, src in zip(grads, got):
        dst.copy_(src)
    return grads


def flash_attention_bwd(q, k, v, out, lse, dout, mask=None,
                        dropout_rate: float = 0.0, dropout_seed=None,
                        lse_lo=None, grads=None):
    """Saved-stats backward (JAX's ``_flash_bwd_pallas_stats``): (dq, dk,
    dv) from the forward's out, fp32 lse and (optionally) its low-order
    tail ``lse_lo`` (``flash_attention_stats``).  ``grads``: optional
    (dq, dk, dv) buffers of q/k/v's shapes and dtype (D contiguous, any
    other strides) to write into."""
    if not _on_card(q, "flash_attention_bwd"):
        return _fill(grads, flash_attention_bwd_reference(
            q, k, v, out, lse, dout, mask, dropout_rate, dropout_seed,
            lse_lo))
    got = _launch_bwd(q, k, v, out, lse, dout, mask, dropout_rate,
                      dropout_seed, lse_lo, grads)
    flash_attention_bwd.launches += 1
    return got


flash_attention_bwd.launches = 0


def flash_attention_bwd_recompute(q, k, v, dout, mask=None,
                                  dropout_rate: float = 0.0,
                                  dropout_seed=None, grads=None):
    """Recompute backward (JAX's ``_flash_bwd_pallas``, residuals = the
    inputs only): the forward kernel re-run with ``emit_lse`` (counted as
    a forward launch), then the saved-stats backward kernels."""
    if not _on_card(q, "flash_attention_bwd_recompute"):
        return _fill(grads, flash_attention_bwd_recompute_reference(
            q, k, v, dout, mask, dropout_rate, dropout_seed))
    out, lse, lse_lo = flash_attention_stats(q, k, v, mask, dropout_rate,
                                             dropout_seed)
    got = _launch_bwd(q, k, v, out, lse, dout, mask, dropout_rate,
                      dropout_seed, lse_lo, grads)
    flash_attention_bwd_recompute.launches += 1
    return got


flash_attention_bwd_recompute.launches = 0


def _split_qkv(qkv):
    """[B, L, 3, H, D] -> three strided [B, H, L, D] views."""
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


class _FlashQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, mask, dropout_rate, dropout_seed, save_stats):
        q, k, v = _split_qkv(qkv)
        ctx.args = (mask, dropout_rate, dropout_seed)
        if save_stats:
            out, lse, lse_lo = flash_attention_stats(
                q, k, v, mask, dropout_rate, dropout_seed)
            ctx.save_for_backward(qkv, out, lse, lse_lo)
        else:
            out = flash_attention(q, k, v, mask, dropout_rate, dropout_seed)
            ctx.save_for_backward(qkv)
        ctx.save_stats = save_stats
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv = ctx.saved_tensors[0]
        q, k, v = _split_qkv(qkv)
        dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
        grads = _split_qkv(dqkv)
        mask, rate, seed = ctx.args
        if ctx.save_stats:
            _, out, lse, lse_lo = ctx.saved_tensors
            flash_attention_bwd(q, k, v, out, lse, dout, mask, rate, seed,
                                lse_lo, grads=grads)
        else:
            flash_attention_bwd_recompute(q, k, v, dout, mask, rate, seed,
                                          grads=grads)
        return dqkv, None, None, None, None


def flash_attention_qkv(qkv: torch.Tensor, mask: Optional[torch.Tensor] = None,
                        dropout_rate: float = 0.0, dropout_seed=None,
                        save_stats: Optional[bool] = None) -> torch.Tensor:
    """Flash attention over a fused projection qkv [B, L, 3, H, D] with
    autograd: the forward kernel, and on backward the saved-stats kernels
    (default) or the recompute route (``save_stats=False`` or
    ``FDT_FLASH_SAVE_STATS=0``).  Returns the context [B, H, L, D]; the
    gradient comes back as one [B, L, 3, H, D] buffer."""
    seed = _seed_int(dropout_seed)
    return _FlashQKV.apply(qkv, mask, float(dropout_rate), seed,
                           save_stats_enabled(save_stats))
