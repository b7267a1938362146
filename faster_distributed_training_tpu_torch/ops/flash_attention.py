"""Flash-attention forward: the Hopper kernel and its plain version.

Counterpart of ``faster_distributed_training_tpu/ops/flash_attention.py``
(the monolithic forward ``_flash_fwd_pallas``).  ``flash_attention``
takes [B, H, L, D] tensors and a key-padding mask, and computes

    s   = q.k^T / sqrt(D) + bias      (fp32; bias is NEG_INF at masked keys)
    p   = exp(s - max_row s)           (fp32)
    l   = max(sum_row p, 1e-30)        (undropped p)
    out = ((p * keep) cast to v's dtype . v) / l
    lse = max_row s + log(l)           (with emit_lse)

with ``keep`` the stateless hash dropout of ``ops.attention.dropout_keep``
over (seed, b*H + h, q row, k column).  For CUDA tensors it launches
``csrc/flash_fwd.cu``; for CPU tensors it runs
``flash_attention_reference``, the same math over whole rows.  There is
no fallback: any other device, or a CUDA input the kernel does not take,
raises.  The backward arrives with the training slice.
"""

from __future__ import annotations

import ctypes
import math
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


def flash_attention_reference(q, k, v, mask=None, dropout_rate: float = 0.0,
                              dropout_seed=None, emit_lse: bool = False):
    """Plain PyTorch version of the kernel: whole-row softmax, the same
    rounding points (fp32 scores and statistics, p cast to v's dtype
    before the value product, division by l last)."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
        1.0 / math.sqrt(D))
    bias = key_bias_from_mask(mask, B, Lk)
    if bias is not None:
        s = s + bias[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    if dropout_rate > 0.0:
        seed = 0 if dropout_seed is None else dropout_seed
        p = p * dropout_keep(
            seed, bh_index(B, H, q.device),
            torch.arange(Lq, device=q.device)[None, None, :, None],
            torch.arange(Lk, device=q.device)[None, None, None, :],
            dropout_rate)
    out = (torch.matmul(p.to(v.dtype).float(), v.float()) / l).to(q.dtype)
    if emit_lse:
        return out, (m + torch.log(l))[..., 0]
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_fwd")
    if lib.fdt_flash_fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        u, f = ctypes.c_uint, ctypes.c_float
        lib.fdt_flash_fwd.argtypes = (
            [p] * 6 + [i] * 6 + [ll] * 12 + [f, i, u, u, u, i, u, f, p])
        lib.fdt_flash_fwd.restype = ctypes.c_int
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    dropout_rate: float = 0.0, dropout_seed=None,
                    emit_lse: bool = False):
    """q/k/v [B, H, L, D] (any strides over B, H and L; D contiguous);
    mask: None or a key-padding mask (mask == 0 masked); dropout_seed: a
    uint32 (python int or integer tensor).  Returns out [B, H, Lq, D]
    (a view of a [B, Lq, H, D] buffer on CUDA) and, with emit_lse, the
    fp32 row lse [B, H, Lq]."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, mask, dropout_rate,
                                         dropout_seed, emit_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda (kernel) or cpu "
                         f"(plain version), not {q.device}")
    _check_inputs(q, k, v)
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    bias = key_bias_from_mask(mask, B, Lk)
    if bias is not None:
        bias = bias.to(q.device)
    out = torch.empty((B, Lq, H, D), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    lse = (torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
           if emit_lse else None)
    rate = float(dropout_rate)
    seed = 0 if dropout_seed is None else int(dropout_seed) & 0xFFFFFFFF
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fdt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            _DTYPES[q.dtype], B, H, Lq, Lk, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            1.0 / math.sqrt(D), int(rate > 0.0), seed, 0, 0, H,
            keep_threshold(rate), keep_scale(rate) if rate > 0.0 else 1.0,
            stream)
    _build.check(lib, err, "flash_fwd launch")
    flash_attention.launches += 1
    return (out, lse) if emit_lse else out


flash_attention.launches = 0
