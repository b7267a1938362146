"""Fused 2-layer classifier MLP forward: the Hopper kernel and its plain
version.

Counterpart of ``faster_distributed_training_tpu/ops/fused_mlp.py``
(``_mlp_fwd_pallas``): linear -> ReLU -> linear with weights in (out, in)
layout like ``torch.nn.Linear``,

    h   = x.w1^T + b1        (fp32 accumulation)
    a   = relu(h) cast to x's dtype
    out = a.w2^T + b2        (fp32 accumulation, cast once)

For CUDA tensors the forward launches ``csrc/fused_mlp.cu``; for CPU
tensors it runs ``mlp_reference``, the same math with the same rounding
points.  There is no fallback: any other device, or a CUDA input the
kernel does not take, raises.  Under autograd ``fused_mlp`` is a
``torch.autograd.Function`` whose backward is the JAX package's recompute
VJP ``_mlp_bwd``: the hidden pre-activation is recomputed (residuals are
the inputs only) and the four gradient products are plain GEMMs, as the
JAX package left them to XLA outside any Pallas kernel.  Bias gradients
are sums over rows, or means with ``mean_bias_grad`` (the reference's
reduction).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from faster_distributed_training_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def mlp_reference(x, w1, b1, w2, b2):
    """Plain PyTorch version of the kernel (x [..., d_in])."""
    h = torch.matmul(x.float(), w1.float().T) + b1.float()
    a = torch.relu(h).to(x.dtype)
    return (torch.matmul(a.float(), w2.float().T) + b2.float()).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_mlp")
    if lib.fdt_fused_mlp_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fdt_fused_mlp_fwd.argtypes = [p] * 8 + [i] * 5 + [p]
        lib.fdt_fused_mlp_fwd.restype = ctypes.c_int
        lib.fdt_mlp_partial_floats.argtypes = [i] * 4
        lib.fdt_mlp_partial_floats.restype = ctypes.c_longlong
        lib.fdt_mlp_counters.argtypes = [i, i]
        lib.fdt_mlp_counters.restype = ctypes.c_int
        lib.fdt_launch_floor.argtypes = [p]
        lib.fdt_launch_floor.restype = ctypes.c_int
    return lib


# {(device index, CUDA stream): int32 tickets}, zeroed once and grown when a call needs
# more, so a call launches no memset.  Reuse is safe: calls on one stream
# run one after another, and the kernel's last block of each row block
# resets its ticket to 0 before the kernel ends.
_counters = {}


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)   # each device's default stream is 0
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def launch_floor(device) -> None:
    """One empty kernel on ``device``'s current stream: the device time of
    a launch that does nothing, the floor beside the MLP kernel's time."""
    lib = _lib()
    with torch.cuda.device(device):
        err = lib.fdt_launch_floor(
            torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, err, "launch floor")


def _check_inputs(x2, w1, b1, w2, b2):
    dt = x2.dtype
    if dt not in _DTYPES:
        raise TypeError(f"fused_mlp kernel takes float32 or bfloat16, got "
                        f"{dt}")
    d_in = x2.shape[1]
    d_h, d_out = w1.shape[0], w2.shape[0]
    want = {"w1": (w1, (d_h, d_in)), "b1": (b1, (d_h,)),
            "w2": (w2, (d_out, d_h)), "b2": (b2, (d_out,))}
    for name, (t, shape) in want.items():
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"fused_mlp {name}: want {dt} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x2.device or not t.is_contiguous():
            raise ValueError(f"fused_mlp {name} must be contiguous on "
                             f"{x2.device}")
    vec = 16 // x2.element_size()
    if d_in % vec:
        raise ValueError(f"fused_mlp kernel needs d_in % {vec} == 0 "
                         f"(16-byte rows), got {d_in}")
    for name, t in (("x", x2), ("w1", w1)):
        if t.data_ptr() % 16:
            raise ValueError(f"fused_mlp {name} is not 16-byte aligned")


def mlp_bwd(x, w1, b1, w2, b2, g, mean_bias_grad: bool = False):
    """JAX's ``_mlp_bwd``: (dx, dw1, db1, dw2, db2) for the cotangent g,
    recomputing h = x.w1^T + b1 (GEMMs in x's dtype)."""
    h = torch.matmul(x, w1.T) + (0.0 if b1 is None else b1.reshape(-1))
    a = torch.relu(h)
    gf = g.reshape(-1, g.shape[-1])
    af = a.reshape(-1, a.shape[-1])
    xf = x.reshape(-1, x.shape[-1])
    d_w2 = torch.matmul(gf.T, af)
    # the zero on g's device: a CPU scalar here would be a host copy,
    # which a captured step graph cannot hold
    d_h = torch.where(h > 0, torch.matmul(g, w2),
                      torch.zeros((), dtype=g.dtype, device=g.device))
    d_hf = d_h.reshape(-1, d_h.shape[-1])
    d_w1 = torch.matmul(d_hf.T, xf)
    d_x = torch.matmul(d_h, w1)

    def red(t, like):
        if like is None:
            return None
        r = t.mean(dim=0) if mean_bias_grad else t.sum(dim=0)
        return r.reshape(like.shape)
    return d_x, d_w1, red(d_hf, b1), d_w2, red(gf, b2)


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, mean_bias_grad: bool):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.mean_bias_grad = mean_bias_grad
        return _mlp_fwd(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2 = ctx.saved_tensors
        return (*mlp_bwd(x, w1, b1, w2, b2, g, ctx.mean_bias_grad), None)


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: Optional[torch.Tensor],
              w2: torch.Tensor, b2: Optional[torch.Tensor],
              mean_bias_grad: bool = False) -> torch.Tensor:
    """x [..., d_in]; w1 (d_h, d_in); b1 (d_h,) or (1, d_h) or None;
    w2 (d_out, d_h); b2 (d_out,) or (1, d_out) or None.  Differentiable
    (the recompute backward) when autograd needs it."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w1, b1, w2, b2)):
        return _FusedMLP.apply(x, w1, b1, w2, b2, bool(mean_bias_grad))
    return _mlp_fwd(x, w1, b1, w2, b2)


def _mlp_fwd(x, w1, b1, w2, b2) -> torch.Tensor:
    """The forward: the kernel on CUDA, mlp_reference on the CPU."""
    d_h, d_out = w1.shape[0], w2.shape[0]
    b1 = (torch.zeros(d_h, dtype=x.dtype, device=x.device) if b1 is None
          else b1.reshape(d_h))
    b2 = (torch.zeros(d_out, dtype=x.dtype, device=x.device) if b2 is None
          else b2.reshape(d_out))
    if x.device.type == "cpu":
        return mlp_reference(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp runs on cuda (kernel) or cpu (plain "
                         f"version), not {x.device}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    _check_inputs(x2, w1, b1, w2, b2)
    rows, d_in = x2.shape
    lib = _lib()
    dt = _DTYPES[x.dtype]
    out = torch.empty((rows, d_out), dtype=x.dtype, device=x.device)
    partial = torch.empty(lib.fdt_mlp_partial_floats(dt, rows, d_h, d_out),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        counters = _tickets(x.device, stream, lib.fdt_mlp_counters(dt, rows))
        err = lib.fdt_fused_mlp_fwd(
            x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), partial.data_ptr(),
            counters.data_ptr(), dt, rows, d_in, d_h, d_out,
            stream)
    _build.check(lib, err, "fused_mlp launch")
    fused_mlp.launches += 1
    return out.reshape(*lead, d_out)


fused_mlp.launches = 0
