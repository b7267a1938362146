"""Quantized GEMMs with per-tensor delayed scaling: the Hopper kernel,
its plain version, the differentiable site op and ``QuantDense``.

Counterpart of ``faster_distributed_training_tpu/ops/quant.py``:

  * the scale state: each quantized operand keeps an fp32 amax history;
    step t quantizes at ``qmax / (margin * max(history))`` (1.0 for an
    all-zero history) and pushes its own amax in at index 0 for step t+1;
  * ``quantize`` (int8: round half to even, clip to +-127; fp8: clip to
    the format's finite max, one round-to-nearest-even cast) and
    ``dequantize``;
  * ``quant_matmul``: out = cast((xq . wq^T) * 1/(sx*sw)) with int32
    accumulation for int8.  On CUDA tensors it launches
    ``csrc/quant_matmul.cu`` (replaces ``quant_dot_pallas``: one 8-bit
    ``wgmma`` GEMM, s8 or E4M3); on CPU tensors it runs
    ``quant_dot_reference``, which sums E4M3 in fp32.  On the card, E4M3
    with fp32 output sums in fp32 too (operands upcast exactly to bf16,
    bf16 ``wgmma``), but E4M3 with bf16 output, the training and serving
    route, accumulates in fp8 ``wgmma``, which keeps about 14 bits of the
    partial sums: 0.0038-0.0057 of max |plain| at the smoke's shapes
    (``PERF.md``), against the 2e-2 it is held to.  Any other device
    raises; there is no VMEM-style fallback;
  * ``quant_dot``: an autograd Function that quantizes both operands once,
    saves the QUANTIZED operands and the scales, and in its backward runs
    the straight-through estimator on the dequantized operands (or, with
    ``grad_fmt="fp8_e5m2"``, quantizes the cotangent to E5M2 at a
    just-in-time scale and runs both gradient GEMMs on quantized operands,
    in plain torch as the JAX package leaves them to XLA);
  * ``QuantDense``: ``nn.Linear``'s parameters (weight [out, in], bias
    [out]) plus two persistent fp32 buffers ``amax_history_x`` /
    ``amax_history_w``.  Under tensor parallelism a site holds its tp
    shard (JAX ``QuantDense(tp_dim=...)`` and ``parallel/kernel_shard.py::
    quant_dense_sharded``): column-parallel (``tp_dim`` > 0:
    qkv, ``Dense_0``) contracts locally into its output columns,
    row-parallel (``tp_dim`` 0: out, ``Dense_1``) contracts its input rows
    and SUMs the partial products over tp before the (whole) bias; the
    scales stay global per-tensor scalars, so the amax of each sharded
    operand is MAX-reduced over tp, and the E5M2 gradient amax of a
    column site too.

Weights are in ``nn.Linear``'s (out, in) layout throughout: the JAX
package's (in, out) kernel transposed, so no transpose runs per call.
Scales stay on the device: the kernel reads them through pointers and
nothing here waits on the card.  Under a data mesh the activation and
gradient amaxes are MAX all-reduced over the ranks before they are used
(``parallel.collectives.all_max_``): every rank's histories are the
global batch's, as in the JAX step; under sp over the sp group too
(JAX's ``grad_axes``), so they are every position's.
"""

from __future__ import annotations

import ctypes
import math
import os
import warnings
from typing import Optional

import torch
from torch import nn

from faster_distributed_training_tpu_torch.ops import _build
from faster_distributed_training_tpu_torch.parallel.collectives import (
    all_max_)

ENV_KILL = "FDT_QUANT"

# the largest magnitude each grid represents (int8 symmetric at 127; E4M3
# has no inf and tops out at 448; E5M2 at 57344, the gradient format)
QMAX = {"int8": 127.0, "fp8": 448.0, "fp8_e4m3": 448.0, "fp8_e5m2": 57344.0}
_FMTS = ("int8", "fp8")
_GRAD_FMTS = (None, "fp8_e5m2")
_FP8 = {"fp8": torch.float8_e4m3fn, "fp8_e4m3": torch.float8_e4m3fn,
        "fp8_e5m2": torch.float8_e5m2}
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_FMTS = {"int8": 0, "fp8": 1}


def quant_enabled() -> bool:
    """The FDT_QUANT=0 kill switch, read per call: False means every
    quantized site computes the plain full-precision matmul."""
    return os.environ.get(ENV_KILL, "1") != "0"


def rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """num / t as one IEEE division (``num / t`` on a tensor is
    reciprocal(t) * num in torch, a second rounding)."""
    return torch.div(torch.full_like(t, num), t)


# -- the delayed-scaling state ---------------------------------------------

def fresh_amax_history(length: int = 16, device=None) -> torch.Tensor:
    """A zero history: scale_from_history reads it as "never observed"."""
    return torch.zeros(int(length), dtype=torch.float32, device=device)


def update_amax_history(history: torch.Tensor, amax) -> torch.Tensor:
    """The newest amax in at index 0, the oldest falls off."""
    amax = torch.as_tensor(amax, dtype=torch.float32,
                           device=history.device).reshape(1)
    return torch.cat([amax, history[:-1]])


def _scale_from_amax(amax: torch.Tensor, fmt: str) -> torch.Tensor:
    """qmax / max(amax, 1e-30), or 1.0 for a zero amax (the shared
    formula of the delayed and the just-in-time scales)."""
    amax = amax.float()
    return torch.where(amax > 0.0,
                       rdiv(QMAX[fmt], torch.clamp(amax, min=1e-30)),
                       torch.ones_like(amax))


def scale_from_history(history: torch.Tensor, fmt: str,
                       margin: float = 1.0) -> torch.Tensor:
    """Delayed scale: qmax / (margin * max over the history window)."""
    return _scale_from_amax(history.max() * float(margin), fmt)


def tensor_amax(x: torch.Tensor) -> torch.Tensor:
    """max |x| in fp32 (upcast first)."""
    return x.detach().float().abs().max()


# -- quantize / dequantize ---------------------------------------------------

def quantize_int8(x: torch.Tensor, scale) -> torch.Tensor:
    xs = x.float() * scale
    return torch.clamp(torch.round(xs), -QMAX["int8"],
                       QMAX["int8"]).to(torch.int8)


def quantize_fp8(x: torch.Tensor, scale, variant: str = "e4m3"
                 ) -> torch.Tensor:
    qmax = QMAX[f"fp8_{variant}"]
    xs = torch.clamp(x.float() * scale, -qmax, qmax)
    return xs.to(_FP8[f"fp8_{variant}"])


def quantize(x: torch.Tensor, scale, fmt: str) -> torch.Tensor:
    if fmt == "int8":
        return quantize_int8(x, scale)
    if fmt in ("fp8", "fp8_e4m3"):
        return quantize_fp8(x, scale, "e4m3")
    if fmt == "fp8_e5m2":
        return quantize_fp8(x, scale, "e5m2")
    raise ValueError(f"unknown quant format {fmt!r}; have int8/fp8"
                     f"/fp8_e4m3/fp8_e5m2")


def dequantize(q: torch.Tensor, scale, dtype=torch.float32) -> torch.Tensor:
    """x ~ q / scale: the inverse multiplied in fp32, one cast."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=q.device)
    return (q.float() * rdiv(1.0, scale)).to(dtype)


# -- the quantized GEMM ------------------------------------------------------

def _dot_q(xq: torch.Tensor, wq: torch.Tensor, fmt: str) -> torch.Tensor:
    """xq [M, K] . wq [N, K]^T in fp32 (pre-descale).  int8 sums are
    exact: int32 on the CPU; on the card (torch has no int8 matmul there)
    an fp64 product of the int8 values, exact below 2^53, whose cast to
    fp32 rounds as the int32 -> fp32 step does."""
    if fmt == "int8":
        if xq.device.type == "cpu":
            return torch.mm(xq.to(torch.int32), wq.to(torch.int32).T).float()
        return torch.mm(xq.double(), wq.double().T).float()
    return torch.mm(xq.float(), wq.float().T)


def quant_dot_reference(xq: torch.Tensor, wq: torch.Tensor, sx, sw,
                        fmt: str, out_dtype) -> torch.Tensor:
    """The plain version: (xq . wq^T) * 1/(sx*sw) in fp32, one cast."""
    acc = _dot_q(xq, wq, fmt)
    inv = rdiv(1.0, torch.as_tensor(sx).float() * torch.as_tensor(sw).float())
    return (acc * inv.to(acc.device)).to(out_dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("quant_matmul")
    if lib.fdt_quant_matmul.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fdt_quant_matmul.argtypes = [p] * 5 + [i] * 5 + [p]
        lib.fdt_quant_matmul.restype = ctypes.c_int
        lib.fdt_qmm_smem_bytes.argtypes = []
        lib.fdt_qmm_smem_bytes.restype = ctypes.c_longlong
    return lib


def _scalar_on(s, device) -> torch.Tensor:
    t = torch.as_tensor(s, dtype=torch.float32)
    return t.reshape(1).to(device).contiguous()


def quant_matmul(xq: torch.Tensor, wq: torch.Tensor, sx, sw, fmt: str,
                 out_dtype) -> torch.Tensor:
    """xq [M, K], wq [N, K] (int8, or float8_e4m3fn for fmt "fp8"); sx,
    sw fp32 scalars (tensors stay on the device).  The kernel on CUDA,
    the plain version on the CPU.  The kernel picks E4M3's accumulation
    by ``out_dtype``: exact fp32 sums for float32, fp8 ``wgmma`` sums
    (about 14 bits) for bfloat16."""
    if xq.device.type == "cpu":
        return quant_dot_reference(xq, wq, sx, sw, fmt, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cuda (kernel) or cpu "
                         f"(plain version), not {xq.device}")
    if fmt not in _KERNEL_FMTS:
        raise ValueError(f"quant_matmul kernel takes int8 or fp8, not "
                         f"{fmt!r}")
    want = torch.int8 if fmt == "int8" else torch.float8_e4m3fn
    if xq.dtype != want or wq.dtype != want:
        raise TypeError(f"quant_matmul {fmt}: operands must be {want}, got "
                        f"{xq.dtype} / {wq.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"quant_matmul writes float32 or bfloat16, not "
                        f"{out_dtype}")
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[1]:
        raise ValueError(f"quant_matmul shapes {tuple(xq.shape)} x "
                         f"{tuple(wq.shape)}^T do not contract")
    M, K = xq.shape
    N = wq.shape[0]
    if K % 16:
        raise ValueError(f"quant_matmul kernel needs K % 16 == 0 (16-byte "
                         f"rows), got K={K}")
    xq, wq = xq.contiguous(), wq.contiguous()
    for name, t in (("xq", xq), ("wq", wq)):
        if t.device != xq.device or t.data_ptr() % 16:
            raise ValueError(f"quant_matmul {name} must be 16-byte aligned "
                             f"on {xq.device}")
    sx_t, sw_t = _scalar_on(sx, xq.device), _scalar_on(sw, xq.device)
    out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    if M == 0 or N == 0:
        return out
    lib = _lib()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = lib.fdt_quant_matmul(
            xq.data_ptr(), wq.data_ptr(), sx_t.data_ptr(), sw_t.data_ptr(),
            out.data_ptr(), _KERNEL_FMTS[fmt], _OUT_DTYPES[out_dtype], M, N,
            K, stream)
    _build.check(lib, err, "quant_matmul launch")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0


# -- the differentiable site op ----------------------------------------------

def _dot_q_mixed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] . b [K, N] of quantized operands in fp32: int8 pairs
    exactly, anything with an fp8 operand upcast (every value is exact in
    fp32)."""
    if a.dtype == torch.int8 and b.dtype == torch.int8:
        return _dot_q(a, b.T.contiguous(), "int8")
    return torch.mm(a.float(), b.float())


def _quant_dot_bwd(xq, wq, sx, sw, g, grad_fmt, grad_tp=None):
    """(dx [M, K], dw [N, K]) for the cotangent g [M, N].  ``grad_tp``: the
    tp group g's columns are sharded over (its amax is the MAX over the
    group too: JAX's ``grad_axes``)."""
    if grad_fmt is not None:
        # the just-in-time scale of the global batch's cotangent
        amax = all_max_(tensor_amax(g))
        if grad_tp is not None:
            amax = grad_tp.max_(amax)
        sg = _scale_from_amax(amax, grad_fmt)
        gq = quantize(g, sg, grad_fmt)
        dx = (_dot_q_mixed(gq, wq) * rdiv(1.0, sg * sw.float())).to(g.dtype)
        dw = (_dot_q_mixed(gq.T, xq) * rdiv(1.0, sx.float() * sg)
              ).to(g.dtype)
        return dx, dw
    x_deq = dequantize(xq, sx, g.dtype)
    w_deq = dequantize(wq, sw, g.dtype)
    # gradient GEMMs in the compute dtype (fp32 accumulation), the
    # straight-through estimator through the rounding
    return torch.matmul(g, w_deq), torch.matmul(g.T, x_deq)


class _QuantDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, sx, sw, fmt: str, grad_fmt, grad_tp):
        # quantize once: the same tensors feed the GEMM and are the
        # residuals (1 byte an element)
        xq, wq = quantize(x, sx, fmt), quantize(w, sw, fmt)
        ctx.save_for_backward(xq, wq, sx, sw)
        ctx.grad_fmt, ctx.grad_tp = grad_fmt, grad_tp
        return quant_matmul(xq, wq, sx, sw, fmt, x.dtype)

    @staticmethod
    def backward(ctx, g):
        xq, wq, sx, sw = ctx.saved_tensors
        dx, dw = _quant_dot_bwd(xq, wq, sx, sw, g, ctx.grad_fmt,
                                ctx.grad_tp)
        return dx, dw, None, None, None, None, None


def quant_dot(x: torch.Tensor, w: torch.Tensor, sx, sw, fmt: str,
              grad_fmt: Optional[str] = None, grad_tp=None) -> torch.Tensor:
    """out [M, N] = dequant(quant(x) . quant(w)^T) in x's dtype; x [M, K],
    w [N, K]; sx/sw the fp32 delayed scales.  ``grad_tp``: the
    ``TensorGroup`` the cotangent's columns are sharded over (a
    column-parallel site; None otherwise)."""
    if fmt not in _FMTS:
        raise ValueError(f"quant_dot fmt must be one of {_FMTS}, got "
                         f"{fmt!r}")
    if grad_fmt not in _GRAD_FMTS:
        raise ValueError(f"quant_dot grad_fmt must be one of {_GRAD_FMTS}, "
                         f"got {grad_fmt!r}")
    sx = torch.as_tensor(sx, dtype=torch.float32, device=x.device)
    sw = torch.as_tensor(sw, dtype=torch.float32, device=x.device)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _QuantDot.apply(x, w, sx, sw, fmt, grad_fmt, grad_tp)
    return quant_matmul(quantize(x, sx, fmt), quantize(w, sw, fmt), sx, sw,
                        fmt, x.dtype)


# -- the site module -----------------------------------------------------------

def _replaying() -> bool:
    from faster_distributed_training_tpu_torch.models.remat import replaying

    return replaying()


class QuantDense(nn.Module):
    """``nn.Linear`` with an int8/fp8 forward GEMM at delayed per-tensor
    scales (the JAX ``QuantDense``).  ``forward(x, train)`` quantizes at
    the scales of the pre-step histories and rolls them only in a
    training forward with ``frozen_scales=False`` (serving freezes
    them); in a staged forward (``parallel.pipeline.current_tick``) each
    microbatch quantizes at the pre-step scales and the histories roll
    once a step (the JAX pipeline cadence).  Under tp (``tp`` a
    ``TensorGroup``; ``tp_dim`` the dim of the JAX kernel its rule
    shards, 0 row-parallel, above 0 column-parallel) the features are
    the rank's shard's: column [out/tp, in], row [out, in/tp] with the
    whole bias added after the SUM over tp."""

    def __init__(self, in_features: int, out_features: int, fmt: str = "int8",
                 amax_history_len: int = 16, margin: float = 1.0,
                 frozen_scales: bool = False, grad_fmt: Optional[str] = None,
                 dtype=torch.float32, param_dtype=torch.float32, tp=None,
                 tp_dim: Optional[int] = None):
        super().__init__()
        if fmt not in _FMTS:
            raise ValueError(f"QuantDense fmt must be one of {_FMTS}, got "
                             f"{fmt!r}")
        self.tp = tp if tp is not None and tp.size > 1 else None
        self.tp_dim = tp_dim if self.tp is not None else None
        self.row = self.tp_dim == 0
        self.in_features, self.out_features = in_features, out_features
        self.fmt, self.margin = fmt, float(margin)
        self.frozen_scales, self.grad_fmt = bool(frozen_scales), grad_fmt
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=param_dtype))
        self.register_buffer("amax_history_x",
                             fresh_amax_history(amax_history_len))
        self.register_buffer("amax_history_w",
                             fresh_amax_history(amax_history_len))
        bound = 1.0 / math.sqrt(in_features)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound)

    def scales(self):
        """(sx, sw) the histories imply now."""
        return (scale_from_history(self.amax_history_x, self.fmt,
                                   self.margin),
                scale_from_history(self.amax_history_w, self.fmt,
                                   self.margin))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        lead = x.shape[:-1]
        x2d = x.to(self.dtype).reshape(-1, self.in_features)
        w2d = self.weight.to(self.dtype)
        if not quant_enabled():
            # FDT_QUANT=0: the plain matmul with fp32 output, state untouched
            out = torch.matmul(x2d.float(), w2d.float().T)
            if self.row:
                out = self.tp.reduce_out(out)
        else:
            from faster_distributed_training_tpu_torch.parallel.pipeline import (
                current_tick)

            cad = current_tick() if train and not self.frozen_scales else None
            if cad is None:
                sx, sw = self.scales()
            else:
                # every microbatch at the pre-step scales
                sx, sw = (scale_from_history(
                    cad.amax_pre((id(self), s), h), self.fmt, self.margin)
                    for s, h in (("x", self.amax_history_x),
                                 ("w", self.amax_history_w)))
            tp = self.tp
            if train and not self.frozen_scales and not _replaying():
                # never in a --remat replay: the histories roll once a step
                # the activation's amax over the global batch (every
                # rank's rows), as the JAX step takes it; under tp the
                # amaxes of the logical operands: the weight's over its
                # shards, a row site's input's too
                with torch.no_grad():
                    ax = all_max_(tensor_amax(x2d))
                    aw = tensor_amax(w2d)
                    if tp is not None:
                        aw = tp.max_(aw)
                        if self.row:
                            ax = tp.max_(ax)
                    if cad is not None:
                        cad.amax_push((id(self), "x"), self.amax_history_x,
                                      ax)
                        cad.amax_push((id(self), "w"), self.amax_history_w,
                                      aw)
                    else:
                        self.amax_history_x.copy_(update_amax_history(
                            self.amax_history_x, ax))
                        self.amax_history_w.copy_(update_amax_history(
                            self.amax_history_w, aw))
            # row 9 on the rank's shard: a column site's cotangent is
            # sharded over tp (its E5M2 amax MAXes over tp too), a row
            # site SUMs its partial products, in x's dtype (JAX's psum)
            out = quant_dot(x2d, w2d, sx, sw, self.fmt, self.grad_fmt,
                            grad_tp=None if self.row else tp)
            if self.row:
                out = tp.reduce_out(out)
            out = out.float()
        out = out + self.bias.float()
        return out.to(self.dtype).reshape(*lead, self.out_features)


def warn_if_killed(fmt: str) -> None:
    """The build-time warning of the kill switch."""
    if not quant_enabled():
        warnings.warn(f"--quant {fmt} requested but {ENV_KILL}=0 is set: "
                      f"every quantized site computes the plain "
                      f"full-precision matmul this run (the scale state is "
                      f"still allocated, so checkpoints interchange)",
                      stacklevel=3)
