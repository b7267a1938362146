"""Fused pre-LN FFN sublayer: the Hopper kernel, its plain versions and
the recompute-backward autograd Functions.

Counterpart of ``faster_distributed_training_tpu/ops/fused_ffn.py``:

    out = h + drop(Dense2(drop(gelu(Dense1(LN(h))))))

in one kernel per call (``csrc/fused_ffn.cu``, which replaces both
``_ffn_fwd_pallas`` and ``_ffn_fwd_pallas2``), with every intermediate
kept on chip: the ``wgmma`` kernel for bf16 and for fp32 under quant up to
d_model 512, the WMMA / FMA kernel otherwise, routed by shape and type in
the kernel's C entry (``ffn_engine`` asks it).  LN is TorchLayerNorm in
fp32, GELU the exact form through the A&S 7.1.26 erf polynomial
(``_erf_f32``, shared with the plain versions so the recompute backward
sees the forward's activations), both dropout sites the stateless hash
stream of ``ops/dropout.py`` addressed by global row id.  Under quant the
two GEMMs run on int8/E4M3 operands at delayed scales: the LN output and
the hidden activation are quantized in the kernel, the weights once per
call here, and the kernel returns
[amax_f, amax_a] for the history roll.

Weights are in ``nn.Linear``'s layout: w1 [d_ff, d], w2 [d, d_ff].  For
CUDA tensors the forwards launch the kernel; for CPU tensors they run
``ffn_sublayer_reference`` / ``_ffn_body_reference``.  Any other device,
or a shape the kernel cannot take, raises; there is no VMEM-style
fallback.  The backward of both Functions saves the INPUTS only and
recomputes through the plain version under autograd (the JAX
``_ffn_vjp_bwd`` / ``_ffn_vjp2_bwd``); inside it the quantized GEMMs go
through ``ops.quant.quant_dot``, which launches the quantized-GEMM kernel
on the card, and the unquantized ones stay ``torch.matmul``.

The generalized core's ``partial`` mode is the Megatron column-then-row
tile a tensor-parallel rank runs (JAX ``_ffn_fwd_pallas2(partial=True)``,
``parallel/kernel_shard.py::fused_ffn_sublayer_tp``): w1 the rank's
[d_ff/tp, d] rows, w2 its [d, d_ff/tp] columns, the hidden dropout at the
global columns (``c0``, ``dff_glob``), and the kernel stops before b2,
the connection dropout and the residual, writing GEMM2's fp32 product
for the SUM over tp.  Under quant its GEMMs' E5M2 gradient amaxes reduce
over the tp group too (``grad_tp``).

Under sequence parallelism an sp rank launches the kernel on its
positions of every row (JAX ``fused_ffn_sublayer_sharded``'s per-shard
call): the sequence offsets ``s0`` (its first position), ``l_loc`` (its
positions a row) and ``l_glob`` (the row's) are operands, so its rows
draw the global rows' dropout words (``_global_rows``) and each half is
bitwise the full launch's rows; its amaxes and its E5M2 gradient amaxes
MAX over the sp group with the data group's (``collectives.all_max_``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from faster_distributed_training_tpu_torch.ops import _build
from faster_distributed_training_tpu_torch.ops.attention import (
    seed_operand, seed_u32)
from faster_distributed_training_tpu_torch.ops.dropout import (
    _GRID, _M32, _thresh_u16, guard_index_ceiling, keep_factor_rows)
from faster_distributed_training_tpu_torch.ops.layernorm import (
    torch_layernorm)
from faster_distributed_training_tpu_torch.ops.quant import (
    quant_dot, quant_dot_reference, quantize, rdiv, tensor_amax)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FMT_CODES = {None: 0, "int8": 1, "fp8": 2}
_SMEM_LIMIT = 232448     # bytes of shared memory a block may use (H100)

_A = tuple(float(np.float32(v)) for v in (
    0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429,
    0.3275911))
_RSQRT2 = float(np.float32(1.0 / np.sqrt(2.0)))


def _erf_f32(x: torch.Tensor) -> torch.Tensor:
    """erf by the Abramowitz-Stegun 7.1.26 polynomial, the JAX op order."""
    a1, a2, a3, a4, a5, p = _A
    s = torch.sign(x)
    ax = torch.abs(x)
    t = rdiv(1.0, 1.0 + p * ax)
    y = 1.0 - (((((a5 * t + a4) * t) + a3) * t + a2) * t + a1) * t \
        * torch.exp(-ax * ax)
    return s * y


def _gelu_f32(h1: torch.Tensor) -> torch.Tensor:
    """Exact-form GELU on fp32 pre-activations."""
    return 0.5 * h1 * (1.0 + _erf_f32(h1 * _RSQRT2))


def _global_rows(r_local: torch.Tensor, b0=0, s0=0, l_loc: int = 1,
                 l_glob: int = 1) -> torch.Tensor:
    """Local flattened row ids -> global row ids of a (B, l_glob, d)
    tensor whose shard starts at batch b0, sequence s0 (uint32 math)."""
    r = r_local.to(torch.int64) & _M32
    return (((int(b0) + r // l_loc) * l_glob) + int(s0) + r % l_loc) & _M32


def _mm32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [M, K] . w [N, K]^T with an fp32 result (the JAX dot with
    preferred_element_type=float32)."""
    return torch.matmul(a.float(), w.float().T)


def ffn_sublayer_reference(h, ln_scale, ln_bias, w1, b1, w2, b2,
                           hid_seed, out_seed, rate_hidden: float,
                           rate_conn: float, eps: float = 1e-6, b0=0, s0=0,
                           l_loc: int = 1, l_glob: int = 1) -> torch.Tensor:
    """The plain version of the unquantized kernel, its op order and
    dtypes (JAX ``ffn_sublayer_reference``)."""
    return _ffn_body_reference(h, ln_scale, ln_bias, w1, b1, w2, b2,
                               hid_seed, out_seed, rate_hidden, rate_conn,
                               eps, b0, s0, l_loc, l_glob)


def _ffn_body_reference(h, ln_scale, ln_bias, w1, b1, w2, b2, hid_seed,
                        out_seed, rate_hidden, rate_conn, eps, b0=0, s0=0,
                        l_loc: int = 1, l_glob: int = 1, c0=0,
                        dff_glob: int = 0, quant=None,
                        return_amax: bool = False, plain_gemm: bool = False,
                        partial: bool = False):
    """The generalized plain version (JAX ``_ffn_body_reference``).
    quant: None or (fmt, sx1, sw1, sx2, sw2, grad_fmt[, grad_tp]), grad_tp
    the ``TensorGroup`` the E5M2 gradient amaxes also reduce over (JAX's
    ``grad_axes``).  partial: stop before b2, the connection dropout and
    the residual, and return GEMM2's fp32 product.  return_amax: also
    return the (2,) fp32 [amax_f, amax_a] (zeros without quant).  The
    quantized GEMMs go through ``quant_dot`` (the kernel on the card, as
    in the recompute backward), or with ``plain_gemm`` through
    ``quant_dot_reference`` (forward only)."""

    def qdot(x, w, sx, sw):
        if plain_gemm:
            return quant_dot_reference(quantize(x, sx, fmt),
                                       quantize(w, sw, fmt), sx, sw, fmt,
                                       x.dtype)
        return quant_dot(x, w, sx, sw, fmt, gfmt, grad_tp=gtp)

    lead, d = h.shape[:-1], h.shape[-1]
    x32 = h.reshape(-1, d).float()
    grows = _global_rows(torch.arange(x32.shape[0], device=h.device), b0,
                         s0, l_loc, l_glob)
    f = torch_layernorm(x32, ln_scale.float(), ln_bias.float(),
                        eps).to(h.dtype)
    amax_f = amax_a = torch.zeros((), dtype=torch.float32, device=h.device)
    if quant is not None:
        fmt, sx1, sw1, sx2, sw2, gfmt, *rest = quant
        gtp = rest[0] if rest else None
        if return_amax:
            amax_f = tensor_amax(f)
        h1 = qdot(f, w1, sx1, sw1).float() + b1.float()
    else:
        h1 = _mm32(f, w1) + b1.float()
    a = _gelu_f32(h1)
    if rate_hidden > 0.0:
        a = a * keep_factor_rows(hid_seed, grows, a.shape[1], rate_hidden,
                                 c0, dff_glob)
    a = a.to(h.dtype)
    if quant is not None:
        if return_amax:
            amax_a = tensor_amax(a)
        f2 = qdot(a, w2, sx2, sw2).float()
    else:
        f2 = _mm32(a, w2)
    if partial:
        out = f2.reshape(*lead, d)
    else:
        f2 = f2 + b2.float()
        if rate_conn > 0.0:
            f2 = f2 * keep_factor_rows(out_seed, grows, f2.shape[1],
                                       rate_conn)
        out = (x32 + f2).to(h.dtype).reshape(*lead, d)
    if return_amax:
        return out, torch.stack([amax_f, amax_a])
    return out


# -- the kernel ---------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_ffn")
    if lib.fdt_fused_ffn_fwd.argtypes is None:
        p, i, u, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                      ctypes.c_float)
        lib.fdt_fused_ffn_fwd.argtypes = (
            [p] * 10 + [i] * 5 + [p] * 2 + [u] * 3 + [i] * 3
            + [u, f, i, u, f, i, f, i, p])
        lib.fdt_fused_ffn_fwd.restype = ctypes.c_int
        lib.fdt_ffn_engine.argtypes = [i, i, i]
        lib.fdt_ffn_engine.restype = ctypes.c_int
        lib.fdt_ffn_smem_bytes.argtypes = [i, i, i]
        lib.fdt_ffn_smem_bytes.restype = ctypes.c_longlong
    return lib


def _dropout_args(rate: float):
    """(threshold, fp32 survivor scale, on) of one hash-dropout site."""
    if rate <= 0.0:
        return 0, 0.0, 0
    t = _thresh_u16(rate)
    return t, (float(np.float32(_GRID / t)) if t > 0 else 0.0), 1


def ffn_engine(dtype, fmt, d: int) -> str:
    """Which kernel of ``csrc/fused_ffn.cu`` a shape runs on, as its C
    entry routes it (by shape and type alone): "sm90" (wgmma: bf16 for
    every fmt, fp32 under quant) up to d_model 512; "wmma" (``ffn_kernel``:
    FMA for fp32 without quant, WMMA bf16 / s8 and FMA E4M3 above d_model
    512) otherwise.  Builds the kernel library on first use."""
    return ("wmma", "sm90")[_lib().fdt_ffn_engine(_DTYPES[dtype],
                                                 _FMT_CODES[fmt], d)]


def _check_inputs(h2d, ln_scale, ln_bias, w1, b1, w2, b2, fmt):
    dt = h2d.dtype
    if dt not in _DTYPES:
        raise TypeError(f"fused_ffn kernel takes float32 or bfloat16, got "
                        f"{dt}")
    rows, d = h2d.shape
    d_ff = w1.shape[0]
    if d % 16 or d_ff % 16:
        raise ValueError(f"fused_ffn kernel needs d_model and d_ff "
                         f"multiples of 16, got {d} and {d_ff}")
    wdt = {None: dt, "int8": torch.int8, "fp8": torch.float8_e4m3fn}[fmt]
    want = {"ln_scale": (ln_scale, (d,), torch.float32),
            "ln_bias": (ln_bias, (d,), torch.float32),
            "w1": (w1, (d_ff, d), wdt), "b1": (b1, (d_ff,), dt),
            "w2": (w2, (d, d_ff), wdt), "b2": (b2, (d,), dt)}
    for name, (t, shape, tdt) in want.items():
        if t.dtype != tdt or tuple(t.shape) != shape:
            raise ValueError(f"fused_ffn {name}: want {tdt} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("h", h2d), *((n, v[0]) for n, v in want.items())):
        if (t.device != h2d.device or not t.is_contiguous()
                or t.data_ptr() % 32):
            raise ValueError(f"fused_ffn {name} must be contiguous and "
                             f"32-byte aligned on {h2d.device}")
    smem = _lib().fdt_ffn_smem_bytes(_DTYPES[dt], _FMT_CODES[fmt], d)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fused_ffn kernel needs {smem} bytes of shared "
                         f"memory at d_model={d} ({fmt or dt}); a block "
                         f"has {_SMEM_LIMIT}")


def _launch(h2d, ln_scale, ln_bias, w1, b1, w2, b2, seeds, scales,
            rate_hidden, rate_conn, eps, l_loc, l_glob, dff_glob, fmt,
            partial: bool = False):
    """One kernel launch: (out [rows, d], amax (2,) fp32).  seeds: (hid,
    out, b0, s0, c0), the two dropout seeds Python ints or one-element
    integer tensors on the device (the kernel reads them there), the
    offsets Python ints; scales: (4,) fp32 on the device or None.
    ``partial``: out is GEMM2's fp32 product (no b2, connection dropout
    or residual)."""
    if fmt is not None:
        # weights quantize once per call at their delayed scales
        w1, w2 = quantize(w1, scales[1], fmt), quantize(w2, scales[3], fmt)
        scales = scales.float().contiguous()
    ln_scale = ln_scale.float().contiguous()
    ln_bias = ln_bias.float().contiguous()
    h2d = h2d.contiguous()
    w1, b1, w2, b2 = (t.contiguous() for t in (w1, b1, w2, b2))
    _check_inputs(h2d, ln_scale, ln_bias, w1, b1, w2, b2, fmt)
    rows, d = h2d.shape
    out = (torch.empty(rows, d, dtype=torch.float32, device=h2d.device)
           if partial else torch.empty_like(h2d))
    amax = torch.zeros(2, dtype=torch.float32, device=h2d.device)
    if rows == 0:
        return out, amax
    t_h, ks_h, on_h = _dropout_args(rate_hidden)
    t_c, ks_c, on_c = _dropout_args(rate_conn)
    hid, out_seed = (seed_operand(sd, h2d.device) if on else None
                     for sd, on in zip(seeds[:2], (on_h, on_c)))
    b0, s0, c0 = (int(s) & _M32 for s in seeds[2:])
    lib = _lib()
    with torch.cuda.device(h2d.device):
        stream = torch.cuda.current_stream(h2d.device).cuda_stream
        err = lib.fdt_fused_ffn_fwd(
            h2d.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), amax.data_ptr(),
            scales.data_ptr() if fmt is not None else None,
            _DTYPES[h2d.dtype], _FMT_CODES[fmt], rows, d, w1.shape[0],
            None if hid is None else hid.data_ptr(),
            None if out_seed is None else out_seed.data_ptr(),
            b0, s0, c0, int(l_loc), int(l_glob),
            int(dff_glob), t_h, ks_h, on_h, t_c, ks_c, on_c, float(eps),
            int(bool(partial)), stream)
    _build.check(lib, err, "fused_ffn launch")
    return out, amax


def _on_card(h: torch.Tensor) -> bool:
    if h.device.type == "cuda":
        return True
    if h.device.type != "cpu":
        raise ValueError(f"fused_ffn runs on cuda (kernel) or cpu (plain "
                         f"version), not {h.device}")
    return False


def ffn_fwd(h2d, ln_scale, ln_bias, w1, b1, w2, b2, hid_seed, out_seed,
            rate_hidden, rate_conn, eps, b0=0, s0=0, l_loc=1, l_glob=1):
    """The unquantized forward (JAX ``_ffn_fwd_pallas``): the kernel on
    CUDA, ``ffn_sublayer_reference`` on the CPU."""
    if not _on_card(h2d):
        return ffn_sublayer_reference(h2d, ln_scale, ln_bias, w1, b1, w2, b2,
                                      hid_seed, out_seed, rate_hidden,
                                      rate_conn, eps, b0, s0, l_loc, l_glob)
    out, _ = _launch(h2d, ln_scale, ln_bias, w1, b1, w2, b2,
                     (hid_seed, out_seed, b0, s0, 0), None, rate_hidden,
                     rate_conn, eps, l_loc, l_glob, w1.shape[0], None)
    ffn_fwd.launches += 1
    return out


ffn_fwd.launches = 0


def ffn_fwd_generalized(h2d, ln_scale, ln_bias, w1, b1, w2, b2, seeds,
                        scales, rate_hidden, rate_conn, eps, l_loc, l_glob,
                        dff_glob, fmt, grad_fmt=None, partial: bool = False):
    """The generalized forward (JAX ``_ffn_fwd_pallas2``): (out, amax2).
    seeds (hid, out, b0, s0, c0) python ints; scales (4,) fp32 [sx1, sw1,
    sx2, sw2] (ignored when fmt is None).  ``partial``: the tp tile's fp32
    GEMM2 product (a tp rank's w1 rows and w2 columns; its launches also
    count in ``ffn_fwd_generalized.partial_launches``)."""
    if not _on_card(h2d):
        hid, out_seed, b0, s0, c0 = seeds
        quant = (None if fmt is None else
                 (fmt, scales[0], scales[1], scales[2], scales[3], grad_fmt))
        return _ffn_body_reference(h2d, ln_scale, ln_bias, w1, b1, w2, b2,
                                   hid, out_seed, rate_hidden, rate_conn,
                                   eps, b0, s0, l_loc, l_glob, c0, dff_glob,
                                   quant, return_amax=True, partial=partial)
    res = _launch(h2d, ln_scale, ln_bias, w1, b1, w2, b2, seeds, scales,
                  rate_hidden, rate_conn, eps, l_loc, l_glob, dff_glob, fmt,
                  partial)
    ffn_fwd_generalized.launches += 1
    if partial:
        ffn_fwd_generalized.partial_launches += 1
    return res


ffn_fwd_generalized.launches = 0
ffn_fwd_generalized.partial_launches = 0


# -- autograd: inputs-only residuals, recompute backward ------------------------

def _core_fwd(h, ln_scale, ln_bias, w1, b1, w2, b2, hid_seed, out_seed, b0,
              s0, rate_hidden, rate_conn, eps, l_loc, l_glob):
    lead, d = h.shape[:-1], h.shape[-1]
    out = ffn_fwd(h.reshape(-1, d), ln_scale, ln_bias, w1, b1, w2, b2,
                  hid_seed, out_seed, rate_hidden, rate_conn, eps, b0, s0,
                  l_loc, l_glob)
    return out.reshape(*lead, d)


def _core2_fwd(h, ln_scale, ln_bias, w1, b1, w2, b2, scales, seeds,
               rate_hidden, rate_conn, eps, l_loc, l_glob, dff_glob, fmt,
               grad_fmt, grad_tp=None, partial=False):
    lead, d = h.shape[:-1], h.shape[-1]
    out, amax2 = ffn_fwd_generalized(
        h.reshape(-1, d), ln_scale, ln_bias, w1, b1, w2, b2, seeds, scales,
        rate_hidden, rate_conn, eps, l_loc, l_glob, dff_glob, fmt, grad_fmt,
        partial)
    return out.reshape(*lead, d), amax2


def _recompute_grads(fn, inputs, g):
    """Gradients of ``fn(*inputs)`` for the cotangent g, recomputed under
    autograd (the JAX vjp of the reference)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        return torch.autograd.grad(out, leaves, g, allow_unused=True)


class _FFNCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, ln_scale, ln_bias, w1, b1, w2, b2, *args):
        ctx.save_for_backward(h, ln_scale, ln_bias, w1, b1, w2, b2)
        ctx.args = args
        return _core_fwd(h, ln_scale, ln_bias, w1, b1, w2, b2, *args)

    @staticmethod
    def backward(ctx, g):
        hid, out_seed, b0, s0, r_h, r_c, eps, l_loc, l_glob = ctx.args

        def fn(h, ls, lb, w1, b1, w2, b2):
            return ffn_sublayer_reference(h, ls, lb, w1, b1, w2, b2, hid,
                                          out_seed, r_h, r_c, eps, b0, s0,
                                          l_loc, l_glob)
        grads = _recompute_grads(fn, ctx.saved_tensors, g)
        return (*grads, *([None] * len(ctx.args)))


class _FFNCore2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, ln_scale, ln_bias, w1, b1, w2, b2, scales, *args):
        ctx.save_for_backward(h, ln_scale, ln_bias, w1, b1, w2, b2, scales)
        ctx.args = args
        out, amax2 = _core2_fwd(h, ln_scale, ln_bias, w1, b1, w2, b2,
                                scales, *args)
        ctx.mark_non_differentiable(amax2)
        return out, amax2

    @staticmethod
    def backward(ctx, g, _g_amax):
        *inputs, scales = ctx.saved_tensors
        (seeds, r_h, r_c, eps, l_loc, l_glob, dff_glob, fmt,
         gfmt, gtp, partial) = ctx.args
        hid, out_seed, b0, s0, c0 = seeds
        quant = (None if fmt is None else
                 (fmt, scales[0], scales[1], scales[2], scales[3], gfmt,
                  gtp))

        def fn(h, ls, lb, w1, b1, w2, b2):
            return _ffn_body_reference(h, ls, lb, w1, b1, w2, b2, hid,
                                       out_seed, r_h, r_c, eps, b0, s0,
                                       l_loc, l_glob, c0, dff_glob, quant,
                                       partial=partial)
        grads = _recompute_grads(fn, inputs, g)
        return (*grads, *([None] * (1 + len(ctx.args))))


def _needs_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _guard(h, w1, rate_hidden, rate_conn, site):
    if rate_hidden > 0.0 or rate_conn > 0.0:
        rows = int(np.prod(h.shape[:-1]))
        width = max(int(w1.shape[0]) if rate_hidden > 0.0 else 0,
                    int(h.shape[-1]) if rate_conn > 0.0 else 0)
        guard_index_ceiling(rows * width, site=site)


def fused_ffn_sublayer(h, ln_scale, ln_bias, w1, b1, w2, b2, hid_seed,
                       out_seed, rate_hidden: float = 0.0,
                       rate_conn: float = 0.0, eps: float = 1e-6,
                       b0: int = 0, s0: int = 0, l_glob: int = 0):
    """out = h + drop(Dense2(drop(gelu(Dense1(LN(h)))))) in one kernel;
    h [..., d] ([B, L, d]: rows are (batch, position)); w1 [d_ff, d], w2
    [d, d_ff]; seeds python ints or one-element integer tensors (ignored
    at rate 0); ``b0`` the global index of batch row 0 (a data-parallel
    rank's first row: global row (b0 + b) * L + l).  Under sequence
    parallelism h is the rank's positions ``[s0, s0 + L)`` of ``l_glob``
    (0: L): global row (b0 + b) * l_glob + s0 + l (JAX
    ``fused_ffn_sublayer_sharded``'s per-shard call).  Differentiable in
    h, the LN parameters, weights and biases."""
    _guard(h, w1, rate_hidden, rate_conn, "fused FFN dropout")
    seq = int(h.shape[-2]) if h.dim() >= 3 else 1
    args = (seed_u32(hid_seed), seed_u32(out_seed), int(b0), int(s0),
            float(rate_hidden), float(rate_conn), float(eps), seq,
            int(l_glob) or seq)
    inputs = (h, ln_scale, ln_bias, w1, b1, w2, b2)
    # eval and serving keep no residuals: the Function only under autograd
    if _needs_grad(inputs):
        return _FFNCore.apply(*inputs, *args)
    return _core_fwd(*inputs, *args)


def pack_scales(quant_scales, device=None) -> torch.Tensor:
    """The (4,) fp32 [sx1, sw1, sx2, sw2] operand, zeros without quant."""
    if quant_scales is None:
        return torch.zeros(4, dtype=torch.float32, device=device)
    return torch.stack([torch.as_tensor(s, dtype=torch.float32,
                                        device=device).reshape(())
                        for s in quant_scales])


def ffn_core_generalized(h, ln_scale, ln_bias, w1, b1, w2, b2, hid_seed,
                         out_seed, b0, s0, c0, rate_hidden: float,
                         rate_conn: float, eps: float, l_loc: int,
                         l_glob: int, dff_glob: int = 0,
                         quant_fmt: Optional[str] = None, quant_scales=None,
                         grad_fmt: Optional[str] = None, grad_tp=None,
                         partial: bool = False):
    """The generalized core: (out, amax2), amax2 = (2,) fp32 [amax_f,
    amax_a] of this call (zeros without quant).  quant_scales: (sx1, sw1,
    sx2, sw2) fp32 scalars when quant_fmt is set.  partial: out is the tp
    tile's fp32 GEMM2 product (row 8's tp mode), grad_tp the
    ``TensorGroup`` the tile's E5M2 gradient amaxes reduce over."""
    _guard(h, w1, rate_hidden, rate_conn, "fused FFN dropout")
    scales = pack_scales(quant_scales if quant_fmt is not None else None,
                         h.device)
    seeds = (seed_u32(hid_seed), seed_u32(out_seed), int(b0), int(s0),
             int(c0))
    args = (scales, seeds, float(rate_hidden), float(rate_conn), float(eps),
            int(l_loc), int(l_glob),
            int(dff_glob) if dff_glob else int(w1.shape[0]), quant_fmt,
            grad_fmt, grad_tp, bool(partial))
    inputs = (h, ln_scale, ln_bias, w1, b1, w2, b2)
    if _needs_grad(inputs):
        return _FFNCore2.apply(*inputs, *args)
    return _core2_fwd(*inputs, *args)
