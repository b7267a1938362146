"""Fused Conv2D + BatchNorm with the conv output recomputed in the
backward (the JAX package's ``ops/conv_bn.py``).

``fused_conv_bn`` is a ``torch.autograd.Function``: its forward runs the
convolution, fp32 single-pass batch statistics and the normalize, and
saves only ``(x, w, mean, sqrt_var)``, not the conv output; its backward
recomputes the conv output, applies the hand-derived BatchNorm backward
and one conv transpose (``aten.convolution_backward``) for dx and dw.
``conv_bn_reference`` is the same forward under plain autograd.

Numerics are the JAX package's, which are the reference's:
  * the BN has no affine parameters;
  * the variance is the unbiased single-pass estimate,
    ``max(E[y²] − E[y]², 0) · n/(n−1)``, in fp32 for bf16 / fp16 / fp32
    compute (fp64 stays fp64);
  * eps is added to the standard deviation: ``(y − mean) / (sqrt(var) +
    eps)``, a division, default eps 1e-3.

Under a data mesh (``parallel.collectives.current()``) the statistics
are the global batch's, as the JAX package's BatchNorm computes them
under GSPMD (SyncBatchNorm): the per-channel means of y and y² are
averaged over the ranks (equal row counts: the mean of the ranks' means
is the global mean) and n is the global count; the backward's two
per-channel sums are all-reduced the same way.

Layout: NCHW activations (``torch.channels_last`` in memory on the card,
the JAX package's NHWC) and OIHW kernels.  No hand kernel: on the TPU the
conv is one XLA op with the normalize fused into its epilogue, and on the
card the conv is cuDNN's (``F.conv2d``); the value of this op is the
backward's recompute policy, not a kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from faster_distributed_training_tpu_torch.parallel import collectives

_STATS_DIMS = (0, 2, 3)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           padding: int = 1) -> torch.Tensor:
    """NCHW conv with an OIHW kernel, symmetric int padding, no bias."""
    return F.conv2d(x, w, stride=stride, padding=padding)


def stats_dtype(dtype: torch.dtype) -> torch.dtype:
    """bf16 / fp16 statistics are unsafe: at least fp32 (fp64 stays)."""
    return torch.promote_types(dtype, torch.float32)


def _bn_stats(y: torch.Tensor, group=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, unbiased var) per channel, in fp32 or wider, in one pass
    over y; with a data ``group``, over every rank's y."""
    n = y.numel() // y.shape[1]
    y = y.to(stats_dtype(y.dtype))
    mean = y.mean(dim=_STATS_DIMS)
    mean_sq = torch.square(y).mean(dim=_STATS_DIMS)
    if group is not None:
        mean, mean_sq = group.mean(torch.stack([mean, mean_sq])).unbind(0)
        n *= group.world
    var = torch.clamp(mean_sq - torch.square(mean), min=0.0) * (n / (n - 1))
    return mean, var


def _bcast(t: torch.Tensor) -> torch.Tensor:
    return t[None, :, None, None]


def _conv_bn_forward(x, w, stride, padding, eps, group=None):
    """conv -> batch stats -> normalize; (out, y, mean, var)."""
    y = conv2d(x, w, stride, padding)
    mean, var = _bn_stats(y, group)
    out = ((y.to(mean.dtype) - _bcast(mean))
           / _bcast(torch.sqrt(var) + eps)).to(y.dtype)
    return out, y, mean, var


def conv_bn_reference(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                      padding: int = 1, eps: float = 1e-3) -> torch.Tensor:
    """The unfused conv + BN under plain autograd: the plain version the
    fused op is held against."""
    return _conv_bn_forward(x, w, stride, padding, eps,
                            collectives.current())[0]


class _FusedConvBN(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, stride, padding, eps):
        group = collectives.current()
        out, _, mean, var = _conv_bn_forward(x, w, stride, padding, eps,
                                             group)
        ctx.save_for_backward(x, w, mean, torch.sqrt(var))
        ctx.conf = (stride, padding, eps)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        x, w, mean, sqrt_var = ctx.saved_tensors
        stride, padding, eps = ctx.conf
        # (1) recompute the conv output
        y = conv2d(x, w, stride, padding)
        # (2) the BatchNorm backward, in fp32:
        #   out_i = (y_i - mu) / s,  s = sqrt(var) + eps, var unbiased over n
        n = y.numel() // y.shape[1]
        y32, g32 = y.to(mean.dtype), g.to(mean.dtype)
        s = sqrt_var + eps
        centered = y32 - _bcast(mean)
        g_sum = g32.sum(dim=_STATS_DIMS)
        gc_sum = (g32 * centered).sum(dim=_STATS_DIMS)
        if ctx.group is not None:
            # the global batch's sums (every rank's cotangents)
            g_sum, gc_sum = ctx.group.sum_(torch.stack([g_sum, gc_sum])
                                           ).unbind(0)
            n *= ctx.group.world
        d_s = -gc_sum / (s * s)
        # a constant channel has sqrt_var == 0: bound its d_var term
        d_var = d_s / (2.0 * torch.clamp(sqrt_var, min=1e-12))
        dy = (g32 / _bcast(s) + centered * _bcast(2.0 * d_var / (n - 1))
              - _bcast(g_sum / (s * n)))
        # (3) the conv transpose: dx and dw in one call
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dy.to(y.dtype), x, w, None, [stride, stride],
            [padding, padding], [1, 1], False, [0, 0], 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw, None, None, None


def fused_conv_bn(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                  padding: int = 1, eps: float = 1e-3
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused conv + BN: ``(out, mean, var)``, the per-channel batch
    statistics (fp32) for the caller's running stats."""
    return _FusedConvBN.apply(x, w, int(stride), int(padding), float(eps))


def conv_bn_train(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                  padding: int = 1, eps: float = 1e-3, remat: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode conv + BN, ``(out, mean, var)``.  ``remat=True`` is
    the fused op (the backward recomputes the conv output); ``remat=
    False`` (``--tricks off``) leaves the backward to autograd, which
    keeps the conv output."""
    if remat:
        return fused_conv_bn(x, w, stride, padding, eps)
    out, _, mean, var = _conv_bn_forward(x, w, stride, padding, eps,
                                         collectives.current())
    return out, mean.detach(), var.detach()
