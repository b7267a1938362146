"""The reference's hand-rolled LayerNorm math and its saved-stats backward.

Counterpart of ``faster_distributed_training_tpu/ops/layernorm.py``: the
std is UNBIASED (n-1) and eps is added to the std, not the variance.

  * ``torch_layernorm_f32`` -- the plain fp32 math: the reference, and the
    eval/serving form (no residuals kept);
  * ``torch_layernorm`` -- the same forward as a ``torch.autograd.Function``
    that saves (x, scale, mean, rstd) and rebuilds x-hat in the backward
    (JAX's ``_ln_fwd`` / ``_ln_bwd``): the training form.

Backward, for y = scale * xhat + bias, xhat = (x - mean) * r,
r = 1 / (sigma + eps), sigma = sqrt(sum (x - mean)^2 / (n - 1)):

    gy = g * scale;  dbias = sum_rows g;  dscale = sum_rows g * xhat
    dx = r * (gy - mean_j gy) - xhat * sum_j(gy * xhat) / (sigma * (n - 1))

with sigma re-derived from the saved rstd as 1/r - eps.
"""

from __future__ import annotations

import torch


def torch_layernorm_f32(x32: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 LayerNorm over the last axis; inputs and output fp32."""
    d = x32.shape[-1]
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.square(x32 - mean).sum(dim=-1, keepdim=True) / (d - 1)
    return scale * ((x32 - mean) / (torch.sqrt(var) + eps)) + bias


class _LNSavedStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x32, scale, bias, eps: float):
        d = x32.shape[-1]
        mean = x32.mean(dim=-1, keepdim=True)
        var = torch.square(x32 - mean).sum(dim=-1, keepdim=True) / (d - 1)
        std = torch.sqrt(var) + eps
        # the primal uses the same division as torch_layernorm_f32, so the
        # forward is bit-identical to the plain form; rstd is a residual
        out = scale * ((x32 - mean) / std) + bias
        ctx.save_for_backward(x32, scale, mean, 1.0 / std)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, g):
        x32, scale, mean, rstd = ctx.saved_tensors
        d = x32.shape[-1]
        xhat = (x32 - mean) * rstd
        g32 = g.to(torch.promote_types(g.dtype, torch.float32))
        dbias = g32.reshape(-1, d).sum(dim=0)
        dscale = (g32 * xhat).reshape(-1, d).sum(dim=0)
        gy = g32 * scale
        c1 = gy.mean(dim=-1, keepdim=True)
        c2 = (gy * xhat).sum(dim=-1, keepdim=True)
        sigma = 1.0 / rstd - ctx.eps
        dx = rstd * (gy - c1) - xhat * (c2 / (sigma * (d - 1)))
        return dx, dscale, dbias, None


def torch_layernorm(x32: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, eps: float) -> torch.Tensor:
    """torch_layernorm_f32 with the saved-stats backward (the training
    form)."""
    return _LNSavedStats.apply(x32, scale, bias, float(eps))
