"""The reference's hand-rolled LayerNorm math (forward only).

Counterpart of ``faster_distributed_training_tpu/ops/layernorm.py::
torch_layernorm_f32``: the std is UNBIASED (n-1) and eps is added to the
std, not the variance.  The saved-statistics backward arrives with the
training slice.
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
