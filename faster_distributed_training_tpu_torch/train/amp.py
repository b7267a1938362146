"""Mixed-precision policy of the port (the JAX package's ``train/amp.py``).

bf16 compute with fp32 parameters: the model keeps every parameter in
fp32 and casts GEMM weights to the compute dtype at use, so autograd
returns fp32 gradients and the optimizer updates fp32 state.  bf16 has
fp32's exponent range, so no loss scaling is needed.  The fp16 mode with
its dynamic loss scale is not ported: ``--precision fp16`` raises.

``QuantPolicy`` / ``resolve_quant_policy`` describe the quantized mode
(``--quant``, ``--quant_grad``) with the JAX package's checks and messages.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import torch

COMPUTE_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def compute_dtype(precision: str) -> torch.dtype:
    """The compute dtype of ``--precision``; fp16 is not ported yet."""
    if precision not in COMPUTE_DTYPES:
        raise NotImplementedError(
            f"not ported yet: --precision {precision} (the port has "
            f"{sorted(COMPUTE_DTYPES)}; fp16 loss scaling comes later)")
    return COMPUTE_DTYPES[precision]


class QuantPolicy(NamedTuple):
    """The quantized-training mode (the JAX ``train/amp.py::QuantPolicy``
    without its TPU routing field).  The per-tensor state (amax
    histories) lives in the model's ``QuantDense`` buffers.

    fmt: "int8" (127-grid, int32 accumulation) or "fp8" (E4M3 forward
      operands, fp32 accumulation).
    amax_history_len, margin: the delayed-scaling window and headroom.
    frozen_scales: inference (serving): quantize at the scales of the
      restored histories and never roll them.
    grad_fmt: None or "fp8_e5m2" (--quant_grad): quantized gradient
      GEMMs at just-in-time scales."""
    fmt: str
    amax_history_len: int = 16
    margin: float = 1.0
    frozen_scales: bool = False
    grad_fmt: Optional[str] = None


def resolve_quant_policy(cfg) -> Optional[QuantPolicy]:
    """cfg.quant / cfg.quant_grad -> QuantPolicy, or None for "none"."""
    mode = (getattr(cfg, "quant", "none") or "none").lower()
    grad = (getattr(cfg, "quant_grad", "none") or "none").lower()
    if mode in ("", "none"):
        if grad not in ("", "none"):
            warnings.warn(
                f"--quant_grad {grad} requires --quant int8/fp8 (gradient "
                f"quantization rides the quantized GEMM sites); running "
                f"full-precision", stacklevel=2)
        return None
    if mode not in ("int8", "fp8"):
        raise ValueError(f"--quant must be none/int8/fp8, got {mode!r}")
    if grad in ("", "none"):
        grad_fmt = None
    elif grad in ("fp8_e5m2", "e5m2"):
        grad_fmt = "fp8_e5m2"
    else:
        raise ValueError(f"--quant_grad must be none/fp8_e5m2, got {grad!r}")
    return QuantPolicy(fmt=mode, grad_fmt=grad_fmt)
