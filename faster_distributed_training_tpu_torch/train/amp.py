"""Mixed-precision policy of the port (the JAX package's ``train/amp.py``).

bf16 compute with fp32 parameters: the model keeps every parameter in
fp32 and casts GEMM weights to the compute dtype at use, so autograd
returns fp32 gradients and the optimizer updates fp32 state.  bf16 has
fp32's exponent range, so no loss scaling is needed.

``--precision fp16`` is the JAX package's parity mode: fp32 compute (its
``build_model`` maps fp16 to fp32) under a torch-GradScaler-style dynamic
loss scale: scale the loss, unscale the grads, skip the step and halve
the scale on non-finite grads, double it after ``growth_interval``
finite steps in a row (``LossScaleState``, ``scale_loss``,
``unscale_and_check``, ``update_loss_scale``).  The scale lives on the
device; the backoff floors at fp32's smallest normal.

``QuantPolicy`` / ``resolve_quant_policy`` describe the quantized mode
(``--quant``, ``--quant_grad``) with the JAX package's checks and messages.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

# fp16 computes in fp32 under loss scaling, as in the JAX package
COMPUTE_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32,
                  "fp16": torch.float32}


def compute_dtype(precision: str) -> torch.dtype:
    """The compute dtype of ``--precision``."""
    if precision not in COMPUTE_DTYPES:
        raise ValueError(f"--precision must be one of "
                         f"{sorted(COMPUTE_DTYPES)}, got {precision!r}")
    return COMPUTE_DTYPES[precision]


@dataclass
class LossScaleState:
    scale: torch.Tensor          # () fp32, the current loss scale
    growth_count: torch.Tensor   # () int32, consecutive finite steps


def fresh_loss_scale(init_scale: float = 2.0 ** 16, device=None
                     ) -> LossScaleState:
    return LossScaleState(
        scale=torch.tensor(init_scale, dtype=torch.float32, device=device),
        growth_count=torch.tensor(0, dtype=torch.int32, device=device))


def scale_loss(loss: torch.Tensor, state: LossScaleState,
               enabled: bool) -> torch.Tensor:
    return loss * state.scale if enabled else loss


def unscale_and_check(grads: Dict[str, torch.Tensor], state: LossScaleState,
                      enabled: bool
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(unscaled grads, a device bool: every grad finite)."""
    if not enabled:
        return grads, torch.tensor(True)
    inv = 1.0 / state.scale
    grads = {n: g * inv for n, g in grads.items()}
    finite = torch.stack([torch.isfinite(g).all()
                          for g in grads.values()]).all()
    return grads, finite


def update_loss_scale(state: LossScaleState, grads_finite: torch.Tensor,
                      enabled: bool, growth_factor: float = 2.0,
                      backoff_factor: float = 0.5,
                      growth_interval: int = 2000) -> LossScaleState:
    """The next scale, decided on the device."""
    if not enabled:
        return state
    grew = state.growth_count + 1 >= growth_interval
    floor = torch.finfo(torch.float32).tiny
    new_scale = torch.where(
        grads_finite,
        torch.where(grew, state.scale * growth_factor, state.scale),
        torch.clamp(state.scale * backoff_factor, min=floor))
    zero = torch.zeros_like(state.growth_count)
    new_count = torch.where(grads_finite,
                            torch.where(grew, zero, state.growth_count + 1),
                            zero)
    return LossScaleState(scale=new_scale,
                          growth_count=new_count.to(torch.int32))


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
