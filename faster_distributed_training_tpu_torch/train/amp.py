"""Mixed-precision policy of the port (the JAX package's ``train/amp.py``).

bf16 compute with fp32 parameters: the model keeps every parameter in
fp32 and casts GEMM weights to the compute dtype at use, so autograd
returns fp32 gradients and the optimizer updates fp32 state.  bf16 has
fp32's exponent range, so no loss scaling is needed.  The fp16 mode with
its dynamic loss scale is not ported: ``--precision fp16`` raises.
"""

from __future__ import annotations

import torch

COMPUTE_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def compute_dtype(precision: str) -> torch.dtype:
    """The compute dtype of ``--precision``; fp16 is not ported yet."""
    if precision not in COMPUTE_DTYPES:
        raise NotImplementedError(
            f"not ported yet: --precision {precision} (the port has "
            f"{sorted(COMPUTE_DTYPES)}; fp16 loss scaling comes later)")
    return COMPUTE_DTYPES[precision]
