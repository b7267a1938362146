"""Which bf16 views the flash forward and backward kernels take.

The bf16 kernels of ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` move
16-byte rows with ``cp.async``: every q/k/v/out/dO/gradient view needs a
16-byte-aligned base and (b, h, l) strides that are multiples of 8
elements, and anything else raises before a launch (no copy, no other
route).  The check is plain
Python over a tensor's address and strides, so it runs here on CPU
tensors; the kernels themselves are held on the card
(``tests/test_torch_cuda.py``).
"""

import pytest
import torch

from faster_distributed_training_tpu_torch.ops.flash_attention import (
    _check_rows16)


def _fused_view():
    """q as the model hands it over: a strided view of [B, L, 3, H, D]."""
    return torch.zeros(2, 16, 3, 4, 16, dtype=torch.bfloat16)[:, :, 0] \
        .transpose(1, 2)


def _odd_row_stride():
    return torch.zeros(1, 2, 16, 17, dtype=torch.bfloat16)[..., :16]


def _misaligned_base():
    return torch.zeros(1 + 2 * 16 * 16, dtype=torch.bfloat16)[1:].view(
        1, 2, 16, 16)


@pytest.mark.parametrize("make,ok", [(_fused_view, True),
                                     (_odd_row_stride, False),
                                     (_misaligned_base, False)])
def test_bf16_backward_takes_16_byte_rows_only(make, ok):
    t = make()
    if ok:
        _check_rows16(q=t)
    else:
        with pytest.raises(ValueError, match="16-byte"):
            _check_rows16(q=t)
