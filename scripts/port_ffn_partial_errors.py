"""Errors of row 8's kernel on the card against its plain version, full
and tp ``partial`` outputs, over shapes, formats and dtypes: the worst
|kernel - plain| over max |plain|, and for the partial tile also over
max |h + plain| (the scale the full output's check reads).  Run on a
card: ``python3 scripts/port_ffn_partial_errors.py``."""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from faster_distributed_training_tpu_torch.ops.fused_ffn import (  # noqa
    _ffn_body_reference, ffn_fwd_generalized)


def inputs(g, rows, d, d_ff, dtype):
    h = torch.randn(rows, d, generator=g, device="cuda").to(dtype)
    ln_s = 1.0 + 0.1 * torch.randn(d, generator=g, device="cuda")
    ln_b = 0.1 * torch.randn(d, generator=g, device="cuda")
    w1 = (torch.randn(d_ff, d, generator=g, device="cuda") / d ** 0.5
          ).to(dtype)
    b1 = (0.1 * torch.randn(d_ff, generator=g, device="cuda")).to(dtype)
    w2 = (torch.randn(d, d_ff, generator=g, device="cuda") / d_ff ** 0.5
          ).to(dtype)
    b2 = (0.1 * torch.randn(d, generator=g, device="cuda")).to(dtype)
    return h, ln_s, ln_b, w1, b1, w2, b2


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    scales = torch.tensor([30.0, 300.0, 60.0, 250.0], device="cuda")
    for fmt in (None, "int8", "fp8"):
        for dtype in (torch.bfloat16, torch.float32):
            for rows, d, f in ((512, 64, 128), (512, 64, 512),
                               (512, 512, 512), (8192, 512, 512),
                               (512, 64, 208), (8192, 512, 1024)):
                args = inputs(g, rows, d, f, dtype)
                quant = None if fmt is None else (fmt, *scales.unbind(),
                                                  None)
                line = []
                for partial in (False, True):
                    seeds = (11, 12, 0, 0, f if partial else 0)
                    out, _ = ffn_fwd_generalized(
                        *args, seeds, scales, 0.1, 0.1, 1e-6, 1, 1,
                        2 * f if partial else f, fmt, partial=partial)
                    want = _ffn_body_reference(
                        *args, 11, 12, 0.1, 0.1, 1e-6, c0=seeds[4],
                        dff_glob=2 * f if partial else f, quant=quant,
                        plain_gemm=True, partial=partial)
                    err = (out.float() - want.float()).abs().max().item()
                    line.append(err / want.float().abs().max().item())
                    if partial:
                        line.append(err / (args[0].float() + want).abs()
                                    .max().item())
                print(f"{fmt} {str(dtype)[6:]} {rows}x{d}->{f}: full "
                      f"{line[0]:.5f}, partial {line[1]:.5f} (of max |h + "
                      f"partial| {line[2]:.5f})", flush=True)


if __name__ == "__main__":
    main()
