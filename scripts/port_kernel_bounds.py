#!/usr/bin/env python3
"""Least H100 time of TPU kernels at the shapes of the port's paths.

    python scripts/port_kernel_bounds.py

Pure arithmetic, no card: for each kernel the bytes it must move (each
input read once, each output written once) over 3.35 TB/s and the
operations it does over the data-sheet peak for their type (H100 SXM,
dense: 989 TFLOP/s bf16, 1,979 TOP/s int8), the larger of the two.
``chip_smoke.py`` computes the same bounds from its own inputs and
prints them beside the kernels' times.
"""

PEAK_BYTES = 3.35e12
PEAK = {"bf16": 989e12, "int8": 1979e12}


def bound(n_bytes: float, n_ops: float, kind: str):
    t_b = n_bytes / PEAK_BYTES * 1e3
    t_o = n_ops / PEAK[kind] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def flash_bounds(B: int, H: int, L: int, D: int = 64):
    """(forward with lse, backward, primal forward) bounds of one flash
    call over [B, H, L, D] bf16 with a fp32 lse (and its tail) per row."""
    N = B * H
    nld = N * L * D
    fwd = bound(4 * nld * 2 + 2 * N * L * 4, 4 * N * L * L * D, "bf16")
    # q k v out dO read, dq dk dv written, lse and its tail read; five
    # L x L x D products
    bwd = bound(8 * nld * 2 + 2 * N * L * 4, 10 * N * L * L * D, "bf16")
    primal = bound(4 * nld * 2, 4 * N * L * L * D, "bf16")
    return fwd, bwd, primal


def main() -> None:
    # long context (path E, --task lm at seq 8192): the k-blocked pair,
    # which JAX takes in training once Lk*D passes the monolithic
    # backward's envelope (4096*64), at batch 4, 8 heads of 64; and the
    # primal forward past 8192*64, one sequence of 16384
    fwd, bwd, _ = flash_bounds(4, 8, 8192)
    _, _, primal = flash_bounds(1, 8, 16384)
    rows = {
        "2 _flash_fwd_kblocked (B 4, H 8, L 8192, D 64, bf16, with lse)": fwd,
        "2 _flash_fwd_kblocked primal (B 1, H 8, L 16384, D 64, bf16)":
            primal,
        "3 _flash_bwd_kblocked (B 4, H 8, L 8192; dq + dk/dv kernels)": bwd,
    }
    # --ffn_impl pallas / --quant on the record's training shape: batch 16
    # x 512 tokens, d_model 512, d_ff 1024
    r, d, f = 16 * 512, 512, 1024
    ffn_ops = 2 * 2 * r * d * f
    rows["7 _ffn_fwd_pallas (8192 rows, 512 -> 1024 -> 512, bf16)"] = bound(
        2 * r * d * 2 + 2 * d * f * 2 + (f + d + 2 * d) * 4, ffn_ops, "bf16")
    rows["8 _ffn_fwd_pallas2 (same rows, int8 GEMMs)"] = bound(
        2 * r * d * 2 + 2 * d * f + (f + d + 2 * d) * 4, ffn_ops, "int8")
    rows["9 quant_dot_pallas (qkv: 8192 x 512 x 1536, int8 -> bf16)"] = bound(
        r * d + d * 3 * d + r * 3 * d * 2, 2 * r * d * 3 * d, "int8")
    for name, (ms, by) in rows.items():
        print(f"row {name}: bound {ms:.5f} ms ({by})")


if __name__ == "__main__":
    main()
