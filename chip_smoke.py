#!/usr/bin/env python3
"""Chip smoke of the PyTorch/H100 port: builds the kernels, holds each
against its plain version, times them, and serves at full width.

    python3 chip_smoke.py

Needs one CUDA card and the repo checkout beside this file; without
either it exits non-zero and prints no result.  Phases, in order (any
failure raises and exits non-zero):

  1. device  — CUDA present; the card's name and power limit;
  2. build   — every kernel of the serving path from csrc/ (one nvcc per
               source, in parallel);
  3. check   — each kernel against its plain version at the serving
               path's shapes, with the stated tolerances;
  4. timing  — kernel, plain version, the library yardstick and the
               bound.  Two clocks: the device time per call (the sum of
               the kernels a call launches, torch.profiler over 25 calls;
               the JSON line's ms fields), and the time per call the
               caller sees (CUDA events, median of 25 after warm-up),
               which at these sizes is mostly Python launch cost;
  5. serve   — ``cli.run_serving`` at the default width (6 layers,
               d_model 512, 8 heads, vocab 30522, buckets 64..512, serve
               batch 8, bf16) with seeded random weights; launch counts
               set to 0 just before and read just after; then the
               per-bucket split of one batch's device time and the
               device's busy share of the host wall time;
  6. output  — p50/p99/qps, the kernels JSON line, the card line, and
               last the ok line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 FMA, HBM3
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12
REPEATS = 25


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def call_ms(fn, repeats: int = REPEATS) -> float:
    """Median CUDA-event time of one call of ``fn`` (host launch cost
    included: the card waits for the host between short kernels), over
    ``repeats`` calls after three warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", None)
                 or getattr(evt, "self_cuda_time_total", 0.0) or 0.0)


def device_kernels(fn, repeats: int):
    """{kernel name: (device microseconds, launches)} over ``repeats``
    calls of ``fn``, from torch.profiler's CUDA activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    return {e.key: (_device_us(e), e.count) for e in prof.key_averages()
            if _device_us(e) > 0}


def measure(fn) -> dict:
    """Device time per call (the sum of every kernel ``fn`` launches,
    torch.profiler; CUDA events when the profiler sees no device time)
    and the per-call time the caller sees (CUDA events)."""
    wall = call_ms(fn)
    dev = sum(us for us, _ in device_kernels(fn, REPEATS).values()
              ) / REPEATS / 1e3
    return {"ms": dev if dev > 0 else wall, "call_ms": wall,
            "timer": "profiler" if dev > 0 else "events"}


def bound(n_bytes: float, n_flops: float, kind: str):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def qkv_views(B, H, L, D, dtype, gen):
    """q/k/v as the model hands them over: strided [B, H, L, D] views of
    one fused (B, L, 3, H, D) projection."""
    import torch

    qkv = torch.randn(B, L, 3, H, D, generator=gen, device="cuda").to(dtype)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def ragged_mask(B, L, gen):
    """Key-padding mask with ragged lengths and one fully masked row."""
    import torch

    lengths = torch.randint(1, L + 1, (B,), generator=gen, device="cuda")
    mask = (torch.arange(L, device="cuda")[None, :]
            < lengths[:, None]).to(torch.int32)
    mask[1] = 0
    return mask


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    try:
        from faster_distributed_training_tpu_torch import cli
        from faster_distributed_training_tpu_torch.interop import (
            params_to_jax)
        from faster_distributed_training_tpu_torch.ops import _build
        from faster_distributed_training_tpu_torch.ops.flash_attention import (
            flash_attention, flash_attention_reference)
        from faster_distributed_training_tpu_torch.ops.fused_mlp import (
            fused_mlp, mlp_reference)
        from faster_distributed_training_tpu_torch.serve import pad_batch
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    # -- 1. device ---------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}); nvidia-smi: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build ----------------------------------------------------------
    build_s, logs = _build.build()
    print(f"[build] {len(logs)} kernel(s) compiled in {build_s:.1f}s "
          f"({', '.join(_build.KERNELS)})", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # -- 3. kernel vs plain version -----------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    err = {"flash_fwd": 0.0, "fused_mlp": 0.0}
    B, H, D = 8, 8, 64
    for L in (64, 512):
        q, k, v = qkv_views(B, H, L, D, bf16, gen)
        mask = ragged_mask(B, L, gen)
        out, lse = flash_attention(q, k, v, mask=mask, emit_lse=True)
        ref, ref_lse = flash_attention_reference(q, k, v, mask=mask,
                                                 emit_lse=True)
        torch.cuda.synchronize()
        e_out = (out.float() - ref.float()).abs().max().item()
        e_lse = (lse - ref_lse).abs().max().item()
        print(f"[check] flash bf16 L={L}: out err {e_out:.3g} (tol 2e-2), "
              f"lse err {e_lse:.3g} (tol 1e-3)")
        check(e_out <= 2e-2, f"flash bf16 L={L} out err {e_out}")
        check(e_lse <= 1e-3, f"flash bf16 L={L} lse err {e_lse}")
        err["flash_fwd"] = max(err["flash_fwd"], e_out)
    q, k, v = qkv_views(B, H, 128, D, torch.float32, gen)
    mask = ragged_mask(B, 128, gen)
    out = flash_attention(q, k, v, mask=mask, dropout_rate=0.1,
                          dropout_seed=0x9E3779B9)
    ref = flash_attention_reference(q, k, v, mask=mask, dropout_rate=0.1,
                                    dropout_seed=0x9E3779B9)
    torch.cuda.synchronize()
    e_drop = (out - ref).abs().max().item()
    print(f"[check] flash fp32 L=128 dropout 0.1: err {e_drop:.3g} "
          f"(tol 1e-5)")
    check(e_drop <= 1e-5, f"flash fp32 dropout err {e_drop}")
    err["flash_fwd"] = max(err["flash_fwd"], e_drop)
    d_in, d_h, d_out = 512, 1024, 4
    w1 = (torch.randn(d_h, d_in, generator=gen, device="cuda") * 0.05).to(bf16)
    b1 = (torch.randn(d_h, generator=gen, device="cuda") * 0.05).to(bf16)
    w2 = (torch.randn(d_out, d_h, generator=gen, device="cuda") * 0.05).to(bf16)
    b2 = (torch.randn(d_out, generator=gen, device="cuda") * 0.05).to(bf16)
    for rows in (8, 4096):
        x = torch.randn(rows, d_in, generator=gen, device="cuda").to(bf16)
        got = fused_mlp(x, w1, b1, w2, b2)
        want = mlp_reference(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        print(f"[check] mlp bf16 {rows}x{d_in}->{d_h}->{d_out}: err {e:.3g} "
              f"(tol 2e-2)")
        check(e <= 2e-2, f"mlp rows={rows} err {e}")
        err["fused_mlp"] = max(err["fused_mlp"], e)

    # -- 4. timings at the serving path's shapes ------------------------------
    L = 512
    q, k, v = qkv_views(B, H, L, D, bf16, gen)
    mask = ragged_mask(B, L, gen)
    sdpa_mask = (mask[:, None, None, :] != 0)
    fa = {"kernel": measure(lambda: flash_attention(q, k, v, mask=mask)),
          "plain": measure(
              lambda: flash_attention_reference(q, k, v, mask=mask)),
          "library": measure(lambda: F.scaled_dot_product_attention(
              q, k, v, attn_mask=sdpa_mask))}
    fa["bound_ms"], fa["bound_by"] = bound(
        4 * B * H * L * D * 2 + B * L * 4, 4 * B * H * L * L * D, "bf16")
    x = torch.randn(8, d_in, generator=gen, device="cuda").to(bf16)
    mlp = {"kernel": measure(lambda: fused_mlp(x, w1, b1, w2, b2)),
           "plain": measure(lambda: mlp_reference(x, w1, b1, w2, b2)),
           "library": measure(lambda: torch.addmm(
               b2, torch.relu(torch.addmm(b1, x, w1.T)), w2.T))}
    mlp["bound_ms"], mlp["bound_by"] = bound(
        2 * (8 * d_in + d_h * d_in + d_h + d_out * d_h + d_out + 8 * d_out),
        2 * 8 * (d_in * d_h + d_h * d_out), "bf16")
    for name, t in (("flash_fwd B8 H8 L512 D64", fa),
                    ("fused_mlp 8x512->1024->4", mlp)):
        print(f"[timing] {name}: device ms per call ({t['kernel']['timer']}"
              f"): kernel {t['kernel']['ms']:.5f}, plain "
              f"{t['plain']['ms']:.5f}, library {t['library']['ms']:.5f}; "
              f"per call incl. launch (events): kernel "
              f"{t['kernel']['call_ms']:.5f}, plain {t['plain']['call_ms']:.5f}"
              f", library {t['library']['call_ms']:.5f}; bound "
              f"{t['bound_ms']:.5f} ms ({t['bound_by']})", flush=True)

    # -- 5. serving at full width ----------------------------------------------
    defaults = cli.TRANSFORMER_DEFAULTS
    cfg = cli.config_from_args(cli.build_parser(defaults=defaults).parse_args(
        ["--device", "cuda", "--serve_requests", "64",
         "--serve_batch_size", "8"]), defaults=defaults)
    model = cli.build_model(cfg, vocab_size=30522, device="cpu")
    model.init_weights(torch.Generator().manual_seed(cfg.seed))
    params = params_to_jax(model.state_dict(), cfg.n_heads)
    requests = cli.synth_requests(64, 30522, cfg.seq_buckets, seed=cfg.seed)
    flash_attention.launches = 0
    fused_mlp.launches = 0
    t0 = time.monotonic()
    res = cli.run_serving(cfg, requests=requests, params=params)
    serve_s = time.monotonic() - t0
    launches = {"flash_fwd": flash_attention.launches,
                "fused_mlp": fused_mlp.launches}
    engines = res["engines"]
    batches_run = sum(e.calls for e in engines)
    results = res["results"]
    print(f"[serve] {res['requests']} requests, {res['batches']} batches + "
          f"{batches_run - res['batches']} warm-up, {serve_s:.1f}s wall; "
          f"launches {launches}", flush=True)
    check(res["requests"] == 64 and len(results) == 64
          and all(r is not None for r in results), "not every request answered")
    logits = np.stack(results)
    check(logits.shape == (64, cfg.num_classes), f"logits {logits.shape}")
    check(bool(np.isfinite(logits).all()), "non-finite logits")
    check(set(res["buckets"]) == set(cfg.seq_buckets),
          f"buckets served {sorted(set(res['buckets']))}")
    check(res["batches"] * cfg.serve_batch_size
          == res["requests"] + res["padded_rows"],
          "a batch was not padded to the serve batch size")
    check(launches["flash_fwd"] == cfg.n_layers * batches_run,
          f"flash launches {launches['flash_fwd']} != {cfg.n_layers} x "
          f"{batches_run} batches")
    check(launches["fused_mlp"] == batches_run,
          f"mlp launches {launches['fused_mlp']} != {batches_run} batches")
    # the same weights through the plain versions on the CPU (flash route,
    # bf16) — the reference the card's logits are held to
    engine = engines[0]
    cpu_model = cli.build_model(cfg.replace(attention="flash"),
                                vocab_size=30522, serving=True, device="cpu")
    cpu_model.load_state_dict({k: t.cpu() for k, t in
                               engine.model.state_dict().items()})
    ref_err = 0.0
    for bucket in cfg.seq_buckets:
        i = res["buckets"].index(bucket)
        batch, _ = pad_batch([SimpleNamespace(tokens=requests[i])], bucket,
                             cfg.serve_batch_size)
        single = engine.predict_batch(batch)[0]
        check(np.array_equal(single, results[i]),
              f"bucket {bucket}: single-request logits differ from the "
              f"batched ones")
        with torch.inference_mode():
            t = {n: torch.from_numpy(batch[n].astype(np.int64))
                 for n in batch}
            plain = cpu_model(t["tokens"], t["token_types"], t["mask"]
                              ).float().numpy()[0]
        ref_err = max(ref_err, float(np.abs(plain - results[i]).max()))
    print(f"[serve] batched == single-request bitwise at every bucket; "
          f"card vs CPU plain-version logits max err {ref_err:.3g} "
          f"(tol 5e-2)")
    check(ref_err <= 5e-2, f"card vs CPU logits err {ref_err}")

    # -- where a batch's time goes (after the counted run) ------------------
    for bucket in cfg.seq_buckets:
        rows = [SimpleNamespace(tokens=t) for t, b in
                zip(requests, res["buckets"]) if b == bucket]
        batch, _ = pad_batch(rows[:cfg.serve_batch_size], bucket,
                             cfg.serve_batch_size)
        n = 10
        t0 = time.perf_counter()
        for _ in range(n):
            engine.predict_batch(batch)
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
        kern = device_kernels(lambda: engine.predict_batch(batch), n)
        groups = {}
        for name, (us, _) in kern.items():
            low = name.lower()
            group = ("flash_fwd" if "flash_fwd" in low else
                     "fused_mlp" if "mlp_fwd" in low else
                     "copies" if "memcpy" in low or "memset" in low else
                     "cuBLAS gemm" if any(w in low for w in (
                         "gemm", "nvjet", "xmma", "cutlass", "sm90_"))
                     else "torch elementwise/LN/softmax")
            groups[group] = groups.get(group, 0.0) + us / n / 1e3
        busy = sum(groups.values())
        n_launch = sum(c for _, c in kern.values()) / n
        print(f"[profile] bucket {bucket}: {wall_ms:.3f} ms/batch host "
              f"wall, {n_launch:.0f} device launches/batch, device busy "
              f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}%): "
              + ", ".join(f"{g} {v:.3f}" for g, v in
                          sorted(groups.items(), key=lambda x: -x[1])))
        if bucket == max(cfg.seq_buckets):
            top = sorted(kern.items(), key=lambda x: -x[1][0])[:8]
            print("[profile] top kernels at the largest bucket (ms/batch, "
                  "launches/batch): " + "; ".join(
                      f"{k[:60]} {us / n / 1e3:.4f} x{c / n:.0f}"
                      for k, (us, c) in top))

    # -- 6. output -----------------------------------------------------------
    print(f"[serve] p50 {res['p50_ms']} ms, p99 {res['p99_ms']} ms, "
          f"{res['qps']} qps (64 requests, batch 8, 1 replica)")
    src = "faster_distributed_training_tpu_torch/csrc/"
    kernels = []
    for name, t, replaces in (
            ("flash_fwd", fa,
             "faster_distributed_training_tpu/ops/flash_attention.py:145"),
            ("fused_mlp", mlp,
             "faster_distributed_training_tpu/ops/fused_mlp.py:108")):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"{src}{name}.cu", "replaces": replaces,
                        "launches": launches[name],
                        "max_abs_err": err[name], "ms": t["kernel"]["ms"],
                        "plain_ms": t["plain"]["ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["library"]["ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
