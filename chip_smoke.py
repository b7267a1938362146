#!/usr/bin/env python3
"""Chip smoke of the PyTorch/H100 port: builds the kernels, holds each
against its plain version, times them, trains (the classifier and the
next-token LM at seq 8192) and serves at full width.

    python3 chip_smoke.py

Needs one CUDA card and the repo checkout beside this file; without
either it exits non-zero and prints no result.  Phases, in order (any
failure raises and exits non-zero):

  1. device  — CUDA present; the card's name and power limit;
  2. build   — every kernel of the training and serving paths from
               csrc/ (five sources, one nvcc each, in parallel);
  3. check   — each kernel against its plain version at the paths'
               shapes, with the stated tolerances; the backward kernels
               also for determinism (two launches, equal bits), the
               recompute route against the saved-stats route, and the
               autograd Function against the kernels' own outputs;
               quant_matmul at the record's four GEMM shapes and a ragged
               row count (int8 bitwise, E4M3 2e-2 of max |plain|), fused_ffn
               at 8192 x 512 -> 1024 -> 512 for fmt none / int8 / E4M3
               with dropout 0.1 at both sites (outputs 2e-2 of max
               |plain|, amaxes 1e-2), two launches equal bits; at long
               context (TPU rows 2 and 3: the same two flash kernels),
               path E's shape (B 4, H 8, L 8192: forward with lse, primal
               forward, backward), B 1 at L 8192 with key padding and at
               L 16384, bf16 and fp32, dropout 0.1, against the plain
               versions walked 1024 q rows at a time (bf16 outputs and
               all gradients 2e-2 / 1e-5 of max |plain|, fp32 outputs
               1e-5), two launches equal bits;
  4. timing  — kernel, plain version, the library yardstick and the
               bound.  Two clocks: the device time per call (the sum of
               the kernels a call launches, torch.profiler over 25 calls;
               the JSON line's ms fields), and the time per call the
               caller sees (CUDA events, median of 25 after warm-up);
               slice 3's rows 7, 8 (int8) and 9 (int8, E4M3) at the
               record's training shape; rows 2 and 3 at path E's shape
               (B 4, H 8, L 8192, D 64, bf16, dropout 0.1; SDPA without
               dropout as the yardstick) and row 2's primal forward at
               B 1, L 16384;
  5. train   — ``cli.run_training`` at the full width of the
               transformer_test.py record (6 layers, d_model 512, 8 heads,
               d_ff 1024, vocab 30522, batch 16, seq 512, bf16, mirror
               MADGRAD + one-cycle + clip 10, hash dropout 0.1, mixup) on
               the synthetic split at subset stride 8 (32 steps + one
               eval of 8 batches), seeded init; launch counts set to 0
               just before and read just after; then the step time, the
               tokens/s, a [profile] split of one step's device time, the
               recompute route (FDT_FLASH_SAVE_STATS=0) for 2 steps with
               its own counts, one fp32 step at reduced width on the card
               against the same step on the CPU (loss 1e-5, each grad
               leaf 1e-5 of its max |CPU grad|), and a checkpoint round
               trip on the card; then path B (``--ffn_impl pallas --quant
               int8``) at full width for 16 steps + 4 eval batches with
               its exact launch counts, one step alone (exact per-step
               launches, every amax history rolled once), its step time
               and [profile] split, an fp32 reduced-width step card vs
               CPU; then 4-step runs of path A (``--ffn_impl pallas``)
               and path C (``--quant fp8``), each with its launch counts;
               then path E: the port's shard writer packs the synthetic
               corpus at seq 8192 (4096 documents, seed 0) into a
               temporary directory, and ``cli.run_training`` trains the
               next-token LM on it (``--task lm --dataset stream``, tied
               head, the record's widths, batch 4: 8 steps + one padded
               eval batch) with exact launch counts booked onto the TPU
               rows (``flash_rows``), then its step time, tokens/s, peak
               memory and [profile] split, a 12-step fixed-batch
               learning probe and an fp32 LM step at d_model 64, L 512
               card vs CPU (held as the slice-2 step is);
  6. serve   — ``cli.run_serving`` at the default width (6 layers,
               d_model 512, 8 heads, vocab 30522, buckets 64..512, serve
               batch 8, bf16) with seeded random weights; launch counts
               set to 0 just before and read just after; then the
               per-bucket split of one batch's device time (no more
               device launches a batch than slice 1's 258) and the
               device's busy share of the host wall time; then path D,
               ``--quant int8 --ffn_impl pallas`` serving on the path-B
               weights and histories (batched == single-request bitwise,
               histories unchanged, card vs CPU plain logits 5e-2,
               launches per batch);
  7. output  — p50/p99/qps, the kernels JSON line (launches from the
               training run, the recompute route's from its own run,
               fused_ffn's from path A, fused_ffn_quant's and
               quant_matmul's from path B, rows 2 and 3's from path E;
               the serving runs' beside them),
               the card line, and last the ok line.
"""

from __future__ import annotations

import itertools
import json
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 FMA, int8
# and fp8 tensor cores, HBM3
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12,
              "fp8": 1979e12}
PEAK_BYTES = 3.35e12
REPEATS = 25
# device launches per serving batch in slice 1 (eval LayerNorm in its
# plain form); serving must not need more
SERVE_LAUNCHES = 258


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


def measure(fn, repeats: int = REPEATS) -> dict:
    """Device time per call (the sum of every kernel ``fn`` launches,
    torch.profiler; CUDA events when the profiler sees no device time)
    and the per-call time the caller sees (CUDA events), each over
    ``repeats`` calls."""
    wall = call_ms(fn, repeats)
    dev = sum(us for us, _ in device_kernels(fn, repeats).values()
              ) / repeats / 1e3
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

def kernel_group(name: str) -> str:
    """The [profile] group of a device kernel's name."""
    low = name.lower()
    if "flash_bwd" in low or "dkdv_kernel" in low or "dq_kernel" in low:
        return "flash_bwd"
    if "flash_fwd" in low:
        return "flash_fwd"
    if "mlp_fwd" in low:
        return "fused_mlp"
    if "ffn_kernel" in low:
        return "fused_ffn"
    if "qmm_" in low:
        return "quant_matmul"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass", "sm90_")):
        return "cuBLAS gemm"
    return "torch elementwise/LN/softmax/reductions"


def launches_per_call(kern: dict, n: int) -> float:
    return sum(c for _, c in kern.values()) / n


def profile_split(kern: dict, n: int, wall_ms: float, what: str) -> str:
    """One [profile] line: device ms per call by group and busy share."""
    groups = {}
    for name, (us, _) in kern.items():
        g = kernel_group(name)
        groups[g] = groups.get(g, 0.0) + us / n / 1e3
    busy = sum(groups.values())
    n_launch = launches_per_call(kern, n)
    return (f"[profile] {what}: {wall_ms:.3f} ms host wall, {n_launch:.0f} "
            f"device launches, device busy {busy:.3f} ms "
            f"({100 * busy / wall_ms:.1f}%): "
            + ", ".join(f"{g} {v:.3f}" for g, v in
                        sorted(groups.items(), key=lambda x: -x[1])))


def rel_err(got, want) -> float:
    """max |got - want| / max |want| over a tuple of tensors."""
    return max((g.float() - w.float()).abs().max().item()
               / max(w.float().abs().max().item(), 1e-30)
               for g, w in zip(got, want))


def abs_err(got, want) -> float:
    return max((g.float() - w.float()).abs().max().item()
               for g, w in zip(got, want))


def grad_err(got: dict, want: dict):
    """(max over leaves of max |got - want| / max |want|, that leaf): each
    gradient leaf held to its own scale, so a small leaf is not hidden
    under a large one's limit."""
    return max(((got[k].cpu().float() - w.float()).abs().max().item()
                / max(w.float().abs().max().item(), 1e-30), k)
               for k, w in want.items())


def check_backward(fa, gen) -> dict:
    """The backward kernels against their plain versions on the card;
    returns the largest absolute error of each route."""
    import torch

    worst = {"flash_bwd_stats": 0.0, "flash_bwd_recompute": 0.0}
    bf16 = torch.bfloat16
    for B, H, L, dtype, tol in ((16, 8, 512, bf16, 2e-2),
                                (8, 8, 64, bf16, 2e-2),
                                (8, 8, 128, torch.float32, 1e-5)):
        q, k, v = qkv_views(B, H, L, 64, dtype, gen)
        mask = ragged_mask(B, L, gen)
        out, lse, lse_lo = fa.flash_attention_stats(q, k, v, mask, 0.1,
                                                    0xC0FFEE)
        dout = torch.randn(B, H, L, 64, generator=gen, device="cuda").to(dtype)
        got = fa.flash_attention_bwd(q, k, v, out, lse, dout, mask, 0.1,
                                     0xC0FFEE, lse_lo)
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                                mask, 0.1, 0xC0FFEE, lse_lo)
        again = fa.flash_attention_bwd(q, k, v, out, lse, dout, mask, 0.1,
                                       0xC0FFEE, lse_lo)
        rec = fa.flash_attention_bwd_recompute(q, k, v, dout, mask, 0.1,
                                               0xC0FFEE)
        rec_ref = fa.flash_attention_bwd_recompute_reference(
            q, k, v, dout, mask, 0.1, 0xC0FFEE)
        torch.cuda.synchronize()
        e, e_rec = rel_err(got, want), rel_err(rec, rec_ref)
        e_routes = rel_err(rec, got)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        name = "bf16" if dtype == bf16 else "fp32"
        print(f"[check] flash bwd {name} B*H={B * H} L={L} D=64 key padding "
              f"+ dropout 0.1: stats err {e:.3g}, recompute err {e_rec:.3g}"
              f" (tol {tol:g} of max |ref|), recompute vs stats "
              f"{e_routes:.3g}; two launches bitwise equal: {same}")
        check(e <= tol and e_rec <= tol, f"flash bwd {name} L={L} err "
              f"{e} / {e_rec}")
        check(e_routes <= max(tol, 2e-2), f"routes differ {e_routes}")
        check(same, f"flash bwd {name} L={L} is not deterministic")
        worst["flash_bwd_stats"] = max(worst["flash_bwd_stats"],
                                       abs_err(got, want))
        worst["flash_bwd_recompute"] = max(worst["flash_bwd_recompute"],
                                           abs_err(rec, rec_ref))
    # the autograd Function hands back exactly the kernels' gradients
    q, k, v = qkv_views(4, 8, 256, 64, bf16, gen)
    mask = ragged_mask(4, 256, gen)
    dout = torch.randn(4, 8, 256, 64, generator=gen, device="cuda").to(bf16)
    qkv = torch.stack([t.transpose(1, 2) for t in (q, k, v)], dim=2)
    out, lse, lse_lo = fa.flash_attention_stats(q, k, v, mask, 0.1, 7)
    routes = {True: fa.flash_attention_bwd(q, k, v, out, lse, dout, mask,
                                           0.1, 7, lse_lo),
              False: fa.flash_attention_bwd_recompute(q, k, v, dout, mask,
                                                      0.1, 7)}
    for save, want in routes.items():
        leaf = qkv.detach().requires_grad_(True)
        ctx = fa.flash_attention_qkv(leaf, mask, 0.1, 7, save_stats=save)
        (dqkv,) = torch.autograd.grad(ctx, leaf, dout)
        torch.cuda.synchronize()
        check(all(torch.equal(dqkv[:, :, i].transpose(1, 2), want[i])
                  for i in range(3)),
              f"autograd grads differ from the kernels' (save_stats={save})")
    print("[check] flash_attention_qkv autograd grads == the kernels' own "
          "dq/dk/dv (bitwise), both routes")
    return worst


def train_phase(cli, fa, fused_mlp, build_dir: str) -> dict:
    """Phase 5: the training path at full width, then its measurements."""
    import shutil

    import numpy as np
    import torch

    from faster_distributed_training_tpu_torch.data.loader import BatchLoader
    from faster_distributed_training_tpu_torch.optim import build_optimizer
    from faster_distributed_training_tpu_torch.train import checkpoint as ckpt
    from faster_distributed_training_tpu_torch.train import steps as steps_mod
    from faster_distributed_training_tpu_torch.train.state import (
        create_train_state)
    from faster_distributed_training_tpu_torch.train.steps import (
        loss_and_grads, make_train_step, step_draws, to_device)

    ckdir = os.path.join(build_dir, "smoke_ckpt")
    shutil.rmtree(ckdir, ignore_errors=True)
    defaults = cli.TRANSFORMER_DEFAULTS
    stride = 8
    cfg = cli.config_from_args(cli.build_parser(defaults=defaults).parse_args(
        ["--device", "cuda", "--dataset", "synthetic", "--epoch", "1",
         "--subset_stride", str(stride), "--checkpoint_dir", ckdir,
         "--log_every", "8"]), defaults=defaults)
    train_ds = cli.apply_subset(cli.load_dataset(cfg, True), stride)
    eval_ds = cli.apply_subset(cli.load_dataset(cfg, False), stride)
    n_eval = -(-len(eval_ds) // cfg.batch_size)
    counters = (fa.flash_attention, fa.flash_attention_bwd,
                fa.flash_attention_bwd_recompute, fused_mlp)

    def reset():
        for c in counters:
            c.launches = 0

    def read():
        return dict(zip(("flash_fwd", "flash_bwd_stats",
                         "flash_bwd_recompute", "fused_mlp"),
                        (c.launches for c in counters)))

    # every step's loss, kept as a device scalar by a wrapper of the
    # step that run_training builds (no per-step sync)
    step_losses = []
    make_step = steps_mod.make_train_step

    def recording(cfg_):
        inner = make_step(cfg_)

        def run(state_, batch, draws=None):
            state_, metrics = inner(state_, batch, draws)
            step_losses.append(metrics["loss"])
            return state_, metrics
        return run

    steps_mod.make_train_step = recording
    try:
        reset()
        t0 = time.monotonic()
        out = cli.run_training(cfg, log=lambda line: print(line, flush=True))
        torch.cuda.synchronize()
        train_s = time.monotonic() - t0
        launches = read()
    finally:
        steps_mod.make_train_step = make_step
    state = out["state"]
    steps = len(step_losses)
    losses = torch.stack(step_losses).cpu().numpy()
    print(f"[train] {steps} steps + {n_eval} eval batches in {train_s:.1f}s "
          f"wall (first-use build and warm-up included); launches "
          f"{launches}", flush=True)
    check(steps == out["steps_per_epoch"] == 4096 // stride // 16,
          f"{steps} train steps")
    n_layers = cfg.n_layers
    want = {"flash_fwd": n_layers * (steps + n_eval),
            "flash_bwd_stats": n_layers * steps, "flash_bwd_recompute": 0,
            "fused_mlp": steps + n_eval}
    check(launches == want, f"launches {launches} != {want}")
    print(f"[train] per step: {n_layers} flash fwd, {n_layers} flash bwd "
          f"(saved stats), 1 fused MLP fwd; per eval batch: {n_layers} "
          f"flash fwd, 1 fused MLP fwd")
    check(bool(np.isfinite(losses).all()), "non-finite train loss")
    test_acc = out["history"]["test_acc"][0]
    print(f"[train] loss first step {losses[0]:.4f}, last step "
          f"{losses[-1]:.4f}; mean of the first 5 steps "
          f"{float(losses[:5].mean()):.4f}, of the last 5 "
          f"{float(losses[-5:].mean()):.4f}; eval accuracy {test_acc:.4f} "
          f"({len(eval_ds)} samples).  The record's recipe (MirrorMADGRAD, "
          f"one-cycle from lr/5) stays near chance for its first hundreds "
          f"of steps, as in the JAX package's own runs", flush=True)

    # step time and tokens/s on the trained state (after the counted run)
    step = make_train_step(cfg)
    loader = BatchLoader(train_ds, cfg.batch_size, epoch=1, seed=cfg.seed,
                         max_len=cfg.seq_len)
    batches = [to_device(b, "cuda") for b in itertools.islice(loader, 14)]
    for b in batches[:2]:
        step(state, b)
    times, real, padded = [], 0, 0
    for b in batches[2:12]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        real += int(b["mask"].sum())
        padded += b["mask"].numel()
    med = statistics.median(times) * 1e3
    print(f"[train] step time median {med:.2f} ms over {len(times)} steps "
          f"(batch 16, buckets {sorted({b['tokens'].shape[1] for b in batches})}); "
          f"{real / sum(times):.0f} real tokens/s, "
          f"{padded / sum(times):.0f} padded tokens/s", flush=True)
    n = 3
    wall = []
    for b in batches[12:14]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(state, b)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t) * 1e3)
    prof_batch = batches[12]
    kern = device_kernels(lambda: step(state, prof_batch), n)
    print(profile_split(kern, n, statistics.median(wall),
                        f"train step (L={prof_batch['tokens'].shape[1]})"))
    top = sorted(kern.items(), key=lambda x: -x[1][0])[:8]
    print("[profile] top kernels of a train step (ms/step, launches/step): "
          + "; ".join(f"{k[:60]} {us / n / 1e3:.4f} x{c / n:.0f}"
                      for k, (us, c) in top))

    # the loss goes down: 12 steps of the same step function, fresh
    # record optimizer (one-cycle over the 12 steps), on one fixed batch
    # with fixed draws, from the seeded init.  The counted run's own
    # losses are only held finite: its one-cycle recipe stays at chance
    # for its first hundreds of steps on this data
    probe_model = cli.build_model(cfg, vocab_size=train_ds.vocab_size(),
                                  device="cuda")
    probe_model.init_weights(torch.Generator().manual_seed(cfg.seed))
    probe_model.cuda()
    probe_tx, _ = build_optimizer(cfg, 12)
    probe = create_train_state(probe_model, probe_tx, seed=cfg.seed)
    fixed = batches[0]
    probe_draws = step_draws(cfg.seed, 0, cfg.batch_size,
                             probe_model.n_dropout_sites(), 0.99)
    probe_losses = [float(step(probe, fixed, probe_draws)[1]["loss"])
                    for _ in range(12)]
    print("[train] one fixed batch (L=" + str(fixed["tokens"].shape[1])
          + "), fixed draws, 12 steps: loss " + " ".join(
              f"{x:.4f}" for x in probe_losses), flush=True)
    check(bool(np.isfinite(probe_losses).all())
          and probe_losses[-1] < probe_losses[0],
          "the loss on a fixed batch did not go down")

    # the recompute route (JAX's _flash_bwd_pallas) on the same path
    os.environ["FDT_FLASH_SAVE_STATS"] = "0"
    try:
        reset()
        for b in batches[:2]:
            step(state, b)
        torch.cuda.synchronize()
        rec = read()
    finally:
        os.environ.pop("FDT_FLASH_SAVE_STATS")
    want = {"flash_fwd": 2 * 2 * n_layers, "flash_bwd_stats": 0,
            "flash_bwd_recompute": 2 * n_layers, "fused_mlp": 2}
    print(f"[train] recompute route (FDT_FLASH_SAVE_STATS=0), 2 steps: "
          f"launches {rec}")
    check(rec == want, f"recompute-route launches {rec} != {want}")

    # one fp32 step at reduced width: the card against the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    small = cfg.replace(n_layers=2, d_model=64, n_heads=4, d_ff=128,
                        seq_len=64, precision="fp32", attention="flash")
    m_cpu = cli.build_model(small, vocab_size=100, device="cpu")
    m_cpu.init_weights(torch.Generator().manual_seed(5))
    m_gpu = cli.build_model(small, vocab_size=100, device="cuda")
    m_gpu.load_state_dict(m_cpu.state_dict())
    m_gpu.cuda()
    rng = np.random.default_rng(11)
    lengths = rng.integers(4, 65, size=8)
    mask = (np.arange(64)[None] < lengths[:, None]).astype(np.int32)
    labels = rng.integers(0, 4, size=8).astype(np.int32)
    tokens = (rng.integers(1, 100, size=(8, 64)) * mask).astype(np.int32)
    batch = {"tokens": tokens, "token_types": np.zeros_like(tokens),
             "mask": mask, "label": labels}
    draws = step_draws(0, 0, 8, m_cpu.n_dropout_sites(), 0.99)
    l_c, g_c, *_ = loss_and_grads(m_cpu, to_device(batch, "cpu"), draws)
    l_g, g_g, *_ = loss_and_grads(m_gpu, to_device(batch, "cuda"), draws)
    l_g, l_c = l_g.item(), l_c.item()
    e_loss = abs(l_g - l_c)
    e_grad, leaf = grad_err(g_g, g_c)
    print(f"[train] fp32 step at d_model 64 x 2 layers, card vs CPU, same "
          f"weights/batch/draws, TF32 off: loss {l_g:.6f} vs "
          f"{l_c:.6f} (err {e_loss:.3g}, tol 1e-5), grads max err "
          f"{e_grad:.3g} of the leaf's max |CPU grad| ({leaf}; tol 1e-5)")
    check(e_loss <= 1e-5 and e_grad <= 1e-5, "card step differs from CPU")

    # checkpoint round trip on the card
    ckpt.save_checkpoint(ckdir, "roundtrip", state, 0, 0.5,
                         step_in_epoch=3)
    fresh_model = cli.build_model(cfg, vocab_size=train_ds.vocab_size(),
                                  device="cuda")
    fresh_model.init_weights(torch.Generator().manual_seed(999))
    fresh_model.cuda()
    tx, _ = build_optimizer(cfg, out["steps_per_epoch"])
    fresh = create_train_state(fresh_model, tx, seed=1)
    fresh, meta = ckpt.restore_checkpoint(ckdir, "roundtrip", fresh)
    same = (fresh.step == state.step and fresh.seed == state.seed
            and all(torch.equal(a, b) for a, b in zip(
                fresh.model.state_dict().values(),
                state.model.state_dict().values()))
            and all(torch.equal(fresh.opt_state[p][k], state.opt_state[p][k])
                    for p in ("v", "z") for k in state.opt_state[p]))
    print(f"[train] checkpoint save/restore on the card: identical state "
          f"{same} (step {fresh.step}, meta {meta})")
    check(same, "restored state differs")
    shutil.rmtree(ckdir, ignore_errors=True)
    return {"launches": launches, "recompute_launches": rec,
            "step_ms": med, "loss_first": probe_losses[0],
            "loss_last": probe_losses[-1], "test_acc": test_acc}


# -- slice 3: the quantized GEMM and the fused FFN -------------------------

# the record's quantized GEMMs at batch 16 x 512 tokens: (rows, K, N)
QMM_SHAPES = {"qkv": (8192, 512, 1536), "out": (8192, 512, 512),
              "Dense_0": (8192, 512, 1024), "Dense_1": (8192, 1024, 512)}
FFN_SHAPE = (8192, 512, 1024)      # rows, d_model, d_ff


def quant_operands(gen, M, K, N, fmt):
    """Quantized x [M, K], w [N, K] at scales that fill the grid, as
    device tensors."""
    import torch

    from faster_distributed_training_tpu_torch.ops.quant import (
        QMAX, quantize)

    x = torch.randn(M, K, generator=gen, device="cuda")
    w = torch.randn(N, K, generator=gen, device="cuda") * 0.05
    sx = torch.tensor(QMAX[fmt] / 4.0, device="cuda")
    sw = torch.tensor(QMAX[fmt] / 0.2, device="cuda")
    return quantize(x, sx, fmt), quantize(w, sw, fmt), sx, sw


def ffn_inputs(gen, rows, d, d_ff, dtype):
    import torch

    h = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    ln_s = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    ln_b = 0.1 * torch.randn(d, generator=gen, device="cuda")
    w1 = (torch.randn(d_ff, d, generator=gen, device="cuda")
          / d ** 0.5).to(dtype)
    b1 = (0.1 * torch.randn(d_ff, generator=gen, device="cuda")).to(dtype)
    w2 = (torch.randn(d, d_ff, generator=gen, device="cuda")
          / d_ff ** 0.5).to(dtype)
    b2 = (0.1 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
    return h, ln_s, ln_b, w1, b1, w2, b2


FFN_SCALES = (30.0, 300.0, 60.0, 250.0)
FFN_SEEDS = (0x1234567, 0x89ABCDE, 0, 0, 0)


def check_quant_kernels(gen) -> dict:
    """quant_matmul at the record's four GEMM shapes and one ragged row
    count (int8 bitwise, E4M3 within 2e-2 of max |plain|), fused_ffn at
    the record's shape for fmt none / int8 / E4M3 with dropout 0.1 at both
    sites (2e-2 of max |plain|; amaxes within 1e-2); two launches give
    equal bits.  Returns the largest absolute error of each kernel."""
    import torch

    from faster_distributed_training_tpu_torch.ops.fused_ffn import (
        _ffn_body_reference, ffn_fwd_generalized)
    from faster_distributed_training_tpu_torch.ops.quant import (
        quant_dot_reference, quant_matmul)

    worst = {"quant_matmul": 0.0, "quant_matmul_e4m3": 0.0, "fused_ffn": 0.0,
             "fused_ffn_quant": 0.0}
    bf16 = torch.bfloat16
    shapes = dict(QMM_SHAPES, ragged=(1000, 512, 1536))
    for fmt in ("int8", "fp8"):
        for name, (M, K, N) in shapes.items():
            xq, wq, sx, sw = quant_operands(gen, M, K, N, fmt)
            got = quant_matmul(xq, wq, sx, sw, fmt, bf16)
            again = quant_matmul(xq, wq, sx, sw, fmt, bf16)
            want = quant_dot_reference(xq, wq, sx, sw, fmt, bf16)
            torch.cuda.synchronize()
            same = torch.equal(got, again)
            e = (got.float() - want.float()).abs().max().item()
            rel = e / max(want.float().abs().max().item(), 1e-30)
            if fmt == "int8":
                ok = torch.equal(got, want)
                note = f"bitwise equal to plain: {ok}"
            else:
                ok = rel <= 2e-2
                note = f"err {rel:.3g} of max |plain| (tol 2e-2)"
            print(f"[check] quant_matmul {fmt} {name} {M}x{K}->{N} bf16: "
                  f"{note}; abs err {e:.3g}; two launches bitwise equal: "
                  f"{same}")
            check(ok and same, f"quant_matmul {fmt} {name}")
            key = "quant_matmul" if fmt == "int8" else "quant_matmul_e4m3"
            worst[key] = max(worst[key], e)
    rows, d, d_ff = FFN_SHAPE
    args = ffn_inputs(gen, rows, d, d_ff, bf16)
    scales = torch.tensor(FFN_SCALES, device="cuda")
    for fmt in (None, "int8", "fp8"):
        def run():
            return ffn_fwd_generalized(*args, FFN_SEEDS, scales, 0.1, 0.1,
                                       1e-6, 1, 1, d_ff, fmt)
        out, amax = run()
        out2, amax2 = run()
        quant = None if fmt is None else (fmt, *scales.unbind(), None)
        want, want_amax = _ffn_body_reference(
            *args, FFN_SEEDS[0], FFN_SEEDS[1], 0.1, 0.1, 1e-6, quant=quant,
            return_amax=True, plain_gemm=True)
        torch.cuda.synchronize()
        same = torch.equal(out, out2) and torch.equal(amax, amax2)
        e = (out.float() - want.float()).abs().max().item()
        rel = e / want.float().abs().max().item()
        e_amax = ((amax - want_amax).abs() / want_amax.clamp(min=1e-30)
                  ).max().item() if fmt else float(amax.abs().max())
        print(f"[check] fused_ffn {fmt or 'none'} bf16 {rows}x{d}->{d_ff}->"
              f"{d}, dropout 0.1 at both sites: err {rel:.3g} of max "
              f"|plain| (tol 2e-2), abs {e:.3g}; amax {amax.tolist()} vs "
              f"{want_amax.tolist()} (rel err {e_amax:.3g}, tol 1e-2); two "
              f"launches bitwise equal: {same}")
        check(rel <= 2e-2 and e_amax <= 1e-2 and same, f"fused_ffn {fmt}")
        key = "fused_ffn" if fmt is None else "fused_ffn_quant"
        worst[key] = max(worst[key], e)
    return worst


def library(fn):
    """measure() of a library yardstick, or None (printed) when this
    torch build refuses the call: the yardstick is no part of the port."""
    try:
        return measure(fn)
    except Exception as e:
        print(f"[timing] library yardstick unavailable: {e}")
        return None


def time_quant_kernels(gen) -> dict:
    """Rows 7, 8 (int8) and 9 (int8, E4M3) at the record's training
    shape: kernel, plain, library yardstick, bound."""
    import torch

    from faster_distributed_training_tpu_torch.ops.fused_ffn import (
        _ffn_body_reference, ffn_fwd_generalized)
    from faster_distributed_training_tpu_torch.ops.quant import (
        quant_dot_reference, quant_matmul, quantize)

    bf16 = torch.bfloat16
    out = {}
    M, K, N = QMM_SHAPES["qkv"]
    for fmt in ("int8", "fp8"):
        xq, wq, sx, sw = quant_operands(gen, M, K, N, fmt)
        t = {"kernel": measure(lambda: quant_matmul(xq, wq, sx, sw, fmt,
                                                    bf16)),
             "plain": measure(lambda: quant_dot_reference(xq, wq, sx, sw,
                                                          fmt, bf16))}
        if fmt == "int8":
            t["library"] = library(lambda: torch._int_mm(xq, wq.t()))
        else:
            inv_x, inv_w = (1.0 / sx).reshape(()), (1.0 / sw).reshape(())
            t["library"] = library(lambda: torch._scaled_mm(
                xq, wq.t(), scale_a=inv_x, scale_b=inv_w, out_dtype=bf16))
        t["bound_ms"], t["bound_by"] = bound(M * K + N * K + 2 * M * N,
                                             2 * M * K * N, fmt)
        out["quant_matmul" if fmt == "int8" else "quant_matmul_e4m3"] = t
    rows, d, d_ff = FFN_SHAPE
    args = ffn_inputs(gen, rows, d, d_ff, bf16)
    scales = torch.tensor(FFN_SCALES, device="cuda")
    f = torch.randn(rows, d, generator=gen, device="cuda").to(bf16)
    a = torch.randn(rows, d_ff, generator=gen, device="cuda").to(bf16)
    fq = quantize(f, scales[0], "int8")
    aq = quantize(a, scales[2], "int8")
    w1q = quantize(args[3], scales[1], "int8")
    w2q = quantize(args[5], scales[3], "int8")
    for name, fmt in (("fused_ffn", None), ("fused_ffn_quant", "int8")):
        quant = None if fmt is None else (fmt, *scales.unbind(), None)
        t = {"kernel": measure(lambda: ffn_fwd_generalized(
                 *args, FFN_SEEDS, scales, 0.1, 0.1, 1e-6, 1, 1, d_ff, fmt)),
             "plain": measure(lambda: _ffn_body_reference(
                 *args, FFN_SEEDS[0], FFN_SEEDS[1], 0.1, 0.1, 1e-6,
                 quant=quant, return_amax=True, plain_gemm=True))}
        # no one call computes the sublayer: the yardstick is its two
        # cuBLAS GEMMs alone (marked so in the output)
        if fmt is None:
            t["library"] = library(lambda: (torch.matmul(f, args[3].t()),
                                            torch.matmul(a, args[5].t())))
        else:
            t["library"] = library(lambda: (torch._int_mm(fq, w1q.t()),
                                            torch._int_mm(aq, w2q.t())))
        w_bytes = 2 if fmt is None else 1
        # read h, both weight matrices, the biases and LN parameters once;
        # write the output (and two amaxes)
        t["bound_ms"], t["bound_by"] = bound(
            2 * rows * d * 2 + 2 * d * d_ff * w_bytes + 2 * (d_ff + d)
            + 8 * d + 8, 4 * rows * d * d_ff, "bf16" if fmt is None else fmt)
        out[name] = t
    for name, t in out.items():
        lib = t["library"]
        print(f"[timing] {name}: device ms per call ({t['kernel']['timer']})"
              f": kernel {t['kernel']['ms']:.5f}, plain "
              f"{t['plain']['ms']:.5f}, library "
              + (f"{lib['ms']:.5f}" if lib else "n/a")
              + (" (two cuBLAS GEMMs only)" if name.startswith("fused_ffn")
                 else "")
              + f"; per call incl. launch (events): kernel "
              f"{t['kernel']['call_ms']:.5f}, plain "
              f"{t['plain']['call_ms']:.5f}; bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']})", flush=True)
    return out


def counted_wrappers():
    """Every kernel wrapper of the port and its launch count
    (``flash_fwd`` counts every forward launch, ``flash_fwd_stats`` the
    ones whose lse a backward takes)."""
    from faster_distributed_training_tpu_torch.ops import flash_attention as fa
    from faster_distributed_training_tpu_torch.ops import fused_ffn as ffn
    from faster_distributed_training_tpu_torch.ops.fused_mlp import fused_mlp
    from faster_distributed_training_tpu_torch.ops.quant import quant_matmul

    return {"flash_fwd": fa.flash_attention,
            "flash_fwd_stats": fa.flash_attention_stats,
            "flash_bwd_stats": fa.flash_attention_bwd,
            "flash_bwd_recompute": fa.flash_attention_bwd_recompute,
            "fused_mlp": fused_mlp, "fused_ffn": ffn.ffn_fwd,
            "fused_ffn_quant": ffn.ffn_fwd_generalized,
            "quant_matmul": quant_matmul}


def reset_counts():
    for fn in counted_wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in counted_wrappers().items()}


def path_counts(n_layers: int, fwd: int, steps: int, ffn: str,
                quant: bool, train_fwd: int = None) -> dict:
    """Exact launches of ``fwd`` forwards and ``steps`` backwards on a
    path: ffn "flax" or "pallas", quant on or off; ``train_fwd`` of the
    forwards are training forwards (their lse saved; default ``steps``)."""
    per_fwd_q = (2 if ffn == "pallas" else 4) * n_layers if quant else 0
    per_bwd_q = 2 * n_layers if (quant and ffn == "pallas") else 0
    train_fwd = steps if train_fwd is None else train_fwd
    return {"flash_fwd": n_layers * fwd,
            "flash_fwd_stats": n_layers * train_fwd,
            "flash_bwd_stats": n_layers * steps,
            "flash_bwd_recompute": 0, "fused_mlp": fwd,
            "fused_ffn": n_layers * fwd if (ffn == "pallas" and not quant)
            else 0,
            "fused_ffn_quant": n_layers * fwd if (ffn == "pallas" and quant)
            else 0,
            "quant_matmul": per_fwd_q * fwd + per_bwd_q * steps}


def run_path(cli, flags, stride: int, build_dir: str, tag: str):
    """``cli.run_training`` at the record's full width with ``flags`` on
    the synthetic split at ``stride``; counts set to 0 just before and
    read just after.  Returns (out, launches, losses, steps, n_eval)."""
    import shutil

    import torch

    from faster_distributed_training_tpu_torch.train import steps as steps_mod

    ckdir = os.path.join(build_dir, f"smoke_ckpt_{tag}")
    shutil.rmtree(ckdir, ignore_errors=True)
    defaults = cli.TRANSFORMER_DEFAULTS
    cfg = cli.config_from_args(cli.build_parser(defaults=defaults).parse_args(
        ["--device", "cuda", "--dataset", "synthetic", "--epoch", "1",
         "--subset_stride", str(stride), "--checkpoint_dir", ckdir,
         "--log_every", "8", *flags]), defaults=defaults)
    step_losses = []
    make_step = steps_mod.make_train_step

    def recording(cfg_):
        inner = make_step(cfg_)

        def run(state_, batch, draws=None):
            state_, metrics = inner(state_, batch, draws)
            step_losses.append(metrics["loss"])
            return state_, metrics
        return run

    steps_mod.make_train_step = recording
    try:
        reset_counts()
        t0 = time.monotonic()
        out = cli.run_training(cfg, log=lambda line: print(line, flush=True))
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = read_counts()
    finally:
        steps_mod.make_train_step = make_step
    shutil.rmtree(ckdir, ignore_errors=True)
    steps = len(step_losses)
    n_eval = -(-(1024 // stride) // cfg.batch_size)
    losses = torch.stack(step_losses).cpu().numpy()
    print(f"[train {tag}] {' '.join(flags)}: {steps} steps + {n_eval} eval "
          f"batches in {wall:.1f}s wall; launches {launches}", flush=True)
    check(bool((losses == losses).all()) and bool(abs(losses).max() < 1e4),
          f"{tag}: non-finite train loss")
    return out, launches, losses, steps, n_eval


def train_quant_phase(cli, build_dir: str) -> dict:
    """Path B (``--ffn_impl pallas --quant int8``) at full width with its
    per-step launches, history rolls, a [profile] split and an fp32 step
    card vs CPU; then short runs of path A (``--ffn_impl pallas``) and
    path C (``--quant fp8``), each with its own launch counts."""
    import numpy as np
    import torch

    from faster_distributed_training_tpu_torch.data.loader import BatchLoader
    from faster_distributed_training_tpu_torch.train.steps import (
        loss_and_grads, make_train_step, step_draws, to_device)

    flags_b = ["--ffn_impl", "pallas", "--quant", "int8"]
    out, launches, losses, steps, n_eval = run_path(cli, flags_b, 16,
                                                    build_dir, "B")
    cfg = out["cfg"]
    L = cfg.n_layers
    # one seeding forward (the JAX init's, a training forward) + every
    # step + every eval batch
    want = path_counts(L, 1 + steps + n_eval, steps, "pallas", True,
                       train_fwd=1 + steps)
    check(launches == want, f"path B launches {launches} != {want}")
    print(f"[train B] launches == the path's exact counts {want} (1 "
          f"seeding forward + {steps} steps + {n_eval} eval batches); loss "
          f"first {losses[0]:.4f}, last {losses[-1]:.4f}")
    state = out["state"]
    model = state.model
    hists = {n: b for n, b in model.named_buffers() if "amax_history" in n}
    check(len(hists) == 8 * L, f"{len(hists)} amax histories")
    check(all(bool((h > 0).all()) for h in hists.values()),
          "an amax history holds a zero after 16 steps")

    # one more step alone: exact per-step launches, every history rolled
    # exactly once with a nonzero amax
    step = make_train_step(cfg)
    train_ds = cli.apply_subset(cli.load_dataset(cfg, True), 16)
    loader = BatchLoader(train_ds, cfg.batch_size, epoch=1, seed=cfg.seed,
                         max_len=cfg.seq_len)
    batches = [to_device(b, "cuda") for b in itertools.islice(loader, 8)]
    before = {n: h.clone() for n, h in hists.items()}
    reset_counts()
    step(state, batches[0])
    torch.cuda.synchronize()
    per_step = read_counts()
    want_step = path_counts(L, 1, 1, "pallas", True)
    check(per_step == want_step, f"per-step launches {per_step} != "
          f"{want_step}")
    rolled = all(torch.equal(h[1:], before[n][:-1]) and h[0].item() > 0
                 for n, h in hists.items())
    check(rolled, "a history did not roll exactly once in a step")
    print(f"[train B] one step: launches {per_step} (fused_ffn_quant "
          f"{per_step['fused_ffn_quant']}, quant_matmul "
          f"{per_step['quant_matmul']} = {2 * L} forward (qkv, out) + "
          f"{2 * L} in the FFN recompute, flash fwd/bwd "
          f"{per_step['flash_fwd']}/{per_step['flash_bwd_stats']}); all "
          f"{len(hists)} histories rolled once, newest amax > 0")

    # step time and the profile of one step
    for b in batches[1:3]:
        step(state, b)
    times = []
    for b in batches[3:7]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    med = statistics.median(times)
    prof_batch = batches[7]
    n = 3
    kern = device_kernels(lambda: step(state, prof_batch), n)
    print(f"[train B] step time median {med:.2f} ms over {len(times)} steps")
    print(profile_split(kern, n, med, f"train step path B "
                        f"(L={prof_batch['tokens'].shape[1]})"))
    top = sorted(kern.items(), key=lambda x: -x[1][0])[:10]
    print("[profile] top kernels of a path-B step (ms/step, launches/step): "
          + "; ".join(f"{k[:60]} {us / n / 1e3:.4f} x{c / n:.0f}"
                      for k, (us, c) in top))

    # one fp32 step at reduced width, card against CPU
    small = cfg.replace(n_layers=2, d_model=64, n_heads=4, d_ff=128,
                        seq_len=64, precision="fp32", attention="flash")
    m_cpu = cli.build_model(small, vocab_size=100, device="cpu")
    m_cpu.init_weights(torch.Generator().manual_seed(5))
    rng = np.random.default_rng(11)
    lengths = rng.integers(4, 65, size=8)
    mask = (np.arange(64)[None] < lengths[:, None]).astype(np.int32)
    labels = rng.integers(0, 4, size=8).astype(np.int32)
    tokens = (rng.integers(1, 100, size=(8, 64)) * mask).astype(np.int32)
    batch = {"tokens": tokens, "token_types": np.zeros_like(tokens),
             "mask": mask, "label": labels}
    draws = step_draws(0, 0, 8, m_cpu.n_dropout_sites(), 0.99)
    m_cpu.seed_amax_histories(8, 64, draws)
    m_gpu = cli.build_model(small, vocab_size=100, device="cuda")
    m_gpu.load_state_dict(m_cpu.state_dict())
    m_gpu.cuda()
    l_c, g_c, *_ = loss_and_grads(m_cpu, to_device(batch, "cpu"), draws)
    l_g, g_g, *_ = loss_and_grads(m_gpu, to_device(batch, "cuda"), draws)
    l_g, l_c = l_g.item(), l_c.item()
    e_loss = abs(l_g - l_c)
    e_grad = max((g_g[k].cpu() - g_c[k]).abs().max().item() for k in g_c)
    e_hist = max((b.cpu() - m_cpu.state_dict()[n]).abs().max().item()
                 for n, b in m_gpu.named_buffers() if "amax_history" in n)
    print(f"[train B] fp32 step at d_model 64 x 2 layers, --ffn_impl pallas "
          f"--quant int8, card vs CPU, same weights/histories/batch/draws: "
          f"loss {l_g:.6f} vs {l_c:.6f} (err {e_loss:.3g}, tol 1e-4), grads "
          f"max err {e_grad:.3g} (tol 1e-3), histories max err {e_hist:.3g}"
          f" (tol 1e-5)")
    check(e_loss <= 1e-4 and e_grad <= 1e-3 and e_hist <= 1e-5,
          "path B card step differs from CPU")

    # short runs of path A and path C (fp8)
    short = {}
    for tag, flags, ffn, quant in (("A", ["--ffn_impl", "pallas"], "pallas",
                                    False),
                                   ("C", ["--quant", "fp8"], "flax", True)):
        # stride 64: 4 steps, the fewest at which the record's one-cycle
        # schedule is finite (optax's, copied: NaN below 4 steps a run)
        _, got, l_short, s_steps, s_eval = run_path(cli, flags, 64,
                                                    build_dir, tag)
        n_fwd = s_steps + s_eval + (1 if quant else 0)
        want = path_counts(L, n_fwd, s_steps, ffn, quant,
                           train_fwd=s_steps + (1 if quant else 0))
        check(got == want, f"path {tag} launches {got} != {want}")
        print(f"[train {tag}] launches == the path's exact counts; losses "
              + " ".join(f"{x:.4f}" for x in l_short))
        short[tag] = got
    return {"launches": launches, "per_step": per_step, "step_ms": med,
            "state": state, "short": short}


def serve_quant_phase(cli, state) -> dict:
    """Path D: ``--quant int8 --ffn_impl pallas`` serving on the weights
    and histories of the path-B run."""
    import numpy as np
    import torch

    from faster_distributed_training_tpu_torch.interop import (
        batch_stats_to_jax, params_to_jax)
    from faster_distributed_training_tpu_torch.serve import pad_batch

    defaults = cli.TRANSFORMER_DEFAULTS
    cfg = cli.config_from_args(cli.build_parser(defaults=defaults).parse_args(
        ["--device", "cuda", "--serve_requests", "32", "--serve_batch_size",
         "8", "--quant", "int8", "--ffn_impl", "pallas"]), defaults=defaults)
    sd = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    bundle = {"params": params_to_jax(sd, cfg.n_heads),
              "batch_stats": batch_stats_to_jax(sd)}
    requests = cli.synth_requests(32, 30522, cfg.seq_buckets, seed=7)
    reset_counts()
    res = cli.run_serving(cfg, requests=requests, params=bundle)
    launches = read_counts()
    engine = res["engines"][0]
    batches_run = sum(e.calls for e in res["engines"])
    results = res["results"]
    check(len(results) == 32 and all(r is not None and np.isfinite(r).all()
                                     for r in results), "quant serving")
    want = {"flash_fwd": 6 * batches_run, "fused_ffn_quant": 6 * batches_run,
            "quant_matmul": 12 * batches_run, "fused_mlp": batches_run}
    got = {k: launches[k] for k in want}
    check(got == want and launches["flash_bwd_stats"] == 0
          and launches["flash_fwd_stats"] == 0
          and launches["fused_ffn"] == 0, f"quant serve launches {launches}")
    hist_same = all(torch.equal(b.cpu(), sd[n]) for n, b in
                    engine.model.named_buffers() if "amax_history" in n)
    check(hist_same, "serving moved an amax history")
    served = sorted(set(res["buckets"]))
    for bucket in served:
        i = res["buckets"].index(bucket)
        batch, _ = pad_batch([SimpleNamespace(tokens=requests[i])], bucket,
                             cfg.serve_batch_size)
        check(np.array_equal(engine.predict_batch(batch)[0], results[i]),
              f"quant serve bucket {bucket}: single != batched")
    # the plain versions on the CPU at the smallest bucket
    cpu_model = cli.build_model(cfg.replace(attention="flash"),
                                vocab_size=30522, serving=True, device="cpu")
    cpu_model.load_state_dict({k: t.cpu() for k, t in
                               engine.model.state_dict().items()})
    bucket = served[0]
    i = res["buckets"].index(bucket)
    batch, _ = pad_batch([SimpleNamespace(tokens=requests[i])], bucket,
                         cfg.serve_batch_size)
    with torch.inference_mode():
        t = {n: torch.from_numpy(batch[n].astype(np.int64)) for n in batch}
        plain = cpu_model(t["tokens"], t["token_types"], t["mask"]
                          ).float().numpy()[0]
    err = float(np.abs(plain - results[i]).max())
    per_batch = {k: v / batches_run for k, v in got.items()}
    print(f"[serve D] --quant int8 --ffn_impl pallas on the path-B weights "
          f"and histories: {res['requests']} requests, {res['batches']} "
          f"batches + {batches_run - res['batches']} warm-up; kernel "
          f"launches per batch {per_batch}; batched == single-request "
          f"bitwise at every bucket; histories unchanged: {hist_same}; card "
          f"vs CPU plain logits at bucket {bucket}: max err {err:.3g} (tol "
          f"5e-2); p50 {res['p50_ms']} ms, p99 {res['p99_ms']} ms, "
          f"{res['qps']} qps")
    check(err <= 5e-2, f"quant serve card vs CPU err {err}")
    n = 10
    top = served[-1]
    batch, _ = pad_batch([SimpleNamespace(tokens=t) for t, b in
                          zip(requests, res["buckets"]) if b == top][:8],
                         top, 8)
    t0 = time.perf_counter()
    for _ in range(n):
        engine.predict_batch(batch)
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kern = device_kernels(lambda: engine.predict_batch(batch), n)
    print(profile_split(kern, n, wall_ms, f"serve path D bucket {top} "
                        "(per batch)"))
    return {"launches": launches}


# -- slice 4: long context (TPU rows 2 and 3) -------------------------------

# The JAX package picks its flash kernels by shape (ops/flash_attention.py:
# _flash_fwd :606-624, _flash_bwd :997-1003, _flash_impl :567-585): a
# forward under grad whose Lk*D is past the monolithic backward's envelope
# (4096*64) runs the k-blocked forward (row 2) and its backward the
# k-blocked backward (row 3), else rows 1 and 4; a primal (eval) forward
# runs the monolithic kernel (row 1) up to Lk*D = 8192*64 and the k-blocked
# one (row 2) past it.  The port launches the same two kernels for all of
# them; flash_rows() books a path's launches onto the TPU rows that way.
BWD_ENVELOPE = 4096 * 64
FWD_ENVELOPE = 8192 * 64
LONG = {"B": 4, "H": 8, "L": 8192, "D": 64}     # path E's attention shape
Q_CHUNK = 1024                                  # plain versions' row chunk
PROBE_FALL = 1.0            # least fall of path E's fixed-batch probe (nat)


def flash_rows(counts: dict, lk: int, d: int) -> dict:
    """{TPU row: launches} of one path's flash counts at key length lk."""
    grad_fwd = counts["flash_fwd_stats"]
    primal = counts["flash_fwd"] - grad_fwd
    long_bwd = lk * d > BWD_ENVELOPE
    rows = {1: 0, 2: 0, 3: 0, 4: 0}
    rows[2 if long_bwd else 1] += grad_fwd
    rows[2 if lk * d > FWD_ENVELOPE else 1] += primal
    rows[3 if long_bwd else 4] += counts["flash_bwd_stats"]
    return rows


def check_long_kernels(fa, gen) -> dict:
    """The long-context kernels against the plain versions run a q-row
    chunk at a time, dropout 0.1, bf16 and fp32: path E's own shape (B 4,
    H 8, L 8192, no padding: forward with lse, its eval's primal forward,
    backward), B 1 at L 8192 with key padding (forward, backward) and at
    L 16384 (forward with lse, primal).  Two launches give equal bits.
    bf16 outputs are held to 2e-2 of max |plain| (|out| shrinks as
    1/sqrt(L): an absolute limit sized at L 512 would be as large as the
    values here), fp32 to 1e-5 absolute, gradients to max |plain| in both.
    Returns the largest absolute errors."""
    import torch

    worst = {"flash_fwd_kblocked": 0.0, "flash_bwd_kblocked": 0.0}
    H, D = LONG["H"], LONG["D"]
    # (B, L, key padding, primal forward, backward)
    cases = ((LONG["B"], LONG["L"], False, True, True),
             (1, 8192, True, False, True),
             (1, 16384, False, True, False))
    for dtype, tol, lse_tol in ((torch.bfloat16, 2e-2, 1e-4),
                                (torch.float32, 1e-5, 1e-5)):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        for B, L, padded, primal, backward in cases:
            what = (f"{name} B{B} H{H} L={L} D{D} dropout 0.1"
                    + (" + key padding" if padded else ""))
            q, k, v = qkv_views(B, H, L, D, dtype, gen)
            # ragged key padding with no fully masked row, or none (path
            # E's packed rows)
            mask = ((torch.arange(L, device="cuda")[None] < 8000).int()
                    if padded else None)
            got = fa.flash_attention_stats(q, k, v, mask, 0.1, 0xBEEF)
            again = fa.flash_attention_stats(q, k, v, mask, 0.1, 0xBEEF)
            want = fa.flash_attention_stats_reference(
                q, k, v, mask, 0.1, 0xBEEF, Q_CHUNK)
            torch.cuda.synchronize()
            outs = [("forward with lse", got[0], again[0], want[0])]
            if primal:              # an eval forward: no dropout, no lse
                outs.append(("primal forward", fa.flash_attention(q, k, v),
                             fa.flash_attention(q, k, v),
                             fa.flash_attention_reference(
                                 q, k, v, q_chunk=Q_CHUNK)))
            e_lse = (got[1] - want[1]).abs().max().item()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            ok = e_lse <= lse_tol
            notes = []
            for kind, o, o2, w in outs:
                e_abs = abs_err((o,), (w,))
                e = rel_err((o,), (w,)) if dtype == torch.bfloat16 else e_abs
                same = same and torch.equal(o, o2)
                ok = ok and e <= tol
                notes.append(f"{kind} out err {e:.3g}"
                             + (f" of max |plain| (abs {e_abs:.3g})"
                                if dtype == torch.bfloat16 else " abs"))
                worst["flash_fwd_kblocked"] = max(
                    worst["flash_fwd_kblocked"], e_abs)
            print(f"[check] long flash fwd {what}: {'; '.join(notes)} (tol "
                  f"{tol:g}); lse err {e_lse:.3g} (tol {lse_tol:g}); two "
                  f"launches bitwise equal: {same}", flush=True)
            check(ok and same, f"long flash fwd {what}")
            if not backward:
                continue
            out, lse, lse_lo = got
            dout = torch.randn(B, H, L, D, generator=gen,
                               device="cuda").to(dtype)
            g = fa.flash_attention_bwd(q, k, v, out, lse, dout, mask, 0.1,
                                       0xBEEF, lse_lo)
            g2 = fa.flash_attention_bwd(q, k, v, out, lse, dout, mask, 0.1,
                                        0xBEEF, lse_lo)
            ref = fa.flash_attention_bwd_reference(
                q, k, v, out, lse, dout, mask, 0.1, 0xBEEF, lse_lo,
                q_chunk=Q_CHUNK)
            torch.cuda.synchronize()
            e = rel_err(g, ref)
            same = all(torch.equal(a, b) for a, b in zip(g, g2))
            print(f"[check] long flash bwd {what}: dq/dk/dv err {e:.3g} of "
                  f"max |plain| (tol {tol:g}, abs {abs_err(g, ref):.3g}); "
                  f"two launches bitwise equal: {same}", flush=True)
            check(e <= tol and same, f"long flash bwd {what}")
            worst["flash_bwd_kblocked"] = max(worst["flash_bwd_kblocked"],
                                              abs_err(g, ref))
            del g, g2, ref, dout
        torch.cuda.empty_cache()
    return worst


def time_long_kernels(fa, gen) -> dict:
    """Rows 2 and 3 at path E's shape (B 4, H 8, L 8192, D 64, bf16,
    dropout 0.1, no padding), and row 2's primal forward at B 1, L 16384:
    kernel, plain (q-row chunked, 3 calls), SDPA (no dropout: its dropout
    is not the hash stream) and the bound."""
    import torch
    import torch.nn.functional as F

    B, H, L, D = LONG["B"], LONG["H"], LONG["L"], LONG["D"]
    q, k, v = qkv_views(B, H, L, D, torch.bfloat16, gen)
    N, nld = B * H, B * H * L * D
    fwd = {"kernel": measure(lambda: fa.flash_attention_stats(
               q, k, v, None, 0.1, 5)),
           "plain": measure(lambda: fa.flash_attention_stats_reference(
               q, k, v, None, 0.1, 5, Q_CHUNK), 3),
           "library": library(lambda: F.scaled_dot_product_attention(
               q, k, v))}
    # read q k v, write out, lse and its tail; two L x L x D products
    fwd["bound_ms"], fwd["bound_by"] = bound(
        4 * nld * 2 + 2 * N * L * 4, 4 * N * L * L * D, "bf16")
    out, lse, lse_lo = fa.flash_attention_stats(q, k, v, None, 0.1, 5)
    dout = torch.randn(B, H, L, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves)
        return torch.autograd.grad(o, leaves, dout)

    bwd = {"kernel": measure(lambda: fa.flash_attention_bwd(
               q, k, v, out, lse, dout, None, 0.1, 5, lse_lo)),
           "plain": measure(lambda: fa.flash_attention_bwd_reference(
               q, k, v, out, lse, dout, None, 0.1, 5, lse_lo,
               q_chunk=Q_CHUNK), 3),
           "library": library(sdpa_bwd),
           "library_fwd_bwd": library(sdpa_fwd_bwd)}
    # read q k v out dO (bf16), lse and its tail; write dq dk dv; five
    # L x L x D products
    bwd["bound_ms"], bwd["bound_by"] = bound(
        8 * nld * 2 + 2 * N * L * 4, 10 * N * L * L * D, "bf16")
    del leaves, sdpa_out
    # row 2 as a primal forward: one sequence of 16384, no dropout (eval)
    L2 = 16384
    q2, k2, v2 = qkv_views(1, H, L2, D, torch.bfloat16, gen)
    prim = {"kernel": measure(lambda: fa.flash_attention(q2, k2, v2)),
            "plain": measure(lambda: fa.flash_attention_reference(
                q2, k2, v2, q_chunk=Q_CHUNK), 3),
            "library": library(lambda: F.scaled_dot_product_attention(
                q2, k2, v2))}
    prim["bound_ms"], prim["bound_by"] = bound(
        4 * H * L2 * D * 2, 4 * H * L2 * L2 * D, "bf16")
    for name, t in (("flash_fwd_kblocked (with lse) B4 H8 L8192 D64", fwd),
                    ("flash_bwd_kblocked B4 H8 L8192 D64", bwd),
                    ("flash_fwd_kblocked primal B1 H8 L16384 D64", prim)):
        lib = t["library"]
        print(f"[timing] {name}: device ms per call ({t['kernel']['timer']})"
              f": kernel {t['kernel']['ms']:.5f}, plain (q-row chunked) "
              f"{t['plain']['ms']:.5f}, SDPA (no dropout) "
              + (f"{lib['ms']:.5f}" if lib else "n/a")
              + (f" (forward + backward {t['library_fwd_bwd']['ms']:.5f})"
                 if t.get("library_fwd_bwd") else "")
              + f"; per call incl. launch (events): kernel "
              f"{t['kernel']['call_ms']:.5f}, plain "
              f"{t['plain']['call_ms']:.5f}; bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']})", flush=True)
    return {"fwd": fwd, "bwd": bwd, "primal": prim}


def lm_phase(cli, build_dir: str) -> dict:
    """Path E: shard the synthetic corpus at seq 8192 with the port's
    writer, train the next-token LM on it at the record's widths (batch 4:
    8 steps + one padded eval batch) with exact launch counts, then its
    step time, tokens/s, peak memory and [profile] split, a fixed-batch
    learning probe and an fp32 LM step card vs CPU."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from faster_distributed_training_tpu_torch.data.loader import BatchLoader
    from faster_distributed_training_tpu_torch.data.stream import shard
    from faster_distributed_training_tpu_torch.optim import build_optimizer
    from faster_distributed_training_tpu_torch.train import steps as steps_mod
    from faster_distributed_training_tpu_torch.train.state import (
        create_train_state)
    from faster_distributed_training_tpu_torch.train.steps import (
        lm_loss_and_grads, make_train_step, step_draws, to_device)

    tmp = tempfile.mkdtemp(prefix="smoke_lm_", dir=build_dir)
    try:
        corpus = os.path.join(tmp, "corpus")
        t0 = time.monotonic()
        written = shard.main(["--out", corpus, "--source", "synthetic",
                              "--seq_len", str(LONG["L"]), "--n_docs",
                              "4096", "--seed", "0", "--data_dir",
                              os.path.join(tmp, "data")],
                             log=lambda line: print(line, flush=True))
        shard_s = time.monotonic() - t0
        n_train, n_test = written["train"]["n"], written["test"]["n"]
        print(f"[shard E] {n_train} train + {n_test} test rows of "
              f"{LONG['L']} tokens, vocab {written['vocab_size']}, in "
              f"{shard_s:.1f}s (host CPU)", flush=True)

        defaults = cli.TRANSFORMER_DEFAULTS
        cfg = cli.config_from_args(cli.build_parser(
            defaults=defaults).parse_args(
            ["--device", "cuda", "--task", "lm", "--dataset", "stream",
             "--stream_dir", corpus, "--seq_len", str(LONG["L"]), "--bs",
             str(LONG["B"]), "--epoch", "1", "--precision", "bf16",
             "--checkpoint_dir", os.path.join(tmp, "ckpt"),
             "--log_every", "2"]), defaults=defaults)
        step_losses = []
        make_step = steps_mod.make_train_step

        def recording(cfg_):
            inner = make_step(cfg_)

            def run(state_, batch, draws=None):
                state_, metrics = inner(state_, batch, draws)
                step_losses.append(metrics["loss"])
                return state_, metrics
            return run

        steps_mod.make_train_step = recording
        try:
            reset_counts()
            t0 = time.monotonic()
            out = cli.run_training(cfg, log=lambda line: print(line,
                                                               flush=True))
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches = read_counts()
        finally:
            steps_mod.make_train_step = make_step
        steps = len(step_losses)
        n_eval = -(-n_test // LONG["B"])
        L = cfg.n_layers
        print(f"[train E] {steps} steps + {n_eval} eval batch(es) in "
              f"{wall:.1f}s wall (first use included); launches {launches}",
              flush=True)
        check(steps == out["steps_per_epoch"] == n_train // LONG["B"],
              f"path E ran {steps} steps")
        check(steps >= 4, "path E needs 4 steps or more (one-cycle)")
        want = path_counts(L, steps + n_eval, steps, "flax", False)
        want["fused_mlp"] = 0           # the LM has no classifier
        check(launches == want, f"path E launches {launches} != {want}")
        rows = flash_rows(launches, LONG["L"], LONG["D"])
        check(rows == {1: L * n_eval, 2: L * steps, 3: L * steps, 4: 0},
              f"path E rows {rows}")
        print(f"[train E] launches == the path's exact counts: per step "
              f"{L} flash forwards with lse (row 2) and {L} flash backwards "
              f"(row 3, dkdv + dq kernels each); per eval batch {L} primal "
              f"forwards (row 1: Lk*D = 8192*64 is inside its envelope); "
              f"rows {rows}")
        losses = torch.stack(step_losses).float().cpu().numpy()
        hist = out["history"]
        res = {k: hist[k][0] for k in ("train_loss", "test_loss",
                                       "train_ppl", "test_ppl", "train_acc",
                                       "test_acc")}
        check(bool(np.isfinite(losses).all())
              and all(np.isfinite(v) for v in res.values()),
              f"path E non-finite: {res}")
        print(f"[train E] loss per step " + " ".join(
            f"{x:.4f}" for x in losses) + "; " + ", ".join(
            f"{k} {v:.4f}" for k, v in res.items()), flush=True)

        # step time, tokens/s, peak memory and the profile (after the
        # counted run, on its state)
        state = out["state"]
        train_ds = cli.load_dataset(out["cfg"], True)
        step = make_train_step(out["cfg"])
        loader = BatchLoader(train_ds, LONG["B"], epoch=1, seed=cfg.seed,
                             max_len=LONG["L"])
        batches = [to_device(b, "cuda") for b in itertools.islice(loader, 7)]
        step(state, batches[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for b in batches[1:5]:
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(state, b)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        med = statistics.median(times)
        tok_s = LONG["B"] * LONG["L"] / (med / 1e3)
        n = 2
        kern = device_kernels(lambda: step(state, batches[5]), n)
        busy = sum(us for us, _ in kern.values()) / n / 1e3
        print(f"[train E] step time median {med:.2f} ms over {len(times)} "
              f"steps ({', '.join(f'{t:.1f}' for t in times)}); "
              f"{tok_s:.0f} tokens/s; device busy {busy:.3f} ms a step "
              f"({100 * busy / med:.1f}% of the median step); peak memory "
              f"{peak / 2**30:.2f} GiB", flush=True)
        print(profile_split(kern, n, med, f"train step path E "
                            f"(B {LONG['B']}, L {LONG['L']})"))
        top = sorted(kern.items(), key=lambda x: -x[1][0])[:10]
        print("[profile] top kernels of a path-E step (ms/step, "
              "launches/step): " + "; ".join(
                  f"{k[:60]} {us / n / 1e3:.4f} x{c / n:.0f}"
                  for k, (us, c) in top))

        # the loss goes down on one fixed batch: fixed draws, seeded init,
        # a fresh record optimizer (one-cycle over the probe's steps)
        n_probe = 12
        probe_model = cli.build_model(out["cfg"],
                                      vocab_size=written["vocab_size"],
                                      device="cuda")
        probe_model.init_weights(torch.Generator().manual_seed(cfg.seed))
        probe_model.to("cuda")
        probe_tx, _ = build_optimizer(out["cfg"], n_probe)
        probe = create_train_state(probe_model, probe_tx, seed=cfg.seed)
        draws = step_draws(cfg.seed, 0, LONG["B"],
                           probe_model.n_dropout_sites(), 0.99)
        probe_losses = [float(step(probe, batches[6], draws)[1]["loss"])
                        for _ in range(n_probe)]
        print(f"[train E] one fixed batch (B {LONG['B']}, L {LONG['L']}), "
              f"fixed draws, {n_probe} steps: loss " + " ".join(
                  f"{x:.4f}" for x in probe_losses), flush=True)
        # the first card run fell 9.147 -> 5.274 over these 12 steps
        # (PERF.md, path E's learning probe): hold it to one nat or more
        check(bool(np.isfinite(probe_losses).all())
              and probe_losses[-1] < probe_losses[0] - PROBE_FALL,
              f"path E: the loss on a fixed batch fell less than "
              f"{PROBE_FALL} nat")
        del probe, probe_model, state, out, batches

        # one fp32 LM step at reduced width, card against CPU
        small = cfg.replace(n_layers=2, d_model=64, n_heads=4, d_ff=128,
                            seq_len=512, precision="fp32", attention="flash")
        V = written["vocab_size"]
        m_cpu = cli.build_model(small, vocab_size=V, device="cpu")
        m_cpu.init_weights(torch.Generator().manual_seed(5))
        m_gpu = cli.build_model(small, vocab_size=V, device="cuda")
        m_gpu.load_state_dict(m_cpu.state_dict())
        m_gpu.to("cuda")
        tokens = np.random.default_rng(11).integers(
            1, V, size=(2, 512)).astype(np.int32)
        batch = {"tokens": tokens, "token_types": np.zeros_like(tokens),
                 "mask": np.ones_like(tokens),
                 "label": np.zeros(2, np.int32)}
        draws = step_draws(0, 0, 2, m_cpu.n_dropout_sites(), 0.99)
        l_c, g_c, *_ = lm_loss_and_grads(m_cpu, to_device(batch, "cpu"),
                                         draws)
        l_g, g_g, *_ = lm_loss_and_grads(m_gpu, to_device(batch, "cuda"),
                                         draws)
        l_g, l_c = l_g.item(), l_c.item()
        e_loss = abs(l_g - l_c)
        e_grad, leaf = grad_err(g_g, g_c)
        print(f"[train E] fp32 LM step at d_model 64 x 2 layers, L 512, "
              f"tied head, card vs CPU, same weights/batch/draws, TF32 off: "
              f"loss {l_g:.6f} vs {l_c:.6f} (err {e_loss:.3g}, tol 1e-5), "
              f"grads max err {e_grad:.3g} of the leaf's max |CPU grad| "
              f"({leaf}; tol 1e-5)", flush=True)
        check(e_loss <= 1e-5 and e_grad <= 1e-5,
              "path E card step differs from CPU")
        return {"launches": launches, "rows": rows, "step_ms": med,
                "tokens_s": tok_s, "peak_bytes": peak, "busy_ms": busy,
                "probe": (probe_losses[0], probe_losses[-1]), **res}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
        from faster_distributed_training_tpu_torch.ops import (
            flash_attention as fa)
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

    err.update(check_backward(fa, gen))
    err.update(check_quant_kernels(gen))
    err.update(check_long_kernels(fa, gen))

    # -- 4. timings at the paths' shapes ---------------------------------------
    L = 512
    q, k, v = qkv_views(B, H, L, D, bf16, gen)
    mask = ragged_mask(B, L, gen)
    sdpa_mask = (mask[:, None, None, :] != 0)
    fa_t = {"kernel": measure(lambda: flash_attention(q, k, v, mask=mask)),
          "plain": measure(
              lambda: flash_attention_reference(q, k, v, mask=mask)),
          "library": measure(lambda: F.scaled_dot_product_attention(
              q, k, v, attn_mask=sdpa_mask))}
    fa_t["bound_ms"], fa_t["bound_by"] = bound(
        4 * B * H * L * D * 2 + B * L * 4, 4 * B * H * L * L * D, "bf16")
    x = torch.randn(8, d_in, generator=gen, device="cuda").to(bf16)
    mlp = {"kernel": measure(lambda: fused_mlp(x, w1, b1, w2, b2)),
           "plain": measure(lambda: mlp_reference(x, w1, b1, w2, b2)),
           "library": measure(lambda: torch.addmm(
               b2, torch.relu(torch.addmm(b1, x, w1.T)), w2.T))}
    mlp["bound_ms"], mlp["bound_by"] = bound(
        2 * (8 * d_in + d_h * d_in + d_h + d_out * d_h + d_out + 8 * d_out),
        2 * 8 * (d_in * d_h + d_h * d_out), "bf16")
    # the backward at the training shape: B 16, H 8, L 512, D 64, bf16,
    # key padding and dropout 0.1 as the train step runs it
    B_t = 16
    q, k, v = qkv_views(B_t, H, L, D, bf16, gen)
    mask = ragged_mask(B_t, L, gen)
    out, lse, lse_lo = fa.flash_attention_stats(q, k, v, mask, 0.1, 5)
    dout = torch.randn(B_t, H, L, D, generator=gen, device="cuda").to(bf16)
    sdpa_mask = (mask[:, None, None, :] != 0)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=sdpa_mask)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves, attn_mask=sdpa_mask)
        return torch.autograd.grad(o, leaves, dout)

    bws = {"kernel": measure(lambda: fa.flash_attention_bwd(
               q, k, v, out, lse, dout, mask, 0.1, 5, lse_lo)),
           "plain": measure(lambda: fa.flash_attention_bwd_reference(
               q, k, v, out, lse, dout, mask, 0.1, 5, lse_lo)),
           "library": measure(sdpa_bwd)}
    bwr = {"kernel": measure(lambda: fa.flash_attention_bwd_recompute(
               q, k, v, dout, mask, 0.1, 5)),
           "plain": measure(
               lambda: fa.flash_attention_bwd_recompute_reference(
                   q, k, v, dout, mask, 0.1, 5)),
           "library": measure(sdpa_fwd_bwd)}
    N_t, nld = B_t * H, B_t * H * L * D
    # saved stats: read q k v out dO (bf16), lse and its tail (fp32), key
    # bias; write dq dk dv; five L x L x D products
    bws["bound_ms"], bws["bound_by"] = bound(
        8 * nld * 2 + 2 * N_t * L * 4 + B_t * L * 4, 10 * N_t * L * L * D,
        "bf16")
    # recompute: read q k v dO and the bias, write dq dk dv; the forward's
    # two products are done again
    bwr["bound_ms"], bwr["bound_by"] = bound(
        7 * nld * 2 + B_t * L * 4, 14 * N_t * L * L * D, "bf16")
    for name, t in (("flash_fwd B8 H8 L512 D64", fa_t),
                    ("flash_bwd_stats B16 H8 L512 D64", bws),
                    ("flash_bwd_recompute B16 H8 L512 D64", bwr),
                    ("fused_mlp 8x512->1024->4", mlp)):
        print(f"[timing] {name}: device ms per call ({t['kernel']['timer']}"
              f"): kernel {t['kernel']['ms']:.5f}, plain "
              f"{t['plain']['ms']:.5f}, library {t['library']['ms']:.5f}; "
              f"per call incl. launch (events): kernel "
              f"{t['kernel']['call_ms']:.5f}, plain {t['plain']['call_ms']:.5f}"
              f", library {t['library']['call_ms']:.5f}; bound "
              f"{t['bound_ms']:.5f} ms ({t['bound_by']})", flush=True)

    qt = time_quant_kernels(gen)
    lt = time_long_kernels(fa, gen)

    # -- 5. training at full width ---------------------------------------------
    tr = train_phase(cli, fa, fused_mlp, str(_build.BUILD_DIR))
    trq = train_quant_phase(cli, str(_build.BUILD_DIR))
    lm = lm_phase(cli, str(_build.BUILD_DIR))

    # -- 6. serving at full width ----------------------------------------------
    defaults = cli.TRANSFORMER_DEFAULTS
    cfg = cli.config_from_args(cli.build_parser(defaults=defaults).parse_args(
        ["--device", "cuda", "--serve_requests", "64",
         "--serve_batch_size", "8"]), defaults=defaults)
    model = cli.build_model(cfg, vocab_size=30522, device="cpu")
    model.init_weights(torch.Generator().manual_seed(cfg.seed))
    params = params_to_jax(model.state_dict(), cfg.n_heads)
    requests = cli.synth_requests(64, 30522, cfg.seq_buckets, seed=cfg.seed)
    reset_counts()
    t0 = time.monotonic()
    res = cli.run_serving(cfg, requests=requests, params=params)
    serve_s = time.monotonic() - t0
    counts = read_counts()
    launches = {"flash_fwd": counts["flash_fwd"],
                "fused_mlp": counts["fused_mlp"]}
    check(counts["flash_bwd_stats"] == counts["flash_bwd_recompute"]
          == counts["flash_fwd_stats"] == 0,
          "serving launched a backward kernel or a training forward")
    check(counts["fused_ffn"] == counts["fused_ffn_quant"]
          == counts["quant_matmul"] == 0,
          "the default serving build launched a slice-3 kernel")
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
        print(profile_split(kern, n, wall_ms, f"serve bucket {bucket} "
                            f"(per batch)"))
        per_batch = launches_per_call(kern, n)
        check(per_batch <= SERVE_LAUNCHES,
              f"serve bucket {bucket}: {per_batch:.0f} launches a batch, "
              f"more than slice 1's {SERVE_LAUNCHES}")
        if bucket == max(cfg.seq_buckets):
            top = sorted(kern.items(), key=lambda x: -x[1][0])[:8]
            print("[profile] top kernels at the largest bucket (ms/batch, "
                  "launches/batch): " + "; ".join(
                      f"{k[:60]} {us / n / 1e3:.4f} x{c / n:.0f}"
                      for k, (us, c) in top))

    sq = serve_quant_phase(cli, trq["state"])

    # -- 7. output -----------------------------------------------------------
    print(f"[serve] p50 {res['p50_ms']} ms, p99 {res['p99_ms']} ms, "
          f"{res['qps']} qps (64 requests, batch 8, 1 replica)")
    print(f"[train] step time median {tr['step_ms']:.2f} ms; fixed-batch "
          f"loss {tr['loss_first']:.4f} -> {tr['loss_last']:.4f}; eval "
          f"accuracy {tr['test_acc']:.4f}; path B step time median "
          f"{trq['step_ms']:.2f} ms")
    print(f"[train E] --task lm B {LONG['B']} L {LONG['L']}: step time "
          f"median {lm['step_ms']:.2f} ms, {lm['tokens_s']:.0f} tokens/s, "
          f"peak memory {lm['peak_bytes'] / 2**30:.2f} GiB; train loss "
          f"{lm['train_loss']:.4f} (ppl {lm['train_ppl']:.2f}, next-token "
          f"accuracy {lm['train_acc']:.4f}), test loss {lm['test_loss']:.4f}"
          f" (ppl {lm['test_ppl']:.2f}, accuracy {lm['test_acc']:.4f}); "
          f"fixed-batch loss {lm['probe'][0]:.4f} -> {lm['probe'][1]:.4f}")
    src = "faster_distributed_training_tpu_torch/csrc/"
    jax_ops = "faster_distributed_training_tpu/ops/"
    # launches: the training run (the main path); the recompute route's
    # from its own 2-step run; the serving run's beside them
    train_l = dict(tr["launches"],
                   flash_bwd_recompute=tr["recompute_launches"][
                       "flash_bwd_recompute"])
    kernels = []
    for name, t, file, replaces in (
            ("flash_fwd", fa_t, "flash_fwd",
             "flash_attention.py:145"),
            ("flash_bwd_stats", bws, "flash_bwd",
             "flash_attention.py:716"),
            ("flash_bwd_recompute", bwr, "flash_bwd",
             "flash_attention.py:847"),
            ("fused_mlp", mlp, "fused_mlp", "fused_mlp.py:108")):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"{src}{file}.cu",
                        "replaces": jax_ops + replaces,
                        "launches": train_l[name],
                        "launches_serve": launches.get(name, 0),
                        "max_abs_err": err[name], "ms": t["kernel"]["ms"],
                        "call_ms": t["kernel"]["call_ms"],
                        "plain_ms": t["plain"]["ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["library"]["ms"]})
    # slice 3: fused_ffn's launches from the path-A run, fused_ffn_quant's
    # and quant_matmul's from the path-B run; serving's from path D
    slice3 = (("fused_ffn", "fused_ffn", "fused_ffn.py:208",
               trq["short"]["A"]["fused_ffn"]),
              ("fused_ffn_quant", "fused_ffn", "fused_ffn.py:624",
               trq["launches"]["fused_ffn_quant"]),
              ("quant_matmul", "quant_matmul", "quant.py:244",
               trq["launches"]["quant_matmul"]))
    for name, file, replaces, n in slice3:
        t = qt[name]
        entry = {"name": name, "route": "cuda", "source": f"{src}{file}.cu",
                 "replaces": jax_ops + replaces, "launches": n,
                 "launches_serve": sq["launches"][name],
                 "max_abs_err": err[name], "ms": t["kernel"]["ms"],
                 "call_ms": t["kernel"]["call_ms"],
                 "plain_ms": t["plain"]["ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"],
                 "library_ms": t["library"]["ms"] if t["library"] else None}
        if name.startswith("fused_ffn"):
            entry["library_is"] = "its two cuBLAS GEMMs only"
        if name == "quant_matmul":
            e = qt["quant_matmul_e4m3"]
            entry.update({
                "shape": "8192x512->1536, int8; e4m3_* the E4M3 kernel",
                "e4m3_launches_path_c": trq["short"]["C"]["quant_matmul"],
                "e4m3_max_abs_err": err["quant_matmul_e4m3"],
                "e4m3_ms": e["kernel"]["ms"],
                "e4m3_plain_ms": e["plain"]["ms"],
                "e4m3_bound_ms": e["bound_ms"],
                "e4m3_library_ms": e["library"]["ms"] if e["library"]
                else None})
        kernels.append(entry)
    # slice 4: rows 2 and 3 are the same two kernels at long context;
    # launches from path E, booked onto the rows by flash_rows()
    for name, key, file, replaces, row in (
            ("flash_fwd_kblocked", "fwd", "flash_fwd",
             "flash_attention.py:290", 2),
            ("flash_bwd_kblocked", "bwd", "flash_bwd",
             "flash_attention.py:379", 3)):
        t = lt[key]
        entry = {"name": name, "route": "cuda", "source": f"{src}{file}.cu",
                 "replaces": jax_ops + replaces,
                 "launches": lm["rows"][row], "launches_serve": 0,
                 "max_abs_err": err[name],
                 "ms": t["kernel"]["ms"], "call_ms": t["kernel"]["call_ms"],
                 "plain_ms": t["plain"]["ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"],
                 "library_ms": t["library"]["ms"] if t["library"] else None,
                 "shape": "B4 H8 L8192 D64 bf16, dropout 0.1 (library: "
                          "SDPA without dropout)"}
        if key == "fwd":
            p = lt["primal"]
            entry.update({
                "primal_shape": "B1 H8 L16384 D64 bf16, no dropout",
                "primal_ms": p["kernel"]["ms"],
                "primal_plain_ms": p["plain"]["ms"],
                "primal_bound_ms": p["bound_ms"],
                "primal_library_ms": p["library"]["ms"] if p["library"]
                else None})
        else:
            lfb = t["library_fwd_bwd"]
            entry["library_fwd_bwd_ms"] = lfb["ms"] if lfb else None
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
