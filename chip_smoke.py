#!/usr/bin/env python3
"""Chip smoke of the PyTorch/H100 port: builds the kernels, holds each
against its plain version, times them, trains and serves at full width.

    python3 chip_smoke.py

Needs one CUDA card and the repo checkout beside this file; without
either it exits non-zero and prints no result.  Phases, in order (any
failure raises and exits non-zero):

  1. device  — CUDA present; the card's name and power limit;
  2. build   — every kernel of the training and serving paths from
               csrc/ (one nvcc per source, in parallel);
  3. check   — each kernel against its plain version at the paths'
               shapes, with the stated tolerances; the backward kernels
               also for determinism (two launches, equal bits), the
               recompute route against the saved-stats route, and the
               autograd Function against the kernels' own outputs;
  4. timing  — kernel, plain version, the library yardstick and the
               bound.  Two clocks: the device time per call (the sum of
               the kernels a call launches, torch.profiler over 25 calls;
               the JSON line's ms fields), and the time per call the
               caller sees (CUDA events, median of 25 after warm-up);
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
               against the same step on the CPU, and a checkpoint round
               trip on the card;
  6. serve   — ``cli.run_serving`` at the default width (6 layers,
               d_model 512, 8 heads, vocab 30522, buckets 64..512, serve
               batch 8, bf16) with seeded random weights; launch counts
               set to 0 just before and read just after; then the
               per-bucket split of one batch's device time (no more
               device launches a batch than slice 1's 258) and the
               device's busy share of the host wall time;
  7. output  — p50/p99/qps, the kernels JSON line (launches from the
               training run, the recompute route's from its own run; the
               serving run's beside them), the card line, and last the
               ok line.
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

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 FMA, HBM3
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
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

def kernel_group(name: str) -> str:
    """The [profile] group of a device kernel's name."""
    low = name.lower()
    if "flash_bwd" in low or "dkdv_kernel" in low or "dq_kernel" in low:
        return "flash_bwd"
    if "flash_fwd" in low:
        return "flash_fwd"
    if "mlp_fwd" in low:
        return "fused_mlp"
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
    e_grad = max((g_g[k].cpu() - g_c[k]).abs().max().item() for k in g_c)
    print(f"[train] fp32 step at d_model 64 x 2 layers, card vs CPU, same "
          f"weights/batch/draws, TF32 off: loss {l_g:.6f} vs "
          f"{l_c:.6f} (err {e_loss:.3g}, tol 1e-4), grads max err "
          f"{e_grad:.3g} (tol 1e-3)")
    check(e_loss <= 1e-4 and e_grad <= 1e-3, "card step differs from CPU")

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

    # -- 5. training at full width ---------------------------------------------
    tr = train_phase(cli, fa, fused_mlp, str(_build.BUILD_DIR))

    # -- 6. serving at full width ----------------------------------------------
    defaults = cli.TRANSFORMER_DEFAULTS
    cfg = cli.config_from_args(cli.build_parser(defaults=defaults).parse_args(
        ["--device", "cuda", "--serve_requests", "64",
         "--serve_batch_size", "8"]), defaults=defaults)
    model = cli.build_model(cfg, vocab_size=30522, device="cpu")
    model.init_weights(torch.Generator().manual_seed(cfg.seed))
    params = params_to_jax(model.state_dict(), cfg.n_heads)
    requests = cli.synth_requests(64, 30522, cfg.seq_buckets, seed=cfg.seed)
    for counted in (flash_attention, fa.flash_attention_bwd,
                    fa.flash_attention_bwd_recompute, fused_mlp):
        counted.launches = 0
    t0 = time.monotonic()
    res = cli.run_serving(cfg, requests=requests, params=params)
    serve_s = time.monotonic() - t0
    launches = {"flash_fwd": flash_attention.launches,
                "fused_mlp": fused_mlp.launches}
    check(fa.flash_attention_bwd.launches == 0
          and fa.flash_attention_bwd_recompute.launches == 0,
          "serving launched a backward kernel")
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

    # -- 6. output -----------------------------------------------------------
    print(f"[serve] p50 {res['p50_ms']} ms, p99 {res['p99_ms']} ms, "
          f"{res['qps']} qps (64 requests, batch 8, 1 replica)")
    print(f"[train] step time median {tr['step_ms']:.2f} ms; fixed-batch "
          f"loss {tr['loss_first']:.4f} -> {tr['loss_last']:.4f}; eval "
          f"accuracy {tr['test_acc']:.4f}")
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
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
