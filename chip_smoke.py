#!/usr/bin/env python3
"""Chip smoke of the PyTorch/H100 port: builds the kernels, holds each
against its plain version, times them, trains (the classifier, the
next-token LM at seq 8192 and ResNet-50 with NGD) and serves at full
width.

    python3 chip_smoke.py
    python3 chip_smoke.py --steps [DIR]
    python3 chip_smoke.py --resnet
    python3 chip_smoke.py --dispatch
    python3 chip_smoke.py --mesh
    python3 chip_smoke.py --tp
    python3 chip_smoke.py --sp
    python3 chip_smoke.py --pp
    python3 chip_smoke.py --decode
    python3 chip_smoke.py --resilience

The second form prints only the device split of one record-width
training step of the slice-2 path and paths B and C, and whether two
identical steps are bitwise equal, then path E's step split (the LM at
seq 8192 on a random batch), for the port at DIR (default: this
checkout): run it on a parent and a change in one call to compare them.
The third runs phase R (the ResNet slice, no kernel build) alone; the
fourth builds the kernels and runs phases K (without path E) and M; the
fifth builds them and runs phase P alone, the sixth phase T alone, the
seventh phase S alone, the eighth phase PP alone, the ninth phase D
alone (no build: the decode path has no hand kernel), the tenth the
build and phase F alone (``resilience_phase``: path B under the
checkpoint manager, a supervised die, SIGTERM and its relaunch, the
sentinel's NaN guard and spike rollback, a two-process fs-simulated pod;
in the whole smoke it runs after phase M, before any process group).
Needs one CUDA card and the repo checkout beside this file; without
either it exits non-zero and prints no result.  Phases, in order (any
failure raises and exits non-zero):

  1. device  — CUDA present; the card's name and power limit;
  2. build   — every kernel of the training and serving paths from
               csrc/ (five sources, one nvcc each, in parallel); the
               registers, spills and shared memory of the bf16 forward
               (flash_fwd_kernel_sm90<D>, four head dims; <64> must not
               spill) and backward kernels and of the wgmma GEMM and FFN;
  3. check   — each kernel against its plain version at the paths'
               shapes, with the stated tolerances; the backward kernels
               also for determinism (two launches, equal bits), the
               recompute route against the saved-stats route, and the
               autograd Function against the kernels' own outputs;
               quant_matmul at the record's four GEMM shapes and a ragged
               row count (int8 bitwise; E4M3 with bf16 output, whose
               sums stay in fp8 wgmma, 2e-2 of max |plain|, its worst
               error printed beside that limit; E4M3 with fp32 output,
               upcast to bf16, 1e-5 at the qkv shape), fused_ffn
               at 8192 x 512 -> 1024 -> 512 for fmt none / int8 / E4M3
               with dropout 0.1 at both sites (outputs 2e-2 of max
               |plain|, amaxes 1e-2), two launches equal bits, and the
               engine each shape routes to; at long
               context (TPU rows 2 and 3: the same two flash kernels),
               path E's shape (B 4, H 8, L 8192: forward with lse, primal
               forward, backward), B 1 at L 8192 with key padding and at
               L 16384, bf16 and fp32, dropout 0.1, against the plain
               versions walked 1024 q rows at a time (bf16 outputs and
               all gradients 2e-2 / 1e-5 of max |plain|, fp32 outputs
               1e-5), two launches equal bits;
  4. timing  — kernel, plain version, the library yardstick and the
               bound; the flash forward (rows 1, 2, 2') and backward also
               at dropout 0, like for like with SDPA (which runs without
               dropout), the forward's and the classifier's own kernel
               time apart from the wrapper's torch work (the key bias),
               the classifier (row 6) at 8, 16 and 4096 rows beside an
               empty kernel's device time (the launch floor), and the bf16
               backward kernels' and the wgmma GEMM and FFN kernels'
               registers, spills (the build log; the D 64 backward pair and
               the record-shape GEMM and FFN instantiations must not spill)
               and shared memory.  Two clocks: the device time per call (the sum of
               the kernels a call launches, torch.profiler over 25 calls;
               the JSON line's ms fields), and the time per call the
               caller sees (CUDA events, median of 25 after warm-up);
               slice 3's rows 7, 8 (int8 and E4M3: two `_int_mm` /
               `_scaled_mm` calls as the yardstick) and 9 (int8, E4M3) at
               the record's training shape; rows 2 and 3 at path E's shape
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
               tokens/s, a [profile] split of one step's device time, one
               fp32 step at reduced width on the card
               against the same step on the CPU (loss 1e-5, each grad
               leaf 1e-5 of its max |CPU grad|), and a checkpoint round
               trip on the card; then path B (``--ffn_impl pallas --quant
               int8``) at full width for 16 steps + 4 eval batches with
               its exact launch counts, one step alone (exact per-step
               launches, every amax history rolled once), its step time
               and [profile] split, an fp32 reduced-width step card vs
               CPU; then 4-step runs of path A (``--ffn_impl pallas``)
               and path C (``--quant fp8``), each with its launch counts,
               path C's step time and [profile] split; one training step
               at the record's width run twice from the same state, batch
               and draws (slice 2 and path B), every parameter and
               optimizer leaf bitwise equal (on a difference the step runs
               again under torch.use_deterministic_algorithms to name the
               op, and the smoke fails); the transformer_test defaults
               (``--dataset agnews`` without its CSVs) train 4 steps on the
               synthetic fallback;
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
  R. resnet — phase R, the ResNet slice, which launches no hand kernel
               (its convolutions are cuDNN's; the hand-kernel counts must
               stay 0): R1 ``cli.run_training`` of resnet50 at batch 512,
               bf16, ``--ngd --meta_learning`` on the synthetic split (2
               epochs of 8 steps: NGD's init step, the always-update
               steps and the gated period; an eval of 1024 images an
               epoch), every step synchronized and timed, the medians of
               update and non-update steps, images/s, peak memory; then
               a torch.profiler split of one update and one non-update
               step (cuDNN conv forward / backward, BN and elementwise
               work, cuSOLVER eigh, GEMMs, the foreach optimizer), their
               launches, the device's busy share and host syncs (a
               non-update step must make none), a 12-step fixed-batch
               learning probe from the seeded init at the record's lr
               0.1 (its last 4 losses' mean below its first), and the
               step time with cuDNN determinism off and on; R2 the
               resnet50_test record (MADGRAD + cosine, static mixup 0.2)
               and SGD with meta mixup at the same shape, 4 steps each
               (NGD's overhead over SGD); R3 an fp32 resnet18 step at
               batch 8 and 16x16 card vs CPU (loss 1e-5; each grad leaf
               of the main path's cuDNN flags no further from an fp64
               CPU step than twice the larger of the CPU's two fp32
               errors on that leaf, with and without oneDNN; printed
               beside it: cuDNN's heuristic algorithms and no cuDNN),
               the same step in fp64 card vs CPU (every leaf 1e-6: the
               logits and loss stay fp32), the augment bitwise, one
               NGD step on resnet18-shaped random directions card vs CPU
               (fp32: updates of the N >= rank leaves 1e-4, every
               update's norm that of its raw direction 1e-5; fp64: the
               updates of the N < rank leaves 1e-3, the factor
               invariants of the N >= rank groups 1e-6 and of the others
               5e-3, beside the CPU's own change when its directions
               move by one fp32 ulp), two
               identical R1 steps bitwise on every leaf, and 4
               ``--precision fp16`` resnet18 steps with the loss scale;
  K. dispatch — K steps a dispatch (``--steps_per_dispatch``, the step
               captured once as a CUDA graph and replayed): every
               parameter, buffer and optimizer leaf bitwise equal to K=1
               after 8 steps of the slice-2 record at K=4 (host,
               ``--data_path resident`` and ``--remat --remat_policy
               attn_out``) and 16 steps at K=16 resident, of path B at
               K=4, of ResNet-50 SGD + meta at
               K=4 (with and without ``--remat``) and of ResNet-50 NGD +
               meta over 16 steps (the factor refreshes eager in their
               slots), and of path E at K=2 (inside the LM phase, on its
               corpus); each
               seed-taking kernel (rows 1-5, 7, 8) captured once and
               replayed with 3 seeds written to its device seed buffer,
               bitwise equal to eager launches, 3 different masks; then
               the host wall a step (median), device ms a step and busy
               share, host launch calls a step (kernel and graph launches
               of the CUDA runtime, torch.profiler) and tokens/s of the
               slice-2 record at K=1 host, K=4 host, K=4 resident and
               K=16 resident, the peak memory and the resident split's
               bytes; the same for path B, ResNet R1's non-update step
               (its factor refresh pushed past the run) and path E at
               K=1 and K=4.  A replay makes no Python call, so the
               wrappers' counts do not see it: the launches of each hand
               kernel in a dispatch of K steps are counted on the device
               (torch.profiler's CUDA activity, by kernel name; up to 3
               profiles, as the profiler can lose a replay's records)
               and must equal K times one eager K=1 step's (slice 2 host
               and resident, path B, path E at K=4; K=16's printed);
  M. remat  — the transformer at batch 256, L 512, record widths, under
               ``--remat_policy`` none, layer, ffn, attn_out and dots:
               peak memory, step ms, examples/s; each policy's gradients
               against none's (ffn bitwise; the attention-wrapping ones,
               through row 5's recompute route, within 2e-2 of each
               leaf's max |grad|); layer and attn_out below none's peak;
               under ``--quant int8`` every amax history rolled once,
               equal to none's; row 5's launches from an entry-point run
               with ``--remat`` (counts set to 0 just before); ResNet-50
               ``--remat`` at batch 512: peak, step ms, gradients and BN
               running statistics bitwise against no remat (cuDNN
               deterministic);
  P. mesh    — the data mesh (slice 10) on the one card.  P1, world 1
               over NCCL, joined by the entry point (``--distributed
               --mesh dp=1``, torchrun's variables): the record (8
               steps), path B (4) and ResNet-50 NGD + meta at batch 512
               (2, an NGD update among them) bitwise against the same
               runs without a process group on every leaf, the hand
               kernels of each path launched (counts set to 0 just
               before each run), step ms with and without the group; the
               record at K=4 bitwise against K=1 under dp=1 (the
               all-reduce captured in the graph).  P2 ``--fsdp
               --host_offload --offload_opt_state`` at world 1 bitwise
               against dp=1, the card's bytes at rest between steps with
               and without, the bytes parked (the fp32 parameters and
               MirrorMADGRAD state, reckoned from the leaves), step ms.
               P3 rows 1/2 and 4 at the record's and path E's shapes and
               rows 7 and 8 at the record's, dropout 0.1, on the two
               halves of the batch at b0 = 0 and B/2: outputs, lse,
               gradients (and the FFN's amaxes, as a max) bitwise the
               full launch's rows; the plain versions (on the CPU, at the
               record's shape) the same.  P4 two ranks on the card over gloo (dp=2): the
               record at 2 layers, fp32, 4 steps on fixed global batches,
               both ranks' states bitwise equal after every step, held to
               the world-1 run within the CPU tests' loss 1e-5 and params
               1e-4, step ms;
  T. tp      — tensor parallelism (slice 11) on the one card (NCCL
               refuses two ranks on one device: a multi-card tp mesh is
               not measured).  T1, one process: rows 1 and 4 at the
               record's shape and 2 and 3 at path E's, dropout 0.1, on
               the head halves at h0 = 0 and H/2 (h_glob = H): out, lse,
               dq, dk, dv bitwise the full launch's heads (the plain
               versions too at the record's shape); row 8' (the fused
               FFN's tp ``partial`` tile) for none, int8 and E4M3 at
               8192 x 512 -> 512 of d_ff 1024, c0 = 0 and 512: each tile
               against its plain version (2e-2 of max |plain|, E4M3 of
               max |h + plain|; amaxes 1e-2), two launches bitwise, the
               two tiles summed + b2, connection dropout and residual
               against the full row 8 launch (2e-2), the tiles' amaxes'
               MAX against the full launch's; its timing (kernel, plain,
               the shard's two cuBLAS GEMMs, bound); row 9's column shards
               (qkv on H/2 heads, Dense_0 on d_ff/2) bitwise the full
               launch's columns and its row shards (out, Dense_1) summed
               against the full GEMM (2e-2), the qkv shard's timing.  T2,
               two ranks on the card over gloo at ``--mesh tp=2``: (a)
               fp32, the record's widths at 2 layers, flash and the fused
               FFN, 4 fixed batches, against world 1 (loss 1e-5, params
               1e-4; the ranks' replicated leaves bitwise after every
               step); (b) path B (``--ffn_impl pallas --quant int8``,
               bf16) at full width, 4 steps: finite losses, replicated
               leaves bitwise, each hand kernel's device launches in one
               step from torch.profiler (rows 1 and 4: 6 on 4 of 8 heads,
               row 8': 6, row 9: 24; the wrappers' counts set to 0 just
               before the run and read after), step ms beside world 1's
               (printed, not a claim);
  S. sp      — sequence parallelism (slice 12) on the one card (a
               multi-card sp mesh is not measured either).  S1, one
               process: rows 7 and 8 (none, int8, E4M3) on the two
               sequence halves of 16 x 512 rows (512 -> 1024 -> 512,
               dropout 0.1) at s0 = 0 and 256, l_loc 256, l_glob 512:
               each half bitwise the full launch's rows and its plain
               version within 2e-2 (amaxes 1e-2), two launches bitwise,
               the halves' amax MAX bitwise the full's; one half's
               timing.  S2, two ranks on the card over gloo at ``--mesh
               sp=2`` in one group: (a) fp32, 2 layers, the fused FFN,
               ring and Ulysses against world 1 (loss 1e-5, params 1e-4,
               the ranks' replicated leaves bitwise after every step);
               (b) path B with Ulysses at full width, 4 steps, each hand
               kernel's device launches in one step (rows 1 and 4: 6 on
               4 of 8 heads of the whole sequence, row 8: 6, row 9: 24,
               row 6: 1), host wall and device ms beside world 1's
               (printed, not a claim); (c) path E with Ulysses (rows 2
               and 3 at h0 = 0 and 4), 2 steps: host wall, device ms and
               peak a rank beside world 1's;
  PP. pp     — pipeline parallelism (slice 13) on the one card (no
               multi-card pp mesh either).  PP1, one process: rows 1 and
               4 (B 16, H 8, L 512, D 64, key padding) and rows 7 and 8
               (none, int8, E4M3; 16 x 512 rows) at dropout 0.1 on the 4
               microbatches of a pipeline step (b0 = 0, 4, 8, 12): each
               bitwise the full launch's rows and within its plain
               version's tolerance, the microbatches' amax MAX bitwise
               the full's; the last microbatch's timing.  PP2, two ranks
               on the card over gloo at ``--mesh pp=2`` (one process a
               stage, M = 4) in one group: (a) fp32, 4 layers, the fused
               FFN, 1f1b and interleaved against world 1 (loss 1e-5,
               params 1e-4, the ranks' gathered states bitwise); (b) the
               record at 6 layers, 4 steps: each stage's device launches
               in one step (rows 1 and 4: 12, row 6 once on the last
               stage), host wall, device ms, the wait at the stage
               boundary and bytes at rest a rank with and without
               residency beside world 1's (printed, not a claim); (c)
               path B: launches, amax histories against world 1 (1e-3
               relative); (d) path E: peak a rank beside world 1's;
  D. decode  — decode serving of the LM (slice 14), which launches no
               hand kernel (the counts, set to 0 before each serving run,
               must stay 0), at the record's widths (6 layers, d_model
               512, 8 heads, d_ff 1024, vocab 30522, tied head, seq 512,
               buckets 64-512, page 16: 32 page counts, 4 slots), seeded
               weights exported as the JAX tree's ``.npz`` and read by
               ``load_serving_state``: (a) fp32, the card's engine
               against the CPU's: prefill logits 1e-4 of max |CPU|, the
               greedy tokens of 4 prompts x 16 equal; (b) bf16, every
               page count's graph replay against the eager
               ``decode_step`` from the same cache and operands, next
               tokens and cache bitwise, one capture a page count, all in
               warmup; (c) with one window (page 512) a mid-stream
               admission leaves a running stream's tokens bitwise
               unchanged, and topk gives each request the same tokens
               over two admission orders (the default page's mid-stream
               comparison printed); (d) ``run_decode_serving`` at the
               defaults (16 requests x 32 tokens) and at 32 slots (64
               requests): TTFT and latency p50 / p99, tokens/s, the KV
               cache's bytes, peak memory, the page counts used, and a
               step at 1, 8 and 32 pages as a replay and eager (host
               wall, device ms, device launches, host launch calls), a
               prefill at buckets 64 and 512 (host wall, device ms);
               (e) the front door, two worker processes on the card
               (fp32), one SIGKILLed with 8 generations in flight: every
               stream finishes at 16 tokens equal to the in-process
               run's, the killed worker respawns, is re-admitted and
               serves again;
  7. output  — p50/p99/qps, the phase-R summary, the kernels JSON line
               (launches from the
               training run, the recompute route's from phase M's
               ``--remat`` run, each kernel's under K=4 beside them,
               fused_ffn's from path A, fused_ffn_quant's and
               quant_matmul's from path B, rows 2 and 3's from path E;
               the serving runs' beside them; each kernel's device
               launches in one T2(b) step at tp=2; row 8''s partial tile
               with its T2(b) launches and T1's times; each kernel's
               launches in one S2 step at sp=2 and rows 7 and 8's S1
               half-launch times; each kernel's device launches in one
               PP2 step at pp=2, a list over the stages, and rows 1, 4,
               7 and 8's PP1 microbatch times),
               the card line, and last the ok line.
"""

from __future__ import annotations

import gc
import itertools
import json
import os
import re
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


def measure(fn, repeats: int = REPEATS, group: str = None) -> dict:
    """Device time per call (the sum of every kernel ``fn`` launches,
    torch.profiler; CUDA events when the profiler sees no device time)
    and the per-call time the caller sees (CUDA events), each over
    ``repeats`` calls; with ``group``, also ``kernel_only_ms``: the
    device time of the kernels of that ``kernel_group`` alone (the hand
    kernel without the wrapper's torch work)."""
    wall = call_ms(fn, repeats)
    kern = device_kernels(fn, repeats)
    dev = sum(us for us, _ in kern.values()) / repeats / 1e3
    got = {"ms": dev if dev > 0 else wall, "call_ms": wall,
           "timer": "profiler" if dev > 0 else "events"}
    if group:
        got["kernel_only_ms"] = sum(
            us for name, (us, _) in kern.items()
            if kernel_group(name) == group) / repeats / 1e3
    return got


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


def ptxas_usage(log: str) -> dict:
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads"}}
    from nvcc's -Xptxas=-v output."""
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)", line)
        if m:
            name = m.group(1)
            usage.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            usage[name].update(spill_stores=int(m.group(1)),
                               spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name]["registers"] = int(m.group(1))
    return usage


def flash_build(fa, logs: dict) -> dict:
    """{"flash_fwd_kernel_sm90<D>" / "dkdv_kernel_sm90<D>" /
    "dq_kernel_sm90<D>": registers, spill bytes and dynamic shared memory}
    of the bf16 flash kernels: registers and spills from this run's build
    logs, shared memory from the libraries."""
    fwd, bwd = fa._fwd_lib(), fa._bwd_lib()
    got = {}
    for src in ("flash_fwd", "flash_bwd"):
        for mangled, u in ptxas_usage(logs.get(src, "")).items():
            m = re.search(r"(flash_fwd|dkdv|dq)_kernel_sm90ILi(\d+)E", mangled)
            if m:
                kind, d = m.group(1), int(m.group(2))
                smem = (fwd.fdt_flash_fwd_smem_bytes(d) if kind == "flash_fwd"
                        else bwd.fdt_flash_bwd_smem_bytes(d, int(kind == "dq")))
                got[f"{kind}_kernel_sm90<{d}>"] = dict(u, smem_bytes=smem)
    return got


QMM_ROUTES = ("direct", "upcast")
FFN_FMTS = ("none", "int8", "e4m3")
# the wgmma instantiations the record's shapes run (bf16, d_model 512)
RECORD_SM90 = ("qmm_kernel_sm90<bf16, int8, direct>",
               "qmm_kernel_sm90<bf16, e4m3, direct>",
               "ffn_kernel_sm90<bf16, none, 256>",
               "ffn_kernel_sm90<bf16, int8, 256>",
               "ffn_kernel_sm90<bf16, e4m3, 256>")


def sm90_build(logs: dict) -> dict:
    """{"qmm_kernel_sm90<T, fmt, route>" / "ffn_kernel_sm90<T, fmt, DH>":
    registers, spill bytes and dynamic shared memory} of the wgmma GEMM
    and FFN instantiations: registers and spills from this run's build
    log, shared memory from the libraries."""
    from faster_distributed_training_tpu_torch.ops import fused_ffn, quant

    got = {}
    for mangled, u in ptxas_usage(logs.get("quant_matmul", "")).items():
        m = re.search(r"qmm_kernel_sm90I(f|13__nv_bfloat16)Li(\d)ELb(\d)E",
                      mangled)
        if m:
            t = "fp32" if m.group(1) == "f" else "bf16"
            key = (f"qmm_kernel_sm90<{t}, {('int8', 'e4m3')[int(m.group(2))]}"
                   f", {QMM_ROUTES[int(m.group(3))]}>")
            got[key] = dict(u, smem_bytes=quant._lib().fdt_qmm_smem_bytes())
    for mangled, u in ptxas_usage(logs.get("fused_ffn", "")).items():
        m = re.search(r"ffn_kernel_sm90I(f|13__nv_bfloat16)Li(\d)ELi(\d+)E",
                      mangled)
        if m:
            t, fmt, dh = (m.group(1) != "f"), int(m.group(2)), int(m.group(3))
            key = (f"ffn_kernel_sm90<{'bf16' if t else 'fp32'}, "
                   f"{FFN_FMTS[fmt]}, {dh}>")
            got[key] = dict(u, smem_bytes=fused_ffn._lib().fdt_ffn_smem_bytes(
                int(t), fmt, 2 * dh))
    return got


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
         "--log_every", "8", "--no_plot"]), defaults=defaults)
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
    return {"launches": launches,
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
        _ffn_body_reference, ffn_engine, ffn_fwd_generalized)
    from faster_distributed_training_tpu_torch.ops.quant import (
        quant_dot_reference, quant_matmul)

    worst = {"quant_matmul": 0.0, "quant_matmul_e4m3": 0.0, "fused_ffn": 0.0,
             "fused_ffn_quant": 0.0}
    bf16 = torch.bfloat16
    shapes = dict(QMM_SHAPES, ragged=(1000, 512, 1536))
    worst_rel = 0.0
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
                worst_rel = max(worst_rel, rel)
            print(f"[check] quant_matmul {fmt} {name} {M}x{K}->{N} bf16: "
                  f"{note}; abs err {e:.3g}; two launches bitwise equal: "
                  f"{same}")
            check(ok and same, f"quant_matmul {fmt} {name}")
            key = "quant_matmul" if fmt == "int8" else "quant_matmul_e4m3"
            worst[key] = max(worst[key], e)
    print(f"[check] quant_matmul fp8 bf16 out (sums in fp8 wgmma, ~14 "
          f"bits): worst err {worst_rel:.3g} of max |plain| over the "
          f"shapes above (tol 2e-2)")
    worst["quant_matmul_e4m3_bf16_rel"] = worst_rel
    # E4M3 with fp32 output (held to 1e-5): operands upcast exactly to
    # bf16, bf16 wgmma with fp32 accumulators
    M, K, N = QMM_SHAPES["qkv"]
    xq, wq, sx, sw = quant_operands(gen, M, K, N, "fp8")
    want = quant_dot_reference(xq, wq, sx, sw, "fp8", torch.float32)
    got = quant_matmul(xq, wq, sx, sw, "fp8", torch.float32)
    again = quant_matmul(xq, wq, sx, sw, "fp8", torch.float32)
    torch.cuda.synchronize()
    rel = (got - want).abs().max().item() / want.abs().max().item()
    same = torch.equal(got, again)
    print(f"[check] quant_matmul fp8 qkv {M}x{K}->{N} fp32 out (upcast to "
          f"bf16): err {rel:.3g} of max |plain| (tol 1e-5); two launches "
          f"bitwise equal: {same}")
    check(rel <= 1e-5 and same, f"quant_matmul E4M3 fp32 err {rel}")
    worst["quant_matmul_e4m3_fp32_rel"] = rel
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
        if fmt == "fp8":
            worst["fused_ffn_quant_e4m3"] = e
    # the engine each shape routes to (by shape and type, never by a
    # failure): wgmma for bf16 and for fp32 under quant up to d_model 512
    for dt, fmt, dd in ((bf16, None, 512), (bf16, "int8", 512),
                        (bf16, "fp8", 512), (torch.float32, "int8", 64),
                        (torch.float32, None, 64), (bf16, None, 1024)):
        print(f"[check] fused_ffn engine for {str(dt)[6:]} fmt "
              f"{fmt or 'none'} d_model {dd}: {ffn_engine(dt, fmt, dd)}")
    check(ffn_engine(bf16, "int8", 512) == "sm90"
          and ffn_engine(torch.float32, None, 64) == "wmma",
          "fused_ffn routing")
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
    """Rows 7, 8 (int8, E4M3) and 9 (int8, E4M3) at the record's
    training shape: kernel, plain, library yardstick, bound."""
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
    f8, a8 = quantize(f, scales[0], "fp8"), quantize(a, scales[2], "fp8")
    w1_8 = quantize(args[3], scales[1], "fp8")
    w2_8 = quantize(args[5], scales[3], "fp8")
    inv = [(1.0 / v).reshape(()) for v in scales.unbind()]
    for name, fmt in (("fused_ffn", None), ("fused_ffn_quant", "int8"),
                      ("fused_ffn_quant_e4m3", "fp8")):
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
        elif fmt == "int8":
            t["library"] = library(lambda: (torch._int_mm(fq, w1q.t()),
                                            torch._int_mm(aq, w2q.t())))
        else:
            t["library"] = library(lambda: (
                torch._scaled_mm(f8, w1_8.t(), scale_a=inv[0],
                                 scale_b=inv[1], out_dtype=bf16),
                torch._scaled_mm(a8, w2_8.t(), scale_a=inv[2],
                                 scale_b=inv[3], out_dtype=bf16)))
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
    ones whose lse a backward takes; a CUDA graph's capture counts once,
    its replays not at all: phase K counts those on the device)."""
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
         "--log_every", "8", "--no_plot", *flags]), defaults=defaults)
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
        out_s, got, l_short, s_steps, s_eval = run_path(cli, flags, 64,
                                                        build_dir, tag)
        n_fwd = s_steps + s_eval + (1 if quant else 0)
        want = path_counts(L, n_fwd, s_steps, ffn, quant,
                           train_fwd=s_steps + (1 if quant else 0))
        check(got == want, f"path {tag} launches {got} != {want}")
        print(f"[train {tag}] launches == the path's exact counts; losses "
              + " ".join(f"{x:.4f}" for x in l_short))
        short[tag] = got
    # path C's step time and the profile of one step: its 24 E4M3 GEMMs
    # (qkv, out and the flax FFN's two Dense per layer) are all in the
    # forward; the backward's straight-through GEMMs are cuBLAS
    cfg_c = out_s["cfg"]
    step_c = make_train_step(cfg_c)
    times = []
    for b in batches[:6]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        step_c(out_s["state"], b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    med_c = statistics.median(times[2:])
    kern = device_kernels(lambda: step_c(out_s["state"], prof_batch), n)
    print(f"[train C] step time median {med_c:.2f} ms over {len(times) - 2} "
          f"steps")
    print(profile_split(kern, n, med_c, f"train step path C "
                        f"(L={prof_batch['tokens'].shape[1]})"))
    top = sorted(kern.items(), key=lambda x: -x[1][0])[:10]
    print("[profile] top kernels of a path-C step (ms/step, launches/step): "
          + "; ".join(f"{k[:60]} {us / n / 1e3:.4f} x{c / n:.0f}"
                      for k, (us, c) in top))
    return {"launches": launches, "per_step": per_step, "step_ms": med,
            "step_ms_c": med_c, "state": state, "short": short}


def record_width_states(cli, flags, n: int):
    """(cfg, the first batch of the synthetic split on the card, ``n``
    train states at the record's width from the same seeded init)."""
    import torch

    from faster_distributed_training_tpu_torch.data.loader import BatchLoader
    from faster_distributed_training_tpu_torch.optim import build_optimizer
    from faster_distributed_training_tpu_torch.train.state import (
        create_train_state)
    from faster_distributed_training_tpu_torch.train.steps import to_device

    defaults = cli.TRANSFORMER_DEFAULTS
    cfg = cli.config_from_args(cli.build_parser(defaults=defaults).parse_args(
        ["--device", "cuda", "--dataset", "synthetic", *flags]),
        defaults=defaults)
    ds = cli.load_dataset(cfg, True)
    batch = to_device(next(iter(BatchLoader(ds, cfg.batch_size, epoch=0,
                                            seed=cfg.seed,
                                            max_len=cfg.seq_len))), "cuda")
    states = []
    for _ in range(n):
        model = cli.build_model(cfg, vocab_size=ds.vocab_size(),
                                device="cuda")
        model.init_weights(torch.Generator().manual_seed(cfg.seed))
        model.cuda()
        tx, _ = build_optimizer(cfg, 100)
        states.append(create_train_state(model, tx, cfg.seed))
    return cfg, batch, states


def two_step_diff(cli, flags):
    """One training step at the record's width, run twice from the same
    seeded state on the same batch with the same draws: (the number of
    parameter, buffer and optimizer leaves, the names of those whose bits
    differ, and on a difference what torch.use_deterministic_algorithms
    says of the step)."""
    import torch

    from faster_distributed_training_tpu_torch.train.steps import (
        make_train_step, step_draws)

    cfg, batch, states = record_width_states(cli, flags, 2)
    draws = step_draws(cfg.seed, 0, cfg.batch_size,
                       states[0].model.n_dropout_sites(), 0.99)
    step = make_train_step(cfg)
    for st in states:
        step(st, batch, draws)
    torch.cuda.synchronize()

    def leaves(st):
        out = {f"model/{k}": v for k, v in st.model.state_dict().items()}
        for part, tree in st.opt_state.items():
            if isinstance(tree, dict):
                out.update({f"opt/{part}/{k}": v for k, v in tree.items()
                            if torch.is_tensor(v)})
        return out

    a, b = leaves(states[0]), leaves(states[1])
    differ = sorted(k for k in a if not torch.equal(a[k], b[k]))
    print(f"[train] two identical steps at the record's width "
          f"({' '.join(flags) or 'slice 2'}): {len(a)} parameter, buffer "
          f"and optimizer leaves, {len(differ)} differ"
          + (f": {differ[:6]}" if differ else " (bitwise equal)"),
          flush=True)
    culprit = None
    if differ:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        try:
            step(states[0], batch, draws)
            torch.cuda.synchronize()
            culprit = "no op refused"
        except RuntimeError as e:
            culprit = str(e).splitlines()[0]
        finally:
            torch.use_deterministic_algorithms(False)
        print(f"[train] under torch.use_deterministic_algorithms: {culprit}",
              flush=True)
    return len(a), differ, culprit


def two_step_check(cli, flags) -> None:
    """``two_step_diff``, failing the smoke on any difference."""
    _, differ, culprit = two_step_diff(cli, flags)
    if differ:
        fail(f"two identical steps differ in {differ[:6]}; under "
             f"torch.use_deterministic_algorithms: {culprit}")


STEP_PATHS = {"2": [], "B": ["--ffn_impl", "pallas", "--quant", "int8"],
              "C": ["--quant", "fp8"]}


def steps_main(repo: str) -> int:
    """``--steps``: for the slice-2 path and paths B and C of the port at
    ``repo``, the [profile] split of one training step at the record's
    width (seeded init, four warm-up steps, host wall the median of four,
    device time over three) and the two-identical-steps comparison,
    reported and not held; then path E's split (``lm_step_split``).  Two
    trees compare in one call on one card:
    unpack the other commit into a git-ignored directory and run parent,
    change, change, parent."""
    import torch

    sys.path.insert(0, repo)
    from faster_distributed_training_tpu_torch import cli
    from faster_distributed_training_tpu_torch.data.loader import BatchLoader
    from faster_distributed_training_tpu_torch.ops import _build
    from faster_distributed_training_tpu_torch.train.steps import (
        make_train_step, to_device)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    build_s, _ = _build.build()
    print(f"[steps] the port at {repo}; kernels built in {build_s:.1f}s; "
          f"nvidia-smi: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    for tag, flags in STEP_PATHS.items():
        cfg, _, (state,) = record_width_states(cli, flags, 1)
        ds = cli.apply_subset(cli.load_dataset(cfg, True), 16)
        batches = [to_device(b, "cuda") for b in itertools.islice(
            BatchLoader(ds, cfg.batch_size, epoch=1, seed=cfg.seed,
                        max_len=cfg.seq_len), 9)]
        step = make_train_step(cfg)
        for b in batches[:4]:
            step(state, b)
        wall = []
        for b in batches[4:8]:
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(state, b)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t) * 1e3)
        n = 3
        kern = device_kernels(lambda: step(state, batches[8]), n)
        print(profile_split(kern, n, statistics.median(wall),
                            f"path {tag} step (L="
                            f"{batches[8]['tokens'].shape[1]})"), flush=True)
        two_step_diff(cli, flags)
    lm_step_split(cli)
    return 0


def lm_step_split(cli, vocab: int = 605) -> None:
    """Path E's step for ``--steps``: the next-token LM at the record's
    widths, tied head, B 4, L 8192, bf16, on one seeded batch of random
    tokens (``vocab`` is the size the port's WordPiece gives the
    synthetic corpus; no corpus is sharded here): the [profile] split of
    one step (two warm-up steps, host wall the median of three, device
    time over two)."""
    import numpy as np
    import torch

    from faster_distributed_training_tpu_torch.optim import build_optimizer
    from faster_distributed_training_tpu_torch.train.state import (
        create_train_state)
    from faster_distributed_training_tpu_torch.train.steps import (
        make_train_step, to_device)

    defaults = cli.TRANSFORMER_DEFAULTS
    cfg = cli.config_from_args(cli.build_parser(defaults=defaults).parse_args(
        ["--device", "cuda", "--task", "lm", "--seq_len", str(LONG["L"]),
         "--bs", str(LONG["B"]), "--precision", "bf16"]), defaults=defaults)
    model = cli.build_model(cfg, vocab_size=vocab, device="cuda")
    model.init_weights(torch.Generator().manual_seed(cfg.seed))
    model.cuda()
    tx, _ = build_optimizer(cfg, 100)
    state = create_train_state(model, tx, cfg.seed)
    tokens = np.random.default_rng(0).integers(
        1, vocab, size=(LONG["B"], LONG["L"])).astype(np.int32)
    batch = to_device({"tokens": tokens, "token_types": np.zeros_like(tokens),
                       "mask": np.ones_like(tokens),
                       "label": np.zeros(LONG["B"], np.int32)}, "cuda")
    step = make_train_step(cfg)
    for _ in range(2):
        step(state, batch)
    wall = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t) * 1e3)
    n = 2
    kern = device_kernels(lambda: step(state, batch), n)
    print(profile_split(kern, n, statistics.median(wall),
                        f"path E step (B {LONG['B']}, L {LONG['L']})"),
          flush=True)


def defaults_fallback_phase(cli, build_dir: str) -> None:
    """The transformer_test entry at its defaults (``--dataset agnews``)
    with no AG News CSVs under --data_dir: the JAX package's synthetic
    fallback, 4 steps on the card."""
    import shutil

    import numpy as np

    tmp = os.path.join(build_dir, "smoke_defaults")
    shutil.rmtree(tmp, ignore_errors=True)
    out = cli.main(["--device", "cuda", "--epoch", "1", "--subset_stride",
                    "187", "--no_plot", "--data_dir", os.path.join(tmp, "d"),
                    "--checkpoint_dir", os.path.join(tmp, "ck"),
                    "--log_every", "0"], defaults=cli.TRANSFORMER_DEFAULTS)
    shutil.rmtree(tmp, ignore_errors=True)
    cfg = out["cfg"]
    loss = out["history"]["train_loss"]
    print(f"[train] transformer_test defaults (--dataset {cfg.dataset}, no "
          f"CSVs): {out['state'].step} steps on the synthetic fallback "
          f"(12000 rows at subset stride 187), train loss {loss}, eval "
          f"accuracy {out['history']['test_acc']}", flush=True)
    check(cfg.dataset == "agnews" and out["state"].step == 4
          and bool(np.isfinite(loss).all()), "the defaults' fallback run")


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
               q, k, v, None, 0.1, 5), group="flash_fwd"),
           "kernel_p0": measure(lambda: fa.flash_attention_stats(
               q, k, v, None, 0.0, 5), group="flash_fwd"),
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
           "kernel_p0": measure(lambda: fa.flash_attention_bwd(
               q, k, v, out, lse, dout, None, 0.0, 5, lse_lo)),
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
    prim = {"kernel": measure(lambda: fa.flash_attention(q2, k2, v2),
                              group="flash_fwd"),
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
        p0 = (f" (dropout 0, like for like with SDPA: "
              f"{t['kernel_p0']['ms']:.5f})" if "kernel_p0" in t else "")
        if "kernel_only_ms" in t["kernel"]:
            p0 += (f" (kernel only {t['kernel']['kernel_only_ms']:.5f}"
                   + (f"; at dropout 0 {t['kernel_p0']['kernel_only_ms']:.5f}"
                      if "kernel_p0" in t else "") + ")")
        print(f"[timing] {name}: device ms per call ({t['kernel']['timer']})"
              f": kernel {t['kernel']['ms']:.5f}{p0}, plain (q-row chunked) "
              f"{t['plain']['ms']:.5f}, SDPA (no dropout) "
              + (f"{lib['ms']:.5f}" if lib else "n/a")
              + (f" (forward + backward {t['library_fwd_bwd']['ms']:.5f})"
                 if t.get("library_fwd_bwd") else "")
              + f"; per call incl. launch (events): kernel "
              f"{t['kernel']['call_ms']:.5f}, plain "
              f"{t['plain']['call_ms']:.5f}; bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']})", flush=True)
    return {"fwd": fwd, "bwd": bwd, "primal": prim}


def lm_phase(cli, build_dir: str, then=None) -> dict:
    """Path E: shard the synthetic corpus at seq 8192 with the port's
    writer, train the next-token LM on it at the record's widths (batch 4:
    8 steps + one padded eval batch) with exact launch counts, then its
    step time, tokens/s, peak memory and [profile] split, a fixed-batch
    learning probe and an fp32 LM step card vs CPU; then ``then(corpus)``
    (phase K's path-E part), its result under "then"."""
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
             "--log_every", "2", "--no_plot"]), defaults=defaults)
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
        del m_cpu, m_gpu
        return {"launches": launches, "rows": rows, "step_ms": med,
                "tokens_s": tok_s, "peak_bytes": peak, "busy_ms": busy,
                "probe": (probe_losses[0], probe_losses[-1]), **res,
                "then": then(corpus) if then is not None else None}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)



# -- slice 8: ResNet-50 / CIFAR-10 with NGD and mixup (phase R) --------------

CUSOLVER_WORDS = ("syev", "sytrd", "stedc", "steqr", "sterf", "ormtr",
                  "orgtr", "larf", "lacpy", "cusolver", "jacobi")


def resnet_group(name: str) -> str:
    """The [profile R] group of a device kernel's name."""
    low = name.lower()
    if any(w in low for w in CUSOLVER_WORDS):
        return "eigh (cuSOLVER)"
    if "multi_tensor" in low or "foreach" in low:
        return "optimizer foreach"
    if "dgrad" in low or "wgrad" in low or ("bwd" in low and "conv" in low):
        return "cuDNN conv backward"
    if any(w in low for w in ("fprop", "conv", "cudnn", "implicit")):
        return "cuDNN conv forward"
    if any(w in low for w in ("gemm", "nvjet", "cutlass", "xmma")):
        return "GEMM (NGD bmm, fc)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "BN / elementwise / reductions"


def full_rank(shape) -> bool:
    """Every preconditioned axis of a (JAX-layout) leaf has N >= rank."""
    size = 1
    for d in shape:
        size *= int(d)
    return all(size // d >= min((d + 1) // 2, 80)
               for d in shape if 1 < d <= 8192)


def ngd_updating(t: int) -> bool:
    """Whether NGD refreshes its factors at counter ``t``."""
    return t < 10 or t % 4 == 0


def resnet_cfg(cli, argv):
    defaults = cli.RESNET50_DEFAULTS
    return cli.config_from_args(cli.build_parser(
        defaults=defaults).parse_args(
        ["--device", "cuda", "--dataset", "synthetic", "--no_plot",
         "--no_telemetry", "--log_every", "0", *argv]), defaults=defaults)


def timed_training(cli, cfg):
    """``cli.run_training(cfg)`` with every step synchronized and timed:
    (result, [(NGD counter before the step or None, host ms)], the
    per-step losses)."""
    import torch

    from faster_distributed_training_tpu_torch.train import steps as steps_mod

    times, losses = [], []
    make_step = steps_mod.make_train_step

    def timing(cfg_):
        inner = make_step(cfg_)

        def run(state, batch, draws=None):
            t = state.opt_state.get("ngd", {}).get("t")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = inner(state, batch, draws)
            torch.cuda.synchronize()
            times.append((t, (time.perf_counter() - t0) * 1e3))
            losses.append(float(metrics["loss"]))
            return state, metrics
        return run

    steps_mod.make_train_step = timing
    try:
        out = cli.run_training(cfg, log=lambda line: print(line, flush=True))
    finally:
        steps_mod.make_train_step = make_step
    return out, times, losses


def resnet_split(kern: dict, n: int, wall_ms: float, what: str) -> str:
    """One [profile R] line: device ms a step by group, launches, busy
    share, and the top kernels."""
    groups = {}
    for name, (us, _) in kern.items():
        g = resnet_group(name)
        groups[g] = groups.get(g, 0.0) + us / n / 1e3
    busy = sum(groups.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
    return (f"[profile R] {what}: {wall_ms:.3f} ms host wall, "
            f"{launches_per_call(kern, n):.0f} device launches, device busy "
            f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}%): "
            + ", ".join(f"{g} {v:.3f}" for g, v in
                        sorted(groups.items(), key=lambda x: -x[1]))
            + "; top kernels (ms/step, launches/step): "
            + "; ".join(f"{k[:70]} {us / n / 1e3:.3f} x{c / n:.0f}"
                        for k, (us, c) in top))


def count_syncs(fn) -> int:
    """Host syncs ``fn`` makes, from torch's sync debug warnings."""
    import warnings

    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def resnet_batch(cfg, n_images=None):
    """The first batch of the synthetic train split on the card."""
    from faster_distributed_training_tpu_torch.data.loader import BatchLoader
    from faster_distributed_training_tpu_torch.data.synthetic import (
        synthetic_cifar)
    from faster_distributed_training_tpu_torch.train.steps import to_device

    data = synthetic_cifar(n=n_images or cfg.batch_size, seed=0)
    return to_device(next(iter(BatchLoader(data, cfg.batch_size, epoch=0,
                                           seed=cfg.seed))), "cuda")


def resnet_states(cli, cfg, n: int):
    """``n`` train states of ``cfg`` on the card from one seeded init."""
    import torch

    from faster_distributed_training_tpu_torch.optim import (build_optimizer,
                                                             layouts_of)
    from faster_distributed_training_tpu_torch.train.state import (
        create_train_state)

    states = []
    for _ in range(n):
        gen = torch.Generator().manual_seed(cfg.seed)
        model = cli.build_model(cfg).init_weights(gen)
        model.cuda().to(memory_format=torch.channels_last)
        tx, _ = build_optimizer(cfg, 8, layouts=layouts_of(model))
        extra = {k: v.cuda() for k, v in cli.resnet_extra_leaves(
            cfg, gen).items()}
        states.append(create_train_state(model, tx, cfg.seed, extra=extra))
    return states


def leaf_errs(got: dict, want: dict) -> dict:
    """Each leaf's max |got - want| over its own max |want|."""
    return {k: ((got[k].detach().cpu().double() - w.double()).abs().max()
                / w.double().abs().max().clamp_min(1e-30)).item()
            for k, w in want.items()}


def resnet_card_vs_cpu(cli) -> dict:
    """R3's numerics: one fp32 resnet18 step (batch 8 at 16x16, NGD +
    meta mixup's draws) on the card and the CPU, each gradient leaf
    measured against an fp64 CPU step: the card under the main path's
    cuDNN flags (deterministic, autotuned), with autotuning off and with
    cuDNN off; the CPU in fp32 with oneDNN's convs and without them
    (another summation order).  The card in fp64 is held to the CPU in fp64 on
    every leaf.  Then one NGD step (the lazy init and an update) of
    resnet18-shaped random directions on the card and the CPU."""
    import numpy as np
    import torch

    from faster_distributed_training_tpu_torch.data.augment import (
        augment_batch)
    from faster_distributed_training_tpu_torch.models import get_model
    from faster_distributed_training_tpu_torch.optim.ngd import (
        NGDHyperParams, ScaleByNGD, build_plan, ngd_invariants)
    from faster_distributed_training_tpu_torch.train.state import TrainState
    from faster_distributed_training_tpu_torch.train.steps import (
        image_draws, image_loss_and_grads, to_device)

    small = resnet_cfg(cli, ["--model", "resnet18", "--bs", "8",
                             "--precision", "fp32", "--ngd",
                             "--meta_learning"])
    (s_g,) = resnet_states(cli, small, 1)
    sd = {k: v.cpu() for k, v in s_g.model.state_dict().items()}

    def state_on(dev, dtype):
        m = get_model("resnet18", 10, dtype=dtype).to(dtype)
        m.load_state_dict(sd)
        m.to(dev)
        if dev == "cuda":
            m.to(memory_format=torch.channels_last)
        return TrainState(model=m, tx=None, opt_state={}, extra={
            k: v.detach().to(dev, dtype).requires_grad_()
            for k, v in s_g.extra.items()})

    rng = np.random.default_rng(11)
    batch = {"image": rng.integers(0, 256, (8, 16, 16, 3), dtype=np.uint8),
             "label": rng.integers(0, 10, 8).astype(np.int32)}
    draws = image_draws(0, 0, 8, small.alpha)

    # the in-step augment (normalize, crop, flip) is bitwise the CPU's
    aug = [augment_batch(torch.tensor(batch["image"]).to(dev),
                         torch.tensor(draws.crop), torch.tensor(draws.flip))
           .cpu() for dev in ("cpu", "cuda")]
    check(torch.equal(*aug), "R3 the card's augment differs from the CPU's")

    # the fp64 steps take the augmented images in fp64, so that the
    # meta mixup (in the images' dtype, as JAX's) runs in fp64 too; the
    # logits and the loss stay fp32 (as JAX's), so the fp64 step carries
    # the fp32 rounding of the cross-entropy, ~1e-7 of a leaf
    batch64 = {"image": aug[0].double().numpy(), "label": batch["label"]}

    def step(st, dev, b=batch):
        loss, grads, *_ = image_loss_and_grads(st, to_device(b, dev),
                                               draws, "meta")
        return loss.item(), grads

    l_64, g_64 = step(state_on("cpu", torch.float64), "cpu", batch64)
    l_c, g_c = step(state_on("cpu", torch.float32), "cpu")
    mkldnn = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        _, g_c1 = step(state_on("cpu", torch.float32), "cpu")
    finally:
        torch.backends.mkldnn.enabled = mkldnn
    cudnn = torch.backends.cudnn
    flags = (cudnn.enabled, cudnn.deterministic, cudnn.benchmark)
    card = {}
    try:
        for arm, (on, det, bench) in (("autotuned", (True, True, True)),
                                      ("heuristic", (True, True, False)),
                                      ("no cuDNN", (False, True, False))):
            cudnn.enabled, cudnn.deterministic, cudnn.benchmark = (on, det,
                                                                   bench)
            card[arm] = step(s_g, "cuda")
        cudnn.enabled, cudnn.deterministic, cudnn.benchmark = True, True, True
        l_g64, g_g64 = step(state_on("cuda", torch.float64), "cuda",
                            batch64)
    finally:
        cudnn.enabled, cudnn.deterministic, cudnn.benchmark = flags
    l_g, g_g = card["autotuned"]
    e_loss = abs(l_g - l_c)
    e_grad, leaf = grad_err(g_g, g_c)
    cpu_e = {"CPU": leaf_errs(g_c, g_64), "CPU without oneDNN": leaf_errs(
        g_c1, g_64)}
    card_e = {arm: leaf_errs(g, g_64) for arm, (_, g) in card.items()}
    e_64 = max(leaf_errs(g_g64, g_64).values())
    # the CPU's fp32 scale on a leaf: the larger of its two summation
    # orders' errors.  The card without cuDNN is held to twice it; with
    # cuDNN (its fp32 conv algorithms, the same under heuristics and
    # autotuning) to three times: the CPU's own two orders lie up to
    # 2.8x apart on one leaf
    scale = {k: max(e[k] for e in cpu_e.values()) for k in g_64}
    factor = {"autotuned": 3, "heuristic": 3, "no cuDNN": 2}
    over = {arm: sorted(((k, round(e[k], 9), round(e[k] / scale[k], 2))
                         for k in e if e[k] > factor[arm] * scale[k]),
                        key=lambda x: -x[2])
            for arm, e in card_e.items()}
    worst_ratio = {arm: max(e[k] / max(scale[k], 1e-30) for k in e)
                   for arm, e in card_e.items()}
    print(f"[train R3] fp32 resnet18 step, batch 8 at 16x16, meta mixup, "
          f"TF32 off: loss card {l_g:.6f} vs CPU {l_c:.6f} (err "
          f"{e_loss:.3g}, tol 1e-5); grads card vs CPU max {e_grad:.3g} of "
          f"the leaf's max |CPU grad| ({leaf}); augment bitwise; fp64 card "
          f"vs fp64 CPU: loss "
          f"{abs(l_g64 - l_64):.3g}, worst leaf {e_64:.3g} (tol 1e-6)",
          flush=True)
    for name, e in (*cpu_e.items(), *card_e.items()):
        worst = max(e, key=e.get)
        print(f"[train R3] grads against fp64, {name}: worst leaf "
              f"{e[worst]:.3g} ({worst}), median leaf "
              f"{statistics.median(e.values()):.3g}"
              + (f"; worst leaf over the CPU's larger error on it "
                 f"{worst_ratio[name]:.3g}x, leaves over {factor[name]}x: "
                 f"{len(over[name])} {over[name][:6]}"
                 if name in over else ""), flush=True)
    e1, e2 = cpu_e.values()
    cross = max(max(e1[k], e2[k]) / max(min(e1[k], e2[k]), 1e-30)
                for k in g_64)
    print(f"[train R3] the CPU's two fp32 orders: on one leaf one's error "
          f"is up to {cross:.3g}x the other's", flush=True)
    check(e_loss <= 1e-5, "R3 card loss differs from the CPU's")
    for arm in ("autotuned", "no cuDNN"):
        check(not over[arm],
              f"R3 card grads ({arm}) further from fp64 than "
              f"{factor[arm]}x the CPU's larger fp32 error on {over[arm]}")
    check(e_64 <= 1e-6 and abs(l_g64 - l_64) <= 1e-6,
          "R3 fp64 card step differs from the fp64 CPU step")

    # NGD: one step (the lazy init and an update) on the card and the
    # CPU from the same random directions of resnet18's leaves.  fp32:
    # the updates of the leaves with N >= rank on every axis, and the
    # norm of every update (the finalize keeps the raw norm, N < rank
    # leaves included).  fp64: every leaf's update and every group's
    # sorted d, rho and W^T diag(d) W.  In fp32 a d that is a small
    # difference of near-equal eigenvalues differs between any two
    # eigensolvers.  An N < rank axis's factor has a near-degenerate
    # null space, so its update moves ~1e-4 between eigensolvers even
    # in fp64: the CPU alone moves as far when its directions move by
    # one fp32 ulp, which the run measures beside it.  A real batch of 8
    # has less rank than the factors, so random directions stand in.
    layouts = s_g.model.jax_layouts()
    gen = torch.Generator().manual_seed(5)
    dirs = {k: torch.randn(v.shape, generator=gen) for k, v in g_c.items()}
    nudged = {k: v * (1.0 + 2.0 ** -23 * torch.randn(v.shape, generator=gen))
              for k, v in dirs.items()}
    jshape = {k: [v.shape[a] for a in layouts.get(k, range(v.dim()))]
              for k, v in dirs.items()}
    full = [k for k in dirs if full_rank(jshape[k])]
    names = list(dirs)
    groups = {key: all(names[i] in full for i in members)
              for rnd in build_plan([jshape[k] for k in names],
                                    NGDHyperParams())
              for key, members in rnd.items()}

    def ngd_step(dtype, dev, d=dirs):
        ngd = ScaleByNGD(layouts=layouts, precond_dtype=dtype)
        st = ngd.init({k: v.to(dev) for k, v in d.items()})
        out = ngd.update({k: v.to(dev) for k, v in d.items()}, st)
        return ({k: v.cpu() for k, v in out.items()},
                {key: {n: t.cpu() for n, t in g.items()}
                 for key, g in st["groups"].items()})

    def ngd_diff(got, want):
        """(max rel update error by leaf, max rel error of the sorted d,
        rho and W^T diag(d) W by "all N >= rank" group class)."""
        upd = {k: ((got[0][k] - want[0][k]).abs().max()
                   / want[0][k].abs().max()).item() for k in want[0]}
        inv = {True: 0.0, False: 0.0}
        for key, is_full in groups.items():
            gg, gc = got[1][key], want[1][key]
            for x, y in ((gg["d"].sort(dim=1).values,
                          gc["d"].sort(dim=1).values),
                         (gg["rho"], gc["rho"]),
                         (ngd_invariants(gg["w"], gg["d"]),
                          ngd_invariants(gc["w"], gc["d"]))):
                inv[is_full] = max(inv[is_full], ((x - y).abs().max()
                                                  / y.abs().max()).item())
        return upd, inv

    pre_c, pre_g = (ngd_step(torch.float32, d)[0] for d in ("cpu", "cuda"))
    e_pre = max(((pre_g[k] - pre_c[k]).abs().max()
                 / pre_c[k].abs().max()).item() for k in full)
    e_norm = max(abs((pre_g[k].double().norm()
                      / dirs[k].double().norm()).item() - 1.0)
                 for k in dirs)
    c64 = ngd_step(torch.float64, "cpu")
    upd, inv = ngd_diff(ngd_step(torch.float64, "cuda"), c64)
    w_upd, w_inv = ngd_diff(ngd_step(torch.float64, "cpu", nudged), c64)
    e_low64 = max(e for k, e in upd.items() if k not in full)
    w_low64 = max(e for k, e in w_upd.items() if k not in full)
    n_low = len(dirs) - len(full)
    n_full_groups = sum(groups.values())
    print(f"[train R3] one NGD step on resnet18-shaped random directions, "
          f"card vs CPU: fp32 updates of the {len(full)} leaves with N >= "
          f"rank on every axis {e_pre:.3g} (tol 1e-4); fp32 update norm "
          f"over the raw norm, all {len(dirs)} leaves, worst |ratio - 1| "
          f"{e_norm:.3g} (tol 1e-5); fp64 updates of the {n_low} leaves "
          f"with an N < rank axis {e_low64:.3g} (tol 1e-3; the CPU against "
          f"itself with its directions moved by one fp32 ulp "
          f"{w_low64:.3g}), of the others "
          f"{max(upd[k] for k in full):.3g}; fp64 sorted d, rho and W^T "
          f"diag(d) W of the {n_full_groups} groups of N >= rank leaves "
          f"{inv[True]:.3g} (tol 1e-6), of the other "
          f"{len(groups) - n_full_groups} {inv[False]:.3g} (tol 5e-3; the "
          f"CPU moved by one ulp {w_inv[False]:.3g})", flush=True)
    check(e_pre <= 1e-4 and e_norm <= 1e-5 and e_low64 <= 1e-3
          and inv[True] <= 1e-6 and inv[False] <= 5e-3,
          "R3 NGD on the card differs from the CPU")
    return {"r3_loss_err": e_loss, "r3_grad_err": e_grad,
            "r3_grad_err64": {k: max(e.values())
                              for k, e in (*cpu_e.items(),
                                           *card_e.items())},
            "r3_grad_over": {k: len(v) for k, v in over.items()},
            "r3_grad_worst_ratio": worst_ratio,
            "r3_cpu_order_spread": cross,
            "r3_fp64_err": e_64, "r3_ngd_update_err": e_pre,
            "r3_ngd_norm_err": e_norm, "r3_ngd_low_rank_err64": e_low64,
            "r3_ngd_low_rank_ulp64": w_low64, "r3_ngd_inv_err": inv[True],
            "r3_ngd_low_inv_err": inv[False],
            "r3_ngd_low_inv_ulp": w_inv[False]}


def resnet_phase(cli, build_dir: str) -> dict:
    """Phase R: R1 the flagship (resnet50, batch 512, bf16, NGD + meta
    mixup, 2 epochs of the 4096-image synthetic split and its evals),
    R2 the resnet50_test record (MADGRAD + cosine, static mixup) and SGD
    for 4 steps each, R3 checks: an fp32 resnet18 step card vs CPU with
    NGD's invariants, two identical R1 steps bitwise, and 4 fp16
    resnet18 steps with the loss scale."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from faster_distributed_training_tpu_torch.train.state import (
        state_leaves)
    from faster_distributed_training_tpu_torch.train.steps import (
        image_draws, make_train_step)

    tmp = tempfile.mkdtemp(prefix="smoke_resnet_", dir=build_dir)
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    res = {}
    try:
        # -- R1: the flagship ----------------------------------------------
        cfg = resnet_cfg(cli, ["--ngd", "--meta_learning", "--epoch", "2",
                               "--checkpoint_dir", os.path.join(tmp, "r1")])
        check(cfg.model == "resnet50" and cfg.batch_size == 512
              and cfg.precision == "bf16", "R1 is not the record's shape")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.monotonic()
        out, times, losses = timed_training(cli, cfg)
        r1_s = time.monotonic() - t0
        counts = read_counts()
        hist = out["history"]
        upd = [ms for t, ms in times if ngd_updating(t)]
        non = [ms for t, ms in times if not ngd_updating(t)]
        check(len(times) == 16 and len(non) == 5,
              f"R1 ran {len(times)} steps ({len(non)} without an update)")
        check(all(v == 0 for v in counts.values()),
              f"the ResNet path launched a hand kernel: {counts}")
        check(bool(np.isfinite(losses).all()), "R1 non-finite loss")
        med_u, med_n = statistics.median(upd[1:]), statistics.median(non)
        peak = torch.cuda.max_memory_allocated()
        res.update(r1_update_ms=med_u, r1_non_update_ms=med_n,
                   r1_first_ms=times[0][1], r1_img_s=512e3 / med_n,
                   r1_img_s_update=512e3 / med_u, r1_peak=peak,
                   r1_train_loss=hist["train_loss"][-1],
                   r1_train_acc=hist["train_acc"][-1],
                   r1_test_loss=hist["test_loss"][-1],
                   r1_test_acc=hist["test_acc"][-1],
                   r1_epoch_s=hist["epoch_time"])
        print(f"[train R1] resnet50 bs 512 bf16 --ngd --meta_learning, "
              f"16 steps + 2 evals of 1024 images in {r1_s:.1f}s; step "
              f"time median: update {med_u:.2f} ms (steps 1-9, 12; the "
              f"init step 0 {times[0][1]:.2f} ms), non-update {med_n:.2f} "
              f"ms (steps 10, 11, 13-15); {512e3 / med_n:.0f} img/s "
              f"without an update, {512e3 / med_u:.0f} with; peak memory "
              f"{peak / 2**30:.2f} GiB; hand-kernel launches {counts} "
              f"(the path has none: cuDNN convs); train loss "
              f"{hist['train_loss']} acc {hist['train_acc']}, test loss "
              f"{hist['test_loss']} acc {hist['test_acc']}", flush=True)

        # one update and one non-update step of R1's final state: the
        # device split, launches, busy share and host syncs
        state = out["state"]
        batch = resnet_batch(cfg)
        step = make_train_step(cfg)

        def one(t):
            state.opt_state["ngd"]["t"] = t
            step(state, batch)

        for kind, t in (("update", 12), ("non-update", 13)):
            one(t)
            torch.cuda.synchronize()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                one(t)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            kern = device_kernels(lambda: one(t), 2)
            wall = statistics.median(walls)
            busy = sum(us for us, _ in kern.values()) / 2 / 1e3
            syncs = count_syncs(lambda: one(t))
            res[f"r1_{kind}_split"] = {
                g: sum(us for name, (us, _) in kern.items()
                       if resnet_group(name) == g) / 2 / 1e3
                for g in {resnet_group(k) for k in kern}}
            res[f"r1_{kind}_launches"] = launches_per_call(kern, 2)
            res[f"r1_{kind}_busy"] = busy / wall
            res[f"r1_{kind}_syncs"] = syncs
            print(resnet_split(kern, 2, wall, f"R1 {kind} step (NGD t={t})")
                  + f"; host syncs {syncs}", flush=True)
        # a fixed-batch learning probe at the record's lr 0.1: a fresh
        # state from the seeded init takes 12 steps on one batch with
        # fixed draws (NGD's init, then always-update steps).  From the
        # seeded init both packages' losses fall at lr 0.1 in fp32 on the
        # CPU (tests/resnet_probe_witness.py); from a state that has
        # trained a few steps the course depends on fp32 rounding, which
        # the two packages do not share (resnet50's fp32 gradient at the
        # init lies percents from its fp64 gradient in either package)
        (fresh,) = resnet_states(cli, cfg, 1)
        draws = image_draws(cfg.seed, 0, cfg.batch_size, cfg.alpha)
        probe = []
        for _ in range(12):
            _, m = step(fresh, batch, draws)
            probe.append(float(m["loss"]))
        res["r1_probe"] = probe
        print(f"[train R1] one fixed batch and draws, 12 steps from the "
              f"seeded init at lr {cfg.lr}: loss {probe[0]:.4f} -> "
              f"{probe[-1]:.4f} ({', '.join(f'{v:.3f}' for v in probe)})",
              flush=True)
        check(bool(np.isfinite(probe).all())
              and statistics.mean(probe[-4:]) < probe[0],
              "R1's fixed-batch loss did not fall")
        del fresh
        # what cuDNN determinism costs (benchmark on in both arms)
        det_ms = {}
        for flag in (False, True):
            torch.backends.cudnn.deterministic = flag
            one(13)
            torch.cuda.synchronize()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                one(13)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            det_ms[flag] = statistics.median(walls)
        torch.backends.cudnn.deterministic = True
        res["r1_det_ms"] = det_ms
        print(f"[train R1] cuDNN determinism: non-update step "
              f"{det_ms[True]:.2f} ms deterministic, {det_ms[False]:.2f} ms "
              f"not (benchmark on in both)", flush=True)
        del out, state, step, batch
        torch.cuda.empty_cache()

        # -- R2: the resnet50_test record, and SGD at the same shape -------
        for tag, argv in (("madgrad", []),
                          ("sgd", ["--optimizer", "sgd", "--meta_learning"])):
            cfg2 = resnet_cfg(cli, ["--subset_stride", "2", "--epoch", "1",
                                    "--checkpoint_dir",
                                    os.path.join(tmp, tag), *argv])
            out2, times2, losses2 = timed_training(cli, cfg2)
            check(len(times2) == 4 and bool(np.isfinite(losses2).all()),
                  f"R2 {tag}: {len(times2)} steps, losses {losses2}")
            res[f"r2_{tag}_ms"] = statistics.median(
                [ms for _, ms in times2[1:]])
            res[f"r2_{tag}_loss"] = losses2
            del out2
        print(f"[train R2] resnet50_test record (MADGRAD + cosine, static "
              f"mixup 0.2), 4 steps: step median {res['r2_madgrad_ms']:.2f}"
              f" ms, losses {res['r2_madgrad_loss']}; SGD + meta mixup at "
              f"the same shape {res['r2_sgd_ms']:.2f} ms; NGD over SGD: "
              f"{med_n - res['r2_sgd_ms']:+.2f} ms a non-update step "
              f"({100 * (med_n / res['r2_sgd_ms'] - 1):+.1f}%), "
              f"{med_u - res['r2_sgd_ms']:+.2f} ms an update step "
              f"({100 * (med_u / res['r2_sgd_ms'] - 1):+.1f}%)", flush=True)

        # -- R3: an fp32 resnet18 step and an NGD step, card against CPU --
        res.update(resnet_card_vs_cpu(cli))

        # -- R3: two identical R1 steps, bitwise --------------------------
        states = resnet_states(cli, cfg, 2)
        batch = resnet_batch(cfg)
        step = make_train_step(cfg)
        for st in states:
            step(st, batch)
            step(st, batch)
        torch.cuda.synchronize()
        a, b = (state_leaves(s) for s in states)
        differ = sorted(k for k in a if not torch.equal(a[k], b[k]))
        res["r3_leaves"] = len(a)
        print(f"[train R3] two identical R1 steps (resnet50 bs 512 bf16, "
              f"NGD init + update, meta mixup): {len(a)} parameter, buffer, "
              f"lambda, NGD and momentum leaves, {len(differ)} differ"
              + (f": {differ[:6]}" if differ else " (bitwise equal)"),
              flush=True)
        check(not differ, f"two identical ResNet steps differ: {differ[:6]}")
        del states, a, b, step, batch
        torch.cuda.empty_cache()

        # -- R3: --precision fp16 on resnet18, 4 steps ---------------------
        cfg16 = resnet_cfg(cli, ["--model", "resnet18", "--precision",
                                 "fp16", "--ngd", "--bs", "128",
                                 "--subset_stride", "8", "--epoch", "1",
                                 "--checkpoint_dir",
                                 os.path.join(tmp, "fp16")])
        out16, times16, losses16 = timed_training(cli, cfg16)
        scale = float(out16["state"].loss_scale.scale)
        res.update(r3_fp16_losses=losses16, r3_fp16_scale=scale)
        print(f"[train R3] --precision fp16 (fp32 compute, dynamic loss "
              f"scale) resnet18 bs 128, 4 steps: losses {losses16}, loss "
              f"scale {scale:g}, growth count "
              f"{int(out16['state'].loss_scale.growth_count)}", flush=True)
        check(len(times16) == 4 and bool(np.isfinite(losses16).all())
              and scale > 0, "R3 fp16 run failed")
        check(res["r1_non-update_syncs"] == 0,
              f"a non-update R1 step made {res['r1_non-update_syncs']} "
              f"host syncs")
        return res
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
        shutil.rmtree(tmp, ignore_errors=True)


# -- slice 9: K steps a dispatch (phase K) and --remat (phase M) --------------

LAUNCH_API = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
              "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")
K_STRIDE = 32            # the slice-2 record on 128 rows: 8 steps of 16


def record_cfg(cli, flags, tag: str, build_dir: str):
    """The transformer_test record on the card (synthetic split) with
    ``flags``, its own checkpoint directory."""
    import shutil

    ckdir = os.path.join(build_dir, f"smoke_ckpt_{tag}")
    shutil.rmtree(ckdir, ignore_errors=True)
    defaults = cli.TRANSFORMER_DEFAULTS
    return cli.config_from_args(cli.build_parser(defaults=defaults).parse_args(
        ["--device", "cuda", "--dataset", "synthetic", "--epoch", "1",
         "--checkpoint_dir", ckdir, "--log_every", "0", "--no_plot",
         *flags]), defaults=defaults)


def counted_run(cli, cfg, tag: str) -> tuple:
    """``cli.run_training(cfg)`` with the launch counts set to 0 just
    before and read just after: (out, every state leaf, counts).  Under a
    dispatch the counts hold the wrappers' calls (the eager steps' and
    the capture's), not the replays' launches."""
    import torch

    from faster_distributed_training_tpu_torch.train.state import (
        state_leaves)

    reset_counts()
    t0 = time.monotonic()
    out = cli.run_training(cfg, log=lambda line: print(line, flush=True))
    torch.cuda.synchronize()
    counts = read_counts()
    disp = out["trainer"].dispatch
    extra = ""
    if disp is not None:
        extra = (f"; dispatch K={disp.k}: {disp.eager_steps} eager step(s), "
                 f"replays {sum(disp.replays.values())} of "
                 f"{len(disp.graphs)} graph(s)")
    print(f"[dispatch {tag}] {out['state'].step} steps in "
          f"{time.monotonic() - t0:.1f}s wall; launches {counts}{extra}",
          flush=True)
    leaves = {k: v.detach().clone() for k, v in
              state_leaves(out["state"]).items()}
    return out, leaves, counts


def bitwise(tag: str, want: dict, got: dict) -> int:
    import torch

    check(want.keys() == got.keys(), f"{tag}: state leaves differ in name")
    bad = [k for k in want if not torch.equal(want[k], got[k])]
    print(f"[dispatch {tag}] {len(want)} state leaves (parameters, buffers, "
          f"optimizer): {len(want) - len(bad)} bitwise equal"
          + (f"; differing: {bad[:8]}" if bad else ""), flush=True)
    check(not bad, f"{tag}: {len(bad)} leaves differ, first {bad[:4]}")
    return len(want)


def seed_replay_check() -> dict:
    """Each seed-taking kernel at the paths' shapes captured once as a
    CUDA graph and replayed with three seeds written to its seed buffer:
    bitwise equal to eager launches with those seeds, three different
    outputs.  Returns {kernel: replays checked}."""
    import torch

    from faster_distributed_training_tpu_torch.ops import flash_attention as fa
    from faster_distributed_training_tpu_torch.ops.fused_ffn import (
        ffn_fwd, ffn_fwd_generalized)

    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = qkv_views(16, 8, 512, 64, torch.bfloat16, gen)
    mask = ragged_mask(16, 512, gen)
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    out, lse, lse_lo = fa.flash_attention_stats(q, k, v, mask, 0.1, 7)
    h, ln_s, ln_b, w1, b1, w2, b2 = ffn_inputs(gen, *FFN_SHAPE,
                                                torch.bfloat16)
    scales = torch.tensor(FFN_SCALES, device="cuda")
    s1 = torch.zeros((), dtype=torch.int64, device="cuda")
    s2 = torch.zeros((), dtype=torch.int64, device="cuda")
    cases = {
        "flash_fwd (rows 1, 2)": lambda a, b: (
            fa.flash_attention(q, k, v, mask, 0.1, a),),
        "flash_fwd_stats (rows 4, 5)": lambda a, b: fa.flash_attention_stats(
            q, k, v, mask, 0.1, a),
        "flash_bwd (rows 3-5)": lambda a, b: fa.flash_attention_bwd(
            q, k, v, out, lse, dout, mask, 0.1, a, lse_lo),
        "fused_ffn (row 7)": lambda a, b: (ffn_fwd(
            h, ln_s, ln_b, w1, b1, w2, b2, a, b, 0.1, 0.1, 1e-6),),
        "fused_ffn_quant int8 (row 8)": lambda a, b: ffn_fwd_generalized(
            h, ln_s, ln_b, w1, b1, w2, b2, (a, b, 0, 0, 0), scales, 0.1, 0.1,
            1e-6, 1, 1, FFN_SHAPE[2], "int8")}
    seeds = [(1, 0x1234567), (0x9E3779B9, 5), (0xFFFFFFFF, 0x89ABCDE)]
    done = {}
    for name, fn in cases.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(s1, s2)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = fn(s1, s2)
        replayed = []
        for a, b in seeds:
            s1.fill_(a)
            s2.fill_(b)
            graph.replay()
            replayed.append(tuple(t.clone() for t in outs))
        torch.cuda.synchronize()
        for (a, b), got in zip(seeds, replayed):
            want = fn(a, b)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(got, want)),
                  f"{name}: a graph replay with seeds {a:#x}, {b:#x} "
                  f"differs from the eager launch")
        firsts = [r[0] for r in replayed]
        check(not torch.equal(firsts[0], firsts[1])
              and not torch.equal(firsts[1], firsts[2]),
              f"{name}: two seeds gave the same output")
        done[name] = len(seeds)
        del graph
    print(f"[dispatch kernels] each seed kernel captured once and replayed "
          f"with 3 seeds written to its device seed buffer: bitwise equal to "
          f"eager launches with those seeds, 3 different masks: "
          f"{', '.join(done)}", flush=True)
    return done


def dispatch_timing(what: str, run_one, kk: int, steps: int,
                    tokens: int, expect: dict = None) -> dict:
    """Host wall a step (median over synchronized dispatches of ``kk``
    steps, ``run_one()`` runs one), device ms a step and busy share,
    host-side launch calls a step (kernel launches plus graph launches,
    the CUDA runtime calls torch.profiler records), tokens (or images) a
    second and the hand kernels' device launches in one dispatch
    (``hand``).  The profiler can lose records of a graph's replays and
    never adds any (three profiles of one K=16 dispatch of the record
    held 58,637 to 60,234 kernel records, H100): with ``expect`` (the
    counts due), up to two more dispatches are profiled while a count
    falls short, and each kernel's largest count is kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run_one()                                   # warm-up (and capture)
    torch.cuda.synchronize()
    times = []
    for _ in range(max(steps // kk, 2)):
        t0 = time.perf_counter()
        run_one()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / kk)
    wall = statistics.median(times)
    # the device time from the CUDA activity alone (with the CPU's on, a
    # CPU op's entry repeats its kernels' time); the launch calls from the
    # runtime API events of a second, CPU + CUDA, profile
    kern = device_kernels(run_one, 1)
    dev = sum(us for us, _ in kern.values()) / kk / 1e3
    hand, profiles = hand_launches(kern), 1
    while expect is not None and hand != expect and profiles < 3:
        more = hand_launches(device_kernels(run_one, 1))
        hand = {n: max(hand.get(n, 0), more.get(n, 0))
                for n in hand.keys() | more.keys()}
        profiles += 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_one()
        torch.cuda.synchronize()
    calls = sum(e.count for e in prof.key_averages() if e.key in LAUNCH_API)
    got = {"wall_ms": wall, "device_ms": dev, "busy": dev / wall,
           "launch_calls": calls / kk, "per_s": tokens / (wall / 1e3),
           "k": kk, "hand": hand, "profiles": profiles}
    print(f"[dispatch timing] {what}: host wall {wall:.3f} ms a step "
          f"(median of {len(times)} dispatches of {kk}), device "
          f"{dev:.3f} ms a step, busy {100 * got['busy']:.1f}%, host launch "
          f"calls {got['launch_calls']:.1f} a step, {got['per_s']:.0f} "
          f"{'tokens' if tokens > 1024 else 'images'}/s; hand kernels' "
          f"device launches in one dispatch: {hand} ({profiles} "
          f"profile(s))", flush=True)
    return got


# the hand kernels by their __global__ names (a name may carry a suffix
# and template arguments): one launch each per wrapper call, the
# backward's pair one each
HAND_KERNELS = ("flash_fwd_kernel", "dkdv_kernel", "dq_kernel",
                "mlp_fwd_kernel", "ffn_kernel", "qmm_kernel")


def hand_launches(kern: dict) -> dict:
    """{hand kernel: device launches} of a ``device_kernels`` profile."""
    out = {}
    for name, (_, n) in kern.items():
        for k in HAND_KERNELS:
            if k in name:
                out[k] = out.get(k, 0) + n
    return out


def k_times(one: dict, k: int) -> dict:
    """K times the hand kernels' launches of one K=1 step (``one``, a
    ``dispatch_timing`` result)."""
    return {n: c * k for n, c in one["hand"].items()}


def same_launches(what: str, one: dict, many: dict, want=()) -> None:
    """The device launches of each hand kernel in a dispatch of K steps
    (``many``, a ``dispatch_timing`` result) equal K times those of one
    eager K=1 step (``one``), and every kernel of ``want`` launched: the
    graph's replays ran the kernels the eager step runs."""
    k = many["k"]
    want_k = k_times(one, k)
    check(many["hand"] == want_k and all(want_k.get(n) for n in want),
          f"{what}: hand kernels' device launches {many['hand']} != "
          f"{k} x K=1's {one['hand']} (expected {list(want)})")


def record_state(cli, cfg, vocab: int = 30522):
    """A seeded train state of ``cfg`` on the card."""
    import torch

    from faster_distributed_training_tpu_torch.optim import (build_optimizer,
                                                             layouts_of)
    from faster_distributed_training_tpu_torch.train.state import (
        create_train_state)

    resnet = cli.is_resnet(cfg)
    gen = torch.Generator().manual_seed(cfg.seed)
    model = cli.build_model(cfg, vocab_size=None if resnet else vocab,
                            device="cuda").init_weights(gen)
    model.cuda()
    extra = {}
    if resnet:
        model.to(memory_format=torch.channels_last)
        extra = {k: v.cuda() for k, v in
                 cli.resnet_extra_leaves(cfg, gen).items()}
    tx, _ = build_optimizer(cfg, 64, layouts=layouts_of(model))
    return create_train_state(model, tx, cfg.seed, extra=extra)


def timing_ladder(cli, build_dir: str) -> dict:
    """Phase K's timing: the slice-2 record at K=1 host, K=4 host, K=4
    resident and K=16 resident; the peak memory and the resident split's
    bytes."""
    import torch

    from faster_distributed_training_tpu_torch.data.device_resident import (
        DeviceResidentData)
    from faster_distributed_training_tpu_torch.data.loader import BatchLoader
    from faster_distributed_training_tpu_torch.train.dispatch import (
        FusedDispatch)
    from faster_distributed_training_tpu_torch.train.steps import (
        make_train_step, to_device)

    cfg = record_cfg(cli, [], "ktime", build_dir)
    B, L = cfg.batch_size, cfg.seq_len
    data = cli.load_dataset(cfg.replace(dataset="synthetic"), True)
    host = list(itertools.islice(iter(BatchLoader(
        data, B, epoch=0, seed=cfg.seed, max_len=L)), 16))
    out = {}
    state = record_state(cli, cfg)
    step = make_train_step(cfg)
    it = itertools.cycle(host)
    torch.cuda.reset_peak_memory_stats()
    out["K=1 host"] = dispatch_timing(
        "slice-2 record K=1 host (eager)",
        lambda: step(state, to_device(next(it), "cuda")), 1, 12, B * L)
    disp = FusedDispatch(cfg, 4, "cuda")
    out["K=4 host"] = dispatch_timing(
        "slice-2 record K=4 host",
        lambda: disp.run(state, 4, batches=[next(it) for _ in range(4)]),
        4, 16, B * L, expect=k_times(out["K=1 host"], 4))
    res = DeviceResidentData(data, B, seed=cfg.seed, max_len=L,
                             device="cuda")
    for k in (4, 16):
        disp = FusedDispatch(cfg, k, "cuda", resident=res)
        disp.set_epoch(0)
        pos = [0]

        def one(d=disp, kk=k):
            start = pos[0]
            pos[0] = (start + kk) % (res.steps_per_epoch - kk)
            return d.run(state, kk, start=start)
        out[f"K={k} resident"] = dispatch_timing(
            f"slice-2 record K={k} resident", one, k, 32, B * L,
            expect=k_times(out["K=1 host"], k))
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["resident_bytes"] = res.nbytes
    # held at K=4; K=16's counts are printed (its profiles lose more
    # records) and phase K holds K=16 bitwise to K=1 over 16 steps
    for k in ("K=4 host", "K=4 resident"):
        same_launches(f"slice-2 record {k}", out["K=1 host"], out[k],
                      ("flash_fwd_kernel", "dkdv_kernel", "dq_kernel",
                       "mlp_fwd_kernel"))
    gib = out["peak_bytes"] / 2**30
    print(f"[dispatch memory] slice-2 record: peak {gib:.2f} GiB over the "
          f"ladder; the resident split {res.n} rows x "
          f"{res.seq_len} tokens, {res.nbytes / 1e6:.1f} MB on the card",
          flush=True)
    del state, res
    return out


def dispatch_phase(cli, build_dir: str) -> dict:
    """Phase K: K steps a dispatch, bitwise against K=1 on the slice-2
    record (host and resident, and under --remat attn_out), path B,
    ResNet-50 SGD + meta (with and without --remat) and ResNet-50 NGD +
    meta across an update step; the seed kernels under graph replay; the
    timing ladder, where the hand kernels' device launches of a dispatch
    are counted and held to K=1's."""
    import torch

    from faster_distributed_training_tpu_torch.train.dispatch import (
        FusedDispatch)
    from faster_distributed_training_tpu_torch.train.steps import (
        make_train_step, step_draws)

    res = {"leaves": {}}
    base = ["--subset_stride", str(K_STRIDE)]
    remat = ["--remat", "--remat_policy", "attn_out"]
    k4 = ["--steps_per_dispatch", "4"]
    for k1_flags, k1_tag, runs in (
            (base, "slice-2 K=1", ((k4, "slice-2 K=4 host"),
                                   (k4 + ["--data_path", "resident"],
                                    "slice-2 K=4 resident"))),
            (["--subset_stride", "16"], "slice-2 K=1 (16 steps)",
             ((["--steps_per_dispatch", "16", "--data_path", "resident"],
               "slice-2 K=16 resident"),)),
            (base + remat, "slice-2 --remat attn_out K=1",
             ((k4, "slice-2 --remat attn_out K=4"),)),
            (base + ["--ffn_impl", "pallas", "--quant", "int8"], "path B K=1",
             ((k4, "path B K=4"),))):
        one, want, _ = counted_run(cli, record_cfg(cli, k1_flags, "k1",
                                                   build_dir), k1_tag)
        for flags, tag in runs:
            out, got, counts = counted_run(
                cli, record_cfg(cli, k1_flags + flags, "k4", build_dir), tag)
            check(out["state"].step == one["state"].step >= 8,
                  f"{tag}: {out['state'].step} steps")
            res["leaves"][tag] = bitwise(f"{tag} vs K=1", want, got)
            check(sum(out["trainer"].dispatch.replays.values()) >= 4,
                  f"{tag}: too few replays")
            del out
        del one
    for tag, flags, epochs in (
            ("resnet50 SGD + meta", ["--optimizer", "sgd",
                                     "--meta_learning"], 1),
            ("resnet50 SGD + meta --remat", ["--optimizer", "sgd",
                                             "--meta_learning", "--remat"],
             1),
            ("resnet50 NGD + meta", ["--ngd", "--meta_learning"], 2)):
        argv = flags + ["--epoch", str(epochs)]
        a, want, _ = counted_run(cli, resnet_cfg(cli, argv + [
            "--checkpoint_dir", os.path.join(build_dir, "smoke_ckpt_r1")]),
            f"{tag} K=1")
        b, got, _ = counted_run(cli, resnet_cfg(cli, argv + [
            "--steps_per_dispatch", "4", "--checkpoint_dir",
            os.path.join(build_dir, "smoke_ckpt_r4")]), f"{tag} K=4")
        check(a["state"].step == b["state"].step == 8 * epochs,
              f"{tag}: {b['state'].step} steps")
        disp = b["trainer"].dispatch
        check(sum(disp.replays.values()) > 0, f"{tag}: no graph replay")
        if "NGD" in tag:
            t = b["state"].opt_state["ngd"]["t"]
            check(t == 16 and disp.eager_steps >= 11,
                  f"{tag}: NGD counter {t}, {disp.eager_steps} eager steps")
        res["leaves"][tag] = bitwise(f"{tag} K=4 vs K=1", want, got)
        del a, b
    res["seed_kernels"] = seed_replay_check()
    res["timing"] = timing_ladder(cli, build_dir)
    # path B's hand kernels under a dispatch, counted on the device
    from faster_distributed_training_tpu_torch.data.loader import BatchLoader
    from faster_distributed_training_tpu_torch.train.steps import to_device

    bcfg = record_cfg(cli, ["--ffn_impl", "pallas", "--quant", "int8"],
                      "kbt", build_dir)
    data = cli.load_dataset(bcfg.replace(dataset="synthetic"), True)
    host = list(itertools.islice(iter(BatchLoader(
        data, bcfg.batch_size, epoch=0, seed=bcfg.seed,
        max_len=bcfg.seq_len)), 4))
    state = record_state(cli, bcfg)
    state.model.seed_amax_histories(bcfg.batch_size, bcfg.seq_len, step_draws(
        bcfg.seed, 0, bcfg.batch_size, state.model.n_dropout_sites(), 0.99))
    stepb = make_train_step(bcfg)
    it = itertools.cycle(host)
    tok = bcfg.batch_size * bcfg.seq_len
    tb = {"K=1": dispatch_timing(
        "path B K=1 (eager)",
        lambda: stepb(state, to_device(next(it), "cuda")), 1, 8, tok)}
    disp = FusedDispatch(bcfg, 4, "cuda")
    tb["K=4"] = dispatch_timing("path B K=4 host",
                                lambda: disp.run(state, 4, batches=host), 4,
                                8, tok, expect=k_times(tb["K=1"], 4))
    same_launches("path B K=4", tb["K=1"], tb["K=4"],
                  ("flash_fwd_kernel", "dkdv_kernel", "dq_kernel",
                   "mlp_fwd_kernel", "ffn_kernel", "qmm_kernel"))
    res["timing_b"] = tb
    del state, disp
    # ResNet R1's non-update step at K=1 and K=4 (R1's config with the
    # factor refresh pushed past the run, so 4 steps in a row are
    # non-update steps: the same work as R1's non-update step)
    rcfg = resnet_cfg(cli, ["--ngd", "--meta_learning"]).replace(
        ngd_update_period=4096)
    state = record_state(cli, rcfg)
    batch = resnet_batch(rcfg)
    step = make_train_step(rcfg)
    for _ in range(10):                      # past the always-update steps
        step(state, batch)
    torch.cuda.synchronize()
    host = [{k: v.cpu().numpy() for k, v in batch.items()}] * 4
    rt = {"K=1": dispatch_timing("ResNet R1 non-update step K=1",
                                 lambda: step(state, batch), 1, 6, 512)}
    disp = FusedDispatch(rcfg, 4, "cuda")
    rt["K=4"] = dispatch_timing("ResNet R1 non-update step K=4 host",
                                lambda: disp.run(state, 4, batches=host), 4,
                                8, 512)
    check(sum(disp.replays.values()) > 0 and disp.eager_steps == 1,
          "R1 non-update dispatch did not replay its graph")
    res["timing_r1"] = rt
    del state, disp
    return res


def lm_dispatch(cli, corpus: str, build_dir: str) -> dict:
    """Path E under a dispatch: K=2 bitwise against K=1 (8 steps), then
    the step timing at K=1 and K=4."""
    import torch

    from faster_distributed_training_tpu_torch.data.loader import BatchLoader
    from faster_distributed_training_tpu_torch.train.dispatch import (
        FusedDispatch)
    from faster_distributed_training_tpu_torch.train.steps import (
        make_train_step, to_device)

    argv = ["--task", "lm", "--dataset", "stream", "--stream_dir", corpus,
            "--seq_len", str(LONG["L"]), "--bs", str(LONG["B"])]
    a, want, _ = counted_run(cli, record_cfg(cli, argv, "e1", build_dir),
                             "path E K=1")
    b, got, _ = counted_run(cli, record_cfg(
        cli, argv + ["--steps_per_dispatch", "2"], "e2", build_dir),
        "path E K=2")
    check(a["state"].step == b["state"].step >= 4, "path E: steps")
    n = bitwise("path E K=2 vs K=1", want, got)
    cfg = a["cfg"]
    del a, b
    data = cli.load_dataset(cfg, True)
    host = list(itertools.islice(iter(BatchLoader(
        data, LONG["B"], epoch=0, seed=cfg.seed, max_len=LONG["L"])), 4))
    state = record_state(cli, cfg, vocab=data.vocab_size())
    step = make_train_step(cfg)
    it = itertools.cycle(host)
    tok = LONG["B"] * LONG["L"]
    out = {"leaves": n, "K=1": dispatch_timing(
        "path E K=1 (eager)",
        lambda: step(state, to_device(next(it), "cuda")), 1, 4, tok)}
    disp = FusedDispatch(cfg, 4, "cuda")
    out["K=4"] = dispatch_timing("path E K=4 host",
                                 lambda: disp.run(state, 4, batches=host),
                                 4, 8, tok, expect=k_times(out["K=1"], 4))
    same_launches("path E K=4", out["K=1"], out["K=4"],
                  ("flash_fwd_kernel", "dkdv_kernel", "dq_kernel"))
    del state, disp
    torch.cuda.empty_cache()
    return out


REMAT_SHAPE = (256, 512)       # the JAX remat measurement: batch, seq


def remat_phase(cli, build_dir: str) -> dict:
    """Phase M: the transformer at batch 256, L 512, record widths, under
    each --remat_policy (none first): peak memory, step ms, examples/s;
    each policy's gradients against none's (ffn bitwise, the
    attention-wrapping ones through row 5's recompute route within
    2e-2 of each leaf's max |grad|); under --quant int8 every amax history
    rolled once, as none's; row 5's launches from a --remat run of the
    entry point; ResNet-50 --remat at batch 512: peak, step ms, gradients
    and BN running statistics bitwise against no remat."""
    import numpy as np
    import torch

    from faster_distributed_training_tpu_torch.train.steps import (
        loss_and_grads, make_train_step, step_draws, to_device)

    B, L = REMAT_SHAPE
    rng = np.random.default_rng(21)
    batch = to_device({"tokens": rng.integers(1, 30522, (B, L)).astype(
        np.int32), "token_types": np.zeros((B, L), np.int32),
        "mask": np.ones((B, L), np.int32),
        "label": rng.integers(0, 4, B).astype(np.int32)}, "cuda")
    out, grads = {}, {}
    for policy in ("none", "layer", "ffn", "attn_out", "dots"):
        flags = [] if policy == "none" else ["--remat", "--remat_policy",
                                             policy]
        cfg = record_cfg(cli, flags + ["--bs", str(B)], "m", build_dir)
        state = record_state(cli, cfg)
        draws = step_draws(0, 0, B, state.model.n_dropout_sites(), 0.99)
        _, g, *_ = loss_and_grads(state.model, batch, draws)
        grads[policy] = {k: v.detach().cpu() for k, v in g.items()}
        del g
        step = make_train_step(cfg)
        step(state, batch, draws)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            step(state, batch, draws)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        out[policy] = {"peak": torch.cuda.max_memory_allocated(),
                       "step_ms": ms, "ex_s": B / (ms / 1e3)}
        print(f"[remat] --remat_policy {policy}: batch {B}, L {L}, peak "
              f"{out[policy]['peak'] / 2**30:.2f} GiB, step {ms:.2f} ms "
              f"(median of 3), {out[policy]['ex_s']:.0f} examples/s",
              flush=True)
        del state, step
        torch.cuda.empty_cache()
    base = grads["none"]
    for policy in ("layer", "ffn", "attn_out", "dots"):
        if policy == "ffn":
            same = all(torch.equal(base[k], grads[policy][k]) for k in base)
            print(f"[remat] ffn gradients bitwise equal to none's: {same}",
                  flush=True)
            check(same, "--remat_policy ffn gradients differ from none's")
            continue
        e, leaf = grad_err(grads[policy], base)
        out[policy]["grad_err"] = e
        print(f"[remat] {policy} gradients (row 5's recompute backward) vs "
              f"none's (row 4's saved stats): max {e:.3g} of the leaf's max "
              f"|grad| ({leaf}; tol 2e-2, bf16)", flush=True)
        check(e <= 2e-2, f"--remat_policy {policy} gradients err {e}")
    del grads, base
    for policy in ("layer", "attn_out"):
        check(out[policy]["peak"] < out["none"]["peak"],
              f"--remat_policy {policy} peak not below none's")
    # --quant int8: every history rolled once, equal to none's
    hist = {}
    for policy in ("none", "layer", "ffn", "attn_out", "dots"):
        flags = ["--quant", "int8", "--bs", "16"] + (
            [] if policy == "none" else ["--remat", "--remat_policy", policy])
        cfg = record_cfg(cli, flags, "mq", build_dir)
        state = record_state(cli, cfg)
        draws = step_draws(0, 0, 16, state.model.n_dropout_sites(), 0.99)
        state.model.seed_amax_histories(16, L, draws)
        b16 = {k: v[:16] for k, v in batch.items()}
        loss_and_grads(state.model, b16, draws)
        hist[policy] = {n: t.clone() for n, t in state.model.named_buffers()
                        if "amax_history" in n}
        del state
    for policy in ("layer", "ffn", "attn_out", "dots"):
        same = hist[policy].keys() == hist["none"].keys() and all(
            torch.equal(hist[policy][n], t) for n, t in hist["none"].items())
        check(same, f"--quant int8 --remat_policy {policy}: the amax "
              f"histories differ from none's (rolled twice?)")
    print(f"[remat] --quant int8: {len(hist['none'])} amax histories after "
          f"one step equal none's under every policy (each rolled once)",
          flush=True)
    # row 5 on a real path: the entry point with --remat (attn_out)
    _, _, counts = counted_run(cli, record_cfg(
        cli, ["--remat", "--subset_stride", "64"], "mrun", build_dir),
        "--remat attn_out K=1")
    steps = 4096 // 64 // 16
    check(counts["flash_bwd_recompute"] == 6 * steps
          and counts["flash_bwd_stats"] == 0,
          f"--remat: row 5 launches {counts}")
    out["row5_launches"] = counts["flash_bwd_recompute"]
    out["remat_counts"] = counts
    # ResNet-50 block remat at batch 512
    rn = {}
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, True
    try:
        rcfg = resnet_cfg(cli, ["--optimizer", "sgd", "--meta_learning"])
        rbatch = resnet_batch(rcfg)
        for remat in (False, True):
            cfg = rcfg.replace(remat=remat)
            state = record_state(cli, cfg)
            step = make_train_step(cfg)
            from faster_distributed_training_tpu_torch.train.steps import (
                image_draws, image_loss_and_grads, resolve_mixup_mode)
            draws = image_draws(0, 0, 512, cfg.alpha)
            _, g, *_ = image_loss_and_grads(state, rbatch, draws,
                                            resolve_mixup_mode(cfg))
            stats = {n: b.clone() for n, b in state.model.named_buffers()}
            rn[remat] = {"grads": {k: v.detach().clone()
                                   for k, v in g.items()}, "stats": stats}
            del g
            step(state, rbatch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                step(state, rbatch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            rn[remat].update(peak=torch.cuda.max_memory_allocated(),
                             step_ms=statistics.median(times))
            print(f"[remat R] resnet50 batch 512 bf16 SGD + meta, remat "
                  f"{remat}: peak {rn[remat]['peak'] / 2**30:.2f} GiB, step "
                  f"{rn[remat]['step_ms']:.2f} ms (median of 3)", flush=True)
            del state, step
            torch.cuda.empty_cache()
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    for part in ("grads", "stats"):
        a, b = rn[False][part], rn[True][part]
        same = a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                            for k in a)
        print(f"[remat R] resnet50 --remat {part} bitwise equal to no remat "
              f"({len(a)} leaves, cuDNN deterministic): {same}", flush=True)
        check(same, f"resnet50 --remat {part} differ from no remat")
    out["resnet"] = {k: {kk: v for kk, v in d.items()
                         if kk in ("peak", "step_ms")} for k, d in rn.items()}
    return out



def dispatch_summary(kd: dict, mr: dict) -> None:
    """The phase K and M summary lines."""
    t = kd["timing"]
    print("[dispatch] slice-2 record, host wall / device ms a step (busy, "
          "host launch calls a step, tokens/s): " + "; ".join(
              f"{k} {v['wall_ms']:.2f} / {v['device_ms']:.2f} "
              f"({100 * v['busy']:.1f}%, {v['launch_calls']:.1f}, "
              f"{v['per_s']:.0f})" for k, v in t.items()
              if isinstance(v, dict)) + f"; peak {t['peak_bytes'] / 2**30:.2f}"
          f" GiB, resident split {t['resident_bytes'] / 1e6:.1f} MB")
    for what, d in (("path B", kd["timing_b"]),
                    ("ResNet R1 non-update", kd["timing_r1"]),
                    ("path E", (kd.get("path_e") or {}))):
        print(f"[dispatch] {what}: " + "; ".join(
            f"{k} {v['wall_ms']:.2f} / {v['device_ms']:.2f} ms "
            f"({100 * v['busy']:.1f}%, {v['launch_calls']:.1f} calls)"
            for k, v in d.items() if isinstance(v, dict)))
    print(f"[dispatch] bitwise K vs K=1: {kd['leaves']}"
          + (f", path E K=2 {kd['path_e']['leaves']}" if kd.get("path_e")
             else "") + f"; hand kernels' device launches in one K=4 "
          f"dispatch (4 x one K=1 step's): slice-2 "
          f"{t['K=4 host']['hand']}, path B {kd['timing_b']['K=4']['hand']}")
    print("[remat] batch 256 L 512: " + "; ".join(
        f"{p} {mr[p]['peak'] / 2**30:.2f} GiB {mr[p]['step_ms']:.1f} ms "
        f"{mr[p]['ex_s']:.0f} ex/s" for p in ("none", "layer", "ffn",
                                              "attn_out", "dots"))
        + f"; resnet50 --remat {mr['resnet']}; row 5 launches on --remat "
        f"{mr['row5_launches']}")


def dispatch_main() -> int:
    """``--dispatch``: the kernels' build, then phases K (without path E)
    and M alone."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from faster_distributed_training_tpu_torch import cli
    from faster_distributed_training_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_s, _ = _build.build()
    print(f"[build] {build_s:.1f}s", flush=True)
    kd = dispatch_phase(cli, str(_build.BUILD_DIR))
    mr = remat_phase(cli, str(_build.BUILD_DIR))
    dispatch_summary(kd, mr)
    return 0


# -- slice 10: data-parallel and fully-sharded training (phase P) ----------

P_STRIDE = 32            # the record on 128 rows: 8 steps of 16
P_LAYERS = 2             # P4's depth


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_env(port: int, rank: int = 0, world: int = 1) -> dict:
    """torchrun's variables for a group on this host."""
    return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
            "RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": "0"}


def stepped_run(cli, cfg, tag: str):
    """``cli.run_training(cfg)`` with every step synchronized and timed and
    the card's bytes at rest read before each step, over what was
    allocated before the run (the launch counts set to 0 just before,
    read just after): (out, leaves, counts, step ms median after the
    first, median bytes at rest, bytes parked)."""
    import torch

    from faster_distributed_training_tpu_torch.train import steps as steps_mod
    from faster_distributed_training_tpu_torch.train.state import (
        state_leaves)

    times, rest = [], []
    make_step = steps_mod.make_train_step

    def timing(cfg_):
        inner = make_step(cfg_)

        def run(state, batch, draws=None):
            torch.cuda.synchronize()
            rest.append(torch.cuda.memory_allocated() - base)
            t0 = time.perf_counter()
            state, metrics = inner(state, batch, draws)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            return state, metrics
        return run

    steps_mod.make_train_step = timing
    gc.collect()                # no earlier run's garbage freed mid-run
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    reset_counts()
    try:
        out = cli.run_training(cfg, log=lambda line: print(line, flush=True))
    finally:
        steps_mod.make_train_step = make_step
    torch.cuda.synchronize()
    counts = read_counts()
    state = out["state"]
    pl = state.placement
    parked = sum(b.numel() * b.element_size()
                 for b in pl.host.values()) if pl is not None else 0
    leaves = {k: v.detach().clone() for k, v in state_leaves(state).items()}
    ms = statistics.median(times[1:] or times)
    print(f"[mesh {tag}] {state.step} steps; step ms median {ms:.2f}; "
          f"bytes at rest {statistics.median(rest) / 1e6:.1f} MB"
          + (f", parked on the host {parked / 1e6:.1f} MB" if parked else "")
          + f"; launches {counts}", flush=True)
    return out, leaves, counts, ms, statistics.median(rest), parked


def mesh_launches(what: str, counts: dict, want: tuple) -> None:
    for name in want:
        check(counts[name] > 0, f"{what}: {name} was not launched")


def p4_steps(n_steps: int, batch: int, seq: int):
    """The P4 record (fp32, ``P_LAYERS`` layers, full width) stepped
    directly on ``n_steps`` fixed global batches with the global draws:
    this process's rows of each (rank r of the running group), (losses,
    digests of the whole state a step, the whole state, the median step
    ms after the first)."""
    import hashlib

    import numpy as np
    import torch

    from faster_distributed_training_tpu_torch import cli
    from faster_distributed_training_tpu_torch.optim import build_optimizer
    from faster_distributed_training_tpu_torch.parallel import (
        DataGroup, Placement, make_mesh, make_put_batch)
    from faster_distributed_training_tpu_torch.train.state import (
        create_train_state, state_leaves)
    from faster_distributed_training_tpu_torch.train.steps import (
        make_train_step, mixup_alpha, step_draws)

    defaults = cli.TRANSFORMER_DEFAULTS
    cfg = cli.config_from_args(cli.build_parser(defaults=defaults).parse_args(
        ["--device", "cuda", "--precision", "fp32", "--n_layers",
         str(P_LAYERS), "--bs", str(batch), "--attention", "flash"]),
        defaults=defaults)
    gen = torch.Generator().manual_seed(cfg.seed)
    model = cli.build_model(cfg, vocab_size=30522, device="cuda"
                            ).init_weights(gen).cuda()
    tx, _ = build_optimizer(cfg, 64)
    state = create_train_state(model, tx, cfg.seed)
    group = DataGroup()
    if group.live:
        state.placement = Placement(cfg, make_mesh(("dp",), (), "cuda"),
                                    "cuda", group)
        state.placement.shard_state(state)
    put = make_put_batch(group, "cuda")
    step = make_train_step(cfg)
    rng = np.random.default_rng(7)
    losses, digests, times = [], [], []
    for i in range(n_steps):
        lengths = rng.integers(seq // 4, seq + 1, batch)
        mask = (np.arange(seq)[None] < lengths[:, None]).astype(np.int32)
        tokens = rng.integers(1, 30522, (batch, seq)).astype(np.int32) * mask
        glob = {"tokens": tokens, "token_types": np.zeros_like(tokens),
                "mask": mask,
                "label": rng.integers(0, 4, batch).astype(np.int32)}
        draws = step_draws(cfg.seed, i, batch, model.n_dropout_sites(),
                           mixup_alpha(cfg))
        local = put(glob)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, local, draws)
        losses.append(float(m["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
        leaves = state_leaves(state)
        h = hashlib.sha256()
        for k in sorted(leaves):
            h.update(leaves[k].detach().cpu().numpy().tobytes())
        digests.append(h.hexdigest())
    whole = {k: v.detach().cpu() for k, v in state_leaves(state).items()}
    return losses, digests, whole, statistics.median(times[1:])


def p4_rank(rank: int, world: int, port: int, out_dir: str,
            n_steps: int, batch: int, seq: int) -> None:
    """One P4 rank: gloo on the one card, the steps, its result file."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        out = p4_steps(n_steps, batch, seq)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"p4_{rank}.pt"))


def half_batch_kernels(gen) -> dict:
    """P3: rows 1/2 and 4 (forward with lse, backward) at the record's and
    path E's shapes and rows 7 and 8 (the fused FFN, int8) at the
    record's, dropout 0.1, launched on the two halves of the batch at b0
    = 0 and b0 = B/2: bitwise the full launch's rows; the plain versions
    (on the CPU, at the record's shape) the same way.  Returns the worst
    difference (0)."""
    import torch

    from faster_distributed_training_tpu_torch.ops import fused_ffn as ffn
    from faster_distributed_training_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_reference,
        flash_attention_stats, flash_attention_stats_reference)

    seed, rate = 0x2545F491, 0.1
    worst = 0

    def same(tag, got, want):
        nonlocal worst
        d = float((got.float() - want.float()).abs().max())
        worst = max(worst, d)
        check(torch.equal(got, want), f"P3 {tag}: half != full rows ({d})")

    # the plain versions at the record's shape only: on the host CPU a
    # path-E plain backward (B 4, L 8192) alone takes minutes
    for B, H, L, D, plain in ((16, 8, 512, 64, True),
                              (LONG["B"], LONG["H"], LONG["L"], LONG["D"],
                               False)):
        q, k, v = qkv_views(B, H, L, D, torch.bfloat16, gen)
        dout = torch.randn(B, H, L, D, generator=gen, device="cuda"
                           ).to(torch.bfloat16)
        mask = ragged_mask(B, L, gen)
        full = flash_attention_stats(q, k, v, mask, rate, seed)
        grads = flash_attention_bwd(q, k, v, *full[:2], dout, mask, rate,
                                    seed, full[2])
        if plain:
            cpu = [t.cpu() for t in (q, k, v, dout, mask)]
            pfull = flash_attention_stats_reference(*cpu[:3], cpu[4], rate,
                                                    seed)
            pgrads = flash_attention_bwd_reference(
                *cpu[:3], *pfull[:2], cpu[3], cpu[4], rate, seed, pfull[2])
        for b0 in (0, B // 2):
            s = slice(b0, b0 + B // 2)
            got = flash_attention_stats(q[s], k[s], v[s], mask[s], rate,
                                        seed, b0=b0)
            for name, a, b in zip(("out", "lse", "lse_lo"), got, full):
                same(f"flash L{L} b0={b0} {name}", a, b[s])
            g = flash_attention_bwd(q[s], k[s], v[s], *got[:2], dout[s],
                                    mask[s], rate, seed, got[2], b0=b0)
            for name, a, b in zip(("dq", "dk", "dv"), g, grads):
                same(f"flash bwd L{L} b0={b0} {name}", a, b[s])
            if not plain:
                continue
            cs = [t[s] for t in cpu]
            pg = flash_attention_stats_reference(*cs[:3], cs[4], rate, seed,
                                                 b0=b0)
            for name, a, b in zip(("out", "lse", "lse_lo"), pg, pfull):
                same(f"plain L{L} b0={b0} {name}", a, b[s])
            pgg = flash_attention_bwd_reference(
                *cs[:3], *pg[:2], cs[3], cs[4], rate, seed, pg[2], b0=b0)
            for name, a, b in zip(("dq", "dk", "dv"), pgg, pgrads):
                same(f"plain bwd L{L} b0={b0} {name}", a, b[s])
        print(f"[mesh P3] flash rows 1/2 and 4 at B {B} L {L}: the halves "
              f"at b0 = 0 and {B // 2} bitwise the full launch (kernels"
              + (" and plain versions)" if plain else ")"), flush=True)
    B, L, d, d_ff = 16, 512, 512, 1024
    h, ln_s, ln_b, w1, b1, w2, b2 = ffn_inputs(gen, B * L, d, d_ff,
                                               torch.bfloat16)
    scales = torch.tensor(FFN_SCALES, dtype=torch.float32, device="cuda")
    for fmt in (None, "int8"):
        def run(x, b0, plain=False):
            args = [x, ln_s, ln_b, w1, b1, w2, b2]
            sc = scales
            if plain:
                args, sc = [t.cpu() for t in args], scales.cpu()
            return ffn.ffn_fwd_generalized(
                *args, (FFN_SEEDS[0], FFN_SEEDS[1], b0, 0, 0), sc, rate,
                rate, 1e-6, L, L, d_ff, fmt)
        for plain in (False, True):
            out, amax = run(h, 0, plain)
            amaxes = []
            for b0 in (0, B // 2):
                rows = slice(b0 * L, (b0 + B // 2) * L)
                o, a = run(h[rows], b0, plain)
                same(f"ffn {fmt} plain={plain} b0={b0}", o, out[rows])
                amaxes.append(a)
            same(f"ffn {fmt} plain={plain} amax", torch.maximum(*amaxes),
                 amax)
    print(f"[mesh P3] fused FFN rows 7 and 8 (int8) at {B * L} x {d} -> "
          f"{d_ff}: the halves bitwise the full launch, the amaxes' max "
          f"the full amax (kernels and plain versions)", flush=True)
    return {"worst": worst}


def mesh_phase(cli, build_dir: str) -> dict:
    """Phase P: the data mesh on the one card.  P1 world size 1 over NCCL
    (``--distributed --mesh dp=1``) bitwise against no process group:
    the record (8 steps), path B (4), ResNet-50 NGD + meta at batch 512
    (2, an NGD update among them) and the record at K=4 against K=1.
    P2 ``--fsdp --host_offload --offload_opt_state`` at world 1 bitwise
    against no offload, the bytes at rest and parked.  P3 the kernels at
    a nonzero batch origin.  P4 two ranks on the card over gloo (dp=2),
    the record at 2 layers held to the world-1 run."""
    import multiprocessing as mp

    import torch
    import torch.distributed as dist

    out = {}
    stride = ["--subset_stride", str(P_STRIDE)]
    runs = {"record": (stride, "record"),
            "path_b": (["--subset_stride", "64", "--ffn_impl", "pallas",
                        "--quant", "int8"], "record"),
            "resnet": (["--model", "resnet50", "--ngd", "--meta_learning",
                        "--bs", "512", "--epoch", "1", "--subset_stride",
                        "4"], "resnet")}
    main_path = {"record": ("flash_fwd", "flash_bwd_stats", "fused_mlp"),
                 "path_b": ("flash_fwd", "flash_bwd_stats", "fused_mlp",
                            "fused_ffn_quant", "quant_matmul"),
                 "resnet": ()}

    def cfg_of(name, extra, tag):
        argv, kind = runs[name]
        if kind == "resnet":
            return resnet_cfg(cli, argv + extra + [
                "--checkpoint_dir", os.path.join(build_dir, f"p_{tag}")])
        return record_cfg(cli, argv + extra, tag, build_dir)

    t0 = time.monotonic()
    # the plain runs (no process group)
    plain = {name: stepped_run(cli, cfg_of(name, [], f"plain_{name}"),
                               f"P1 {name} no group")
             for name in runs}
    plain["p4"] = p4_steps(4, 16, 512)
    # P1: world 1 over NCCL, joined by the entry point (--distributed)
    os.environ.update(mesh_env(free_port()))
    dp1 = ["--distributed", "--mesh", "dp=1"]
    for name in runs:
        got = stepped_run(cli, cfg_of(name, dp1, f"dp1_{name}"),
                          f"P1 {name} dp=1")
        check(dist.is_initialized() and dist.get_backend() == "nccl",
              "P1: --distributed joined no NCCL group")
        mesh_launches(f"P1 {name}", got[2], main_path[name])
        bitwise(f"P1 {name} dp=1 vs no group", plain[name][1], got[1])
        out[f"p1_{name}_ms"] = got[3]
        out[f"p1_{name}_plain_ms"] = plain[name][3]
        if name == "record":
            dp1_record = got
    # (untimed: a synchronize inside the captured step would break it)
    k4 = counted_run(cli, cfg_of("record", dp1 + ["--steps_per_dispatch",
                                                  "4"], "dp1_k4"), "P1 K=4")
    check(sum(k4[0]["trainer"].dispatch.replays.values()) > 0,
          "P1 K=4: no graph replayed")
    bitwise("P1 record dp=1 K=4 vs K=1 (the all-reduce captured)",
            dp1_record[1], k4[1])
    # P2: the host tiers at world 1, against the dp=1 run
    off = stepped_run(cli, cfg_of("record", [
        "--distributed", "--mesh", "fsdp=1", "--fsdp", "--host_offload",
        "--offload_opt_state"], "dp1_off"), "P2 record fsdp + host offload")
    mesh_launches("P2", off[2], main_path["record"])
    bitwise("P2 offload vs no offload", dp1_record[1], off[1])
    params = sum(v.numel() * v.element_size() for k, v in off[1].items()
                 if k.startswith("model/") and "amax" not in k
                 and k[len("model/"):] in dict(
                     off[0]["state"].model.named_parameters()))
    opt = sum(v.numel() * v.element_size() for k, v in off[1].items()
              if k.startswith("opt/") and v.dim())
    out.update(p2_rest_bytes=off[4], p2_rest_bytes_resident=dp1_record[4],
               p2_parked_bytes=off[5], p2_param_bytes=params,
               p2_opt_bytes=opt, p2_ms=off[3], p2_ms_resident=dp1_record[3])
    check(off[5] == params + opt, f"P2: parked {off[5]} bytes, the leaves "
          f"hold {params} + {opt}")
    check(dp1_record[4] - off[4] >= 0.9 * off[5],
          f"P2: the card's bytes at rest fell by {dp1_record[4] - off[4]}, "
          f"{off[5]} were parked")
    print(f"[mesh P2] bytes at rest between steps: {off[4] / 1e6:.1f} MB "
          f"with offload, {dp1_record[4] / 1e6:.1f} MB without; parked "
          f"{off[5] / 1e6:.1f} MB = fp32 params {params / 1e6:.1f} MB + "
          f"optimizer state {opt / 1e6:.1f} MB; step ms {off[3]:.2f} with, "
          f"{dp1_record[3]:.2f} without", flush=True)
    # P4's world-1 reference, in the NCCL group
    ref = p4_steps(4, 16, 512)
    check(ref[1] == plain["p4"][1], "P4 reference: dp=1 != no group")
    dist.destroy_process_group()
    for k in mesh_env(0):
        os.environ.pop(k, None)
    print(f"[mesh] P1 and P2 in {time.monotonic() - t0:.1f}s", flush=True)
    # P3: the kernels at a batch origin
    t0 = time.monotonic()
    out["p3"] = half_batch_kernels(torch.Generator(device="cuda"
                                                   ).manual_seed(3))
    print(f"[mesh] P3 in {time.monotonic() - t0:.1f}s", flush=True)
    # P4: two ranks on the card over gloo
    ctx = mp.get_context("spawn")
    port = free_port()
    t0 = time.monotonic()
    procs = [ctx.Process(target=p4_rank, args=(r, 2, port, build_dir, 4,
                                               16, 512)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    check(all(p.exitcode == 0 for p in procs),
          f"P4: ranks exited {[p.exitcode for p in procs]}")
    ranks = [torch.load(os.path.join(build_dir, f"p4_{r}.pt"))
             for r in range(2)]
    out["p4_s"] = time.monotonic() - t0
    check(ranks[0][1] == ranks[1][1], "P4: the ranks' states differ")
    loss_err = max(abs(a - b) for a, b in zip(ranks[0][0], ref[0]))
    param_err = max(float((ranks[0][2][k] - v).abs().max())
                    for k, v in ref[2].items()
                    if k.startswith("model/") and v.is_floating_point())
    out.update(p4_loss_err=loss_err, p4_param_err=param_err,
               p4_ms=[r[3] for r in ranks], p4_ms_world1=ref[3],
               p4_ms_no_group=plain["p4"][3])
    print(f"[mesh P4] dp=2 over gloo on one card, {P_LAYERS} layers fp32, "
          f"4 steps: both ranks bitwise equal after every step; vs world "
          f"1: loss err {loss_err:.3g} (tol 1e-5), param err "
          f"{param_err:.3g} (tol 1e-4); step ms median {out['p4_ms']} "
          f"(ranks 0, 1) against {ref[3]:.2f} at world 1 over NCCL and "
          f"{plain['p4'][3]:.2f} without a group; {out['p4_s']:.1f}s wall "
          f"with the ranks' start", flush=True)
    check(loss_err <= 1e-5 and param_err <= 1e-4, "P4: dp=2 vs world 1")
    return out


T_LAYERS = 2             # T2(a)'s depth
T_RECORD_LAYERS = 6      # T2(b): the record's depth


def tp_kernels(gen) -> dict:
    """T1: every hand kernel on a tp rank's shard, in one process.  Rows 1
    and 4 at the record's shape (and 2, 3 at path E's), dropout 0.1, on
    heads [0, H/2) and [H/2, H) (h0 = 0 and H/2, h_glob = H): out, lse,
    dq, dk, dv bitwise the full launch's heads (the plain versions too at
    the record's shape).  Row 8' (the fused FFN's tp ``partial`` tile) for
    none, int8 and E4M3 at 8192 rows, d 512 -> d_ff/2 = 512 -> 512, c0 = 0
    and 512: each against its plain version (2e-2 of max |plain|; E4M3 of
    max |h + plain|, the scale the sublayer's output reads; amaxes 1e-2),
    two launches bitwise, the two tiles summed + b2, connection dropout
    and residual against the full row 8 launch (2e-2 of max |full|), the
    halves' amaxes against the full one's; its timing.  Row 9: the column
    shards (qkv on H/2 heads, Dense_0 on d_ff/2) bitwise the full launch's
    columns, the row shards (out, Dense_1) summed against the full launch
    (2e-2 of max |plain|); the qkv shard's timing."""
    import torch

    from faster_distributed_training_tpu_torch.ops.dropout import (
        keep_factor_rows)
    from faster_distributed_training_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_reference,
        flash_attention_stats, flash_attention_stats_reference)
    from faster_distributed_training_tpu_torch.ops.fused_ffn import (
        _ffn_body_reference, ffn_fwd_generalized)
    from faster_distributed_training_tpu_torch.ops.quant import (
        quant_dot_reference, quant_matmul, quantize)
    from faster_distributed_training_tpu_torch.parallel.sharding import (
        tp_shard)

    seed, rate, bf16 = 0x2545F491, 0.1, torch.bfloat16
    out = {}

    def same(tag, got, want):
        d = float((got.float() - want.float()).abs().max())
        check(torch.equal(got, want), f"T1 {tag}: shard != full ({d})")

    for B, H, L, D, plain in ((16, 8, 512, 64, True),
                              (LONG["B"], LONG["H"], LONG["L"], LONG["D"],
                               False)):
        q, k, v = qkv_views(B, H, L, D, bf16, gen)
        dout = torch.randn(B, H, L, D, generator=gen, device="cuda"
                           ).to(bf16)
        mask = ragged_mask(B, L, gen)
        full = flash_attention_stats(q, k, v, mask, rate, seed)
        grads = flash_attention_bwd(q, k, v, *full[:2], dout, mask, rate,
                                    seed, full[2])
        if plain:
            cpu = [t.cpu() for t in (q, k, v, dout, mask)]
            pfull = flash_attention_stats_reference(*cpu[:3], cpu[4], rate,
                                                    seed)
            pgrads = flash_attention_bwd_reference(
                *cpu[:3], *pfull[:2], cpu[3], cpu[4], rate, seed, pfull[2])
        for h0 in (0, H // 2):
            s = slice(h0, h0 + H // 2)
            got = flash_attention_stats(q[:, s], k[:, s], v[:, s], mask,
                                        rate, seed, h0=h0, h_glob=H)
            for name, a, b in zip(("out", "lse", "lse_lo"), got, full):
                same(f"flash L{L} h0={h0} {name}", a, b[:, s])
            g = flash_attention_bwd(q[:, s], k[:, s], v[:, s], *got[:2],
                                    dout[:, s], mask, rate, seed, got[2],
                                    h0=h0, h_glob=H)
            for name, a, b in zip(("dq", "dk", "dv"), g, grads):
                same(f"flash bwd L{L} h0={h0} {name}", a, b[:, s])
            if not plain:
                continue
            cs = [t[:, s] for t in cpu[:4]]
            pg = flash_attention_stats_reference(*cs[:3], cpu[4], rate, seed,
                                                 h0=h0, h_glob=H)
            for name, a, b in zip(("out", "lse", "lse_lo"), pg, pfull):
                same(f"plain L{L} h0={h0} {name}", a, b[:, s])
            pgg = flash_attention_bwd_reference(
                *cs[:3], *pg[:2], cs[3], cpu[4], rate, seed, pg[2], h0=h0,
                h_glob=H)
            for name, a, b in zip(("dq", "dk", "dv"), pgg, pgrads):
                same(f"plain bwd L{L} h0={h0} {name}", a, b[:, s])
        print(f"[tp T1] flash rows {'1 and 4' if plain else '2 and 3'} at "
              f"B {B} H {H} L {L}: the head halves at h0 = 0 and {H // 2} "
              f"(h_glob {H}) bitwise the full launch's heads (kernels"
              + (" and plain versions)" if plain else ")"), flush=True)
    rows, d, d_ff = FFN_SHAPE
    half = d_ff // 2
    args = ffn_inputs(gen, rows, d, d_ff, bf16)
    h, ln_s, ln_b, w1, b1, w2, b2 = args
    scales = torch.tensor(FFN_SCALES, device="cuda")
    keep = keep_factor_rows(FFN_SEEDS[1], torch.arange(rows, device="cuda"),
                            d, rate)
    errs, amax_same = {}, {}
    for fmt in (None, "int8", "fp8"):
        tag = fmt or "none"
        full, amax = ffn_fwd_generalized(*args, FFN_SEEDS, scales, rate,
                                         rate, 1e-6, 1, 1, d_ff, fmt)
        quant = None if fmt is None else (fmt, *scales.unbind(), None)
        tiles, worst, worst_abs = [], 0.0, 0.0
        for c0 in (0, half):
            shard = (h, ln_s, ln_b, w1[c0:c0 + half].contiguous(),
                     b1[c0:c0 + half].contiguous(),
                     w2[:, c0:c0 + half].contiguous(), b2)
            seeds = FFN_SEEDS[:4] + (c0,)
            p, a = ffn_fwd_generalized(*shard, seeds, scales, rate, 0.0,
                                       1e-6, 1, 1, d_ff, fmt, partial=True)
            p2, a2 = ffn_fwd_generalized(*shard, seeds, scales, rate, 0.0,
                                         1e-6, 1, 1, d_ff, fmt, partial=True)
            check(torch.equal(p, p2) and torch.equal(a, a2),
                  f"T1 row 8' {tag} c0={c0}: two launches differ")
            want, want_amax = _ffn_body_reference(
                *[t.cpu() for t in shard], seeds[0], seeds[1], rate, 0.0,
                1e-6, c0=c0, dff_glob=d_ff,
                quant=None if quant is None else (
                    fmt, *[s.cpu() for s in scales.unbind()], None),
                return_amax=True, plain_gemm=True, partial=True)
            want, want_amax = want.cuda(), want_amax.cuda()
            e = (p - want).abs().max().item()
            scale = (h.float() + want if fmt == "fp8" else want
                     ).abs().max().item()
            worst, worst_abs = max(worst, e / scale), max(worst_abs, e)
            check(e <= 2e-2 * scale, f"T1 row 8' {tag} c0={c0}: err {e} "
                  f"over 2e-2 x {scale}")
            if fmt is not None:
                check(torch.allclose(a, want_amax, rtol=1e-2, atol=0),
                      f"T1 row 8' {tag} c0={c0}: amax {a} vs {want_amax}")
            tiles.append((p, a))
        got = (h.float() + (tiles[0][0] + tiles[1][0] + b2.float()) * keep
               ).to(bf16)
        e_sum = (got.float() - full.float()).abs().max().item()
        rel_sum = e_sum / full.float().abs().max().item()
        check(rel_sum <= 2e-2, f"T1 row 8' {tag}: the tiles' sum vs the full "
              f"launch {rel_sum}")
        if fmt is not None:
            m = torch.maximum(tiles[0][1], tiles[1][1])
            amax_same[tag] = bool(torch.equal(m, amax))
            check(torch.allclose(m, amax, rtol=1e-2, atol=0),
                  f"T1 row 8' {tag}: the tiles' amax MAX {m} vs {amax}")
            check(torch.equal(tiles[0][1][0], tiles[1][1][0]),
                  f"T1 row 8' {tag}: the tiles' amax_f differ")
        errs[tag] = {"rel": worst, "abs": worst_abs, "sum_rel": rel_sum}
        print(f"[tp T1] row 8' partial {tag} at {rows} x {d} -> {half} of "
              f"{d_ff}: each tile vs its plain version {worst:.5f} of max "
              f"|" + ("h + " if fmt == "fp8" else "") + "plain| (tol 2e-2); "
              f"two launches bitwise; tiles summed + b2, dropout, residual "
              f"vs the full launch {rel_sum:.5f} of max |full| (tol 2e-2)"
              + (f"; amax_f equal, the amax MAX "
                 + ("bitwise" if amax_same[tag] else "within 1e-2")
                 + " the full launch's" if fmt else ""), flush=True)
    out["row8p_err"] = errs
    out["row8p_amax_bitwise"] = amax_same
    # timing at rank 1's tile (c0 = 512): kernel, plain, library (the
    # shard's two cuBLAS GEMMs), bound
    shard = (h, ln_s, ln_b, w1[half:].contiguous(), b1[half:].contiguous(),
             w2[:, half:].contiguous(), b2)
    seeds = FFN_SEEDS[:4] + (half,)
    f = torch.randn(rows, d, generator=gen, device="cuda").to(bf16)
    a = torch.randn(rows, half, generator=gen, device="cuda").to(bf16)
    inv = [(1.0 / v).reshape(()) for v in scales.unbind()]
    timings = {}
    for fmt in (None, "int8", "fp8"):
        quant = None if fmt is None else (fmt, *scales.unbind(), None)
        t = {"kernel": measure(lambda: ffn_fwd_generalized(
                 *shard, seeds, scales, rate, 0.0, 1e-6, 1, 1, d_ff, fmt,
                 partial=True)),
             "plain": measure(lambda: _ffn_body_reference(
                 *shard, seeds[0], seeds[1], rate, 0.0, 1e-6, c0=half,
                 dff_glob=d_ff, quant=quant, return_amax=True,
                 plain_gemm=True, partial=True))}
        if fmt is None:
            t["library"] = library(lambda: (
                torch.matmul(f, shard[3].t()), torch.matmul(a, shard[5].t())))
        else:
            fq, aq = quantize(f, scales[0], fmt), quantize(a, scales[2], fmt)
            w1q = quantize(shard[3], scales[1], fmt)
            w2q = quantize(shard[5], scales[3], fmt)
            if fmt == "int8":
                t["library"] = library(lambda: (torch._int_mm(fq, w1q.t()),
                                                torch._int_mm(aq, w2q.t())))
            else:
                t["library"] = library(lambda: (
                    torch._scaled_mm(fq, w1q.t(), scale_a=inv[0],
                                     scale_b=inv[1], out_dtype=bf16),
                    torch._scaled_mm(aq, w2q.t(), scale_a=inv[2],
                                     scale_b=inv[3], out_dtype=bf16)))
        w_bytes = 2 if fmt is None else 1
        # read h (bf16), the shard's weights, biases and LN parameters
        # once; write the fp32 tile (and two amaxes)
        t["bound_ms"], t["bound_by"] = bound(
            rows * d * 2 + rows * d * 4 + 2 * d * half * w_bytes
            + 2 * (half + d) + 8 * d + 8, 4 * rows * d * half,
            "bf16" if fmt is None else fmt)
        timings[fmt or "none"] = t
        lib = t["library"]
        print(f"[tp T1] row 8' partial {fmt or 'none'} timing: device ms per "
              f"call ({t['kernel']['timer']}): kernel {t['kernel']['ms']:.5f}"
              f", plain {t['plain']['ms']:.5f}, library "
              + (f"{lib['ms']:.5f}" if lib else "n/a")
              + f" (the shard's two cuBLAS GEMMs); per call incl. launch "
              f"(events): kernel {t['kernel']['call_ms']:.5f}; bound "
              f"{t['bound_ms']:.5f} ms ({t['bound_by']})", flush=True)
    out["row8p"] = timings
    # row 9 per shard
    worst_row = 0.0
    for fmt in ("int8", "fp8"):
        for name, (M, K, N), cut in (("qkv", QMM_SHAPES["qkv"], "heads"),
                                     ("Dense_0", (8192, 512, 1024), "rows")):
            xq, wq, sx, sw = quant_operands(gen, M, K, N, fmt)
            full = quant_matmul(xq, wq, sx, sw, fmt, bf16)
            for r in range(2):
                w_r = tp_shard(wq.view(torch.uint8), cut, r, 2, 8).view(
                    wq.dtype)
                got = quant_matmul(xq, w_r, sx, sw, fmt, bf16)
                same(f"row 9 {name} {fmt} column shard {r}", got,
                     tp_shard(full.T, cut, r, 2, 8).T)
        for name, (M, K, N) in (("out", (8192, 512, 512)),
                                ("Dense_1", (8192, 1024, 512))):
            xq, wq, sx, sw = quant_operands(gen, M, K, N, fmt)
            want = quant_dot_reference(xq, wq, sx, sw, fmt, torch.float32)
            kh = K // 2
            got = sum(quant_matmul(
                xq[:, r * kh:(r + 1) * kh].contiguous(),
                wq[:, r * kh:(r + 1) * kh].contiguous(), sx, sw, fmt,
                bf16).float() for r in range(2))
            e = ((got - want).abs().max() / want.abs().max()).item()
            worst_row = max(worst_row, e)
            check(e <= 2e-2, f"T1 row 9 {name} {fmt} row shards: {e}")
    print(f"[tp T1] row 9: column shards (qkv on H/2 heads, Dense_0 on "
          f"d_ff/2) bitwise the full launch's columns; row shards (out, "
          f"Dense_1) summed vs the full GEMM {worst_row:.5f} of max |plain| "
          f"(tol 2e-2), int8 and E4M3", flush=True)
    out["row9_row_err"] = worst_row
    M, K, N = QMM_SHAPES["qkv"]
    xq, wq, sx, sw = quant_operands(gen, M, K, N, "int8")
    w_r = tp_shard(wq, "heads", 1, 2, 8)
    t = {"kernel": measure(lambda: quant_matmul(xq, w_r, sx, sw, "int8",
                                                bf16)),
         "plain": measure(lambda: quant_dot_reference(xq, w_r, sx, sw,
                                                      "int8", bf16)),
         "library": library(lambda: torch._int_mm(xq, w_r.t()))}
    n_r = w_r.shape[0]
    t["bound_ms"], t["bound_by"] = bound(M * K + n_r * K + 2 * M * n_r,
                                         2 * M * K * n_r, "int8")
    out["row9_qkv_shard"] = t
    print(f"[tp T1] row 9 qkv column shard {M}x{K}->{n_r} int8: device ms "
          f"per call: kernel {t['kernel']['ms']:.5f}, plain "
          f"{t['plain']['ms']:.5f}, library "
          + (f"{t['library']['ms']:.5f}" if t["library"] else "n/a")
          + f"; bound {t['bound_ms']:.5f} ms ({t['bound_by']})", flush=True)
    return out


def t2_steps(flags, n_layers: int, n_steps: int, batch: int, seq: int,
             profile_last: bool = False, axis: str = "tp",
             attention: str = "flash", vocab: int = 30522):
    """The record at ``n_layers`` with ``flags`` stepped on ``n_steps``
    fixed global batches with the global draws, as rank r of the running
    group at ``--mesh <axis>=<world>`` (``tp``, ``sp`` or ``pp``, with
    ``attention`` under sp; no group: one card, flash attention).  Under
    pp the digests are empty (a rank holds its stage's leaves), and the
    result also holds the bytes at rest a rank (all leaves: without
    residency; after the drop: with it) and each step's wait at the stage
    boundary.  The
    classifier's rows are ragged; under ``--task lm`` packed token rows
    of ``vocab``.  The wrappers' launch counts set to 0 just before and
    read just after; with ``profile_last`` the last step runs under
    torch.profiler (the hand kernels' device launches, the step's device
    ms).  Returns a dict: losses, per-step digests of the replicated
    leaves (this rank's copies), the whole state at the end, step ms
    (median after the first), launches, the profiled step's, the peak
    of the card's allocated bytes over the steps."""
    import contextlib
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from faster_distributed_training_tpu_torch import cli
    from faster_distributed_training_tpu_torch.ops import fused_ffn as ffn
    from faster_distributed_training_tpu_torch.optim import build_optimizer
    from faster_distributed_training_tpu_torch.parallel import (
        Placement, make_mesh, make_put_batch, mesh_groups)
    from faster_distributed_training_tpu_torch.parallel.collectives import (
        DataGroup)
    from faster_distributed_training_tpu_torch.parallel.sharding import (
        tp_cut)
    from faster_distributed_training_tpu_torch.train.state import (
        create_train_state, state_leaves)
    from faster_distributed_training_tpu_torch.train.steps import (
        make_train_step, mixup_alpha, step_draws)

    defaults = cli.TRANSFORMER_DEFAULTS
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh_flags = ["--mesh", f"{axis}={world}"] if world > 1 else []
    attn = attention if world > 1 and axis == "sp" else "flash"
    cfg = cli.config_from_args(cli.build_parser(defaults=defaults).parse_args(
        ["--device", "cuda", "--n_layers", str(n_layers), "--bs",
         str(batch), "--seq_len", str(seq), "--attention", attn]
        + mesh_flags + list(flags)), defaults=defaults)
    lm = cfg.task == "lm"
    group, tp, mesh = DataGroup(), None, None
    if world > 1:
        mesh = make_mesh(cfg.mesh_axes, cfg.mesh_shape, "cuda")
        group, tp = mesh_groups(mesh)
    gen = torch.Generator().manual_seed(cfg.seed)
    model = cli.build_model(cfg, vocab_size=vocab, device="cuda", tp=tp,
                            sp=group.seq).init_weights(gen).cuda()
    draws0 = step_draws(cfg.seed, 0, batch, model.n_dropout_sites(),
                        mixup_alpha(cfg))
    with group.active():
        model.seed_amax_histories(batch, seq, draws0)
    tx, _ = build_optimizer(cfg, 64)
    state = create_train_state(model, tx, cfg.seed)

    def at_rest():
        return sum(t.numel() * t.element_size() for t in (
            list(state.model.state_dict().values())
            + [v for k, v in state_leaves(state).items()
               if k.startswith("opt/") and v.dim()]))
    bytes_whole = at_rest()
    if world > 1:
        state.placement = Placement(cfg, mesh, "cuda", group, tp)
        state.placement.shard_state(state)
    pp = axis == "pp" and world > 1
    put = make_put_batch(group, "cuda")
    step = make_train_step(cfg)
    rng = np.random.default_rng(7)
    losses, digests, times, prof, waits = [], [], [], None, []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ffn.ffn_fwd_generalized.partial_launches = 0
    for i in range(n_steps):
        lengths = (np.full(batch, seq) if lm
                   else rng.integers(seq // 4, seq + 1, batch))
        mask = (np.arange(seq)[None] < lengths[:, None]).astype(np.int32)
        tokens = rng.integers(1, vocab, (batch, seq)).astype(np.int32) * mask
        glob = {"tokens": tokens, "token_types": np.zeros_like(tokens),
                "mask": mask,
                "label": rng.integers(0, 4, batch).astype(np.int32)}
        draws = step_draws(cfg.seed, i, batch, model.n_dropout_sites(),
                           mixup_alpha(cfg))
        local = put(glob)
        torch.cuda.synchronize()
        if profile_last and i == n_steps - 1:
            counts, got = read_counts(), {}
            wall = time.perf_counter()
            kern = device_kernels(
                lambda: got.update(m=step(state, local, draws)[1]), 1)
            wall = (time.perf_counter() - wall) * 1e3
            prof = {"hand": hand_launches(kern), "wall_ms": wall,
                    "device_ms": sum(us for us, _ in kern.values()) / 1e3,
                    "launches": {k: read_counts()[k] - counts[k]
                                 for k in counts}}
            if pp:
                prof["wait_ms"] = sum(state.placement.pp_wait) * 1e3
            losses.append(float(got["m"]["loss"]))
        else:
            t0 = time.perf_counter()
            state, m = step(state, local, draws)
            losses.append(float(m["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
        if pp:
            waits.append(sum(state.placement.pp_wait) * 1e3)
            continue
        leaves = {k: v for k, v in state_leaves(state).items()
                  if k.startswith("model/") and tp_cut(k[6:]) is None}
        h = hashlib.sha256()
        for k in sorted(leaves):
            h.update(leaves[k].detach().float().cpu().numpy().tobytes())
        digests.append(h.hexdigest())
    launches = dict(read_counts(),
                    fused_ffn_partial=ffn.ffn_fwd_generalized.partial_launches)
    pl = state.placement
    with (pl.whole(state) if pl is not None else contextlib.nullcontext()):
        whole = {k: v.detach().cpu() for k, v in state_leaves(state).items()}
    return {"losses": losses, "digests": digests, "whole": whole,
            "ms": statistics.median(times[1:] or times) if times else None,
            "launches": launches, "profile": prof,
            "h_loc": model.layers[0].attn.h_loc,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "sp_rank": group.seq.rank if group.seq is not None else None,
            "pp_stage": group.pipe.stage if group.pipe is not None else None,
            "bytes_whole": bytes_whole,
            "bytes_rest": (state.placement.resident_bytes(state) if pp
                           else bytes_whole),
            "wait_ms": waits}


def t2_rank(rank: int, world: int, port: int, out_dir: str, tag: str,
            args: tuple) -> None:
    """One T2 rank: gloo on the one card, ``t2_steps(*args)``, its result
    file."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        out = t2_steps(*args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"t2_{tag}_{rank}.pt"))


def t2_group(tag: str, args: tuple, out_dir: str, world: int = 2) -> list:
    """``t2_steps(*args)`` on ``world`` gloo ranks sharing the card."""
    import multiprocessing as mp

    import torch

    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=t2_rank, args=(r, world, port, out_dir, tag,
                                               args)) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    check(all(p.exitcode == 0 for p in procs),
          f"T2 {tag}: ranks exited {[p.exitcode for p in procs]}")
    return [torch.load(os.path.join(out_dir, f"t2_{tag}_{r}.pt"))
            for r in range(world)]


def tp_phase(build_dir: str) -> dict:
    """Phase T: tensor parallelism on the one card (NCCL refuses two
    ranks on one device, so no real tp mesh over NVLink).  T1 the kernels
    per shard (``tp_kernels``).  T2 two gloo ranks at ``--mesh tp=2``:
    (a) fp32, the record's widths, 2 layers, flash and ``--ffn_impl
    pallas``, 4 fixed batches, against world 1 (loss 1e-5, params 1e-4),
    the ranks' replicated leaves bitwise equal after every step; (b)
    path B (``--ffn_impl pallas --quant int8``, bf16) at full width, 4
    steps: finite losses, replicated leaves bitwise, each hand kernel's
    device launches in one step from the profiler (rows 1 and 4: 6 on
    H/2 heads, row 8': 6, row 9: 24), step ms beside world 1's."""
    import numpy as np
    import torch

    out = {}
    t0 = time.monotonic()
    out.update(tp_kernels(torch.Generator(device="cuda").manual_seed(11)))
    print(f"[tp] T1 in {time.monotonic() - t0:.1f}s", flush=True)
    t0 = time.monotonic()
    a_args = (["--precision", "fp32", "--ffn_impl", "pallas"], T_LAYERS, 4,
              16, 512)
    ref = t2_steps(*a_args)
    ranks = t2_group("a", a_args, build_dir)
    check(ranks[0]["digests"] == ranks[1]["digests"],
          "T2(a): the ranks' replicated leaves differ")
    loss_err = max(abs(x - y) for x, y in zip(ranks[0]["losses"],
                                               ref["losses"]))
    param_err = max(float((ranks[0]["whole"][k] - v).abs().max())
                    for k, v in ref["whole"].items()
                    if k.startswith("model/") and v.is_floating_point())
    check(sorted(ranks[0]["whole"]) == sorted(ref["whole"]),
          "T2(a): the gathered state's leaves differ from world 1's")
    out.update(t2a_loss_err=loss_err, t2a_param_err=param_err,
               t2a_ms=[r["ms"] for r in ranks], t2a_ms_world1=ref["ms"])
    print(f"[tp T2a] tp=2 over gloo on one card, {T_LAYERS} layers fp32, "
          f"flash + fused FFN, 4 steps: the ranks' replicated leaves bitwise "
          f"equal after every step; vs world 1: loss err {loss_err:.3g} (tol "
          f"1e-5), param err {param_err:.3g} (tol 1e-4); step ms median "
          f"{out['t2a_ms']} (ranks 0, 1) against {ref['ms']:.2f} at world 1",
          flush=True)
    check(loss_err <= 1e-5 and param_err <= 1e-4, "T2(a): tp=2 vs world 1")
    b_args = (["--ffn_impl", "pallas", "--quant", "int8"], T_RECORD_LAYERS,
              4, 16, 512, True)
    ref_b = t2_steps(*b_args)
    rb = t2_group("b", b_args, build_dir)
    check(rb[0]["digests"] == rb[1]["digests"],
          "T2(b): the ranks' replicated leaves differ")
    check(all(np.isfinite(r["losses"]).all() for r in rb),
          f"T2(b): non-finite losses {[r['losses'] for r in rb]}")
    n = T_RECORD_LAYERS
    want = {"flash_fwd_kernel": n, "dkdv_kernel": n, "dq_kernel": n,
            "ffn_kernel": n, "qmm_kernel": 4 * n, "mlp_fwd_kernel": 1}
    for r in rb:
        got = r["profile"]["hand"]
        check(got == want and r["h_loc"] == 4,
              f"T2(b): device launches a step {got} (heads a rank "
              f"{r['h_loc']}), want {want} on 4 of 8 heads")
        check(r["profile"]["launches"]["fused_ffn_quant"] == n
              and r["launches"]["fused_ffn_partial"] == 4 * n,
              f"T2(b): row 8' wrapper launches {r['launches']}")
    out.update(t2b_launches=rb[0]["launches"],
               t2b_device_launches=rb[0]["profile"]["hand"],
               t2b_ms=[r["ms"] for r in rb], t2b_ms_world1=ref_b["ms"],
               t2b_wall_ms=[r["profile"]["wall_ms"] for r in rb],
               t2b_device_ms=[r["profile"]["device_ms"] for r in rb],
               t2b_wall_ms_world1=ref_b["profile"]["wall_ms"],
               t2b_device_ms_world1=ref_b["profile"]["device_ms"],
               t2b_losses=rb[0]["losses"])
    print(f"[tp T2b] path B (--ffn_impl pallas --quant int8, bf16) at "
          f"{n} layers, tp=2 over gloo on one card, 4 steps: losses "
          f"{[round(x, 4) for x in rb[0]['losses']]} finite; the ranks' "
          f"replicated leaves bitwise equal after every step; device "
          f"launches of one step {rb[0]['profile']['hand']} (rows 1 and 4 "
          f"on {rb[0]['h_loc']} of 8 heads; row 8' the partial tile); "
          f"step host wall ms median {out['t2b_ms']} (ranks 0, 1) against "
          f"{ref_b['ms']:.2f} at world 1; the profiled step's device ms "
          f"{out['t2b_device_ms']} against {ref_b['profile']['device_ms']:.2f}"
          f" (printed, not a claim: gloo stages every collective through "
          f"the host)", flush=True)
    print(f"[tp] T2 in {time.monotonic() - t0:.1f}s", flush=True)
    return out


def tp_main() -> int:
    """``--tp``: the kernels' build, then phase T alone."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from faster_distributed_training_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}",
          flush=True)
    build_s, _ = _build.build()
    print(f"[build] {build_s:.1f}s", flush=True)
    tp = tp_phase(str(_build.BUILD_DIR))
    print(json.dumps(tp, default=str))
    return 0


S_LAYERS = 2             # S2(a)'s depth


def sp_kernels(gen) -> dict:
    """S1: rows 7 and 8 (the fused FFN: none, int8, E4M3) on the two
    sequence halves of the record's training rows (B 16 x L 512 = 8192
    rows, 512 -> 1024 -> 512, dropout 0.1 at both sites), launched at s0
    = 0 and L/2 with l_loc = L/2, l_glob = L: each half bitwise the full
    launch's rows, two launches bitwise, the halves' amax MAX the full
    launch's (bitwise), each half against its plain version on the card
    (2e-2 of max |plain|, amaxes 1e-2); the second half's timing."""
    import torch

    from faster_distributed_training_tpu_torch.ops.fused_ffn import (
        _ffn_body_reference, ffn_fwd, ffn_fwd_generalized)
    from faster_distributed_training_tpu_torch.ops.quant import quantize

    rate, bf16 = 0.1, torch.bfloat16
    B, L = 16, 512
    rows, d, d_ff = FFN_SHAPE
    half = L // 2
    args = ffn_inputs(gen, rows, d, d_ff, bf16)
    h, rest = args[0], args[1:]
    scales = torch.tensor(FFN_SCALES, device="cuda")
    parts = [h.view(B, L, d)[:, s * half:(s + 1) * half].reshape(
        B * half, d).contiguous() for s in range(2)]
    seeds = FFN_SEEDS[:2]

    def launch(x, s0, l_loc, fmt):
        if fmt is None:     # row 7's wrapper
            return ffn_fwd(x, *rest, *seeds, rate, rate, 1e-6, 0, s0, l_loc,
                           L), None
        return ffn_fwd_generalized(x, *rest, (*seeds, 0, s0, 0), scales,
                                   rate, rate, 1e-6, l_loc, L, d_ff, fmt)

    def plain(x, s0, fmt):
        quant = None if fmt is None else (fmt, *scales.unbind(), None)
        return _ffn_body_reference(x, *rest, *seeds, rate, rate, 1e-6, 0,
                                   s0, half, L, quant=quant,
                                   return_amax=True, plain_gemm=True)

    out, errs = {}, {}
    for fmt in (None, "int8", "fp8"):
        tag = fmt or "none"
        full, famax = launch(h, 0, L, fmt)
        fullv = full.view(B, L, d)
        amaxes, worst, worst_abs = [], 0.0, 0.0
        for s in range(2):
            s0 = s * half
            got, a = launch(parts[s], s0, half, fmt)
            again, a2 = launch(parts[s], s0, half, fmt)
            check(torch.equal(got, again) and (a is None or torch.equal(
                a, a2)), f"S1 row {7 if fmt is None else 8} {tag} s0={s0}: "
                f"two launches differ")
            d_full = float((got.view(B, half, d).float() - fullv[
                :, s0:s0 + half].float()).abs().max())
            check(torch.equal(got.view(B, half, d),
                              fullv[:, s0:s0 + half]),
                  f"S1 {tag} s0={s0}: the half != the full launch's rows "
                  f"({d_full})")
            want, want_amax = plain(parts[s], s0, fmt)
            e = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            worst, worst_abs = max(worst, e / scale), max(worst_abs, e)
            check(e <= 2e-2 * scale, f"S1 {tag} s0={s0}: err {e} over 2e-2 "
                  f"x {scale} of its plain version")
            if fmt is not None:
                check(torch.allclose(a, want_amax, rtol=1e-2, atol=0),
                      f"S1 {tag} s0={s0}: amax {a} vs plain {want_amax}")
                amaxes.append(a)
        if fmt is not None:
            check(torch.equal(torch.maximum(*amaxes), famax),
                  f"S1 {tag}: the halves' amax MAX "
                  f"{torch.maximum(*amaxes)} != the full launch's {famax}")
        errs[tag] = {"rel": worst, "abs": worst_abs}
        print(f"[sp S1] row {7 if fmt is None else 8} {tag} at {B} x {L} "
              f"rows x {d} -> {d_ff}: the sequence halves (s0 = 0, {half}; "
              f"l_loc {half}, l_glob {L}) bitwise the full launch's rows, "
              f"two launches bitwise"
              + (", the halves' amax MAX bitwise the full's" if fmt else "")
              + f"; vs the plain version {worst:.5f} of max |plain| (tol "
              f"2e-2)", flush=True)
    out["s1_err"] = errs
    # timing at the second half (s0 = L/2): kernel, plain, library (the
    # half's two cuBLAS GEMMs), bound
    x = parts[1]
    n = x.shape[0]
    f = torch.randn(n, d, generator=gen, device="cuda").to(bf16)
    a = torch.randn(n, d_ff, generator=gen, device="cuda").to(bf16)
    inv = [(1.0 / v).reshape(()) for v in scales.unbind()]
    timings = {}
    for fmt in (None, "int8", "fp8"):
        t = {"kernel": measure(lambda: launch(x, half, half, fmt)),
             "full": measure(lambda: launch(h, 0, L, fmt)),
             "plain": measure(lambda: plain(x, half, fmt))}
        if fmt is None:
            t["library"] = library(lambda: (torch.matmul(f, rest[2].t()),
                                            torch.matmul(a, rest[4].t())))
        else:
            fq, aq = quantize(f, scales[0], fmt), quantize(a, scales[2], fmt)
            w1q = quantize(rest[2], scales[1], fmt)
            w2q = quantize(rest[4], scales[3], fmt)
            if fmt == "int8":
                t["library"] = library(lambda: (torch._int_mm(fq, w1q.t()),
                                                torch._int_mm(aq, w2q.t())))
            else:
                t["library"] = library(lambda: (
                    torch._scaled_mm(fq, w1q.t(), scale_a=inv[0],
                                     scale_b=inv[1], out_dtype=bf16),
                    torch._scaled_mm(aq, w2q.t(), scale_a=inv[2],
                                     scale_b=inv[3], out_dtype=bf16)))
        w_bytes = 2 if fmt is None else 1
        # read the half's rows, both weight matrices, the biases and LN
        # parameters once; write the half's output (and two amaxes)
        t["bound_ms"], t["bound_by"] = bound(
            2 * n * d * 2 + 2 * d * d_ff * w_bytes + 2 * (d_ff + d) + 8 * d
            + 8, 4 * n * d * d_ff, "bf16" if fmt is None else fmt)
        timings[fmt or "none"] = t
        lib = t["library"]
        print(f"[sp S1] row {7 if fmt is None else 8} {fmt or 'none'} half "
              f"({n} rows at s0 {half}) timing: device ms per call "
              f"({t['kernel']['timer']}): kernel {t['kernel']['ms']:.5f}, "
              f"plain {t['plain']['ms']:.5f}, library "
              + (f"{lib['ms']:.5f}" if lib else "n/a")
              + f" (the half's two cuBLAS GEMMs); per call incl. launch "
              f"(events): kernel {t['kernel']['call_ms']:.5f}; bound "
              f"{t['bound_ms']:.5f} ms ({t['bound_by']}); the full launch "
              f"({rows} rows) {t['full']['ms']:.5f}", flush=True)
    out["s1"] = timings
    return out


def s2_rank(rank: int, world: int, port: int, out_dir: str,
            cases: dict) -> None:
    """One S2 rank: gloo on the one card, ``t2_steps(*args)`` of every case
    in one process group, their results in one file."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        out = {tag: t2_steps(*args) for tag, args in cases.items()}
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"s2_{rank}.pt"))


def sp_phase(build_dir: str) -> dict:
    """Phase S: sequence parallelism on the one card (NCCL refuses two
    ranks on one device, so no real sp mesh over NVLink).  S1 rows 7 and
    8 on sequence halves (``sp_kernels``).  S2 two gloo ranks at
    ``--mesh sp=2`` in one group: (a) fp32, the record's widths, 2
    layers, ``--ffn_impl pallas`` (row 7 at s0), ring and Ulysses (the
    flash kernels at h0 = 0, 4), 4 fixed batches each, against world 1
    (flash, loss 1e-5, params 1e-4), the ranks' replicated leaves bitwise
    equal after every step; (b) path B (``--ffn_impl pallas --quant
    int8``, Ulysses) at full width, 4 steps: finite losses, replicated
    leaves bitwise, each hand kernel's device launches in one step from
    the profiler (rows 1 and 4 on 4 of 8 heads of the whole sequence,
    row 8 on half the positions, row 9, row 6: 6, 6, 6, 24, 1), host
    wall and device ms a step beside world 1's; (c) path E (the LM at
    seq 8192, B 4, Ulysses, rows 2 and 3 at h0 = 0 and 4), 2 steps: host
    wall, device ms and peak a rank beside world 1's."""
    import multiprocessing as mp

    import numpy as np
    import torch

    out = {}
    t0 = time.monotonic()
    out.update(sp_kernels(torch.Generator(device="cuda").manual_seed(13)))
    print(f"[sp] S1 in {time.monotonic() - t0:.1f}s", flush=True)
    t0 = time.monotonic()
    a_flags = ["--precision", "fp32", "--ffn_impl", "pallas"]
    b_flags = ["--ffn_impl", "pallas", "--quant", "int8"]
    e_flags = ["--task", "lm", "--precision", "bf16"]
    cases = {
        "a_ring": (a_flags, S_LAYERS, 4, 16, 512, False, "sp", "ring"),
        "a_ulysses": (a_flags, S_LAYERS, 4, 16, 512, False, "sp",
                      "ulysses"),
        "b": (b_flags, T_RECORD_LAYERS, 4, 16, 512, True, "sp", "ulysses"),
        "e": (e_flags, T_RECORD_LAYERS, 2, LONG["B"], LONG["L"], True, "sp",
              "ulysses", 605)}
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=s2_rank, args=(r, 2, port, build_dir, cases))
             for r in range(2)]
    for p in procs:
        p.start()
    # the world-1 references while the ranks start
    ref = {tag: t2_steps(*args) for tag, args in (
        ("a", cases["a_ring"]), ("b", cases["b"]), ("e", cases["e"]))}
    for p in procs:
        p.join(900)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    check(all(p.exitcode == 0 for p in procs),
          f"S2: ranks exited {[p.exitcode for p in procs]}")
    ranks = [torch.load(os.path.join(build_dir, f"s2_{r}.pt"))
             for r in range(2)]
    for tag in ("a_ring", "a_ulysses"):
        rs = [r[tag] for r in ranks]
        check(rs[0]["digests"] == rs[1]["digests"],
              f"S2({tag}): the ranks' replicated leaves differ")
        check(sorted(rs[0]["whole"]) == sorted(ref["a"]["whole"]),
              f"S2({tag}): the state's leaves differ from world 1's")
        loss_err = max(abs(x - y) for x, y in zip(rs[0]["losses"],
                                                   ref["a"]["losses"]))
        param_err = max(float((rs[0]["whole"][k] - v).abs().max())
                        for k, v in ref["a"]["whole"].items()
                        if k.startswith("model/") and v.is_floating_point())
        out.update({f"s2{tag}_loss_err": loss_err,
                    f"s2{tag}_param_err": param_err,
                    f"s2{tag}_ms": [r["ms"] for r in rs],
                    f"s2{tag}_launches": rs[0]["launches"]})
        check(rs[0]["launches"]["fused_ffn"] == 4 * S_LAYERS,
              f"S2({tag}): row 7 launches {rs[0]['launches']}")
        print(f"[sp S2{tag[0]}] {tag[2:]} at sp=2 over gloo on one card, "
              f"{S_LAYERS} layers fp32, fused FFN (row 7 at s0 = 0, 256), 4 "
              f"steps: the ranks' replicated leaves bitwise equal after "
              f"every step; vs world 1 (flash): loss err {loss_err:.3g} (tol "
              f"1e-5), param err {param_err:.3g} (tol 1e-4); step ms median "
              f"{out[f's2{tag}_ms']} (ranks 0, 1) against "
              f"{ref['a']['ms']:.2f} at world 1; wrapper launches "
              f"{rs[0]['launches']}", flush=True)
        check(loss_err <= 1e-5 and param_err <= 1e-4,
              f"S2({tag}): sp=2 vs world 1")
    n = T_RECORD_LAYERS
    rb = [r["b"] for r in ranks]
    check(rb[0]["digests"] == rb[1]["digests"],
          "S2(b): the ranks' replicated leaves differ")
    check(all(np.isfinite(r["losses"]).all() for r in rb),
          f"S2(b): non-finite losses {[r['losses'] for r in rb]}")
    want = {"flash_fwd_kernel": n, "dkdv_kernel": n, "dq_kernel": n,
            "ffn_kernel": n, "qmm_kernel": 4 * n, "mlp_fwd_kernel": 1}
    for r in rb:
        check(r["profile"]["hand"] == want,
              f"S2(b): device launches a step {r['profile']['hand']}, want "
              f"{want}")
    out.update(s2b_device_launches=rb[0]["profile"]["hand"],
               s2b_launches=rb[0]["launches"],
               s2b_ms=[r["ms"] for r in rb], s2b_ms_world1=ref["b"]["ms"],
               s2b_wall_ms=[r["profile"]["wall_ms"] for r in rb],
               s2b_device_ms=[r["profile"]["device_ms"] for r in rb],
               s2b_wall_ms_world1=ref["b"]["profile"]["wall_ms"],
               s2b_device_ms_world1=ref["b"]["profile"]["device_ms"],
               s2b_losses=rb[0]["losses"])
    print(f"[sp S2b] path B (--ffn_impl pallas --quant int8, bf16, Ulysses) "
          f"at {n} layers, sp=2 over gloo on one card, 4 steps: losses "
          f"{[round(x, 4) for x in rb[0]['losses']]} finite; the ranks' "
          f"replicated leaves bitwise equal after every step; device "
          f"launches of one step {rb[0]['profile']['hand']} (a rank: rows "
          f"1 and 4 on 4 of 8 heads of all 512 positions, row 8 on its 256 "
          f"positions); step host wall ms median {out['s2b_ms']} (ranks 0, "
          f"1) against {ref['b']['ms']:.2f} at world 1; the profiled step's "
          f"device ms {out['s2b_device_ms']} against "
          f"{ref['b']['profile']['device_ms']:.2f} (gloo stages every "
          f"collective through the host)", flush=True)
    re_ = [r["e"] for r in ranks]
    check(re_[0]["digests"] == re_[1]["digests"],
          "S2(c): the ranks' replicated leaves differ")
    check(all(np.isfinite(r["losses"]).all() for r in re_),
          f"S2(c): non-finite losses {[r['losses'] for r in re_]}")
    for r in re_:
        got = r["profile"]["hand"]
        check(got.get("flash_fwd_kernel") == n and got.get("dkdv_kernel")
              == n and got.get("dq_kernel") == n,
              f"S2(c): rows 2 and 3 launches a step {got}")
    out.update(s2c_wall_ms=[r["profile"]["wall_ms"] for r in re_],
               s2c_device_ms=[r["profile"]["device_ms"] for r in re_],
               s2c_peak_bytes=[r["peak_bytes"] for r in re_],
               s2c_h0=[r["sp_rank"] * 4 for r in re_],
               s2c_device_launches=re_[0]["profile"]["hand"],
               s2c_wall_ms_world1=ref["e"]["profile"]["wall_ms"],
               s2c_device_ms_world1=ref["e"]["profile"]["device_ms"],
               s2c_peak_bytes_world1=ref["e"]["peak_bytes"],
               s2c_losses=re_[0]["losses"])
    print(f"[sp S2c] path E (--task lm, B {LONG['B']} L {LONG['L']}, "
          f"Ulysses) at sp=2 over gloo on one card, 2 steps: losses "
          f"{[round(x, 4) for x in re_[0]['losses']]}; rows 2 and 3 at h0 "
          f"{out['s2c_h0']} (ranks 0, 1), {n} each a step; the profiled "
          f"step's host wall ms {[round(x, 2) for x in out['s2c_wall_ms']]}"
          f", device ms {[round(x, 2) for x in out['s2c_device_ms']]}, "
          f"peak {[round(b / 2**30, 2) for b in out['s2c_peak_bytes']]} "
          f"GiB a rank; world 1: {ref['e']['profile']['wall_ms']:.2f} ms "
          f"wall, {ref['e']['profile']['device_ms']:.2f} ms device, peak "
          f"{ref['e']['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    print(f"[sp] S2 in {time.monotonic() - t0:.1f}s", flush=True)
    return out


def sp_main() -> int:
    """``--sp``: the kernels' build, then phase S alone."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from faster_distributed_training_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}",
          flush=True)
    build_s, _ = _build.build()
    print(f"[build] {build_s:.1f}s", flush=True)
    sp = sp_phase(str(_build.BUILD_DIR))
    print(json.dumps(sp, default=str))
    return 0


# -- slice 13: pipeline parallelism (phase PP) ---------------------------------

PP_MICRO = 4        # the record's 16 rows as 4 microbatches


def pp_kernels(gen) -> dict:
    """PP1: rows 1 and 4 (the flash forward with lse, its saved-stats
    backward; B 16, H 8, L 512, D 64, key padding) and rows 7 and 8 (the
    fused FFN: none, int8, E4M3; 16 x 512 rows, 512 -> 1024 -> 512), all
    at dropout 0.1, launched on the 4 microbatches of a pipeline step at
    b0 = 0, 4, 8, 12: each bitwise the full launch's rows, the
    microbatches' amax MAX bitwise the full launch's; each microbatch
    against its plain version on the card (flash 2e-2 abs, lse 1e-3; the
    FFN 2e-2 of max |plain|, amaxes 1e-2); the last microbatch's timing
    (kernel, plain, library, bound)."""
    import torch
    import torch.nn.functional as F

    from faster_distributed_training_tpu_torch.ops import flash_attention as fa
    from faster_distributed_training_tpu_torch.ops.fused_ffn import (
        _ffn_body_reference, ffn_fwd, ffn_fwd_generalized)
    from faster_distributed_training_tpu_torch.ops.quant import quantize

    seed, rate, bf16 = 0x2545F491, 0.1, torch.bfloat16
    B, H, L, D = 16, 8, 512, 64
    mb = B // PP_MICRO
    origins = list(range(0, B, mb))
    q, k, v = qkv_views(B, H, L, D, bf16, gen)
    dout = torch.randn(B, H, L, D, generator=gen, device="cuda").to(bf16)
    mask = ragged_mask(B, L, gen)
    full = fa.flash_attention_stats(q, k, v, mask, rate, seed)
    grads = fa.flash_attention_bwd(q, k, v, *full[:2], dout, mask, rate,
                                   seed, full[2])
    errs = {"flash_fwd": 0.0, "flash_bwd_stats": 0.0}
    for b0 in origins:
        s = slice(b0, b0 + mb)
        got = fa.flash_attention_stats(q[s], k[s], v[s], mask[s], rate, seed,
                                       b0=b0)
        for name, a, b in zip(("out", "lse", "lse_lo"), got, full):
            check(torch.equal(a, b[s]), f"PP1 row 1 b0={b0} {name}: the "
                  f"microbatch != the full launch's rows")
        g = fa.flash_attention_bwd(q[s], k[s], v[s], *got[:2], dout[s],
                                   mask[s], rate, seed, got[2], b0=b0)
        for name, a, b in zip(("dq", "dk", "dv"), g, grads):
            check(torch.equal(a, b[s]), f"PP1 row 4 b0={b0} {name}: the "
                  f"microbatch != the full launch's rows")
        ref = fa.flash_attention_stats_reference(q[s], k[s], v[s], mask[s],
                                                 rate, seed, b0=b0)
        e = float((got[0].float() - ref[0].float()).abs().max())
        e_lse = float((got[1] - ref[1]).abs().max())
        check(e <= 2e-2 and e_lse <= 1e-3, f"PP1 row 1 b0={b0}: {e} / lse "
              f"{e_lse} vs its plain version")
        errs["flash_fwd"] = max(errs["flash_fwd"], e)
        gref = fa.flash_attention_bwd_reference(
            q[s], k[s], v[s], *ref[:2], dout[s], mask[s], rate, seed, ref[2],
            b0=b0)
        for a, b in zip(g, gref):
            e = float((a.float() - b.float()).abs().max())
            scale = float(b.float().abs().max())
            check(e <= 2e-2 * scale, f"PP1 row 4 b0={b0}: {e} over 2e-2 x "
                  f"{scale} of its plain version")
            errs["flash_bwd_stats"] = max(errs["flash_bwd_stats"], e)
    print(f"[pp PP1] flash rows 1 and 4 at B {B} H {H} L {L} D {D}, dropout "
          f"{rate}: the {PP_MICRO} microbatches at b0 = {origins} bitwise the "
          f"full launch's rows (out, lse, dq, dk, dv); vs the plain versions "
          f"{errs['flash_fwd']:.5f} / {errs['flash_bwd_stats']:.5f} abs",
          flush=True)
    rows, d, d_ff = FFN_SHAPE
    args = ffn_inputs(gen, rows, d, d_ff, bf16)
    h, rest = args[0], args[1:]
    scales = torch.tensor(FFN_SCALES, device="cuda")
    seeds = FFN_SEEDS[:2]

    def launch(x, b0, fmt):
        if fmt is None:     # row 7's wrapper
            return ffn_fwd(x, *rest, *seeds, rate, rate, 1e-6, b0, 0, L,
                           L), None
        return ffn_fwd_generalized(x, *rest, (*seeds, b0, 0, 0), scales,
                                   rate, rate, 1e-6, L, L, d_ff, fmt)

    def plain(x, b0, fmt):
        quant = None if fmt is None else (fmt, *scales.unbind(), None)
        return _ffn_body_reference(x, *rest, *seeds, rate, rate, 1e-6, b0,
                                   0, L, L, quant=quant, return_amax=True,
                                   plain_gemm=True)

    for fmt in (None, "int8", "fp8"):
        tag = fmt or "none"
        whole, wamax = launch(h, 0, fmt)
        amaxes, worst, worst_abs = [], 0.0, 0.0
        for b0 in origins:
            r = slice(b0 * L, (b0 + mb) * L)
            got, a = launch(h[r], b0, fmt)
            check(torch.equal(got, whole[r]), f"PP1 {tag} b0={b0}: the "
                  f"microbatch != the full launch's rows")
            want, want_amax = plain(h[r], b0, fmt)
            e = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            worst, worst_abs = max(worst, e / scale), max(worst_abs, e)
            check(e <= 2e-2 * scale, f"PP1 {tag} b0={b0}: err {e} over 2e-2 "
                  f"x {scale} of its plain version")
            if fmt is not None:
                check(torch.allclose(a, want_amax, rtol=1e-2, atol=0),
                      f"PP1 {tag} b0={b0}: amax {a} vs plain {want_amax}")
                amaxes.append(a)
        if fmt is not None:
            check(torch.equal(torch.stack(amaxes).amax(0), wamax),
                  f"PP1 {tag}: the microbatches' amax MAX != the full "
                  f"launch's")
        errs[tag] = {"rel": worst, "abs": worst_abs}
        print(f"[pp PP1] row {7 if fmt is None else 8} {tag} at {rows} rows "
              f"x {d} -> {d_ff}: the {PP_MICRO} microbatches ({mb * L} rows "
              f"at b0 = {origins}) bitwise the full launch's rows"
              + (", their amax MAX bitwise the full's" if fmt else "")
              + f"; vs the plain version {worst:.5f} of max |plain| (tol "
              f"2e-2)", flush=True)
    # timing at the last microbatch (b0 = 12): kernel, plain, library, bound
    s = slice(B - mb, B)
    qs, ks, vs, ms_, ds = q[s], k[s], v[s], mask[s], dout[s]
    sdpa_mask = (ms_[:, None, None, :] != 0)
    n, nld = mb * H, mb * H * L * D
    out = {}
    t = {"kernel": measure(lambda: fa.flash_attention_stats(
             qs, ks, vs, ms_, rate, seed, b0=B - mb), group="flash_fwd"),
         "plain": measure(lambda: fa.flash_attention_stats_reference(
             qs, ks, vs, ms_, rate, seed, b0=B - mb)),
         "library": library(lambda: F.scaled_dot_product_attention(
             qs, ks, vs, attn_mask=sdpa_mask))}
    t["bound_ms"], t["bound_by"] = bound(4 * nld * 2 + 2 * n * L * 4
                                         + mb * L * 4, 4 * n * L * L * D,
                                         "bf16")
    out["flash_fwd"] = t
    o, lse, lo = fa.flash_attention_stats(qs, ks, vs, ms_, rate, seed,
                                          b0=B - mb)
    leaves = [x.detach().requires_grad_(True) for x in (qs, ks, vs)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=sdpa_mask)
    t = {"kernel": measure(lambda: fa.flash_attention_bwd(
             qs, ks, vs, o, lse, ds, ms_, rate, seed, lo, b0=B - mb)),
         "plain": measure(lambda: fa.flash_attention_bwd_reference(
             qs, ks, vs, o, lse, ds, ms_, rate, seed, lo, b0=B - mb)),
         "library": library(lambda: torch.autograd.grad(
             sdpa_out, leaves, ds, retain_graph=True))}
    t["bound_ms"], t["bound_by"] = bound(8 * nld * 2 + 2 * n * L * 4
                                         + mb * L * 4, 10 * n * L * L * D,
                                         "bf16")
    out["flash_bwd_stats"] = t
    del leaves, sdpa_out
    x = h[(B - mb) * L:]
    nr = x.shape[0]
    f = torch.randn(nr, d, generator=gen, device="cuda").to(bf16)
    a = torch.randn(nr, d_ff, generator=gen, device="cuda").to(bf16)
    inv = [(1.0 / v_).reshape(()) for v_ in scales.unbind()]
    for fmt in (None, "int8", "fp8"):
        t = {"kernel": measure(lambda: launch(x, B - mb, fmt)),
             "plain": measure(lambda: plain(x, B - mb, fmt))}
        if fmt is None:
            t["library"] = library(lambda: (torch.matmul(f, rest[2].t()),
                                            torch.matmul(a, rest[4].t())))
        else:
            fq, aq = quantize(f, scales[0], fmt), quantize(a, scales[2], fmt)
            w1q = quantize(rest[2], scales[1], fmt)
            w2q = quantize(rest[4], scales[3], fmt)
            if fmt == "int8":
                t["library"] = library(lambda: (torch._int_mm(fq, w1q.t()),
                                                torch._int_mm(aq, w2q.t())))
            else:
                t["library"] = library(lambda: (
                    torch._scaled_mm(fq, w1q.t(), scale_a=inv[0],
                                     scale_b=inv[1], out_dtype=bf16),
                    torch._scaled_mm(aq, w2q.t(), scale_a=inv[2],
                                     scale_b=inv[3], out_dtype=bf16)))
        w_bytes = 2 if fmt is None else 1
        t["bound_ms"], t["bound_by"] = bound(
            2 * nr * d * 2 + 2 * d * d_ff * w_bytes + 2 * (d_ff + d) + 8 * d
            + 8, 4 * nr * d * d_ff, "bf16" if fmt is None else fmt)
        out["ffn_" + (fmt or "none")] = t
    for name, t in out.items():
        lib = t["library"]
        print(f"[pp PP1] {name} at the last microbatch (b0 {B - mb}, {mb} "
              f"rows) timing: device ms per call ({t['kernel']['timer']}): "
              f"kernel {t['kernel']['ms']:.5f}, plain {t['plain']['ms']:.5f}, "
              f"library " + (f"{lib['ms']:.5f}" if lib else "n/a")
              + f"; per call incl. launch (events): kernel "
              f"{t['kernel']['call_ms']:.5f}; bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']})", flush=True)
    return {"pp1": out, "pp1_err": errs}


def pp2_rank(rank: int, world: int, port: int, out_dir: str,
             cases: dict) -> None:
    """One PP2 rank: gloo on the one card, ``t2_steps(*args)`` of every
    case in one process group, their results in one file."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        out = {tag: t2_steps(*args) for tag, args in cases.items()}
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"pp2_{rank}.pt"))


def pp_phase(build_dir: str) -> dict:
    """Phase PP: pipeline parallelism on the one card (NCCL refuses two
    ranks on one device: the two stages run over gloo).  PP1 rows 1, 4,
    7, 8 on the 4 microbatches of the record's 16 rows (``pp_kernels``).
    PP2 two gloo ranks at ``--mesh pp=2`` in one group, M = 4: (a) fp32,
    the record's widths, 4 layers, the fused FFN, 1f1b and interleaved, 4
    fixed batches each, against world 1 (loss 1e-5, params 1e-4); (b) the
    record at full width (6 layers, bf16, flash), 4 steps: each rank's
    device launches of one step (rows 1 and 4: 3 layers x 4 microbatches
    = 12, row 6 once on the last stage), host wall, device ms, the wait
    at the stage boundary, bytes at rest a rank with and without
    residency, beside world 1's; (c) path B (``--ffn_impl pallas --quant
    int8``) at 6 layers, one step: launches, the amax histories against
    world 1's after the same step (1e-5 relative: every microbatch's
    amaxes are the full rows', and one roll a step MAXes them); and the
    same in fp32 over 4 steps, the histories against world 1's after the
    fourth (1e-5 relative): the cadence from the second step on, where
    bf16 runs part (the microbatches' summed weight gradients round
    otherwise than the full batch's; bf16 activations and int8 rounding
    amplify that, fp32 does not at this depth); (d)
    path E (the LM at seq 8192, B 4), 2 steps: peak a rank beside world
    1's."""
    import multiprocessing as mp

    import numpy as np
    import torch

    out = {}
    t0 = time.monotonic()
    out.update(pp_kernels(torch.Generator(device="cuda").manual_seed(17)))
    print(f"[pp] PP1 in {time.monotonic() - t0:.1f}s", flush=True)
    t0 = time.monotonic()
    a_flags = ["--precision", "fp32", "--ffn_impl", "pallas"]
    b_flags = []
    c_flags = ["--ffn_impl", "pallas", "--quant", "int8"]
    e_flags = ["--task", "lm", "--precision", "bf16"]
    n = T_RECORD_LAYERS
    cases = {
        "a_1f1b": (a_flags, 4, 4, 16, 512, False, "pp"),
        "a_interleaved": (a_flags + ["--pp_schedule", "interleaved"], 4, 4,
                          16, 512, False, "pp"),
        "b": (b_flags, n, 4, 16, 512, True, "pp"),
        "c": (c_flags, n, 1, 16, 512, True, "pp"),
        "c_fp32": (c_flags + ["--precision", "fp32"], n, 4, 16, 512, False,
                   "pp"),
        "d": (e_flags, n, 2, LONG["B"], LONG["L"], True, "pp", "flash",
              605)}
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=pp2_rank, args=(r, 2, port, build_dir,
                                                cases))
             for r in range(2)]
    for p in procs:
        p.start()
    # the world-1 references while the ranks start
    ref = {tag: t2_steps(*args) for tag, args in (
        ("a", cases["a_1f1b"]), ("b", cases["b"]), ("c", cases["c"]),
        ("c_fp32", cases["c_fp32"]), ("d", cases["d"]))}
    for p in procs:
        p.join(900)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    check(all(p.exitcode == 0 for p in procs),
          f"PP2: ranks exited {[p.exitcode for p in procs]}")
    ranks = [torch.load(os.path.join(build_dir, f"pp2_{r}.pt"))
             for r in range(2)]
    for tag in ("a_1f1b", "a_interleaved"):
        rs = [r[tag] for r in ranks]
        check(rs[0]["losses"] == rs[1]["losses"],
              f"PP2({tag}): the ranks report different losses")
        check(sorted(rs[0]["whole"]) == sorted(ref["a"]["whole"]),
              f"PP2({tag}): the state's leaves differ from world 1's")
        for k, v in rs[0]["whole"].items():
            check(torch.equal(v, rs[1]["whole"][k]),
                  f"PP2({tag}): the ranks' gathered {k} differ")
        loss_err = max(abs(x - y) for x, y in zip(rs[0]["losses"],
                                                   ref["a"]["losses"]))
        param_err = max(float((rs[0]["whole"][k] - v).abs().max())
                        for k, v in ref["a"]["whole"].items()
                        if k.startswith("model/") and v.is_floating_point())
        out.update({f"pp2{tag}_loss_err": loss_err,
                    f"pp2{tag}_param_err": param_err,
                    f"pp2{tag}_launches": [r["launches"] for r in rs]})
        print(f"[pp PP2a] {tag[2:]} at pp=2 over gloo on one card, 4 layers "
              f"fp32, fused FFN (row 7 at each microbatch's b0), M "
              f"{PP_MICRO}, 4 steps: the ranks' gathered states bitwise "
              f"equal; vs world 1: loss err {loss_err:.3g} (tol 1e-5), param "
              f"err {param_err:.3g} (tol 1e-4); wrapper launches "
              f"{[r['launches'] for r in rs]} (stages 0, 1)", flush=True)
        check(loss_err <= 1e-5 and param_err <= 1e-4,
              f"PP2({tag}): pp=2 vs world 1")
    rb = [r["b"] for r in ranks]
    check(all(np.isfinite(r["losses"]).all() for r in rb),
          f"PP2(b): non-finite losses {[r['losses'] for r in rb]}")
    per = n // 2 * PP_MICRO
    for r in rb:
        last = r["pp_stage"] == 1
        want = {"flash_fwd_kernel": per, "dkdv_kernel": per,
                "dq_kernel": per, **({"mlp_fwd_kernel": 1} if last else {})}
        check(r["profile"]["hand"] == want,
              f"PP2(b): stage {r['pp_stage']}'s device launches a step "
              f"{r['profile']['hand']}, want {want}")
    out.update(
        pp2b_device_launches=[r["profile"]["hand"] for r in rb],
        pp2b_launches=[r["launches"] for r in rb],
        pp2b_ms=[r["ms"] for r in rb], pp2b_ms_world1=ref["b"]["ms"],
        pp2b_wall_ms=[r["profile"]["wall_ms"] for r in rb],
        pp2b_device_ms=[r["profile"]["device_ms"] for r in rb],
        pp2b_wait_ms=[r["profile"]["wait_ms"] for r in rb],
        pp2b_wait_ms_steps=[r["wait_ms"] for r in rb],
        pp2b_wait_ms_median=[statistics.median(r["wait_ms"][1:-1])
                             for r in rb],
        pp2b_wall_ms_world1=ref["b"]["profile"]["wall_ms"],
        pp2b_device_ms_world1=ref["b"]["profile"]["device_ms"],
        pp2b_bytes_rest=[r["bytes_rest"] for r in rb],
        pp2b_bytes_whole=[r["bytes_whole"] for r in rb],
        pp2b_bytes_world1=ref["b"]["bytes_whole"],
        pp2b_losses=rb[0]["losses"], pp2b_losses_world1=ref["b"]["losses"])
    mib = [round(x / 2**20, 1) for x in out["pp2b_bytes_rest"]]
    share = [x / out["pp2b_bytes_world1"] for x in out["pp2b_bytes_rest"]]
    print(f"[pp PP2b] the record (6 layers, bf16, flash) at pp=2 over gloo on "
          f"one card, M {PP_MICRO}, 4 steps: losses "
          f"{[round(x, 4) for x in rb[0]['losses']]} (world 1 "
          f"{[round(x, 4) for x in ref['b']['losses']]}); device launches of "
          f"one step {out['pp2b_device_launches']} (stages 0, 1); step host "
          f"wall ms median {[round(x, 2) for x in out['pp2b_ms']]} against "
          f"{ref['b']['ms']:.2f} at world 1, of which the wait at the stage "
          f"boundary {[round(x, 2) for x in out['pp2b_wait_ms_median']]} ms "
          f"(median of steps 2-3); the profiled step's device ms "
          f"{[round(x, 2) for x in out['pp2b_device_ms']]} (world 1 "
          f"{ref['b']['profile']['device_ms']:.2f}), its host wall under "
          f"the profiler {[round(x, 2) for x in out['pp2b_wall_ms']]} ms "
          f"(world 1 {ref['b']['profile']['wall_ms']:.2f}), its wait "
          f"{[round(x, 2) for x in out['pp2b_wait_ms']]} ms; bytes "
          f"at rest a rank {mib} MiB with residency "
          f"({[round(x, 3) for x in share]} of world 1's "
          f"{out['pp2b_bytes_world1'] / 2**20:.1f} MiB, which every rank "
          f"holds without it)", flush=True)
    rc = [r["c"] for r in ranks]
    check(all(np.isfinite(r["losses"]).all() for r in rc),
          f"PP2(c): non-finite losses {[r['losses'] for r in rc]}")
    for r in rc:
        last = r["pp_stage"] == 1
        want = {"flash_fwd_kernel": per, "dkdv_kernel": per,
                "dq_kernel": per, "ffn_kernel": per, "qmm_kernel": 4 * per,
                **({"mlp_fwd_kernel": 1} if last else {})}
        check(r["profile"]["hand"] == want,
              f"PP2(c): stage {r['pp_stage']}'s device launches a step "
              f"{r['profile']['hand']}, want {want}")
    def hist_rel_err(tag, got):
        err = 0.0
        for k, v in ref[tag]["whole"].items():
            if "amax_history" in k:
                check(bool(v.any()), f"PP2({tag}): {k} is all zero")
                err = max(err, float(((got[k] - v).abs() / v.abs().clamp(
                    min=1e-30)).max()))
        return err
    hist_err = hist_rel_err("c", rc[0]["whole"])
    check(hist_err <= 1e-5, f"PP2(c): amax histories {hist_err} relative "
          f"from world 1's")
    rf = [r["c_fp32"] for r in ranks]
    check(rf[0]["losses"] == rf[1]["losses"],
          "PP2(c_fp32): the ranks report different losses")
    f32_hist_err = hist_rel_err("c_fp32", rf[0]["whole"])
    f32_loss_err = max(abs(x - y) for x, y in zip(rf[0]["losses"],
                                                   ref["c_fp32"]["losses"]))
    f32_param_err = max(float((rf[0]["whole"][k] - v).abs().max())
                        for k, v in ref["c_fp32"]["whole"].items()
                        if k.startswith("model/") and v.is_floating_point())
    out.update(pp2c_device_launches=[r["profile"]["hand"] for r in rc],
               pp2c_hist_rel_err=hist_err,
               pp2c_losses=rc[0]["losses"],
               pp2c_losses_world1=ref["c"]["losses"],
               pp2c_fp32_hist_rel_err=f32_hist_err,
               pp2c_fp32_loss_err=f32_loss_err,
               pp2c_fp32_param_err=f32_param_err)
    print(f"[pp PP2c] path B (--ffn_impl pallas --quant int8) at pp=2, one "
          f"step: device launches {out['pp2c_device_launches']} (stages 0, "
          f"1); the amax histories {hist_err:.3g} relative from world 1's "
          f"after the same step (tol 1e-5); in fp32 over 4 steps: the "
          f"histories {f32_hist_err:.3g} relative from world 1's after the "
          f"fourth (tol 1e-5), loss err {f32_loss_err:.3g}, param err "
          f"{f32_param_err:.3g}", flush=True)
    check(f32_hist_err <= 1e-5, f"PP2(c_fp32): amax histories "
          f"{f32_hist_err} relative from world 1's after 4 steps")
    rd = [r["d"] for r in ranks]
    check(all(np.isfinite(r["losses"]).all() for r in rd),
          f"PP2(d): non-finite losses {[r['losses'] for r in rd]}")
    for r in rd:
        got = r["profile"]["hand"]
        check(got.get("flash_fwd_kernel") == per and got.get("dkdv_kernel")
              == per and got.get("dq_kernel") == per,
              f"PP2(d): rows 2 and 3 launches a step {got}")
    out.update(pp2d_peak_bytes=[r["peak_bytes"] for r in rd],
               pp2d_peak_bytes_world1=ref["d"]["peak_bytes"],
               pp2d_wall_ms=[r["profile"]["wall_ms"] for r in rd],
               pp2d_device_ms=[r["profile"]["device_ms"] for r in rd],
               pp2d_wait_ms=[r["profile"]["wait_ms"] for r in rd],
               pp2d_wall_ms_world1=ref["d"]["profile"]["wall_ms"],
               pp2d_device_ms_world1=ref["d"]["profile"]["device_ms"],
               pp2d_device_launches=[r["profile"]["hand"] for r in rd],
               pp2d_losses=rd[0]["losses"])
    print(f"[pp PP2d] path E (--task lm, B {LONG['B']} L {LONG['L']}) at "
          f"pp=2, M {PP_MICRO}, 2 steps: losses "
          f"{[round(x, 4) for x in rd[0]['losses']]}; rows 2 and 3 {per} "
          f"each a step a rank; peak "
          f"{[round(b / 2**30, 2) for b in out['pp2d_peak_bytes']]} GiB a "
          f"rank against {ref['d']['peak_bytes'] / 2**30:.2f} GiB at world "
          f"1; the profiled step's host wall "
          f"{[round(x, 2) for x in out['pp2d_wall_ms']]} ms, device "
          f"{[round(x, 2) for x in out['pp2d_device_ms']]} ms (world 1 "
          f"{ref['d']['profile']['wall_ms']:.2f} / "
          f"{ref['d']['profile']['device_ms']:.2f}), wait "
          f"{[round(x, 2) for x in out['pp2d_wait_ms']]} ms", flush=True)
    print(f"[pp] PP2 in {time.monotonic() - t0:.1f}s", flush=True)
    return out


def pp_main() -> int:
    """``--pp``: the kernels' build, then phase PP alone."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from faster_distributed_training_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}",
          flush=True)
    build_s, _ = _build.build()
    print(f"[build] {build_s:.1f}s", flush=True)
    pp = pp_phase(str(_build.BUILD_DIR))
    print(json.dumps({k: v for k, v in pp.items() if k != "pp1"},
                     default=str))
    return 0


def mesh_main() -> int:
    """``--mesh``: the kernels' build, then phase P alone."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from faster_distributed_training_tpu_torch import cli
    from faster_distributed_training_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_s, _ = _build.build()
    print(f"[build] {build_s:.1f}s", flush=True)
    pm = mesh_phase(cli, str(_build.BUILD_DIR))
    print(json.dumps(pm))
    return 0


# -- phase D: decode serving (slice 14) ---------------------------------------

# prompt lengths of D(a): buckets 64, 64, 128, 256
DECODE_PROMPTS = (7, 40, 100, 250)


def decode_cfg(cli, ckpt: str, *flags):
    """The record-width LM served from ``ckpt`` on the card: 6 layers,
    d_model 512, 8 heads, d_ff 1024, tied head, seq 512, buckets 64-512,
    page 16, 4 slots, bf16, greedy (the defaults), and ``flags``."""
    d = cli.TRANSFORMER_DEFAULTS
    return cli.config_from_args(cli.build_parser(defaults=d).parse_args(
        ["--task", "lm", "--device", "cuda", "--checkpoint_dir", ckpt,
         "--no_telemetry", "--no_plot", *flags]), defaults=d)


def decode_drive(eng, prompts, n_new: int, at=None, ids=None) -> list:
    """The scheduler's slot protocol under a fixed plan: prompt i is
    admitted at step ``at[i]`` (0) with request id ``ids[i]`` (i) and
    generates ``n_new`` tokens (fewer where the position table ends).
    Returns the token lists in prompt order."""
    from faster_distributed_training_tpu_torch.data.loader import (
        select_bucket)

    at = at or [0] * len(prompts)
    ids = ids or list(range(len(prompts)))
    outs = [None] * len(prompts)
    slot_of, pending, steps = {}, sorted(range(len(prompts)),
                                         key=lambda i: at[i]), 0
    while pending or slot_of:
        while (pending and at[pending[0]] <= steps
               and eng.cache.free_slot() is not None):
            i = pending.pop(0)
            slot, first = eng.admit(prompts[i], select_bucket(
                len(prompts[i]), eng.buckets), ids[i])
            outs[i] = [first]
            if n_new > 1 and eng.cache.headroom(slot) > 0:
                slot_of[slot] = i
            else:
                eng.cache.evict(slot)
        steps += 1
        if not slot_of:
            continue
        tokens, _pages = eng.step()
        for slot, i in list(slot_of.items()):
            outs[i].append(int(tokens[slot]))
            if len(outs[i]) >= n_new or eng.cache.headroom(slot) <= 0:
                eng.cache.evict(slot)
                del slot_of[slot]
    return outs


def decode_step_times(eng, pages: int, n: int = 50) -> dict:
    """One decode step of ``eng`` with every slot active and the window at
    ``pages`` pages: the graph replay (``eng.step``) and the eager
    ``decode_step`` on the same operands, each as host wall ms a step
    (median of ``n``, synchronized), device ms and device launches a step
    (torch.profiler over ``n``) and host launch calls a step (the CUDA
    runtime's kernel and graph launches)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from faster_distributed_training_tpu_torch.models.decode import (
        decode_step)

    cache = eng.cache
    B = eng.batch_size
    length = pages * eng.page - 1
    cache.active[:] = True
    cache.tokens[:] = np.arange(1, B + 1)
    cache.req_ids[:] = np.arange(B)

    def replay():
        cache.lengths[:] = length
        eng.step()

    ops = torch.tensor(np.stack([cache.tokens, np.full(B, length),
                                 cache.req_ids]), dtype=torch.int64,
                       device="cuda")
    active = torch.ones(B, dtype=torch.bool, device="cuda")

    def eager():
        with torch.no_grad():
            decode_step(eng.model, eng.spec, eng.sampling, pages * eng.page,
                        cache.k, cache.v, ops[0], ops[1], active, ops[2])
        torch.cuda.synchronize()

    got = {}
    for tag, fn in (("replay", replay), ("eager", eager)):
        for _ in range(3):
            fn()
        walls = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - t0) * 1e3)
        kern = device_kernels(fn, n)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        got[tag] = {
            "wall_ms": statistics.median(walls),
            "device_ms": sum(us for us, _ in kern.values()) / n / 1e3,
            "launches": launches_per_call(kern, n),
            "launch_calls": sum(e.count for e in prof.key_averages()
                                if e.key in LAUNCH_API)}
    cache.active[:] = False
    cache.lengths[:] = 0
    return got


def decode_prefill_times(eng, bucket: int, n: int = 20) -> dict:
    """One admission's prefill at ``bucket`` (batch 1, eager): host wall
    ms (median of ``n``, synchronized), device ms and device launches
    (torch.profiler over ``n``)."""
    import numpy as np
    import torch

    tokens = np.arange(1, bucket + 1, dtype=np.int64)[None] % 30000 + 1

    def run():
        with torch.no_grad():
            eng._prefill(tokens, bucket, 0)
        torch.cuda.synchronize()

    for _ in range(3):
        run()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3)
    kern = device_kernels(run, n)
    return {"wall_ms": statistics.median(walls),
            "device_ms": sum(us for us, _ in kern.values()) / n / 1e3,
            "launches": launches_per_call(kern, n)}


def decode_phase(cli, build_dir: str) -> dict:
    """Phase D: (a) card vs CPU in fp32, (b) each page count's graph
    against the eager step, (c) admission invariance, (d) the serving
    runs and the step's times, (e) the front door across a killed
    worker."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from faster_distributed_training_tpu_torch.interop import (
        flatten, params_to_jax)
    from faster_distributed_training_tpu_torch.models.decode import (
        SamplingCfg, decode_step)
    from faster_distributed_training_tpu_torch.serve import (
        load_serving_state)
    from faster_distributed_training_tpu_torch.serve.decode import (
        DecodeEngine, FrontDoor)

    t_phase = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="smoke_decode_", dir=build_dir)
    out = {}
    silent = lambda s: None                                 # noqa: E731
    try:
        cfg = decode_cfg(cli, tmp)
        m = cli.build_model(cfg, vocab_size=30522, device="cpu")
        m.init_weights(torch.Generator().manual_seed(cfg.seed))
        # the real load path: the JAX parameter tree as an .npz
        np.savez(os.path.join(tmp, "transformer_params.npz"),
                 **flatten(params_to_jax(m.state_dict(), cfg.n_heads)))
        del m
        rng = np.random.default_rng(cfg.seed)
        prompts = [rng.integers(1, 30522, size=n).astype(np.int32)
                   for n in DECODE_PROMPTS]

        # -- (a) card vs CPU, fp32 ------------------------------------------
        cfg32 = cfg.replace(precision="fp32")
        tok, probe = {}, {}
        for dev in ("cpu", "cuda"):
            model, _, _ = load_serving_state(cfg32, torch.device(dev),
                                             log=silent)
            eng = DecodeEngine(model, cfg.seq_buckets, batch_size=4,
                               page=16)
            eng.warmup()
            probe[dev] = eng.prefill_logits(prompts[3], 256)
            tok[dev] = decode_drive(eng, prompts, 16)
            del eng, model
        err_a = float(np.abs(probe["cuda"] - probe["cpu"]).max())
        lim_a = 1e-4 * float(np.abs(probe["cpu"]).max())
        print(f"[decode D(a)] fp32 card vs CPU: prefill logits (256-token "
              f"prompt) max err {err_a:.3g} (tol {lim_a:.3g} = 1e-4 of max "
              f"|CPU|); greedy tokens of {len(prompts)} prompts x 16 equal: "
              f"{tok['cuda'] == tok['cpu']}", flush=True)
        check(err_a <= lim_a, f"D(a) prefill logits err {err_a}")
        check(tok["cuda"] == tok["cpu"],
              f"D(a) greedy tokens differ: {tok['cuda']} vs {tok['cpu']}")
        out["a_err"], out["a_tol"] = err_a, lim_a

        # -- (b) every page count's graph vs the eager step, bf16 -----------
        model, _, _ = load_serving_state(cfg, torch.device("cuda"),
                                         log=silent)
        eng = DecodeEngine(model, cfg.seq_buckets, batch_size=4, page=16)
        t0 = time.monotonic()
        eng.warmup()
        out["warmup_s"] = time.monotonic() - t0
        check(eng.captures == eng.max_pages == len(eng.graphs),
              f"D(b) {eng.captures} captures for {eng.max_pages} pages")
        gen = torch.Generator(device="cuda").manual_seed(14)
        B = eng.batch_size
        for pages in range(1, eng.max_pages + 1):
            cap = pages * eng.page
            k0 = torch.randn(eng.cache.k.shape, generator=gen,
                             device="cuda").to(torch.bfloat16)
            v0 = torch.randn(eng.cache.k.shape, generator=gen,
                             device="cuda").to(torch.bfloat16)
            pos = torch.randint(max(cap - eng.page, 0), min(cap, 511),
                                (B,), generator=gen, device="cuda")
            ops = torch.stack([
                torch.randint(1, 30522, (B,), generator=gen, device="cuda"),
                pos, torch.tensor([1, 1, 0, 1], device="cuda"),
                torch.randint(0, 1000, (B,), generator=gen, device="cuda")])
            eng.cache.k.copy_(k0)
            eng.cache.v.copy_(v0)
            with torch.no_grad():
                want = decode_step(model, eng.spec, eng.sampling, cap,
                                   eng.cache.k, eng.cache.v, ops[0], ops[1],
                                   ops[2].bool(), ops[3])
            ke, ve = eng.cache.k.clone(), eng.cache.v.clone()
            eng.cache.k.copy_(k0)
            eng.cache.v.copy_(v0)
            eng._ops.copy_(ops)
            eng.graphs[pages].replay()
            torch.cuda.synchronize()
            check(torch.equal(eng._next, want),
                  f"D(b) {pages} pages: replay tokens differ from eager")
            check(torch.equal(eng.cache.k, ke) and torch.equal(eng.cache.v,
                                                               ve),
                  f"D(b) {pages} pages: replay cache differs from eager")
            check(not torch.equal(ke, k0), f"D(b) {pages}: nothing written")
        del k0, v0, ke, ve
        out["b_pages"] = eng.max_pages
        print(f"[decode D(b)] {eng.max_pages} graphs captured in warmup "
              f"({out['warmup_s']:.2f}s with 4 prefill buckets); each "
              f"replay bitwise the eager decode_step (next tokens and the "
              f"cache) at every page count 1..{eng.max_pages}", flush=True)

        # -- (c) admission invariance ----------------------------------------
        # one page covering the position table: every step one window
        fixed = DecodeEngine(model, cfg.seq_buckets, batch_size=4,
                             page=512, max_pages=1)
        fixed.warmup()
        a, b = prompts[1], prompts[2]
        solo_a = decode_drive(fixed, [a], 24)[0]
        solo_b = decode_drive(fixed, [b], 24, ids=[1])[0]
        mixed = decode_drive(fixed, [a, b], 24, at=[0, 3])
        check(mixed == [solo_a, solo_b],
              "D(c) a mid-stream admission changed a running stream")
        samp = SamplingCfg(method="topk", temperature=1.0, top_k=40,
                           seed=cfg.seed)
        topk = DecodeEngine(model, cfg.seq_buckets, batch_size=4, page=512,
                            max_pages=1, sampling=samp)
        topk.warmup()
        three = [prompts[0], prompts[1], prompts[2]]
        one = decode_drive(topk, three, 16, ids=[10, 11, 12])
        two = decode_drive(topk, three[::-1], 16, at=[0, 2, 5],
                           ids=[12, 11, 10])[::-1]
        check(one == two, "D(c) topk tokens depend on the admission order")
        greedy = decode_drive(fixed, three, 16)
        off = sum(x != y for p, q in zip(one, greedy) for x, y in zip(p, q))
        # the default engine (the window follows the longest slot): the
        # same comparison, printed
        dflt = (decode_drive(eng, [a, b], 24, at=[0, 3])
                == [decode_drive(eng, [a], 24)[0],
                    decode_drive(eng, [b], 24, ids=[1])[0]])
        print(f"[decode D(c)] one window (page 512): a mid-stream admission "
              f"leaves the running stream's tokens bitwise unchanged; topk "
              f"(T 1, k 40) equal per request over two admission orders, "
              f"{off} of 48 tokens off greedy; with the default page (16) the "
              f"mid-stream run's tokens equal the solo runs': {dflt}",
              flush=True)
        out["c_default_equal"] = dflt
        del fixed, topk

        # -- (d) the serving runs and the step's times ---------------------
        from faster_distributed_training_tpu_torch.models.decode import (
            decode_spec)

        runs = {}
        for tag, flags in (("default", []),
                           ("32 slots", ["--decode_batch_size", "32",
                                         "--decode_requests", "64"])):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.monotonic()
            res = cli.run_decode_serving(decode_cfg(cli, tmp, *flags),
                                         log=silent)
            wall = time.monotonic() - t0
            counts = read_counts()
            check(all(v == 0 for v in counts.values()),
                  f"D(d) decode launched a hand kernel: {counts}")
            e = res["engines"][0]
            n_req = 64 if flags else 16
            # 32 tokens, fewer where the prompt meets the position table
            due = [min(32, 1 + 512 - min(len(p), 512))
                   for p in cli.synth_requests(n_req, 30522, cfg.seq_buckets,
                                               seed=cfg.seed)]
            check(res["requests"] == n_req
                  and [len(r) for r in res["results"]] == due,
                  f"D(d) {tag}: {res['requests']} requests, lengths "
                  f"{[len(r) for r in res['results']]}, due {due}")
            check(all(bool(((r >= 0) & (r < 30522)).all())
                      for r in res["results"]), "D(d) token out of range")
            check(e.captures == e.max_pages,
                  f"D(d) {tag}: {e.captures} captures after the run")
            runs[tag] = dict(
                {k: res[k] for k in ("requests", "tokens", "steps",
                                     "prefills", "ttft_p50_ms",
                                     "ttft_p99_ms", "latency_p50_ms",
                                     "latency_p99_ms", "tokens_per_sec")},
                wall_s=wall, kv_bytes=e.cache.nbytes,
                peak_bytes=torch.cuda.max_memory_allocated(),
                pages=dict(sorted(e.page_counts.items())))
            print(f"[decode D(d)] {tag}: {res['requests']} requests, "
                  f"{res['tokens']} tokens, {e.batch_size} slots, "
                  f"{res['steps']} steps: "
                  f"TTFT p50 {res['ttft_p50_ms']} ms / p99 "
                  f"{res['ttft_p99_ms']} ms, latency p50 "
                  f"{res['latency_p50_ms']} ms / p99 "
                  f"{res['latency_p99_ms']} ms, {res['tokens_per_sec']} "
                  f"tokens/s; KV cache {e.cache.nbytes} B, peak "
                  f"{runs[tag]['peak_bytes'] / 2**20:.1f} MiB; page counts "
                  f"used {runs[tag]['pages']}; hand-kernel launches "
                  f"{counts} (none on this path)", flush=True)
            if not flags:
                steps = {}
                for pages in (1, 8, e.max_pages):
                    t = decode_step_times(e, pages)
                    steps[pages] = t
                    r, g = t["replay"], t["eager"]
                    print(f"[decode D(d)] step at {pages} page(s), 4 "
                          f"slots: replay host wall {r['wall_ms']:.3f} ms, "
                          f"device {r['device_ms']:.3f} ms, "
                          f"{r['launches']:.0f} device launches, "
                          f"{r['launch_calls']} host launch calls; eager "
                          f"host wall {g['wall_ms']:.3f} ms, device "
                          f"{g['device_ms']:.3f} ms, {g['launches']:.0f} "
                          f"device launches, {g['launch_calls']} host "
                          f"launch calls", flush=True)
                runs[tag]["steps"] = steps
                pre = {b: decode_prefill_times(e, b) for b in (64, 512)}
                runs[tag]["prefill"] = pre
                print("[decode D(d)] prefill (batch 1, eager): " + "; ".join(
                    f"bucket {b}: host wall {t['wall_ms']:.3f} ms, device "
                    f"{t['device_ms']:.3f} ms, {t['launches']:.0f} device "
                    f"launches" for b, t in pre.items()), flush=True)
            del res, e
        out["d"] = runs
        spec = decode_spec(model)
        # a step's bound at 4 slots and the whole window: the layer
        # weights (bf16) and the tied head's fp32 table read once, the
        # cache's window read, the next tokens written
        layer_w = spec.n_layers * 2 * (spec.d_model * 3 * spec.d_model
                                       + spec.d_model ** 2
                                       + 2 * spec.d_model * spec.d_ff)
        kv = 2 * spec.n_layers * 4 * spec.d_model * 512 * 2
        out["bound_ms"], out["bound_by"] = bound(
            layer_w + 4 * spec.vocab * spec.d_model + kv, 0, "bf16")
        print(f"[decode D(d)] a step's bound at 4 slots, 32 pages: "
              f"{out['bound_ms']:.5f} ms ({out['bound_by']}: layer weights "
              f"{layer_w} B, fp32 token table {4 * spec.vocab * spec.d_model}"
              f" B, KV window {kv} B)", flush=True)
        del eng, model
        gc.collect()
        torch.cuda.empty_cache()

        # -- (e) the front door, one worker killed -------------------------
        cfg_e = decode_cfg(cli, tmp, "--precision", "fp32",
                           "--decode_max_new_tokens", "16")
        fd_prompts = [rng.integers(1, 30522, size=n).astype(np.int32)
                      for n in (5, 30, 64, 90, 12, 200, 48, 9)]
        want = [r.tolist() for r in cli.run_decode_serving(
            cfg_e, prompts=fd_prompts, log=silent)["results"]]
        fd = FrontDoor(cfg_e, n_workers=2, run_dir=os.path.join(tmp, "fd"),
                       heartbeat_timeout_s=60.0, marker_timeout_s=5.0,
                       readmit_after_s=0.5, log=silent)
        try:
            t0 = time.monotonic()
            fd.start()
            up_s = time.monotonic() - t0
            handles = [fd.submit(t, max_new=16) for t in fd_prompts]
            victim = fd.replicas[0]
            victim.kill()
            got = [h.wait(timeout=180.0).tolist() for h in handles]
            check(all(len(g) == 16 for g in got),
                  f"D(e) truncated streams: {[len(g) for g in got]}")
            check(got == want, "D(e) front door tokens differ from the "
                  "in-process run's")
            t1 = time.monotonic()
            while victim.respawns < 1 or not victim.alive:
                check(time.monotonic() - t1 < 120.0,
                      "D(e) the killed worker was not re-admitted")
                time.sleep(0.1)
            back_s = time.monotonic() - t1
            served = victim.served_requests
            while victim.served_requests == served:
                check(time.monotonic() - t1 < 180.0,
                      "D(e) the respawned worker never served")
                fd.submit(fd_prompts[0], max_new=4).wait(timeout=60.0)
            stats = fd.sched.summary()
        finally:
            fd.close()
        check(all(r.proc.poll() is not None for r in fd.replicas),
              "D(e) a worker outlived the front door")
        out["e"] = {"up_s": up_s, "respawn_s": back_s,
                    "retries": stats["decode_request_retries"],
                    "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"]}
        print(f"[decode D(e)] front door, 2 worker processes on the card "
              f"(fp32): up in {up_s:.1f}s; {victim.name} SIGKILLed with "
              f"{len(handles)} generations in flight, every stream finished "
              f"at 16 tokens equal to the in-process run's "
              f"({stats['decode_request_retries']} re-dispatched); respawned "
              f"and re-admitted in {back_s:.1f}s and served again; latency "
              f"p50 {stats['p50_ms']} ms / p99 {stats['p99_ms']} ms",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.monotonic() - t_phase
    print(f"[decode] phase D {out['phase_s']:.1f}s", flush=True)
    return out


def decode_main() -> int:
    """``--decode``: phase D alone (the decode path launches no hand
    kernel: nothing is built)."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from faster_distributed_training_tpu_torch import cli

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)} (torch "
          f"{torch.__version__}, cuda {torch.version.cuda}); nvidia-smi: "
          f"{card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "faster_distributed_training_tpu_torch",
                             "_build")
    os.makedirs(build_dir, exist_ok=True)
    dd = decode_phase(cli, build_dir)
    print(json.dumps(dd, default=str))
    return 0


# -- slice 15: resilience for training (phase F) ----------------------------

F_STRIDE = 16            # the record on 256 rows: 16 steps of 16
F_POD_LAYERS = 2         # F(e)'s depth: two processes share the card

F_HOST = r"""
import hashlib, json, sys, time
t_start = time.monotonic()
sys.path.insert(0, sys.argv[1])
import torch
from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch.train.state import state_leaves
first = []

def log(line):
    if line.startswith("[epoch") and not first:
        first.append(time.monotonic() - t_start)
    print(line, flush=True)

defaults = cli.TRANSFORMER_DEFAULTS
cfg = cli.config_from_args(cli.build_parser(defaults=defaults).parse_args(
    sys.argv[2:]), defaults=defaults)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
out = cli.run_training(cfg, log=log)
h = hashlib.sha256()
for k, v in sorted(state_leaves(out["state"]).items()):
    h.update(k.encode()); h.update(v.detach().cpu().contiguous().numpy().tobytes())
res = out["resilience"]
print("RESULT " + json.dumps({
    "step": int(out["state"].step), "digest": h.hexdigest(),
    "preempted": out["preempted"],
    "emergency_save_ms": None if out["trainer"].emergency_save_s is None
    else out["trainer"].emergency_save_s * 1e3,
    "first_step_s": first[0] if first else None,
    "generation": None if res.coordinator is None
    else res.coordinator.generation,
    "restarts": out["goodput_restarts"], "restores": out["goodput_restores"]}),
    flush=True)
"""


def f_state(state) -> dict:
    """Every leaf of a state as a checkpoint names it
    (``checkpoint._flat``), copied to the host."""
    from faster_distributed_training_tpu_torch.train import checkpoint as ck

    tensors, scalars = ck._flat(ck.state_payload(state))
    out = {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}
    out.update({k: torch_scalar(v) for k, v in scalars.items()})
    return out


def torch_scalar(v):
    import torch

    return torch.tensor(v)


def f_digest(leaves: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k, v in sorted(leaves.items()):
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def f_run(cli, flags, tag: str, build_dir: str, k: int, every: int):
    """``counted_run`` of ``flags`` with each state leaf copied to the
    host at each multiple of ``every`` steps (after the step, or at the
    dispatch boundary: under K > 1 the step runs inside a captured
    graph).  Returns (out, {step: leaves}, counts)."""
    from faster_distributed_training_tpu_torch.train import dispatch as dmod
    from faster_distributed_training_tpu_torch.train import steps as tsteps

    at = {}
    cfg = record_cfg(cli, flags, tag, build_dir)
    real_step, real_run = tsteps.make_train_step, dmod.FusedDispatch.run

    def after(state):
        step = int(state.step)
        if step % every == 0 and step not in at:
            at[step] = f_state(state)

    def make(c):
        fn = real_step(c)

        def run(state, batch, *a, **kw):
            out = fn(state, batch, *a, **kw)
            after(state)
            return out
        return run

    def run(self, state, kk, *a, **kw):
        out = real_run(self, state, kk, *a, **kw)
        after(state)
        return out

    if k == 1:
        tsteps.make_train_step = make
    else:
        dmod.FusedDispatch.run = run
    try:
        out, _, counts = counted_run(cli, cfg, tag)
    finally:
        tsteps.make_train_step, dmod.FusedDispatch.run = real_step, real_run
    return out, at, counts


def f_committed(ckdir: str) -> dict:
    """{step: leaves} of every committed step checkpoint under ``ckdir``,
    read from its ``state.pt``."""
    import torch

    from faster_distributed_training_tpu_torch.train import checkpoint as ck

    got = {}
    for step, name in ck.series_members(ckdir, "transformer_step"):
        payload = torch.load(os.path.join(ckdir, name, "state.pt"),
                             map_location="cpu", weights_only=True)
        tensors, scalars = ck._flat(payload)
        got[step] = {**tensors, **{k: torch_scalar(v)
                                   for k, v in scalars.items()}}
    return got


def f_host(build_dir: str, argv: list, env: dict, tag: str):
    """One training process on the card (``F_HOST``), started now."""
    import tempfile

    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, **env)
    out = tempfile.NamedTemporaryFile("w+", prefix=f"f_{tag}_",
                                      suffix=".log", dir=build_dir,
                                      delete=False)
    t0 = time.monotonic()
    proc = subprocess.Popen([sys.executable, "-c", F_HOST, repo] + argv,
                            env=env, stdout=out, stderr=subprocess.STDOUT,
                            text=True)
    return proc, out, t0


def f_result(handle, timeout: float, tag: str) -> dict:
    proc, out, t0 = handle
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    out.seek(0)
    text = out.read()
    out.close()
    os.unlink(out.name)
    lines = [x for x in text.splitlines() if x.startswith("RESULT ")]
    check(proc.returncode == 0 and bool(lines),
          f"F {tag}: exit {proc.returncode}; log tail:\n{text[-3000:]}")
    got = json.loads(lines[-1][len("RESULT "):])
    got["wall_s"] = time.monotonic() - t0
    got["log"] = text
    return got


F_PAIRS = 3              # F(d): alternated blocks of none and guard
F_BLOCK = 8              # steps a timed block


def f_guard_cost(cli, path_b: list, build_dir: str) -> dict:
    """F(d)'s cost of ``--sentinel guard`` against ``none`` on path B,
    and the blocking snapshot's share of a step.  One state and 16 host
    batches; each mode's K=1 step and K=4 dispatch warmed (and captured)
    once, then ``F_PAIRS`` pairs of ``F_BLOCK``-step blocks of each mode,
    their order swapped every pair, at K=1 and at K=4.  A block's host
    wall runs from a synchronized card to a synchronized card, the
    optimizer's count settled before it (outside the clock: the guard's
    one read every 64 steps, ``train.steps.SETTLE_EVERY``, falls outside
    a block).  Medians and spread of each; the wrapper launches of a K=1
    block and the hand kernels' device launches of one profiled step or
    dispatch are held equal between the modes.  The snapshot: the
    manager's own ``save`` on this state (the card synchronized first:
    the copy alone, no step in flight), its reused-buffer median over 3
    saves after the first (which pins its buffers), over each K's median
    step without the guard."""
    import shutil

    import torch

    from faster_distributed_training_tpu_torch.data.loader import BatchLoader
    from faster_distributed_training_tpu_torch.resilience.manager import (
        AsyncCheckpointManager)
    from faster_distributed_training_tpu_torch.train.dispatch import (
        FusedDispatch)
    from faster_distributed_training_tpu_torch.train.state import settle
    from faster_distributed_training_tpu_torch.train.steps import (
        make_train_step, to_device)

    t_start = time.monotonic()
    modes = ("none", "guard")
    cfg = {m: record_cfg(cli, path_b + ["--sentinel", m], f"f_g{m}",
                         build_dir) for m in modes}
    c0 = cfg["none"]
    data = cli.load_dataset(c0.replace(dataset="synthetic"), True)
    host = list(itertools.islice(iter(BatchLoader(
        data, c0.batch_size, epoch=0, seed=c0.seed, max_len=c0.seq_len)),
        16))
    it = itertools.cycle(host)
    state = record_state(cli, c0)
    run = {}
    for m in modes:
        step = make_train_step(cfg[m])
        disp = FusedDispatch(cfg[m], 4, "cuda")
        run[(1, m)] = (lambda s=step: s(state, to_device(next(it), "cuda")))
        run[(4, m)] = (lambda d=disp: d.run(
            state, 4, batches=[next(it) for _ in range(4)]))
    for fn in run.values():
        fn()
        fn()
    settle(state)
    torch.cuda.synchronize()

    def block(k, m):
        settle(state)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(F_BLOCK // k):
            run[(k, m)]()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / F_BLOCK, read_counts()

    times = {key: [] for key in run}
    counts = {}
    for pair in range(F_PAIRS):
        for k in (1, 4):
            for m in (modes if pair % 2 == 0 else modes[::-1]):
                ms, c = block(k, m)
                times[(k, m)].append(ms)
                counts.setdefault((k, m), c)
    hand = {}
    for key in sorted(run):
        settle(state)
        hand[key] = hand_launches(device_kernels(run[key], 1))
        # the profiler can lose records of a graph's replays and never
        # adds any: up to two more profiles while a dispatch's count
        # falls short of 4 x K=1's, each kernel's largest kept
        want = {n: 4 * c for n, c in hand.get((1, key[1]), {}).items()}
        for _ in range(2 if key[0] == 4 else 0):
            if hand[key] == want:
                break
            more = hand_launches(device_kernels(run[key], 1))
            hand[key] = {n: max(hand[key].get(n, 0), more.get(n, 0))
                         for n in hand[key].keys() | more.keys()}
    out = {}
    for k in (1, 4):
        med = {m: statistics.median(times[(k, m)]) for m in modes}
        out[f"k{k}"] = {
            **{f"{m}_ms": med[m] for m in modes},
            **{f"{m}_ms_each": times[(k, m)] for m in modes},
            "guard_over_none": med["guard"] / med["none"],
            "hand_launches": {m: hand[(k, m)] for m in modes}}
        check(hand[(k, "none")] == hand[(k, "guard")]
              and all(hand[(k, "none")].get(n) for n in HAND_KERNELS),
              f"F(d) K={k}: hand kernels' device launches with the guard "
              f"{hand[(k, 'guard')]} != without {hand[(k, 'none')]}")
        print(f"[resilience F(d)] K={k}: --sentinel guard vs none, host wall "
              f"a step over {F_PAIRS} alternated pairs of {F_BLOCK}-step "
              f"blocks: guard median {med['guard']:.3f} ms "
              f"({min(times[(k, 'guard')]):.3f}-"
              f"{max(times[(k, 'guard')]):.3f}), none median "
              f"{med['none']:.3f} ms ({min(times[(k, 'none')]):.3f}-"
              f"{max(times[(k, 'none')]):.3f}), ratio "
              f"{med['guard'] / med['none']:.4f}; hand kernels' device "
              f"launches a {'step' if k == 1 else 'dispatch'}: "
              f"{hand[(k, 'guard')]} both", flush=True)
    check(counts[(1, "none")] == counts[(1, "guard")],
          f"F(d) K=1: wrapper launches of a block with the guard "
          f"{counts[(1, 'guard')]} != without {counts[(1, 'none')]}")
    out["k1"]["wrapper_launches"] = counts[(1, "none")]
    snapdir = os.path.join(build_dir, "f_snap")
    shutil.rmtree(snapdir, ignore_errors=True)
    mgr = AsyncCheckpointManager(snapdir, prefix="transformer", keep=1,
                                 log=lambda *_: None)
    for i in range(4):
        settle(state)
        torch.cuda.synchronize()
        mgr.save(state, 1000 + i)
        mgr.wait()
    mgr.close()
    shutil.rmtree(snapdir, ignore_errors=True)
    snaps = [t * 1e3 for _s, t in mgr.snapshots]
    steady = statistics.median(snaps[1:])
    out["snapshot_ms"] = snaps
    out["state_bytes"] = mgr.last_snapshot_bytes
    for k in (1, 4):
        share = steady / out[f"k{k}"]["none_ms"]
        out[f"k{k}"]["snapshot_share_of_step"] = share
        print(f"[resilience F(a)] K={k}: a blocking snapshot into reused "
              f"host buffers (median {steady:.3f} ms of 3, "
              f"{min(snaps[1:]):.3f}-{max(snaps[1:]):.3f}; the first "
              f"{snaps[0]:.1f} ms pins them; {mgr.last_snapshot_bytes} "
              f"bytes) is {100 * share:.2f}% of a {out[f'k{k}']['none_ms']:.3f}"
              f" ms step without the guard", flush=True)
    del state, run
    print(f"[resilience F(d)] the guard's cost and the snapshot took "
          f"{time.monotonic() - t_start:.1f} s", flush=True)
    return out


def resilience_phase(cli, build_dir: str) -> dict:
    """Phase F: path B (``--ffn_impl pallas --quant int8``, the record's
    width, 16 steps) under the resilience layer.  (a) K=1 and K=4 with
    ``--checkpoint_every 4``: every committed checkpoint bitwise the
    uninterrupted run's state at its step, the hand kernels' device
    launches over the K=1 run, the blocking snapshot's time and share of
    a step, the state's bytes and the background commit's time; (b)
    ``FDT_FAULT_DIE_AT_STEP=6`` under ``--supervise`` in process at K=4,
    bitwise the uninterrupted run, with MTTR split into detect, restore,
    graph capture and backoff, and goodput; a resnet18 in-process restart
    bitwise its uninterrupted run; (c) ``FDT_FAULT_SIGTERM_AT_STEP=5`` in a
    subprocess: exit 0 preempted, the emergency save's time, and the same
    command relaunched ending bitwise the uninterrupted run, with its time
    to the first step; (d) ``--sentinel guard`` with
    ``FDT_FAULT_NAN_AT_STEP=2`` at K=1 and K=4, bitwise each other, one
    step skipped; the guard's step time against ``--sentinel none`` in
    alternated blocks, with equal launches, and the blocking snapshot's
    share of a step (``f_guard_cost``); ``--sentinel full --supervise``
    with a loss spike
    at step 10: one rollback, one quarantined batch, 15 steps; (e) two
    fs-simulated pod processes on the card (``FDT_POD_INDEX`` /
    ``FDT_POD_COUNT``, 2 layers), a die on host 1: both restart into
    generation 1 and end with equal states."""
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from faster_distributed_training_tpu_torch.resilience import faults

    path_b = ["--ffn_impl", "pallas", "--quant", "int8", "--subset_stride",
              str(F_STRIDE)]
    res = {}
    n_steps = 4096 // F_STRIDE // 16

    # -- (a) committed checkpoints against the uninterrupted run ----------
    ref1, at1, _ = f_run(cli, path_b, "f_ref1", build_dir, 1, 4)
    ref4, at4, _ = f_run(cli, path_b + ["--steps_per_dispatch", "4"],
                            "f_ref4", build_dir, 4, 4)
    check(sorted(at1) == sorted(at4) == list(range(4, n_steps + 1, 4)),
          f"F(a) reference snapshots at {sorted(at1)} / {sorted(at4)}")
    bitwise("F(a) K=4 reference vs K=1 reference, final state",
            at1[n_steps], at4[n_steps])
    for k, at in ((1, at1), (4, at4)):
        flags = path_b + ["--checkpoint_every", "4"] + (
            ["--steps_per_dispatch", "4"] if k > 1 else [])
        cfg = record_cfg(cli, flags, f"f_a{k}", build_dir)
        if k == 1:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out, _, counts = counted_run(cli, cfg, f"F(a) K={k}")
                torch.cuda.synchronize()
            events = prof.key_averages()
            hand = hand_launches({e.key: (_device_us(e), e.count)
                                  for e in events})
            # the manager's spans (telemetry/spans.py), as the trace shows
            spans = {e.key: (e.count, e.cpu_time_total / 1e3 / e.count)
                     for e in events if e.key.startswith("fdt/")}
            res["a_device_launches"] = hand
            res["a_wrapper_launches"] = counts
            res["a_spans"] = spans
            print(f"[resilience F(a)] spans in the K=1 run's trace (count, "
                  f"host ms each): {spans}", flush=True)
            check(spans.get("fdt/ckpt_snapshot", (0,))[0] > 0,
                  f"F(a): no fdt/ckpt_snapshot span in the trace: {spans}")
            print(f"[resilience F(a)] hand kernels' device launches over the "
                  f"K=1 run ({n_steps} steps + eval): {hand}; wrapper counts "
                  f"{counts}", flush=True)
            for kern in ("flash_fwd_kernel", "dkdv_kernel", "dq_kernel",
                         "mlp_fwd_kernel", "ffn_kernel", "qmm_kernel"):
                check(hand.get(kern, 0) > 0,
                      f"F(a): {kern} launched no time on path B")
        else:
            out, _, counts = counted_run(cli, cfg, f"F(a) K={k}")
        mgr = out["resilience"].manager
        got = f_committed(cfg.checkpoint_dir)
        check(bool(got), f"F(a) K={k}: no checkpoint committed")
        for step, leaves in sorted(got.items()):
            bitwise(f"F(a) K={k} checkpoint at step {step}", at[step],
                    leaves)
        snaps = [round(t * 1e3, 3) for _s, t in mgr.snapshots]
        res[f"a{k}"] = {
            "committed": sorted(got), "saves": out["goodput_saves"],
            "skipped_saves": out["goodput_skipped_saves"],
            "snapshot_ms": snaps, "state_bytes": mgr.last_snapshot_bytes,
            "commit_s": mgr.last_commit_s,
            "blocking_s": out["goodput_checkpoint_blocking_s"]}
        print(f"[resilience F(a)] K={k}: committed {sorted(got)} (each "
              f"bitwise the uninterrupted run at its step; "
              f"{out['goodput_skipped_saves']} tick(s) skipped while a write "
              f"ran); blocking snapshots {snaps} ms (the first pins its "
              f"host buffers); state {mgr.last_snapshot_bytes} bytes; "
              f"background commit {mgr.last_commit_s:.2f} s", flush=True)
        shutil.rmtree(cfg.checkpoint_dir, ignore_errors=True)

    # -- (b) a die under --supervise, in process --------------------------
    os.environ[faults.ENV_DIE] = "6"
    try:
        cfg = record_cfg(cli, path_b + ["--steps_per_dispatch", "4",
                                         "--checkpoint_every", "4",
                                         "--supervise"], "f_b", build_dir)
        out, leaves, _ = counted_run(cli, cfg, "F(b) die at 6, K=4")
    finally:
        os.environ.pop(faults.ENV_DIE, None)
    bitwise("F(b) supervised die run vs the uninterrupted run",
            at4[n_steps], f_state(out["state"]))
    disp = out["trainer"].dispatch
    g = {k[len("goodput_"):] if k != "goodput_pct" else k: v
         for k, v in out.items() if k.startswith("goodput")}
    res["b"] = {"restarts": g["restarts"], "restores": g["restores"],
                "mttr_s": g.get("restart_mttr_s"),
                "mttr_restore_s": g.get("restart_mttr_restore_s"),
                "detect_s": g["detect_s"], "backoff_s": g["restart_backoff_s"],
                "capture_s": disp.capture_s, "captures": len(disp.graphs),
                "goodput_pct": g["goodput_pct"],
                "rollback_lost_s": g["rollback_lost_s"]}
    check(g["restarts"] == 1 and g["restores"] == 1,
          f"F(b): restarts {g['restarts']}, restores {g['restores']}")
    print(f"[resilience F(b)] die at step 6 (K=4, fires at the step-8 "
          f"boundary), restored in process: bitwise the uninterrupted run; "
          f"MTTR {res['b']['mttr_s']} s = detect {g['detect_s']} s + "
          f"restore {g.get('restart_mttr_restore_s')} s + graph capture 0 s "
          f"(the {len(disp.graphs)} graph(s) captured once, "
          f"{disp.capture_s:.3f} s, kept: the restore copies into the "
          f"tensors they read) + backoff {g['restart_backoff_s']} s; "
          f"rollback re-ran {g['rollback_lost_s']} s of steps; goodput "
          f"{g['goodput_pct']}% (smoke-only: over 16 steps the first "
          f"snapshot's pinning, the captures and the epoch checkpoint "
          f"weigh as they would not over a long run)", flush=True)
    shutil.rmtree(cfg.checkpoint_dir, ignore_errors=True)
    rflags = ["--model", "resnet18", "--bs", "128", "--subset_stride", "8",
              "--epoch", "2"]
    ck = os.path.join(build_dir, "f_resnet")
    shutil.rmtree(ck, ignore_errors=True)
    rref, rleaves, _ = counted_run(cli, resnet_cfg(
        cli, rflags + ["--checkpoint_dir", ck + "_ref"]), "F(b) resnet18")
    os.environ[faults.ENV_DIE] = "5"
    try:
        rdie, rgot, _ = counted_run(cli, resnet_cfg(
            cli, rflags + ["--checkpoint_every", "2", "--supervise",
                           "--checkpoint_dir", ck]), "F(b) resnet18 die at 5")
    finally:
        os.environ.pop(faults.ENV_DIE, None)
    bitwise("F(b) resnet18 supervised restart vs uninterrupted", rleaves,
            rgot)
    res["b_resnet_restarts"] = rdie["goodput_restarts"]
    check(rdie["goodput_restarts"] == 1, "F(b) resnet18 did not restart")
    shutil.rmtree(ck, ignore_errors=True)
    shutil.rmtree(ck + "_ref", ignore_errors=True)

    # -- (c) SIGTERM in a subprocess, then the same command ----------------
    ckc = os.path.join(build_dir, "f_c")
    shutil.rmtree(ckc, ignore_errors=True)
    argv = ["--device", "cuda", "--dataset", "synthetic", "--epoch", "1",
            "--checkpoint_dir", ckc, "--log_every", "1", "--no_plot",
            "--checkpoint_every", "1000", *path_b]
    first = f_result(f_host(build_dir, argv, {faults.ENV_SIGTERM: "5"},
                            "c1"), 300, "(c) SIGTERM")
    check(first["preempted"] and first["step"] == 5,
          f"F(c): preempted {first['preempted']} at step {first['step']}")
    again = f_result(f_host(build_dir, argv, {}, "c2"), 300, "(c) relaunch")
    check(not again["preempted"] and again["step"] == n_steps
          and again["restores"] == 1, f"F(c) relaunch: {again}")
    check(again["digest"] == f_digest(_leaves_of(ref1)),
          "F(c): the relaunched run is not bitwise the uninterrupted run")
    res["c"] = {"emergency_save_ms": first["emergency_save_ms"],
                "relaunch_first_step_s": again["first_step_s"],
                "relaunch_wall_s": again["wall_s"],
                "first_wall_s": first["wall_s"]}
    print(f"[resilience F(c)] SIGTERM at step 5: exit 0, preempted, "
          f"emergency save {first['emergency_save_ms']:.1f} ms; the same "
          f"command relaunched restored step 5 and ended bitwise the "
          f"uninterrupted run; its first step {again['first_step_s']:.2f} s "
          f"after its interpreter started ({again['wall_s']:.1f} s wall)",
          flush=True)
    shutil.rmtree(ckc, ignore_errors=True)

    # -- (d) the NaN guard and the spike ---------------------------------
    os.environ[faults.ENV_NAN] = "2"
    try:
        guards = {}
        for k in (1, 4):
            out, _, _ = counted_run(cli, record_cfg(
                cli, path_b + ["--sentinel", "guard"] + (
                    ["--steps_per_dispatch", "4"] if k > 1 else []),
                f"f_d{k}", build_dir), f"F(d) guard K={k}")
            check(out["goodput_skipped_steps"] == 1
                  and out["state"].opt_state["step"] == n_steps - 1,
                  f"F(d) K={k}: skipped {out['goodput_skipped_steps']}")
            guards[k] = f_state(out["state"])
    finally:
        os.environ.pop(faults.ENV_NAN, None)
    bitwise("F(d) guard K=4 vs K=1 (step 2 skipped)", guards[1], guards[4])
    print("[resilience F(d)] --sentinel guard, NaN at step 2: skipped at "
          "K=1 and K=4, K=4 bitwise K=1", flush=True)
    res["d"] = f_guard_cost(cli, path_b, build_dir)
    os.environ[faults.ENV_SPIKE] = "10"
    try:
        # a threshold past the record's own loss noise: the injected
        # x 1e4 is the one spike
        cfg = record_cfg(cli, path_b + ["--sentinel", "full", "--supervise",
                                        "--checkpoint_every", "4",
                                        "--sync_checkpoint",
                                        "--spike_threshold", "30"],
                         "f_spike", build_dir)
        out, _, _ = counted_run(cli, cfg, "F(d) spike at 10")
    finally:
        os.environ.pop(faults.ENV_SPIKE, None)
    ledger = json.load(open(os.path.join(cfg.checkpoint_dir, "quarantine",
                                         "ledger.json")))
    check(out["goodput_rollbacks"] == 1
          and out["goodput_quarantined_batches"] == 1
          and int(out["state"].step) == n_steps - 1
          and ledger["batches"] == {"0": [9]},
          f"F(d) spike: rollbacks {out['goodput_rollbacks']}, quarantined "
          f"{out['goodput_quarantined_batches']}, step "
          f"{int(out['state'].step)}, ledger {ledger}")
    res["d_spike"] = {"rollbacks": 1, "ledger": ledger,
                      "restore_s": out["goodput_restore_s"]}
    print(f"[resilience F(d)] --sentinel full: the spike at step 10 rolled "
          f"back to step 8, quarantined epoch 0 position 9 ({ledger}), "
          f"replayed to step {int(out['state'].step)}", flush=True)
    shutil.rmtree(cfg.checkpoint_dir, ignore_errors=True)

    # -- (e) two fs-simulated pod processes on the card --------------------
    cke = os.path.join(build_dir, "f_e")
    shutil.rmtree(cke, ignore_errors=True)
    argv = ["--device", "cuda", "--dataset", "synthetic", "--epoch", "1",
            "--checkpoint_dir", cke, "--log_every", "0", "--no_plot",
            "--n_layers", str(F_POD_LAYERS), "--supervise",
            "--checkpoint_every", "2", "--preempt_sync_every", "1",
            "--peer_timeout_s", "30", "--commit_timeout_s", "10", *path_b]
    env = {"FDT_POD_COUNT": "2", faults.ENV_HOST: "1", faults.ENV_DIE: "3"}
    hosts = [f_host(build_dir, argv, dict(env, FDT_POD_INDEX=str(pi)),
                    f"e{pi}") for pi in (0, 1)]
    r0, r1 = [f_result(h, 400, f"(e) host {i}") for i, h in enumerate(hosts)]
    check(r0["generation"] == r1["generation"] == 1
          and r0["digest"] == r1["digest"] and r0["step"] == r1["step"]
          == n_steps, f"F(e): host 0 {r0['generation']}/{r0['step']}, host "
          f"1 {r1['generation']}/{r1['step']}")
    res["e"] = {"wall_s": [r0["wall_s"], r1["wall_s"]],
                "restarts": [r0["restarts"], r1["restarts"]]}
    print(f"[resilience F(e)] two pod processes on the card, die on host 1 "
          f"at step 3: both restarted into generation 1 and ended at step "
          f"{r0['step']} with equal states ({r0['wall_s']:.1f} / "
          f"{r1['wall_s']:.1f} s wall)", flush=True)
    shutil.rmtree(cke, ignore_errors=True)
    return res


def _leaves_of(out) -> dict:
    """The final state of a run as ``F_HOST`` digests it."""
    from faster_distributed_training_tpu_torch.train.state import (
        state_leaves)

    return dict(state_leaves(out["state"]))


def resilience_main() -> int:
    """``--resilience``: the kernels' build, then phase F alone."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from faster_distributed_training_tpu_torch import cli
    from faster_distributed_training_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)} (torch "
          f"{torch.__version__}, cuda {torch.version.cuda}); nvidia-smi: "
          f"{card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_s, _ = _build.build()
    print(f"[build] {build_s:.1f}s", flush=True)
    t0 = time.monotonic()
    ff = resilience_phase(cli, str(_build.BUILD_DIR))
    print(f"[resilience] phase F took {time.monotonic() - t0:.1f} s")
    print(json.dumps(ff, default=str))
    return 0


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
            fused_mlp, launch_floor, mlp_reference)
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
    flash_use = flash_build(fa, logs)
    fwd_use = {k: u for k, u in flash_use.items() if k.startswith("flash_")}
    bwd_use = {k: u for k, u in flash_use.items() if k not in fwd_use}
    for kname, u in sorted(flash_use.items()):
        src = "flash_fwd" if kname in fwd_use else "flash_bwd"
        print(f"[build] {src} {kname} (bf16, wgmma): {u.get('registers')} "
              f"registers, spill stores {u.get('spill_stores')} B, spill "
              f"loads {u.get('spill_loads')} B, dynamic shared memory "
              f"{u['smem_bytes']} B", flush=True)
    for src, got, n in (("flash_fwd", fwd_use, 4), ("flash_bwd", bwd_use, 8)):
        check(len(got) == n or not logs.get(src),
              f"the build log names {sorted(got)}, not the {n} bf16 {src} "
              f"kernels")
    # the paths' head dim: these must not spill
    for kname in ("flash_fwd_kernel_sm90<64>", "dkdv_kernel_sm90<64>",
                  "dq_kernel_sm90<64>"):
        src = "flash_fwd" if kname in fwd_use else "flash_bwd"
        u = flash_use.get(kname, {})
        check(not logs.get(src) or (u and not u.get("spill_stores")
                                    and not u.get("spill_loads")),
              f"{kname} spills or is missing: {u}")
    sm90_use = sm90_build(logs)
    for kname, u in sorted(sm90_use.items()):
        print(f"[build] {kname} (wgmma): {u.get('registers')} registers, "
              f"spill stores {u.get('spill_stores')} B, spill loads "
              f"{u.get('spill_loads')} B, dynamic shared memory "
              f"{u['smem_bytes']} B", flush=True)
    check(len(sm90_use) == 24 or not (logs.get("quant_matmul")
                                      and logs.get("fused_ffn")),
          f"the build log names {len(sm90_use)} wgmma GEMM / FFN "
          f"instantiations, not 24")
    for kname in RECORD_SM90:
        if sm90_use:
            u = sm90_use.get(kname, {})
            check(u and not u.get("spill_stores") and not u.get(
                "spill_loads"), f"{kname} spills or is missing: {u}")

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
    # the primal (eval, serving) forward, no dropout: like for like with
    # SDPA; and the training forward (lse and its tail, dropout 0.1)
    fa_t = {"kernel": measure(lambda: flash_attention(q, k, v, mask=mask),
                              group="flash_fwd"),
            "kernel_train": measure(lambda: fa.flash_attention_stats(
                q, k, v, mask, 0.1, 5), group="flash_fwd"),
            "plain": measure(
                lambda: flash_attention_reference(q, k, v, mask=mask)),
            "library": measure(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=sdpa_mask))}
    fa_t["bound_ms"], fa_t["bound_by"] = bound(
        4 * B * H * L * D * 2 + B * L * 4, 4 * B * H * L * L * D, "bf16")
    # the classifier at serving's 8 rows, training's 16 and 4096; beside
    # it the device time of an empty kernel, the floor of any launch
    mlp_at = {}
    for rows in (8, 16, 4096):
        x = torch.randn(rows, d_in, generator=gen, device="cuda").to(bf16)
        mlp_at[rows] = {
            "kernel": measure(lambda: fused_mlp(x, w1, b1, w2, b2),
                              group="fused_mlp"),
            "plain": measure(lambda: mlp_reference(x, w1, b1, w2, b2)),
            "library": measure(lambda: torch.addmm(
                b2, torch.relu(torch.addmm(b1, x, w1.T)), w2.T))}
        mlp_at[rows]["bound_ms"], mlp_at[rows]["bound_by"] = bound(
            2 * (rows * d_in + d_h * d_in + d_h + d_out * d_h + d_out
                 + rows * d_out),
            2 * rows * (d_in * d_h + d_h * d_out), "bf16")
    mlp = mlp_at[8]
    floor = measure(lambda: launch_floor(torch.device("cuda")))
    print(f"[timing] launch floor (an empty kernel, <<<1, 32>>>): device ms "
          f"per call ({floor['timer']}) {floor['ms']:.5f}; per call incl. "
          f"launch (events) {floor['call_ms']:.5f}", flush=True)
    for rows in (16, 4096):
        t = mlp_at[rows]
        print(f"[timing] fused_mlp {rows}x{d_in}->{d_h}->{d_out}: device ms "
              f"per call ({t['kernel']['timer']}): kernel "
              f"{t['kernel']['ms']:.5f} (kernel only "
              f"{t['kernel']['kernel_only_ms']:.5f}), plain "
              f"{t['plain']['ms']:.5f}, library (addmm, relu, addmm) "
              f"{t['library']['ms']:.5f}; per call incl. launch (events): "
              f"kernel {t['kernel']['call_ms']:.5f}, library "
              f"{t['library']['call_ms']:.5f}; bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']})", flush=True)
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
           "kernel_p0": measure(lambda: fa.flash_attention_bwd(
               q, k, v, out, lse, dout, mask, 0.0, 5, lse_lo)),
           "plain": measure(lambda: fa.flash_attention_bwd_reference(
               q, k, v, out, lse, dout, mask, 0.1, 5, lse_lo)),
           "library": measure(sdpa_bwd)}
    bwr = {"kernel": measure(lambda: fa.flash_attention_bwd_recompute(
               q, k, v, dout, mask, 0.1, 5)),
           "kernel_p0": measure(lambda: fa.flash_attention_bwd_recompute(
               q, k, v, dout, mask, 0.0, 5)),
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
    for name, t in (("flash_fwd B8 H8 L512 D64 (primal, key padding, "
                     "dropout 0)", fa_t),
                    ("flash_bwd_stats B16 H8 L512 D64", bws),
                    ("flash_bwd_recompute B16 H8 L512 D64", bwr),
                    ("fused_mlp 8x512->1024->4", mlp)):
        p0 = (f" (dropout 0: {t['kernel_p0']['ms']:.5f}, beside the "
              f"library's {t['library']['ms']:.5f} without dropout)"
              if "kernel_p0" in t else "")
        if "kernel_only_ms" in t["kernel"]:
            p0 += f" (kernel only {t['kernel']['kernel_only_ms']:.5f})"
        if "kernel_train" in t:
            p0 += (f"; with lse and dropout 0.1 (a training forward) "
                   f"{t['kernel_train']['ms']:.5f} (kernel only "
                   f"{t['kernel_train']['kernel_only_ms']:.5f})")
        print(f"[timing] {name}: device ms per call ({t['kernel']['timer']}"
              f"): kernel {t['kernel']['ms']:.5f}{p0}, plain "
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
    two_step_check(cli, [])
    two_step_check(cli, ["--ffn_impl", "pallas", "--quant", "int8"])
    defaults_fallback_phase(cli, str(_build.BUILD_DIR))
    lm = lm_phase(cli, str(_build.BUILD_DIR), then=lambda corpus: lm_dispatch(
        cli, corpus, str(_build.BUILD_DIR)))

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

    # -- phase R: ResNet-50 / CIFAR-10 with NGD and mixup ----------------------
    rn = resnet_phase(cli, str(_build.BUILD_DIR))

    # -- phases K and M: K steps a dispatch, --remat -----------------------
    kd = dispatch_phase(cli, str(_build.BUILD_DIR))
    kd["path_e"] = lm["then"]
    mr = remat_phase(cli, str(_build.BUILD_DIR))
    dispatch_summary(kd, mr)

    # -- phase F: resilience (slice 15), before any process group: its
    # relaunch is held against a run of this process ---------------------
    t_f = time.monotonic()
    ff = resilience_phase(cli, str(_build.BUILD_DIR))
    print(f"[resilience] phase F took {time.monotonic() - t_f:.1f} s",
          flush=True)

    # -- phase P: the data mesh (slice 10) ---------------------------------
    pm = mesh_phase(cli, str(_build.BUILD_DIR))

    # -- phase T: tensor parallelism (slice 11) ------------------------------
    tpm = tp_phase(str(_build.BUILD_DIR))

    # -- phase S: sequence parallelism (slice 12) ----------------------------
    spm = sp_phase(str(_build.BUILD_DIR))

    # -- phase PP: pipeline parallelism (slice 13) ---------------------------
    ppm = pp_phase(str(_build.BUILD_DIR))

    # -- phase D: decode serving (slice 14) ----------------------------------
    dd = decode_phase(cli, str(_build.BUILD_DIR))

    # -- 7. output -----------------------------------------------------------
    print(f"[mesh] P1 step ms (dp=1 over NCCL / no group): record "
          f"{pm['p1_record_ms']:.2f} / {pm['p1_record_plain_ms']:.2f}, path B "
          f"{pm['p1_path_b_ms']:.2f} / {pm['p1_path_b_plain_ms']:.2f}, "
          f"ResNet-50 {pm['p1_resnet_ms']:.2f} / "
          f"{pm['p1_resnet_plain_ms']:.2f}; P2 bytes at rest "
          f"{pm['p2_rest_bytes']} with offload, "
          f"{pm['p2_rest_bytes_resident']} without, parked "
          f"{pm['p2_parked_bytes']}, step ms {pm['p2_ms']:.2f} / "
          f"{pm['p2_ms_resident']:.2f}; P4 dp=2 gloo step ms "
          f"{pm['p4_ms']} (world 1: {pm['p4_ms_world1']:.2f})")
    print(f"[tp] T2(a) tp=2 vs world 1: loss err {tpm['t2a_loss_err']:.3g}, "
          f"param err {tpm['t2a_param_err']:.3g}; T2(b) path B tp=2 gloo "
          f"step ms {tpm['t2b_ms']} (world 1: {tpm['t2b_ms_world1']:.2f}), "
          f"device launches a step {tpm['t2b_device_launches']}")
    print(f"[sp] S2(a) sp=2 vs world 1: ring loss err "
          f"{spm['s2a_ring_loss_err']:.3g}, param err "
          f"{spm['s2a_ring_param_err']:.3g}; Ulysses loss err "
          f"{spm['s2a_ulysses_loss_err']:.3g}, param err "
          f"{spm['s2a_ulysses_param_err']:.3g}; S2(b) path B sp=2 gloo step "
          f"ms {spm['s2b_ms']} (world 1: {spm['s2b_ms_world1']:.2f}); S2(c) "
          f"path E sp=2 peak {spm['s2c_peak_bytes']} bytes a rank")
    print(f"[serve] p50 {res['p50_ms']} ms, p99 {res['p99_ms']} ms, "
          f"{res['qps']} qps (64 requests, batch 8, 1 replica)")
    d_def, d_32 = dd["d"]["default"], dd["d"]["32 slots"]
    d_st = d_def["steps"][1]
    print(f"[decode] default run (16 requests, 4 slots): TTFT p50 "
          f"{d_def['ttft_p50_ms']} ms / p99 {d_def['ttft_p99_ms']} ms, "
          f"{d_def['tokens_per_sec']} tokens/s; 32 slots (64 requests): TTFT "
          f"p50 {d_32['ttft_p50_ms']} ms / p99 {d_32['ttft_p99_ms']} ms, "
          f"{d_32['tokens_per_sec']} tokens/s; a step at 1 page: replay "
          f"{d_st['replay']['wall_ms']:.3f} ms host wall, eager "
          f"{d_st['eager']['wall_ms']:.3f} ms; phase D {dd['phase_s']:.1f}s")
    print(f"[train] step time median {tr['step_ms']:.2f} ms; fixed-batch "
          f"loss {tr['loss_first']:.4f} -> {tr['loss_last']:.4f}; eval "
          f"accuracy {tr['test_acc']:.4f}; path B step time median "
          f"{trq['step_ms']:.2f} ms, path C {trq['step_ms_c']:.2f} ms")
    print(f"[train E] --task lm B {LONG['B']} L {LONG['L']}: step time "
          f"median {lm['step_ms']:.2f} ms, {lm['tokens_s']:.0f} tokens/s, "
          f"peak memory {lm['peak_bytes'] / 2**30:.2f} GiB; train loss "
          f"{lm['train_loss']:.4f} (ppl {lm['train_ppl']:.2f}, next-token "
          f"accuracy {lm['train_acc']:.4f}), test loss {lm['test_loss']:.4f}"
          f" (ppl {lm['test_ppl']:.2f}, accuracy {lm['test_acc']:.4f}); "
          f"fixed-batch loss {lm['probe'][0]:.4f} -> {lm['probe'][1]:.4f}")
    print(f"[train R] resnet50 bs 512 bf16 NGD + meta mixup: step time "
          f"median {rn['r1_non_update_ms']:.2f} ms without an NGD update "
          f"({rn['r1_img_s']:.0f} img/s), {rn['r1_update_ms']:.2f} ms with "
          f"one ({rn['r1_img_s_update']:.0f} img/s); peak memory "
          f"{rn['r1_peak'] / 2**30:.2f} GiB; launches a step "
          f"{rn['r1_non-update_launches']:.0f} / "
          f"{rn['r1_update_launches']:.0f}, device busy "
          f"{100 * rn['r1_non-update_busy']:.1f}% / "
          f"{100 * rn['r1_update_busy']:.1f}% (non-update / update); host "
          f"syncs {rn['r1_non-update_syncs']} / {rn['r1_update_syncs']}; "
          f"the record (MADGRAD) {rn['r2_madgrad_ms']:.2f} ms, SGD "
          f"{rn['r2_sgd_ms']:.2f} ms; test accuracy {rn['r1_test_acc']}")
    src = "faster_distributed_training_tpu_torch/csrc/"
    jax_ops = "faster_distributed_training_tpu/ops/"
    # launches: the training run (the main path); the recompute route's
    # from its own 2-step run; the serving run's beside them
    # the recompute route's (row 5) from the --remat run, its real path
    train_l = dict(tr["launches"],
                   flash_bwd_recompute=mr["row5_launches"])
    # the bf16 backward kernels at the paths' head dim (D 64)
    bwd_d64 = {k: u for k, u in bwd_use.items() if k.endswith("<64>")}
    fwd_d64 = {k: u for k, u in fwd_use.items() if k.endswith("<64>")}
    # under K=4: the device launches of each kernel in one dispatch of 4
    # steps (the graph's replays), torch.profiler's CUDA activity by
    # kernel name (slice 2; path B for its kernels), held in phase K to
    # 4 x one eager K=1 step's
    k4s, k4b = kd["timing"]["K=4 host"]["hand"], kd["timing_b"]["K=4"]["hand"]
    disp_l = {"flash_fwd": k4s["flash_fwd_kernel"],
              "flash_bwd_stats": k4s["dkdv_kernel"],
              "fused_mlp": k4s["mlp_fwd_kernel"],
              "fused_ffn_quant": k4b["ffn_kernel"],
              "quant_matmul": k4b["qmm_kernel"]}
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
                        "launches_dispatch_k4": disp_l.get(name),
                        "max_abs_err": err[name], "ms": t["kernel"]["ms"],
                        "call_ms": t["kernel"]["call_ms"],
                        "plain_ms": t["plain"]["ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["library"]["ms"]})
        if "kernel_p0" in t:
            kernels[-1].update(ms_dropout0=t["kernel_p0"]["ms"],
                               build=bwd_d64)
        if name == "flash_fwd":     # "ms" is the primal: dropout 0
            kernels[-1].update(
                ms_dropout0=t["kernel"]["ms"],
                kernel_only_ms=t["kernel"]["kernel_only_ms"],
                ms_train_lse_dropout01=t["kernel_train"]["ms"],
                kernel_only_ms_train_lse_dropout01=t["kernel_train"][
                    "kernel_only_ms"], build=fwd_d64)
        if name == "fused_mlp":
            kernels[-1].update(
                kernel_only_ms=t["kernel"]["kernel_only_ms"],
                launch_floor_ms=floor["ms"],
                **{f"{key}_{rows}_rows": val for rows in (16, 4096)
                   for key, val in (
                       ("ms", mlp_at[rows]["kernel"]["ms"]),
                       ("kernel_only_ms",
                        mlp_at[rows]["kernel"]["kernel_only_ms"]),
                       ("plain_ms", mlp_at[rows]["plain"]["ms"]),
                       ("library_ms", mlp_at[rows]["library"]["ms"]),
                       ("bound_ms", mlp_at[rows]["bound_ms"]))})
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
                 "launches_dispatch_k4": disp_l.get(name),
                 "max_abs_err": err[name], "ms": t["kernel"]["ms"],
                 "call_ms": t["kernel"]["call_ms"],
                 "plain_ms": t["plain"]["ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"],
                 "library_ms": t["library"]["ms"] if t["library"] else None}
        if name.startswith("fused_ffn"):
            entry["library_is"] = "its two cuBLAS GEMMs only"
            entry["engine"] = "ffn_kernel_sm90 (wgmma) at the record's shapes"
            fmts = ("none",) if name == "fused_ffn" else ("int8", "e4m3")
            entry["build"] = {k: u for k, u in sm90_use.items()
                              if k.startswith("ffn_") and k.endswith(", 256>")
                              and k.split(", ")[1] in fmts and "bf16" in k}
        if name == "fused_ffn_quant":
            e = qt["fused_ffn_quant_e4m3"]
            entry.update({
                "e4m3_max_abs_err": err["fused_ffn_quant_e4m3"],
                "e4m3_ms": e["kernel"]["ms"],
                "e4m3_call_ms": e["kernel"]["call_ms"],
                "e4m3_plain_ms": e["plain"]["ms"],
                "e4m3_bound_ms": e["bound_ms"],
                "e4m3_library_ms": e["library"]["ms"] if e["library"]
                else None,
                "e4m3_library_is": "two _scaled_mm calls"})
        if name == "quant_matmul":
            e = qt["quant_matmul_e4m3"]
            entry.update({
                "shape": "8192x512->1536, int8; e4m3_* the E4M3 kernel",
                "e4m3_launches_path_c": trq["short"]["C"]["quant_matmul"],
                "e4m3_max_abs_err": err["quant_matmul_e4m3"],
                "e4m3_ms": e["kernel"]["ms"],
                "e4m3_call_ms": e["kernel"]["call_ms"],
                "e4m3_plain_ms": e["plain"]["ms"],
                "e4m3_bound_ms": e["bound_ms"],
                "e4m3_library_ms": e["library"]["ms"] if e["library"]
                else None,
                "e4m3_bf16_out_err_of_max_plain":
                    err["quant_matmul_e4m3_bf16_rel"],
                "e4m3_fp32_out_err_of_max_plain":
                    err["quant_matmul_e4m3_fp32_rel"],
                "build": {k: u for k, u in sm90_use.items()
                          if k.startswith("qmm_")}})
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
                "ms_dropout0": t["kernel_p0"]["ms"],
                "kernel_only_ms": t["kernel"]["kernel_only_ms"],
                "kernel_only_ms_dropout0": t["kernel_p0"]["kernel_only_ms"],
                "primal_kernel_only_ms": p["kernel"]["kernel_only_ms"],
                "build": fwd_d64,
                "primal_shape": "B1 H8 L16384 D64 bf16, no dropout",
                "primal_ms": p["kernel"]["ms"],
                "primal_plain_ms": p["plain"]["ms"],
                "primal_bound_ms": p["bound_ms"],
                "primal_library_ms": p["library"]["ms"] if p["library"]
                else None})
        else:
            lfb = t["library_fwd_bwd"]
            entry.update(library_fwd_bwd_ms=lfb["ms"] if lfb else None,
                         ms_dropout0=t["kernel_p0"]["ms"], build=bwd_d64)
        kernels.append(entry)
    # slice 11: row 8's tp partial tile (T1's timing at rank 1's shard,
    # int8 as path B runs it; the main path's launches from T2(b)'s run),
    # and every kernel's device launches in one T2(b) step at tp=2
    tp_dev = tpm["t2b_device_launches"]
    for entry in kernels:
        entry["launches_tp2_step"] = tp_dev.get({
            "flash_fwd": "flash_fwd_kernel",
            "flash_bwd_stats": "dkdv_kernel", "fused_mlp": "mlp_fwd_kernel",
            "quant_matmul": "qmm_kernel"}.get(entry["name"], ""))
    t = tpm["row8p"]["int8"]
    entry = {"name": "fused_ffn_partial", "route": "cuda",
             "source": f"{src}fused_ffn.cu",
             "replaces": jax_ops + "fused_ffn.py:624 (partial=True)",
             "launches": tpm["t2b_launches"]["fused_ffn_partial"],
             "launches_tp2_step": tp_dev.get("ffn_kernel"),
             "launches_serve": 0,
             "max_abs_err": tpm["row8p_err"]["int8"]["abs"],
             "ms": t["kernel"]["ms"], "call_ms": t["kernel"]["call_ms"],
             "plain_ms": t["plain"]["ms"], "bound_ms": t["bound_ms"],
             "bound_by": t["bound_by"],
             "library_ms": t["library"]["ms"] if t["library"] else None,
             "library_is": "the shard's two cuBLAS GEMMs only",
             "shape": "8192 x 512 -> 512 of d_ff 1024 -> 512, c0 512, "
                      "dropout 0.1, fp32 out; int8",
             "err_of_max_plain": tpm["row8p_err"],
             "amax_max_bitwise_full": tpm["row8p_amax_bitwise"]}
    for fmt in ("none", "fp8"):
        t = tpm["row8p"][fmt]
        entry.update({f"{fmt}_ms": t["kernel"]["ms"],
                      f"{fmt}_call_ms": t["kernel"]["call_ms"],
                      f"{fmt}_plain_ms": t["plain"]["ms"],
                      f"{fmt}_bound_ms": t["bound_ms"],
                      f"{fmt}_bound_by": t["bound_by"],
                      f"{fmt}_library_ms": t["library"]["ms"]
                      if t["library"] else None})
    kernels.append(entry)
    # slice 12: each kernel's device launches in one S2(b) step at sp=2
    # (rows 2 and 3: path E's S2(c) step; row 7: S2(a)'s fp32 run, its
    # wrapper's launches over 4 steps), and rows 7 and 8 on a sequence
    # half (S1: s0 = L/2, l_loc = L/2)
    sp_dev, sp_e = spm["s2b_device_launches"], spm["s2c_device_launches"]
    for entry in kernels:
        name = entry["name"]
        if name.endswith("kblocked"):
            entry["launches_sp2_step"] = sp_e.get(
                "flash_fwd_kernel" if "fwd" in name else "dkdv_kernel")
        elif name == "fused_ffn":
            entry["launches_sp2_step"] = (
                spm["s2a_ulysses_launches"]["fused_ffn"] / 4)
        else:
            entry["launches_sp2_step"] = sp_dev.get({
                "flash_fwd": "flash_fwd_kernel",
                "flash_bwd_stats": "dkdv_kernel",
                "fused_mlp": "mlp_fwd_kernel",
                "fused_ffn_quant": "ffn_kernel",
                "quant_matmul": "qmm_kernel"}.get(name, ""))
        fmts = {"fused_ffn": ("none",),
                "fused_ffn_quant": ("int8", "fp8")}.get(name, ())
        for fmt in fmts:
            t = spm["s1"][fmt]
            pre = "sp_half_e4m3_" if fmt == "fp8" else "sp_half_"
            entry.update({
                pre + "ms": t["kernel"]["ms"],
                pre + "call_ms": t["kernel"]["call_ms"],
                pre + "plain_ms": t["plain"]["ms"],
                pre + "bound_ms": t["bound_ms"],
                pre + "bound_by": t["bound_by"],
                pre + "library_ms": t["library"]["ms"] if t["library"]
                else None,
                pre + "max_abs_err": spm["s1_err"][fmt]["abs"]})
        if fmts:
            entry["sp_half_shape"] = ("4096 rows: the second sequence half "
                                      "of 16 x 512, s0 256, l_loc 256, "
                                      "l_glob 512")
    # slice 13: each kernel's device launches in one PP2 step at pp=2, a
    # list over the two stages (rows 1, 4, 6: PP2(b)'s record step; rows
    # 8-9: PP2(c)'s path B; rows 2-3: PP2(d)'s path E; row 7: PP2(a)'s
    # wrapper launches over 4 steps), and rows 1, 4, 7, 8 at the last of
    # the 4 microbatches (PP1: b0 12 of 16 rows)
    pp_b, pp_c, pp_d = (ppm["pp2b_device_launches"],
                        ppm["pp2c_device_launches"],
                        ppm["pp2d_device_launches"])
    for entry in kernels:
        name = entry["name"]
        if name.endswith("kblocked"):
            src_l, key = pp_d, ("flash_fwd_kernel" if "fwd" in name
                                else "dkdv_kernel")
        elif name in ("fused_ffn_quant", "quant_matmul"):
            src_l, key = pp_c, {"fused_ffn_quant": "ffn_kernel",
                                "quant_matmul": "qmm_kernel"}[name]
        else:
            src_l, key = pp_b, {"flash_fwd": "flash_fwd_kernel",
                                "flash_bwd_stats": "dkdv_kernel",
                                "fused_mlp": "mlp_fwd_kernel"}.get(name, "")
        entry["launches_pp2_step"] = [d.get(key, 0) for d in src_l]
        if name == "fused_ffn":
            entry["launches_pp2_step"] = [
                r["fused_ffn"] / 4 for r in ppm["pp2a_1f1b_launches"]]
        pp1 = {"flash_fwd": "flash_fwd", "flash_bwd_stats": "flash_bwd_stats",
               "fused_ffn": "ffn_none", "fused_ffn_quant": "ffn_int8"}
        if name in pp1:
            t = ppm["pp1"][pp1[name]]
            err = ppm["pp1_err"][{"ffn_none": "none", "ffn_int8": "int8"}.get(
                pp1[name], pp1[name])]
            entry.update({
                "pp_mb_ms": t["kernel"]["ms"],
                "pp_mb_call_ms": t["kernel"]["call_ms"],
                "pp_mb_plain_ms": t["plain"]["ms"],
                "pp_mb_bound_ms": t["bound_ms"],
                "pp_mb_bound_by": t["bound_by"],
                "pp_mb_library_ms": t["library"]["ms"] if t["library"]
                else None,
                "pp_mb_max_abs_err": err["abs"] if isinstance(err, dict)
                else err,
                "pp_mb_shape": ("the last of 4 microbatches: b0 12, 4 of 16 "
                                "rows (flash B4 H8 L512 D64; FFN 2048 rows)")})
            if name == "fused_ffn_quant":
                t = ppm["pp1"]["ffn_fp8"]
                entry.update({
                    "pp_mb_e4m3_ms": t["kernel"]["ms"],
                    "pp_mb_e4m3_plain_ms": t["plain"]["ms"],
                    "pp_mb_e4m3_bound_ms": t["bound_ms"],
                    "pp_mb_e4m3_library_ms": t["library"]["ms"]
                    if t["library"] else None,
                    "pp_mb_e4m3_max_abs_err": ppm["pp1_err"]["fp8"]["abs"]})
    # slice 15: each kernel's device launches over phase F(a)'s K=1 run of
    # path B (16 steps and the eval)
    f_keys = {"flash_fwd": "flash_fwd_kernel",
              "flash_bwd_stats": "dkdv_kernel",
              "fused_mlp": "mlp_fwd_kernel",
              "fused_ffn_quant": "ffn_kernel", "quant_matmul": "qmm_kernel"}
    for entry in kernels:
        if entry["name"] in f_keys:
            entry["launches_phase_f"] = ff["a_device_launches"].get(
                f_keys[entry["name"]], 0)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def resnet_main() -> int:
    """``--resnet``: phase R alone (no kernel build: the path has none)."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from faster_distributed_training_tpu_torch import cli

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)} (torch "
          f"{torch.__version__}, cuda {torch.version.cuda}); nvidia-smi: "
          f"{card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "faster_distributed_training_tpu_torch",
                             "_build")
    os.makedirs(build_dir, exist_ok=True)
    rn = resnet_phase(cli, build_dir)
    print(json.dumps({k: v for k, v in rn.items()
                      if isinstance(v, (int, float, list, dict))}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--resnet"]:
        import torch

        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            sys.exit(2)
        sys.exit(resnet_main())
    if sys.argv[1:2] == ["--dispatch"]:
        import torch

        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            sys.exit(2)
        sys.exit(dispatch_main())
    if sys.argv[1:2] == ["--sp"]:
        import torch

        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            sys.exit(2)
        sys.exit(sp_main())
    if sys.argv[1:2] == ["--decode"]:
        import torch

        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            sys.exit(2)
        sys.exit(decode_main())
    if sys.argv[1:2] == ["--pp"]:
        import torch

        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            sys.exit(2)
        sys.exit(pp_main())
    if sys.argv[1:2] == ["--tp"]:
        import torch

        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            sys.exit(2)
        sys.exit(tp_main())
    if sys.argv[1:2] == ["--mesh"]:
        import torch

        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            sys.exit(2)
        sys.exit(mesh_main())
    if sys.argv[1:2] == ["--resilience"]:
        import torch

        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            sys.exit(2)
        sys.exit(resilience_main())
    if sys.argv[1:2] == ["--steps"]:
        import torch

        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            sys.exit(2)
        sys.exit(steps_main(os.path.abspath(
            sys.argv[2] if len(sys.argv) > 2
            else os.path.dirname(os.path.abspath(__file__)))))
    sys.exit(main())
