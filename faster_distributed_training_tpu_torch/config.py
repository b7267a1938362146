"""Unified configuration surface for every entry point (PyTorch port).

A copy of ``faster_distributed_training_tpu/config.py`` with the same
flag names and defaults, so one command line drives either package.
The one difference is ``--device``: ``cuda`` (the default) or ``cpu``.
Flags whose features the port has not reached yet parse and are
carried in the record unchanged.

The reference duplicates an argparse block per script (resnet50_test.py:46-59,
transformer_test.py:350-361, tuning/resnet50_tuning.py:33-50).  Here there is
ONE flag surface shared by all entries, preserving the reference's flag names
(--bs, --lr, --epoch, --alpha, --workers, --meta_learning, --distributed,
--ngd, --resume) and adding the TPU-specific ones (--device, mesh shape,
precision policy).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Tuple

from faster_distributed_training_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ALIASES, canonical_axes, parse_mesh)


@dataclasses.dataclass
class TrainConfig:
    """Everything a training run needs, in one picklable record."""

    # -- workload ---------------------------------------------------------
    model: str = "resnet50"           # resnet18/34/50/101/152 | transformer
    dataset: str = "cifar10"          # cifar10 | agnews | synthetic |
                                      # stream (a sharded on-disk dataset
                                      # under --stream_dir, data/stream/)
    num_classes: int = 10
    task: str = "cls"                 # cls | lm: the training objective.
                                      # "lm" (transformer only) = next-
                                      # token prediction — per-position
                                      # vocab logits (lm_head), shifted-
                                      # target token cross-entropy,
                                      # perplexity metric; no mixup/
                                      # pooler.  The streamed text
                                      # workload's objective (r18)
    tie_lm_head: bool = True          # tie the LM head to token_embedding
                                      # (logits = h @ E^T): ~vocab*d_model
                                      # fewer params, the vocab-sharding
                                      # TP rule serves the head for free.
                                      # --untie_lm_head restores the r18
                                      # separate projection; untied
                                      # checkpoints restore into tied
                                      # models via a warned compat shim
                                      # (train/checkpoint.py)
    lm_causal: bool = False           # --task lm: apply the causal mask
                                      # at TRAINING time so the trained
                                      # conditional matches the mask
                                      # decode serving imposes (closes
                                      # the r21 train/decode mismatch;
                                      # resolve_attention routes it to
                                      # the dense impl — flash is key-
                                      # padding-only)
    pp_microbatches: int = 0          # M on a pp>1 mesh: microbatches
                                      # per step through the staged
                                      # encoder (parallel/pipeline.py).
                                      # 0 = auto (largest divisor of the
                                      # batch in [S, 2S] — 2S halves the
                                      # bubble vs M=S); must divide
                                      # --batch_size when set
    pp_schedule: str = "1f1b"         # 1f1b (contiguous stages) |
                                      # interleaved (round-robin layer
                                      # chunks, v=2; needs L % 2S == 0,
                                      # else contiguous fallback) — the
                                      # tick loop always traverses the
                                      # chunks in DEPTH order, so both
                                      # schedules compute the pp=1
                                      # function (pipeline.py)
    pp_residency: bool = True         # shard stage-owned params (and,
                                      # via the ZeRO overlay, their
                                      # opt-state mirrors) over pp so
                                      # per-chip HBM scales ~1/S with
                                      # pipeline depth (sharding.py
                                      # pp_residency_specs);
                                      # --no_pp_residency restores the
                                      # r22 replicated-over-pp layout

    # -- optimization (reference flag surface) ----------------------------
    lr: float = 0.1
    batch_size: int = 512             # --bs
    epochs: int = 30                  # --epoch
    alpha: float = 0.2                # mixup Beta(alpha, alpha)
    workers: int = 4
    meta_learning: bool = False       # learnable per-sample mixup lambda
    mixup_mode: str = ""              # "" auto | static | intra | meta | attn | none
    use_ngd: bool = False             # --ngd
    resume: bool = False
    distributed: bool = False
    weight_decay: float = 1e-4        # tuning/resnet50_tuning.py:47
    gamma: float = 0.2                # LR decay factor (tuning flag)
    momentum: float = 0.9
    clip_norm: float = 10.0           # resnet50_test.py:546
    label_smoothing: float = 0.0
    optimizer: str = ""               # "" = auto (ngd if use_ngd else madgrad)
    schedule: str = ""                # "" = auto per reference pairing

    # -- NGD hyperparameters (ngd_optimizer.py:9-15 hard-codes these) -----
    ngd_rank: int = -1                # -1 = auto: min((dim+1)//2, 80) per axis
    ngd_update_period: int = 4
    ngd_alpha: float = 4.0
    ngd_eta: float = 0.1
    ngd_max_dim: int = 8192           # skip Fisher preconditioning on axes
                                      # larger than this (vocab-sized
                                      # embedding axes stall training;
                                      # optim/ngd.py NGDHyperParams.max_dim)

    # -- precision --------------------------------------------------------
    precision: str = "bf16"           # bf16 | fp32 | fp16 (fp16 uses loss scaling)
    quant: str = "none"               # none | int8 | fp8: quantized-training
                                      # mode for the transformer's hot GEMMs
                                      # (attention q/k/v/out projections +
                                      # both FFN matmuls): forward GEMMs run
                                      # at int8 (s32 accumulation) or fp8
                                      # E4M3 (fp32 accumulation) with
                                      # per-tensor DELAYED scaling — amax
                                      # histories ride the batch_stats
                                      # collection through the fused-
                                      # dispatch carry/checkpoints, so K-
                                      # dispatch and kill-at-N resume stay
                                      # bitwise (ops/quant.py,
                                      # train.amp.QuantPolicy).  Kill
                                      # switch: FDT_QUANT=0 (plain matmuls,
                                      # same state tree).  tp meshes run
                                      # the quant kernel PER-SHARD on the
                                      # Megatron column/row tiles through
                                      # the r19 shard_map layer (parallel/
                                      # kernel_shard.py); off-TPU backends
                                      # and the FDT_KERNEL_SHARD=0 /
                                      # non-dividing-shape fallbacks use
                                      # the XLA reference path (warned)
    quant_grad: str = "none"          # none | fp8_e5m2: quantize the
                                      # backward cotangents to the wide-
                                      # range E5M2 grid (JIT per-tensor
                                      # scale) and run BOTH gradient GEMMs
                                      # on quantized operands — the FP8-LM
                                      # recipe's gradient half (requires
                                      # --quant int8/fp8; ops/quant.py
                                      # _quant_dot_bwd)

    # -- device / mesh ----------------------------------------------------
    device: str = "cuda"              # cuda | cpu (no silent fallback)
    mesh_shape: Tuple[int, ...] = ()  # () = auto: all devices on the dp axis
    mesh_axes: Tuple[str, ...] = ("dp",)
    fsdp: bool = False                # shard params/opt state over the dp axis
    zero1: bool = False               # shard ONLY optimizer state over the
                                      # data axes (ZeroRedundancyOptimizer
                                      # analog, transformer_test.py:4,221-222)
    host_offload: bool = False        # FSDP param offload to host memory
    zero_opt: bool = True             # ZeRO over tp: shape-aware sharding of
                                      # the FULL optimizer state wherever the
                                      # mesh has a tp axis (sharding.py
                                      # OPT_STATE_RULES); --no_zero_opt
                                      # restores the r15 replicated layout
                                      # (the interchange/twin baseline)
    offload_opt_state: bool = False   # park the big (cold) opt-state leaves
                                      # in pinned host memory and stream them
                                      # through the update — the reference's
                                      # FSDP+CPUOffload row without also
                                      # offloading params (sharding.py
                                      # offload_opt_leaf selects the tier)
    overlap_grad_reduce: bool = False # bucketed gradient reduce-scatter
                                      # expressed inside the K-dispatch scan
                                      # so microbatch i's collective hides
                                      # under i+1's compute.  Value-identity
                                      # reshard; off by default because the
                                      # reduce order may shift float bits
                                      # (the bitwise pins compare flag-off)
    overlap_bucket_mb: int = 4        # bucket size for --overlap_grad_reduce
                                      # (DDP's 25 MB default scaled to TPU
                                      # slice interconnect latency)
    remat: bool = False               # jax.checkpoint the model blocks
    remat_policy: str = "attn_out"    # transformer --remat granularity.
                                      # attn_out (default): whole-layer
                                      # remat but the attention context is
                                      # SAVED so the kernel never re-runs —
                                      # measured bs256/seq512: 941 ex/s @
                                      # 4.9 GB vs layer 560 @ 4.1, ffn
                                      # 1074 @ 10.7, dots 838 @ 8.0, none
                                      # ~1080 @ 15.7.  Also: ffn | layer |
                                      # dots
    donate: bool = True               # donate the train state into the step
                                      # (in-place update; disable on backends
                                      # with donated-buffer dealloc bugs)

    # -- data -------------------------------------------------------------
    data_dir: str = "./data"
    subset_stride: int = 1            # tuning harness uses 10
    seq_len: int = 512                # transformer max length
    seq_buckets: Tuple[int, ...] = (64, 128, 256, 512)
    prefetch_depth: int = 2
    data_path: str = "host"           # host | resident | stream:
                                      # "resident" uploads the train split
                                      # to device once (uint8 images /
                                      # int32 token ids) and gathers each
                                      # batch inside the jitted dispatch
                                      # (data/device_resident.py); works
                                      # single-host (replicated) AND on
                                      # pods (per-host sharded — see
                                      # resident_layout).  "stream" (r18)
                                      # keeps the split ON DISK in the
                                      # sharded stream format (requires
                                      # --dataset stream + --stream_dir)
                                      # and trains through a fixed device
                                      # window refilled by a background
                                      # double-buffered H2D thread — the
                                      # beyond-HBM tier (data/stream/)
    stream_dir: str = ""              # root of a sharded stream dataset
                                      # (train/ + test/ subdirs, each with
                                      # manifest.json + shard_*.npy —
                                      # scripts/shard_dataset.py writes
                                      # one); required by
                                      # --dataset/--data_path stream
    stream_window: int = 8            # batches per stream buffer (two
                                      # buffers double-buffer; a third is
                                      # transiently in flight in the
                                      # refill thread).  Rounded UP to a
                                      # multiple of --steps_per_dispatch
                                      # so buffer boundaries stay
                                      # dispatch-aligned (warned)
    resident_layout: str = "auto"     # auto | replicated | sharded: how the
                                      # resident split is placed.  auto =
                                      # replicated on one host (the r8
                                      # layout, unchanged), per-host sharded
                                      # on pods (each process uploads only
                                      # its row shard; one jitted re-shard
                                      # per epoch builds the batch-major
                                      # view, so steady-state gathers are
                                      # local-HBM dynamic_index reads).
                                      # "sharded" forces the sharded layout
                                      # even single-host (spreads the split
                                      # over local chips); "replicated"
                                      # multi-host falls back to the host
                                      # path with a warning
    steps_per_dispatch: int = 1       # K: train steps fused into one device
                                      # dispatch via lax.scan (steps.py
                                      # make_fused_train_step); 1 = today's
                                      # one-dispatch-per-step loop.
                                      # checkpoint/preemption cadence
                                      # quantizes to dispatch boundaries
                                      # (checkpoint_every rounds UP to a
                                      # multiple of K, warned)

    # -- transformer architecture (reference defaults, transformer.py:12-35)
    n_layers: int = 6
    d_model: int = 512
    d_ff: int = 1024
    n_heads: int = 8
    attention: str = ""               # "" auto | dense | flash | ring | ulysses
    mlp_impl: str = ""                # "" auto (pallas on TPU) | fused | pallas
    ffn_impl: str = "flax"            # flax | pallas: fused LN+FFN+dropout+
                                      # residual sublayer kernel
                                      # (ops/fused_ffn.py) — a capacity
                                      # lever (zero FFN-shaped backward
                                      # residuals); see PARITY for the
                                      # measured time trade
    dropout_impl: str = "hash"        # hash (stateless index-hash masks,
                                      # seed-only backward residual, bit-
                                      # reproducible AND fastest measured —
                                      # ops/dropout.py) | xla (flax
                                      # nn.Dropout) | none (floor probes)
    dropout_rng_impl: str = "threefry"  # PRNG for the xla dropout impl:
                                      # threefry (bit-reproducible masks,
                                      # the default — ADVICE r3 #2) | rbg
                                      # (hardware-RNG path, faster mask
                                      # GENERATION but backend-dependent
                                      # bits; superseded by dropout_impl=
                                      # hash, which is faster than both)

    # -- bag-of-tricks ablation (reference README.md:63: ~2.5x end-to-end
    # from AMP + kernel fusion + prefetch + distributed) -------------------
    tricks: str = "on"                # on | off.  "off" disables EVERY
                                      # speed lever at once: bf16->fp32,
                                      # flash->dense attention, Pallas/
                                      # fused MLP->naive, fused QKV->3
                                      # Linears, conv recompute->autodiff,
                                      # hash dropout->threefry nn.Dropout,
                                      # prefetch/workers->synchronous.
                                      # resolve_tricks() applies it.

    # -- bookkeeping ------------------------------------------------------
    seed: int = 123456                # resnet50_test.py:728
    checkpoint_dir: str = "./checkpoint"
    log_every: int = 50               # live loss/acc/ex-s line every N steps
                                      # (tqdm-descriptor observability,
                                      # resnet50_test.py:560-566, at 1/N the
                                      # sync cost; 0 disables)
    profile: bool = False
    profile_steps: str = ""           # "A:B": start/stop jax.profiler
                                      # around global train steps A..B
                                      # (1-indexed, inclusive) MID-RUN —
                                      # the whole-run --profile is
                                      # unusable past toy scale.  Trace
                                      # lands under the telemetry dir
                                      # (utils/profiling.py
                                      # StepWindowProfiler)
    plot: bool = True

    # -- telemetry (telemetry/ package; on by default, <1% guarded) -------
    telemetry: bool = True            # per-dispatch JSONL records + run
                                      # manifest + span breakdown under
                                      # <checkpoint_dir>/telemetry (or
                                      # --telemetry_dir); process 0 folds
                                      # per-host files into pod p50/p95/
                                      # p99 + straggler flags per epoch.
                                      # Kill switches: --no_telemetry,
                                      # FDT_TELEMETRY=0; overhead guarded
                                      # <1% by bench telemetry_overhead_pct
    telemetry_dir: str = ""           # "" = <checkpoint_dir>/telemetry
                                      # (pods share it like the ckpt fs —
                                      # the aggregation transport needs a
                                      # shared directory)
    straggler_ratio: float = 2.0      # flag a host whose per-step p95
                                      # exceeds this multiple of the pod
                                      # median host-p95 (the [telemetry]
                                      # straggler line)
    aggregate_grace_s: float = 2.0    # how long process 0 waits at an
                                      # epoch boundary for the peers'
                                      # telemetry epoch markers before
                                      # folding without them (was a
                                      # hard-coded 2 s — slow CI hosts
                                      # raced it); skipped hosts are
                                      # recorded in pod_summary.json
                                      # (hosts_missing) either way
    telemetry_every: int = 1          # record every Nth dispatch (compile-
                                      # marked firsts always recorded).  The
                                      # r12 note flags per-dispatch
                                      # time.monotonic pressure under async
                                      # dispatch as the first suspect if
                                      # telemetry_overhead_pct fails on live
                                      # TPU — this knob is the landed
                                      # mitigation (sampled records keep
                                      # their true step numbers)

    # -- failure detection / debugging ------------------------------------
    # The reference has neither (SURVEY.md §5: recovery = manual re-launch
    # with --resume; its NGD NaN guard + never-enabled _self_test are the
    # nearest analogs).  Both are deliberate do-better additions.
    auto_recover: bool = False        # non-finite epoch loss -> restore the
                                      # last good checkpoint and continue
    max_recoveries: int = 2           # consecutive restores before giving up
    debug: bool = False               # per-epoch NGD Fisher invariant checks
                                      # (the reference's debug flag,
                                      # ngd_optimizer.py:46, which it never
                                      # turns on)
    sentinel: str = "none"            # anomaly sentinel
                                      # (resilience/sentinel.py):
                                      # "none" = off (programs stay
                                      # byte-identical to the unguarded
                                      # build); "guard" = in-graph bad-step
                                      # guard only (one fused non-finite
                                      # check over loss + global grad norm;
                                      # a poisoned step leaves params/
                                      # opt-state/RNG bitwise-untouched and
                                      # is counted as skipped_steps);
                                      # "full" = guard + host-side
                                      # loss-spike detector with rollback-
                                      # and-quarantine (needs --supervise
                                      # + --checkpoint_every for the
                                      # rollback half — warned otherwise)
    spike_window: int = 32            # sentinel "full": trailing window of
                                      # per-dispatch losses the median/MAD
                                      # spike statistic is computed over
    spike_threshold: float = 8.0      # sentinel "full": a dispatch loss
                                      # more than this many MADs above the
                                      # window median is a spike (rollback
                                      # + quarantine of the dispatch's
                                      # global-batch indices)

    # -- resilience (resilience/ package; all off by default) --------------
    checkpoint_every: int = 0         # async step-cadence checkpoints every
                                      # N train steps (0 = epoch-level only)
    checkpoint_every_secs: float = 0.0  # ... and/or every S seconds of wall
                                      # clock, whichever fires first
    checkpoint_keep: int = 3          # keep-last-K retention for the
                                      # step-cadence checkpoints
    checkpoint_async: bool = True     # off-critical-path saves (snapshot on
                                      # the step thread, serialize + commit
                                      # in the background); forced sync for
                                      # multi-host runs (collective save)
    supervise: bool = False           # wrap the train loop in the bounded-
                                      # retry supervisor: on a crash, restore
                                      # the newest valid checkpoint and
                                      # continue (resilience/supervisor.py)
    max_restarts: int = 3             # supervisor restart budget
    preempt_sync_every: int = 8       # steps between cross-host preemption
                                      # agreement collectives (multi-host
                                      # only; bounds SIGTERM-to-save latency
                                      # vs per-step allgather cost).  The
                                      # pod coordinator polls peer FAIL
                                      # markers at the same cadence
    peer_timeout_s: float = 60.0      # pod health watchdog: a peer whose
                                      # heartbeat file is older than this is
                                      # presumed dead and the pod restarts
                                      # together (resilience/coordinator.py;
                                      # active with --supervise on a pod)
    step_timeout_s: float = 0.0       # local step watchdog (requires
                                      # --supervise — warned otherwise): no
                                      # completed
                                      # dispatch for this many seconds means
                                      # this host is wedged (hung device
                                      # program / collective blocked on a
                                      # dead peer) — the watchdog thread
                                      # writes its FAIL marker and hard-
                                      # aborts so the pod converges on a
                                      # restart.  0 = off (default: it must
                                      # exceed the worst-case dispatch
                                      # (re)compile, which only the operator
                                      # knows)
    storage_backend: str = "posix"    # durable-write medium for the
                                      # resilience stack (markers, sharded
                                      # checkpoints, retention): "posix"
                                      # (shared fs, today's semantics),
                                      # "fake_object_store" (rename-free
                                      # object semantics under
                                      # <checkpoint_dir>/_objects — the GCS
                                      # stand-in), or "gs://bucket[/prefix]"
                                      # (resilience/storage.py)
    readmit_timeout_s: float = 60.0   # slice-granular elastic recovery
                                      # (multi-slice pods, FDT_SLICE_COUNT):
                                      # how long surviving slices hold at a
                                      # dispatch boundary for a failed
                                      # slice's restart + rejoin before
                                      # falling back to a whole-pod restart.
                                      # 0 = disable re-admission (every
                                      # failure restarts the whole pod, the
                                      # r10 behavior)
    commit_timeout_s: float = 0.0     # sharded-checkpoint commit-barrier
                                      # timeout.  0 = auto: tied to
                                      # O(peer_timeout_s) (max(2x, 10s))
                                      # whenever the pod coordinator is
                                      # armed — a 600s barrier that
                                      # outlives peer detection turns
                                      # every re-admission hold into a
                                      # pod_fallback_restart (r14 follow-
                                      # on) — else the historic 600s.
                                      # User values that invert the
                                      # ordering (below peer_timeout_s, or
                                      # above readmit_timeout_s) warn
    executable_cache: str = ""        # persistent EXECUTABLE cache
                                      # (resilience/executable_cache.py):
                                      # "" = off, "on" =
                                      # <checkpoint_dir>/_exec_cache
                                      # through the storage backend, else
                                      # an explicit directory.  A
                                      # restarted/rejoining process
                                      # deserializes its compiled (train,
                                      # eval, reshard, serve-predict)
                                      # programs instead of recompiling
                                      # (cache_source=deserialized in the
                                      # manifest compile table); keyed by
                                      # HLO fingerprint + jax/jaxlib +
                                      # device kind + mesh; corrupt
                                      # entries degrade to plain compile.
                                      # Env seam: FDT_EXEC_CACHE (0=off)
    warm_spares: int = 0              # launcher-side contract (r17): how
                                      # many STANDBY spare processes to
                                      # launch beside the pod, each with
                                      # FDT_SLICE_SPARE=<id> (and an out-
                                      # of-pod FDT_POD_INDEX).  A spare
                                      # pre-admits — mesh built, programs
                                      # warmed via the executable cache,
                                      # params restored to the last COMMIT
                                      # and refreshed at each new one —
                                      # and claims a failed slice's seat
                                      # at re-admission time (CLAIM
                                      # marker, first writer wins).  The
                                      # training process itself reads
                                      # FDT_SLICE_SPARE, not this flag

    # -- serving (serve/ package; cli.run_serving) -------------------------
    serve_replicas: int = 0           # inference replicas: 0 = auto (one
                                      # per local chip under the
                                      # replicated-per-chip layout; forced
                                      # to 1 model-sharded group when the
                                      # mesh has a model axis — SNIPPETS
                                      # [3]: 1D is essentially always
                                      # faster for inference, so shard the
                                      # model only when it doesn't fit)
    serve_batch_size: int = 8         # compiled batch dimension every
                                      # dispatch cell pads to
    serve_max_delay_ms: float = 20.0  # continuous-batching deadline: how
                                      # long a partial batch waits for
                                      # company before flushing with
                                      # masked pad rows — THE latency/
                                      # throughput trade-off knob (raise
                                      # for fuller batches, lower for
                                      # tail latency)
    serve_heartbeat_timeout_s: float = 5.0  # a replica silent past this
                                      # is detached and its work re-
                                      # dispatched (r10 heartbeat idiom
                                      # at request scope; must exceed the
                                      # worst single predict — engines
                                      # are warmed up so that excludes
                                      # compiles)
    serve_readmit_s: float = 0.0      # auto re-admit a detached replica
                                      # after this many seconds (0 =
                                      # manual readmit() only)
    serve_requests: int = 64          # built-in synthetic request count
                                      # for the CLI serve smoke

    # -- decode serving (serve/decode/; cli.run_decode_serving) ------------
    decode_batch_size: int = 4        # cache SLOTS per replica — the
                                      # decode-step batch dimension a
                                      # mid-stream admission swaps into
    decode_page: int = 16             # KV-cache page size (tokens): the
                                      # attention-window quantum — live
                                      # length picks ceil(len/page)
                                      # pages, so the decode program set
                                      # is one program per page count,
                                      # not per length
    decode_max_pages: int = 0         # cache capacity in pages per slot:
                                      # 0 = auto (largest prompt bucket
                                      # plus one page of generation
                                      # headroom, capped at the position
                                      # table)
    decode_max_new_tokens: int = 32   # per-request generation budget cap
                                      # (a request's own max_new is
                                      # honored up to this)
    decode_sample: str = "greedy"     # "greedy" | "topk" — STATIC, baked
                                      # into the compiled program set
    decode_temperature: float = 1.0   # topk softmax temperature
    decode_top_k: int = 40            # topk truncation (<=0 = full vocab)
    decode_replicas: int = 0          # decode replicas: 0 = auto (one per
                                      # local chip; 1 model-sharded group
                                      # when the mesh has a model axis —
                                      # same SNIPPETS [3] rule as
                                      # serve_replicas)
    decode_requests: int = 16         # built-in synthetic prompt count
                                      # for the CLI decode smoke
    decode_deadline_s: float = 120.0  # decode front door: per-request
                                      # wall deadline (assembly to
                                      # completion, all retries
                                      # included) — a request stranded
                                      # by dying worker processes fails
                                      # with TimeoutError after this
                                      # instead of waiting forever;
                                      # <=0 disables

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def resolve_tricks(cfg: "TrainConfig") -> "TrainConfig":
    """Apply the bag-of-tricks switch: tricks="off" rewrites every
    speed-lever field to its naive setting (the ablation baseline the
    reference's headline ~2.5x figure is measured against, per the
    reference's README).  Model-level levers without a config field
    (fused QKV, conv recompute) are read off cfg.tricks by
    cli.build_model."""
    if cfg.tricks != "off":
        return cfg
    return cfg.replace(
        precision="fp32",
        quant="none",
        quant_grad="none",
        attention="dense",
        mlp_impl="naive",
        dropout_impl="xla",
        dropout_rng_impl="threefry",
        prefetch_depth=0,
        workers=0,
    )


def build_parser(prog: str = "fdt",
                 defaults: Optional[TrainConfig] = None
                 ) -> argparse.ArgumentParser:
    """One argparse surface; flag names match the reference CLI.  Flag
    defaults come from `defaults` so each entry point's TrainConfig record
    (e.g. transformer lr=5e-5) survives unless overridden on the CLI."""
    p = argparse.ArgumentParser(prog=prog, description=__doc__)
    d = defaults or TrainConfig()
    p.add_argument("--lr", default=d.lr, type=float, help="learning rate")
    p.add_argument("--resume", "-r", action="store_true", help="resume from checkpoint")
    p.add_argument("--epoch", default=d.epochs, type=int, help="number of epochs")
    p.add_argument("--alpha", default=d.alpha, type=float, help="mixup Beta parameter")
    p.add_argument("--bs", "--batch_size", "-b", dest="bs", default=d.batch_size,
                   type=int, help="global batch size")
    p.add_argument("--workers", default=d.workers, type=int, help="data loader workers")
    p.add_argument("--meta_learning", action="store_true",
                   help="learnable per-sample mixup lambda")
    p.add_argument("--mixup_mode", default=d.mixup_mode,
                   choices=["", "static", "intra", "meta", "attn", "none"],
                   help="mixup variant ('' auto: meta when --meta_learning, "
                        "static when alpha != 0, else none; attn = learnable "
                        "per-pixel map, resnet50_test.py:404-424; intra = "
                        "same-class-only static)")
    p.add_argument("--distributed", action="store_true", help="multi-host run")
    p.add_argument("--ngd", action="store_true", help="natural gradient descent")
    p.add_argument("--weight_decay", default=d.weight_decay, type=float)
    p.add_argument("--gamma", default=d.gamma, type=float, help="LR decay factor")
    p.add_argument("--model", default=None, type=str)
    p.add_argument("--optimizer", default=d.optimizer, type=str,
                   help="override: sgd|madgrad|mirror_madgrad|ngd|adamw")
    p.add_argument("--schedule", default=d.schedule,
                   choices=["", "multistep", "cosine", "onecycle", "step",
                            "constant"],
                   help="LR schedule override ('' = the reference pairing "
                        "for the chosen optimizer)")
    p.add_argument("--ngd_max_dim", default=d.ngd_max_dim, type=int,
                   help="skip NGD Fisher preconditioning on tensor axes "
                        "larger than this (vocab-sized embedding axes "
                        "violate the dense-gradient assumption)")
    p.add_argument("--device", default=d.device, choices=["cuda", "cpu"])
    p.add_argument("--precision", default=d.precision, choices=["bf16", "fp32", "fp16"])
    p.add_argument("--quant", default=d.quant,
                   choices=["none", "int8", "fp8"],
                   help="quantized-training mode (transformer): forward "
                        "GEMMs of the attention projections + FFN at int8 "
                        "(s32 accumulation) or fp8 E4M3 (fp32 accumulation) "
                        "with per-tensor delayed scaling; scale state rides "
                        "the train-state carry so K-dispatch/resume stay "
                        "bitwise.  FDT_QUANT=0 kills it; tp meshes run "
                        "the kernel per-shard via the shard_map layer "
                        "(parallel/kernel_shard.py); off-TPU and the "
                        "FDT_KERNEL_SHARD=0 / non-dividing fallbacks use "
                        "the XLA reference GEMMs (warned)")
    p.add_argument("--quant_grad", default=d.quant_grad,
                   choices=["none", "fp8_e5m2"],
                   help="gradient quantization (requires --quant int8/"
                        "fp8): quantize the backward cotangents to the "
                        "wide-range fp8-E5M2 grid at a just-in-time "
                        "per-tensor scale and run BOTH gradient GEMMs on "
                        "quantized operands — the FP8-LM recipe's "
                        "gradient half (ops/quant.py)")
    p.add_argument("--mesh", default="", type=str,
                   help="mesh as axis=size pairs, e.g. 'dp=4,tp=2' (a 2D "
                        "(data, model) mesh), 'dp=4,fsdp=2', or "
                        "'dp=2,tp=2,pp=2' (3D: pipeline stages over pp — "
                        "the axis that spans DCN between slices); axis "
                        "aliases: model/mp=tp, seq/context=sp, "
                        "pipe/stage=pp (default: all devices on dp)")
    p.add_argument("--fsdp", action="store_true", help="fully-shard params/opt state")
    p.add_argument("--zero1", action="store_true",
                   help="shard only optimizer state over the data axes "
                        "(ZeRO-1; params stay replicated)")
    p.add_argument("--host_offload", action="store_true")
    p.add_argument("--no_zero_opt", action="store_true",
                   help="keep the optimizer state replicated over tp (the "
                        "r15 layout) instead of the default shape-aware "
                        "ZeRO sharding (sharding.py OPT_STATE_RULES)")
    p.add_argument("--offload_opt_state", action="store_true",
                   help="park the big opt-state leaves in pinned host "
                        "memory and stream them through each update "
                        "(FSDP+CPUOffload analog without offloading "
                        "params; no-op where the backend lacks "
                        "pinned_host)")
    p.add_argument("--overlap_grad_reduce", action="store_true",
                   help="lower the gradient reduction as bucketed "
                        "reduce-scatter inside the K-dispatch scan so "
                        "microbatch i's collective overlaps i+1's compute "
                        "(value-identity; reduce order may shift bits)")
    p.add_argument("--overlap_bucket_mb", default=d.overlap_bucket_mb,
                   type=int,
                   help="bucket size (MB) for --overlap_grad_reduce")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--remat_policy", default=d.remat_policy,
                   choices=["ffn", "layer", "attn_out", "dots"],
                   help="what --remat checkpoints on the transformer: "
                        "ffn = FFN sublayer only, layer = whole encoder "
                        "layer (max savings), attn_out = whole layer but "
                        "the attention context is saved so the kernel "
                        "never re-runs, dots = XLA matmul-saveable policy")
    p.add_argument("--data_dir", default=d.data_dir, type=str)
    p.add_argument("--dataset", default=None, type=str)
    p.add_argument("--subset_stride", default=d.subset_stride, type=int,
                   help="take every Nth sample (tuning harness uses 10)")
    p.add_argument("--seed", default=d.seed, type=int)
    p.add_argument("--checkpoint_dir", default=d.checkpoint_dir, type=str)
    p.add_argument("--profile", action="store_true", help="capture a jax.profiler trace")
    p.add_argument("--profile_steps", default=d.profile_steps, type=str,
                   help="capture a jax.profiler trace around global train "
                        "steps A:B only (1-indexed, inclusive; quantized "
                        "to dispatch boundaries under --steps_per_dispatch)"
                        " — the mid-run window --profile can't give")
    p.add_argument("--no_telemetry", action="store_true",
                   help="disable run telemetry (per-dispatch JSONL + "
                        "manifest + pod straggler aggregation under "
                        "<checkpoint_dir>/telemetry); FDT_TELEMETRY=0 "
                        "is the env equivalent")
    p.add_argument("--telemetry_dir", default=d.telemetry_dir, type=str,
                   help="telemetry output directory (default "
                        "<checkpoint_dir>/telemetry; pods must share it, "
                        "like the checkpoint fs)")
    p.add_argument("--straggler_ratio", default=d.straggler_ratio,
                   type=float,
                   help="flag a host whose per-step p95 exceeds this "
                        "multiple of the pod median host-p95 in the "
                        "epoch [telemetry] line")
    p.add_argument("--aggregate_grace_s", default=d.aggregate_grace_s,
                   type=float,
                   help="epoch-boundary grace for the pod telemetry "
                        "fold: how long process 0 waits for peer epoch "
                        "markers before aggregating without them "
                        "(skipped hosts land in pod_summary.json's "
                        "hosts_missing; raise on slow shared "
                        "filesystems/CI hosts)")
    p.add_argument("--telemetry_every", default=d.telemetry_every,
                   type=int,
                   help="record every Nth dispatch in the telemetry "
                        "stream (default 1 = all; compile-marked first "
                        "dispatches are always recorded) — the mitigation "
                        "for per-dispatch clock pressure under async "
                        "dispatch")
    p.add_argument("--log_every", default=d.log_every, type=int,
                   help="live loss/acc/throughput line every N train steps "
                        "(0 disables; the reference's tqdm descriptors, "
                        "resnet50_test.py:560-566, at 1/N the sync cost)")
    p.add_argument("--no_plot", action="store_true")
    p.add_argument("--auto_recover", action="store_true",
                   help="on a non-finite epoch loss, restore the last good "
                        "checkpoint and keep training")
    p.add_argument("--sentinel", default=d.sentinel,
                   choices=["none", "guard", "full"],
                   help="anomaly sentinel: 'guard' arms the in-graph "
                        "bad-step guard (non-finite loss/grad-norm steps "
                        "leave the state bitwise-untouched and are counted); "
                        "'full' adds the host-side loss-spike detector with "
                        "rollback-and-quarantine (wants --supervise + "
                        "--checkpoint_every); 'none' keeps the programs "
                        "byte-identical to the unguarded build")
    p.add_argument("--spike_window", default=d.spike_window, type=int,
                   help="sentinel full: trailing per-dispatch loss window "
                        "for the median/MAD spike statistic")
    p.add_argument("--spike_threshold", default=d.spike_threshold,
                   type=float,
                   help="sentinel full: MAD multiples above the window "
                        "median that count as a loss spike")
    p.add_argument("--checkpoint_every", default=d.checkpoint_every, type=int,
                   help="async step-cadence checkpoints every N train steps "
                        "(keep-last-K, atomic commit markers, preemption-"
                        "aware; 0 = epoch-level checkpoints only)")
    p.add_argument("--checkpoint_every_secs", default=d.checkpoint_every_secs,
                   type=float,
                   help="wall-clock checkpoint cadence in seconds (combines "
                        "with --checkpoint_every; whichever fires first)")
    p.add_argument("--checkpoint_keep", default=d.checkpoint_keep, type=int,
                   help="how many step-cadence checkpoints to retain")
    p.add_argument("--sync_checkpoint", action="store_true",
                   help="disable the async (off-critical-path) checkpoint "
                        "write; saves block the step loop instead")
    p.add_argument("--supervise", action="store_true",
                   help="self-restarting supervisor: on a crash, restore "
                        "the newest valid checkpoint and continue with "
                        "exponential backoff (bounded by --max_restarts; "
                        "deterministic crashes re-raise immediately)")
    p.add_argument("--max_restarts", default=d.max_restarts, type=int,
                   help="supervisor restart budget")
    p.add_argument("--preempt_sync_every", default=d.preempt_sync_every,
                   type=int,
                   help="steps between cross-host preemption-agreement "
                        "collectives (multi-host; lower = faster SIGTERM-"
                        "to-emergency-save, higher = less sync overhead); "
                        "the pod coordinator polls peer failure markers at "
                        "the same cadence")
    p.add_argument("--peer_timeout_s", default=d.peer_timeout_s, type=float,
                   help="pod health watchdog: a peer heartbeat older than "
                        "this many seconds is a failed host and the pod "
                        "restarts together (with --supervise on a pod)")
    p.add_argument("--step_timeout_s", default=d.step_timeout_s, type=float,
                   help="local step watchdog (requires --supervise): no "
                        "completed dispatch for this many seconds => write "
                        "a FAIL marker and hard-abort so the pod converges "
                        "on a restart (0 = off; must exceed the worst-case "
                        "dispatch (re)compile time)")
    p.add_argument("--storage_backend", default=d.storage_backend,
                   help="durable-write medium for resilience markers / "
                        "sharded checkpoints / retention: posix (default), "
                        "fake_object_store (rename-free object semantics "
                        "under <checkpoint_dir>/_objects), or "
                        "gs://bucket[/prefix]")
    p.add_argument("--readmit_timeout_s", default=d.readmit_timeout_s,
                   type=float,
                   help="multi-slice elastic recovery (FDT_SLICE_COUNT): "
                        "how long surviving slices hold for a failed "
                        "slice's restart + re-admission before falling "
                        "back to a whole-pod restart (0 = always whole-pod)")
    p.add_argument("--commit_timeout_s", default=d.commit_timeout_s,
                   type=float,
                   help="sharded-checkpoint commit-barrier timeout (0 = "
                        "auto: max(2 x peer_timeout_s, 10s) when the pod "
                        "coordinator is armed, else 600s); values that "
                        "invert the detection/hold ordering warn")
    p.add_argument("--executable_cache", default=d.executable_cache,
                   help="persistent executable cache: '' = off, 'on' = "
                        "<checkpoint_dir>/_exec_cache via the storage "
                        "backend, else an explicit directory — a "
                        "restarted process deserializes its compiled "
                        "programs instead of recompiling (restart MTTR "
                        "is compile-dominated on real hardware); "
                        "FDT_EXEC_CACHE overrides (0 = kill)")
    p.add_argument("--warm_spares", default=d.warm_spares, type=int,
                   help="launcher contract: standby spare processes to "
                        "run beside the pod (each sets "
                        "FDT_SLICE_SPARE=<id>); a spare pre-admits and "
                        "claims a failed slice's seat at re-admission "
                        "time instead of waiting out a cold restart")
    p.add_argument("--debug", action="store_true",
                   help="per-epoch NGD Fisher invariant self-tests")
    p.add_argument("--data_path", default=d.data_path,
                   choices=["host", "resident", "stream"],
                   help="input pipeline: host = BatchLoader + prefetch + "
                        "per-batch H2D (default), resident = train split "
                        "uploaded to device once and batches gathered "
                        "inside the jitted dispatch (zero steady-state "
                        "host work; multi-host via per-host sharded "
                        "residency, see --resident_layout), stream = the "
                        "split stays ON DISK (sharded stream format, "
                        "--stream_dir) and trains through a fixed device "
                        "window refilled by a background double-buffered "
                        "H2D thread — the beyond-HBM tier; stall guarded "
                        "<1% by bench stream_stall_pct")
    p.add_argument("--task", default=d.task, choices=["cls", "lm"],
                   help="training objective: cls = classification (the "
                        "reference's), lm = next-token prediction through "
                        "the transformer (per-position vocab logits, "
                        "shifted-target loss, perplexity metric; no "
                        "mixup) — the streamed LM workload")
    p.add_argument("--untie_lm_head", action="store_true",
                   help="--task lm: use the r18 separate lm_head "
                        "projection instead of tying the head to "
                        "token_embedding (logits = h @ E^T, the r19 "
                        "default; untied checkpoints restore into tied "
                        "models via a warned compat shim)")
    p.add_argument("--lm_causal", action="store_true",
                   help="--task lm: apply the causal (next-token) mask "
                        "at TRAINING time, matching the mask decode "
                        "serving imposes — without it the model trains "
                        "bidirectional and decodes causal (the r21 "
                        "mismatch).  Routes attention to the dense impl "
                        "(the only one whose mask path takes a full "
                        "[B,1,L,L] mask)")
    p.add_argument("--pp_microbatches", default=d.pp_microbatches,
                   type=int,
                   help="pipeline microbatches M per step on a pp>1 "
                        "mesh (must divide --batch_size); 0 = auto "
                        "(largest divisor in [S, 2S] — bubble "
                        "(S-1)/(M+S-1))")
    p.add_argument("--pp_schedule", default=d.pp_schedule,
                   choices=["1f1b", "interleaved"],
                   help="pipeline stage assignment: 1f1b = contiguous "
                        "layer blocks; interleaved = round-robin chunks "
                        "(Megatron v=2, requires n_layers %% (2*pp) == "
                        "0, contiguous fallback otherwise) — executed "
                        "in depth order either way, at the price of a "
                        "longer fill/drain (bubble (2S-1)/(M+2S-1))")
    p.add_argument("--no_pp_residency", action="store_true",
                   help="keep params/opt-state replicated over pp (the "
                        "r22 layout) instead of the default per-stage "
                        "residency (sharding.py pp_residency_specs) — "
                        "the interchange/twin baseline, and the right "
                        "call when pp fits one slice anyway")
    p.add_argument("--stream_dir", default=d.stream_dir, type=str,
                   help="sharded stream dataset root (train/ + test/ "
                        "subdirs; scripts/shard_dataset.py writes one) — "
                        "required by --dataset stream / --data_path "
                        "stream")
    p.add_argument("--stream_window", default=d.stream_window, type=int,
                   help="batches per stream buffer (double-buffered; "
                        "rounded up to a multiple of "
                        "--steps_per_dispatch)")
    p.add_argument("--resident_layout", default=d.resident_layout,
                   choices=["auto", "replicated", "sharded"],
                   help="placement of the resident split: auto = "
                        "replicated single-host / per-host sharded on "
                        "pods; sharded = each process holds only its row "
                        "shard (~n/process_count per host) and one jitted "
                        "re-shard per epoch builds the batch-major view "
                        "(steady-state gathers stay in local HBM); "
                        "replicated = the r8 whole-split-per-host layout "
                        "(single-host only)")
    p.add_argument("--steps_per_dispatch", default=d.steps_per_dispatch,
                   type=int,
                   help="K train steps fused into one device dispatch "
                        "(lax.scan); 1 = the classic per-step loop.  K>1 "
                        "amortizes Python dispatch + resilience polling "
                        "K-fold; checkpoint cadence rounds up to a "
                        "multiple of K")
    p.add_argument("--seq_len", default=d.seq_len, type=int,
                   help="transformer max sequence length")
    p.add_argument("--n_layers", default=d.n_layers, type=int)
    p.add_argument("--d_model", default=d.d_model, type=int)
    p.add_argument("--d_ff", default=d.d_ff, type=int)
    p.add_argument("--n_heads", default=d.n_heads, type=int)
    p.add_argument("--attention", default=d.attention,
                   choices=["", "dense", "flash", "ring", "ulysses"],
                   help="attention impl ('' = the measured 4-impl routing "
                        "surface, cli.resolve_attention: sequence-parallel "
                        "ulysses/ring on a model axis (sp always; tp from "
                        "seq 2048 up — ulysses when the axis divides heads "
                        "and seq, else ring), dense/flash per the 2D "
                        "crossover otherwise)")
    p.add_argument("--mlp_impl", default=d.mlp_impl,
                   choices=["", "fused", "pallas"],
                   help="classifier MLP kernel ('' = pallas on TPU, else "
                        "the custom_vjp fused path)")
    p.add_argument("--ffn_impl", default=d.ffn_impl,
                   choices=["flax", "pallas"],
                   help="FFN sublayer impl: flax = Dense/GELU composition "
                        "(default), pallas = fused LN+FFN+dropout+residual "
                        "kernel with recompute backward (capacity lever; "
                        "not valid with a tp-sharded mesh)")
    p.add_argument("--tricks", default=d.tricks, choices=["on", "off"],
                   help="bag-of-tricks switch: off = disable every speed "
                        "lever at once (fp32, dense attention, naive MLP, "
                        "unfused QKV, autodiff conv+BN, threefry "
                        "nn.Dropout, synchronous loading) — the ablation "
                        "baseline for the end-to-end speedup figure")
    p.add_argument("--dropout_impl", default=d.dropout_impl,
                   choices=["hash", "xla", "none"],
                   help="dropout engine: hash = stateless index-hash masks "
                        "(no mask tensor in HBM, bit-reproducible, fastest "
                        "measured), xla = flax nn.Dropout (PRNG per "
                        "--dropout_rng_impl), none = disabled (probes)")
    p.add_argument("--dropout_rng_impl", default=d.dropout_rng_impl,
                   choices=["threefry", "rbg"],
                   help="PRNG for the xla dropout impl: threefry = bit-"
                        "reproducible masks (default), rbg = hardware-RNG "
                        "path (faster generation, backend-dependent bits)")
    p.add_argument("--serve_replicas", default=d.serve_replicas, type=int,
                   help="inference replicas (serve entrypoint): 0 = auto "
                        "(one per local chip; one model-sharded group "
                        "when the mesh has a model axis)")
    p.add_argument("--serve_batch_size", default=d.serve_batch_size,
                   type=int,
                   help="compiled serving batch size every dispatch cell "
                        "pads to")
    p.add_argument("--serve_max_delay_ms", default=d.serve_max_delay_ms,
                   type=float,
                   help="continuous-batching deadline: max wait before a "
                        "partial batch flushes with masked pad rows (the "
                        "latency/throughput trade-off knob)")
    p.add_argument("--serve_heartbeat_timeout_s",
                   default=d.serve_heartbeat_timeout_s, type=float,
                   help="detach a serving replica whose heartbeat is "
                        "silent past this many seconds; its work "
                        "re-dispatches to the survivors")
    p.add_argument("--serve_readmit_s", default=d.serve_readmit_s,
                   type=float,
                   help="auto re-admit a detached serving replica after "
                        "this many seconds (0 = manual only)")
    p.add_argument("--serve_requests", default=d.serve_requests, type=int,
                   help="synthetic request count for the CLI serve smoke")
    p.add_argument("--decode_batch_size", default=d.decode_batch_size,
                   type=int,
                   help="KV-cache slots per decode replica (the decode-"
                        "step batch dimension admissions swap into)")
    p.add_argument("--decode_page", default=d.decode_page, type=int,
                   help="KV-cache page size in tokens: live length picks "
                        "ceil(len/page) pages, so the decode program set "
                        "is one program per page count")
    p.add_argument("--decode_max_pages", default=d.decode_max_pages,
                   type=int,
                   help="cache capacity in pages per slot (0 = auto: "
                        "largest prompt bucket + one page of headroom)")
    p.add_argument("--decode_max_new_tokens",
                   default=d.decode_max_new_tokens, type=int,
                   help="per-request generation budget cap")
    p.add_argument("--decode_sample", default=d.decode_sample,
                   choices=["greedy", "topk"],
                   help="sampling method, baked into the compiled decode "
                        "programs (deterministic per (seed, request) "
                        "either way)")
    p.add_argument("--decode_temperature", default=d.decode_temperature,
                   type=float, help="topk sampling temperature")
    p.add_argument("--decode_top_k", default=d.decode_top_k, type=int,
                   help="topk truncation; <=0 samples the full vocab")
    p.add_argument("--decode_replicas", default=d.decode_replicas,
                   type=int,
                   help="decode replicas: 0 = auto (one per local chip; "
                        "one model-sharded group when the mesh has a "
                        "model axis)")
    p.add_argument("--decode_requests", default=d.decode_requests,
                   type=int,
                   help="synthetic prompt count for the CLI decode smoke")
    p.add_argument("--decode_deadline_s", default=d.decode_deadline_s,
                   type=float,
                   help="decode front door per-request wall deadline in "
                        "seconds (all retries included); a request "
                        "stranded by dying worker processes fails with "
                        "TimeoutError after this instead of waiting "
                        "forever (<=0 disables)")
    return p


def config_from_args(args: argparse.Namespace, defaults: Optional[TrainConfig] = None,
                     **overrides) -> TrainConfig:
    base = defaults or TrainConfig()
    axes, shape = parse_mesh(args.mesh)
    cfg = base.replace(
        lr=args.lr, resume=args.resume, epochs=args.epoch, alpha=args.alpha,
        batch_size=args.bs, workers=args.workers,
        meta_learning=args.meta_learning, mixup_mode=args.mixup_mode,
        distributed=args.distributed, use_ngd=args.ngd,
        weight_decay=args.weight_decay, gamma=args.gamma,
        optimizer=args.optimizer, schedule=args.schedule,
        ngd_max_dim=args.ngd_max_dim,
        device=args.device, precision=args.precision, quant=args.quant,
        quant_grad=args.quant_grad,
        tie_lm_head=not args.untie_lm_head,
        lm_causal=args.lm_causal,
        pp_microbatches=args.pp_microbatches,
        pp_schedule=args.pp_schedule,
        pp_residency=not args.no_pp_residency,
        fsdp=args.fsdp, zero1=args.zero1, host_offload=args.host_offload,
        zero_opt=not args.no_zero_opt,
        offload_opt_state=args.offload_opt_state,
        overlap_grad_reduce=args.overlap_grad_reduce,
        overlap_bucket_mb=args.overlap_bucket_mb,
        remat=args.remat, remat_policy=args.remat_policy,
        data_dir=args.data_dir, subset_stride=args.subset_stride, seed=args.seed,
        checkpoint_dir=args.checkpoint_dir, profile=args.profile,
        profile_steps=args.profile_steps,
        telemetry=not args.no_telemetry,
        telemetry_dir=args.telemetry_dir,
        straggler_ratio=args.straggler_ratio,
        aggregate_grace_s=args.aggregate_grace_s,
        telemetry_every=args.telemetry_every,
        log_every=args.log_every,
        plot=not args.no_plot,
        auto_recover=args.auto_recover, debug=args.debug,
        sentinel=args.sentinel,
        spike_window=args.spike_window,
        spike_threshold=args.spike_threshold,
        checkpoint_every=args.checkpoint_every,
        checkpoint_every_secs=args.checkpoint_every_secs,
        checkpoint_keep=args.checkpoint_keep,
        checkpoint_async=not args.sync_checkpoint,
        supervise=args.supervise, max_restarts=args.max_restarts,
        preempt_sync_every=args.preempt_sync_every,
        peer_timeout_s=args.peer_timeout_s,
        step_timeout_s=args.step_timeout_s,
        storage_backend=args.storage_backend,
        readmit_timeout_s=args.readmit_timeout_s,
        commit_timeout_s=args.commit_timeout_s,
        executable_cache=args.executable_cache,
        warm_spares=args.warm_spares,
        data_path=args.data_path,
        task=args.task,
        stream_dir=args.stream_dir,
        stream_window=args.stream_window,
        resident_layout=args.resident_layout,
        steps_per_dispatch=args.steps_per_dispatch,
        seq_len=args.seq_len, n_layers=args.n_layers, d_model=args.d_model,
        d_ff=args.d_ff, n_heads=args.n_heads, attention=args.attention,
        mlp_impl=args.mlp_impl, ffn_impl=args.ffn_impl,
        dropout_impl=args.dropout_impl,
        dropout_rng_impl=args.dropout_rng_impl, tricks=args.tricks,
        serve_replicas=args.serve_replicas,
        serve_batch_size=args.serve_batch_size,
        serve_max_delay_ms=args.serve_max_delay_ms,
        serve_heartbeat_timeout_s=args.serve_heartbeat_timeout_s,
        serve_readmit_s=args.serve_readmit_s,
        serve_requests=args.serve_requests,
        decode_batch_size=args.decode_batch_size,
        decode_page=args.decode_page,
        decode_max_pages=args.decode_max_pages,
        decode_max_new_tokens=args.decode_max_new_tokens,
        decode_sample=args.decode_sample,
        decode_temperature=args.decode_temperature,
        decode_top_k=args.decode_top_k,
        decode_replicas=args.decode_replicas,
        decode_requests=args.decode_requests,
        decode_deadline_s=args.decode_deadline_s,
    )
    cfg = resolve_tricks(cfg)
    if args.model:
        cfg = cfg.replace(model=args.model)
    if args.dataset:
        cfg = cfg.replace(dataset=args.dataset)
    if axes:
        cfg = cfg.replace(mesh_axes=axes, mesh_shape=shape)
    if cfg.fsdp and "fsdp" not in cfg.mesh_axes:
        if cfg.mesh_shape != ():
            raise ValueError(
                f"--fsdp requires an 'fsdp' axis in --mesh, got {cfg.mesh_axes}; "
                f"e.g. --mesh dp=2,fsdp=4")
        # --fsdp with no explicit mesh: put every device on one fsdp axis,
        # which is the ZeRO-3 topology (params sharded where data is sharded).
        cfg = cfg.replace(mesh_axes=("fsdp",))
    return cfg if not overrides else cfg.replace(**overrides)
