"""Entry points of the port: classifier training (slice 2) and serving
(slice 1), with the fused FFN and quantized GEMMs (slice 3: ``--ffn_impl
pallas``, ``--quant int8|fp8``, ``--quant_grad fp8_e5m2``), the
next-token LM on a sharded stream corpus (slice 4: ``--task lm --dataset
stream --stream_dir D``, host data path), and ResNet-18…152 training on
CIFAR-10 with NGD, the image mixup modes and fp16 loss scaling (slice 8:
``--model resnet50``, ``python -m faster_distributed_training_tpu_torch.
resnet50_test``), and the one-card performance layers (slice 9:
``--steps_per_dispatch K``, K steps a dispatch replaying a captured
CUDA graph; ``--data_path resident``, the train split on the card;
``--remat`` with ``--remat_policy``), and data-parallel and
fully-sharded training over ``torch.distributed`` (slice 10:
``--distributed``, ``--mesh dp=N`` / ``fsdp=N``, ``--fsdp``, ``--zero1``,
``--host_offload``, ``--offload_opt_state``, ``--overlap_grad_reduce``;
one process a rank, launched by torchrun: ``run_distributed.sh``), and
tensor parallelism for the Transformer classifier (slice 11: ``--mesh
dp=D,tp=T``, every hand kernel on the rank's shard, ZeRO over tp unless
``--no_zero_opt``), and sequence parallelism for Transformer training
(slice 12: ``--mesh sp=S`` / ``dp=D,sp=S``, ring or Ulysses attention,
the rank's positions of every row through the other kernels), and
pipeline parallelism for Transformer training (slice 13: ``--mesh
pp=P`` / ``dp=D,pp=P``, one process a stage, ``--pp_schedule``,
``--pp_microbatches``, ``--no_pp_residency``), and decode serving for
the LM with causal LM training (slice 14: ``run_decode_serving`` /
``main_decode``, the paged KV cache and a CUDA graph a page count;
``--task lm --lm_causal``), and resilience for training (slice 15: the
asynchronous checkpoint manager on ``--storage_backend``, preemption,
``--supervise``, the ``FDT_FAULT_*`` drills, goodput, ``--sentinel``,
``--auto_recover`` and the pod coordinator; ``resilience/``), and the
rest of the data plane (slice 17: ``--data_path stream``, a window of
batches on the card refilled from disk, on text and image stream shards;
``--resident_layout sharded``; the native host library), and the run
record (slice 18: ``telemetry/``), and the program table with the
executable cache (slice 19: every entry point installs a
``ProgramObservatory`` before anything loads a kernel library, arms
``--executable_cache`` on it and bills goodput; the Trainer's
placement-drift guard).

Counterparts of ``faster_distributed_training_tpu/cli.py``'s
``resolve_attention``, ``build_model``, ``load_dataset`` (the agnews,
cifar10, synthetic and stream branches), ``apply_subset``, ``make_loaders``,
``run_training``, ``main``, ``synth_requests``, ``run_serving``,
``main_serve``, ``run_decode_serving`` and ``main_decode``.  Everything runs
on CUDA unless the caller passes ``--device cpu`` / ``device="cpu"``;
``cuda`` without a GPU raises, nothing falls back on its own.

Attention routing does not copy the JAX package's measured TPU surface
(its dense/flash crossover, sequence-parallel threshold and dense
memory budget were all measured on a TPU): on CUDA every shape the
flash kernel takes routes to it; on the CPU the default is dense, as in
the JAX package; on a dedicated sp axis JAX's rule, Ulysses where sp
divides the heads, else the ring.  An explicit ``--attention`` always
wins (``flash`` on the CPU runs the kernel's plain version).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from faster_distributed_training_tpu_torch.config import (TrainConfig,
                                                          build_parser,
                                                          config_from_args)
from faster_distributed_training_tpu_torch.ops.flash_attention import (
    HEAD_DIMS)

# the transformer entry's record (the JAX package's transformer_test.py)
TRANSFORMER_DEFAULTS = TrainConfig(model="transformer", dataset="agnews",
                                   num_classes=4, lr=5e-5, batch_size=16,
                                   epochs=30, alpha=0.99, seq_len=512)
# the ResNet entry's record (the JAX package's resnet50_test.py)
RESNET50_DEFAULTS = TrainConfig(model="resnet50", dataset="cifar10",
                                num_classes=10, lr=0.1, batch_size=512,
                                epochs=30, alpha=0.2)
IMAGE_DATASETS = ("cifar10", "synthetic", "stream")
TEXT_DATASETS = ("agnews", "synthetic", "stream")


def is_resnet(cfg: TrainConfig) -> bool:
    from faster_distributed_training_tpu_torch.models import RESNETS

    return cfg.model in RESNETS


def resolve_device(name) -> torch.device:
    """``cuda`` (the default) or ``cpu``; ``cuda`` without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "device; pass --device cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {name!r}: the port runs on cuda or cpu")
    return dev


def route_model_axis(cfg: TrainConfig, ax_size: int) -> Optional[str]:
    """The sequence-parallel attention a model axis of ``ax_size`` serves
    for this shape (JAX ``cli._route_model_axis``): None when the axis
    does not divide ``seq_len`` (both strategies shard the sequence over
    it), Ulysses when it also divides the heads, else the ring."""
    if cfg.seq_len % ax_size:
        return None
    return "ulysses" if cfg.n_heads % ax_size == 0 else "ring"


def resolve_attention(cfg: TrainConfig, device: torch.device) -> str:
    """Explicit ``--attention`` wins; ``--task lm --lm_causal`` is dense
    (the one attention that takes the causal mask); on a dedicated sp
    axis above 1 JAX's
    sequence-parallel route (``route_model_axis``; JAX's tp-axis tier from
    seq 2048 is a TPU measurement and is not copied: under tp the port
    runs flash on the rank's heads); else flash on CUDA wherever the
    kernel takes the head dim, dense otherwise (and on the CPU)."""
    from faster_distributed_training_tpu_torch.parallel.mesh import (
        seq_parallel_axis)

    if cfg.attention:
        return cfg.attention
    if cfg.task == "lm" and cfg.lm_causal:
        # the causal LM's [1, 1, L, L] mask: dense is the attention that
        # takes a whole query-by-key mask (JAX cli.py:418-429)
        return "dense"
    ax, n = seq_parallel_axis((cfg.mesh_axes, cfg.mesh_shape))
    if ax == "sp":
        impl = route_model_axis(cfg, n)
        if impl:
            return impl
    if (torch.device(device).type == "cuda"
            and cfg.d_model % cfg.n_heads == 0
            and cfg.d_model // cfg.n_heads in HEAD_DIMS):
        return "flash"
    return "dense"


def build_model(cfg: TrainConfig, vocab_size: Optional[int] = None,
                serving: bool = False, device=None, tp=None, sp=None):
    """The port's Transformer for ``cfg``.  ``serving=True`` builds the
    inference twin: GEMM weights stored in the compute dtype (the JAX
    model casts its fp32 weights at every call; serving rounds them once
    at load) and, under ``--quant``, the scale state frozen (quantize at
    the restored histories' scales, never roll).  ``--ffn_impl pallas``
    takes the fused FFN kernel at every width the config accepts (the
    JAX package's VMEM go/no-go checks are TPU figures and are not
    copied; a shape the kernel cannot take raises in its wrapper).
    ``--task lm`` builds the next-token LM: the head tied to the token
    table unless ``--untie_lm_head``, causal under ``--lm_causal`` (with
    an explicit ``--attention`` other than dense: a ValueError naming
    both flags).  Features the port has not reached
    raise, among them ``--task lm`` with ``--quant`` or ``--ffn_impl
    pallas``.  ``tp`` (a ``TensorGroup``): the rank's tp shard of the
    model (a vocabulary tp does not divide pads the last shards); ``sp``
    (a ``SequenceGroup``): the model runs the rank's positions."""
    from faster_distributed_training_tpu_torch.models import get_model
    from faster_distributed_training_tpu_torch.ops.quant import (
        warn_if_killed)
    from faster_distributed_training_tpu_torch.train.amp import (
        compute_dtype, resolve_quant_policy)

    if is_resnet(cfg):
        return _build_resnet(cfg)
    if cfg.model != "transformer":
        raise ValueError(f"unknown model {cfg.model!r}")
    unported = {"--task lm with --quant": (cfg.task == "lm" and (
                    cfg.quant or "none") != "none"),
                "--task lm with --ffn_impl pallas": (
                    cfg.task == "lm" and cfg.ffn_impl == "pallas"),
                "--tricks off (unfused qkv)": cfg.tricks == "off",
                "--dropout_impl xla": cfg.dropout_impl == "xla",
                "serving under --mesh": serving and any(
                    int(s) > 1 for s in cfg.mesh_shape)}
    missing = [k for k, v in unported.items() if v]
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")
    dtype = compute_dtype(cfg.precision)
    device = torch.device(device if device is not None else cfg.device)
    attention = resolve_attention(cfg, device)
    # JAX's causal needs task lm (cli.py:475-476): on cls the flag is inert
    causal = cfg.task == "lm" and bool(cfg.lm_causal)
    if causal and attention != "dense":
        # JAX reroutes this to dense with a warning; a run that asks for a
        # kernel does not silently run without it
        raise ValueError(
            f"--lm_causal needs the whole [1, 1, L, L] causal mask, which "
            f"only --attention dense takes; --attention {attention} takes "
            f"key-padding masks (flash) or shards the sequence (ring, "
            f"ulysses): drop --attention {attention} or --lm_causal")
    quant = resolve_quant_policy(cfg)
    if quant is not None:
        warn_if_killed(quant.fmt)
        quant = quant._replace(frozen_scales=bool(serving))
    if cfg.ffn_impl not in ("flax", "pallas"):
        raise ValueError(f"--ffn_impl must be flax or pallas, got "
                         f"{cfg.ffn_impl!r}")
    mlp_impl = cfg.mlp_impl or "fused"
    if mlp_impl not in ("fused", "pallas", "naive"):
        raise ValueError(f"--mlp_impl must be fused, pallas or naive, got "
                         f"{cfg.mlp_impl!r}")
    from faster_distributed_training_tpu_torch.models.transformer import (
        REMAT_POLICIES)

    if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"--remat_policy must be one of {REMAT_POLICIES}, "
                         f"got {cfg.remat_policy!r}")
    rate = 0.0 if cfg.dropout_impl == "none" else 0.1
    rates = {k: rate for k in (
        "dropout_encodings", "dropout_connection_attention",
        "dropout_connection_ffn", "dropout_attention", "dropout_ffn",
        "dropout_pooler")}
    return get_model("transformer", cfg.num_classes,
                     vocab=vocab_size or 30522, maxlen=cfg.seq_len,
                     n_layers=cfg.n_layers, d_model=cfg.d_model,
                     d_ff=cfg.d_ff, h=cfg.n_heads, dtype=dtype,
                     param_dtype=dtype if serving else torch.float32,
                     attention_impl=attention,
                     ffn_impl=cfg.ffn_impl, quant=quant,
                     mlp_impl=mlp_impl,
                     lm_head=cfg.task == "lm",
                     tie_lm_head=cfg.task == "lm" and cfg.tie_lm_head,
                     remat=bool(cfg.remat) and not serving,
                     remat_policy=cfg.remat_policy, causal=causal, tp=tp,
                     sp=sp, **rates)


def _build_resnet(cfg: TrainConfig):
    """The ResNet of ``cfg``: bf16 compute unless ``--precision fp32`` or
    fp16 (fp32 compute, as in the JAX package); ``--tricks off`` (fp32
    by then) leaves the conv + BN backward to autograd.  ``--quant``
    warns and runs full precision, as the JAX package does; ``--remat``
    checkpoints every residual block."""
    import warnings

    from faster_distributed_training_tpu_torch.models import get_model
    from faster_distributed_training_tpu_torch.train.amp import (
        compute_dtype)

    if (cfg.quant or "none") != "none":
        warnings.warn(
            f"--quant {cfg.quant} is only wired for the transformer's "
            f"GEMMs (attention projections + FFN); {cfg.model} runs "
            f"full-precision", stacklevel=3)
    return get_model(cfg.model, cfg.num_classes,
                     dtype=compute_dtype(cfg.precision),
                     conv_remat=cfg.tricks != "off", remat=bool(cfg.remat))


def tp_unported(cfg: TrainConfig) -> list:
    """What ``--mesh tp=N`` (N > 1) does not reach, by flag or shape:
    --task lm (a vocab-parallel tied head and loss) and --lm_causal, a
    ResNet, a dispatch or the resident split (the tp collectives in a
    captured graph), --ngd, --remat, fsdp / zero1 / the host tiers
    beside tp, and heads, d_ff or d_model tp does not divide (JAX
    routes those to warned fallbacks; the port has none)."""
    from faster_distributed_training_tpu_torch.parallel.mesh import (
        canonical_axes)

    sizes = dict(zip(canonical_axes(cfg.mesh_axes), cfg.mesh_shape))
    tp = int(sizes.get("tp", 1))
    if tp <= 1:
        return []
    on = f"under --mesh tp={tp}"
    k = max(int(cfg.steps_per_dispatch or 1), 1)
    checks = {
        f"--task lm {on} (vocab-parallel tied head and loss)":
            cfg.task == "lm",
        f"--lm_causal {on}": cfg.task == "lm" and bool(cfg.lm_causal),
        f"--model {cfg.model} {on}": cfg.model != "transformer",
        f"--steps_per_dispatch {k} {on}": k > 1,
        f"--data_path {cfg.data_path} {on}": cfg.data_path != "host",
        f"--ngd {on}": bool(cfg.use_ngd or cfg.optimizer == "ngd"),
        f"--remat {on}": bool(cfg.remat),
        **{f"{flag} {on}": bool(v) for flag, v in (
            ("--fsdp", cfg.fsdp), ("--zero1", cfg.zero1),
            ("--host_offload", cfg.host_offload),
            ("--offload_opt_state", cfg.offload_opt_state))},
        # the heads (qkv, flash), Dense_0's d_ff columns, the out
        # projection's d_model input rows
        **{f"--{flag} {n} not divisible by --mesh tp={tp}": n % tp != 0
           for flag, n in (("n_heads", cfg.n_heads), ("d_ff", cfg.d_ff),
                           ("d_model", cfg.d_model))},
    }
    return [k for k, v in checks.items() if v]


def sp_unported(cfg: TrainConfig) -> list:
    """What sequence parallelism (``--mesh sp=S``, S > 1) does not reach,
    by flag or shape: sp with tp, --lm_causal, with fsdp / zero1 / the
    host tiers, under a dispatch or the resident split, ``--remat``, a
    ResNet or
    ``--ngd``, ``--attention dense|flash`` on an sp mesh (JAX gathers
    q / k / v there), a ``seq_len`` sp does not divide (JAX falls back to
    replicated attention), Ulysses on heads sp does not divide; and ring
    or Ulysses without an sp axis (over a tp-only axis or none).
    Serving under a mesh raises in ``build_model``."""
    from faster_distributed_training_tpu_torch.parallel.mesh import (
        canonical_axes)

    sizes = dict(zip(canonical_axes(cfg.mesh_axes), cfg.mesh_shape))
    sp, tp = int(sizes.get("sp", 1)), int(sizes.get("tp", 1))
    attn = cfg.attention or ""
    if sp <= 1:
        return ([f"--attention {attn} without --mesh sp=N (ring and Ulysses "
                 f"shard the sequence over an sp axis)"]
                if attn in ("ring", "ulysses") else [])
    on = f"under --mesh sp={sp}"
    k = max(int(cfg.steps_per_dispatch or 1), 1)
    checks = {
        f"--mesh tp={tp} {on}": tp > 1,
        f"--lm_causal {on}": cfg.task == "lm" and bool(cfg.lm_causal),
        **{f"{flag} {on}": bool(v) for flag, v in (
            ("--fsdp", cfg.fsdp), ("--zero1", cfg.zero1),
            ("--host_offload", cfg.host_offload),
            ("--offload_opt_state", cfg.offload_opt_state))},
        f"--steps_per_dispatch {k} {on}": k > 1,
        f"--data_path {cfg.data_path} {on}": cfg.data_path != "host",
        f"--remat {on}": bool(cfg.remat),
        f"--model {cfg.model} {on}": cfg.model != "transformer",
        f"--ngd {on}": bool(cfg.use_ngd or cfg.optimizer == "ngd"),
        f"--attention {attn} {on} (JAX gathers q/k/v there)":
            attn in ("dense", "flash"),
        f"--seq_len {cfg.seq_len} not divisible by --mesh sp={sp}":
            cfg.seq_len % sp != 0,
        f"--attention ulysses with --n_heads {cfg.n_heads} not divisible "
        f"by --mesh sp={sp}": attn == "ulysses" and cfg.n_heads % sp != 0,
    }
    return [k for k, v in checks.items() if v]


def pp_unported(cfg: TrainConfig) -> list:
    """What pipeline parallelism (``--mesh pp=P``, P > 1) does not reach,
    by flag: pp with tp or sp, with fsdp / zero1 / the host tiers, under
    a dispatch or the resident split, ``--remat`` and ``--lm_causal``.
    Serving under a mesh raises in ``build_model``; a ResNet raises JAX's
    ValueError in ``parallel.pipeline.build_pipeline_spec``."""
    from faster_distributed_training_tpu_torch.parallel.mesh import (
        canonical_axes)

    sizes = dict(zip(canonical_axes(cfg.mesh_axes), cfg.mesh_shape))
    pp = int(sizes.get("pp", 1))
    if pp <= 1:
        return []
    on = f"under --mesh pp={pp}"
    k = max(int(cfg.steps_per_dispatch or 1), 1)
    checks = {
        **{f"--mesh {ax}={int(sizes.get(ax, 1))} {on}":
           int(sizes.get(ax, 1)) > 1 for ax in ("tp", "sp")},
        **{f"{flag} {on}": bool(v) for flag, v in (
            ("--fsdp", cfg.fsdp), ("--zero1", cfg.zero1),
            ("--host_offload", cfg.host_offload),
            ("--offload_opt_state", cfg.offload_opt_state))},
        f"--steps_per_dispatch {k} {on}": k > 1,
        f"--data_path {cfg.data_path} {on}": cfg.data_path != "host",
        f"--remat {on}": bool(cfg.remat),
        f"--lm_causal {on}": cfg.task == "lm" and bool(cfg.lm_causal),
    }
    return [k for k, v in checks.items() if v]


def unported_training_flags(cfg: TrainConfig) -> list:
    """The flags of features the training slice does not reach.  Of the
    mesh: what tp, sp and pp do not reach (``tp_unported``,
    ``sp_unported``, ``pp_unported``);
    --ngd with --fsdp or --zero1 (NGD preconditions whole gradient
    leaves); --fsdp, --zero1 and the host tiers under a dispatch (K > 1
    or the resident split: their gathers and copies are not captured);
    --warm_spares (warm spares are not ported)."""
    datasets = IMAGE_DATASETS if is_resnet(cfg) else TEXT_DATASETS
    k = max(int(cfg.steps_per_dispatch or 1), 1)
    tiers = [f for f, on in (("--fsdp", cfg.fsdp), ("--zero1", cfg.zero1),
                             ("--host_offload", cfg.host_offload),
                             ("--offload_opt_state", cfg.offload_opt_state))
             if on]
    ngd = cfg.use_ngd or cfg.optimizer == "ngd"
    checks = {
        # NGD preconditions the axes in the JAX layout's order, and the
        # transformer's fused qkv kernel has no permutation onto it
        "--ngd on the transformer": (not is_resnet(cfg) and (
            cfg.use_ngd or cfg.optimizer == "ngd")),
        f"--data_path {cfg.data_path}": cfg.data_path not in (
            "host", "resident", "stream"),
        f"--dataset {cfg.dataset} for {cfg.model}": (
            cfg.dataset not in datasets),
        **{bad: True for bad in tp_unported(cfg)},
        **{bad: True for bad in sp_unported(cfg)},
        **{bad: True for bad in pp_unported(cfg)},
        f"--ngd with {' / '.join(t for t in tiers if t in ('--fsdp', '--zero1'))}"
        " (NGD preconditions whole gradient leaves)": ngd and (
            cfg.fsdp or cfg.zero1),
        f"{' / '.join(tiers)} with --steps_per_dispatch {k}": bool(
            tiers) and k > 1,
        f"{' / '.join(tiers)} with --data_path {cfg.data_path}": bool(
            tiers) and cfg.data_path in ("resident", "stream"),
        f"--warm_spares {cfg.warm_spares} (warm spares)": (
            int(cfg.warm_spares or 0) > 0),
    }
    return [k for k, v in checks.items() if v]


def load_dataset(cfg: TrainConfig, train: bool):
    """A split of ``cfg.dataset``.  ``stream``: the sharded on-disk
    dataset under ``--stream_dir``, the reader itself for text (it speaks
    ``encode_batch``), an ``(image, label)`` pair of its mmaps for images.
    Text:
    ``agnews``, the CSVs under ``--data_dir/ag_news`` or, when they cannot
    be read, the synthetic split of the JAX package's fallback (12000 /
    2000 rows, seeds 0 and 1; nothing is downloaded); or ``synthetic``,
    the AG-News-shaped split (4096 train / 1024 test rows).  Images (a
    ResNet), as an ``(x, y)`` pair: ``cifar10``, the pickled batches
    under ``--data_dir`` or, without them, ``synthetic_cifar`` (50000 /
    10000 images, nothing is downloaded); or ``synthetic``, 4096 / 1024
    synthetic images."""
    from faster_distributed_training_tpu_torch.data.stream import (
        open_stream_split)
    from faster_distributed_training_tpu_torch.data.synthetic import (
        synthetic_agnews, synthetic_cifar)

    if cfg.dataset == "stream":
        if not cfg.stream_dir:
            raise ValueError("--dataset stream requires --stream_dir (python "
                             "-m faster_distributed_training_tpu_torch.data."
                             "stream.shard writes one)")
        return open_stream_split(cfg.stream_dir, train=train)
    if is_resnet(cfg):
        if cfg.dataset not in IMAGE_DATASETS:
            raise NotImplementedError(f"not ported yet: --dataset "
                                      f"{cfg.dataset} for {cfg.model}")
        if cfg.dataset == "cifar10":
            from faster_distributed_training_tpu_torch.data.cifar10 import (
                load_cifar10)
            try:
                return load_cifar10(cfg.data_dir, train=train)
            except Exception as e:
                print(f"[data] CIFAR-10 unavailable ({e!r}); using "
                      f"synthetic")
                return synthetic_cifar(n=50000 if train else 10000,
                                       seed=0 if train else 1)
        return synthetic_cifar(n=4096 if train else 1024,
                               seed=0 if train else 1)
    if cfg.dataset not in TEXT_DATASETS:
        raise NotImplementedError(f"not ported yet: --dataset "
                                  f"{cfg.dataset} for {cfg.model}")
    if cfg.dataset == "agnews":
        from faster_distributed_training_tpu_torch.data.agnews import (
            AGNewsDataset)
        try:
            return AGNewsDataset(cfg.data_dir, train=train,
                                 buckets=cfg.seq_buckets)
        except Exception as e:
            print(f"[data] AG News unavailable ({e!r}); using synthetic")
            return synthetic_agnews(n=12000 if train else 2000,
                                    seed=0 if train else 1,
                                    max_len=cfg.seq_len)
    return synthetic_agnews(n=4096 if train else 1024,
                            seed=0 if train else 1, max_len=cfg.seq_len)


def apply_subset(ds, stride: int):
    """1/N-stride subset of either dataset kind (applied to both
    splits)."""
    if stride <= 1:
        return ds
    if isinstance(ds, tuple):
        x, y = ds
        return (x[::stride], y[::stride])

    class _Subset:
        def __init__(self, base):
            self._base = base
            self._idx = np.arange(0, len(base), stride)

        def __len__(self):
            return len(self._idx)

        def num_classes(self):
            return self._base.num_classes()

        def vocab_size(self):
            return self._base.vocab_size()

        def encode_batch(self, indices, max_len=512):
            return self._base.encode_batch(self._idx[np.asarray(indices)],
                                           max_len)

    return _Subset(ds)


def check_stream_corpus(cfg: TrainConfig, train_ds, log) -> TrainConfig:
    """The JAX ``run_training``'s checks of a stream dataset: the flavor
    fits the model (image shards for a ResNet, text for the transformer);
    packed LM rows carry no labels, so ``--task cls`` on one raises; and
    the rows have one width, which overrides ``--seq_len``."""
    is_text = not isinstance(train_ds, tuple)
    if is_text == is_resnet(cfg):
        raise ValueError(
            f"{cfg.stream_dir} holds {'text' if is_text else 'image'} "
            f"shards, which --model {cfg.model} does not train on")
    if not is_text:
        return cfg
    if train_ds.manifest.get("content") == "lm" and cfg.task != "lm":
        raise ValueError(
            f"{cfg.stream_dir} is an LM-content corpus (packed token rows, "
            f"no labels) but --task is {cfg.task!r}; train it with --task "
            f"lm")
    sl = int(train_ds.seq_len or 0)
    if sl and sl != cfg.seq_len:
        log(f"[data] stream dataset rows are seq_len={sl}; overriding "
            f"--seq_len {cfg.seq_len}")
        cfg = cfg.replace(seq_len=sl)
    return cfg


def make_loaders(cfg: TrainConfig, train_ds, eval_ds, dp: int = 1,
                 rank: int = 0, group=None):
    """(train_loader(epoch, start), eval_loader(epoch), steps_per_epoch);
    ``start`` is the epoch's first batch (a mid-epoch resume).
    ``max(1, --workers)`` threads materialize batches in order, at most
    ``max(--prefetch_depth, --workers)`` ahead; ``--prefetch_depth 0``
    is synchronous.  ``--batch_size`` is the global batch: each of the
    ``dp`` processes loads ``batch_size / dp`` rows of it, its contiguous
    shard of the epoch's permutation (the JAX package's multi-host
    contract); ``--debug`` checks the shards (over the data ``group``:
    the ranks of a tp group load the same rows)."""
    from faster_distributed_training_tpu_torch.data.loader import (
        BatchLoader, ParallelBatchIterator, dataset_len, verify_host_shards,
        verify_host_shards_global)

    if cfg.batch_size % dp:
        raise ValueError(f"global batch {cfg.batch_size} not divisible by "
                         f"{dp} processes")
    local_bs = cfg.batch_size // dp
    if cfg.debug:
        n_train = dataset_len(train_ds)
        verify_host_shards(n_train, epoch=0, seed=cfg.seed, process_count=dp)
        verify_host_shards_global(n_train, epoch=0, seed=cfg.seed,
                                  process_index=rank, process_count=dp,
                                  group=None if group is None
                                  else group.group)
    shard = dict(process_index=rank, process_count=dp)

    def wrap(loader):
        if cfg.prefetch_depth <= 0:
            return loader
        return ParallelBatchIterator(loader, cfg.workers,
                                     depth=cfg.prefetch_depth)

    def train_loader(epoch: int, start: int = 0):
        return wrap(BatchLoader(train_ds, local_bs, epoch=epoch,
                                seed=cfg.seed, shuffle=True,
                                max_len=cfg.seq_len, start=start, **shard))

    def eval_loader(epoch: int):
        return wrap(BatchLoader(eval_ds, local_bs, epoch=0,
                                seed=cfg.seed, shuffle=False,
                                max_len=cfg.seq_len, pad_last=True, **shard))

    steps = len(BatchLoader(train_ds, local_bs, **shard))
    return train_loader, eval_loader, max(steps, 1)


def run_training(cfg: TrainConfig, params=None, device=None,
                 log: Callable[[str], None] = print) -> dict:
    """Full training run of the transformer or a ResNet; returns
    {'state', 'history', 'best_acc', 'cfg', 'trainer', 'steps_per_epoch'}.
    ``params``: a JAX-layout parameter tree to start from (seeded
    init from ``cfg.seed`` when None; a ``{"params", "batch_stats"}``
    bundle also sets the amax histories of ``--quant`` or a ResNet's
    running statistics).  Runs on ``cfg.device`` (cuda by default)
    unless ``device`` says otherwise.  ``--distributed`` joins the
    process group (``parallel.initialize_distributed``); in a group
    (joined here or by the caller) the run is one rank of the data mesh
    ``--mesh`` describes: this process trains on its rows of every global
    batch, on ``cuda:LOCAL_RANK``, and logs, plots and writes checkpoints
    on rank 0 only.

    Resilience (``resilience.build_resilience``): with a checkpoint
    cadence the run restores the newest valid step checkpoint when one
    exists, --resume or not (a relaunch after a preemption picks up the
    emergency checkpoint unaided: point --checkpoint_dir at a fresh
    directory for a fresh run); ``--supervise`` runs each attempt under
    ``Supervisor.run`` (a restore point is saved first, so a crash before
    the first cadence save is recoverable: the live state, updated in
    place, cannot serve as one).  The result then also holds
    ``preempted`` and the ``goodput_*`` keys.

    Telemetry (``telemetry.build_telemetry``) and its program table are
    set up before anything loads a kernel library, so the table's
    ``lib:*`` rows and the executable cache (``--executable_cache``) see
    every library the run loads; they close when the run ends, however
    it ends."""
    import torch.distributed as dist

    from faster_distributed_training_tpu_torch.parallel import (
        DataGroup, initialize_distributed, local_device, make_mesh,
        mesh_groups)
    from faster_distributed_training_tpu_torch.parallel.pipeline import (
        build_pipeline_spec)
    from faster_distributed_training_tpu_torch.telemetry import (
        build_telemetry, programs)
    from faster_distributed_training_tpu_torch.utils.profiling import (
        parse_profile_steps)

    missing = unported_training_flags(cfg)
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")
    # a malformed --profile_steps fails before anything is built
    window = parse_profile_steps(cfg.profile_steps)
    if cfg.data_path == "stream":
        # JAX's refusals: the window reads the on-disk format, over its
        # whole index space
        if cfg.dataset != "stream":
            raise ValueError(
                f"--data_path stream reads the sharded on-disk format; use "
                f"--dataset stream --stream_dir <dir> (got dataset="
                f"{cfg.dataset!r}; python -m faster_distributed_training_"
                f"tpu_torch.data.stream.shard writes one)")
        if cfg.subset_stride > 1:
            raise ValueError("--subset_stride is not supported with "
                             "--data_path stream (the window refill "
                             "addresses the full on-disk index space); "
                             "shard a smaller dataset instead")
    # pp: JAX's refusals (a model with no staged form) before anything
    # is built
    pipeline = build_pipeline_spec(cfg, (cfg.mesh_axes, cfg.mesh_shape))
    dev = resolve_device(device if device is not None else cfg.device)
    if cfg.distributed:
        initialize_distributed(dev.type)
    mesh = make_mesh(cfg.mesh_axes, cfg.mesh_shape, dev.type)
    group, tp = (mesh_groups(mesh) if mesh is not None
                 else (DataGroup(), None))
    if group.live and dev.type == "cuda" and dev.index is None:
        dev = local_device("cuda")
    rank0 = not group.live or dist.get_rank() == 0
    if not rank0:
        log = _silent
    # telemetry (None under --no_telemetry / FDT_TELEMETRY=0) and its
    # program table, with the executable cache armed on it through the
    # run's storage backend: the process-global observatory every library
    # loader reads
    telemetry = build_telemetry(cfg, log=log)
    prev_observatory = None
    if telemetry is not None and telemetry.observatory is not None:
        prev_observatory = programs.set_observatory(telemetry.observatory)
    try:
        return _train(cfg, params, dev, mesh, group, tp, rank0, pipeline,
                      window, telemetry, log)
    finally:
        if telemetry is not None:
            # the program table merged into the manifest, the tail
            # flushed, pod_summary.json refreshed; the observatory given
            # back
            telemetry.close()
            programs.set_observatory(prev_observatory)


def _train(cfg: TrainConfig, params, dev, mesh, group, tp, rank0: bool,
           pipeline, window, telemetry, log) -> dict:
    """``run_training``'s run, from the data on: the model, the state,
    the resilience bundle, the Trainer and its attempts."""
    from faster_distributed_training_tpu_torch.interop import load_jax_tree
    from faster_distributed_training_tpu_torch.optim import (build_optimizer,
                                                             layouts_of)
    import torch.distributed as dist

    from faster_distributed_training_tpu_torch.parallel import (
        Placement, dp_size, shard_train_state)
    from faster_distributed_training_tpu_torch.train.checkpoint import (
        restore_newest)
    from faster_distributed_training_tpu_torch.train.loop import Trainer
    from faster_distributed_training_tpu_torch.train.state import (
        create_train_state)
    from faster_distributed_training_tpu_torch.train.steps import (
        make_eval_step, make_train_step, mixup_alpha, step_draws)

    from faster_distributed_training_tpu_torch.parallel.pipeline import (
        pipeline_rules)

    from faster_distributed_training_tpu_torch.resilience import (
        Preempted, Supervisor, build_resilience)
    from faster_distributed_training_tpu_torch.resilience.faults import (
        apply_corrupt_shard_fault)
    from faster_distributed_training_tpu_torch.train import loop as loop_mod
    from faster_distributed_training_tpu_torch.train.metrics import (
        attach_goodput)

    from faster_distributed_training_tpu_torch.telemetry import (
        flight, resolve_telemetry_dir, spans, write_manifest)
    from faster_distributed_training_tpu_torch.utils.profiling import (
        StepWindowProfiler, trace_profile)

    world = dp_size(mesh)
    resnet = is_resnet(cfg)
    from faster_distributed_training_tpu_torch.runtime import native_lib
    native_lib.report(log)
    if cfg.dataset == "stream" and cfg.stream_dir:
        # the damage is on disk before the reader first touches the shard
        apply_corrupt_shard_fault(cfg.stream_dir, log=log)
    train_ds = load_dataset(cfg, train=True)
    reader = train_ds if hasattr(train_ds, "on_quarantine") else None
    if cfg.dataset == "stream":
        cfg = check_stream_corpus(cfg, train_ds, log)
    train_ds = apply_subset(train_ds, cfg.subset_stride)
    eval_ds = apply_subset(load_dataset(cfg, train=False), cfg.subset_stride)
    gen = torch.Generator().manual_seed(cfg.seed)
    sp = group.seq
    model = build_model(cfg, vocab_size=None if resnet
                        else train_ds.vocab_size(), device=dev, tp=tp, sp=sp)
    if params is not None:
        load_jax_tree(model, params)
    else:
        model.init_weights(gen)
    model.to(dev)
    local_bs = cfg.batch_size // world
    extra = {}
    if resnet:
        extra = resnet_extra_leaves(cfg, gen)
        if dev.type == "cuda":
            # cuDNN's NHWC kernels for the bf16 convs
            model.to(memory_format=torch.channels_last)
    elif params is None:
        # the JAX init's training forward on a zero batch (seeds the
        # --quant amax histories; a no-op without quant); this rank's
        # rows, the amaxes over the global batch
        draws = step_draws(cfg.seed, 0, cfg.batch_size,
                           model.n_dropout_sites(), mixup_alpha(cfg))
        with group.active():
            model.seed_amax_histories(local_bs, cfg.seq_len, dataclasses.replace(
                draws, b0=group.origin(local_bs)))
    train_loader, eval_loader, steps_per_epoch = make_loaders(
        cfg, train_ds, eval_ds, dp=world, rank=group.rank, group=group)
    if cfg.supervise and not (cfg.checkpoint_every
                              or cfg.checkpoint_every_secs):
        # a supervisor without restore points could only replay from the
        # start: one step-cadence save an epoch
        cfg = cfg.replace(checkpoint_every=steps_per_epoch)
        log(f"[resilience] --supervise without a checkpoint cadence: "
            f"defaulting --checkpoint_every to {steps_per_epoch} "
            f"(one save per epoch)")
    cfg, dispatch = build_dispatch(cfg, train_ds, dev, log, group,
                                   reader=reader)
    stream = (dispatch.resident if dispatch is not None and getattr(
        dispatch.resident, "program_key", None) == "stream" else None)
    if stream is not None:
        # the window's refills read (and screen) the stream's reader
        reader = stream.dataset
    res = build_resilience(cfg, log=log,
                           clock=lambda: loop_mod.cadence_clock())
    if res is not None and reader is not None:
        # a shard that fails its checksum: the sentinel's ledger and
        # counter, or the counter alone
        reader.on_quarantine = (
            res.sentinel.quarantine_shard if res.sentinel is not None
            else lambda s, p: res.goodput.count("quarantined_shards"))
    if (dispatch is not None and dispatch.resident is not None
            and getattr(dispatch.resident, "upload_checksums", None)
            and (cfg.sentinel or "none") == "full"):
        log("[sentinel] device-resident upload verified: post-upload "
            "readback matches the host-side encode checksums")
    # the learning rate scales with the data-parallel world (JAX's
    # lr_scale=dp_size(mesh))
    tx, _ = build_optimizer(cfg, steps_per_epoch, lr_scale=float(world),
                            layouts=layouts_of(model))
    state = create_train_state(
        model, tx, cfg.seed, extra={n: t.to(dev) for n, t in extra.items()})
    if group.live:
        state.placement = Placement(cfg, mesh, dev, group, tp)
        shard_train_state(state, state.placement)
        log(f"[mesh] {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} "
            f"over {dist.get_world_size()} process(es) "
            f"({dist.get_backend()}): batch "
            f"{cfg.batch_size} = {world} x {local_bs}, "
            + ("fsdp" if cfg.fsdp else "zero1" if cfg.zero1 else "dp")
            + (f", tp={tp.size} (heads, the FFN's d_ff and the vocab "
               f"split; optimizer state "
               + ("ZeRO-sharded over tp)" if cfg.zero_opt
                  else "replicated over tp)") if tp is not None else "")
            + (f", sp={sp.size} ({cfg.seq_len // sp.size} of {cfg.seq_len} "
               f"positions a rank; attention "
               f"{model.layers[0].attn.attention_impl}; state replicated "
               f"over sp)" if sp is not None else "")
            + (f", pp={group.pipe.size} (stage {group.pipe.stage}; "
               + ("each stage's layers and their optimizer state on their "
                  "stage" if cfg.pp_residency else
                  "every leaf on every stage: --no_pp_residency")
               + f"; {state.placement.resident_bytes(state) / 2**20:.1f} "
               f"MiB at rest on rank 0)" if group.pipe is not None else "")
            + (", params + optimizer state on the host between steps"
               if cfg.host_offload else
               ", big optimizer leaves on the host between steps"
               if cfg.offload_opt_state else "")
            + (f", gradients reduced in {cfg.overlap_bucket_mb} MB buckets"
               if cfg.overlap_grad_reduce else ""))
    if pipeline is not None:
        log(f"[pipeline] pp={pipeline.n_stages} stages x "
            f"{pipeline.n_microbatches} microbatches "
            f"({pipeline.schedule}): layers "
            f"{[list(s) for s in pipeline.stage_layers]}, "
            f"bubble {pipeline.bubble_pct:.1f}% "
            f"({pipeline.n_ticks} ticks/step; stage boundary = a "
            f"send / receive between the ranks of neighbouring chunks)")
        if cfg.debug:
            log("[pipeline] rules "
                + json.dumps(pipeline_rules(pipeline, cfg), sort_keys=True))
    ckpt_name = "resnet" if resnet else "transformer"
    trainer = Trainer(cfg, make_train_step(cfg), make_eval_step(cfg), dev,
                      log=log, dispatch=dispatch, resilience=res)
    if resnet:
        from faster_distributed_training_tpu_torch.train.steps import (
            resolve_mixup_mode)
        opt = cfg.optimizer or ("ngd" if cfg.use_ngd else "madgrad")
        what = (f"{cfg.model} on {dev.type}: {cfg.precision}, optimizer "
                f"{opt}, mixup {resolve_mixup_mode(cfg)}")
    else:
        what = (f"{cfg.model}"
                + (" next-token LM (tied head" if model.tie_lm_head else
                   " next-token LM (untied head" if model.lm else "")
            + ((", causal)" if model.causal else ")") if model.lm else "")
                + f" on {dev.type}: {cfg.n_layers} layers, d_model "
                f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.precision}, "
                f"attention {model.layers[0].attn.attention_impl}, ffn "
                f"{cfg.ffn_impl}, quant {cfg.quant or 'none'}"
                + (f" (grads {cfg.quant_grad})"
                   if (cfg.quant_grad or "none") != "none" else ""))
    log(f"[train] {what}, {steps_per_epoch} steps/epoch x {cfg.epochs} "
        f"epochs, batch {cfg.batch_size}")
    manager = res.manager if res is not None else None
    state, start_epoch = trainer.maybe_resume(state, ckpt_name)
    # the epoch checkpoint --resume restored: a step checkpoint replaces
    # it on the first attempt only when newer
    resumed_step = int(state.step) if start_epoch else -1

    def attempt(restart_index: int):
        """One training attempt (JAX ``cli.py``'s): from the newest valid
        step checkpoint when there is one (the manager's walk, --resume or
        not; without a manager, with --resume, the same walk,
        ``checkpoint.restore_newest``), restored into the live state
        (every leaf: a crash may have left an update half done), else
        from where ``maybe_resume`` left it."""
        st, ep, sie = state, start_epoch, 0
        newer_than = resumed_step if restart_index == 0 else -1
        prev_step = trainer.global_step
        got = None
        if manager is not None:
            got = manager.restore_latest(st, newer_than)
        elif cfg.resume:
            got = restore_newest(cfg.checkpoint_dir, f"{ckpt_name}_step", st,
                                 newer_than=newer_than, log=log)
            got = None if got is None else got[:2]
        if got is not None:
            st, meta = got
            ep = int(meta.get("epoch", 0))
            sie = int(meta.get("step_in_epoch", 0))
            trainer.best_acc = float(meta.get("best_acc", trainer.best_acc))
            step = int(meta.get("step", 0))
            log(f"[resume] restored step-cadence checkpoint: step {step} "
                f"(epoch {ep}, batch {sie})")
            if restart_index > 0 and prev_step > step:
                # the steps the rollback re-runs, at the run's productive
                # step time
                s = res.goodput.summary()
                if s["steps"]:
                    res.goodput.add("rollback_lost_s",
                                    (prev_step - step)
                                    * s["productive_s"] / s["steps"])
        elif manager is not None and cfg.supervise and restart_index == 0:
            # the restore point a crash before the first cadence save
            # returns to
            manager.save(st, int(st.step), epoch=ep, step_in_epoch=sie,
                         best_acc=trainer.best_acc)
        return trainer.fit(st, train_loader, eval_loader,
                           ckpt_name=ckpt_name, start_epoch=ep,
                           start_step_in_epoch=sie)

    # the telemetry's sinks, set up where the try below gives them back:
    # the span sink, the flight recorder's target, the manifest (process
    # 0), the pipeline's schedule events, goodput's event sink and the
    # program table's goodput (billed every acquisition, those before
    # this too)
    prev_span_recorder = prev_flight = None
    if telemetry is not None:
        if telemetry.pi == 0:
            write_manifest(telemetry.directory, cfg, mesh_sizes(cfg, mesh),
                           device=dev, process_count=telemetry.pc,
                           extra={"steps_per_epoch": steps_per_epoch,
                                  "workload": ckpt_name,
                                  "pipeline": pipeline_rules(pipeline,
                                                             cfg)})
        prev_span_recorder = spans.set_recorder(telemetry.recorder)
        prev_flight = flight.configure(
            telemetry.directory,
            backend=res.backend if res is not None else None,
            goodput=res.goodput if res is not None else None, log=log)
        if pipeline is not None:
            record_pipeline(telemetry.recorder, pipeline)
        if res is not None:
            res.goodput.set_event_sink(telemetry.recorder.goodput_event_sink)
            if telemetry.observatory is not None:
                telemetry.observatory.goodput = res.goodput
        log(f"[telemetry] recording to {telemetry.directory} "
            f"(host {telemetry.pi}/{telemetry.pc}; disable with "
            f"--no_telemetry or FDT_TELEMETRY=0)")
    profiler = None
    if window is not None:
        trace_dir = os.path.join(resolve_telemetry_dir(cfg),
                                 f"trace_steps_{window[0]}_{window[1]}")
        profiler = StepWindowProfiler(trace_dir, *window, log=log)
        log(f"[profile] windowed capture armed: global steps "
            f"{window[0]}..{window[1]} -> {trace_dir}")
    trainer.telemetry, trainer.profiler = telemetry, profiler
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    if resnet and dev.type == "cuda":
        # conv algorithms without atomics, autotuned: two identical steps
        # are bitwise equal; the process's own flags come back after
        cudnn.deterministic, cudnn.benchmark = True, True
    preempted = False
    try:
        # --profile: the whole run's trace under the telemetry directory
        with trace_profile(os.path.join(resolve_telemetry_dir(cfg), "profile")
                           if cfg.profile else None, log=log):
            if res is not None and cfg.supervise:
                sup = Supervisor(max_restarts=cfg.max_restarts,
                                 goodput=res.goodput, log=log,
                                 coordinator=res.coordinator)
                state = sup.run(attempt,
                                progress=lambda: trainer.global_step)
            else:
                state = attempt(0)
    except Preempted as p:
        preempted = True
        if p.state is not None:
            state = p.state
        log(f"[preempt] training stopped cleanly at step {p.step}; "
            f"re-launch with the same --checkpoint_dir to resume")
    except BaseException as e:
        # the run dies for good: the flight dump first (one an exception:
        # one the supervisor already wrote is not written again)
        flight.emergency_dump("unhandled_exception", exc=e,
                              step=trainer.global_step)
        raise
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
        if res is not None:
            # the write in flight drains, the signal handlers go back
            res.close()
        if profiler is not None:
            profiler.close()   # an open window is still captured
        if telemetry is not None:
            # the process's sinks given back (run_training closes the
            # telemetry itself)
            spans.set_recorder(prev_span_recorder)
            flight.restore(prev_flight)
    if state.placement is not None:
        state.placement.unshard(state)     # the caller gets the whole state
    if cfg.plot and trainer.history["test_acc"] and rank0:
        plot_history(trainer.history, ckpt_name, log)
    out = {"state": state, "history": trainer.history,
           "best_acc": trainer.best_acc, "cfg": cfg, "trainer": trainer,
           "steps_per_epoch": steps_per_epoch}
    if res is not None:
        out["preempted"] = preempted
        out["resilience"] = res
        attach_goodput(out, res.goodput)
    if telemetry is not None:
        out["telemetry_dir"] = telemetry.directory
    if profiler is not None:
        out["profiler"] = profiler
    if stream is not None:
        out["stream"] = stream
        if trainer.stream_stall_pct is not None:
            # the streamed input path's headline: the steady state's
            # share of step time blocked on the window
            out["stream_stall_pct"] = round(trainer.stream_stall_pct, 3)
            log(f"[stream] steady-state stall: {out['stream_stall_pct']}% "
                f"of step time ({stream.refills} refills, read "
                f"{stream.read_s:.3f}s, H2D {stream.h2d_s:.3f}s)")
    return out


def mesh_sizes(cfg: TrainConfig, mesh) -> dict:
    """The run's mesh as ``{axis: size}`` (the manifest's ``mesh``): the
    process group's mesh, or without a group the axes ``--mesh`` names at
    the sizes one process gives them."""
    from faster_distributed_training_tpu_torch.parallel.mesh import (
        canonical_axes, ordered_axes)

    if mesh is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    axes = canonical_axes(cfg.mesh_axes)
    shape = tuple(cfg.mesh_shape) or (1,) * len(axes)
    return dict(zip(*ordered_axes(axes, shape)))


def record_pipeline(recorder, spec) -> None:
    """The pipeline's schedule into the stream (JAX ``cli.py:1097-1117``):
    one ``pp_bubble`` with the schedule's bubble, one ``pp_stage`` a
    stage with its layers and its idle / active slot-ticks."""
    from faster_distributed_training_tpu_torch.parallel.pipeline import (
        stage_idle_ticks)

    recorder.record_event(
        "pp_bubble", n_stages=spec.n_stages,
        n_microbatches=spec.n_microbatches, n_ticks=spec.n_ticks,
        schedule=spec.schedule, bubble_pct=round(spec.bubble_pct, 3))
    for s, idle in enumerate(stage_idle_ticks(spec)):
        recorder.record_event(
            "pp_stage", stage=s,
            layers=[f"layer_{i}" for i in spec.stage_layers[s]],
            idle_ticks=idle,
            # slot-ticks, as idle_ticks: M a slot x V / S slots a stage
            active_ticks=spec.n_microbatches
            * (spec.n_virtual // spec.n_stages))


def round_checkpoint_every(cfg: TrainConfig, log) -> TrainConfig:
    """Under K steps a dispatch checkpoints land on dispatch boundaries:
    ``--checkpoint_every`` rounds up to a multiple of K, with the JAX
    package's warning and log line."""
    k = max(int(cfg.steps_per_dispatch or 1), 1)
    if k > 1 and cfg.checkpoint_every and cfg.checkpoint_every % k:
        import warnings

        rounded = -(-cfg.checkpoint_every // k) * k
        warnings.warn(
            f"--checkpoint_every {cfg.checkpoint_every} is not a multiple "
            f"of --steps_per_dispatch {k}; rounding up to {rounded} "
            f"(checkpoints land on dispatch boundaries)", stacklevel=3)
        log(f"[ckpt] checkpoint_every rounded {cfg.checkpoint_every} -> "
            f"{rounded} (multiple of steps_per_dispatch={k})")
        cfg = cfg.replace(checkpoint_every=rounded)
    return cfg


def _silent(line: str) -> None:
    """The log of a rank other than 0."""


def build_dispatch(cfg: TrainConfig, train_ds, dev, log, group=None,
                   reader=None):
    """(cfg, FusedDispatch or None): K steps a dispatch when
    ``--steps_per_dispatch`` > 1, ``--data_path resident`` (the resident
    split uploaded here, in the layout ``--resident_layout`` resolves to
    over the data ``group``) or ``--data_path stream`` (the window over
    ``reader``, the open stream dataset, allocated here); None keeps the
    one-step loop."""
    from faster_distributed_training_tpu_torch.data.device_resident import (
        ShardedDeviceResidentData, build_device_resident)
    from faster_distributed_training_tpu_torch.data.stream import (
        build_stream)
    from faster_distributed_training_tpu_torch.train.dispatch import (
        FusedDispatch)

    k = max(int(cfg.steps_per_dispatch or 1), 1)
    cfg = round_checkpoint_every(cfg, log)
    world = 1 if group is None else group.world
    rank = 0 if group is None else group.rank
    resident = build_stream(cfg, dev, dataset=reader, process_index=rank,
                            process_count=world)
    if resident is not None:
        log(f"[data] streaming train split from disk: {resident.n} samples "
            f"({resident.dataset.nbytes_on_disk / 1e6:.0f} MB on disk, "
            f"{len(resident.dataset.manifest['shards'])} shard(s)), window "
            f"2 x {resident.window} batches on {dev.type} "
            f"({resident.device_bytes / 1e6:.1f} MB, pinned staging "
            f"{resident.pinned_bytes / 1e6:.1f} MB), "
            f"{resident.steps_per_epoch} steps/epoch"
            + (f", seq_len={resident.seq_len}" if resident.is_text else ""))
    else:
        resident = build_device_resident(cfg, train_ds, dev, world, group)
    if isinstance(resident, ShardedDeviceResidentData):
        log(f"[data] device-resident train split (sharded): {resident.n} "
            f"samples, {resident.rows} rows a rank "
            f"({resident.nbytes / 1e6:.3f} MB at rest on rank "
            f"{resident.pi} of {resident.pc}; the epoch view "
            f"{resident.view_bytes / 1e6:.3f} MB, re-sharded once an "
            f"epoch by one all-to-all), {resident.steps_per_epoch} "
            f"steps/epoch"
            + (f", seq_len={resident.seq_len}" if resident.is_text else ""))
    elif resident is not None and not resident.batch_major:
        log(f"[data] device-resident train split (replicated): "
            f"{resident.n} samples, {resident.nbytes / 1e6:.0f} MB on "
            f"{dev.type}, {resident.steps_per_epoch} steps/epoch"
            + (f", seq_len={resident.seq_len}" if resident.is_text else ""))
    if getattr(resident, "verify_upload", lambda: False)():
        log("[data] device-resident upload verified against its "
            "encode-time CRC32s")
    if k == 1 and resident is None:
        return cfg, None
    log(f"[dispatch] {k} step(s) a dispatch on {dev.type}"
        + (": the step captured once as a CUDA graph and replayed"
           if dev.type == "cuda" else ": the step body in a loop"))
    return cfg, FusedDispatch(cfg, k, dev, resident=resident, log=log,
                              group=group if world > 1 else None)


def resnet_extra_leaves(cfg: TrainConfig, gen: torch.Generator) -> dict:
    """The trainable leaves beside a ResNet: the meta mode's per-sample
    lambda (batch, 1, 1, 1) or the attn mode's NHWC lambda map, drawn
    from ``gen``; none for the other modes."""
    from faster_distributed_training_tpu_torch.train.mixup import (
        init_attn_lambda, init_meta_lambda)
    from faster_distributed_training_tpu_torch.train.steps import (
        resolve_mixup_mode)

    mode = resolve_mixup_mode(cfg)
    if mode == "meta":
        return {"mixup_lambda": init_meta_lambda(gen, cfg.batch_size)}
    if mode == "attn":
        return {"mixup_lambda": init_attn_lambda(gen, cfg.batch_size, 32,
                                                 32, 3)}
    return {}


def plot_history(history: dict, prefix: str, log=print) -> list:
    """``<prefix>_accuracy.png`` and ``<prefix>_time.png`` in the working
    directory (the JAX ``run_training``'s curves after training).  A plot
    is a report, not a result: without matplotlib one line says so and
    the run goes on."""
    from faster_distributed_training_tpu_torch.utils.plotting import (
        draw_graph)

    try:
        return [draw_graph(history["test_acc"], "test accuracy",
                           f"{prefix} test accuracy",
                           f"{prefix}_accuracy.png"),
                draw_graph(history["epoch_time"], "seconds",
                           f"{prefix} epoch time", f"{prefix}_time.png")]
    except ImportError:
        log("[plot] matplotlib is not installed: no PNGs written")
        return []


def main(argv=None, defaults: Optional[TrainConfig] = None,
         prog: str = "fdt") -> dict:
    """The training CLI: the JAX package's flag surface."""
    parser = build_parser(prog=prog, defaults=defaults)
    cfg = config_from_args(parser.parse_args(argv), defaults=defaults)
    return run_training(cfg)


def synth_requests(n: int, vocab: int, buckets, seed: int = 0,
                   min_len: int = 4):
    """Ragged synthetic request mix: ``n`` token arrays with lengths
    uniform over [min_len, max bucket] (the JAX package's generator, same
    numpy draws)."""
    rng = np.random.default_rng(seed)
    top = max(buckets)
    out = []
    for _ in range(int(n)):
        length = int(rng.integers(min_len, top + 1))
        out.append(rng.integers(1, max(int(vocab), 2),
                                size=length).astype(np.int32))
    return out


def run_serving(cfg: TrainConfig, requests=None, params=None, device=None,
                log: Callable[[str], None] = print) -> dict:
    """Load the weights (``params``, a JAX-layout tree, or the ``.npz``
    under ``cfg.checkpoint_dir``), stand up the serve/ stack — one warmed
    engine per replica, the continuous-batching queue, replicas with
    heartbeat liveness — push ``requests`` (ragged int32 token arrays; a
    synthetic mix of ``cfg.serve_requests`` when None) through it, and
    return results plus the latency/throughput summary.  Replicas are one
    per visible card on CUDA (``--serve_replicas`` overrides), one on
    the CPU."""
    import copy

    from faster_distributed_training_tpu_torch.serve import (
        BatchScheduler, InferenceEngine, Replica, ReplicaSet, RequestQueue,
        load_serving_state)
    from faster_distributed_training_tpu_torch.telemetry import spans

    dev = resolve_device(device if device is not None else cfg.device)
    devs = ([torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
            if dev.type == "cuda" else [dev])
    if dev.index is not None:
        devs = [dev]
    tel = _serving_telemetry(cfg, "serve", log)
    recorder = tel[0]
    try:
        model, sstate, meta = load_serving_state(cfg, devs[0], params=params,
                                                 log=log)
        q = RequestQueue(cfg.seq_buckets, max_len=cfg.seq_len)
        buckets = q.buckets
        n_rep = int(cfg.serve_replicas) or len(devs)
        models = {devs[0]: model}
        engines = []
        for i in range(n_rep):
            d = devs[i % len(devs)]
            if d not in models:
                models[d] = copy.deepcopy(model).to(d)
            engines.append(InferenceEngine(models[d], cfg.serve_batch_size,
                                           buckets, device=d,
                                           name=f"replica{i}"))
        chips_serving = min(n_rep, len(devs)) if dev.type == "cuda" else 0
        with spans.span("serve_warmup"):
            warm_s = sum(e.warmup() for e in engines)
        log(f"[serve] {len(engines)} replica(s) x {len(buckets)} bucket(s) "
            f"warmed in {warm_s:.1f}s on {dev.type} (buckets {list(buckets)}, "
            f"batch {cfg.serve_batch_size})")
        replicas = [Replica(e.name, e, log=log) for e in engines]
        rset = ReplicaSet(replicas,
                          heartbeat_timeout_s=cfg.serve_heartbeat_timeout_s,
                          readmit_after_s=cfg.serve_readmit_s, log=log)
        sched = BatchScheduler(q, rset, batch_size=cfg.serve_batch_size,
                               max_delay_ms=cfg.serve_max_delay_ms,
                               recorder=recorder, log=log)
        sched.start()
        try:
            if requests is None:
                requests = synth_requests(cfg.serve_requests, meta["vocab"],
                                          buckets, seed=cfg.seed)
            handles = [q.submit(t) for t in requests]
            results = [h.wait(timeout=300.0) for h in handles]
        finally:
            sched.close()
        summary = sched.summary()
        out = {"results": results, "meta": meta, "cfg": cfg, "state": sstate,
               "engines": engines, "replicas": rset.stats(), **summary,
               "buckets": [h.bucket for h in handles],
               "warmup_s": round(warm_s, 3), "device": dev.type,
               "chips_serving": chips_serving,
               "qps_per_chip": round(summary["qps"] / max(chips_serving, 1),
                                     2)}
        if recorder is not None:
            out["telemetry_dir"] = recorder.directory
        log(f"[serve] served {summary['requests']} requests in "
            f"{summary['batches']} batches ({summary['padded_rows']} pad "
            f"rows): p50 {summary['p50_ms']} ms, p99 {summary['p99_ms']} "
            f"ms, {summary['qps']} qps")
        return out
    finally:
        _close_serving_telemetry(*tel, log=log)


def _serving_telemetry(cfg: TrainConfig, section: str, log) -> tuple:
    """(recorder, the span sink it replaces, the program table, the
    observatory it replaces, section) of a serving entry point, all None
    but ``section`` with telemetry off: the recorder in the run's
    telemetry directory, installed as the span sink, ``section`` (this
    run's config) merged into the manifest, never replacing a training
    run's (JAX ``cli.py:1366-1392``), and the serving run's own
    observatory with ``--executable_cache`` armed, installed before the
    weights load (JAX ``cli.py:1383-1407``)."""
    import time as time_mod

    from faster_distributed_training_tpu_torch.telemetry import (
        TelemetryRecorder, build_observatory, enabled, programs,
        resolve_telemetry_dir, spans, update_manifest)

    if not enabled(cfg):
        return None, None, None, None, section
    tdir = resolve_telemetry_dir(cfg)
    recorder = TelemetryRecorder(tdir, log=log)
    update_manifest(tdir, {section: {
        "unix_time": round(time_mod.time(), 3),
        "config": dataclasses.asdict(cfg)}}, log=log)
    prev = spans.set_recorder(recorder)
    obs = build_observatory(cfg, recorder, log)
    prev_obs = programs.set_observatory(obs) if obs is not None else None
    log(f"[{section.split('_')[0]}] telemetry recording to {tdir}")
    return recorder, prev, obs, prev_obs, section


def _close_serving_telemetry(recorder, prev_rec, obs, prev_obs, section: str,
                             log) -> None:
    """Give the sinks back; the program table goes into the manifest
    under its own key (``serve_compile``, ``decode_compile``: a training
    run's ``compile`` stays), then the recorder closes."""
    from faster_distributed_training_tpu_torch.telemetry import (
        programs, spans, update_manifest)

    if recorder is None:
        return
    spans.set_recorder(prev_rec)
    if obs is not None:
        programs.set_observatory(prev_obs)
        key = ("decode_compile" if section.startswith("decode")
               else "serve_compile")
        update_manifest(recorder.directory, {key: obs.summary()}, log=log)
    recorder.close()


def main_serve(argv=None, defaults: Optional[TrainConfig] = None,
               prog: str = "fdt-serve") -> dict:
    """The serve CLI: the JAX package's flag surface; reads the
    parameters under ``--checkpoint_dir`` and pushes a synthetic ragged
    request mix through the serving stack.  Returns the numbers, not the
    tensors."""
    defaults = defaults or TRANSFORMER_DEFAULTS
    parser = build_parser(prog=prog, defaults=defaults)
    cfg = config_from_args(parser.parse_args(argv), defaults=defaults)
    out = run_serving(cfg)
    for heavy in ("results", "state", "cfg", "engines"):
        out.pop(heavy, None)
    return out


def run_decode_serving(cfg: TrainConfig, prompts=None, params=None,
                       device=None, log: Callable[[str], None] = print
                       ) -> dict:
    """Generation from a ``--task lm`` checkpoint (JAX ``cli.py:1488``):
    load the weights (``params``, a JAX-layout tree, or the ``.npz``
    under ``cfg.checkpoint_dir``), stand up the decode stack (paged KV
    cache, prefill, the decode step as a CUDA graph a page count on the
    card, slot-granular continuous batching), push ``prompts`` (ragged
    int32 token arrays; ``cfg.decode_requests`` synthetic ones when None)
    through it with a ``cfg.decode_max_new_tokens`` budget each, and
    return the generated tokens and the TTFT / latency / throughput
    summary under the JAX package's keys.  One replica a card (``--
    decode_replicas`` 0: ``torch.cuda.device_count()``), one on the CPU,
    all draining one queue.  The multi-process front door
    (``serve.decode.FrontDoor``) runs this wiring in each worker."""
    import copy

    from faster_distributed_training_tpu_torch.models.decode import (
        QUANTIZED, UNFUSED, SamplingCfg)
    from faster_distributed_training_tpu_torch.parallel.mesh import (
        canonical_axes)
    from faster_distributed_training_tpu_torch.serve import (
        RequestQueue, load_serving_state)
    from faster_distributed_training_tpu_torch.serve.decode import (
        DecodeEngine, DecodeScheduler)
    from faster_distributed_training_tpu_torch.telemetry import spans
    from faster_distributed_training_tpu_torch.train.metrics import (
        percentiles)

    sizes = dict(zip(canonical_axes(cfg.mesh_axes), cfg.mesh_shape))
    model_axes = [f"{ax}={int(sizes[ax])}" for ax in ("tp", "sp", "pp")
                  if int(sizes.get(ax, 1)) > 1]
    if model_axes:
        raise NotImplementedError(
            f"not ported yet: decode serving under a model axis (--mesh "
            f"{','.join(model_axes)}: JAX's one model-sharded replica)")
    if (cfg.quant or "none") != "none":
        raise ValueError(QUANTIZED)
    if cfg.tricks == "off":
        raise ValueError(UNFUSED)
    tel = _serving_telemetry(cfg, "decode_serve", log)
    recorder = tel[0]
    try:
        dev = resolve_device(device if device is not None else cfg.device)
        devs = ([torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
                if dev.type == "cuda" else [dev])
        if dev.index is not None:
            devs = [dev]
        model, sstate, meta = load_serving_state(cfg, devs[0], params=params,
                                                 log=log)
        q = RequestQueue(cfg.seq_buckets, max_len=cfg.seq_len)
        buckets = q.buckets
        sampling = SamplingCfg(method=cfg.decode_sample,
                               temperature=cfg.decode_temperature,
                               top_k=cfg.decode_top_k, seed=cfg.seed)
        n_rep = int(cfg.decode_replicas) or len(devs)
        models = {devs[0]: model}
        engines = []
        for i in range(n_rep):
            d = devs[i % len(devs)]
            if d not in models:
                models[d] = copy.deepcopy(model).to(d)
            engines.append(DecodeEngine(models[d], buckets,
                                        batch_size=cfg.decode_batch_size,
                                        page=cfg.decode_page,
                                        max_pages=cfg.decode_max_pages,
                                        sampling=sampling, name=f"decode{i}"))
        chips_serving = min(n_rep, len(devs)) if dev.type == "cuda" else 0
        with spans.span("decode_warmup"):
            warm_s = sum(e.warmup() for e in engines)
        log(f"[decode] {len(engines)} replica(s) x ({len(buckets)} prefill "
            f"bucket(s) + {engines[0].max_pages} decode page counts"
            + (", a CUDA graph each" if dev.type == "cuda" else ", eager")
            + f") warmed in {warm_s:.1f}s on {dev.type} (buckets "
            f"{list(buckets)}, page {cfg.decode_page}, "
            f"{cfg.decode_batch_size} slots, {cfg.decode_sample})")
        scheds = [DecodeScheduler(q, e, max_delay_ms=cfg.serve_max_delay_ms,
                                  max_new_tokens=cfg.decode_max_new_tokens,
                                  recorder=recorder, name=e.name)
                  for e in engines]
        for s in scheds:
            s.start()
        try:
            if prompts is None:
                prompts = synth_requests(cfg.decode_requests, meta["vocab"],
                                         buckets, seed=cfg.seed)
            handles = [q.submit(t, max_new_tokens=cfg.decode_max_new_tokens)
                       for t in prompts]
            results = [h.wait(timeout=300.0) for h in handles]
        finally:
            q.close()
            for s in scheds:
                s.close()
        # one summary over the union of the schedulers' samples (percentiles
        # of the whole population, not a mean of per-replica percentiles)
        ttft, total = [], []
        n_req = toks = steps = prefills = 0
        t_first, t_last = None, None
        for s in scheds:
            ttft += [t for t in s.ttft_ms if t is not None]
            total += [t for t in s.total_ms if t is not None]
            n_req += s.completed_requests
            toks += s.generated_tokens
            steps += s.engine.steps
            prefills += s.engine.prefills
            if s._t_first is not None:
                t_first = s._t_first if t_first is None \
                    else min(t_first, s._t_first)
            if s._t_last is not None:
                t_last = (s._t_last if t_last is None
                          else max(t_last, s._t_last))
        wall = ((t_last - t_first) if (t_first is not None
                                        and t_last is not None
                                        and t_last > t_first) else 0.0)
        pt = percentiles(ttft, qs=(50, 99))
        pl = percentiles(total, qs=(50, 99))
        tps = round(toks / wall, 2) if wall else 0.0
        out = {"results": results, "meta": meta, "cfg": cfg, "state": sstate,
               "engines": engines, "requests": n_req, "tokens": toks,
               "steps": steps, "prefills": prefills,
               "ttft_p50_ms": pt.get(50, 0.0), "ttft_p99_ms": pt.get(99, 0.0),
               "latency_p50_ms": pl.get(50, 0.0),
               "latency_p99_ms": pl.get(99, 0.0), "tokens_per_sec": tps,
               "chips_serving": chips_serving,
               "tokens_per_sec_per_chip": round(
                   tps / max(chips_serving, 1), 2),
               "warmup_s": round(warm_s, 3), "device": dev.type}
        if recorder is not None:
            out["telemetry_dir"] = recorder.directory
        log(f"[decode] generated {toks} tokens for {n_req} requests in "
            f"{steps} steps ({prefills} prefills): TTFT p50 "
            f"{out['ttft_p50_ms']} ms / p99 {out['ttft_p99_ms']} ms, {tps} "
            f"tok/s "
            f"({out['tokens_per_sec_per_chip']}/chip)")
        return out
    finally:
        _close_serving_telemetry(*tel, log=log)


def main_decode(argv=None, defaults: Optional[TrainConfig] = None,
                prog: str = "fdt-decode") -> dict:
    """The decode CLI (JAX ``cli.py:1700``): the JAX package's flag
    surface; reads a ``--task lm`` checkpoint's parameters under
    ``--checkpoint_dir`` and generates for a synthetic ragged prompt mix.
    Returns the numbers, not the tensors."""
    defaults = defaults or TRANSFORMER_DEFAULTS
    parser = build_parser(prog=prog, defaults=defaults)
    cfg = config_from_args(parser.parse_args(argv), defaults=defaults)
    out = run_decode_serving(cfg)
    for heavy in ("results", "state", "cfg", "engines"):
        out.pop(heavy, None)
    return out


if __name__ == "__main__":
    print(json.dumps(main_serve()))
