"""Entry points of the port: classifier training (slice 2) and serving
(slice 1), with the fused FFN and quantized GEMMs (slice 3: ``--ffn_impl
pallas``, ``--quant int8|fp8``, ``--quant_grad fp8_e5m2``), and the
next-token LM on a sharded stream corpus (slice 4: ``--task lm --dataset
stream --stream_dir D``, host data path).

Counterparts of ``faster_distributed_training_tpu/cli.py``'s
``resolve_attention``, ``build_model``, ``load_dataset`` (the synthetic
and stream branches), ``apply_subset``, ``make_loaders``,
``run_training``, ``main``, ``synth_requests``, ``run_serving`` and
``main_serve``.  Everything runs
on CUDA unless the caller passes ``--device cpu`` / ``device="cpu"``;
``cuda`` without a GPU raises, nothing falls back on its own.

Attention routing does not copy the JAX package's measured TPU surface
(its dense/flash crossover, sequence-parallel threshold and dense
memory budget were all measured on a TPU): on CUDA every shape the
flash kernel takes routes to it; on the CPU the default is dense, as in
the JAX package.  An explicit ``--attention`` always wins (``flash`` on
the CPU runs the kernel's plain version).
"""

from __future__ import annotations

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


def resolve_device(name) -> torch.device:
    """``cuda`` (the default) or ``cpu``; ``cuda`` without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "device; pass --device cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {name!r}: the port runs on cuda or cpu")
    return dev


def resolve_attention(cfg: TrainConfig, device: torch.device) -> str:
    """Explicit ``--attention`` wins; else flash on CUDA wherever the
    kernel takes the head dim, dense otherwise (and on the CPU)."""
    if cfg.attention:
        return cfg.attention
    if (torch.device(device).type == "cuda"
            and cfg.d_model % cfg.n_heads == 0
            and cfg.d_model // cfg.n_heads in HEAD_DIMS):
        return "flash"
    return "dense"


def build_model(cfg: TrainConfig, vocab_size: Optional[int] = None,
                serving: bool = False, device=None):
    """The port's Transformer for ``cfg``.  ``serving=True`` builds the
    inference twin: GEMM weights stored in the compute dtype (the JAX
    model casts its fp32 weights at every call; serving rounds them once
    at load) and, under ``--quant``, the scale state frozen (quantize at
    the restored histories' scales, never roll).  ``--ffn_impl pallas``
    takes the fused FFN kernel at every width the config accepts (the
    JAX package's VMEM go/no-go checks are TPU figures and are not
    copied; a shape the kernel cannot take raises in its wrapper).
    ``--task lm`` builds the next-token LM: the head tied to the token
    table unless ``--untie_lm_head``.  Features the port has not reached
    raise, among them ``--task lm`` with ``--quant`` or ``--ffn_impl
    pallas``."""
    from faster_distributed_training_tpu_torch.models import get_model
    from faster_distributed_training_tpu_torch.ops.quant import (
        warn_if_killed)
    from faster_distributed_training_tpu_torch.train.amp import (
        compute_dtype, resolve_quant_policy)

    if cfg.model != "transformer":
        raise NotImplementedError(f"the port builds the transformer only "
                                  f"so far, not {cfg.model!r}")
    unported = {"--lm_causal": bool(cfg.lm_causal),
                "serving --task lm (decode)": serving and cfg.task == "lm",
                "--task lm with --quant": (cfg.task == "lm" and (
                    cfg.quant or "none") != "none"),
                "--task lm with --ffn_impl pallas": (
                    cfg.task == "lm" and cfg.ffn_impl == "pallas"),
                "--tricks off (unfused qkv)": cfg.tricks == "off",
                "--dropout_impl xla": cfg.dropout_impl == "xla",
                "--remat": bool(cfg.remat),
                "--mesh": any(int(s) > 1 for s in cfg.mesh_shape)}
    missing = [k for k, v in unported.items() if v]
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")
    dtype = compute_dtype(cfg.precision)
    device = torch.device(device if device is not None else cfg.device)
    quant = resolve_quant_policy(cfg)
    if quant is not None:
        warn_if_killed(quant.fmt)
        quant = quant._replace(frozen_scales=bool(serving))
    if cfg.ffn_impl not in ("flax", "pallas"):
        raise ValueError(f"--ffn_impl must be flax or pallas, got "
                         f"{cfg.ffn_impl!r}")
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
                     attention_impl=resolve_attention(cfg, device),
                     ffn_impl=cfg.ffn_impl, quant=quant,
                     lm_head=cfg.task == "lm",
                     tie_lm_head=cfg.task == "lm" and cfg.tie_lm_head,
                     **rates)


def unported_training_flags(cfg: TrainConfig) -> list:
    """The flags of features the training slice does not reach."""
    checks = {
        "--ngd": cfg.use_ngd,
        "--remat": bool(cfg.remat),
        "--steps_per_dispatch > 1": int(cfg.steps_per_dispatch or 1) > 1,
        f"--data_path {cfg.data_path}": cfg.data_path != "host",
        f"--dataset {cfg.dataset}": cfg.dataset not in ("synthetic",
                                                        "stream"),
        "--lm_causal": bool(cfg.lm_causal),
        "--mesh": any(int(s) > 1 for s in cfg.mesh_shape),
        "--distributed": bool(cfg.distributed),
        "--fsdp / --host_offload / --offload_opt_state": bool(
            cfg.fsdp or cfg.host_offload or cfg.offload_opt_state),
        f"--sentinel {cfg.sentinel}": (cfg.sentinel or "none") != "none",
        "--supervise": bool(cfg.supervise),
        "--auto_recover": bool(cfg.auto_recover),
        "--profile_steps": bool(cfg.profile_steps),
        "--precision fp16": cfg.precision == "fp16",
    }
    return [k for k, v in checks.items() if v]


def load_dataset(cfg: TrainConfig, train: bool):
    """A split of ``cfg.dataset``: ``stream``, the sharded on-disk
    dataset under ``--stream_dir`` (its reader speaks ``encode_batch``),
    or ``synthetic``, the AG-News-shaped split (the JAX package's branch:
    4096 train / 1024 test rows, seeds 0 and 1).  Real AG News waits for
    its CSVs in the repository."""
    from faster_distributed_training_tpu_torch.data.stream import (
        open_stream_split)
    from faster_distributed_training_tpu_torch.data.synthetic import (
        synthetic_agnews)

    if cfg.model != "transformer" or cfg.dataset not in ("synthetic",
                                                         "stream"):
        raise NotImplementedError(f"not ported yet: --dataset "
                                  f"{cfg.dataset} for {cfg.model}")
    if cfg.dataset == "stream":
        if not cfg.stream_dir:
            raise ValueError("--dataset stream requires --stream_dir (python "
                             "-m faster_distributed_training_tpu_torch.data."
                             "stream.shard writes one)")
        return open_stream_split(cfg.stream_dir, train=train)
    return synthetic_agnews(n=4096 if train else 1024,
                            seed=0 if train else 1, max_len=cfg.seq_len)


def apply_subset(ds, stride: int):
    """1/N-stride subset of a text dataset (applied to both splits)."""
    if stride <= 1:
        return ds

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
    """The JAX ``run_training``'s checks of a stream corpus: packed LM
    rows carry no labels, so ``--task cls`` on one raises; and the rows
    have one width, which overrides ``--seq_len``."""
    if not train_ds.is_text:
        raise NotImplementedError(f"not ported yet: image stream datasets "
                                  f"({cfg.stream_dir})")
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


def make_loaders(cfg: TrainConfig, train_ds, eval_ds):
    """(train_loader(epoch, start), eval_loader(epoch), steps_per_epoch);
    ``start`` is the epoch's first batch (a mid-epoch resume).  One
    background thread prefetches batches (``--prefetch_depth``; the JAX
    package's ``--workers`` thread pool yields the same order and is not
    ported)."""
    from faster_distributed_training_tpu_torch.data.loader import (
        BatchLoader, PrefetchIterator)

    def wrap(loader):
        if cfg.prefetch_depth <= 0:
            return loader
        return PrefetchIterator(loader, depth=cfg.prefetch_depth)

    def train_loader(epoch: int, start: int = 0):
        return wrap(BatchLoader(train_ds, cfg.batch_size, epoch=epoch,
                                seed=cfg.seed, shuffle=True,
                                max_len=cfg.seq_len, start=start))

    def eval_loader(epoch: int):
        return wrap(BatchLoader(eval_ds, cfg.batch_size, epoch=0,
                                seed=cfg.seed, shuffle=False,
                                max_len=cfg.seq_len, pad_last=True))

    steps = len(BatchLoader(train_ds, cfg.batch_size))
    return train_loader, eval_loader, max(steps, 1)


def run_training(cfg: TrainConfig, params=None, device=None,
                 log: Callable[[str], None] = print) -> dict:
    """Full training run of the transformer classifier; returns
    {'state', 'history', 'best_acc', 'cfg', 'trainer', 'steps_per_epoch'}.
    ``params``: a JAX-layout parameter tree to start from (seeded
    init from ``cfg.seed`` when None; a ``{"params", "batch_stats"}``
    bundle also sets the amax histories of ``--quant``).  Runs on ``cfg.device`` (cuda by
    default) unless ``device`` says otherwise."""
    from faster_distributed_training_tpu_torch.interop import load_jax_tree
    from faster_distributed_training_tpu_torch.optim import build_optimizer
    from faster_distributed_training_tpu_torch.train.loop import Trainer
    from faster_distributed_training_tpu_torch.train.state import (
        create_train_state)
    from faster_distributed_training_tpu_torch.train.steps import (
        make_eval_step, make_train_step, mixup_alpha, step_draws)

    missing = unported_training_flags(cfg)
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")
    dev = resolve_device(device if device is not None else cfg.device)
    train_ds = load_dataset(cfg, train=True)
    if cfg.dataset == "stream":
        cfg = check_stream_corpus(cfg, train_ds, log)
    train_ds = apply_subset(train_ds, cfg.subset_stride)
    eval_ds = apply_subset(load_dataset(cfg, train=False), cfg.subset_stride)
    model = build_model(cfg, vocab_size=train_ds.vocab_size(), device=dev)
    if params is not None:
        load_jax_tree(model, params)
    else:
        model.init_weights(torch.Generator().manual_seed(cfg.seed))
    model.to(dev)
    if params is None:
        # the JAX init's training forward on a zero batch (seeds the
        # --quant amax histories; a no-op without quant)
        model.seed_amax_histories(cfg.batch_size, cfg.seq_len, step_draws(
            cfg.seed, 0, cfg.batch_size, model.n_dropout_sites(),
            mixup_alpha(cfg)))
    train_loader, eval_loader, steps_per_epoch = make_loaders(
        cfg, train_ds, eval_ds)
    tx, _ = build_optimizer(cfg, steps_per_epoch)
    state = create_train_state(model, tx, cfg.seed)
    trainer = Trainer(cfg, make_train_step(cfg), make_eval_step(cfg), dev,
                      log=log)
    if cfg.telemetry:
        log("[telemetry] not ported yet: this run records no telemetry "
            "(per-step JSONL, manifest, spans come with the telemetry "
            "slice)")
    log(f"[train] {cfg.model}"
        + (" next-token LM (tied head)" if model.tie_lm_head else
           " next-token LM (untied head)" if model.lm else "")
        + f" on {dev.type}: {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads, {cfg.precision}, "
        f"attention {model.layers[0].attn.attention_impl}, ffn "
        f"{cfg.ffn_impl}, quant {cfg.quant or 'none'}"
        + (f" (grads {cfg.quant_grad})"
           if (cfg.quant_grad or "none") != "none" else "") + ", "
        f"{steps_per_epoch} steps/epoch x {cfg.epochs} epochs, batch "
        f"{cfg.batch_size}")
    ckpt_name = "transformer"
    state, start_epoch, start_step = trainer.maybe_resume(state, ckpt_name)
    state = trainer.fit(state, train_loader, eval_loader,
                        ckpt_name=ckpt_name, start_epoch=start_epoch,
                        start_step_in_epoch=start_step)
    return {"state": state, "history": trainer.history,
            "best_acc": trainer.best_acc, "cfg": cfg, "trainer": trainer,
            "steps_per_epoch": steps_per_epoch}


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
    warm_s = sum(e.warmup() for e in engines)
    log(f"[serve] {len(engines)} replica(s) x {len(buckets)} bucket(s) "
        f"warmed in {warm_s:.1f}s on {dev.type} (buckets {list(buckets)}, "
        f"batch {cfg.serve_batch_size})")
    replicas = [Replica(e.name, e, log=log) for e in engines]
    rset = ReplicaSet(replicas,
                      heartbeat_timeout_s=cfg.serve_heartbeat_timeout_s,
                      readmit_after_s=cfg.serve_readmit_s, log=log)
    sched = BatchScheduler(q, rset, batch_size=cfg.serve_batch_size,
                           max_delay_ms=cfg.serve_max_delay_ms, log=log)
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
    log(f"[serve] served {summary['requests']} requests in "
        f"{summary['batches']} batches ({summary['padded_rows']} pad rows): "
        f"p50 {summary['p50_ms']} ms, p99 {summary['p99_ms']} ms, "
        f"{summary['qps']} qps")
    return out


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


if __name__ == "__main__":
    import json

    print(json.dumps(main_serve()))
