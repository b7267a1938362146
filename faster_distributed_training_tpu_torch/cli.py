"""Entry points of the port: classifier serving (slice 1).

Counterparts of ``faster_distributed_training_tpu/cli.py``'s
``resolve_attention``, ``build_model``, ``synth_requests``,
``run_serving`` and ``main_serve``.  Everything runs on CUDA unless the
caller passes ``--device cpu`` / ``device="cpu"``; ``cuda`` without a
GPU raises, nothing falls back on its own.

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
    at load).  Features the port has not reached raise."""
    from faster_distributed_training_tpu_torch.models import get_model

    if cfg.model != "transformer":
        raise NotImplementedError(f"the port builds the transformer only "
                                  f"so far, not {cfg.model!r}")
    unported = {"--task lm": cfg.task != "cls",
                "--quant": (cfg.quant or "none") != "none",
                "--ffn_impl pallas": cfg.ffn_impl == "pallas",
                "--tricks off (unfused qkv)": cfg.tricks == "off",
                "--mesh": any(int(s) > 1 for s in cfg.mesh_shape)}
    missing = [k for k, v in unported.items() if v]
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")
    dtype = torch.bfloat16 if cfg.precision == "bf16" else torch.float32
    device = torch.device(device if device is not None else cfg.device)
    return get_model("transformer", cfg.num_classes,
                     vocab=vocab_size or 30522, maxlen=cfg.seq_len,
                     n_layers=cfg.n_layers, d_model=cfg.d_model,
                     d_ff=cfg.d_ff, h=cfg.n_heads, dtype=dtype,
                     param_dtype=dtype if serving else torch.float32,
                     attention_impl=resolve_attention(cfg, device))


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
