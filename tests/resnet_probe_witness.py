"""A CPU witness for the ResNet fixed-batch probe at the record's lr 0.1.

JAX's ``train/steps.py::make_train_step`` (jitted) and the port's take
the same steps from one seeded init (the JAX init, converted), on one
fixed batch: the first ``--bs`` images of ``synthetic_cifar``,
normalized (float images, so neither step augments), with JAX's mixup
draws for each step handed to the port.  It prints both loss
trajectories and their relative gap a step, for each arm:

  * ``ngd-meta``: ``--ngd --meta_learning`` (NGD at its default rank,
    momentum 0.9, weight decay 1e-4, clip 10, multistep; the learnable
    per-sample lambda), the smoke's R1;
  * ``madgrad-static``: the ``resnet50_test`` record (MADGRAD + cosine,
    static mixup at alpha 0.2), the smoke's R2;
  * ``sgd-meta``: SGD with the meta lambda, R2's second arm.

    JAX_PLATFORMS=cpu python tests/resnet_probe_witness.py \\
        --model resnet50 --bs 16 --steps 12 --arms ngd-meta,madgrad-static

``--conditioning`` first measures one training-mode gradient at the
init (plain cross-entropy, no mixup, the batch above) in fp32 and fp64 in
both packages: how far each package's fp32 gradient lies from the fp64
one, leaf by leaf.  Where that is large, no two fp32 implementations
share a trajectory, and the trajectories are compared by their course.

It is not a pytest module: a resnet50 trajectory takes minutes on the
CPU.  ``--out FILE`` also writes the trajectories as JSON.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ARMS = {
    "ngd-meta": dict(use_ngd=True, meta_learning=True),
    "madgrad-static": dict(),
    "sgd-meta": dict(optimizer="sgd", meta_learning=True),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="resnet50")
    p.add_argument("--bs", type=int, default=16)
    p.add_argument("--hw", type=int, default=32)
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--precision", default="fp32", choices=("fp32", "bf16"))
    p.add_argument("--arms", default="ngd-meta,madgrad-static")
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--out", default=None)
    p.add_argument("--conditioning", action="store_true")
    args = p.parse_args(argv)

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(args.threads)

    from faster_distributed_training_tpu import cli as jcli
    from faster_distributed_training_tpu.config import TrainConfig as JConfig
    from faster_distributed_training_tpu.optim import (
        build_optimizer as j_build_optimizer)
    from faster_distributed_training_tpu.train.amp import fresh_loss_scale
    from faster_distributed_training_tpu.train.mixup import (
        init_meta_lambda as j_init_meta_lambda, sample_lam as j_sample_lam)
    from faster_distributed_training_tpu.train.state import (
        TrainState as JTrainState)
    from faster_distributed_training_tpu.train.steps import (
        make_train_step as j_make_train_step)
    from faster_distributed_training_tpu_torch import cli
    from faster_distributed_training_tpu_torch.config import TrainConfig
    from faster_distributed_training_tpu_torch.data.cifar10 import (
        CIFAR10_MEAN, CIFAR10_STD)
    from faster_distributed_training_tpu_torch.data.synthetic import (
        synthetic_cifar)
    from faster_distributed_training_tpu_torch.interop import resnet_from_jax
    from faster_distributed_training_tpu_torch.optim import (
        build_optimizer, layouts_of)
    from faster_distributed_training_tpu_torch.train.state import (
        create_train_state)
    from faster_distributed_training_tpu_torch.train.steps import (
        StepDraws, make_train_step, resolve_mixup_mode, to_device)

    B, HW = args.bs, args.hw
    x, y = synthetic_cifar(n=B, seed=0)
    x = ((x.astype(np.float32) / 255.0 - CIFAR10_MEAN) / CIFAR10_STD)
    x = np.ascontiguousarray(x[:, :HW, :HW].astype(np.float32))
    batch = {"image": x, "label": y.astype(np.int32)}
    out = {"model": args.model, "bs": B, "hw": HW, "lr": args.lr,
           "precision": args.precision, "arms": {}}
    if args.conditioning:
        out["conditioning"] = conditioning(args.model, batch)
    for arm in args.arms.split(","):
        kw = dict(model=args.model, dataset="synthetic", num_classes=10,
                  lr=args.lr, batch_size=B, epochs=30, alpha=0.2,
                  telemetry=False, plot=False, precision=args.precision,
                  **ARMS[arm])
        jcfg = JConfig(device="cpu", **kw)
        cfg = TrainConfig(device="cpu", **kw)
        mode = resolve_mixup_mode(cfg)
        t0 = time.perf_counter()
        jtx, _ = j_build_optimizer(jcfg, steps_per_epoch=8)
        rng = jax.random.PRNGKey(0)
        jmodel = jcli.build_model(jcfg)
        variables = jax.jit(lambda k, v: jmodel.init(
            {"params": k, "dropout": jax.random.fold_in(k, 1),
             "mixup": jax.random.fold_in(k, 2)}, v, train=True))(
            rng, jnp.zeros((B, HW, HW, 3), jnp.float32))
        variables = jax.tree_util.tree_map(np.asarray, variables)
        jparams = {"model": jax.tree_util.tree_map(jnp.asarray,
                                                   variables["params"])}
        extra = {}
        if mode == "meta":
            lam0 = np.asarray(j_init_meta_lambda(rng, B))
            jparams["mixup_lambda"] = jnp.asarray(lam0)
            extra["mixup_lambda"] = torch.tensor(lam0)
        jstate = JTrainState(
            step=jnp.asarray(0, jnp.int32), params=jparams,
            batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                               variables["batch_stats"]),
            opt_state=jtx.init(jparams), loss_scale=fresh_loss_scale(),
            rng=jax.random.PRNGKey(0), apply_fn=jmodel.apply, tx=jtx)
        jstep = jax.jit(j_make_train_step(jcfg))

        model = cli.build_model(cfg, device="cpu")
        model.load_state_dict(resnet_from_jax(variables["params"],
                                              variables["batch_stats"]))
        tx, _ = build_optimizer(cfg, steps_per_epoch=8,
                                layouts=layouts_of(model))
        state = create_train_state(model, tx, 0, extra=extra)
        step = make_train_step(cfg)

        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        tb = to_device(batch, "cpu")
        j_loss, t_loss = [], []
        for i in range(args.steps):
            # JAX's mixup key for step i, and the draws it makes from it
            k_mix, _ = jax.random.split(jax.random.fold_in(jstate.rng, i))
            if mode == "meta":
                lam, perm = 1.0, np.asarray(jax.random.permutation(k_mix, B))
            else:
                k_lam, k_perm = jax.random.split(k_mix)
                lam = float(j_sample_lam(k_lam, cfg.alpha))
                perm = np.asarray(jax.random.permutation(k_perm, B))
            jstate, jm = jstep(jstate, jb)
            state, m = step(state, tb, StepDraws(seeds=(), lam=lam,
                                                 perm=perm))
            j_loss.append(float(jm["loss"]))
            t_loss.append(float(m["loss"]))
        gap = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(t_loss, j_loss)]
        out["arms"][arm] = {"jax": j_loss, "port": t_loss, "rel_gap": gap,
                            "seconds": time.perf_counter() - t0}
        print(f"[witness] {args.model} bs {B} {HW}x{HW} {args.precision} "
              f"lr {args.lr} {arm} ({mode} mixup), one fixed batch, "
              f"{args.steps} steps in {time.perf_counter() - t0:.1f}s",
              flush=True)
        print("  JAX : " + ", ".join(f"{v:.4f}" for v in j_loss))
        print("  port: " + ", ".join(f"{v:.4f}" for v in t_loss))
        print("  gap : " + ", ".join(f"{v:.2g}" for v in gap), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


def _leaf_report(got: dict, want: dict) -> dict:
    e = {k: float(np.abs(got[k].astype(np.float64) - want[k]).max()
                  / np.abs(want[k]).max()) for k in want}
    worst = max(e, key=e.get)
    return {"worst": e[worst], "leaf": worst,
            "median": float(np.median(list(e.values())))}


def conditioning(name: str, batch: dict) -> dict:
    """One training-mode gradient of ``name`` at a seeded flax init, in
    fp32 and fp64, by JAX and by the port on the converted weights: each
    fp32 gradient against the fp64 ones, leaf by leaf."""
    import jax
    import jax.numpy as jnp
    import torch
    import torch.nn.functional as F

    from faster_distributed_training_tpu.models import resnet as jresnet
    from faster_distributed_training_tpu_torch.interop import (
        flatten, resnet_from_jax, resnet_to_jax)
    from faster_distributed_training_tpu_torch.models import get_model

    x, y = batch["image"], batch["label"]
    B = x.shape[0]
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        init = getattr(jresnet, name)(dtype=jnp.float32)
        v = jax.jit(lambda k, a: init.init(k, a, train=True))(
            jax.random.PRNGKey(3), jnp.asarray(x))
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), v)
        grads, losses = {}, {}
        for tag, jdt, tdt in (("fp32", jnp.float32, torch.float32),
                              ("fp64", jnp.float64, torch.float64)):
            model = getattr(jresnet, name)(dtype=jdt)
            vv = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), v)

            def loss_fn(p, model=model, vv=vv, jdt=jdt):
                logits, _ = model.apply(
                    {"params": p, "batch_stats": vv["batch_stats"]},
                    jnp.asarray(x, jdt), train=True, mutable=["batch_stats"])
                lp = jax.nn.log_softmax(logits.astype(jdt))
                return -jnp.mean(lp[jnp.arange(B), jnp.asarray(y)])

            loss, g = jax.jit(jax.value_and_grad(loss_fn))(vv["params"])
            grads["JAX", tag] = flatten(jax.tree_util.tree_map(np.asarray,
                                                               g))
            losses["JAX", tag] = float(loss)
            m = get_model(name, 10, dtype=tdt).to(tdt)
            m.load_state_dict(resnet_from_jax(v["params"],
                                              v["batch_stats"]))
            loss = F.cross_entropy(m(torch.tensor(x).to(tdt), train=True)
                                   .to(tdt), torch.tensor(y).long())
            named = list(m.named_parameters())
            gs = torch.autograd.grad(loss, [t for _, t in named])
            sd = dict(m.state_dict())
            sd.update({n: t.detach() for (n, _), t in zip(named, gs)})
            grads["port", tag] = flatten(resnet_to_jax(sd)[0])
            losses["port", tag] = loss.item()
    finally:
        jax.config.update("jax_enable_x64", x64)
    rep = {"losses": {f"{a} {b}": v for (a, b), v in losses.items()}}
    for tag, got, want in (
            ("JAX fp32 vs fp64", grads["JAX", "fp32"], grads["JAX", "fp64"]),
            ("port fp32 vs fp64", grads["port", "fp32"],
             grads["JAX", "fp64"]),
            ("port fp32 vs JAX fp32", grads["port", "fp32"],
             grads["JAX", "fp32"]),
            ("port fp64 vs JAX fp64", grads["port", "fp64"],
             grads["JAX", "fp64"])):
        rep[tag] = r = _leaf_report(got, want)
        print(f"[conditioning] {name} bs {B} {x.shape[1]}x{x.shape[2]}, one "
              f"training-mode gradient at the init, {tag}: worst leaf "
              f"{r['worst']:.3g} ({r['leaf']}), median leaf "
              f"{r['median']:.3g}", flush=True)
    return rep


if __name__ == "__main__":
    sys.exit(main())
