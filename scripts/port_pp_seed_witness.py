#!/usr/bin/env python3
"""Why the pp classifier test's batches use seed 4: the seed-3 readings.

    JAX_PLATFORMS=cpu python3 scripts/port_pp_seed_witness.py [--seeds 3 4]

For each seed, the classifier case of ``tests/test_torch_pp_distributed.py``
(the tiny Transformer with mixup, hash dropout 0.1 on dense attention,
MirrorMADGRAD and the clip at 0.25; 3 steps on the batches of
``cls_batches(3, seed)``) runs four ways on the CPU:

  * JAX ``make_train_step(cfg, pipeline=spec)`` on its ``(pp,)`` mesh of
    2 virtual devices, M = 4 (``jax_pp_run``);
  * JAX's unstaged step (``pipeline=None``), one device;
  * the port at pp=2 on two spawned gloo ranks, with the staged run's
    draws;
  * the port in one process (world 1), with the unstaged run's draws.

It prints, per seed, the largest parameter difference (and its leaf) of
port pp=2 against JAX pp=2, port world 1 against JAX pp=1, port pp=2
against port world 1 and JAX pp=2 against JAX pp=1, and the smallest
absolute pre-activation of the classifier's hidden ReLU over the three
steps' batches in the port at world 1 (a value near 0 sits at the kink,
where each package's rounding picks a side).  The test holds pp=2
against JAX at params 1e-4: if port pp=2 and port world 1 read the same
distance from JAX, the bound hides no pp-only fault.  Imports the tests'
helpers (the conftest's 8 virtual CPU devices), so it runs from the
repository root.
"""

import argparse
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import conftest  # noqa: E402,F401  (the CPU platform and its 8 devices)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import test_torch_pp_distributed as T  # noqa: E402
import torch_dist_worker as W  # noqa: E402


def jax_unstaged_run(flags, batches):
    """JAX's unstaged step of the same config from the same init: (draws,
    final params flat)."""
    from test_torch_distributed import _Recorder
    from faster_distributed_training_tpu.train.amp import fresh_loss_scale
    from faster_distributed_training_tpu.train.state import (
        TrainState as JTrainState)

    jcfg = T.JConfig(**dict(T.PP_SMALL, **flags))
    jtx, _ = T.j_build_optimizer(jcfg, steps_per_epoch=4)
    model = T.jcli.build_model(jcfg, vocab_size=T.VOCAB)
    rng = jax.random.PRNGKey(0)
    rngs = {"params": rng, "dropout": jax.random.fold_in(rng, 1),
            "mixup": jax.random.fold_in(rng, 2)}
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r, x: model.init(r, x, train=True))(
        rngs, jnp.zeros((4, T.L), jnp.int32)))
    params = {"model": variables["params"]}
    state = JTrainState(
        step=jnp.asarray(0, jnp.int32), params=params,
        batch_stats=variables.get("batch_stats", {}),
        opt_state=jtx.init(params), loss_scale=fresh_loss_scale(), rng=rng,
        apply_fn=model.apply, tx=jtx)
    rec, draws = _Recorder(), []
    step = jax.jit(T.j_make_train_step(jcfg))
    for batch in batches:
        state, _ = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        draws.append(rec.take())
    return draws, T.flatten(jax.tree_util.tree_map(np.asarray,
                                                   state.params["model"]))


def worst(a, b):
    """(max |a - b| over the common leaves, the leaf)."""
    errs = {k: float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max())
            for k in b}
    k = max(errs, key=errs.get)
    return errs[k], k


def relu_margin(init, batches, draws):
    """The smallest |pre-activation| of the classifier's hidden ReLU over
    the steps' batches, in the port at world 1 (the classifier MLP's
    ``x.w1^T + b1``, read around its call)."""
    from faster_distributed_training_tpu_torch.models import transformer

    cfg, state = W.build_state({**T.PP_SMALL, **T.CLS}, init, place=False)
    seen, mlp = [], transformer.fused_mlp

    def spy(x, w1, b1, *rest, **kw):
        h = x.detach() @ w1.detach().t() + b1.detach()
        seen.append(float(h.abs().min()))
        return mlp(x, w1, b1, *rest, **kw)
    step = T.make_train_step(cfg)
    transformer.fused_mlp = spy
    try:
        for batch, d in zip(batches, draws):
            state, _ = step(state, T.to_device(batch, "cpu"),
                            T.StepDraws(**d))
    finally:
        transformer.fused_mlp = mlp
    return min(seen)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[3, 4])
    args = ap.parse_args()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        from test_torch_distributed import _Recorder
        _Recorder.install(mp)
        for seed in args.seeds:
            batches = T.cls_batches(3, seed=seed)
            init, jdraws, _, jpp2, _, _ = T.jax_pp_run(T.CLS, batches,
                                                       *T.PP2)
            udraws, jpp1 = jax_unstaged_run(T.CLS, batches)
            with tempfile.TemporaryDirectory() as tmp:
                group = W.start("run_steps", 2, tmp, cfg_kw=T.PP_SMALL,
                                init=init, batches=batches, draws=jdraws,
                                variants={"pp2": T._pp(T.CLS)})
                one, _ = T.single_process(T.CLS, init, batches, udraws)
                res = W.wait(group, T.TIMEOUT)
            pp2 = T.port_params(res[0]["pp2"]["leaves"])
            w1 = T.port_params(W.whole_leaves(one))
            print(f"seed {seed}: draws of JAX pp=2 and pp=1 equal: "
                  f"{all(a['seeds'] == b['seeds'] for a, b in zip(jdraws, udraws))}")
            for what, a, b in (("port pp=2 vs JAX pp=2", pp2, jpp2),
                               ("port world 1 vs JAX pp=1", w1, jpp1),
                               ("port pp=2 vs port world 1", pp2, w1),
                               ("JAX pp=2 vs JAX pp=1", jpp2, jpp1)):
                err, leaf = worst(a, b)
                print(f"  {what}: params max err {err:.3g} ({leaf})")
            print(f"  port world 1: smallest |ReLU pre-activation| "
                  f"{relu_margin(init, batches, udraws):.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
