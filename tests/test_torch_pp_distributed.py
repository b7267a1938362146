"""The port's pipeline-parallel training (``--mesh pp=2`` and
``dp=2,pp=2``) on spawned gloo ranks, against the JAX package's staged
step on the same mesh.

The ranks run in processes of ``tests/torch_dist_worker.py`` (the port
and torch only), joined by gloo through a FileStore; one process a
stage.  The JAX side runs here on the conftest's virtual CPU devices:
JAX ``make_train_step(cfg, pipeline=spec)`` jitted under its ``(pp,)``
mesh of 2 devices or its ``(dp, pp)`` mesh of 4, the spec from JAX's
``build_pipeline_spec`` (M = 4), its draws recorded and handed to the
port.  3 steps each of the tiny Transformer (d_model 32, 4 heads, d_ff
64, L 16, batch 8), held at loss 1e-5 each step, parameters 1e-4, amax
histories 1e-5 relative:

  * the LM (tied head) in fp32 with SGD and dropout off, 2 layers, at
    pp=2 and dp=2,pp=2 (JAX ``tests/test_pipeline.py``'s parity case),
    and at 4 layers with ``--pp_schedule interleaved`` (chunks 0, 2 on
    stage 0 and 1, 3 on stage 1: the ring closes);
  * the classifier with mixup, hash dropout 0.1 on dense attention (the
    flax FFN: JAX's dropout-parity combination) and MirrorMADGRAD with
    the clip at 0.25 (engaged), at pp=2 and dp=2,pp=2;
  * ``--quant int8`` on the classifier at pp=2 (the amax cadence: one
    roll a step, the microbatches' MAX).

Against the port itself: flash (its plain version) with the fused FFN
and dropout 0.1 at pp=2 against the port at world 1 (the kernels take
the microbatch's origin: pp=1's stream; JAX's staged kernels draw
another); ``--no_pp_residency`` bitwise equal to residency after every
step; checkpoints pp=2 ↔ one process both ways, bitwise; ``--precision
fp16`` with an inf planted in one stage's layer gradient (every stage
skips the step and backs its scale off); the staged eval
(classifier and LM) against the unstaged eval; ``cli.main`` at ``--mesh
pp=2``.  After every step every rank's whole state (gathered
from the stages) is bitwise equal to every other's, and every rank
reports the last stage's metrics.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_dist_worker as W
from faster_distributed_training_tpu import cli as jcli
from faster_distributed_training_tpu.config import TrainConfig as JConfig
from faster_distributed_training_tpu.optim import (
    build_optimizer as j_build_optimizer)
from faster_distributed_training_tpu.parallel.pipeline import (
    build_pipeline_spec as j_build_spec)
from faster_distributed_training_tpu.train.steps import (
    make_train_step as j_make_train_step)
from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.interop import (
    batch_stats_to_jax, flatten, load_jax_tree, params_to_jax)
from faster_distributed_training_tpu_torch.train import checkpoint as ckpt
from faster_distributed_training_tpu_torch.train.steps import (
    StepDraws, make_train_step, step_draws, to_device)

VOCAB, B, L = 100, 8, 16
TIMEOUT = 420.0
PP_SMALL = dict(W.SMALL, n_layers=2, d_model=32, d_ff=64, n_heads=4,
                seq_len=L, attention="dense", pp_microbatches=4)
LM = dict(task="lm", dropout_impl="none", optimizer="sgd")
CLS = dict(dropout_impl="hash", clip_norm=0.25)
QUANT = dict(quant="int8", clip_norm=0.25)
INTERLEAVED = dict(LM, n_layers=4, pp_schedule="interleaved")
FLASH_FFN = dict(attention="flash", ffn_impl="pallas", dropout_impl="hash")
PP2, DP2PP2 = (("pp",), (2,)), (("dp", "pp"), (2, 2))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cls_batches(n, seed=4):
    """Ragged padded token batches with learnable labels.  (Seed 3 put
    one classifier ReLU pre-activation at 1.5e-10 in step 3, in the port
    world 1 as in JAX pp=1: which side of the kink each package's
    rounding lands on is a coin toss, and MirrorMADGRAD turns it into a
    1.8e-4 difference of that unit's weights, at pp=2 and at world 1
    alike: ``scripts/port_pp_seed_witness.py`` prints the readings.)"""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lengths = rng.integers(4, L + 1, size=B)
        mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int32)
        labels = rng.integers(0, 4, size=B).astype(np.int32)
        tokens = (rng.integers(1, VOCAB // 4, size=(B, L)) * 4
                  + labels[:, None]).astype(np.int32) * mask
        out.append({"tokens": tokens, "token_types": np.zeros_like(tokens),
                    "mask": mask, "label": labels})
    return out


def lm_batches(n, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lengths = rng.integers(L // 2, L + 1, B)
        mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int32)
        tokens = rng.integers(1, VOCAB, size=(B, L)).astype(np.int32) * mask
        out.append({"tokens": tokens, "token_types": np.zeros_like(tokens),
                    "mask": mask, "label": np.zeros(B, np.int32)})
    return out


def jax_pp_run(flags, batches, axes, shape):
    """JAX's 3 staged steps of the tiny Transformer on a mesh of ``axes``
    x ``shape`` (``make_train_step(cfg, pipeline=spec)`` jitted under the
    mesh), the draws recorded: (port init state dict, draws, metrics,
    final params flat, final batch_stats flat, initial params flat)."""
    from test_torch_distributed import _Recorder
    from faster_distributed_training_tpu.train.amp import fresh_loss_scale
    from faster_distributed_training_tpu.train.state import (
        TrainState as JTrainState)

    small = dict(PP_SMALL, **flags)
    jcfg = JConfig(**small)
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)
    spec = j_build_spec(jcfg, mesh, attention_impl="dense")
    assert spec.n_stages == 2 and spec.n_microbatches == 4
    jtx, _ = j_build_optimizer(jcfg, steps_per_epoch=4)
    model = jcli.build_model(jcfg, vocab_size=VOCAB)
    rng = jax.random.PRNGKey(0)
    rngs = {"params": rng, "dropout": jax.random.fold_in(rng, 1),
            "mixup": jax.random.fold_in(rng, 2)}
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r, x: model.init(r, x, train=True))(
        rngs, jnp.zeros((4, L), jnp.int32)))
    params = {"model": variables["params"]}
    jstate = JTrainState(
        step=jnp.asarray(0, jnp.int32), params=params,
        batch_stats=variables.get("batch_stats", {}),
        opt_state=jtx.init(params), loss_scale=fresh_loss_scale(), rng=rng,
        apply_fn=model.apply, tx=jtx)
    jstate0 = jstate
    rec = _Recorder()
    draws, metrics = [], []
    with mesh:
        jstep = jax.jit(j_make_train_step(jcfg, pipeline=spec))
        for batch in batches:
            jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
            metrics.append({k: float(v) for k, v in jm.items()})
            draws.append(rec.take())
    port = cli.build_model(TrainConfig(**small), vocab_size=VOCAB,
                           device="cpu")
    load_jax_tree(port, {"params": jstate0.params["model"],
                         "batch_stats": jstate0.batch_stats})
    init = {k: v.numpy().copy() for k, v in port.state_dict().items()}
    return (init, draws, metrics,
            flatten(jax.tree_util.tree_map(np.asarray,
                                           jstate.params["model"])),
            flatten(jax.tree_util.tree_map(np.asarray, jstate.batch_stats)),
            flatten(jstate0.params["model"]))


def port_params(leaves, n_heads=4):
    sd = {k[len("model/"):]: torch.from_numpy(v) for k, v in leaves.items()
          if k.startswith("model/")}
    return flatten(params_to_jax(sd, n_heads))


def check_ranks(res, world):
    """Every rank's whole state after every step and its metrics the
    same."""
    assert len(res) == world
    for r in res:
        assert r["digests"] == res[0]["digests"]
        assert r["metrics"] == res[0]["metrics"]


def check_against_jax(res, jax_run, world):
    """Each step's loss, the final parameters (they moved), the ranks'
    agreement."""
    _, _, jmetrics, jparams, _, start = jax_run
    check_ranks(res, world)
    for i, jm in enumerate(jmetrics):
        np.testing.assert_allclose(res[0]["metrics"][i]["loss"], jm["loss"],
                                   rtol=0, atol=1e-5, err_msg=f"step {i}")
    got = port_params(res[0]["leaves"])
    assert sorted(got) == sorted(jparams)
    for k in jparams:
        np.testing.assert_allclose(got[k], jparams[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    assert max(np.abs(jparams[k] - start[k]).max() for k in jparams) > 1e-3


def single_process(flags, init, batches, draws):
    """The same steps in this process, no process group."""
    cfg, state = W.build_state({**PP_SMALL, **flags}, init, place=False)
    step = make_train_step(cfg)
    losses = []
    for batch, d in zip(batches, draws):
        state, m = step(state, to_device(batch, "cpu"), StepDraws(**d))
        losses.append(float(m["loss"]))
    return state, losses


def _pp(over, mesh=PP2, **more):
    return ({"mesh_shape": mesh[1], **over, **more}, mesh[0])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references and the port's groups side by side: 2 gloo ranks
    (pp=2: the LM, interleaved, the classifier with and without
    residency, int8, flash + fused FFN, the checkpoints, the CLI) and 4
    (dp=2,pp=2: the LM and the classifier)."""
    tmp = tmp_path_factory.mktemp("pp_groups")
    groups = {"pp2": W.start("many", 2, str(tmp / "pp2")),
              "dp2pp2": W.start("many", 4, str(tmp / "dp2pp2"))}
    try:
        return _run_groups(tmp, groups)
    finally:
        for g in groups.values():
            W.kill(g)


def _run_groups(tmp, groups) -> dict:
    from test_torch_distributed import _Recorder

    cls, lm = cls_batches(3), lm_batches(3)
    jobs = {"lm": (LM, lm, *PP2), "lm_dp2pp2": (LM, lm, *DP2PP2),
            "interleaved": (INTERLEAVED, lm, *PP2),
            "cls": (CLS, cls, *PP2), "cls_dp2pp2": (CLS, cls, *DP2PP2),
            "quant": (QUANT, cls, *PP2)}
    with pytest.MonkeyPatch.context() as mp:
        _Recorder.install(mp)
        with ThreadPoolExecutor(len(jobs)) as ex:
            futs = {n: ex.submit(jax_pp_run, *job)
                    for n, job in jobs.items()}
            jax_runs = {n: f.result(timeout=TIMEOUT)
                        for n, f in futs.items()}
    init = jax_runs["cls"][0]
    # the port's own draws for flash + the fused FFN (dropout 0.1), and
    # its world-1 run
    model = cli.build_model(TrainConfig(**{**PP_SMALL, **FLASH_FFN}),
                            vocab_size=VOCAB, device="cpu")
    own = [dict(seeds=d.seeds, lam=d.lam, perm=d.perm) for d in (
        step_draws(0, i, B, model.n_dropout_sites(), 0.99)
        for i in range(3))]
    ck = str(tmp / "ck")
    one, _ = single_process(CLS, init, cls[:2], jax_runs["cls"][1][:2])
    ckpt.save_checkpoint(ck, "one", one, 0, 0.0)

    def job(name, flags, batches, variants, ckpt_dir=""):
        return ("run_steps", dict(
            cfg_kw=PP_SMALL, init=jax_runs[name][0], batches=batches,
            draws=jax_runs[name][1], ckpt_dir=ckpt_dir,
            variants={k: _pp(dict(flags, **over), mesh)
                      for k, (over, mesh) in variants.items()}))
    W.feed(groups["pp2"], cases={
        "lm": job("lm", LM, lm, {"pp2": ({}, PP2)}),
        "interleaved": job("interleaved", INTERLEAVED, lm,
                           {"pp2": ({}, PP2)}),
        "cls": job("cls", CLS, cls, {
            "res": ({}, PP2), "nores": ({"pp_residency": False}, PP2)},
            ckpt_dir=ck),
        "quant": job("quant", QUANT, cls, {"pp2": ({}, PP2)}),
        "flash_ffn": ("run_steps", dict(
            cfg_kw=PP_SMALL, init=init, batches=cls, draws=own,
            variants={"pp2": _pp(FLASH_FFN)})),
        "restore": ("restore", dict(cfg_kw={**PP_SMALL, **CLS}, init=init,
                                    ckpt_dir=ck, name="one",
                                    mesh_axes=PP2[0],
                                    over={"mesh_shape": PP2[1]})),
        "fp16": ("fp16_planted_inf", dict(
            cfg_kw={**PP_SMALL, **CLS, "mesh_shape": PP2[1]},
            init=init, batches=cls, draws=jax_runs["cls"][1], stage=1,
            at_step=1, mesh_axes=PP2[0])),
        "cli": ("cli_pp_run", dict(ckpt_root=str(tmp / "cli"))),
        "eval_cls": ("eval_metrics", dict(
            cfg_kw={**PP_SMALL, **CLS}, init=init, batches=cls,
            mesh_axes=PP2[0], over={"mesh_shape": PP2[1]})),
        "eval_lm": ("eval_metrics", dict(
            cfg_kw={**PP_SMALL, **LM}, init=jax_runs["lm"][0], batches=lm,
            mesh_axes=PP2[0], over={"mesh_shape": PP2[1]}))})
    W.feed(groups["dp2pp2"], cases={
        "lm": job("lm_dp2pp2", LM, lm, {"dp2pp2": ({}, DP2PP2)}),
        "cls": job("cls_dp2pp2", CLS, cls, {"dp2pp2": ({}, DP2PP2)})})
    # the world-1 references while the ranks run: flash + the fused FFN,
    # the unstaged eval
    flash_one, flash_losses = single_process(FLASH_FFN, init, cls, own)
    evals = {name: W.eval_metrics({**PP_SMALL, **flags}, jax_runs[src][0],
                                  batches)
             for name, flags, src, batches in (("eval_cls", CLS, "cls", cls),
                                               ("eval_lm", LM, "lm", lm))}
    a, b = (W.wait(g, TIMEOUT) for g in groups.values())
    port = {name: [r[name] for r in a] for name in a[0]}
    port["dp2pp2"] = {name: [r[name] for r in b] for name in b[0]}
    return {"jax": jax_runs, "port": port, "ck": ck, "init": init,
            "one": W.whole_leaves(one),
            "flash_one": (W.whole_leaves(flash_one), flash_losses),
            "evals": evals}


@pytest.mark.parametrize("case,mesh", [
    ("lm", "pp2"), ("lm", "dp2pp2"), ("interleaved", "pp2"),
    ("cls", "pp2"), ("cls", "dp2pp2")])
def test_staged_steps_match_jax_pipeline_step(runs, case, mesh):
    port = runs["port"]
    if mesh == "dp2pp2":
        res, jrun, world = ([r["dp2pp2"] for r in port["dp2pp2"][case]],
                            runs["jax"][f"{case}_dp2pp2"], 4)
    else:
        res = [r["res" if case == "cls" else "pp2"] for r in port[case]]
        jrun, world = runs["jax"][case], 2
    check_against_jax(res, jrun, world)


def test_int8_histories_match_jax_pipeline_cadence(runs):
    res = [r["pp2"] for r in runs["port"]["quant"]]
    jrun = runs["jax"]["quant"]
    check_against_jax(res, jrun, 2)
    sd = {k[len("model/"):]: torch.from_numpy(v)
          for k, v in res[0]["leaves"].items() if k.startswith("model/")}
    got, want = flatten(batch_stats_to_jax(sd)), jrun[4]
    assert sorted(got) == sorted(want) and want
    for k in want:
        assert want[k].any(), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0,
                                   err_msg=k)


def test_residency_on_and_off_train_bitwise_alike(runs):
    for r in runs["port"]["cls"]:
        assert r["res"]["digests"] == r["nores"]["digests"]
        assert r["res"]["metrics"] == r["nores"]["metrics"]


def test_flash_and_fused_ffn_with_dropout_match_the_port_at_world_1(runs):
    """flash and the fused FFN take each microbatch's origin: pp=2 draws
    world 1's dropout stream."""
    res = [r["pp2"] for r in runs["port"]["flash_ffn"]]
    check_ranks(res, 2)
    want, losses = runs["flash_one"]
    for got, ref in zip(res[0]["metrics"], losses):
        np.testing.assert_allclose(got["loss"], ref, rtol=0, atol=1e-5)
    assert sorted(res[0]["leaves"]) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(res[0]["leaves"][k], v, rtol=0,
                                   atol=1e-4, err_msg=k)


def test_checkpoints_interchange_between_pp2_and_one_process(runs):
    want = runs["port"]["cls"][0]["res"]["leaves"]
    _, state = W.build_state({**PP_SMALL, **CLS}, runs["init"], place=False)
    ckpt.restore_checkpoint(runs["ck"], "res", state)
    got = W.whole_leaves(state)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(got[k], v), k
    for r in runs["port"]["restore"]:
        assert sorted(r["leaves"]) == sorted(runs["one"])
        for k, v in runs["one"].items():
            assert np.array_equal(r["leaves"][k], v), k


def test_fp16_overflow_on_one_stage_skips_the_step_on_every_stage(runs):
    """``--precision fp16`` at pp=2 with one of stage 1's layer gradients
    made inf at step 1 (stage 0's leaves finite): both stages skip that
    step (the whole state as before it) and back their loss scales off
    alike, so stage 0 unscales the cotangent the last stage scaled by
    the same scale; the steps around it update."""
    res = runs["port"]["fp16"]
    assert res[0] == res[1]
    scales, digests = res[0]["scales"], res[0]["digests"]
    assert scales[1] == scales[2] == scales[0] / 2
    assert digests[2] == digests[1]
    assert digests[1] != digests[0] and digests[3] != digests[2]


def test_cli_trains_the_classifier_at_pp2(runs):
    out = [{k: v for k, v in r.items() if k != "rules"}
           for r in runs["port"]["cli"]]
    assert out[0] == out[1]
    assert out[0]["step"] == out[0]["steps_per_epoch"] > 0
    assert np.isfinite(out[0]["train_loss"])
    assert np.isfinite(out[0]["test_loss"])
    # --debug logs the rule table once (rank 0 logs): the stages, M and
    # the residency
    rules, = runs["port"]["cli"][0]["rules"]
    assert (rules["n_stages"], rules["n_microbatches"]) == (2, 4)
    assert rules["param_residency"]["stage_home"] == {
        "layer_0": 0, "layer_1": 1, "embeddings": 0, "head": 1}


@pytest.mark.parametrize("case", ["eval_cls", "eval_lm"])
def test_staged_eval_matches_the_unstaged_eval(runs, case):
    """The staged eval forward (the whole local batch through the stages,
    the last stage's metrics on every rank) against the unstaged eval of
    the same state: counts equal, sums 1e-5 relative."""
    want = runs["evals"][case]
    res = runs["port"][case]
    assert res[0] == res[1]
    for got, ref in zip(res[0], want):
        assert got["total"] == ref["total"] and got["total"] > 0
        for k in ("loss", "loss_total", "correct"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=0,
                                       err_msg=k)
