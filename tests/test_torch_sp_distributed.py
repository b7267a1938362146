"""The port's sequence-parallel training (``--mesh sp=2`` and
``dp=2,sp=2``) on spawned gloo ranks, against the JAX package on the
same mesh.

The ranks run in processes of ``tests/torch_dist_worker.py`` (the port
and torch only), joined by gloo through a FileStore.  The JAX side runs
here on the conftest's virtual CPU devices: JAX ``make_train_step``
jitted on an ``(sp,)`` mesh of 2 devices and a ``(dp, sp)`` mesh of 4,
its model built on the mesh (ring or Ulysses attention, the sequence-
sharded residual stream), the draws recorded and handed to the port.  3
steps of the tiny Transformer (2 layers, d_model 32, 4 heads, d_ff 64,
L 16, batch 8, dropout 0.1 at every site, mixup, the clip at 0.25 so
that it engages):

  * sp=2 with ring and with Ulysses, and dp=2,sp=2 with both, against
    JAX: loss 1e-5 each step, parameters 1e-4 (the data-mesh tests'
    tolerances); after every step every rank's whole state bitwise equal
    to every other's, and the reduced gradients bitwise equal on every
    rank;
  * path B (``--ffn_impl pallas --quant int8``: rows 7-8's plain version
    at the sequence offsets, ``QuantDense`` amaxes MAXed over sp) at
    sp=2: the same, and the amax histories 1e-5 relative;
  * the next-token LM (tied head) at sp=2, with rows whose padding lies
    in one sequence half only (the two ranks count different numbers of
    targets; the target at the shard edge is read from the full rows):
    the same, and each step's target count and summed loss;
  * checkpoints interchange bitwise between sp=2 and one process, both
    ways; ``cli.main`` trains the classifier at ``--mesh sp=2``.
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
from faster_distributed_training_tpu.parallel.placement import (
    make_put_batch as j_put_batch, shard_train_state as j_shard,
    train_state_shardings as j_shardings)
from faster_distributed_training_tpu.train.steps import (
    make_train_step as j_make_train_step)
from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.interop import (
    batch_stats_to_jax, flatten, load_jax_tree, params_to_jax)
from faster_distributed_training_tpu_torch.train import checkpoint as ckpt
from faster_distributed_training_tpu_torch.train.steps import (
    StepDraws, make_train_step, to_device)

VOCAB, B, L = 100, 8, 16
TIMEOUT = 420.0
SP_SMALL = dict(W.SMALL, n_layers=2, d_model=32, d_ff=64, n_heads=4,
                seq_len=L, clip_norm=0.25)
RING, ULYSSES = dict(attention="ring"), dict(attention="ulysses")
PATH_B = dict(ffn_impl="pallas", quant="int8", attention="ulysses")
LM = dict(task="lm", attention="ulysses")


def _sp(over, axes=("sp",), shape=(2,)):
    return ({"mesh_shape": shape, **over}, axes)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cls_batches(n, seed=3):
    """Ragged padded token batches with learnable labels; one row's keys
    all in the first sequence half."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lengths = rng.integers(4, L + 1, size=B)
        lengths[1], lengths[2] = L, 5
        mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int32)
        labels = rng.integers(0, 4, size=B).astype(np.int32)
        tokens = (rng.integers(1, VOCAB // 4, size=(B, L)) * 4
                  + labels[:, None]).astype(np.int32) * mask
        out.append({"tokens": tokens, "token_types": np.zeros_like(tokens),
                    "mask": mask, "label": labels})
    return out


def lm_batches(n, seed=5):
    """LM rows half of which end inside the first sequence half (their
    second half holds no target: the sp ranks' counts differ)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lengths = np.concatenate([rng.integers(3, L // 2 + 1, B // 2),
                                  rng.integers(L - 3, L + 1, B // 2)])
        mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int32)
        tokens = rng.integers(1, VOCAB, size=(B, L)).astype(np.int32) * mask
        out.append({"tokens": tokens, "token_types": np.zeros_like(tokens),
                    "mask": mask, "label": np.zeros(B, np.int32)})
    return out


def jax_sp_run(flags, batches, axes, shape):
    """JAX's 3 steps of the tiny Transformer on a mesh of ``axes`` x
    ``shape`` (the model built on it), the draws recorded: (port init
    state dict, draws, metrics, final params flat, final batch_stats
    flat, initial params flat).  The LM runs with 64-bit types off on its
    thread: with them on, XLA's SPMD partitioner fails a check on the
    sequence-sharded next-token shift (the process aborts)."""
    if flags.get("task") == "lm":
        with jax.enable_x64(False):
            return _jax_sp_run(flags, batches, axes, shape)
    return _jax_sp_run(flags, batches, axes, shape)


def _jax_sp_run(flags, batches, axes, shape):
    from test_torch_distributed import _Recorder
    from faster_distributed_training_tpu.train.amp import fresh_loss_scale
    from faster_distributed_training_tpu.train.state import (
        TrainState as JTrainState)

    small = dict(SP_SMALL, **flags)
    jcfg = JConfig(**small, mesh_axes=axes, mesh_shape=shape)
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)
    jtx, _ = j_build_optimizer(jcfg, steps_per_epoch=4)
    plain = jcli.build_model(jcfg.replace(mesh_axes=("dp",), mesh_shape=(),
                                          attention="dense"),
                             vocab_size=VOCAB)
    rng = jax.random.PRNGKey(0)
    rngs = {"params": rng, "dropout": jax.random.fold_in(rng, 1),
            "mixup": jax.random.fold_in(rng, 2)}
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r, x: plain.init(r, x, train=True))(
        rngs, jnp.zeros((4, L), jnp.int32)))
    params = {"model": variables["params"]}
    model = jcli.build_model(jcfg, vocab_size=VOCAB, mesh=mesh)
    jstate = JTrainState(
        step=jnp.asarray(0, jnp.int32), params=params,
        batch_stats=variables.get("batch_stats", {}),
        opt_state=jtx.init(params), loss_scale=fresh_loss_scale(), rng=rng,
        apply_fn=model.apply, tx=jtx)
    jstate0 = jstate
    shardings = j_shardings(jstate, mesh, jcfg)
    jstate = j_shard(jstate, mesh, jcfg, shardings=shardings)
    placed = jax.tree_util.tree_map(lambda x: x.sharding, jstate)
    jstep = jax.jit(j_make_train_step(jcfg, state_shardings=shardings),
                    out_shardings=(placed, None))
    put = j_put_batch(mesh)
    rec = _Recorder()
    draws, metrics = [], []
    for batch in batches:
        jstate, jm = jstep(jstate, put(batch))
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


def check_against_jax(res, jax_run, world):
    """Each step's loss, the final parameters, the ranks' agreement (the
    whole state after every step, the reduced gradients)."""
    _, _, jmetrics, jparams, _, start = jax_run
    assert len(res) == world
    for i, jm in enumerate(jmetrics):
        np.testing.assert_allclose(res[0]["metrics"][i]["loss"], jm["loss"],
                                   rtol=0, atol=1e-5, err_msg=f"step {i}")
        for r in res:
            assert r["digests"][i] == res[0]["digests"][i], i
            assert r["metrics"][i] == res[0]["metrics"][i], i
            assert r["replicated_grads"][i] == res[0]["replicated_grads"][i]
    got = port_params(res[0]["leaves"])
    assert sorted(got) == sorted(jparams)
    for k in jparams:
        np.testing.assert_allclose(got[k], jparams[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    assert max(np.abs(jparams[k] - start[k]).max() for k in jparams) > 1e-3


def single_process(init, batches, draws, flags=RING):
    """The same steps in this process, no process group (the dense
    attention: one process has no sp axis)."""
    cfg, state = W.build_state({**SP_SMALL, **flags, "attention": "dense"},
                               init, place=False)
    step = make_train_step(cfg)
    for batch, d in zip(batches, draws):
        state, _ = step(state, to_device(batch, "cpu"), StepDraws(**d))
    return state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references and the port's groups side by side: 2 gloo ranks
    (sp=2: ring, Ulysses, path B, the LM, the checkpoints, the CLI) and 4
    (dp=2,sp=2: ring and Ulysses)."""
    tmp = tmp_path_factory.mktemp("sp_groups")
    groups = {"sp2": W.start("many", 2, str(tmp / "sp2")),
              "dp2sp2": W.start("run_steps", 4, str(tmp / "dp2sp2"))}
    try:
        return _run_groups(tmp, groups)
    finally:
        for g in groups.values():
            W.kill(g)


def _run_groups(tmp, groups) -> dict:
    from test_torch_distributed import _Recorder

    cls, lm = cls_batches(3), lm_batches(3)
    jobs = {"ring": (RING, cls, ("sp",), (2,)),
            "ulysses": (ULYSSES, cls, ("sp",), (2,)),
            "dp2sp2_ring": (RING, cls, ("dp", "sp"), (2, 2)),
            "dp2sp2_ulysses": (ULYSSES, cls, ("dp", "sp"), (2, 2)),
            "path_b": (PATH_B, cls, ("sp",), (2,)),
            "lm": (LM, lm, ("sp",), (2,))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FDT_FORCE_PALLAS_INTERPRET", "1")
        _Recorder.install(mp)
        with ThreadPoolExecutor(len(jobs)) as ex:
            futs = {n: ex.submit(jax_sp_run, *job)
                    for n, job in jobs.items()}
            jax_runs = {n: f.result(timeout=TIMEOUT)
                        for n, f in futs.items()}
    init, draws = jax_runs["ring"][0], jax_runs["ring"][1]
    ck = str(tmp / "ck")
    one = single_process(init, cls[:2], draws[:2])
    ckpt.save_checkpoint(ck, "one", one, 0, 0.0)
    kw = dict(cfg_kw=SP_SMALL, init=init, batches=cls, draws=draws)
    W.feed(groups["sp2"], cases={
        "cls": ("run_steps", dict(kw, ckpt_dir=ck, variants={
            "ring": _sp(RING), "ulysses": _sp(ULYSSES)})),
        "path_b": ("run_steps", dict(
            kw, init=jax_runs["path_b"][0], draws=jax_runs["path_b"][1],
            variants={"sp2": _sp(PATH_B)})),
        "lm": ("run_steps", dict(
            kw, init=jax_runs["lm"][0], batches=lm,
            draws=jax_runs["lm"][1], variants={"sp2": _sp(LM)})),
        "restore": ("restore", dict(cfg_kw={**SP_SMALL, **ULYSSES},
                                    init=init, ckpt_dir=ck, name="one",
                                    mesh_axes=("sp",),
                                    over={"mesh_shape": (2,)})),
        "cli": ("cli_sp_run", dict(ckpt_root=str(tmp / "cli")))})
    W.feed(groups["dp2sp2"], **kw, variants={
        "ring": _sp(RING, ("dp", "sp"), (2, 2)),
        "ulysses": _sp(ULYSSES, ("dp", "sp"), (2, 2))})
    a, b = (W.wait(g, TIMEOUT) for g in groups.values())
    port = {name: [r[name] for r in a]
            for name in ("cls", "path_b", "lm", "restore", "cli")}
    port["dp2sp2"] = b
    return {"cls": cls, "lm": lm, "jax": jax_runs, "port": port, "ck": ck,
            "one": W.whole_leaves(one)}


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_sp2_matches_jax_sp_mesh(runs, strategy):
    check_against_jax([r[strategy] for r in runs["port"]["cls"]],
                      runs["jax"][strategy], 2)


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_dp2_sp2_matches_jax_2d_mesh(runs, strategy):
    jrun = runs["jax"][f"dp2sp2_{strategy}"]
    # the draws do not depend on the mesh or the strategy (partitionable
    # threefry)
    assert all(a["seeds"] == b["seeds"] and a["lam"] == b["lam"]
               for a, b in zip(jrun[1], runs["jax"]["ring"][1]))
    check_against_jax([r[strategy] for r in runs["port"]["dp2sp2"]], jrun,
                      4)


def test_path_b_at_sp2_matches_jax(runs):
    res, jrun = [r["sp2"] for r in runs["port"]["path_b"]], \
        runs["jax"]["path_b"]
    check_against_jax(res, jrun, 2)
    sd = {k[len("model/"):]: torch.from_numpy(v)
          for k, v in res[0]["leaves"].items() if k.startswith("model/")}
    got, want = flatten(batch_stats_to_jax(sd)), jrun[4]
    assert sorted(got) == sorted(want) and want
    for k in want:
        assert want[k].any(), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0,
                                   err_msg=k)


def test_lm_at_sp2_with_one_sided_padding_matches_jax(runs):
    batches = runs["lm"]
    half = L // 2
    for b in batches:          # the two sp ranks' target counts differ
        valid = b["mask"][:, :-1] * b["mask"][:, 1:]
        assert valid[:, :half].sum() > 2 * valid[:, half:].sum() > 0
    res, jrun = [r["sp2"] for r in runs["port"]["lm"]], runs["jax"]["lm"]
    check_against_jax(res, jrun, 2)
    for m, jm in zip(res[0]["metrics"], jrun[2]):
        assert m["total"] == jm["total"]
        np.testing.assert_allclose(m["loss_total"], jm["loss_total"],
                                   rtol=1e-5, atol=0)


def test_checkpoints_interchange_between_sp2_and_one_process(runs):
    want = runs["port"]["cls"][0]["ring"]["leaves"]
    _, state = W.build_state({**SP_SMALL, "attention": "dense"},
                             runs["jax"]["ring"][0], place=False)
    ckpt.restore_checkpoint(runs["ck"], "ring", state)
    got = W.whole_leaves(state)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(got[k], v), k
    for r in runs["port"]["restore"]:
        assert sorted(r["leaves"]) == sorted(runs["one"])
        for k, v in runs["one"].items():
            assert np.array_equal(r["leaves"][k], v), k


def test_cli_trains_the_classifier_at_sp2(runs):
    out = runs["port"]["cli"]
    assert out[0] == out[1]
    assert out[0]["step"] == out[0]["steps_per_epoch"] > 0
    assert np.isfinite(out[0]["train_loss"])
    assert np.isfinite(out[0]["test_loss"])
