"""The port's tensor-parallel training (``--mesh tp=2`` and ``dp=2,tp=2``)
on spawned gloo ranks, against the JAX package on the same mesh.

The ranks run in processes of ``tests/torch_dist_worker.py`` (the port
and torch only), joined by gloo through a FileStore.  The JAX side runs
here on the conftest's virtual CPU devices: JAX ``make_train_step``
jitted on a ``(tp,)`` mesh of 2 devices and a ``(dp, tp)`` mesh of 4,
its model built on the mesh (the tp annotations), the state placed by
``shard_train_state`` (the tp rules, ZeRO over tp), the draws recorded
and handed to the port.  3 steps of the tiny Transformer (2 layers,
d_model 32, 4 heads, d_ff 64, L 16, batch 8, dropout 0.1, mixup, the
clip at 0.25 so that it engages; the port's flash plain versions on
each rank's heads at h0, JAX's dense route with the same hash dropout;
the flax FFN with its hidden dropout at the global columns):

  * tp=2 and dp=2,tp=2 against JAX: loss 1e-5 each step, parameters
    1e-4 (the data-mesh tests' tolerances); after every step every rank's
    whole state bitwise equal to every other's, and the gradients of the
    replicated leaves bitwise equal across the ranks of a tp group;
  * ``--no_zero_opt`` against JAX (the same tolerances) and the default
    (loss 1e-6, every leaf 1e-4: ZeRO over tp cuts the same elementwise
    update into slices, the clip's norm sums them in another order);
  * checkpoints interchange bitwise between tp=2 and one process, both
    ways;
  * ``cli.main`` trains the classifier at ``--mesh tp=2`` (the
    acceptance run of ``run_distributed.sh --device cpu --mesh tp=2``).

The fused FFN and the quantized GEMMs under tp are in
``tests/test_torch_tp_distributed_quant.py``.
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
    flatten, load_jax_tree, params_to_jax)
from faster_distributed_training_tpu_torch.train import checkpoint as ckpt
from faster_distributed_training_tpu_torch.train.steps import (
    StepDraws, make_train_step, to_device)

VOCAB, B, L = 100, 8, 16
VOCAB_ODD = 101
TIMEOUT = 420.0
# the clip at 0.25 engages every step: the global norm sums each tp
# shard's squares over tp and counts each replicated leaf once
TP_SMALL = dict(W.SMALL, n_layers=2, d_model=32, d_ff=64, n_heads=4,
                seq_len=L, clip_norm=0.25)
CLS_FLAGS = dict(attention="flash")
TP2 = ({"mesh_shape": (2,)}, ("tp",))
DP2TP2 = ({"mesh_shape": (2, 2)}, ("dp", "tp"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cls_batches(n, seed=3):
    """Ragged padded token batches with learnable labels."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lengths = rng.integers(4, L + 1, size=B)
        lengths[1] = L
        mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int32)
        labels = rng.integers(0, 4, size=B).astype(np.int32)
        tokens = (rng.integers(1, VOCAB // 4, size=(B, L)) * 4
                  + labels[:, None]).astype(np.int32) * mask
        out.append({"tokens": tokens, "token_types": np.zeros_like(tokens),
                    "mask": mask, "label": labels})
    return out


def jax_tp_run(flags, batches, axes, shape):
    """JAX's 3 steps of the tiny Transformer on a mesh of ``axes`` x
    ``shape`` (the model built on it, the state placed by the tp rules),
    the draws recorded: (port init state dict, draws, metrics, final
    params flat, final batch_stats flat, initial params flat)."""
    from test_torch_distributed import _Recorder
    from faster_distributed_training_tpu.train.amp import fresh_loss_scale
    from faster_distributed_training_tpu.train.state import (
        TrainState as JTrainState)

    small = dict(TP_SMALL, **flags)
    jcfg = JConfig(**{**small, "attention": "dense"}, mesh_axes=axes,
                   mesh_shape=shape)
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)
    jtx, _ = j_build_optimizer(jcfg, steps_per_epoch=4)
    plain = jcli.build_model(jcfg.replace(mesh_axes=("dp",), mesh_shape=()),
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


def check_against_jax(res, jax_run, world, tp=2):
    """Each step's loss, the final parameters, the ranks' agreement and
    the replicated gradients' across each tp group."""
    _, _, jmetrics, jparams, _, start = jax_run
    assert len(res) == world
    for i, jm in enumerate(jmetrics):
        np.testing.assert_allclose(res[0]["metrics"][i]["loss"], jm["loss"],
                                   rtol=0, atol=1e-5, err_msg=f"step {i}")
        for r in res:   # every rank's whole state after every step
            assert r["digests"][i] == res[0]["digests"][i], i
            assert r["metrics"][i] == res[0]["metrics"][i], i
        for d in range(world // tp):   # replicated grads, each tp group
            group = res[d * tp:(d + 1) * tp]
            assert len({r["replicated_grads"][i] for r in group}) == 1, i
    got = port_params(res[0]["leaves"])
    assert sorted(got) == sorted(jparams)
    for k in jparams:
        np.testing.assert_allclose(got[k], jparams[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    assert max(np.abs(jparams[k] - start[k]).max() for k in jparams) > 1e-3


def single_process(init, batches, draws, flags=CLS_FLAGS, vocab=VOCAB):
    """The same steps in this process, no process group."""
    cfg, state = W.build_state({**TP_SMALL, **flags}, init, vocab=vocab,
                               place=False)
    step = make_train_step(cfg)
    for batch, d in zip(batches, draws):
        state, _ = step(state, to_device(batch, "cpu"), StepDraws(**d))
    return state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references and the port's groups side by side: 2 gloo ranks
    (tp=2, its --no_zero_opt twin, the checkpoints, the CLI) and 4 (dp=2,
    tp=2)."""
    tmp = tmp_path_factory.mktemp("tp_groups")
    groups = {"tp2": W.start("many", 2, str(tmp / "tp2")),
              "dp2tp2": W.start("run_steps", 4, str(tmp / "dp2tp2"))}
    try:
        return _run_groups(tmp, groups)
    finally:
        for g in groups.values():
            W.kill(g)


def _run_groups(tmp, groups) -> dict:
    from test_torch_distributed import _Recorder

    cls = cls_batches(3)
    with pytest.MonkeyPatch.context() as mp:
        _Recorder.install(mp)
        with ThreadPoolExecutor(2) as ex:
            futs = {"tp2": ex.submit(jax_tp_run, CLS_FLAGS, cls, ("tp",),
                                     (2,)),
                    "dp2tp2": ex.submit(jax_tp_run, CLS_FLAGS, cls,
                                        ("dp", "tp"), (2, 2))}
            jax_runs = {n: f.result() for n, f in futs.items()}
    init, draws = jax_runs["tp2"][0], jax_runs["tp2"][1]
    # a vocabulary tp=2 does not divide: one more token row, and batches
    # that look it up (it lands on rank 1's padded shard)
    odd = dict(init)
    odd["embeddings.token_embedding"] = np.concatenate(
        [init["embeddings.token_embedding"], np.random.default_rng(7).normal(
            size=(1, TP_SMALL["d_model"])).astype(np.float32)])
    cls_odd = [dict(b, tokens=np.where(np.arange(L) == 0, VOCAB_ODD - 1,
                                       b["tokens"]).astype(np.int32))
               for b in cls]
    ck = str(tmp / "ck")
    one = single_process(init, cls[:2], draws[:2])
    ckpt.save_checkpoint(ck, "one", one, 0, 0.0)
    kw = dict(cfg_kw={**TP_SMALL, **CLS_FLAGS}, init=init, batches=cls,
              draws=draws)
    W.feed(groups["tp2"], cases={
        "cls": ("run_steps", dict(kw, ckpt_dir=ck, variants={
            "tp2": TP2, "tp2_nozero": ({**TP2[0], "zero_opt": False},
                                       TP2[1])})),
        "restore": ("restore", dict(cfg_kw={**TP_SMALL, **CLS_FLAGS},
                                    init=init, ckpt_dir=ck, name="one",
                                    mesh_axes=TP2[1], over=TP2[0])),
        "cli": ("cli_tp_run", dict(ckpt_root=str(tmp / "cli"))),
        "vocab_odd": ("run_steps", dict(kw, init=odd, batches=cls_odd,
                                        vocab=VOCAB_ODD,
                                        variants={"tp2": TP2}))})
    W.feed(groups["dp2tp2"], **kw, variants={"dp2tp2": DP2TP2})
    a, b = (W.wait(g, TIMEOUT) for g in groups.values())
    port = {name: [r[name] for r in a]
            for name in ("cls", "restore", "cli", "vocab_odd")}
    port["dp2tp2"] = [r["dp2tp2"] for r in b]
    return {"cls": cls, "jax": jax_runs, "port": port, "ck": ck,
            "one": W.whole_leaves(one),
            "one_odd": W.whole_leaves(single_process(
                odd, cls_odd, draws, vocab=VOCAB_ODD)),
            "odd_row": odd["embeddings.token_embedding"][-1]}


def test_tp2_matches_jax_tp_mesh(runs):
    check_against_jax([r["tp2"] for r in runs["port"]["cls"]],
                      runs["jax"]["tp2"], 2)


def test_dp2_tp2_matches_jax_2d_mesh(runs):
    jrun = runs["jax"]["dp2tp2"]
    # the draws do not depend on the mesh (partitionable threefry)
    assert all(a["seeds"] == b["seeds"] and a["lam"] == b["lam"]
               for a, b in zip(jrun[1], runs["jax"]["tp2"][1]))
    check_against_jax(runs["port"]["dp2tp2"], jrun, 4)


def test_no_zero_opt_matches_jax_and_zero_over_tp(runs):
    res = runs["port"]["cls"]
    a, b = [r["tp2"] for r in res], [r["tp2_nozero"] for r in res]
    check_against_jax(b, runs["jax"]["tp2"], 2)
    # the same update; the clip's global norm sums the ZeRO slices'
    # squares in another order (every leaf, optimizer state included, at
    # the parameters' 1e-4)
    for ma, mb in zip(a[0]["metrics"], b[0]["metrics"]):
        np.testing.assert_allclose(mb["loss"], ma["loss"], rtol=0, atol=1e-6)
    for k, v in a[0]["leaves"].items():
        np.testing.assert_allclose(b[0]["leaves"][k], v, rtol=0, atol=1e-4,
                                   err_msg=k)
    # the default's placement table shards the replicated parameters'
    # optimizer mirrors over tp (ZeRO), --no_zero_opt none of them
    za, zb = a[0]["table"], b[0]["table"]
    zero = [p for p, row in za.items() if p.startswith("opt/")
            and row["tp"] is None and row["dim"] is not None]
    assert zero and not [p for p, row in zb.items() if p.startswith("opt/")
                         and row["tp"] is None and row["dim"] is not None]
    assert {p: row["tp"] for p, row in za.items()} == {
        p: row["tp"] for p, row in zb.items()}


def test_checkpoints_interchange_between_tp2_and_one_process(runs):
    want = runs["port"]["cls"][0]["tp2"]["leaves"]
    _, state = W.build_state({**TP_SMALL, **CLS_FLAGS},
                             runs["jax"]["tp2"][0], place=False)
    ckpt.restore_checkpoint(runs["ck"], "tp2", state)
    got = W.whole_leaves(state)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(got[k], v), k
    for r in runs["port"]["restore"]:
        assert sorted(r["leaves"]) == sorted(runs["one"])
        for k, v in runs["one"].items():
            assert np.array_equal(r["leaves"][k], v), k


def test_cli_trains_the_classifier_at_tp2(runs):
    out = runs["port"]["cli"]
    assert out[0] == out[1]
    assert out[0]["step"] == out[0]["steps_per_epoch"] > 0
    assert np.isfinite(out[0]["train_loss"])


def test_tp2_pads_a_vocabulary_it_does_not_divide(runs):
    """Vocab 101 at tp=2 (JAX's device placement refuses the uneven
    split, so the reference is the port in one process): each rank holds
    51 token rows, rank 1's last one padding; 3 steps against one
    process at the JAX comparisons' tolerances (loss 1e-5, every whole
    leaf 1e-4), the ranks bitwise after every step."""
    res = [r["tp2"] for r in runs["port"]["vocab_odd"]]
    assert res[0]["digests"] == res[1]["digests"]
    assert res[0]["table"]["params/embeddings.token_embedding"]["tp"] == (
        "rows")
    want = runs["one_odd"]
    got = res[0]["leaves"]
    assert sorted(got) == sorted(want)
    table = "model/embeddings.token_embedding"
    assert got[table].shape[0] == VOCAB_ODD
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-4, err_msg=k)
    # the extra row was looked up and trained
    assert np.abs(got[table][-1] - runs["odd_row"]).max() > 1e-3
