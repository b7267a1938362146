"""The port's data-parallel and fully-sharded training on spawned gloo
ranks, against the JAX package on the same mesh.

The ranks run in processes of ``tests/torch_dist_worker.py`` (the port
and torch only), joined by gloo through a FileStore; each group runs
under a timeout of its own and fails past it.  The JAX side runs here,
on the conftest's virtual CPU devices: JAX ``make_train_step`` (un-jitted,
its draws recorded and handed to the port; jitted for the ResNet, whose
permutation comes from its step key) on a ``dp`` mesh of the same world,
or on an ``fsdp`` mesh, the state and the global batch placed by JAX's
``shard_train_state`` / ``make_put_batch``.  Each rank of the port takes
its rows of the same global batches.  3 steps each:

  * the tiny Transformer (1 layer, d_model 64; flash plain versions on
    the port, JAX's dense route with the same hash dropout; dropout 0.1,
    mixup) at dp=2 and dp=4, and at fsdp=2 and zero1 against JAX's fsdp
    and zero1 meshes;
  * path B with int8 (the fused FFN and quantized GEMMs: amax histories
    MAX-reduced over the ranks);
  * the LM with padding that differs between ranks (the loss divides by
    the global target count);
  * resnet18 with ``--ngd --meta_learning`` (``--ngd_rank 1``, batch 8,
    16x16, float images: BatchNorm over the global batch, the meta
    lambda's rows).

Loss to 1e-5 each step, parameters to 1e-4, amax histories to 1e-5
relative, BN statistics to 1e-4.  And: ``--host_offload`` /
``--offload_opt_state`` bitwise equal to no offload;
``--overlap_grad_reduce`` allclose to without; dp=1 over gloo bitwise
equal to no process group; checkpoints interchange bitwise between dp=2
(and fsdp=2) and dp=1 both ways; after every step every rank's whole
state is bitwise equal to every other's; ``cli.run_training`` and both
entry twins train under the mesh flags; what still raises is named.
"""

import threading
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
    make_put_batch as j_put_batch, shard_train_state as j_shard)
from faster_distributed_training_tpu.train.steps import (
    make_train_step as j_make_train_step)
from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.interop import (
    flatten, load_jax_tree, params_to_jax)
from faster_distributed_training_tpu_torch.train import checkpoint as ckpt
from faster_distributed_training_tpu_torch.train.steps import (
    StepDraws, make_train_step, to_device)

VOCAB, B, L = 100, 8, 32
TIMEOUT = 420.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cls_batches(n, seed=3):
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


def _lm_batches(n, seed=5):
    """LM rows whose padding differs from row to row (so from rank to
    rank: rank 0's rows are short, rank 1's long)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lengths = np.concatenate([rng.integers(3, 12, B // 2),
                                  rng.integers(20, L + 1, B // 2)])
        mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int32)
        tokens = rng.integers(1, VOCAB, size=(B, L)).astype(np.int32) * mask
        out.append({"tokens": tokens, "token_types": np.zeros_like(tokens),
                    "mask": mask, "label": np.zeros(B, np.int32)})
    return out


_LOCAL = threading.local()


class _Recorder:
    """Records the values of jax.random.bits / beta / permutation inside
    a jitted JAX step: each call traced on this thread is wrapped with a
    host callback keyed by its trace-time position, so one step's draws
    come back in call order (``take``).  ``install`` patches jax.random
    once; the recorder of the tracing thread gets the values, so
    references traced on several threads keep their draws apart."""

    def __init__(self):
        self.vals, self.n = {}, 0
        _LOCAL.rec = self

    @staticmethod
    def install(mp):
        for name in ("bits", "beta", "permutation"):
            orig = getattr(jax.random, name)

            def wrapped(*a, _orig=orig, _name=name, **kw):
                out = _orig(*a, **kw)
                rec = getattr(_LOCAL, "rec", None)
                if rec is not None:
                    i, rec.n = rec.n, rec.n + 1
                    jax.debug.callback(
                        lambda v, i=i, nm=_name, r=rec: r.vals.__setitem__(
                            i, (nm, np.asarray(v))), out)
                return out
            mp.setattr(jax.random, name, wrapped)

    def take(self) -> dict:
        got = [self.vals[i] for i in sorted(self.vals)]
        self.vals.clear()
        pick = {nm: v for nm, v in got if nm != "bits"}
        return dict(seeds=tuple(int(x) for nm, v in got if nm == "bits"
                                for x in np.ravel(v)),
                    lam=float(pick["beta"]) if "beta" in pick else 0.5,
                    perm=pick.get("permutation", np.arange(B)))


def _jax_mesh(world, axis="dp"):
    return Mesh(np.array(jax.devices()[:world]), (axis,))


def _jax_init(jcfg):
    """JAX's initial state of ``jcfg`` (``create_train_state``'s, the
    init jitted)."""
    from faster_distributed_training_tpu.train.amp import fresh_loss_scale
    from faster_distributed_training_tpu.train.state import (
        TrainState as JTrainState)

    jtx, _ = j_build_optimizer(jcfg, steps_per_epoch=4)
    model = jcli.build_model(jcfg, vocab_size=VOCAB)
    rng = jax.random.PRNGKey(0)
    rngs = {"params": rng, "dropout": jax.random.fold_in(rng, 1),
            "mixup": jax.random.fold_in(rng, 2)}
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r, x: model.init(r, x, train=True))(
        rngs, jnp.zeros((4, L), jnp.int32)))
    params = {"model": variables["params"]}
    return JTrainState(
        step=jnp.asarray(0, jnp.int32), params=params,
        batch_stats=variables.get("batch_stats", {}),
        opt_state=jtx.init(params), loss_scale=fresh_loss_scale(), rng=rng,
        apply_fn=model.apply, tx=jtx)


def _jax_steps(jcfg, jstate, batches, mesh):
    """JAX ``make_train_step`` jitted on ``mesh`` (its output state pinned
    to the input's placement: one compile), the draws recorded: (state,
    draws, metrics)."""
    jstate = j_shard(jstate, mesh, jcfg)
    placed = jax.tree_util.tree_map(lambda x: x.sharding, jstate)
    jstep = jax.jit(j_make_train_step(jcfg), out_shardings=(placed, None))
    put = j_put_batch(mesh)
    rec = _Recorder()
    draws, metrics = [], []
    for batch in batches:
        jstate, jm = jstep(jstate, put(batch))
        metrics.append({k: float(v) for k, v in jm.items()})
        draws.append(rec.take())
    return jstate, draws, metrics


_INITS = {}


def _jax_transformer(flags, batches, world, axis="dp", **jflags):
    """JAX's 3 steps of the small Transformer on a ``world`` mesh of
    ``axis``: (port init state dict, draws, metrics, final params flat,
    final batch_stats flat, initial params flat)."""
    small = dict(W.SMALL, **flags)
    jcfg = JConfig(**{**small, "attention": "dense"}, **jflags)
    key = tuple(sorted(flags.items()))
    if key not in _INITS:
        _INITS[key] = _jax_init(jcfg)
    jstate0 = _INITS[key]
    jstate, draws, metrics = _jax_steps(
        jcfg.replace(mesh_axes=(axis,)), jstate0, batches,
        _jax_mesh(world, axis))
    p0 = jstate0.params["model"]
    model = cli.build_model(TrainConfig(**small), vocab_size=VOCAB,
                            device="cpu")
    load_jax_tree(model, {"params": p0, "batch_stats": jstate0.batch_stats})
    init = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return (init, draws, metrics,
            flatten(jax.tree_util.tree_map(np.asarray,
                                           jstate.params["model"])),
            flatten(jax.tree_util.tree_map(np.asarray, jstate.batch_stats)),
            flatten(p0))


def _port_params(leaves, n_heads=4):
    sd = {k[len("model/"):]: torch.from_numpy(v) for k, v in leaves.items()
          if k.startswith("model/")}
    return flatten(params_to_jax(sd, n_heads))


def _check_against_jax(res, jax_run, world, loss_tol=1e-5):
    """Each step's loss, the final parameters and the ranks' agreement."""
    _, _, jmetrics, jparams, _, start = jax_run
    assert len(res) == world
    for i, jm in enumerate(jmetrics):
        np.testing.assert_allclose(res[0]["metrics"][i]["loss"], jm["loss"],
                                   rtol=0, atol=loss_tol, err_msg=f"step {i}")
        for r in res:   # every rank's whole state after every step
            assert r["digests"][i] == res[0]["digests"][i], i
    got = _port_params(res[0]["leaves"])
    assert sorted(got) == sorted(jparams)
    for k in jparams:
        np.testing.assert_allclose(got[k], jparams[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    assert max(np.abs(jparams[k] - start[k]).max() for k in jparams) > 1e-3


CLS_FLAGS = dict(attention="flash")
PATH_B = dict(ffn_impl="pallas", quant="int8", attention="dense")
LM = dict(task="lm", attention="dense")
VARIANTS = {
    "dp": ({}, ("dp",)),
    "dp_overlap": ({"overlap_grad_reduce": True, "overlap_bucket_mb": 1},
                   ("dp",)),
    "dp_offload": ({"offload_opt_state": True, "host_offload": True},
                   ("dp",)),
    "fsdp": ({"fsdp": True}, ("fsdp",)),
    "fsdp_offload": ({"fsdp": True, "host_offload": True,
                      "offload_opt_state": True}, ("fsdp",)),
    "zero1": ({"zero1": True}, ("dp",)),
    "zero1_offload": ({"zero1": True, "offload_opt_state": True}, ("dp",)),
}
DP = {"dp": VARIANTS["dp"]}
HW = 16
RESNET = dict(model="resnet18", dataset="synthetic", num_classes=10,
              lr=0.1, batch_size=B, epochs=1, use_ngd=True,
              meta_learning=True, ngd_rank=1, precision="fp32")


def _single_process(init, batches, draws, flags=CLS_FLAGS):
    """The same steps in this process, no process group."""
    cfg, state = W.build_state(flags, init, place=False)
    step = make_train_step(cfg)
    metrics = []
    for batch, d in zip(batches, draws):
        state, m = step(state, to_device(batch, "cpu"), StepDraws(**d))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _jax_resnet():
    """JAX's 3 steps of resnet18 (NGD, meta mixup) on the global batch
    (jitted on one device: its dp mesh computes this function, which
    the JAX package's own mesh tests hold): (port init, meta lambda,
    batches, draws, losses, final JAX state)."""
    from faster_distributed_training_tpu.train.amp import fresh_loss_scale
    from faster_distributed_training_tpu.train.mixup import (
        init_meta_lambda as j_init_meta_lambda)
    from faster_distributed_training_tpu.train.state import (
        TrainState as JTrainState)
    from faster_distributed_training_tpu_torch.interop import (
        resnet_from_jax)

    jcfg = JConfig(device="cpu", **RESNET)
    jtx, _ = j_build_optimizer(jcfg, steps_per_epoch=8)
    rng = jax.random.PRNGKey(0)
    model = jcli.build_model(jcfg)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k, x: model.init({"params": k,
                                 "dropout": jax.random.fold_in(k, 1),
                                 "mixup": jax.random.fold_in(k, 2)}, x,
                                train=True))(
        rng, jnp.zeros((B, HW, HW, 3), jnp.float32)))
    lam0 = np.asarray(j_init_meta_lambda(rng, B))
    jparams = {"model": variables["params"], "mixup_lambda": lam0}
    jstate = JTrainState(
        step=jnp.asarray(0, jnp.int32), params=jparams,
        batch_stats=variables["batch_stats"], opt_state=jtx.init(jparams),
        loss_scale=fresh_loss_scale(), rng=rng, apply_fn=model.apply,
        tx=jtx)
    jstep = jax.jit(j_make_train_step(jcfg))
    data = np.random.default_rng(1)
    batches, draws, losses = [], [], []
    for i in range(3):
        batch = {"image": data.normal(size=(B, HW, HW, 3)).astype(np.float32),
                 "label": data.integers(0, 10, B).astype(np.int32)}
        k_mix, _ = jax.random.split(jax.random.fold_in(rng, i))
        draws.append(dict(seeds=(), lam=1.0, perm=np.asarray(
            jax.random.permutation(k_mix, B))))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        batches.append(batch)
        losses.append(float(jm["loss"]))
    port = cli.build_model(TrainConfig(device="cpu", **RESNET), device="cpu")
    port.load_state_dict(resnet_from_jax(variables["params"],
                                         variables["batch_stats"]))
    init = {k: v.numpy().copy() for k, v in port.state_dict().items()}
    return init, lam0, batches, draws, losses, jstate


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every JAX reference, the single-process steps, and the port's
    groups, running side by side: 2 gloo ranks for every world-2 case
    (two groups), 4 for dp=4 and 1 for dp=1."""
    tmp = tmp_path_factory.mktemp("groups")
    # the ranks start now and wait for their arguments while JAX runs
    groups = {"first": W.start("many", 2, str(tmp / "first")),
              "dp4": W.start("run_steps", 4, str(tmp / "dp4")),
              "dp1": W.start("run_steps", 1, str(tmp / "dp1")),
              "second": W.start("many", 2, str(tmp / "second"))}
    try:
        return _run_groups(tmp, groups)
    finally:
        for g in groups.values():
            W.kill(g)


def _run_groups(tmp, groups) -> dict:
    """The fixture's work, its groups started: the JAX references, then
    each group fed its arguments and collected."""
    cls, path_b, lm = _cls_batches(3), _cls_batches(3, seed=7), _lm_batches(3)
    jobs = {"cls": (CLS_FLAGS, cls, 2, "dp", {}),
            "fsdp": (CLS_FLAGS, cls, 2, "fsdp", {"fsdp": True}),
            "zero1": (CLS_FLAGS, cls, 2, "dp", {"zero1": True}),
            "dp4": (CLS_FLAGS, cls, 4, "dp", {}),
            "path_b": (PATH_B, path_b, 2, "dp", {}),
            "lm": (LM, lm, 2, "dp", {})}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FDT_FORCE_PALLAS_INTERPRET", "1")
        _Recorder.install(mp)
        for flags in (CLS_FLAGS, PATH_B, LM):
            _INITS[tuple(sorted(flags.items()))] = _jax_init(JConfig(
                **{**W.SMALL, **flags, "attention": "dense"}))
        # XLA compiles release the GIL: the references compile side by
        # side on threads, each recording its own draws
        with ThreadPoolExecutor(len(jobs) + 1) as ex:
            futs = {n: ex.submit(_jax_transformer, f, bt, w, axis=ax, **kw)
                    for n, (f, bt, w, ax, kw) in jobs.items()}
            futs["resnet"] = ex.submit(_jax_resnet)
            jax_runs = {n: f.result() for n, f in futs.items()}
    init, draws = jax_runs["cls"][0], jax_runs["cls"][1]
    single, metrics = _single_process(init, cls, draws)
    ck = str(tmp / "ck")
    one, _ = _single_process(init, cls[:2], draws[:2])
    ckpt.save_checkpoint(ck, "one", one, 0, 0.0)
    step_kw = dict(cfg_kw=CLS_FLAGS, init=init, batches=cls, draws=draws)
    rn = jax_runs["resnet"]
    first = {
        "cls": ("run_steps", dict(step_kw, variants=VARIANTS,
                                  ckpt_dir=ck)),
        "restore_dp": ("restore", dict(cfg_kw=CLS_FLAGS, init=init,
                                       ckpt_dir=ck, name="one")),
        "restore_fsdp": ("restore", dict(cfg_kw=CLS_FLAGS, init=init,
                                         ckpt_dir=ck, name="one",
                                         mesh_axes=("fsdp",),
                                         over={"fsdp": True})),
        "cli": ("cli_runs", dict(ckpt_root=str(tmp / "cli"))),
        "collectives": ("collectives", {}),
        "clock_skew": ("clock_skew", dict(ckpt_root=str(tmp / "skew"))),
    }
    second = {
        "path_b": ("run_steps", dict(
            cfg_kw=PATH_B, init=jax_runs["path_b"][0], batches=path_b,
            draws=jax_runs["path_b"][1], variants=DP)),
        "lm": ("run_steps", dict(cfg_kw=LM, init=jax_runs["lm"][0],
                                 batches=lm, draws=jax_runs["lm"][1],
                                 variants=DP)),
        "resnet": ("run_steps", dict(cfg_kw=RESNET, init=rn[0], batches=rn[2],
                                     draws=rn[3], variants=DP,
                                     extra={"mixup_lambda": rn[1]})),
    }
    # the draws do not depend on the mesh (JAX's partitionable threefry):
    # dp=4 takes dp=2's, and its test checks that
    W.feed(groups["first"], cases=first)
    W.feed(groups["dp4"], variants=DP, **step_kw)
    W.feed(groups["dp1"], **step_kw, variants={
        "dp": VARIANTS["dp"], "fsdp": VARIANTS["fsdp_offload"]})
    W.feed(groups["second"], cases=second)
    a, dp4, dp1, b = (W.wait(g, TIMEOUT) for g in groups.values())

    port = {name: [r[name] for r in a] for name in first}
    port.update({name: [r[name] for r in b] for name in second})
    port["dp4"] = [r["dp"] for r in dp4]
    return {"cls": cls, "jax": jax_runs, "single": (single, metrics),
            "one": W.whole_leaves(one), "ck": ck, "port": port,
            "dp1": dp1[0]}


def _variant(runs, case, name="dp"):
    return [r[name] for r in runs["port"][case]]


def test_dp2_matches_jax_dp_mesh(runs):
    _check_against_jax(_variant(runs, "cls"), runs["jax"]["cls"], 2)


def test_dp4_matches_jax_dp_mesh(runs):
    jrun = runs["jax"]["dp4"]
    assert all(
        a["seeds"] == b["seeds"] and a["lam"] == b["lam"]
        and np.array_equal(a["perm"], b["perm"])
        for a, b in zip(jrun[1], runs["jax"]["cls"][1]))
    _check_against_jax(runs["port"]["dp4"], jrun, 4)


@pytest.mark.parametrize("name", ["fsdp", "zero1"])
def test_fsdp_and_zero1_match_jax_meshes(runs, name):
    _check_against_jax(_variant(runs, "cls", name), runs["jax"][name], 2)


@pytest.mark.parametrize("plain,offload", [
    ("dp", "dp_offload"), ("fsdp", "fsdp_offload"),
    ("zero1", "zero1_offload")])
def test_offload_is_bitwise_no_offload(runs, plain, offload):
    a, b = _variant(runs, "cls", plain), _variant(runs, "cls", offload)
    assert [r["digests"] for r in a] == [r["digests"] for r in b]
    assert a[0]["metrics"] == b[0]["metrics"]
    for k, v in a[0]["leaves"].items():
        assert np.array_equal(v, b[0]["leaves"][k]), k


def test_overlap_grad_reduce_is_allclose(runs):
    a = _variant(runs, "cls")[0]
    b = _variant(runs, "cls", "dp_overlap")[0]
    for ma, mb in zip(a["metrics"], b["metrics"]):
        np.testing.assert_allclose(mb["loss"], ma["loss"], rtol=0, atol=1e-6)
    for k, v in a["leaves"].items():
        np.testing.assert_allclose(b["leaves"][k], v, rtol=0, atol=1e-6,
                                   err_msg=k)


def test_dp1_over_gloo_is_bitwise_no_group(runs):
    single, metrics = runs["single"]
    want = W.whole_leaves(single)
    for name in ("dp", "fsdp"):
        got = runs["dp1"][name]
        for gm, m in zip(got["metrics"], metrics):
            assert gm["loss"] == m["loss"] and gm["correct"] == m["correct"]
        assert sorted(got["leaves"]) == sorted(want)
        for k, v in want.items():
            assert np.array_equal(got["leaves"][k], v), (name, k)


def test_checkpoints_interchange_between_dp2_and_dp1(runs):
    jrun = runs["jax"]["cls"]
    # dp=2 and fsdp=2 saved (rank 0, the gathered state); one process
    # without a group restores each bitwise
    for name in ("dp", "fsdp"):
        _, state = W.build_state(CLS_FLAGS, jrun[0], place=False)
        ckpt.restore_checkpoint(runs["ck"], name, state)
        got = W.whole_leaves(state)
        want = _variant(runs, "cls", name)[0]["leaves"]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert np.array_equal(got[k], v), (name, k)
    # the other way round: one process saved, dp=2 and fsdp=2 restored
    for case in ("restore_dp", "restore_fsdp"):
        for r in runs["port"][case]:
            assert sorted(r["leaves"]) == sorted(runs["one"])
            for k, v in runs["one"].items():
                assert np.array_equal(r["leaves"][k], v), (case, k)


def test_path_b_int8_matches_jax_with_global_amax_histories(runs):
    from faster_distributed_training_tpu_torch.interop import (
        batch_stats_to_jax)

    res, jrun = _variant(runs, "path_b"), runs["jax"]["path_b"]
    _check_against_jax(res, jrun, 2)
    sd = {k[len("model/"):]: torch.from_numpy(v)
          for k, v in res[0]["leaves"].items() if k.startswith("model/")}
    got, want = flatten(batch_stats_to_jax(sd)), jrun[4]
    assert sorted(got) == sorted(want) and want
    for k in want:
        assert want[k].any(), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0,
                                   err_msg=k)


def test_lm_with_ragged_padding_matches_jax(runs):
    # the ranks' target counts differ: the global count divides the loss
    batches = _lm_batches(3)
    counts = [int((b["mask"][:, :-1] * b["mask"][:, 1:])[s].sum())
              for b in batches[:1] for s in (slice(0, 4), slice(4, 8))]
    assert counts[0] < counts[1] / 2
    res, jrun = _variant(runs, "lm"), runs["jax"]["lm"]
    _check_against_jax(res, jrun, 2)
    for m, jm in zip(res[0]["metrics"], jrun[2]):
        assert m["total"] == jm["total"]
        np.testing.assert_allclose(m["loss_total"], jm["loss_total"],
                                   rtol=1e-5, atol=0)


def test_resnet_ngd_meta_matches_jax(runs):
    from faster_distributed_training_tpu_torch.interop import resnet_to_jax

    res = _variant(runs, "resnet")
    _, _, _, _, jlosses, jstate = runs["jax"]["resnet"]
    for i, want in enumerate(jlosses):
        np.testing.assert_allclose(res[0]["metrics"][i]["loss"], want,
                                   rtol=3e-5, atol=0, err_msg=f"step {i}")
        assert res[1]["digests"][i] == res[0]["digests"][i]
    leaves = res[0]["leaves"]
    params, stats = resnet_to_jax(
        {k[len("model/"):]: torch.from_numpy(v) for k, v in leaves.items()
         if k.startswith("model/")})
    for mine, theirs in ((params, jstate.params["model"]),
                         (stats, jstate.batch_stats)):
        got = flatten(mine)
        want = flatten(jax.tree_util.tree_map(np.asarray, theirs))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                       err_msg=k)
    np.testing.assert_allclose(leaves["extra/mixup_lambda"],
                               np.asarray(jstate.params["mixup_lambda"]),
                               rtol=0, atol=1e-4)


def test_entry_points_train_under_the_mesh_flags(runs):
    out = runs["port"]["cli"]
    for r in out:
        for name, got in r.items():
            assert got["step"] == got["steps_per_epoch"] > 0, name
            assert np.isfinite(got["train_loss"]), name
    # the same numbers on both ranks, and the learning rate doubled
    assert out[0] == out[1]
    assert out[0]["dp"]["lr0"] == 2 * out[0]["dp"]["lr0_one"]


@pytest.mark.parametrize("name", ["fsdp", "zero1", "fsdp_offload",
                                  "zero1_offload"])
def test_placement_table_follows_the_sharding_rules(runs, name):
    """Every leaf's shard dim and host tier: fsdp shards the parameters
    and their optimizer mirrors by ``fsdp_partition_params``, zero1 the
    mirrors only; ``--host_offload`` parks every leaf,
    ``--offload_opt_state`` the optimizer leaves ``offload_opt_leaf``
    picks."""
    from faster_distributed_training_tpu_torch.parallel import (
        fsdp_partition_params, offload_opt_leaf)

    res = _variant(runs, "cls", name)[0]
    over = VARIANTS[name][0]
    shapes = {k[len("model/"):]: v.shape for k, v in res["leaves"].items()
              if k.startswith("model/") and "amax" not in k}
    table = res["table"]
    params = {k[len("params/"):]: v for k, v in table.items()
              if k.startswith("params/")}
    dims = fsdp_partition_params(
        {k: torch.empty(shapes[k]) for k in params}, 2)
    assert any(d is not None for d in dims.values())
    for k, row in params.items():
        assert row["dim"] == (dims[k] if over.get("fsdp") else None), k
        assert row["host"] == bool(over.get("host_offload")), k
    for path, row in table.items():
        if not path.startswith("opt/"):
            continue
        k = path.split("/")[-1]
        assert row["dim"] == dims[k], path
        assert row["host"] == (bool(over.get("host_offload")) or (
            bool(over.get("offload_opt_state"))
            and offload_opt_leaf(shapes[k]))), path


def test_a_time_cadence_save_is_decided_once_for_every_rank(runs):
    """Rank 1's clock says a ``--checkpoint_every_secs`` save is due every
    step, rank 0's never: both follow rank 0 (a save is collective; a
    rank alone in it would wait for the others until the timeout)."""
    out = runs["port"]["clock_skew"]
    assert out[0] == out[1]
    assert out[0]["step"] > 0 and out[0]["saved"] == 0


def test_host_value_collectives_keep_int64_and_fp64(runs):
    for r in runs["port"]["collectives"]:
        np.testing.assert_array_equal(
            r["gathered"], [[2 ** 40, -(2 ** 33)], [2 ** 40 + 1, -(2 ** 33)]])
        assert r["gathered"].dtype == np.int64
        assert r["fp64"].tolist() == [1 / 3, 1 / 3 + 1]
        np.testing.assert_array_equal(r["summed"], [1.0, 3.0])
        assert r["metrics"] == {"bytes": float(2 ** 41 + 1), "files": 3.0}


@pytest.mark.parametrize("flags,name", [
    (["--mesh", "dp=1,tp=2", "--task", "lm"], "--mesh tp=2"),
    (["--mesh", "seq=2", "--remat"], "--mesh sp=2"),
    (["--mesh", "pp=2", "--remat"], "--mesh pp=2"),
    (["--fsdp", "--optimizer", "ngd"], "--ngd with --fsdp"),
    (["--zero1", "--ngd", "--model", "resnet18", "--dataset", "synthetic"],
     "--ngd with --zero1"),
    (["--fsdp", "--steps_per_dispatch", "2"],
     "--fsdp with --steps_per_dispatch 2"),
    (["--zero1", "--host_offload", "--steps_per_dispatch", "4"],
     "--zero1 / --host_offload with --steps_per_dispatch 4"),
    (["--offload_opt_state", "--data_path", "resident"],
     "--offload_opt_state with --data_path resident"),
    (["--data_path", "resident", "--resident_layout", "sharded"],
     "--resident_layout sharded"),
])
def test_unported_mesh_flags_raise_by_name(tmp_path, flags, name):
    argv = ["--dataset", "synthetic", "--device", "cpu", "--no_plot",
            "--checkpoint_dir", str(tmp_path)]
    cfg = cli.config_from_args(cli.build_parser(
        defaults=cli.TRANSFORMER_DEFAULTS).parse_args(argv + flags),
        defaults=cli.TRANSFORMER_DEFAULTS)
    assert any(name in f for f in cli.unported_training_flags(cfg))
    with pytest.raises(NotImplementedError, match=name.replace("|", r"\|")):
        cli.main(argv + flags, defaults=cli.TRANSFORMER_DEFAULTS)
