"""The port's ResNet slice against the JAX package.

  * ``ops.conv_bn.fused_conv_bn`` forward (out, mean, var) and VJP
    against ``jax.vjp`` of JAX ``ops/conv_bn.py::fused_conv_bn`` at
    stride 1 and 2, with one channel whose variance is 0 (the
    ``max(sqrt_var, 1e-12)`` guard), and the autograd arm
    (``remat=False``, no zero-variance channel) against JAX
    ``conv_bn_train(remat=False)``: fp32 1e-5 and bf16 2e-2, of max
    |JAX|.
  * The Function's backward against autograd through its plain version
    ``conv_bn_reference``: fp32 1e-5.
  * ``models.resnet`` logits in train and eval mode and the updated
    ``batch_stats`` against JAX ``models/resnet.py`` (flax) on converted
    weights, resnet18 and resnet50 at 16x16 images, batch 4: fp32 1e-4
    of max |JAX| (logits) and 1e-4 (stats); bf16 eval 5e-2, bf16 train
    mode within twice JAX's own bf16-to-fp32 distance.
  * 3 train steps of resnet18 with ``--ngd --meta_learning`` against
    JAX's real ``train/steps.py::make_train_step`` (jitted) on float
    images (no augmentation) with JAX's mixup permutation handed over,
    batch 8 at 16x16, fp32 and ``--precision fp16``.  The NGD rank is 1
    (``--ngd_rank 1``) so every axis-state has N >= rank: below that
    (BN scales and biases have N = 1 at the default rank) the factors
    follow rounding noise in both packages and no two implementations
    share a trajectory (``tests/test_torch_ngd.py`` holds those leaves
    for one step and by their invariants).  Loss 3e-5 relative each
    step, parameters, BN stats and the mixup lambda 1e-4 after 3 steps.
    Measured: loss equal at step 1, ~1e-6 at step 2 and 1.3e-5 relative
    at step 3; parameters 1.1e-5.  The first update's stem gradient
    differs by ~1e-5 relative (fp32 sums in another order through the
    backward) and each step multiplies the parameter drift by about 6.
  * Resume within the port: a run killed before step 4 and resumed
    equals a straight 8-step run bitwise (parameters, BN stats, the
    mixup lambda, the NGD factors and counter, momentum).
  * ``--precision fp16`` skips a step with non-finite grads (state kept,
    step and loss scale advance), as the JAX step does.
  * The entry points: ``resnet50_test`` trains, evaluates, checkpoints
    and resumes on the CPU at a tiny size, every mixup mode, SGD and fp16
    run, ``--data_path stream`` raises naming the flag.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax  # noqa: F401  (the JAX optimizer chain)
import pytest
import torch

from faster_distributed_training_tpu import cli as jcli
from faster_distributed_training_tpu.config import TrainConfig as JConfig
from faster_distributed_training_tpu.models.resnet import (
    resnet18 as j_resnet18, resnet50 as j_resnet50)
from faster_distributed_training_tpu.ops.conv_bn import (
    conv_bn_train as j_conv_bn_train, fused_conv_bn as j_fused_conv_bn)
from faster_distributed_training_tpu.optim import (
    build_optimizer as j_build_optimizer)
from faster_distributed_training_tpu.train.mixup import (
    init_meta_lambda as j_init_meta_lambda)
from faster_distributed_training_tpu.train.amp import fresh_loss_scale
from faster_distributed_training_tpu.train.state import (
    TrainState as JTrainState)
from faster_distributed_training_tpu.train.steps import (
    make_train_step as j_make_train_step)
from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.interop import (
    flatten, resnet_from_jax, resnet_to_jax)
from faster_distributed_training_tpu_torch.models import get_model
from faster_distributed_training_tpu_torch.ops.conv_bn import (
    conv_bn_reference, conv_bn_train, fused_conv_bn)
from faster_distributed_training_tpu_torch.optim import (build_optimizer,
                                                         layouts_of)
from faster_distributed_training_tpu_torch.train import checkpoint as ckpt
from faster_distributed_training_tpu_torch.train.state import (
    create_train_state, state_leaves)
from faster_distributed_training_tpu_torch.train.steps import (
    StepDraws, make_train_step, to_device)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes,
    and torch's default of a thread a core in each of them oversubscribes
    the CPU (the ResNet CLI runs slowed 75x under the whole suite)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max()
                 / max(np.abs(np.asarray(want, np.float64)).max(), 1e-30))


# -- fused conv + BN ---------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("remat", [True, False])
def test_fused_conv_bn_matches_jax(stride, dtype, tol, remat):
    rng = np.random.default_rng(stride)
    x = rng.normal(size=(4, 9, 9, 5)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 5, 6)) * 0.3).astype(np.float32)
    if remat:
        # an output channel with var == 0: the fused backward bounds its
        # d_var term; autodiff through sqrt(0) gives NaN in both packages
        w[..., 0] = 0.0
    ho = (9 - 1) // stride + 1
    g = rng.normal(size=(4, ho, ho, 6)).astype(np.float32)
    jdt = jnp.dtype(dtype)

    def jfun(a, b):
        if remat:
            return j_fused_conv_bn(a, b, stride, 1, 1e-3)
        return j_conv_bn_train(a, b, stride, 1, 1e-3, remat=False)

    (out, mean, var), vjp = jax.vjp(jfun, jnp.asarray(x, jdt),
                                    jnp.asarray(w, jdt))
    dx, dw = vjp((jnp.asarray(g, jdt), jnp.zeros_like(mean),
                  jnp.zeros_like(var)))

    tdt = getattr(torch, dtype)
    xt = torch.tensor(x).permute(0, 3, 1, 2).to(tdt).requires_grad_()
    wt = torch.tensor(w).permute(3, 2, 0, 1).to(tdt).requires_grad_()
    if remat:
        o, m, v = fused_conv_bn(xt, wt, stride, 1, 1e-3)
    else:
        o, m, v = conv_bn_train(xt, wt, stride, 1, 1e-3, remat=False)
    dxt, dwt = torch.autograd.grad(
        o, (xt, wt), torch.tensor(g).permute(0, 3, 1, 2).to(tdt))
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    n = lambda t: t.detach().float().numpy()                  # noqa: E731
    assert _rel(n(o.permute(0, 2, 3, 1)), f32(out)) <= tol
    assert _rel(n(m), f32(mean)) <= tol
    assert _rel(n(v), f32(var)) <= tol
    assert float(v[0]) == 0.0 or not remat
    assert _rel(n(dxt.permute(0, 2, 3, 1)), f32(dx)) <= tol
    assert _rel(n(dwt.permute(2, 3, 1, 0)), f32(dw)) <= tol


def test_fused_conv_bn_backward_matches_plain_autograd():
    """The Function's hand-derived backward (recomputed conv output)
    against autograd through ``conv_bn_reference``, fp32 1e-5 of max."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 5, 9, 9, generator=gen, requires_grad=True)
    w = (torch.randn(6, 5, 3, 3, generator=gen) * 0.3).requires_grad_()
    g = torch.randn(4, 6, 5, 5, generator=gen)
    out, _, _ = fused_conv_bn(x, w, 2, 1)
    want_out = conv_bn_reference(x, w, 2, 1)
    got = torch.autograd.grad(out, (x, w), g)
    want = torch.autograd.grad(want_out, (x, w), g)
    assert torch.equal(out, want_out)
    for a, b in zip(got, want):
        assert _rel(a.numpy(), b.numpy()) <= 1e-5


# -- the model -----------------------------------------------------------------

_JFACTORY = {"resnet18": j_resnet18, "resnet50": j_resnet50}


@pytest.fixture(scope="module")
def jax_variables():
    """flax variables of resnet18 and resnet50 at 16x16, initialized once."""
    out = {}
    for name, make in _JFACTORY.items():
        model = make(dtype=jnp.float32)
        v = jax.jit(lambda k, x, m=model: m.init(k, x, train=True))(
            jax.random.PRNGKey(3), jnp.zeros((4, 16, 16, 3), jnp.float32))
        out[name] = jax.tree_util.tree_map(np.asarray, v)
    return out


def _flax_logits(name, dtype, v, x):
    model = _JFACTORY[name](dtype=dtype)
    apply = jax.jit(lambda vv, xx, train: model.apply(
        vv, xx, train=train, mutable=["batch_stats"] if train else False),
        static_argnums=2)
    (train, mutated), ev = apply(v, jnp.asarray(x), True), apply(
        v, jnp.asarray(x), False)
    return np.asarray(train), np.asarray(ev), mutated


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_resnet_logits_and_stats_match_flax(jax_variables, name, precision):
    """fp32: logits 1e-4 of max |JAX|, stats 1e-4.  bf16: eval logits
    5e-2 of max |JAX bf16|; train-mode logits within twice JAX's own
    bf16 distance from its fp32 logits (measured on resnet50 at 16x16:
    JAX 0.17, the port 0.18 of max |fp32|; train-mode BN at batch 4
    amplifies bf16 rounding through the blocks, so two bf16 runs sit
    that far apart whichever package runs them)."""
    v = jax_variables[name]
    x = np.random.default_rng(0).normal(size=(4, 16, 16, 3)).astype(np.float32)
    want_train, want_eval, mutated = _flax_logits(name, jnp.float32, v, x)
    tdt = torch.float32
    if precision == "bf16":
        ref_train = want_train
        want_train, want_eval, _ = _flax_logits(name, jnp.bfloat16, v, x)
        tdt = torch.bfloat16

    model = get_model(name, 10, dtype=tdt)
    model.load_state_dict(resnet_from_jax(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got_train = model(torch.tensor(x), train=True)
        # the running stats the training forward left behind
        _, got_stats = resnet_to_jax(model.state_dict())
        model.load_state_dict(resnet_from_jax(v["params"], v["batch_stats"]))
        got_eval = model(torch.tensor(x), train=False)
    assert got_train.dtype == got_eval.dtype == torch.float32
    if precision == "bf16":
        assert _rel(got_eval.numpy(), want_eval) <= 5e-2
        assert (_rel(got_train.numpy(), ref_train)
                <= 2 * _rel(want_train, ref_train))
        return
    assert _rel(got_train.numpy(), want_train) <= 1e-4
    assert _rel(got_eval.numpy(), want_eval) <= 1e-4
    want_stats = flatten(jax.tree_util.tree_map(np.asarray,
                                                mutated["batch_stats"]))
    got_stats = flatten(got_stats)
    assert sorted(got_stats) == sorted(want_stats)
    for k in want_stats:
        np.testing.assert_allclose(got_stats[k], want_stats[k], rtol=0,
                                   atol=1e-4, err_msg=k)


def test_interop_round_trip(jax_variables):
    v = jax_variables["resnet50"]
    sd = resnet_from_jax(v["params"], v["batch_stats"])
    model = get_model("resnet50", 10)
    model.load_state_dict(sd)          # every leaf and buffer, strictly
    params, stats = resnet_to_jax(model.state_dict())
    for mine, theirs in ((params, v["params"]), (stats, v["batch_stats"])):
        a, b = flatten(mine), flatten(jax.tree_util.tree_map(np.asarray,
                                                             theirs))
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].shape == b[k].shape and np.array_equal(a[k], b[k]), k


# -- three train steps against JAX make_train_step --------------------------

B, HW = 8, 16
STEP_KW = dict(model="resnet18", dataset="synthetic", num_classes=10, lr=0.1,
               batch_size=B, epochs=1, use_ngd=True, meta_learning=True,
               ngd_rank=1, telemetry=False, plot=False)


@pytest.fixture(scope="module")
def jax_start():
    """The JAX train state's initial params and stats (resnet18, 16x16,
    with the meta lambda), shared by the step tests."""
    cfg = JConfig(device="cpu", precision="fp32", **STEP_KW)
    tx, _ = j_build_optimizer(cfg, steps_per_epoch=8)
    rng = jax.random.PRNGKey(0)
    model = jcli.build_model(cfg)
    variables = jax.jit(lambda k, x: model.init(
        {"params": k, "dropout": jax.random.fold_in(k, 1),
         "mixup": jax.random.fold_in(k, 2)}, x, train=True))(
        rng, jnp.zeros((B, HW, HW, 3), jnp.float32))
    lam = np.asarray(j_init_meta_lambda(rng, B))
    return jax.tree_util.tree_map(np.asarray, variables), lam


@pytest.mark.parametrize("precision", ["fp32", "fp16"])
def test_three_resnet_steps_match_jax_make_train_step(jax_start, precision):
    variables, lam0 = jax_start
    jcfg = JConfig(device="cpu", precision=precision, **STEP_KW)
    jtx, _ = j_build_optimizer(jcfg, steps_per_epoch=8)
    jparams = {"model": jax.tree_util.tree_map(jnp.asarray,
                                               variables["params"]),
               "mixup_lambda": jnp.asarray(lam0)}
    # train/state.py::create_train_state's state, on the shared init
    jstate = JTrainState(
        step=jnp.asarray(0, jnp.int32), params=jparams,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=jtx.init(jparams), loss_scale=fresh_loss_scale(),
        rng=jax.random.PRNGKey(0), apply_fn=jcli.build_model(jcfg).apply,
        tx=jtx)
    jstep = jax.jit(j_make_train_step(jcfg))

    cfg = TrainConfig(device="cpu", precision=precision, **STEP_KW)
    model = cli.build_model(cfg, device="cpu")
    model.load_state_dict(resnet_from_jax(variables["params"],
                                          variables["batch_stats"]))
    tx, _ = build_optimizer(cfg, steps_per_epoch=8,
                            layouts=layouts_of(model))
    state = create_train_state(model, tx, 0,
                               extra={"mixup_lambda": torch.tensor(lam0)})
    step = make_train_step(cfg)

    rng = np.random.default_rng(1)
    for i in range(3):
        batch = {"image": rng.normal(size=(B, HW, HW, 3)).astype(np.float32),
                 "label": rng.integers(0, 10, B).astype(np.int32)}
        # JAX's mixup key for step i, and the permutation it draws
        k_mix, _ = jax.random.split(jax.random.fold_in(jstate.rng, i))
        perm = np.asarray(jax.random.permutation(k_mix, B))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, to_device(batch, "cpu"),
                        StepDraws(seeds=(), lam=1.0, perm=perm))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=3e-5, atol=0, err_msg=f"step {i}")
        np.testing.assert_allclose(float(m["correct"]), float(jm["correct"]),
                                   atol=1e-4)
        if precision == "fp16":
            assert float(m["loss_scale"]) == float(jm["loss_scale"])
    params, stats = resnet_to_jax(model.state_dict())
    start = flatten(variables["params"])
    for mine, theirs in ((params, jstate.params["model"]),
                         (stats, jstate.batch_stats)):
        got = flatten(mine)
        want = flatten(jax.tree_util.tree_map(np.asarray, theirs))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                       err_msg=k)
    np.testing.assert_allclose(
        state.extra["mixup_lambda"].detach().numpy(),
        np.asarray(jstate.params["mixup_lambda"]), rtol=0, atol=1e-4)
    # the parameters did move, by much more than the tolerance
    want = flatten(jax.tree_util.tree_map(np.asarray,
                                          jstate.params["model"]))
    assert max(np.abs(want[k] - start[k]).max() for k in want) > 1e-3


# -- the entry points ----------------------------------------------------------

TINY = ["--device", "cpu", "--model", "resnet18", "--dataset", "synthetic",
        "--bs", "4", "--epoch", "1", "--subset_stride", "128", "--no_plot",
        "--no_telemetry", "--log_every", "0"]


class _Killed(Exception):
    pass


def test_resnet_resume_is_bitwise(tmp_path, monkeypatch):
    """32 training images (subset stride 128), batch 4: 8 steps an
    epoch; a checkpoint every 3 steps; the kill comes before step 4."""
    from faster_distributed_training_tpu_torch.train import steps as tsteps

    from faster_distributed_training_tpu_torch.resnet50_test import DEFAULTS

    argv = TINY + ["--ngd", "--meta_learning", "--checkpoint_every", "3",
                   "--epoch", "1"]
    straight = cli.main(argv + ["--checkpoint_dir", str(tmp_path / "a")],
                        defaults=DEFAULTS)
    assert straight["state"].step == 8
    real = tsteps.make_train_step

    def killed_after_3(cfg):
        step = real(cfg)

        def run(state, batch, draws=None):
            if state.step == 3:
                raise _Killed()
            return step(state, batch, draws)
        return run

    monkeypatch.setattr(tsteps, "make_train_step", killed_after_3)
    with pytest.raises(_Killed):
        cli.main(argv + ["--checkpoint_dir", str(tmp_path / "b")],
                 defaults=DEFAULTS)
    monkeypatch.setattr(tsteps, "make_train_step", real)
    assert ckpt.read_meta(str(tmp_path / "b"), "resnet_step")["step"] == 3
    resumed = cli.main(argv + ["--checkpoint_dir", str(tmp_path / "b"),
                               "--resume"], defaults=DEFAULTS)
    assert resumed["state"].step == 8
    assert resumed["state"].opt_state["ngd"]["t"] == 8
    a, b = state_leaves(straight["state"]), state_leaves(resumed["state"])
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("flags", [
    ["--ngd", "--meta_learning"], ["--mixup_mode", "static"],
    ["--mixup_mode", "intra"], ["--mixup_mode", "attn"],
    ["--mixup_mode", "none"], ["--optimizer", "sgd"],
    ["--precision", "fp16", "--ngd"], ["--tricks", "off"]],
    ids=["ngd-meta", "static", "intra", "attn", "none", "sgd", "fp16",
         "tricks-off"])
def test_resnet50_test_entry_trains_on_cpu(tmp_path, flags):
    from faster_distributed_training_tpu_torch.resnet50_test import DEFAULTS

    out = cli.main(TINY + flags + ["--checkpoint_dir", str(tmp_path)],
                   defaults=DEFAULTS)
    hist = out["history"]
    assert out["state"].step == out["steps_per_epoch"] == 8
    assert np.isfinite(hist["train_loss"]).all() and len(hist["test_acc"]) == 1
    assert ckpt.read_meta(str(tmp_path), "resnet") or hist["test_acc"] == [0]
    if "--precision" in flags:
        assert float(out["state"].loss_scale.scale) == 2.0 ** 16
    if "--tricks" in flags:
        assert out["cfg"].precision == "fp32"
        assert not out["state"].model.FusedConvBNLayer_0.conv_remat


def test_fp16_skips_a_non_finite_step():
    """--precision fp16: a step whose grads overflow is skipped (the JAX
    step's GradScaler policy): parameters, BN statistics, the mixup
    lambda and the optimizer state stay as they were, the step count
    advances and the loss scale halves; the next finite step updates."""
    from faster_distributed_training_tpu_torch.optim import (
        build_optimizer, layouts_of)

    cfg = TrainConfig(device="cpu", precision="fp16", **dict(
        STEP_KW, ngd_rank=-1))
    model = cli.build_model(cfg).init_weights(torch.Generator().manual_seed(0))
    tx, _ = build_optimizer(cfg, 8, layouts=layouts_of(model))
    state = create_train_state(model, tx, 0, extra=cli.resnet_extra_leaves(
        cfg, torch.Generator().manual_seed(1)))
    step = make_train_step(cfg)
    rng = np.random.default_rng(0)
    image = rng.normal(size=(B, HW, HW, 3)).astype(np.float32)
    label = rng.integers(0, 10, B).astype(np.int32)
    before = {k: v.clone() for k, v in state_leaves(state).items()}
    bad = dict(image=np.where(np.arange(B)[:, None, None, None] == 0,
                              np.float32(np.inf), image), label=label)
    state, m = step(state, to_device(bad, "cpu"))
    after = state_leaves(state)
    assert state.step == 1 and float(m["loss_scale"]) == 2.0 ** 15
    for k, v in before.items():
        if not k.startswith("loss_scale"):
            assert torch.equal(v, after[k]), k
    state, m = step(state, to_device({"image": image, "label": label},
                                     "cpu"))
    assert state.step == 2 and state.opt_state["ngd"]["t"] == 1
    assert np.isfinite(float(m["loss"]))
    assert not torch.equal(before["model/fc_kernel"],
                           state.model.fc_kernel.detach())


def test_resnet_unported_flags_raise(tmp_path):
    from faster_distributed_training_tpu_torch.resnet50_test import DEFAULTS

    argv = TINY + ["--checkpoint_dir", str(tmp_path)]
    for flags, name in ((["--data_path", "stream"], "--data_path stream"),
                        (["--dataset", "agnews"], "--dataset agnews"),
                        (["--optimizer", "adamw"], "adamw")):
        with pytest.raises(NotImplementedError, match=name):
            cli.main(argv + flags, defaults=DEFAULTS)
    with pytest.warns(UserWarning, match="full-precision"):
        out = cli.main(argv + ["--quant", "int8"], defaults=DEFAULTS)
    assert out["state"].step == 8
    # block remat trains (slice 9)
    out = cli.main(argv + ["--remat"], defaults=DEFAULTS)
    assert out["state"].step == 8 and out["state"].model.remat
