"""``--remat`` in the port against the JAX package's ``remat=True`` models
and against the port without remat.

  * Transformer, each ``--remat_policy`` (layer, ffn, attn_out, dots):
    one training forward and backward of ``sum(logits * w)`` on the same
    parameters, batch and draws as the JAX ``Transformer`` with
    ``remat=True`` and that policy (dense attention on both sides; JAX's
    draws recorded from its own forward): logits and gradients fp32 1e-5
    of max |JAX|.  Against the port without remat, on the dense route and
    on flash's plain versions (where the policies other than ffn take
    TPU row 5's recompute backward), with the flax FFN and the fused FFN:
    logits and gradients bitwise.
  * Under ``--quant int8`` every amax history rolls exactly once: equal to
    the port without remat, and to the JAX model's rolled
    ``batch_stats`` (1e-5 relative, the quant parity tolerance).
  * ResNet-18 remat (16x16, batch 4, fp32): gradients and BN running
    statistics bitwise equal to the port without remat, and within the
    ResNet parity tolerance (1e-4 of max |JAX| a leaf) of JAX's
    ``remat=True`` model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_distributed_training_tpu import cli as jcli
from faster_distributed_training_tpu.config import TrainConfig as JConfig
from faster_distributed_training_tpu.models.resnet import (
    resnet18 as j_resnet18)
from faster_distributed_training_tpu.optim import (
    build_optimizer as j_build_optimizer)
from faster_distributed_training_tpu.train.state import (
    create_train_state as j_create_train_state)
from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.interop import (
    flatten, load_jax_tree, params_from_jax, params_to_jax, resnet_from_jax,
    resnet_to_jax)
from faster_distributed_training_tpu_torch.models import get_model
from faster_distributed_training_tpu_torch.models.transformer import (
    REMAT_POLICIES)
from faster_distributed_training_tpu_torch.train.steps import StepDraws

SMALL = dict(model="transformer", dataset="synthetic", num_classes=4,
             lr=1e-2, batch_size=4, epochs=1, alpha=0.99, seq_len=32,
             n_layers=2, d_model=32, d_ff=64, n_heads=2, precision="fp32",
             telemetry=False, plot=False)
VOCAB = 50


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch():
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, VOCAB, (4, 32)).astype(np.int32)
    mask = np.ones((4, 32), np.int32)
    mask[1, 20:] = 0
    mask[3, 9:] = 0
    w = rng.normal(size=(4, 4)).astype(np.float32)
    return tokens * mask, mask, w


def _jax_run(jcfg, variables, draws_from=None):
    """One training forward and backward of the JAX model: (logits, grads
    by path, rolled batch_stats, the recorded draws)."""
    tokens, mask, w = _batch()
    model = jcli.build_model(jcfg, vocab_size=VOCAB)
    rec = {"bits": [], "beta": [], "permutation": []}

    def f(p):
        (logits, _, _), mutated = model.apply(
            {"params": p, "batch_stats": variables["batch_stats"]},
            jnp.asarray(tokens), token_types=jnp.zeros_like(tokens),
            mask=jnp.asarray(mask), train=True,
            rngs={"dropout": jax.random.PRNGKey(5),
                  "mixup": jax.random.PRNGKey(6)},
            mutable=["batch_stats"])
        return jnp.sum(logits * w), (logits, mutated)

    if draws_from is None:
        orig = {n: getattr(jax.random, n) for n in rec}
        try:
            for n, sink in rec.items():
                def wrapped(*a, _o=orig[n], _s=sink, **kw):
                    out = _o(*a, **kw)
                    _s.append(np.asarray(out))
                    return out
                setattr(jax.random, n, wrapped)
            g, (logits, mutated) = jax.grad(f, has_aux=True)(
                variables["params"])
        finally:
            for n, fn in orig.items():
                setattr(jax.random, n, fn)
    else:
        g, (logits, mutated) = jax.grad(f, has_aux=True)(variables["params"])
    draws = StepDraws(seeds=tuple(int(v) for b in rec["bits"]
                                  for v in np.ravel(b)),
                      lam=float(rec["beta"][0]) if rec["beta"] else 0.0,
                      perm=rec["permutation"][0] if rec["permutation"]
                      else None)
    return (np.asarray(logits), flatten(jax.tree_util.tree_map(np.asarray, g)),
            jax.tree_util.tree_map(np.asarray, mutated["batch_stats"]),
            draws)


def _port_run(cfg, variables, draws):
    """The port's forward and backward of the same loss: (logits, grads in
    the JAX layout by path, amax histories in the JAX layout)."""
    tokens, mask, w = _batch()
    model = cli.build_model(cfg, vocab_size=VOCAB, device="cpu")
    load_jax_tree(model, variables)
    logits, _, _ = model(torch.from_numpy(tokens),
                         token_types=torch.zeros(4, 32, dtype=torch.int32),
                         mask=torch.from_numpy(mask), train=True,
                         draws=draws)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad((logits * torch.from_numpy(w)).sum(),
                                [p for _, p in model.named_parameters()])
    sd = dict(model.state_dict())
    sd.update({n: g for n, g in zip(names, grads)})
    tree = params_to_jax(sd, cfg.n_heads)
    hists = {n: b.clone() for n, b in model.named_buffers()
             if "amax_history" in n}
    return logits.detach().numpy(), flatten(tree), hists


def _jax_start(jcfg):
    jtx, _ = j_build_optimizer(jcfg, steps_per_epoch=4)
    st = j_create_train_state(
        jcli.build_model(jcfg.replace(remat=False), vocab_size=VOCAB), jtx,
        jnp.zeros((4, 32), jnp.int32), jax.random.PRNGKey(0),
        init_kwargs={"train": True})
    return {"params": st.params["model"], "batch_stats": st.batch_stats}


def _close(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= tol * scale, (k, err, scale)


@pytest.mark.parametrize("policy", REMAT_POLICIES)
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_remat_policies_match_jax_remat_model(policy, quant):
    jcfg = JConfig(device="cpu", attention="dense", quant=quant, **SMALL)
    variables = _jax_start(jcfg)
    want_l, want_g, want_stats, draws = _jax_run(jcfg, variables)
    assert len(draws.seeds) == 2 + 4 * SMALL["n_layers"]
    remat_l, remat_g, remat_stats, _ = _jax_run(
        jcfg.replace(remat=True, remat_policy=policy), variables, draws)
    # the JAX remat model draws the same masks: its forward is unchanged
    np.testing.assert_array_equal(remat_l, want_l)
    cfg = TrainConfig(device="cpu", attention="dense", quant=quant, **SMALL)
    got_l, got_g, hists = _port_run(cfg.replace(remat=True,
                                                remat_policy=policy),
                                    variables, draws)
    np.testing.assert_allclose(got_l, remat_l, rtol=0,
                               atol=1e-5 * np.abs(remat_l).max())
    _close(got_g, remat_g, 1e-5)
    if quant == "int8":
        _, _, plain = _port_run(cfg, variables, draws)
        assert hists.keys() == plain.keys() and hists
        for k in hists:
            assert torch.equal(hists[k], plain[k]), k
        want = {k: v for k, v in params_from_jax(
            variables["params"], remat_stats).items() if k in hists}
        assert want.keys() == hists.keys()
        for k, v in want.items():
            np.testing.assert_allclose(hists[k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=0, err_msg=k)


@pytest.mark.parametrize("policy", REMAT_POLICIES)
@pytest.mark.parametrize("attention,ffn", [("dense", "pallas"),
                                           ("flash", "flax"),
                                           ("flash", "pallas")])
def test_remat_equals_no_remat_bitwise(policy, attention, ffn):
    """The port with and without remat on one draw: logits and every
    gradient bitwise (the replay recomputes the same ops; on flash the
    attention-wrapping policies run the recompute route, whose plain
    version is the same arithmetic as the saved-stats one)."""
    jcfg = JConfig(device="cpu", attention="dense", **SMALL)
    variables = _jax_start(jcfg)
    cfg = TrainConfig(device="cpu", attention=attention, ffn_impl=ffn,
                      **SMALL)
    model = cli.build_model(cfg, vocab_size=VOCAB, device="cpu")
    draws = StepDraws(seeds=tuple(range(11, 11 + model.n_dropout_sites())),
                      lam=0.375, perm=np.array([2, 0, 3, 1]))
    want_l, want_g, _ = _port_run(cfg, variables, draws)
    got_l, got_g, _ = _port_run(cfg.replace(remat=True, remat_policy=policy),
                                variables, draws)
    np.testing.assert_array_equal(got_l, want_l)
    assert sorted(got_g) == sorted(want_g)
    for k in want_g:
        np.testing.assert_array_equal(got_g[k], want_g[k], err_msg=k)


def test_resnet18_remat_bitwise_and_against_jax_remat():
    """Block remat: one forward and backward of sum(logits * w) in train
    mode; gradients and BN running statistics bitwise against no remat,
    and 1e-4 of max |JAX| against flax's ``remat=True`` resnet18."""
    x = np.random.default_rng(0).normal(size=(4, 16, 16, 3)).astype(
        np.float32)
    w = np.random.default_rng(1).normal(size=(4, 10)).astype(np.float32)
    v = jax.jit(lambda k, xx: j_resnet18(dtype=jnp.float32).init(
        k, xx, train=True))(jax.random.PRNGKey(3), jnp.asarray(x))
    jmodel = j_resnet18(dtype=jnp.float32, remat=True)

    def rename(tree, a, b):
        # nn.remat names the blocks CheckpointBasicBlock_<i>
        return {(b + k[len(a):] if k.startswith(a) else k): t
                for k, t in tree.items()}

    def f(p):
        logits, mutated = jmodel.apply(
            {"params": p, "batch_stats": rename(
                v["batch_stats"], "BasicBlock", "CheckpointBasicBlock")},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(logits * w), mutated
    jg, jm = jax.grad(f, has_aux=True)(
        rename(v["params"], "BasicBlock", "CheckpointBasicBlock"))
    jg = rename(jg, "CheckpointBasicBlock", "BasicBlock")
    jm = {"batch_stats": rename(jm["batch_stats"], "CheckpointBasicBlock",
                                "BasicBlock")}

    out = {}
    for remat in (False, True):
        model = get_model("resnet18", 10, dtype=torch.float32, remat=remat)
        model.load_state_dict(resnet_from_jax(v["params"], v["batch_stats"]))
        logits = model(torch.from_numpy(x), train=True)
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad((logits * torch.from_numpy(w)).sum(),
                                    [p for _, p in model.named_parameters()])
        sd = dict(model.state_dict())
        stats = {k: t.clone() for k, t in sd.items()
                 if k.endswith((".mean", ".var"))}
        sd.update(dict(zip(names, grads)))
        out[remat] = (resnet_to_jax(sd), stats)
    (g0, _), s0 = out[False]
    (g1, _), s1 = out[True]
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    f0, f1 = flatten(g0), flatten(g1)
    for k in f0:
        np.testing.assert_array_equal(f1[k], f0[k], err_msg=k)
    _close(f1, flatten(jax.tree_util.tree_map(np.asarray, jg)), 1e-4)
    _, got_stats = resnet_to_jax({k: t for k, t in model.state_dict().items()})
    want_stats = flatten(jax.tree_util.tree_map(np.asarray,
                                                jm["batch_stats"]))
    got_stats = flatten(got_stats)
    for k in want_stats:
        np.testing.assert_allclose(got_stats[k], want_stats[k], rtol=0,
                                   atol=1e-4, err_msg=k)
