"""The port's quantized GEMMs (``ops/quant.py``) against the JAX package's.

Same numpy inputs through both packages:

  * the delayed-scaling helpers (history roll, ``scale_from_history``:
    an all-zero history gives 1.0, the margin, the max not the newest) —
    bitwise;
  * ``quantize``: int8 on a grid with .5 ties and saturation, E4M3/E5M2
    on grids with the clip points, every midpoint between neighbouring
    grid values and the floats right beside each midpoint — bitwise on
    the bytes (so the JAX f32 -> fp8 cast rounds once, as torch's does);
  * ``quant_dot_reference`` (the plain version of the Hopper kernel)
    against JAX ``quant_dot_pallas`` in interpret mode and JAX
    ``quant_dot_reference``: int8 bitwise, fp8 within 1e-6 of max |ref|;
  * ``quant_dot`` gradients against ``jax.vjp`` of JAX ``quant_dot``,
    with and without ``grad_fmt="fp8_e5m2"``: fp32 1e-5;
  * ``QuantDense`` against the flax ``QuantDense``: outputs and histories
    after training forwards (fp32 1e-5 / bitwise), no roll at eval or
    with frozen scales, ``FDT_QUANT=0``'s plain matmul with the state
    untouched; the state-dict keys map onto the JAX param and batch_stats
    trees;
  * path C (``--quant int8`` with the flax FFN): three train steps
    against JAX ``make_train_step`` — loss 1e-5, params 1e-4, histories
    1e-5 relative;
  * the serving build: two identical requests give bitwise-equal logits
    and a serving run leaves the histories untouched.

Small size: 2 layers, d_model 32-64, d_ff 64-128, a few dozen rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_distributed_training_tpu.ops import quant as jq
from faster_distributed_training_tpu_torch.ops import quant as tq


def _f32(x):
    return jnp.asarray(np.float32(x))


def test_history_roll_and_scale_match_jax():
    rng = np.random.default_rng(0)
    hist = np.zeros(16, np.float32)
    for fmt in ("int8", "fp8", "fp8_e5m2"):
        # an all-zero history reads "never observed": scale 1.0
        for margin in (1.0, 2.0):
            assert float(tq.scale_from_history(torch.from_numpy(hist), fmt,
                                               margin)) == 1.0
    th, jh = torch.from_numpy(hist), jnp.asarray(hist)
    for step in range(20):
        amax = np.float32(rng.uniform(0.1, 9.0) * (3.0 if step == 4 else 1))
        th = tq.update_amax_history(th, torch.tensor(amax))
        jh = jq.update_amax_history(jh, _f32(amax))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        assert th[0].item() == amax
        for fmt in ("int8", "fp8", "fp8_e5m2"):
            for margin in (1.0, 1.5):
                got = tq.scale_from_history(th, fmt, margin)
                want = jq.scale_from_history(jh, fmt, margin)
                assert got.dtype == torch.float32
                assert got.item() == float(np.asarray(want)), (step, fmt)
    # the max of the window, not the newest entry
    assert th.max().item() > th[0].item()
    assert tq.scale_from_history(th, "int8").item() == np.float32(
        127.0) / th.max().item()


def test_quantize_int8_grid_bitwise():
    rng = np.random.default_rng(1)
    x = np.concatenate([np.arange(-400, 401) * 0.5,       # .5 ties
                        rng.normal(size=500) * 80.0,      # saturation
                        [np.inf, -np.inf, 127.5, -127.5, 126.5]]
                       ).astype(np.float32)
    for s in (1.0, 0.37, 3.0, 127.0 / 9.5):
        want = np.asarray(jq.quantize(jnp.asarray(x), _f32(s), "int8"))
        got = tq.quantize(torch.from_numpy(x), torch.tensor(np.float32(s)),
                          "int8")
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fmt,jdt", [("fp8", jnp.float8_e4m3fn),
                                     ("fp8_e5m2", jnp.float8_e5m2)])
def test_quantize_fp8_grid_bitwise_and_rounds_once(fmt, jdt):
    qmax = jq.QMAX["fp8_e4m3" if fmt == "fp8" else fmt]
    grid = np.unique(np.asarray(jnp.asarray(np.linspace(
        -qmax, qmax, 40001, dtype=np.float32)).astype(jdt).astype(
            jnp.float32)))
    mids = ((grid[1:].astype(np.float64) + grid[:-1]) / 2).astype(np.float32)
    # a double rounding (f32 -> f16 -> fp8) would move the floats beside
    # a midpoint onto it and then round the tie to even
    beside = np.concatenate([np.nextafter(mids, np.float32(np.inf)),
                             np.nextafter(mids, np.float32(-np.inf))])
    x = np.concatenate([grid, mids, beside,
                        np.linspace(-2 * qmax, 2 * qmax, 4001),
                        [qmax, -qmax, qmax * 1.01, -qmax * 3]]
                       ).astype(np.float32)
    for s in (1.0, 0.75):
        want = np.asarray(jq.quantize(jnp.asarray(x), _f32(s), fmt)).view(
            np.uint8)
        got = tq.quantize(torch.from_numpy(x), torch.tensor(np.float32(s)),
                          fmt).view(torch.uint8).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_quant_dot_reference_matches_pallas_kernel(fmt, out_dtype):
    rng = np.random.default_rng(2)
    M, K, N = 40, 64, 48
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32) * 0.1
    sx, sw = np.float32(jq.QMAX[fmt] / 3.5), np.float32(jq.QMAX[fmt] / 0.35)
    xq = jq.quantize(jnp.asarray(x), _f32(sx), fmt)
    wq = jq.quantize(jnp.asarray(w), _f32(sw), fmt)
    jdt, tdt = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    kern = np.asarray(jq.quant_dot_pallas(xq, wq, _f32(sx), _f32(sw), fmt,
                                          jdt, block_rows=16)
                      .astype(jnp.float32))
    ref = np.asarray(jq.quant_dot_reference(xq, wq, _f32(sx), _f32(sw), fmt,
                                            jdt).astype(jnp.float32))
    txq = tq.quantize(torch.from_numpy(x), torch.tensor(sx), fmt)
    twq = tq.quantize(torch.from_numpy(w.T.copy()), torch.tensor(sw), fmt)
    got = tq.quant_matmul(txq, twq, torch.tensor(sx), torch.tensor(sw), fmt,
                          tdt)
    assert got.dtype == tdt and got.shape == (M, N)
    got = got.float().numpy()
    if fmt == "int8":
        np.testing.assert_array_equal(got, kern)
        np.testing.assert_array_equal(got, ref)
    else:
        tol = 1e-6 if out_dtype == "float32" else 8e-3
        for want in (kern, ref):
            assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("grad_fmt", [None, "fp8_e5m2"])
def test_quant_dot_grads_match_jax_vjp(fmt, grad_fmt):
    rng = np.random.default_rng(3)
    M, K, N = 24, 32, 40
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.2).astype(np.float32)
    g = rng.normal(size=(M, N)).astype(np.float32)
    sx, sw = np.float32(jq.QMAX[fmt] / 3.0), np.float32(jq.QMAX[fmt] / 0.6)
    out_j, vjp = jax.vjp(
        lambda a, b: jq.quant_dot(a, b, _f32(sx), _f32(sw), fmt,
                                  use_pallas=False, grad_fmt=grad_fmt),
        jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w.T.copy()).requires_grad_(True)
    out = tq.quant_dot(tx, tw, torch.tensor(sx), torch.tensor(sw), fmt,
                       grad_fmt)
    dx, dw = torch.autograd.grad(out, (tx, tw), torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), rtol=0,
                               atol=1e-5 * np.abs(dx_j).max())
    np.testing.assert_allclose(dw.numpy().T, np.asarray(dw_j), rtol=0,
                               atol=1e-5 * np.abs(dw_j).max())


def _jax_dense(fmt, frozen=False):
    return jq.QuantDense(features=24, fmt=fmt, frozen_scales=frozen,
                         dtype=jnp.float32)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quant_dense_matches_flax_and_rolls_only_in_training(fmt):
    rng = np.random.default_rng(4)
    xs = [rng.normal(size=(3, 5, 16)).astype(np.float32) * (1 + i)
          for i in range(3)]
    mod = _jax_dense(fmt)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    params = variables["params"]
    stats = variables["batch_stats"]
    dense = tq.QuantDense(16, 24, fmt=fmt)
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(np.array(params["kernel"]).T))
        dense.bias.copy_(torch.from_numpy(np.asarray(params["bias"])))
        # flax's init forward already rolled the histories once
        for k in ("amax_history_x", "amax_history_w"):
            getattr(dense, k).copy_(torch.from_numpy(np.array(stats[k])))
    assert sorted(dense.state_dict()) == sorted(
        ["weight", "bias", *stats.keys()])
    for x in xs:
        want, mutated = mod.apply({"params": params, "batch_stats": stats},
                                  jnp.asarray(x), mutable=["batch_stats"])
        stats = mutated["batch_stats"]
        got = dense(torch.from_numpy(x), train=True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)
        for k in ("amax_history_x", "amax_history_w"):
            np.testing.assert_array_equal(getattr(dense, k).numpy(),
                                          np.asarray(stats[k]))
    # eval forward: scales from the histories, nothing rolls
    before = {k: v.clone() for k, v in dense.state_dict().items()}
    want = mod.apply({"params": params, "batch_stats": stats},
                     jnp.asarray(xs[0]))
    got = dense(torch.from_numpy(xs[0]), train=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    # frozen scales: a training forward does not roll either
    frozen = tq.QuantDense(16, 24, fmt=fmt, frozen_scales=True)
    frozen.load_state_dict(before)
    frozen(torch.from_numpy(xs[2]), train=True)
    for k, v in before.items():
        assert torch.equal(dense.state_dict()[k], v)
        assert torch.equal(frozen.state_dict()[k], v)


def test_quant_kill_switch_runs_the_plain_matmul(monkeypatch):
    monkeypatch.setenv("FDT_QUANT", "0")
    rng = np.random.default_rng(5)
    x = rng.normal(size=(7, 16)).astype(np.float32)
    mod = _jax_dense("int8")
    variables = mod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want, mutated = mod.apply(variables, jnp.asarray(x),
                              mutable=["batch_stats"])
    dense = tq.QuantDense(16, 24)
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(
            np.asarray(variables["params"]["kernel"]).T))
        dense.bias.copy_(torch.from_numpy(
            np.asarray(variables["params"]["bias"])))
    got = dense(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.detach().numpy(),
                               x @ np.asarray(variables["params"]["kernel"])
                               + np.asarray(variables["params"]["bias"]),
                               rtol=0, atol=1e-5)
    assert not dense.amax_history_x.any() and not dense.amax_history_w.any()
    assert not np.asarray(mutated["batch_stats"]["amax_history_x"]).any()


# -- the model under --quant ------------------------------------------------------

from faster_distributed_training_tpu import cli as jcli  # noqa: E402
from faster_distributed_training_tpu.config import (  # noqa: E402
    TrainConfig as JConfig)
from faster_distributed_training_tpu_torch import cli  # noqa: E402
from faster_distributed_training_tpu_torch.config import (  # noqa: E402
    TrainConfig)
from faster_distributed_training_tpu_torch.interop import (  # noqa: E402
    batch_stats_to_jax, flatten, load_jax_tree, params_to_jax)

SMALL = dict(model="transformer", dataset="synthetic", num_classes=4,
             lr=1e-2, batch_size=4, epochs=2, alpha=0.99, seq_len=32,
             n_layers=2, d_model=32, d_ff=64, n_heads=2, precision="fp32",
             telemetry=False, plot=False, attention="dense")
VOCAB = 100


def jax_state(jcfg):
    """A JAX train state of ``jcfg``'s model (dense init), its step fn."""
    from faster_distributed_training_tpu.optim import (
        build_optimizer as j_build_optimizer)
    from faster_distributed_training_tpu.train.state import (
        create_train_state as j_create_train_state)
    from faster_distributed_training_tpu.train.steps import (
        make_train_step as j_make_train_step)

    jtx, _ = j_build_optimizer(jcfg, steps_per_epoch=4)
    jstate = j_create_train_state(
        jcli.build_model(jcfg, vocab_size=VOCAB), jtx,
        jnp.zeros((4, 32), jnp.int32), jax.random.PRNGKey(0),
        init_kwargs={"train": True})
    return jstate, j_make_train_step(jcfg)


def run_three_steps_against_jax(monkeypatch, **flags):
    """Three train steps of the port and of JAX ``make_train_step`` on
    the same parameters, batches and recorded draws; returns both final
    (params, batch_stats) flat dicts and the port's model."""
    from test_torch_train import _batches, _Recorder
    from faster_distributed_training_tpu_torch.optim import build_optimizer
    from faster_distributed_training_tpu_torch.train.state import (
        create_train_state)
    from faster_distributed_training_tpu_torch.train.steps import (
        make_train_step, to_device)

    monkeypatch.setenv("FDT_FORCE_PALLAS_INTERPRET", "1")
    jcfg = JConfig(device="cpu", **SMALL, **flags)
    jstate, jstep = jax_state(jcfg)
    p0 = jax.tree_util.tree_map(np.asarray, jstate.params["model"])
    s0 = jax.tree_util.tree_map(np.asarray, jstate.batch_stats)
    cfg = TrainConfig(device="cpu", **SMALL, **flags)
    model = cli.build_model(cfg, vocab_size=VOCAB, device="cpu")
    load_jax_tree(model, {"params": p0, "batch_stats": s0})
    tx, _ = build_optimizer(cfg, steps_per_epoch=4)
    state = create_train_state(model, tx, seed=0)
    step = make_train_step(cfg)
    rec = _Recorder(monkeypatch)
    for i, batch in enumerate(_batches(3, bs=4, seq_len=32)):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        draws = rec.take()
        assert len(draws.seeds) == model.n_dropout_sites()
        state, m = step(state, to_device(batch, "cpu"), draws)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=0, atol=1e-5, err_msg=f"step {i}")
    want_p = flatten(jax.tree_util.tree_map(np.asarray,
                                            jstate.params["model"]))
    got_p = flatten(params_to_jax(model.state_dict(), cfg.n_heads))
    assert sorted(got_p) == sorted(want_p)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    start = flatten(p0)
    assert max(np.abs(want_p[k] - start[k]).max() for k in want_p) > 1e-3
    want_s = flatten(jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    got_s = flatten(batch_stats_to_jax(model.state_dict()))
    assert sorted(got_s) == sorted(want_s)
    start_s = flatten(s0)
    for k in want_s:
        # three steps rolled three more entries in (after the init's)
        n0 = int((start_s[k] > 0).sum())
        assert (want_s[k][:n0 + 3] > 0).all(), k
        assert not want_s[k][n0 + 3:].any(), k
        np.testing.assert_allclose(got_s[k], want_s[k], rtol=1e-5, atol=0,
                                   err_msg=k)
    return model


def test_three_train_steps_quant_int8_match_jax(monkeypatch):
    """Path C: --quant int8 with the flax FFN (JAX's CPU quant path runs
    the reference GEMMs, the same function as the kernel)."""
    model = run_three_steps_against_jax(monkeypatch, quant="int8")
    names = [k for k in model.state_dict() if "amax_history" in k]
    assert len(names) == 2 * 4 * SMALL["n_layers"]


def test_serving_build_is_frozen_and_batch_invariant(tmp_path):
    cfg = TrainConfig(**dict(SMALL, device="cpu", quant="int8",
                             ffn_impl="pallas", seq_buckets=(16, 32),
                             serve_batch_size=4, serve_requests=8,
                             checkpoint_dir=str(tmp_path)))
    model = cli.build_model(cfg, vocab_size=VOCAB, device="cpu")
    model.init_weights(torch.Generator().manual_seed(3))
    # histories as a few training forwards would leave them
    rng = np.random.default_rng(6)
    for name, buf in model.named_buffers():
        if "amax_history" in name:
            buf.copy_(torch.from_numpy(
                rng.uniform(0.5, 4.0, size=buf.shape).astype(np.float32)))
    sd = model.state_dict()
    bundle = {"params": params_to_jax(sd, cfg.n_heads),
              "batch_stats": batch_stats_to_jax(sd)}
    np.savez(tmp_path / "transformer_params.npz", **flatten(bundle))
    requests = cli.synth_requests(8, VOCAB, (16, 32), seed=2)
    requests.append(requests[0].copy())
    out = cli.run_serving(cfg, requests=requests, log=lambda s: None)
    res = out["results"]
    np.testing.assert_array_equal(res[0], res[-1])
    assert all(np.isfinite(r).all() for r in res)
    served = out["engines"][0].model
    assert served.layers[0].attn.qkv.frozen_scales
    for name, buf in served.named_buffers():
        if "amax_history" in name:
            assert torch.equal(buf, sd[name]), name
    # the histories set the scales: the same weights with fresh histories
    # answer differently
    fresh = cli.build_model(cfg, vocab_size=VOCAB, serving=True,
                            device="cpu")
    load_jax_tree(fresh, {"params": bundle["params"]})
    tokens = torch.from_numpy(requests[0][None].astype(np.int64))
    with torch.inference_mode():
        a = served(tokens, mask=torch.ones_like(tokens))
        b = fresh(tokens, mask=torch.ones_like(tokens))
    assert not torch.equal(a, b)
