"""The port's fused pre-LN FFN sublayer (``ops/fused_ffn.py``) and the
``--ffn_impl pallas`` paths against the JAX package's.

Same numpy inputs through both packages:

  * the plain versions against JAX ``_ffn_fwd_pallas`` and
    ``_ffn_fwd_pallas2`` (interpret mode; ``fmt`` none, int8, fp8),
    dropout 0.1 at both sites: fp32 1e-5, bf16 2e-2 of max |ref|; the
    amaxes bitwise in bf16, to 1 ulp in fp32 (the LN mean sums in another
    order and XLA's and torch's exp differ in the last place);
  * the gradients of ``fused_ffn_sublayer`` and ``ffn_core_generalized``
    (the recompute backward) against ``jax.vjp`` of the JAX functions,
    with and without quant and ``grad_fmt="fp8_e5m2"``: fp32 1e-5;
  * one ``EncoderLayer``, fused branch, against the flax layer with
    ``ffn_impl="pallas"``, with and without quant, dropout on, the JAX
    seeds handed over: output fp32 1e-5, histories after two training
    forwards 1e-5 relative;
  * paths A (``--ffn_impl pallas``) and B (``--ffn_impl pallas --quant
    int8``): three train steps against JAX ``make_train_step`` — loss
    1e-5, params 1e-4, histories 1e-5 relative;
  * resume within the port with ``--quant int8 --ffn_impl pallas``:
    bitwise, histories included;
  * ``cli.main`` trains on the CPU with both flags and raises for CUDA
    without a card.

Small size: 2 layers, d_model 32-64, d_ff 64-128, a few dozen rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_distributed_training_tpu.ops import fused_ffn as jf
from faster_distributed_training_tpu_torch.ops import fused_ffn as tf

D, DFF, ROWS = 32, 64, 48
SEEDS = (0x9E3779B9, 0x2545F491)


def _inputs(seed=0, rows=ROWS, d=D, d_ff=DFF):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        h=rng.normal(size=(rows, d)).astype(f32),
        ln_scale=(1.0 + 0.1 * rng.normal(size=d)).astype(f32),
        ln_bias=(0.1 * rng.normal(size=d)).astype(f32),
        w1=(rng.normal(size=(d, d_ff)) / np.sqrt(d)).astype(f32),
        b1=(0.1 * rng.normal(size=d_ff)).astype(f32),
        w2=(rng.normal(size=(d_ff, d)) / np.sqrt(d_ff)).astype(f32),
        b2=(0.1 * rng.normal(size=d)).astype(f32))


def _jax_args(x, dtype):
    jd = getattr(jnp, dtype)
    return (jnp.asarray(x["h"]).astype(jd), jnp.asarray(x["ln_scale"]),
            jnp.asarray(x["ln_bias"]), jnp.asarray(x["w1"]).astype(jd),
            jnp.asarray(x["b1"]).astype(jd), jnp.asarray(x["w2"]).astype(jd),
            jnp.asarray(x["b2"]).astype(jd))


def _torch_args(x, dtype, grad=False):
    td = getattr(torch, dtype)
    out = (torch.from_numpy(x["h"]).to(td), torch.from_numpy(x["ln_scale"]),
           torch.from_numpy(x["ln_bias"]),
           torch.from_numpy(x["w1"].T.copy()).to(td),
           torch.from_numpy(x["b1"]).to(td),
           torch.from_numpy(x["w2"].T.copy()).to(td),
           torch.from_numpy(x["b2"]).to(td))
    if grad:
        out = tuple(t.requires_grad_(True) for t in out)
    return out


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = 1e-5 if dtype == "float32" else 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


SCALES = np.array([40.0, 300.0, 25.0, 250.0], np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_ffn_fwd_pallas(dtype):
    x = _inputs(1)
    jargs = _jax_args(x, dtype)
    seeds = jnp.asarray([[SEEDS[0], SEEDS[1], 0, 0]], jnp.uint32)
    want = jf._ffn_fwd_pallas(*jargs, seeds, 0.1, 0.1, 1e-6, 1, 1,
                              block_rows=16)
    targs = _torch_args(x, dtype)
    got = tf.ffn_fwd(*targs, SEEDS[0], SEEDS[1], 0.1, 0.1, 1e-6)
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)
    # the Function's forward is the same function
    again = tf.fused_ffn_sublayer(*targs, *SEEDS, 0.1, 0.1)
    assert torch.equal(again, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", [None, "int8", "fp8"])
def test_plain_version_matches_ffn_fwd_pallas2(dtype, fmt):
    x = _inputs(2)
    jargs = _jax_args(x, dtype)
    seeds = jnp.asarray([[SEEDS[0], SEEDS[1], 0, 0, 0]], jnp.uint32)
    want, want_amax = jf._ffn_fwd_pallas2(
        *jargs, seeds, jnp.asarray(SCALES), 0.1, 0.1, 1e-6, 1, 1, DFF, fmt,
        None, (), False, block_rows=16)
    targs = _torch_args(x, dtype)
    got, amax = tf.ffn_fwd_generalized(
        *targs, (*SEEDS, 0, 0, 0), torch.from_numpy(SCALES), 0.1, 0.1, 1e-6,
        1, 1, DFF, fmt)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)
    want_amax = np.asarray(want_amax)
    # bitwise once rounded to bf16; in fp32 to 1 ulp (the LN mean sums in
    # another order, GELU's exp rounds differently in the last place)
    if dtype == "float32":
        np.testing.assert_allclose(amax.numpy(), want_amax, rtol=2 ** -23,
                                   atol=0)
    else:
        np.testing.assert_array_equal(amax.numpy(), want_amax)
    if fmt is not None:
        assert (amax.numpy() > 0).all()


def _grads_close(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1.0),
                                   err_msg=f"argument {i}")


def _t_grads_jax_layout(grads):
    """The port's (w [out, in]) gradients in JAX's (in, out) layout."""
    g = list(grads)
    g[3], g[5] = g[3].T, g[5].T
    return g


def test_sublayer_grads_match_jax_vjp():
    x = _inputs(3)
    rng = np.random.default_rng(4)
    g = rng.normal(size=(ROWS, D)).astype(np.float32)
    jargs = _jax_args(x, "float32")
    _, vjp = jax.vjp(lambda *a: jf.fused_ffn_sublayer(
        *a, jnp.uint32(SEEDS[0]), jnp.uint32(SEEDS[1]), 0.1, 0.1), *jargs)
    want = vjp(jnp.asarray(g))
    targs = _torch_args(x, "float32", grad=True)
    out = tf.fused_ffn_sublayer(*targs, *SEEDS, 0.1, 0.1)
    got = torch.autograd.grad(out, targs, torch.from_numpy(g))
    _grads_close(_t_grads_jax_layout(got), want)


@pytest.mark.parametrize("fmt,grad_fmt", [(None, None), ("int8", None),
                                          ("fp8", None),
                                          ("int8", "fp8_e5m2")])
def test_generalized_core_grads_match_jax_vjp(fmt, grad_fmt):
    x = _inputs(5)
    rng = np.random.default_rng(6)
    g = rng.normal(size=(ROWS, D)).astype(np.float32)
    jargs = _jax_args(x, "float32")
    qs = tuple(jnp.float32(s) for s in SCALES)

    def jfn(*a):
        out, _ = jf.ffn_core_generalized(
            *a, jnp.uint32(SEEDS[0]), jnp.uint32(SEEDS[1]), 0, 0, 0, 0.1,
            0.1, 1e-6, 1, 1, dff_glob=DFF, quant_fmt=fmt, quant_scales=qs,
            grad_fmt=grad_fmt)
        return out
    _, vjp = jax.vjp(jfn, *jargs)
    want = vjp(jnp.asarray(g))
    targs = _torch_args(x, "float32", grad=True)
    out, amax = tf.ffn_core_generalized(
        *targs, *SEEDS, 0, 0, 0, 0.1, 0.1, 1e-6, 1, 1, dff_glob=DFF,
        quant_fmt=fmt, quant_scales=tuple(torch.from_numpy(SCALES)),
        grad_fmt=grad_fmt)
    assert not amax.requires_grad
    got = torch.autograd.grad(out, targs, torch.from_numpy(g))
    _grads_close(_t_grads_jax_layout(got), want)


# -- one encoder layer ---------------------------------------------------------

class _Bits:
    """Wraps jax.random.bits and keeps its values, flattened, in order."""

    def __init__(self, monkeypatch):
        self.seeds = []
        orig = jax.random.bits

        def wrapped(*a, **kw):
            out = orig(*a, **kw)
            self.seeds.extend(int(v) for v in np.ravel(np.asarray(out)))
            return out
        monkeypatch.setattr(jax.random, "bits", wrapped)

    def take(self):
        out, self.seeds = self.seeds, []
        return out


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_encoder_layer_fused_branch_matches_flax(quant, monkeypatch):
    from faster_distributed_training_tpu.models.transformer import (
        EncoderLayer as JLayer)
    from faster_distributed_training_tpu.train.amp import (
        QuantPolicy as JPolicy)
    from faster_distributed_training_tpu_torch.models.transformer import (
        EncoderLayer)
    from faster_distributed_training_tpu_torch.train.amp import QuantPolicy

    monkeypatch.setenv("FDT_FORCE_PALLAS_INTERPRET", "1")
    B, L, H = 2, 16, 2
    rng = np.random.default_rng(7)
    hs = [rng.normal(size=(B, L, D)).astype(np.float32) for _ in range(2)]
    mask = np.ones((B, 1, 1, L), np.int32)
    mask[1, ..., 11:] = 0
    jpol = None if quant is None else JPolicy(fmt=quant, use_pallas=False)
    jlayer = JLayer(h=H, d_model=D, d_ff=DFF, ffn_impl="pallas", quant=jpol)
    variables = jlayer.init({"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(1)},
                            jnp.asarray(hs[0]), jnp.asarray(mask), False)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    layer = EncoderLayer(H, D, DFF, ffn_impl="pallas",
                         quant=None if quant is None else QuantPolicy(quant))
    jtree = {"layer_0": jax.tree_util.tree_map(np.asarray, params)}
    from faster_distributed_training_tpu_torch.interop import (
        batch_stats_to_jax, params_from_jax)
    sd = {k[len("layers.0."):]: v for k, v in params_from_jax(
        {**_model_shell(jtree), **jtree},
        {"layer_0": jax.tree_util.tree_map(np.asarray, stats)}
        if stats else None).items() if k.startswith("layers.0.")}
    layer.load_state_dict(sd)
    bits = _Bits(monkeypatch)
    for i, h in enumerate(hs):
        want, mutated = jlayer.apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(h),
            jnp.asarray(mask), True, rngs={"dropout": jax.random.PRNGKey(
                10 + i)}, mutable=["batch_stats"])
        stats = mutated.get("batch_stats", stats)
        seeds = bits.take()
        assert len(seeds) == 4      # attention, connection, (hid, out)
        got = layer(torch.from_numpy(h), torch.from_numpy(mask), train=True,
                    seeds=iter(seeds))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5, err_msg=f"call {i}")
        if quant is not None:
            got_s = batch_stats_to_jax(
                {f"layers.0.{k}": v for k, v in layer.state_dict().items()})
            want_s = jax.tree_util.tree_map(np.asarray, stats)
            from faster_distributed_training_tpu_torch.interop import flatten
            gf, wf = flatten(got_s["layer_0"]), flatten(want_s)
            assert sorted(gf) == sorted(wf) and len(wf) == 8
            for k in wf:
                np.testing.assert_allclose(gf[k], wf[k], rtol=1e-5, atol=0,
                                           err_msg=k)


def _model_shell(layer_tree):
    """The non-layer leaves params_from_jax reads, as zeros."""
    d = D
    z = np.zeros
    return {"Embeddings_0": {"token_embedding": z((4, d)),
                             "pos_embedding": z((4, d)),
                             "segment_embedding": z((3, d))},
            "ln_final": {"scale": z(d), "bias": z(d)},
            "pooler": {"kernel": z((d, d)), "bias": z(d)},
            "cls_w1": z((4, d)), "cls_b1": z((1, 4)),
            "cls_w2": z((2, 4)), "cls_b2": z((1, 2))}


# -- the training paths ------------------------------------------------------------

def test_three_train_steps_path_a_match_jax(monkeypatch):
    """Path A: --ffn_impl pallas (JAX runs _ffn_fwd_pallas in interpret
    mode)."""
    from test_torch_quant import run_three_steps_against_jax

    model = run_three_steps_against_jax(monkeypatch, ffn_impl="pallas")
    assert not any("amax" in k for k in model.state_dict())


def test_three_train_steps_path_b_match_jax(monkeypatch):
    """Path B: --ffn_impl pallas --quant int8 (JAX runs _ffn_fwd_pallas2
    in interpret mode, the attention projections on the reference
    GEMMs)."""
    from test_torch_quant import run_three_steps_against_jax

    run_three_steps_against_jax(monkeypatch, ffn_impl="pallas", quant="int8")


def test_resume_with_quant_and_fused_ffn_is_bitwise(tmp_path, monkeypatch):
    """6 straight steps against 3, kill, resume, 3 more: parameters,
    optimizer state and every amax history bitwise equal."""
    from test_torch_train import _Killed, _state_tensors, _tiny_cfg
    from faster_distributed_training_tpu_torch import cli
    from faster_distributed_training_tpu_torch.train import steps as tsteps

    kw = dict(batch_size=10, epochs=1, checkpoint_every=3, quant="int8",
              ffn_impl="pallas")
    straight = cli.run_training(_tiny_cfg(tmp_path / "a", **kw),
                                log=lambda s: None)
    assert straight["state"].step == 6
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
        cli.run_training(_tiny_cfg(tmp_path / "b", **kw), log=lambda s: None)
    monkeypatch.setattr(tsteps, "make_train_step", real)
    resumed = cli.run_training(_tiny_cfg(tmp_path / "b", resume=True, **kw),
                               log=lambda s: None)
    a, b = _state_tensors(straight["state"]), _state_tensors(resumed["state"])
    hists = [k for k in a if "amax_history" in k]
    assert len(hists) == 2 * 4 * 2
    # the init forward and every training step rolled each history once
    # (no eval roll); the init's attention-out and FFN-hidden amaxes are 0,
    # as in the JAX init (fresh scales quantize the weights to zero)
    for k in hists:
        assert (a[k][:6] > 0).all() and not a[k][7:].any(), k
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_cli_trains_with_fused_ffn_and_quant_on_cpu(tmp_path):
    from faster_distributed_training_tpu_torch import cli

    argv = ["--dataset", "synthetic", "--epoch", "1", "--n_layers", "1",
            "--d_model", "32", "--n_heads", "2", "--d_ff", "64",
            "--seq_len", "64", "--subset_stride", "64", "--bs", "16",
            "--precision", "fp32", "--log_every", "0", "--checkpoint_dir",
            str(tmp_path), "--no_telemetry", "--no_plot", "--ffn_impl",
            "pallas", "--quant", "int8"]
    out = cli.main(argv + ["--device", "cpu"],
                   defaults=cli.TRANSFORMER_DEFAULTS)
    assert out["state"].step == 4
    assert np.isfinite(out["history"]["train_loss"]).all()
    layer = out["state"].model.layers[0]
    assert layer.ffn_impl == "pallas" and layer.attn.qkv.fmt == "int8"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(argv, defaults=cli.TRANSFORMER_DEFAULTS)
