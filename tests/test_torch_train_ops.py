"""Parity of the training slice's ops, optimizers and data with the JAX
package's, one test per counterpart, same numpy inputs on both sides.

  * ``hash_dropout`` / ``keep_factor_rows`` vs ``ops/dropout.py``: forward
    and VJP bitwise over seeds, rates, ``col0``/``cols_glob`` and bf16;
  * the LayerNorm saved-stats backward vs ``_ln_bwd``: fp64 to 1e-12,
    fp32 to 1e-5;
  * the flash backward plain versions vs ``_flash_bwd_pallas_stats(...)(g)``
    and ``_flash_bwd_pallas(...)(g)`` in interpret mode (key padding,
    ragged L = 40, a fully masked row, dropout 0.1): fp32 to 1e-5, bf16 to
    2e-2 of max |ref| (the port rounds pt and ds to bf16 as tensor-core
    operands, the TPU kernel keeps them fp32 for dk/dv); at the fully
    masked row the saved-stats route follows the recompute kernel (the
    dense VJP), see the test's docstring; and the autograd
    Function's grads vs ``jax.vjp`` of the JAX ``flash_attention`` under
    ``FDT_FORCE_PALLAS_INTERPRET=1``, fp32 to 1e-5;
  * the fused-MLP backward vs ``_mlp_bwd``, sum and mean bias reductions:
    fp32 to 1e-5;
  * MADGRAD / MirrorMADGRAD: 5 updates on the same gradients vs the JAX
    optax transformations, fp64 to 1e-12 and fp32 to 1e-6; the builder's
    clip + one-cycle chain to 1e-6;
  * schedules vs ``optim/schedules.py`` at every step of an epoch grid;
  * ``BatchLoader``'s epoch stream and ``synthetic_agnews`` bitwise.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from faster_distributed_training_tpu.config import TrainConfig as JConfig
from faster_distributed_training_tpu.data.loader import (
    BatchLoader as JBatchLoader)
from faster_distributed_training_tpu.data.synthetic import (
    synthetic_agnews as j_synthetic)
from faster_distributed_training_tpu.optim import (
    build_optimizer as j_build_optimizer)
from faster_distributed_training_tpu.optim import schedules as jsched
from faster_distributed_training_tpu.train.metrics import (
    MetricAccumulator as JAccumulator)
from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.data.loader import BatchLoader
from faster_distributed_training_tpu_torch.data.synthetic import (
    synthetic_agnews)
from faster_distributed_training_tpu_torch.ops import dropout as tdrop
from faster_distributed_training_tpu_torch.ops.flash_attention import (
    flash_attention_bwd, flash_attention_bwd_recompute,
    flash_attention_bwd_recompute_reference, flash_attention_bwd_reference,
    flash_attention_qkv, flash_attention_stats)
from faster_distributed_training_tpu_torch.ops.fused_mlp import (
    fused_mlp, mlp_bwd)
from faster_distributed_training_tpu_torch.ops.layernorm import (
    torch_layernorm, torch_layernorm_f32)
from faster_distributed_training_tpu_torch.optim import (
    build_optimizer, madgrad, mirror_madgrad)
from faster_distributed_training_tpu_torch.optim import schedules as tsched
from faster_distributed_training_tpu_torch.train.metrics import (
    MetricAccumulator)
from faster_distributed_training_tpu_torch.train.steps import step_draws

jdrop, jln, jflash, jmlp, jattn, jmadgrad = (importlib.import_module(
    f"faster_distributed_training_tpu.{m}")
    for m in ("ops.dropout", "ops.layernorm", "ops.flash_attention",
              "ops.fused_mlp", "ops.attention", "optim.madgrad"))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


# ------------------------------------------------------------ hash dropout
@pytest.mark.parametrize("rate", [0.1, 0.5, 0.95])
@pytest.mark.parametrize("seed", [0, 77, 0x9E3779B9, 0xFFFFFFFF])
def test_keep_factor_rows_bitwise(seed, rate):
    rows = np.array([0, 3, 2**20 + 7, 5000], np.uint32)
    for col0, glob in ((0, 0), (5, 40), (2**31, 2**16)):
        want = jdrop.keep_factor_rows(jnp.uint32(seed), jnp.asarray(rows), 9,
                                      rate, col0=col0, cols_glob=glob)
        got = tdrop.keep_factor_rows(seed, torch.from_numpy(
            rows.astype(np.int64)), 9, rate, col0=col0, cols_glob=glob)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate,offset", [(0.1, 0), (0.3, 12345), (0.0, 0)])
def test_hash_dropout_forward_and_vjp_bitwise(dtype, rate, offset):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 7, 10)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    jdt = jnp.dtype(dtype)
    out, vjp = jax.vjp(lambda a: jdrop.hash_dropout(a, jnp.uint32(99), rate,
                                                    offset=offset),
                       jnp.asarray(x, jdt))
    (dx,) = vjp(jnp.asarray(g, jdt))
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(_np(jnp.asarray(x, jdt))).to(tdt).requires_grad_()
    got = tdrop.hash_dropout(tx, 99, rate, offset=offset)
    (tdx,) = torch.autograd.grad(got, tx, torch.from_numpy(
        _np(jnp.asarray(g, jdt))).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.detach().float().numpy(), _np(out))
    np.testing.assert_array_equal(tdx.float().numpy(), _np(dx))
    assert tdrop.realized_rate(rate) == jdrop.realized_rate(rate)
    with pytest.raises(ValueError, match="ceiling"):
        tdrop.guard_index_ceiling(2**32 + 1)


# ------------------------------------------------------------- layernorm
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-5)])
def test_layernorm_saved_stats_backward_matches_ln_bwd(dtype, tol):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(3, 5, 32)) * 2 + 0.5).astype(dtype)
    scale = rng.normal(size=(32,)).astype(dtype)
    bias = rng.normal(size=(32,)).astype(dtype)
    g = rng.normal(size=x.shape).astype(dtype)
    out, res = jln._ln_fwd(*(jnp.asarray(a) for a in (x, scale, bias)), 1e-6)
    want = jln._ln_bwd(1e-6, res, jnp.asarray(g))
    tx, ts, tb = (torch.from_numpy(a).requires_grad_() for a in
                  (x, scale, bias))
    y = torch_layernorm(tx, ts, tb, 1e-6)
    np.testing.assert_array_equal(
        y.detach().numpy(), torch_layernorm_f32(tx, ts, tb, 1e-6).detach()
        .numpy())
    got = torch.autograd.grad(y, (tx, ts, tb), torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out),
                               atol=tol, rtol=0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol,
                                   rtol=0)


def test_layernorm_module_keeps_residuals_only_under_autograd(monkeypatch):
    """TorchLayerNorm: the saved-stats Function where autograd needs it,
    the plain form (no residuals) under no_grad / inference_mode, with
    bitwise-equal outputs."""
    from faster_distributed_training_tpu_torch.models.transformer import (
        TorchLayerNorm)
    from faster_distributed_training_tpu_torch.ops import layernorm as tln

    calls = []
    real = tln._LNSavedStats.apply

    def counted(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(tln._LNSavedStats, "apply", counted)
    ln = TorchLayerNorm(16)
    x = torch.from_numpy(
        np.random.default_rng(3).normal(size=(2, 5, 16)).astype(np.float32))
    with torch.no_grad():
        plain = ln(x)
    with torch.inference_mode():
        served = ln(x)
    assert not calls
    trained = ln(x.clone().requires_grad_())
    assert len(calls) == 1 and trained.grad_fn is not None
    np.testing.assert_array_equal(plain.numpy(), trained.detach().numpy())
    np.testing.assert_array_equal(served.numpy(), plain.numpy())


# ------------------------------------------------------ flash backward
def _bwd_inputs(B, H, L, D, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, H, L, D)).astype(np.float32)
                  for _ in range(4))
    lengths = rng.integers(1, L + 1, size=B)
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
    mask[-1] = 0                                     # a fully masked row
    return q, k, v, g, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["stats", "recompute"])
def test_flash_bwd_plain_matches_pallas_kernels(dtype, route):
    """The fully masked row (batch B-1): JAX's saved-stats kernel computes
    p = exp(s - lse) with an lse that rounds to -1e9, so that row's
    gradient comes out Lk times too large; the port carries the lse's
    low-order tail and matches the recompute kernel (= the dense VJP)
    there.  Without the tail it reproduces the saved-stats kernel
    exactly as it is."""
    B, H, L, D, rate, seed = 2, 2, 40, 16, 0.1, 4242
    q, k, v, g, mask = _bwd_inputs(B, H, L, D, seed=7)
    jdt = jnp.dtype(dtype)
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    bias = jattn.mask_to_bias(jnp.asarray(mask))
    seed3 = jflash._pack_seed(seed)
    out, lse = jflash._flash_fwd_pallas(
        *(a.reshape(B * H, L, D) for a in (jq, jk, jv)), bias, H,
        block_q=16, dropout_rate=rate, seed3=seed3, emit_lse=True)
    out = out.reshape(B, H, L, D)
    j_stats = jflash._flash_bwd_pallas_stats(jq, jk, jv, bias, seed3, rate,
                                             out, lse)(jg)
    j_rec = jflash._flash_bwd_pallas(jq, jk, jv, bias, seed3, rate,
                                     block_q=16)(jg)
    # unmasked rows from the route's own kernel, the masked row from the
    # recompute kernel (the two JAX kernels agree everywhere else)
    want = [np.concatenate([_np(a)[:-1], _np(b)[-1:]])
            for a, b in zip(j_stats if route == "stats" else j_rec, j_rec)]
    tdt = getattr(torch, dtype)
    t = lambda a: torch.from_numpy(_np(a)).to(tdt)  # noqa: E731
    tq, tk, tv, tg = map(t, (jq, jk, jv, jg))
    tmask = torch.from_numpy(mask)
    tout, tlse, tlo = flash_attention_stats(tq, tk, tv, tmask, rate, seed)
    if route == "stats":
        got = flash_attention_bwd_reference(tq, tk, tv, tout, tlse, tg,
                                            tmask, rate, seed, tlo)
        wrapped = flash_attention_bwd(tq, tk, tv, tout, tlse, tg, tmask,
                                      rate, seed, tlo)
        # without the tail: the TPU saved-stats kernel, masked row and all
        as_tpu = flash_attention_bwd_reference(tq, tk, tv, tout, tlse, tg,
                                               tmask, rate, seed)
        for a, b in zip(as_tpu, j_stats):
            ref = _np(b)
            tol = 1e-5 if dtype == "float32" else 2e-2 * np.abs(ref).max()
            np.testing.assert_allclose(a.float().numpy(), ref, atol=tol,
                                       rtol=0)
    else:
        got = flash_attention_bwd_recompute_reference(tq, tk, tv, tg, tmask,
                                                      rate, seed)
        wrapped = flash_attention_bwd_recompute(tq, tk, tv, tg, tmask, rate,
                                                seed)
    for a, b in zip(got, wrapped):            # CPU: the plain version
        assert torch.equal(a, b)
    for a, ref in zip(got, want):
        assert a.dtype == tdt
        tol = 1e-5 if dtype == "float32" else 2e-2 * np.abs(ref).max()
        np.testing.assert_allclose(a.float().numpy(), ref, atol=tol, rtol=0)


@pytest.mark.parametrize("save_stats", [True, False])
def test_flash_autograd_matches_jax_vjp(save_stats, monkeypatch):
    """jax.vjp of the JAX flash_attention on either backward route; at the
    fully masked row (batch B-1) the recompute route's (= dense VJP's)
    gradient is the reference for both (see the kernel test above)."""
    monkeypatch.setenv("FDT_FORCE_PALLAS_INTERPRET", "1")
    B, H, L, D, rate, seed = 2, 2, 40, 16, 0.1, 99
    q, k, v, g, mask = _bwd_inputs(B, H, L, D, seed=3)

    def jax_grads(save):
        out, vjp = jax.vjp(
            lambda a, b, c: jflash.flash_attention(
                a, b, c, jnp.asarray(mask)[:, None, None, :], block_q=16,
                dropout_rate=rate, dropout_seed=jnp.uint32(seed),
                save_stats=save), *map(jnp.asarray, (q, k, v)))
        return out, vjp(jnp.asarray(g))

    out, want = jax_grads(save_stats)
    if save_stats:
        _, masked_ref = jax_grads(False)
        want = [np.concatenate([np.asarray(a)[:-1], np.asarray(b)[-1:]])
                for a, b in zip(want, masked_ref)]
    qkv = torch.from_numpy(np.stack([a.transpose(0, 2, 1, 3)
                                     for a in (q, k, v)], axis=2))
    qkv.requires_grad_()
    ctx = flash_attention_qkv(qkv, torch.from_numpy(mask), rate, seed,
                              save_stats=save_stats)
    np.testing.assert_allclose(ctx.detach().numpy(), np.asarray(out),
                               atol=1e-5, rtol=0)
    (dqkv,) = torch.autograd.grad(ctx, qkv, torch.from_numpy(g))
    for i in range(3):
        np.testing.assert_allclose(
            dqkv[:, :, i].transpose(1, 2).numpy(), np.asarray(want[i]),
            atol=1e-5, rtol=0)


# ----------------------------------------------------------- fused MLP
@pytest.mark.parametrize("mean_bias_grad", [False, True])
def test_mlp_backward_matches_mlp_bwd(mean_bias_grad):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    w1 = (rng.normal(size=(48, 32)) * 0.2).astype(np.float32)
    b1 = (rng.normal(size=(1, 48)) * 0.2).astype(np.float32)
    w2 = (rng.normal(size=(4, 48)) * 0.2).astype(np.float32)
    b2 = (rng.normal(size=(1, 4)) * 0.2).astype(np.float32)
    g = rng.normal(size=(2, 5, 4)).astype(np.float32)
    args = (x, w1, b1, w2, b2)
    want = jmlp._mlp_bwd(mean_bias_grad, tuple(map(jnp.asarray, args)),
                         jnp.asarray(g))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fused_mlp(*targs, mean_bias_grad=mean_bias_grad)
    got = torch.autograd.grad(out, targs, torch.from_numpy(g))
    plain = mlp_bwd(*(a.detach() for a in targs), torch.from_numpy(g),
                    mean_bias_grad)
    for a, b, c in zip(got, want, plain):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)
        assert torch.equal(a, c)


# ------------------------------------------------------------ optimizers
@pytest.mark.parametrize("mirror", [False, True])
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-6)])
def test_madgrad_matches_jax(mirror, dtype, tol):
    rng = np.random.default_rng(8)
    params = {"a": rng.normal(size=(6, 5)).astype(dtype),
              "b": rng.normal(size=(5,)).astype(dtype)}
    grads = [{k: rng.normal(size=v.shape).astype(dtype)
              for k, v in params.items()} for _ in range(5)]
    sched = lambda step: 0.01 * (1.0 + 0.1 * step)  # noqa: E731
    jmake = jmadgrad.mirror_madgrad if mirror else jmadgrad.madgrad
    tx = jmake(sched, momentum=0.9, weight_decay=1e-3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    make = mirror_madgrad if mirror else madgrad
    opt = make(sched, momentum=0.9, weight_decay=1e-3)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = opt.init(tp)
    for g in grads:
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update({k: torch.from_numpy(v) for k, v in g.items()}, state, tp)
    assert state["step"] == 5
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=tol, rtol=0)
        np.testing.assert_allclose(state["v"][k].numpy(),
                                   np.asarray(jstate.v[k]), atol=tol, rtol=0)


def test_builder_chain_matches_jax():
    """mirror MADGRAD + one-cycle + clip_by_global_norm(10), large
    gradients so the clip bites."""
    kw = dict(model="transformer", lr=5e-3, epochs=2)
    jtx, _ = j_build_optimizer(JConfig(**kw), steps_per_epoch=3)
    tx, _ = build_optimizer(TrainConfig(**kw), steps_per_epoch=3)
    rng = np.random.default_rng(9)
    params = {"w": rng.normal(size=(8, 8)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = tx.init(tp)
    for i in range(6):
        g = {"w": (rng.normal(size=(8, 8)) * (30.0 if i % 2 else 0.1))
             .astype(np.float32)}
        upd, jstate = jtx.update({"w": jnp.asarray(g["w"])}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tx.update({"w": torch.from_numpy(g["w"])}, state, tp)
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                                   atol=1e-6, rtol=0)


def test_schedules_match_jax_on_an_epoch_grid():
    spe, epochs = 7, 5
    pairs = [
        (jsched.one_cycle(5e-5, epochs, spe), tsched.one_cycle(5e-5, epochs,
                                                               spe)),
        (jsched.multistep(0.1, (1, 3), 0.2, spe),
         tsched.multistep(0.1, (1, 3), 0.2, spe)),
        (jsched.cosine_annealing(0.1, 4, spe),
         tsched.cosine_annealing(0.1, 4, spe)),
        (jsched.step_decay(0.1, 2, 0.2, spe), tsched.step_decay(0.1, 2, 0.2,
                                                                spe)),
        (optax.constant_schedule(0.3), tsched.constant(0.3))]
    for jfn, tfn in pairs:
        for step in range(epochs * spe + 3):
            want = float(jfn(jnp.asarray(step)))
            assert tfn(step) == pytest.approx(want, rel=1e-6, abs=1e-12), step


# ------------------------------------------------------------------ data
def test_loader_epoch_stream_and_synthetic_data_bitwise():
    jds = j_synthetic(n=300, seed=0, max_len=128)
    tds = synthetic_agnews(n=300, seed=0, max_len=128)
    for epoch in (0, 1, 5):
        for pad_last, shuffle in ((False, True), (True, False)):
            jl = JBatchLoader(jds, 32, epoch=epoch, seed=11, shuffle=shuffle,
                              max_len=128, pad_last=pad_last,
                              process_index=0, process_count=1)
            tl = BatchLoader(tds, 32, epoch=epoch, seed=11, shuffle=shuffle,
                             max_len=128, pad_last=pad_last)
            assert len(jl) == len(tl)
            for jb, tb in zip(jl, tl):
                assert jb.keys() == tb.keys()
                for key in jb:
                    assert jb[key].dtype == tb[key].dtype
                    np.testing.assert_array_equal(jb[key], tb[key])


def test_loader_start_skips_batches_without_building_them():
    """BatchLoader(start=k): the epoch stream from batch k on, with only
    those batches encoded (a mid-epoch resume skips at the plan level)."""
    tds = synthetic_agnews(n=300, seed=0, max_len=64)
    built = []

    class Counting:
        def __len__(self):
            return len(tds)

        def encode_batch(self, idx, max_len):
            built.append(len(idx))
            return tds.encode_batch(idx, max_len)

    full = list(BatchLoader(tds, 32, epoch=2, seed=11, max_len=64))
    tail = list(BatchLoader(Counting(), 32, epoch=2, seed=11, max_len=64,
                            start=3))
    assert len(built) == len(tail) == len(full) - 3
    for a, b in zip(full[3:], tail):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def test_metric_accumulator_and_step_draws():
    steps = [{"loss": torch.tensor(1.5), "loss_total": 4.0,
              "correct": torch.tensor(2.0), "total": torch.tensor(4.0)},
             {"loss": torch.tensor(0.5), "loss_total": 1.0,
              "correct": torch.tensor(1.0), "total": torch.tensor(2.0)}]
    acc, jacc = MetricAccumulator(), JAccumulator()
    for m in steps:
        acc.add(m)
        jacc.add({k: jnp.asarray(float(v)) for k, v in m.items()})
    assert acc.summary() == pytest.approx(jacc.summary())
    a = step_draws(123456, 7, 16, 26, 0.99)
    b = step_draws(123456, 7, 16, 26, 0.99)
    c = step_draws(123456, 8, 16, 26, 0.99)
    assert a.seeds == b.seeds and a.lam == b.lam
    np.testing.assert_array_equal(a.perm, b.perm)
    assert a.seeds != c.seeds and sorted(a.perm) == list(range(16))
    assert all(0 <= s < 2**32 for s in a.seeds) and 0.0 <= a.lam <= 1.0
