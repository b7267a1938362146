"""K steps a dispatch, the device-resident split and device-side per-step
values in the port, against the JAX package and against the port's own
K=1 loop.

  * ``DeviceResidentData`` against JAX ``data/device_resident.py::
    DeviceResidentData``: arrays and ``epoch_order`` byte-identical; text
    rows equal the port's ``BatchLoader`` batches modulo trailing
    padding; a split smaller than a batch raises.
  * The port's K=4 (K=3 where the epoch needs a tail) against the port's
    K=1, bitwise on every state leaf: a tiny transformer (2 layers, d 16,
    fp32, dropout and mixup on) and resnet18 (SGD + static mixup), host
    and resident paths, an epoch tail shorter than K.  The port is held
    to its own K=1 here; JAX's own K=4-vs-K=1 tests are not run.
  * The port's K=4 dispatch against JAX ``make_fused_train_step`` at K=4
    on the same parameters, batches and draws (JAX's scan runs eagerly
    under ``jax.disable_jit``, so its draws can be recorded): loss 1e-5,
    parameters 1e-4, the tolerance of the K=1 parity test.
  * ``reduce_metrics`` against ``_reduce_scanned_metrics``, and the host
    group stacking against ``_stack_host_batches``.
  * ``--checkpoint_every`` rounding to a multiple of K (JAX's warning and
    log line) and a run killed at a dispatch boundary that resumes
    bitwise (host and resident).
  * The fp16 device select against K=1's host branch on an injected inf,
    bitwise.
  * Tensor seeds against int seeds in ``hash_dropout``, the flash plain
    versions (forward and backward) and the fused FFN plain versions,
    bitwise; the device-scalar optimizers against the host-float ones,
    bitwise.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_distributed_training_tpu import cli as jcli
from faster_distributed_training_tpu.config import TrainConfig as JConfig
from faster_distributed_training_tpu.data.device_resident import (
    DeviceResidentData as JResident)
from faster_distributed_training_tpu.data.synthetic import (
    synthetic_agnews as j_synthetic_agnews, synthetic_cifar as j_cifar)
from faster_distributed_training_tpu.optim import (
    build_optimizer as j_build_optimizer)
from faster_distributed_training_tpu.train.loop import (
    _stack_host_batches as j_stack)
from faster_distributed_training_tpu.train.state import (
    create_train_state as j_create_train_state)
from faster_distributed_training_tpu.train.steps import (
    _reduce_scanned_metrics, make_fused_train_step)
from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.data.device_resident import (
    DeviceResidentData)
from faster_distributed_training_tpu_torch.data.loader import BatchLoader
from faster_distributed_training_tpu_torch.data.synthetic import (
    synthetic_agnews, synthetic_cifar)
from faster_distributed_training_tpu_torch.interop import (
    flatten, params_from_jax, params_to_jax)
from faster_distributed_training_tpu_torch.optim import build_optimizer
from faster_distributed_training_tpu_torch.train import checkpoint as ckpt
from faster_distributed_training_tpu_torch.train import dispatch as dmod
from faster_distributed_training_tpu_torch.train.state import (
    create_train_state, state_leaves)
from faster_distributed_training_tpu_torch.train.steps import (
    StepDraws, make_train_step, step_draws, to_device)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs test files in parallel
    workers, and torch's thread-a-core default oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the device-resident split ----------------------------------------------

@pytest.mark.parametrize("kind", ["image", "text"])
def test_resident_split_matches_jax(kind):
    """JAX ``DeviceResidentData``: the same arrays and epoch orders, byte
    for byte."""
    if kind == "image":
        jds, tds = j_cifar(n=100, seed=0), synthetic_cifar(n=100, seed=0)
    else:
        jds = j_synthetic_agnews(n=100, seed=0, max_len=64)
        tds = synthetic_agnews(n=100, seed=0, max_len=64)
    want = JResident(jds, 16, seed=5, max_len=64)
    got = DeviceResidentData(tds, 16, seed=5, max_len=64, device="cpu")
    assert (got.n, got.steps_per_epoch, got.is_text, got.seq_len,
            got.nbytes) == (want.n, want.steps_per_epoch, want.is_text,
                            want.seq_len, want.nbytes)
    assert got.arrays.keys() == want.arrays.keys()
    for k, v in want.arrays.items():
        w = np.asarray(v)
        g = got.arrays[k].numpy()
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), k
    for epoch in (0, 1, 3):
        w = np.asarray(want.epoch_order(epoch))
        g = got.epoch_order(epoch).numpy()
        assert g.dtype == w.dtype == np.int32 and g.tobytes() == w.tobytes()


def test_resident_text_rows_equal_loader_batches_and_small_split_raises():
    tds = synthetic_agnews(n=100, seed=0, max_len=64)
    res = DeviceResidentData(tds, 16, seed=5, max_len=64, device="cpu",
                             checksum=True)
    assert res.verify_upload()
    order = res.epoch_order(2)
    for i, batch in enumerate(BatchLoader(tds, 16, epoch=2, seed=5,
                                          max_len=64)):
        rows = order[i * 16:(i + 1) * 16].long()
        for k, v in batch.items():
            g = res.arrays[k][rows].numpy()
            np.testing.assert_array_equal(g[..., :v.shape[-1]] if v.ndim > 1
                                          else g, v, err_msg=k)
            if v.ndim > 1:
                assert not g[..., v.shape[-1]:].any(), k
    with pytest.raises(ValueError, match="smaller than one batch"):
        DeviceResidentData(tds, 128, device="cpu")


def test_stream_and_sharded_layout_raise(tmp_path):
    """Both layers are ported (slice 17); what JAX refuses, the port
    refuses by name: the window off the on-disk format (a synthetic
    dataset) or over a subset."""
    argv = ["--dataset", "synthetic", "--epoch", "1", "--device", "cpu",
            "--n_layers", "1", "--d_model", "16", "--n_heads", "2",
            "--d_ff", "32", "--seq_len", "32", "--subset_stride", "64",
            "--bs", "8", "--checkpoint_dir", str(tmp_path), "--no_plot"]
    for flags, name in ((["--data_path", "stream"],
                         "--data_path stream reads the sharded on-disk"),
                        (["--data_path", "stream", "--dataset", "stream",
                          "--stream_dir", str(tmp_path)],
                         "--subset_stride is not supported with "
                         "--data_path stream")):
        with pytest.raises(ValueError, match=name):
            cli.main(argv + flags, defaults=cli.TRANSFORMER_DEFAULTS)
    assert not cli.unported_training_flags(cli.config_from_args(
        cli.build_parser(defaults=cli.TRANSFORMER_DEFAULTS).parse_args(
            argv + ["--data_path", "resident", "--resident_layout",
                    "sharded"]), defaults=cli.TRANSFORMER_DEFAULTS))


# -- K against K=1, bitwise ---------------------------------------------------

TINY_TF = ["--dataset", "synthetic", "--epoch", "1", "--device", "cpu",
           "--n_layers", "2", "--d_model", "16", "--n_heads", "2",
           "--d_ff", "32", "--seq_len", "32", "--subset_stride", "64",
           "--bs", "8", "--precision", "fp32", "--log_every", "0",
           "--no_plot"]
TINY_RN = ["--device", "cpu", "--model", "resnet18", "--dataset",
           "synthetic", "--bs", "8", "--epoch", "1", "--subset_stride",
           "128", "--optimizer", "sgd", "--mixup_mode", "static",
           "--precision", "fp32", "--log_every", "0", "--no_plot"]


def _run(tmp_path, name, argv, extra, model="transformer"):
    from faster_distributed_training_tpu_torch.resnet50_test import DEFAULTS

    defaults = cli.TRANSFORMER_DEFAULTS if model == "transformer" else DEFAULTS
    return cli.main(argv + ["--checkpoint_dir", str(tmp_path / name)]
                    + extra, defaults=defaults)


def _assert_bitwise(a, b):
    la, lb = state_leaves(a["state"]), state_leaves(b["state"])
    assert la.keys() == lb.keys()
    for k in la:
        assert torch.equal(la[k], lb[k]), k


@pytest.mark.parametrize("model,k,path", [
    ("transformer", 4, "host"), ("transformer", 3, "resident"),
    ("resnet18", 3, "host"), ("resnet18", 4, "resident")])
def test_k_steps_a_dispatch_equal_k1_bitwise(tmp_path, model, k, path):
    """The transformer's epoch is 8 steps (4 + 4, or 3 + 3 + a tail of
    2), resnet18's 4 (3 + a tail of 1, or one dispatch)."""
    argv = TINY_TF if model == "transformer" else TINY_RN
    one = _run(tmp_path, "k1", argv, [], model)
    many = _run(tmp_path, "kk", argv, ["--steps_per_dispatch", str(k),
                                       "--data_path", path], model)
    assert one["state"].step == many["state"].step
    assert one["state"].opt_state["step"] == many["state"].opt_state["step"]
    assert many["trainer"].dispatch.k == k
    _assert_bitwise(one, many)
    np.testing.assert_allclose(many["history"]["train_loss"],
                               one["history"]["train_loss"], rtol=1e-6)


# -- K=4 against JAX make_fused_train_step --------------------------------------

SMALL = dict(model="transformer", dataset="synthetic", num_classes=4,
             lr=1e-2, batch_size=4, epochs=2, alpha=0.99, seq_len=32,
             n_layers=2, d_model=64, d_ff=128, n_heads=4, precision="fp32",
             telemetry=False, plot=False, attention="dense")
VOCAB = 100


def _batches(n, bs=4, seq_len=32):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n):
        lengths = rng.integers(4, seq_len + 1, size=bs)
        lengths[1] = seq_len
        mask = (np.arange(seq_len)[None] < lengths[:, None]).astype(np.int32)
        labels = rng.integers(0, 4, size=bs).astype(np.int32)
        tokens = (rng.integers(1, VOCAB // 4, size=(bs, seq_len)) * 4
                  + labels[:, None]).astype(np.int32) * mask
        out.append({"tokens": tokens, "token_types": np.zeros_like(tokens),
                    "mask": mask, "label": labels})
    return out


def test_k4_dispatch_matches_jax_fused_step(monkeypatch):
    """``make_fused_train_step(cfg, 4)`` (un-jitted, its scan looped
    eagerly) records its draws by wrapping ``jax.random.bits`` / ``beta``
    / ``permutation``; the port's dispatch takes them as its tables."""
    jcfg = JConfig(device="cpu", **SMALL)
    jtx, _ = j_build_optimizer(jcfg, steps_per_epoch=4)
    jstate = j_create_train_state(
        jcli.build_model(jcfg, vocab_size=VOCAB), jtx,
        jnp.zeros((4, 32), jnp.int32), jax.random.PRNGKey(0),
        init_kwargs={"train": True})
    p0 = jax.tree_util.tree_map(np.asarray, jstate.params["model"])
    batches = _batches(4)

    rec = {"bits": [], "beta": [], "permutation": []}
    for name, sink in rec.items():
        orig = getattr(jax.random, name)

        def wrapped(*a, _orig=orig, _sink=sink, **kw):
            out = _orig(*a, **kw)
            _sink.append(np.asarray(out))
            return out
        monkeypatch.setattr(jax.random, name, wrapped)
    step_k = make_fused_train_step(jcfg, 4)
    with jax.disable_jit():
        jstate, jm = step_k(jstate, {k: jnp.asarray(v) for k, v in
                                     j_stack(batches).items()})

    cfg = TrainConfig(device="cpu", **SMALL)
    model = cli.build_model(cfg, vocab_size=VOCAB, device="cpu")
    model.load_state_dict(params_from_jax(p0))
    tx, _ = build_optimizer(cfg, steps_per_epoch=4)
    state = create_train_state(model, tx, seed=0)
    n = model.n_dropout_sites()
    assert len(rec["bits"]) == 4 * n and len(rec["beta"]) == 4
    draws = [StepDraws(seeds=tuple(int(b) for b in rec["bits"][i * n:
                                                             (i + 1) * n]),
                       lam=float(rec["beta"][i]),
                       perm=rec["permutation"][i]) for i in range(4)]
    disp = dmod.FusedDispatch(cfg, 4, "cpu")
    m = disp.run(state, 4, batches=batches, draws=draws)
    assert state.step == 4 and state.opt_state["step"] == 4
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(m["correct"]), float(jm["correct"]),
                               atol=1e-4)
    assert float(m["total"]) == float(jm["total"]) == 16
    want = flatten(jax.tree_util.tree_map(np.asarray,
                                          jstate.params["model"]))
    got = flatten(params_to_jax(model.state_dict(), cfg.n_heads))
    start = flatten(p0)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    assert max(np.abs(want[k] - start[k]).max() for k in want) > 1e-3


@pytest.mark.parametrize("lm,fp16", [(False, False), (True, True)])
def test_reduced_metrics_match_reduce_scanned_metrics(lm, fp16):
    rng = np.random.default_rng(1)
    ms = {"loss": rng.random(5).astype(np.float32),
          "correct": rng.integers(0, 8, 5).astype(np.float32),
          "total": np.full(5, 8.0, np.float32)}
    if lm:
        ms["loss_total"] = rng.random(5).astype(np.float32) * 50
    if fp16:
        ms["loss_scale"] = np.array([2.0 ** 16] * 4 + [2.0 ** 15],
                                    np.float32)
    want = _reduce_scanned_metrics({k: jnp.asarray(v) for k, v in ms.items()})
    got = dmod.reduce_metrics({k: torch.from_numpy(v) for k, v in ms.items()})
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)


def test_host_group_stacking_matches_jax():
    """Text batches of three bucket widths: padded to the widest, stacked,
    byte-identical to JAX ``_stack_host_batches``."""
    group = []
    for L in (16, 32, 8):
        b = _batches(1, seq_len=L)[0]
        group.append(b)
    want, got = j_stack(group), dmod.stack_host_batches(group)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].shape == want[k].shape and (
            got[k].tobytes() == want[k].tobytes()), k


# -- checkpoints on dispatch boundaries ---------------------------------------------

def test_checkpoint_every_rounds_up_to_a_multiple_of_k():
    lines = []
    cfg = TrainConfig(steps_per_dispatch=4, checkpoint_every=5)
    with pytest.warns(UserWarning, match="rounding up to 8"):
        got = cli.round_checkpoint_every(cfg, lines.append)
    assert got.checkpoint_every == 8
    assert lines == ["[ckpt] checkpoint_every rounded 5 -> 8 (multiple of "
                     "steps_per_dispatch=4)"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert cli.round_checkpoint_every(
            cfg.replace(checkpoint_every=8), lines.append
        ).checkpoint_every == 8
        assert cli.round_checkpoint_every(
            cfg.replace(steps_per_dispatch=1), lines.append
        ).checkpoint_every == 5


class _Killed(Exception):
    pass


@pytest.mark.parametrize("path", ["host", "resident"])
def test_killed_at_a_dispatch_boundary_resumes_bitwise(tmp_path, monkeypatch,
                                                       path):
    """K=2, --checkpoint_every 3 (rounded to 4): a run killed as its
    third dispatch starts resumes from the step-4 checkpoint and ends
    bitwise equal to the straight run (8 steps)."""
    kw = ["--steps_per_dispatch", "2", "--data_path", path,
          "--checkpoint_every", "3"]
    with pytest.warns(UserWarning, match="rounding up to 4"):
        straight = _run(tmp_path, "a", TINY_TF, kw)
    real = dmod.FusedDispatch.run

    def killed(self, state, kk, *a, **k):
        if state.step == 4:
            raise _Killed()
        return real(self, state, kk, *a, **k)

    monkeypatch.setattr(dmod.FusedDispatch, "run", killed)
    with pytest.warns(UserWarning), pytest.raises(_Killed):
        _run(tmp_path, "b", TINY_TF, kw)
    monkeypatch.setattr(dmod.FusedDispatch, "run", real)
    meta = ckpt.read_meta(str(tmp_path / "b"), "transformer_step")
    assert meta["step"] == 4 and meta["step_in_epoch"] == 4
    logs = []
    with pytest.warns(UserWarning):
        resumed = cli.main(TINY_TF + ["--checkpoint_dir", str(tmp_path / "b"),
                                      "--resume"] + kw,
                           defaults=cli.TRANSFORMER_DEFAULTS)
    assert resumed["state"].step == 8
    _assert_bitwise(straight, resumed)


# -- device-side per-step values ------------------------------------------------

def _fp16_state(cfg, vocab=VOCAB):
    model = cli.build_model(cfg, vocab_size=vocab, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    tx, _ = build_optimizer(cfg, steps_per_epoch=4)
    return create_train_state(model, tx, seed=0)


def test_fp16_select_skip_equals_k1_branch_on_an_injected_inf():
    """An inf in a parameter makes every grad non-finite: K=1 skips the
    update on the host (one ``bool``), the dispatch step selects the old
    leaves on the device; then a finite step.  Every leaf bitwise equal,
    the loss scale halved once."""
    cfg = TrainConfig(device="cpu", **dict(SMALL, precision="fp16",
                                           d_model=32, d_ff=64))
    batch = to_device(_batches(1)[0], "cpu")
    a, b = _fp16_state(cfg), _fp16_state(cfg)
    step = make_train_step(cfg)
    for st in (a, b):
        with torch.no_grad():
            st.model.cls_b2[0, 0] = float("inf")
    draws = step_draws(0, 0, 4, a.model.n_dropout_sites(), 0.99)
    step(a, batch, draws)
    sc = {k: torch.tensor(v, dtype=torch.float32)
          for k, v in b.tx.host_scalars(0).items()}
    _, m = step(b, batch, draws, sc)
    assert not bool(m["finite"])
    assert float(a.loss_scale.scale) == float(b.loss_scale.scale) == 2.0 ** 15
    la, lb = state_leaves(a), state_leaves(b)
    for k in la:
        if k != "opt/step":
            assert torch.equal(la[k], lb[k]), k
    for st in (a, b):
        with torch.no_grad():
            st.model.cls_b2[0, 0] = 0.0
    draws = step_draws(0, 1, 4, a.model.n_dropout_sites(), 0.99)
    step(a, batch, draws)
    _, m = step(b, batch, draws, {k: torch.tensor(v, dtype=torch.float32)
                                  for k, v in b.tx.host_scalars(0).items()})
    assert bool(m["finite"])
    la, lb = state_leaves(a), state_leaves(b)
    for k in la:
        if k != "opt/step":
            assert torch.equal(la[k], lb[k]), k


def test_tensor_seeds_equal_int_seeds_bitwise():
    from faster_distributed_training_tpu_torch.ops.dropout import hash_dropout
    from faster_distributed_training_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_recompute_reference,
        flash_attention_stats_reference)
    from faster_distributed_training_tpu_torch.ops.fused_ffn import (
        _ffn_body_reference, ffn_sublayer_reference)

    g = torch.Generator().manual_seed(0)
    for seed in (0, 12345, 0x9E3779B9, 0xFFFFFFFF):
        t = torch.tensor(seed, dtype=torch.int64)
        x = torch.randn(4, 33, generator=g, requires_grad=True)
        a = hash_dropout(x, seed, 0.1, offset=7)
        b = hash_dropout(x, t, 0.1, offset=7)
        assert torch.equal(a, b)
        ga, = torch.autograd.grad(a.sum(), x)
        gb, = torch.autograd.grad(b.sum(), x)
        assert torch.equal(ga, gb)
        q, k, v = (torch.randn(2, 2, 20, 16, generator=g) for _ in range(3))
        mask = torch.ones(2, 20, dtype=torch.int32)
        mask[1, 13:] = 0
        for got, want in zip(
                flash_attention_stats_reference(q, k, v, mask, 0.1, t),
                flash_attention_stats_reference(q, k, v, mask, 0.1, seed)):
            assert torch.equal(got, want)
        dout = torch.randn(q.shape, generator=g)
        for got, want in zip(
                flash_attention_bwd_recompute_reference(q, k, v, dout, mask,
                                                        0.1, t),
                flash_attention_bwd_recompute_reference(q, k, v, dout, mask,
                                                        0.1, seed)):
            assert torch.equal(got, want)
        h = torch.randn(6, 32, generator=g)
        args = (torch.ones(32), torch.zeros(32),
                torch.randn(64, 32, generator=g) * 0.2, torch.zeros(64),
                torch.randn(32, 64, generator=g) * 0.2, torch.zeros(32))
        assert torch.equal(
            ffn_sublayer_reference(h, *args, t, t ^ 5, 0.1, 0.1),
            ffn_sublayer_reference(h, *args, seed, seed ^ 5, 0.1, 0.1))
        assert torch.equal(
            _ffn_body_reference(h, *args, t, t ^ 5, 0.1, 0.1, 1e-6,
                                c0=3, dff_glob=128),
            _ffn_body_reference(h, *args, seed, seed ^ 5, 0.1, 0.1, 1e-6,
                                c0=3, dff_glob=128))


@pytest.mark.parametrize("optimizer,schedule", [
    ("mirror_madgrad", "onecycle"), ("madgrad", "cosine"),
    ("sgd", "multistep"), ("ngd", "step")])
def test_device_scalar_optimizers_equal_host_float_ones(optimizer, schedule):
    """Six updates with the host schedule's Python floats and with the
    same values as fp32 0-dim tensors (a dispatch's table slots): every
    parameter and state leaf bitwise equal; clip 10 on, large grads so
    it bites."""
    cfg = TrainConfig(model="resnet18", optimizer=optimizer, lr=0.1,
                      schedule=schedule, epochs=3, momentum=0.9,
                      weight_decay=1e-4, clip_norm=10.0, ngd_update_period=2)
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(6, 5)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    tx, _ = build_optimizer(cfg, steps_per_epoch=2)
    pa = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    pb = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    sa, sb = tx.init(pa), tx.init(pb)
    for i in range(12):
        g = {k: torch.from_numpy((rng.normal(size=v.shape)
                                  * (40.0 if i % 3 == 0 else 0.5))
                                 .astype(np.float32))
             for k, v in params.items()}
        tx.update(dict(g), sa, pa)
        sc = {k: torch.tensor(v, dtype=torch.float32)
              for k, v in tx.host_scalars(sb["step"]).items()}
        tx.update(dict(g), sb, pb, sc)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    la, lb = list(_tensors(sa)), list(_tensors(sb))
    assert sa["step"] == sb["step"] == 12 and len(la) == len(lb) > 0
    assert all(torch.equal(x, y) for x, y in zip(la, lb))


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k])
