"""The port's training slice as a whole, against the JAX package.

  * 3 train steps of the port (``train.steps.make_train_step``) against
    JAX's real ``train/steps.py::make_train_step`` (un-jitted) on the
    same parameters, batches and draws, fp32.  The flash route runs the
    JAX Pallas forward and saved-stats backward kernels in interpret mode
    (``FDT_FORCE_PALLAS_INTERPRET=1``); a second case takes the dense
    route.  JAX's draws are recorded by wrapping ``jax.random.bits``,
    ``jax.random.beta`` and ``jax.random.permutation`` and handed to the
    port as ``StepDraws``.  Loss to 1e-5 each step; parameters after 3
    steps to 1e-4 (they move by more than 1e-3).
  * Resume within the port: 6 straight steps against 3 steps, save, a
    fresh state, restore, 3 more steps — parameters and optimizer state
    bitwise equal, at an epoch boundary and mid-epoch.
  * The entry points: ``cli.main`` trains on the CPU when asked (also
    with ``--ffn_impl pallas --quant int8``, ``--remat``,
    ``--steps_per_dispatch 2`` and ``--data_path resident``), and the
    flags of unreached features raise NotImplementedError.

Small size: 2 layers, d_model 64, 4 heads (D = 16), d_ff 128, vocab 100.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_distributed_training_tpu import cli as jcli
from faster_distributed_training_tpu.config import TrainConfig as JConfig
from faster_distributed_training_tpu.optim import (
    build_optimizer as j_build_optimizer)
from faster_distributed_training_tpu.train.state import (
    create_train_state as j_create_train_state)
from faster_distributed_training_tpu.train.steps import (
    make_train_step as j_make_train_step)
from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.interop import (
    flatten, params_from_jax, params_to_jax)
from faster_distributed_training_tpu_torch.optim import build_optimizer
from faster_distributed_training_tpu_torch.train import checkpoint as ckpt
from faster_distributed_training_tpu_torch.train.state import (
    create_train_state)
from faster_distributed_training_tpu_torch.train.steps import (
    StepDraws, make_train_step, to_device)

SMALL = dict(model="transformer", dataset="synthetic", num_classes=4,
             lr=1e-2, batch_size=8, epochs=2, alpha=0.99, seq_len=64,
             n_layers=2, d_model=64, d_ff=128, n_heads=4, precision="fp32",
             telemetry=False, plot=False)
VOCAB = 100


def _batches(n, bs=8, seq_len=64):
    """Ragged padded token batches (ids < VOCAB) with learnable labels."""
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


class _Recorder:
    """Wraps jax.random.bits / beta / permutation and keeps their
    values in call order."""

    def __init__(self, monkeypatch):
        self.bits, self.lam, self.perm = [], [], []
        for name, sink in (("bits", self.bits), ("beta", self.lam),
                           ("permutation", self.perm)):
            orig = getattr(jax.random, name)

            def wrapped(*a, _orig=orig, _sink=sink, **kw):
                out = _orig(*a, **kw)
                _sink.append(np.asarray(out))
                return out
            monkeypatch.setattr(jax.random, name, wrapped)

    def take(self) -> StepDraws:
        assert len(self.lam) == 1 and len(self.perm) == 1
        # a shaped draw (the fused FFN's (2,) pair) gives one seed per
        # element, in order
        draws = StepDraws(seeds=tuple(int(v) for b in self.bits
                                      for v in np.ravel(b)),
                          lam=float(self.lam[0]), perm=self.perm[0])
        self.bits.clear(), self.lam.clear(), self.perm.clear()
        return draws


@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_three_train_steps_match_jax_make_train_step(attention,
                                                     monkeypatch):
    monkeypatch.setenv("FDT_FORCE_PALLAS_INTERPRET", "1")
    jcfg = JConfig(device="cpu", attention=attention, **SMALL)
    jtx, _ = j_build_optimizer(jcfg, steps_per_epoch=4)
    # the parameter tree does not depend on the attention route: init
    # through the dense model (no interpret-mode kernels), step through
    # the configured one
    jstate = j_create_train_state(
        jcli.build_model(jcfg.replace(attention="dense"), vocab_size=VOCAB),
        jtx, jnp.zeros((4, 32), jnp.int32), jax.random.PRNGKey(0),
        init_kwargs={"train": True})
    jstate = jstate.replace(
        apply_fn=jcli.build_model(jcfg, vocab_size=VOCAB).apply)
    p0 = jax.tree_util.tree_map(np.asarray, jstate.params["model"])
    jstep = j_make_train_step(jcfg)

    cfg = TrainConfig(device="cpu", attention=attention, **SMALL)
    model = cli.build_model(cfg, vocab_size=VOCAB, device="cpu")
    model.load_state_dict(params_from_jax(p0))
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
        np.testing.assert_allclose(float(m["correct"]), float(jm["correct"]),
                                   atol=1e-4)
    want = flatten(jax.tree_util.tree_map(np.asarray,
                                          jstate.params["model"]))
    got = flatten(params_to_jax(model.state_dict(), cfg.n_heads))
    start = flatten(p0)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    # the parameters did move, by much more than the tolerance
    assert max(np.abs(want[k] - start[k]).max() for k in want) > 1e-3


def _tiny_cfg(tmp_path, **kw):
    base = dict(SMALL, lr=5e-3, subset_stride=64, checkpoint_dir=str(tmp_path),
                log_every=0, device="cpu", prefetch_depth=0)
    base.update(kw)
    return TrainConfig(**base)


def _state_tensors(state):
    flat = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    for part in ("v", "z"):
        for k, v in state.opt_state[part].items():
            flat[f"opt/{part}/{k}"] = v
    return flat


class _Killed(Exception):
    pass


@pytest.mark.parametrize("batch_size,epochs", [(21, 2), (10, 1)],
                         ids=["epoch_boundary", "mid_epoch"])
def test_resume_is_bitwise(tmp_path, monkeypatch, batch_size, epochs):
    """64 training rows (subset stride 64): batch 21 gives 3 steps an
    epoch (the checkpoint at step 3 closes epoch 0), batch 10 gives 6
    (the checkpoint at step 3 is mid-epoch).  6 steps either way."""
    from faster_distributed_training_tpu_torch.train import steps as tsteps

    logs = []
    kw = dict(batch_size=batch_size, epochs=epochs, checkpoint_every=3)
    straight = cli.run_training(_tiny_cfg(tmp_path / "a", **kw),
                                log=logs.append)
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
        cli.run_training(_tiny_cfg(tmp_path / "b", **kw), log=logs.append)
    monkeypatch.setattr(tsteps, "make_train_step", real)
    assert ckpt.read_meta(str(tmp_path / "b"), "transformer_step")["step"] == 3
    resumed = cli.run_training(_tiny_cfg(tmp_path / "b", resume=True, **kw),
                               log=logs.append)
    assert resumed["state"].step == 6
    assert any("[resume]" in line or "resumed from" in line for line in logs)
    a, b = _state_tensors(straight["state"]), _state_tensors(resumed["state"])
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_cli_trains_on_cpu_and_rejects_unported_flags(tmp_path):
    argv = ["--dataset", "synthetic", "--epoch", "1", "--device", "cpu",
            "--n_layers", "1", "--d_model", "32", "--n_heads", "2",
            "--d_ff", "64", "--seq_len", "64", "--subset_stride", "64",
            "--bs", "16", "--precision", "fp32", "--log_every", "0",
            "--checkpoint_dir", str(tmp_path), "--no_telemetry", "--no_plot"]
    out = cli.main(argv, defaults=cli.TRANSFORMER_DEFAULTS)
    hist = out["history"]
    assert out["state"].step == out["steps_per_epoch"] == 4
    assert np.isfinite(hist["train_loss"]).all() and len(hist["test_acc"]) == 1
    for flags, name in ((["--ngd"], "--ngd"),
                        (["--warm_spares", "1"], "--warm_spares"),
                        (["--data_path", "stream"], "--data_path stream"),
                        (["--mesh", "dp=1,tp=3"], "--mesh"),
                        (["--profile"], "--profile"),
                        (["--dataset", "cifar10"], "--dataset cifar10")):
        with pytest.raises(NotImplementedError, match=name):
            cli.main(argv + flags, defaults=cli.TRANSFORMER_DEFAULTS)
    # the resilience flags train (slice 15)
    for flags in (["--auto_recover"], ["--supervise"]):
        out = cli.main(argv + flags, defaults=cli.TRANSFORMER_DEFAULTS)
        assert out["state"].step == 4 and not out.get("preempted"), flags
    # --lm_causal on --task cls does what JAX's does: nothing (JAX's
    # causal mask needs task lm)
    out = cli.main(argv + ["--lm_causal"], defaults=cli.TRANSFORMER_DEFAULTS)
    assert out["state"].step == 4 and not out["state"].model.causal
    # the one-card performance layers train (slice 9)
    for flags in (["--remat"], ["--steps_per_dispatch", "2"],
                  ["--data_path", "resident"]):
        out = cli.main(argv + flags, defaults=cli.TRANSFORMER_DEFAULTS)
        assert out["state"].step == 4, flags
    # fp16 loss scaling (fp32 compute) trains the transformer too
    out = cli.main(argv + ["--precision", "fp16"],
                   defaults=cli.TRANSFORMER_DEFAULTS)
    assert out["state"].step == 4
    assert float(out["state"].loss_scale.scale) == 2.0 ** 16
    assert np.isfinite(out["history"]["train_loss"]).all()
    # the record's --dataset agnews without its CSVs: the JAX package's
    # synthetic fallback (12000 train rows, 188 at subset stride 64)
    out = cli.main(argv[2:] + ["--data_dir", str(tmp_path / "no_csv")],
                   defaults=cli.TRANSFORMER_DEFAULTS)
    assert out["state"].step == out["steps_per_epoch"] == 188 // 16
    assert np.isfinite(out["history"]["train_loss"]).all()
