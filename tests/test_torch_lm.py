"""The port's next-token LM (``--task lm``) against the JAX package.

  * The LM head, tied (the default) and untied: eval logits and a training
    forward with dropout against the flax ``Transformer(lm_head=True)`` at
    fp32, the training forward's seeds recorded from JAX's
    ``jax.random.bits`` in its call order (no pooler site).
  * ``train/steps.py::lm_shift_metrics`` with a token mask and a sample
    ``valid`` mask (fp32, 1e-6 relative); ``train/metrics.py::perplexity``
    with its cap (equal).
  * 3 LM train steps of the port against JAX's ``make_train_step`` (dense
    attention, tied, untied and ``--lm_causal``) with injected draws: loss
    to 1e-5 each step, parameters to 1e-4 after 3 steps.  The LM eval
    step on a padded batch against JAX's ``make_eval_step``.
  * Interop: the untied ``lm_head`` through the JAX tree and back; the
    tied model has no extra leaf.
  * Within the port: ``--task lm`` killed after 3 steps and resumed is
    bitwise the uninterrupted run; the CLI trains the LM on the CPU from a
    port-written corpus and raises for what it has not reached.

Small size: 2 layers, d_model 64, 4 heads (D = 16), d_ff 128, vocab 100,
sequence 32 (the CLI cases run on a 64-document synthetic corpus).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_distributed_training_tpu import cli as jcli
from faster_distributed_training_tpu.config import TrainConfig as JConfig
from faster_distributed_training_tpu.models.transformer import (
    Transformer as FlaxTransformer)
from faster_distributed_training_tpu.optim import (
    build_optimizer as j_build_optimizer)
from faster_distributed_training_tpu.train.metrics import (
    perplexity as j_perplexity)
from faster_distributed_training_tpu.train.state import (
    create_train_state as j_create_train_state)
from faster_distributed_training_tpu.train.steps import (
    lm_shift_metrics as j_lm_shift_metrics)
from faster_distributed_training_tpu.train.steps import (
    make_eval_step as j_make_eval_step)
from faster_distributed_training_tpu.train.steps import (
    make_train_step as j_make_train_step)
from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.data.stream import (
    synthetic_corpus, write_lm_corpus)
from faster_distributed_training_tpu_torch.interop import (
    flatten, params_from_jax, params_to_jax)
from faster_distributed_training_tpu_torch.models.transformer import (
    Transformer)
from faster_distributed_training_tpu_torch.optim import build_optimizer
from faster_distributed_training_tpu_torch.train import checkpoint as ckpt
from faster_distributed_training_tpu_torch.train.metrics import perplexity
from faster_distributed_training_tpu_torch.train.state import (
    create_train_state)
from faster_distributed_training_tpu_torch.train.steps import (
    StepDraws, lm_shift_metrics, make_eval_step, make_train_step, to_device)

VOCAB, L = 100, 32
WIDTHS = dict(vocab=VOCAB, n_layers=2, h=4, d_model=64, d_ff=128, maxlen=L)
SMALL = dict(model="transformer", dataset="synthetic", num_classes=4,
             lr=1e-2, batch_size=4, epochs=1, alpha=0.99, seq_len=L,
             n_layers=2, d_model=64, d_ff=128, n_heads=4, precision="fp32",
             telemetry=False, plot=False, task="lm", attention="dense")


def _lm_batches(n, bs=4, seed=5):
    """Packed LM rows (mask all ones), ids in [1, VOCAB)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tokens = rng.integers(1, VOCAB, size=(bs, L)).astype(np.int32)
        out.append({"tokens": tokens, "token_types": np.zeros_like(tokens),
                    "mask": np.ones_like(tokens),
                    "label": np.zeros(bs, np.int32)})
    return out


class _Bits:
    """Records jax.random.bits (the dropout sites' u32 seeds) in call
    order; the LM draws no mixup lambda or permutation."""

    def __init__(self, monkeypatch):
        self.bits = []
        self.mixup_calls = 0
        orig = jax.random.bits

        def bits(*a, **kw):
            out = orig(*a, **kw)
            self.bits.append(np.asarray(out))
            return out
        monkeypatch.setattr(jax.random, "bits", bits)
        for name in ("beta", "permutation"):
            fn = getattr(jax.random, name)

            def counted(*a, _fn=fn, **kw):
                self.mixup_calls += 1
                return _fn(*a, **kw)
            monkeypatch.setattr(jax.random, name, counted)

    def take(self, batch_size) -> StepDraws:
        seeds = tuple(int(v) for b in self.bits for v in np.ravel(b))
        self.bits.clear()
        return StepDraws(seeds=seeds, lam=0.5, perm=np.arange(batch_size))


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_lm_head_matches_flax(tied, monkeypatch):
    """Transformer(lm_head=True) against the flax module: eval logits and
    a training forward with dropout 0.1 at every site, fp32 1e-5."""
    flax_model = FlaxTransformer(n_class=4, lm_head=True, tie_lm_head=tied,
                                 **WIDTHS)
    tokens = _lm_batches(1, bs=3)[0]["tokens"]
    variables = flax_model.init(jax.random.PRNGKey(0), jnp.asarray(tokens),
                                train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    assert ("lm_head" in params) == (not tied)
    assert "pooler" not in params and "cls_w1" not in params
    model = Transformer(n_class=4, lm_head=True, tie_lm_head=tied, **WIDTHS)
    model.load_state_dict(params_from_jax(params))
    t = torch.from_numpy(tokens).long()

    want = np.asarray(flax_model.apply({"params": params},
                                       jnp.asarray(tokens), train=False))
    with torch.no_grad():
        got = model(t).numpy()
    assert got.shape == (3, L, VOCAB) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    rec = _Bits(monkeypatch)
    want = np.asarray(flax_model.apply(
        {"params": params}, jnp.asarray(tokens), train=True,
        rngs={"dropout": jax.random.PRNGKey(1),
              "mixup": jax.random.PRNGKey(2)}))
    draws = rec.take(3)
    assert rec.mixup_calls == 0
    assert len(draws.seeds) == model.n_dropout_sites() == 1 + 4 * 2
    with torch.no_grad():
        got = model(t, train=True, draws=draws).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_tied_logits_read_the_token_table():
    """Tied: a bump to one row of the token table moves that vocab
    column's logits only (the tokens never embed that row)."""
    model = Transformer(n_class=4, lm_head=True, tie_lm_head=True, **WIDTHS)
    model.init_weights(torch.Generator().manual_seed(0))
    assert not hasattr(model, "lm_head") and not hasattr(model, "pooler")
    tokens = torch.ones(2, L, dtype=torch.long)
    with torch.no_grad():
        base = model(tokens)
        model.embeddings.token_embedding[7] += 100.0
        out = model(tokens)
    assert not torch.equal(out[..., 7], base[..., 7])
    assert torch.equal(out[..., :7], base[..., :7])


def test_lm_shift_metrics_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 10, 17)) * 3).astype(np.float32)
    tokens = rng.integers(0, 17, size=(3, 10)).astype(np.int32)
    tok_mask = np.ones((3, 10), np.int32)
    tok_mask[1, 6:] = 0
    valid = np.array([1.0, 1.0, 0.0], np.float32)
    for tm, sv in ((None, None), (tok_mask, None), (tok_mask, valid)):
        want = j_lm_shift_metrics(
            jnp.asarray(logits), jnp.asarray(tokens),
            None if tm is None else jnp.asarray(tm),
            None if sv is None else jnp.asarray(sv))
        got = lm_shift_metrics(
            torch.from_numpy(logits), torch.from_numpy(tokens),
            None if tm is None else torch.from_numpy(tm),
            None if sv is None else torch.from_numpy(sv))
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=0)
    # the padded row and the masked tail count no target
    assert float(got[2]) == 9 + 5


def test_perplexity_matches_jax_and_caps():
    for loss in (0.0, 1.5, 6.4, 29.9, 30.0, 31.0, 1e9, float("inf")):
        assert perplexity(loss) == j_perplexity(loss)
    assert perplexity(1e9) == perplexity(30.0) < float("inf")


def _jax_state(jcfg, tied):
    jtx, _ = j_build_optimizer(jcfg, steps_per_epoch=4)
    model = jcli.build_model(jcfg.replace(tie_lm_head=tied),
                             vocab_size=VOCAB)
    return j_create_train_state(model, jtx, jnp.zeros((4, L), jnp.int32),
                                jax.random.PRNGKey(0),
                                init_kwargs={"train": True})


@pytest.mark.parametrize("tied,causal", [(True, False), (False, False),
                                         (True, True)],
                         ids=["tied", "untied", "causal"])
def test_three_lm_steps_match_jax_make_train_step(tied, causal, monkeypatch):
    """``causal``: ``--lm_causal``, the [1, 1, L, L] mask in every
    attention of the training and eval forwards (JAX
    ``models/transformer.py:851-857``)."""
    jcfg = JConfig(device="cpu", tie_lm_head=tied, lm_causal=causal, **SMALL)
    jstate = _jax_state(jcfg, tied)
    p0 = jax.tree_util.tree_map(np.asarray, jstate.params["model"])
    jstep = j_make_train_step(jcfg)

    cfg = TrainConfig(device="cpu", tie_lm_head=tied, lm_causal=causal,
                      **SMALL)
    model = cli.build_model(cfg, vocab_size=VOCAB, device="cpu")
    assert model.tie_lm_head == tied and model.causal == causal
    model.load_state_dict(params_from_jax(p0))
    tx, _ = build_optimizer(cfg, steps_per_epoch=4)
    state = create_train_state(model, tx, seed=0)
    step = make_train_step(cfg)

    rec = _Bits(monkeypatch)
    for i, batch in enumerate(_lm_batches(3)):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        draws = rec.take(4)
        assert len(draws.seeds) == model.n_dropout_sites()
        state, m = step(state, to_device(batch, "cpu"), draws)
        for key, tol in (("loss", 1e-5), ("loss_total", 1e-5 * 4 * 31),
                         ("correct", 1e-4), ("total", 0)):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=0, atol=tol,
                                       err_msg=f"step {i} {key}")
    assert rec.mixup_calls == 0
    want = flatten(jax.tree_util.tree_map(np.asarray,
                                          jstate.params["model"]))
    got = flatten(params_to_jax(model.state_dict(), cfg.n_heads))
    start = flatten(p0)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    assert max(np.abs(want[k] - start[k]).max() for k in want) > 1e-3


def test_lm_eval_step_on_a_padded_batch_matches_jax():
    """Two real rows and two pad rows (``valid`` 0), one real row with a
    padded tail (token mask 0): only the real targets count."""
    jcfg = JConfig(device="cpu", **SMALL)
    jstate = _jax_state(jcfg, True)
    params = jax.tree_util.tree_map(np.asarray, jstate.params["model"])
    cfg = TrainConfig(device="cpu", **SMALL)
    model = cli.build_model(cfg, vocab_size=VOCAB, device="cpu")
    model.load_state_dict(params_from_jax(params))
    tx, _ = build_optimizer(cfg, steps_per_epoch=4)
    state = create_train_state(model, tx, seed=0)
    batch = _lm_batches(1)[0]
    batch["mask"][1, 20:] = 0
    batch["valid"] = np.array([1.0, 1.0, 0.0, 0.0], np.float32)
    want = j_make_eval_step(jcfg)(jstate, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    got = make_eval_step(cfg)(state, to_device(batch, "cpu"))
    assert float(got["total"]) == float(want["total"]) == 31 + 19
    for key, tol in (("loss", 1e-5), ("loss_total", 1e-3), ("correct", 0)):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=0, atol=tol, err_msg=key)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_interop_round_trips_the_lm_tree(tied):
    flax_model = FlaxTransformer(n_class=4, lm_head=True, tie_lm_head=tied,
                                 **WIDTHS)
    variables = flax_model.init(jax.random.PRNGKey(3),
                                jnp.ones((2, L), jnp.int32), train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    model = Transformer(n_class=4, lm_head=True, tie_lm_head=tied, **WIDTHS)
    model.load_state_dict(params_from_jax(params))
    keys = set(model.state_dict())
    assert ("lm_head.weight" in keys) == (not tied)
    assert not any(k.startswith(("pooler", "cls_")) for k in keys)
    back = flatten(params_to_jax(model.state_dict(), WIDTHS["h"]))
    want = flatten(params)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A port-written LM corpus: 64 synthetic documents packed at seq 32
    (about 150 train rows, 17 test rows), its vocab cached in a data_dir
    of its own."""
    root = tmp_path_factory.mktemp("lm_corpus")
    out = write_lm_corpus(str(root / "corpus"), synthetic_corpus(64, seed=0),
                          L, data_dir=str(root / "data"), log=lambda _: None)
    return str(root / "corpus"), out


def _lm_cfg(tmp_path, stream_dir, **kw):
    base = dict(SMALL, dataset="stream", stream_dir=stream_dir, lr=5e-3,
                batch_size=8, subset_stride=4, epochs=2,
                checkpoint_dir=str(tmp_path), log_every=0, device="cpu",
                prefetch_depth=0)
    base.update(kw)
    return TrainConfig(**base)


class _Killed(Exception):
    pass


def test_lm_resume_is_bitwise(tmp_path, monkeypatch, corpus):
    """Untied head, subset stride 4: 4 steps an epoch over 2 epochs; the
    run is killed at step 3 (mid-epoch, after the step-3 checkpoint) and
    resumed in a fresh state.  Parameters (lm_head included) and
    optimizer state equal the uninterrupted run's bit for bit."""
    from faster_distributed_training_tpu_torch.train import steps as tsteps

    stream_dir, _ = corpus
    kw = dict(checkpoint_every=3, tie_lm_head=False)
    logs = []
    straight = cli.run_training(_lm_cfg(tmp_path / "a", stream_dir, **kw),
                                log=logs.append)
    assert straight["steps_per_epoch"] == 4 and straight["state"].step == 8

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
        cli.run_training(_lm_cfg(tmp_path / "b", stream_dir, **kw),
                         log=logs.append)
    monkeypatch.setattr(tsteps, "make_train_step", real)
    assert ckpt.read_meta(str(tmp_path / "b"), "transformer_step")["step"] == 3
    resumed = cli.run_training(
        _lm_cfg(tmp_path / "b", stream_dir, resume=True, **kw),
        log=logs.append)
    assert resumed["state"].step == 8
    assert any("[resume]" in line for line in logs)
    a, b = straight["state"], resumed["state"]
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert "lm_head.weight" in sa and sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for part in ("v", "z"):
        for k in a.opt_state[part]:
            assert torch.equal(a.opt_state[part][k], b.opt_state[part][k]), k


def test_cli_trains_the_lm_on_cpu_and_rejects_what_is_not_ported(
        tmp_path, corpus):
    stream_dir, written = corpus
    argv = ["--task", "lm", "--dataset", "stream", "--stream_dir",
            stream_dir, "--epoch", "1", "--n_layers", "1", "--d_model",
            "32", "--n_heads", "2", "--d_ff", "64", "--bs", "8",
            "--precision", "fp32", "--log_every", "0", "--subset_stride",
            "4", "--checkpoint_dir", str(tmp_path), "--no_telemetry",
            "--no_plot"]
    logs = []
    cfg = cli.config_from_args(cli.build_parser(
        defaults=cli.TRANSFORMER_DEFAULTS).parse_args(argv + [
            "--device", "cpu"]), defaults=cli.TRANSFORMER_DEFAULTS)
    out = cli.run_training(cfg, log=logs.append)
    hist = out["history"]
    assert out["state"].step == out["steps_per_epoch"] == 4
    assert out["cfg"].seq_len == L      # the corpus's rows, not --seq_len
    assert any("overriding --seq_len 512" in line for line in logs)
    assert out["state"].model.embeddings.token_embedding.shape[0] == (
        written["vocab_size"])
    for key in ("train_loss", "test_loss", "train_ppl", "test_ppl"):
        assert len(hist[key]) == 1 and np.isfinite(hist[key]).all(), key
    assert hist["test_ppl"][0] == perplexity(hist["test_loss"][0])
    assert any("test_ppl=" in line for line in logs)

    cpu = argv + ["--device", "cpu"]
    for flags, name in ((["--quant", "int8"], "--task lm with --quant"),
                        (["--ffn_impl", "pallas"],
                         "--task lm with --ffn_impl pallas"),
                        (["--lm_causal", "--mesh", "pp=2"],
                         "--lm_causal under --mesh pp=2")):
        with pytest.raises(NotImplementedError, match=name):
            cli.main(cpu + flags, defaults=cli.TRANSFORMER_DEFAULTS)
    # the stream window (slice 17) addresses the whole on-disk split:
    # a subset is refused, as JAX refuses it
    with pytest.raises(ValueError, match="--subset_stride is not supported"):
        cli.main(cpu + ["--data_path", "stream"],
                 defaults=cli.TRANSFORMER_DEFAULTS)
    # --lm_causal trains (dense attention, the causal mask in the model);
    # an explicit kernel that cannot take the mask raises, naming both
    # flags, and so do the sequence and tensor meshes
    out = cli.main(cpu + ["--lm_causal"], defaults=cli.TRANSFORMER_DEFAULTS)
    model = out["state"].model
    assert model.causal and model.layers[0].attn.attention_impl == "dense"
    assert out["state"].step == 4
    assert np.isfinite(out["history"]["train_loss"]).all()
    with pytest.raises(ValueError, match="--lm_causal.*--attention flash"):
        cli.main(cpu + ["--lm_causal", "--attention", "flash"],
                 defaults=cli.TRANSFORMER_DEFAULTS)
    for mesh in ("sp=2", "tp=2"):
        with pytest.raises(NotImplementedError,
                           match=f"--lm_causal under --mesh {mesh}"):
            cli.main(cpu + ["--lm_causal", "--mesh", mesh],
                     defaults=cli.TRANSFORMER_DEFAULTS)
    # packed LM rows carry no labels: a classifier run on them raises
    with pytest.raises(ValueError, match="--task lm"):
        cli.main([a for a in cpu if a not in ("--task", "lm")],
                 defaults=cli.TRANSFORMER_DEFAULTS)
    if not torch.cuda.is_available():
        # the entry point runs on the card unless asked for the CPU
        with pytest.raises(RuntimeError, match="no CUDA"):
            cli.main(argv, defaults=cli.TRANSFORMER_DEFAULTS)
