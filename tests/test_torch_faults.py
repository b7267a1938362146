"""The port against the JAX package where they used to part ways: the AG
News reader and its synthetic fallback (``--dataset agnews``), ``--plot``,
``--mlp_impl naive``, step checkpoints kept by ``--checkpoint_keep`` and
saved by ``--checkpoint_every_secs``, and flags and resilience seams that
raise (``--optimizer adamw``, ``--warm_spares``, ``FDT_SLICE_COUNT`` > 1,
``FDT_SLICE_SPARE``, ``FDT_FAULT_SLICE``).

Token ids, lengths and batches are held byte-identical to JAX's
(``data/agnews.py``, ``cli.load_dataset``); the naive classifier's
logits and gradients to the flax model's ``mlp_impl="naive"`` arm at fp32
1e-5; resume from the newest kept checkpoint bitwise to an unbroken run.
JAX's HuggingFace tokenizer step is monkeypatched away: ``transformers``
is installed here and the port has no HF step.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faster_distributed_training_tpu.data.agnews as j_agnews
from faster_distributed_training_tpu import cli as jcli
from faster_distributed_training_tpu.config import TrainConfig as JConfig
from faster_distributed_training_tpu.models.transformer import (
    Transformer as FlaxTransformer)
from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.data import agnews
from faster_distributed_training_tpu_torch.interop import params_from_jax
from faster_distributed_training_tpu_torch.models import transformer as tmod
from faster_distributed_training_tpu_torch.train import checkpoint as ckpt
from faster_distributed_training_tpu_torch.train import loop as tloop

ROWS = [
    ("Wall St. Bears Claw Back Into the Black (Reuters)", 3),
    ("Carlyle Looks Toward Commercial Aerospace &lt;b&gt;...&lt;/b&gt;", 3),
    ("Oil and Economy Cloud Stocks' Outlook http://www.reuters.com/x", 3),
    ("Iraq Halts Oil Exports from Main Southern Pipeline", 1),
    ("Google IPO faces a hurdle as the auction nears www.google.com", 4),
    ("The Red Sox beat the Yankees 11-9 in the ninth inning", 2),
    ("<p>Scientists find water ice on a distant moon</p>", 4),
    ("Phelps wins his sixth gold medal; sets a world record", 2),
    ("New chip doubles the speed of home computers, maker says", 4),
    ("Ministers meet in Geneva to talk about trade and tariffs", 1),
    ("A a an the of and is was were it its they them", 1),
    ("Rivals' shares fall as the dollar gains against the yen", 3),
]


@pytest.fixture(autouse=True)
def _no_hf_tokenizer(monkeypatch):
    monkeypatch.setattr(j_agnews, "_load_hf_tokenizer", lambda: None)


def _assert_batches_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def test_agnews_from_samples_matches_jax():
    """``AGNewsDataset.from_samples`` (JAX data/agnews.py:228) on a dozen
    hand-written rows: cleaned texts, token ids, lengths and labels."""
    got = agnews.AGNewsDataset.from_samples(ROWS, buckets=(8, 16, 32))
    want = j_agnews.AGNewsDataset.from_samples(ROWS, buckets=(8, 16, 32))
    assert got.samples == want.samples
    assert got.vocab_size() == want.vocab_size()
    for idx in ([0, 1, 2], list(range(12)), [10], [5, 3, 9, 11]):
        for max_len in (8, 32):
            _assert_batches_equal(got.encode_batch(idx, max_len),
                                  want.encode_batch(idx, max_len))


def _write_csvs(root, train_rows, test_rows):
    os.makedirs(os.path.join(root, "ag_news"))
    for name, rows in (("train.csv", train_rows), ("test.csv", test_rows)):
        with open(os.path.join(root, "ag_news", name), "w",
                  encoding="utf-8") as f:
            for text, label in rows:
                title, _, desc = text.partition(" ")
                f.write(f'"{label}","{title}","{desc}"\n')


def test_agnews_csv_matches_jax(tmp_path):
    """A two-line CSV pair read by both packages from their own copies:
    the same samples, the same cached WordPiece vocab file and
    byte-identical ``encode_batch`` output for both splits."""
    for d in ("jax", "port"):
        _write_csvs(str(tmp_path / d), ROWS[:2], ROWS[5:7])
    for train in (True, False):
        got = agnews.AGNewsDataset(str(tmp_path / "port"), train=train)
        want = j_agnews.AGNewsDataset(str(tmp_path / "jax"), train=train)
        assert got.samples == want.samples and len(got) == 2
        _assert_batches_equal(got.encode_batch([0, 1], 512),
                              want.encode_batch([0, 1], 512))
    vocab = [sorted(os.listdir(tmp_path / d / "ag_news"))
             for d in ("jax", "port")]
    assert vocab[0] == vocab[1] and len(vocab[0]) == 3
    name = [n for n in vocab[0] if n.startswith("wordpiece_vocab_")][0]
    assert ((tmp_path / "jax" / "ag_news" / name).read_bytes()
            == (tmp_path / "port" / "ag_news" / name).read_bytes())


def test_agnews_fallback_matches_jax(tmp_path, capsys):
    """No CSVs under --data_dir: both packages print the same line and
    fall back to the same synthetic split (12000 / 2000 rows)."""
    kw = dict(model="transformer", dataset="agnews", data_dir=str(tmp_path),
              seq_len=64)
    for train, n in ((True, 12000), (False, 2000)):
        got = cli.load_dataset(TrainConfig(**kw), train)
        port_out = capsys.readouterr().out
        want = jcli.load_dataset(JConfig(**kw), train)
        jax_out = capsys.readouterr().out
        assert port_out == jax_out
        assert port_out.startswith("[data] AG News unavailable (")
        assert port_out.rstrip().endswith("; using synthetic")
        assert len(got) == len(want) == n
        _assert_batches_equal(got.encode_batch(list(range(16)), 64),
                              want.encode_batch(list(range(16)), 64))


SMALL = dict(model="transformer", dataset="synthetic", num_classes=4,
             lr=5e-3, batch_size=10, epochs=1, alpha=0.99, seq_len=64,
             n_layers=2, d_model=64, d_ff=128, n_heads=4, precision="fp32",
             telemetry=False, plot=False, subset_stride=64, log_every=0,
             device="cpu", prefetch_depth=0)


def _cfg(path, **kw):
    return TrainConfig(**dict(SMALL, checkpoint_dir=str(path), **kw))


def test_plot_writes_the_two_curves(tmp_path, monkeypatch):
    """--plot: <ckpt>_accuracy.png and <ckpt>_time.png in the working
    directory after training (JAX cli.py:1293-1298)."""
    monkeypatch.chdir(tmp_path)
    out = cli.run_training(_cfg(tmp_path / "ck", plot=True), log=print)
    assert len(out["history"]["test_acc"]) == 1
    for name in ("transformer_accuracy.png", "transformer_time.png"):
        assert (tmp_path / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_plot_without_matplotlib_says_so(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    lines = []
    assert cli.plot_history({"test_acc": [0.5], "epoch_time": [1.0]},
                            "transformer", lines.append) == []
    assert lines == ["[plot] matplotlib is not installed: no PNGs written"]
    assert not list(tmp_path.iterdir())


def test_mlp_naive_matches_jax_naive_arm(monkeypatch):
    """--mlp_impl naive: plain autograd of the MLP's plain version (no
    Function), logits and every parameter gradient against the flax
    model's naive arm, fp32 1e-5."""
    small = dict(vocab=100, n_layers=2, h=4, d_model=64, d_ff=128,
                 d_hidden=96, maxlen=64)
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, 100, size=(3, 40)).astype(np.int32)
    mask = (np.arange(40)[None] < np.array([[40], [17], [5]])).astype(np.int32)
    g = rng.standard_normal((3, 4)).astype(np.float32)
    fmodel = FlaxTransformer(n_class=4, attention_impl="dense",
                             mlp_impl="naive", **small)
    params = fmodel.init(jax.random.PRNGKey(0), jnp.asarray(tokens),
                         mask=jnp.asarray(mask), train=False)["params"]

    def f(p):
        out = fmodel.apply({"params": p}, jnp.asarray(tokens),
                           mask=jnp.asarray(mask), train=False)
        return jnp.sum(out * g), out

    (_, want), jgrads = jax.value_and_grad(f, has_aux=True)(params)
    want_grads = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))

    def no_function(*a):
        raise AssertionError("the naive arm ran the kernel's Function")

    monkeypatch.setattr(tmod, "fused_mlp", no_function)
    model = tmod.Transformer(n_class=4, attention_impl="dense",
                             mlp_impl="naive", **small)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    got = model(torch.from_numpy(tokens).long(), mask=torch.from_numpy(mask))
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    for name, p in model.named_parameters():
        w = torch.as_tensor(np.asarray(want_grads[name]))
        scale = max(w.abs().max().item(), 1e-30)
        assert (p.grad - w).abs().max().item() <= 1e-5 * scale, name


def test_mlp_impl_is_checked():
    with pytest.raises(ValueError, match="--mlp_impl"):
        cli.build_model(_cfg("/nonexistent", mlp_impl="bogus"),
                        vocab_size=100, device="cpu")


class _Killed(Exception):
    pass


def _state_tensors(state):
    flat = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    for part in ("v", "z"):
        for k, v in state.opt_state[part].items():
            flat[f"opt/{part}/{k}"] = v
    return flat


def _step_dirs(path):
    return [n for _, n in ckpt.series_members(str(path), "transformer_step")]


def test_checkpoint_keep_and_resume_from_the_newest(tmp_path, monkeypatch):
    """--checkpoint_every 1 --checkpoint_keep 2 over 6 steps leaves
    exactly the step-5 and step-6 checkpoints; a run killed before step 5
    keeps steps 3 and 4 and resumes from step 4, bitwise equal to the
    unbroken run."""
    from faster_distributed_training_tpu_torch.train import steps as tsteps

    kw = dict(checkpoint_every=1, checkpoint_keep=2)
    straight = cli.run_training(_cfg(tmp_path / "a", **kw), log=print)
    assert straight["state"].step == 6
    assert _step_dirs(tmp_path / "a") == ["transformer_step_000000005",
                                          "transformer_step_000000006"]
    real = tsteps.make_train_step

    def killed_after_4(cfg):
        step = real(cfg)

        def run(state, batch, draws=None):
            if state.step == 4:
                raise _Killed()
            return step(state, batch, draws)
        return run

    monkeypatch.setattr(tsteps, "make_train_step", killed_after_4)
    with pytest.raises(_Killed):
        cli.run_training(_cfg(tmp_path / "b", **kw), log=print)
    monkeypatch.setattr(tsteps, "make_train_step", real)
    assert _step_dirs(tmp_path / "b") == ["transformer_step_000000003",
                                          "transformer_step_000000004"]
    assert ckpt.read_meta(str(tmp_path / "b"), "transformer_step")["step"] == 4
    logs = []
    resumed = cli.run_training(_cfg(tmp_path / "b", resume=True, **kw),
                               log=logs.append)
    assert any("restored step-cadence checkpoint: step 4" in line
               for line in logs)
    assert resumed["state"].step == 6
    a, b = _state_tensors(straight["state"]), _state_tensors(resumed["state"])
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_checkpoint_every_secs_saves_on_its_cadence(tmp_path, monkeypatch):
    """--checkpoint_every_secs 2.5 under a clock that advances one second
    a step: saves after steps 3 and 6, none on the step cadence."""
    from faster_distributed_training_tpu_torch.train import steps as tsteps

    now = [100.0]
    monkeypatch.setattr(tloop, "cadence_clock", lambda: now[0])
    real = tsteps.make_train_step

    def ticking(cfg):
        step = real(cfg)

        def run(state, batch, draws=None):
            now[0] += 1.0
            return step(state, batch, draws)
        return run

    monkeypatch.setattr(tsteps, "make_train_step", ticking)
    out = cli.run_training(_cfg(tmp_path, checkpoint_every_secs=2.5),
                           log=print)
    assert out["state"].step == 6
    assert _step_dirs(tmp_path) == ["transformer_step_000000003",
                                    "transformer_step_000000006"]


@pytest.mark.parametrize("flags,name", [
    (["--optimizer", "adamw"], "adamw"),
    (["--warm_spares", "1"], "--warm_spares"),
])
def test_flags_without_a_port_raise(tmp_path, flags, name):
    argv = ["--dataset", "synthetic", "--device", "cpu", "--no_plot",
            "--checkpoint_dir", str(tmp_path)]
    with pytest.raises(NotImplementedError, match=name):
        cli.main(argv + flags, defaults=cli.TRANSFORMER_DEFAULTS)


@pytest.mark.parametrize("rows", [3, 100])
def test_lookup_backward_matches_embedding(rows):
    """The embedding lookups' backward (sorted indices, an fp64 running
    sum: deterministic on the card) equals F.embedding's gradient up to
    summation order, repeated and absent rows included."""
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.standard_normal((rows, 16)).astype(
        np.float32))
    idx = torch.from_numpy(rng.integers(0, max(rows - 7, 2), size=(4, 300)))
    g = torch.from_numpy(rng.standard_normal((4, 300, 16)).astype(np.float32))
    a = table.clone().requires_grad_(True)
    b = table.clone().requires_grad_(True)
    out_a = tmod._Lookup.apply(a, idx)
    out_b = torch.nn.functional.embedding(idx, b)
    assert torch.equal(out_a, out_b)
    (out_a * g).sum().backward()
    (out_b * g).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5)
    want = torch.zeros(rows, 16, dtype=torch.float64).index_add_(
        0, idx.reshape(-1), g.reshape(-1, 16).double())
    torch.testing.assert_close(a.grad.double(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("env,name", [
    ({"FDT_SLICE_COUNT": "2"}, "FDT_SLICE_COUNT"),
    ({"FDT_SLICE_SPARE": "0"}, "FDT_SLICE_SPARE"),
    ({"FDT_FAULT_SLICE": "1", "FDT_FAULT_DIE_AT_STEP": "3"},
     "FDT_FAULT_SLICE"),
])
def test_unported_resilience_seams_raise(tmp_path, monkeypatch, env, name):
    """Slices, warm spares and the slice-scoped fault are not ported: the
    resilience bundle ``run_training`` builds raises NotImplementedError
    naming the seam; ``FDT_SLICE_COUNT=1`` (one slice) does not."""
    from faster_distributed_training_tpu_torch.resilience import (
        build_resilience)

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = _cfg(tmp_path, checkpoint_every=2)
    with pytest.raises(NotImplementedError, match=name):
        build_resilience(cfg, log=print)
    if name == "FDT_SLICE_COUNT":
        monkeypatch.setenv("FDT_SLICE_COUNT", "1")
        res = build_resilience(cfg, log=print)
        assert res.manager is not None
        res.close()
