"""The port's LM corpus pipeline against the JAX package, bit for bit.

  * The cleaner (``data/agnews.py::clean_text_py`` and ``clean_text``),
    the hash tokenizer, ``data/wordpiece.py`` (``basic_tokenize``, the
    corpus vocab of ``build_wordpiece_vocab``, token ids) and
    ``data/stream/format.py::pack_lm_rows``: equal.
  * A corpus written by the port and by JAX's ``write_lm_corpus`` (and by
    the two shard entry points) from the same documents and seed:
    byte-identical shard ``.npy`` files, equal manifests, checksums
    included, and the same cached vocab file.
  * Each package's reader reads the other's directory; ``encode_batch``
    and the batch order of the host loader (shuffled train, padded eval)
    are equal; a corrupted shard is quarantined and remapped alike.
  * The image flavor: ``write_array_dataset`` and ``shard.py --kind image
    --source synthetic`` write byte-identical shards and manifests to the
    JAX writer's and ``scripts/shard_dataset.py``'s; ``row_bytes`` and the
    lazy multi-shard view (``_LazyShardRows``) equal JAX's; the batches the
    stream window serves a tiny ResNet-18 with NGD and meta mixup (16 x 16
    images, ``--ngd_rank 1``) train two steps held to JAX
    ``make_train_step`` on the same batches and mixup draws (loss 3e-5
    rel, parameters, statistics and lambda 1e-4, the ResNet tolerances),
    and ``--data_path stream`` trains the ResNet (3 steps, an epoch tail
    shorter than K) bitwise as ``--data_path resident`` at the same K.
  * AG News: a small CSV in the test's data_dir (nothing downloaded) is
    sharded by ``shard.py --source agnews`` and by the JAX script into
    byte-identical corpora through the WordPiece vocab both ladders train
    offline.

The JAX ladder's HuggingFace step is switched off here (the port does not
have it); every data_dir is a temporary directory of the test's own.
"""

import csv
import json
import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faster_distributed_training_tpu.data.agnews as j_agnews
from faster_distributed_training_tpu.data import wordpiece as j_wordpiece
from faster_distributed_training_tpu.data.loader import (
    BatchLoader as JBatchLoader)
from faster_distributed_training_tpu.data.stream import format as j_format
from faster_distributed_training_tpu.data.stream import (
    reader as j_reader)
from faster_distributed_training_tpu_torch.data import text, wordpiece
from faster_distributed_training_tpu_torch.data.loader import BatchLoader
from faster_distributed_training_tpu_torch.data.stream import (
    format as p_format)
from faster_distributed_training_tpu_torch.data.stream import (
    reader as p_reader)
from faster_distributed_training_tpu_torch.data.stream import shard

TEXTS = [
    "Wall St. Bears Claw Back Into the Black (Reuters) &lt;b&gt;Short-"
    "sellers&lt;/b&gt;, Wall Street's dwindling band of ultra-cynics!",
    "Visit http://example.com/a?b=1 or www.test.org &amp; see <i>it</i>",
    "Café déjà vu: naïve façade — “quotes” and 数据 CJK, tabs\tand\nlines",
    "The and of a an is was were it its  12 3.14 don't won't O'Neil",
    "",
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: under the suite's parallel workers torch's
    thread-a-core default oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_hf(monkeypatch):
    """The port's ladder starts at a vocab.txt on disk."""
    monkeypatch.setattr(j_agnews, "_load_hf_tokenizer", lambda: None)


def test_cleaner_matches_jax():
    assert text.STOPWORDS == j_agnews.STOPWORDS
    assert text.cleaner_fingerprint() == j_agnews.cleaner_fingerprint()
    for t in TEXTS + p_format.synthetic_corpus(8, seed=3):
        assert text.clean_text_py(t) == j_agnews.clean_text_py(t)
        assert text.clean_text_py(t) == j_agnews.clean_text(t)


def test_hash_tokenizer_matches_jax():
    mine, theirs = text.HashTokenizer(), j_agnews.HashTokenizer()
    for t in TEXTS:
        clean = text.clean_text_py(t)
        for max_len in (4, 512):
            assert mine.encode(clean, max_len) == theirs.encode(clean,
                                                                max_len)


def test_wordpiece_matches_jax():
    docs = p_format.synthetic_corpus(48, seed=1) + TEXTS
    for t in docs:
        assert wordpiece.basic_tokenize(t) == j_wordpiece.basic_tokenize(t)
    vocab = wordpiece.build_wordpiece_vocab(docs, size=400)
    assert vocab == j_wordpiece.build_wordpiece_vocab(docs, size=400)
    mine = wordpiece.WordPieceTokenizer(vocab)
    theirs = j_wordpiece.WordPieceTokenizer(vocab)
    assert mine.vocab_size == theirs.vocab_size
    assert mine.vocab_lines() == theirs.vocab_lines()
    for t in docs:
        for max_length in (6, 512):
            assert mine.encode(t, truncation=True, max_length=max_length) \
                == theirs.encode(t, truncation=True, max_length=max_length)
        for w in wordpiece.basic_tokenize(t):
            assert (wordpiece.wordpiece_word(w, vocab)
                    == j_wordpiece.wordpiece_word(w, vocab))


def test_pack_lm_rows_matches_jax():
    docs = [text.clean_text_py(t) for t in p_format.synthetic_corpus(40)]
    tk = wordpiece.WordPieceTokenizer(wordpiece.build_wordpiece_vocab(docs))
    jtk = j_wordpiece.WordPieceTokenizer(tk.vocab)
    for seq_len, chunk_docs in ((16, 7), (64, 512)):
        mine = list(p_format.pack_lm_rows(docs, tk, seq_len, chunk_docs))
        theirs = list(j_format.pack_lm_rows(docs, jtk, seq_len, chunk_docs))
        assert len(mine) == len(theirs) > 0
        for a, b in zip(mine, theirs):
            assert a["tokens"].dtype == np.int32
            np.testing.assert_array_equal(a["tokens"], b["tokens"])


def _same_dirs(a, b):
    """Two stream roots hold equal manifests and byte-identical files."""
    for split in ("train", "test"):
        da, db = os.path.join(a, split), os.path.join(b, split)
        assert sorted(os.listdir(da)) == sorted(os.listdir(db))
        with open(os.path.join(da, "manifest.json")) as f:
            ma = json.load(f)
        with open(os.path.join(db, "manifest.json")) as f:
            mb = json.load(f)
        assert ma == mb
        for s in ma["shards"]:
            for info in s["files"].values():
                with open(os.path.join(da, info["file"]), "rb") as f:
                    xa = f.read()
                with open(os.path.join(db, info["file"]), "rb") as f:
                    assert xa == f.read(), info["file"]


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The same 96 documents written at seq 48 with 16 rows a shard by
    both writers, each with a data_dir (vocab cache) of its own."""
    root = tmp_path_factory.mktemp("corpora")
    texts = p_format.synthetic_corpus(96, seed=2)
    kw = dict(seq_len=48, val_fraction=0.25, rows_per_shard=16, seed=4)
    mine = p_format.write_lm_corpus(str(root / "port"), texts,
                                    data_dir=str(root / "pd"),
                                    log=lambda _: None, **kw)
    orig = j_agnews._load_hf_tokenizer
    j_agnews._load_hf_tokenizer = lambda: None
    try:
        theirs = j_format.write_lm_corpus(str(root / "jax"), texts,
                                          data_dir=str(root / "jd"), **kw)
    finally:
        j_agnews._load_hf_tokenizer = orig
    return root, mine, theirs


def test_written_corpus_is_byte_identical_to_jax(corpora):
    root, mine, theirs = corpora
    assert mine == theirs
    assert len(mine["train"]["shards"]) > 2       # several shards
    assert mine["train"]["tokenizer"] == "WordPieceTokenizer"
    assert all(f["crc_alg"] == p_format.CRC_ALG == j_format.CRC_ALG
               for s in mine["train"]["shards"] for f in s["files"].values())
    _same_dirs(str(root / "port"), str(root / "jax"))
    cache = f"wordpiece_vocab_{text.cleaner_fingerprint()}.txt"
    with open(root / "pd" / "ag_news" / cache) as f:
        mine_vocab = f.read()
    with open(root / "jd" / "ag_news" / cache) as f:
        assert mine_vocab == f.read()


def test_shard_entry_points_write_the_same_corpus(tmp_path, monkeypatch):
    """The port's ``data/stream/shard.py`` against the JAX package's
    ``scripts/shard_dataset.py`` with the same flags (``--source agnews``
    falls back to the synthetic corpus in both: no CSVs)."""
    flags = ["--source", "agnews", "--seq_len", "40", "--n_docs", "48",
             "--rows_per_shard", "8", "--seed", "1"]
    got = shard.main(["--out", str(tmp_path / "p"), "--data_dir",
                      str(tmp_path / "pd")] + flags, log=lambda _: None)
    script = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "shard_dataset.py")
    jmain = runpy.run_path(script)["main"]
    assert jmain(["--out", str(tmp_path / "j"), "--data_dir",
                  str(tmp_path / "jd")] + flags) == 0
    _same_dirs(str(tmp_path / "p"), str(tmp_path / "j"))
    assert got["train"]["n"] > 8
    # a second run reads the cached vocab back
    again = shard.main(["--out", str(tmp_path / "p2"), "--data_dir",
                        str(tmp_path / "pd")] + flags, log=lambda _: None)
    assert again == got


def test_ladder_prefers_a_vocab_txt_on_disk(tmp_path):
    vocab = j_wordpiece.build_wordpiece_vocab(TEXTS, size=200)
    j_wordpiece.WordPieceTokenizer(vocab).save_vocab(
        str(tmp_path / "vocab.txt"))
    mine = text._resolve_tokenizer(str(tmp_path), ["unused corpus"],
                                   log=lambda _: None)
    theirs = j_agnews._resolve_tokenizer(str(tmp_path), ["unused corpus"])
    assert mine.vocab == theirs.vocab == vocab
    # no data_dir, no corpus: the hash tokenizer, nothing written
    assert isinstance(text._resolve_tokenizer("", [], log=lambda _: None),
                      text.HashTokenizer)


def test_each_reader_reads_the_other_s_directory(corpora):
    root, _, _ = corpora
    for split in ("train", "test"):
        for d in (root / "port" / split, root / "jax" / split):
            mine = p_reader.ShardedStreamDataset(str(d))
            theirs = j_reader.ShardedStreamDataset(str(d))
            assert len(mine) == len(theirs) and mine.is_text
            assert mine.vocab_size() == theirs.vocab_size()
            assert mine.seq_len == theirs.seq_len == 48
            idx = np.random.default_rng(0).integers(0, len(mine), 23)
            a, b = mine.gather(idx), theirs.gather(idx)
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            for max_len in (48, 20):
                ea = mine.encode_batch(idx, max_len)
                eb = theirs.encode_batch(idx, max_len)
                assert sorted(ea) == sorted(eb)
                for k in ea:
                    assert ea[k].dtype == eb[k].dtype
                    np.testing.assert_array_equal(ea[k], eb[k])


def test_loader_batches_match_jax(corpora):
    """The host loader over the port's reader against the JAX loader over
    the JAX reader: shuffled train epochs and the padded eval batches."""
    root, _, _ = corpora
    for split, shuffle, pad_last in (("train", True, False),
                                     ("test", False, True)):
        mine = p_reader.open_stream_split(str(root / "port"),
                                          train=split == "train")
        theirs = j_reader.open_stream_split(str(root / "jax"),
                                            train=split == "train")
        for epoch in (0, 3):
            a = list(BatchLoader(mine, 5, epoch=epoch, seed=7,
                                 shuffle=shuffle, max_len=48,
                                 pad_last=pad_last))
            b = list(JBatchLoader(theirs, 5, epoch=epoch, seed=7,
                                  shuffle=shuffle, max_len=48,
                                  pad_last=pad_last))
            assert len(a) == len(b) > 0
            for x, y in zip(a, b):
                assert sorted(x) == sorted(y)
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=k)
            if pad_last:
                assert "valid" in a[-1]


def test_corrupt_shard_is_quarantined_like_jax(tmp_path, corpora):
    """A same-size byte flip: the size check passes, the first gather's
    checksum catches it, and both readers remap the rows alike."""
    import shutil

    root, _, _ = corpora
    d = tmp_path / "train"
    shutil.copytree(root / "port" / "train", d)
    with open(d / "manifest.json") as f:
        man = json.load(f)
    path = d / man["shards"][1]["files"]["tokens"]["file"]
    raw = bytearray(path.read_bytes())
    raw[-3] ^= 0x5A
    path.write_bytes(bytes(raw))
    mine = p_reader.ShardedStreamDataset(str(d))
    theirs = j_reader.ShardedStreamDataset(str(d))
    idx = np.arange(len(mine))
    with pytest.warns(UserWarning, match="CRC mismatch"):
        a = mine.gather(idx)
    with pytest.warns(UserWarning, match="CRC mismatch"):
        b = theirs.gather(idx)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert mine._bad_shards == {1}


# -- the image flavor -----------------------------------------------------------


def _script_main():
    script = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "shard_dataset.py")
    return runpy.run_path(script)["main"]


def test_image_writers_are_byte_identical_to_jax(tmp_path):
    from faster_distributed_training_tpu_torch.data.synthetic import (
        synthetic_cifar)

    x, y = synthetic_cifar(70, seed=3)
    meta = {"content": "image", "num_classes": 10, "split": "train"}
    mine = p_format.write_array_dataset(str(tmp_path / "p" / "train"),
                                        {"image": x, "label": y},
                                        rows_per_shard=25, meta=meta)
    theirs = j_format.write_array_dataset(str(tmp_path / "j" / "train"),
                                          {"image": x, "label": y},
                                          rows_per_shard=25, meta=meta)
    assert mine == theirs and len(mine["shards"]) == 3
    flags = ["--kind", "image", "--source", "synthetic", "--n", "96",
             "--rows_per_shard", "40", "--seed", "2"]
    got = shard.main(["--out", str(tmp_path / "sp")] + flags,
                     log=lambda _: None)
    assert _script_main()(["--out", str(tmp_path / "sj")] + flags) == 0
    _same_dirs(str(tmp_path / "sp"), str(tmp_path / "sj"))
    assert got["train"]["n"] == 96 and got["test"]["n"] == 24
    for d in (tmp_path / "sp" / "train", tmp_path / "p" / "train"):
        a = p_reader.ShardedStreamDataset(str(d))
        b = j_reader.ShardedStreamDataset(str(d))
        assert not a.is_text and a.row_bytes() == b.row_bytes() == 3076
    img, lab = p_reader.open_stream_split(str(tmp_path / "sp"), train=True)
    jimg, jlab = j_reader.open_stream_split(str(tmp_path / "sj"), train=True)
    assert isinstance(img, p_reader._LazyShardRows)
    idx = np.array([95, 0, 39, 40, 41, 80])
    np.testing.assert_array_equal(img[idx], jimg[idx])
    np.testing.assert_array_equal(lab[::7], jlab[::7])
    np.testing.assert_array_equal(np.asarray(img), np.asarray(jimg))


HW, B = 16, 8
RN = dict(model="resnet18", dataset="stream", num_classes=10, lr=0.1,
          batch_size=B, epochs=1, use_ngd=True, meta_learning=True,
          ngd_rank=1, telemetry=False, plot=False, precision="fp32")


@pytest.fixture(scope="module")
def image_shards(tmp_path_factory):
    """24 train / 8 test CIFAR-like 16 x 16 images, 10 rows a shard."""
    rng = np.random.default_rng(5)
    root = tmp_path_factory.mktemp("img16")
    for split, n in (("train", 24), ("test", 8)):
        p_format.write_array_dataset(
            str(root / split),
            {"image": rng.integers(0, 256, (n, HW, HW, 3)).astype(np.uint8),
             "label": rng.integers(0, 10, n).astype(np.int32)},
            rows_per_shard=10, meta={"content": "image", "num_classes": 10})
    return str(root)


def test_resnet_ngd_on_the_window_s_batches_matches_jax(image_shards):
    """The batches the port's stream window serves (its slot rows, equal
    to JAX's ``host_buffer``) through JAX ``make_train_step`` and the
    port's step: two NGD + meta mixup steps from one init, JAX's mixup
    permutations handed to the port.  The steps take the window's uint8
    batches normalized to float (both packages skip the in-step augment
    for float images, whose draws come from different generators)."""
    from faster_distributed_training_tpu.config import TrainConfig as JConf
    from faster_distributed_training_tpu.data.stream import (
        DiskStreamSource as JSource)
    from faster_distributed_training_tpu.optim import (
        build_optimizer as j_build_optimizer)
    from faster_distributed_training_tpu.train.amp import fresh_loss_scale
    from faster_distributed_training_tpu.train.mixup import (
        init_meta_lambda as j_init_meta_lambda)
    from faster_distributed_training_tpu.train.state import (
        TrainState as JTrainState)
    from faster_distributed_training_tpu.train.steps import (
        make_train_step as j_make_train_step)
    from faster_distributed_training_tpu import cli as jcli
    from faster_distributed_training_tpu_torch import cli
    from faster_distributed_training_tpu_torch.config import TrainConfig
    from faster_distributed_training_tpu_torch.data.stream import (
        DiskStreamSource)
    from faster_distributed_training_tpu_torch.interop import (
        flatten, resnet_from_jax, resnet_to_jax)
    from faster_distributed_training_tpu_torch.optim import (
        build_optimizer, layouts_of)
    from faster_distributed_training_tpu_torch.train.state import (
        create_train_state)
    from faster_distributed_training_tpu_torch.train.steps import (
        StepDraws, make_train_step, to_device)

    train = os.path.join(image_shards, "train")
    src = DiskStreamSource(p_reader.ShardedStreamDataset(train), B, seed=0,
                           window_batches=2)
    jsrc = JSource(j_reader.ShardedStreamDataset(train), B, seed=0,
                   window_batches=2)
    order = src.epoch_order(0)
    win = src.epoch_window(0)
    batches = []
    try:
        base, hi, slot = win.buffer_for(0)
        want = jsrc.host_buffer(jsrc.epoch_order(0), base, hi)
        for n in (0, 1):
            row = {k: t[slot * src.window + n - base].numpy()
                   for k, t in src.arrays.items()}
            for k in row:
                assert row[k].tobytes() == want[k][n - base].tobytes(), k
            batches.append(row)
    finally:
        win.close()
    np.testing.assert_array_equal(order, jsrc.epoch_order(0))

    jcfg = JConf(device="cpu", **RN)
    jtx, _ = j_build_optimizer(jcfg, steps_per_epoch=6)
    rng = jax.random.PRNGKey(0)
    jmodel = jcli.build_model(jcfg)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k, x: jmodel.init({"params": k, "dropout": jax.random.fold_in(
            k, 1), "mixup": jax.random.fold_in(k, 2)}, x, train=True))(
        rng, jnp.zeros((B, HW, HW, 3), jnp.float32)))
    lam0 = np.asarray(j_init_meta_lambda(rng, B))
    jparams = {"model": jax.tree_util.tree_map(jnp.asarray,
                                               variables["params"]),
               "mixup_lambda": jnp.asarray(lam0)}
    jstate = JTrainState(
        step=jnp.asarray(0, jnp.int32), params=jparams,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=jtx.init(jparams), loss_scale=fresh_loss_scale(),
        rng=jax.random.PRNGKey(0), apply_fn=jmodel.apply, tx=jtx)
    jstep = jax.jit(j_make_train_step(jcfg))

    cfg = TrainConfig(device="cpu", **RN)
    model = cli.build_model(cfg, device="cpu")
    model.load_state_dict(resnet_from_jax(variables["params"],
                                          variables["batch_stats"]))
    tx, _ = build_optimizer(cfg, steps_per_epoch=6,
                            layouts=layouts_of(model))
    state = create_train_state(model, tx, 0,
                               extra={"mixup_lambda": torch.tensor(lam0)})
    step = make_train_step(cfg)
    mean = np.asarray([0.4914, 0.4822, 0.4465], np.float32)
    std = np.asarray([0.2470, 0.2435, 0.2616], np.float32)
    for i, row in enumerate(batches):
        batch = {"image": ((row["image"].astype(np.float32) / 255.0 - mean)
                           / std).astype(np.float32),
                 "label": row["label"]}
        k_mix, _ = jax.random.split(jax.random.fold_in(jstate.rng, i))
        perm = np.asarray(jax.random.permutation(k_mix, B))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, to_device(batch, "cpu"),
                        StepDraws(seeds=(), lam=1.0, perm=perm))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=3e-5, atol=0, err_msg=f"step {i}")
    params, stats = resnet_to_jax(model.state_dict())
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


def test_resnet_streams_bitwise_as_resident(image_shards, tmp_path):
    from faster_distributed_training_tpu_torch import cli
    from faster_distributed_training_tpu_torch.resnet50_test import DEFAULTS

    argv = ["--device", "cpu", "--model", "resnet18", "--dataset", "stream",
            "--stream_dir", image_shards, "--bs", str(B), "--epoch", "1",
            "--ngd", "--meta_learning", "--precision",
            "fp32", "--log_every", "0", "--no_plot", "--no_telemetry",
            "--steps_per_dispatch", "2", "--stream_window", "4"]
    out = {}
    for path in ("stream", "resident"):
        res = cli.main(argv + ["--data_path", path, "--checkpoint_dir",
                               str(tmp_path / path)], defaults=DEFAULTS)
        assert int(res["state"].step) == 3, path
        out[path] = {k: v.clone() for k, v in
                     res["state"].model.state_dict().items()}
    assert type(res["trainer"].dispatch.resident).__name__ == \
        "DeviceResidentData"
    for k, v in out["stream"].items():
        assert torch.equal(v, out["resident"][k]), k


# -- AG News ------------------------------------------------------------------


def test_agnews_csv_shards_are_byte_identical_to_jax(tmp_path):
    rows = [(1 + i % 4, f"Title {i}: " + t, TEXTS[i % 4] + " " + t)
            for i, t in enumerate(p_format.synthetic_corpus(60, seed=6))]
    for d in ("pd", "jd"):
        os.makedirs(tmp_path / d / "ag_news")
        with open(tmp_path / d / "ag_news" / "train.csv", "w", newline="",
                  encoding="utf-8") as f:
            csv.writer(f).writerows(rows)
    flags = ["--source", "agnews", "--seq_len", "24", "--rows_per_shard",
             "16", "--seed", "3"]
    logs = []
    got = shard.main(["--out", str(tmp_path / "p"), "--data_dir",
                      str(tmp_path / "pd")] + flags, log=logs.append)
    assert not any("unavailable" in x for x in logs)
    assert _script_main()(["--out", str(tmp_path / "j"), "--data_dir",
                           str(tmp_path / "jd")] + flags) == 0
    _same_dirs(str(tmp_path / "p"), str(tmp_path / "j"))
    assert got["train"]["tokenizer"] == "WordPieceTokenizer"
    assert got["train"]["docs"] == 54 and len(got["train"]["shards"]) > 1
    cache = f"wordpiece_vocab_{text.cleaner_fingerprint()}.txt"
    with open(tmp_path / "pd" / "ag_news" / cache) as f:
        mine = f.read()
    with open(tmp_path / "jd" / "ag_news" / cache) as f:
        assert mine == f.read()
