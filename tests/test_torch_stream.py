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

The JAX ladder's HuggingFace step is switched off here (the port does not
have it); every data_dir is a temporary directory of the test's own.
"""

import json
import os
import runpy

import numpy as np
import pytest

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
