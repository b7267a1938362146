"""The port's native host library (``faster_distributed_training_tpu_torch/
runtime/``) against the JAX package's (``runtime/native_lib.py``) and
against the port's own Python paths, byte for byte.

  * the library builds with g++ into the port's ``_build/`` (not the JAX
    package's ``runtime/_build/``);
  * ``clean_text`` (the cases of JAX ``tests/test_runtime.py``: HTML
    entities from the whole HTML5 table, tags, URLs and the near misses,
    unicode, empty text, a long text), ``stopwords``, ``crc32``,
    ``encode_batch`` (with truncation), ``wp_load`` / ``wp_encode_batch``
    (the overlong word and the non-ASCII refusal of JAX
    ``tests/test_wordpiece.py``) and ``gather_u8``: equal to JAX
    ``native_lib``'s and to ``data.text.clean_text_py``,
    ``HashTokenizer.encode``, ``WordPieceTokenizer.encode``, ``zlib`` and
    numpy's fancy index;
  * the call sites: ``AGNewsDataset.encode_batch`` (hash and WordPiece)
    and ``BatchLoader``'s image gather give the same batches with the
    library and without it (``native_lib.load`` patched to None), and
    equal JAX ``AGNewsDataset.encode_batch`` on the same CSV.
"""

import csv
import zlib

import numpy as np
import pytest
import torch

import faster_distributed_training_tpu.data.agnews as j_agnews
from faster_distributed_training_tpu.data.wordpiece import (
    WordPieceTokenizer as JWordPiece)
from faster_distributed_training_tpu.runtime import native_lib as j_native
from faster_distributed_training_tpu_torch.data import agnews, text
from faster_distributed_training_tpu_torch.data.loader import BatchLoader
from faster_distributed_training_tpu_torch.data.wordpiece import (
    WordPieceTokenizer, build_wordpiece_vocab)
from faster_distributed_training_tpu_torch.runtime import native_lib

SAMPLES = [
    "World's largest oil company &amp; partners <b>announce</b> merger!",
    "Visit https://example.com/x?a=1 or www.example.org for more info",
    "  <div class='x'>Reuters &mdash; Stocks fell 3.5% on Monday...</div>",
    "AT&amp;T to buy T-Mobile&#39;s assets; shares don't move",
    "plain lowercase text with stopwords the a an of to in",
    "&lt;not a tag&gt; but &unknown; entity stays",
    "Tabs\tand\nnewlines  and   MIXED Case WORDS",
    "", "   ", "a", "'''", "100% numbers 42 and ids a1b2",
    "caf&eacute; prices rise", "3&times;4 grid", "&copy;2024 &hearts; news",
    "http:// broken", "see www. for details", "end with www.",
    "HTTP://CAPS.example not a match", "wwww.notaurl.com ok",
    "Café déjà vu: naïve façade — “quotes” and 数据 CJK",
    "x" * 150 + " overlong word handling",
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
    """The JAX ladder's HuggingFace step is not the port's."""
    monkeypatch.setattr(j_agnews, "_load_hf_tokenizer", lambda: None)


def test_library_builds_into_the_port_build_dir():
    assert native_lib.available(), native_lib.failure()
    path = native_lib.lib_path()
    assert path.exists()
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "faster_distributed_training_tpu_torch"
    logs = []
    assert native_lib.report(logs.append)
    assert len(logs) <= 1                     # once a process


def test_clean_text_equals_jax_and_the_python_path():
    import html

    assert j_native.available()
    for s in SAMPLES + [" ".join(SAMPLES) * 50]:
        got = native_lib.clean_text(html.unescape(s))
        assert got == j_native.clean_text(html.unescape(s)), repr(s)
        assert got == text.clean_text_py(s) == text.clean_text(s), repr(s)
        assert got == j_agnews.clean_text(s)


def test_stopwords_and_crc32():
    assert native_lib.stopwords() == j_native.stopwords() == text.STOPWORDS
    for data in (b"", b"a", b"hello world", bytes(range(256)) * 7):
        assert native_lib.crc32(data) == zlib.crc32(data) \
            == j_native.crc32(data)


@pytest.mark.parametrize("max_len", [8, 16, 512])
def test_hash_encode_batch_equals_jax_and_the_tokenizer(max_len):
    tk = text.HashTokenizer()
    texts = [text.clean_text_py(s) for s in SAMPLES]
    texts.append(" ".join(f"word{i}" for i in range(100)))
    args = (max_len, tk.vocab_size, tk.pad_id, tk.cls_id, tk.sep_id,
            tk._reserved)
    tokens, lens = native_lib.encode_batch(texts, *args)
    jt, jl = j_native.encode_batch(texts, *args)
    np.testing.assert_array_equal(tokens, jt)
    np.testing.assert_array_equal(lens, jl)
    for i, t in enumerate(texts):
        ref = tk.encode(t, max_len)
        assert lens[i] == len(ref)
        np.testing.assert_array_equal(tokens[i, :len(ref)], ref)
        assert (tokens[i, len(ref):] == tk.pad_id).all()


def test_wordpiece_encode_batch_equals_jax_and_the_tokenizer():
    corpus = [text.clean_text_py(s) for s in SAMPLES if s.strip()]
    corpus = [c for c in corpus if c.isascii()]
    corpus += ["oil economy cloud stocks' outlook 2004 don't",
               "x" * 150 + " overlong word"]
    vocab = build_wordpiece_vocab(corpus[:-3], size=300)
    tk = WordPieceTokenizer(vocab)
    jtk = JWordPiece(vocab)
    handle, jhandle = tk.native_handle(), jtk.native_handle()
    assert handle is not None and tk.native_handle() == handle
    for max_len in (6, 64):
        args = (max_len, tk.cls_id, tk.sep_id, tk.unk_id, tk.pad_token_id)
        tokens, lens = native_lib.wp_encode_batch(handle, corpus, *args)
        jt, jl = j_native.wp_encode_batch(jhandle, corpus, *args)
        np.testing.assert_array_equal(tokens, jt)
        np.testing.assert_array_equal(lens, jl)
        for i, t in enumerate(corpus):
            ref = tk.encode(t, truncation=True, max_length=max_len)
            assert lens[i] == len(ref)
            np.testing.assert_array_equal(tokens[i, :len(ref)], ref)
            assert (tokens[i, len(ref):] == tk.pad_token_id).all()
    # outside the cleaned alphabet: the Python path's, in both packages
    for bad in (["café"], ["UPPER"], ["a,b"]):
        assert native_lib.wp_encode_batch(handle, bad, 16, *args[1:]) is None
        assert j_native.wp_encode_batch(jhandle, bad, 16, *args[1:]) is None


def test_gather_u8_equals_jax_and_numpy():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, size=(50, 8, 8, 3)).astype(np.uint8)
    idx = np.concatenate([rng.permutation(50)[:16], [3, 3, 49, 0]])
    got = native_lib.gather_u8(src, idx)
    np.testing.assert_array_equal(got, src[idx])
    np.testing.assert_array_equal(got, j_native.gather_u8(src, idx))
    assert native_lib.gather_u8(src.astype(np.int32), idx) is None
    assert native_lib.gather_u8(src[:, ::2], idx) is None   # not contiguous
    with pytest.raises(IndexError):
        native_lib.gather_u8(src, np.array([50]))


def _csv(tmp_path):
    d = tmp_path / "ag_news"
    d.mkdir()
    with open(d / "train.csv", "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        for i, s in enumerate(t for t in SAMPLES if t.strip()):
            w.writerow([1 + i % 4, f"Title {i}", s])
    return str(tmp_path)


@pytest.mark.parametrize("tokenizer", ["hash", "wordpiece"])
def test_agnews_encode_batch_native_equals_python_and_jax(
        tokenizer, tmp_path, monkeypatch):
    root = _csv(tmp_path)
    kw = dict(train=True, buckets=(8, 16, 32))
    if tokenizer == "hash":
        mine = agnews.AGNewsDataset(root, tokenizer=text.HashTokenizer(),
                                    **kw)
        theirs = j_agnews.AGNewsDataset(root,
                                        tokenizer=j_agnews.HashTokenizer(),
                                        **kw)
    else:
        mine = agnews.AGNewsDataset(root, **kw)
        theirs = j_agnews.AGNewsDataset(root, **kw)
        assert isinstance(mine.tokenizer, WordPieceTokenizer)
    assert mine.samples == theirs.samples
    idx = list(range(len(mine)))
    for max_len in (16, 32):
        native = mine.encode_batch(idx, max_len)
        jax_out = theirs.encode_batch(idx, max_len)
        with monkeypatch.context() as m:
            m.setattr(native_lib, "load", lambda: None)
            py = mine.encode_batch(idx, max_len)
        assert sorted(native) == sorted(py) == sorted(jax_out)
        for k in native:
            assert native[k].dtype == py[k].dtype == jax_out[k].dtype, k
            assert native[k].tobytes() == py[k].tobytes(), k
            np.testing.assert_array_equal(native[k], jax_out[k], err_msg=k)


def test_image_batches_native_equal_python(monkeypatch):
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (40, 4, 4, 3)).astype(np.uint8)
    y = rng.integers(0, 10, 40).astype(np.int32)
    assert native_lib.available()
    got = list(BatchLoader((x, y), 8, epoch=2, seed=3))
    monkeypatch.setattr(native_lib, "load", lambda: None)
    py = list(BatchLoader((x, y), 8, epoch=2, seed=3))
    assert len(got) == len(py) == 5
    for a, b in zip(got, py):
        assert a["image"].tobytes() == b["image"].tobytes()
        np.testing.assert_array_equal(a["label"], b["label"])
