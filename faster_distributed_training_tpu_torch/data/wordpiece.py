"""WordPiece tokenization (BERT-style), a copy of the JAX package's
``data/wordpiece.py``.

HuggingFace's BasicTokenizer (lowercase, accent strip, punctuation split,
CJK isolation) plus greedy longest-match WordPiece with ``##``
continuations, so that over the same ``vocab.txt`` the ids equal HF's and
the JAX package's bit for bit.  ``build_wordpiece_vocab`` trains the
deterministic corpus vocabulary (every character bare and as a ``##``
continuation, then the most frequent whole words), laid out with BERT's
special ids ([PAD]=0, [UNK]=100, [CLS]=101, [SEP]=102, [MASK]=103).  A
tokenizer registers its vocab once with the native host library
(``native_handle``), whose batch encoder ``data/agnews.py`` calls.
"""

from __future__ import annotations

import os
import threading
import unicodedata
from typing import Dict, Iterable, List, Optional

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
_SPECIAL_IDS = {PAD: 0, UNK: 100, CLS: 101, SEP: 102, MASK: 103}


# character classes of transformers.models.bert.tokenization_bert

def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def basic_tokenize(text: str, do_lower_case: bool = True) -> List[str]:
    """HF BasicTokenizer(do_lower_case, strip_accents=None): drop control
    chars, isolate CJK, NFC, lowercase with NFD accent strip, split
    punctuation into tokens of its own."""
    cleaned = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        cleaned.append(" " if _is_whitespace(ch) else ch)
    out = []
    for ch in "".join(cleaned):
        if _is_cjk(ord(ch)):
            out.append(" ")
            out.append(ch)
            out.append(" ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    tokens = []
    for tok in text.split():
        if do_lower_case:
            tok = tok.lower()
            tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                          if unicodedata.category(c) != "Mn")
        word: List[str] = []
        for ch in tok:
            if _is_punctuation(ch):
                if word:
                    tokens.append("".join(word))
                    word = []
                tokens.append(ch)
            else:
                word.append(ch)
        if word:
            tokens.append("".join(word))
    return tokens


def wordpiece_word(word: str, vocab: Dict[str, int],
                   max_chars: int = 100) -> List[str]:
    """Greedy longest-match-first segmentation of one basic token
    (HF WordpieceTokenizer.tokenize, single-word case)."""
    if len(word) > max_chars:
        return [UNK]
    pieces: List[str] = []
    start = 0
    while start < len(word):
        end = len(word)
        cur = None
        while start < end:
            piece = word[start:end]
            if start > 0:
                piece = "##" + piece
            if piece in vocab:
                cur = piece
                break
            end -= 1
        if cur is None:
            return [UNK]
        pieces.append(cur)
        start = end
    return pieces


class WordPieceTokenizer:
    """bert-base-uncased-compatible tokenizer over an explicit vocab, with
    the HF interface subset the corpus writer uses: ``encode(text,
    truncation=..., max_length=...)``, ``vocab_size``, ``pad_token_id``."""

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True):
        self.vocab = vocab
        self.do_lower_case = do_lower_case
        self.pad_token_id = vocab[PAD]
        self.unk_id = vocab[UNK]
        self.cls_id = vocab[CLS]
        self.sep_id = vocab[SEP]
        self._native_handle = -1          # -1: not registered yet
        self._native_lock = threading.Lock()

    def native_handle(self) -> Optional[int]:
        """This vocab's handle in the native library's registry
        (``fdt_wp_load``), registered once; None without the library.
        Locked: the loader's worker threads reach the first batches
        together."""
        with self._native_lock:
            if self._native_handle == -1:
                from faster_distributed_training_tpu_torch.runtime import (
                    native_lib)
                self._native_handle = native_lib.wp_load(self.vocab_lines())
            return self._native_handle

    def vocab_lines(self) -> List[str]:
        by_id = {i: t for t, i in self.vocab.items()}
        return [by_id.get(i, f"[unused{i}]") for i in range(self.vocab_size)]

    @property
    def vocab_size(self) -> int:
        # the model's embedding size: one past the largest id
        return max(self.vocab.values()) + 1

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kw)

    def save_vocab(self, path: str) -> None:
        """HF vocab.txt format (line index = id); id gaps become
        [unusedN] fillers so the file round-trips exactly."""
        with open(path, "w", encoding="utf-8") as f:
            for line in self.vocab_lines():
                f.write(line + "\n")

    def tokenize(self, text: str) -> List[str]:
        pieces: List[str] = []
        for word in basic_tokenize(text, self.do_lower_case):
            pieces.extend(wordpiece_word(word, self.vocab))
        return pieces

    def encode(self, text: str, truncation: bool = True,
               max_length: int = 512) -> List[int]:
        ids = [self.vocab.get(p, self.unk_id) for p in self.tokenize(text)]
        if truncation and len(ids) > max_length - 2:
            ids = ids[:max_length - 2]
        return [self.cls_id] + ids + [self.sep_id]


def build_wordpiece_vocab(texts: Iterable[str], size: int = 30522,
                          do_lower_case: bool = True) -> Dict[str, int]:
    """Deterministic corpus-trained WordPiece vocabulary: every character
    seen enters bare and as a ``##`` continuation, then whole words by
    count (descending, ties by token) fill the budget, so greedy
    longest-match segments every corpus word without [UNK]."""
    counts: Dict[str, int] = {}
    chars: set = set()
    for text in texts:
        for word in basic_tokenize(text, do_lower_case):
            counts[word] = counts.get(word, 0) + 1
            chars.update(word)
    vocab: Dict[str, int] = dict(_SPECIAL_IDS)
    next_id = 0

    def alloc() -> int:
        nonlocal next_id
        while next_id in _SPECIAL_IDS.values():
            next_id += 1
        i = next_id
        next_id += 1
        return i

    for ch in sorted(chars):
        vocab[ch] = alloc()
        vocab["##" + ch] = alloc()
    budget = size - len(vocab)
    ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    for word, _ in ranked:
        if budget <= 0:
            break
        if word not in vocab:
            vocab[word] = alloc()
            budget -= 1
    return vocab


def find_bert_vocab(data_dir: str) -> Optional[str]:
    """A real bert-base-uncased vocab.txt without network access:
    ``data_dir`` copies first, then the HF hub cache layout."""
    candidates = [
        os.path.join(data_dir, "bert-base-uncased-vocab.txt"),
        os.path.join(data_dir, "vocab.txt"),
    ]
    hf_home = os.environ.get("HF_HOME",
                             os.path.expanduser("~/.cache/huggingface"))
    hub = os.path.join(hf_home, "hub", "models--bert-base-uncased",
                       "snapshots")
    if os.path.isdir(hub):
        for snap in sorted(os.listdir(hub)):
            candidates.append(os.path.join(hub, snap, "vocab.txt"))
    for path in candidates:
        if os.path.isfile(path):
            return path
    return None
