"""Text cleaning and tokenizer resolution for the AG News reader and the
LM corpus writer.

Copies of what ``faster_distributed_training_tpu/data/agnews.py`` gives
the stream corpus writer: the reference's cleaner (HTML tags and URLs
stripped, lowercase word tokens, gensim's stopword list), the crc32
``HashTokenizer`` and the tokenizer ladder of ``_resolve_tokenizer``.
The JAX ``clean_text`` prefers a native C++ cleaner held byte-equal to
``clean_text_py`` by the JAX package's tests; the port runs the Python
one.  The ladder's first step, HuggingFace's ``bert-base-uncased`` when
cached locally, is not ported (it needs ``transformers``, which the port
does not depend on): a real ``vocab.txt`` on disk comes first here, then
the corpus-trained WordPiece vocab cached beside the data, then the hash
tokenizer.  ``data/agnews.py`` reads the AG News CSVs with them.
"""

from __future__ import annotations

import html
import os
import re
import zlib
from typing import Dict, List, Sequence

_TAG_RE = re.compile(r"<[^>]+>")
_URL_RE = re.compile(r"https?://\S+|www\.\S+")
_TOKEN_RE = re.compile(r"[a-z0-9']+")

# gensim's 337-word STOPWORDS list (the JAX package's copy, verbatim)
STOPWORDS = frozenset("""
a about above across after afterwards again against all almost alone
along already also although always am among amongst amoungst amount an
and another any anyhow anyone anything anyway anywhere are around as at
back be became because become becomes becoming been before beforehand
behind being below beside besides between beyond bill both bottom but
by call can cannot cant co computer con could couldnt cry de describe
detail did didn do does doesn doing don done down due during each eg
eight either eleven else elsewhere empty enough etc even ever every
everyone everything everywhere except few fifteen fifty fill find fire
first five for former formerly forty found four from front full further
get give go had has hasnt have he hence her here hereafter hereby
herein hereupon hers herself him himself his how however hundred i ie
if in inc indeed interest into is it its itself just keep kg km last
latter latterly least less ltd made make many may me meanwhile might
mill mine more moreover most mostly move much must my myself name
namely neither never nevertheless next nine no nobody none noone nor
not nothing now nowhere of off often on once one only onto or other
others otherwise our ours ourselves out over own part per perhaps
please put quite rather re really regarding same say see seem seemed
seeming seems serious several she should show side since sincere six
sixty so some somehow someone something sometime sometimes somewhere
still such system take ten than that the their them themselves then
thence there thereafter thereby therefore therein thereupon these they
thick thin third this those though three through throughout thru thus
to together too top toward towards twelve twenty two un under unless
until up upon us used using various very via was we well were what
whatever when whence whenever where whereafter whereas whereby wherein
whereupon wherever whether which while whither who whoever whole whom
whose why will with within without would yet you your yours yourself
yourselves
""".split())


def cleaner_fingerprint() -> str:
    """Hash of the stopword list: the cached corpus vocab's file name
    carries it, so a vocab built under another cleaner is not reused."""
    return format(zlib.crc32(" ".join(sorted(STOPWORDS)).encode()), "08x")


def clean_text_py(text: str) -> str:
    """The reference's cleaner: unescape HTML entities, strip tags and
    URLs, keep lowercase word tokens that are not stopwords."""
    text = html.unescape(text)
    text = _TAG_RE.sub(" ", text)
    text = _URL_RE.sub(" ", text)
    words = _TOKEN_RE.findall(text.lower())
    return " ".join(w for w in words if w not in STOPWORDS)


class HashTokenizer:
    """Last-resort tokenizer: crc32 hash buckets above the BERT special
    ids (pad 0, unk 100, cls 101, sep 102)."""

    def __init__(self, vocab_size: int = 30522):
        self.vocab_size = vocab_size
        self.pad_id, self.cls_id, self.sep_id, self.unk_id = 0, 101, 102, 100
        self._reserved = 999  # ids below this are never produced by hashing

    def encode(self, text: str, max_len: int) -> List[int]:
        ids = [self.cls_id]
        for w in text.split()[:max_len - 2]:
            h = zlib.crc32(w.encode()) % (self.vocab_size - self._reserved)
            ids.append(h + self._reserved)
        ids.append(self.sep_id)
        return ids


# corpus-trained tokenizers by data_dir: the train split builds the vocab
# and the test split of the same run must reuse it even when the disk
# cache cannot be written
_corpus_tokenizers: Dict[str, object] = {}


def _resolve_tokenizer(data_dir: str, corpus_texts: Sequence[str],
                       log=print):
    """The tokenizer a corpus is written with: a real bert ``vocab.txt``
    under ``data_dir`` (or the HF hub cache), else the WordPiece vocab
    trained on this corpus and cached at ``data_dir/ag_news/`` (read back
    when present), else the hash tokenizer.  With ``data_dir`` empty
    nothing is read from or written to disk."""
    from faster_distributed_training_tpu_torch.data.wordpiece import (
        WordPieceTokenizer, build_wordpiece_vocab, find_bert_vocab)

    log("[data] the HuggingFace bert-base-uncased step of the tokenizer "
        "ladder is not ported; trying a vocab.txt on disk, then a "
        "corpus-trained WordPiece vocab")
    cache = ""
    if data_dir:
        vocab_path = find_bert_vocab(data_dir)
        if vocab_path:
            return WordPieceTokenizer.from_vocab_file(vocab_path)
        cache = os.path.join(data_dir, "ag_news",
                             f"wordpiece_vocab_{cleaner_fingerprint()}.txt")
        if os.path.isfile(cache):
            return WordPieceTokenizer.from_vocab_file(cache)
        memo = _corpus_tokenizers.get(os.path.abspath(data_dir))
        if memo is not None:
            return memo
    if not corpus_texts:
        return HashTokenizer()
    tk = WordPieceTokenizer(build_wordpiece_vocab(corpus_texts))
    if cache:
        _corpus_tokenizers[os.path.abspath(data_dir)] = tk
        try:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            tk.save_vocab(cache)
        except OSError:
            log(f"[data] warning: could not write {cache}; a later run "
                f"rebuilds the vocab from its own corpus")
    return tk
