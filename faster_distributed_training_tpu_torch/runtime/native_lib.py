"""Build and bind the host data path's native core
(``runtime/native/fdt_native.cc``): the port's copy of the JAX package's
``runtime/native_lib.py``.

The library compiles at first use with ``g++ -O3 -std=c++17 -shared
-fPIC`` into ``faster_distributed_training_tpu_torch/_build/``
(git-ignored), named by a hash of the source and the flags, and is bound
through ctypes.  Every entry point has a Python path in ``data/`` that
returns the same bytes; where g++ or the build is missing the callers
take it, and ``report`` says once a process which path runs (the card
machine's smoke fails when the library did not load).  The library is
acquired through ``ops/_build.py::acquire``'s tiers (the local
``_build/``, the executable cache, g++) and is the program table's
``lib:fdt_native`` row.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "native" / "fdt_native.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# why the library is not loaded (None: not tried yet, or loaded)
_failure: Optional[str] = None
_reported = False


def lib_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()
                            ).hexdigest()
    return BUILD_DIR / f"libfdt_native-{digest[:16]}.so"


def _build(out: Path) -> None:
    """g++ into a temporary name, then an atomic rename; raises with the
    compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ exited {proc.returncode}: "
                           f"{proc.stderr.strip()[-2000:]}")
    os.replace(tmp, out)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    p_i32, p_i64 = ctypes.POINTER(i32), ctypes.POINTER(i64)
    p_str = ctypes.POINTER(ctypes.c_char_p)
    for name, res, args in (
            ("fdt_crc32", ctypes.c_uint32, [ctypes.c_char_p, i64]),
            ("fdt_clean_text", i64, [ctypes.c_char_p, ctypes.c_char_p, i64]),
            ("fdt_encode_batch", i32, [p_str, i32, i32, i32, i32, i32, i32,
                                       i32, p_i32, p_i32]),
            ("fdt_gather_u8", i32, [ctypes.c_char_p, p_i64, i32, i64,
                                    ctypes.c_char_p]),
            ("fdt_wp_load", i32, [ctypes.c_char_p, i64]),
            ("fdt_stopwords", i64, [ctypes.c_char_p, i64]),
            ("fdt_wp_encode_batch", i32, [i32, p_str, i32, i32, i32, i32,
                                          i32, i32, p_i32, p_i32])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The bound library, built first when absent; None when it cannot be
    built or loaded (``failure()`` says why)."""
    global _lib, _failure
    if _lib is not None or _failure is not None:
        return _lib
    with _lock:
        if _lib is not None or _failure is not None:
            return _lib
        try:
            from faster_distributed_training_tpu_torch.ops._build import (
                acquire, digest_of)
            from faster_distributed_training_tpu_torch.telemetry import (
                programs)

            t0 = time.monotonic()
            out = lib_path()
            source, armed = acquire("fdt_native", out,
                                    lambda: _build(out), "g++")
            _lib = _bind(ctypes.CDLL(str(out)))
            programs.library_loaded("fdt_native", digest_of(out), str(out),
                                    (time.monotonic() - t0) * 1e3, source,
                                    armed)
        except Exception as e:              # no g++, a refused build, ...
            _failure = f"{type(e).__name__}: {e}"
    return _lib


def available() -> bool:
    return load() is not None


def failure() -> Optional[str]:
    """Why the library did not load (None when it did)."""
    load()
    return _failure


def report(log: Callable[[str], None] = print) -> bool:
    """Log, once a process, which path the host data pipeline takes;
    returns whether the library loaded."""
    global _reported
    ok = available()
    if not _reported:
        _reported = True
        log(f"[native] host data library {lib_path().name} loaded from "
            f"{BUILD_DIR}" if ok else
            f"[native] host data library not loaded ({_failure}); the "
            f"Python paths clean, tokenize and gather")
    return ok


def crc32(data: bytes) -> int:
    lib = load()
    if lib is None:
        import zlib
        return zlib.crc32(data)
    return lib.fdt_crc32(data, len(data))


def clean_text(text: str) -> Optional[str]:
    """The cleaner over html-unescaped ``text``; None without the library
    (the caller runs ``data.text.clean_text_py``)."""
    lib = load()
    if lib is None:
        return None
    raw = text.encode("utf-8", "ignore")
    cap = max(len(raw) + 16, 64)
    buf = ctypes.create_string_buffer(cap)
    n = lib.fdt_clean_text(raw, buf, cap)
    if n < 0:                       # cleaning only shrinks; kept as JAX's
        cap = -int(n)
        buf = ctypes.create_string_buffer(cap)
        n = lib.fdt_clean_text(raw, buf, cap)
        if n < 0:
            return None
    return buf.raw[:n].decode("utf-8", "ignore")


def stopwords() -> Optional[frozenset]:
    """The library's vendored stopword list; None without it."""
    lib = load()
    if lib is None:
        return None
    cap = 4096
    buf = ctypes.create_string_buffer(cap)
    n = lib.fdt_stopwords(buf, cap)
    if n < 0:
        cap = -int(n)
        buf = ctypes.create_string_buffer(cap)
        n = lib.fdt_stopwords(buf, cap)
        if n < 0:
            return None
    return frozenset(buf.raw[:n].decode("utf-8").split("\n"))


def encode_batch(texts: List[str], max_len: int, vocab_size: int,
                 pad_id: int = 0, cls_id: int = 101, sep_id: int = 102,
                 reserved: int = 999
                 ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The hash tokenizer over a batch of CLEANED texts: (tokens [n,
    max_len] int32, lengths [n] int32), or None."""
    lib = load()
    if lib is None:
        return None
    n = len(texts)
    tokens = np.empty((n, max_len), np.int32)
    lens = np.empty((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[t.encode("utf-8", "ignore") for t in texts])
    rc = lib.fdt_encode_batch(
        arr, n, max_len, vocab_size, pad_id, cls_id, sep_id, reserved,
        tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        return None
    return tokens, lens


def wp_load(vocab_lines: List[str]) -> Optional[int]:
    """Register a WordPiece vocab (id = list index); a handle, or None
    without the library.  One registration a tokenizer."""
    lib = load()
    if lib is None:
        return None
    blob = "\n".join(vocab_lines).encode("utf-8")
    h = lib.fdt_wp_load(blob, len(blob))
    return None if h < 0 else h


def wp_encode_batch(handle: int, texts: List[str], max_len: int,
                    cls_id: int, sep_id: int, unk_id: int, pad_id: int
                    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """WordPiece over a batch of CLEANED ([a-z0-9' ]) texts: (tokens [n,
    max_len] int32, lengths [n] int32), or None without the library or
    when a text needs the Python path's full Unicode handling."""
    lib = load()
    if lib is None:
        return None
    n = len(texts)
    tokens = np.empty((n, max_len), np.int32)
    lens = np.empty((n,), np.int32)
    try:
        arr = (ctypes.c_char_p * n)(*[t.encode("ascii") for t in texts])
    except UnicodeEncodeError:
        return None
    rc = lib.fdt_wp_encode_batch(
        handle, arr, n, max_len, cls_id, sep_id, unk_id, pad_id,
        tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        return None
    return tokens, lens


def gather_u8(src: np.ndarray, indices: np.ndarray) -> Optional[np.ndarray]:
    """``src[indices]`` for a C-contiguous uint8 array; None without the
    library."""
    lib = load()
    if lib is None or src.dtype != np.uint8 or not src.flags.c_contiguous:
        return None
    idx = np.ascontiguousarray(indices, np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= len(src)):
        raise IndexError(f"gather_u8 index out of range [0, {len(src)})")
    row_bytes = int(np.prod(src.shape[1:])) * src.itemsize
    dst = np.empty((len(idx),) + src.shape[1:], np.uint8)
    lib.fdt_gather_u8(
        src.ctypes.data_as(ctypes.c_char_p),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(idx), row_bytes, dst.ctypes.data_as(ctypes.c_char_p))
    return dst
