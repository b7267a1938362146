"""Pluggable checkpoint/coordination storage backend (a copy of the JAX
package's ``resilience/storage.py``; it imports neither JAX nor torch).

Every durable-write seam in the resilience stack — the two-phase sharded
checkpoint (npz blocks, manifests, DONE/COMMIT markers), the manager's
retention GC, and the pod coordinator's FAIL/HB/EXIT/RESTORE marker
transport — historically assumed ONE POSIX shared filesystem: atomic
writes were tmp + ``os.replace`` + fsync, retention was
``shutil.rmtree``, and the restore/commit barriers polled
``os.path.exists``.  Production multi-slice TPU pods break both halves
of that assumption: each slice mounts its own filesystem, and the only
durable medium every host can reach is an object store (GCS), which has
NO rename primitive — only whole-object PUT, generation-preconditioned
create, list-by-prefix and per-object delete.

:class:`StorageBackend` is the narrow contract both worlds satisfy:

  * ``put_bytes`` / ``put_stream`` / ``put_json`` — atomic whole-object
    publish: a reader sees the previous object (or absence) or the new
    one, never a torn middle.  POSIX implements it with the historic
    tmp+replace+fsync idiom (byte-compatible with every older
    checkpoint directory); object stores get it natively from PUT;
  * ``create_if_absent`` — the put-if-absent marker primitive (GCS
    ``if_generation_match=0``): first writer wins, losers observe False;
  * ``read_bytes(start, length)`` / ``open_read`` — ranged reads, so
    the block-filtered sharded restore can keep skipping npz
    members it doesn't need even when the "file" is a remote object
    (``open_read`` returns a seekable file-like whose reads translate
    to ranged GETs);
  * ``list_prefix`` / ``delete_prefix`` — discovery and BATCHED
    retention over a key prefix (an object store has no directories and
    no rmtree; prefix enumeration + batched delete is the native
    shape, and the POSIX implementation maps it back onto the tree);
  * ``exists`` / ``size`` / ``mtime`` — cheap metadata probes (the
    commit barrier polls ``exists``; heartbeat staleness reads
    ``mtime``).

Keys are plain "/"-separated paths (the same strings the call sites
always built with ``os.path.join``), so routing through the backend did
not require re-keying the world: :class:`PosixBackend` treats them as
filesystem paths verbatim, while the object-store backends relativize
them against their configured root.

Three implementations:

  * :class:`PosixBackend` — today's semantics, bit-for-bit.  The ONLY
    place in ``resilience/`` + ``train/checkpoint.py`` allowed to call
    ``os.replace``/``os.rename``/``shutil.rmtree``
    
  * :class:`FakeObjectStoreBackend` — object-store semantics with no
    rename anywhere: whole-object PUT, generation-preconditioned
    create, ranged reads, per-key delete.  Backed by a pluggable
    medium: :class:`MemoryMedium` (in-process dict — the test suite's
    simulated pods share one instance across host threads) or
    :class:`FileMedium` (a flat, rename-free on-disk encoding —
    footer-framed generation files created with ``O_EXCL`` — so
    REAL multi-process pods can run against object-store semantics).  Fault-injectable (``fail_puts``) and
    op-counting (``counts``), so tests can both break it on purpose and
    prove "zero rename operations issued".
  * :class:`GCSBackend` — a thin real-object-store binding
    (``gs://bucket/prefix``).  COMMIT markers use the
    precondition-create path (the compose-or-precondition equivalent of
    the POSIX atomic rename), retention uses batched prefix deletes.
    The google-cloud-storage client is imported lazily and its absence
    is a clear error, not an import-time crash — this container does
    not ship it, so the tests exercises the object-store CODE PATHS
    against :class:`FakeObjectStoreBackend` and the GCS binding stays a
    documented, structurally-mirrored thin shim (README caveat).
"""

from __future__ import annotations

import io
import json
import os
import shutil
import threading
import time
import urllib.parse
from typing import Callable, Dict, List, Optional, Tuple


class StorageBackend:
    """Base class + shared helpers.  ``kind`` identifies the semantics
    class ("posix" | "fake_object_store" | "gcs"); everything that is
    not plain POSIX must survive without a rename primitive, which is
    what the manager keys its "force the sharded two-phase path" and
    "skip the single-file path" decisions on."""

    kind: str = "abstract"

    # -- writes ------------------------------------------------------------

    def put_bytes(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def put_stream(self, key: str, write_fn: Callable) -> None:
        """Atomic publish of content produced by ``write_fn(fileobj)``.
        POSIX streams into the staging tmp file (no extra copy of a
        multi-GB shard set in host memory); object stores buffer and
        issue one whole-object PUT — inherent to the medium."""
        buf = io.BytesIO()
        write_fn(buf)
        self.put_bytes(key, buf.getvalue())

    def put_json(self, key: str, obj) -> None:
        self.put_bytes(key, json.dumps(obj).encode("utf-8"))

    def create_if_absent(self, key: str, data: bytes) -> bool:
        """Put-if-absent: True iff this call created the object (GCS
        ``if_generation_match=0``; POSIX ``O_EXCL``).  Losers must be
        able to trust that SOME complete object exists at `key`."""
        raise NotImplementedError

    # -- reads -------------------------------------------------------------

    def read_bytes(self, key: str, start: int = 0,
                   length: Optional[int] = None) -> bytes:
        raise NotImplementedError

    def read_json(self, key: str) -> Optional[dict]:
        """Parsed JSON object, or None when absent/torn — the marker-
        read contract every poller relies on."""
        try:
            return json.loads(self.read_bytes(key).decode("utf-8"))
        except (OSError, ValueError, KeyError):
            return None

    def open_read(self, key: str):
        """Seekable binary file-like over the object (ranged reads
        under the hood for object stores) — what lets ``np.load`` keep
        its lazy per-member npz access on every backend."""
        return _RangeReader(self, key)

    # -- metadata ----------------------------------------------------------

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def size(self, key: str) -> int:
        raise NotImplementedError

    def mtime(self, key: str) -> float:
        """Last-modified unix time; raises OSError when absent."""
        raise NotImplementedError

    # -- listing / deletion ------------------------------------------------

    def list_prefix(self, prefix: str) -> List[str]:
        """Every object key starting with `prefix` (full keys, any
        depth).  Directories are not objects and never appear."""
        raise NotImplementedError

    def list_entries(self, prefix: str) -> List[str]:
        """Immediate child NAMES under a directory-like prefix — one
        path component, no recursion.  THE discovery primitive for the
        hot enumeration sites (checkpoint entries after every save,
        generation dirs / FAIL markers every poll): object stores
        derive it from the key listing; POSIX overrides with a single
        readdir so a large checkpoint tree (telemetry JSONL, epoch
        checkpoint trees) is never walked whole just to name its top
        level."""
        base = prefix.rstrip("/").rstrip(os.sep) + os.sep
        out = set()
        for key in self.list_prefix(base):
            rel = key[len(base):]
            out.add(rel.split(os.sep, 1)[0].split("/", 1)[0])
        return sorted(n for n in out if n)

    def any_prefix(self, prefix: str) -> bool:
        return bool(self.list_prefix(prefix))

    def delete(self, key: str) -> None:
        """Idempotent single-object delete (absent key is a no-op)."""
        raise NotImplementedError

    def delete_prefix(self, prefix: str) -> int:
        """Batched delete of every object under `prefix`; returns the
        number of objects removed.  THE retention/GC primitive — maps
        to rmtree on POSIX and to list+batched-delete on object
        stores."""
        n = 0
        for k in self.list_prefix(prefix):
            self.delete(k)
            n += 1
        return n

    # -- conveniences ------------------------------------------------------

    def ensure_dir(self, path: str) -> None:
        """POSIX needs parent directories to exist before an atomic
        write can stage next to its target; object stores have no
        directories and no-op."""

    def join(self, *parts: str) -> str:
        return "/".join(p.rstrip("/") for p in parts if p)


class _RangeReader(io.RawIOBase):
    """Seekable read-only file over ``backend.read_bytes`` ranged
    GETs.  Small sequential reads are the np.load/zipfile access
    pattern; each ``read`` issues exactly one ranged fetch."""

    def __init__(self, backend: StorageBackend, key: str):
        self._b, self._key = backend, key
        self._size = backend.size(key)
        self._pos = 0

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def seek(self, offset: int, whence: int = io.SEEK_SET) -> int:
        if whence == io.SEEK_SET:
            self._pos = offset
        elif whence == io.SEEK_CUR:
            self._pos += offset
        elif whence == io.SEEK_END:
            self._pos = self._size + offset
        else:
            raise ValueError(f"bad whence {whence}")
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        if self._pos >= self._size:
            return b""
        length = self._size - self._pos if n is None or n < 0 else \
            min(n, self._size - self._pos)
        data = self._b.read_bytes(self._key, start=self._pos, length=length)
        self._pos += len(data)
        return data

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)


# ---------------------------------------------------------------------------
# POSIX
# ---------------------------------------------------------------------------


class PosixBackend(StorageBackend):
    """The historic shared-filesystem semantics, byte-compatible with
    every existing checkpoint directory: atomic publish is tmp +
    ``os.replace`` + fsync (exactly the older ``_write_json_atomic``
    idiom, staged beside the target so the rename never crosses a
    filesystem), listing walks the tree, prefix deletion is rmtree.
    Keys are filesystem paths verbatim."""

    kind = "posix"

    def put_bytes(self, key: str, data: bytes) -> None:
        self.put_stream(key, lambda f: f.write(data))

    def put_stream(self, key: str, write_fn: Callable) -> None:
        self.ensure_dir(os.path.dirname(key))
        # pid + thread ident in the staging name: markers are written
        # from both the watchdog thread and the main thread — a shared
        # tmp path would let one thread's replace consume the other's
        # staged file (the coordinator lesson, kept here)
        tmp = f"{key}.tmp{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, key)

    def create_if_absent(self, key: str, data: bytes) -> bool:
        self.ensure_dir(os.path.dirname(key))
        try:
            fd = os.open(key, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        return True

    def read_bytes(self, key: str, start: int = 0,
                   length: Optional[int] = None) -> bytes:
        with open(key, "rb") as f:
            if start:
                f.seek(start)
            return f.read() if length is None else f.read(length)

    def open_read(self, key: str):
        return open(key, "rb")        # the real thing beats a shim

    def exists(self, key: str) -> bool:
        return os.path.exists(key)

    def size(self, key: str) -> int:
        return os.path.getsize(key)

    def mtime(self, key: str) -> float:
        return os.path.getmtime(key)

    def list_prefix(self, prefix: str) -> List[str]:
        # `prefix` is a path prefix, not necessarily a directory: walk
        # the deepest existing directory at-or-above it and filter.
        # Empty LEAF directories surface as pseudo-keys (their own
        # path): an object store cannot have them, but POSIX crash
        # residue can (a mkdir with nothing staged yet), and the
        # manager's torn-dir sweep must still see it.
        root = prefix if os.path.isdir(prefix) else os.path.dirname(prefix)
        out = []
        for dirpath, dirs, files in os.walk(root):
            for name in files:
                p = os.path.join(dirpath, name)
                if p.startswith(prefix):
                    out.append(p)
            if not dirs and not files and dirpath.startswith(prefix) \
                    and dirpath != root:
                out.append(dirpath)
        return sorted(out)

    def any_prefix(self, prefix: str) -> bool:
        return os.path.isdir(prefix) or os.path.exists(prefix) \
            or bool(self.list_prefix(prefix))

    def list_entries(self, prefix: str) -> List[str]:
        # one readdir — names of files AND directories (a bare mkdir
        # from a crashed save is an entry the torn-dir sweep must see)
        try:
            with os.scandir(prefix) as it:
                return sorted(e.name for e in it)
        except OSError:
            return []

    def delete(self, key: str) -> None:
        try:
            os.remove(key)
        except OSError:
            pass

    def delete_prefix(self, prefix: str) -> int:
        if os.path.isdir(prefix):
            n = sum(len(files) for _d, _s, files in os.walk(prefix))
            shutil.rmtree(prefix, ignore_errors=True)
            return n
        n = 0
        for k in self.list_prefix(prefix):
            self.delete(k)
            n += 1
        return n

    def ensure_dir(self, path: str) -> None:
        if path:
            os.makedirs(path, exist_ok=True)


# module singleton: the default backend of every routed call site, so
# older callers (and the single-file path) behave identically
# without threading a backend through code that never needs another one
_POSIX = PosixBackend()


def posix_backend() -> PosixBackend:
    return _POSIX


# ---------------------------------------------------------------------------
# Fake object store (the tests' GCS stand-in)
# ---------------------------------------------------------------------------


class MemoryMedium:
    """In-process object map — the unit the simulated-pod THREADS
    share.  All mutation under one lock; values are
    (bytes, generation, mtime)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._objects: Dict[str, Tuple[bytes, int, float]] = {}

    def put(self, name: str, data: bytes) -> None:
        with self._lock:
            gen = self._objects.get(name, (b"", 0, 0.0))[1] + 1
            self._objects[name] = (bytes(data), gen, time.time())

    def create(self, name: str, data: bytes) -> bool:
        with self._lock:
            if name in self._objects:
                return False
            self._objects[name] = (bytes(data), 1, time.time())
            return True

    def get(self, name: str) -> Optional[Tuple[bytes, float]]:
        with self._lock:
            got = self._objects.get(name)
            return None if got is None else (got[0], got[2])

    def list(self) -> List[str]:
        with self._lock:
            return sorted(self._objects)

    def remove(self, name: str) -> bool:
        with self._lock:
            return self._objects.pop(name, None) is not None


class FileMedium:
    """Rename-free on-disk object map, so a fake-object-store pod can
    span real PROCESSES.  One flat directory; each object is a family of
    *generation files* ``<quoted-key>.g<N>`` written with
    ``O_CREAT|O_EXCL`` (the creation itself is the atomicity: no
    staging, no rename) and framed as

        8-byte big-endian payload length | payload | 8-byte magic

    A torn write (killed mid-PUT) lacks the trailing magic or the full
    length and is ignored by readers; the newest VALID generation wins,
    which is exactly an object store's last-writer-wins PUT.  Old
    generations are best-effort unlinked after a successful put."""

    _MAGIC = b"FDTOBJ\r\n"

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _enc(self, name: str) -> str:
        return urllib.parse.quote(name, safe="")

    def _dec(self, fname: str) -> str:
        return urllib.parse.unquote(fname)

    def _gens(self, name: str) -> List[Tuple[int, str]]:
        enc = self._enc(name) + ".g"
        out = []
        try:
            for f in os.listdir(self.root):
                if f.startswith(enc):
                    try:
                        out.append((int(f[len(enc):]),
                                    os.path.join(self.root, f)))
                    except ValueError:
                        pass
        except OSError:
            return []
        return sorted(out)

    def _read_valid(self, path: str) -> Optional[Tuple[bytes, float]]:
        try:
            with open(path, "rb") as f:
                raw = f.read()
            st = os.stat(path)
        except OSError:
            return None
        if len(raw) < 16 or raw[-8:] != self._MAGIC:
            return None
        n = int.from_bytes(raw[:8], "big")
        if len(raw) != 16 + n:
            return None
        return raw[8:8 + n], st.st_mtime

    def _frame(self, data: bytes) -> bytes:
        return len(data).to_bytes(8, "big") + data + self._MAGIC

    def _write_gen(self, name: str, gen0: int, data: bytes) -> bool:
        gen = gen0
        framed = self._frame(data)
        while True:
            path = os.path.join(self.root, f"{self._enc(name)}.g{gen:06d}")
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                if gen0 == 0 and gen == 0:
                    return False        # create-if-absent lost the race
                gen += 1
                continue
            with os.fdopen(fd, "wb") as f:
                f.write(framed)
                f.flush()
                os.fsync(f.fileno())
            # sweep superseded generations (best-effort — a concurrent
            # reader that already opened one still reads it to the end)
            for g, p in self._gens(name):
                if g < gen:
                    try:
                        os.remove(p)
                    except OSError:
                        pass
            return True

    def put(self, name: str, data: bytes) -> None:
        gens = self._gens(name)
        self._write_gen(name, (gens[-1][0] + 1) if gens else 1, data)

    def create(self, name: str, data: bytes) -> bool:
        # an object exists iff ANY valid generation does; O_EXCL on
        # gen 0 arbitrates true creation races.  A key whose valid
        # generations were all deleted (or torn) re-creates at the next
        # generation number — that path's concurrent-create arbitration
        # is best-effort only, like an object store recreated right
        # after a delete (generation preconditions restart)
        if self.get(name) is not None:
            return False
        gens = self._gens(name)
        if not gens:
            return self._write_gen(name, 0, data)
        return self._write_gen(name, gens[-1][0] + 1, data)

    def get(self, name: str) -> Optional[Tuple[bytes, float]]:
        for _g, path in reversed(self._gens(name)):
            got = self._read_valid(path)
            if got is not None:
                return got
        return None

    def list(self) -> List[str]:
        names = set()
        try:
            files = os.listdir(self.root)
        except OSError:
            return []
        for f in files:
            enc, _, tail = f.rpartition(".g")
            if enc and tail.isdigit():
                names.add(self._dec(enc))
        return sorted(n for n in names if self.get(n) is not None)

    def remove(self, name: str) -> bool:
        hit = False
        for _g, path in self._gens(name):
            try:
                os.remove(path)
                hit = True
            except OSError:
                pass
        return hit


class FakeObjectStoreBackend(StorageBackend):
    """Object-store semantics for the tests (and rename-free multi-process
    smokes): no rename primitive EXISTS on this class — writes are
    whole-object PUTs, markers are generation-preconditioned creates,
    retention is list+delete.  ``counts`` tallies every operation ("no
    rename issued" holds both ways: the op vocabulary has no rename, and
    tests additionally trap ``os.replace``/``os.rename`` while the
    backend runs).  ``fail_puts``
    arms deterministic write faults for the torn-save tests."""

    kind = "fake_object_store"

    def __init__(self, medium=None, root: str = ""):
        self.medium = medium if medium is not None else MemoryMedium()
        self.root = os.path.abspath(root) if root else ""
        self.counts: Dict[str, int] = {
            "put": 0, "create": 0, "read": 0, "list": 0, "delete": 0}
        self._fail_puts_match: Optional[str] = None
        self._fail_puts_left = 0
        self._lock = threading.Lock()

    # keys arrive as the same absolute-ish paths the POSIX world uses;
    # the store's namespace is rooted, so relativize when a root is set.
    # A trailing separator (a "directory" prefix) survives abspath
    # normalization — prefix listings depend on it.
    def _k(self, key: str) -> str:
        trailing = key.endswith(os.sep) or key.endswith("/")
        if self.root:
            key = os.path.abspath(key)
            if key == self.root:
                return ""
            if key.startswith(self.root + os.sep):
                key = key[len(self.root) + 1:]
        key = key.replace(os.sep, "/")
        if trailing and key and not key.endswith("/"):
            key += "/"
        return key

    def fail_puts(self, substring: str, count: int = 1) -> None:
        """Arm the next `count` puts whose key contains `substring` to
        raise OSError — the injected-storage-fault seam."""
        with self._lock:
            self._fail_puts_match = substring
            self._fail_puts_left = int(count)

    def _maybe_fail(self, key: str) -> None:
        with self._lock:
            if (self._fail_puts_left > 0 and self._fail_puts_match is not None
                    and self._fail_puts_match in key):
                self._fail_puts_left -= 1
                raise OSError(f"injected object-store PUT failure: {key}")

    def put_bytes(self, key: str, data: bytes) -> None:
        k = self._k(key)
        self._maybe_fail(k)
        self.counts["put"] += 1
        self.medium.put(k, data)

    def create_if_absent(self, key: str, data: bytes) -> bool:
        k = self._k(key)
        self._maybe_fail(k)
        self.counts["create"] += 1
        return self.medium.create(k, data)

    def read_bytes(self, key: str, start: int = 0,
                   length: Optional[int] = None) -> bytes:
        got = self.medium.get(self._k(key))
        if got is None:
            raise FileNotFoundError(f"no object {key!r}")
        self.counts["read"] += 1
        data = got[0]
        if start or length is not None:
            stop = None if length is None else start + length
            return data[start:stop]
        return data

    def exists(self, key: str) -> bool:
        return self.medium.get(self._k(key)) is not None

    def size(self, key: str) -> int:
        got = self.medium.get(self._k(key))
        if got is None:
            raise FileNotFoundError(f"no object {key!r}")
        return len(got[0])

    def mtime(self, key: str) -> float:
        got = self.medium.get(self._k(key))
        if got is None:
            raise OSError(f"no object {key!r}")
        return got[1]

    def list_prefix(self, prefix: str) -> List[str]:
        self.counts["list"] += 1
        p = self._k(prefix)
        return [self._unk(name) for name in self.medium.list()
                if name.startswith(p)]

    def _unk(self, name: str) -> str:
        return (self.root + os.sep + name.replace("/", os.sep)) \
            if self.root else name

    def delete(self, key: str) -> None:
        if self.medium.remove(self._k(key)):
            self.counts["delete"] += 1


# ---------------------------------------------------------------------------
# GCS (thin; exercised against the fake in the tests — README caveat)
# ---------------------------------------------------------------------------


class GCSBackend(StorageBackend):
    """``gs://bucket/prefix`` binding of the same contract.  Atomic
    publish is the object store's native PUT; the COMMIT/DONE marker
    creates use ``if_generation_match=0`` (the compose-or-precondition
    equivalent of the POSIX atomic-rename commit); retention issues
    batched prefix deletes (one HTTP batch per 100 objects, the client
    library's batch limit).  Local paths relativize against ``root``
    (the run's checkpoint_dir) exactly like the fake backend, so the
    manager/coordinator key-building code is shared verbatim.

    The google-cloud-storage client is resolved lazily; this container
    does not ship it, so construction raises a clear RuntimeError and
    the tests proves the object-store code paths on
    :class:`FakeObjectStoreBackend` instead (ROADMAP caveat)."""

    kind = "gcs"

    def __init__(self, bucket: str, prefix: str = "", root: str = ""):
        try:
            from google.cloud import storage as gcs  # noqa: PLC0415
        except ImportError as e:
            raise RuntimeError(
                "GCSBackend needs the google-cloud-storage client, which "
                "is not installed in this environment — use "
                "--storage_backend fake_object_store to exercise the "
                "object-store code paths, or install the client where "
                "GCS is reachable") from e
        try:
            self._client = gcs.Client()
        except Exception as e:
            raise RuntimeError(
                f"GCSBackend could not construct a client ({e}) — "
                f"missing credentials?  Set up Application Default "
                f"Credentials on every pod host, or use "
                f"--storage_backend fake_object_store for local "
                f"object-semantics testing") from e
        self._bucket = self._client.bucket(bucket)
        self.bucket_name = bucket
        self.prefix = prefix.strip("/")
        self.root = os.path.abspath(root) if root else ""

    def _k(self, key: str) -> str:
        if self.root:
            key = os.path.abspath(key)
            if key.startswith(self.root + os.sep):
                key = key[len(self.root) + 1:]
            elif key == self.root:
                key = ""
        key = key.replace(os.sep, "/").lstrip("/")
        return f"{self.prefix}/{key}" if self.prefix else key

    def put_bytes(self, key: str, data: bytes) -> None:
        self._bucket.blob(self._k(key)).upload_from_string(
            data, content_type="application/octet-stream")

    def create_if_absent(self, key: str, data: bytes) -> bool:
        from google.api_core import exceptions as gexc  # noqa: PLC0415
        try:
            self._bucket.blob(self._k(key)).upload_from_string(
                data, content_type="application/octet-stream",
                if_generation_match=0)
            return True
        except gexc.PreconditionFailed:
            return False

    def read_bytes(self, key: str, start: int = 0,
                   length: Optional[int] = None) -> bytes:
        end = None if length is None else start + length - 1
        return self._bucket.blob(self._k(key)).download_as_bytes(
            start=start or None, end=end)

    def exists(self, key: str) -> bool:
        return self._bucket.blob(self._k(key)).exists()

    def size(self, key: str) -> int:
        blob = self._bucket.get_blob(self._k(key))
        if blob is None:
            raise FileNotFoundError(f"no object {key!r}")
        return int(blob.size)

    def mtime(self, key: str) -> float:
        blob = self._bucket.get_blob(self._k(key))
        if blob is None or blob.updated is None:
            raise OSError(f"no object {key!r}")
        return blob.updated.timestamp()

    def list_prefix(self, prefix: str) -> List[str]:
        p = self._k(prefix)
        out = []
        for blob in self._client.list_blobs(self._bucket, prefix=p):
            name = blob.name
            if self.prefix:
                name = name[len(self.prefix) + 1:]
            local = name.replace("/", os.sep)
            out.append(self.root + os.sep + local if self.root else local)
        return out

    def delete(self, key: str) -> None:
        from google.api_core import exceptions as gexc  # noqa: PLC0415
        try:
            self._bucket.blob(self._k(key)).delete()
        except gexc.NotFound:
            pass

    def delete_prefix(self, prefix: str) -> int:
        keys = self.list_prefix(prefix)
        for i in range(0, len(keys), 100):     # client batch limit
            chunk = keys[i:i + 100]
            try:
                # deletes inside a batch context are DEFERRED: per-call
                # NotFound suppression cannot work, errors surface at
                # batch __exit__ — so the whole chunk is try/excepted
                with self._client.batch():
                    for k in chunk:
                        self._bucket.blob(self._k(k)).delete()
            except Exception:
                # a concurrently-deleted object (another host's sweep,
                # a lifecycle rule) fails the batch: fall back to
                # per-object tolerant deletes — retention must never
                # crash training over a deletion race
                for k in chunk:
                    self.delete(k)
        return len(keys)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


def build_backend(spec: str, root: str,
                  log: Callable[[str], None] = print) -> StorageBackend:
    """Backend from a --storage_backend spec:

      * ""/"posix"            -> :class:`PosixBackend` (the default;
                                 byte-compatible with every existing
                                 checkpoint directory)
      * "fake_object_store"   -> :class:`FakeObjectStoreBackend` over a
                                 :class:`FileMedium` under
                                 ``<root>/_objects`` (cross-process
                                 durable, rename-free — the smoke /
                                 simulated-pod configuration)
      * "gs://bucket[/prefix]"-> :class:`GCSBackend`

    ``root`` (the run's checkpoint_dir) anchors key relativization for
    the object-store backends."""
    spec = (spec or "posix").strip()
    if spec in ("", "posix"):
        return _POSIX
    root = os.path.abspath(root)
    if spec == "fake_object_store":
        log(f"[storage] fake object store (rename-free FileMedium) under "
            f"{root}/_objects — markers/shards live as framed objects, "
            f"not plain files")
        return FakeObjectStoreBackend(
            FileMedium(os.path.join(root, "_objects")), root=root)
    if spec.startswith("gs://"):
        rest = spec[len("gs://"):]
        bucket, _, prefix = rest.partition("/")
        if not bucket:
            raise ValueError(f"malformed GCS spec {spec!r}: want "
                             f"gs://bucket[/prefix]")
        log(f"[storage] GCS backend bucket={bucket} prefix={prefix!r}")
        return GCSBackend(bucket, prefix=prefix, root=root)
    raise ValueError(
        f"unknown --storage_backend {spec!r}: want posix, "
        f"fake_object_store, or gs://bucket[/prefix]")
