"""The executable cache over the built kernel libraries (the JAX package's
``resilience/executable_cache.py``): a fresh host or container reads its
libraries instead of compiling them.

What a restart pays for in the port is the build of each kernel library
(``ops/_build.py``: five ``nvcc`` builds; ``runtime/native_lib.py``: one
``g++`` build) and, in every process, the CUDA graphs' captures and the
eager programs' first dispatches.  A CUDA graph cannot leave its process,
so this cache holds the libraries: a library's ``.so`` is the same bytes
whoever built it, on any host with the same toolchain, card and CPU.

The loaders try three tiers in order (``ops/_build.py``): the local
``_build/`` directory (``cache_source`` ``persistent_dir``, JAX's
persistent-dir tier; the port's is always on), this cache
(``deserialized``: the verified bytes are written into ``_build/``), and
the compiler (``compiled``, then stored here).  The active observatory
(``telemetry/programs.py``) carries the cache (``executable_cache``) and
records each library's row.

Mechanics, as JAX's:

* Entries are whole objects through a ``resilience/storage.py`` backend
  (posix, the fake object store, GCS) under ``<checkpoint_dir>/
  _exec_cache/`` by default, so a process on another machine that reaches
  the same medium finds them.
* The frame is JAX's magic and big-endian length, plus the payload's
  sha256: a torn or bit-flipped ``.so`` would crash the process at
  ``dlopen``, where XLA's deserializer refused a bad executable.  A frame
  that fails its check is counted ``corrupt`` and the caller builds with
  the compiler (never a plain torch version in its place); a corrupt
  entry never blocks a start.
* Keys: sha256 over the library's build digest (source, headers, flags)
  and the environment it is valid in (:func:`environment_key`: torch,
  CUDA, the compiler's version line, the card and its compute
  capability, the machine and a CPU-feature hash).  JAX also keys the
  mesh and the donation flag; a library depends on neither, so they stay
  out.
* Retention GC: at most ``FDT_EXEC_CACHE_MAX_ENTRIES`` (64) entries and
  ``FDT_EXEC_CACHE_MAX_BYTES`` (512 MiB), least recently used first (a
  hit touches a ``.last_used`` sidecar); the most recent entry always
  survives.  Every method is best-effort: ``store`` and ``gc`` never
  raise into a build.

JAX's ``serialize_available`` and ``arm_persistent_cache`` are XLA's and
have no counterpart.  JAX skips storing a program the persistent dir
served (an XLA:CPU quirk); the port stores a library ``_build/`` served
as well.

Enablement: ``--executable_cache on`` (``<checkpoint_dir>/_exec_cache``)
or a directory; ``FDT_EXEC_CACHE`` overrides (``0`` turns it off).  The
cache rides the observatory, so ``FDT_PROGRAM_OBS=0`` turns it off too.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
from typing import Callable, Dict, List, Optional, Tuple

from faster_distributed_training_tpu_torch.resilience import (
    storage as storage_mod)

ENV_CACHE = "FDT_EXEC_CACHE"
ENV_MAX_ENTRIES = "FDT_EXEC_CACHE_MAX_ENTRIES"
ENV_MAX_BYTES = "FDT_EXEC_CACHE_MAX_BYTES"
DEFAULT_MAX_ENTRIES = 64
DEFAULT_MAX_BYTES = 512 * 1024 * 1024

# an entry's last use: a hit touches this sidecar instead of rewriting
# the payload
_USED_SUFFIX = ".last_used"

# frame: magic + 8-byte big-endian payload length + sha256(payload) +
# payload
_MAGIC = b"FDTXEC01"
_HEAD = len(_MAGIC) + 8 + 32

# {tool: its version line}, read once a process
_TOOL_LINES: Dict[str, str] = {}


def host_isa_fingerprint() -> str:
    """Short hash of this host's machine and CPU feature flags (the JAX
    package's ``cli._host_isa_fingerprint`` without jaxlib): a host
    library built with wider vector extensions faults elsewhere."""
    feat = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feat += line
                    break
    except OSError:
        feat += platform.processor() or ""
    return hashlib.sha1(feat.encode()).hexdigest()[:8]


def tool_line(tool: str) -> str:
    """The compiler's version line (``nvcc --version``'s release line,
    ``g++ --version``'s first), read once a process; "" when it does not
    run."""
    if tool not in _TOOL_LINES:
        line = ""
        try:
            if tool == "nvcc":
                from faster_distributed_training_tpu_torch.ops._build import (
                    nvcc_path)
                exe = nvcc_path()
            else:
                exe = tool
            text = subprocess.run([exe, "--version"], capture_output=True,
                                  text=True, timeout=60).stdout
            lines = [x.strip() for x in text.splitlines() if x.strip()]
            rel = [x for x in lines if "release" in x]
            line = (rel or lines or [""])[0]
        except (OSError, RuntimeError, subprocess.SubprocessError):
            pass
        _TOOL_LINES[tool] = line
    return _TOOL_LINES[tool]


def environment_key(tool: str = "nvcc") -> str:
    """Fingerprint of what a library built with ``tool`` is valid under:
    torch and CUDA versions, the compiler's version line, the card and
    its compute capability, the machine and the CPU features."""
    import torch

    bits = [f"torch={torch.__version__}", f"cuda={torch.version.cuda}",
            f"{tool}={tool_line(tool)}"]
    if torch.cuda.is_available():
        cap = torch.cuda.get_device_capability(0)
        bits.append(f"device={torch.cuda.get_device_name(0)}"
                    f"/sm_{cap[0]}{cap[1]}")
    else:
        bits.append("device=cpu")
    bits.append(f"machine={platform.machine()}")
    bits.append(f"isa={host_isa_fingerprint()}")
    return hashlib.sha256("|".join(bits).encode()).hexdigest()[:16]


def frame(payload: bytes) -> bytes:
    return (_MAGIC + len(payload).to_bytes(8, "big")
            + hashlib.sha256(payload).digest() + payload)


def unframe(raw: bytes) -> bytes:
    """The payload of a framed entry; raises ValueError on a bad magic, a
    torn length or a hash that does not match."""
    if len(raw) < _HEAD or raw[:len(_MAGIC)] != _MAGIC:
        raise ValueError("bad frame magic")
    n = int.from_bytes(raw[8:16], "big")
    if len(raw) != _HEAD + n:
        raise ValueError(f"truncated entry ({len(raw) - _HEAD}/{n} payload "
                         f"bytes)")
    payload = raw[_HEAD:]
    if hashlib.sha256(payload).digest() != raw[16:_HEAD]:
        raise ValueError("payload sha256 mismatch")
    return payload


class ExecutableCache:
    """Library store keyed by (build digest x environment), read and
    written through a StorageBackend.  ``load`` returns None on any
    failure and ``store`` swallows its own: a build is exactly as
    available with the cache as without it."""

    def __init__(self, directory: str,
                 backend: Optional[storage_mod.StorageBackend] = None,
                 log: Callable[[str], None] = print,
                 max_entries: Optional[int] = None,
                 max_bytes: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.backend = backend if backend is not None \
            else storage_mod.posix_backend()
        self._log = log
        self._warned: set = set()
        self.max_entries = int(
            os.environ.get(ENV_MAX_ENTRIES, "") or
            (DEFAULT_MAX_ENTRIES if max_entries is None else max_entries))
        self.max_bytes = int(
            os.environ.get(ENV_MAX_BYTES, "") or
            (DEFAULT_MAX_BYTES if max_bytes is None else max_bytes))
        self.stats: Dict[str, int] = {
            "hits": 0, "misses": 0, "stores": 0, "corrupt": 0,
            "store_failures": 0, "evicted": 0}
        self.backend.ensure_dir(self.directory)

    # -- keys --------------------------------------------------------------

    def key_for(self, name: str, digest: str, tool: str = "nvcc") -> str:
        """Object key of one library: its build digest crossed with the
        environment key of its compiler; the (sanitized) name rides along
        for readable listings."""
        h = hashlib.sha256(f"{digest}|{environment_key(tool)}".encode()
                           ).hexdigest()[:24]
        safe = "".join(c if c.isalnum() else "-" for c in name)[:40]
        return self.backend.join(self.directory, f"exec_{safe}_{h}")

    # -- load / store ------------------------------------------------------

    def load(self, key: str) -> Optional[bytes]:
        """The verified payload at ``key``, or None (a miss, or a corrupt
        entry: counted, warned once; the caller builds)."""
        try:
            raw = self.backend.read_bytes(key)
        except (OSError, ValueError):
            self.stats["misses"] += 1
            return None
        try:
            payload = unframe(raw)
        except ValueError as e:
            self.stats["corrupt"] += 1
            self._warn_once(
                "corrupt", f"[exec_cache] entry {os.path.basename(key)} "
                f"failed its check ({e}); building it (a corrupt entry "
                f"never blocks a start)")
            return None
        self.stats["hits"] += 1
        self._touch(key)
        return payload

    def store(self, key: str, payload: bytes) -> bool:
        """Publish one library (an atomic whole-object put), then GC.  A
        backend failure is counted and warned once, never raised."""
        try:
            self.backend.put_bytes(key, frame(payload))
        except Exception as e:
            self.stats["store_failures"] += 1
            self._warn_once(
                "store", f"[exec_cache] could not store "
                f"{os.path.basename(key)} ({e!r}); this library builds "
                f"again on the next fresh host")
            return False
        self.stats["stores"] += 1
        self.gc()
        return True

    # -- retention GC ------------------------------------------------------

    def _touch(self, key: str) -> None:
        """The LRU clock: a hit refreshes the ``.last_used`` sidecar."""
        try:
            self.backend.put_bytes(key + _USED_SUFFIX, b"")
        except Exception:
            pass

    def _last_used(self, key: str) -> float:
        """The sidecar's mtime when a hit touched it, else the entry's
        own (its store time)."""
        try:
            if self.backend.exists(key + _USED_SUFFIX):
                return self.backend.mtime(key + _USED_SUFFIX)
        except Exception:
            pass
        try:
            return self.backend.mtime(key)
        except Exception:
            return 0.0

    def entries(self) -> List[Tuple[str, int, float]]:
        """[(key, bytes, last_used)] of every entry (sidecars aside)."""
        out = []
        try:
            keys = self.backend.list_prefix(
                self.backend.join(self.directory, "exec_"))
        except Exception:
            return out
        for k in keys:
            if k.endswith(_USED_SUFFIX):
                continue
            try:
                out.append((k, self.backend.size(k), self._last_used(k)))
            except Exception:
                continue
        return out

    def gc(self) -> int:
        """Keep the most recently used entries while count <=
        ``max_entries`` and bytes <= ``max_bytes``; evict the rest (entry
        and sidecar).  The newest always survives.  Never raises; returns
        the entries evicted."""
        ents = self.entries()
        if not ents:
            return 0
        ents.sort(key=lambda e: e[2], reverse=True)   # newest first
        evicted = kept = total = 0
        for key, nbytes, _ in ents:
            kept += 1
            total += nbytes
            if kept == 1 or (kept <= self.max_entries
                             and total <= self.max_bytes):
                continue
            try:
                self.backend.delete(key)
                try:
                    self.backend.delete(key + _USED_SUFFIX)
                except Exception:
                    pass
                evicted += 1
            except Exception:
                continue
        if evicted:
            self.stats["evicted"] += evicted
            self._warn_once(
                "gc", f"[exec_cache] retention GC evicted {evicted} LRU "
                f"entr{'y' if evicted == 1 else 'ies'} (bounds: "
                f"{self.max_entries} entries / {self.max_bytes >> 20} MiB; "
                f"{ENV_MAX_ENTRIES} / {ENV_MAX_BYTES} override)")
        return evicted

    def _warn_once(self, topic: str, msg: str) -> None:
        if topic not in self._warned:
            self._warned.add(topic)
            self._log(msg)


def build_executable_cache(cfg, backend=None,
                           log: Callable[[str], None] = print
                           ) -> Optional[ExecutableCache]:
    """ExecutableCache from a TrainConfig, or None when it is off.

    ``--executable_cache``: ``""`` / ``off`` = off (the default), ``on`` =
    ``<checkpoint_dir>/_exec_cache`` through ``backend`` (the run's
    storage backend), anything else = a directory.  ``FDT_EXEC_CACHE``
    overrides (``0`` = off, ``on`` / a path = on).  Runs the GC once when
    armed."""
    spec = (getattr(cfg, "executable_cache", "") or "").strip()
    env = os.environ.get(ENV_CACHE, "").strip()
    if env == "0":
        return None
    if env:
        spec = env
    if spec in ("", "off", "0"):
        return None
    if spec in ("on", "1"):
        directory = os.path.join(getattr(cfg, "checkpoint_dir", "."),
                                 "_exec_cache")
    else:
        directory = spec
    cache = ExecutableCache(directory, backend=backend, log=log)
    cache.gc()
    log(f"[exec_cache] kernel-library cache armed at {directory} (a fresh "
        f"host loads its libraries from here instead of building them)")
    return cache
