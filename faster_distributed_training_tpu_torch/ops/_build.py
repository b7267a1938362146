"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles by hand with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, loaded with ``ctypes``
(pointers and the stream as ``c_void_p``).  Nothing here includes
PyTorch's headers, so a build takes seconds.  Libraries land in
``faster_distributed_training_tpu_torch/_build/`` (git-ignored), named by
a hash of the source, the shared headers (``csrc/*.cuh``) and the flags:
an edited source rebuilds, an unchanged one is reused.  ``build`` starts
one ``nvcc`` per stale source, all at once.  The build runs at first use,
never at import.

``load`` acquires a library through three tiers (``acquire``, which
``runtime/native_lib.py`` shares): the local ``_build/`` directory, then
the active observatory's executable cache (``resilience/
executable_cache.py``: the verified bytes are written into ``_build/``),
then the compiler (its output then stored in the cache).  A compiler
failure raises.  Each library a process loads is one ``lib:<name>`` row
of the program table (``telemetry/programs.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNELS = ("flash_fwd", "flash_bwd", "fused_mlp", "quant_matmul", "fused_ffn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, else $PATH, else /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels build with the CUDA toolkit's nvcc")


def lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    # the shared headers are part of every source
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Tuple[float, Dict[str, str]]:
    """Compile every stale library in ``names`` in parallel.  Returns
    (seconds, {name: compiler log}); raises with nvcc's output when a
    source does not compile."""
    t0 = time.monotonic()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return time.monotonic() - t0, logs


def digest_of(path: Path) -> str:
    """The build digest a library's file name carries."""
    return path.stem.rsplit("-", 1)[1]


def acquire(name: str, out: Path, build_fn: Callable[[], None],
            tool: str) -> Tuple[str, bool]:
    """Make library ``name``'s file ``out`` exist: the local ``_build/``
    (``persistent_dir``), else the active observatory's executable cache
    (``deserialized``), else ``build_fn`` with ``tool`` (``compiled``;
    raises when the compiler fails).  With a cache armed, a library it
    does not hold yet is stored.  Returns (source, cache armed)."""
    from faster_distributed_training_tpu_torch.telemetry import programs

    obs = programs.get_observatory()
    cache = getattr(obs, "executable_cache", None)
    key = (cache.key_for(f"lib:{name}", digest_of(out), tool)
           if cache is not None else None)
    if out.exists():
        if cache is not None and not cache.backend.exists(key):
            cache.store(key, out.read_bytes())
        return "persistent_dir", cache is not None
    if cache is not None:
        payload = cache.load(key)
        if payload is not None:
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(
                f".{os.getpid()}.{threading.get_ident()}.tmp")
            tmp.write_bytes(payload)
            os.replace(tmp, out)
            return "deserialized", True
    build_fn()
    if cache is not None:
        cache.store(key, out.read_bytes())
    return "compiled", cache is not None


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, acquired first if needed
    (``acquire``)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            from faster_distributed_training_tpu_torch.telemetry import (
                programs)

            t0 = time.monotonic()
            out = lib_path(name)
            source, armed = acquire(name, out, lambda: build([name]), "nvcc")
            lib = ctypes.CDLL(str(out))
            lib.fdt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.fdt_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
            programs.library_loaded(name, digest_of(out), str(out),
                                    (time.monotonic() - t0) * 1e3, source,
                                    armed)
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.fdt_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
