"""The port's executable cache over the built kernel libraries
(``faster_distributed_training_tpu_torch/resilience/executable_cache.py``
and the tiers of ``ops/_build.py::acquire``) held to the JAX package's
contract (``resilience/executable_cache.py``, its
``tests/test_executable_cache.py``), with the real native host library
(``runtime/native_lib.py``; g++ is here), built once for the module into a
temporary ``_build/``:

  * ``compiled`` -> stored; a fresh build directory -> ``deserialized``
    with no compiler started (``subprocess.run`` patched to fail), the
    library working;
  * a truncated and a byte-flipped entry -> ``corrupt`` counted, the
    library rebuilt with g++ and stored again (never a plain version in
    its place); the fake object store's round trip; a changed environment
    key misses; goodput billed on a hit and a miss;
  * the retention GC by count and by bytes in LRU order, a hit's touch
    reordering it, the newest always kept, a backend whose ``delete``
    raises never blocking a store;
  * ``--executable_cache`` off / on / a directory and ``FDT_EXEC_CACHE=0``
    (JAX ``build_executable_cache``), and ``on`` armed by each of the
    three entry points;
  * JAX's ``scripts/check_storage_routing.py::_banned_calls`` finds no
    rename or rmtree in the port's module (the lint is imported, not
    edited).

Two differences from JAX, by design: the environment key leaves out the
mesh and the donation flag (a library depends on neither) and names the
compiler's version line; a library the local ``_build/`` served is stored
too (its bytes are the same whoever built them), where JAX skips storing
a program XLA's persistent directory served.
"""

import importlib.util
import os
import shutil
import subprocess
import zlib

import numpy as np
import pytest
import torch

from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.interop import (flatten,
                                                           params_to_jax)
from faster_distributed_training_tpu_torch.resilience import (
    executable_cache as ec)
from faster_distributed_training_tpu_torch.resilience.goodput import (
    GoodputTracker)
from faster_distributed_training_tpu_torch.resilience.storage import (
    FakeObjectStoreBackend, MemoryMedium, posix_backend)
from faster_distributed_training_tpu_torch.runtime import native_lib
from faster_distributed_training_tpu_torch.telemetry import programs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SILENT = lambda *_: None                                 # noqa: E731


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _acquire(build_dir, cache, goodput=None):
    """A fresh process's load of the native library into ``build_dir``
    with ``cache`` on the active observatory: (the library, its table
    row, the observatory)."""
    obs = programs.ProgramObservatory(log=_SILENT)
    obs.executable_cache = cache
    if goodput is not None:
        obs.goodput = goodput
    prev = programs.set_observatory(obs)
    saved = (native_lib.BUILD_DIR, native_lib._lib, native_lib._failure)
    native_lib.BUILD_DIR = build_dir
    native_lib._lib, native_lib._failure = None, None
    try:
        lib = native_lib.load()
        assert lib is not None, native_lib._failure
        row = obs.programs["lib:fdt_native"][0]
        assert crc32_of(lib, b"restart") == zlib.crc32(b"restart")
    finally:
        (native_lib.BUILD_DIR, native_lib._lib,
         native_lib._failure) = saved
        programs.set_observatory(prev)
    return lib, row, obs


def crc32_of(lib, data: bytes) -> int:
    return lib.fdt_crc32(data, len(data))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The module's one cold build: an empty ``_build/`` and an empty
    cache -> g++, then the store.  (cache dir, its cache, the row, the
    entry's key, the library's bytes)."""
    root = tmp_path_factory.mktemp("native")
    cache = ec.ExecutableCache(str(root / "cache"), log=_SILENT)
    _lib, row, _obs = _acquire(root / "build0", cache)
    out = root / "build0" / native_lib.lib_path().name
    key = cache.key_for("lib:fdt_native", out.stem.rsplit("-", 1)[1], "g++")
    return root, cache, row, key, out.read_bytes()


def _fresh(root, name):
    d = root / name
    shutil.rmtree(d, ignore_errors=True)
    return d


def test_cold_build_is_compiled_and_stored(built):
    _root, cache, row, key, so = built
    assert (row["cache_source"], row["cache"], row["cache_method"]) == (
        "compiled", "miss", "executable_cache")
    assert row["generated_code_bytes"] == len(so) > 0
    assert len(row["fingerprint"]) == 16
    assert cache.stats["stores"] == 1 and cache.backend.exists(key)
    assert cache.load(key) == so


def test_fresh_build_dir_deserializes_without_a_compiler(built,
                                                         monkeypatch):
    """A fresh host: the bytes come from the cache, no compiler runs."""
    root, cache, _row, _key, so = built

    def no_compiler(*a, **kw):
        raise AssertionError(f"a compiler was started: {a}")
    monkeypatch.setattr(subprocess, "run", no_compiler)
    monkeypatch.setattr(subprocess, "Popen", no_compiler)
    d = _fresh(root, "build_hit")
    _lib, row, _obs = _acquire(d, cache)
    assert (row["cache_source"], row["cache"], row["cache_method"]) == (
        "deserialized", "hit", "executable_cache")
    assert (d / native_lib.lib_path().name).read_bytes() == so
    # a second start on the same _build/ is served locally (and the
    # entry is not rewritten)
    stores = cache.stats["stores"]
    _lib, row, _obs = _acquire(d, cache)
    assert (row["cache_source"], row["cache"], row["cache_method"]) == (
        "persistent_dir", "hit", "dir_stat")
    assert cache.stats["stores"] == stores


@pytest.mark.parametrize("damage", ["truncate", "flip"])
def test_corrupt_entry_is_rebuilt_and_stored_again(built, damage):
    """JAX ``test_corrupt_entry_degrades_to_compile_not_crash``: the frame
    check (with the payload's sha256) refuses it, g++ builds, the entry
    is replaced."""
    root, _cache, _row, key, so = built
    d = root / f"cache_{damage}"
    shutil.copytree(root / "cache", d, dirs_exist_ok=True)
    cache = ec.ExecutableCache(str(d), log=_SILENT)
    mine = os.path.join(str(d), os.path.basename(key))
    raw = open(mine, "rb").read()
    if damage == "truncate":
        raw = raw[:len(raw) // 2]
    else:
        raw = raw[:-100] + bytes([raw[-100] ^ 0x40]) + raw[-99:]
    with open(mine, "wb") as f:
        f.write(raw)
    _lib, row, _obs = _acquire(_fresh(root, f"build_{damage}"), cache)
    assert row["cache_source"] == "compiled"
    assert cache.stats["corrupt"] == 1 and cache.stats["stores"] == 1
    assert cache.load(mine) == so


def test_object_store_round_trip_and_frame_check():
    """JAX ``test_object_store_backend_round_trip`` on the fake object
    store; a flipped payload byte fails the hash."""
    be = FakeObjectStoreBackend(MemoryMedium(), root="/x")
    cache = ec.ExecutableCache("/x/_exec_cache", backend=be, log=_SILENT)
    key = cache.key_for("lib:fused_mlp", "0123456789abcdef")
    payload = bytes(range(256)) * 9
    assert cache.store(key, payload)
    assert cache.load(key) == payload
    assert [k for k, _n, _t in cache.entries()] == [key]
    raw = bytearray(be.read_bytes(key))
    raw[-1] ^= 1
    be.put_bytes(key, bytes(raw))
    assert cache.load(key) is None and cache.stats["corrupt"] == 1
    assert cache.load(key + "x") is None and cache.stats["misses"] == 1


def test_changed_environment_misses(built, monkeypatch):
    """JAX ``test_environment_key_partitions_the_namespace``: another
    compiler (or torch, card, CPU) gives another key: a clean miss."""
    _root, cache, _row, key, _so = built
    digest = native_lib.lib_path().stem.rsplit("-", 1)[1]
    assert cache.key_for("lib:fdt_native", digest, "g++") == key
    monkeypatch.setitem(ec._TOOL_LINES, "g++", "g++ (another) 99.0")
    other = cache.key_for("lib:fdt_native", digest, "g++")
    assert other != key
    misses = cache.stats["misses"]
    assert cache.load(other) is None
    assert cache.stats["misses"] == misses + 1


def test_goodput_billed_on_hit_and_miss(built):
    """JAX ``test_goodput_billed_for_acquisition_both_ways``: the
    acquisition ms of a build and of a load go to ``add_compile``."""
    root, _cache, _row, _key, _so = built
    for cold in (True, False):
        cache = ec.ExecutableCache(str(root / "cache"), log=_SILENT)
        if cold:
            cache = ec.ExecutableCache(str(_fresh(root, "cache_gp")),
                                       log=_SILENT)
        gp = GoodputTracker()
        _lib, row, obs = _acquire(_fresh(root, "build_gp"), cache,
                                  goodput=gp)
        assert row["cache_source"] == ("compiled" if cold
                                       else "deserialized")
        assert row["compile_ms"] > 0
        assert gp.summary()["compile_s"] == pytest.approx(
            row["compile_ms"] / 1e3, abs=1e-3)
        assert obs.summary()["total_acquisition_ms"] == pytest.approx(
            row["compile_ms"], abs=0.01)


# -- retention GC ---------------------------------------------------------

def _put(cache, name, payload=b"x" * 64, when=None):
    key = cache.key_for(name, "fp_" + name)
    cache.backend.put_bytes(key, ec.frame(payload))
    if when is not None:
        os.utime(key, (when, when))
    return key


def test_gc_by_count_and_by_bytes_in_lru_order(tmp_path):
    """JAX ``TestRetentionGC``: the bounds keep the most recently used."""
    t0 = 1_700_000_000.0
    cache = ec.ExecutableCache(str(tmp_path / "n"), log=_SILENT,
                               max_entries=3, max_bytes=1 << 30)
    keys = [_put(cache, f"p{i}", when=t0 + i) for i in range(5)]
    assert cache.gc() == 2 and cache.stats["evicted"] == 2
    assert [cache.backend.exists(k) for k in keys] == [False, False, True,
                                                       True, True]
    entry = b"y" * 1024
    frame = len(ec.frame(entry))
    cache = ec.ExecutableCache(str(tmp_path / "b"), log=_SILENT,
                               max_entries=100, max_bytes=2 * frame)
    keys = [_put(cache, f"p{i}", payload=entry, when=t0 + i)
            for i in range(4)]
    assert cache.gc() == 2
    assert [cache.backend.exists(k) for k in keys] == [False, False, True,
                                                       True]
    # one entry over the byte bound alone survives: the newest is kept
    cache = ec.ExecutableCache(str(tmp_path / "one"), log=_SILENT,
                               max_entries=100, max_bytes=1)
    k = _put(cache, "big", payload=entry)
    assert cache.gc() == 0 and cache.backend.exists(k)


def test_hit_touch_reorders_lru(tmp_path):
    t0 = 1_700_000_000.0
    cache = ec.ExecutableCache(str(tmp_path), log=_SILENT, max_entries=2,
                               max_bytes=1 << 30)
    k_old = _put(cache, "old", when=t0)
    k_mid = _put(cache, "mid", when=t0 + 10)
    k_new = _put(cache, "new", when=t0 + 20)
    assert cache.load(k_old) == b"x" * 64       # a hit touches it
    assert cache.gc() == 1
    assert [cache.backend.exists(k) for k in (k_old, k_mid, k_new)] == [
        True, False, True]


def test_delete_failure_never_blocks_a_store(tmp_path):
    """JAX ``test_store_path_triggers_gc_and_never_blocks``: a backend
    whose ``delete`` raises leaves the store done and counted."""
    class NoDelete(type(posix_backend())):
        def delete(self, key):
            raise OSError("delete refused")
    cache = ec.ExecutableCache(str(tmp_path), backend=NoDelete(),
                               log=_SILENT, max_entries=1)
    t0 = 1_700_000_000.0
    _put(cache, "stale", when=t0)
    key = cache.key_for("lib:x", "d")
    assert cache.store(key, b"payload") is True
    assert cache.stats["stores"] == 1 and cache.stats["evicted"] == 0
    assert cache.load(key) == b"payload"


# -- enablement -----------------------------------------------------------

class _Cfg:
    executable_cache = ""
    checkpoint_dir = ""


@pytest.mark.parametrize("spec,env,where", [
    ("", "", None), ("off", "", None), ("on", "", "ckpt"),
    ("DIR", "", "dir"), ("on", "0", None), ("", "on", "ckpt"),
    ("", "DIR", "dir")])
def test_build_executable_cache_gating(tmp_path, monkeypatch, spec, env,
                                       where):
    """JAX ``test_build_gating``: ``--executable_cache`` off / on / a
    directory, ``FDT_EXEC_CACHE`` overriding (``0`` the kill switch)."""
    cfg = _Cfg()
    cfg.checkpoint_dir = str(tmp_path / "ckpt")
    d = str(tmp_path / "explicit")
    cfg.executable_cache = d if spec == "DIR" else spec
    if env:
        monkeypatch.setenv(ec.ENV_CACHE, d if env == "DIR" else env)
    else:
        monkeypatch.delenv(ec.ENV_CACHE, raising=False)
    got = ec.build_executable_cache(cfg, log=_SILENT)
    want = {None: None, "ckpt": os.path.join(cfg.checkpoint_dir,
                                             "_exec_cache"),
            "dir": d}[where]
    assert (got.directory if got is not None else None) == want


def test_gc_runs_when_armed(tmp_path, monkeypatch):
    cache = ec.ExecutableCache(str(tmp_path / "_exec_cache"), log=_SILENT)
    t0 = 1_700_000_000.0
    for i in range(6):
        _put(cache, f"p{i}", when=t0 + i)
    cfg = _Cfg()
    cfg.executable_cache, cfg.checkpoint_dir = "on", str(tmp_path)
    monkeypatch.setenv(ec.ENV_MAX_ENTRIES, "4")
    armed = ec.build_executable_cache(cfg, log=_SILENT)
    assert len(armed.entries()) == 4


SMALL = dict(model="transformer", dataset="synthetic", num_classes=4,
             n_layers=1, d_model=16, n_heads=2, d_ff=32, seq_len=16,
             seq_buckets=(16,), precision="fp32", plot=False, device="cpu",
             executable_cache="on")


def _tree(**kw):
    """A seeded port model's parameters as the JAX-layout tree."""
    cfg = TrainConfig(**dict(SMALL, **kw))
    m = cli.build_model(cfg, vocab_size=100, device="cpu")
    m.init_weights(torch.Generator().manual_seed(0))
    return params_to_jax(m.state_dict(), 2)


def test_every_entry_point_arms_the_cache(tmp_path, monkeypatch):
    """``--executable_cache on`` takes effect in training, serving and
    decode serving (JAX ``cli.py:1126-1139``, ``:1383-1407``,
    ``:1538-1557``): each run arms the cache under its checkpoint
    directory on the observatory every program row of the run sees."""
    seen = []
    real = programs.ProgramObservatory.observe

    def spy(self, *a, **kw):
        seen.append((a[0], self.executable_cache))
        return real(self, *a, **kw)
    monkeypatch.setattr(programs.ProgramObservatory, "observe", spy)
    lines = []
    cli.run_training(TrainConfig(checkpoint_dir=str(tmp_path / "t"),
                                 batch_size=8, epochs=1, subset_stride=64,
                                 workers=0, **SMALL), log=lines.append)
    cli.run_serving(TrainConfig(checkpoint_dir=str(tmp_path / "c"),
                                serve_requests=2, serve_batch_size=2,
                                **SMALL),
                    params=_tree(), log=lines.append)
    d = tmp_path / "s"
    d.mkdir()
    np.savez(d / "transformer_params.npz", **flatten(_tree(task="lm")))
    cli.run_decode_serving(TrainConfig(checkpoint_dir=str(d), task="lm",
                                       decode_requests=2,
                                       decode_max_new_tokens=2,
                                       decode_batch_size=2, **SMALL),
                           log=lines.append)
    assert len([x for x in lines if x.startswith("[exec_cache]")]) == 3
    for sub in ("t", "c", "s"):
        assert os.path.isdir(tmp_path / sub / "_exec_cache"), sub
    names = {n for n, _c in seen}
    assert {"train:host:k1", "eval", "replica0:predict:L16",
            "decode0:prefill:L16", "decode0:decode:P1"} <= names, names
    assert all(c is not None for _n, c in seen)


def test_storage_routing_lint_finds_nothing_in_the_port_module():
    """JAX ``scripts/check_storage_routing.py::_banned_calls`` (imported,
    not edited) over the port's module: no rename or rmtree outside the
    storage backends (the ``_build/`` write is ``ops/_build.py``'s)."""
    spec = importlib.util.spec_from_file_location(
        "check_storage_routing",
        os.path.join(ROOT, "scripts", "check_storage_routing.py"))
    lint = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lint)
    assert lint._banned_calls(ec.__file__) == []
