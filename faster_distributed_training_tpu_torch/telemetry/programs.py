"""The program table, the train state's bytes on each card and the
placement-drift guard (the JAX package's ``telemetry/programs.py``).

**The program table.**  JAX observes every ``jit`` program at its
explicit ``lower()`` / ``compile()``.  The port has no compiler step a
program; what it builds, and a restart pays for again, are:

  * a CUDA graph: a ``FusedDispatch`` graph key (``train:{path}:k{K}``),
    a decode step a page count (``{name}:decode:P{pages}``); its
    ``lower_ms`` is the eager warm-up before the capture, its
    ``compile_ms`` the capture;
  * an eager program's first dispatch of one input signature (the K=1
    step ``train:host:k1``, ``eval``, ``epoch_reshard``,
    ``{name}:predict:L{bucket}``, ``{name}:prefill:L{bucket}``): cuBLAS
    and cuDNN set-up, the allocator's growth; ``lower_ms`` 0;
  * a kernel library (``lib:flash_fwd``, ... ``lib:fdt_native``,
    ``ops/_build.py`` and ``runtime/native_lib.py``): its ``compile_ms``
    is the compiler's seconds, or the load from the executable cache or
    the local ``_build/`` directory, and ``cache_source`` says which.

The caller times the work and :meth:`ProgramObservatory.observe` records
it (the one seam that stands for JAX's ``observe_compile``): a ``program``
event with exactly JAX's fields, the retrace detector's decisions (JAX's
three reasons, ``max_variants`` 8), and the acquisition billed to goodput
(``goodput.add_compile``), hit or miss.  A :class:`Stopwatch` times a
block less the libraries the same thread loaded inside it, which have
rows of their own.  A CUDA graph cannot leave its process: every process
captures anew, and its rows read ``cache`` ``off``.  The table goes into
``manifest.json`` at the run's end (``compile``; ``serve_compile`` and
``decode_compile`` for serving).  ``FDT_PROGRAM_OBS=0`` turns it off, and
the executable cache, which rides it, with it.

The process-global observatory (``set_observatory``, the spans idiom)
is what every seam reads: the Trainer, the dispatch, the resident
split's re-shard, the engines and the library loaders.

**The state's bytes.**  ``state_bytes_table(state)`` splits the bytes
this rank holds between ``params`` (the trainable leaves: the model's
parameters and ``extra``), ``opt_state`` (the optimizer's tensors) and
``batch_stats`` (the model's buffers: BatchNorm's running statistics,
the ``--quant`` amax histories), names the largest leaves, and gives each
optimizer leaf its tier from ``parallel/placement.py``: ``replicated`` (a
whole copy on every rank), ``sharded`` (cut over fsdp, zero1 or tp) or
``offloaded`` (parked in pinned host memory between steps).  The Trainer
emits it once, after the run's first dispatch, as the ``memory`` event of
scope ``state``.

**The drift guard.**  ``sharding_fingerprint(state)`` hashes each
leaf's device, dtype, shape, stride and tier, and, while a captured graph
reads the state, its storage address: a graph holds its addresses, so a
leaf whose storage was swapped instead of copied into would leave the
graph updating dead memory.  The Trainer fingerprints after the first
dispatch and checks at every epoch's end (``train/loop.py``).
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
import warnings
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

ENV_KILL = "FDT_PROGRAM_OBS"

# the process-global observatory (the spans.set_recorder idiom)
_ACTIVE = None
# {library name: build digest} of the kernel libraries this process
# loaded (every program's fingerprint names them)
_LIBRARIES: Dict[str, str] = {}
# per thread: the ms its library acquisitions took (a Stopwatch leaves
# them out of the program that triggered them)
_NESTED = threading.local()


def set_observatory(obs) -> Optional["ProgramObservatory"]:
    """Install the process-global observatory; returns the previous one
    for the caller to restore."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, obs
    return prev


def get_observatory() -> Optional["ProgramObservatory"]:
    return _ACTIVE


def observatory_enabled() -> bool:
    return os.environ.get(ENV_KILL, "1") != "0"


# -- signatures ------------------------------------------------------------

def _dtype_name(dtype) -> str:
    """numpy's name of a dtype (``torch.float32`` -> ``float32``)."""
    return str(dtype).replace("torch.", "")


def _leaf_sig(x) -> Tuple[tuple, str, bool]:
    """(shape, dtype, weak) of one argument leaf: a tensor's or an
    array's own; a Python scalar is "weak" (JAX's weak type, the leak
    the detector looks for when a scalar meets a tensor)."""
    if torch.is_tensor(x):
        return tuple(x.shape), _dtype_name(x.dtype), False
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return tuple(shape), _dtype_name(dtype), False
    import numpy as np

    a = np.asarray(x)
    return (tuple(a.shape), str(a.dtype),
            isinstance(x, (bool, int, float, complex)))


def _flatten(x, leaves: list) -> str:
    """JAX's tree flattening (dict keys sorted, None an empty node):
    appends the leaves, returns the structure as text."""
    if isinstance(x, dict):
        return "{" + ",".join(f"{k}:{_flatten(x[k], leaves)}"
                              for k in sorted(x)) + "}"
    if isinstance(x, (list, tuple)):
        inner = ",".join(_flatten(v, leaves) for v in x)
        return f"[{inner}]" if isinstance(x, list) else f"({inner})"
    if x is None:
        return "None"
    leaves.append(x)
    return "*"


def args_signature(args, argnums) -> tuple:
    """Hashable signature of the positional ``args`` at ``argnums``: tree
    structure and per-leaf (shape, dtype, weak)."""
    parts = []
    for i in argnums:
        leaves: list = []
        treedef = _flatten(args[i], leaves)
        parts.append((treedef, tuple(_leaf_sig(x) for x in leaves)))
    return tuple(parts)


def _sig_shapes(sig) -> tuple:
    """The shape-only projection of a signature: equal shapes with
    unequal dtypes or weak flags are the scalar-leak retrace."""
    return tuple((treedef, tuple(s[0] for s in leaf_sigs))
                 for treedef, leaf_sigs in sig)


def _sig_text(sig, limit: Optional[int] = 240) -> str:
    """Compact readable avals of a signature."""
    bits = []
    for _treedef, leaf_sigs in sig:
        for shape, dtype, weak in leaf_sigs:
            bits.append(f"{dtype}{list(shape)}" + ("w" if weak else ""))
    txt = ",".join(bits)
    return txt if limit is None or len(txt) <= limit else txt[:limit] + "..."


def program_fingerprint(sig) -> str:
    """sha256 of (the signature's text | the loaded libraries' digests |
    the torch version), 16 hex characters: a graph or an eager program is
    what its inputs' avals, the kernels it can call and torch make it."""
    libs = ",".join(f"{k}={v}" for k, v in sorted(_LIBRARIES.items()))
    text = f"{_sig_text(sig, limit=None) if sig else ''}|{libs}|" \
           f"{torch.__version__}"
    return hashlib.sha256(text.encode()).hexdigest()[:16]


# -- timing ----------------------------------------------------------------

def _nested_ms() -> float:
    return getattr(_NESTED, "ms", 0.0)


def tensor_bytes(*trees) -> int:
    """Bytes of every tensor in ``trees`` (dicts, lists, tuples, tensors;
    other leaves count 0)."""
    leaves: list = []
    for t in trees:
        _flatten(t, leaves)
    return int(sum(x.numel() * x.element_size() for x in leaves
                   if torch.is_tensor(x)))


def pool_bytes(device, pool) -> int:
    """The reserved bytes of CUDA graph memory pool ``pool`` (a
    ``torch.cuda.graph_pool_handle()``) on ``device``: its segments in
    the allocator's snapshot."""
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return int(sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if seg.get("device") == idx
                   and tuple(seg.get("segment_pool_id", ())) == tuple(pool)))


class Stopwatch:
    """Host ms of a block, less the library acquisitions the same thread
    made inside it (their rows count them); on a card also the program's
    ``temp_bytes``: the growth of graph pool ``pool``'s reserved bytes
    (a capture's), or without a pool of the allocator's reserved bytes
    (an eager program's first dispatch: 0 when the cache already held
    enough)."""

    def __init__(self, device=None, pool=None):
        dev = torch.device(device) if device is not None else None
        self.cuda = dev is not None and dev.type == "cuda"
        self.device = dev
        self.pool = pool if self.cuda else None
        self.reserved0 = self._reserved()
        self.nested0 = _nested_ms()
        self.t0 = time.monotonic()

    def _reserved(self) -> int:
        if not self.cuda:
            return 0
        if self.pool is not None:
            return pool_bytes(self.device, self.pool)
        return torch.cuda.memory_reserved(self.device)

    def ms(self) -> float:
        return max((time.monotonic() - self.t0) * 1e3
                   - (_nested_ms() - self.nested0), 0.0)

    def memory(self, argument: int = 0, output: int = 0,
               alias: int = 0) -> Optional[Dict[str, int]]:
        """The ``program`` event's byte fields on a card; None on the CPU
        (no pool: JAX leaves them out when ``memory_analysis`` is None).
        ``argument``: what the body reads from outside its pool;
        ``output``: its result buffers; ``alias``: state updated in
        place."""
        if not self.cuda:
            return None
        grown = self._reserved() - self.reserved0
        return {"argument_bytes": int(argument), "output_bytes": int(output),
                "temp_bytes": int(max(grown, 0)),
                "generated_code_bytes": 0, "alias_bytes": int(alias)}


def library_loaded(name: str, digest: str, path: str, ms: float,
                   source: str, cache_armed: bool) -> None:
    """A kernel library's acquisition (``ops/_build.py``,
    ``runtime/native_lib.py``): its digest joins every later program's
    fingerprint, its ms leave the enclosing Stopwatch, and the active
    observatory records its ``lib:<name>`` row.  ``source``:
    ``persistent_dir`` (the local ``_build/`` held it), ``deserialized``
    (the executable cache served it) or ``compiled``."""
    _LIBRARIES[name] = digest
    _NESTED.ms = _nested_ms() + ms
    obs = get_observatory()
    if obs is None:
        return
    if source == "compiled":
        cache, method = "miss", ("executable_cache" if cache_armed
                                 else "dir_stat")
    elif source == "deserialized":
        cache, method = "hit", "executable_cache"
    else:
        cache, method = "hit", "dir_stat"
    try:
        size = os.path.getsize(path)
    except OSError:
        size = 0
    obs.observe(f"lib:{name}", None, compile_ms=ms, fingerprint=digest,
                cache=cache, method=method, source=source,
                mem={"generated_code_bytes": int(size)})


# -- the observatory ---------------------------------------------------------

class ProgramObservatory:
    """The run's program table.  Thread-safe (a replica's worker thread
    warms its bucket while another serves).

    ``recorder`` (a TelemetryRecorder, optional) receives one ``program``
    event a lowering and one ``retrace`` event a detection;
    :meth:`summary` is the table the run's manifest gets.  Attributes set
    after construction by the entry points: ``executable_cache`` (the
    libraries' load-before-build / store-after-build tier,
    ``resilience/executable_cache.py``) and ``goodput`` (billed every
    acquisition; what was recorded before it was set is billed when it
    is)."""

    def __init__(self, recorder=None, log: Callable[[str], None] = print,
                 max_variants: int = 8):
        self.recorder = recorder
        self._log = log
        self.max_variants = int(max_variants)
        self._lock = threading.Lock()
        # name -> [entry dicts in lowering order]; private keys ("_sig",
        # "_replays") stay out of events and the summary
        self.programs: Dict[str, List[dict]] = {}
        self.retraces: List[dict] = []
        self._variant_flood_warned: set = set()
        self.executable_cache = None
        self._goodput = None
        self._acquired_s = 0.0

    @property
    def goodput(self):
        return self._goodput

    @goodput.setter
    def goodput(self, tracker) -> None:
        self._goodput = tracker
        if tracker is not None and self._acquired_s:
            tracker.add_compile(self._acquired_s)

    def observe(self, name: str, sig=None, lower_ms: float = 0.0,
                compile_ms: float = 0.0, fingerprint: Optional[str] = None,
                cache: str = "off", method: str = "none",
                source: str = "compiled", mem: Optional[dict] = None,
                replays: Optional[Callable[[], int]] = None) -> dict:
        """Record one lowering of program ``name`` the caller timed:
        ``lower_ms`` (a graph's eager warm-up), ``compile_ms`` (the
        capture, the first dispatch, the build or the load), the
        signature ``sig`` (``args_signature``), the memory fields ``mem``
        (``Stopwatch.memory``), ``replays`` (a graph's replay count, read
        by ``summary``).  Bills goodput; returns the entry."""
        if fingerprint is None:
            fingerprint = program_fingerprint(sig)
        acquired = (lower_ms + compile_ms) / 1e3
        with self._lock:
            self._acquired_s += acquired
        if self._goodput is not None:
            self._goodput.add_compile(acquired)
        return self._record(name, sig, lower_ms, compile_ms, fingerprint,
                            cache, method, mem, source, replays)

    def _record(self, name, sig, lower_ms, compile_ms, fingerprint,
                cache, method, mem, source: str = "compiled",
                replays=None) -> dict:
        with self._lock:
            entries = self.programs.setdefault(name, [])
            self._detect_retrace(name, entries, sig)
            entry = {"variant": len(entries),
                     "compile_ms": round(compile_ms, 2),
                     "lower_ms": round(lower_ms, 2),
                     "fingerprint": fingerprint,
                     "cache": cache, "cache_method": method,
                     "cache_source": source,
                     "avals": _sig_text(sig) if sig else "",
                     "_sig": sig, "_replays": replays}
            if mem:
                entry.update(mem)
            entries.append(entry)
        if self.recorder is not None:
            ev = {"name": name, "lowerings": len(entries),
                  "variant": entry["variant"],
                  "compile_ms": entry["compile_ms"],
                  "lower_ms": entry["lower_ms"],
                  "fingerprint": entry["fingerprint"],
                  "cache": entry["cache"],
                  "cache_method": entry["cache_method"],
                  "cache_source": entry["cache_source"],
                  "avals": entry["avals"]}
            if mem:
                ev.update(mem)
            self.recorder.record_event("program", **ev)
        return entry

    def _detect_retrace(self, name, entries, sig) -> None:
        """Under the lock, before the new entry lands: JAX's three
        accidental-retrace classes (a lowering with the same avals, one
        whose avals differ only in dtype or weak type, more than
        ``max_variants`` lowerings); shape variants pass silently."""
        reason = None
        prev = None
        if sig is not None:
            for e in entries:
                if e["_sig"] == sig:
                    reason, prev = "duplicate-avals", e
                    break
                if (e["_sig"] is not None
                        and _sig_shapes(e["_sig"]) == _sig_shapes(sig)):
                    reason, prev = "dtype-or-weak-type-leak", e
                    break
        if (reason is None and len(entries) + 1 > self.max_variants
                and name not in self._variant_flood_warned):
            self._variant_flood_warned.add(name)
            reason = "variant-flood"
        if reason is None:
            return
        msg = (f"program {name!r} re-traced ({reason}): lowering "
               f"#{len(entries) + 1}, avals "
               f"[{_sig_text(sig) if sig else '?'}]"
               + (f" vs prior [{prev['avals']}]" if prev else "")
               + " — an accidental retrace re-pays the whole build "
                 "(check for a Python scalar or a shape leak)")
        warnings.warn(msg, stacklevel=4)
        self._log(f"[programs] WARNING: {msg}")
        ev = {"name": name, "reason": reason,
              "lowerings": len(entries) + 1,
              "avals": _sig_text(sig) if sig else "",
              "prev_avals": prev["avals"] if prev else ""}
        self.retraces.append(ev)
        if self.recorder is not None:
            self.recorder.record_event("retrace", **ev)

    def summary(self) -> dict:
        """The manifest's table: per program name its lowerings and every
        variant's record (a graph's with its ``replays``), the retraces,
        ``total_compile_ms`` (JAX's: the compile_ms column) and
        ``total_acquisition_ms`` (lower + compile, what goodput is
        billed)."""
        with self._lock:
            progs = []
            total_ms = 0.0
            for name, entries in sorted(self.programs.items()):
                variants = []
                for e in entries:
                    v = {k: x for k, x in e.items() if not k.startswith("_")}
                    if e["_replays"] is not None:
                        v["replays"] = int(e["_replays"]())
                    variants.append(v)
                total_ms += sum(e["compile_ms"] for e in entries)
                progs.append({"name": name, "lowerings": len(entries),
                              "variants": variants})
            return {"programs": progs,
                    "retraces": list(self.retraces),
                    "total_compile_ms": round(total_ms, 1),
                    "total_acquisition_ms": round(self._acquired_s * 1e3, 3)}


# the state table's fields (the schema lint resolves the
# record_event("memory", **state_bytes_table(...)) splat through them)
STATE_MEMORY_FIELDS = (
    "scope", "params_bytes_per_chip", "params_leaves",
    "opt_state_bytes_per_chip", "opt_state_leaves",
    "batch_stats_bytes_per_chip", "batch_stats_leaves",
    "total_bytes_per_chip", "top_leaves", "opt_state_tiers",
    "pp_residency")


def leaf_bytes_per_chip(leaf) -> int:
    """Bytes this rank holds for ``leaf``: a tensor's storage as it rests
    (a shard when it is cut), 0 for a host scalar."""
    if torch.is_tensor(leaf):
        return int(leaf.numel() * leaf.element_size())
    return 0


def leaf_tier(entry) -> str:
    """The tier of one leaf from its entry of ``Placement.table`` (None:
    no placement, one process): ``offloaded`` (in host memory between
    steps), ``sharded`` (cut along a dim, or a tp cut) or
    ``replicated``."""
    if entry is None:
        return "replicated"
    if entry.get("host"):
        return "offloaded"
    if entry.get("dim") is not None or entry.get("tp") is not None:
        return "sharded"
    return "replicated"


def _opt_tensors(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _opt_tensors(v, path + (str(k),))
        elif torch.is_tensor(v):
            yield path + (str(k),), v


def _rest(state, name: str, p: torch.Tensor):
    """The storage a parameter rests in between steps: the placement's
    parked copy when it has one, else the parameter."""
    pl = state.placement
    rest = getattr(pl, "rest", None) if pl is not None else None
    if rest and name in rest:
        return rest[name]
    return p.detach()


def state_bytes_table(state, top: int = 5) -> dict:
    """This rank's bytes of a ``TrainState`` split params / opt_state /
    batch_stats, with the ``top`` largest leaves and their tiers, the
    optimizer leaves by tier, and the pp residency (the leaves a stage
    owns and their bytes; zeros off pp or with ``--no_pp_residency``)."""
    pl = state.placement
    table = pl.table(state) if pl is not None else {}
    homes = getattr(pl, "homes", {}) if pl is not None else {}
    residency = bool(getattr(pl, "residency", False))
    groups: Dict[str, List[Tuple[str, object, object, bool]]] = {
        "params": [], "opt_state": [], "batch_stats": []}
    for name, p in state.params().items():
        groups["params"].append(
            (name, _rest(state, name, p), table.get(f"params/{name}"),
             residency and homes.get(name) is not None))
    for path, t in _opt_tensors(state.opt_state):
        key = "/".join(path)
        groups["opt_state"].append(
            (key, t, table.get(f"opt/{key}"),
             residency and homes.get(path[-1]) is not None))
    for name, b in state.model.named_buffers():
        groups["batch_stats"].append(
            (name, b, None, residency and homes.get(name) is not None))
    out: dict = {"scope": "state"}
    sized = []
    total = 0
    tiers: Dict[str, Dict[str, int]] = {}
    ppres: Dict[str, Dict[str, int]] = {}
    for group, leaves in groups.items():
        b = pp_leaves = pp_bytes = 0
        for name, t, entry, staged in leaves:
            n = leaf_bytes_per_chip(t)
            b += n
            tier = leaf_tier(entry)
            sized.append((n, f"{group}/{name}", tier))
            if staged:
                pp_leaves += 1
                pp_bytes += n
            if group == "opt_state":
                agg = tiers.setdefault(tier, {"leaves": 0,
                                              "bytes_per_chip": 0})
                agg["leaves"] += 1
                agg["bytes_per_chip"] += n
        out[f"{group}_bytes_per_chip"] = b
        out[f"{group}_leaves"] = len(leaves)
        ppres[group] = {"leaves": pp_leaves, "bytes_per_chip": pp_bytes}
        total += b
    out["total_bytes_per_chip"] = total
    out["top_leaves"] = [
        {"path": p, "bytes_per_chip": n, "tier": t}
        for n, p, t in sorted(sized, reverse=True)[:top]]
    out["opt_state_tiers"] = tiers
    out["pp_residency"] = ppres
    return out


# -- the placement-drift guard ---------------------------------------------

def state_tensors(state) -> Iterator[Tuple[str, torch.Tensor, object]]:
    """(path, tensor, placement entry) of every tensor leaf of a
    ``TrainState``, the host counters aside: the parameters as they rest
    between steps, the model's buffers, ``extra``, the optimizer's
    tensors and the loss scale.  Reads metadata only (no host read, no
    settle of the applied count)."""
    pl = state.placement
    table = pl.table(state) if pl is not None else {}
    params = state.params()
    for name, p in params.items():
        yield f"params/{name}", _rest(state, name, p), table.get(
            f"params/{name}")
    for name, b in state.model.named_buffers():
        yield f"batch_stats/{name}", b, None
    for path, t in _opt_tensors(state.opt_state):
        key = "/".join(path)
        yield f"opt_state/{key}", t, table.get(f"opt/{key}")
    ls = state.loss_scale
    if ls is not None:
        for name in ("scale", "growth_count"):
            t = getattr(ls, name, None)
            if torch.is_tensor(t):
                yield f"loss_scale/{name}", t, None


def state_bytes(state) -> int:
    """Bytes of every tensor leaf of the state (``state_tensors``)."""
    return int(sum(leaf_bytes_per_chip(t) for _, t, _ in state_tensors(state)))


def sharding_table(state, addresses: bool = False) -> Dict[str, str]:
    """{leaf path: placement descriptor} over the train state: device,
    dtype, shape, stride and tier (``leaf_tier``), and with
    ``addresses`` (a captured graph reads the state) the storage address.
    The debug side of the drift guard: a drift names its leaves."""
    out = {}
    for path, t, entry in state_tensors(state):
        desc = (f"{t.device}|{_dtype_name(t.dtype)}|{tuple(t.shape)}|"
                f"{tuple(t.stride())}|{leaf_tier(entry)}")
        if addresses:
            desc += f"|@{t.data_ptr():x}"
        out[path] = desc
    return out


def sharding_fingerprint(state, addresses: bool = False) -> str:
    """Cheap always-on hash of ``sharding_table``: taken after the run's
    first dispatch and checked at every epoch's end by the Trainer."""
    h = hashlib.sha1()
    for path, desc in sorted(sharding_table(state, addresses).items()):
        h.update(path.encode())
        h.update(desc.encode())
    return h.hexdigest()[:16]
