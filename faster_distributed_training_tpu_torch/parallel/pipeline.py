"""Pipeline parallelism over the pp mesh axis (the JAX package's
``parallel/pipeline.py``): the rule table, the tick cadence and the
executor.

The pure pieces are the JAX module's, copied and held equal to it by the
tests: ``PipelineSpec``, ``partition_stages`` (contiguous 1F1B stages, or
the v=2 interleaved assignment), ``virtual_chunks`` (the depth-ordered
chunks a microbatch walks), ``bubble_fraction``, ``schedule_ticks``,
``stage_idle_ticks``, ``resolve_microbatches``, ``param_stage_home`` (the
stage a leaf lives on), ``build_pipeline_spec`` (with JAX's refusals: a
model with no staged form, ``--quant`` with ``--remat``) and the rule
table ``pipeline_rules``.

JAX runs the pipeline as one SPMD program: a ``[V, B/M, L, d]`` stage
buffer sharded over pp rotates once a tick and every slot is applied,
the fill and drain slots on recycled data whose outputs are discarded;
``jax.grad`` through the rotation is the reversed backward.  The port
runs one process a stage (``run_pipeline``):

  * rank s holds stage s's layers (chunk j of ``virtual_chunks`` on stage
    ``j % S``); at tick t it runs only its real (chunk j, microbatch
    t - j) slots, on the activation ``[B_l/M, L, d]`` that the stage of
    chunk j - 1 sent at the end of tick t - 1, and sends its output to
    the stage of chunk j + 1 (under ``interleaved`` the hop from chunk
    S - 1 to chunk S wraps from the last rank to rank 0).  A tick's sends
    and receives are posted together (``PipeGroup.exchange``): with the
    ring closed, blocking sends on both ends would deadlock;
  * stage 0 builds the embeddings (and the encodings dropout) of its
    local batch once and cuts them into the M microbatches; the last
    stage reassembles the local batch and runs the head and the loss on
    it (mixup couples the microbatches, so all M forwards come before
    the backward, as in JAX's program);
  * the backward replays the ticks in reverse: each slot's
    ``torch.autograd.backward`` takes its output's cotangent from the
    next chunk's stage and sends its input's to the previous one; the
    parameters' gradients accumulate over the microbatches; stage 0 runs
    the embeddings' backward once on the reassembled cotangent;
  * bubble slots are computed nowhere: in JAX their outputs are
    discarded and their cotangents are zero, so the values are the same.

``PipelineTickCtx`` is the JAX ``PipelineTickCtx``'s amax cadence:
every microbatch quantizes at the pre-step scale, the first call of a
step rolls the history, later calls MAX their amax into slot 0, so the
history after the step is pp=1's bitwise (``ops.quant.QuantDense`` and
the fused FFN read it through ``current_tick``).  The rest of JAX's
context needs no counterpart: a step's draws are explicit, so the
dropout seeds are fixed for the step, each microbatch of a chunk reading
the chunk's seeds from their place in the model's call order
(``Transformer.seed_positions``); and the caller's ``chunk(j, x, m)``
gives microbatch m its global origin (the data rank's origin plus m ·
B_l/M, ``Transformer.seed_stream``), so every dropout site draws pp=1's
stream at the microbatch's global rows, flash and the fused FFN
included: their kernels take the origin.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Callable, Optional, Sequence, Tuple

import torch

SCHEDULES = ("1f1b", "interleaved")

_LAYER_RE = re.compile(r"(?:^|/)layer_(\d+)(?:/|$)")

# markers of the leaves applied after the staged region (the head)
_HEAD_MARKERS = ("ln_final", "pooler", "cls_", "lm_head")


def param_stage_home(spec: "PipelineSpec", flat_name: str
                     ) -> Tuple[str, Optional[int]]:
    """(role, stage) for a '/'-joined JAX param path (the port's names go
    through ``sharding.jax_param_path``): ``('stage_owned', s)`` under
    ``layer_{i}`` with i on stage s; ``('shared_embed', 0)`` for the
    embedding tables (stage 0's input, and the tied LM head's table on
    the last stage); ``('shared_head', S - 1)`` for ln_final, the pooler,
    the classifier and the LM head; ``('unknown', None)`` otherwise."""
    low = flat_name.lower()
    m = _LAYER_RE.search(low)
    if m:
        li = int(m.group(1))
        for s, layers in enumerate(spec.stage_layers):
            if li in layers:
                return "stage_owned", s
        return "unknown", None
    if "embedding" in low:
        return "shared_embed", 0
    if any(mk in low for mk in _HEAD_MARKERS):
        return "shared_head", spec.n_stages - 1
    return "unknown", None


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """Static description of one pipelined encoder."""
    n_layers: int
    n_stages: int
    n_microbatches: int
    stage_layers: Tuple[Tuple[int, ...], ...]   # layer indices per stage
    schedule: str = "1f1b"

    @property
    def n_virtual(self) -> int:
        """V: the depth-ordered chunks (S under 1f1b, 2S interleaved)."""
        return len(virtual_chunks(self))

    @property
    def n_ticks(self) -> int:
        return self.n_microbatches + self.n_virtual - 1

    @property
    def bubble_pct(self) -> float:
        return 100.0 * bubble_fraction(self.n_virtual, self.n_microbatches)


def partition_stages(n_layers: int, n_stages: int, schedule: str = "1f1b"
                     ) -> Tuple[Tuple[int, ...], ...]:
    """Layer indices per stage: contiguous balanced blocks, earlier stages
    taking the extra layer ("1f1b"); or chunks of L / 2S dealt round-robin
    ("interleaved", when 2S divides L; the contiguous split otherwise)."""
    if not 1 <= n_stages <= n_layers:
        raise ValueError(f"cannot split {n_layers} layers into "
                         f"{n_stages} pipeline stages")
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r} "
                         f"(one of {SCHEDULES})")
    if schedule == "interleaved" and n_layers % (2 * n_stages) == 0:
        chunk = n_layers // (n_stages * 2)
        chunks = [tuple(range(i, i + chunk))
                  for i in range(0, n_layers, chunk)]
        out = [[] for _ in range(n_stages)]
        for idx, ch in enumerate(chunks):
            out[idx % n_stages].extend(ch)
        return tuple(tuple(s) for s in out)
    base, extra = divmod(n_layers, n_stages)
    bounds, lo = [], 0
    for s in range(n_stages):
        hi = lo + base + (1 if s < extra else 0)
        bounds.append(tuple(range(lo, hi)))
        lo = hi
    return tuple(bounds)


def virtual_chunks(spec: PipelineSpec) -> Tuple[Tuple[int, ...], ...]:
    """The maximal runs of consecutive layers of each stage, ordered by
    first layer: chunk j (on stage j % S) walks every microbatch through
    layers 0..L-1 in depth order under every schedule."""
    runs = []
    for layers in spec.stage_layers:
        start = 0
        for k in range(1, len(layers) + 1):
            if k == len(layers) or layers[k] != layers[k - 1] + 1:
                runs.append(tuple(layers[start:k]))
                start = k
    runs.sort(key=lambda r: r[0])
    flat = [i for r in runs for i in r]
    if flat != sorted(flat):
        raise ValueError(f"stage assignment {spec.stage_layers} has "
                         f"overlapping depth runs — no depth-ordered "
                         f"traversal exists")
    return tuple(runs)


def bubble_fraction(n_slots: int, n_microbatches: int) -> float:
    """(V - 1) / (M + V - 1): the idle share of a slot's ticks."""
    if n_slots <= 1:
        return 0.0
    return (n_slots - 1) / float(n_microbatches + n_slots - 1)


def schedule_ticks(n_stages: int, n_microbatches: int
                   ) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """Per tick, the active (stage, microbatch) pairs: stage s runs
    microbatch t - s when 0 <= t - s < M."""
    out = []
    for t in range(n_microbatches + n_stages - 1):
        out.append(tuple((s, t - s) for s in range(n_stages)
                         if 0 <= t - s < n_microbatches))
    return tuple(out)


def stage_idle_ticks(spec: PipelineSpec) -> Tuple[int, ...]:
    """Bubble slot-ticks per stage: (V/S)(V - 1)."""
    slots_per_stage = spec.n_virtual // spec.n_stages
    return tuple(slots_per_stage * (spec.n_ticks - spec.n_microbatches)
                 for _ in range(spec.n_stages))


def resolve_microbatches(batch_size: int, n_stages: int,
                         requested: int = 0) -> int:
    """M for a global batch: ``requested`` when given (in [1, batch] and
    dividing it), else the largest divisor of the batch in [S, 2S], else
    the largest one up to S."""
    if requested:
        if not 1 <= requested <= batch_size:
            raise ValueError(
                f"--pp_microbatches {requested} must be in "
                f"[1, batch_size={batch_size}]")
        if batch_size % requested:
            raise ValueError(
                f"--pp_microbatches {requested} does not divide the "
                f"global batch {batch_size}")
        return requested
    for m in range(2 * n_stages, n_stages - 1, -1):
        if m and batch_size % m == 0:
            return m
    for m in range(min(n_stages, batch_size), 0, -1):
        if batch_size % m == 0:
            return m
    return 1


def _stages(mesh) -> int:
    """The pp size of ``mesh``: a ``DeviceMesh``, ``(axes, shape)`` as
    ``--mesh`` gives them, a stage count, or None."""
    from faster_distributed_training_tpu_torch.parallel.mesh import (
        canonical_axes, pp_size)

    if mesh is None:
        return 1
    if isinstance(mesh, int):
        return mesh
    if isinstance(mesh, tuple):
        sizes = dict(zip(canonical_axes(mesh[0]), mesh[1]))
        return int(sizes.get("pp", 1))
    return pp_size(mesh)


def build_pipeline_spec(cfg, mesh) -> Optional[PipelineSpec]:
    """The spec for ``cfg`` on ``mesh`` (see ``_stages``), or None without
    a pp axis above 1.  Refuses a model with no staged form and
    ``--quant`` with ``--remat`` (JAX's ValueErrors).  M comes from the
    global batch (``resolve_microbatches``)."""
    stages = _stages(mesh)
    if stages <= 1:
        return None
    if cfg.model != "transformer":
        raise ValueError(
            f"--mesh with pp={stages}: pipeline parallelism stages the "
            f"transformer encoder; model {cfg.model!r} has no staged "
            f"form")
    remat = bool(getattr(cfg, "remat", False))
    if getattr(cfg, "quant", "none") not in (None, "", "none") and remat:
        raise ValueError(
            f"--quant with pp={stages} and --remat: the per-step amax "
            f"cadence that makes delayed scaling match pp=1 cannot "
            f"cross nn.remat's per-tick checkpoint traces; drop --remat "
            f"on pp meshes with quant, or train unquantized")
    schedule = getattr(cfg, "pp_schedule", "1f1b") or "1f1b"
    m = resolve_microbatches(cfg.batch_size, stages,
                             int(getattr(cfg, "pp_microbatches", 0) or 0))
    return PipelineSpec(
        n_layers=cfg.n_layers, n_stages=stages, n_microbatches=m,
        stage_layers=partition_stages(cfg.n_layers, stages, schedule),
        schedule=schedule)


def pipeline_rules(spec: Optional[PipelineSpec], cfg=None) -> dict:
    """The rule table (JAX's keys and counts, the port's placement and
    residency strings): stages, microbatches, ticks, bubble, depth
    order, residency.  ``--debug`` logs it."""
    if spec is None:
        return {"enabled": False, "n_stages": 1}
    return {
        "enabled": True,
        "schedule": spec.schedule,
        "n_stages": spec.n_stages,
        "n_layers": spec.n_layers,
        "n_microbatches": spec.n_microbatches,
        "n_virtual_stages": spec.n_virtual,
        "n_ticks": spec.n_ticks,
        "bubble_pct": round(spec.bubble_pct, 3),
        "stage_idle_ticks": list(stage_idle_ticks(spec)),
        "depth_order": [[f"layer_{i}" for i in ch]
                        for ch in virtual_chunks(spec)],
        "stages": [
            {"stage": s,
             "layers": [f"layer_{i}" for i in layers],
             "extra": (["embeddings"] if s == 0 else [])
             + (["ln_final", "head"] if s == spec.n_stages - 1 else [])}
            for s, layers in enumerate(spec.stage_layers)],
        "activation_placement":
            "one process a pp stage; a microbatch's [B_l/M, L, d] "
            "activation on the rank of its chunk",
        "boundary_collective":
            "send / receive between the ranks of neighbouring chunks, a "
            "tick's posted together (batch_isend_irecv)",
        "param_residency": _param_residency_rules(spec, cfg),
        "batch_axes": "dp/fsdp only (pp never shards the batch)",
    }


def _param_residency_rules(spec: PipelineSpec, cfg=None) -> dict:
    """The residency block of the rule table: which leaf roles live on
    their stage, which are replicated and why (the port's, JAX's keys),
    and each layer's stage."""
    from faster_distributed_training_tpu_torch.parallel.sharding import (
        PP_RESIDENCY_RULES, REPLICATED_PP_PARAMS)
    enabled = (bool(getattr(cfg, "pp_residency", True)) if cfg is not None
               else True)
    return {
        "enabled": enabled,
        "axis": "pp",
        "sharded": dict(PP_RESIDENCY_RULES) if enabled else {},
        "replicated": (dict(REPLICATED_PP_PARAMS) if enabled else {
            "all": "--no_pp_residency: every rank holds every leaf and "
                   "its optimizer state; every gradient is SUMmed over "
                   "pp (zero off its stage)"}),
        "stage_home": {
            **{f"layer_{i}": s
               for s, layers in enumerate(spec.stage_layers)
               for i in layers},
            "embeddings": 0,
            "head": spec.n_stages - 1,
        },
    }


# -- the tick cadence --------------------------------------------------------

_TICK = threading.local()


def current_tick() -> Optional["PipelineTickCtx"]:
    """The cadence of the staged forward running on this thread, or None
    (no pipeline: every site rolls its history as at pp=1)."""
    return getattr(_TICK, "ctx", None)


class PipelineTickCtx:
    """The delayed-scaling amax cadence the staged forward threads
    through the quantized sites (JAX ``PipelineTickCtx``'s).  A fresh one
    a step; ``active()`` makes it the thread's for a ``with`` block."""

    def __init__(self):
        self._amax_rolled: set = set()
        self._amax_pre: dict = {}

    @contextlib.contextmanager
    def active(self):
        prev = current_tick()
        _TICK.ctx = self
        try:
            yield self
        finally:
            _TICK.ctx = prev

    def amax_pre(self, site, hist: torch.Tensor) -> torch.Tensor:
        """The site's pre-step history (a copy stashed at first touch):
        every microbatch's scale comes from it."""
        if site not in self._amax_pre:
            self._amax_pre[site] = hist.detach().clone()
        return self._amax_pre[site]

    def amax_push(self, site, hist: torch.Tensor, amax) -> torch.Tensor:
        """One roll a step, in place on ``hist``: the first push rolls the
        pre-step history with ``amax``, later pushes MAX ``amax`` into
        slot 0 (the port runs no bubble slot, whose push JAX skips).
        Returns ``hist``."""
        from faster_distributed_training_tpu_torch.ops.quant import (
            update_amax_history)

        amax = torch.as_tensor(amax, dtype=hist.dtype, device=hist.device)
        with torch.no_grad():
            if site in self._amax_rolled:
                hist[0] = torch.maximum(hist[0], amax)
            else:
                self._amax_rolled.add(site)
                hist.copy_(update_amax_history(self.amax_pre(site, hist),
                                               amax))
        return hist


# -- the executor ------------------------------------------------------------

def _slots(ticks, n_stages: int, stage: int, t: int):
    """(chunk, microbatch) this stage runs at tick ``t``, chunks rising:
    its chunks' pairs of ``ticks`` (``schedule_ticks`` over the V chunks,
    chunk j on stage j % S)."""
    return [(j, m) for j, m in ticks[t] if j % n_stages == stage]


def run_pipeline(spec: PipelineSpec, pipe, n_microbatches: int,
                 act_shape: Sequence[int], dtype, device,
                 embed: Optional[Callable[[], torch.Tensor]],
                 chunk: Callable[[int, torch.Tensor, int], torch.Tensor],
                 head: Callable[[torch.Tensor], tuple],
                 train: bool, tick: Optional[PipelineTickCtx] = None,
                 wait_s: Optional[list] = None):
    """One staged forward (and, with ``train``, its backward) of a local
    batch on this rank's stage of ``pipe`` (a ``PipeGroup``).

    ``embed()`` (stage 0): the local batch's encoder input ``[B_l, L,
    d]``, with its graph; ``chunk(j, x, m)``: chunk j's layers on
    microbatch m's activation ``x`` (``act_shape``, ``dtype``);
    ``head(h)`` (the last stage): on the reassembled ``[B_l, L, d]``
    output (a leaf that requires grad in training) returns ``(loss,
    result)``; ``loss`` (None at eval) is differentiated.  ``tick``:
    the step's amax cadence, active over the forward.  ``wait_s``: a list the seconds spent in the
    stage boundary's exchanges are appended to.  Returns ``head``'s
    ``result`` on the last stage, None elsewhere."""
    import time

    S, V, M = spec.n_stages, spec.n_virtual, int(n_microbatches)
    s = pipe.stage if pipe is not None else 0
    last = s == S - 1
    T = M + V - 1
    ticks = schedule_ticks(V, M)
    act_shape = tuple(int(n) for n in act_shape)

    def exchange(sends, recvs):
        t0 = time.perf_counter()
        got = pipe.exchange(sends, recvs, act_shape, dtype, device)
        if wait_s is not None:
            wait_s.append(time.perf_counter() - t0)
        return got

    firsts = None
    h0 = None
    if s == 0:
        h0 = embed()
        firsts = list(h0.detach().split(act_shape[0]))
        if len(firsts) != M:
            raise ValueError(f"{h0.shape[0]} rows do not cut into {M} "
                             f"microbatches of {act_shape[0]}")
    saved = {}
    pending = []
    ctx = tick.active() if tick is not None else contextlib.nullcontext()
    with ctx, torch.set_grad_enabled(train):
        for t in range(T):
            mine = _slots(ticks, S, s, t)
            want = [(j, m) for j, m in mine if j > 0]
            got = exchange([((j + 1) % S, z, j + 1) for j, z in pending],
                           [((j - 1) % S, j) for j, _ in want]) \
                if (pending or want) else []
            inputs = dict(zip(want, got))
            pending = []
            for j, m in mine:
                x = firsts[m] if j == 0 else inputs[(j, m)]
                if train:
                    x = x.detach().requires_grad_()
                z = chunk(j, x, m)
                saved[(j, m)] = (x, z)
                if j < V - 1:
                    pending.append((j, z.detach()))
    result, outs = None, None
    if last:
        outs = [saved[(V - 1, m)][1] for m in range(M)]
        h = torch.cat([o.detach() for o in outs])
        if train:
            h.requires_grad_()
        with torch.set_grad_enabled(train):
            loss, result = head(h)
        if train:
            torch.autograd.backward(loss)
            head_grads = list(h.grad.split(act_shape[0]))
    if not train:
        return result
    # the backward: the ticks in reverse, a tick's slots in falling chunk
    # order, each slot's input cotangent sent to the previous chunk's rank
    first_grads = [None] * M
    pending = []
    for t in reversed(range(T)):
        mine = list(reversed(_slots(ticks, S, s, t)))
        want = [(j, m) for j, m in mine if j < V - 1]
        got = exchange([((j - 1) % S, g, V + j - 1) for j, g in pending],
                       [((j + 1) % S, V + j) for j, _ in want]) \
            if (pending or want) else []
        cots = dict(zip(want, got))
        pending = []
        for j, m in mine:
            x, z = saved.pop((j, m))
            g = head_grads[m] if j == V - 1 else cots[(j, m)]
            torch.autograd.backward(z, g)
            if j > 0:
                pending.append((j, x.grad))
            else:
                first_grads[m] = x.grad
    if s == 0:
        torch.autograd.backward(h0, torch.cat(first_grads))
    return result
