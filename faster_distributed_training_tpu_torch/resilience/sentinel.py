"""Anomaly sentinel (the JAX package's ``resilience/sentinel.py``): the
host half of the silent-failure ladder.

  * non-finite steps: the in-graph guard (``train/steps.py``, armed by
    ``--sentinel guard|full``) decides on the device whether a step's
    loss, global gradient norm and fp16 overflow check are all finite,
    and a bad step leaves the parameters, the optimizer state and the
    buffers as they were while the step count advances; the epoch's
    ``bad_steps`` sum feeds the ``skipped_steps`` goodput counter;
  * loss spikes (``--sentinel full``): one readback of the dispatch's
    loss a dispatch feeds a windowed median/MAD detector
    (:class:`SpikeDetector`); a spike quarantines the dispatch's batch
    positions in a durable ledger (:class:`QuarantineLedger`, through the
    storage backend) and raises :class:`LossSpike`, which the supervisor
    recovers like a crash; the replay skips the quarantined positions
    (:meth:`Sentinel.plan`), which are a pure function of (seed, epoch,
    position);
  * stream shards that fail their checksum land here as ledger entries
    and the ``quarantined_shards`` counter.

Host bookkeeping only; ``--sentinel none`` builds no Sentinel and the
step is unchanged.  The ledger's JSON is byte-identical to the JAX
package's for the same inputs."""

from __future__ import annotations

import math
import warnings
from collections import deque
from typing import Callable, Dict, List, Set, Tuple

LEDGER_KEY = "quarantine/ledger.json"


def host_finite(x) -> bool:
    """Whether a metric is finite, on the host: a Python float, or a
    torch tensor read once (one device-to-host copy for a card tensor).
    The in-graph guard's device bit (``train/steps.py``) is the same
    predicate computed on the device."""
    try:
        return x is not None and math.isfinite(float(x))
    except (TypeError, ValueError, RuntimeError):
        return False


class LossSpike(RuntimeError):
    """A detected loss spike: the offending batch positions are already
    quarantined (durably) by the time this raises, so the supervisor's
    standard newest-VALID restore + replay recovers WITHOUT the bad
    batches.  Restartable — and exempt from the supervisor's
    deterministic-crash short-circuit: the quarantine changes the
    replay, so a second spike at the same step is a NEW incident (a
    different batch spiking), not evidence that retrying is futile."""

    def __init__(self, message: str, epoch: int = 0,
                 positions: Tuple[int, ...] = ()):
        super().__init__(message)
        self.epoch = int(epoch)
        self.positions = tuple(positions)


class SpikeDetector:
    """Windowed median/MAD spike statistic over the dispatch loss
    stream.  Median/MAD (not mean/std): a single outlier inflates a
    std enough to mask itself, while the median absolute deviation is
    robust to exactly the contamination being hunted.  A loss more
    than ``threshold`` MADs above the trailing window's median is a
    spike; ``min_history`` observations are required before anything
    can flag (early training is legitimately volatile), and the MAD is
    floored at a small fraction of the median so a perfectly flat
    window (synthetic data) cannot divide by ~zero and flag noise."""

    def __init__(self, window: int = 32, threshold: float = 8.0,
                 min_history: int = 8):
        self.window = max(int(window), 2)
        self.threshold = float(threshold)
        self.min_history = max(int(min_history), 2)
        self._losses: deque = deque(maxlen=self.window)

    def observe(self, loss: float) -> bool:
        """Feed one dispatch loss; True when it spikes vs the trailing
        window (the spiking loss itself is NOT added to the window —
        after the rollback the replay re-observes the healthy stream)."""
        loss = float(loss)
        if not math.isfinite(loss):
            # non-finite is the in-graph guard's jurisdiction (the step
            # was already skipped); don't poison the window with it
            return False
        if len(self._losses) >= self.min_history:
            hist = sorted(self._losses)
            m = len(hist)
            median = (hist[m // 2] if m % 2
                      else 0.5 * (hist[m // 2 - 1] + hist[m // 2]))
            devs = sorted(abs(v - median) for v in hist)
            mad = (devs[m // 2] if m % 2
                   else 0.5 * (devs[m // 2 - 1] + devs[m // 2]))
            mad = max(mad, 1e-3 * max(abs(median), 1e-6))
            if loss > median + self.threshold * mad:
                return True
        self._losses.append(loss)
        return False

    def reset(self) -> None:
        """Clear the window — called on rollback so the replayed
        stream is not double-observed."""
        self._losses.clear()


class QuarantineLedger:
    """The durable record of what was quarantined: global-batch
    POSITIONS per epoch (skipped deterministically by every data path:
    the epoch order is a pure function of (seed, epoch)) and corrupt
    stream-shard indices (informational — shard verdicts re-derive deterministically
    from the CRCs, the ledger is the run's record of them).

    Written through the resilience ``StorageBackend`` under
    ``quarantine/ledger.json`` so a killed-mid-replay restart (same
    host or a peer) reloads the identical skip set before its first
    dispatch.  Format::

        {"version": 1,
         "batches": {"<epoch>": [position, ...]},
         "shards":  [shard_index, ...]}

    ``backend=None`` (no resilience bundle) keeps it in memory only."""

    def __init__(self, backend=None, key: str = LEDGER_KEY):
        self._backend = backend
        self._key = key
        self._batches: Dict[int, Set[int]] = {}
        self._shards: Set[int] = set()
        self.load()

    def load(self) -> None:
        if self._backend is None:
            return
        try:
            obj = self._backend.read_json(self._key)
        except Exception:
            obj = None
        if not obj:
            return
        self._batches = {int(e): set(int(p) for p in ps)
                         for e, ps in (obj.get("batches") or {}).items()}
        self._shards = set(int(s) for s in obj.get("shards") or ())

    def _flush(self) -> None:
        if self._backend is None:
            return
        self._backend.put_json(self._key, {
            "version": 1,
            "batches": {str(e): sorted(ps)
                        for e, ps in sorted(self._batches.items())},
            "shards": sorted(self._shards)})

    def add_batches(self, epoch: int, positions) -> None:
        self._batches.setdefault(int(epoch), set()).update(
            int(p) for p in positions)
        self._flush()

    def add_shard(self, index: int) -> None:
        self._shards.add(int(index))
        self._flush()

    def batches_for(self, epoch: int) -> Set[int]:
        return self._batches.get(int(epoch), set())

    def shards(self) -> Set[int]:
        return set(self._shards)


class Sentinel:
    """The host half of the anomaly ladder (mode ``guard`` or
    ``full``): owns the spike detector + quarantine ledger and plans
    the deterministic skips for the dispatch loops.

    ``observe(...)`` is only called in ``full`` mode — it costs one
    device->host loss readback per dispatch; ``guard`` mode adds
    ZERO host work (the in-graph guard is self-contained)."""

    def __init__(self, mode: str, backend=None, goodput=None,
                 window: int = 32, threshold: float = 8.0,
                 log: Callable[[str], None] = print, root: str = ""):
        if mode not in ("guard", "full"):
            raise ValueError(f"sentinel mode must be guard/full, got "
                             f"{mode!r} (none builds no Sentinel)")
        self.mode = mode
        self.goodput = goodput
        self.log = log
        self.detector = (SpikeDetector(window=window, threshold=threshold)
                         if mode == "full" else None)
        # anchor the ledger under the run's checkpoint root: PosixBackend
        # keys are filesystem paths verbatim, so a bare LEDGER_KEY would
        # land relative to the process CWD and a restart launched from
        # anywhere else would silently miss the quarantine set
        key = (backend.join(root, LEDGER_KEY)
               if backend is not None and root else LEDGER_KEY)
        self.ledger = QuarantineLedger(backend=backend, key=key)

    # -- deterministic quarantine skips (all data paths) ---------------

    def quarantined(self, epoch: int, position: int) -> bool:
        return position in self.ledger.batches_for(epoch)

    def plan(self, epoch: int, start: int, count: int
             ) -> List[Tuple[int, int]]:
        """Contiguous (start, length) sub-segments of the dispatch
        group ``[start, start + count)`` that are NOT quarantined for
        ``epoch`` — the dispatch loops run one fused dispatch per
        segment (a tail-program per length already exists for any
        length <= K).  ``[(start, count)]`` when nothing overlaps (the
        hot path: one comparison against an empty set)."""
        bad = self.ledger.batches_for(epoch)
        if not bad:
            return [(start, count)]
        segs: List[Tuple[int, int]] = []
        s = None
        for p in range(start, start + count):
            if p in bad:
                if s is not None:
                    segs.append((s, p - s))
                    s = None
            elif s is None:
                s = p
        if s is not None:
            segs.append((s, start + count - s))
        return segs

    # -- loss-spike detection ------------------------------------------

    def observe(self, epoch: int, start: int, count: int, loss: float,
                step: int) -> None:
        """Feed one dispatch's mean loss (positions ``[start,
        start + count)`` of ``epoch``); on a spike: quarantine the
        group durably, count the rollback, reset the detector window
        (the replay re-observes the healthy stream) and raise
        :class:`LossSpike` for the supervisor to roll back through."""
        if self.detector is None:
            return
        if not self.detector.observe(loss):
            return
        positions = [p for p in range(start, start + count)
                     if p not in self.ledger.batches_for(epoch)]
        self.ledger.add_batches(epoch, positions)
        if self.goodput is not None:
            self.goodput.count("rollbacks")
            self.goodput.count("quarantined_batches", len(positions))
        self.detector.reset()
        self.log(f"[sentinel] loss SPIKE at step {step} (epoch {epoch}, "
                 f"batches {start}..{start + count - 1}, loss "
                 f"{loss:.4g} vs trailing window): quarantining "
                 f"{len(positions)} batch position(s) durably and "
                 f"rolling back to the newest valid checkpoint")
        raise LossSpike(
            f"loss spike at step {step}: dispatch loss {loss:.4g} "
            f"breached the median/MAD window; batches "
            f"{positions} of epoch {epoch} quarantined",
            epoch=epoch, positions=tuple(positions))

    # -- data-integrity reporting (data/stream CRC verdicts) -----------

    def quarantine_shard(self, index: int, path: str = "") -> None:
        """Record a CRC-failed stream shard (reader.py already remapped
        its rows): ledger entry + counter + loud warning — the run
        CONTINUES, never crashes."""
        self.ledger.add_shard(index)
        if self.goodput is not None:
            self.goodput.count("quarantined_shards")
        msg = (f"stream shard {index} failed its CRC check"
               + (f" ({path})" if path else "")
               + " — rows remapped to a healthy shard; shard "
                 "quarantined in the ledger")
        warnings.warn("[sentinel] " + msg, stacklevel=2)
        self.log("[sentinel] WARNING: " + msg)
