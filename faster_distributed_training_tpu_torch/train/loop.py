"""The Trainer's K=1 host loop (the JAX package's ``train/loop.py``):
``run_epoch``, ``evaluate``, ``fit`` with the best-accuracy epoch
checkpoint, and ``maybe_resume`` (with ``--resume``, the epoch
checkpoint; the cli then restores a newer step checkpoint).  A
mid-epoch resume starts the epoch's loader at the first batch the
checkpoint had not trained: the
loader's order is a pure function of (seed, epoch) and the step draws of
(seed, step), so the remainder replays exactly, and the skipped batches
are never built.  Log lines follow the JAX format.

Resilience (``resilience.Resilience``, built by the cli whenever a
checkpoint cadence, ``--supervise``, a fault or ``--sentinel`` asks for
it) runs after every dispatch in hazard order (``_resilience_hooks``):
injected faults, the sentinel's spike observation (``--sentinel full``:
one readback of the dispatch's loss), the pod coordinator's check, the
agreed preemption decision with its emergency save, then the manager's
cadence save (``--checkpoint_every`` steps and/or
``--checkpoint_every_secs``, whichever fires first; named by global
step, the newest ``--checkpoint_keep`` kept).  Every epoch loop skips
the batch positions the sentinel quarantined; ``fit`` counts the guard's
skipped steps, keeps ``--auto_recover``'s rolling last-good snapshot and
rolls back to it after a non-finite epoch, and logs a ``[goodput]``
line an epoch.

``--steps_per_dispatch K > 1`` (or ``--data_path resident`` or
``stream``, at any K) trains through ``train.dispatch.FusedDispatch``:
``_run_epoch_fused_host`` groups K loader batches into one dispatch,
``_run_epoch_resident`` gathers them from the device-resident split
(either layout), ``_run_epoch_stream`` reads them from the stream's
window on the card while its producer refills the other slot (in both,
a mid-epoch resume is a seek: no host batch is built).  An epoch tail
shorter than K runs fewer steps on the same graph.  Checkpoints land on dispatch boundaries (the
cli rounds ``--checkpoint_every`` up to a multiple of K), and the live
log line reads the loss at a dispatch boundary.  K=1 on the host path is
the one-step loop above, unchanged.

Under a data mesh (``state.placement``) every rank runs this loop on its
rows; the step's and the eval's metrics come back summed over the ranks,
the eval pass runs with the parameters whole (``Placement.materialized``),
rank 0 writes the checkpoints (``train.checkpoint``), and the caller
logs on rank 0 only.

Telemetry (``telemetry.RunTelemetry``, None under ``--no_telemetry``):
every epoch loop records one ``step`` record a dispatch (its host wall,
the dispatch call, the data wait and the resilience hooks' time, all
host clock reads: nothing reads the card for it), the first dispatch of
a program marked ``compile`` with a ``first_dispatch_compile`` span (K=1:
the eager first step; under a dispatch: ``FusedDispatch.builds``), the
``memory`` event of scope ``state`` after the run's first dispatch, an
``eval`` span, and at each epoch's end the ``epoch``, ``memory`` (scope
``epoch``, on a card) and ``goodput`` events before the pod fold
(``end_epoch``).  With an observatory active (``telemetry/programs.py``,
the entry points install it) the first dispatch of each input signature
of the K=1 step and of the eval step is a row of the program table
(``train:host:k1``, ``eval``; the dispatch records its graph keys).

The placement-drift guard (JAX ``_check_sharding_drift``), on with or
without telemetry: after the first dispatch (and the first after a
restore) the state's placement is fingerprinted
(``programs.sharding_fingerprint``: each leaf's device, dtype, shape,
stride and tier, and its storage address while a captured graph reads
it; with ``--debug`` the per-leaf table too), and at every epoch's end
checked: a drift warns, logs a ``[memory] WARNING`` line, emits a
``memory`` event of scope ``sharding_drift`` (the changed leaves under
``--debug``) and re-anchors.  Nothing reads a tensor on the host for it.  ``--profile_steps A:B`` (``utils.profiling.
StepWindowProfiler``) starts and stops its trace at dispatch boundaries,
the stop after the last dispatch's resilience hooks (JAX stops before
them; the decisions are the same); the window's close reads that
dispatch's loss once."""

from __future__ import annotations

import contextlib
import itertools
import time
from typing import Callable, Dict, Iterable, Optional

import torch

from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.resilience.sentinel import (
    host_finite)
from faster_distributed_training_tpu_torch.telemetry import programs, spans
from faster_distributed_training_tpu_torch.train import checkpoint as ckpt
from faster_distributed_training_tpu_torch.train.metrics import (
    MetricAccumulator, format_goodput, perplexity)
from faster_distributed_training_tpu_torch.train.state import (TrainState,
                                                              settle)
from faster_distributed_training_tpu_torch.train.steps import to_device
from faster_distributed_training_tpu_torch.utils.profiling import (
    memory_watermarks, peak_memory_bytes)

# the wall clock of the --checkpoint_every_secs cadence
cadence_clock = time.monotonic

LoaderFn = Callable[[int], Iterable]
# (epoch, first batch) -> that epoch's batches from the first one on
TrainLoaderFn = Callable[[int, int], Iterable]


class Trainer:
    def __init__(self, cfg: TrainConfig, train_step, eval_step, device,
                 log: Callable[[str], None] = print, dispatch=None,
                 resilience=None):
        self.cfg = cfg
        self.train_step = train_step
        self.eval_step = eval_step
        self.device = torch.device(device)
        self.log = log
        # a train.dispatch.FusedDispatch: K steps a dispatch (its
        # resident split, when it has one, replaces the train loader)
        self.dispatch = dispatch
        # a resilience.Resilience bundle, or None (no per-dispatch work)
        self.resilience = resilience
        # a telemetry.RunTelemetry, or None (no telemetry work at all);
        # the entry point sets it once telemetry is built
        self.telemetry = None
        # a utils.profiling.StepWindowProfiler (--profile_steps), or None;
        # set by the entry point as telemetry is
        self.profiler = None
        # whether the K=1 step ran yet (its first dispatch is "compile")
        self._stepped = False
        self._state_seen = False
        # the program table: the input signatures each program has seen
        self._sigs: Dict[str, set] = {}
        # the drift guard's anchor: the placement fingerprint, the
        # per-leaf table (--debug), the captured graphs it was taken with
        self._sharding_expect: Optional[str] = None
        self._sharding_detail: Optional[Dict[str, str]] = None
        self._anchor_graphs = 0
        # the epoch positions the last epoch loop reached (epoch events)
        self._last_epoch_steps = 0
        self.best_acc = 0.0
        self.global_step = 0
        # --data_path stream: the steady state's seconds blocked on the
        # window and its wall seconds (stream_stall_pct)
        self._stream_stall_s = 0.0
        self._stream_wall_s = 0.0
        self._stream_steps = 0
        self._stream_warm = False
        self.recoveries = 0
        # the last emergency save's seconds (None: none yet)
        self.emergency_save_s: Optional[float] = None
        self.history: Dict[str, list] = {
            "train_acc": [], "train_loss": [], "test_acc": [],
            "test_loss": [], "epoch_time": [], "peak_mem_bytes": []}
        if cfg.task == "lm":
            # the LM's headline: perplexity of the token-weighted epoch
            # loss; "accuracy" is next-token accuracy
            self.history["train_ppl"] = []
            self.history["test_ppl"] = []

    def _resilience_hooks(self, state: TrainState, epoch: int,
                          step_in_epoch: int, n_steps: int = 1,
                          metrics=None, group=None) -> None:
        """After a dispatch of ``n_steps`` (JAX ``_resilience_hooks``), in
        hazard order: injected faults; the sentinel's spike observation
        (``--sentinel full``: the dispatch's loss read once; ``group`` is
        the (start, count) of epoch positions it covered); the pod
        coordinator's check; the agreed preemption decision, whose
        emergency save commits before ``Preempted`` is raised; the
        manager's cadence save."""
        from faster_distributed_training_tpu_torch.resilience import (
            Preempted)

        res = self.resilience
        step = self.global_step
        res.goodput.count("steps", n_steps)
        if res.faults is not None:
            res.faults.on_step(step)
        sent = res.sentinel
        if (sent is not None and sent.mode == "full" and metrics is not None
                and group is not None):
            loss = float(metrics["loss"])
            if res.faults is not None:
                loss = res.faults.perturb_loss(step, loss)
            sent.observe(epoch, group[0], group[1], loss, step)
        if res.coordinator is not None:
            res.coordinator.check(step)
        with (res.coordinator.pause_watch() if res.coordinator is not None
              else contextlib.nullcontext()):
            if res.preemption is not None and res.preemption.should_stop(
                    step):
                res.goodput.count("preemptions")
                if res.manager is not None:
                    t0 = time.monotonic()
                    res.manager.save(state, step, epoch=epoch,
                                     step_in_epoch=step_in_epoch,
                                     best_acc=self.best_acc, sync=True,
                                     segment="emergency_save_s")
                    self.emergency_save_s = time.monotonic() - t0
                    self.log(f"[preempt] emergency checkpoint committed at "
                             f"step {step} (epoch {epoch}); exiting cleanly")
                else:
                    self.log(f"[preempt] no checkpoint manager configured — "
                             f"exiting at step {step} WITHOUT an emergency "
                             f"save (set --checkpoint_every to get one)")
                raise Preempted(f"preempted at step {step}", state=state,
                                step=step)
            if res.manager is not None:
                res.manager.maybe_save(state, step, epoch=epoch,
                                       step_in_epoch=step_in_epoch,
                                       best_acc=self.best_acc)

    # -- telemetry ---------------------------------------------------------
    def _keep_dispatch_times(self) -> bool:
        """Whether a K=1 dispatch takes its telemetry-only clock reads:
        with telemetry on, for the first step and for the dispatches
        ``--telemetry_every`` keeps (JAX ``_keep_dispatch_times``)."""
        tel = self.telemetry
        if tel is None:
            return False
        return not self._stepped or tel.recorder.next_step_kept()

    def _record_dispatch(self, epoch: int, n: int, kk: int, wall_s: float,
                         dispatch_s: float, data_s: float, block_s: float,
                         first: bool) -> None:
        """One ``step`` record of a dispatch into the recorder's ring (no
        device work); ``first`` marks a program's first dispatch, also
        recorded as a ``first_dispatch_compile`` span (JAX
        ``_record_dispatch``)."""
        tel = self.telemetry
        if tel is None:
            return
        rec = tel.recorder
        rec.record_step(self.global_step, epoch, n, kk, wall_s * 1e3,
                        dispatch_s * 1e3, kk * self.cfg.batch_size,
                        data_ms=data_s * 1e3, block_ms=block_s * 1e3,
                        compile_=first)
        if first:
            rec.record_span("first_dispatch_compile", dispatch_s * 1e3,
                            step=self.global_step)

    def _prof_before(self, kk: int) -> None:
        prof = self.profiler
        if prof is not None and not prof.done:
            prof.before_dispatch(self.global_step, kk)

    def _prof_after(self, metrics) -> None:
        """After a dispatch and its resilience hooks (a checkpoint at the
        window's last step is in the trace): the window's close, with
        its fence (one loss readback) then only."""
        prof = self.profiler
        if prof is not None and prof.active:
            prof.after_dispatch(self.global_step,
                                fence=lambda: float(metrics["loss"]))

    def _watch(self, name: str, batch) -> tuple:
        """(signature, Stopwatch) when an observatory is active and
        ``batch``'s signature is new for program ``name``, else (None,
        None)."""
        if programs.get_observatory() is None:
            return None, None
        sig = programs.args_signature((batch,), (0,))
        seen = self._sigs.setdefault(name, set())
        if sig in seen:
            return None, None
        seen.add(sig)
        return sig, programs.Stopwatch(self.device)

    def _observed(self, name: str, sig, watch, state: TrainState, batch,
                  out, in_place: bool) -> None:
        """Program ``name``'s row after its first dispatch of ``sig``:
        the state and the batch in, ``out`` out, the state updated in
        place by a train step."""
        obs = programs.get_observatory()
        if obs is None or watch is None:
            return
        ms = watch.ms()
        held = programs.state_bytes(state)
        obs.observe(name, sig, compile_ms=ms, mem=watch.memory(
            argument=held + programs.tensor_bytes(batch),
            output=programs.tensor_bytes(out),
            alias=held if in_place else 0))

    def _graphs(self) -> int:
        """The captured graphs that read the state."""
        return len(self.dispatch.graphs) if self.dispatch is not None else 0

    def _anchor_placement(self, state: TrainState) -> None:
        """The drift guard's anchor: the state's placement fingerprint now
        (with the storage addresses while a captured graph reads them),
        and with ``--debug`` its per-leaf table."""
        self._anchor_graphs = self._graphs()
        addresses = self._anchor_graphs > 0
        self._sharding_expect = programs.sharding_fingerprint(state,
                                                              addresses)
        self._sharding_detail = (programs.sharding_table(state, addresses)
                                 if self.cfg.debug else None)

    def _check_sharding_drift(self, state: TrainState, epoch: int) -> None:
        """An epoch's end: the placement against the anchor.  A capture
        since the anchor reads the addresses as they are (a new program,
        not a drift): re-anchor.  A drift warns, logs, emits a ``memory``
        event of scope ``sharding_drift`` and re-anchors (one incident,
        one warning)."""
        if self._sharding_expect is None:
            return
        if self._graphs() != self._anchor_graphs:
            self._anchor_placement(state)
            return
        addresses = self._anchor_graphs > 0
        got = programs.sharding_fingerprint(state, addresses)
        if got == self._sharding_expect:
            return
        changed: list = []
        if self._sharding_detail is not None:
            now = programs.sharding_table(state, addresses)
            before = self._sharding_detail
            changed = sorted(p for p in set(now) | set(before)
                             if now.get(p) != before.get(p))[:8]
        import warnings

        msg = (f"train-state placement DRIFT at epoch {epoch}: fingerprint "
               f"{self._sharding_expect} -> {got}"
               + (f"; changed leaves (first 8): {changed}" if changed
                  else " (re-run with --debug for the per-leaf diff)")
               + " — a leaf was re-placed (device, dtype, layout, tier) or"
                 " its storage swapped where a captured graph reads it; "
                 "state is restored by copying into the live tensors")
        warnings.warn(msg, stacklevel=2)
        self.log("[memory] WARNING: " + msg)
        if self.telemetry is not None:
            self.telemetry.recorder.record_event(
                "memory", scope="sharding_drift", epoch=epoch,
                expected=self._sharding_expect, got=got,
                changed_leaves=changed)
        self._anchor_placement(state)

    def _observe_state(self, state: TrainState) -> None:
        """After the run's first dispatch, and the first after a restore:
        the drift guard's anchor; once a Trainer, the state's bytes a
        card (``telemetry.programs.state_bytes_table``) as the ``memory``
        event of scope ``state``, and a ``[memory]`` line when the
        optimizer state is not all replicated."""
        self._anchor_placement(state)
        if self._state_seen:
            return
        self._state_seen = True
        tiers = programs.state_bytes_table(state).get("opt_state_tiers") or {}
        if set(tiers) - {"replicated"}:
            self.log("[memory] opt state per chip: " + ", ".join(
                f"{t}={v['bytes_per_chip'] / 1e6:.1f}MB"
                f"/{v['leaves']} leaves" for t, v in sorted(tiers.items())))
        if self.telemetry is not None:
            # a second walk of the leaves' metadata, once a run: the
            # splat stays a direct state_bytes_table call, the one form
            # scripts/check_telemetry_schema.py resolves the fields of
            self.telemetry.recorder.record_event(
                "memory", **programs.state_bytes_table(state))

    def _save_epoch_checkpoint(self, name: str, state: TrainState,
                               epoch: int) -> None:
        """An epoch checkpoint (best accuracy, or ``--auto_recover``'s
        rolling last-good), timed into goodput with a resilience bundle.
        On an fs-simulated pod host 0 writes it alone: every host holds
        the same whole state."""
        res = self.resilience
        if (res is not None and res.pod_simulated and res.pod_count > 1
                and res.pod_index != 0):
            return
        if res is None:
            ckpt.save_checkpoint(self.cfg.checkpoint_dir, name, state, epoch,
                                 self.best_acc)
            return
        with res.goodput.timed("checkpoint_blocking_s"):
            ckpt.save_checkpoint(self.cfg.checkpoint_dir, name, state, epoch,
                                 self.best_acc)
        res.goodput.count("saves")

    def run_epoch(self, state: TrainState, loader: Iterable, epoch: int = 0,
                  start_step: int = 0) -> tuple:
        """One epoch over ``loader``, which starts at batch ``start_step``
        of the epoch (a mid-epoch resume)."""
        cfg = self.cfg
        acc = MetricAccumulator()
        t0 = time.monotonic()
        res = self.resilience
        sent = res.sentinel if res is not None else None
        closer = getattr(loader, "close", None)
        if res is not None and res.faults is not None:
            loader = res.faults.wrap_data(loader)
        if start_step:
            self.log(f"[resume] epoch {epoch}: skipped {start_step} "
                     f"already-trained batches")
        n = start_step
        last_t, last_n = t0, n
        metrics = None
        log_every = int(cfg.log_every or 0)
        it = iter(loader)
        try:
            while True:
                # the data wait is its own field: next() under the clock
                want = self._keep_dispatch_times()
                t_rec = time.monotonic() if want else 0.0
                try:
                    batch = next(it)
                except StopIteration:
                    break
                if sent is not None and sent.quarantined(epoch, n):
                    # built, never trained: the replay is the epoch that
                    # never saw this batch
                    n += 1
                    continue
                t_disp = time.monotonic() if want else 0.0
                self._prof_before(1)
                dev_batch = to_device(batch, self.device)
                sig, watch = self._watch("train:host:k1", dev_batch)
                state, metrics = self.train_step(state, dev_batch)
                if watch is not None:
                    self._observed("train:host:k1", sig, watch, state,
                                   dev_batch, metrics, True)
                t_done = time.monotonic() if want else 0.0
                acc.add(metrics)
                n += 1
                self.global_step += 1
                if self._sharding_expect is None:
                    self._observe_state(state)
                if log_every and n % log_every == 0:
                    now = time.monotonic()
                    loss = float(metrics["loss"])
                    acc_now = (float(metrics["correct"])
                               / float(metrics["total"]))
                    exs = ((n - last_n) * cfg.batch_size
                           / max(now - last_t, 1e-9))
                    self.log(f"[epoch {epoch}] step {n}: loss={loss:.4f} "
                             f"acc={acc_now:.4f} {exs:.0f} ex/s")
                    last_t, last_n = now, n
                if res is not None:
                    self._resilience_hooks(state, epoch, n, 1, metrics,
                                           (n - 1, 1))
                self._prof_after(metrics)
                first, self._stepped = not self._stepped, True
                # a record a dispatch (--telemetry_every counts them all);
                # one sampled out took no clock reads and is dropped
                t_end = time.monotonic() if want else 0.0
                self._record_dispatch(epoch, n, 1, t_end - t_rec,
                                      t_done - t_disp, t_disp - t_rec,
                                      t_end - t_done, first)
        finally:
            if closer is not None:
                closer()
        if metrics is not None:
            float(metrics["loss"])     # the card finishes the epoch here
        self._last_epoch_steps = n
        elapsed = time.monotonic() - t0
        return state, acc.summary(), elapsed

    def _dispatch_done(self, state: TrainState, acc: MetricAccumulator,
                       metrics, epoch: int, n: int, kk: int, last: tuple,
                       group: tuple, times: tuple, first: bool) -> tuple:
        """After a dispatch of kk steps ending at batch n (it covered the
        epoch positions ``group``: (start, count)): accumulate, the state
        table after the run's first dispatch, the profiler's window, a
        live line when a ``--log_every`` boundary was crossed, the
        resilience hooks, then the dispatch's ``step`` record.  ``times``:
        the host clock before the data wait, before and after the
        dispatch call (0s without telemetry); ``first``: the dispatch
        built a program (``FusedDispatch.builds`` moved)."""
        cfg = self.cfg
        acc.add(metrics)
        self.global_step += kk
        if self._sharding_expect is None:
            self._observe_state(state)
        log_every = int(cfg.log_every or 0)
        if log_every and n // log_every > (n - kk) // log_every:
            last_t, last_n = last
            now = time.monotonic()
            loss = float(metrics["loss"])
            acc_now = float(metrics["correct"]) / max(
                float(metrics["total"]), 1e-9)
            exs = ((n - last_n) * cfg.batch_size / max(now - last_t, 1e-9))
            self.log(f"[epoch {epoch}] step {n}: loss={loss:.4f} "
                     f"acc={acc_now:.4f} {exs:.0f} ex/s (K={kk} fused)")
            last = (now, n)
        if self.resilience is not None:
            self._resilience_hooks(state, epoch, n, kk, metrics, group)
        self._prof_after(metrics)
        t_rec, t_disp, t_done = times
        t_end = time.monotonic() if self.telemetry is not None else 0.0
        self._record_dispatch(epoch, n, kk, t_end - t_rec, t_done - t_disp,
                              t_disp - t_rec, t_end - t_done, first)
        return last

    def _clock(self) -> float:
        """The host clock when telemetry is on (a dispatch's compile is
        known only after it ran, so under a dispatch every one takes its
        reads, K steps sharing them), else 0."""
        return time.monotonic() if self.telemetry is not None else 0.0

    def _run_epoch_fused_host(self, state: TrainState, loader: Iterable,
                              epoch: int, start_step: int = 0) -> tuple:
        """K>1 on the host data path (JAX ``_run_epoch_fused_host``): K
        loader batches a dispatch, stacked and staged in one pinned copy
        a leaf; the loader starts at ``start_step`` (a mid-epoch resume,
        a whole number of dispatches)."""
        disp = self.dispatch
        acc = MetricAccumulator()
        t0 = time.monotonic()
        res = self.resilience
        sent = res.sentinel if res is not None else None
        closer = getattr(loader, "close", None)
        if res is not None and res.faults is not None:
            loader = res.faults.wrap_data(loader)
        if start_step:
            self.log(f"[resume] epoch {epoch}: skipped {start_step} "
                     f"already-trained batches")
        n, last, metrics = start_step, (t0, start_step), None
        it = iter(loader)
        try:
            while True:
                t_rec = self._clock()
                group = list(itertools.islice(it, disp.k))
                if not group:
                    break
                full = len(group)
                if sent is not None:
                    # quarantined positions leave the group; the cursor
                    # still moves by the whole group
                    group = [b for j, b in enumerate(group)
                             if not sent.quarantined(epoch, n + j)]
                    if not group:
                        n += full
                        continue
                kk = len(group)
                built = disp.builds
                t_disp = self._clock()
                self._prof_before(kk)
                metrics = disp.run(state, kk, batches=group)
                t_done = self._clock()
                n += full
                last = self._dispatch_done(state, acc, metrics, epoch, n,
                                           kk, last, (n - full, full),
                                           (t_rec, t_disp, t_done),
                                           disp.builds > built)
        finally:
            if closer is not None:
                closer()
        if metrics is not None:
            float(metrics["loss"])     # the card finishes the epoch here
        self._last_epoch_steps = n
        return state, acc.summary(), time.monotonic() - t0

    def _run_epoch_resident(self, state: TrainState, epoch: int,
                            start_step: int = 0) -> tuple:
        """The resident split (JAX ``_run_epoch_resident``): the epoch
        order uploads once, each dispatch gathers its K batches on the
        device; a mid-epoch resume seeks to ``start_step``."""
        disp = self.dispatch
        acc = MetricAccumulator()
        t0 = time.monotonic()
        disp.set_epoch(epoch)
        n_steps = disp.resident.steps_per_epoch
        if start_step:
            self.log(f"[resume] epoch {epoch}: seeking to batch "
                     f"{start_step} (device-resident order, no host "
                     f"replay)")
        res = self.resilience
        sent = res.sentinel if res is not None else None
        n, last, metrics = start_step, (t0, start_step), None
        while n < n_steps:
            kk = min(disp.k, n_steps - n)
            # the dispatch's positions without the quarantined ones: one
            # dispatch a contiguous run of them
            segs = sent.plan(epoch, n, kk) if sent is not None else [(n, kk)]
            if not segs:
                n += kk
                continue
            built = disp.builds
            t_rec = self._clock()
            for s0, length in segs[:-1]:
                self._prof_before(length)
                acc.add(disp.run(state, length, start=s0))
                self.global_step += length
            s0, length = segs[-1]
            self._prof_before(length)
            metrics = disp.run(state, length, start=s0)
            t_done = self._clock()
            n += kk
            last = self._dispatch_done(state, acc, metrics, epoch, n, length,
                                       last, (n - kk, kk),
                                       (t_rec, t_rec, t_done),
                                       disp.builds > built)
        if metrics is not None:
            float(metrics["loss"])
        self._last_epoch_steps = n
        return state, acc.summary(), time.monotonic() - t0

    def _run_epoch_stream(self, state: TrainState, epoch: int,
                          start_step: int = 0) -> tuple:
        """The streamed epoch (JAX ``_run_epoch_stream``): the split stays
        on disk, the dispatches read their batches from the window's slot
        on the card (row ``slot * W + n - base``) while its producer
        refills the other slot.  A mid-epoch resume is a seek (the refills
        start at ``start_step``); the window is closed on every exit,
        normal or not (a fault, a preemption), which joins the producer.

        Stall accounting: a dispatch that swapped slots waited
        ``window.last_wait`` for the refill; the steady state (neither the
        run's first dispatch, which captures the graph, nor an epoch's
        first, the cold fill) adds it to the stalled seconds and the
        dispatch's wall, up to the resilience hooks, to the wall seconds
        of ``stream_stall_pct``.  The step record's ``data_ms`` is the
        wait in ``buffer_for``."""
        disp = self.dispatch
        src = disp.resident
        acc = MetricAccumulator()
        t0 = time.monotonic()
        n_steps = src.steps_per_epoch
        if start_step:
            self.log(f"[resume] epoch {epoch}: stream seek to batch "
                     f"{start_step} (window refills start there; no host "
                     f"replay)")
        res = self.resilience
        sent = res.sentinel if res is not None else None
        window = src.epoch_window(epoch, start_step)
        n, last, metrics = start_step, (t0, start_step), None
        epoch_cold = True
        try:
            while n < n_steps:
                t_rec = time.monotonic()
                base, hi, slot = window.buffer_for(n)
                t_disp = self._clock()
                row0 = slot * src.window - base
                kk = min(disp.k, n_steps - n, hi - n)
                segs = (sent.plan(epoch, n, kk) if sent is not None
                        else [(n, kk)])
                if not segs:
                    n += kk
                    continue
                first = not self._stream_warm
                built = disp.builds
                for s0, length in segs[:-1]:
                    self._prof_before(length)
                    acc.add(disp.run(state, length, start=row0 + s0))
                    self.global_step += length
                s0, length = segs[-1]
                self._prof_before(length)
                metrics = disp.run(state, length, start=row0 + s0)
                self._stream_warm = True
                t_step = time.monotonic()
                if not first and not epoch_cold:
                    self._stream_stall_s += window.last_wait
                    self._stream_wall_s += t_step - t_rec
                    self._stream_steps += kk
                epoch_cold = False
                n += kk
                last = self._dispatch_done(state, acc, metrics, epoch, n,
                                           length, last, (n - kk, kk),
                                           (t_rec, t_disp, t_step),
                                           disp.builds > built)
        finally:
            window.close()
        if metrics is not None:
            float(metrics["loss"])
        self._last_epoch_steps = n
        return state, acc.summary(), time.monotonic() - t0

    @property
    def stream_stall_pct(self) -> Optional[float]:
        """The steady state's percent of streamed step time blocked on the
        window (None before a steady-state streamed dispatch)."""
        if self._stream_wall_s <= 0:
            return None
        return 100.0 * self._stream_stall_s / self._stream_wall_s

    def evaluate(self, state: TrainState, loader: Iterable
                 ) -> Dict[str, float]:
        acc = MetricAccumulator()
        t0 = time.monotonic()
        pl = state.placement
        with spans.span("eval", step=self.global_step):
            with (contextlib.nullcontext() if pl is None
                  else pl.materialized(state)):
                for batch in loader:
                    dev_batch = to_device(batch, self.device)
                    sig, watch = self._watch("eval", dev_batch)
                    m = self.eval_step(state, dev_batch)
                    if watch is not None:
                        self._observed("eval", sig, watch, state, dev_batch,
                                       m, False)
                    acc.add(m)
            summary = acc.summary()   # the host read ends the span
        elapsed = time.monotonic() - t0
        total = summary.get("total_sum")
        if total:
            self.log(f"[eval] {total:.0f} samples in {elapsed:.1f}s "
                     f"({total / max(elapsed, 1e-9):.0f} ex/s)")
        return summary

    def fit(self, state: TrainState, train_loader: TrainLoaderFn,
            eval_loader: LoaderFn, ckpt_name: str = "ckpt",
            start_epoch: int = 0, start_step_in_epoch: int = 0
            ) -> TrainState:
        cfg = self.cfg
        res = self.resilience
        self.global_step = int(state.step)
        # a restored state (a resume, a supervisor restart) re-anchors
        # the drift guard after its next dispatch, never compared across
        self._sharding_expect = None
        # a supervisor restart re-enters fit from the restored epoch: the
        # history of the epochs it replays goes
        for series in self.history.values():
            del series[start_epoch:]
        if res is not None:
            res.goodput.start()
        recover_name = ckpt_name + "_last"
        failures = 0
        if cfg.auto_recover:
            # the rolling last-good snapshot (separate from the best-
            # accuracy checkpoint), written now so one always exists:
            # a non-finite epoch has poisoned the live state
            self._save_epoch_checkpoint(recover_name, state, start_epoch - 1)
        epoch = start_epoch
        resume_step = start_step_in_epoch
        cuda = self.device.type == "cuda"
        while epoch < cfg.epochs:
            if cuda:
                torch.cuda.reset_peak_memory_stats(self.device)
            disp = self.dispatch
            # the hang watchdog runs around the dispatches only
            with (res.coordinator.watch_steps()
                  if res is not None and res.coordinator is not None
                  else contextlib.nullcontext()):
                if (disp is not None and getattr(
                        disp.resident, "program_key", None) == "stream"):
                    state, train_m, elapsed = self._run_epoch_stream(
                        state, epoch, resume_step)
                elif disp is not None and disp.resident is not None:
                    state, train_m, elapsed = self._run_epoch_resident(
                        state, epoch, resume_step)
                elif disp is not None:
                    state, train_m, elapsed = self._run_epoch_fused_host(
                        state, train_loader(epoch, resume_step), epoch,
                        resume_step)
                else:
                    state, train_m, elapsed = self.run_epoch(
                        state, train_loader(epoch, resume_step), epoch,
                        start_step=resume_step)
            resumed_mid_epoch, resume_step = resume_step, 0
            # the optimizer's count, exact at every epoch's end
            settle(state)
            if res is not None:
                # the guard's skipped steps, read with the epoch's sums
                bad = train_m.get("bad_steps_sum")
                if bad:
                    res.goodput.count("skipped_steps", int(round(bad)))
            if "loss" not in train_m:
                if not resumed_mid_epoch:
                    raise RuntimeError(
                        f"epoch {epoch} produced no batches — dataset too "
                        f"small for batch_size={cfg.batch_size}?")
                self.log(f"[resume] epoch {epoch} was already fully trained "
                         f"at checkpoint time; running its eval and "
                         f"continuing")
            if ("loss" in train_m and cfg.auto_recover
                    and not host_finite(train_m.get("loss"))):
                failures += 1
                if failures > cfg.max_recoveries:
                    raise RuntimeError(
                        f"training diverged {failures} times in a row "
                        f"(epoch {epoch}); giving up")
                state, meta = ckpt.restore_checkpoint(
                    cfg.checkpoint_dir, recover_name, state)
                self.global_step = int(state.step)
                self._sharding_expect = None
                self.log(f"[recover] non-finite loss at epoch {epoch}; "
                         f"restored last-good state from epoch "
                         f"{meta.get('epoch')}, retrying")
                if self.telemetry is not None:
                    # a rolled-back epoch has no epoch event; the
                    # rollback is in the stream
                    self.telemetry.recorder.record_event(
                        "rollback", epoch=epoch,
                        restored_epoch=int(meta.get("epoch", -1)),
                        step=self.global_step)
                self.recoveries += 1
                # the retry takes the next epoch's order; the restored
                # step puts the schedule back where the snapshot was
                epoch += 1
                continue
            failures = 0
            self._check_sharding_drift(state, epoch)
            if cfg.auto_recover:
                self._save_epoch_checkpoint(recover_name, state, epoch)
            test_m = self.evaluate(state, eval_loader(epoch))
            if cfg.task == "lm":
                for m, key in ((train_m, "train_ppl"), (test_m, "test_ppl")):
                    if host_finite(m.get("loss")):
                        m["perplexity"] = perplexity(m["loss"])
                    self.history[key].append(m.get("perplexity", 0.0))
            peak = peak_memory_bytes(self.device)
            self.history["train_acc"].append(train_m.get("accuracy", 0.0))
            self.history["train_loss"].append(train_m.get("loss", 0.0))
            self.history["test_acc"].append(test_m.get("accuracy", 0.0))
            self.history["test_loss"].append(test_m.get("loss", 0.0))
            self.history["epoch_time"].append(elapsed)
            self.history["peak_mem_bytes"].append(peak)
            self.log(
                f"epoch {epoch}: train_loss={train_m.get('loss', 0):.4f} "
                f"train_acc={train_m.get('accuracy', 0):.4f} "
                f"test_loss={test_m.get('loss', 0):.4f} "
                f"test_acc={test_m.get('accuracy', 0):.4f} "
                f"time={elapsed:.1f}s"
                + (f" test_ppl={test_m['perplexity']:.2f}"
                   if "perplexity" in test_m else "")
                + (f" peak_mem={peak / 1e6:.0f}MB" if peak else ""))
            if test_m.get("accuracy", 0.0) > self.best_acc:
                self.best_acc = test_m["accuracy"]
                self._save_epoch_checkpoint(ckpt_name, state, epoch)
            if res is not None:
                self.log("[goodput] " + format_goodput(res.goodput))
            if self.telemetry is not None:
                self._epoch_events(epoch, train_m, test_m, elapsed, peak,
                                   resumed_mid_epoch)
            epoch += 1
        if self.profiler is not None:
            # a window the run never reached the end of is still captured
            self.profiler.close()
        if res is not None and res.manager is not None:
            # no uncommitted newest checkpoint after a clean exit
            res.manager.wait()
        return state

    def _epoch_events(self, epoch: int, train_m: dict, test_m: dict,
                      elapsed: float, peak: Optional[int],
                      resumed_mid_epoch: int) -> None:
        """The epoch's ``epoch``, ``memory`` (scope ``epoch``, on a card)
        and ``goodput`` events, then the flush, the marker and (process
        0) the pod fold (JAX ``train/loop.py:1180-1210``)."""
        rec = self.telemetry.recorder
        trained = self._last_epoch_steps - resumed_mid_epoch
        ev = {"epoch": epoch, "steps": self._last_epoch_steps,
              "trained_steps": trained, "wall_s": round(elapsed, 3)}
        if "loss" in train_m:
            ev["loss"] = train_m["loss"]
        if "accuracy" in train_m:
            ev["accuracy"] = train_m["accuracy"]
        if trained and elapsed:
            ev["ex_s"] = round(trained * self.cfg.batch_size / elapsed, 1)
        if "loss" in test_m:
            ev["eval_loss"] = test_m["loss"]
        if "accuracy" in test_m:
            ev["eval_accuracy"] = test_m["accuracy"]
        if "perplexity" in train_m:
            ev["perplexity"] = train_m["perplexity"]
        if "perplexity" in test_m:
            ev["eval_perplexity"] = test_m["perplexity"]
        if peak:
            ev["peak_mem_bytes"] = int(peak)
        rec.record_event("epoch", **ev)
        stats = memory_watermarks(self.device)
        if stats is not None:
            rec.record_event("memory", scope="epoch", epoch=epoch,
                             peak_bytes=stats["peak_bytes"],
                             bytes_in_use=stats["bytes_in_use"])
        if self.resilience is not None:
            rec.record_event("goodput", **self.resilience.goodput.summary())
        self.telemetry.end_epoch(epoch)

    def maybe_resume(self, state: TrainState, ckpt_name: str = "ckpt"
                     ) -> tuple:
        """--resume: restore the best-accuracy epoch checkpoint when there
        is one (JAX ``Trainer.maybe_resume``; the step checkpoints are
        the cli's, through ``checkpoint.restore_newest``).  Returns
        (state, start epoch)."""
        d = self.cfg.checkpoint_dir
        if not (self.cfg.resume and ckpt.has_checkpoint(d, ckpt_name)):
            return state, 0
        state, meta = ckpt.restore_checkpoint(d, ckpt_name, state)
        self.best_acc = float(meta.get("best_acc", 0.0))
        self.log(f"resumed from epoch {meta['epoch']} "
                 f"(best_acc={self.best_acc:.4f})")
        return state, int(meta["epoch"]) + 1
