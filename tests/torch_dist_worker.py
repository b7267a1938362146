"""The rank side of ``tests/test_torch_distributed.py``,
``tests/test_torch_tp_distributed*.py``,
``tests/test_torch_sp_distributed.py`` and
``tests/test_torch_pp_distributed.py``: the port's training steps under
a data mesh, a (dp, tp), a (dp, sp) or a (dp, pp) mesh, run in spawned
processes joined by gloo.

Imports the port and torch only (never JAX, never the test module), so a
spawned rank starts quickly.  ``launch`` starts ``world`` processes that
rendezvous through a ``FileStore`` file (no port to collide on under
pytest-xdist), each runs one case of ``CASES`` and writes its result to
``<out>/<rank>.pt``; ``wait`` joins them under a timeout, kills what is
left and raises when any rank failed or ran past it (``start`` lets a
group run while the caller computes).
"""

from __future__ import annotations

import hashlib
import itertools
import multiprocessing as mp
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

SMALL = dict(model="transformer", dataset="synthetic", num_classes=4,
             lr=1e-2, batch_size=8, epochs=2, alpha=0.99, seq_len=32,
             n_layers=1, d_model=64, d_ff=128, n_heads=4, precision="fp32",
             telemetry=False, plot=False, device="cpu")


def launch(case: str, world: int, out_dir: str, timeout: float = 120.0,
           **kwargs) -> list:
    """Run ``CASES[case](**kwargs)`` on ``world`` gloo ranks; returns each
    rank's result, in rank order."""
    return wait(start(case, world, out_dir, **kwargs), timeout)


def start(case: str, world: int, out_dir: str, **kwargs):
    """Start the ``world`` ranks of a group that will run ``case``
    (``wait`` collects them).  The ranks import, join the group and then
    wait for their arguments: ``kwargs`` here, or ``feed`` later (so a
    group's start-up overlaps the caller's work)."""
    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.get_context("spawn")
    # daemons: a group its caller abandons dies with the caller
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(rank, world, case, out_dir))
             for rank in range(world)]
    for p in procs:
        p.start()
    handle = (case, procs, out_dir, time.monotonic())
    if kwargs:
        feed(handle, **kwargs)
    return handle


def feed(handle, **kwargs) -> None:
    """The group's arguments, written where its ranks wait for them."""
    out_dir = handle[2]
    tmp = os.path.join(out_dir, "kwargs.tmp")
    torch.save(kwargs, tmp)
    os.replace(tmp, os.path.join(out_dir, "kwargs.pt"))


def kill(handle) -> None:
    """Stop a group's ranks that are still running."""
    for p in handle[1]:
        if p.is_alive():
            p.kill()
            p.join(10)


def wait(handle, timeout: float = 120.0) -> list:
    """Join a started group within ``timeout`` seconds of its start; kill
    what is left and raise when a rank failed or ran past it."""
    case, procs, out_dir, t0 = handle
    try:
        for p in procs:
            p.join(max(timeout - (time.monotonic() - t0), 0.0))
    finally:
        late = [p for p in procs if p.is_alive()]
        kill(handle)
    if late:
        raise TimeoutError(f"{case}: {len(late)} of {len(procs)} ranks "
                           f"still running after {timeout}s")
    results = []
    for rank, p in enumerate(procs):
        path = os.path.join(out_dir, f"{rank}.pt")
        if p.exitcode != 0 or not os.path.exists(path):
            err = os.path.join(out_dir, f"{rank}.err")
            msg = open(err).read() if os.path.exists(err) else ""
            raise RuntimeError(f"{case}: rank {rank} exited "
                               f"{p.exitcode}\n{msg}")
        results.append(torch.load(path, weights_only=False))
    return results


def _rank_main(rank, world, case, out_dir, patience: float = 600.0):
    import datetime

    torch.set_num_threads(1)
    try:
        # the FileStore rendezvous and every collective give up after
        # ``patience``: a peer that never comes fails this rank
        dist.init_process_group(
            "gloo", rank=rank, world_size=world,
            init_method=f"file://{os.path.join(out_dir, 'rendezvous')}",
            timeout=datetime.timedelta(seconds=patience))
        try:
            path = os.path.join(out_dir, "kwargs.pt")
            t0 = time.monotonic()
            while not os.path.exists(path):
                if time.monotonic() - t0 > patience:
                    raise TimeoutError(f"no arguments at {path}")
                time.sleep(0.02)
            out = CASES[case](**torch.load(path, weights_only=False))
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(out_dir, f"{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def digest(leaves: dict) -> str:
    """sha256 of every leaf's bytes, in name order."""
    h = hashlib.sha256()
    for k in sorted(leaves):
        h.update(k.encode())
        h.update(np.ascontiguousarray(leaves[k]).tobytes())
    return h.hexdigest()


def whole_leaves(state) -> dict:
    """Every tensor of the state, whole (gathered under a placement), as
    numpy."""
    from faster_distributed_training_tpu_torch.train.state import (
        state_leaves)

    pl = state.placement
    if pl is None:
        return {k: v.detach().cpu().numpy().copy()
                for k, v in state_leaves(state).items()}
    with pl.whole(state):
        return {k: v.detach().cpu().numpy().copy()
                for k, v in state_leaves(state).items()}


def build_state(cfg_kw: dict, init: dict, extra=None, vocab: int = 100,
                spe: int = 4, lr_scale: float = 1.0, mesh_axes=("dp",),
                place: bool = True):
    """The port's train state of ``cfg_kw`` from the whole model state
    dict ``init`` (numpy), placed on the running group's mesh: ``cfg_kw``
    may name its ``mesh_shape`` (a (dp, tp) mesh: the model holds this
    rank's tp shards of ``init``; a (dp, sp) mesh: it runs this rank's
    positions; a (dp, pp) mesh: the whole model built, then the other
    stages' leaves dropped)."""
    from faster_distributed_training_tpu_torch import cli
    from faster_distributed_training_tpu_torch.config import TrainConfig
    from faster_distributed_training_tpu_torch.interop import tp_state_dict
    from faster_distributed_training_tpu_torch.optim import (build_optimizer,
                                                             layouts_of)
    from faster_distributed_training_tpu_torch.parallel import (
        Placement, make_mesh, mesh_groups, shard_train_state)
    from faster_distributed_training_tpu_torch.train.state import (
        create_train_state)

    cfg = TrainConfig(**{**SMALL, **cfg_kw}, mesh_axes=tuple(mesh_axes))
    mesh = group = tp = None
    if place and dist.is_initialized():
        mesh = make_mesh(cfg.mesh_axes, cfg.mesh_shape, "cpu")
        group, tp = mesh_groups(mesh)
    model = cli.build_model(cfg, vocab_size=None if cli.is_resnet(cfg)
                            else vocab, device="cpu", tp=tp,
                            sp=None if group is None else group.seq)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in init.items()}
    if tp is not None:
        sd = tp_state_dict(sd, tp.rank, tp.size, cfg.n_heads)
    model.load_state_dict(sd)
    tx, _ = build_optimizer(cfg, steps_per_epoch=spe, lr_scale=lr_scale,
                            layouts=layouts_of(model))
    state = create_train_state(model, tx, cfg.seed, extra={
        k: torch.from_numpy(np.array(v)) for k, v in (extra or {}).items()})
    if mesh is not None:
        state.placement = Placement(cfg, mesh, "cpu", group, tp)
        shard_train_state(state, state.placement)
    return cfg, state


def _spy_grads(state) -> list:
    """Record, each step, the digest of the reduced gradients of the
    replicated leaves (those with no tp cut): under tp they must come
    out equal on every rank of a tp group."""
    pl, seen = state.placement, []
    if pl is None:
        return seen
    reduce = pl.reduce_grads

    def spy(grads):
        out = reduce(grads)
        seen.append(digest({k: v.detach().numpy() for k, v in out.items()
                            if pl.cuts.get(k) is None}))
        return out
    pl.reduce_grads = spy
    return seen


def run_steps(cfg_kw: dict, init: dict, batches: list, draws: list,
              variants: dict, extra=None, vocab: int = 100,
              lr_scale: float = 1.0, ckpt_dir: str = "") -> dict:
    """For every variant (name -> (cfg overrides, mesh axes)): the steps
    on this rank's rows of ``batches`` with the global ``draws``; the
    metrics a step, the digest of the whole state after each step, and
    (rank 0) the whole state after the last.  ``ckpt_dir``: the last
    state is also saved there as checkpoint ``<variant>``."""
    from faster_distributed_training_tpu_torch.parallel import (
        DataGroup, make_put_batch, train_state_shardings)
    from faster_distributed_training_tpu_torch.train import checkpoint
    from faster_distributed_training_tpu_torch.train.steps import (
        StepDraws, make_train_step)

    out = {}
    for name, (over, axes) in variants.items():
        cfg, state = build_state({**cfg_kw, **over}, init, extra, vocab,
                                 lr_scale=lr_scale, mesh_axes=axes)
        group = (state.placement.group if state.placement is not None
                 else DataGroup())
        put = make_put_batch(group, "cpu")
        grads = _spy_grads(state)
        step = make_train_step(cfg)
        metrics, digests = [], []
        for batch, d in zip(batches, draws):
            state, m = step(state, put(batch), StepDraws(**d))
            metrics.append({k: float(v) for k, v in m.items()})
            digests.append(digest(whole_leaves(state)))
        res = {"metrics": metrics, "digests": digests,
               "replicated_grads": grads}
        leaves = whole_leaves(state)      # collective: every rank
        if not dist.is_initialized() or dist.get_rank() == 0:
            res["leaves"] = leaves
            if state.placement is not None:
                res["table"] = train_state_shardings(state,
                                                     state.placement)
        if ckpt_dir:
            checkpoint.save_checkpoint(ckpt_dir, name, state, 0, 0.0)
        out[name] = res
    return out


def restore(cfg_kw: dict, init: dict, ckpt_dir: str, name: str,
            extra=None, vocab: int = 100, mesh_axes=("dp",),
            over=None) -> dict:
    """A fresh state of this group's mesh restored from checkpoint
    ``name``: its whole leaves."""
    from faster_distributed_training_tpu_torch.train import checkpoint

    _, state = build_state({**cfg_kw, **(over or {})}, init, extra, vocab,
                           mesh_axes=mesh_axes)
    checkpoint.restore_checkpoint(ckpt_dir, name, state)
    return {"leaves": whole_leaves(state)}


def eval_metrics(cfg_kw: dict, init: dict, batches: list, vocab: int = 100,
                 mesh_axes=("dp",), over=None) -> list:
    """The eval step's metrics (summed over the group) on this rank's rows
    of each of ``batches``, from a fresh state of this group's mesh."""
    from faster_distributed_training_tpu_torch.parallel import (
        DataGroup, make_put_batch)
    from faster_distributed_training_tpu_torch.train.steps import (
        make_eval_step)

    cfg, state = build_state({**cfg_kw, **(over or {})}, init, None, vocab,
                             mesh_axes=mesh_axes)
    group = (state.placement.group if state.placement is not None
             else DataGroup())
    put = make_put_batch(group, "cpu")
    step = make_eval_step(cfg)
    return [{k: float(v) for k, v in step(state, put(b)).items()}
            for b in batches]


def cli_runs(ckpt_root: str) -> dict:
    """``cli.main`` and the two entry twins under the mesh flags, one
    epoch each at a tiny size: name -> (steps, steps an epoch, train
    loss, the first learning rate)."""
    from faster_distributed_training_tpu_torch import cli
    from faster_distributed_training_tpu_torch.resnet50_test import (
        DEFAULTS as RESNET)
    from faster_distributed_training_tpu_torch.transformer_test import (
        DEFAULTS as TRANSFORMER)

    text = ["--dataset", "synthetic", "--epoch", "1", "--device", "cpu",
            "--n_layers", "1", "--d_model", "32", "--n_heads", "2",
            "--d_ff", "64", "--seq_len", "32", "--subset_stride", "128",
            "--bs", "8", "--precision", "fp32", "--log_every", "0",
            "--no_telemetry", "--no_plot", "--distributed", "--debug"]
    image = ["--device", "cpu", "--model", "resnet18", "--dataset",
             "synthetic", "--bs", "4", "--epoch", "1", "--subset_stride",
             "512", "--precision", "fp32", "--no_plot", "--no_telemetry",
             "--log_every", "0", "--distributed"]
    runs = {
        "dp": (text + ["--mesh", "dp=2"], TRANSFORMER),
        "fsdp_offload": (text + ["--fsdp", "--host_offload",
                                 "--offload_opt_state"], TRANSFORMER),
        "zero1_overlap": (text + ["--zero1", "--overlap_grad_reduce"],
                          TRANSFORMER),
        "resident_k2": (text + ["--mesh", "data=2", "--data_path",
                                "resident", "--steps_per_dispatch", "2"],
                        TRANSFORMER),
        "resnet_ngd_meta": (image + ["--ngd", "--meta_learning"], RESNET),
    }
    out = {}
    for name, (argv, defaults) in runs.items():
        res = cli.main(argv + ["--checkpoint_dir", f"{ckpt_root}/{name}"],
                       defaults=defaults)
        state = res["state"]
        out[name] = {"step": int(state.step),
                     "steps_per_epoch": int(res["steps_per_epoch"]),
                     "train_loss": float(res["history"]["train_loss"][0]),
                     "lr0": _first_scalar(state.tx)}
    one = cli.config_from_args(cli.build_parser(defaults=TRANSFORMER)
                               .parse_args(runs["dp"][0]),
                               defaults=TRANSFORMER)
    from faster_distributed_training_tpu_torch.optim import build_optimizer

    tx, _ = build_optimizer(one, out["dp"]["steps_per_epoch"])
    out["dp"]["lr0_one"] = _first_scalar(tx)
    return out


def cli_tp_run(ckpt_root: str) -> dict:
    """``cli.main`` of the transformer entry at ``--mesh tp=2`` (ZeRO over
    tp), one epoch at a tiny width: (steps, steps an epoch, train
    loss)."""
    from faster_distributed_training_tpu_torch import cli
    from faster_distributed_training_tpu_torch.transformer_test import (
        DEFAULTS as TRANSFORMER)

    argv = ["--dataset", "synthetic", "--epoch", "1", "--device", "cpu",
            "--n_layers", "2", "--d_model", "32", "--n_heads", "4",
            "--d_ff", "64", "--seq_len", "16", "--subset_stride", "128",
            "--bs", "8", "--precision", "fp32", "--log_every", "0",
            "--no_telemetry", "--no_plot", "--distributed", "--debug",
            "--mesh", "tp=2", "--checkpoint_dir", ckpt_root]
    res = cli.main(argv, defaults=TRANSFORMER)
    return {"step": int(res["state"].step),
            "steps_per_epoch": int(res["steps_per_epoch"]),
            "train_loss": float(res["history"]["train_loss"][0])}


def cli_sp_run(ckpt_root: str, argv=()) -> dict:
    """``cli.main`` of the transformer entry at ``--mesh sp=2`` (Ulysses
    unless ``argv`` says otherwise), one epoch at a tiny width: (steps,
    steps an epoch, train loss, test loss)."""
    from faster_distributed_training_tpu_torch import cli
    from faster_distributed_training_tpu_torch.transformer_test import (
        DEFAULTS as TRANSFORMER)

    base = ["--dataset", "synthetic", "--epoch", "1", "--device", "cpu",
            "--n_layers", "2", "--d_model", "32", "--n_heads", "4",
            "--d_ff", "64", "--seq_len", "16", "--subset_stride", "128",
            "--bs", "8", "--precision", "fp32", "--log_every", "0",
            "--no_telemetry", "--no_plot", "--distributed", "--debug",
            "--mesh", "sp=2", "--checkpoint_dir", ckpt_root, *argv]
    res = cli.main(base, defaults=TRANSFORMER)
    return {"step": int(res["state"].step),
            "steps_per_epoch": int(res["steps_per_epoch"]),
            "train_loss": float(res["history"]["train_loss"][0]),
            "test_loss": float(res["history"]["test_loss"][0])}


def fp16_planted_inf(cfg_kw: dict, init: dict, batches: list, draws: list,
                     stage: int, at_step: int, mesh_axes=("pp",)) -> dict:
    """``--precision fp16`` steps on a pp mesh with one layer gradient of
    stage ``stage`` made inf at step ``at_step`` (after the reduce, so
    only that stage sees it): per step this rank's loss scale and the
    digest of the whole state but the loss scale, the initial state's
    digest first."""
    from faster_distributed_training_tpu_torch.parallel import make_put_batch
    from faster_distributed_training_tpu_torch.train.steps import (
        StepDraws, make_train_step)

    cfg, state = build_state({**cfg_kw, "precision": "fp16"}, init,
                             mesh_axes=mesh_axes)
    pl = state.placement
    reduce, seen = pl.reduce_grads, [0]

    def plant(grads):
        out = reduce(grads)
        if seen[0] == at_step and pl.pipe.stage == stage:
            name = sorted(k for k in out if pl.homes.get(k) == stage)[0]
            out[name] = torch.full_like(out[name], float("inf"))
        seen[0] += 1
        return out
    pl.reduce_grads = plant
    put = make_put_batch(pl.group, "cpu")
    step = make_train_step(cfg)

    def trained():
        return digest({k: v for k, v in whole_leaves(state).items()
                       if not k.startswith("loss_scale/")})
    scales, digests = [], [trained()]
    for batch, d in zip(batches, draws):
        state, m = step(state, put(batch), StepDraws(**d))
        scales.append(float(m["loss_scale"]))
        digests.append(trained())
    return {"scales": scales, "digests": digests}


def cli_pp_run(ckpt_root: str, argv=()) -> dict:
    """``cli.main`` of the transformer entry at ``--mesh pp=2`` (4
    microbatches), one epoch at a tiny width: (steps, steps an epoch,
    train loss, test loss, the rule table ``--debug`` logs)."""
    import contextlib
    import io
    import json

    from faster_distributed_training_tpu_torch import cli
    from faster_distributed_training_tpu_torch.transformer_test import (
        DEFAULTS as TRANSFORMER)

    base = ["--dataset", "synthetic", "--epoch", "1", "--device", "cpu",
            "--n_layers", "2", "--d_model", "32", "--n_heads", "4",
            "--d_ff", "64", "--seq_len", "16", "--subset_stride", "128",
            "--bs", "8", "--precision", "fp32", "--log_every", "0",
            "--no_telemetry", "--no_plot", "--distributed", "--debug",
            "--mesh", "pp=2", "--pp_microbatches", "4", "--checkpoint_dir",
            ckpt_root, *argv]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = cli.main(base, defaults=TRANSFORMER)
    rules = [json.loads(line.split("[pipeline] rules ", 1)[1])
             for line in out.getvalue().splitlines()
             if line.startswith("[pipeline] rules ")]
    return {"step": int(res["state"].step),
            "steps_per_epoch": int(res["steps_per_epoch"]),
            "train_loss": float(res["history"]["train_loss"][0]),
            "test_loss": float(res["history"]["test_loss"][0]),
            "rules": rules}


def _first_scalar(tx) -> float:
    """The optimizer's first step's learning-rate scalar."""
    return float(next(iter(tx.host_scalars(0).values())))


def collectives() -> dict:
    """The host-value collectives: an int64 past 2^31 and an fp64 value
    gathered whole, a SUM, and a metrics dict summed."""
    from faster_distributed_training_tpu_torch.parallel import (
        DataGroup, all_gather_across_processes, all_reduce_metrics,
        all_sum_across_processes)

    r = DataGroup().rank
    big = np.array([2 ** 40 + r, -(2 ** 33)], np.int64)
    return {"gathered": all_gather_across_processes(big),
            "fp64": all_gather_across_processes(np.float64(1 / 3 + r)),
            "summed": all_sum_across_processes(np.array([r, 1.5])),
            "metrics": all_reduce_metrics({"bytes": 2 ** 40 + r,
                                           "files": float(r + 1)})}


def clock_skew(ckpt_root: str) -> dict:
    """``--fsdp --checkpoint_every_secs`` with rank 1's clock racing (its
    own reading: a save due every step, rank 0's: never): the ranks take
    rank 0's decision, so no rank enters the collective save alone.
    Returns the steps trained and the step checkpoints written."""
    from faster_distributed_training_tpu_torch import cli
    from faster_distributed_training_tpu_torch.train import checkpoint, loop

    if dist.get_rank() == 1:
        # 1000 s pass between any two readings
        loop.cadence_clock = itertools.count(0.0, 1000.0).__next__
    argv = ["--dataset", "synthetic", "--epoch", "1", "--device", "cpu",
            "--n_layers", "1", "--d_model", "32", "--n_heads", "2",
            "--d_ff", "64", "--seq_len", "32", "--subset_stride", "128",
            "--bs", "8", "--precision", "fp32", "--log_every", "0",
            "--no_telemetry", "--no_plot", "--fsdp",
            "--checkpoint_every_secs", "600", "--checkpoint_dir", ckpt_root]
    out = cli.main(argv, defaults=cli.TRANSFORMER_DEFAULTS)
    return {"step": int(out["state"].step), "saved": len(
        checkpoint.series_members(ckpt_root, "transformer_step"))}


def cli_argv(argv, slow_write_s: float = 0.0) -> dict:
    """``cli.main`` on ``argv`` (the transformer's defaults) joined to the
    group: the steps trained and the goodput counters.  ``slow_write_s``:
    each single-file checkpoint write sleeps that long first (a writer
    slower than a step)."""
    from faster_distributed_training_tpu_torch import cli
    from faster_distributed_training_tpu_torch.train import checkpoint

    if slow_write_s:
        write = checkpoint.write_payload

        def slow(*args, **kwargs):
            time.sleep(slow_write_s)
            return write(*args, **kwargs)
        checkpoint.write_payload = slow

    out = cli.main(list(argv) + ["--distributed"],
                   defaults=cli.TRANSFORMER_DEFAULTS)
    return {"step": int(out["state"].step),
            **{k: v for k, v in out.items() if k.startswith("goodput_")}}


def cli_logged(argv) -> dict:
    """``cli.run_training`` on ``argv`` (the transformer's defaults)
    joined to the group, with its log lines: the steps trained, the
    lines (rank 0's; the others log nothing) and the telemetry
    directory."""
    from faster_distributed_training_tpu_torch import cli

    lines = []
    parser = cli.build_parser(defaults=cli.TRANSFORMER_DEFAULTS)
    cfg = cli.config_from_args(
        parser.parse_args(list(argv) + ["--distributed"]),
        defaults=cli.TRANSFORMER_DEFAULTS)
    out = cli.run_training(cfg, log=lines.append)
    return {"step": int(out["state"].step), "lines": lines,
            "telemetry_dir": out.get("telemetry_dir")}


def resident_layouts(argv, ckpt_root: str) -> dict:
    """``cli.main`` on ``argv`` (the transformer's defaults) joined to the
    group with ``--data_path resident`` under each ``--resident_layout``:
    per layout the steps, the train losses and the digest of the final
    whole state; for the sharded layout also the rows and bytes at rest a
    rank, the view's address after every epoch and the re-shards."""
    from faster_distributed_training_tpu_torch import cli
    from faster_distributed_training_tpu_torch.train.state import (
        state_leaves)

    out = {}
    for layout in ("replicated", "sharded"):
        res = cli.main(list(argv) + [
            "--distributed", "--data_path", "resident", "--resident_layout",
            layout, "--checkpoint_dir", os.path.join(ckpt_root, layout)],
            defaults=cli.TRANSFORMER_DEFAULTS)
        src = res["trainer"].dispatch.resident
        out[layout] = {
            "step": int(res["state"].step),
            "train_loss": list(res["history"]["train_loss"]),
            "digest": digest({k: v.detach().cpu().numpy() for k, v in
                              state_leaves(res["state"]).items()}),
            "kind": type(src).__name__}
        if layout == "sharded":
            out[layout].update(rows=src.rows, nbytes=src.nbytes, n=src.n,
                               reshards=len(src.reshard_ms),
                               view_ptr=src._view.data_ptr(),
                               arrays_ptr={k: t.data_ptr() for k, t in
                                           src.arrays.items()})
    return out


def many(cases: dict) -> dict:
    """Several cases in one group: name -> (case, kwargs)."""
    return {name: CASES[case](**kw) for name, (case, kw) in cases.items()}


CASES = {"run_steps": run_steps, "restore": restore, "cli_runs": cli_runs,
         "cli_tp_run": cli_tp_run, "cli_sp_run": cli_sp_run,
         "cli_pp_run": cli_pp_run, "eval_metrics": eval_metrics,
         "fp16_planted_inf": fp16_planted_inf,
         "collectives": collectives, "clock_skew": clock_skew,
         "cli_argv": cli_argv, "cli_logged": cli_logged,
         "resident_layouts": resident_layouts,
         "many": many}
