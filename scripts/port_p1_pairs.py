#!/usr/bin/env python3
"""Phase P1's ResNet pair of ``chip_smoke.py``, run again and again.

    python3 scripts/port_p1_pairs.py [--repo DIR] [--pairs N]
        [--benchmark on|off|port] [--threads same|fresh] [--warmup N]
        [--join_first] [--grads]

One pair is P1's ResNet-50 NGD + meta run (batch 512, 2 steps, seeded
init, synthetic split) without a process group, then the same run at
``--distributed --mesh dp=1`` over NCCL.  For each run the script logs the
loss of every step and keeps every state leaf (parameters, BN buffers,
optimizer state) after every step; for each pair it prints whether the
two runs are bitwise equal and, if not, the first step and the first
leaves where they part, with the two loss courses.

``--repo DIR`` runs the port found at DIR (default: this checkout), so a
parent unpacked with ``git archive`` runs beside the change in one call.
``--benchmark`` pins cuDNN's autotuner for the ResNet runs: ``on`` and
``off`` override what the port's ``cli.run_training`` sets (``on`` is
what the port set before its fix), ``port`` leaves the port's own
choice.  ``--threads fresh`` runs every run on a new thread: cuDNN keeps
its autotuned plans per thread, so each run then chooses its
convolution algorithms anew, as a run whose convolutions meet new cache
keys does.  ``--warmup N`` runs the no-group run N times first, unpaired
(the pairs then start in a process that has trained ResNet-50 already,
as phase P1 does in the full smoke).  ``--join_first`` joins the NCCL
group (world 1) and runs one all-reduce before the pairs, as P1's
record run does before its ResNet pair; without it the first pair's
dp=1 run creates the group.  ``--grads`` also keeps, each step, the
reduced gradients handed to the optimizer, the clipped ones, each NGD
group's input, output and factors, and the preconditioned gradients, and
reports the first step and names where those part: where in the step a
difference starts.  ``--around_join`` runs, instead of pairs, one no-group run
before the NCCL group exists, then joins it and runs the no-group run and
the dp=1 run: whether joining the group alone changes the no-group run's
bits.  Needs one CUDA card.
"""

import argparse
import json
import os
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARGV = ["--model", "resnet50", "--ngd", "--meta_learning", "--bs", "512",
        "--epoch", "1", "--subset_stride", "4"]


def pin_benchmark(value: bool) -> None:
    """Make every later ``torch.backends.cudnn.benchmark = x`` set
    ``value`` instead."""
    import torch

    mod = torch.backends.cudnn
    cls = type(mod)
    get = torch._C._get_cudnn_benchmark
    cls.benchmark = property(lambda self: get(),
                             lambda self, v: torch._C._set_cudnn_benchmark(
                                 value))
    mod.benchmark = value


def run_once(cli, cs, extra, tag, build_dir, fresh: bool,
             grads: bool = False):
    """One ResNet run: (per-step losses, per-step leaves on the card, the
    per-step reduced gradients with ``grads``)."""
    import torch

    from faster_distributed_training_tpu_torch.train import steps as steps_mod
    from faster_distributed_training_tpu_torch.train.state import (
        state_leaves)

    cfg = cs.resnet_cfg(cli, ARGV + extra + [
        "--checkpoint_dir", os.path.join(build_dir, f"p1pairs_{tag}")])
    from faster_distributed_training_tpu_torch.optim import builder, ngd

    losses, leaves, seen = [], [], []
    make_step = steps_mod.make_train_step
    apply_update = steps_mod.apply_update
    clip = builder.clip_by_global_norm
    precondition = ngd.precondition_group
    scale = ngd.ScaleByNGD.update

    def keep(prefix, tensors):
        seen[-1].update({f"{prefix}/{k}": v.detach().clone()
                         for k, v in tensors.items()})

    def spy(state, g, *args, **kw):
        seen.append({})
        keep("grads", g)
        return apply_update(state, g, *args, **kw)

    def spy_clip(g, *args, **kw):
        out = clip(g, *args, **kw)
        keep("clipped", out)
        return out

    def spy_group(group, t, xs, hp):
        n = len([k for k in seen[-1] if k.startswith("ngd_in/")])
        keep("ngd_in", {str(n): xs})
        out = precondition(group, t, xs, hp)
        keep("ngd_out", {str(n): out})
        keep(f"ngd_factors/{n}", group)
        return out

    def spy_scale(self, g, state):
        out = scale(self, g, state)
        keep("preconditioned", out)
        return out

    def recording(cfg_):
        inner = make_step(cfg_)

        def run(state, batch, draws=None):
            state, metrics = inner(state, batch, draws)
            losses.append(float(metrics["loss"]))
            leaves.append({k: v.detach().clone()
                           for k, v in state_leaves(state).items()})
            return state, metrics
        return run

    box = {}

    def body():
        steps_mod.make_train_step = recording
        if grads:
            steps_mod.apply_update = spy
            builder.clip_by_global_norm = spy_clip
            ngd.precondition_group = spy_group
            ngd.ScaleByNGD.update = spy_scale
        try:
            box["out"] = cli.run_training(cfg, log=lambda line: None)
        except BaseException as e:   # re-raised on the caller's thread
            box["err"] = e
        finally:
            steps_mod.make_train_step = make_step
            steps_mod.apply_update = apply_update
            builder.clip_by_global_norm = clip
            ngd.precondition_group = precondition
            ngd.ScaleByNGD.update = scale
        torch.cuda.synchronize()

    if fresh:
        t = threading.Thread(target=body)
        t.start()
        t.join()
    else:
        body()
    if "err" in box:
        raise box["err"]
    return losses, leaves, seen


def _part(xs, ys) -> dict:
    """The first step and names where two per-step dicts part."""
    import torch

    for i, (x, y) in enumerate(zip(xs, ys)):
        bad = [k for k in x if not torch.equal(x[k], y[k])]
        if bad:
            return {"first_step": i + 1, "differing": len(bad),
                    "of": len(x), "first": bad[:6]}
    return {}


def compare(a, b) -> dict:
    """Where two runs' per-step leaves (and gradients, when kept) part:
    {equal, step, leaves}."""
    out = {"equal": not _part(a[1], b[1]) and len(a[1]) == len(b[1]),
           "steps": len(a[1]), "leaves": _part(a[1], b[1])}
    if a[2] and b[2]:
        out["grads"] = _part(a[2], b[2])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--benchmark", choices=("on", "off", "port"),
                    default="port")
    ap.add_argument("--threads", choices=("same", "fresh"), default="same")
    ap.add_argument("--warmup", type=int, default=0)
    ap.add_argument("--join_first", action="store_true")
    ap.add_argument("--grads", action="store_true")
    ap.add_argument("--around_join", action="store_true")
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("port_p1_pairs: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from faster_distributed_training_tpu_torch import cli

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.benchmark != "port":
        pin_benchmark(args.benchmark == "on")
    build_dir = tempfile.mkdtemp(prefix="p1pairs_")
    os.environ.update(cs.mesh_env(cs.free_port()))
    what = (f"repo {repo}, cudnn {torch.backends.cudnn.version()}, "
            f"benchmark {args.benchmark}, threads {args.threads}, warm-up "
            f"runs {args.warmup}, group joined first {args.join_first}")
    print(f"[p1 pairs] {what}", flush=True)
    fresh = args.threads == "fresh"

    def join():
        from faster_distributed_training_tpu_torch.parallel import (
            initialize_distributed)

        initialize_distributed("cuda")
        dist.all_reduce(torch.ones(1, device="cuda"))
        torch.cuda.synchronize()

    def host():
        return {"cpus": len(os.sched_getaffinity(0)),
                "torch_threads": torch.get_num_threads(),
                "free_bytes": torch.cuda.mem_get_info()[0]}

    if args.around_join:
        before = run_once(cli, cs, [], "before", build_dir, fresh,
                          args.grads)
        host_before = host()
        join()
        print(json.dumps({"host before joining": host_before,
                          "after": host()}), flush=True)
        after = run_once(cli, cs, [], "after", build_dir, fresh, args.grads)
        dp1 = run_once(cli, cs, ["--distributed", "--mesh", "dp=1"], "dp1",
                       build_dir, fresh, args.grads)
        res = {"no group before vs after joining": compare(before, after),
               "no group after joining vs dp=1": compare(after, dp1),
               "losses": [before[0], after[0], dp1[0]]}
        print(json.dumps({"p1_around_join": what, **res}), flush=True)
        dist.destroy_process_group()
        return 0
    if args.join_first:
        join()
    for i in range(args.warmup):
        run_once(cli, cs, [], f"w{i}", build_dir, fresh)
    results = []
    for i in range(args.pairs):
        t0 = time.monotonic()
        a = run_once(cli, cs, [], f"a{i}", build_dir, fresh, args.grads)
        b = run_once(cli, cs, ["--distributed", "--mesh", "dp=1"], f"b{i}",
                     build_dir, fresh, args.grads)
        r = compare(a, b)
        r.update(pair=i, loss_no_group=a[0], loss_dp1=b[0],
                 seconds=round(time.monotonic() - t0, 1))
        results.append(r)
        print(f"[p1 pair {i}] {json.dumps(r)}", flush=True)
        del a, b
    if dist.is_initialized():
        dist.destroy_process_group()
    n_eq = sum(r["equal"] for r in results)
    print(json.dumps({"p1_pairs": what, "pairs": len(results),
                      "bitwise_pairs": n_eq}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
