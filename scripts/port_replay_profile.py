#!/usr/bin/env python3
"""How many kernel records torch.profiler sees in a replayed step graph.

    python3 scripts/port_replay_profile.py        # on a CUDA card

The port's K-step dispatch (``train/dispatch.py``) replays a captured CUDA
graph, so the kernel wrappers' launch counts do not see the replays and
``chip_smoke.py`` counts their kernels from torch.profiler's CUDA
activity.  This script measures that source on the transformer_test.py
record (6 layers, d_model 512, batch 16, L 512, synthetic split, seeded
init): the kernel records of one eager step, of 4 and 16 eager steps,
then three profiles each of one dispatch of K = 4, 8 and 16 steps from
the resident split, with the hand kernels' counts and every kernel name
whose count is not K times one eager step's; last, 16 steps at K=16
resident against 16 eager K=1 steps through ``cli.run_training``,
bitwise on every parameter, buffer and optimizer leaf (a replay that
skipped a kernel would leave a different state).
"""

import itertools
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    import torch

    import chip_smoke as cs
    from faster_distributed_training_tpu_torch import cli
    from faster_distributed_training_tpu_torch.data.device_resident import (
        DeviceResidentData)
    from faster_distributed_training_tpu_torch.data.loader import BatchLoader
    from faster_distributed_training_tpu_torch.ops import _build
    from faster_distributed_training_tpu_torch.train.dispatch import (
        FusedDispatch)
    from faster_distributed_training_tpu_torch.train.steps import (
        make_train_step, to_device)

    if not torch.cuda.is_available():
        print("port_replay_profile: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    bd = str(_build.BUILD_DIR)
    cfg = cs.record_cfg(cli, [], "replay_profile", bd)
    B, L = cfg.batch_size, cfg.seq_len
    data = cli.load_dataset(cfg.replace(dataset="synthetic"), True)
    state = cs.record_state(cli, cfg)
    step = make_train_step(cfg)
    host = list(itertools.islice(iter(BatchLoader(
        data, B, epoch=0, seed=cfg.seed, max_len=L)), 16))

    def total(kern):
        return sum(c for _, c in kern.values())

    for _ in range(2):
        step(state, to_device(host[0], "cuda"))
    k1 = cs.device_kernels(lambda: step(state, to_device(host[0], "cuda")), 1)
    print("K=1 total", total(k1), cs.hand_launches(k1), flush=True)
    for n in (4, 16):
        kb = cs.device_kernels(
            lambda: [step(state, to_device(b, "cuda")) for b in host[:n]], 1)
        print(f"{n} eager total", total(kb),
              f"x{total(kb) / total(k1):.4f}", cs.hand_launches(kb),
              flush=True)
    res = DeviceResidentData(data, B, seed=cfg.seed, max_len=L,
                             device="cuda")
    for k in (4, 8, 16):
        disp = FusedDispatch(cfg, k, "cuda", resident=res)
        disp.set_epoch(0)
        disp.run(state, k, start=0)
        torch.cuda.synchronize()
        for r in range(3):
            kk = cs.device_kernels(lambda: disp.run(state, k, start=0), 1)
            print(f"K={k} try {r}: total {total(kk)} "
                  f"(x{total(kk) / total(k1):.4f}) hand "
                  f"{cs.hand_launches(kk)}", flush=True)
            off = {n[:50]: (c, k * k1.get(n, (0, 0))[1])
                   for n, (_, c) in kk.items()
                   if c != k * k1.get(n, (0, 0))[1]}
            print("   off:", off, flush=True)
        del disp
    base = ["--subset_stride", "16"]
    _, want, _ = cs.counted_run(cli, cs.record_cfg(cli, base, "rp1", bd),
                                "K=1")
    _, got, _ = cs.counted_run(cli, cs.record_cfg(
        cli, base + ["--steps_per_dispatch", "16", "--data_path",
                     "resident"], "rp16", bd), "K=16")
    cs.bitwise("K=16 resident vs K=1 (16 steps)", want, got)
    return 0


if __name__ == "__main__":
    sys.exit(main())
