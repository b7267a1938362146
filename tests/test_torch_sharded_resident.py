"""The port's sharded device-resident layout
(``data/device_resident.py::ShardedDeviceResidentData``,
``--resident_layout sharded``) against the JAX package's.

  * Each simulated rank's batch-major view ``[steps, local_bs, ...]`` of
    every batch is bitwise its rows of JAX
    ``ShardedDeviceResidentData.epoch_arrays`` on the suite's CPU mesh
    (JAX ``tests/test_pod_scale.py:72-``), for images at 2 and 4 ranks
    and for text, over two epochs.  The ranks run in this process: each
    builds its ``send_buffer``, the test routes the chunks as
    ``all_to_all_single`` would, and each ``receive``s.
  * Storage a rank is its ceil(n / pc) contiguous rows, and the exchange
    plan is what ``pod_epoch_order`` asks of it.
  * The view is allocated once: its address (and every leaf's) is the
    same after the epoch turns, and ``epoch_arrays`` of the current epoch
    does not re-shard.
  * ``build_device_resident`` resolves the layouts as JAX does (``auto``
    is sharded over more than one process).
  * Two gloo ranks (``tests/torch_dist_worker.py``) at dp=2 train 2
    epochs of 2 steps at K=2 through ``cli.main``: the sharded layout's
    final state is bitwise the replicated layout's, each rank holding
    half the rows and re-sharding once an epoch.
"""

import os

import numpy as np
import pytest
import torch

from faster_distributed_training_tpu.data import (
    ShardedDeviceResidentData as JSharded)
from faster_distributed_training_tpu.parallel import make_mesh as j_make_mesh
from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.data.device_resident import (
    DeviceResidentData, ShardedDeviceResidentData, build_device_resident)
from faster_distributed_training_tpu_torch.data.loader import pod_epoch_order
from faster_distributed_training_tpu_torch.data.synthetic import (
    synthetic_agnews, synthetic_cifar)

import torch_dist_worker as W


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: under the suite's parallel workers torch's
    thread-a-core default oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ranks(data, pc, bs=16, seed=42, max_len=512):
    return [ShardedDeviceResidentData(data, bs, seed=seed, max_len=max_len,
                                      device="cpu", process_index=pi,
                                      process_count=pc)
            for pi in range(pc)]


def _exchange(ranks, epoch):
    """The ranks' all-to-all in one process: rank d receives, from every
    rank s in rank order, the chunk s sends to d."""
    sends = [r.send_buffer(epoch) for r in ranks]
    for d, r in enumerate(ranks):
        chunks = []
        for buf, sizes, _ in sends:
            off = sum(sizes[:d])
            chunks.append(buf[off:off + sizes[d]])
        assert [len(c) for c in chunks] == sends[d][2]
        r.receive(epoch, torch.cat(chunks))


@pytest.mark.parametrize("pc", [2, 4])
def test_image_views_equal_jax_epoch_arrays(pc):
    x, y = synthetic_cifar(70, seed=3)
    bs, lbs = 16, 16 // pc
    theirs = JSharded((x, y), bs, seed=42, mesh=j_make_mesh(("dp",), (8,)),
                      process_count=pc)
    ranks = _ranks((x, y), pc)
    assert ranks[0].steps_per_epoch == theirs.steps_per_epoch
    for epoch in (0, 2):
        view = {k: np.asarray(v) for k, v in
                theirs.epoch_arrays(epoch).items()}
        _exchange(ranks, epoch)
        for pi, r in enumerate(ranks):
            for k in ("image", "label"):
                want = view[k][:, pi * lbs:(pi + 1) * lbs]
                got = r.arrays[k].numpy()
                assert got.dtype == want.dtype and got.shape == want.shape
                assert got.tobytes() == np.ascontiguousarray(
                    want).tobytes(), (k, pi, epoch)


def test_text_views_equal_jax_epoch_arrays():
    ds = synthetic_agnews(40, max_len=60, seed=7)
    bs, pc = 8, 2
    theirs = JSharded(ds, bs, seed=9, max_len=64,
                      mesh=j_make_mesh(("dp",), (8,)), process_count=pc)
    ranks = _ranks(ds, pc, bs=bs, seed=9, max_len=64)
    assert ranks[0].seq_len == theirs.seq_len
    for epoch in (1, 3):
        view = {k: np.asarray(v) for k, v in
                theirs.epoch_arrays(epoch).items()}
        _exchange(ranks, epoch)
        for pi, r in enumerate(ranks):
            assert sorted(r.arrays) == sorted(view)
            for k in view:
                want = view[k][:, pi * 4:(pi + 1) * 4]
                np.testing.assert_array_equal(r.arrays[k].numpy(), want,
                                              err_msg=k)


def test_storage_is_a_rank_s_rows_and_the_plan_is_the_order():
    x, y = synthetic_cifar(70, seed=3)
    ranks = _ranks((x, y), 4)
    rows = -(-70 // 4)
    for pi, r in enumerate(ranks):
        assert r.rows == rows and r.shards["image"].shape[0] == rows
        hi = min((pi + 1) * rows, 70)
        np.testing.assert_array_equal(r.shards["image"][:hi - pi * rows]
                                      .numpy(), x[pi * rows:hi])
        assert not r.shards["image"][hi - pi * rows:].numpy().any()
        assert r.nbytes == rows * r.row_bytes < x.nbytes + y.nbytes
        p = r.plan(1)
        order = pod_epoch_order(70, 1, 42, True, 4, 4).reshape(-1, 4, 4)
        assert sum(p["recv_sizes"]) == order[:, pi].size
        assert sorted(p["perm"]) == list(range(order[:, pi].size))
    sent = sum(sum(r.plan(1)["send_sizes"]) for r in ranks)
    assert sent == ranks[0].steps_per_epoch * 16


def test_view_is_allocated_once():
    x, y = synthetic_cifar(70, seed=3)
    r = ShardedDeviceResidentData((x, y), 16, seed=42, device="cpu")
    arrays = r.epoch_arrays(0)
    ptrs = {k: t.data_ptr() for k, t in arrays.items()}
    first = arrays["image"].clone()
    assert r.epoch_arrays(0) is arrays and len(r.reshard_ms) == 1
    again = r.epoch_arrays(1)
    assert again is arrays and len(r.reshard_ms) == 2
    assert {k: t.data_ptr() for k, t in again.items()} == ptrs
    assert not torch.equal(again["image"], first)
    order = pod_epoch_order(70, 1, 42, True, 1, 16).reshape(-1, 16)
    np.testing.assert_array_equal(again["image"].numpy(), x[order])


def test_layouts_resolve_as_jax():
    x, y = synthetic_cifar(64, seed=3)
    cfg = TrainConfig(data_path="resident", batch_size=16, seq_len=32)
    assert isinstance(build_device_resident(cfg, (x, y), "cpu"),
                      DeviceResidentData)
    for layout, pc, kind in (("auto", 2, ShardedDeviceResidentData),
                             ("sharded", 1, ShardedDeviceResidentData),
                             ("replicated", 2, DeviceResidentData)):
        got = build_device_resident(cfg.replace(resident_layout=layout),
                                    (x, y), "cpu", process_count=pc)
        assert type(got) is kind, layout
    with pytest.raises(ValueError, match="resident_layout"):
        build_device_resident(cfg.replace(resident_layout="striped"),
                              (x, y), "cpu")
    assert build_device_resident(cfg.replace(data_path="host"), (x, y),
                                 "cpu") is None


def test_dp2_sharded_is_bitwise_the_replicated_layout(tmp_path):
    argv = ["--dataset", "synthetic", "--epoch", "2", "--device", "cpu",
            "--n_layers", "1", "--d_model", "32", "--n_heads", "2",
            "--d_ff", "64", "--seq_len", "32", "--subset_stride", "128",
            "--bs", "16", "--precision", "fp32", "--log_every", "0",
            "--no_telemetry", "--no_plot", "--mesh", "dp=2",
            "--steps_per_dispatch", "2"]
    runs = W.launch("resident_layouts", 2, str(tmp_path / "g"),
                    timeout=240.0, argv=argv,
                    ckpt_root=str(tmp_path / "ck"))
    for rank, r in enumerate(runs):
        rep, sh = r["replicated"], r["sharded"]
        assert rep["kind"] == "DeviceResidentData"
        assert sh["kind"] == "ShardedDeviceResidentData"
        assert rep["step"] == sh["step"] == 4
        assert sh["train_loss"] == rep["train_loss"]
        assert sh["digest"] == rep["digest"], rank
        assert sh["rows"] == -(-sh["n"] // 2) and sh["reshards"] == 2
    assert runs[0]["sharded"]["digest"] == runs[1]["sharded"]["digest"]
    assert os.path.isdir(tmp_path / "ck" / "sharded")
