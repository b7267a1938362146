"""The port's stream window (``data/stream/window.py``, ``--data_path
stream``) against the JAX package's (``data/stream/window.py``).

  * Window bytes: ``DiskStreamSource.host_buffer`` equals JAX
    ``DiskStreamSource.host_buffer`` byte for byte on the same shards, for
    images at 1, 2 and 4 simulated processes (every window position, the
    zero-padded tail included) and for text, where it is also
    ``encode_batch`` of ``pod_epoch_order``'s rows (JAX
    ``tests/test_stream.py:155-209``).
  * The lifecycle (JAX ``tests/test_stream.py:211-291``): the refills
    serve the epoch and a window opened at ``start_step`` seeks there;
    ``close()`` after an abnormal exit joins the producer (no thread left
    alive) and is idempotent; a request that skips a window or runs past
    the epoch raises; the window rounds up to a multiple of K with a
    warning; a dataset smaller than one local batch is refused.
  * The two slots on the CPU: with a producer slowed down, the consumer
    is never handed a slot whose refill has not finished, each slot holds
    exactly the batches it was handed out for, and a refill never starts
    on the slot being read.
  * Streamed training of a tiny LM (2 layers, d_model 64, no dropout, so
    both packages' runs are a function of the initial parameters and the
    data order; SGD: JAX's K-step scan refuses MADGRAD's state under the
    suite's 64-bit types; JAX's initial parameters handed to the port):
    against
    JAX's streamed run on the same corpus (loss 1e-5, parameters 1e-4);
    bitwise the port's ``--data_path resident`` run at the same K (JAX
    ``test_resident_reference_is_bitwise_equal``); and a run killed
    inside a window (step 6 of window [4, 8)) resumes under
    ``--supervise`` bitwise on the uninterrupted run (JAX
    ``test_killed_mid_window_resumes_bitwise``).
"""

import threading
import time
import warnings

import jax
import numpy as np
import pytest
import torch

from faster_distributed_training_tpu import cli as jcli
from faster_distributed_training_tpu.config import TrainConfig as JConfig
from faster_distributed_training_tpu.data.stream import (
    DiskStreamSource as JSource)
from faster_distributed_training_tpu.data.stream import (
    ShardedStreamDataset as JReader)
from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.data.loader import pod_epoch_order
from faster_distributed_training_tpu_torch.data.stream import (
    DiskStreamSource, ShardedStreamDataset, synthetic_corpus,
    write_array_dataset, write_lm_corpus)
from faster_distributed_training_tpu_torch.data.synthetic import (
    synthetic_cifar)
from faster_distributed_training_tpu_torch.interop import (flatten,
                                                           params_to_jax)
from faster_distributed_training_tpu_torch.resilience import faults


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: under the suite's parallel workers torch's
    thread-a-core default oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def image_stream(tmp_path_factory):
    """96 CIFAR-shaped samples at 25 rows a shard: four shards, the last
    partial, so windows cross shard boundaries."""
    x, y = synthetic_cifar(96, seed=3)
    d = str(tmp_path_factory.mktemp("img_stream"))
    write_array_dataset(d, {"image": x, "label": y}, rows_per_shard=25)
    return d, x, y


@pytest.fixture(scope="module")
def lm_corpus(tmp_path_factory):
    """A synthetic-text LM corpus packed at seq 16, several shards."""
    root = tmp_path_factory.mktemp("lm_stream")
    texts = synthetic_corpus(40, seed=3, words_per_doc=(25, 50))
    write_lm_corpus(str(root / "c"), texts, seq_len=16, rows_per_shard=16,
                    val_fraction=0.15, data_dir=str(root / "dd"),
                    log=lambda _: None)
    train = ShardedStreamDataset(str(root / "c" / "train"))
    assert len(train.manifest["shards"]) > 1
    return str(root / "c"), train


# -- window bytes -------------------------------------------------------------


@pytest.mark.parametrize("pc", [1, 2, 4])
def test_image_host_buffers_equal_jax(image_stream, pc):
    d, x, y = image_stream
    bs, lbs = 8, 8 // pc
    mine = [DiskStreamSource(ShardedStreamDataset(d), bs, seed=5,
                             window_batches=5, process_index=pi,
                             process_count=pc) for pi in range(pc)]
    theirs = [JSource(JReader(d), bs, seed=5, window_batches=5,
                      process_index=pi, process_count=pc)
              for pi in range(pc)]
    steps = mine[0].steps_per_epoch
    assert steps == theirs[0].steps_per_epoch == 96 // 8
    for epoch in (0, 1):
        order = mine[0].epoch_order(epoch)
        np.testing.assert_array_equal(order, theirs[0].epoch_order(epoch))
        np.testing.assert_array_equal(
            order, pod_epoch_order(96, epoch, 5, True, pc, lbs))
        for base in range(0, steps, 5):           # the short tail too
            hi = min(base + 5, steps)
            for m, t in zip(mine, theirs):
                a, b = m.host_buffer(order, base, hi), t.host_buffer(
                    order, base, hi)
                assert sorted(a) == sorted(b) == ["image", "label"]
                for k in a:
                    assert a[k].dtype == b[k].dtype and a[k].shape == \
                        b[k].shape == (5, lbs) + x.shape[1:] * (k == "image")
                    assert a[k].tobytes() == b[k].tobytes(), (k, base)
            glob = np.concatenate([m.host_buffer(order, base, hi)["image"]
                                   for m in mine], axis=1)
            for b in range(base, hi):
                np.testing.assert_array_equal(
                    glob[b - base], x[order[b * bs:(b + 1) * bs]])
            if hi - base < 5:
                assert not glob[hi - base:].any()


def test_text_host_buffer_equals_jax_and_encode_batch(lm_corpus):
    d, train = lm_corpus
    pc, bs = 2, 8
    jtrain = JReader(train.directory)
    order = pod_epoch_order(train.n, 1, 0, True, pc, bs // pc)
    for pi in range(pc):
        src = DiskStreamSource(train, bs, seed=0, window_batches=3,
                               process_index=pi, process_count=pc,
                               max_len=16)
        jsrc = JSource(jtrain, bs, seed=0, window_batches=3,
                       process_index=pi, process_count=pc, max_len=16)
        buf = src.host_buffer(src.epoch_order(1), 0, 3)
        jbuf = jsrc.host_buffer(jsrc.epoch_order(1), 0, 3)
        assert sorted(buf) == sorted(jbuf) == ["label", "mask",
                                               "token_types", "tokens"]
        idx = order.reshape(-1, pc, bs // pc)[0:3, pi]
        ref = train.encode_batch(idx.reshape(-1), 16)
        for k in ref:
            assert buf[k].tobytes() == jbuf[k].tobytes(), k
            np.testing.assert_array_equal(
                buf[k].reshape((-1,) + buf[k].shape[2:]), ref[k])


# -- the lifecycle --------------------------------------------------------------


def _rows(src, slot, base, n):
    """Batch n as the dispatch reads it: row slot * W + n - base."""
    return {k: t[slot * src.window + n - base].numpy()
            for k, t in src.arrays.items()}


def test_refills_serve_the_epoch_and_seek(image_stream):
    d, x, _y = image_stream
    src = DiskStreamSource(ShardedStreamDataset(d), 8, seed=5,
                           window_batches=4)
    order = src.epoch_order(0).reshape(-1, 8)
    win = src.epoch_window(0)
    try:
        for n in range(src.steps_per_epoch):
            base, hi, slot = win.buffer_for(n)
            assert base <= n < hi and slot == (base // 4) % 2
            np.testing.assert_array_equal(_rows(src, slot, base, n)["image"],
                                          x[order[n]])
    finally:
        win.close()
    assert win.refills == 3 and win.stalls == 3
    seek = src.epoch_window(0, start_step=9)
    try:
        base, hi, slot = seek.buffer_for(9)
        assert (base, hi, slot) == (9, 12, 0)
        np.testing.assert_array_equal(_rows(src, slot, base, 9)["image"],
                                      x[order[9]])
    finally:
        seek.close()


def test_close_after_an_abnormal_exit_joins_the_producer(image_stream):
    d, *_ = image_stream
    src = DiskStreamSource(ShardedStreamDataset(d), 8, seed=5,
                           window_batches=2)
    before = threading.active_count()
    win = src.epoch_window(0)
    with pytest.raises(RuntimeError, match="injected"):
        try:
            win.buffer_for(0)                 # the next refill in flight
            raise RuntimeError("injected mid-epoch fault")
        finally:
            win.close()
    assert not any(t.is_alive() for t in win._it._ex._threads)
    assert threading.active_count() <= before
    win.close()                               # idempotent
    assert src.in_use == [False, False]


def test_consumer_must_advance_monotonically(image_stream):
    d, *_ = image_stream
    src = DiskStreamSource(ShardedStreamDataset(d), 8, seed=5,
                           window_batches=2)
    win = src.epoch_window(0)
    try:
        win.buffer_for(0)
        with pytest.raises(RuntimeError, match="skew"):
            win.buffer_for(7)                 # skipped a whole window
    finally:
        win.close()
    tail = src.epoch_window(0, start_step=10)
    try:
        tail.buffer_for(10)
        with pytest.raises(RuntimeError, match="exhausted"):
            tail.buffer_for(src.steps_per_epoch)
    finally:
        tail.close()


def test_window_rounds_up_and_small_datasets_are_refused(image_stream):
    d, *_ = image_stream
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        src = DiskStreamSource(ShardedStreamDataset(d), 8, window_batches=3,
                               steps_per_dispatch=2)
    assert src.window == 4
    assert any("dispatch-aligned" in str(x.message) for x in w)
    assert tuple(src.slots["image"].shape) == (2, 4, 8, 32, 32, 3)
    assert src.nbytes == src.device_bytes == 2 * 4 * 8 * (32 * 32 * 3 + 4)
    with pytest.raises(ValueError, match="nothing to train on"):
        DiskStreamSource(ShardedStreamDataset(d), 128, process_count=2,
                         process_index=0)


def test_two_slots_never_hand_out_an_unfinished_refill(image_stream,
                                                      monkeypatch):
    d, x, _y = image_stream
    src = DiskStreamSource(ShardedStreamDataset(d), 8, seed=5,
                           window_batches=2)
    order = src.epoch_order(1).reshape(-1, 8)
    real = src.host_buffer
    seen = []

    def slow(order_, base, hi):
        # the consumer holds the other slot the whole time this runs
        seen.append((base, list(src.in_use), list(src.slot_range)))
        time.sleep(0.03)
        return real(order_, base, hi)
    monkeypatch.setattr(src, "host_buffer", slow)
    win = src.epoch_window(1)
    waits = []
    try:
        for n in range(src.steps_per_epoch):
            base, hi, slot = win.buffer_for(n)
            if n == base:
                waits.append(win.last_wait)
            assert src.slot_range[slot] == (base, hi)
            assert src.in_use[slot] and not src.in_use[1 - slot]
            for b in range(base, hi):
                np.testing.assert_array_equal(
                    _rows(src, slot, base, b)["image"], x[order[b]])
    finally:
        win.close()
    assert [b for b, _, _ in seen] == list(range(0, 12, 2))
    for base, in_use, ranges in seen:
        slot = (base // 2) % 2
        assert not in_use[slot]               # never the slot being read
        assert ranges[slot] is None           # marked unfinished
    # the consumer waited for the slowed refills
    assert sum(w > 0.01 for w in waits) >= 3


# -- streamed training ----------------------------------------------------------

LM = dict(model="transformer", dataset="stream", task="lm", batch_size=8,
          seq_len=16, n_layers=2, d_model=64, d_ff=128, n_heads=4, epochs=2,
          precision="fp32", plot=False, log_every=0, dropout_impl="none",
          telemetry=False, steps_per_dispatch=2, stream_window=4,
          optimizer="sgd")


def _jcfg(corpus, tmp, **kw):
    # one device: the suite's virtual CPU devices would make a dp mesh
    return JConfig(stream_dir=corpus, checkpoint_dir=str(tmp), donate=False,
                   mesh_shape=(1,), workers=0, **dict(LM, **kw))


def _pcfg(corpus, tmp, **kw):
    return TrainConfig(stream_dir=corpus, checkpoint_dir=str(tmp),
                       device="cpu", **dict(LM, **kw))


@pytest.fixture(scope="module")
def streamed(lm_corpus, tmp_path_factory):
    """JAX's initial parameters, JAX's streamed run and the port's from
    them."""
    corpus, train = lm_corpus
    assert train.n // 8 >= 8            # room for a kill inside [4, 8)
    root = tmp_path_factory.mktemp("streamed")
    j0 = jcli.run_training(_jcfg(corpus, root / "j0", epochs=0,
                                 data_path="host"), log=lambda *_: None)
    params = jax.tree_util.tree_map(np.asarray, j0["state"].params)
    jout = jcli.run_training(_jcfg(corpus, root / "j", data_path="stream"),
                             log=lambda *_: None)
    logs = []
    port = cli.run_training(_pcfg(corpus, root / "p", data_path="stream"),
                            params=params, log=logs.append)
    return {"params": params, "jax": jout, "port": port, "logs": logs}


def _leaves(out):
    return {k: v.clone() for k, v in out["state"].model.state_dict().items()}


def _assert_bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_streamed_lm_run_matches_jax(streamed):
    port, jout = streamed["port"], streamed["jax"]
    steps = port["steps_per_epoch"] * 2
    assert int(port["state"].step) == int(jout["state"].step) == steps
    assert any("streaming train split from disk" in x
               for x in streamed["logs"])
    assert "stream_stall_pct" in port and "stream_stall_pct" in jout
    assert port["stream"].refills == 2 * -(-port["steps_per_epoch"] // 4)
    np.testing.assert_allclose(port["history"]["train_loss"],
                               jout["history"]["train_loss"], rtol=0,
                               atol=1e-5)
    want = flatten(jax.tree_util.tree_map(
        np.asarray, jout["state"].params["model"]))
    got = flatten(params_to_jax(port["state"].model.state_dict(), 4))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)


def test_streamed_run_is_bitwise_the_resident_run(streamed, lm_corpus,
                                                  tmp_path):
    corpus, _ = lm_corpus
    res = cli.run_training(_pcfg(corpus, tmp_path, data_path="resident"),
                           params=streamed["params"], log=lambda *_: None)
    assert int(res["state"].step) == int(streamed["port"]["state"].step)
    _assert_bitwise(_leaves(res), _leaves(streamed["port"]))
    assert res["history"]["train_loss"] == \
        streamed["port"]["history"]["train_loss"]


def test_killed_mid_window_resumes_bitwise(streamed, lm_corpus, tmp_path,
                                           monkeypatch):
    corpus, _ = lm_corpus
    monkeypatch.setenv(faults.ENV_DIE, "6")
    logs = []
    got = cli.run_training(
        _pcfg(corpus, tmp_path, data_path="stream", supervise=True,
              checkpoint_every=4, checkpoint_async=False),
        params=streamed["params"], log=logs.append)
    assert got["goodput_restarts"] == 1
    assert any("stream seek to batch 4" in x for x in logs)
    assert int(got["state"].step) == int(streamed["port"]["state"].step)
    _assert_bitwise(_leaves(got), _leaves(streamed["port"]))
