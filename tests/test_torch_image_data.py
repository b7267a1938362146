"""The port's image data path against the JAX package's, bitwise.

  * ``data.synthetic.synthetic_cifar`` against JAX
    ``data/synthetic.py::synthetic_cifar``: equal bytes and labels.
  * ``data.cifar10``: pickled batches written to ``tmp_path`` (the
    CIFAR-10 format, small), read back with their MD5s by the port's and
    JAX's ``_load_batches``: equal arrays; a wrong MD5 or a missing file
    raises in both.
  * The image ``BatchLoader`` order (train: shuffled, the trailing
    partial batch dropped; eval: padded with ``valid``) against JAX
    ``data/loader.py::BatchLoader`` for several (n, seed, epoch), equal
    arrays; ``ParallelBatchIterator`` on 1 or 3 threads (``--workers``)
    yields the same batches from any start, raises a worker's exception
    at its batch, and stops on ``close``.
  * ``data.augment.augment_batch`` given JAX's crop offsets and flip bits
    (drawn from the keys JAX ``data/augment.py::augment_batch`` splits)
    against it: equal floats; eval normalize equal.
  * Mixup given JAX's lambda and permutation: static and intra
    (``train/mixup.py::mixup_data``), meta and attn
    (``meta_mixup_apply``, ``attn_mixup_apply``): equal mixed images and
    labels (attn: 1e-6, the sigmoid differs by 1 ulp on a few pixels);
    lambdas and ``lam_scale`` 1e-6 relative (measured 1.5e-7).
  * The ``resnet50_test`` twin holds JAX's ``DEFAULTS`` record, and
    ``--dataset cifar10`` without the batches prints the JAX package's
    fallback line and trains on ``synthetic_cifar``.
"""

import hashlib
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_distributed_training_tpu.data import augment as j_augment
from faster_distributed_training_tpu.data import cifar10 as j_cifar10
from faster_distributed_training_tpu.data.loader import (
    BatchLoader as JBatchLoader)
from faster_distributed_training_tpu.data.synthetic import (
    synthetic_cifar as j_synthetic_cifar)
from faster_distributed_training_tpu.train import mixup as j_mixup
from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch.data import cifar10
from faster_distributed_training_tpu_torch.data.augment import (
    augment_batch, normalize)
from faster_distributed_training_tpu_torch.data.loader import (
    BatchLoader, ParallelBatchIterator)
from faster_distributed_training_tpu_torch.data.synthetic import (
    synthetic_cifar)
from faster_distributed_training_tpu_torch.train import mixup



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes,
    and torch's default of a thread a core in each oversubscribes the
    CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

@pytest.mark.parametrize("n,seed", [(16, 0), (37, 1)])
def test_synthetic_cifar_is_bitwise(n, seed):
    x, y = synthetic_cifar(n=n, seed=seed)
    jx, jy = j_synthetic_cifar(n=n, seed=seed)
    assert x.dtype == np.uint8 and x.shape == (n, 32, 32, 3)
    assert np.array_equal(x, jx) and np.array_equal(y, jy)
    assert y.dtype == jy.dtype == np.int32


def _write_batches(root, names, n=5):
    rng = np.random.default_rng(7)
    os.makedirs(os.path.join(root, cifar10.BASE))
    md5 = {}
    for name in names:
        entry = {"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                 "labels": rng.integers(0, 10, n).tolist()}
        path = os.path.join(root, cifar10.BASE, name)
        with open(path, "wb") as f:
            pickle.dump(entry, f)
        with open(path, "rb") as f:
            md5[name] = hashlib.md5(f.read()).hexdigest()
    return md5


def test_cifar_batches_read_back_with_md5(tmp_path):
    md5 = _write_batches(str(tmp_path), ["data_batch_1", "data_batch_2"])
    x, y = cifar10._load_batches(str(tmp_path), md5, True)
    jx, jy = j_cifar10._load_batches(str(tmp_path), md5, True)
    assert x.shape == (10, 32, 32, 3) and x.dtype == np.uint8
    assert x.flags.c_contiguous
    assert np.array_equal(x, jx) and np.array_equal(y, jy)
    assert y.dtype == np.int32
    bad = dict(md5, data_batch_2="0" * 32)
    for load in (cifar10._load_batches, j_cifar10._load_batches):
        with pytest.raises(RuntimeError, match="corrupt or missing"):
            load(str(tmp_path), bad, True)
    with pytest.raises(RuntimeError, match="corrupt or missing"):
        cifar10.load_cifar10(str(tmp_path / "nowhere"), train=False)
    np.testing.assert_array_equal(cifar10.CIFAR10_MEAN,
                                  j_cifar10.CIFAR10_MEAN)
    np.testing.assert_array_equal(cifar10.CIFAR10_STD, j_cifar10.CIFAR10_STD)


@pytest.mark.parametrize("n,bs,seed,epoch", [(50, 8, 0, 0), (50, 8, 3, 2),
                                             (37, 5, 1, 1)])
@pytest.mark.parametrize("pad_last", [False, True])
def test_image_batch_order_is_jax_bitwise(n, bs, seed, epoch, pad_last):
    data = synthetic_cifar(n=n, seed=seed)
    kw = dict(epoch=epoch, seed=seed, shuffle=not pad_last,
              pad_last=pad_last, process_index=0, process_count=1)
    got = list(BatchLoader(data, bs, **kw))
    want = list(JBatchLoader(data, bs, **kw))
    assert len(got) == len(want) == len(BatchLoader(data, bs, **kw))
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    for start in (0, 2):
        for workers, depth in ((1, 2), (3, 4)):
            loader = BatchLoader(data, bs, start=start, **kw)
            par = list(ParallelBatchIterator(loader, workers, depth=depth))
            assert len(par) == len(got) - start
            for a, b in zip(par, got[start:]):
                assert all(np.array_equal(a[k], b[k]) for k in a)


def test_parallel_batch_iterator_raises_in_order_and_closes():
    """A worker's exception surfaces at its batch, after the batches
    before it; ``close`` mid-epoch stops the iterator and its threads."""
    data = synthetic_cifar(n=40, seed=0)

    bad = BatchLoader(data, 4, seed=0).plan()[2][0]

    class Faulty(BatchLoader):
        def materialize(self, entry):
            if np.array_equal(entry[0], bad):
                raise ValueError("bad batch 2")
            return super().materialize(entry)

    it = ParallelBatchIterator(Faulty(data, 4, seed=0), 3, depth=4)
    want = list(BatchLoader(data, 4, seed=0))
    for i in range(2):
        assert np.array_equal(next(it)["image"], want[i]["image"])
    with pytest.raises(ValueError, match="bad batch 2"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)
    it = ParallelBatchIterator(BatchLoader(data, 4, seed=0), 2)
    next(it)
    it.close()
    assert it._ex._shutdown
    with pytest.raises(StopIteration):
        next(it)


def test_augment_is_jax_bitwise():
    x, _ = synthetic_cifar(n=16, seed=2)
    key = jax.random.PRNGKey(5)
    want = np.asarray(j_augment.augment_batch(key, jnp.asarray(x)))
    # the draws JAX's augment_batch makes from its key
    k_crop, k_flip = jax.random.split(key)
    off = np.asarray(jax.random.randint(k_crop, (16, 2), 0, 9))
    flip = np.asarray(jax.random.bernoulli(k_flip, 0.5, (16, 1, 1, 1)))
    got = augment_batch(torch.tensor(x), torch.tensor(off),
                        torch.tensor(flip.reshape(-1)))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    # the padding is 0 in normalized space, not the mean
    assert (off == 0).any() and bool((got == 0).any())
    ev = np.asarray(j_augment.augment_batch(key, jnp.asarray(x), train=False))
    assert np.array_equal(normalize(torch.tensor(x)).numpy(), ev)


@pytest.mark.parametrize("mode", ["static", "intra", "meta", "attn"])
def test_mixup_is_jax_bitwise(mode):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(8, 6, 6, 3)).astype(np.float32)
    y = np.array([0, 1, 1, 2, 0, 3, 1, 2], np.int32)
    key = jax.random.PRNGKey(9)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    if mode in ("static", "intra"):
        out = j_mixup.mixup_data(key, jx, jy, 0.2,
                                 intra_only=mode == "intra")
        k_lam, k_perm = jax.random.split(key)
        lam = float(j_mixup.sample_lam(k_lam, 0.2))
        perm = np.asarray(jax.random.permutation(k_perm, 8))
        got = mixup.mixup_data(torch.tensor(x), torch.tensor(y), lam,
                               torch.tensor(perm),
                               intra_only=mode == "intra")
    else:
        shape = (8, 1, 1, 1) if mode == "meta" else (8, 6, 6, 3)
        lam_param = rng.uniform(size=shape).astype(np.float32)
        fn = j_mixup.meta_mixup_apply if mode == "meta" else (
            j_mixup.attn_mixup_apply)
        out = fn(jnp.asarray(lam_param), key, jx, jy)
        perm = np.asarray(jax.random.permutation(key, 8))
        port_fn = (mixup.meta_mixup_apply if mode == "meta"
                   else mixup.attn_mixup_apply)
        got = port_fn(torch.tensor(lam_param), torch.tensor(perm),
                      torch.tensor(x), torch.tensor(y))
    mixed, y_a, y_b, lam_out = (t.numpy() for t in got)
    if mode == "attn":
        # XLA's vectorized exp and torch's sigmoid differ by 1 ulp on a
        # few of the map's 864 values (4 here)
        np.testing.assert_allclose(mixed, np.asarray(out[0]), rtol=0,
                                   atol=1e-6)
    else:
        assert np.array_equal(mixed, np.asarray(out[0]))
    assert np.array_equal(y_a, np.asarray(out[1]))
    assert np.array_equal(y_b, np.asarray(out[2]))
    np.testing.assert_allclose(lam_out, np.asarray(out[3]), rtol=1e-6,
                               atol=0)
    if mode == "intra":
        same = y == y[perm]
        assert same.any() and np.array_equal(mixed[same], x[same])


def test_resnet50_test_twin_and_cifar_fallback(tmp_path, capsys,
                                              monkeypatch):
    """The fallback asks ``synthetic_cifar`` for JAX's 50000 / 10000
    images (seeds 0 / 1); the run here is handed 64 a split."""
    import importlib.util

    from faster_distributed_training_tpu_torch.data import synthetic
    from faster_distributed_training_tpu_torch.resnet50_test import DEFAULTS

    asked = []

    def small(n=1024, seed=0, **kw):
        asked.append((n, seed))
        return synthetic_cifar(n=64, seed=seed, **kw)

    monkeypatch.setattr(synthetic, "synthetic_cifar", small)

    spec = importlib.util.spec_from_file_location(
        "jax_resnet50_test", os.path.join(os.path.dirname(__file__), "..",
                                          "resnet50_test.py"))
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    for f in ("model", "dataset", "num_classes", "lr", "batch_size",
              "epochs", "alpha", "precision", "momentum", "weight_decay",
              "clip_norm", "workers", "meta_learning", "use_ngd"):
        assert getattr(DEFAULTS, f) == getattr(jmod.DEFAULTS, f), f
    argv = ["--device", "cpu", "--model", "resnet18", "--bs", "4",
            "--epoch", "1", "--subset_stride", "16", "--no_plot",
            "--no_telemetry", "--log_every", "0",
            "--data_dir", str(tmp_path / "no_cifar"),
            "--checkpoint_dir", str(tmp_path)]
    out = cli.main(argv, defaults=DEFAULTS)
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[data] CIFAR-10 unavailable")]
    assert len(line) == 2 and line[0].endswith("; using synthetic")
    assert asked == [(50000, 0), (10000, 1)]
    # 64 / 16 training images at batch 4
    assert out["state"].step == out["steps_per_epoch"] == 1
    assert np.isfinite(out["history"]["train_loss"]).all()
