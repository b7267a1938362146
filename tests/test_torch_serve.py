"""The PyTorch port's serving slice against the JAX package's.

One command line (``--device cpu --precision fp32 --attention flash
--mlp_impl pallas`` at a small width) configures both packages.  The
port's ``run_serving(device="cpu", params=...)`` serves a ragged
request mix through its queue, scheduler and replicas; every answer is
held to the JAX ``make_predict_fn(model.apply)`` on the same
``pad_batch`` (Pallas kernels in interpret mode) at fp32 1e-4.  Also
pinned: the batched-vs-single-request bitwise contract inside the port,
the ``.npz`` CLI path, device selection, the import boundary (no JAX in
the port or chip_smoke.py), the flag surface, and the queue/replica
machinery.
"""

import ast
import os
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_distributed_training_tpu import cli as jcli
from faster_distributed_training_tpu import config as jconfig
from faster_distributed_training_tpu.data.loader import (
    select_bucket as j_select_bucket)
from faster_distributed_training_tpu.serve.engine import (
    make_predict_fn, pad_batch as j_pad_batch)
from faster_distributed_training_tpu.train.metrics import (
    percentiles as j_percentiles)
from faster_distributed_training_tpu_torch import cli, config
from faster_distributed_training_tpu_torch.data.loader import select_bucket
from faster_distributed_training_tpu_torch.interop import flatten
from faster_distributed_training_tpu_torch.serve import (
    BatchScheduler, Replica, ReplicaSet, RequestQueue, pad_batch)
from faster_distributed_training_tpu_torch.train.metrics import percentiles

REPO = Path(__file__).resolve().parent.parent
ARGV = ["--device", "cpu", "--precision", "fp32", "--n_layers", "2",
        "--d_model", "64", "--n_heads", "4", "--d_ff", "128",
        "--seq_len", "64", "--serve_batch_size", "4",
        "--serve_max_delay_ms", "5", "--serve_requests", "10"]
VOCAB = 100


def _cfgs(extra=()):
    argv = ARGV + list(extra)
    pdef = cli.TRANSFORMER_DEFAULTS.replace(seq_buckets=(16, 32, 64))
    jdef = jconfig.TrainConfig(model="transformer", dataset="agnews",
                               num_classes=4, seq_len=512,
                               seq_buckets=(16, 32, 64))
    pcfg = config.config_from_args(
        config.build_parser(defaults=pdef).parse_args(argv), defaults=pdef)
    jcfg = jconfig.config_from_args(
        jconfig.build_parser(defaults=jdef).parse_args(argv), defaults=jdef)
    return pcfg, jcfg


@pytest.fixture(scope="module")
def jax_model():
    """The JAX serving model for the slice config and its parameters."""
    old = os.environ.get("FDT_FORCE_PALLAS_INTERPRET")
    os.environ["FDT_FORCE_PALLAS_INTERPRET"] = "1"
    try:
        _, jcfg = _cfgs(["--attention", "flash", "--mlp_impl", "pallas"])
        model = jcli.build_model(jcfg, vocab_size=VOCAB, serving=True)
        z = jnp.zeros((2, 16), jnp.int32)
        params = model.init(jax.random.PRNGKey(0), z, mask=z + 1,
                            train=False)["params"]
        params = jax.tree_util.tree_map(np.asarray, params)
        predict = jax.jit(make_predict_fn(model.apply))
        variables = {"params": {"model": params}, "batch_stats": {}}

        def jax_predict(batch):
            os.environ["FDT_FORCE_PALLAS_INTERPRET"] = "1"
            return np.asarray(predict(variables, batch))
        yield params, jax_predict
    finally:
        if old is None:
            os.environ.pop("FDT_FORCE_PALLAS_INTERPRET", None)
        else:
            os.environ["FDT_FORCE_PALLAS_INTERPRET"] = old


def test_serving_slice_matches_jax_per_request(jax_model, tmp_path):
    params, jax_predict = jax_model
    pcfg, _ = _cfgs(["--attention", "flash", "--mlp_impl", "pallas",
                     "--checkpoint_dir", str(tmp_path)])
    requests = cli.synth_requests(10, VOCAB, (16, 32, 64), seed=3)
    out = cli.run_serving(pcfg, requests=requests,
                          params={"params": {"model": params}},
                          device="cpu", log=lambda s: None)
    assert out["requests"] == 10 and out["device"] == "cpu"
    assert set(out["buckets"]) == {16, 32, 64}
    engine = out["engines"][0]
    assert engine.model.layers[0].attn.attention_impl == "flash"
    for req, bucket, got in zip(requests, out["buckets"], out["results"]):
        assert bucket == j_select_bucket(len(req), (16, 32, 64))
        ns = [SimpleNamespace(tokens=req)]
        batch, _ = j_pad_batch(ns, bucket, pcfg.serve_batch_size)
        want = jax_predict(batch)[0]
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        # the batched answer equals the request served alone, bitwise
        pbatch, _ = pad_batch(ns, bucket, pcfg.serve_batch_size)
        np.testing.assert_array_equal(engine.predict_batch(pbatch)[0], got)


def test_main_serve_reads_npz_checkpoint(jax_model, tmp_path):
    params, _ = jax_model
    np.savez(tmp_path / "transformer_params.npz", **flatten(params))
    pdef = cli.TRANSFORMER_DEFAULTS.replace(seq_buckets=(16, 32, 64))
    out = cli.main_serve(ARGV + ["--checkpoint_dir", str(tmp_path)],
                         defaults=pdef)
    assert out["requests"] == 10 and out["meta"]["vocab"] == VOCAB
    assert "results" not in out and "engines" not in out
    with pytest.raises(FileNotFoundError):
        cli.main_serve(ARGV + ["--checkpoint_dir", str(tmp_path / "none")],
                       defaults=pdef)


def test_cuda_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    pcfg, _ = _cfgs()
    with pytest.raises(RuntimeError, match="cuda"):
        cli.run_serving(pcfg, params={}, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.resolve_device("cuda")
    assert config.TrainConfig().device == "cuda"


def test_attention_routing():
    pcfg, _ = _cfgs()
    assert cli.resolve_attention(pcfg, torch.device("cpu")) == "dense"
    assert cli.resolve_attention(pcfg, torch.device("cuda")) == "flash"
    odd = pcfg.replace(d_model=96, n_heads=4)            # head dim 24
    assert cli.resolve_attention(odd, torch.device("cuda")) == "dense"
    assert cli.resolve_attention(pcfg.replace(attention="flash"),
                                 torch.device("cpu")) == "flash"
    with pytest.raises(ValueError, match="--remat_policy"):
        cli.build_model(pcfg.replace(remat=True, remat_policy="all"),
                        device="cpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "faster_distributed_training_tpu_torch").rglob(
        "*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    banned = {"jax", "jaxlib", "flax", "optax", "orbax",
              "faster_distributed_training_tpu"}
    for path in files:
        bad = [m for m in _imports(path) if m.split(".")[0] in banned]
        assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_flag_surface_matches_jax_except_device():
    pp = config.build_parser()
    jp = jconfig.build_parser()

    def surface(p):
        return {a.dest: (tuple(a.option_strings), a.default,
                         tuple(a.choices) if a.choices else None)
                for a in p._actions if a.dest != "help"}
    ps, js = surface(pp), surface(jp)
    assert ps.keys() == js.keys()
    diff = {k for k in ps if ps[k] != js[k]}
    assert diff == {"device"}
    assert ps["device"][1:] == ("cuda", ("cuda", "cpu"))
    assert config.parse_mesh("data=2,model=4") == jconfig.parse_mesh(
        "data=2,model=4")


def test_bucketing_and_percentiles_match_jax():
    rng = np.random.default_rng(0)
    buckets = (64, 128, 256, 512)
    for n in list(rng.integers(1, 700, size=50)) + [1, 64, 65, 512, 513]:
        assert select_bucket(n, buckets) == j_select_bucket(n, buckets)
        assert select_bucket(n, buckets, 100) == j_select_bucket(n, buckets,
                                                                 100)
    vals = rng.exponential(size=37)
    assert percentiles(vals, (50, 95, 99)) == j_percentiles(vals, (50, 95, 99))
    assert percentiles([]) == {}


def test_queue_bins_truncates_and_drains_by_deadline():
    now = [0.0]
    q = RequestQueue((16, 32, 64), max_len=32, clock=lambda: now[0])
    assert q.buckets == (16, 32)
    long_req = q.submit(np.arange(50))
    assert long_req.bucket == 32 and len(long_req.tokens) == 32
    assert long_req.raw_len == 50
    for _ in range(3):
        q.submit(np.arange(5))
    assert q.take_cell(4, max_delay_s=1.0, timeout_s=0) is None
    q.submit(np.arange(5))
    bucket, cell = q.take_cell(4, max_delay_s=1.0, timeout_s=0)
    assert bucket == 16 and len(cell) == 4
    now[0] = 2.0                                  # the 32-bucket expires
    bucket, cell = q.take_cell(4, max_delay_s=1.0, timeout_s=0)
    assert bucket == 32 and cell == [long_req]
    q.close()
    with pytest.raises(RuntimeError):
        q.submit(np.arange(3))


class _EchoEngine:
    """Logits = the first token of each row (a stand-in engine)."""

    def __init__(self):
        self.calls = 0

    def predict_batch(self, batch):
        self.calls += 1
        return batch["tokens"][:, :1].astype(np.float32)


def test_failed_replica_is_detached_and_its_work_served_elsewhere():
    q = RequestQueue((8,), max_len=8)
    bad, good = _EchoEngine(), _EchoEngine()
    replicas = [Replica("bad", bad, log=lambda s: None),
                Replica("good", good, log=lambda s: None)]
    replicas[0].fail_next = RuntimeError("injected")
    rset = ReplicaSet(replicas, heartbeat_timeout_s=5.0,
                      log=lambda s: None)
    sched = BatchScheduler(q, rset, batch_size=2, max_delay_ms=1,
                           retry_backoff_s=0.0, log=lambda s: None)
    sched.start()
    try:
        handles = [q.submit(np.array([i + 1, 0, 0])) for i in range(6)]
        got = [h.wait(timeout=10.0) for h in handles]
        alive = [r.alive for r in replicas]
    finally:
        sched.close()
    assert [float(g[0]) for g in got] == [1, 2, 3, 4, 5, 6]
    assert alive == [False, True]
    assert not sched._thread.is_alive()
    assert rset.replica_failures == 1 and good.calls >= 1
    summary = sched.summary()
    assert summary["requests"] == 6
    assert summary["batches"] * 2 == 6 + summary["padded_rows"]
