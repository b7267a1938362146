"""The port's tensor-parallel fused FFN and quantized GEMMs at ``--mesh
tp=2`` on spawned gloo ranks, against the JAX package on a tp=2 mesh of
the virtual CPU devices (the set-up of ``test_torch_tp_distributed.py``):

  * path A (``--ffn_impl pallas``): row 8's ``partial`` tile on each
    rank's d_ff half, one SUM; JAX ``kernel_shard.fused_ffn_sublayer_tp``
    (the Pallas kernel in interpret mode under ``shard_map``);
  * path B (``--ffn_impl pallas --quant int8``): the same tile quantized,
    qkv column-parallel and out row-parallel (``QuantDense`` per shard),
    every amax MAX-reduced over tp;
  * path C (``--quant fp8 --quant_grad fp8_e5m2``, the flax FFN): all four
    quantized sites per shard (Dense_0 column-, Dense_1 row-parallel),
    the E5M2 gradient amaxes of the column sites over tp.

3 steps each: loss 1e-5, parameters 1e-4, amax histories 1e-5 relative
(the data-mesh tests' tolerances); every rank's whole state bitwise
equal after every step, the replicated leaves' gradients bitwise equal
across the ranks.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torch_dist_worker as W
from test_torch_tp_distributed import (TIMEOUT, TP2, TP_SMALL,
                                       check_against_jax, cls_batches,
                                       jax_tp_run)
from faster_distributed_training_tpu_torch.interop import (
    batch_stats_to_jax, flatten)

PATHS = {"path_a": dict(ffn_impl="pallas", attention="dense"),
         "path_b": dict(ffn_impl="pallas", quant="int8", attention="dense"),
         "path_c": dict(quant="fp8", quant_grad="fp8_e5m2",
                        attention="dense")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three JAX references on threads and one group of 2 ranks
    running the three paths."""
    from test_torch_distributed import _Recorder

    tmp = tmp_path_factory.mktemp("tp_quant")
    group = W.start("many", 2, str(tmp / "tp2"))
    try:
        batches = {p: cls_batches(3, seed=11 + i)
                   for i, p in enumerate(PATHS)}
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("FDT_FORCE_PALLAS_INTERPRET", "1")
            _Recorder.install(mp)
            with ThreadPoolExecutor(len(PATHS)) as ex:
                futs = {p: ex.submit(jax_tp_run, f, batches[p], ("tp",),
                                     (2,)) for p, f in PATHS.items()}
                jax_runs = {p: f.result(timeout=TIMEOUT)
                            for p, f in futs.items()}
        W.feed(group, cases={p: ("run_steps", dict(
            cfg_kw={**TP_SMALL, **f}, init=jax_runs[p][0],
            batches=batches[p], draws=jax_runs[p][1],
            variants={"tp2": TP2})) for p, f in PATHS.items()})
        res = W.wait(group, TIMEOUT)
    finally:
        W.kill(group)
    return {"jax": jax_runs,
            "port": {p: [r[p]["tp2"] for r in res] for p in PATHS}}


@pytest.mark.parametrize("path", list(PATHS))
def test_tp2_path_matches_jax_tp_mesh(runs, path):
    res, jrun = runs["port"][path], runs["jax"][path]
    check_against_jax(res, jrun, 2)
    if "quant" not in PATHS[path]:
        return
    sd = {k[len("model/"):]: torch.from_numpy(v)
          for k, v in res[0]["leaves"].items() if k.startswith("model/")}
    got, want = flatten(batch_stats_to_jax(sd)), jrun[4]
    assert sorted(got) == sorted(want) and want
    for k in want:
        assert want[k].any(), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0,
                                   err_msg=k)
