"""The port's decode serving (``models/decode.py``, ``ops/cached_attention
.py``, ``serve/decode/``, ``cli.run_decode_serving``) against the JAX
package's.

A tiny LM (2 layers, d_model 64, 4 heads, d_ff 128, vocab 100, seq 16,
buckets (8, 16), page 4), its parameters from a seeded flax init handed
to both packages.  Each test names the JAX function it holds the port to:

  * ``ops/cached_attention.cached_attention`` with garbage past each
    length: fp32 1e-6, bf16 2e-2 relative;
  * ``models/decode.prefill`` logits and K/V (fp32 1e-5) and
    ``decode_step``'s caches and tokens (1e-5), tied and untied;
  * ``serve/decode/engine.DecodeEngine``'s greedy tokens under a fixed
    admission plan, tied and untied, with every generated position's
    top-2 logit margin over 10x the logit tolerance (a flip would be a
    fault, not rounding);
  * the port's greedy tokens against its own cacheless causal forward
    (the ``--lm_causal`` model); a mid-stream admission is bitwise
    invisible; the page counts used stay within 1..max_pages and the CPU
    engine captures nothing;
  * ``sample_tokens``' topk with JAX's Gumbel draws handed to the port's
    selection (and to its engine) gives JAX's tokens; the port's own
    stream is deterministic per (seed, request) whatever the slot and
    the order;
  * ``cli.run_decode_serving`` end to end from an ``.npz`` against JAX's
    ``run_decode_serving`` (greedy tokens), and the decode refusals;
  * the front door: ``GenScheduler`` and ``ProcReplica`` against fakes
    (JAX ``tests/test_decode.py:328``, ``:363``), and one ``FrontDoor``
    run with two CPU worker processes, one SIGKILLed mid-generation.
"""

import functools
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_distributed_training_tpu import cli as jcli
from faster_distributed_training_tpu.config import TrainConfig as JConfig
from faster_distributed_training_tpu.models import decode as jdecode
from faster_distributed_training_tpu.ops.cached_attention import (
    cached_attention as j_cached_attention)
from faster_distributed_training_tpu.serve.decode import (
    DecodeEngine as JDecodeEngine)
from faster_distributed_training_tpu.serve.engine import (
    ServingState as JServingState)
from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.data.loader import select_bucket
from faster_distributed_training_tpu_torch.interop import flatten
from faster_distributed_training_tpu_torch.models import decode
from faster_distributed_training_tpu_torch.ops.cached_attention import (
    cached_attention)
from faster_distributed_training_tpu_torch.serve import (
    Replica, ReplicaSet, RequestQueue, load_serving_state)
from faster_distributed_training_tpu_torch.serve.decode import (
    DecodeEngine, DecodeScheduler, FrontDoor, GenScheduler, ProcReplica,
    WorkerClient)
from faster_distributed_training_tpu_torch.serve.queue import GenRequest

VOCAB, L, BUCKETS, PAGE = 100, 16, (8, 16), 4
TOL = 1e-5                    # fp32 logits, port against JAX
SMALL = dict(model="transformer", task="lm", dataset="synthetic",
             num_classes=4, n_layers=2, d_model=64, n_heads=4, d_ff=128,
             seq_len=L, seq_buckets=BUCKETS, precision="fp32",
             decode_page=PAGE, decode_batch_size=2, telemetry=False,
             plot=False, device="cpu")
_SILENT = lambda *_: None                                 # noqa: E731


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(tied: bool = True, **kw):
    return (TrainConfig(tie_lm_head=tied, **SMALL, **kw),
            JConfig(tie_lm_head=tied, **SMALL, **kw))


@functools.lru_cache(maxsize=None)
def _jax_lm(tied: bool):
    """The JAX serving model and its parameters from a seeded flax
    init."""
    _, jcfg = _cfgs(tied)
    jmodel = jcli.build_model(jcfg, vocab_size=VOCAB, serving=True)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, L), jnp.int32),
                         train=False)["params"]
    return jmodel, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module", params=[True, False],
                ids=["tied", "untied"])
def lm(request):
    """(tied, JAX serving model, its parameters, the port's serving model
    loaded from the same tree)."""
    tied = request.param
    jmodel, params = _jax_lm(tied)
    assert ("lm_head" in params) == (not tied)
    model, _, meta = load_serving_state(_cfgs(tied)[0], "cpu",
                                        params=params, log=_SILENT)
    assert meta["vocab"] == VOCAB
    return tied, jmodel, params, model


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, size=int(n)).astype(np.int32)
            for n in lengths]


def _drive(eng, plan, max_new):
    """The scheduler's slot protocol under a fixed admission plan
    ``[(admit_at_step, prompt)]`` (JAX ``tests/test_decode.py::_drive``),
    for either package's engine; the token lists in plan order."""
    outs = [None] * len(plan)
    slot_of = {}
    pending = list(enumerate(plan))
    steps = 0
    while pending or slot_of:
        while (pending and pending[0][1][0] <= steps
               and eng.cache.free_slot() is not None):
            i, (_at, prompt) = pending.pop(0)
            slot, first = eng.admit(np.asarray(prompt, np.int32),
                                    select_bucket(len(prompt), BUCKETS), i)
            outs[i] = [int(first)]
            if len(outs[i]) >= max_new or eng.cache.headroom(slot) <= 0:
                eng.cache.evict(slot)
            else:
                slot_of[slot] = i
        if not slot_of:
            steps += 1
            continue
        tokens, _pages = eng.step()
        steps += 1
        for slot, i in list(slot_of.items()):
            outs[i].append(int(tokens[slot]))
            if len(outs[i]) >= max_new or eng.cache.headroom(slot) <= 0:
                eng.cache.evict(slot)
                del slot_of[slot]
    return outs


def _causal_logits(model, seq):
    """The cacheless reference: the whole sequence through the port's
    forward under the causal mask, fp32 logits a position."""
    t = torch.tensor([list(map(int, seq))], dtype=torch.long)
    with torch.no_grad():
        return model(t, mask=decode.causal_mask(len(seq)))[0]


# -- ops/cached_attention --------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cached_attention_matches_jax(dtype):
    """JAX ``ops/cached_attention.cached_attention``: garbage (large
    values) past each slot's length never shows."""
    rng = np.random.default_rng(0)
    B, H, C, D = 3, 4, 12, 16
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    k = rng.standard_normal((B, H, C, D)).astype(np.float32)
    v = rng.standard_normal((B, H, C, D)).astype(np.float32)
    lengths = np.array([1, 7, 12], np.int32)
    for b, n in enumerate(lengths):
        k[b, :, n:] = 1e4
        v[b, :, n:] = -1e4
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(j_cached_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(lengths)
    ).astype(jnp.float32))
    got = cached_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                           torch.from_numpy(lengths)).float().numpy()
    assert got.shape == (B, H, 1, D)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-2,
                                   atol=2e-2 * np.abs(want).max())
    # the garbage is invisible: slot 0 attends to its one column
    np.testing.assert_allclose(got[0], v[0, :, :1].astype(got.dtype),
                               rtol=2e-2 if dtype != "float32" else 1e-6)


# -- models/decode ---------------------------------------------------------

def test_prefill_matches_jax(lm):
    """JAX ``models/decode.prefill``: per-layer K/V, the last real
    position's logits and the first token, for prompts padded to a
    bucket."""
    tied, jmodel, params, model = lm
    spec, jspec = decode.decode_spec(model), jdecode.decode_spec(jmodel)
    assert spec.tied == jspec.tied == tied
    for n, bucket in ((3, 8), (8, 8), (11, 16), (16, 16)):
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = _prompts(n, [n])[0]
        jk, jv, jlog, jfirst = jdecode.prefill(
            jspec, jdecode.SamplingCfg(), params, jnp.asarray(toks),
            jnp.asarray([n], jnp.int32), jnp.zeros((1,), jnp.int32))
        with torch.no_grad():
            k, v, logits, first = decode.prefill(
                model, spec, decode.SamplingCfg(),
                torch.from_numpy(toks).long(), torch.tensor([n]),
                torch.tensor([0]))
        assert k.shape == (2, 1, 4, bucket, 16)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlog),
                                   rtol=0, atol=TOL)
        for got, want in ((k, jk), (v, jv)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=TOL)
        assert int(first[0]) == int(jfirst[0])


def test_decode_step_matches_jax(lm):
    """JAX ``models/decode.decode_step``: the cache columns written and
    the next tokens, two active slots and a free one, over a window of
    two pages."""
    _tied, jmodel, params, model = lm
    spec, jspec = decode.decode_spec(model), jdecode.decode_spec(jmodel)
    rng = np.random.default_rng(1)
    shape = (2, 3, 4, L, 16)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    token = np.array([5, 17, 0], np.int32)
    pos = np.array([4, 6, 0], np.int32)
    active = np.array([True, True, False])
    req = np.array([3, 9, 0], np.int32)
    jk, jv, jnxt = jdecode.decode_step(
        jspec, jdecode.SamplingCfg(), 2 * PAGE, params, jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(token), jnp.asarray(pos),
        jnp.asarray(active), jnp.asarray(req))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    with torch.no_grad():
        nxt = decode.decode_step(
            model, spec, decode.SamplingCfg(), 2 * PAGE, tk, tv,
            torch.from_numpy(token).long(), torch.from_numpy(pos).long(),
            torch.from_numpy(active), torch.from_numpy(req).long())
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    assert int(nxt[2]) == 0
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)
    # exactly the columns at pos were written
    changed = np.argwhere((tk.numpy() != kc).any(axis=(2, 4)))
    assert sorted(map(tuple, changed.tolist())) == sorted(
        (layer, b, int(pos[b])) for layer in range(2) for b in range(3))


def _jax_engine(jmodel, params, **kw):
    return JDecodeEngine(jmodel, JServingState({"model": params}, {}),
                         BUCKETS, batch_size=2, page=PAGE, log=_SILENT, **kw)


def test_engine_greedy_tokens_match_jax(lm):
    """JAX ``serve/decode/engine.DecodeEngine``: the same admission plan
    (a mid-stream admission, a bucket-16 prompt, a slot reused) gives the
    same greedy tokens, with every generated position's top-2 margin over
    10x the logit tolerance."""
    _tied, jmodel, params, model = lm
    plan = list(zip((0, 0, 2, 3, 5), _prompts(2, (3, 6, 10, 5, 4))))
    want = _drive(_jax_engine(jmodel, params), plan, max_new=6)
    eng = DecodeEngine(model, BUCKETS, batch_size=2, page=PAGE)
    eng.warmup()
    got = _drive(eng, plan, max_new=6)
    assert got == want
    for (_at, prompt), toks in zip(plan, got):
        seq = list(map(int, prompt)) + toks[:-1]
        logits = _causal_logits(model, seq)[len(prompt) - 1:]
        top2 = torch.topk(logits, 2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > 10 * TOL
        assert logits.argmax(dim=-1).tolist() == toks


def test_greedy_tokens_match_the_cacheless_causal_forward(lm):
    """Greedy decode through the paged cache is the argmax loop of the
    cacheless forward of the ``--lm_causal`` model (``causal``: the mask
    comes from the model), token for token, up to the position table's
    end."""
    tied, _jmodel, params, model = lm
    pcfg, _ = _cfgs(tied, lm_causal=True)
    causal, _, _ = load_serving_state(pcfg, "cpu", params=params,
                                      log=_SILENT)
    assert causal.causal and not model.causal
    prompts = _prompts(3, (3, 5, 12, 15))
    eng = DecodeEngine(model, BUCKETS, batch_size=2, page=PAGE)
    got = _drive(eng, [(0, p) for p in prompts], max_new=6)
    for p, g in zip(prompts, got):
        seq, want = list(map(int, p)), []
        while len(want) < 6 and len(seq) <= L:
            with torch.no_grad():
                t = int(causal(torch.tensor([seq]))[0, -1].argmax())
            want.append(t)
            seq.append(t)
        assert g == want, (list(p), g, want)


def test_mid_stream_admission_is_bitwise_invisible(lm):
    """A running stream's tokens do not change when another request is
    admitted beside it mid-stream (one page covering the position table:
    every step is the same window)."""
    _tied, _jmodel, _params, model = lm
    eng = DecodeEngine(model, BUCKETS, batch_size=2, page=L, max_pages=1)
    a, b = _prompts(4, (5, 7))
    solo_a = _drive(eng, [(0, a)], max_new=6)[0]
    solo_b = _drive(eng, [(0, b)], max_new=6)[0]
    mixed = _drive(eng, [(0, a), (2, b)], max_new=6)
    assert mixed == [solo_a, solo_b]


def test_page_counts_stay_in_range_and_nothing_is_captured_on_cpu(lm):
    """A ragged mix through the scheduler: every step's page count is in
    1..max_pages (several are used), and the CPU engine runs
    ``decode_step`` eagerly: no graph, no capture, warmup or not."""
    _tied, _jmodel, _params, model = lm
    eng = DecodeEngine(model, BUCKETS, batch_size=2, page=PAGE)
    assert eng.max_pages == 4
    eng.warmup()
    q = RequestQueue(BUCKETS, max_len=L)
    sched = DecodeScheduler(q, eng, max_new_tokens=5)
    sched.start()
    try:
        handles = [q.submit(t, max_new_tokens=5)
                   for t in _prompts(5, (3, 8, 9, 12, 16, 4))]
        outs = [h.wait(timeout=60.0) for h in handles]
    finally:
        q.close()
        sched.close()
    # a 16-token prompt fills the position table: its prefill token only
    assert [len(o) for o in outs] == [5, 5, 5, 5, 1, 5]
    assert set(eng.page_counts) <= set(range(1, eng.max_pages + 1))
    assert len(eng.page_counts) >= 2
    assert sum(eng.page_counts.values()) == eng.steps
    assert eng.captures == 0 and not eng.graphs and not eng.on_card
    summ = sched.summary()
    assert summ["requests"] == 6 and summ["tokens"] == 26
    assert summ["ttft_p99_ms"] >= summ["ttft_p50_ms"] > 0


# -- sampling --------------------------------------------------------------

def _jax_gumbel(seed, req_ids, positions, k):
    """JAX's Gumbel draws of ``sample_tokens``' topk: the noise
    ``jax.random.categorical`` adds under each (request, position) key."""
    keys = jdecode._sample_keys(seed, jnp.asarray(req_ids, jnp.int32),
                                jnp.asarray(positions, jnp.int32))
    return np.stack([np.asarray(jax.random.gumbel(key, (k,), jnp.float32))
                     for key in keys])


def test_topk_selection_with_jax_draws_gives_jax_tokens():
    """JAX ``models/decode.sample_tokens`` (topk): the port's top-k and
    ``select_topk`` on JAX's Gumbel draws pick JAX's tokens."""
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((5, VOCAB)).astype(np.float32)
    req = np.array([0, 1, 2, 40, 41], np.int32)
    pos = np.array([3, 3, 9, 15, 16], np.int32)
    for temp, k in ((1.0, 10), (0.5, 40), (3.0, 0)):
        samp = jdecode.SamplingCfg(method="topk", temperature=temp,
                                   top_k=k, seed=7)
        want = np.asarray(jdecode.sample_tokens(
            jnp.asarray(logits), samp, jnp.asarray(req), jnp.asarray(pos)))
        kk = VOCAB if k <= 0 else k
        vals, idx = torch.topk(torch.from_numpy(logits), kk, dim=-1)
        got = decode.select_topk(
            vals, idx, torch.from_numpy(_jax_gumbel(7, req, pos, kk)), temp)
        np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(want.tolist())) > 1


def test_topk_engine_with_jax_draws_gives_jax_tokens(lm, monkeypatch):
    """JAX's ``DecodeEngine`` with topk against the port's, the port's
    noise replaced by JAX's draws for each (request, position)."""
    _tied, jmodel, params, model = lm
    cfg = dict(method="topk", temperature=1.0, top_k=20, seed=11)
    plan = list(zip((0, 0, 1), _prompts(7, (4, 6, 3))))
    want = _drive(_jax_engine(jmodel, params,
                              sampling=jdecode.SamplingCfg(**cfg)),
                  plan, max_new=5)

    def jax_noise(seed, req_ids, positions, k):
        return torch.from_numpy(_jax_gumbel(seed, req_ids.numpy(),
                                            positions.numpy(), k))
    monkeypatch.setattr(decode, "gumbel_noise", jax_noise)
    eng = DecodeEngine(model, BUCKETS, batch_size=2, page=PAGE,
                       sampling=decode.SamplingCfg(**cfg))
    assert _drive(eng, plan, max_new=5) == want
    greedy = _drive(DecodeEngine(model, BUCKETS, batch_size=2, page=PAGE),
                    plan, max_new=5)
    assert greedy != want


def test_port_topk_stream_is_per_request_and_order_free(lm):
    """The port's own noise (murmur3 of seed, request, position, rank):
    a request's tokens are the same whatever its slot and admission
    order; another request id or seed draws another stream."""
    _tied, _jmodel, _params, model = lm
    a, b, c = _prompts(8, (4, 6, 5))

    def run(order, seed=3):
        eng = DecodeEngine(model, BUCKETS, batch_size=2, page=PAGE,
                           sampling=decode.SamplingCfg(
                               method="topk", temperature=5.0, top_k=0,
                               seed=seed))
        q = RequestQueue(BUCKETS, max_len=L)
        sched = DecodeScheduler(q, eng, max_new_tokens=8)
        sched.start()
        try:
            hs = {rid: q.submit(p, max_new_tokens=8, req_id=rid)
                  for rid, p in order}
            return {rid: h.wait(timeout=60.0).tolist()
                    for rid, h in hs.items()}
        finally:
            q.close()
            sched.close()

    one = run([(10, a), (11, b), (12, c)])
    two = run([(12, c), (11, b), (10, a)])
    assert one == two
    # the same prompt under another request id, or another seed
    assert run([(13, a)])[13] != one[10]
    assert run([(10, a)], seed=4)[10] != one[10]
    g = decode.gumbel_noise(3, torch.tensor([10, 10]), torch.tensor([5, 6]),
                            4)
    assert g.shape == (2, 4) and torch.isfinite(g).all()
    assert not torch.equal(g[0], g[1])


# -- the entry point -------------------------------------------------------

def test_run_decode_serving_from_npz_matches_jax(lm, tmp_path,
                                                 monkeypatch):
    """JAX ``cli.run_decode_serving`` (its checkpoint read replaced by the
    same parameters) against the port's, reading the ``.npz`` under
    ``--checkpoint_dir``: the same synthetic prompts, the same greedy
    tokens; ``main_decode`` returns the summary under JAX's keys."""
    import faster_distributed_training_tpu.serve as jserve

    tied, jmodel, params, _model = lm
    np.savez(tmp_path / "transformer_params.npz", **flatten(params))
    extra = dict(decode_replicas=1, decode_requests=5,
                 decode_max_new_tokens=4, checkpoint_dir=str(tmp_path))
    pcfg, jcfg = _cfgs(tied, **extra)
    monkeypatch.setattr(
        jserve, "load_serving_state", lambda cfg, mesh=None, log=None: (
            jmodel, JServingState({"model": params}, {}),
            {"vocab": VOCAB}))
    want = jcli.run_decode_serving(jcfg, log=_SILENT)
    got = cli.run_decode_serving(pcfg, log=_SILENT)
    assert [r.tolist() for r in got["results"]] == [
        np.asarray(r).tolist() for r in want["results"]]
    keys = ("requests", "tokens", "steps", "prefills", "ttft_p50_ms",
            "ttft_p99_ms", "latency_p50_ms", "latency_p99_ms",
            "tokens_per_sec", "chips_serving", "tokens_per_sec_per_chip")
    assert set(keys) <= set(got)
    assert got["requests"] == 5 and got["tokens"] == want["tokens"]
    argv = ["--task", "lm", "--device", "cpu", "--precision", "fp32",
            "--n_layers", "2", "--d_model", "64", "--n_heads", "4",
            "--d_ff", "128", "--seq_len", str(L), "--decode_page",
            str(PAGE), "--decode_requests", "3", "--decode_max_new_tokens",
            "2", "--checkpoint_dir", str(tmp_path)] + (
        [] if tied else ["--untie_lm_head"])
    out = cli.main_decode(argv, defaults=cli.TRANSFORMER_DEFAULTS.replace(
        seq_buckets=BUCKETS))
    assert out["requests"] == 3 and out["tokens"] == 6
    assert set(keys) <= set(out) and "results" not in out


def test_decode_refusals(lm):
    """JAX's ValueErrors (a classifier, --quant, --tricks off), a model
    axis by name, a head that does not fit the parameters, and the card
    by default."""
    tied, jmodel, params, model = lm
    cls = cli.build_model(TrainConfig(**dict(SMALL, task="cls")),
                          vocab_size=VOCAB, device="cpu")
    with pytest.raises(ValueError, match="needs an LM checkpoint"):
        decode.decode_spec(cls)
    tree = {"params": {"model": params}}
    for kw, err, match in (
            (dict(quant="int8"), ValueError, "unquantized checkpoints"),
            (dict(tricks="off"), ValueError, "fused-QKV"),
            (dict(mesh_axes=("dp", "tp"), mesh_shape=(1, 2)),
             NotImplementedError, "model axis"),
            (dict(tie_lm_head=not tied), ValueError, "untie_lm_head")):
        pcfg = TrainConfig(**{**SMALL, "tie_lm_head": tied, **kw})
        with pytest.raises(err, match=match):
            cli.run_decode_serving(pcfg, params=tree, log=_SILENT)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            cli.run_decode_serving(
                TrainConfig(**dict(SMALL, tie_lm_head=tied, device="cuda")),
                params=tree, log=_SILENT)


# -- the queue and the front door ------------------------------------------

def test_queue_generation_requests_and_take_one():
    """``submit(max_new_tokens=...)`` makes a GenRequest (id override,
    TTFT stamp); ``take_one`` is take_cell at batch 1, deadline first."""
    clock = [0.0]
    q = RequestQueue(BUCKETS, max_len=L, clock=lambda: clock[0])
    long_req = q.submit(np.arange(1, 12), max_new_tokens=3, req_id=77)
    clock[0] = 0.5
    short = q.submit(np.arange(1, 4), max_new_tokens=2)
    plain = q.submit(np.arange(1, 4))
    assert isinstance(long_req, GenRequest) and long_req.id == 77
    assert not isinstance(plain, GenRequest) and q.submitted == 3
    # the 16 bucket's head waited past the deadline: it beats bucket 8
    assert q.take_one(0.4, timeout_s=0.0) == (16, long_req)
    assert q.take_one(10.0, timeout_s=0.0) == (8, short)
    long_req.push_token(5, 0.75)
    long_req.push_token(6, 0.9)
    assert long_req.out == [5, 6] and long_req.ttft_ms() == 750.0
    assert not long_req.done


def test_gen_scheduler_payload_and_fulfill():
    """JAX ``tests/test_decode.py:328``: cells of one GenRequest, the wire
    payload as the batch, the replica's tokens as the result; a plain
    request is refused."""

    class FakeWorker:
        def predict_batch(self, payload):
            n = len(payload["tokens"])
            return np.arange(n, n + payload["max_new"], dtype=np.int32)

    rep = Replica("w0", FakeWorker(), log=_SILENT)
    rset = ReplicaSet([rep], heartbeat_timeout_s=5.0, log=_SILENT)
    q = RequestQueue((8,), max_len=8)
    sched = GenScheduler(q, rset, max_delay_ms=5.0, log=_SILENT)
    sched.start()
    try:
        h = q.submit(np.arange(1, 4, dtype=np.int32), max_new_tokens=3)
        assert list(map(int, h.wait(timeout=10.0))) == [3, 4, 5]
        assert sched.completed_requests == 1
        assert {"decode_request_retries", "decode_request_timeouts"} <= set(
            sched.summary())
    finally:
        q.close()
        sched.close()
    plain = RequestQueue((8,), max_len=8).submit(np.arange(1, 4))
    with pytest.raises(TypeError):
        sched._assemble(8, [plain])


def test_proc_replica_staleness_and_failed_respawn(tmp_path):
    """JAX ``tests/test_decode.py:363``: a dead process or a stale marker
    makes the replica stale; a respawn whose ping fails re-arms the
    detach timer instead of raising, and is no re-admission."""

    class FakeProc:
        dead = False

        def poll(self):
            return 1 if self.dead else None

        def kill(self):
            self.dead = True

    hb = tmp_path / "HB_w0"
    hb.write_text(str(time.time()))
    proc = FakeProc()
    # port 1 never listens: the ping fails after the short budget
    r = ProcReplica("w0", lambda: proc, WorkerClient(1, connect_timeout_s=0.3),
                    hb_path=str(hb), marker_timeout_s=0.2, log=_SILENT)
    rset = ReplicaSet([r], heartbeat_timeout_s=60.0, log=_SILENT)
    r.start()
    assert r.alive is False and r.detached_at is not None
    rset.readmit(r)
    assert r.alive is False and rset.replica_readmissions == 0
    r.alive, r.last_beat = True, time.monotonic()
    os.utime(hb)
    assert not r.stale(time.monotonic(), timeout_s=60.0)
    proc.dead = True
    assert r.stale(time.monotonic(), timeout_s=60.0)
    proc.dead = False
    old = time.time() - 5.0
    os.utime(hb, (old, old))
    assert r.stale(time.monotonic(), timeout_s=60.0)


def test_front_door_survives_a_killed_worker(tmp_path, monkeypatch):
    """Two CPU worker processes behind the front door; one is SIGKILLed
    with generations in flight.  The survivor finishes every stream at
    its full budget, with the tokens of the in-process run; the killed
    worker respawns, passes its ping and serves again.  Bounded: the
    whole run must end within 60 s."""
    _jmodel, params = _jax_lm(True)
    t_start = time.monotonic()
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    np.savez(tmp_path / "transformer_params.npz", **flatten(params))
    pcfg, _ = _cfgs(True, checkpoint_dir=str(tmp_path),
                    decode_max_new_tokens=6, serve_max_delay_ms=5.0)
    prompts = _prompts(9, (3, 7, 5, 4, 6, 8, 3, 5))
    want = [r.tolist() for r in cli.run_decode_serving(
        pcfg, prompts=prompts, log=_SILENT)["results"]]
    fd = FrontDoor(pcfg, n_workers=2, run_dir=str(tmp_path / "fd"),
                   heartbeat_timeout_s=30.0, marker_timeout_s=5.0,
                   readmit_after_s=0.5, log=_SILENT)
    try:
        fd.start()
        deadline = t_start + 60.0
        while not all(r.alive for r in fd.replicas):
            assert time.monotonic() < deadline, "workers not ready"
            time.sleep(0.1)
        handles = [fd.submit(t, max_new=6) for t in prompts]
        victim = fd.replicas[0]
        victim.kill()
        got = [h.wait(timeout=max(deadline - time.monotonic(), 1.0)).tolist()
               for h in handles]
        assert got == want
        while victim.respawns < 1 or not victim.alive:
            assert time.monotonic() < deadline, "victim not re-admitted"
            time.sleep(0.1)
        assert fd.rset.replica_readmissions >= 1
        served = victim.served_requests
        while victim.served_requests == served:
            assert time.monotonic() < deadline, "victim never served again"
            fd.submit(prompts[0], max_new=2).wait(timeout=30.0)
    finally:
        fd.close()
    assert all(r.proc.poll() is not None for r in fd.replicas)
    assert time.monotonic() - t_start < 60.0
