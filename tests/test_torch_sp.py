"""The port's sequence parallelism (``--mesh sp=S``) against the JAX
package, in one process.

  * ``online_block_update``, ``init_carry`` and ``finalize`` against
    JAX's (fp32 1e-6);
  * the ring and Ulysses per-rank math: the port's bodies run on the
    shards of each rank of a dp=2 x sp=4 grid, the ranks as threads of
    this process whose collectives exchange through shared slots
    (``ThreadSeq``, a ``SequenceGroup`` whose four primitives are
    overridden), against JAX ``ring_self_attention`` /
    ``ulysses_self_attention`` on its dp=2,sp=4 CPU mesh: no mask, a
    padding mask, causal, dropout 0.1; outputs and q / k / v gradients
    fp32 1e-5 (bf16 2e-2 of max), and the dropout mask itself bitwise
    (q = 0 and v = I make the output the keep factors over L);
  * the sequence-shard addressing of ``hash_dropout`` (the global
    mask's slice, bitwise) and the (b, h) index of ``global_bh``;
  * the plain fused FFN (the unquantized and the generalized function)
    at ``s0 = L/2``, ``l_loc = L/2``, ``l_glob = L`` against
    ``_ffn_fwd_pallas`` / ``_ffn_fwd_pallas2`` in interpret mode at the
    same operands (fp32 1e-5, bf16 2e-2 of max, amaxes bitwise in bf16,
    1 ulp in fp32), and each half bitwise the full call's rows;
  * the embeddings at ``s0``: JAX's embeddings of the whole row, sliced;
  * the attention route against JAX ``cli._route_model_axis`` /
    ``resolve_attention`` on an sp mesh; the mesh parse and layout;
  * every flag of ``cli.sp_unported`` raising ``NotImplementedError``
    naming itself.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from faster_distributed_training_tpu import cli as jcli
from faster_distributed_training_tpu.config import TrainConfig as JConfig
from faster_distributed_training_tpu.ops import attention as ja
from faster_distributed_training_tpu.ops import fused_ffn as jf
from faster_distributed_training_tpu.ops.ring_attention import (
    ring_self_attention as j_ring)
from faster_distributed_training_tpu.ops.ulysses_attention import (
    ulysses_self_attention as j_ulysses)
from faster_distributed_training_tpu.parallel import make_mesh as j_mesh
from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.ops import attention as ta
from faster_distributed_training_tpu_torch.ops import fused_ffn as tf
from faster_distributed_training_tpu_torch.ops.dropout import hash_dropout
from faster_distributed_training_tpu_torch.ops.ring_attention import (
    ring_self_attention)
from faster_distributed_training_tpu_torch.ops.sequence_parallel import (
    batch_axes, global_bh)
from faster_distributed_training_tpu_torch.ops.ulysses_attention import (
    ulysses_self_attention)
from faster_distributed_training_tpu_torch.parallel.collectives import (
    SequenceGroup)
from faster_distributed_training_tpu_torch.parallel.mesh import (
    ordered_axes, parse_mesh, seq_parallel_axis)

DP, SP = 2, 4
# a rank thread's longest wait at a barrier, and the whole grid's run
BARRIER_S, RANKS_S = 60.0, 120.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Hub:
    """The shared slots of one sp group's threads."""

    def __init__(self, n):
        self.n, self.slots = n, [None] * n
        # a rank that never arrives breaks the barrier for the others
        self.bar = threading.Barrier(n, timeout=BARRIER_S)

    def exchange(self, rank, obj):
        self.slots[rank] = obj
        self.bar.wait()
        out = list(self.slots)
        self.bar.wait()
        return out


class ThreadSeq(SequenceGroup):
    """An sp rank that is a thread of this process: the collectives'
    primitives exchange through the hub."""

    def __init__(self, hub, rank):
        super().__init__(None, rank, hub.n)
        self.hub = hub

    def _ex(self, obj):
        return self.hub.exchange(self.rank, obj)

    def _rotate(self, t, shift):
        return self._ex(t.clone())[(self.rank - shift) % self.size].clone()

    def _all_to_all(self, chunks):
        got = self._ex([c.clone() for c in chunks])
        return [got[j][self.rank].clone() for j in range(self.size)]

    def _all_gather(self, t):
        return [x.clone() for x in self._ex(t.clone())]

    def _all_reduce(self, t, op):
        got = self._ex(t.clone())
        out = got[0].clone()
        for x in got[1:]:
            out = out + x if op == dist.ReduceOp.SUM else torch.maximum(
                out, x)
        return t.copy_(out)


def run_ranks(fn, n_dp=DP, n_sp=SP):
    """``fn(d, group)`` on every rank of an n_dp x n_sp grid, one thread a
    rank; returns the results as ``[d][s]``."""
    hubs = [_Hub(n_sp) for _ in range(n_dp)]
    out = [[None] * n_sp for _ in range(n_dp)]
    errs = []

    def body(d, s):
        try:
            with torch.autograd.set_multithreading_enabled(False):
                out[d][s] = fn(d, ThreadSeq(hubs[d], s))
        except BaseException as e:      # noqa: BLE001 (re-raised below)
            errs.append(e)
            for h in hubs:
                h.bar.abort()

    # daemons: a hung rank fails the test below and cannot keep the worker
    # process from exiting
    threads = [threading.Thread(target=body, args=(d, s), daemon=True)
               for d in range(n_dp) for s in range(n_sp)]
    for t in threads:
        t.start()
    t0 = time.monotonic()
    for t in threads:
        t.join(max(RANKS_S - (time.monotonic() - t0), 0.0))
    if errs:
        raise errs[0]
    late = sum(t.is_alive() for t in threads)
    if late:
        for h in hubs:
            h.bar.abort()
        raise TimeoutError(f"{late} of {len(threads)} rank threads still "
                           f"running after {RANKS_S} s")
    return out


def _qkv(seed, B=4, H=4, L=32, D=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, H, L, D)).astype(np.float32)
                 for _ in range(3))


def _padding(seed, B=4, L=32):
    rng = np.random.default_rng(seed)
    lens = rng.integers(L // 2, L + 1, size=B)
    lens[0] = 3            # keys of one row only in the first shard
    return (np.arange(L)[None] < lens[:, None]).astype(np.int32)


def _port_sp(fn, q, k, v, mask, dtype, causal, rate, seed, g=None):
    """The port's per-rank ``fn`` on every rank's shards; the assembled
    output and, with the cotangent ``g``, the assembled q / k / v
    gradients."""
    B, H, L, D = q.shape
    bl, ll = B // DP, L // SP
    td = getattr(torch, dtype)

    def rank(d, sp):
        rows = slice(d * bl, (d + 1) * bl)
        pos = slice(sp.rank * ll, (sp.rank + 1) * ll)
        ts = [torch.from_numpy(np.ascontiguousarray(t[rows, :, pos])).to(td)
              .requires_grad_(g is not None) for t in (q, k, v)]
        m = (None if mask is None else
             torch.from_numpy(np.ascontiguousarray(mask[rows, pos])))
        out = fn(*ts, m, sp, b0=d * bl, causal=causal, dropout_rate=rate,
                 dropout_seed=seed)
        grads = None
        if g is not None:
            gg = torch.from_numpy(np.ascontiguousarray(g[rows, :, pos])).to(td)
            grads = torch.autograd.grad((out.float() * gg.float()).sum(), ts)
            grads = [x.float().detach().numpy() for x in grads]
        return out.float().detach().numpy(), grads

    res = run_ranks(rank)
    cat = lambda parts: np.concatenate(  # noqa: E731
        [np.concatenate(row, axis=2) for row in parts], axis=0)
    out = cat([[r[0] for r in row] for row in res])
    if g is None:
        return out, None
    return out, [cat([[r[1][i] for r in row] for row in res])
                 for i in range(3)]


def _jax_sp(fn, q, k, v, mask, dtype, causal, rate, seed, g=None):
    mesh = j_mesh(("dp", "sp"), (DP, SP), jax.devices()[:8])
    jd = getattr(jnp, dtype)
    qs = tuple(jnp.asarray(t).astype(jd) for t in (q, k, v))
    jm = None if mask is None else jnp.asarray(mask)
    kw = dict(causal=causal, dropout_rate=rate,
              dropout_seed=jnp.uint32(seed))

    def f(q_, k_, v_):
        return fn(q_, k_, v_, jm, mesh, **kw)
    if g is None:
        return np.asarray(f(*qs).astype(jnp.float32)), None
    out, vjp = jax.vjp(f, *qs)
    grads = vjp(jnp.asarray(g).astype(jd))
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(x.astype(jnp.float32)) for x in grads])


def _close(got, want, dtype):
    tol = 1e-5 if dtype == "float32" else 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


STRATEGIES = {"ring": (ring_self_attention, j_ring),
              "ulysses": (ulysses_self_attention, j_ulysses)}


def test_online_block_primitives_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 3, 8, 16)).astype(np.float32)
    kb = rng.normal(size=(2, 3, 5, 16)).astype(np.float32)
    vb = rng.normal(size=(2, 3, 5, 16)).astype(np.float32)
    bias = np.where(rng.random((2, 1, 1, 5)) < 0.3, -1e9, 0.0).astype(
        np.float32)
    keep = (rng.random((2, 3, 8, 5)) < 0.9).astype(np.float32) / 0.9
    jc = ja.init_carry(jnp.asarray(q))
    tc = ta.init_carry(torch.from_numpy(q))
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for _ in range(2):      # two blocks: the correction term at work
        jc = ja.online_block_update(jnp.asarray(q), jnp.asarray(kb),
                                    jnp.asarray(vb), jnp.asarray(bias), *jc,
                                    0.25, keep_blk=jnp.asarray(keep))
        tc = ta.online_block_update(torch.from_numpy(q), torch.from_numpy(kb),
                                    torch.from_numpy(vb),
                                    torch.from_numpy(bias), *tc, 0.25,
                                    keep_blk=torch.from_numpy(keep))
        kb, vb = kb[:, :, ::-1].copy() * 0.5, vb * 2.0
    for a, b in zip(jc, tc):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(
        ta.finalize(*tc, torch.float32).numpy(),
        np.asarray(ja.finalize(*jc, jnp.float32)), rtol=1e-6, atol=1e-6)
    # a fully masked row comes out 0, not NaN
    z = ta.finalize(torch.full((1, 2), -np.inf), torch.zeros(1, 2),
                    torch.zeros(1, 2, 4), torch.float32)
    assert torch.equal(z, torch.zeros(1, 2, 4))


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
@pytest.mark.parametrize("case", ["none", "padding", "causal", "dropout"])
def test_sp_attention_matches_jax_per_rank(strategy, case):
    """Each rank's output and q / k / v gradients, assembled, against the
    JAX strategy on the dp=2,sp=4 mesh (fp32)."""
    port_fn, jax_fn = STRATEGIES[strategy]
    q, k, v = _qkv(11, L=32 if case != "causal" else 16)
    B, H, L, D = q.shape
    mask = _padding(12, B, L) if case in ("padding", "dropout") else None
    causal, rate = case == "causal", 0.1 if case == "dropout" else 0.0
    g = np.random.default_rng(13).normal(size=q.shape).astype(np.float32)
    got, ggot = _port_sp(port_fn, q, k, v, mask, "float32", causal, rate,
                         0x5EED, g)
    want, gwant = _jax_sp(jax_fn, q, k, v, mask, "float32", causal, rate,
                          0x5EED, g)
    _close(got, want, "float32")
    for name, a, b in zip("qkv", ggot, gwant):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_sp_attention_bf16_matches_jax(strategy):
    port_fn, jax_fn = STRATEGIES[strategy]
    q, k, v = _qkv(21)
    mask = _padding(22)
    got, _ = _port_sp(port_fn, q, k, v, mask, "bfloat16", False, 0.1, 7)
    want, _ = _jax_sp(jax_fn, q, k, v, mask, "bfloat16", False, 0.1, 7)
    _close(got, want, "bfloat16")


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_sp_dropout_mask_is_the_global_mask_bitwise(strategy):
    """q = 0 and v = I: every output row is the keep factors of its row
    over L (a uniform softmax), so the assembled output times L is the
    mask itself, held bitwise to JAX ``dropout_keep`` on the global
    (b, h, q, k) grid."""
    port_fn, _ = STRATEGIES[strategy]
    B, H, L = 4, 4, 32
    q = np.zeros((B, H, L, L), np.float32)
    v = np.broadcast_to(np.eye(L, dtype=np.float32), (B, H, L, L)).copy()
    got, _ = _port_sp(port_fn, q, q, v, None, "float32", False, 0.1, 99)
    keep = np.asarray(ja.dropout_keep(
        jnp.uint32(99), ja.bh_index(B, H),
        jnp.arange(L)[None, None, :, None], jnp.arange(L)[None, None, None, :],
        0.1))
    np.testing.assert_array_equal(got * L, keep)


def test_sequence_shard_dropout_and_stream_index_are_global():
    """``hash_dropout`` on a rank's [B, L/S, d] shard (offset b0 · L · d,
    s0, l_glob) is the global mask's slice bitwise, forward and backward;
    ``global_bh`` is JAX's global (b, h) index of the rank's rows."""
    B, L, d = 4, 16, 8
    x = torch.randn(B, L, d)
    whole = hash_dropout(x, 1234, 0.1)
    for b0, bl in ((0, 2), (2, 2)):
        for s in range(SP):
            ll = L // SP
            part = x[b0:b0 + bl, s * ll:(s + 1) * ll].clone().requires_grad_()
            got = hash_dropout(part, 1234, 0.1, offset=b0 * L * d,
                               s0=s * ll, l_glob=L)
            assert torch.equal(got, whole[b0:b0 + bl, s * ll:(s + 1) * ll])
            (gp,) = torch.autograd.grad(got.sum(), part)
            assert torch.equal(gp != 0, got != 0)
    np.testing.assert_array_equal(
        global_bh(2, 4, b0=2).numpy(), np.asarray(ja.bh_index(4, 4))[2:4])


def _ffn_inputs(seed, rows, d=32, d_ff=64):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        h=rng.normal(size=(rows, d)).astype(f32),
        ln_scale=(1.0 + 0.1 * rng.normal(size=d)).astype(f32),
        ln_bias=(0.1 * rng.normal(size=d)).astype(f32),
        w1=(rng.normal(size=(d, d_ff)) / np.sqrt(d)).astype(f32),
        b1=(0.1 * rng.normal(size=d_ff)).astype(f32),
        w2=(rng.normal(size=(d_ff, d)) / np.sqrt(d_ff)).astype(f32),
        b2=(0.1 * rng.normal(size=d)).astype(f32))


def _ffn_jax(x, dtype, h):
    jd = getattr(jnp, dtype)
    return (jnp.asarray(h).astype(jd), jnp.asarray(x["ln_scale"]),
            jnp.asarray(x["ln_bias"]), jnp.asarray(x["w1"]).astype(jd),
            jnp.asarray(x["b1"]).astype(jd), jnp.asarray(x["w2"]).astype(jd),
            jnp.asarray(x["b2"]).astype(jd))


def _ffn_torch(x, dtype, h):
    td = getattr(torch, dtype)
    return (torch.from_numpy(h).to(td), torch.from_numpy(x["ln_scale"]),
            torch.from_numpy(x["ln_bias"]),
            torch.from_numpy(x["w1"].T.copy()).to(td),
            torch.from_numpy(x["b1"]).to(td),
            torch.from_numpy(x["w2"].T.copy()).to(td),
            torch.from_numpy(x["b2"]).to(td))


SEEDS = (0x9E3779B9, 0x2545F491)
FFN_SCALES = np.array([40.0, 300.0, 25.0, 250.0], np.float32)
B_FFN, L_FFN = 3, 16


def _halves(x):
    """The rank's rows of a sequence half: [B, L/2, d] of each b, flat."""
    h = x["h"].reshape(B_FFN, L_FFN, -1)
    half = L_FFN // 2
    return [np.ascontiguousarray(h[:, s * half:(s + 1) * half]).reshape(
        B_FFN * half, -1) for s in range(2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_ffn_at_sequence_offsets_matches_ffn_fwd_pallas(dtype):
    """The unquantized plain version (and ``fused_ffn_sublayer``) on the
    second half of each row (s0 = L/2, l_loc = L/2, l_glob = L, b0 = 1)
    against ``_ffn_fwd_pallas`` at the same operands; each half bitwise
    the whole call's rows."""
    x = _ffn_inputs(1, B_FFN * L_FFN)
    half = L_FFN // 2
    parts = _halves(x)
    hs = parts[1]
    seeds = jnp.asarray([[SEEDS[0], SEEDS[1], 1, half]], jnp.uint32)
    want = jf._ffn_fwd_pallas(*_ffn_jax(x, dtype, hs), seeds, 0.1, 0.1, 1e-6,
                              half, L_FFN, block_rows=8)
    targs = _ffn_torch(x, dtype, hs)
    got = tf.ffn_fwd(*targs, *SEEDS, 0.1, 0.1, 1e-6, 1, half, half, L_FFN)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)
    again = tf.fused_ffn_sublayer(targs[0].reshape(B_FFN, half, -1),
                                  *targs[1:], *SEEDS, 0.1, 0.1, b0=1,
                                  s0=half, l_glob=L_FFN)
    assert torch.equal(again.reshape(got.shape), got)
    # the halves are the whole rows' (b0 = 1 throughout)
    whole = tf.ffn_fwd(*_ffn_torch(x, dtype, x["h"]), *SEEDS, 0.1, 0.1,
                       1e-6, 1, 0, L_FFN, L_FFN).reshape(B_FFN, L_FFN, -1)
    for s, p in enumerate(parts):
        out = tf.ffn_fwd(*_ffn_torch(x, dtype, p), *SEEDS, 0.1, 0.1, 1e-6, 1,
                         s * half, half, L_FFN)
        assert torch.equal(out.reshape(B_FFN, half, -1),
                           whole[:, s * half:(s + 1) * half])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", [None, "int8", "fp8"])
def test_plain_ffn2_at_sequence_offsets_matches_ffn_fwd_pallas2(dtype, fmt):
    """The generalized plain version on the second halves against
    ``_ffn_fwd_pallas2`` (none / int8 / E4M3); the amaxes bitwise in
    bf16, to 1 ulp in fp32; the halves' amax MAX the whole call's."""
    x = _ffn_inputs(2, B_FFN * L_FFN)
    half = L_FFN // 2
    parts = _halves(x)
    seeds = jnp.asarray([[SEEDS[0], SEEDS[1], 0, half, 0]], jnp.uint32)
    want, want_amax = jf._ffn_fwd_pallas2(
        *_ffn_jax(x, dtype, parts[1]), seeds, jnp.asarray(FFN_SCALES), 0.1,
        0.1, 1e-6, half, L_FFN, 64, fmt, None, (), False, block_rows=8)
    sc = torch.from_numpy(FFN_SCALES)
    got, amax = tf.ffn_fwd_generalized(
        *_ffn_torch(x, dtype, parts[1]), (*SEEDS, 0, half, 0), sc, 0.1, 0.1,
        1e-6, half, L_FFN, 64, fmt)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)
    if dtype == "float32":
        np.testing.assert_allclose(amax.numpy(), np.asarray(want_amax),
                                   rtol=2 ** -23, atol=0)
    else:
        np.testing.assert_array_equal(
            amax.to(torch.bfloat16).float().numpy(),
            np.asarray(jnp.asarray(want_amax).astype(jnp.bfloat16)
                       .astype(jnp.float32)))
    whole, wamax = tf.ffn_fwd_generalized(
        *_ffn_torch(x, dtype, x["h"]), (*SEEDS, 0, 0, 0), sc, 0.1, 0.1, 1e-6,
        L_FFN, L_FFN, 64, fmt)
    whole = whole.reshape(B_FFN, L_FFN, -1)
    amaxes = []
    for s, p in enumerate(parts):
        out, a = tf.ffn_fwd_generalized(
            *_ffn_torch(x, dtype, p), (*SEEDS, 0, s * half, 0), sc, 0.1, 0.1,
            1e-6, half, L_FFN, 64, fmt)
        assert torch.equal(out.reshape(B_FFN, half, -1),
                           whole[:, s * half:(s + 1) * half])
        amaxes.append(a)
    if fmt is not None:
        assert torch.equal(torch.maximum(*amaxes), wamax)


def test_embeddings_at_s0_are_the_whole_rows_slice():
    """The port's ``Embeddings`` and the model's encodings site on the
    positions ``[s0, s0 + L/S)`` of each row against JAX's embeddings of
    the whole rows, sliced."""
    from faster_distributed_training_tpu.models.transformer import (
        Embeddings as JEmbeddings)
    from faster_distributed_training_tpu_torch.models.transformer import (
        Embeddings)

    V, L, d = 50, 16, 8
    rng = np.random.default_rng(4)
    x = rng.integers(0, V, size=(3, L)).astype(np.int32)
    tt = rng.integers(0, 2, size=(3, L)).astype(np.int32)
    jm = JEmbeddings(d_model=d, vocab=V, maxlen=L)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(tt))
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(tt))[0])
    port = Embeddings(d, V, L)
    with torch.no_grad():
        for name in ("token_embedding", "pos_embedding",
                     "segment_embedding"):
            getattr(port, name).copy_(torch.from_numpy(np.asarray(
                params["params"][name])))
    for s0 in (0, 4, 8, 12):
        got = port(torch.from_numpy(x[:, s0:s0 + 4]).long(),
                   torch.from_numpy(tt[:, s0:s0 + 4]).long(), s0)
        np.testing.assert_allclose(got.detach().numpy(),
                                   want[:, s0:s0 + 4], rtol=0, atol=1e-6)


def _cfg(**kw):
    return TrainConfig(**{**dict(model="transformer", device="cpu",
                                 n_heads=8, seq_len=512), **kw})


@pytest.mark.parametrize("heads,seq,sp", [(8, 512, 2), (8, 512, 4),
                                          (6, 512, 4), (8, 500, 8),
                                          (8, 8192, 2), (4, 64, 3)])
def test_route_matches_jax_route_model_axis(heads, seq, sp):
    """The sp route: Ulysses where sp divides the heads, else the ring,
    None where sp does not divide seq_len (JAX ``_route_model_axis``);
    ``resolve_attention`` on an sp mesh takes it, an explicit
    ``--attention`` wins."""
    jc = JConfig(n_heads=heads, seq_len=seq)
    want = jcli._route_model_axis(jc, sp)
    assert cli.route_model_axis(_cfg(n_heads=heads, seq_len=seq), sp) == want
    mesh = dict(mesh_axes=("dp", "sp"), mesh_shape=(1, sp))
    if want is not None:
        assert cli.resolve_attention(_cfg(n_heads=heads, seq_len=seq,
                                          **mesh), "cpu") == want
        jmesh = j_mesh(("sp",), (sp,), jax.devices()[:sp]) if sp <= 8 \
            else None
        if jmesh is not None:
            assert jcli.resolve_attention(jc, jmesh) == want
    assert cli.resolve_attention(_cfg(n_heads=heads, seq_len=seq,
                                      attention="ring", **mesh),
                                 "cpu") == "ring"


def test_mesh_parse_and_layout_of_sp():
    """The sp aliases parse as JAX's; sp is laid out inside the data axes
    and outside tp; the sequence axis is the dedicated sp axis, else tp
    (JAX ``seq_parallel_axis``); an sp mesh needs its processes."""
    from faster_distributed_training_tpu.config import (
        parse_mesh as j_parse_mesh)
    from faster_distributed_training_tpu.parallel import mesh as jm
    from faster_distributed_training_tpu_torch.parallel.mesh import (
        make_mesh)

    for spec in ("sp=2", "seq=2", "sequence=4", "context=2", "dp=2,sp=2",
                 "sp=2,dp=2"):
        assert parse_mesh(spec) == j_parse_mesh(spec)
    assert ordered_axes(*parse_mesh("context=2,dp=4")) == (("dp", "sp"),
                                                           (4, 2))
    assert ordered_axes(("sp", "tp", "dp"), (2, 2, 2)) == (
        ("dp", "sp", "tp"), (2, 2, 2))
    for spec in ("dp=2,sp=4", "tp=2", "dp=2,tp=2,sp=2", "dp=8", ""):
        axes, shape = parse_mesh(spec)
        jmesh = (j_mesh(axes, shape, jax.devices()[:int(np.prod(shape))])
                 if shape else None)
        assert seq_parallel_axis((axes, shape)) == jm.seq_parallel_axis(
            jmesh), spec
    assert batch_axes(("dp", "sp")) == ("dp",)
    assert batch_axes(("fsdp", "dp", "sp")) == ("dp", "fsdp")
    axes, shape = parse_mesh("dp=1,sp=2")
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh(axes, shape, "cpu")


SP_UNPORTED = [
    (["--mesh", "sp=2,tp=2"], "--mesh tp=2 under --mesh sp=2"),
    (["--mesh", "fsdp=1,sp=2", "--fsdp"], "--fsdp under --mesh sp=2"),
    (["--mesh", "sp=2", "--zero1"], "--zero1 under --mesh sp=2"),
    (["--mesh", "sp=2", "--host_offload"],
     "--host_offload under --mesh sp=2"),
    (["--mesh", "sp=2", "--offload_opt_state"],
     "--offload_opt_state under --mesh sp=2"),
    (["--mesh", "sp=2", "--steps_per_dispatch", "2"],
     "--steps_per_dispatch 2 under --mesh sp=2"),
    (["--mesh", "sp=2", "--data_path", "resident"],
     "--data_path resident under --mesh sp=2"),
    (["--mesh", "sp=2", "--remat"], "--remat under --mesh sp=2"),
    (["--mesh", "sp=2", "--model", "resnet18"],
     "--model resnet18 under --mesh sp=2"),
    (["--mesh", "sp=2", "--ngd"], "--ngd under --mesh sp=2"),
    (["--mesh", "sp=2", "--attention", "dense"],
     "--attention dense under --mesh sp=2"),
    (["--mesh", "sp=2", "--attention", "flash"],
     "--attention flash under --mesh sp=2"),
    (["--mesh", "sp=2", "--seq_len", "15"],
     "--seq_len 15 not divisible by --mesh sp=2"),
    (["--mesh", "sp=4", "--n_heads", "6", "--d_model", "96", "--attention",
      "ulysses"], "--attention ulysses with --n_heads 6 not divisible by "
     "--mesh sp=4"),
    (["--mesh", "tp=2", "--attention", "ring"],
     "--attention ring without --mesh sp=N"),
    (["--attention", "ulysses"], "--attention ulysses without --mesh sp=N"),
]


@pytest.mark.parametrize("flags,name", SP_UNPORTED)
def test_unported_sp_combinations_raise_by_name(tmp_path, flags, name):
    """Each of ``cli.sp_unported``'s flags raises ``NotImplementedError``
    naming itself, before any process group is needed; serving under sp
    raises in ``build_model``."""
    argv = ["--dataset", "synthetic", "--device", "cpu", "--no_plot",
            "--checkpoint_dir", str(tmp_path)]
    defaults = (cli.RESNET50_DEFAULTS if "resnet18" in flags
                else cli.TRANSFORMER_DEFAULTS)
    cfg = cli.config_from_args(cli.build_parser(defaults=defaults)
                               .parse_args(argv + flags), defaults=defaults)
    assert any(name in f for f in cli.sp_unported(cfg)), cli.sp_unported(cfg)
    with pytest.raises(NotImplementedError, match=name):
        cli.main(argv + flags, defaults=defaults)
    if name.startswith("--fsdp"):
        with pytest.raises(NotImplementedError, match="serving under --mesh"):
            cli.build_model(cfg.replace(fsdp=False), vocab_size=100,
                            serving=True, device="cpu")
