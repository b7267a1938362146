"""The port's data-mesh layer in one process, against the JAX package.

  * The axis alias table and the ``--mesh`` parse against JAX's
    ``canonical_axis`` / ``parse_mesh`` / ``MeshSpec``; a tp, sp or pp
    mesh needs its processes, tp is laid out innermost.
  * The fsdp shard dim of every parameter of the record (6 layers,
    d_model 512, vocab 30522) and of resnet50 against JAX
    ``fsdp_partition_params`` on the same shapes, at 2, 4 and 8 shards;
    the zero1 choice of every MirrorMADGRAD leaf and ``offload_opt_leaf``
    against JAX's on the same shapes.
  * ``local_batch_slice``, and each rank's rows from ``make_put_batch``
    against the shards JAX's ``make_put_batch`` places on a dp mesh.
  * Every dropout site at a batch origin: rank r's keep factors at
    ``b0 = r * Bl`` are bitwise the rows r * Bl.. of the single-process
    factors (flash plain versions, dense attention, ``hash_dropout``,
    the fused FFN's plain version), N = 2 and 4; the plain attention
    and FFN outputs of a half batch are the full batch's rows.
  * BatchNorm's global statistics from N shards against the whole
    batch's: fp64 to 1e-12, fp32 to 1e-6.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from faster_distributed_training_tpu.config import parse_mesh as j_parse_mesh
from faster_distributed_training_tpu.parallel import mesh as jmesh
from faster_distributed_training_tpu.parallel import placement as jplacement
from faster_distributed_training_tpu.parallel import sharding as jsharding
from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.ops import conv_bn
from faster_distributed_training_tpu_torch.ops.attention import (
    bh_index, dense_attention_reference, dropout_keep)
from faster_distributed_training_tpu_torch.ops.dropout import (
    hash_dropout, keep_factor_rows)
from faster_distributed_training_tpu_torch.ops.flash_attention import (
    _keep, flash_attention_bwd_reference, flash_attention_stats_reference)
from faster_distributed_training_tpu_torch.ops.fused_ffn import (
    _global_rows, ffn_sublayer_reference)
from faster_distributed_training_tpu_torch.optim import build_optimizer
from faster_distributed_training_tpu_torch.parallel import (
    AXIS_ALIASES, DataGroup, MeshSpec, canonical_axis, fsdp_partition_params,
    local_batch_slice, make_mesh, make_put_batch, offload_opt_leaf,
    parse_mesh, zero1_opt_specs)
from faster_distributed_training_tpu_torch.parallel.mesh import ordered_axes
from faster_distributed_training_tpu_torch.train.state import (
    create_train_state)

SHARDS = (2, 4, 8)


def test_axis_aliases_and_mesh_parse_match_jax():
    assert AXIS_ALIASES == jmesh.AXIS_ALIASES
    for name in list(AXIS_ALIASES) + ["Data", " model ", "expert"]:
        assert canonical_axis(name) == jmesh.canonical_axis(name), name
    for spec in ("dp=4", "data=2,model=4", "fsdp=8", "zero=2,dp=2",
                 "dp=2,seq=2,stage=2", ""):
        assert parse_mesh(spec) == j_parse_mesh(spec), spec
    for spec in ("dp", "dp=2,=3", "=2"):
        with pytest.raises(ValueError):
            j_parse_mesh(spec)
        with pytest.raises(ValueError):
            parse_mesh(spec)
    with pytest.raises(ValueError, match="duplicate"):
        parse_mesh("dp=2,data=2")
    assert MeshSpec(("dp", "tp"), (4, 2)).size == jmesh.MeshSpec(
        ("dp", "tp"), (4, 2)).size == 8
    # tp, sp and pp are ported: a tp=2, sp=2 or pp=4 mesh needs its
    # processes (and one process has none), and tp, then sp, is laid out
    # innermost whatever order --mesh names them in
    axes, shape = parse_mesh("pipe=4")
    with pytest.raises(ValueError, match="needs 4 processes"):
        make_mesh(axes, shape, "cpu")
    for spec in ("dp=1,tp=2", "seq=2"):
        axes, shape = parse_mesh(spec)
        with pytest.raises(ValueError, match="needs 2 processes"):
            make_mesh(axes, shape, "cpu")
    assert ordered_axes(*parse_mesh("model=2,dp=4")) == (("dp", "tp"),
                                                         (4, 2))
    assert ordered_axes(*parse_mesh("seq=2,dp=4")) == (("dp", "sp"),
                                                       (4, 2))


def _meta_model(model: str, **kw):
    """The port's model of ``model`` at full width on the meta device
    (shapes only)."""
    cfg = TrainConfig(model=model, device="cpu", **kw)
    with torch.device("meta"):
        return cli.build_model(cfg, vocab_size=30522, device="cpu")


def _jax_dims(shapes: dict, n: int) -> dict:
    """JAX fsdp_partition_params on a dict of shapes: name -> dim."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("fsdp",))
    tree = {k: jax.ShapeDtypeStruct(s, np.float32) for k, s in shapes.items()}
    specs = jsharding.fsdp_partition_params(tree, mesh, axis="fsdp")
    out = {}
    for k, spec in specs.items():
        dims = [i for i, a in enumerate(tuple(spec)) if a == "fsdp"]
        out[k] = dims[0] if dims else None
    return out


@pytest.mark.parametrize("model", ["transformer", "resnet50"])
def test_fsdp_dims_match_jax_fsdp_partition_params(model):
    kw = (dict(n_layers=6, d_model=512, n_heads=8, d_ff=1024, seq_len=512)
          if model == "transformer" else {})
    params = dict(_meta_model(model, **kw).named_parameters())
    shapes = {k: tuple(p.shape) for k, p in params.items()}
    sharded = 0
    for n in SHARDS:
        got = fsdp_partition_params(params, n)
        assert got == _jax_dims(shapes, n), n
        sharded += sum(d is not None for d in got.values())
    # the rule shards most leaves and keeps the small ones whole
    assert sharded and any(d is None for d in got.values())


def test_zero1_and_offload_choices_match_jax():
    cfg = TrainConfig(model="transformer", device="cpu", n_layers=2,
                      d_model=64, n_heads=4, d_ff=128, seq_len=32)
    model = cli.build_model(cfg, vocab_size=4000, device="cpu")
    tx, _ = build_optimizer(cfg, steps_per_epoch=4)
    state = create_train_state(model, tx)
    leaves = {f"{part}/{k}": t for part in ("v", "z")
              for k, t in state.opt_state[part].items()}
    shapes = {k: tuple(t.shape) for k, t in leaves.items()}
    for n in SHARDS:
        specs = zero1_opt_specs(state.opt_state, n)
        got = {f"{part}/{k}": specs[part][k] for part in ("v", "z")
               for k in specs[part]}
        assert got == _jax_dims(shapes, n), n
        assert specs["step"] is None
    picks = {k: offload_opt_leaf(s) for k, s in shapes.items()}
    assert picks == {k: jsharding.offload_opt_leaf(s)
                     for k, s in shapes.items()}
    assert any(picks.values()) and not all(picks.values())


def _fake_group(rank: int, world: int) -> DataGroup:
    g = DataGroup()
    g.rank, g.world = rank, world
    return g


@pytest.mark.parametrize("n", [2, 4])
def test_rank_rows_match_jax_process_local_shards(n):
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 100, (8, 6)).astype(np.int32),
             "label": rng.integers(0, 4, 8).astype(np.int32)}
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    placed = jplacement.make_put_batch(mesh)(batch)
    for k, arr in placed.items():
        shards = sorted(arr.addressable_shards, key=lambda s: s.device.id)
        for r, shard in enumerate(shards):
            got = make_put_batch(_fake_group(r, n), "cpu")(batch)[k]
            np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                          np.asarray(shard.data), err_msg=k)
            assert local_batch_slice(8, n, r) == (8 // n, r * 8 // n)
    stacked = {"tokens": rng.integers(0, 9, (3, 8, 2)).astype(np.int32)}
    got = make_put_batch(_fake_group(1, n), "cpu", stacked=True)(stacked)
    np.testing.assert_array_equal(
        got["tokens"].numpy(), stacked["tokens"][:, 8 // n:2 * 8 // n])
    with pytest.raises(ValueError, match="not divisible"):
        local_batch_slice(9, 2, 0)


SEED, RATE = 0x9E3779B9, 0.1


@pytest.mark.parametrize("n", [2, 4])
def test_keep_factors_at_a_batch_origin_are_the_global_rows(n):
    B, H, L, D, F = 8, 2, 12, 16, 24
    Bl = B // n
    q = torch.zeros(B, H, L, D)
    full_flash = _keep(q, L, RATE, SEED)
    full_bh = bh_index(B, H)
    x = torch.ones(B, L, D)
    full_drop = hash_dropout(x, SEED, RATE)
    full_ffn = keep_factor_rows(SEED, _global_rows(
        torch.arange(B * L), 0, 0, L, L), F, RATE)
    for r in range(n):
        rows, b0 = slice(r * Bl, (r + 1) * Bl), r * Bl
        assert torch.equal(_keep(q[rows], L, RATE, SEED, b0=b0),
                           full_flash[rows])
        assert torch.equal(bh_index(Bl, H, b0=b0), full_bh[rows])
        assert torch.equal(hash_dropout(x[rows], SEED, RATE,
                                        offset=b0 * L * D), full_drop[rows])
        got = keep_factor_rows(SEED, _global_rows(
            torch.arange(Bl * L), b0, 0, L, L), F, RATE)
        assert torch.equal(got, full_ffn[r * Bl * L:(r + 1) * Bl * L])
    # the factors do differ from rank to rank
    assert not torch.equal(full_flash[:Bl], full_flash[Bl:2 * Bl])


def test_plain_attention_and_ffn_at_a_batch_origin_are_the_full_rows():
    g = torch.Generator().manual_seed(0)
    B, H, L, D, d, F = 4, 2, 16, 16, 32, 64
    q, k, v, dout = (torch.randn(B, H, L, D, generator=g) for _ in range(4))
    out, lse, lse_lo = flash_attention_stats_reference(q, k, v, None, RATE,
                                                       SEED)
    grads = flash_attention_bwd_reference(q, k, v, out, lse, dout, None,
                                          RATE, SEED, lse_lo)
    dense = dense_attention_reference(q, k, v, None, RATE, SEED)
    h = torch.randn(B, L, d, generator=g)
    w1, w2 = torch.randn(F, d, generator=g), torch.randn(d, F, generator=g)
    b1, b2 = torch.randn(F, generator=g), torch.randn(d, generator=g)
    ln = (torch.ones(d), torch.zeros(d))
    ffn = ffn_sublayer_reference(h.reshape(-1, d), *ln, w1, b1, w2, b2,
                                 SEED, SEED + 1, RATE, RATE, 1e-6)
    for r0 in (0, 2):
        rows = slice(r0, r0 + 2)
        o, ls, lo = flash_attention_stats_reference(
            q[rows], k[rows], v[rows], None, RATE, SEED, b0=r0)
        torch.testing.assert_close(o, out[rows], rtol=0, atol=0)
        torch.testing.assert_close(ls, lse[rows], rtol=0, atol=0)
        gr = flash_attention_bwd_reference(
            q[rows], k[rows], v[rows], o, ls, dout[rows], None, RATE, SEED,
            lo, b0=r0)
        for a, b in zip(gr, grads):
            torch.testing.assert_close(a, b[rows], rtol=0, atol=0)
        torch.testing.assert_close(
            dense_attention_reference(q[rows], k[rows], v[rows], None, RATE,
                                      SEED, b0=r0), dense[rows],
            rtol=0, atol=0)
        got = ffn_sublayer_reference(h[rows].reshape(-1, d), *ln, w1, b1,
                                     w2, b2, SEED, SEED + 1, RATE, RATE,
                                     1e-6, r0, 0, L, L)
        torch.testing.assert_close(got, ffn[r0 * L:(r0 + 2) * L],
                                   rtol=0, atol=0)
    # the keep factors a plain attention version takes at b0 are the
    # dense engine's at global (b, h)
    want = dropout_keep(SEED, bh_index(B, H),
                        torch.arange(L)[None, None, :, None],
                        torch.arange(L)[None, None, None, :], RATE)
    torch.testing.assert_close(_keep(q[2:], L, RATE, SEED, b0=2), want[2:],
                               rtol=0, atol=0)


class _Shards:
    """A stand-in DataGroup for N shards of one process: ``mean`` returns
    the mean of what every shard handed it (recorded in a first pass)."""

    def __init__(self, world, seen=None):
        self.world, self.seen = world, seen

    def mean(self, t):
        if self.seen is None or isinstance(self.seen, list):
            self.seen = (self.seen or []) + [t]
            return t
        return self.seen


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-6)])
@pytest.mark.parametrize("n", [2, 4])
def test_bn_global_stats_from_shards_match_the_whole_batch(dtype, tol, n):
    g = torch.Generator().manual_seed(1)
    y = (torch.randn(8, 6, 5, 5, generator=g, dtype=torch.float64) * 3.0
         + 1.5).to(dtype)
    want_mean, want_var = conv_bn._bn_stats(y)
    rec = _Shards(n)
    for part in y.chunk(n):
        conv_bn._bn_stats(part, rec)
    avg = _Shards(n, torch.stack(rec.seen).sum(0) / n)
    for part in y.chunk(n):
        mean, var = conv_bn._bn_stats(part, avg)
        assert mean.dtype == want_mean.dtype
        torch.testing.assert_close(mean, want_mean, rtol=0, atol=tol)
        torch.testing.assert_close(var, want_var, rtol=tol, atol=tol)


def test_global_norm_over_shards_is_the_whole_norm():
    """Under fsdp / zero1 each rank holds slices of the sharded leaves:
    their sums of squares are summed over the shard group before the
    whole leaves' join (here the two ranks' slices in one process)."""
    from faster_distributed_training_tpu_torch.optim.builder import (
        clip_by_global_norm, global_norm)

    g = torch.Generator().manual_seed(2)
    grads = {"w": torch.randn(8, 6, generator=g) * 3,
             "b": torch.randn(6, generator=g), "u": torch.randn(4, 10,
                                                               generator=g)}
    sharded = {"w": 0, "u": 1}
    halves = [{k: (v.chunk(2, dim=sharded[k])[r] if k in sharded else v)
               for k, v in grads.items()} for r in range(2)]

    def other_rank_sum(r):
        other = halves[1 - r]
        return lambda t: t + sum(torch.sum(torch.square(other[k]))
                                 for k in sharded)

    want = global_norm(grads)
    for r in range(2):
        got = global_norm(halves[r], (set(sharded), other_rank_sum(r)))
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        clipped = clip_by_global_norm(halves[r], 1.0,
                                      (set(sharded), other_rank_sum(r)))
        full = clip_by_global_norm(grads, 1.0)
        torch.testing.assert_close(
            clipped["w"], full["w"].chunk(2, dim=0)[r], rtol=1e-6, atol=0)


def test_bucketed_grad_reduce_keeps_each_gradient_layout(tmp_path):
    """The gradient buckets (one process, a gloo group of one) return each
    leaf with the layout it came in, a channels_last conv gradient
    channels_last: the clip's global norm, which adds a leaf's squares in
    memory order, is then bitwise the norm without a group (the ResNet's
    conv gradients on the card are channels_last; a contiguous copy
    changed the norm's rounding, and with the clip engaged every update:
    phase P1's ResNet check)."""
    import torch.distributed as dist

    from faster_distributed_training_tpu_torch.optim.builder import (
        global_norm)
    from faster_distributed_training_tpu_torch.parallel.sharding import (
        bucketed_grad_reduce)

    g = torch.Generator().manual_seed(5)
    grads = {"conv": torch.randn(64, 32, 3, 3, generator=g).to(
                 memory_format=torch.channels_last),
             "bias": torch.randn(64, generator=g),
             "fc": torch.randn(10, 512, generator=g).t(),
             "bn": torch.randn(1, 64, 1, 1, generator=g).to(
                 memory_format=torch.channels_last)}
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        def strides(t):     # a size-1 dim's stride is never read
            return [s for s, n in zip(t.stride(), t.shape) if n > 1]

        for bucket in (0, 4096):
            out = bucketed_grad_reduce(grads, None, bucket, 1)
            for k, v in grads.items():
                assert torch.equal(out[k], v), k
                assert strides(out[k]) == strides(v), k
            assert torch.equal(global_norm(out), global_norm(grads))
    finally:
        dist.destroy_process_group()
