"""The port's tensor-parallel layer (``parallel/sharding.py``'s tp rules,
``parallel/kernel_shard.py``, row 8's ``partial`` tile, the head and
column origins of the dropout streams) against the JAX package's, in
one process.

Same numpy inputs through both packages:

  * every parameter's tp layout (``tp_cut``, through its JAX path)
    against JAX ``tensor_parallel_rules`` and ``apply_tp_rules`` on a
    tp=2 mesh, equal; the shards cut and reassembled bitwise;
  * ZeRO over tp: every MirrorMADGRAD leaf's class and sharded axis
    against JAX ``zero_opt_state_specs`` (``classify_opt_state_leaf``),
    equal;
  * ``_ffn_body_reference(partial=True)`` against JAX
    ``_ffn_fwd_pallas2(..., partial=True)`` in interpret mode, fmt none,
    int8 and E4M3, dropout 0.1, c0 = d_ff/2: fp32 1e-5, bf16 2e-2 of max
    |ref|, the amaxes bitwise in bf16 (1 ulp in fp32);
  * the plain flash forward and ``flash_attention_qkv`` on a head shard
    at h0 = H/2 (h_glob = H) against JAX ``flash_attention_sharded``'s
    heads on a tp=2 mesh: 1e-5;
  * the dense path's attention keep mask at (h0, h_glob) and the flax
    FFN's hidden dropout at (c0, d_ff) against the global arrays'
    slices (JAX ``dropout_keep``, ``hash_dropout``, ``keep_factor_rows``
    at ``col0`` / ``cols_glob``), bitwise;
  * each rank's ``QuantDense`` on its shard against JAX ``kernel_shard.
    quant_dense_sharded`` on a tp=2 mesh: int8 column shards bitwise,
    the row-parallel SUM 1e-6 of max |ref| (E4M3 the same);
  * the fused tp sublayer's backward: the two ranks' gradients, summed
    where the tile's inputs are replicated, against the whole sublayer's;
  * a vocabulary tp does not divide: the padded token-table shards, their
    masked lookups and gradients against the one-card table's.

Small sizes: d 32, 4 heads, d_ff 64, a few dozen rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from faster_distributed_training_tpu.ops import fused_ffn as jf
from faster_distributed_training_tpu.parallel import sharding as jsh
from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.ops import fused_ffn as tf
from faster_distributed_training_tpu_torch.parallel import sharding as tsh
from faster_distributed_training_tpu_torch.parallel.collectives import (
    TensorGroup)

D, H, DFF, ROWS, L = 32, 4, 64, 48, 16
SEEDS = (0x9E3779B9, 0x2545F491)
SCALES = np.array([40.0, 300.0, 25.0, 250.0], np.float32)


def _tp_mesh(n=2):
    return Mesh(np.array(jax.devices()[:n]), ("tp",))


def _shard_rank(r, n=2):
    """A rank's TensorGroup without a process group: the per-shard math,
    collectives the identity."""
    return TensorGroup(None, r, n)


def _jax_params(**flags):
    """JAX's initial parameter tree of the small Transformer (numpy)."""
    from faster_distributed_training_tpu import cli as jcli
    from faster_distributed_training_tpu.config import TrainConfig as JCfg

    jcfg = JCfg(model="transformer", dataset="synthetic", num_classes=4,
                seq_len=L, n_layers=2, d_model=D, d_ff=DFF, n_heads=H,
                precision="fp32", attention="dense", device="cpu", **flags)
    model = jcli.build_model(jcfg, vocab_size=100)
    rng = jax.random.PRNGKey(0)
    variables = jax.jit(lambda r, x: model.init(r, x, train=True))(
        {"params": rng, "dropout": rng, "mixup": rng},
        jnp.zeros((2, L), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, variables["params"])


@pytest.mark.parametrize("n", [2, 4])
def test_tp_layout_of_every_leaf_matches_jax_rules(n):
    """``tp_cut`` of every port parameter, through its JAX path, is JAX's
    ``tensor_parallel_rules`` / ``apply_tp_rules`` spec in the port's
    layout; each leaf's shards reassemble the whole leaf bitwise."""
    from faster_distributed_training_tpu_torch.interop import (
        params_from_jax)

    jparams = _jax_params()
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jparams)[0]}
    specs = jsh.apply_tp_rules(jparams, _tp_mesh(n))
    jspec = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s)
             for path, s in jax.tree_util.tree_flatten_with_path(
                 specs, is_leaf=lambda x: isinstance(
                     x, jax.sharding.PartitionSpec))[0]}
    assert tsh._TP_RULES == tuple(
        (pat, tuple(spec)) for pat, spec in jsh._TP_RULES)
    sd = params_from_jax(jparams)
    cut_any = set()
    for name, whole in sd.items():
        path = tsh.jax_param_path(name)
        assert path in flat, name
        want = jspec[path]
        assert tuple(jsh.tensor_parallel_rules(path)) == want
        assert tsh.tensor_parallel_rules(path) == want
        cut = tsh.tp_cut(name)
        if "tp" not in want:
            assert cut is None, name
            continue
        cut_any.add(cut)
        jdim = want.index("tp")
        if cut == "heads":
            assert flat[path].shape[jdim] == H
        elif cut == "rows":
            assert jdim == (1 if name.endswith(".weight") else 0), name
        else:
            assert jdim == 0 and name.endswith(".weight"), name
        parts = [tsh.tp_shard(whole, cut, r, n, H) for r in range(n)]
        assert all(p.numel() * n == whole.numel() for p in parts)
        assert torch.equal(tsh.tp_unshard(parts, cut, H), whole), name
    assert cut_any == {"rows", "cols", "heads"}
    # the head shard's rows of the fused qkv: {i*H*Dk + (h0 + j)*Dk + k}
    dk, w = D // H, sd["layers.0.attn.qkv.weight"]
    rows = [i * H * dk + (H // n + j) * dk + k for i in range(3)
            for j in range(H // n) for k in range(dk)]
    assert torch.equal(tsh.tp_shard(w, "heads", 1, n, H), w[rows])


def test_zero_over_tp_matches_jax_zero_opt_state_specs():
    """Every MirrorMADGRAD leaf: JAX's ZeRO-over-tp spec (the
    param_mirror rule on the tp-overlaid params, the largest divisible
    axis of a replicated param's mirror, 1024 elements and up) is the
    port's tp cut or zero dim on the same leaf."""
    from faster_distributed_training_tpu.optim import (
        build_optimizer as j_build_optimizer)
    from faster_distributed_training_tpu.config import TrainConfig as JCfg
    from faster_distributed_training_tpu_torch.interop import (
        params_from_jax)

    jparams = {"model": _jax_params()}
    mesh = _tp_mesh(2)
    jtx, _ = j_build_optimizer(JCfg(model="transformer", lr=1e-3),
                               steps_per_epoch=4)
    opt = jtx.init(jparams)
    pspecs = {"model": jsh.apply_tp_rules(jparams["model"], mesh)}
    zspecs = jsh.zero_opt_state_specs(opt, jparams, pspecs, mesh)
    sd = params_from_jax(jparams["model"])
    cuts = tsh.apply_tp_rules(sd)
    dims = tsh.zero_opt_dims({k: tsh.tp_shard(v, cuts[k], 0, 2, H)
                              for k, v in sd.items()}, cuts, 2)
    by_path = {tsh.jax_param_path(k): k for k in sd}
    seen = 0
    for (path, leaf), (_, spec) in zip(
            jax.tree_util.tree_flatten_with_path(opt)[0],
            jax.tree_util.tree_flatten_with_path(
                zspecs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]):
        key = jax.tree_util.keystr(path)
        names = [p for p in by_path if key.endswith(
            "".join(f"['{s}']" for s in p.split("/")))]
        if not names or np.shape(leaf) != np.shape(
                _leaf(jparams["model"], names[0])):
            assert "tp" not in tuple(spec), key
            continue
        name = by_path[names[0]]
        seen += 1
        spec = tuple(spec)
        if cuts[name] is not None:
            assert spec == tuple(jsh.tensor_parallel_rules(names[0])), key
            continue
        if "tp" not in spec:
            assert dims[name] is None, key
            continue
        jdim = spec.index("tp")
        port = (1 - jdim) if (name.endswith(".weight")
                              and len(np.shape(leaf)) == 2) else jdim
        assert dims[name] == port, key
    assert seen >= 2 * len(sd)


def _leaf(tree, path):
    for p in path.split("/"):
        tree = tree[p]
    return tree


def _ffn_inputs(seed, rows=ROWS, d=D, d_ff=DFF):
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", [None, "int8", "fp8"])
def test_partial_plain_version_matches_ffn_fwd_pallas2_partial(dtype, fmt):
    """Row 8's tp tile: rank 1's d_ff half (w1 columns / w2 rows of JAX's
    layout), the hidden dropout at c0 = d_ff/2 of dff_glob = d_ff."""
    x = _ffn_inputs(3)
    half = DFF // 2
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    w1, b1, w2 = x["w1"][:, half:], x["b1"][half:], x["w2"][half:]
    jargs = (jnp.asarray(x["h"]).astype(jd), jnp.asarray(x["ln_scale"]),
             jnp.asarray(x["ln_bias"]), jnp.asarray(w1).astype(jd),
             jnp.asarray(b1).astype(jd), jnp.asarray(w2).astype(jd),
             jnp.asarray(x["b2"]).astype(jd))
    seeds = jnp.asarray([[SEEDS[0], SEEDS[1], 0, 0, half]], jnp.uint32)
    want, want_amax = jf._ffn_fwd_pallas2(
        *jargs, seeds, jnp.asarray(SCALES), 0.1, 0.1, 1e-6, 1, 1, DFF, fmt,
        None, (), True, block_rows=16)
    targs = (torch.from_numpy(x["h"]).to(td),
             torch.from_numpy(x["ln_scale"]), torch.from_numpy(x["ln_bias"]),
             torch.from_numpy(w1.T.copy()).to(td),
             torch.from_numpy(b1.copy()).to(td),
             torch.from_numpy(w2.T.copy()).to(td),
             torch.from_numpy(x["b2"]).to(td))
    got, amax = tf.ffn_fwd_generalized(
        *targs, (*SEEDS, 0, 0, half), torch.from_numpy(SCALES), 0.1, 0.1,
        1e-6, 1, 1, DFF, fmt, partial=True)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    want = np.asarray(want)
    tol = 1e-5 if dtype == "float32" else 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    want_amax = np.asarray(want_amax)
    if dtype == "float32":
        np.testing.assert_allclose(amax.numpy(), want_amax, rtol=2 ** -23,
                                   atol=0)
    else:
        np.testing.assert_array_equal(amax.numpy(), want_amax)


def test_head_sharded_plain_flash_matches_jax_flash_attention_sharded():
    """The plain flash forward on heads [H/2, H) at h0 = H/2, h_glob = H,
    dropout 0.1, against JAX ``flash_attention_sharded`` on a tp=2 mesh
    (each device its heads at the global (b, h) stream); so is
    ``flash_attention_qkv`` (the model's route) on the rank's head shard
    of the fused [B, L, 3, H/2, D] buffer."""
    from faster_distributed_training_tpu.parallel.kernel_shard import (
        flash_attention_sharded as j_sharded)
    from faster_distributed_training_tpu_torch.ops.flash_attention import (
        flash_attention_qkv, flash_attention_reference)

    rng = np.random.default_rng(5)
    B = 2
    q, k, v = (rng.normal(size=(B, H, L, 8)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((B, L), np.int32)
    mask[1, 11:] = 0
    want = np.asarray(j_sharded(
        *(jnp.asarray(t) for t in (q, k, v)), jnp.asarray(mask), _tp_mesh(),
        dropout_rate=0.1, dropout_seed=jnp.uint32(SEEDS[0])))
    for h0 in (0, H // 2):
        s = slice(h0, h0 + H // 2)
        got = flash_attention_reference(
            *(torch.from_numpy(t[:, s].copy()) for t in (q, k, v)),
            torch.from_numpy(mask), 0.1, SEEDS[0], h0=h0, h_glob=H)
        np.testing.assert_allclose(got.numpy(), want[:, s], rtol=0,
                                   atol=1e-5)
        qkv = np.stack([q, k, v], axis=2).transpose(0, 3, 2, 1, 4)
        got = flash_attention_qkv(
            torch.from_numpy(qkv[:, :, :, s].copy()), torch.from_numpy(mask),
            0.1, SEEDS[0], b0=0, h0=h0, h_glob=H)
        np.testing.assert_allclose(got.numpy(), want[:, s], rtol=0,
                                   atol=1e-5)


def test_dropout_masks_at_head_and_column_origins_are_the_global_slices():
    """The dense path's keep factors at (h0, h_glob) and the flax FFN's
    hidden dropout on the columns [c0, c0 + d_ff/2) of d_ff: bitwise the
    JAX global arrays' slices."""
    from faster_distributed_training_tpu.ops import attention as jattn
    from faster_distributed_training_tpu.ops import dropout as jdrop
    from faster_distributed_training_tpu_torch.ops.attention import (
        bh_index, dropout_keep)
    from faster_distributed_training_tpu_torch.ops.dropout import (
        hash_dropout, keep_factor_rows)

    B, b0, rate = 3, 2, 0.1
    qi = np.arange(L)[None, None, :, None]
    ki = np.arange(L)[None, None, None, :]
    # the global batch starts b0 rows before this rank's
    glob = np.asarray(jattn.dropout_keep(
        jnp.uint32(SEEDS[0]), jattn.bh_index(b0 + B, H), jnp.asarray(qi),
        jnp.asarray(ki), rate))[b0:]
    for h0 in (0, H // 2):
        got = dropout_keep(SEEDS[0], bh_index(B, H // 2, b0=b0, h0=h0,
                                              h_glob=H),
                           torch.from_numpy(qi), torch.from_numpy(ki), rate)
        np.testing.assert_array_equal(got.numpy(),
                                      glob[:, h0:h0 + H // 2])
    ones = jnp.ones(((b0 + B), L, DFF), jnp.float32)
    want = np.asarray(jdrop.hash_dropout(ones, jnp.uint32(SEEDS[1]),
                                         rate))[b0:]
    grows = np.arange(b0 * L, (b0 + B) * L, dtype=np.uint32)
    for c0 in (0, DFF // 2):
        cols = slice(c0, c0 + DFF // 2)
        got = hash_dropout(torch.ones(B, L, DFF // 2), SEEDS[1], rate,
                           offset=b0 * L * DFF, col0=c0, cols_glob=DFF)
        np.testing.assert_array_equal(got.numpy(), want[..., cols])
        rows = keep_factor_rows(SEEDS[1], torch.from_numpy(
            grows.astype(np.int64)), DFF // 2, rate, c0, DFF)
        jrows = np.asarray(jf._keep_rows(jnp.uint32(SEEDS[1]),
                                         jnp.asarray(grows), DFF // 2, rate,
                                         c0, DFF))
        np.testing.assert_array_equal(rows.numpy(), jrows)
        np.testing.assert_array_equal(rows.numpy().reshape(B, L, -1),
                                      want[..., cols])


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quant_dense_sharded_matches_jax_per_shard(fmt):
    """Column-parallel (qkv on the head axis, Dense_0 on d_ff) and
    row-parallel (out, Dense_1) sites: each rank's ``QuantDense`` on its
    shard (``tp_dim``, eval, zero bias) against JAX ``kernel_shard.
    quant_dense_sharded`` on a tp=2 mesh at the layer's scales; int8
    column shards bitwise (E4M3 to 1e-6 of max |ref|), the row SUM
    1e-6."""
    from faster_distributed_training_tpu.parallel.kernel_shard import (
        quant_dense_sharded as j_qds)
    from faster_distributed_training_tpu_torch.ops.quant import QuantDense

    rng = np.random.default_rng(9)
    M = 40
    mesh = _tp_mesh()

    def site(w, r, tp_dim):
        """Rank r's QuantDense holding shard ``w`` [out, in] (the
        histories give the scales the JAX call takes)."""
        layer = QuantDense(w.shape[1], w.shape[0], fmt=fmt,
                           tp=_shard_rank(r), tp_dim=tp_dim)
        with torch.no_grad():
            layer.weight.copy_(w)
            layer.bias.zero_()
            layer.amax_history_x.fill_(4.0)
            layer.amax_history_w.fill_(0.5)
        return layer

    sx, sw = (float(t) for t in site(torch.zeros(2, 2), 0, 1).scales())
    x = rng.normal(size=(M, D)).astype(np.float32)
    for feats, tp_dim, cut in (((3, H, D // H), 2, "heads"), ((DFF,), 1,
                                                             "rows")):
        kernel = (rng.normal(size=(D,) + feats) * 0.1).astype(np.float32)
        want = np.asarray(j_qds(jnp.asarray(x), jnp.asarray(kernel),
                                sx, sw, fmt, mesh, tp_dim))
        w = torch.from_numpy(kernel.reshape(D, -1).T.copy())
        for r in range(2):
            with torch.no_grad():
                got = site(tsh.tp_shard(w, cut, r, 2, H), r, tp_dim)(
                    torch.from_numpy(x))
            want_r = tsh.tp_shard(torch.from_numpy(want).T, cut, r, 2,
                                  H).T.numpy()
            if fmt == "int8":
                np.testing.assert_array_equal(got.numpy(), want_r)
            else:
                np.testing.assert_allclose(
                    got.numpy(), want_r, rtol=0,
                    atol=1e-6 * np.abs(want_r).max())
    for n_in in (D, DFF):
        xin = rng.normal(size=(M, n_in)).astype(np.float32)
        kernel = (rng.normal(size=(n_in, D)) * 0.1).astype(np.float32)
        want = np.asarray(j_qds(jnp.asarray(xin), jnp.asarray(kernel), sx,
                                sw, fmt, mesh, 0))
        w = torch.from_numpy(kernel.T.copy())
        half = n_in // 2
        with torch.no_grad():
            # the identity stands in for the SUM over tp: summed here
            got = sum(site(tsh.tp_shard(w, "cols", r, 2), r, 0)(
                torch.from_numpy(xin[:, r * half:(r + 1) * half].copy()))
                for r in range(2))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("fmt", [None, "int8"])
def test_fused_tp_tiles_sum_to_the_whole_sublayer_with_grads(fmt):
    """The two ranks' fused tp sublayers (``kernel_shard.
    fused_ffn_sublayer_tp``, collectives summed by hand) against the whole
    fused sublayer: outputs 1e-6, gradients 1e-5 of max |grad| (the
    replicated inputs' summed over the ranks, w1 / b1 / w2 the shards)."""
    from faster_distributed_training_tpu_torch.parallel.kernel_shard import (
        fused_ffn_sublayer_tp)

    x = _ffn_inputs(4, rows=2 * L)
    B, rate = 2, 0.1
    whole = [torch.from_numpy(x[k].T.copy() if k in ("w1", "w2") else x[k])
             for k in ("h", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2")]
    whole[0] = whole[0].reshape(B, L, D)
    scales = tuple(float(s) for s in SCALES) if fmt else None
    kw = dict(quant_fmt=fmt, quant_scales=scales)

    def run(args, r=None):
        args = [a.clone().requires_grad_(True) for a in args]
        if r is None:
            out = tf.ffn_core_generalized(
                *args, *SEEDS, 2, 0, 0, rate, rate, 1e-6, L, L,
                quant_fmt=fmt, quant_scales=scales)[0]
        else:
            out = fused_ffn_sublayer_tp(*args, *SEEDS, _shard_rank(r), rate,
                                        rate, 1e-6, 2, **kw)
            out = out[0] if fmt else out
        return out, args

    want, wargs = run(whole)
    g = torch.from_numpy(np.random.default_rng(1).normal(
        size=want.shape).astype(np.float32))
    want.backward(g)
    half = DFF // 2
    parts, grads = [], []
    for r in range(2):
        cut = [whole[0], whole[1], whole[2], whole[3][r * half:(r + 1) * half],
               whole[4][r * half:(r + 1) * half],
               whole[5][:, r * half:(r + 1) * half], whole[6]]
        parts.append(tf.ffn_fwd_generalized(
            cut[0].reshape(-1, D), *cut[1:], (*SEEDS, 2, 0, r * half),
            torch.from_numpy(SCALES), rate, 0.0, 1e-6, L, L, DFF, fmt,
            partial=True)[0])
        # with the identity for collectives a rank's backward is its
        # tile's share (copy_in sums the shares over the ranks)
        out, args = run(cut, r)
        out.backward(g)
        grads.append([a.grad for a in args])
    from faster_distributed_training_tpu_torch.ops.dropout import (
        keep_factor_rows)
    keep = keep_factor_rows(SEEDS[1], torch.arange(2 * L, 4 * L), D, rate)
    got = whole[0].reshape(-1, D) + (parts[0] + parts[1] + whole[6]) * keep
    np.testing.assert_allclose(got.reshape(want.shape).detach().numpy(),
                               want.detach().numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(grads[0][6].numpy(), grads[1][6].numpy())
    np.testing.assert_allclose(grads[0][6].numpy(), wargs[6].grad.numpy(),
                               rtol=0, atol=1e-6)
    for i, name in enumerate(("h", "ln_scale", "ln_bias")):
        # the tile's share of each replicated input's cotangent, summed
        # over the ranks (copy_in's backward), plus h's residual once
        got = grads[0][i] + grads[1][i] - (g if name == "h" else 0)
        ref = wargs[i].grad
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-5 * ref.abs().max().item(),
                                   err_msg=name)
    for i, sl in ((3, lambda t, r: t[r * half:(r + 1) * half]),
                  (4, lambda t, r: t[r * half:(r + 1) * half]),
                  (5, lambda t, r: t[:, r * half:(r + 1) * half])):
        for r in range(2):
            ref = sl(wargs[i].grad, r)
            np.testing.assert_allclose(grads[r][i].numpy(), ref.numpy(),
                                       rtol=0,
                                       atol=1e-5 * ref.abs().max().item())


def test_build_model_shards_and_raises_on_a_vocab_tp_does_not_divide():
    """A rank's model holds its shards; a vocabulary tp does not divide
    no longer raises: each rank holds ceil(V/tp) rows of the token table
    (the last shard's tail padding), the init and ``tp_unshard`` give
    back the one-card table, and the two ranks' masked lookups sum to
    the whole lookup, their gradients each rank's own rows."""
    cfg = TrainConfig(model="transformer", dataset="synthetic",
                      num_classes=4, seq_len=L, n_layers=1, d_model=D,
                      d_ff=DFF, n_heads=H, precision="fp32", device="cpu")
    m = cli.build_model(cfg, vocab_size=100, device="cpu",
                        tp=_shard_rank(1))
    assert m.embeddings.token_embedding.shape == (50, D)
    assert m.layers[0].attn.qkv.weight.shape == (3 * D // 2, D)
    assert m.layers[0].ffn.Dense_1.weight.shape == (D, DFF // 2)
    one = cli.build_model(cfg, vocab_size=101, device="cpu").init_weights(
        torch.Generator().manual_seed(0)).embeddings.token_embedding
    ranks = [cli.build_model(cfg, vocab_size=101, device="cpu",
                             tp=_shard_rank(r)).init_weights(
        torch.Generator().manual_seed(0)).embeddings for r in range(2)]
    parts = [e.token_embedding.detach() for e in ranks]
    assert [tuple(p.shape) for p in parts] == [(51, D), (51, D)]
    assert torch.equal(parts[1][-1], torch.zeros(D))
    assert torch.equal(tsh.tp_unshard(parts, "rows", size=101), one)
    tokens = torch.tensor([[0, 50, 51, 100, 7, 99]])
    looked = [e._tokens(tokens) for e in ranks]
    assert torch.equal(looked[0] + looked[1], one[tokens].float())
    (looked[0].sum() + looked[1].sum()).backward()
    grads = torch.cat([e.token_embedding.grad for e in ranks])[:101]
    want = torch.zeros(101, D)
    want[tokens[0]] = 1.0
    assert torch.equal(grads, want)
    assert torch.equal(ranks[1].token_embedding.grad[-1], torch.zeros(D))


@pytest.mark.parametrize("flags,name", [
    (["--task", "lm"], "--task lm under --mesh tp=2"),
    (["--model", "resnet18"], "--model resnet18 under --mesh tp=2"),
    (["--steps_per_dispatch", "2"], "--steps_per_dispatch 2 under"),
    (["--data_path", "resident"], "--data_path resident under"),
    (["--ngd"], "--ngd under --mesh tp=2"),
    (["--remat"], "--remat under --mesh tp=2"),
    (["--zero1"], "--zero1 under --mesh tp=2"),
    (["--host_offload"], "--host_offload under --mesh tp=2"),
    (["--offload_opt_state"], "--offload_opt_state under --mesh tp=2"),
    (["--n_heads", "3", "--d_model", "33"],
     "--n_heads 3 not divisible by --mesh tp=2"),
    (["--d_ff", "65"], "--d_ff 65 not divisible by --mesh tp=2"),
    (["--mesh", "fsdp=1,tp=2", "--fsdp"], "--fsdp under --mesh tp=2"),
])
def test_unported_tp_combinations_raise_by_name(tmp_path, flags, name):
    """What tp does not reach raises NotImplementedError naming the flag
    or the shape, before any process group is joined."""
    argv = ["--dataset", "synthetic", "--device", "cpu", "--no_plot",
            "--mesh", "tp=2", "--n_layers", "1", "--d_model", "32",
            "--n_heads", "4", "--d_ff", "64", "--seq_len", "16",
            "--checkpoint_dir", str(tmp_path)]
    cfg = cli.config_from_args(cli.build_parser(
        defaults=cli.TRANSFORMER_DEFAULTS).parse_args(argv + flags),
        defaults=cli.TRANSFORMER_DEFAULTS)
    assert any(name in f for f in cli.unported_training_flags(cfg))
    with pytest.raises(NotImplementedError, match=name):
        cli.main(argv + flags, defaults=cli.TRANSFORMER_DEFAULTS)


def test_serving_under_a_tp_mesh_raises():
    cfg = TrainConfig(model="transformer", num_classes=4, seq_len=L,
                      n_layers=1, d_model=D, d_ff=DFF, n_heads=H,
                      device="cpu", mesh_axes=("tp",), mesh_shape=(2,))
    with pytest.raises(NotImplementedError, match="serving under --mesh"):
        cli.build_model(cfg, vocab_size=100, serving=True, device="cpu")
