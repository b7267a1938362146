"""The port's pipeline parallelism (``--mesh pp=P``) against the JAX
package, in one process.

  * the pure functions of ``parallel/pipeline.py`` (``partition_stages``,
    ``virtual_chunks``, ``bubble_fraction``, ``schedule_ticks``,
    ``stage_idle_ticks``, ``resolve_microbatches`` with its ValueErrors,
    ``build_pipeline_spec`` with its refusals, ``pipeline_rules``) equal to
    JAX's on the cases of ``tests/test_pipeline.py``;
  * ``param_stage_home`` on every leaf of the port's tree (parameters
    and amax histories, through ``sharding.jax_param_path``) against
    JAX's on the flax tree, and the port's ``pp_stage_homes`` against
    JAX's ``classify_pp_param_leaf``: a leaf JAX keeps replicated over pp
    as shared is replicated in the port, every other lives on its stage;
  * the amax cadence (``PipelineTickCtx.amax_pre`` / ``amax_push``)
    against JAX's ``PipelineTickCtx`` on a recorded sequence of
    microbatch amaxes, bitwise, and its end state the full batch's roll;
  * the staged pieces' chunk on each microbatch (hash dropout, a data
    origin) bitwise the unstaged layers' rows: each microbatch's seed
    stream starts at its global rows;
  * the plain versions of rows 1, 4, 7 and 8 on M = 4 microbatches at
    their batch origins ``b0``: each bitwise the full call's rows (the
    flash forward, its saved-stats backward's gradients, the fused FFN,
    the generalized FFN in none / int8 / E4M3 with the microbatches'
    amax MAX the full call's);
  * the pp layout (outermost) and every flag of ``cli.pp_unported``
    raising ``NotImplementedError`` by name; a ResNet under pp raising
    JAX's ValueError.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from faster_distributed_training_tpu import cli as jcli
from faster_distributed_training_tpu.config import TrainConfig as JConfig
from faster_distributed_training_tpu.ops import quant as jquant
from faster_distributed_training_tpu.parallel import make_mesh as j_mesh
from faster_distributed_training_tpu.parallel import pipeline as jp
from faster_distributed_training_tpu.parallel import sharding as js
from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch.config import TrainConfig
from faster_distributed_training_tpu_torch.interop import flatten
from faster_distributed_training_tpu_torch.ops import fused_ffn as tf
from faster_distributed_training_tpu_torch.ops.flash_attention import (
    flash_attention_qkv)
from faster_distributed_training_tpu_torch.parallel import pipeline as tp
from faster_distributed_training_tpu_torch.parallel import sharding as ts
from faster_distributed_training_tpu_torch.parallel.mesh import (
    ordered_axes, parse_mesh)
from faster_distributed_training_tpu_torch.train.steps import (
    _stage_pieces, step_draws)

M = 4


def _spec_pair(n_layers, n_stages, m, schedule="1f1b"):
    j = jp.PipelineSpec(n_layers=n_layers, n_stages=n_stages,
                        n_microbatches=m,
                        stage_layers=jp.partition_stages(n_layers, n_stages,
                                                         schedule),
                        schedule=schedule)
    t = tp.PipelineSpec(n_layers=n_layers, n_stages=n_stages,
                        n_microbatches=m,
                        stage_layers=tp.partition_stages(n_layers, n_stages,
                                                         schedule),
                        schedule=schedule)
    return j, t


@pytest.mark.parametrize("layers,stages", [(6, 2), (7, 3), (4, 1), (8, 2),
                                           (9, 4), (3, 2), (6, 3), (4, 4)])
@pytest.mark.parametrize("schedule", ["1f1b", "interleaved"])
def test_schedule_functions_match_jax(layers, stages, schedule):
    """partition_stages, virtual_chunks, the spec's counts, the bubble,
    stage_idle_ticks, schedule_ticks and the rule table, equal to JAX's."""
    assert tp.partition_stages(layers, stages, schedule) == \
        jp.partition_stages(layers, stages, schedule)
    for m in (1, 2, 4, 8):
        j, t = _spec_pair(layers, stages, m, schedule)
        assert tp.virtual_chunks(t) == jp.virtual_chunks(j)
        assert (t.n_virtual, t.n_ticks, t.bubble_pct) == (
            j.n_virtual, j.n_ticks, j.bubble_pct)
        assert tp.stage_idle_ticks(t) == jp.stage_idle_ticks(j)
        assert tp.schedule_ticks(stages, m) == jp.schedule_ticks(stages, m)
        assert tp.bubble_fraction(t.n_virtual, m) == jp.bubble_fraction(
            j.n_virtual, m)
        for cfg in (None, JConfig(pp_residency=False)):
            want = jp.pipeline_rules(j, cfg)
            got = tp.pipeline_rules(t, cfg)
            # the placement and residency strings name each package's
            # mechanism; the keys, counts and stage homes are JAX's
            for key in ("activation_placement", "boundary_collective"):
                want.pop(key)
                got.pop(key)
            wres, gres = want.pop("param_residency"), got.pop(
                "param_residency")
            assert got == want
            for key in ("enabled", "axis", "stage_home"):
                assert gres[key] == wres[key], key
            assert set(gres["sharded"]) == set(wres["sharded"])
            assert set(gres["replicated"]) <= set(wres["replicated"])
    assert tp.pipeline_rules(None) == jp.pipeline_rules(None)


def test_partition_and_microbatch_errors_match_jax():
    for args in ((2, 3), (4, 2, "gpipe"), (4, 0)):
        for mod in (jp, tp):
            with pytest.raises(ValueError) as e:
                mod.partition_stages(*args)
        with pytest.raises(ValueError, match=str(e.value)[:12]):
            jp.partition_stages(*args)
    for batch, stages, req in ((16, 2, 8), (16, 2, 0), (16, 4, 0),
                               (12, 2, 0), (7, 2, 0), (1, 4, 0), (8, 8, 0),
                               (30, 4, 0), (16, 2, 16)):
        assert tp.resolve_microbatches(batch, stages, req) == \
            jp.resolve_microbatches(batch, stages, req)
    for batch, stages, req, msg in ((16, 2, 3, "does not divide"),
                                    (8, 2, -2, "must be in"),
                                    (8, 2, 16, "must be in")):
        with pytest.raises(ValueError, match=msg):
            jp.resolve_microbatches(batch, stages, req)
        with pytest.raises(ValueError, match=msg):
            tp.resolve_microbatches(batch, stages, req)


def test_build_pipeline_spec_matches_jax():
    """The spec of each config on a (dp, pp) mesh equals JAX's on its
    mesh; None without pp; JAX's refusals (a ResNet; --quant with
    --remat) raise the same ValueErrors."""
    base = dict(model="transformer", dataset="synthetic", num_classes=4,
                batch_size=8, seq_len=16, n_layers=4, d_model=16, d_ff=32,
                n_heads=2)
    for axes, shape in ((("dp", "pp"), (2, 2)), (("pp",), (2,)),
                        (("pp",), (4,)), (("dp",), (2,))):
        jmesh = j_mesh(axes, shape, jax.devices()[:int(np.prod(shape))])
        for over in ({}, {"pp_schedule": "interleaved"},
                     {"pp_microbatches": 8}, {"pp_microbatches": 2},
                     {"quant": "int8"}, {"batch_size": 12}):
            want = jp.build_pipeline_spec(JConfig(**{**base, **over}),
                                          jmesh, attention_impl="dense")
            got = tp.build_pipeline_spec(TrainConfig(**{**base, **over}),
                                         (axes, shape))
            if want is None:
                assert got is None
                continue
            assert (got.n_layers, got.n_stages, got.n_microbatches,
                    got.stage_layers, got.schedule) == (
                want.n_layers, want.n_stages, want.n_microbatches,
                want.stage_layers, want.schedule)
    jmesh = j_mesh(("dp", "pp"), (2, 2), jax.devices()[:4])
    for over, msg in (({"model": "resnet18"}, "no staged form"),
                      ({"quant": "int8", "remat": True}, "remat")):
        with pytest.raises(ValueError, match=msg):
            jp.build_pipeline_spec(JConfig(**{**base, **over}), jmesh)
        with pytest.raises(ValueError, match=msg):
            tp.build_pipeline_spec(TrainConfig(**{**base, **over}),
                                   (("dp", "pp"), (2, 2)))


def _flax_leaves(kw):
    m = jcli.build_model(JConfig(**kw), vocab_size=100)
    v = jax.jit(lambda r, x: m.init(r, x, train=True))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "mixup": jax.random.PRNGKey(2)}, jnp.zeros((4, 16), jnp.int32))
    out = flatten(jax.tree_util.tree_map(np.asarray, v["params"]))
    out.update(flatten(jax.tree_util.tree_map(
        np.asarray, v.get("batch_stats", {}))))
    return out


@pytest.mark.parametrize("flags", [
    dict(quant="int8", ffn_impl="pallas"), dict(task="lm"),
    dict(task="lm", tie_lm_head=False)],
    ids=["cls_quant_fused", "lm_tied", "lm_untied"])
@pytest.mark.parametrize("schedule", ["1f1b", "interleaved"])
def test_stage_homes_of_every_leaf_match_jax(flags, schedule):
    """param_stage_home on every leaf of the port's tree (its JAX paths)
    equals JAX's on the flax tree; the port's pp_stage_homes places each
    on JAX's stage (None: shared), and replicates exactly the leaves
    that JAX's classify_pp_param_leaf calls shared."""
    kw = dict(model="transformer", dataset="synthetic", num_classes=4,
              batch_size=8, seq_len=16, n_layers=4, d_model=32, d_ff=64,
              n_heads=4, precision="fp32", **flags)
    flax = _flax_leaves(kw)
    port = cli.build_model(TrainConfig(**kw), vocab_size=100, device="cpu")
    sd = port.state_dict()
    assert sorted(ts.jax_param_path(k) for k in sd) == sorted(flax)
    j, t = _spec_pair(4, 2, M, schedule)
    homes = ts.pp_stage_homes(list(sd), t)
    for k in sd:
        path = ts.jax_param_path(k)
        role, stage = jp.param_stage_home(j, path)
        assert tp.param_stage_home(t, path) == (role, stage), k
        assert role != "unknown", k
        assert homes[k] == (stage if role == "stage_owned" else None), k
        for n in (2, 4):
            cls_, _ = js.classify_pp_param_leaf(role, flax[path].shape,
                                                P(), n)
            assert (homes[k] is None) == (
                cls_ in ts.REPLICATED_PP_PARAMS), (k, cls_)
    assert set(ts.PP_RESIDENCY_RULES) == set(js.PP_RESIDENCY_RULES)
    assert set(ts.REPLICATED_PP_PARAMS) <= set(js.REPLICATED_PP_PARAMS)
    with pytest.raises(ValueError, match="no rule places"):
        ts.pp_stage_homes(["mystery.weight"], t)


def test_amax_cadence_matches_jax_tick_ctx_bitwise():
    """A site's history over two steps of M microbatches through the
    port's cadence against JAX's ``PipelineTickCtx``: bitwise; the
    pre-step scale every push; the end state the full batch's roll (max
    of the microbatch amaxes)."""
    rng = np.random.default_rng(5)
    hist = np.abs(rng.normal(size=16)).astype(np.float32)
    jh, th = jnp.asarray(hist), torch.from_numpy(hist.copy())
    for step in range(2):
        amaxes = np.abs(rng.normal(size=M) * 3).astype(np.float32)
        jctx, tctx = jp.PipelineTickCtx(M, 2), tp.PipelineTickCtx()
        pre_j = jctx.amax_pre("s", jh)
        for m, a in enumerate(amaxes):
            jctx.microbatch = m
            np.testing.assert_array_equal(
                tctx.amax_pre("s", th).numpy(), np.asarray(pre_j))
            jh = jctx.amax_push("s", jh, jnp.float32(a))
            tctx.amax_push("s", th, torch.tensor(a))
            np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        full = jquant.update_amax_history(pre_j, jnp.float32(amaxes.max()))
        np.testing.assert_array_equal(th.numpy(), np.asarray(full))


def test_stage_pieces_run_each_microbatch_at_its_global_rows():
    """The staged pieces (``steps._stage_pieces``, M = 4) at a data origin
    b0 = 8 with hash dropout 0.1 on every site: chunk 0 then chunk 1 on
    microbatch m is bitwise the unstaged layers' rows m·B/M of the same
    batch, so each microbatch's seed stream starts at its global rows."""
    cfg = TrainConfig(model="transformer", dataset="synthetic",
                      num_classes=4, batch_size=8, seq_len=16, n_layers=2,
                      d_model=32, d_ff=64, n_heads=4, precision="fp32",
                      attention="dense", dropout_impl="hash")
    model = cli.build_model(cfg, vocab_size=100, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    spec = tp.build_pipeline_spec(cfg, 2)
    rng = np.random.default_rng(2)
    mask = (np.arange(16)[None] < rng.integers(4, 17, (8, 1))).astype(
        np.int32)
    batch = {"tokens": torch.from_numpy(rng.integers(1, 100, (8, 16))
                                        .astype(np.int32) * mask),
             "mask": torch.from_numpy(mask)}
    draws = dataclasses.replace(step_draws(0, 0, 16, model.n_dropout_sites(),
                                           0.99), b0=8)
    rows = 8 // M
    embed, chunk = _stage_pieces(model, spec, batch, True, draws, rows)
    with torch.no_grad():
        h = embed()
        full = model.run_layers(
            h, model.attention_mask(batch["mask"]), True,
            model.seed_stream(draws, 16, model.seed_positions()["layers"][0]))
        for m, x in enumerate(h.split(rows)):
            out = chunk(1, chunk(0, x, m), m)
            assert torch.equal(out, full[m * rows:(m + 1) * rows]), m


RATE, SEED = 0.1, 0x2545F491
B, L, H, D = 8, 16, 2, 16


def _microbatches(t):
    return list(t.split(B // M))


def test_plain_flash_rows_1_4_on_microbatches_are_the_full_rows():
    """Rows 1 (the training forward with dropout 0.1) and 4 (its saved-
    stats backward) on M = 4 microbatches at b0 = 2 + m·B/M, each bitwise
    the full call's rows at b0 = 2: the output and the qkv gradient."""
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(B, L, 3, H, D, generator=gen)
    mask = (torch.arange(L)[None] < torch.randint(
        4, L + 1, (B, 1), generator=gen)).int()[:, None, None, :]
    cot = torch.randn(B, H, L, D, generator=gen)

    def run(x, mk, g, b0):
        x = x.clone().requires_grad_()
        out = flash_attention_qkv(x, mk, RATE, SEED, save_stats=True, b0=b0)
        out.backward(g)
        return out.detach(), x.grad
    full, gfull = run(qkv, mask, cot, 2)
    rows = B // M
    for m, (x, mk, g) in enumerate(zip(_microbatches(qkv),
                                       _microbatches(mask),
                                       _microbatches(cot))):
        out, gx = run(x, mk, g, 2 + m * rows)
        assert torch.equal(out, full[m * rows:(m + 1) * rows]), m
        assert torch.equal(gx, gfull[m * rows:(m + 1) * rows]), m


@pytest.mark.parametrize("fmt", [None, "int8", "fp8"])
def test_plain_ffn_rows_7_8_on_microbatches_are_the_full_rows(fmt):
    """Rows 7 (``fused_ffn_sublayer``) and 8 (the generalized core: none,
    int8, E4M3) on M = 4 microbatches at b0 = 1 + m·B/M, dropout 0.1 at
    both sites: each bitwise the full call's rows at b0 = 1, and the
    microbatches' amax MAX the full call's."""
    gen = torch.Generator().manual_seed(1)
    d, d_ff = 32, 64
    h = torch.randn(B, L, d, generator=gen)
    ln_s, ln_b = 1 + 0.1 * torch.randn(d, generator=gen), \
        0.1 * torch.randn(d, generator=gen)
    w1 = torch.randn(d_ff, d, generator=gen) / d ** 0.5
    b1 = 0.1 * torch.randn(d_ff, generator=gen)
    w2 = torch.randn(d, d_ff, generator=gen) / d_ff ** 0.5
    b2 = 0.1 * torch.randn(d, generator=gen)
    rest = (ln_s, ln_b, w1, b1, w2, b2, 0x9E3779B9, 0x2545F491)
    scales = torch.tensor([40.0, 300.0, 25.0, 250.0])
    rows = B // M

    def call(x, b0):
        if fmt is None:
            return tf.fused_ffn_sublayer(x, *rest, RATE, RATE, b0=b0), None
        return tf.ffn_core_generalized(
            x, *rest, b0, 0, 0, RATE, RATE, 1e-6, L, L, dff_glob=d_ff,
            quant_fmt=fmt, quant_scales=tuple(scales.unbind()))
    full, famax = call(h, 1)
    amaxes = []
    for m, x in enumerate(_microbatches(h)):
        out, a = call(x, 1 + m * rows)
        assert torch.equal(out, full[m * rows:(m + 1) * rows]), m
        amaxes.append(a)
    if fmt is not None:
        assert torch.equal(torch.stack(amaxes).amax(0), famax)


def test_pp_is_laid_out_outermost():
    for spec, want in (("dp=2,pp=2", (("pp", "dp"), (2, 2))),
                       ("stage=2,data=4", (("pp", "dp"), (2, 4))),
                       ("pipe=4", (("pp",), (4,)))):
        assert ordered_axes(*parse_mesh(spec)) == want


PP_UNPORTED = [
    (["--mesh", "pp=2,tp=2"], "--mesh tp=2 under --mesh pp=2"),
    (["--mesh", "pp=2,sp=2"], "--mesh sp=2 under --mesh pp=2"),
    (["--mesh", "fsdp=1,pp=2", "--fsdp"], "--fsdp under --mesh pp=2"),
    (["--mesh", "pp=2", "--zero1"], "--zero1 under --mesh pp=2"),
    (["--mesh", "pp=2", "--host_offload"],
     "--host_offload under --mesh pp=2"),
    (["--mesh", "pp=2", "--offload_opt_state"],
     "--offload_opt_state under --mesh pp=2"),
    (["--mesh", "pp=2", "--steps_per_dispatch", "2"],
     "--steps_per_dispatch 2 under --mesh pp=2"),
    (["--mesh", "pp=2", "--data_path", "resident"],
     "--data_path resident under --mesh pp=2"),
    (["--mesh", "pp=2", "--remat"], "--remat under --mesh pp=2"),
]


@pytest.mark.parametrize("flags,name", PP_UNPORTED)
def test_unported_pp_combinations_raise_by_name(tmp_path, flags, name):
    """Each of ``cli.pp_unported``'s flags raises ``NotImplementedError``
    naming itself, before any process group is needed; serving under pp
    raises in ``build_model``."""
    argv = ["--dataset", "synthetic", "--device", "cpu", "--no_plot",
            "--checkpoint_dir", str(tmp_path)]
    defaults = cli.TRANSFORMER_DEFAULTS
    cfg = cli.config_from_args(cli.build_parser(defaults=defaults)
                               .parse_args(argv + flags), defaults=defaults)
    assert any(name in f for f in cli.pp_unported(cfg)), cli.pp_unported(cfg)
    with pytest.raises(NotImplementedError, match=name):
        cli.main(argv + flags, defaults=defaults)
    if name.startswith("--remat"):
        with pytest.raises(NotImplementedError, match="serving under --mesh"):
            cli.build_model(cfg.replace(remat=False), vocab_size=100,
                            serving=True, device="cpu")


def test_resnet_under_pp_raises_jax_value_error(tmp_path):
    argv = ["--dataset", "synthetic", "--device", "cpu", "--no_plot",
            "--model", "resnet18", "--mesh", "pp=2", "--checkpoint_dir",
            str(tmp_path)]
    with pytest.raises(ValueError, match="no staged form"):
        cli.main(argv, defaults=cli.RESNET50_DEFAULTS)
