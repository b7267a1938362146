"""Whole-model parity of the PyTorch port's Transformer with the flax one.

The flax ``Transformer(attention_impl="flash", mlp_impl="pallas")`` runs
its Pallas kernels in interpret mode (``FDT_FORCE_PALLAS_INTERPRET=1``);
its parameters go through ``interop.params_from_jax`` into the port,
whose flash and fused-MLP wrappers run their plain versions on the CPU.
Same token ids, same padding mask; logits held to fp32 1e-4 and bf16
5e-2 (bf16 rounds at other places in the two frameworks' GEMMs and
GELU).  Small size: 2 layers, d_model 64, 4 heads, d_ff 128, vocab 100.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_distributed_training_tpu.models.transformer import (
    Transformer as FlaxTransformer)
from faster_distributed_training_tpu_torch.interop import (
    flatten, params_from_jax, params_to_jax)
from faster_distributed_training_tpu_torch.models import get_model
from faster_distributed_training_tpu_torch.models.transformer import (
    Transformer, sinusoidal_table)

SMALL = dict(vocab=100, n_layers=2, h=4, d_model=64, d_ff=128, d_hidden=96,
             maxlen=64)
N_CLASS = 4


def _inputs(B=3, L=40, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, SMALL["vocab"], size=(B, L)).astype(np.int32)
    lengths = np.array([L, 17, 5][:B])
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
    return tokens, mask


@pytest.fixture(scope="module")
def flax_params():
    model = FlaxTransformer(n_class=N_CLASS, **SMALL)
    tokens, mask = _inputs()
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens),
                           mask=jnp.asarray(mask), train=False)
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def _flax_logits(params, impl, dtype, tokens, mask, monkeypatch):
    monkeypatch.setenv("FDT_FORCE_PALLAS_INTERPRET", "1")
    model = FlaxTransformer(
        n_class=N_CLASS, attention_impl=impl,
        mlp_impl="pallas" if impl == "flash" else "fused",
        dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32, **SMALL)
    return np.asarray(model.apply({"params": params}, jnp.asarray(tokens),
                                  mask=jnp.asarray(mask), train=False))


@pytest.mark.parametrize("impl,dtype,tol", [("flash", "float32", 1e-4),
                                            ("flash", "bfloat16", 5e-2),
                                            ("dense", "float32", 1e-4)])
def test_logits_match_flax(flax_params, impl, dtype, tol, monkeypatch):
    tokens, mask = _inputs()
    want = _flax_logits(flax_params, impl, dtype, tokens, mask, monkeypatch)
    tdt = getattr(torch, dtype)
    # bf16 runs the serving twin: GEMM weights stored in bf16 (rounded
    # once at load, as flax rounds its fp32 weights at every call)
    model = Transformer(n_class=N_CLASS, dtype=tdt, param_dtype=tdt,
                        attention_impl=impl, **SMALL)
    model.load_state_dict(params_from_jax(flax_params))
    with torch.inference_mode():
        got = model(torch.from_numpy(tokens).long(),
                    mask=torch.from_numpy(mask)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, N_CLASS)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_interop_round_trip(flax_params):
    sd = params_from_jax({"params": {"model": flax_params}})
    back = flatten(params_to_jax(sd, SMALL["h"]))
    want = flatten(flax_params)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    model = Transformer(n_class=N_CLASS, **SMALL)
    assert sorted(sd) == sorted(model.state_dict())


def test_init_weights_is_seeded_and_follows_jax_init():
    a = Transformer(n_class=N_CLASS, **SMALL).init_weights(
        torch.Generator().manual_seed(3))
    b = Transformer(n_class=N_CLASS, **SMALL).init_weights(
        torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    sd = a.state_dict()
    d = SMALL["d_model"]
    assert sd["layers.0.attn.qkv.weight"].abs().max() <= (3.0 / d) ** 0.5
    assert torch.equal(sd["layers.1.ln_ffn.scale"], torch.ones(d))
    assert not sd["cls_b1"].any() and not sd["pooler.bias"].any()
    bound = (6.0 / (SMALL["vocab"] + d)) ** 0.5
    tok = sd["embeddings.token_embedding"]
    assert tok.abs().max() <= bound and tok.abs().max() > bound / 2


def test_positional_table_matches_jax():
    from faster_distributed_training_tpu.models.transformer import (
        sinusoidal_table as jax_table)
    np.testing.assert_array_equal(sinusoidal_table(64, 32), jax_table(64, 32))


def test_train_forward_raises_until_training_slice():
    """The training forward takes its randomness explicitly: without
    draws it raises; with them it returns (logits, index, lam), its
    dropout follows the seeds, and the gradients reach every parameter.
    An unknown model still raises."""
    from faster_distributed_training_tpu_torch.train.steps import step_draws

    model = get_model("transformer", N_CLASS, **SMALL).init_weights(
        torch.Generator().manual_seed(0))
    tokens, mask = _inputs()
    x, m = torch.from_numpy(tokens).long(), torch.from_numpy(mask)
    with pytest.raises(ValueError, match="draws"):
        model(x, mask=m, train=True)
    draws = step_draws(0, 0, 3, model.n_dropout_sites(), 0.99)
    logits, index, lam = model(x, mask=m, train=True, draws=draws)
    assert logits.shape == (3, N_CLASS) and torch.isfinite(logits).all()
    assert sorted(index.tolist()) == [0, 1, 2]
    assert float(lam) == pytest.approx(draws.lam)
    again = model(x, mask=m, train=True, draws=draws)[0]
    assert torch.equal(logits, again)                  # seeds fix the masks
    other = model(x, mask=m, train=True,
                  draws=step_draws(0, 1, 3, model.n_dropout_sites(),
                                   0.99))[0]
    assert not torch.equal(logits, other)
    grads = torch.autograd.grad(logits.sum(), list(model.parameters()),
                                allow_unused=True)
    names = [n for n, _ in model.named_parameters()]
    missing = [n for n, g in zip(names, grads) if g is None]
    assert missing == ["embeddings.segment_embedding"] or not missing
    with pytest.raises(ValueError):
        get_model("vgg16", 10)
