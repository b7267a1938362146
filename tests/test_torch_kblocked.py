"""Long-context attention: the port's plain flash versions against the
JAX package's k-blocked kernels (TPU kernel table rows 2 and 3).

  * ``flash_attention_reference`` against ``ops/flash_attention.py::
    _flash_fwd_kblocked`` and ``flash_attention_bwd_reference`` against
    ``_flash_bwd_kblocked`` (its ``dq_kernel`` and ``dkv_kernel``), both
    run directly in Pallas interpret mode: ragged L 44 and L 1100 (3 x 3
    tiles of 512), D 64, fp32 and bf16, dropout 0 and 0.3, a key-padding
    bias with no fully masked row.  out and the gradients: fp32 1e-5,
    bf16 2e-2 of max |ref|; lse 1e-5.  The backward takes the JAX
    forward's out and lse, so both compute from the same statistics.
  * The plain versions' q-row chunking (``q_chunk``, how the card phase
    holds the kernels at L 8192 and 16384): out, lse and dq bitwise equal
    to the unchunked ones; dk and dv, sums over the chunks in another
    order, fp32 1e-6 of max |ref|.
  * A fully masked row, where the port deliberately follows the dense
    VJP and not the k-blocked kernel (whose p = exp(s - lse) comes out
    Lk times too large there): the chunked backward with the forward's
    lse tail against ``jax.vjp`` of ``dense_attention_reference``, fp32
    1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_distributed_training_tpu.ops.attention import (
    dense_attention_reference as j_dense_attention_reference)
from faster_distributed_training_tpu.ops.attention import (
    mask_to_bias as j_mask_to_bias)
from faster_distributed_training_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_reference, flash_attention_reference,
    flash_attention_stats_reference)

jfa = importlib.import_module(
    "faster_distributed_training_tpu.ops.flash_attention")

D = 64
SEED = 17


def _inputs(B, H, L, dtype, lengths, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, H, L, D)).astype(np.float32)
                  for _ in range(4))
    if dtype == "bfloat16":
        # round once so both packages see the same bf16 values
        q, k, v, g = (np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in
                      (q, k, v, g))
    mask = (np.arange(L)[None] < np.asarray(lengths)[:, None]
            ).astype(np.int32)
    return q, k, v, g, mask


def _t(x, dtype):
    return torch.from_numpy(np.array(x, np.float32)).to(
        getattr(torch, dtype))


def _rel(got, want):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


CASES = [(44, 2, 2, (44, 31)), (1100, 1, 2, (1063,))]


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("L,B,H,lengths", CASES, ids=["L44", "L1100"])
def test_plain_versions_match_kblocked_kernels(L, B, H, lengths, dtype, tol,
                                               rate, monkeypatch):
    monkeypatch.setenv("FDT_FORCE_PALLAS_INTERPRET", "1")
    q, k, v, g, mask = _inputs(B, H, L, dtype, lengths)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv, jg = (jnp.asarray(x, jdt) for x in (q, k, v, g))
    kb = j_mask_to_bias(jnp.asarray(mask, jnp.float32))
    seed3 = jfa._pack_seed(jnp.uint32(SEED))
    n3 = lambda x: x.reshape(B * H, L, D)  # noqa: E731
    jout, jlse = jfa._flash_fwd_kblocked(n3(jq), n3(jk), n3(jv),
                                         jnp.repeat(kb, H, axis=0), rate,
                                         seed3, n_heads=H)
    jout = jout.reshape(B, H, L, D)
    jgrads = jfa._flash_bwd_kblocked(jq, jk, jv, kb, seed3, rate, jout,
                                     jlse)(jg)

    tq, tk, tv, tg = (_t(x, dtype) for x in (q, k, v, g))
    tmask = torch.from_numpy(mask)
    out, lse = flash_attention_reference(tq, tk, tv, tmask, rate, SEED,
                                         emit_lse=True)
    assert _rel(out, jout) <= tol
    np.testing.assert_allclose(lse.reshape(B * H, L).numpy(),
                               np.asarray(jlse), rtol=0, atol=1e-5)
    # the backward from the JAX forward's statistics (no lse tail: no
    # row here is fully masked, and the k-blocked kernel has none)
    grads = flash_attention_bwd_reference(
        tq, tk, tv, _t(jout, dtype), torch.from_numpy(
            np.asarray(jlse)).reshape(B, H, L), tg, tmask, rate, SEED)
    for name, got, want in zip("qkv", grads, jgrads):
        assert got.dtype == tq.dtype
        assert _rel(got, want) <= tol, f"d{name}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_plain_versions_equal_unchunked(dtype):
    q, k, v, g, mask = _inputs(2, 2, 300, dtype, (300, 211), seed=1)
    tq, tk, tv, tg = (_t(x, dtype) for x in (q, k, v, g))
    tmask = torch.from_numpy(mask)
    whole = flash_attention_stats_reference(tq, tk, tv, tmask, 0.1, SEED)
    for q_chunk in (128, 77):
        parts = flash_attention_stats_reference(tq, tk, tv, tmask, 0.1,
                                                SEED, q_chunk)
        for a, b in zip(whole, parts):
            assert torch.equal(a, b)
        out, lse, lse_lo = whole
        full = flash_attention_bwd_reference(tq, tk, tv, out, lse, tg, tmask,
                                             0.1, SEED, lse_lo)
        chunked = flash_attention_bwd_reference(tq, tk, tv, out, lse, tg,
                                                tmask, 0.1, SEED, lse_lo,
                                                q_chunk=q_chunk)
        assert torch.equal(full[0], chunked[0])
        if dtype == "float32":
            for name, a, b in zip("kv", full[1:], chunked[1:]):
                assert _rel(b, a.numpy()) <= 1e-6, f"d{name}"


def test_fully_masked_row_follows_the_dense_vjp():
    """Batch row 1 masks every key.  The chunked backward with the lse
    tail gives the dense VJP's gradient (the mean of V's cotangent over
    the keys), also at that row."""
    B, H, L = 2, 2, 300
    q, k, v, g, mask = _inputs(B, H, L, "float32", (300, 0), seed=2)
    tq, tk, tv, tg = (_t(x, "float32") for x in (q, k, v, g))
    tmask = torch.from_numpy(mask)
    out, lse, lse_lo = flash_attention_stats_reference(tq, tk, tv, tmask,
                                                       0.0, None, 64)
    got = flash_attention_bwd_reference(tq, tk, tv, out, lse, tg, tmask,
                                        0.0, None, lse_lo, q_chunk=64)
    jmask = jnp.asarray(mask)[:, None, None, :]

    def f(q_, k_, v_):
        return j_dense_attention_reference(q_, k_, v_, jmask)

    want_out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(g))
    assert _rel(out, want_out) <= 1e-5
    for name, a, b in zip("qkv", got, want):
        assert _rel(a, b) <= 1e-5, f"d{name}"
    # the masked row's dv is its share of every key: sum_q g / L
    dv_row = np.asarray(g[1]).sum(axis=1) / L
    assert np.abs(got[2][1].numpy() - dv_row[:, None, :]).max() <= 1e-5
