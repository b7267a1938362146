"""The plain versions the card kernels are held against, pinned to the JAX
kernels at the Hopper kernels' tile edges.

On the card ``flash_fwd_kernel_sm90`` works in 128-row q blocks of two
64-row warpgroups over 64-key tiles, and the classifier's tensor-core
kernel in blocks of 16 rows (128 past 64 rows); ``tests/test_torch_cuda.py``
holds both against ``flash_attention_reference`` /
``flash_attention_stats_reference`` and ``mlp_reference``.  Here the same
numpy inputs (made from a seed) go through those plain versions and
through the JAX package's Pallas kernels in interpret mode, at lengths one
short of and one past those edges:

  * ``flash_attention_reference`` and ``flash_attention_stats_reference``
    against ``_flash_fwd_pallas`` -- L 63, 65, 129 x D 16, 64 x dropout 0,
    0.1, key padding with one batch row fully masked: fp32 out 1e-5, lse
    1e-5; the stats version's lse_lo against (m + log l) - lse, m and l
    in float64 over the fp32 scores (1e-5): log Lk at the fully masked
    row;
  * ``mlp_reference`` against ``_mlp_fwd_pallas`` at 1, 9 and 17 rows:
    fp32 1e-5, bf16 2e-2.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_distributed_training_tpu_torch.ops.flash_attention import (
    flash_attention_reference, flash_attention_stats_reference)
from faster_distributed_training_tpu_torch.ops.fused_mlp import mlp_reference

jattn, jflash, jmlp = (importlib.import_module(
    f"faster_distributed_training_tpu.ops.{m}")
    for m in ("attention", "flash_attention", "fused_mlp"))


def _inputs(B, H, L, D, seed):
    """q/k/v [B, H, L, D] fp32 and a ragged key mask whose last batch row
    is fully masked."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, L, D)).astype(np.float32)
               for _ in range(3))
    lengths = rng.integers(1, L + 1, size=B)
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
    mask[-1] = 0
    return q, k, v, mask


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("L", [63, 65, 129])
def test_flash_plain_matches_pallas_at_tile_edges(L, D, rate):
    B, H = 2, 2
    q, k, v, mask = _inputs(B, H, L, D, seed=L * 7 + D + int(rate * 10))
    seed = 0x2545F491
    n3 = lambda a: jnp.asarray(a).reshape(B * H, L, D)  # noqa: E731
    want_out, want_lse = jflash._flash_fwd_pallas(
        n3(q), n3(k), n3(v), jattn.mask_to_bias(jnp.asarray(mask)), H,
        block_q=64, dropout_rate=rate, seed3=jflash._pack_seed(seed),
        emit_lse=True)
    want_out = np.asarray(want_out).reshape(B, H, L, D)
    want_lse = np.asarray(want_lse).reshape(B, H, L)
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))

    out, lse = flash_attention_reference(tq, tk, tv, tm, rate, seed,
                                         emit_lse=True)
    np.testing.assert_allclose(out.numpy(), want_out, atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=0)

    s_out, s_lse, s_lo = flash_attention_stats_reference(
        tq, tk, tv, tm, rate, seed)
    np.testing.assert_allclose(s_out.numpy(), want_out, atol=1e-5, rtol=0)
    np.testing.assert_allclose(s_lse.numpy(), want_lse, atol=1e-5, rtol=0)
    # the lse's low-order tail: what the fp32 head leaves out of m + log l,
    # m and l taken in float64 over the fp32 scores (at a masked key the
    # bias swamps q.k: fp32 steps by 64 at -1e9)
    s = (np.einsum("bhqd,bhkd->bhqk", q, k) * np.float32(1 / np.sqrt(D))
         + np.where(mask == 0, np.float32(-1e9), np.float32(0))[
             :, None, None, :]).astype(np.float64)
    m = s.max(axis=-1)
    exact = m + np.log(np.exp(s - m[..., None]).sum(axis=-1))
    np.testing.assert_allclose(s_lo.numpy(), exact - s_lse.numpy(),
                               atol=1e-5, rtol=0)
    # at the fully masked row every key ties at -1e9: l = Lk
    np.testing.assert_allclose(s_lo[-1].numpy(), np.log(L), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 9, 17])
def test_mlp_plain_matches_pallas_at_row_edges(rows, dtype):
    rng = np.random.default_rng(rows)
    d_in, d_h, d_out = 64, 128, 4
    x = rng.normal(size=(rows, d_in)).astype(np.float32)
    w1 = (rng.normal(size=(d_h, d_in)) * 0.1).astype(np.float32)
    b1 = (rng.normal(size=(d_h,)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(d_out, d_h)) * 0.1).astype(np.float32)
    b2 = (rng.normal(size=(d_out,)) * 0.1).astype(np.float32)
    jdt = jnp.dtype(dtype)
    args = [jnp.asarray(a, jdt) for a in (x, w1, b1, w2, b2)]
    want = np.asarray(jnp.asarray(jmlp._mlp_fwd_pallas(*args, block_b=8),
                                  jnp.float32))
    tdt = getattr(torch, dtype)
    got = mlp_reference(*[torch.from_numpy(
        np.asarray(jnp.asarray(a, jnp.float32))).to(tdt) for a in args])
    assert got.dtype == tdt and got.shape == (rows, d_out)
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=1e-5 if dtype == "float32" else 2e-2,
                               rtol=0)
