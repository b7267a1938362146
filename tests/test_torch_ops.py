"""Parity of the PyTorch port's ops with the JAX package's.

Each test feeds the same numpy inputs (made from a seed) to the JAX
function and to its port counterpart:

  * ``dropout_keep`` — bitwise (integer hash);
  * ``torch_layernorm_f32`` — fp32, atol 1e-6;
  * ``flash_attention_reference`` (the plain version of the Hopper
    kernel) against ``_flash_fwd_pallas`` in interpret mode — padding,
    ragged Lq = 40, a fully masked row, dropout 0.1 and the lse: fp32 to
    1e-5, bf16 to 2e-2;
  * ``mlp_reference`` (the plain version of the fused-MLP kernel) against
    ``_mlp_fwd_pallas`` in interpret mode: fp32 to 1e-5, bf16 to 2e-2.

The kernels themselves only run on a card (tests/test_torch_cuda.py).
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_distributed_training_tpu.ops.layernorm import (
    torch_layernorm_f32 as j_layernorm)
from faster_distributed_training_tpu_torch.ops import attention as tattn
from faster_distributed_training_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_reference)
from faster_distributed_training_tpu_torch.ops.fused_mlp import (
    fused_mlp, mlp_reference)
from faster_distributed_training_tpu_torch.ops.layernorm import (
    torch_layernorm_f32)

# the JAX ops package re-exports functions under the module names
jattn, jflash, jmlp = (importlib.import_module(
    f"faster_distributed_training_tpu.ops.{m}")
    for m in ("attention", "flash_attention", "fused_mlp"))

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("seed", [0, 7, 0x9E3779B9, 0xFFFFFFFF])
def test_dropout_keep_bitwise(seed, rate):
    rng = np.random.default_rng(seed % 1000 + int(rate * 10))
    bh = rng.integers(0, 2**20, size=(6, 1, 1)).astype(np.int32)
    q = rng.integers(0, 2**16, size=(1, 5, 1)).astype(np.int32)
    k = rng.integers(0, 2**16, size=(1, 1, 7)).astype(np.int32)
    want = jattn.dropout_keep(jnp.uint32(seed), jnp.asarray(bh),
                              jnp.asarray(q), jnp.asarray(k), rate)
    got = tattn.dropout_keep(seed, torch.from_numpy(bh), torch.from_numpy(q),
                             torch.from_numpy(k), rate)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_layernorm_fp32():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3 + 1
    scale = rng.normal(size=(64,)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    want = j_layernorm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                       1e-6)
    got = torch_layernorm_f32(torch.from_numpy(x), torch.from_numpy(scale),
                              torch.from_numpy(bias), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def _attn_inputs(B, H, L, D, seed, masked_row=True):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, L, D)).astype(np.float32)
               for _ in range(3))
    lengths = rng.integers(1, L + 1, size=B)
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
    if masked_row:
        mask[-1] = 0
    return q, k, v, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,rate,emit_lse", [(40, 0.0, True), (32, 0.1, False),
                                             (40, 0.1, True)])
def test_flash_plain_matches_pallas_kernel(dtype, L, rate, emit_lse):
    B, H, D = 2, 2, 16
    q, k, v, mask = _attn_inputs(B, H, L, D, seed=L + int(rate * 10))
    seed = 123457
    jdt = jnp.dtype(dtype)
    n3 = lambda a: jnp.asarray(a, jdt).reshape(B * H, L, D)  # noqa: E731
    res = jflash._flash_fwd_pallas(
        n3(q), n3(k), n3(v), jattn.mask_to_bias(jnp.asarray(mask)), H,
        block_q=16, dropout_rate=rate, seed3=jflash._pack_seed(seed),
        emit_lse=emit_lse)
    want_out, want_lse = res if emit_lse else (res, None)
    tdt = getattr(torch, dtype)
    t = lambda a: torch.from_numpy(  # noqa: E731
        _f32(jnp.asarray(a, jdt))).to(tdt)
    got = flash_attention_reference(t(q), t(k), t(v),
                                     mask=torch.from_numpy(mask),
                                     dropout_rate=rate, dropout_seed=seed,
                                     emit_lse=emit_lse)
    got_out, got_lse = got if emit_lse else (got, None)
    assert got_out.dtype == tdt and got_out.shape == (B, H, L, D)
    np.testing.assert_allclose(got_out.float().numpy(),
                               _f32(want_out).reshape(B, H, L, D),
                               atol=TOL[dtype], rtol=0)
    if emit_lse:
        np.testing.assert_allclose(got_lse.numpy(),
                                   _f32(want_lse).reshape(B, H, L),
                                   atol=1e-5 if dtype == "float32" else 1e-3,
                                   rtol=1e-6)
    # the fully masked row comes out as the mean of V, not 0 or NaN
    masked = got_out[-1].float().numpy()
    np.testing.assert_allclose(
        masked, np.broadcast_to(_f32(jnp.asarray(v[-1], jdt)).mean(
            axis=1, keepdims=True), masked.shape) if rate == 0 else masked,
        atol=TOL[dtype] * 5)


def test_flash_plain_matches_dense_and_blockwise():
    """Without dropout the kernel's plain version, the dense reference and
    the blockwise (online-softmax) form agree — the JAX package's own
    dense/blockwise pair as the oracle."""
    B, H, L, D = 2, 2, 24, 8
    q, k, v, mask = _attn_inputs(B, H, L, D, seed=5)
    m4 = mask[:, None, None, :]
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want = np.asarray(jattn.dense_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m4),
        dropout_rate=0.1, dropout_seed=jnp.uint32(11)))
    got_dense = tattn.dense_attention_reference(
        tq, tk, tv, torch.from_numpy(m4), dropout_rate=0.1, dropout_seed=11)
    got_block = tattn.blockwise_attention(
        tq, tk, tv, torch.from_numpy(m4), block_k=7, dropout_rate=0.1,
        dropout_seed=11)
    np.testing.assert_allclose(got_dense.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got_block.numpy(), want, atol=1e-5)
    got_flash = flash_attention_reference(tq, tk, tv, torch.from_numpy(mask),
                                          dropout_rate=0.1, dropout_seed=11)
    np.testing.assert_allclose(got_flash.numpy(), want, atol=1e-5)


def test_blockwise_causal_matches_jax():
    B, H, L, D = 1, 2, 20, 8
    q, k, v, _ = _attn_inputs(B, H, L, D, seed=9, masked_row=False)
    want = np.asarray(jattn.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, block_k=8,
        causal=True))
    got = tattn.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                    block_k=8, causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [8, 13])
def test_mlp_plain_matches_pallas_kernel(dtype, rows):
    rng = np.random.default_rng(rows)
    d_in, d_h, d_out = 64, 96, 4
    x = rng.normal(size=(rows, d_in)).astype(np.float32)
    w1 = (rng.normal(size=(d_h, d_in)) * 0.1).astype(np.float32)
    b1 = (rng.normal(size=(d_h,)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(d_out, d_h)) * 0.1).astype(np.float32)
    b2 = (rng.normal(size=(d_out,)) * 0.1).astype(np.float32)
    jdt = jnp.dtype(dtype)
    args = [jnp.asarray(a, jdt) for a in (x, w1, b1, w2, b2)]
    want = jmlp._mlp_fwd_pallas(*args, block_b=8)
    tdt = getattr(torch, dtype)
    targs = [torch.from_numpy(_f32(a)).to(tdt) for a in args]
    got = mlp_reference(*targs)
    assert got.dtype == tdt and got.shape == (rows, d_out)
    np.testing.assert_allclose(got.float().numpy(), _f32(want),
                               atol=TOL[dtype], rtol=0)
    # the wrapper takes the plain version for CPU tensors, and only then
    n0 = fused_mlp.launches
    np.testing.assert_array_equal(fused_mlp(*targs).float().numpy(),
                                  got.float().numpy())
    assert fused_mlp.launches == n0


def test_wrappers_take_plain_version_only_on_cpu():
    q = torch.zeros(1, 1, 4, 16)
    n0 = flash_attention.launches
    torch.testing.assert_close(flash_attention(q, q, q),
                               flash_attention_reference(q, q, q))
    assert flash_attention.launches == n0
    meta = torch.empty(1, 1, 4, 16, device="meta")
    with pytest.raises(ValueError):
        flash_attention(meta, meta, meta)
    with pytest.raises(ValueError):
        fused_mlp(torch.empty(2, 16, device="meta"),
                  torch.empty(8, 16, device="meta"), None,
                  torch.empty(4, 8, device="meta"), None)


def test_keep_scale_and_threshold_match_jax_rounding():
    for rate in (0.1, 0.3, 0.9):
        want = np.float32(1.0) / np.float32(1.0 - rate)
        assert tattn.keep_scale(rate) == float(want)
        assert tattn.keep_threshold(rate) == min(
            int((1.0 - rate) * 4294967296.0), 4294967295)
    assert tattn.keep_threshold(0.0) == 4294967295
    assert math.isfinite(tattn.keep_scale(0.5))


def test_mask_to_bias_matches_jax():
    mask = np.array([[1, 0, 1], [0, 0, 1]], np.int32)
    np.testing.assert_array_equal(
        tattn.mask_to_bias(torch.from_numpy(mask)).numpy(),
        np.asarray(jattn.mask_to_bias(jnp.asarray(mask))))
    assert tattn.mask_to_bias(None) is None
    assert jax.numpy.float32(tattn.NEG_INF) == jattn.NEG_INF
