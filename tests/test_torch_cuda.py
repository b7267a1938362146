"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU: each is marked ``cuda`` and skips
without one (decided inside the ``card`` fixture, never at import).
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: bf16 2e-2 max abs on outputs (p and relu(h) round to bf16
at the same points, accumulation orders differ), lse 1e-3; fp32 1e-5
with TF32 off (one flipped dropout keep bit would show).
"""

import numpy as np
import pytest
import torch

from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch.interop import params_to_jax
from faster_distributed_training_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_reference)
from faster_distributed_training_tpu_torch.ops.fused_mlp import (
    fused_mlp, mlp_reference)
from faster_distributed_training_tpu_torch.serve import pad_batch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(gen, B, H, L, D, dtype):
    qkv = torch.randn(B, L, 3, H, D, generator=gen, device="cuda").to(dtype)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def _mask(gen, B, L):
    lengths = torch.randint(1, L + 1, (B,), generator=gen, device="cuda")
    mask = (torch.arange(L, device="cuda")[None] < lengths[:, None]).int()
    mask[0] = 0
    return mask


@pytest.mark.parametrize("L,D", [(40, 16), (64, 64), (130, 32), (512, 64),
                                 (96, 128)])
def test_flash_bf16_matches_plain(card, L, D):
    q, k, v = _qkv(card, 2, 4, L, D, torch.bfloat16)
    mask = _mask(card, 2, L)
    n0 = flash_attention.launches
    out, lse = flash_attention(q, k, v, mask=mask, emit_lse=True)
    ref, ref_lse = flash_attention_reference(q, k, v, mask=mask,
                                             emit_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_flash_fp32_dropout_matches_plain(card, rate):
    q, k, v = _qkv(card, 2, 3, 100, 64, torch.float32)
    mask = _mask(card, 2, 100)
    out = flash_attention(q, k, v, mask=mask, dropout_rate=rate,
                          dropout_seed=2024)
    ref = flash_attention_reference(q, k, v, mask=mask, dropout_rate=rate,
                                    dropout_seed=2024)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-5


def test_flash_rejects_what_the_kernel_does_not_take(card):
    q, k, v = _qkv(card, 1, 2, 16, 24, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, k, v)
    q, k, v = _qkv(card, 1, 2, 16, 16, torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, k, v)


@pytest.mark.parametrize("rows,dtype", [(8, torch.bfloat16),
                                        (4096, torch.bfloat16),
                                        (13, torch.float32)])
def test_mlp_matches_plain(card, rows, dtype):
    g = card
    x = torch.randn(rows, 512, generator=g, device="cuda").to(dtype)
    w1 = (torch.randn(1024, 512, generator=g, device="cuda") * 0.05).to(dtype)
    b1 = (torch.randn(1024, generator=g, device="cuda") * 0.05).to(dtype)
    w2 = (torch.randn(4, 1024, generator=g, device="cuda") * 0.05).to(dtype)
    b2 = (torch.randn(4, generator=g, device="cuda") * 0.05).to(dtype)
    n0 = fused_mlp.launches
    got = fused_mlp(x, w1, b1, w2, b2)
    want = mlp_reference(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert fused_mlp.launches == n0 + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    assert (got.float() - want.float()).abs().max().item() <= tol
    # deterministic: the same call gives the same bits
    assert torch.equal(fused_mlp(x, w1, b1, w2, b2), got)


def test_mlp_rejects_unaligned_rows(card):
    x = torch.randn(2, 12, device="cuda", dtype=torch.bfloat16)
    w1 = torch.randn(8, 12, device="cuda", dtype=torch.bfloat16)
    w2 = torch.randn(4, 8, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="d_in"):
        fused_mlp(x, w1, None, w2, None)


def test_serving_on_card_counts_launches_and_is_batch_invariant(card):
    cfg = cli.TRANSFORMER_DEFAULTS.replace(
        n_layers=2, d_model=64, n_heads=4, d_ff=128, seq_len=64,
        seq_buckets=(16, 32, 64), serve_batch_size=4, serve_requests=12,
        device="cuda")
    model = cli.build_model(cfg, vocab_size=100, device="cpu")
    model.init_weights(torch.Generator().manual_seed(1))
    requests = cli.synth_requests(12, 100, (16, 32, 64), seed=5)
    flash_attention.launches = fused_mlp.launches = 0
    out = cli.run_serving(cfg, requests=requests,
                          params=params_to_jax(model.state_dict(), 4),
                          log=lambda s: None)
    calls = sum(e.calls for e in out["engines"])
    assert flash_attention.launches == 2 * calls
    assert fused_mlp.launches == calls
    engine = out["engines"][0]
    for req, bucket, got in zip(requests, out["buckets"], out["results"]):
        assert np.isfinite(got).all()
        batch, _ = pad_batch([type("R", (), {"tokens": req})], bucket, 4)
        np.testing.assert_array_equal(engine.predict_batch(batch)[0], got)
