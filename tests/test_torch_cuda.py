"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU: each is marked ``cuda`` and skips
without one (decided inside the ``card`` fixture, never at import).
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: bf16 2e-2 max abs on forward outputs (p and relu(h) round to
bf16 at the same points, accumulation orders differ), lse 1e-3; fp32
1e-5 with TF32 off (one flipped dropout keep bit would show).  Backward
gradients are held relative to the plain version's max |value|: bf16
2e-2, fp32 1e-5 (sums of 128-512 products in another order).  The
long-context cases (L 8192 and 16384, the TPU's k-blocked shapes) run
against the plain versions walked 1024 q rows at a time; there |out|
shrinks as 1/sqrt(L) (~0.018 at 8192), so bf16 outputs are held to 2e-2
of max |plain| and lse to 1e-4.  fp32 steps card vs CPU: loss 1e-5, each
gradient leaf 1e-5 of its own max |CPU grad|.
"""

import numpy as np
import pytest
import torch

from faster_distributed_training_tpu_torch import cli
from faster_distributed_training_tpu_torch.interop import params_to_jax
from faster_distributed_training_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_recompute,
    flash_attention_bwd_reference, flash_attention_qkv,
    flash_attention_reference, flash_attention_stats)
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


def _bwd_inputs(gen, B, H, L, D, dtype, rate):
    q, k, v = _qkv(gen, B, H, L, D, dtype)
    mask = _mask(gen, B, L)
    out, lse, lse_lo = flash_attention_stats(q, k, v, mask, rate, 99)
    dout = torch.randn(B, H, L, D, generator=gen, device="cuda").to(dtype)
    return q, k, v, mask, out, (lse, lse_lo), dout


def _rel_err(got, want):
    return max((g.float() - w.float()).abs().max().item()
               / max(w.float().abs().max().item(), 1e-30)
               for g, w in zip(got, want))


def _assert_step_matches(l_g, g_g, l_c, g_c):
    """An fp32 step card vs CPU: loss 1e-5; each gradient leaf held to its
    own scale, so a small leaf is not hidden under a large one's limit."""
    assert abs(l_g.item() - l_c.item()) <= 1e-5
    for name, want in g_c.items():
        assert _rel_err((g_g[name].cpu(),), (want,)) <= 1e-5, name


@pytest.mark.parametrize("L,D,rate", [(40, 16, 0.1), (64, 64, 0.1),
                                      (130, 32, 0.0), (512, 64, 0.1),
                                      (96, 128, 0.1)])
def test_flash_bwd_bf16_matches_plain(card, L, D, rate):
    q, k, v, mask, out, lse, dout = _bwd_inputs(card, 2, 4, L, D,
                                                torch.bfloat16, rate)
    n0 = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse[0], dout, mask, rate, 99,
                              lse[1])
    want = flash_attention_bwd_reference(q, k, v, out, lse[0], dout, mask,
                                         rate, 99, lse[1])
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == n0 + 1
    assert [g.dtype for g in got] == [torch.bfloat16] * 3
    assert _rel_err(got, want) <= 2e-2
    # no atomics: the same launch gives the same bits
    again = flash_attention_bwd(q, k, v, out, lse[0], dout, mask, rate, 99,
                                lse[1])
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("D", [16, 64])
def test_flash_bwd_fp32_dropout_matches_plain(card, D):
    q, k, v, mask, out, lse, dout = _bwd_inputs(card, 2, 3, 128, D,
                                                torch.float32, 0.1)
    got = flash_attention_bwd(q, k, v, out, lse[0], dout, mask, 0.1, 99,
                              lse[1])
    want = flash_attention_bwd_reference(q, k, v, out, lse[0], dout, mask,
                                         0.1, 99, lse[1])
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= 1e-5


def test_flash_bwd_recompute_route_and_autograd(card):
    q, k, v, mask, out, lse, dout = _bwd_inputs(card, 2, 4, 100, 64,
                                                torch.bfloat16, 0.1)
    stats = flash_attention_bwd(q, k, v, out, lse[0], dout, mask, 0.1, 99,
                                lse[1])
    n0 = flash_attention_bwd_recompute.launches
    rec = flash_attention_bwd_recompute(q, k, v, dout, mask, 0.1, 99)
    torch.cuda.synchronize()
    assert flash_attention_bwd_recompute.launches == n0 + 1
    assert _rel_err(rec, stats) <= 2e-2
    qkv = torch.stack([t.transpose(1, 2) for t in (q, k, v)], dim=2)
    for save in (True, False):
        leaf = qkv.detach().requires_grad_(True)
        ctx = flash_attention_qkv(leaf, mask, 0.1, 99, save_stats=save)
        (dqkv,) = torch.autograd.grad(ctx, leaf, dout)
        want = stats if save else rec
        for i in range(3):
            assert torch.equal(dqkv[:, :, i].transpose(1, 2), want[i])


def test_flash_bwd_rejects_what_the_kernel_does_not_take(card):
    q, k, v, mask, out, lse, dout = _bwd_inputs(card, 1, 2, 16, 128,
                                                torch.float32, 0.0)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd(q, k, v, out, lse[0], dout, mask)
    q, k, v, mask, out, lse, dout = _bwd_inputs(card, 1, 2, 16, 16,
                                                torch.bfloat16, 0.0)
    with pytest.raises(ValueError, match="dout"):
        flash_attention_bwd(q, k, v, out, lse[0], dout.float(), mask)


def test_train_step_on_card_matches_cpu(card):
    """One fp32 train step at small width: the card's kernels against the
    CPU's plain versions, same weights, batch and draws (loss 1e-5, grads
    1e-5 of each leaf's max), and the step's launches (2 flash fwd, 2 flash
    bwd, 1 MLP)."""
    from faster_distributed_training_tpu_torch.train.steps import (
        loss_and_grads, step_draws, to_device)

    cfg = cli.TRANSFORMER_DEFAULTS.replace(
        n_layers=2, d_model=64, n_heads=4, d_ff=128, seq_len=64,
        precision="fp32", attention="flash")
    cpu = cli.build_model(cfg, vocab_size=100, device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(2))
    gpu = cli.build_model(cfg, vocab_size=100, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    gpu.cuda()
    rng = np.random.default_rng(1)
    mask = (np.arange(64)[None] < rng.integers(4, 65, size=(6, 1))).astype(
        np.int32)
    batch = {"tokens": (rng.integers(1, 100, size=(6, 64)) * mask).astype(
                 np.int32),
             "mask": mask, "label": rng.integers(0, 4, size=6).astype(
                 np.int32)}
    draws = step_draws(0, 3, 6, cpu.n_dropout_sites(), 0.99)
    want_loss, want, *_ = loss_and_grads(cpu, to_device(batch, "cpu"),
                                         draws)
    counts = (flash_attention.launches, flash_attention_bwd.launches,
              fused_mlp.launches)
    loss, got, *_ = loss_and_grads(gpu, to_device(batch, "cuda"), draws)
    torch.cuda.synchronize()
    assert (flash_attention.launches - counts[0],
            flash_attention_bwd.launches - counts[1],
            fused_mlp.launches - counts[2]) == (2, 2, 1)
    _assert_step_matches(loss, got, want_loss, want)


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


# -- slice 3: the quantized GEMM and the fused FFN ---------------------------
#
# int8 GEMMs are exact: kernel == plain version bit for bit.  E4M3 and the
# fused FFN hold to 2e-2 of max |plain| in bf16 and under quant (the
# kernels sum in another order; a flipped rounding of f or a before
# quantization moves one grid step), 1e-4 in fp32 without quant.  Two launches on the same inputs give the
# same bits, the amaxes included.


def _quant_operands(g, M, K, N, fmt):
    from faster_distributed_training_tpu_torch.ops.quant import quantize

    x = torch.randn(M, K, generator=g, device="cuda")
    w = torch.randn(N, K, generator=g, device="cuda") * 0.05
    sx = torch.tensor(127.0 / 4.0 if fmt == "int8" else 448.0 / 4.0,
                      device="cuda")
    sw = torch.tensor(127.0 / 0.2 if fmt == "int8" else 448.0 / 0.2,
                      device="cuda")
    return quantize(x, sx, fmt), quantize(w, sw, fmt), sx, sw


@pytest.mark.parametrize("M,K,N", [(8192, 512, 1536), (8192, 1024, 512),
                                   (77, 48, 40)])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quant_matmul_matches_plain(card, M, K, N, fmt):
    from faster_distributed_training_tpu_torch.ops.quant import (
        quant_dot_reference, quant_matmul)

    xq, wq, sx, sw = _quant_operands(card, M, K, N, fmt)
    for dtype in (torch.bfloat16, torch.float32):
        n0 = quant_matmul.launches
        got = quant_matmul(xq, wq, sx, sw, fmt, dtype)
        again = quant_matmul(xq, wq, sx, sw, fmt, dtype)
        want = quant_dot_reference(xq, wq, sx, sw, fmt, dtype)
        torch.cuda.synchronize()
        assert quant_matmul.launches == n0 + 2
        assert torch.equal(got, again)
        if fmt == "int8":
            assert torch.equal(got, want)
        else:
            tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
            err = (got.float() - want.float()).abs().max().item()
            assert err <= tol * want.float().abs().max().item()


def test_quant_matmul_rejects_what_the_kernel_does_not_take(card):
    from faster_distributed_training_tpu_torch.ops.quant import quant_matmul

    xq, wq, sx, sw = _quant_operands(card, 8, 24, 8, "int8")
    with pytest.raises(ValueError, match="K % 16"):
        quant_matmul(xq, wq, sx, sw, "int8", torch.bfloat16)
    with pytest.raises(TypeError, match="operands"):
        quant_matmul(xq.float(), wq, sx, sw, "int8", torch.bfloat16)


def _ffn_inputs(g, rows, d, d_ff, dtype):
    h = torch.randn(rows, d, generator=g, device="cuda").to(dtype)
    ln_s = 1.0 + 0.1 * torch.randn(d, generator=g, device="cuda")
    ln_b = 0.1 * torch.randn(d, generator=g, device="cuda")
    w1 = (torch.randn(d_ff, d, generator=g, device="cuda")
          / d ** 0.5).to(dtype)
    b1 = (0.1 * torch.randn(d_ff, generator=g, device="cuda")).to(dtype)
    w2 = (torch.randn(d, d_ff, generator=g, device="cuda")
          / d_ff ** 0.5).to(dtype)
    b2 = (0.1 * torch.randn(d, generator=g, device="cuda")).to(dtype)
    return h, ln_s, ln_b, w1, b1, w2, b2


@pytest.mark.parametrize("rows,d,d_ff", [(8192, 512, 1024), (100, 64, 208)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fmt", [None, "int8", "fp8"])
def test_fused_ffn_matches_plain(card, rows, d, d_ff, dtype, fmt):
    from faster_distributed_training_tpu_torch.ops.fused_ffn import (
        _ffn_body_reference, ffn_fwd_generalized)

    args = _ffn_inputs(card, rows, d, d_ff, dtype)
    scales = torch.tensor([30.0, 300.0, 60.0, 250.0], device="cuda")
    seeds = (0x1234567, 0x89ABCDE, 0, 0, 0)
    run = lambda: ffn_fwd_generalized(  # noqa: E731
        *args, seeds, scales, 0.1, 0.1, 1e-6, 1, 1, d_ff, fmt)
    n0 = ffn_fwd_generalized.launches
    out, amax = run()
    out2, amax2 = run()
    quant = None if fmt is None else (fmt, *scales.unbind(), None)
    want, want_amax = _ffn_body_reference(
        *args, seeds[0], seeds[1], 0.1, 0.1, 1e-6, quant=quant,
        return_amax=True, plain_gemm=True)
    torch.cuda.synchronize()
    assert ffn_fwd_generalized.launches == n0 + 2
    assert torch.equal(out, out2) and torch.equal(amax, amax2)
    tol = 2e-2 if dtype == torch.bfloat16 or fmt is not None else 1e-4
    err = (out.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()
    if fmt is None:
        assert torch.equal(amax, torch.zeros_like(amax))
    else:
        assert torch.allclose(amax, want_amax, rtol=1e-2, atol=0)


def test_fused_ffn_sublayer_autograd_on_card(card):
    """The Function's forward is the kernel's output; its gradients are
    the recompute's (the plain version under autograd) on the card."""
    from faster_distributed_training_tpu_torch.ops.fused_ffn import (
        ffn_fwd, ffn_sublayer_reference, fused_ffn_sublayer)

    args = _ffn_inputs(card, 256, 64, 128, torch.float32)
    leaves = [t.detach().requires_grad_(True) for t in args]
    n0 = ffn_fwd.launches
    out = fused_ffn_sublayer(*leaves, 5, 6, 0.1, 0.1)
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, leaves, g)
    ref_leaves = [t.detach().requires_grad_(True) for t in args]
    ref = ffn_sublayer_reference(*ref_leaves, 5, 6, 0.1, 0.1)
    want = torch.autograd.grad(ref, ref_leaves, g)
    torch.cuda.synchronize()
    assert ffn_fwd.launches == n0 + 1
    assert (out - ref).abs().max().item() <= 1e-4
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


# -- long context: the same kernels as TPU rows 2 and 3 -------------------

@pytest.mark.parametrize("B,padded", [(1, True), (4, False)])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
def test_flash_long_context_matches_chunked_plain(card, dtype, tol, B,
                                                  padded):
    """L 8192 (past the TPU's monolithic envelopes: its k-blocked pair's
    shape), H 8, D 64, dropout 0.1; B 1 with ragged key padding and B 4
    with none (the LM's packed rows): the forward with lse and the
    backward against the plain versions walked 1024 q rows at a time; two
    launches give equal bits.  bf16 outputs relative to max |plain|."""
    from faster_distributed_training_tpu_torch.ops.flash_attention import (
        flash_attention_stats_reference)

    L = 8192
    q, k, v = _qkv(card, B, 8, L, 64, dtype)
    mask = ((torch.arange(L, device="cuda")[None] < 8000).int() if padded
            else None)
    out, lse, lse_lo = flash_attention_stats(q, k, v, mask, 0.1, 7)
    want = flash_attention_stats_reference(q, k, v, mask, 0.1, 7,
                                           q_chunk=1024)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        assert _rel_err((out,), (want[0],)) <= tol
    else:
        assert (out - want[0]).abs().max().item() <= tol
    lse_tol = 1e-4 if dtype == torch.bfloat16 else 1e-5
    assert (lse - want[1]).abs().max().item() <= lse_tol
    dout = torch.randn(B, 8, L, 64, generator=card, device="cuda").to(dtype)
    got = flash_attention_bwd(q, k, v, out, lse, dout, mask, 0.1, 7, lse_lo)
    ref = flash_attention_bwd_reference(q, k, v, out, lse, dout, mask, 0.1,
                                        7, lse_lo, q_chunk=1024)
    again = flash_attention_bwd(q, k, v, out, lse, dout, mask, 0.1, 7,
                                lse_lo)
    torch.cuda.synchronize()
    assert _rel_err(got, ref) <= tol
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_flash_primal_forward_at_16384(card):
    """Row 2's primal shape (Lk*D past 8192*64): one sequence of 16384,
    held to 2e-2 of max |plain| (|out| ~0.013 here), and the forward with
    lse at the same shape (lse 1e-4)."""
    from faster_distributed_training_tpu_torch.ops.flash_attention import (
        flash_attention_stats_reference)

    q, k, v = _qkv(card, 1, 8, 16384, 64, torch.bfloat16)
    out = flash_attention(q, k, v)
    want = flash_attention_reference(q, k, v, q_chunk=1024)
    _, lse, _ = flash_attention_stats(q, k, v, None, 0.0, 0)
    want_lse = flash_attention_stats_reference(q, k, v, None, 0.0, 0,
                                               q_chunk=1024)[1]
    torch.cuda.synchronize()
    assert _rel_err((out,), (want,)) <= 2e-2
    assert (lse - want_lse).abs().max().item() <= 1e-4


def test_lm_train_step_on_card_matches_cpu(card):
    """One fp32 next-token LM step (tied head) at d_model 64, L 512: the
    card's kernels against the CPU's plain versions (loss 1e-5, grads
    1e-5 of each leaf's max), and the step's launches (2 forwards with lse, 2 backward
    pairs, no classifier)."""
    from faster_distributed_training_tpu_torch.train.steps import (
        lm_loss_and_grads, step_draws, to_device)

    cfg = cli.TRANSFORMER_DEFAULTS.replace(
        task="lm", n_layers=2, d_model=64, n_heads=4, d_ff=128, seq_len=512,
        precision="fp32", attention="flash")
    m_cpu = cli.build_model(cfg, vocab_size=300, device="cpu")
    m_cpu.init_weights(torch.Generator().manual_seed(5))
    m_gpu = cli.build_model(cfg, vocab_size=300, device="cuda")
    m_gpu.load_state_dict(m_cpu.state_dict())
    m_gpu.cuda()
    tokens = np.random.default_rng(1).integers(1, 300, size=(2, 512))
    batch = {"tokens": tokens.astype(np.int32),
             "mask": np.ones((2, 512), np.int32)}
    draws = step_draws(0, 0, 2, m_cpu.n_dropout_sites(), 0.99)
    l_c, g_c, *_ = lm_loss_and_grads(m_cpu, to_device(batch, "cpu"), draws)
    counts = (flash_attention_stats.launches, flash_attention_bwd.launches,
              fused_mlp.launches)
    l_g, g_g, *_ = lm_loss_and_grads(m_gpu, to_device(batch, "cuda"), draws)
    torch.cuda.synchronize()
    assert (flash_attention_stats.launches - counts[0],
            flash_attention_bwd.launches - counts[1],
            fused_mlp.launches - counts[2]) == (2, 2, 0)
    _assert_step_matches(l_g, g_g, l_c, g_c)
