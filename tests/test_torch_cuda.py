"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU: each is marked ``cuda`` and skips
without one (decided inside the ``card`` fixture, never at import).
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: bf16 2e-2 max abs on forward outputs (p and relu(h) round to
bf16 at the same points, accumulation orders differ; at the forward's
tile edges relative to max |plain|), lse 1e-3; fp32
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
    flash_attention_reference, flash_attention_stats,
    flash_attention_stats_reference)
from faster_distributed_training_tpu_torch.ops.fused_mlp import (
    fused_mlp, mlp_reference)
from faster_distributed_training_tpu_torch.serve import pad_batch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    """The card's generator, TF32 matmuls off; the process's backend
    flags (TF32, cuDNN determinism and autotuning) come back after."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    cudnn = torch.backends.cudnn
    flags = (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32,
             cudnn.deterministic, cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.Generator(device="cuda").manual_seed(0)
    (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32,
     cudnn.deterministic, cudnn.benchmark) = flags


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


# the bf16 forward kernel's tile edges: 128-row q blocks of two 64-row
# warpgroups, 64-key ring stages
_FWD_EDGES = [(L, D, rate) for L in (1, 63, 65, 127, 129, 200, 1100)
              for D in (16, 32, 64, 128) for rate in (0.0, 0.1)]


@pytest.mark.parametrize("L,D,rate", _FWD_EDGES)
def test_flash_fwd_bf16_at_tile_edges(card, L, D, rate):
    """flash_fwd_kernel_sm90 against the plain version: out 2e-2 of max
    |plain|, lse 1e-3, lse_lo 1e-3 (batch element 0 has every key masked,
    ``_mask``); q/k/v are views of one [B, L, 3, H, D] buffer, and the
    same values copied out contiguous give the same bits; two launches
    give the same bits."""
    q, k, v = _qkv(card, 2, 4, L, D, torch.bfloat16)
    mask = _mask(card, 2, L)
    n0 = flash_attention.launches
    got = flash_attention_stats(q, k, v, mask, rate, 99)
    want = flash_attention_stats_reference(q, k, v, mask, rate, 99)
    again = flash_attention_stats(q, k, v, mask, rate, 99)
    flat = flash_attention_stats(q.contiguous(), k.contiguous(),
                                 v.contiguous(), mask, rate, 99)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 3
    assert got[0].dtype == torch.bfloat16 and got[0].shape == (2, 4, L, D)
    assert _rel_err(got[:1], want[:1]) <= 2e-2
    assert (got[1] - want[1]).abs().max().item() <= 1e-3
    assert (got[2] - want[2]).abs().max().item() <= 1e-3
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(got, flat))


@pytest.mark.parametrize("Lq,Lk", [(100, 300), (300, 65), (1, 129)])
def test_flash_fwd_bf16_lq_ne_lk(card, Lq, Lk):
    q, _, _ = _qkv(card, 2, 4, Lq, 64, torch.bfloat16)
    _, k, v = _qkv(card, 2, 4, Lk, 64, torch.bfloat16)
    mask = _mask(card, 2, Lk)
    got = flash_attention_stats(q, k, v, mask, 0.1, 5)
    want = flash_attention_stats_reference(q, k, v, mask, 0.1, 5)
    torch.cuda.synchronize()
    assert _rel_err(got[:1], want[:1]) <= 2e-2
    assert (got[1] - want[1]).abs().max().item() <= 1e-3


@pytest.mark.parametrize("D", [16, 64, 128])
def test_flash_fwd_bf16_fully_masked_row(card, D):
    """A batch row with every key masked: its out (the mean of V) and its
    lse tail (log Lk) match the plain version, and the backward that takes
    this forward's lse gives the dense VJP's gradients."""
    L = 200
    q, k, v = _qkv(card, 2, 4, L, D, torch.bfloat16)
    mask = torch.ones(2, L, dtype=torch.int32, device="cuda")
    mask[1] = 0
    out, lse, lse_lo = flash_attention_stats(q, k, v, mask, 0.0, 0)
    want = flash_attention_stats_reference(q, k, v, mask, 0.0, 0)
    torch.cuda.synchronize()
    assert _rel_err((out[1],), (want[0][1],)) <= 2e-2
    assert (lse_lo[1] - want[2][1]).abs().max().item() <= 1e-3
    dout = torch.randn(2, 4, L, D, generator=card, device="cuda").to(
        torch.bfloat16)
    got = flash_attention_bwd(q, k, v, out, lse, dout, mask, 0.0, 0, lse_lo)
    dense = _dense_vjp(q[1:], k[1:], v[1:], mask[1:], dout[1:])
    torch.cuda.synchronize()
    assert _rel_err([g[1:] for g in got], dense) <= 2e-2


def test_flash_fwd_refuses_views_it_cannot_take(card):
    """The bf16 forward moves 16-byte rows: a base that is not 16-byte
    aligned, or an l stride that is not a multiple of 8, raises before a
    launch (no copy, no other route)."""
    q, k, v = _qkv(card, 1, 2, 16, 16, torch.bfloat16)
    wide = torch.randn(1, 2, 16, 20, device="cuda").to(torch.bfloat16)
    flat = torch.randn(1 + 2 * 16 * 16, device="cuda").to(torch.bfloat16)
    n0 = flash_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(wide[..., :16], k, v)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, flat[1:].view(1, 2, 16, 16), v)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_stats(q, k, flat[1:].view(1, 2, 16, 16))
    assert flash_attention.launches == n0


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


def _dense_vjp(q, k, v, mask, dout):
    """fp32 autograd through plain softmax attention (no dropout): the
    dense VJP a fully masked row's gradients must match (a uniform row)."""
    from faster_distributed_training_tpu_torch.ops.attention import (
        mask_to_bias)

    leaves = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    s = leaves[0] @ leaves[1].transpose(-1, -2) / q.shape[-1] ** 0.5
    s = s + mask_to_bias(mask)[:, None, None, :]
    out = torch.softmax(s, dim=-1) @ leaves[2]
    return torch.autograd.grad(out, leaves, dout.float())


# the wgmma kernels' tile edges: 128-key dkdv blocks, 64-row q stages (32
# at D 128), 128-row dq blocks and 64-key stages
_BWD_EDGES = [(L, D, rate) for L in (127, 129, 200, 1100)
              for D in (16, 32, 64, 128) for rate in (0.0, 0.1)]


@pytest.mark.parametrize("L,D,rate", [(40, 16, 0.1), (64, 64, 0.1),
                                      (130, 32, 0.0), (512, 64, 0.1),
                                      (96, 128, 0.1)] + _BWD_EDGES)
def test_flash_bwd_bf16_matches_plain(card, L, D, rate):
    """Batch element 0 has every key masked (``_mask``); q/k/v are strided
    views of one [B, L, 3, H, D] projection, and the gradients also go
    into the views of one such buffer."""
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
    # no atomics: the same launch gives the same bits, into separate
    # buffers or into the fused [B, L, 3, H, D] gradient's views
    again = flash_attention_bwd(q, k, v, out, lse[0], dout, mask, rate, 99,
                                lse[1])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    dqkv = torch.empty(2, L, 3, 4, D, device="cuda", dtype=torch.bfloat16)
    fused = tuple(dqkv[:, :, i].transpose(1, 2) for i in range(3))
    flash_attention_bwd(q, k, v, out, lse[0], dout, mask, rate, 99, lse[1],
                        grads=fused)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, fused))
    if rate == 0.0:
        # the fully masked element against the dense VJP (the lse tail)
        dense = _dense_vjp(q[:1], k[:1], v[:1], mask[:1], dout[:1])
        assert _rel_err([g[:1] for g in got], dense) <= 2e-2


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
    # the bf16 kernels move 16-byte rows: an odd row stride, or a base
    # that is not 16-byte aligned, raises (no copy, no other route)
    wide = torch.randn(1, 2, 16, 17, device="cuda").to(torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd(wide[..., :16], k, v, out, lse[0], dout, mask)
    flat = torch.randn(1 + 2 * 16 * 16, device="cuda").to(torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd(q, flat[1:].view(1, 2, 16, 16), v, out, lse[0],
                            dout, mask)


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


def _mlp_weights(g, dtype, d_in=512, d_h=1024, d_out=4):
    return [(torch.randn(*shape, generator=g, device="cuda") * 0.05).to(dtype)
            for shape in ((d_h, d_in), (d_h,), (d_out, d_h), (d_out,))]


@pytest.mark.parametrize("rows", [1, 8, 9, 16, 17, 64, 65, 4096])
def test_mlp_bf16_rows_and_batch_invariance(card, rows):
    """The tensor-core classifier (16-row blocks up to 64 rows, 128-row
    blocks past them) against the plain version at 2e-2; two calls give
    the same bits, and each of the first rows gives the same bits alone
    as inside the batch (whichever block shape ran it)."""
    w1, b1, w2, b2 = _mlp_weights(card, torch.bfloat16)
    x = torch.randn(rows, 512, generator=card, device="cuda").to(
        torch.bfloat16)
    got = fused_mlp(x, w1, b1, w2, b2)
    want = mlp_reference(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    assert torch.equal(fused_mlp(x, w1, b1, w2, b2), got)
    for i in range(min(rows, 3)):
        assert torch.equal(fused_mlp(x[i:i + 1], w1, b1, w2, b2), got[i:i + 1])


@pytest.mark.parametrize("rows,d_in,d_h,d_out", [(8, 520, 1000, 40),
                                                 (200, 520, 1000, 40),
                                                 (9, 64, 1000, 4),
                                                 (130, 64, 1000, 4)])
def test_mlp_bf16_ragged_and_wide_shapes(card, rows, d_in, d_h, d_out):
    """Shapes off the record: d_in a half k step past a multiple of 16, d_h
    not a multiple of the 64-unit groups, and 40 outputs, whose w2 columns
    and group sums no longer fit shared memory (both block shapes then read
    them from device memory): 2e-2 against the plain version, and the
    first row's bits alone equal its bits in the batch."""
    w1, b1, w2, b2 = _mlp_weights(card, torch.bfloat16, d_in, d_h, d_out)
    x = torch.randn(rows, d_in, generator=card, device="cuda").to(
        torch.bfloat16)
    got = fused_mlp(x, w1, b1, w2, b2)
    want = mlp_reference(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    assert torch.equal(fused_mlp(x[:1], w1, b1, w2, b2), got[:1])


def test_mlp_row_alone_equals_row_in_a_batch_of_16(card):
    w1, b1, w2, b2 = _mlp_weights(card, torch.bfloat16)
    x = torch.randn(16, 512, generator=card, device="cuda").to(torch.bfloat16)
    batched = fused_mlp(x, w1, b1, w2, b2)
    alone = torch.cat([fused_mlp(x[i:i + 1], w1, b1, w2, b2)
                       for i in range(16)])
    torch.cuda.synchronize()
    assert torch.equal(alone, batched)


def test_mlp_rejects_unaligned_rows(card):
    x = torch.randn(2, 12, device="cuda", dtype=torch.bfloat16)
    w1 = torch.randn(8, 12, device="cuda", dtype=torch.bfloat16)
    w2 = torch.randn(4, 8, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="d_in"):
        fused_mlp(x, w1, None, w2, None)


def test_serving_on_card_counts_launches_and_is_batch_invariant(card,
                                                               tmp_path):
    cfg = cli.TRANSFORMER_DEFAULTS.replace(
        n_layers=2, d_model=64, n_heads=4, d_ff=128, seq_len=64,
        seq_buckets=(16, 32, 64), serve_batch_size=4, serve_requests=12,
        device="cuda", checkpoint_dir=str(tmp_path))
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
# kernels sum in another order, fp8 wgmma with a narrower accumulator; a
# flipped rounding of f or a before quantization moves one grid step),
# 1e-4 in fp32 without quant; the E4M3 GEMM with fp32 output (its exact
# bf16 upcast) 1e-5.  Two launches on the same inputs give the
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
                                   (77, 48, 40), (1000, 512, 1536),
                                   (130, 96, 72), (300, 1056, 200)])
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


@pytest.mark.parametrize("rows,d,d_ff", [(8192, 512, 1024), (100, 64, 208)]
                         + [(r, d, f) for r in (64, 100, 512) for d in (64, 512)
                            for f in (208, 1024)
                            if (r, d, f) != (100, 64, 208)])
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


def test_ffn_engine_routes_by_shape_and_type(card):
    """The wgmma FFN takes bf16 for every fmt and fp32 under quant up to
    d_model 512; fp32 without quant and wider models run the WMMA / FMA
    kernel (the C entry's rule, read through ``ffn_engine``)."""
    from faster_distributed_training_tpu_torch.ops.fused_ffn import (
        ffn_engine)

    bf16, f32 = torch.bfloat16, torch.float32
    assert [ffn_engine(bf16, f, 512) for f in (None, "int8", "fp8")] == [
        "sm90"] * 3
    assert [ffn_engine(f32, f, 64) for f in (None, "int8", "fp8")] == [
        "wmma", "sm90", "sm90"]
    assert ffn_engine(bf16, None, 528) == ffn_engine(bf16, "int8", 1024) \
        == "wmma"


@pytest.mark.parametrize("fmt", [None, "int8"])
def test_fused_ffn_above_the_wgmma_envelope(card, fmt):
    """d_model 1024 (bf16) routes to the WMMA / FMA kernel by shape: it matches
    the plain version where that kernel's shared memory holds the shape
    (fmt none) and raises naming the bytes where it does not (int8), as
    that kernel always did."""
    from faster_distributed_training_tpu_torch.ops.fused_ffn import (
        _ffn_body_reference, ffn_engine, ffn_fwd_generalized)

    assert ffn_engine(torch.bfloat16, fmt, 1024) == "wmma"
    args = _ffn_inputs(card, 40, 1024, 256, torch.bfloat16)
    scales = torch.tensor([30.0, 300.0, 60.0, 250.0], device="cuda")
    seeds = (0x1234567, 0x89ABCDE, 0, 0, 0)
    if fmt is not None:
        with pytest.raises(ValueError, match="shared memory"):
            ffn_fwd_generalized(*args, seeds, scales, 0.1, 0.1, 1e-6, 1, 1,
                                256, fmt)
        return
    out, amax = ffn_fwd_generalized(*args, seeds, scales, 0.1, 0.1, 1e-6, 1,
                                    1, 256, fmt)
    quant = None if fmt is None else (fmt, *scales.unbind(), None)
    want, want_amax = _ffn_body_reference(
        *args, seeds[0], seeds[1], 0.1, 0.1, 1e-6, quant=quant,
        return_amax=True, plain_gemm=True)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item()
    assert torch.equal(amax, torch.zeros_like(amax))


def test_two_identical_steps_are_bitwise_equal(card):
    """One training step at d_model 64 but the record's batch 16 x seq 512
    (8192 token rows, 100 token ids: every embedding row repeats), run
    twice from the same state, batch and draws on bf16 with
    the flash, fused-FFN and quantized-GEMM kernels: every parameter,
    buffer and optimizer leaf bitwise equal."""
    from faster_distributed_training_tpu_torch.optim import build_optimizer
    from faster_distributed_training_tpu_torch.train.state import (
        create_train_state)
    from faster_distributed_training_tpu_torch.train.steps import (
        make_train_step, step_draws, to_device)

    cfg = cli.TRANSFORMER_DEFAULTS.replace(
        n_layers=1, d_model=64, n_heads=4, d_ff=128, seq_len=512,
        attention="flash", ffn_impl="pallas", quant="int8")
    rng = np.random.default_rng(4)
    mask = (np.arange(512)[None] < rng.integers(64, 513, size=(16, 1))
            ).astype(np.int32)
    batch = to_device({"tokens": (rng.integers(1, 100, size=(16, 512))
                                  * mask).astype(np.int32),
                       "token_types": np.zeros((16, 512), np.int32),
                       "mask": mask,
                       "label": rng.integers(0, 4, size=16).astype(np.int32)},
                      "cuda")
    states = []
    for _ in range(2):
        model = cli.build_model(cfg, vocab_size=100, device="cuda")
        model.init_weights(torch.Generator().manual_seed(3))
        model.cuda()
        tx, _ = build_optimizer(cfg, 10)
        states.append(create_train_state(model, tx, 0))
    draws = step_draws(0, 0, 16, states[0].model.n_dropout_sites(), 0.99)
    step = make_train_step(cfg)
    for st in states:
        step(st, batch, draws)
        step(st, batch, draws)
    torch.cuda.synchronize()
    a, b = states
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    for part in ("v", "z"):
        for k, v in a.opt_state[part].items():
            assert torch.equal(v, b.opt_state[part][k]), (part, k)


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


# -- the ResNet slice: conv + BN, NGD on cuSOLVER, the image step ------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("stride", [1, 2])
def test_fused_conv_bn_card_matches_cpu(card, dtype, tol, stride):
    """``fused_conv_bn`` on cuDNN (channels_last) against the CPU: out,
    mean, var and both gradients, fp32 1e-5 and bf16 2e-2 of max |CPU|;
    one output channel has variance 0."""
    from faster_distributed_training_tpu_torch.ops.conv_bn import (
        fused_conv_bn)

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(stride)
    x = torch.randn(8, 64, 16, 16, generator=gen)
    w = torch.randn(128, 64, 3, 3, generator=gen) * 0.05
    w[0] = 0.0
    g = torch.randn(8, 128, 16 // stride, 16 // stride, generator=gen)
    outs = []
    for dev in ("cpu", "cuda"):
        xd = x.to(dev, dtype).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        wd = w.to(dev, dtype).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        o, m, v = fused_conv_bn(xd, wd, stride, 1)
        dx, dw = torch.autograd.grad(o, (xd, wd), g.to(dev, dtype))
        outs.append([t.detach().float().cpu() for t in (o, m, v, dx, dw)])
    for got, want in zip(outs[1], outs[0]):
        assert _rel_err((got,), (want,)) <= tol


def test_augment_card_is_bitwise_cpu(card):
    """The in-step augment (normalize, zero pad, crop, flip) on the card
    equals the CPU's bitwise: the division by 255 is a true division on
    both (CUDA turns a division by a Python scalar into a multiply by
    its reciprocal)."""
    from faster_distributed_training_tpu_torch.data.augment import (
        augment_batch)

    rng = np.random.default_rng(4)
    x = torch.tensor(rng.integers(0, 256, (64, 32, 32, 3), dtype=np.uint8))
    off = torch.tensor(rng.integers(0, 9, (64, 2)))
    flip = torch.tensor(rng.random(64) < 0.5)
    for train in (True, False):
        want = augment_batch(x, off, flip, train=train)
        got = augment_batch(x.cuda(), off, flip, train=train)
        assert torch.equal(got.cpu(), want), train


def _ngd_case(dev, dtype):
    from faster_distributed_training_tpu_torch.optim.ngd import ScaleByNGD

    # OIHW and (out, in); every axis-state has N >= rank
    shapes = {"conv": (64, 32, 3, 3), "fc": (40, 64)}
    port = ScaleByNGD(layouts={"conv": (2, 3, 1, 0), "fc": (1, 0)},
                      precond_dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    state = port.init({k: torch.zeros(s, device=dev)
                       for k, s in shapes.items()})
    outs = []
    for _ in range(12):
        g = {k: torch.randn(s, generator=gen).to(dev)
             for k, s in shapes.items()}
        outs.append({k: v.cpu() for k, v in port.update(g, state).items()})
    return outs, state


def test_ngd_card_matches_cpu(card):
    """12 NGD steps on the card (cuSOLVER's Jacobi ``eigh``) and the CPU
    (LAPACK), every axis-state with N >= rank: in fp32 the preconditioned
    updates 1e-5 of max |CPU|; in fp64 (``precond_dtype``) the factors,
    sorted d and rho 1e-6 relative and W^T diag(d) W 1e-6 of its max.
    The factors are compared in fp64 because in fp32 a d that is a small
    difference of near-equal eigenvalues (an axis of dim 3 over 6144
    rows) differs by 1e-4 between any two eigensolvers."""
    from faster_distributed_training_tpu_torch.optim.ngd import (
        ngd_invariants)

    torch.backends.cuda.matmul.allow_tf32 = False
    for a, b in zip(_ngd_case("cuda", torch.float32)[0],
                    _ngd_case("cpu", torch.float32)[0]):
        for k in a:
            assert _rel_err((a[k],), (b[k],)) <= 1e-5, k
    (_, s_g), (_, s_c) = (_ngd_case(dev, torch.float64)
                          for dev in ("cuda", "cpu"))
    for key, gc in s_c["groups"].items():
        gg = {n: t.cpu() for n, t in s_g["groups"][key].items()}
        assert _rel_err((gg["d"].sort(dim=1).values,),
                        (gc["d"].sort(dim=1).values,)) <= 1e-6, key
        assert _rel_err((gg["rho"],), (gc["rho"],)) <= 1e-6, key
        assert _rel_err((ngd_invariants(gg["w"], gg["d"]),),
                        (ngd_invariants(gc["w"], gc["d"]),)) <= 1e-6, key


def _resnet_states(n, precision="bf16", bs=32):
    from faster_distributed_training_tpu_torch.optim import (build_optimizer,
                                                             layouts_of)
    from faster_distributed_training_tpu_torch.train.state import (
        create_train_state)

    cfg = cli.RESNET50_DEFAULTS.replace(
        model="resnet18", batch_size=bs, use_ngd=True, meta_learning=True,
        precision=precision)
    torch.backends.cudnn.deterministic = True
    states = []
    for _ in range(n):
        gen = torch.Generator().manual_seed(3)
        model = cli.build_model(cfg).init_weights(gen)
        model.cuda().to(memory_format=torch.channels_last)
        tx, _ = build_optimizer(cfg, 10, layouts=layouts_of(model))
        states.append(create_train_state(
            model, tx, 0, extra={
                k: v.cuda() for k, v in cli.resnet_extra_leaves(
                    cfg, gen).items()}))
    rng = np.random.default_rng(2)
    batch = {"image": torch.tensor(rng.integers(0, 256, (bs, 32, 32, 3),
                                                dtype=np.uint8)).cuda(),
             "label": torch.tensor(rng.integers(0, 10, bs)).cuda()}
    return cfg, states, batch


def test_two_identical_resnet_steps_are_bitwise_equal(card):
    """Two resnet18 NGD + meta-mixup steps (bf16, channels_last, cuDNN
    deterministic), run twice from the same state, batch and draws:
    every parameter, BN statistic, mixup lambda, NGD factor and
    momentum leaf bitwise equal."""
    from faster_distributed_training_tpu_torch.train.state import (
        state_leaves)
    from faster_distributed_training_tpu_torch.train.steps import (
        make_train_step)

    cfg, states, batch = _resnet_states(2)
    step = make_train_step(cfg)
    for st in states:
        step(st, batch)
        step(st, batch)
    torch.cuda.synchronize()
    a, b = (state_leaves(s) for s in states)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_non_update_ngd_step_never_waits_on_the_card(card):
    """A resnet18 NGD step whose factors are not refreshed (t = 11)
    makes no host sync (``set_sync_debug_mode("error")`` raises on one);
    an update step's syncs are eigh's error checks, one a group at
    most."""
    import warnings

    from faster_distributed_training_tpu_torch.train.steps import (
        make_train_step)

    cfg, (state,), batch = _resnet_states(1)
    step = make_train_step(cfg)
    for _ in range(11):                   # init, then updates, warmed up
        step(state, batch)
    torch.cuda.synchronize()
    assert state.opt_state["ngd"]["t"] == 11
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    state.opt_state["ngd"]["t"] = 12
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) <= len(state.opt_state["ngd"]["groups"])


# -- slice 9: seeds on the device, K steps a dispatch, --remat -----------------

def _replay_with_seeds(fn, seed_bufs, values):
    """``fn()`` captured once as a CUDA graph (after a warm-up launch on
    the capture stream) and replayed with each tuple of ``values`` written
    into ``seed_bufs``: the replayed outputs (cloned) a tuple."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    got = []
    for vals in values:
        for buf, v in zip(seed_bufs, vals):
            buf.fill_(v)
        graph.replay()
        got.append(tuple(t.clone() for t in out))
    torch.cuda.synchronize()
    return got


SEEDS3 = (1, 0x9E3779B9, 0xFFFFFFFF)


def test_graph_replayed_kernels_take_changing_seeds(card):
    """Each seed-taking kernel (flash forward, flash backward pair, fused
    FFN plain and int8) captured once and replayed with three seeds
    written to its seed buffer: bitwise equal to eager launches with
    those seeds as Python ints, and three different masks."""
    from faster_distributed_training_tpu_torch.ops.fused_ffn import (
        ffn_fwd, ffn_fwd_generalized)

    q, k, v = _qkv(card, 2, 4, 130, 64, torch.bfloat16)
    mask = _mask(card, 2, 130)
    dout = torch.randn(q.shape, generator=card, device="cuda").to(q.dtype)
    out, lse, lse_lo = flash_attention_stats(q, k, v, mask, 0.1, 7)
    h, ln_s, ln_b, w1, b1, w2, b2 = _ffn_inputs(card, 100, 64, 208,
                                                torch.bfloat16)
    scales = torch.tensor([30.0, 300.0, 60.0, 250.0], device="cuda")
    s1 = torch.zeros((), dtype=torch.int64, device="cuda")
    s2 = torch.zeros((), dtype=torch.int64, device="cuda")
    cases = {
        "flash_fwd": (lambda a, b: (flash_attention(q, k, v, mask, 0.1, a),),
                      1),
        "flash_bwd": (lambda a, b: flash_attention_bwd(
            q, k, v, out, lse, dout, mask, 0.1, a, lse_lo), 1),
        "fused_ffn": (lambda a, b: (ffn_fwd(h, ln_s, ln_b, w1, b1, w2, b2,
                                            a, b, 0.1, 0.1, 1e-6),), 2),
        "fused_ffn_int8": (lambda a, b: ffn_fwd_generalized(
            h, ln_s, ln_b, w1, b1, w2, b2, (a, b, 0, 0, 0), scales, 0.1,
            0.1, 1e-6, 1, 1, 208, "int8"), 2)}
    for name, (fn, n_seeds) in cases.items():
        values = [(sd, sd ^ 0x5555) for sd in SEEDS3]
        got = _replay_with_seeds(lambda: fn(s1, s2), (s1, s2), values)
        for vals, replayed in zip(values, got):
            want = fn(*vals)
            torch.cuda.synchronize()
            for a, b in zip(replayed, want):
                assert torch.equal(a, b), (name, vals)
        firsts = [g[0] for g in got]
        assert not torch.equal(firsts[0], firsts[1]), name
        assert not torch.equal(firsts[1], firsts[2]), name


def _k_run(tmp_path, extra, model="transformer"):
    """A short cli.run_training on the card: the transformer at d_model
    64 (one bucket width, so host groups need no padding) or resnet18 at
    16 images a batch."""
    from faster_distributed_training_tpu_torch.train.state import (
        state_leaves)

    if model == "transformer":
        argv = ["--dataset", "synthetic", "--epoch", "1", "--n_layers", "2",
                "--d_model", "64", "--n_heads", "4", "--d_ff", "128",
                "--seq_len", "64", "--subset_stride", "64", "--bs", "8"]
        defaults = cli.TRANSFORMER_DEFAULTS
    else:
        argv = ["--model", "resnet18", "--dataset", "synthetic", "--bs", "16",
                "--epoch", "1", "--subset_stride", "32", "--optimizer", "sgd",
                "--meta_learning"]
        defaults = cli.RESNET50_DEFAULTS
    argv += ["--log_every", "0", "--no_plot", "--checkpoint_dir",
             str(tmp_path / "_".join(extra or ["k1"])), *extra]
    out = cli.main(argv, defaults=defaults)
    torch.cuda.synchronize()
    return out, state_leaves(out["state"])


@pytest.mark.parametrize("model,extra", [
    ("transformer", ["--steps_per_dispatch", "4"]),
    ("transformer", ["--steps_per_dispatch", "4", "--data_path", "resident"]),
    ("transformer", ["--steps_per_dispatch", "4", "--ffn_impl", "pallas",
                     "--quant", "int8"]),
    ("transformer", ["--steps_per_dispatch", "4", "--remat",
                     "--remat_policy", "attn_out"]),
    ("resnet", ["--steps_per_dispatch", "4"]),
    ("resnet", ["--steps_per_dispatch", "4", "--remat"])],
    ids=["host", "resident", "path_b", "remat_attn_out", "resnet18",
         "resnet18_remat"])
def test_dispatch_k4_matches_k1_bitwise(card, tmp_path, model, extra):
    """K=4 steps a dispatch (graph replays) against the eager K=1 loop
    from the same seeded init and data: every parameter, buffer and
    optimizer leaf bitwise equal, and the graph was replayed.  Under
    ``--remat`` the checkpointed regions (their history and running-stat
    guards, the ``attn_out`` context stash) are captured too."""
    base = [a for a in extra[2:] if a not in ("--data_path", "resident")]
    one, want = _k_run(tmp_path, base, model)
    four, got = _k_run(tmp_path, extra, model)
    assert one["state"].step == four["state"].step >= 8
    disp = four["trainer"].dispatch
    assert disp is not None and sum(disp.replays.values()) >= 4
    assert want.keys() == got.keys()
    for key in want:
        assert torch.equal(want[key], got[key]), key


def test_a_host_sync_inside_capture_raises(card, tmp_path, monkeypatch):
    """A step that reads the card on the host (``.item()``) cannot be
    captured: the run raises at the capture, and nothing re-runs the
    step eagerly in its place."""
    from faster_distributed_training_tpu_torch.train import steps as steps_mod

    real = steps_mod.make_train_step
    calls = []

    def syncing(cfg):
        inner = real(cfg)

        def step(state, batch, draws=None, scalars=None):
            state, m = inner(state, batch, draws, scalars)
            calls.append(float(m["loss"].item()))
            return state, m
        return step

    monkeypatch.setattr(steps_mod, "make_train_step", syncing)
    with pytest.raises(RuntimeError):
        _k_run(tmp_path, ["--steps_per_dispatch", "4"])
    # the warm-up step ran eagerly and the capture raised: one call each
    assert len(calls) == 1


# -- slice 10: the data mesh on the card ---------------------------------------

def test_kernels_at_a_batch_origin_are_bitwise_the_full_rows(card):
    """Rows 1 and 4 (the flash forward with lse, its backward) and rows 7
    and 8 (the fused FFN, plain and int8) at D 64, dropout 0.1, launched
    on the two halves of a batch at b0 = 0 and b0 = B/2: bitwise the
    full launch's rows (the FFN's 64-row blocks divide the half)."""
    from faster_distributed_training_tpu_torch.ops import fused_ffn as ffn

    B, H, L, D, seed, rate = 4, 4, 128, 64, 0x2545F491, 0.1
    q, k, v = _qkv(card, B, H, L, D, torch.bfloat16)
    dout = torch.randn(B, H, L, D, generator=card, device="cuda").to(
        torch.bfloat16)
    mask = _mask(card, B, L)
    full = flash_attention_stats(q, k, v, mask, rate, seed)
    grads = flash_attention_bwd(q, k, v, *full[:2], dout, mask, rate, seed,
                                full[2])
    for b0 in (0, B // 2):
        s = slice(b0, b0 + B // 2)
        got = flash_attention_stats(q[s], k[s], v[s], mask[s], rate, seed,
                                    b0=b0)
        for a, b in zip(got, full):
            assert torch.equal(a, b[s]), b0
        g = flash_attention_bwd(q[s], k[s], v[s], *got[:2], dout[s],
                                mask[s], rate, seed, got[2], b0=b0)
        for a, b in zip(g, grads):
            assert torch.equal(a, b[s]), b0
    d, d_ff = 64, 128
    h = torch.randn(B * L, d, generator=card, device="cuda").to(
        torch.bfloat16)
    ws = [(torch.randn(*shape, generator=card, device="cuda") * 0.1).to(dt)
          for shape, dt in (((d,), torch.float32), ((d,), torch.float32),
                            ((d_ff, d), torch.bfloat16),
                            ((d_ff,), torch.bfloat16),
                            ((d, d_ff), torch.bfloat16),
                            ((d,), torch.bfloat16))]
    scales = torch.tensor([30.0, 300.0, 60.0, 250.0], device="cuda")
    for fmt in (None, "int8"):
        def run(x, b0):
            return ffn.ffn_fwd_generalized(x, *ws, (11, 12, b0, 0, 0), scales,
                                           rate, rate, 1e-6, L, L, d_ff, fmt)
        out, amax = run(h, 0)
        halves = [run(h[b0 * L:(b0 + B // 2) * L], b0)
                  for b0 in (0, B // 2)]
        assert torch.equal(torch.cat([o for o, _ in halves]), out), fmt
        assert torch.equal(torch.maximum(halves[0][1], halves[1][1]), amax)


@pytest.fixture
def nccl_env(monkeypatch):
    """torchrun's variables for a world-1 NCCL group on this host (the
    entry point joins it under ``--distributed``); the group is left
    after the test."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port)),
                 ("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_world1_nccl_step_is_bitwise_the_plain_step(card, tmp_path,
                                                   nccl_env):
    """The entry point under ``--distributed --mesh dp=1`` (world 1 over
    NCCL: every collective of the data mesh runs) against no process
    group: every leaf bitwise equal."""
    import torch.distributed as dist

    one, want = _k_run(tmp_path, [])
    dp1, got = _k_run(tmp_path, ["--distributed", "--mesh", "dp=1"])
    assert dist.is_initialized() and dist.get_backend() == "nccl"
    assert dp1["state"].placement is not None
    assert want.keys() == got.keys()
    for key in want:
        assert torch.equal(want[key], got[key]), key


def test_host_offload_is_bitwise_no_offload(card, tmp_path, nccl_env):
    """``--fsdp --host_offload --offload_opt_state`` at world 1: the
    parameters and optimizer state rest in pinned host memory between
    steps and every leaf ends bitwise equal to the resident run's."""
    from faster_distributed_training_tpu_torch.train.state import (
        state_leaves)

    dp1 = ["--distributed", "--mesh", "fsdp=1", "--fsdp"]
    _, want = _k_run(tmp_path, dp1)
    out, _ = _k_run(tmp_path, dp1 + ["--host_offload",
                                     "--offload_opt_state"])
    pl = out["state"].placement
    assert pl.host and all(b.is_pinned() for b in pl.host.values())
    got = state_leaves(out["state"])
    assert want.keys() == got.keys()
    for key in want:
        assert torch.equal(want[key], got[key]), key


@pytest.mark.parametrize("rows,d,dff_loc", [(r, d, f) for r in (64, 100, 512)
                                            for d in (64, 512)
                                            for f in (128, 512)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fmt", [None, "int8", "fp8"])
def test_fused_ffn_partial_matches_plain(card, rows, d, dff_loc, dtype, fmt):
    """Row 8's tp ``partial`` tile (rank 1 of 2: c0 = d_ff/2, hidden
    dropout at the global columns) against its plain version: the fp32
    GEMM2 product at the tolerances of the full output, two launches
    bitwise.  E4M3's tile is held on the scale the sublayer's output
    reads it at, max |h + plain| (its fp8 ``wgmma`` sums and the hidden
    activation's 3-bit mantissa rounding put 1.1-2.2% of max |plain|
    on the bare product, 0.7-1.2% of max |h + plain|, in
    ``scripts/port_ffn_partial_errors.py``)."""
    from faster_distributed_training_tpu_torch.ops.fused_ffn import (
        _ffn_body_reference, ffn_fwd_generalized)

    args = _ffn_inputs(card, rows, d, dff_loc, dtype)
    scales = torch.tensor([30.0, 300.0, 60.0, 250.0], device="cuda")
    seeds = (0x1234567, 0x89ABCDE, 0, 0, dff_loc)
    run = lambda: ffn_fwd_generalized(  # noqa: E731
        *args, seeds, scales, 0.1, 0.1, 1e-6, 1, 1, 2 * dff_loc, fmt,
        partial=True)
    n0 = ffn_fwd_generalized.partial_launches
    out, amax = run()
    out2, amax2 = run()
    quant = None if fmt is None else (fmt, *scales.unbind(), None)
    want, want_amax = _ffn_body_reference(
        *args, seeds[0], seeds[1], 0.1, 0.1, 1e-6, c0=dff_loc,
        dff_glob=2 * dff_loc, quant=quant, return_amax=True,
        plain_gemm=True, partial=True)
    torch.cuda.synchronize()
    assert ffn_fwd_generalized.partial_launches == n0 + 2
    assert out.dtype == torch.float32 and out.shape == (rows, d)
    assert torch.equal(out, out2) and torch.equal(amax, amax2)
    tol = 2e-2 if dtype == torch.bfloat16 or fmt is not None else 1e-4
    err = (out - want).abs().max().item()
    scale = (args[0].float() + want if fmt == "fp8" else want).abs().max()
    assert err <= tol * scale.item()
    if fmt is not None:
        assert torch.allclose(amax, want_amax, rtol=1e-2, atol=0)


@pytest.mark.parametrize("fmt", [None, "int8", "fp8"])
def test_fused_ffn_partials_sum_to_the_full_launch(card, fmt):
    """The two tp ranks' partial tiles (c0 = 0 and d_ff/2) summed, then
    b2, the connection dropout and the residual, against the full
    launch: 2e-2 of max |full| (bf16 GEMM2 sums split in two); the
    halves' amax_f equal, their amax_a's MAX the full one's (1e-2)."""
    from faster_distributed_training_tpu_torch.ops.dropout import (
        keep_factor_rows)
    from faster_distributed_training_tpu_torch.ops.fused_ffn import (
        ffn_fwd_generalized)

    rows, d, d_ff, rate = 512, 512, 1024, 0.1
    h, ln_s, ln_b, w1, b1, w2, b2 = _ffn_inputs(card, rows, d, d_ff,
                                                torch.bfloat16)
    scales = torch.tensor([30.0, 300.0, 60.0, 250.0], device="cuda")
    seeds = (0x1234567, 0x89ABCDE, 0, 0, 0)
    full, amax = ffn_fwd_generalized(h, ln_s, ln_b, w1, b1, w2, b2, seeds,
                                     scales, rate, rate, 1e-6, 1, 1, d_ff,
                                     fmt)
    half = d_ff // 2
    parts = [ffn_fwd_generalized(
        h, ln_s, ln_b, w1[c:c + half].contiguous(),
        b1[c:c + half].contiguous(), w2[:, c:c + half].contiguous(), b2,
        seeds[:4] + (c,), scales, rate, 0.0, 1e-6, 1, 1, d_ff, fmt,
        partial=True) for c in (0, half)]
    keep = keep_factor_rows(seeds[1], torch.arange(rows, device="cuda"), d,
                            rate)
    got = (h.float() + (parts[0][0] + parts[1][0] + b2.float()) * keep
           ).to(h.dtype)
    err = (got.float() - full.float()).abs().max().item()
    assert err <= 2e-2 * full.float().abs().max().item()
    if fmt is not None:
        assert torch.equal(parts[0][1][0], parts[1][1][0])
        assert torch.allclose(torch.maximum(parts[0][1], parts[1][1]), amax,
                              rtol=1e-2, atol=0)


def test_flash_at_a_head_origin_is_bitwise_the_full_heads(card):
    """Rows 1 and 4 (forward with lse, backward) at D 64, dropout 0.1, on
    the two head halves at h0 = 0 and H/2 (h_glob = H): bitwise the full
    launch's heads (a tp rank's heads)."""
    B, H, L, D, seed, rate = 2, 8, 256, 64, 0x2545F491, 0.1
    q, k, v = _qkv(card, B, H, L, D, torch.bfloat16)
    dout = torch.randn(B, H, L, D, generator=card, device="cuda").to(
        torch.bfloat16)
    mask = _mask(card, B, L)
    full = flash_attention_stats(q, k, v, mask, rate, seed)
    grads = flash_attention_bwd(q, k, v, *full[:2], dout, mask, rate, seed,
                                full[2])
    for h0 in (0, H // 2):
        s = slice(h0, h0 + H // 2)
        got = flash_attention_stats(q[:, s], k[:, s], v[:, s], mask, rate,
                                    seed, h0=h0, h_glob=H)
        for a, b in zip(got, full):
            assert torch.equal(a, b[:, s]), h0
        g = flash_attention_bwd(q[:, s], k[:, s], v[:, s], *got[:2],
                                dout[:, s], mask, rate, seed, got[2], h0=h0,
                                h_glob=H)
        for a, b in zip(g, grads):
            assert torch.equal(a, b[:, s]), h0


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quant_matmul_column_shard_is_bitwise(card, fmt):
    """Row 9 on a tp rank's column shard (qkv's head rows, Dense_0's d_ff
    rows): bitwise the full launch's columns."""
    from faster_distributed_training_tpu_torch.ops.quant import quant_matmul
    from faster_distributed_training_tpu_torch.parallel.sharding import (
        tp_shard)

    for (M, K, N), cut in (((1024, 512, 1536), "heads"),
                           ((1024, 512, 1024), "rows")):
        xq, wq, sx, sw = _quant_operands(card, M, K, N, fmt)
        full = quant_matmul(xq, wq, sx, sw, fmt, torch.bfloat16)
        for r in range(2):
            w_r = tp_shard(wq.view(torch.uint8), cut, r, 2, 8).view(wq.dtype)
            got = quant_matmul(xq, w_r, sx, sw, fmt, torch.bfloat16)
            want = tp_shard(full.T, cut, r, 2, 8).T
            assert torch.equal(got, want), (cut, r)


@pytest.mark.parametrize("rows,d,d_ff", [(r, d, 208 if d == 64 else 1024)
                                         for r in (64, 100, 512)
                                         for d in (64, 512)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fmt", [None, "int8", "fp8"])
def test_fused_ffn_at_sequence_offsets_is_bitwise_the_full_rows(
        card, rows, d, d_ff, dtype, fmt):
    """Rows 7 and 8 on an sp rank's sequence half: ``rows`` = 2 rows of
    length L, launched whole (s0 0, l_loc = l_glob = L) and as the two
    halves of each row (s0 = 0 and L/2, l_loc = L/2, l_glob = L, b0 = 1),
    dropout 0.1 at both sites: each half bitwise the full launch's rows,
    the halves' amax MAX bitwise the full launch's (row 7 through its
    own wrapper)."""
    from faster_distributed_training_tpu_torch.ops.fused_ffn import (
        ffn_fwd, ffn_fwd_generalized)

    B, L = 2, rows // 2
    half = L // 2
    h, *rest = _ffn_inputs(card, rows, d, d_ff, dtype)
    scales = torch.tensor([30.0, 300.0, 60.0, 250.0], device="cuda")

    def run(x, s0, l_loc):
        if fmt is None:
            return ffn_fwd(x, *rest, 0x1234567, 0x89ABCDE, 0.1, 0.1, 1e-6, 1,
                           s0, l_loc, L), None
        return ffn_fwd_generalized(x, *rest, (0x1234567, 0x89ABCDE, 1, s0, 0),
                                   scales, 0.1, 0.1, 1e-6, l_loc, L, d_ff,
                                   fmt)

    full, amax = run(h, 0, L)
    full = full.view(B, L, d)
    amaxes = []
    for s0, n in ((0, half), (half, L - half)):
        part = h.view(B, L, d)[:, s0:s0 + n].reshape(B * n, d).contiguous()
        got, a = run(part, s0, n)
        assert torch.equal(got.view(B, n, d), full[:, s0:s0 + n]), s0
        amaxes.append(a)
    if fmt is not None:
        assert torch.equal(torch.maximum(*amaxes), amax)


class _Hub:
    """The shared slots of two sp ranks that are threads of this
    process."""

    def __init__(self, n):
        import threading

        self.n, self.slots = n, [None] * n
        self.bar = threading.Barrier(n)

    def exchange(self, rank, obj):
        self.slots[rank] = obj
        self.bar.wait()
        out = list(self.slots)
        self.bar.wait()
        return out


def _thread_seq(hub, rank):
    """A ``SequenceGroup`` whose primitives exchange through ``hub``."""
    from faster_distributed_training_tpu_torch.parallel.collectives import (
        SequenceGroup)

    class ThreadSeq(SequenceGroup):
        def _rotate(self, t, shift):
            got = hub.exchange(self.rank, t.clone())
            return got[(self.rank - shift) % self.size].clone()

        def _all_to_all(self, chunks):
            got = hub.exchange(self.rank, [c.clone() for c in chunks])
            return [got[j][self.rank].clone() for j in range(self.size)]

        def _all_gather(self, t):
            return [x.clone() for x in hub.exchange(self.rank, t.clone())]

        def _all_reduce(self, t, op):
            got = hub.exchange(self.rank, t.clone())
            return t.copy_(sum(got[1:], got[0].clone()))

    return ThreadSeq(None, rank, hub.n)


def test_flash_inside_ulysses_is_bitwise_the_one_shard_launch(card):
    """The Ulysses body at sp=2 (two sp ranks as threads of this process,
    their all-to-alls through shared slots) on the card: rows 1 and 4 run
    on each rank's 4 of 8 heads of the whole sequence at h0 = 0 and 4,
    dropout 0.1, a key mask gathered; the ranks' contexts and the
    gradients of their projections, assembled, bitwise the one-shard
    flash launch's."""
    import threading

    from faster_distributed_training_tpu_torch.ops.ulysses_attention import (
        ulysses_attention)

    B, H, L, D, seed, rate = 2, 8, 256, 64, 0x2545F491, 0.1
    qkv = torch.randn(B, L, 3, H, D, generator=card, device="cuda").to(
        torch.bfloat16)
    mask = _mask(card, B, L).reshape(B, L)
    dout = torch.randn(B, H, L, D, generator=card, device="cuda").to(
        torch.bfloat16)
    ref_in = qkv.clone().requires_grad_()
    ref = flash_attention_qkv(ref_in, mask[:, None, None, :], rate, seed,
                              b0=3)
    (ref_g,) = torch.autograd.grad(ref, ref_in, dout)
    hub, n = _Hub(2), L // 2
    got, errs = [None, None], []

    def rank(j):
        try:
            with torch.autograd.set_multithreading_enabled(False):
                sp = _thread_seq(hub, j)
                x = qkv[:, j * n:(j + 1) * n].clone().requires_grad_()
                out = ulysses_attention(x, sp, mask[:, j * n:(j + 1) * n],
                                        dropout_rate=rate, dropout_seed=seed,
                                        b0=3)
                (g,) = torch.autograd.grad(
                    out, x, dout[:, :, j * n:(j + 1) * n].contiguous())
                torch.cuda.synchronize()
                got[j] = (out, g)
        except BaseException as e:     # noqa: BLE001 (re-raised below)
            errs.append(e)
            hub.bar.abort()

    threads = [threading.Thread(target=rank, args=(j,)) for j in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errs, errs
    assert torch.equal(torch.cat([o for o, _ in got], dim=2), ref)
    assert torch.equal(torch.cat([g for _, g in got], dim=1), ref_g)


def test_kernels_at_quarter_batch_origins_are_bitwise_the_full_rows(card):
    """Rows 1 and 4 (the flash forward with lse, its backward) and rows 7
    and 8 (the fused FFN: none, int8, E4M3) at D 64, dropout 0.1, on the
    M = 4 microbatches of a pipeline step (b0 = m·B/4): bitwise the full
    launch's rows, and the microbatches' amax MAX the full launch's."""
    from faster_distributed_training_tpu_torch.ops import fused_ffn as ffn

    B, H, L, D, seed, rate = 8, 4, 128, 64, 0x2545F491, 0.1
    q, k, v = _qkv(card, B, H, L, D, torch.bfloat16)
    dout = torch.randn(B, H, L, D, generator=card, device="cuda").to(
        torch.bfloat16)
    mask = _mask(card, B, L)
    full = flash_attention_stats(q, k, v, mask, rate, seed)
    grads = flash_attention_bwd(q, k, v, *full[:2], dout, mask, rate, seed,
                                full[2])
    mb = B // 4
    for b0 in range(0, B, mb):
        s = slice(b0, b0 + mb)
        got = flash_attention_stats(q[s], k[s], v[s], mask[s], rate, seed,
                                    b0=b0)
        for a, b in zip(got, full):
            assert torch.equal(a, b[s]), b0
        g = flash_attention_bwd(q[s], k[s], v[s], *got[:2], dout[s],
                                mask[s], rate, seed, got[2], b0=b0)
        for a, b in zip(g, grads):
            assert torch.equal(a, b[s]), b0
    d, d_ff = 64, 128
    h = torch.randn(B * L, d, generator=card, device="cuda").to(
        torch.bfloat16)
    ws = [(torch.randn(*shape, generator=card, device="cuda") * 0.1).to(dt)
          for shape, dt in (((d,), torch.float32), ((d,), torch.float32),
                            ((d_ff, d), torch.bfloat16),
                            ((d_ff,), torch.bfloat16),
                            ((d, d_ff), torch.bfloat16),
                            ((d,), torch.bfloat16))]
    scales = torch.tensor([30.0, 300.0, 60.0, 250.0], device="cuda")
    for fmt in (None, "int8", "fp8"):
        def run(x, b0):
            return ffn.ffn_fwd_generalized(x, *ws, (11, 12, b0, 0, 0), scales,
                                           rate, rate, 1e-6, L, L, d_ff, fmt)
        out, amax = run(h, 0)
        parts = [run(h[b0 * L:(b0 + mb) * L], b0) for b0 in range(0, B, mb)]
        assert torch.equal(torch.cat([o for o, _ in parts]), out), fmt
        assert torch.equal(torch.stack([a for _, a in parts]).amax(0),
                           amax), fmt


class _Mailbox:
    """Point-to-point queues between pipeline stages that are threads of
    this process, keyed (source stage, destination stage, tag)."""

    def __init__(self):
        import collections
        import queue
        import threading

        self.lock = threading.Lock()
        self.q = collections.defaultdict(queue.Queue)

    def box(self, key):
        with self.lock:
            return self.q[key]


def _thread_pipe(box, stage, size):
    """A ``PipeGroup`` whose exchange goes through ``box``."""
    from faster_distributed_training_tpu_torch.parallel.collectives import (
        PipeGroup)

    class ThreadPipe(PipeGroup):
        def exchange(self, sends, recvs, shape, dtype, device):
            for st, t, tag in sends:
                box.box((self.stage, st, tag)).put(t.detach().clone())
            return [box.box((st, self.stage, tag)).get(timeout=120)
                    for st, tag in recvs]

    pipe = ThreadPipe(None, stage, size, list(range(size)))
    pipe.live = True
    return pipe


def staged_step_on_threads(device, flags=(), n_stages=2):
    """One staged training step (``pipeline_forward_backward``) of a
    2-layer fp32 classifier (flash, the fused FFN, dropout 0.1, mixup),
    its stages as threads of this process on ``device``, beside the same
    step unstaged: (staged loss, unstaged loss, {name: (staged grad from
    its stage, unstaged grad)})."""
    import copy
    import threading
    import types

    from faster_distributed_training_tpu_torch.parallel.collectives import (
        DataGroup)
    from faster_distributed_training_tpu_torch.parallel.pipeline import (
        build_pipeline_spec)
    from faster_distributed_training_tpu_torch.parallel.sharding import (
        pp_stage_homes)
    from faster_distributed_training_tpu_torch.train import steps

    B, L, vocab = 8, 128, 100
    cfg = cli.config_from_args(cli.build_parser(
        defaults=cli.TRANSFORMER_DEFAULTS).parse_args(
        ["--n_layers", "2", "--d_model", "64", "--n_heads", "4", "--d_ff",
         "128", "--bs", str(B), "--seq_len", str(L), "--precision", "fp32",
         "--attention", "flash", "--ffn_impl", "pallas", "--pp_microbatches",
         "4", *flags]), defaults=cli.TRANSFORMER_DEFAULTS)
    gen = torch.Generator().manual_seed(3)
    model = cli.build_model(cfg, vocab_size=vocab, device=device)
    model.init_weights(gen).to(device)
    rng = np.random.default_rng(4)
    lengths = rng.integers(L // 4, L + 1, B)
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int32)
    tokens = rng.integers(1, vocab, (B, L)).astype(np.int32) * mask
    batch = steps.to_device({"tokens": tokens, "token_types": 0 * tokens,
                             "mask": mask,
                             "label": rng.integers(0, 4, B).astype(np.int32)},
                            device)
    draws = steps.step_draws(0, 0, B, model.n_dropout_sites(), 0.99)
    spec = build_pipeline_spec(cfg, n_stages)
    homes = pp_stage_homes(list(model.state_dict()), spec)
    box, out, errs = _Mailbox(), [None] * n_stages, []

    def stage(s, m):
        try:
            pl = types.SimpleNamespace(
                spec=spec, pipe=_thread_pipe(box, s, n_stages),
                group=DataGroup(), own=lambda k: True, pp_wait=[])
            state = types.SimpleNamespace(model=m, placement=pl)
            out[s] = steps.pipeline_forward_backward(state, batch, draws,
                                                     False)
            if device.type == "cuda":
                torch.cuda.synchronize()
        except BaseException as e:     # noqa: BLE001 (re-raised below)
            errs.append(e)

    copies = [copy.deepcopy(model) for _ in range(n_stages)]
    threads = [threading.Thread(target=stage, args=(s, copies[s]))
               for s in range(n_stages)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not errs, errs
    loss, grads, *_ = steps.loss_and_grads(model, batch, draws)
    pairs = {}
    for k, g in grads.items():
        home = homes.get(k)
        staged = (sum(out[s][1][k] for s in range(n_stages)) if home is None
                  else out[home][1][k])
        pairs[k] = (staged, g)
    return float(out[-1][0].detach()), float(loss.detach()), pairs


def test_staged_step_on_two_threads_matches_world_1(card):
    """A 2-layer fp32 step at pp=2, M = 4 (flash and the fused FFN at each
    microbatch's origin, dropout 0.1, mixup), its two stages as threads
    on the card: the loss 1e-6 and every gradient (a shared leaf's summed
    over the stages) 1e-5 of its max against the unstaged step's."""
    staged, plain, pairs = staged_step_on_threads(torch.device("cuda"))
    assert abs(staged - plain) <= 1e-6
    for k, (a, b) in pairs.items():
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * max(scale, 1e-12), k


def _decode_lm(device, precision, tied=True, vocab=100, seq=64):
    """A small LM served on ``device`` (seeded random weights through the
    JAX-layout tree, the real load path) and its config."""
    from faster_distributed_training_tpu_torch.config import TrainConfig
    from faster_distributed_training_tpu_torch.serve import (
        load_serving_state)

    cfg = TrainConfig(model="transformer", task="lm", n_layers=2,
                      d_model=64, n_heads=4, d_ff=128, seq_len=seq,
                      seq_buckets=(16, 32, 64), precision=precision,
                      tie_lm_head=tied, decode_page=16, device=device)
    m = cli.build_model(cfg, vocab_size=vocab, device="cpu")
    m.init_weights(torch.Generator().manual_seed(0))
    tree = {"params": {"model": params_to_jax(m.state_dict(), 4)}}
    model, _, _ = load_serving_state(cfg, torch.device(device), params=tree,
                                     log=lambda s: None)
    return model, cfg


def test_decode_graph_replay_is_bitwise_the_eager_step(card):
    """At three page counts, from the same cache and operands (bf16): the
    replay of the warmup's graph and the eager ``decode_step`` give the
    same next tokens and the same cache columns, bitwise; nothing is
    captured after warmup."""
    from faster_distributed_training_tpu_torch.models.decode import (
        decode_step)
    from faster_distributed_training_tpu_torch.serve.decode import (
        DecodeEngine)

    model, _ = _decode_lm("cuda", "bf16")
    eng = DecodeEngine(model, (16, 32, 64), batch_size=4, page=16)
    eng.warmup()
    assert eng.captures == eng.max_pages == len(eng.graphs) == 4
    rng = np.random.default_rng(0)
    for pages in (1, 2, 4):
        cap = pages * 16
        k0 = torch.randn(eng.cache.k.shape, generator=card, device="cuda"
                         ).to(torch.bfloat16)
        v0 = torch.randn_like(k0.float()).to(torch.bfloat16)
        pos = rng.integers(max(cap - 16, 0), cap, size=4)
        ops = torch.tensor(np.stack([rng.integers(1, 100, 4), pos,
                                     [1, 1, 0, 1], rng.integers(0, 50, 4)]),
                           dtype=torch.int64, device="cuda")
        eng.cache.k.copy_(k0)
        eng.cache.v.copy_(v0)
        with torch.no_grad():
            eager = decode_step(model, eng.spec, eng.sampling, cap,
                                eng.cache.k, eng.cache.v, ops[0], ops[1],
                                ops[2].bool(), ops[3])
        ke, ve = eng.cache.k.clone(), eng.cache.v.clone()
        eng.cache.k.copy_(k0)
        eng.cache.v.copy_(v0)
        eng._ops.copy_(ops)
        eng.graphs[pages].replay()
        torch.cuda.synchronize()
        assert torch.equal(eng._next, eager)
        assert torch.equal(eng.cache.k, ke) and torch.equal(eng.cache.v, ve)
        assert not torch.equal(ke, k0)
    assert eng.captures == 4


def test_cached_attention_on_the_card_matches_the_cpu(card):
    from faster_distributed_training_tpu_torch.ops.cached_attention import (
        cached_attention)

    B, H, C, D = 4, 8, 96, 64
    q, k, v = (torch.randn(B, H, n, D, generator=card, device="cuda")
               for n in (1, C, C))
    lengths = torch.tensor([1, 17, 64, 96], device="cuda")
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        args = [t.to(dtype) for t in (q, k, v)]
        got = cached_attention(*args, lengths).float().cpu()
        want = cached_attention(*(t.cpu() for t in args), lengths.cpu())
        assert (got - want.float()).abs().max().item() <= tol


def test_decode_engine_greedy_tokens_on_the_card_match_the_cpu(card):
    """fp32: the card's engine (CUDA graphs) and the CPU's (eager) give
    the same greedy tokens for a ragged mix; a bucket's prefill logits
    agree to 1e-4 of max |CPU|."""
    from faster_distributed_training_tpu_torch.serve import RequestQueue
    from faster_distributed_training_tpu_torch.serve.decode import (
        DecodeEngine, DecodeScheduler)

    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 100, size=n).astype(np.int32)
               for n in (5, 20, 33, 64, 9, 12)]
    outs, probes = {}, {}
    for dev in ("cpu", "cuda"):
        model, _ = _decode_lm(dev, "fp32")
        eng = DecodeEngine(model, (16, 32, 64), batch_size=4, page=16)
        eng.warmup()
        probes[dev] = eng.prefill_logits(prompts[2], 64)
        q = RequestQueue((16, 32, 64), max_len=64)
        sched = DecodeScheduler(q, eng, max_new_tokens=12)
        sched.start()
        try:
            hs = [q.submit(p, max_new_tokens=12) for p in prompts]
            outs[dev] = [h.wait(timeout=120.0).tolist() for h in hs]
        finally:
            q.close()
            sched.close()
        assert eng.captures == (eng.max_pages if dev == "cuda" else 0)
    assert outs["cuda"] == outs["cpu"]
    err = np.abs(probes["cuda"] - probes["cpu"]).max()
    assert err <= 1e-4 * np.abs(probes["cpu"]).max()


# -- resilience (slice 15) ---------------------------------------------------

def _committed_leaves(ckdir):
    """{step: leaves} of every committed step checkpoint (``state.pt``)."""
    import os

    from faster_distributed_training_tpu_torch.train import checkpoint as ck

    out = {}
    for step, name in ck.series_members(str(ckdir), "transformer_step"):
        payload = torch.load(os.path.join(str(ckdir), name, "state.pt"),
                             map_location="cpu", weights_only=True)
        out[step] = ck._flat(payload)[0]
    return out


def test_k4_snapshot_is_bitwise_the_live_state(card, tmp_path, monkeypatch):
    """``--steps_per_dispatch 4 --checkpoint_every 4`` (asynchronous
    saves): every committed checkpoint equals the live state at its
    dispatch boundary, read from the uninterrupted run, bitwise; the
    snapshot finished before the next dispatch updated the tensors."""
    from faster_distributed_training_tpu_torch.train import checkpoint as ck
    from faster_distributed_training_tpu_torch.train import dispatch as dmod

    at = {}
    real = dmod.FusedDispatch.run

    def run(self, state, kk, *a, **k):
        out = real(self, state, kk, *a, **k)
        at[int(state.step)] = {n: t.detach().to("cpu", copy=True) for n, t in
                               ck._flat(ck.state_payload(state))[0].items()}
        return out
    monkeypatch.setattr(dmod.FusedDispatch, "run", run)
    _k_run(tmp_path, ["--steps_per_dispatch", "4"])
    monkeypatch.setattr(dmod.FusedDispatch, "run", real)
    out, _ = _k_run(tmp_path, ["--steps_per_dispatch", "4",
                               "--checkpoint_every", "4"])
    got = _committed_leaves(out["cfg"].checkpoint_dir)
    assert got and sum(out["trainer"].dispatch.replays.values()) >= 4
    for step, leaves in got.items():
        assert leaves.keys() == at[step].keys()
        for name in leaves:
            assert torch.equal(leaves[name], at[step][name]), (step, name)


def test_in_process_restart_under_a_captured_graph(card, tmp_path,
                                                   monkeypatch):
    """``--supervise`` with ``FDT_FAULT_DIE_AT_STEP=6`` at K=4: the restore
    copies into the tensors the captured graph reads, so the restarted
    attempt replays the same graph (none captured again) and ends bitwise
    the uninterrupted run."""
    from faster_distributed_training_tpu_torch.resilience import faults

    _, want = _k_run(tmp_path, ["--steps_per_dispatch", "4"])
    monkeypatch.setenv(faults.ENV_DIE, "6")
    out, got = _k_run(tmp_path, ["--steps_per_dispatch", "4",
                                 "--checkpoint_every", "4", "--supervise"])
    disp = out["trainer"].dispatch
    assert out["goodput_restarts"] == 1 and len(disp.graphs) == 1
    assert want.keys() == got.keys()
    for key in want:
        assert torch.equal(want[key], got[key]), key


def test_nan_guard_inside_the_graph(card, tmp_path, monkeypatch):
    """``--sentinel guard`` with ``FDT_FAULT_NAN_AT_STEP=2``: the NaN
    compares the device step inside the replayed graph, the step is
    skipped there, and K=4 ends bitwise K=1."""
    from faster_distributed_training_tpu_torch.resilience import faults

    monkeypatch.setenv(faults.ENV_NAN, "2")
    one, want = _k_run(tmp_path, ["--sentinel", "guard"])
    four, got = _k_run(tmp_path, ["--sentinel", "guard",
                                  "--steps_per_dispatch", "4"])
    assert one["goodput_skipped_steps"] == four["goodput_skipped_steps"] == 1
    assert sum(four["trainer"].dispatch.replays.values()) >= 4
    assert want.keys() == got.keys()
    for key in want:
        assert torch.equal(want[key], got[key]), key


# -- slice 17: the stream window and the sharded resident view on the card ----

def _lm_corpus(root):
    """A tiny LM corpus (seq 64) written by the port's shard writer."""
    from faster_distributed_training_tpu_torch.data.stream import shard

    shard.main(["--out", str(root / "corpus"), "--source", "synthetic",
                "--seq_len", "64", "--n_docs", "200", "--rows_per_shard",
                "24", "--data_dir", str(root / "dd")], log=lambda _: None)
    return str(root / "corpus")


def _lm_k_run(root, corpus, extra):
    from faster_distributed_training_tpu_torch.train.state import (
        state_leaves)

    argv = ["--task", "lm", "--dataset", "stream", "--stream_dir", corpus,
            "--epoch", "2", "--n_layers", "2", "--d_model", "64",
            "--n_heads", "4", "--d_ff", "128", "--bs", "8",
            "--steps_per_dispatch", "4", "--log_every", "0", "--no_plot",
            "--checkpoint_dir", str(root / "_".join(extra)), *extra]
    out = cli.main(argv, defaults=cli.TRANSFORMER_DEFAULTS)
    torch.cuda.synchronize()
    return out, state_leaves(out["state"])


def test_stream_k4_replays_are_bitwise_the_resident_replays(card, tmp_path):
    """--data_path stream at K=4, W=4 (each window one dispatch: the
    refill of one slot runs on the side stream while the replays read
    the other) over two epochs against --data_path resident at K=4: every
    parameter, buffer and optimizer leaf bitwise equal; one graph served
    both slots; every refill was copied on the side stream."""
    corpus = _lm_corpus(tmp_path)
    res, want = _lm_k_run(tmp_path, corpus, ["--data_path", "resident"])
    out, got = _lm_k_run(tmp_path, corpus, ["--data_path", "stream",
                                            "--stream_window", "4"])
    src = out["stream"]
    disp = out["trainer"].dispatch
    assert src.cuda and src.refills >= 6
    assert list(disp.graphs) == [("stream",)]
    assert disp.replays[("stream",)] >= 4 * (src.refills - 2)
    assert src.h2d_device_ms > 0 and src.h2d_bytes > 0
    assert out["state"].step == res["state"].step
    assert want.keys() == got.keys()
    for key in want:
        assert torch.equal(want[key], got[key]), key


def test_stream_slots_and_pinned_staging_are_reused(card, tmp_path):
    """Every refill writes the same two slots through the same pinned
    staging (their addresses never change), and each slot handed out
    holds exactly ``host_buffer``'s bytes for its batches."""
    from faster_distributed_training_tpu_torch.data.stream import (
        DiskStreamSource, ShardedStreamDataset)

    corpus = _lm_corpus(tmp_path)
    src = DiskStreamSource(ShardedStreamDataset(f"{corpus}/train"), 8,
                           device="cuda", window_batches=3, max_len=64)
    slots = {k: t.data_ptr() for k, t in src.slots.items()}
    staging = {k: t.data_ptr() for k, t in src.staging.items()}
    assert all(t.is_pinned() for t in src.staging.values())
    for epoch in (0, 1):
        order = src.epoch_order(epoch)
        win = src.epoch_window(epoch)
        try:
            for n in range(src.steps_per_epoch):
                base, hi, slot = win.buffer_for(n)
                if n == base:
                    want = src.host_buffer(order, base, hi)
                    torch.cuda.current_stream().synchronize()
                    for k, t in src.slots.items():
                        assert t[slot].cpu().numpy().tobytes() == \
                            want[k].tobytes(), (k, base)
        finally:
            win.close()
    assert {k: t.data_ptr() for k, t in src.slots.items()} == slots
    assert {k: t.data_ptr() for k, t in src.staging.items()} == staging
    assert src.refills == 2 * -(-src.steps_per_epoch // 3)


def test_sharded_resident_k4_is_bitwise_the_replicated(card, tmp_path):
    """--resident_layout sharded in one process (the view rebuilt in
    place each epoch, read by the captured graph at row n) against the
    replicated layout, K=4: bitwise."""
    _, want = _k_run(tmp_path, ["--steps_per_dispatch", "4", "--data_path",
                                "resident", "--resident_layout",
                                "replicated", "--epoch", "2"])
    out, got = _k_run(tmp_path, ["--steps_per_dispatch", "4", "--data_path",
                                 "resident", "--resident_layout", "sharded",
                                 "--epoch", "2"])
    src = out["trainer"].dispatch.resident
    assert type(src).__name__ == "ShardedDeviceResidentData"
    assert len(src.reshard_ms) == 2
    for key in want:
        assert torch.equal(want[key], got[key]), key


def test_profiler_window_captures_a_hand_kernel(card, tmp_path):
    """``utils.profiling.StepWindowProfiler`` (the default
    ``TorchTrace``) around a launch of the flash forward: the exported
    trace names ``flash_fwd_kernel_sm90`` beside the ``fdt/`` label, and
    the capture counts its device events."""
    import json
    import os

    from faster_distributed_training_tpu_torch.telemetry import spans
    from faster_distributed_training_tpu_torch.utils.profiling import (
        StepWindowProfiler)

    q, k, v = _qkv(card, 2, 4, 128, 64, torch.bfloat16)
    prof = StepWindowProfiler(str(tmp_path / "w"), 1, 1,
                              log=lambda *_: None)
    prof.before_dispatch(0, 1)
    with spans.span("probe"):
        out = flash_attention(q, k, v)
    prof.after_dispatch(1, fence=lambda: float(out.float().sum()))
    assert prof.done and prof.device_events > 0
    with open(os.path.join(str(tmp_path / "w"), "trace.json")) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("flash_fwd_kernel_sm90" in n for n in names)
    assert "fdt/probe" in names


def test_memory_watermarks_on_the_card(card):
    """``memory_watermarks`` / ``peak_memory_bytes`` read the allocator
    on the card (not None), peak >= in use."""
    from faster_distributed_training_tpu_torch.utils.profiling import (
        memory_watermarks, peak_memory_bytes)

    x = torch.empty(1 << 20, device="cuda")
    got = memory_watermarks()
    assert got is not None and got["bytes_in_use"] >= x.numel() * 4
    assert got["peak_bytes"] >= got["bytes_in_use"]
    assert peak_memory_bytes("cuda") == got["peak_bytes"]


# -- the program table and the executable cache (slice 19) ----------------

def test_program_table_k4_graph_row_on_the_card(card, tmp_path):
    """A K=4 tiny run: one ``train:host:k4`` row (its warm-up the
    lower_ms, its capture the compile_ms), its ``replays`` equal to the
    dispatch's, the graph pool's growth ``temp_bytes`` > 0, and
    ``compiled_memory_bytes`` positive."""
    import json
    import os

    from faster_distributed_training_tpu_torch.config import TrainConfig
    from faster_distributed_training_tpu_torch.utils.profiling import (
        compiled_memory_bytes)

    cfg = TrainConfig(model="transformer", dataset="synthetic",
                      num_classes=4, batch_size=8, seq_len=16, n_layers=1,
                      d_model=16, d_ff=32, n_heads=2, epochs=2,
                      subset_stride=64, optimizer="sgd", precision="fp32",
                      plot=False, workers=0, log_every=0, device="cuda",
                      steps_per_dispatch=4, checkpoint_dir=str(tmp_path))
    out = cli.run_training(cfg, log=lambda *_: None)
    with open(os.path.join(out["telemetry_dir"], "manifest.json")) as f:
        table = json.load(f)["compile"]
    rows = {p["name"]: p for p in table["programs"]}
    disp = out["trainer"].dispatch
    k4 = rows["train:host:k4"]
    assert k4["lowerings"] == 1 and len(disp.graphs) == 1
    v = k4["variants"][0]
    assert v["replays"] == sum(disp.replays.values()) > 0
    assert v["temp_bytes"] > 0 and v["lower_ms"] > 0 and v["compile_ms"] > 0
    assert v["alias_bytes"] > 0 and compiled_memory_bytes(v) > 0
    assert rows["eval"]["lowerings"] == 1 and table["retraces"] == []


_TIERS = r"""
import json, os, subprocess, sys
sys.path.insert(0, sys.argv[1])
from faster_distributed_training_tpu_torch.ops import _build
from faster_distributed_training_tpu_torch.resilience.executable_cache \
    import ExecutableCache
from faster_distributed_training_tpu_torch.runtime import native_lib
from faster_distributed_training_tpu_torch.telemetry import programs

assert _build.__file__.startswith(sys.argv[1]), _build.__file__
builds = []
real = subprocess.Popen.__init__

def guard(self, args, *a, **kw):
    argv = [str(x) for x in (args if isinstance(args, (list, tuple))
                             else [args])]
    if (os.path.basename(argv[0]) in ("nvcc", "g++")
            and "--version" not in argv):
        builds.append(argv[0])
    return real(self, args, *a, **kw)

subprocess.Popen.__init__ = guard
obs = programs.ProgramObservatory(log=lambda *_: None)
obs.executable_cache = ExecutableCache(sys.argv[2], log=lambda *_: None)
programs.set_observatory(obs)
for name in _build.KERNELS:
    _build.load(name)
assert native_lib.load() is not None, native_lib.failure()
print(json.dumps({"rows": {n: e[0]["cache_source"]
                           for n, e in obs.programs.items()},
                  "stats": obs.executable_cache.stats, "builds": builds}))
"""


def test_build_tiers_on_a_copy_of_the_package(card, tmp_path):
    """``ops/_build.py::acquire`` on two copies of the package: with the
    built ``_build/`` each library is ``persistent_dir`` and stored; a
    copy without it loads every library ``deserialized`` from the same
    cache, starting no nvcc or g++ build; a ``lib:*`` row for each."""
    import json
    import os
    import shutil
    import subprocess
    import sys

    from faster_distributed_training_tpu_torch.ops import _build
    from faster_distributed_training_tpu_torch.runtime import native_lib

    _build.build()
    assert native_lib.load() is not None
    pkg = os.path.dirname(os.path.dirname(_build.__file__))
    want = {f"lib:{n}" for n in _build.KERNELS} | {"lib:fdt_native"}
    got = []
    for tag, keep in (("warm", True), ("fresh", False)):
        root = tmp_path / tag
        shutil.copytree(pkg, root / os.path.basename(pkg), ignore=(
            None if keep else shutil.ignore_patterns("_build")))
        proc = subprocess.run(
            [sys.executable, "-c", _TIERS, str(root), str(tmp_path / "c")],
            capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        got.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    warm, fresh = got
    assert warm["rows"] == {n: "persistent_dir" for n in want}
    assert warm["stats"]["stores"] == len(want)
    assert fresh["rows"] == {n: "deserialized" for n in want}
    assert fresh["stats"]["hits"] == len(want) and fresh["builds"] == []
