"""Stateless hash dropout: the FastDropout engine of the JAX package.

Counterpart of ``faster_distributed_training_tpu/ops/dropout.py``: the
keep decision for element ``i`` of a tensor is one murmur3 32-bit
finalizer over ``seed ^ i`` whose top 16 bits are compared with a
threshold on the 1/65536 grid.  The mask is a pure function of
(seed, index), so the backward (a ``torch.autograd.Function``) saves only
the seed and regenerates the mask.  The survivor scale ``GRID / t`` (the
realized keep probability) multiplies in fp32 with one final cast to the
activation dtype.

This is not ``ops.attention.dropout_keep`` (the chained u32-threshold
hash of the attention probabilities); the two streams are separate.

The JAX package let XLA fuse this into the surrounding elementwise work;
there is no TPU kernel here, so the port is plain PyTorch.  CPU torch has
no uint32 shift, so the hash runs in int64 masked to 32 bits after every
product and sum (the u32 arithmetic of the JAX version wraps modulo 2^32).
"""

from __future__ import annotations

import numpy as np
import torch

from faster_distributed_training_tpu_torch.ops.attention import (
    _M32, _fmix32, seed_u32)

_GRID = 1 << 16          # keep-prob quantization grid
_INDEX_CEILING = 1 << 32


def guard_index_ceiling(n_elements: int, site: str = "hash dropout") -> None:
    """Raise when a mask stream would address more than 2^32 global
    elements (the uint32 index would wrap and distant positions share
    mask bits)."""
    if int(n_elements) > _INDEX_CEILING:
        raise ValueError(
            f"{site}: {int(n_elements)} global elements exceed the uint32 "
            f"index ceiling (2^32) of the stateless hash-dropout stream; "
            f"reduce the activation size or set the site's rate to 0")


def _thresh_u16(rate: float) -> int:
    """Keep iff (hash >> 16) < t; realized keep prob = t / 65536."""
    return max(min(int(round((1.0 - rate) * _GRID)), _GRID), 0)


def realized_rate(rate: float) -> float:
    """The drop probability hash_dropout actually applies."""
    return 1.0 - min(_thresh_u16(rate), _GRID) / _GRID


def keep_factor_rows(seed, global_rows, cols: int, rate: float, col0=0,
                     cols_glob: int = 0) -> torch.Tensor:
    """fp32 {0, GRID/t} keep factors [rows, cols] for a tile whose rows
    have GLOBAL ids ``global_rows``: element (r, c) keeps iff the top 16
    bits of ``fmix(seed ^ (global_rows[r] * width + col0 + c))`` clear
    the threshold, with width = ``cols_glob`` or ``cols``.  ``seed``: a
    Python int or a one-element integer tensor (on the tile's device)."""
    t = _thresh_u16(rate)
    rows_t = torch.as_tensor(global_rows).reshape(-1).to(torch.int64)
    rows = rows_t.shape[0]
    if t <= 0:
        return torch.zeros((rows, cols), dtype=torch.float32,
                           device=rows_t.device)
    width = int(cols_glob) if cols_glob else cols
    c = torch.arange(cols, dtype=torch.int64, device=rows_t.device)
    idx = ((rows_t & _M32)[:, None] * width) & _M32
    idx = (idx + (int(col0) & _M32) + c[None, :]) & _M32
    h16 = _fmix32(seed_u32(seed) ^ idx) >> 16
    inv = float(np.float32(_GRID / t))
    return (h16 < t).to(torch.float32) * inv


def _keep_factor(seed, shape, rate: float, offset: int = 0, col0: int = 0,
                 cols_glob: int = 0, s0: int = 0, l_glob: int = 0,
                 device=None) -> torch.Tensor:
    """0 or 1/realized_keep per element, shaped like the input, always
    fp32.  Element (r, c) of the rows (the leading dims flattened) draws
    the stream word of global element ``offset + r * width + col0 + c``,
    width = ``cols_glob`` or the last dim: without a column shard,
    element i draws the word of ``offset + i``.  With ``l_glob`` the rows
    are a sequence shard (``shape`` [..., L_loc, cols]): local row ``b *
    L_loc + i`` is global row ``b * l_glob + s0 + i``."""
    cols = int(shape[-1]) if len(shape) else 1
    rows = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    width = int(cols_glob) or cols
    r = torch.arange(rows, dtype=torch.int64, device=device)
    last = rows - 1
    if l_glob:
        l_loc = int(shape[-2])
        r = (r // l_loc) * int(l_glob) + int(s0) + r % l_loc
        last = (last // l_loc) * int(l_glob) + int(s0) + last % l_loc
    guard_index_ceiling(int(offset) + last * width + int(col0) + cols)
    return keep_factor_rows(seed, r, cols, rate, int(offset) + int(col0),
                            width).reshape(shape)


def _scale(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """x * factor computed in fp32, one rounding back to x.dtype."""
    return (x.float() * factor).to(x.dtype)


class _HashDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed: int, rate: float, where: tuple):
        # residual: the seed only; the mask is regenerated in backward
        ctx.args = (seed, rate, where)
        return _scale(x, _keep_factor(seed, x.shape, rate, *where,
                                      device=x.device))

    @staticmethod
    def backward(ctx, g):
        seed, rate, where = ctx.args
        return (_scale(g, _keep_factor(seed, g.shape, rate, *where,
                                       device=g.device)), None, None, None)


def hash_dropout(x: torch.Tensor, seed, rate: float,
                 deterministic: bool = False, offset: int = 0,
                 col0: int = 0, cols_glob: int = 0, s0: int = 0,
                 l_glob: int = 0) -> torch.Tensor:
    """Stateless hash dropout.  seed: a uint32 (one fresh value per site
    per step), a Python int or a one-element integer tensor (a device
    tensor is never read back to the host); rate: python float in [0, 1];
    offset: the global element index where this tensor's first row
    starts.  Element (r, c) of its rows (the leading dims flattened)
    draws the word of global element ``offset + r * width + col0 + c``,
    width = ``cols_glob`` or x's last dim: by default element i draws
    ``offset + i``; a tp rank's column shard (its columns ``col0 ..`` of
    a last dim ``cols_glob`` wide) draws the global array's words.  An sp
    rank's sequence shard (x [B, L_loc, cols], its positions ``s0 ..`` of
    ``l_glob``) does too: local row ``b * L_loc + i`` is global row ``b *
    l_glob + s0 + i``."""
    if deterministic or rate <= 0.0:
        return x
    t = _thresh_u16(rate)
    if t >= _GRID:     # rate below half a grid step: keep everything
        return x
    if t <= 0:         # rate above 1 - half a grid step: drop everything
        return torch.zeros_like(x)
    return _HashDropout.apply(x, seed_u32(seed), float(rate),
                              (int(offset), int(col0), int(cols_glob),
                               int(s0), int(l_glob)))
