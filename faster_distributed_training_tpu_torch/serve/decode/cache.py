"""Paged KV cache: fixed device tensors plus the host slot table.

Port of ``faster_distributed_training_tpu/serve/decode/cache.py``.  One
cache serves one decode batch of ``batch_size`` slots.  The K and V
tensors are allocated once, at the whole capacity (``max_pages · page``
columns), so every decode-step graph (one a page count,
``serve/decode/engine.py``) writes the same storage in place.  "Paging"
is about the attention window, not the allocation: a step reads the first
``pages · page`` columns, ``pages`` the fewest covering the longest
active slot, so its cost follows the live sequences while the set of
graphs stays the ``max_pages`` enumerated ones.

The slot table is host numpy: lengths, current tokens, request ids,
active flags.  The scheduler changes it between steps (admit / evict),
and the engine reads it into each step's operands.  A freed slot's
columns are not zeroed: the length mask of ``ops/cached_attention.py``
hides them, and the next admission's prefill overwrites the prefix it
needs.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch


class PagedKVCache:
    """K/V tensors [n_layers, batch, heads, max_pages·page, d_k] on
    ``device``, in the spec's compute dtype, plus the host slot table."""

    def __init__(self, spec, batch_size: int, page: int, max_pages: int,
                 device=None):
        if page < 1 or max_pages < 1:
            raise ValueError(f"page {page} / max_pages {max_pages} must "
                             f"be >= 1")
        self.spec = spec
        self.batch_size = int(batch_size)
        self.page = int(page)
        self.max_pages = int(max_pages)
        self.capacity = self.page * self.max_pages
        shape = (spec.n_layers, self.batch_size, spec.h, self.capacity,
                 spec.d_k)
        self.k = torch.zeros(shape, dtype=spec.dtype, device=device)
        self.v = torch.zeros(shape, dtype=spec.dtype, device=device)
        B = self.batch_size
        self.lengths = np.zeros((B,), np.int32)    # valid cache columns
        self.tokens = np.zeros((B,), np.int32)     # token AT lengths - 1
        self.req_ids = np.zeros((B,), np.int32)
        self.active = np.zeros((B,), bool)

    @property
    def nbytes(self) -> int:
        """Device bytes of the K and V tensors."""
        return 2 * self.k.numel() * self.k.element_size()

    # -- slot management (host side, between steps) ------------------------

    def free_slot(self) -> Optional[int]:
        idle = np.flatnonzero(~self.active)
        return int(idle[0]) if len(idle) else None

    def active_slots(self) -> List[int]:
        return [int(i) for i in np.flatnonzero(self.active)]

    def admit(self, slot: int, req_id: int, prompt_len: int,
              first_token: int) -> None:
        """Claim ``slot`` for a prefilled request: ``prompt_len`` columns
        are valid and ``first_token`` (sampled off the prefill logits) is
        the token the next decode step consumes."""
        if self.active[slot]:
            raise RuntimeError(f"slot {slot} is already active")
        if prompt_len > self.capacity:
            raise ValueError(f"prompt of {prompt_len} exceeds cache "
                             f"capacity {self.capacity}")
        self.lengths[slot] = int(prompt_len)
        self.tokens[slot] = int(first_token)
        self.req_ids[slot] = int(req_id)
        self.active[slot] = True

    def evict(self, slot: int) -> None:
        self.active[slot] = False
        self.lengths[slot] = 0
        self.tokens[slot] = 0
        self.req_ids[slot] = 0

    def advance(self, next_tokens: np.ndarray) -> None:
        """Commit one decode step: every active slot consumed its token
        (column ``lengths`` was written) and sampled the next."""
        act = self.active
        self.lengths[act] += 1
        self.tokens[act] = next_tokens[act]

    # -- window accounting -------------------------------------------------

    def window_pages(self) -> int:
        """The fewest pages whose window covers every active slot through
        the next step's write (column ``lengths``, 0-based, so lengths + 1
        columns must show)."""
        if not self.active.any():
            return 1
        need = int(self.lengths[self.active].max()) + 1
        return min(self.max_pages, max(1, math.ceil(need / self.page)))

    def slot_pages(self, slot: int) -> int:
        """Pages the slot's live prefix occupies."""
        return max(1, math.ceil(int(self.lengths[slot]) / self.page))

    def headroom(self, slot: int) -> int:
        """Generated tokens the slot can still take before the cache (or
        the model's position table) runs out."""
        cap = min(self.capacity, self.spec.maxlen)
        return cap - int(self.lengths[slot])
