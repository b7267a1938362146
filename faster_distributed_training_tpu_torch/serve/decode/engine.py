"""DecodeEngine: prefill per prompt and a CUDA graph a page count.

Port of ``faster_distributed_training_tpu/serve/decode/engine.py``.  The
JAX engine compiles two program families ahead of time: a prefill per
prompt bucket and a decode step per page count.  Here:

  * prefill runs eagerly at batch 1 for a prompt padded to its bucket
    (``models/decode.py::prefill``), and its K/V are copied into the
    slot's first columns;
  * the decode step over the whole slot batch is captured at
    :meth:`DecodeEngine.warmup` as one CUDA graph a page count
    ``1..max_pages``, each with the attention window sliced statically to
    ``pages · page`` columns.  The graphs share the cache's storage (the
    step writes it in place) and one graph memory pool.  A step copies
    its operands (token, pos, active, request ids) into static device
    buffers in one host-to-device copy, replays the graph of its page
    count, and brings the next tokens back in one device-to-host copy.
    Nothing is captured after warmup: a page count without a graph
    raises.

A decode step is some 150 small launches for one token a slot, so on the
card the host's launch cost is the step's; the graph replays them as one.
On the CPU the same ``decode_step`` runs eagerly.

Each bucket's first prefill is the program table's
``{name}:prefill:L{bucket}`` row and each captured graph its
``{name}:decode:P{pages}`` row (``telemetry/programs.py``: the two eager
runs before the captures are the ``lower_ms`` of the widest); on the CPU,
with an observatory active, warmup runs the eager step once a page count
for those rows.  JAX's ``:insert:L{bucket}`` program is not observed in
JAX either (its engine passes it no name).

Request length picks a bucket (``data.loader.select_bucket``) and the
longest live slot picks a page count, both finite sets, so ragged
traffic never needs a shape the warmup did not see.
"""

from __future__ import annotations

import collections
import contextlib
import math
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from faster_distributed_training_tpu_torch.models.decode import (
    SamplingCfg, decode_spec, decode_step, prefill)
from faster_distributed_training_tpu_torch.serve.decode.cache import (
    PagedKVCache)
from faster_distributed_training_tpu_torch.telemetry import programs


class DecodeEngine:
    """Paged-KV-cache generation over one LM on the device its parameters
    live on (a model from ``serve.engine.load_serving_state``)."""

    def __init__(self, model, buckets: Sequence[int], batch_size: int = 4,
                 page: int = 16, max_pages: int = 0,
                 sampling: Optional[SamplingCfg] = None,
                 name: str = "serve"):
        self.model = model
        self.spec = decode_spec(model)
        self.device = model.embeddings.token_embedding.device
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        self.batch_size = int(batch_size)
        self.page = int(page)
        if max_pages <= 0:
            # room for the longest prompt bucket plus a page of
            # generation, capped by the position table
            max_pages = math.ceil(
                min(max(self.buckets) + page, self.spec.maxlen) / page)
        self.max_pages = int(max_pages)
        if max(self.buckets) > self.page * self.max_pages:
            raise ValueError(
                f"largest bucket {max(self.buckets)} exceeds the cache "
                f"capacity {self.page * self.max_pages} "
                f"(= page {self.page} x max_pages {self.max_pages})")
        self.sampling = sampling or SamplingCfg()
        self.name = name
        self.cache = PagedKVCache(self.spec, self.batch_size, self.page,
                                  self.max_pages, self.device)
        self.steps = 0
        self.prefills = 0
        self.page_counts: collections.Counter = collections.Counter()
        # the card's decode graphs by page count, and how many captures
        # ran (all of them in warmup)
        self.graphs: Dict[int, torch.cuda.CUDAGraph] = {}
        self.captures = 0
        # the buckets whose first prefill the program table has, and
        # whether it has the decode rows
        self._prefilled: set = set()
        self._decode_rows = False
        self.on_card = self.device.type == "cuda"
        if self.on_card:
            B = self.batch_size
            # rows: token, pos, active, request id
            self._ops_host = torch.zeros((4, B), dtype=torch.int64
                                         ).pin_memory()
            self._ops = torch.zeros((4, B), dtype=torch.int64,
                                    device=self.device)
            self._next_host = torch.zeros(B, dtype=torch.int64).pin_memory()
            self._next = torch.zeros(B, dtype=torch.int64,
                                     device=self.device)

    def _ctx(self):
        stack = contextlib.ExitStack()
        stack.enter_context(torch.no_grad())
        if self.on_card:
            stack.enter_context(torch.cuda.device(self.device))
        return stack

    # -- warmup ------------------------------------------------------------

    def _graph_body(self, pages: int) -> None:
        """The step a graph holds: the static operands in, the next
        tokens into the static output, the cache written in place."""
        token, pos, active, req = self._ops
        self._next.copy_(decode_step(
            self.model, self.spec, self.sampling, pages * self.page,
            self.cache.k, self.cache.v, token, pos, active.bool(), req))

    def warmup(self) -> float:
        """Before any request: one prefill a bucket (cuBLAS handles and
        the allocator's growth), and on the card the capture of every
        page count's decode graph.  Returns wall seconds."""
        t0 = time.monotonic()
        with self._ctx():
            for b in self.buckets:
                self._prefill(np.zeros((1, b), np.int64), 1, 0)
            obs = programs.get_observatory()
            if self.on_card and not self.graphs:
                self._capture(obs)
            elif not self.on_card and obs is not None and \
                    not self._decode_rows:
                self._eager_rows(obs)
        return time.monotonic() - t0

    def _decode_sig(self) -> tuple:
        z = torch.zeros(self.batch_size, dtype=torch.int64)
        return programs.args_signature((z, z, z.bool(), z), (0, 1, 2, 3))

    def _observe_decode(self, obs, pages: int, watch, lower_ms: float,
                        compile_ms: float) -> None:
        cache = programs.tensor_bytes(self.cache.k, self.cache.v)
        params = programs.tensor_bytes(dict(self.model.named_parameters()))
        obs.observe(f"{self.name}:decode:P{pages}", self._decode_sig(),
                    lower_ms, compile_ms, mem=watch.memory(
                        argument=params + cache + 4 * 8 * self.batch_size,
                        output=8 * self.batch_size, alias=cache),
                    replays=((lambda: self.page_counts.get(pages, 0))
                             if self.on_card else None))

    def _eager_rows(self, obs) -> None:
        """The CPU's decode rows: the eager step once a page count (zero
        operands: every slot's column 0 is written, which no admission
        reads)."""
        self._decode_rows = True
        z = torch.zeros(self.batch_size, dtype=torch.int64,
                        device=self.device)
        for pages in range(1, self.max_pages + 1):
            watch = programs.Stopwatch(self.device)
            decode_step(self.model, self.spec, self.sampling,
                        pages * self.page, self.cache.k, self.cache.v, z, z,
                        z.bool(), z)
            self._observe_decode(obs, pages, watch, 0.0, watch.ms())

    def _capture(self, obs) -> None:
        warm = programs.Stopwatch(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            # eager runs before capture (the operands are zeros: every
            # slot's column 0 is written, which no admission reads)
            for _ in range(2):
                self._graph_body(self.max_pages)
        torch.cuda.current_stream(self.device).wait_stream(side)
        warm_ms = warm.ms()
        pool = torch.cuda.graph_pool_handle()
        for pages in range(1, self.max_pages + 1):
            watch = programs.Stopwatch(self.device, pool)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                self._graph_body(pages)
            self.graphs[pages] = graph
            self.captures += 1
            if obs is not None:
                # the eager warm-up ran at the widest page count
                self._observe_decode(
                    obs, pages, watch,
                    warm_ms if pages == self.max_pages else 0.0, watch.ms())
        torch.cuda.synchronize(self.device)

    # -- the hot path ------------------------------------------------------

    def _prefill(self, padded: np.ndarray, length: int, req_id: int):
        dev = self.device
        bucket = padded.shape[1]
        obs, watch = programs.get_observatory(), None
        if obs is not None and bucket not in self._prefilled:
            self._prefilled.add(bucket)
            watch = programs.Stopwatch(dev)
        args = (torch.as_tensor(padded, dtype=torch.int64).to(dev),
                torch.tensor([length], dtype=torch.int64, device=dev),
                torch.tensor([req_id], dtype=torch.int64, device=dev))
        out = prefill(self.model, self.spec, self.sampling, *args)
        if watch is not None:
            obs.observe(f"{self.name}:prefill:L{bucket}",
                        programs.args_signature(args, (0, 1, 2)),
                        compile_ms=watch.ms(), mem=watch.memory(
                            argument=programs.tensor_bytes(
                                dict(self.model.named_parameters()), args),
                            output=programs.tensor_bytes(out)))
        return out

    @staticmethod
    def _pad(tokens, bucket: int) -> Tuple[np.ndarray, int]:
        t = np.asarray(tokens, np.int64).reshape(-1)[:bucket]
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :len(t)] = t
        return padded, max(len(t), 1)

    def admit(self, tokens: np.ndarray, bucket: int,
              req_id: int) -> Tuple[int, int]:
        """Prefill one prompt and copy its K/V into a free slot.  Returns
        (slot, first token).  The caller makes sure a slot is free."""
        slot = self.cache.free_slot()
        if slot is None:
            raise RuntimeError("admit called with no free slot")
        padded, length = self._pad(tokens, bucket)
        with self._ctx():
            pk, pv, _logits, first = self._prefill(padded, length, req_id)
            self.cache.k[:, slot, :, :bucket] = pk[:, 0]
            self.cache.v[:, slot, :, :bucket] = pv[:, 0]
            first_token = int(first[0])
        self.cache.admit(slot, req_id, length, first_token)
        self.prefills += 1
        return slot, first_token

    def prefill_logits(self, tokens: np.ndarray, bucket: int) -> np.ndarray:
        """The [vocab] fp32 logits at the prompt's last position, the
        parity probe (the cache is not touched)."""
        padded, length = self._pad(tokens, bucket)
        with self._ctx():
            _pk, _pv, logits, _first = self._prefill(padded, length, 0)
            return logits[0].cpu().numpy()

    def step(self) -> Tuple[np.ndarray, int]:
        """One decode step over every slot.  Returns (next tokens [batch]
        int32, pages); callers read the tokens of active slots only.  The
        slot table advances."""
        cache = self.cache
        pages = cache.window_pages()
        pos = cache.lengths.copy()           # the column this step writes
        pos[~cache.active] = 0
        with self._ctx():
            if self.on_card:
                graph = self.graphs.get(pages)
                if graph is None:
                    raise RuntimeError(
                        f"{self.name}: no decode graph for {pages} page(s); "
                        f"warmup() captures 1..{self.max_pages} before the "
                        f"first step")
                ops = self._ops_host.numpy()
                ops[0], ops[1] = cache.tokens, pos
                ops[2], ops[3] = cache.active, cache.req_ids
                self._ops.copy_(self._ops_host, non_blocking=True)
                graph.replay()
                self._next_host.copy_(self._next, non_blocking=True)
                torch.cuda.current_stream(self.device).synchronize()
                nxt = self._next_host.numpy().astype(np.int32)
            else:
                def t(a):
                    return torch.from_numpy(np.asarray(a, np.int64))
                nxt = decode_step(
                    self.model, self.spec, self.sampling, pages * self.page,
                    cache.k, cache.v, t(cache.tokens), t(pos),
                    torch.from_numpy(cache.active.copy()),
                    t(cache.req_ids)).numpy().astype(np.int32)
        cache.advance(nxt)
        self.steps += 1
        self.page_counts[pages] += 1
        return nxt, pages

    def active_count(self) -> int:
        return int(self.cache.active.sum())
