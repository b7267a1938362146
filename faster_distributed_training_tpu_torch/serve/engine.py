"""Inference engine: frozen weights, one warm-up batch per bucket.

Port of ``faster_distributed_training_tpu/serve/engine.py``.  The
serving step does not reuse any training machinery:

  * **weights are frozen** — :class:`ServingState` carries the weights
    and no optimizer state; the model runs ``train=False`` under
    ``torch.inference_mode``;
  * **one program shape per bucket** — every batch is padded to
    (batch_size, bucket), so the kernels and cuBLAS see a fixed set of
    shapes; :meth:`InferenceEngine.warmup` runs one batch per bucket
    before the queue opens (kernel builds, cuBLAS handles and the
    allocator's growth happen there, never under a request);
  * **per-row independence** — no operation mixes rows, and every
    kernel reduces in a fixed order, so a request's logits are bitwise
    the same whatever shares its batch.

Checkpoints: :func:`load_serving_state` reads the JAX parameter tree
from an ``.npz`` of flat "a/b/c" paths (or takes it in memory) through
``interop.load_jax_tree``, with the ``--quant`` amax histories of its
``batch_stats`` frozen in the serving build.  Reading the JAX package's Orbax
checkpoints comes with the checkpoint slice.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class ServingState:
    """The serving-side state bundle: the weights (a ``state_dict``) and
    the step they were trained to; no optimizer state exists."""

    def __init__(self, params: Dict[str, torch.Tensor], step: int = 0):
        self.params = params
        self.step = int(step)


def pad_batch(requests: Sequence, bucket: int, batch_size: int,
              pad_id: int = 0) -> Tuple[Dict[str, np.ndarray], int]:
    """Assemble a (batch_size, bucket) batch from <= batch_size
    requests; returns (batch, n_real).  Rows past n_real are PAD rows:
    copies of row 0 (a real request, so the model only sees
    in-distribution rows) whose outputs the scheduler drops."""
    if not requests:
        raise ValueError("pad_batch needs at least one request")
    if len(requests) > batch_size:
        raise ValueError(f"{len(requests)} requests > batch_size "
                         f"{batch_size}")
    tokens = np.full((batch_size, bucket), pad_id, np.int32)
    mask = np.zeros((batch_size, bucket), np.int32)
    for i, req in enumerate(requests):
        t = np.asarray(req.tokens, np.int32)[:bucket]
        tokens[i, :len(t)] = t
        mask[i, :len(t)] = 1
    n_real = len(requests)
    for i in range(n_real, batch_size):
        tokens[i] = tokens[0]
        mask[i] = mask[0]
    return {"tokens": tokens, "token_types": np.zeros_like(tokens),
            "mask": mask}, n_real


class InferenceEngine:
    """Batched predict over one frozen model on one device."""

    def __init__(self, model: torch.nn.Module, batch_size: int,
                 buckets: Sequence[int], device: torch.device,
                 name: str = "serve"):
        self.batch_size = int(batch_size)
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        self.name = name
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.calls = 0

    def _dummy_batch(self, bucket: int) -> Dict[str, np.ndarray]:
        z = np.zeros((self.batch_size, bucket), np.int32)
        return {"tokens": z, "token_types": z, "mask": np.ones_like(z)}

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> float:
        """One batch per bucket BEFORE the queue opens, so no request
        (and no replica heartbeat) ever waits on a first-call cost.
        Returns wall seconds."""
        t0 = time.monotonic()
        for b in (buckets if buckets is not None else self.buckets):
            self.predict_batch(self._dummy_batch(int(b)))
        return time.monotonic() - t0

    def predict_batch(self, batch: Dict[str, Any]) -> np.ndarray:
        """fp32 logits [batch_size, n_class] for one assembled batch.
        Runs on a replica worker thread: inference mode is thread-local,
        so it is entered here, inside the call."""
        tokens = batch["tokens"]
        bs, _ = tokens.shape
        if bs != self.batch_size:
            raise ValueError(f"batch rows {bs} != engine batch_size "
                             f"{self.batch_size} (the scheduler pads)")

        def put(name):
            return torch.from_numpy(np.ascontiguousarray(
                batch[name], np.int64)).to(self.device)

        with torch.inference_mode():
            logits = self.model(put("tokens"), token_types=put("token_types"),
                                mask=put("mask"), train=False)
            out = logits.float().cpu().numpy()
        self.calls += 1
        return out


def load_serving_state(cfg, device: torch.device, params=None,
                       path: Optional[str] = None,
                       log: Callable[[str], None] = print
                       ) -> Tuple[torch.nn.Module, ServingState, dict]:
    """(model on ``device``, ServingState, meta).

    ``params``: a JAX-layout parameter tree (nested dicts of arrays, in
    any layout ``interop.model_tree`` accepts, with the ``--quant`` amax
    histories under a ``batch_stats`` key).  Without it the tree is read
    from ``path`` (default ``<checkpoint_dir>/transformer_params.npz``),
    an ``.npz`` whose keys are the flat "a/b/c" paths (``interop.flatten``;
    the histories under ``batch_stats/...``).  The model comes from
    ``cli.build_model(serving=True)``: GEMM weights stored in the compute
    dtype, rounded once here as the JAX model rounds them at every call,
    and under ``--quant`` the scales frozen at the histories' values.  A
    ``--task lm`` tree (the decode tier's) holds a tied head (no
    ``lm_head`` leaf) or an untied ``lm_head``, as ``--untie_lm_head``
    says."""
    from faster_distributed_training_tpu_torch.cli import build_model
    from faster_distributed_training_tpu_torch.interop import (
        load_jax_tree, model_tree, unflatten)

    if cfg.model != "transformer":
        raise ValueError(f"serving is wired for the transformer text "
                         f"workload; got model={cfg.model!r}")
    if params is None:
        path = path or os.path.join(cfg.checkpoint_dir,
                                    "transformer_params.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no serveable parameters at {path!r}: the port reads an "
                f".npz of flat JAX parameter paths (interop.flatten); "
                f"Orbax checkpoints come with the checkpoint slice")
        with np.load(path) as z:
            params = unflatten({k: z[k] for k in z.files})
        log(f"[serve] loaded parameters from {path}")
    tree = model_tree(params)
    vocab = int(np.shape(tree["Embeddings_0"]["token_embedding"])[0])
    untied = "lm_head" in tree
    if cfg.task == "lm" and untied == bool(cfg.tie_lm_head):
        raise ValueError(
            f"the LM parameters hold {'an untied' if untied else 'a tied'} "
            f"head but the config asks for "
            f"{'a tied' if cfg.tie_lm_head else 'an untied'} one: "
            f"{'pass' if untied else 'drop'} --untie_lm_head")
    model = build_model(cfg, vocab_size=vocab, serving=True,
                        device=torch.device(device))
    load_jax_tree(model, params)
    model = model.to(device).eval()
    state = ServingState(params=model.state_dict())
    return model, state, {"vocab": vocab, "step": state.step}
