"""Carry Transformer and ResNet weights between the JAX package and the
port.

The JAX model's parameter tree (nested dicts of arrays, as ``model.init``
returns under ``"params"``) maps onto the port's ``state_dict``:

    Embeddings_0/{token,pos,segment}_embedding  -> embeddings.*
    layer_i/ln_attn, ln_ffn /{scale,bias}        -> layers.i.ln_*.*
    layer_i/attn/qkv/kernel (d, 3, H, d_k)       -> layers.i.attn.qkv.weight
                                                    (3*H*d_k, d)
    layer_i/attn/qkv/bias (3, H, d_k)            -> ....qkv.bias (3*H*d_k,)
    layer_i/attn/out, ffn/Dense_{0,1}, pooler,   -> nn.Linear: kernels are
    lm_head (the untied LM head)                    (in, out), transposed
    ln_final/{scale,bias}                        -> ln_final.*
    cls_w1 (d_hidden, d), cls_w2 (n_class, d_hidden), cls_b1 (1, d_hidden),
    cls_b2 (1, n_class)                          -> the same, unchanged

The next-token LM (``--task lm``) has no pooler and no classifier; its
tied head is the token table and adds no leaf.

Under ``--quant`` the JAX ``batch_stats`` tree holds the amax histories,
``layer_i/attn/{qkv,out}/amax_history_{x,w}`` and
``layer_i/ffn/Dense_{0,1}/amax_history_{x,w}``; they map onto the port's
``QuantDense`` buffers ``layers.i.attn.qkv.amax_history_x`` and so on
(``batch_stats_to_jax`` / the ``batch_stats`` argument of
``params_from_jax``).  Parameters and statistics stay in separate trees,
as in the JAX variables.

A ResNet's flax tree maps onto the port's ``state_dict`` by its path
(the port's modules carry flax's auto names, ``BottleNeck_3/ConvBN_1/
BatchNorm_0/scale`` -> ``BottleNeck_3.ConvBN_1.BatchNorm_0.scale``):
conv kernels HWIO -> OIHW, ``fc_kernel`` (in, out) -> (out, in), and the
``batch_stats`` tree's ``mean`` / ``var`` onto the running-stat buffers
(``resnet_from_jax`` / ``resnet_to_jax``).

Under tensor parallelism a rank's model holds its tp shards:
``tp_state_dict`` cuts a whole ``state_dict`` (JAX's, through
``params_from_jax``) to rank r's shards by the tp rules
(``parallel.sharding.tp_cut``), and ``load_jax_tree`` does so for a
model built with a tp group.

Arrays cross as numpy (the tests hand the same arrays to both packages);
nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_LINEARS = (("attn/qkv", "attn.qkv"), ("attn/out", "attn.out"),
            ("ffn/Dense_0", "ffn.Dense_0"), ("ffn/Dense_1", "ffn.Dense_1"))
_NORMS = ("ln_attn", "ln_ffn")
_CLS = ("cls_w1", "cls_b1", "cls_w2", "cls_b2")
_EMB = ("token_embedding", "pos_embedding", "segment_embedding")
_HISTS = ("amax_history_x", "amax_history_w")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def model_tree(tree: Mapping[str, Any]) -> Mapping[str, Any]:
    """The model's own parameter tree from any of the layouts the JAX side
    hands out: the full variables (``{"params": {"model": ...}}``, what
    the serving engine reads), the train-state params (``{"model": ...}``)
    or the model tree itself."""
    if "params" in tree:
        tree = tree["params"]
    if "model" in tree:
        tree = tree["model"]
    return tree


def stats_tree(tree: Mapping[str, Any]) -> Mapping[str, Any]:
    """The ``batch_stats`` tree of a JAX variables bundle ({} if none)."""
    stats = tree.get("batch_stats", {}) if isinstance(tree, Mapping) else {}
    return stats.get("model", stats)


def params_from_jax(tree: Mapping[str, Any],
                    batch_stats: Optional[Mapping[str, Any]] = None
                    ) -> Dict[str, torch.Tensor]:
    """The port's fp32 ``state_dict`` for a JAX Transformer tree; with
    ``batch_stats`` also the amax histories it holds."""
    sd = _params_from_jax(tree)
    for path, hist in flatten(batch_stats or {}).items():
        *mods, leaf = path.split("/")
        if leaf not in _HISTS or not mods[0].startswith("layer_"):
            raise ValueError(f"batch_stats/{path}: not an amax history of "
                             f"the Transformer")
        sd[".".join(["layers", mods[0][len("layer_"):], *mods[1:], leaf])
           ] = _t(hist)
    return sd


def _params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    tree = model_tree(tree)
    sd = {f"embeddings.{n}": _t(tree["Embeddings_0"][n]) for n in _EMB}
    i = 0
    while f"layer_{i}" in tree:
        lay, pre = tree[f"layer_{i}"], f"layers.{i}."
        for ln in _NORMS:
            sd[pre + ln + ".scale"] = _t(lay[ln]["scale"])
            sd[pre + ln + ".bias"] = _t(lay[ln]["bias"])
        for jpath, tname in _LINEARS:
            a, b = jpath.split("/")
            kernel = np.asarray(lay[a][b]["kernel"], np.float32)
            sd[pre + tname + ".weight"] = _t(
                kernel.reshape(kernel.shape[0], -1).T)
            sd[pre + tname + ".bias"] = _t(
                np.asarray(lay[a][b]["bias"]).reshape(-1))
        i += 1
    sd["ln_final.scale"] = _t(tree["ln_final"]["scale"])
    sd["ln_final.bias"] = _t(tree["ln_final"]["bias"])
    # the classifier's head, or the LM's: an untied lm_head Dense, or
    # nothing at all (tied to the token table)
    for head in ("pooler", "lm_head"):
        if head in tree:
            sd[f"{head}.weight"] = _t(np.asarray(tree[head]["kernel"]).T)
            sd[f"{head}.bias"] = _t(tree[head]["bias"])
    for n in _CLS:
        if n in tree:
            sd[n] = _t(tree[n])
    return sd


def params_to_jax(sd: Mapping[str, torch.Tensor], n_heads: int
                  ) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: a JAX-layout tree of fp32
    numpy arrays from the port's ``state_dict``."""
    tree: Dict[str, Any] = {
        "Embeddings_0": {n: _np(sd[f"embeddings.{n}"]) for n in _EMB}}
    i = 0
    while f"layers.{i}.ln_attn.scale" in sd:
        pre, lay = f"layers.{i}.", {}
        for ln in _NORMS:
            lay[ln] = {"scale": _np(sd[pre + ln + ".scale"]),
                       "bias": _np(sd[pre + ln + ".bias"])}
        for jpath, tname in _LINEARS:
            a, b = jpath.split("/")
            w = _np(sd[pre + tname + ".weight"]).T
            bias = _np(sd[pre + tname + ".bias"])
            if b == "qkv":
                d_k = w.shape[1] // (3 * n_heads)
                w = w.reshape(w.shape[0], 3, n_heads, d_k)
                bias = bias.reshape(3, n_heads, d_k)
            lay.setdefault(a, {})[b] = {"kernel": np.ascontiguousarray(w),
                                        "bias": bias}
        tree[f"layer_{i}"] = lay
        i += 1
    tree["ln_final"] = {"scale": _np(sd["ln_final.scale"]),
                        "bias": _np(sd["ln_final.bias"])}
    for head in ("pooler", "lm_head"):
        if f"{head}.weight" in sd:
            tree[head] = {"kernel": np.ascontiguousarray(
                _np(sd[f"{head}.weight"]).T), "bias": _np(sd[f"{head}.bias"])}
    for n in _CLS:
        if n in sd:
            tree[n] = _np(sd[n])
    return tree


def batch_stats_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The JAX ``batch_stats`` tree (fp32 numpy) of the port's amax
    history buffers; {} for an unquantized model."""
    flat = {}
    for key, t in sd.items():
        parts = key.split(".")
        if parts[-1] in _HISTS and parts[0] == "layers":
            flat["/".join([f"layer_{parts[1]}", *parts[2:]])] = _np(t)
    return unflatten(flat)


def _resnet_leaf_from_jax(path: str, a) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    if path.endswith("kernel") and a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)          # HWIO -> OIHW
    elif path == "fc_kernel":
        a = a.T                              # (in, out) -> (out, in)
    return _t(np.ascontiguousarray(a))


def resnet_from_jax(tree: Mapping[str, Any],
                    batch_stats: Optional[Mapping[str, Any]] = None
                    ) -> Dict[str, torch.Tensor]:
    """The port's fp32 ResNet ``state_dict`` for a flax ResNet tree and,
    when given, its ``batch_stats`` (the running statistics)."""
    sd = {}
    for src in (model_tree(tree), batch_stats or {}):
        for path, a in flatten(src).items():
            sd[path.replace("/", ".")] = _resnet_leaf_from_jax(path, a)
    return sd


def resnet_to_jax(sd: Mapping[str, torch.Tensor]):
    """The inverse of :func:`resnet_from_jax`: ``(params, batch_stats)``,
    flax-layout trees of fp32 numpy arrays."""
    params, stats = {}, {}
    for key, t in sd.items():
        path, a = key.replace(".", "/"), _np(t)
        if path.endswith("kernel") and a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)      # OIHW -> HWIO
        elif path == "fc_kernel":
            a = a.T
        leaf = path.rsplit("/", 1)[-1]
        (stats if leaf in ("mean", "var") else params)[path] = (
            np.ascontiguousarray(a))
    return unflatten(params), unflatten(stats)


def tp_state_dict(sd: Mapping[str, torch.Tensor], rank: int, n: int,
                  n_heads: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s shards, of ``n``, of a whole Transformer
    ``state_dict`` (replicated leaves unchanged)."""
    from faster_distributed_training_tpu_torch.parallel.sharding import (
        tp_cut, tp_shard)

    return {k: tp_shard(v, tp_cut(k), rank, n, n_heads)
            for k, v in sd.items()}


def load_jax_tree(model: torch.nn.Module, tree: Mapping[str, Any]) -> None:
    """Load a JAX parameter tree (and the ``batch_stats`` of a variables
    bundle, when it has them) into ``model``; a model built with a tp
    group takes its rank's shards.  Histories the tree lacks stay as they
    are (fresh zeros); anything else missing raises.  A ResNet's tree
    must hold every leaf, its running statistics included."""
    from faster_distributed_training_tpu_torch.models.resnet import ResNet

    if isinstance(model, ResNet):
        model.load_state_dict(resnet_from_jax(tree, stats_tree(tree)))
        return
    sd = params_from_jax(tree, stats_tree(tree))
    tp = getattr(model, "tp", None)
    if tp is not None:
        sd = tp_state_dict(sd, tp.rank, tp.size, model.h)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    bad = [k for k in missing if k.rsplit(".", 1)[-1] not in _HISTS]
    if bad or unexpected:
        raise KeyError(f"JAX tree does not fit the model: missing {bad}, "
                       f"unexpected {list(unexpected)}")


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> {"a/b/c": leaf} (the ``.npz`` key layout)."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """{"a/b/c": leaf} -> nested dicts."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree
