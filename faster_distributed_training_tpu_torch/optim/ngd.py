"""Online natural-gradient descent (the JAX package's ``optim/ngd.py``).

Per parameter tensor and per axis, a rank-R-plus-identity approximation
of that axis's Fisher matrix,

    F_t ≈ W_t^T diag(d_t) W_t + rho_t I          (dim x dim, R << dim)

preconditions the gradient (approximately by F_t^{-1}), which is then
rescaled to keep the raw gradient's norm.  In the first 10 steps and then
every ``update_period`` steps the factors are refreshed from the current
directions by an (R, R) symmetric eigendecomposition, on the device.
Hyperparameters: alpha 4, rank min((dim+1)//2, 80), update period 4,
eta 0.1, epsilon 1e-10, delta 5e-4; axes of dim 1 or above ``max_dim``
are left alone.

Axes are preconditioned in sequence, axis 0 then 1 and so on, and the
result depends on that order.  The order is the JAX layout's: a conv
kernel's (H, W, I, O) and the fc kernel's (in, out), whereas the port
stores them OIHW and (out, in).  ``NGD`` takes each leaf's permutation to
the JAX layout (``layouts``), builds its plan on JAX-order shapes and
preconditions permuted views.

Same-shaped axis-states of a round form a group (the grouped plan,
default): their factors are stacked ``(G, rank, dim)`` and every step of
the core is one batched op over the group.  ``grouped=False`` runs each
axis-state alone (the reference's shape); the math per state is the
same.  Every scalar stays on the device: the NaN fallback is a
``torch.where``.  The update gate reads the host ``int`` counter ``t``,
which the state carries and a checkpoint saves; it never reads a device
tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

EPSILON = 1.0e-10
DELTA = 5.0e-4
NUM_INITIAL_ITERS = 10  # always update during the first 10 steps

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class NGDHyperParams:
    alpha: float = 4.0
    rank: int = -1          # -1 -> min((dim+1)//2, 80) per axis
    update_period: int = 4
    eta: float = 0.1
    max_dim: int = 8192     # larger axes (vocab tables) stay identity


def _default_rank(dim: int, rank: int) -> int:
    if rank > 0:
        return min(rank, dim - 1)
    return min((dim + 1) // 2, 80)


def _orthonormal_special(rank: int, dim: int) -> np.ndarray:
    """The deterministic near-orthonormal (rank, dim) start matrix."""
    first_elem = 1.1
    num_cols = dim // rank
    remainder = dim % rank
    k = np.full((rank,), 1.0 / np.sqrt(first_elem * first_elem + num_cols - 1))
    k[:remainder] = 1.0 / np.sqrt(first_elem * first_elem + num_cols)
    diag = np.diag(k)
    return np.concatenate([np.diag(k * first_elem)]
                          + [diag] * (num_cols + 1), axis=1)[:, :dim]


def init_ng_state(dim: int, rank: int, hp: NGDHyperParams,
                  dtype=torch.float32, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The default (w, d, rho) of one axis-state; the data-dependent
    warm-up runs at the first precondition call."""
    e_tii = 1.0 / (2.0 + (dim + rank) * hp.alpha / dim)
    w0 = np.sqrt(e_tii) * _orthonormal_special(rank, dim)
    return (torch.as_tensor(w0, dtype=dtype, device=device),
            torch.full((rank,), EPSILON, dtype=dtype, device=device),
            torch.tensor(EPSILON, dtype=dtype, device=device))


def _core_step(w, d, rho, x, tr_xxt, updating: bool, hp: NGDHyperParams):
    """One preconditioning step on a group: ``x`` (G, N, dim), factors
    ``w`` (G, rank, dim), ``d`` (G, rank), ``rho`` (G,), ``tr_xxt``
    (G,).  Returns ((w', d', rho'), x_hat)."""
    n_rows, dim = x.shape[1], x.shape[2]
    rank = w.shape[1]
    alpha, eta = hp.alpha, hp.eta
    eta_n = eta / n_rows
    wt = w.transpose(1, 2)
    h = torch.bmm(x, wt)                           # H_t = X_t W_t^T
    x_hat = x - torch.bmm(h, w)                    # X_t - H_t W_t
    if not updating:
        return (w, d, rho), x_hat

    ht = h.transpose(1, 2)
    j = torch.bmm(ht, x)                           # J_t = H_t^T X_t
    l_mat = torch.bmm(j, wt) if n_rows > dim else torch.bmm(ht, h)
    k_mat = torch.bmm(j, j.transpose(1, 2))

    d_sum = d.sum(dim=1)
    beta = rho * (1.0 + alpha) + alpha * d_sum / dim
    e = 1.0 / (beta[:, None] / d + 1.0)
    inv_sqrt_e = 1.0 / torch.sqrt(e)
    z_scale = torch.clamp(k_mat.diagonal(dim1=1, dim2=2).sum(dim=1), min=1.0)
    d_plus_rho = d + rho[:, None]
    inv_sqrt_e_outer = (((eta_n ** 2) / z_scale)[:, None, None]
                        * (inv_sqrt_e[:, :, None] * inv_sqrt_e[:, None, :]))
    op1 = ((eta_n * (1.0 - eta) / z_scale)[:, None, None]
           * (inv_sqrt_e[:, :, None] * (inv_sqrt_e * d_plus_rho)[:, None, :]))
    z = (k_mat * inv_sqrt_e_outer + l_mat * (op1 + op1.transpose(1, 2))
         + torch.diag_embed(((1.0 - eta) ** 2 / z_scale)[:, None]
                            * d_plus_rho * d_plus_rho))
    z = 0.5 * (z + z.transpose(1, 2))
    c, u = torch.linalg.eigh(z)                    # ascending
    c = c.flip(1)                                  # descending
    u = u.flip(2)
    c_floor = torch.square(rho * (1.0 - eta)) / z_scale
    c = torch.maximum(c, c_floor[:, None])
    sqrt_c = torch.sqrt(c) * torch.sqrt(z_scale)[:, None]
    inv_sqrt_c = 1.0 / sqrt_c

    rho_new = (1.0 / (dim - rank)) * (
        eta_n * tr_xxt + (1.0 - eta) * (dim * rho + d_sum)
        - sqrt_c.sum(dim=1))
    floor_val = torch.clamp(DELTA * sqrt_c.amax(dim=1), min=EPSILON)
    d_new = torch.maximum(sqrt_c - rho_new[:, None], floor_val[:, None])
    rho_new = torch.maximum(rho_new, floor_val)

    beta_new = rho_new * (1.0 + alpha) + alpha * d_new.sum(dim=1) / dim
    e_new = 1.0 / (beta_new[:, None] / d_new + 1.0)
    sqrt_e_new = torch.sqrt(e_new)

    # B_t = J_t + (1-eta)/(eta/N) (D_t + rho_t I) W_t
    w_coeff = ((1.0 - eta) / eta_n) * d_plus_rho
    b = j + w_coeff[:, :, None] * w
    # A_t = (eta/N) E_{t+1}^{1/2} C_t^{-1/2} U_t^T E_t^{-1/2}
    a = u.transpose(1, 2) * ((eta_n * sqrt_e_new * inv_sqrt_c)[:, :, None]
                             * inv_sqrt_e[:, None, :])
    return (torch.bmm(a, b), d_new, rho_new), x_hat


def _member_init(x, tr_xxt, rank: int, hp: NGDHyperParams):
    """The lazy init: the default factors, then 3 discarded updates on
    this same minibatch (a power-iteration stand-in for an SVD)."""
    g, _, dim = x.shape
    w0, d0, rho0 = init_ng_state(dim, rank, hp, x.dtype, x.device)
    wdr = (w0.expand(g, *w0.shape), d0.expand(g, rank), rho0.expand(g))
    for _ in range(3):
        wdr, _x = _core_step(*wdr, x, tr_xxt, True, hp)
    return wdr


def _member_finalize(w, d, rho, w1, d1, rho1, x, x_hat, tr_xxt):
    """The norm-preserving rescale; on a non-finite result the raw
    directions come back and the factors roll back."""
    final = torch.square(x_hat).sum(dim=(1, 2))
    good = torch.isfinite(final)
    scale = torch.sqrt(tr_xxt / (final + 1.0e-30))
    out = torch.where(good[:, None, None], x_hat * scale[:, None, None], x)
    w1 = torch.where(good[:, None, None], w1, w)
    d1 = torch.where(good[:, None], d1, d)
    rho1 = torch.where(good, rho1, rho)
    return w1, d1, rho1, out


def refreshes(t: int, hp: NGDHyperParams) -> bool:
    """Whether step ``t`` refreshes the factors (an ``eigh`` a group):
    each of the first ``NUM_INITIAL_ITERS`` steps, then every
    ``update_period``-th."""
    return t < NUM_INITIAL_ITERS or t % hp.update_period == 0


def precondition_group(group: Tensors, t: int, xs: torch.Tensor,
                       hp: NGDHyperParams) -> torch.Tensor:
    """Precondition ``xs`` (G, N, dim) with the group's stacked factors
    at step ``t``; updates ``group`` ({"w", "d", "rho"}) and returns the
    preconditioned directions."""
    w, d, rho = group["w"], group["d"], group["rho"]
    trs = torch.square(xs).sum(dim=(1, 2))
    if t == 0:
        w, d, rho = _member_init(xs, trs, w.shape[1], hp)
    (w1, d1, rho1), x_hat = _core_step(w, d, rho, xs, trs, refreshes(t, hp),
                                       hp)
    w1, d1, rho1, out = _member_finalize(w, d, rho, w1, d1, rho1, xs, x_hat,
                                         trs)
    # in place: a captured step graph reads and writes the same storage
    # every replay
    for key, new in (("w", w1), ("d", d1), ("rho", rho1)):
        group[key].copy_(new)
    return out


def group_key(r: int, n: int, dim: int, rank: int) -> str:
    return f"r{r}:n{n}:d{dim}:k{rank}"


def build_plan(shapes: Sequence[Tuple[int, ...]], hp: NGDHyperParams,
               grouped: bool = True) -> List[Dict[str, List[int]]]:
    """rounds[r] maps a group key to the indices of its leaves: round r
    preconditions axis r of every leaf with more than r axes (the rounds
    run in sequence, the groups of a round are independent).  Ungrouped,
    every axis-state is a group of one (its key names the leaf)."""
    rounds = []
    for r in range(max((len(s) for s in shapes), default=0)):
        groups: Dict[str, List[int]] = {}
        for i, shp in enumerate(shapes):
            if len(shp) > r and 1 < shp[r] <= hp.max_dim:
                dim = int(shp[r])
                n = int(np.prod(shp)) // dim
                key = group_key(r, n, dim, _default_rank(dim, hp.rank))
                if not grouped:
                    key = f"{key}:leaf{i}"
                groups.setdefault(key, []).append(i)
        rounds.append(groups)
    return rounds


def _parse_key(key: str) -> Dict[str, int]:
    parts = {}
    for p in key.split(":"):
        if p[0] in "rndk":
            parts[p[0]] = int(p[1:])
    return parts


Layouts = Dict[str, Sequence[int]]


class ScaleByNGD:
    """The preconditioning stage: per leaf, per axis with 1 < dim <=
    max_dim, in the JAX layout's axis order.  ``layouts[name]`` is the
    permutation taking the port's leaf to the JAX layout (identity when
    absent).  State: ``{"t": int, "groups": {key: {"w", "d", "rho"}}}``."""

    def __init__(self, hp: NGDHyperParams = NGDHyperParams(),
                 grouped: bool = True, layouts: Optional[Layouts] = None,
                 precond_dtype: torch.dtype = torch.float32):
        self.hp = hp
        self.grouped = grouped
        self.layouts = dict(layouts or {})
        self.precond_dtype = precond_dtype

    def _perm(self, name: str, ndim: int) -> Tuple[int, ...]:
        return tuple(self.layouts.get(name, range(ndim)))

    def _jax_shapes(self, tensors: Tensors) -> List[Tuple[int, ...]]:
        return [tuple(t.shape[a] for a in self._perm(n, t.dim()))
                for n, t in tensors.items()]

    def init(self, params: Tensors) -> dict:
        groups = {}
        dev = next(iter(params.values())).device if params else None
        for round_groups in build_plan(self._jax_shapes(params), self.hp,
                                       self.grouped):
            for key, members in round_groups.items():
                k = _parse_key(key)
                w, d, rho = init_ng_state(k["d"], k["k"], self.hp,
                                          self.precond_dtype, dev)
                g = len(members)
                groups[key] = {"w": w.expand(g, *w.shape).clone(),
                               "d": d.expand(g, *d.shape).clone(),
                               "rho": rho.expand(g).clone()}
        return {"t": 0, "groups": groups}

    @torch.no_grad()
    def update(self, grads: Tensors, state: dict) -> Tensors:
        """The preconditioned grads (same names, layouts and dtypes);
        advances ``state`` in place."""
        names = list(grads)
        perms = [self._perm(n, grads[n].dim()) for n in names]
        work = [grads[n].to(self.precond_dtype).permute(p)
                for n, p in zip(names, perms)]
        t = int(state["t"])
        for round_groups in build_plan([tuple(w.shape) for w in work],
                                       self.hp, self.grouped):
            for key, members in round_groups.items():
                k = _parse_key(key)
                r, n, dim = k["r"], k["n"], k["d"]
                moved = [work[i].movedim(r, -1) for i in members]
                xs = torch.stack([m.reshape(n, dim) for m in moved])
                outs = precondition_group(state["groups"][key], t, xs,
                                          self.hp)
                for slot, i in enumerate(members):
                    work[i] = outs[slot].reshape(moved[slot].shape).movedim(
                        -1, r)
        state["t"] = t + 1
        out = {}
        for n, w, p in zip(names, work, perms):
            inv = tuple(int(a) for a in np.argsort(p))
            out[n] = w.permute(inv).to(grads[n].dtype)
        return out


def self_test(w, d, rho, hp: NGDHyperParams = NGDHyperParams()
              ) -> Dict[str, bool]:
    """The factorization's invariants on one axis-state (the JAX
    ``self_test``): rho >= epsilon; min(d) >= epsilon and > 0.9 delta
    max(d); rho > 0.9 delta max(d); and W's rows orthogonal with squared
    norms e = 1/(beta/d + 1) to 0.1."""
    dim, rank = w.shape[1], w.shape[0]
    d_max, d_min = d.max(), d.min()
    beta = rho * (1.0 + hp.alpha) + hp.alpha * d.sum() / dim
    e = 1.0 / (beta / d + 1.0)
    inv_sqrt_e = 1.0 / torch.sqrt(e)
    should_be_zero = ((w @ w.T) * torch.outer(inv_sqrt_e, inv_sqrt_e)
                      - torch.eye(rank, dtype=w.dtype, device=w.device))
    res = {"rho_floor": bool(rho >= EPSILON),
           "d_floor": bool((d_min >= EPSILON)
                           & (d_min > DELTA * d_max * 0.9)),
           "rho_vs_d": bool(rho > DELTA * d_max * 0.9),
           "orthonormal": bool(should_be_zero.abs().max() < 0.1)}
    res["ok"] = all(res.values())
    return res


class NGD:
    """The NGD optimizer in the JAX ``ngd`` chain's order: weight decay
    (g + wd p), the preconditioning (``use_ngd``), torch-style momentum
    (buf = g + momentum buf), then −lr.  ``use_ngd=False`` is SGD.
    Updates the parameters in place."""

    def __init__(self, learning_rate: Union[float, Callable[[int], float]],
                 momentum: float = 0.0, weight_decay: float = 0.0,
                 use_ngd: bool = True,
                 hp: NGDHyperParams = NGDHyperParams(), grouped: bool = True,
                 layouts: Optional[Layouts] = None,
                 precond_dtype: torch.dtype = torch.float32):
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.scale = (ScaleByNGD(hp, grouped, layouts, precond_dtype)
                      if use_ngd else None)

    def lr(self, step: int) -> float:
        lr = self.learning_rate
        return float(lr(step) if callable(lr) else lr)

    def host_scalars(self, step: int) -> Dict[str, float]:
        """The per-step scalars of optimizer step ``step`` (a dispatch
        uploads them as a table)."""
        return {"lr": self.lr(step)}

    def updating(self, state: dict) -> bool:
        """Whether the next update refreshes NGD's factors (an
        ``eigh`` a group, host syncs: a dispatch runs it eagerly)."""
        if self.scale is None:
            return False
        return refreshes(int(state["ngd"]["t"]), self.scale.hp)

    def init(self, params: Tensors) -> dict:
        state = {"step": 0}
        if self.scale is not None:
            state["ngd"] = self.scale.init(params)
        if self.momentum:
            state["trace"] = {n: torch.zeros_like(p)
                              for n, p in params.items()}
        return state

    @torch.no_grad()
    def update(self, grads: Tensors, state: dict, params: Tensors,
               scalars: Optional[Dict[str, torch.Tensor]] = None) -> dict:
        """One step in place.  ``scalars``: the step's lr as a 0-dim fp32
        device tensor (a dispatch), else the host count's float; either
        multiplies as fp32, so the two are bitwise equal."""
        # each product rounds before its sum, as in the optax chain
        names = list(params)
        p = [params[n] for n in names]
        g = [grads[n] for n in names]
        if self.weight_decay:
            g = torch._foreach_add(g, torch._foreach_mul(p,
                                                         self.weight_decay))
        if self.scale is not None:
            pre = self.scale.update(dict(zip(names, g)), state["ngd"])
            g = [pre[n] for n in names]
        if self.momentum:
            buf = [state["trace"][n] for n in names]
            torch._foreach_mul_(buf, self.momentum)
            torch._foreach_add_(buf, g)
            g = buf
        neg_lr = (-scalars["lr"] if scalars is not None
                  else -self.lr(state["step"]))
        torch._foreach_add_(p, torch._foreach_mul(g, neg_lr))
        state["step"] += 1
        return state


def layouts_of(model) -> Layouts:
    """The permutations into the JAX layout of a model's parameters
    (``model.jax_layouts()``; none for a model without one)."""
    return model.jax_layouts() if hasattr(model, "jax_layouts") else {}


def ngd_invariants(w: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The basis-free W^T diag(d) W of an axis-state: equal for two
    factorizations that differ only by eigenvector sign or by the basis
    of a degenerate eigenspace."""
    return w.transpose(-1, -2) @ (d[..., :, None] * w)


