"""The port's NGD (``optim/ngd.py``) against the JAX package's.

  * ``ScaleByNGD`` against JAX ``optim/ngd.py::scale_by_ngd``, grouped
    and ungrouped, 14 steps (the lazy init, the always-update steps
    1-9, then the gated period 4), on leaves with N >= rank: a 4-D leaf
    with four distinct dims stored in the port's OIHW order with its
    permutation to JAX's HWIO (the axis-order trap: preconditioning the
    axes in another order gives another result), two 4-D leaves of one
    shape (a group of two) and a 2-D leaf.  Every step: the
    preconditioned update 1e-5 of max |JAX|.  After the steps, for each
    axis-state: sorted d and rho 1e-4 relative, and the basis-free
    W^T diag(d) W 1e-4 of its max (eigenvectors are free in sign and
    inside a degenerate eigenspace, so W itself is not compared).
    Measured: updates 7e-7, d 2e-5, rho 1.1e-6, W^T diag(d) W 5e-5.
  * A leaf with N < rank (a bias: N = 1, dim 10, rank 5): its Fisher
    factors follow rounding noise (Z has a null space), so fp32 results
    of two implementations differ from the first step on (measured:
    6% of the update, and either package's fp32 d differs from its own
    fp64 d by 10^4).  It is held for one step in fp64 (both packages'
    ``precond_dtype``): update 1e-6, sorted d, rho and W^T diag(d) W
    1e-5 (measured 3e-8, 1e-7, 1e-7).
  * The full ``NGD`` optimizer against JAX ``ngd`` (weight decay, the
    preconditioning, momentum 0.9, -lr), grouped, and with
    ``use_ngd=False`` against the SGD chain: parameters 1e-5 after 6
    steps.
  * ``self_test`` on the port's factors after the steps (the JAX
    ``self_test`` invariants) holds for every N >= rank axis-state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_distributed_training_tpu.optim.ngd import ngd as j_ngd
from faster_distributed_training_tpu.optim.ngd import (
    scale_by_ngd as j_scale_by_ngd)
from faster_distributed_training_tpu_torch.optim.ngd import (
    NGD, ScaleByNGD, ngd_invariants, self_test)

# JAX-layout shapes; "a_conv" is stored OIHW in the port
SHAPES = {"a_conv": (3, 5, 6, 7), "b_conv": (2, 3, 4, 9),
          "c_conv": (2, 3, 4, 9), "d_fc": (12, 9)}
LAYOUTS = {"a_conv": (2, 3, 1, 0)}          # OIHW -> HWIO
TO_PORT = {"a_conv": (3, 2, 0, 1)}          # HWIO -> OIHW



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes,
    and torch's default of a thread a core in each oversubscribes the
    CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _port(name, a):
    t = torch.tensor(np.asarray(a, np.float32))
    return t.permute(TO_PORT[name]) if name in TO_PORT else t


def _jax_layout(name, t):
    return (t.permute(LAYOUTS[name]) if name in LAYOUTS else t).numpy()


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _states(jstate, pstate, grouped):
    """(key, JAX (w, d, rho), port (w, d, rho)) for every axis-state."""
    out = []
    if grouped:
        for key, g in jstate.groups.items():
            p = pstate["groups"][key]
            for i in range(g.w.shape[0]):
                out.append((f"{key}[{i}]",
                            (np.asarray(g.w[i]), np.asarray(g.d[i]),
                             np.asarray(g.rho[i])),
                            (p["w"][i].numpy(), p["d"][i].numpy(),
                             p["rho"][i].numpy())))
        return out
    leaves = sorted(SHAPES)
    for key, p in pstate["groups"].items():
        # ungrouped keys: "r{axis}:n..:d..:k..:leaf{index}"
        group, index = key.rsplit(":leaf", 1)
        leaf = leaves[int(index)]
        st = jstate.axes[leaf][int(group.split(":")[0][1:])]
        out.append((f"{leaf}/{key}", (np.asarray(st.w), np.asarray(st.d),
                                      np.asarray(st.rho)),
                    (p["w"][0].numpy(), p["d"][0].numpy(),
                     p["rho"][0].numpy())))
    return out


@pytest.mark.parametrize("grouped", [True, False])
def test_scale_by_ngd_matches_jax(grouped):
    rng = np.random.default_rng(0)
    jtx = j_scale_by_ngd(grouped=grouped)
    jstate = jtx.init({k: jnp.zeros(s, jnp.float32)
                       for k, s in SHAPES.items()})
    jupdate = jax.jit(jtx.update)
    port = ScaleByNGD(grouped=grouped, layouts=LAYOUTS)
    pstate = port.init({k: _port(k, np.zeros(s)) for k, s in SHAPES.items()})
    if grouped:
        assert sorted(pstate["groups"]) == sorted(jstate.groups)
        assert pstate["groups"]["r0:n108:d2:k1"]["w"].shape[0] == 2
    for step in range(14):
        g = {k: rng.normal(size=s).astype(np.float32)
             for k, s in SHAPES.items()}
        ju, jstate = jupdate({k: jnp.asarray(v) for k, v in g.items()},
                             jstate)
        pu = port.update({k: _port(k, v) for k, v in g.items()}, pstate)
        for k in SHAPES:
            assert pu[k].shape == _port(k, g[k]).shape
            err = _rel(_jax_layout(k, pu[k]), np.asarray(ju[k]))
            assert err <= 1e-5, (step, k, err)
    assert pstate["t"] == 14
    for key, (jw, jd, jr), (pw, pd, pr) in _states(jstate, pstate, grouped):
        assert _rel(np.sort(pd), np.sort(jd)) <= 1e-4, key
        assert abs(float(pr) - float(jr)) <= 1e-4 * abs(float(jr)), key
        inv_j = ngd_invariants(torch.tensor(jw), torch.tensor(jd)).numpy()
        inv_p = ngd_invariants(torch.tensor(pw), torch.tensor(pd)).numpy()
        assert _rel(inv_p, inv_j) <= 1e-4, key
        assert self_test(torch.tensor(pw), torch.tensor(pd),
                         torch.tensor(pr))["ok"], key


def test_axis_order_matters():
    """Preconditioning the 4-D leaf in the port's stored (OIHW) order
    instead of JAX's (HWIO) gives another update: the layouts are
    needed."""
    rng = np.random.default_rng(1)
    g = rng.normal(size=SHAPES["a_conv"]).astype(np.float32)
    jtx = j_scale_by_ngd()
    ju, _ = jtx.update({"a_conv": jnp.asarray(g)},
                       jtx.init({"a_conv": jnp.zeros(g.shape, jnp.float32)}))
    for layouts, close in ((LAYOUTS, True), ({}, False)):
        port = ScaleByNGD(layouts=layouts)
        x = _port("a_conv", g)
        pu = port.update({"a_conv": x}, port.init({"a_conv": x}))
        err = _rel(_jax_layout("a_conv", pu["a_conv"]), np.asarray(
            ju["a_conv"]))
        assert (err <= 1e-5) == close, err


@pytest.mark.parametrize("grouped", [True, False])
def test_n_below_rank_leaf_one_step_fp64(grouped):
    g = np.random.default_rng(2).normal(size=10)
    jtx = j_scale_by_ngd(precond_dtype=jnp.float64, grouped=grouped)
    jstate = jtx.init({"bias": jnp.zeros(10, jnp.float64)})
    ju, jstate = jtx.update({"bias": jnp.asarray(g, jnp.float64)}, jstate)
    port = ScaleByNGD(precond_dtype=torch.float64, grouped=grouped)
    pstate = port.init({"bias": torch.zeros(10, dtype=torch.float64)})
    pu = port.update({"bias": torch.tensor(g)}, pstate)
    assert _rel(pu["bias"].numpy(), np.asarray(ju["bias"])) <= 1e-6
    (p,) = pstate["groups"].values()
    if grouped:
        (j,) = jstate.groups.values()
        jw, jd, jr = np.asarray(j.w[0]), np.asarray(j.d[0]), np.asarray(
            j.rho[0])
    else:
        st = jstate.axes["bias"][0]
        jw, jd, jr = np.asarray(st.w), np.asarray(st.d), np.asarray(st.rho)
    assert _rel(np.sort(p["d"][0].numpy()), np.sort(jd)) <= 1e-5
    assert abs(float(p["rho"][0]) - float(jr)) <= 1e-5 * float(jr)
    inv_j = ngd_invariants(torch.tensor(jw), torch.tensor(jd)).numpy()
    assert _rel(ngd_invariants(p["w"][0], p["d"][0]).numpy(), inv_j) <= 1e-5


@pytest.mark.parametrize("use_ngd", [True, False])
def test_ngd_optimizer_matches_jax_chain(use_ngd):
    import optax

    rng = np.random.default_rng(3)
    p0 = {k: rng.normal(size=s).astype(np.float32)
          for k, s in SHAPES.items()}
    lr = lambda step: 0.05 * (0.5 if step >= 3 else 1.0)  # noqa: E731
    jtx = j_ngd(lambda c: jnp.where(c >= 3, 0.025, 0.05), momentum=0.9,
                weight_decay=1e-4, use_ngd=use_ngd)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jtx.init(jp)
    jupdate = jax.jit(jtx.update)
    opt = NGD(lr, momentum=0.9, weight_decay=1e-4, use_ngd=use_ngd,
              layouts=LAYOUTS)
    pp = {k: _port(k, v).clone() for k, v in p0.items()}
    ps = opt.init(pp)
    for _ in range(6):
        g = {k: rng.normal(size=s).astype(np.float32)
             for k, s in SHAPES.items()}
        u, js = jupdate({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        opt.update({k: _port(k, v) for k, v in g.items()}, ps, pp)
    assert ps["step"] == 6
    for k in SHAPES:
        np.testing.assert_allclose(_jax_layout(k, pp[k]), np.asarray(jp[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
