"""The port's Chamfer distance (`lidiff_tpu_torch/ops/chamfer.py`) against
the JAX package's on the CPU, same numpy clouds on both sides.

Tolerances:
  * `nn_indices` (exact): indices equal; where a float32 GEMM summed in
    another order flips a near-tie, the two picks' distances agree to 1e-6
    relative.
  * `nn_indices_grid` with a fixed `res`: indices equal (integer matcher
    on both sides, same quantization). With the adaptive step a one-ulp
    difference in `res` may move a point across a cell edge, so there the
    loss is compared, within 1e-6 relative.
  * `chamfer_distance` (exact, grid, masked, batched): values within 1e-5
    relative; gradients to both clouds within 1e-5 of max|grad| against
    `jax.grad` (float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidiff_tpu.ops import chamfer as jch
from lidiff_tpu_torch.ops import chamfer as tch


def _scene(rng, B, n, m, noise=0.3):
    """Ring-like dense clouds at metric scale (tests/test_chamfer.py)."""
    az = rng.uniform(0, 2 * np.pi, (B, n))
    r = rng.uniform(3, 45, (B, n))
    x = np.stack([r * np.cos(az), r * np.sin(az),
                  rng.uniform(-2, 2, (B, n))], -1).astype(np.float32)
    y = (x[:, rng.permutation(n)[:m]]
         + rng.normal(scale=noise, size=(B, m, 3))).astype(np.float32)
    return x, y


def test_nn_indices_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(5000, 3)).astype(np.float32)
    t = rng.normal(size=(9000, 3)).astype(np.float32)
    tm = rng.random(9000) < 0.8
    for mask in (None, tm):
        ref = np.asarray(jch.nn_indices(
            jnp.asarray(q), jnp.asarray(t),
            None if mask is None else jnp.asarray(mask)))
        got = tch.nn_indices(torch.from_numpy(q), torch.from_numpy(t),
                             None if mask is None else torch.from_numpy(mask),
                             ).numpy()
        diff = got != ref
        assert diff.mean() < 1e-3
        d_got = ((q[diff] - t[got[diff]]) ** 2).sum(-1)
        d_ref = ((q[diff] - t[ref[diff]]) ** 2).sum(-1)
        np.testing.assert_allclose(d_got, d_ref, rtol=1e-6)
        if mask is not None:
            assert mask[got].all()


@pytest.mark.parametrize("B", [1, 2])
def test_nn_indices_grid_fixed_res_equal(B):
    rng = np.random.default_rng(1)
    x, y = _scene(rng, B, 3000, 2200)
    q, t = x.reshape(-1, 3), y.reshape(-1, 3)
    qm = rng.random(len(q)) < 0.9
    tm = rng.random(len(t)) < 0.9
    ref = np.asarray(jch.nn_indices_grid(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(tm), jnp.asarray(qm),
        res=0.05, n_batch=B))
    got = tch.nn_indices_grid(
        torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(tm),
        torch.from_numpy(qm), res=0.05, n_batch=B).numpy()
    np.testing.assert_array_equal(got[qm], ref[qm])
    # never across items, never an invalid target
    assert ((got[qm] * B) // len(t) == (np.arange(len(q))[qm] * B)
            // len(q)).all()
    assert tm[got[qm]].all()


def test_adaptive_res_and_grid_limit():
    rng = np.random.default_rng(2)
    x, y = _scene(rng, 2, 500, 300)
    mx = rng.random((2, 500)) < 0.7
    ref = float(jch._adaptive_res([(jnp.asarray(x), jnp.asarray(mx)),
                                   (jnp.asarray(y), None)]))
    got = float(tch._adaptive_res([(torch.from_numpy(x),
                                    torch.from_numpy(mx)),
                                   (torch.from_numpy(y), None)]))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert tch._grid_lim() == jch._grid_lim() == 1279


def _both(x, y, mx=None, my=None, **kw):
    """(loss, dx, dy) of the JAX package and of the port."""
    jm = [None if m is None else jnp.asarray(m) for m in (mx, my)]
    j_loss, (j_dx, j_dy) = jax.value_and_grad(
        lambda a, b: jch.chamfer_distance(a, b, *jm, **kw), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(y))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    tm = [None if m is None else torch.from_numpy(m) for m in (mx, my)]
    t_loss = tch.chamfer_distance(tx, ty, *tm, **kw)
    t_loss.backward()
    return ((float(j_loss), np.asarray(j_dx), np.asarray(j_dy)),
            (float(t_loss.detach()), tx.grad.numpy(), ty.grad.numpy()))


CHAMFER_CASES = {
    "exact": dict(B=2, n=900, m=700, kw=dict(method="exact")),
    "exact_masked": dict(B=2, n=900, m=700, masked=True,
                         kw=dict(method="exact")),
    "grid_adaptive": dict(B=1, n=3000, m=2500, kw=dict(method="grid")),
    "grid_batched_masked": dict(B=2, n=2000, m=1500, masked=True,
                                kw=dict(method="grid")),
    "grid_fixed_res": dict(B=2, n=2000, m=1500,
                           kw=dict(method="grid", grid_res=0.04)),
    "auto_small_is_exact": dict(B=1, n=400, m=300, kw=dict()),
}


@pytest.mark.parametrize("case", list(CHAMFER_CASES))
def test_chamfer_value_and_grads_match_jax(case):
    c = CHAMFER_CASES[case]
    rng = np.random.default_rng(len(case))
    x, y = _scene(rng, c["B"], c["n"], c["m"])
    mx = my = None
    if c.get("masked"):
        mx = rng.random(x.shape[:2]) < 0.7
        my = rng.random(y.shape[:2]) < 0.7
    (j_loss, j_dx, j_dy), (t_loss, t_dx, t_dy) = _both(x, y, mx, my,
                                                       **c["kw"])
    np.testing.assert_allclose(
        t_loss, j_loss, rtol=1e-6 if case == "grid_adaptive" else 1e-5)
    assert np.abs(j_dx).max() > 0 and np.abs(j_dy).max() > 0
    for got, ref in ((t_dx, j_dx), (t_dy, j_dy)):
        # with the adaptive step a point on a cell edge may pick another
        # neighbour: allow a few rows, hold the rest to the tolerance
        bad = np.abs(got - ref).max(-1) > 1e-5 * np.abs(ref).max()
        limit = 0.002 if case.startswith("grid") and "fixed" not in case \
            else 0.0
        assert bad.mean() <= limit, (case, bad.mean())
    if mx is not None:
        assert (t_dx[~mx] == 0).sum() > 0


def test_grid_matches_exact_loss_and_descends():
    """tests/test_chamfer.py::test_grid_matches_exact_loss for the port:
    the grid loss within 1e-3 relative of the exact one, and a gradient
    step on x lowers it."""
    rng = np.random.default_rng(6)
    x, y = _scene(rng, 2, 2000, 1500)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y)
    exact = float(tch.chamfer_distance(tx.detach(), ty, method="exact"))
    grid = tch.chamfer_distance(tx, ty, method="grid")
    assert abs(float(grid.detach()) - exact) <= 1e-3 * exact
    grid.backward()
    assert bool(torch.isfinite(tx.grad).all())
    with torch.no_grad():
        stepped = float(tch.chamfer_distance(tx - 0.02 * tx.grad, ty,
                                             method="grid"))
    assert stepped < float(grid.detach())


def test_method_selection(monkeypatch):
    rng = np.random.default_rng(7)
    x, y = _scene(rng, 1, 300, 200)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    exact = float(tch.chamfer_distance(tx, ty, method="exact"))
    monkeypatch.setenv("LIDIFF_CHAMFER", "grid")
    monkeypatch.setenv("LIDIFF_CHAMFER_RES", "5.0")      # a coarse grid
    coarse = float(tch.chamfer_distance(tx, ty))
    assert coarse > exact * 1.01
    assert float(tch.chamfer_distance(tx, ty, method="exact")) == exact
    monkeypatch.delenv("LIDIFF_CHAMFER_RES")
    fine = float(tch.chamfer_distance(tx, ty))
    assert abs(fine - exact) <= 1e-3 * exact
    with pytest.raises(ValueError):
        tch.chamfer_distance(tx, ty, method="nearest")
    # the threshold of "auto": 2^26 pairs per item
    assert tch._AUTO_GRID_PAIRS == jch._AUTO_GRID_PAIRS == 1 << 26
