"""The port's 1-NN matcher for the grid chamfer (kernel C2's plain
version: the tile search over a grid index of the references) against the
JAX package on the CPU, on the inputs of tests/test_pallas_knn.py:
`lidiff_tpu.ops.knn.nn_match_idx` (XLA) and the compact-grid Pallas kernel
in interpret mode (`nn_match_idx_pallas(interpret=True, compact_min_nr=2,
maxb=5)`); and the tile search's own invariants: every valid query's
argmin row lies in a cell its tile staged, and the index built without a
host read holds the rows of kernel C1's index cell by cell.

Tolerance: none. Distances are integers on every side, so the indices of
valid queries are equal (invalid queries get 0 in the port; they are
unspecified in the JAX package).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidiff_tpu.ops.knn import nn_match_idx
from lidiff_tpu.ops.pallas_knn import COORD_LIM, nn_match_idx_pallas
from lidiff_tpu_torch.ops import knn
from tests.test_pallas_knn import _lexsort, _mk, _mk_sorted


def _slabs(rng, n_per_slab=2200, nq=2000):
    """Clustered ref slabs with empty gaps between them, queries all over
    (tests/test_pallas_knn.py:166-187)."""
    slabs = [np.stack([np.full(n_per_slab, 0),
                       rng.integers(x0, x0 + 40, n_per_slab),
                       rng.integers(-200, 200, n_per_slab),
                       rng.integers(-30, 30, n_per_slab)], 1).astype(np.int32)
             for x0 in (-900, -300, 500, 950)]
    rc = _lexsort(np.concatenate(slabs))
    qc = _lexsort(np.concatenate(
        [np.zeros((nq, 1)), rng.integers(-1000, 1000, (nq, 3))],
        1).astype(np.int32))
    return (jnp.asarray(qc), jnp.ones((len(qc),), bool), jnp.asarray(rc),
            jnp.ones((len(rc),), bool))


# name: (inputs, n_batch)
CASES = {
    "sorted": lambda: (_mk_sorted(np.random.default_rng(9), 4000, 9000,
                                  lim=1000), 1),
    "sorted_two_batch_invalid_refs": lambda: (
        _mk_sorted(np.random.default_rng(10), 3000, 9000, b=2, lim=900,
                   r_valid=0.9), 0),
    "clustered_slabs": lambda: (_slabs(np.random.default_rng(11)), 1),
    "coords_at_grid_limit": lambda: (
        _mk_sorted(np.random.default_rng(8), 3000, 9000, lim=COORD_LIM - 1),
        1),
    "unsorted": lambda: (_mk(np.random.default_rng(0), 3000, 5000), 0),
    "fewer_refs_than_window": lambda: (
        _mk_sorted(np.random.default_rng(3), 2000, 300), 1),
    "dense_ties": lambda: (_mk(np.random.default_rng(4), 700, 5000, b=1,
                               lim=6), 1),
}


def _to_torch(qc, qm, rc, rm):
    return tuple(torch.from_numpy(np.array(a)) for a in (qc, qm, rc, rm))


def _case(case):
    if case == "two_batch_invalid_queries":
        (qc, qm, rc, rm), n_batch = CASES["sorted_two_batch_invalid_refs"]()
        qm = jnp.asarray(np.random.default_rng(13).random(len(qm)) < 0.7)
        return (qc, qm, rc, rm), n_batch
    return CASES[case]()


@pytest.mark.parametrize("case", list(CASES))
def test_pruned_plain_matches_jax(case):
    (qc, qm, rc, rm), n_batch = CASES[case]()
    ref = np.asarray(nn_match_idx(qc, qm, rc, rm))
    pal = np.asarray(nn_match_idx_pallas(qc, qm, rc, rm, interpret=True,
                                         n_batch=n_batch, compact_min_nr=2,
                                         maxb=5))
    tq, tqm, tr, trm = _to_torch(qc, qm, rc, rm)
    index = knn.build_tile_index(tr, trm, n_batch)
    got, _ = knn.nn_tiles_plain(tq, tqm, index,
                                knn.tile_order(tq, tqm, index))
    got = got.numpy()
    # the entry point takes the same path for CPU tensors
    same = knn.nn_match_tiled(tq, tqm, tr, trm, n_batch).numpy()
    v = np.asarray(qm)
    np.testing.assert_array_equal(got[v], ref[v])
    np.testing.assert_array_equal(got[v], pal[v])
    np.testing.assert_array_equal(same, got)
    assert (got[~v] == 0).all()
    # and equals the unpruned matcher of the sampling path
    np.testing.assert_array_equal(
        got[v], knn.nn_match_plain(tq, tr, trm).numpy()[v])


@pytest.mark.parametrize("case", list(CASES) + ["two_batch_invalid_queries"])
def test_tiles_stage_every_argmin(case):
    """The tile search equals the plain scan, and the row of each valid
    query's true argmin is among the index rows its tile staged; the
    staged count is the number of those rows."""
    (qc, qm, rc, rm), n_batch = _case(case)
    tq, tqm, tr, trm = _to_torch(qc, qm, rc, rm)
    index = knn.build_tile_index(tr, trm, n_batch)
    order = knn.tile_order(tq, tqm, index)
    got, staged, rows = knn.nn_tiles_plain(tq, tqm, index, order,
                                           keep_rows=True)
    true_idx = knn.nn_match_plain(tq, tr, trm, tqm)
    assert torch.equal(got, true_idx)
    assert [len(r) for r in rows] == staged.tolist()
    # a query whose item has no valid ref has no argmin to stage
    has_ref = torch.zeros(tq.shape[0], dtype=torch.bool)
    for b in tr[trm][:, 0].unique():
        has_ref |= tq[:, 0] == b if n_batch != 1 else True
    pos = torch.full((tr.shape[0],), -1, dtype=torch.long)
    pos[index.pts[:, 3].long()] = torch.arange(index.pts.shape[0])
    for t, r in enumerate(rows):
        qs = order[t * knn.QTILE:(t + 1) * knn.QTILE].long()
        qs = qs[tqm[qs] & has_ref[qs]]
        assert bool(torch.isin(pos[true_idx[qs].long()], r).all()), t
    # on uniform refs the tiles stage a small share of a scan's rows (far
    # queries, as the slabs' are, can stage more: each group of a tile
    # grows its shells until it reaches its nearest row)
    if case == "sorted":
        assert int(staged.sum()) < 0.2 * len(rows) * tr.shape[0]


@pytest.mark.parametrize("n_batch,items", [(1, 1), (0, 2), (2, 2)])
def test_tile_index_holds_the_rows_of_c1s_index(n_batch, items):
    """Built without a host read, the index holds the same rows per cell,
    in the same order, as `build_nn_index` (same corner, cell and grid);
    the rows past the valid ones are the invalid ones."""
    rng = np.random.default_rng(items + n_batch)
    r = torch.from_numpy(np.concatenate(
        [rng.integers(0, items, (3000, 1)), rng.integers(-700, 700, (3000, 3))],
        1).astype(np.int32))
    rm = torch.from_numpy(rng.random(3000) < 0.9)
    c1 = knn.build_nn_index(r, rm, n_batch)
    got = knn.build_tile_index(r, rm, n_batch)
    n = int(rm.sum())
    assert got.geo.tolist() == [*c1.lo, c1.cell, *c1.dims, c1.items]
    assert torch.equal(got.pts[:n], c1.pts)
    cells = c1.cell_start.shape[0]
    assert torch.equal(got.cell_start[:cells], c1.cell_start)
    assert bool((got.cell_start[cells:] == n).all())
    assert got.cell_start.shape[0] == got.cap + 1
    assert sorted(got.pts[n:, 3].tolist()) == \
        torch.nonzero(~rm).squeeze(1).tolist()


def test_no_valid_ref_in_an_item_gives_index_zero():
    (qc, qm, rc, rm), _ = CASES["sorted_two_batch_invalid_refs"]()
    tq, tqm, tr, trm = _to_torch(qc, qm, rc, rm)
    trm = trm & (tr[:, 0] == 0)               # item 1 loses every ref
    got = knn.nn_match_tiled(tq, tqm, tr, trm, 2)
    ref = np.asarray(nn_match_idx(qc, qm, rc, jnp.asarray(trm.numpy())))
    v = tqm.numpy()
    np.testing.assert_array_equal(got.numpy()[v], ref[v])
    assert bool((got[tqm & (tq[:, 0] == 1)] == 0).all())


def test_pruned_rejects_bad_input():
    (qc, qm, rc, rm), _ = CASES["fewer_refs_than_window"]()
    tq, tqm, tr, trm = _to_torch(qc, qm, rc, rm)
    with pytest.raises(ValueError):
        knn.nn_match_tiled(tq.long(), tqm, tr, trm)
    with pytest.raises(ValueError):
        knn.nn_match_tiled(tq, tqm[:-1], tr, trm)
    with pytest.raises(ValueError):
        knn.nn_match_tiled(tq.to("meta"), tqm.to("meta"), tr.to("meta"),
                           trm.to("meta"))
    r_neg = tr.clone()
    r_neg[0, 0] = -1
    with pytest.raises(ValueError):          # a batch id below 0
        knn.nn_match_tiled(tq, tqm, r_neg, trm, 0)


@pytest.mark.parametrize("B", [1, 2])
def test_grid_chamfer_ties_go_to_the_sorted_target_row(B):
    """`nn_indices_grid` against the JAX function on clouds made of ties:
    targets on a coarse lattice, each point three times, and a slab of
    them beyond the grid's edge, which the clamp piles onto one face;
    queries between lattice points and beyond the edge too. The JAX
    package matches the lex-sorted arrays, so a tie goes to the lowest
    row of the sorted target; the port's index is built over the sorted
    target and must pick the same row."""
    from lidiff_tpu.ops import chamfer as jch
    from lidiff_tpu_torch.ops import chamfer as tch
    rng = np.random.default_rng(30 + B)
    res = 0.05
    g = np.arange(-20, 21, 4) * res
    lat = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    face = lat.copy()
    face[:, 0] = rng.uniform(70, 90, len(face))        # beyond 1279 * res
    t = np.concatenate([lat, lat, face, lat, face])
    t = np.concatenate([t[rng.permutation(len(t))] for _ in range(B)])
    q = rng.integers(-22, 23, (B * 1500, 3)) * res
    q[::5, 0] = rng.uniform(66, 95, len(q[::5]))
    q, t = q.astype(np.float32), t.astype(np.float32)
    qm = rng.random(len(q)) < 0.9
    tm = rng.random(len(t)) < 0.9
    ref = np.asarray(jch.nn_indices_grid(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(tm), jnp.asarray(qm),
        res=res, n_batch=B))
    got = tch.nn_indices_grid(
        torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(tm),
        torch.from_numpy(qm), res=res, n_batch=B).numpy()
    np.testing.assert_array_equal(got[qm], ref[qm])
    # the case is about ties: many queries have several nearest targets
    d = ((q[qm, None, :] - t[None, tm, :]) ** 2).sum(-1)
    assert ((d == d.min(1, keepdims=True)).sum(1) > 1).mean() > 0.3
