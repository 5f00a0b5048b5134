"""The port's pruned 1-NN matcher (kernel C2's plain version and the
interval prolog) against the JAX package on the CPU, on the inputs of
tests/test_pallas_knn.py: `lidiff_tpu.ops.knn.nn_match_idx` (XLA) and the
compact-grid Pallas kernel in interpret mode
(`nn_match_idx_pallas(interpret=True, compact_min_nr=2, maxb=5)`).

Tolerance: none. Distances are integers on every side, so the indices of
valid queries are equal (invalid queries are unspecified in both packages).
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
        _mk_sorted(np.random.default_rng(3), 2000, knn.UWND_MIN - 212), 1),
    "dense_ties": lambda: (_mk(np.random.default_rng(4), 700, 5000, b=1,
                               lim=6), 1),
}


def _to_torch(qc, qm, rc, rm):
    return tuple(torch.from_numpy(np.array(a)) for a in (qc, qm, rc, rm))


@pytest.mark.parametrize("case", list(CASES))
def test_pruned_plain_matches_jax(case):
    (qc, qm, rc, rm), n_batch = CASES[case]()
    ref = np.asarray(nn_match_idx(qc, qm, rc, rm))
    pal = np.asarray(nn_match_idx_pallas(qc, qm, rc, rm, interpret=True,
                                         n_batch=n_batch, compact_min_nr=2,
                                         maxb=5))
    tq, tqm, tr, trm = _to_torch(qc, qm, rc, rm)
    got = knn.nn_match_pruned_plain(tq, tqm, tr, trm, n_batch).numpy()
    # the entry point takes the same path for CPU tensors
    same = knn.nn_match_pruned(tq, tqm, tr, trm, n_batch).numpy()
    v = np.asarray(qm)
    np.testing.assert_array_equal(got[v], ref[v])
    np.testing.assert_array_equal(got[v], pal[v])
    np.testing.assert_array_equal(same, got)
    # and equals the unpruned matcher of the sampling path
    np.testing.assert_array_equal(
        got[v], knn.nn_match_plain(tq, tr, trm).numpy()[v])


@pytest.mark.parametrize("case", list(CASES) + ["two_batch_invalid_queries"])
def test_intervals_hold_every_argmin(case):
    """For every tile the row of each valid query's true argmin lies in
    [start, start + cnt); intervals start on block edges and stay in
    range."""
    tile, block = knn.QTILE, knn.RBLK
    if case == "two_batch_invalid_queries":
        (qc, qm, rc, rm), n_batch = CASES["sorted_two_batch_invalid_refs"]()
        qm = jnp.asarray(np.random.default_rng(13).random(len(qm)) < 0.7)
    else:
        (qc, qm, rc, rm), n_batch = CASES[case]()
    tq, tqm, tr, trm = _to_torch(qc, qm, rc, rm)
    start, cnt = knn.prune_intervals(tq, tqm, tr, trm, n_batch)
    nt = -(-tq.shape[0] // tile)
    assert start.shape == cnt.shape == (nt,) and start.dtype == torch.int32
    assert bool((start % block == 0).all())
    assert bool((start + cnt <= tr.shape[0]).all()) and bool((cnt >= 0).all())
    true_idx = knn.nn_match_plain(tq, tr, trm).long()
    # a query whose item has no valid ref has no argmin to protect
    has_ref = torch.zeros(tq.shape[0], dtype=torch.bool)
    for b in tr[trm][:, 0].unique():
        has_ref |= tq[:, 0] == b
    tile_of = torch.arange(tq.shape[0]) // tile
    lo, hi = start.long()[tile_of], (start + cnt).long()[tile_of]
    inside = (true_idx >= lo) & (true_idx < hi)
    assert bool(inside[tqm & has_ref].all())
    got = knn.nn_match_pruned_plain(tq, tqm, tr, trm, n_batch)
    assert torch.equal(got[tqm], true_idx[tqm].int())
    if case == "clustered_slabs":
        assert int(cnt.min()) < tr.shape[0]          # something is pruned
    if case == "sorted":
        assert float(cnt.sum()) < 0.5 * nt * tr.shape[0]


def test_window_bound_plain_is_the_brute_force_bound():
    """The per-tile bound against a direct numpy evaluation: max over valid
    queries of the min squared distance to valid same-batch window rows."""
    (qc, qm, rc, rm), _ = CASES["sorted_two_batch_invalid_refs"]()
    tq, tqm, tr, trm = _to_torch(qc, qm, rc, rm)
    tile, U = 64, knn.UWND_MIN
    nt = -(-tq.shape[0] // tile)
    rng = np.random.default_rng(2)
    win = torch.from_numpy(rng.integers(0, tr.shape[0] - U, nt)
                           .astype(np.int32))
    got = knn.window_bound_plain(tq, tqm, tr, trm, win, U, True, tile)
    q, r = np.asarray(qc).astype(np.int64), np.asarray(rc).astype(np.int64)
    for i in range(nt):
        w = slice(int(win[i]), int(win[i]) + U)
        best = 0
        for k in range(i * tile, min((i + 1) * tile, len(q))):
            if not bool(qm[k]):
                continue
            ok = np.asarray(rm)[w] & (r[w, 0] == q[k, 0])
            d = ((r[w, 1:] - q[k, 1:]) ** 2).sum(-1)
            best = max(best, d[ok].min() if ok.any() else knn.NO_BOUND)
        assert int(got[i]) == best, i


def test_no_valid_ref_in_an_item_gives_index_zero():
    (qc, qm, rc, rm), _ = CASES["sorted_two_batch_invalid_refs"]()
    tq, tqm, tr, trm = _to_torch(qc, qm, rc, rm)
    trm = trm & (tr[:, 0] == 0)               # item 1 loses every ref
    got = knn.nn_match_pruned_plain(tq, tqm, tr, trm, 0)
    ref = np.asarray(nn_match_idx(qc, qm, rc, jnp.asarray(trm.numpy())))
    v = tqm.numpy()
    np.testing.assert_array_equal(got.numpy()[v], ref[v])
    assert bool((got[tqm & (tq[:, 0] == 1)] == 0).all())


def test_pruned_rejects_bad_input():
    (qc, qm, rc, rm), _ = CASES["fewer_refs_than_window"]()
    tq, tqm, tr, trm = _to_torch(qc, qm, rc, rm)
    with pytest.raises(ValueError):
        knn.nn_match_pruned(tq.long(), tqm, tr, trm)
    with pytest.raises(ValueError):
        knn.nn_match_pruned(tq, tqm[:-1], tr, trm)
    with pytest.raises(ValueError):
        knn.nn_match_pruned(tq.to("meta"), tqm.to("meta"), tr.to("meta"),
                            trm.to("meta"))


def test_window_grows_with_the_reference_count():
    """A 64th of the rows in steps of 512, between 512 and 4096; exact with
    a window above the smallest (70,000 refs: 1024 rows)."""
    assert [knn.window_rows(n) for n in (600, 11264, 18048, 70_000, 360_000,
                                         1_080_000)] == \
        [512, 512, 512, 1024, 4096, 4096]
    (qc, qm, rc, rm), _ = (_mk_sorted(np.random.default_rng(12), 1500,
                                      70_000, lim=1200, r_valid=0.9), 1)
    tq, tqm, tr, trm = _to_torch(qc, qm, rc, rm)
    start, cnt = knn.prune_intervals(tq, tqm, tr, trm, 1)
    assert float(cnt.sum()) < 0.5 * len(cnt) * tr.shape[0]
    got = knn.nn_match_pruned_plain(tq, tqm, tr, trm, 1)
    ref = knn.nn_match_plain(tq, tr, trm, block=250)
    assert torch.equal(got[tqm], ref[tqm])
