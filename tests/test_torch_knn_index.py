"""Kernel C1's index and search (lidiff_tpu_torch/ops/knn.py
`build_nn_index`, `nn_grid_plain`) against the function's definition: the
plain scan `nn_match_plain` and the JAX package's `nn_match_idx`, equal on
every valid query (exact integers: |c| <= 2047 keeps every distance the
search compares below 2^31, and every distance the JAX path's argmin
decides by below 2^24, so its float32 is exact too). `nn_grid_plain` is
the kernel's search in tensor code: the same cells, shells, stop rule and
(distance, row) minimum. Also: `match_features` returns exact zeros for
invalid queries whatever the bank holds, as the JAX function does, and a
bank's index is built once per geom and reused."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidiff_tpu.ops.knn import match_features as jax_match_features
from lidiff_tpu.ops.knn import nn_match_idx as jax_nn_match_idx
from lidiff_tpu_torch.config import finalize_config
from lidiff_tpu_torch.models.diffusion import DiffusionTask
from lidiff_tpu_torch.ops import knn
from tests.torch_parity_helpers import CFG, NP, TILE, ring_scan


def _cloud(rng, v, items, lo, hi):
    return np.concatenate([rng.integers(0, items, (v, 1)),
                           rng.integers(lo, hi, (v, 3))], 1).astype(np.int32)


def _case(name):
    """(q, q_mask, r, r_mask, n_batch) as numpy arrays."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "random":
        q, r = _cloud(rng, 3000, 2, -600, 600), _cloud(rng, 700, 2, -600, 600)
        return q, rng.random(3000) < 0.9, r, rng.random(700) < 0.9, 2
    if name == "one_batch":
        q, r = _cloud(rng, 1500, 1, -300, 300), _cloud(rng, 400, 1, -300, 300)
        return q, rng.random(1500) < 0.9, r, np.ones(400, bool), 1
    if name == "ties":
        # refs on a lattice of spacing 4 with every ref twice: queries
        # between lattice points are equidistant from up to 8 of them
        g = np.arange(-12, 13, 4)
        xyz = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
        xyz = np.concatenate([xyz, xyz[::-1]])
        r = np.concatenate([np.zeros((len(xyz), 1)), xyz], 1).astype(np.int32)
        q = _cloud(rng, 800, 1, -14, 15)
        return q, np.ones(800, bool), r, np.ones(len(r), bool), 1
    if name == "item_without_refs":
        q, r = _cloud(rng, 1000, 2, -200, 200), _cloud(rng, 300, 2, -200, 200)
        rm = rng.random(300) < 0.9
        rm[r[:, 0] == 1] = False
        return q, rng.random(1000) < 0.9, r, rm, 0
    if name == "corners":
        # coordinates at +-2047: a bank in two opposite corners, queries
        # around both
        r = np.concatenate([_cloud(rng, 200, 2, 1990, 2048),
                            _cloud(rng, 200, 2, -2047, -1990)])
        q = np.concatenate([_cloud(rng, 500, 2, 1900, 2048),
                            _cloud(rng, 500, 2, -2047, -1900)])
        return q, rng.random(1000) < 0.9, r, rng.random(400) < 0.9, 2
    if name == "far_queries":
        # a small bank and queries far outside its box on every side
        r = _cloud(rng, 300, 2, -60, 60)
        q = _cloud(rng, 600, 2, -1500, 1500)
        q[:200, 1:] = rng.integers(-40, 40, (200, 3))
        return q, np.ones(600, bool), r, rng.random(300) < 0.9, 0
    if name == "bank_of_8":
        # the uncond bank: 8 rows, one valid voxel per item
        q = _cloud(rng, 700, 2, -300, 300)
        r = np.zeros((8, 4), np.int32)
        r[1] = [1, 0, 0, 0]
        rm = np.zeros(8, bool)
        rm[[0, 1]] = True
        return q, rng.random(700) < 0.9, r, rm, 0
    if name == "bank_of_1":
        q = _cloud(rng, 500, 1, -2047, 2048)
        r = np.array([[0, 2047, -2047, 2047]], np.int32)
        return q, rng.random(500) < 0.9, r, np.ones(1, bool), 1
    raise ValueError(name)


CASES = ["random", "one_batch", "ties", "item_without_refs", "corners",
         "far_queries", "bank_of_8", "bank_of_1"]


@pytest.mark.parametrize("name", CASES)
def test_grid_search_matches_scan_and_jax(name):
    q, qm, r, rm, n_batch = _case(name)
    tq, tqm, tr, trm = map(torch.from_numpy, (q, qm, r, rm))
    index = knn.build_nn_index(tr, trm, n_batch)
    got, pairs = knn.nn_grid_plain(tq, tqm, index)
    scan = knn.nn_match_plain(tq, tr, trm, tqm)
    ref = np.asarray(jax_nn_match_idx(*map(jnp.asarray, (q, qm, r, rm)),
                                      n_batch=n_batch))
    np.testing.assert_array_equal(got.numpy()[qm], scan.numpy()[qm])
    np.testing.assert_array_equal(got.numpy()[qm], ref[qm])
    assert (got.numpy()[~qm] == 0).all() and (scan.numpy()[~qm] == 0).all()
    assert (pairs.numpy()[~qm] == 0).all()
    if name == "item_without_refs":
        assert (got.numpy()[qm & (q[:, 0] == 1)] == 0).all()
    if name in ("bank_of_8", "bank_of_1"):
        assert index.scan            # one cell per item: a plain scan
    else:
        assert not index.scan
        # the index cuts the pairs a full scan would examine
        n_valid = int(rm.sum())
        assert float(pairs.numpy()[qm].mean()) < 0.5 * n_valid


def test_index_layout():
    """Every valid row once, in its cell, rows ascending within a cell."""
    q, qm, r, rm, _ = _case("random")
    index = knn.build_nn_index(torch.from_numpy(r), torch.from_numpy(rm))
    pts, start = index.pts.long(), index.cell_start.long()
    assert sorted(pts[:, 3].tolist()) == np.nonzero(rm)[0].tolist()
    assert torch.equal(pts[:, :3], torch.from_numpy(r)[pts[:, 3], 1:].long())
    nxyz = index.dims[0] * index.dims[1] * index.dims[2]
    cell = torch.div(pts[:, :3] - torch.tensor(index.lo), index.cell,
                     rounding_mode="floor")
    item = torch.from_numpy(r)[pts[:, 3], 0].long()
    cid = ((item * index.dims[0] + cell[:, 0]) * index.dims[1]
           + cell[:, 1]) * index.dims[2] + cell[:, 2]
    assert int(start[-1]) == len(pts) and start.shape[0] == \
        index.items * nxyz + 1
    assert bool((cid.diff() >= 0).all())
    same = cid[1:] == cid[:-1]
    assert bool((pts[1:, 3] > pts[:-1, 3])[same].all())
    assert torch.equal(torch.searchsorted(start, torch.arange(len(pts)),
                                          right=True) - 1, cid)


def test_match_features_zeroes_invalid_queries():
    """The open fault of ROADMAP Queue C: a non-finite bank row must not
    reach an invalid query."""
    q = np.array([[0, 0, 0, 0], [0, 5, 5, 5]], np.int32)
    qm = np.array([True, False])
    r = np.array([[0, 0, 0, 1], [0, 5, 5, 4]], np.int32)
    rm = np.array([True, True])
    feats = np.array([[1, 2], [np.inf, np.nan]], np.float32)
    ref = np.asarray(jax_match_features(*map(jnp.asarray,
                                             (q, qm, r, rm, feats))))
    got = knn.match_features(*map(torch.from_numpy, (q, qm, r, rm, feats)))
    np.testing.assert_array_equal(got.numpy()[1], [0.0, 0.0])
    np.testing.assert_array_equal(got.numpy(), ref)


def test_index_built_once_per_bank():
    """A completion builds each bank's index once, in `encode_banks`, and
    every level of every solver step reuses it; a training step builds
    its bank's once for all five levels."""
    task = DiffusionTask(finalize_config(CFG), device="cpu", seed=0)
    rng = np.random.default_rng(3)
    part = torch.from_numpy(ring_scan(rng, NP))
    x = part.repeat(1, TILE, 1) + torch.from_numpy(
        rng.normal(0, 0.3, (part.shape[0], NP * TILE, 3)).astype(np.float32))
    before = knn.NNIndex.builds
    banks = task.encode_banks(part)
    assert knn.NNIndex.builds == before + 2
    geom_c, geom_u = banks[1], banks[3]
    ic, iu = geom_c.nn_index(part.shape[0]), geom_u.nn_index(part.shape[0])
    for t in (90, 40):
        task.denoise_pair(x, *banks, t)
    assert knn.NNIndex.builds == before + 2
    assert geom_c.nn_index(part.shape[0]) is ic
    assert geom_u.nn_index(part.shape[0]) is iu
    assert iu.scan and not ic.scan
    before = knn.NNIndex.builds
    task.loss_fn({"pcd_full": x, "pcd_part": part},
                 torch.Generator().manual_seed(0))
    assert knn.NNIndex.builds == before + 1
