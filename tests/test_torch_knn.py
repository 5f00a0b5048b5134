"""Exact parity of the plain version of kernel C1 (the port's 1-NN match)
with the JAX package's XLA path and its TPU kernel in interpret mode:
indices equal on valid queries, distance ties to the first index, and a
batch item without a valid reference gives index 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidiff_tpu.ops.knn import match_features as jax_match_features
from lidiff_tpu.ops.knn import nn_match_idx as jax_nn_match_idx
from lidiff_tpu.ops.pallas_knn import nn_match_idx_pallas
from lidiff_tpu_torch.ops.knn import match_features, nn_match


def _mk(seed, vq, vr, b=2, lim=600):
    rng = np.random.default_rng(seed)
    qc = np.concatenate([rng.integers(0, b, (vq, 1)),
                         rng.integers(-lim, lim, (vq, 3))], 1).astype(np.int32)
    rc = np.concatenate([rng.integers(0, b, (vr, 1)),
                         rng.integers(-lim, lim, (vr, 3))], 1).astype(np.int32)
    return qc, rng.random(vq) < 0.9, rc, rng.random(vr) < 0.9


def _both(qc, qm, rc, rm, n_batch=0):
    ref = np.asarray(jax_nn_match_idx(*map(jnp.asarray, (qc, qm, rc, rm)),
                                      n_batch=n_batch))
    got = nn_match(*map(torch.from_numpy, (qc, rc, rm)),
                   n_batch=n_batch).numpy()
    return got, ref


@pytest.mark.parametrize("case", ["random", "ties", "one_batch", "tiny_bank"])
def test_matches_xla_and_pallas(case):
    if case == "random":
        qc, qm, rc, rm = _mk(0, 3000, 700)
    elif case == "ties":          # coords in [-5, 5): dense exact ties
        qc, qm, rc, rm = _mk(1, 512, 300, b=1, lim=5)
        rm[:] = True
    elif case == "one_batch":
        qc, qm, rc, rm = _mk(2, 1000, 400, b=1)
    else:                         # the uncond bank: 8 rows, 2 valid
        qc, qm, rc, rm = _mk(3, 1000, 8, b=2)
        rm[:] = False
        rm[[0, 5]] = True
        rc[[0, 5], 0] = [0, 1]
    n_batch = 1 if case in ("ties", "one_batch") else 0
    got, ref = _both(qc, qm, rc, rm, n_batch)
    np.testing.assert_array_equal(got[qm], ref[qm])
    pal = np.asarray(nn_match_idx_pallas(*map(jnp.asarray, (qc, qm, rc, rm)),
                                         interpret=True, n_batch=n_batch))
    np.testing.assert_array_equal(got[qm], pal[qm])


def test_batch_without_valid_ref_gives_index_zero():
    qc, qm, rc, rm = _mk(4, 400, 100, b=2)
    rm[rc[:, 0] == 1] = False            # batch item 1 has no valid ref
    got, ref = _both(qc, qm, rc, rm)
    np.testing.assert_array_equal(got[qm], ref[qm])
    assert (got[qm & (qc[:, 0] == 1)] == 0).all()


def test_match_features():
    qc, qm, rc, rm = _mk(5, 800, 200)
    feats = np.random.default_rng(5).normal(size=(200, 16)).astype(np.float32)
    ref = np.asarray(jax_match_features(*map(jnp.asarray,
                                             (qc, qm, rc, rm, feats))))
    got = match_features(*map(torch.from_numpy, (qc, qm, rc, rm, feats)))
    np.testing.assert_array_equal(got.numpy(), ref)
