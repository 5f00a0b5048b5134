"""The port's host C++ kernels (`lidiff_tpu_torch.native`, its own copy of
lidiff_tpu/native/src/lidiff_native.cpp built with -ffp-contract=off)
against the JAX package's build (`lidiff_tpu.native`) and against the
port's numpy and scipy versions, on seeded clouds:

  * `voxel_unique_native`: the first point of each voxel, equal to both;
  * `viewpoint_filter_native`: equal to the JAX build, and to the port's
    numpy version (`data/collation.py` `viewpoint_filter_numpy`) on every
    point farther than float32 rounding from a cell face (the C++ kernel
    computes the cells in float64);
  * `nn_dist_native`: equal to the JAX build, and to `utils/metrics.py`
    `nn_distance` (scipy's cKDTree) within float32 rtol 1e-6 (both take the
    distance in float64 and round it once).
Also: the library is built once under `_build/` by the hash of its source
and flags, and the collation's `viewpoint_filter` is the C++ kernel."""

import os

import numpy as np
import pytest
import torch

from lidiff_tpu import native as jnative
from lidiff_tpu_torch import native
from lidiff_tpu_torch.data import collation
from lidiff_tpu_torch.data.preprocess import voxel_unique_index
from lidiff_tpu_torch.utils.metrics import nn_distance


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small tensor ops, which a
    thread pool slows down many times over when the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(n, seed, scale=20.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, scale, (n, 3)) * [1, 1, 0.2]).astype(np.float32)


@pytest.mark.parametrize("voxel", [0.05, 0.1, 0.5])
def test_voxel_unique(voxel):
    pts = _cloud(20_000, 1, scale=5.0)
    got = native.voxel_unique_native(pts, voxel)
    np.testing.assert_array_equal(got, jnative.voxel_unique_native(pts,
                                                                   voxel))
    np.testing.assert_array_equal(got, voxel_unique_index(pts, voxel))
    assert 0 < len(got) < len(pts)


@pytest.mark.parametrize("voxel", [2.0, 10.0])
def test_viewpoint_filter(voxel):
    full = _cloud(30_000, 2)
    part = _cloud(3_000, 3, scale=8.0)
    got = native.viewpoint_filter_native(full, part, voxel)
    np.testing.assert_array_equal(
        got, jnative.viewpoint_filter_native(full, part, voxel))
    np.testing.assert_array_equal(collation.viewpoint_filter(full, part,
                                                             voxel), got)
    plain = collation.viewpoint_filter_numpy(full, part, voxel)
    # points whose cell is decided by rounding: within float32 rounding of a
    # face of the grid (origin at part's minimum corner)
    rel = (full - part.min(0)) / voxel
    near = (np.abs(rel - np.round(rel)) < 1e-5).any(1)
    np.testing.assert_array_equal(got[~near], plain[~near])
    assert 0 < got.sum() < len(full)


@pytest.mark.parametrize("cell", [0.5, 1.0, 2.0])
def test_nn_dist(cell):
    a = _cloud(5_000, 4)
    b = _cloud(8_000, 5)
    got = native.nn_dist_native(a, b, cell)
    np.testing.assert_array_equal(got, jnative.nn_dist_native(a, b, cell))
    np.testing.assert_allclose(got, nn_distance(a, b), rtol=1e-6)
    assert np.isinf(native.nn_dist_native(a[:3], b[:0])).all()


def test_library_is_built_once():
    path = native.library_path()
    native.fps_native(_cloud(10, 6), 3)
    assert os.path.isfile(path)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert "-ffp-contract=off" in native.CXX_FLAGS
    assert path == native.library_path()
