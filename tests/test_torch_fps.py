"""Farthest-point sampling of the port on the CPU against the JAX package:
`fps_plain` (tensor ops, the plain version of kernel F1), the port's host
C++ copy (`lidiff_tpu_torch.native.fps_native`) and its `fps_numpy` all
equal `lidiff_tpu.ops.fps.fps_numpy` index for index, on a seeded ring of
20,000 points with 2,000 picks and on small cases (k >= N, k = 1,
duplicated points, N = 0). The JAX package's own C++ build
(`lidiff_tpu.native.fps_native`, -march=native with g++'s default FP
contraction) is held to the same: contraction may move a distance by an
ulp, which would show as a different pick near a tie; on these inputs it
gives none. Then `preprocess_scan` of the pipeline on the CPU against the
JAX pipeline's crop and FPS. Every comparison is exact: the squared
distances are the same float32 products and sums on every side."""

import types

import numpy as np
import pytest
import torch

from lidiff_tpu.native import fps_native as jax_fps_native
from lidiff_tpu.ops.fps import fps_numpy as jax_fps_numpy
from lidiff_tpu.tools import diff_completion_pipeline as jpipe
from lidiff_tpu_torch.native import fps_native
from lidiff_tpu_torch.ops import fps as F
from lidiff_tpu_torch.tools import diff_completion_pipeline as tpipe


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small tensor ops, which a
    thread pool slows down many times over when the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ring(n, seed=0, r_max=50.0):
    rng = np.random.default_rng(seed)
    az = rng.uniform(0, 2 * np.pi, n)
    el = rng.choice(np.linspace(-0.4, 0.05, 64), n)
    r = rng.uniform(3.5, r_max, n)
    return np.stack([r * np.cos(az) * np.cos(el), r * np.sin(az) * np.cos(el),
                     r * np.sin(el)], -1).astype(np.float32)


def _dup(n, seed=1):
    """n distinct points, each three times: after n picks every distance
    is 0 and each later pick is index 0 (the first of the maxima)."""
    return np.tile(_ring(n, seed), (3, 1))


CASES = {
    "ring 2000 of 20000": (lambda: _ring(20_000), 2_000),
    "k = N": (lambda: _ring(300, 2), 300),
    "k > N": (lambda: _ring(300, 2), 450),
    "k = 1": (lambda: _ring(300, 2), 1),
    "duplicated points": (lambda: _dup(200), 260),
    "N = 0": (lambda: _ring(0), 5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fps_matches_jax(case):
    make, k = CASES[case]
    pts = make()
    want = jax_fps_numpy(pts, k)
    assert len(want) == min(k, len(pts))
    np.testing.assert_array_equal(F.fps_plain(torch.from_numpy(pts), k),
                                  want)
    np.testing.assert_array_equal(fps_native(pts, k), want)
    np.testing.assert_array_equal(F.fps_numpy(pts, k), want)
    np.testing.assert_array_equal(jax_fps_native(pts, k), want)
    # on a CPU tensor F1's wrapper takes its plain version
    np.testing.assert_array_equal(F.fps_cuda(torch.from_numpy(pts), k), want)
    np.testing.assert_array_equal(F.fps(pts, k), pts[want])


def test_fps_cuda_refuses_bad_input():
    with pytest.raises(ValueError, match=r"\[N, 3\] float32"):
        F.fps_cuda(torch.zeros(10, 4), 3)
    with pytest.raises(ValueError, match=r"\[N, 3\] float32"):
        F.fps_cuda(torch.zeros(10, 3, dtype=torch.float64), 3)
    with pytest.raises(ValueError, match="max_cluster must be 8 or 16"):
        F.fps_cuda(torch.zeros(10, 3), 3, max_cluster=4)


@pytest.mark.parametrize("seed", [0, 1])
def test_preprocess_scan_matches_jax(seed):
    """Crop (3.5 m, 50 m), FPS to n_part and tile 10x of a 12,000-point
    scan with points inside and outside the crop: the port on the CPU (its
    host C++ FPS) equals the JAX pipeline's."""
    scan = _ring(12_000, seed + 10, r_max=60.0)
    ns = types.SimpleNamespace(max_range=50.0, n_part=1_800,
                               device=torch.device("cpu"))
    got = tpipe.DiffCompletion.preprocess_scan(ns, scan)
    want = jpipe.DiffCompletion.preprocess_scan(ns, scan)
    assert got.shape == (1, 18_000, 3)
    np.testing.assert_array_equal(got, want)
