"""The port's host metrics and PLY I/O against the JAX package's copies on
the same seeded clouds.

Tolerances: Chamfer distance, RMSE, PR-AUC and the JSDs rtol 1e-6 (both
sides run the same scipy and numpy code); CompletionIoU exactly (integer
counts of occupied bins); PLY bit for bit."""

import numpy as np
import pytest

from lidiff_tpu.utils import histogram_metrics as jhist
from lidiff_tpu.utils import metrics as jmetrics
from lidiff_tpu.utils import ply as jply
from lidiff_tpu_torch.utils import histogram_metrics as thist
from lidiff_tpu_torch.utils import metrics as tmetrics
from lidiff_tpu_torch.utils import ply as tply

RTOL = 1e-6


def _clouds(seed, n_gt=3000, n_pred=2500, r=45.0):
    """Three (gt, pred) scans of ring-like clouds within +-r."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        gt = rng.uniform(-r, r, (n_gt, 3)).astype(np.float32)
        gt[:, 2] *= 0.1
        pred = (gt[:n_pred] + rng.normal(0, 0.08, (n_pred, 3))).astype(
            np.float32)
        out.append((gt, pred))
    return out


@pytest.mark.parametrize("name", ["ChamferDistance", "RMSE"])
def test_distance_metrics_match_jax(name):
    j, t = getattr(jmetrics, name)(), getattr(tmetrics, name)()
    for gt, pred in _clouds(0):
        j.update(gt, pred)
        t.update(gt, pred)
    np.testing.assert_allclose(t.compute(), j.compute(), rtol=RTOL)
    assert t.compute()[0] > 0


def test_precision_recall_auc_matches_jax():
    j = jmetrics.PrecisionRecall(0.05, 0.10, 100)
    t = tmetrics.PrecisionRecall(0.05, 0.10, 100)
    for gt, pred in _clouds(1):
        j.update(gt, pred)
        t.update(gt, pred)
    np.testing.assert_allclose(t.compute_auc(), j.compute_auc(), rtol=RTOL)
    assert 0 < t.compute_auc()[2] < 100          # percentages
    np.testing.assert_allclose(t.compute_at_threshold(0.07),
                               j.compute_at_threshold(0.07), rtol=RTOL)


@pytest.mark.parametrize("bev", [False, True])
def test_jsd_matches_jax(bev):
    gt, pred = _clouds(2)[0]
    np.testing.assert_allclose(thist.compute_hist_metrics(gt, pred, bev),
                               jhist.compute_hist_metrics(gt, pred, bev),
                               rtol=RTOL)


def _edge_cloud(seed, r, vs, n=4000):
    """Points inside, on bin edges (the +-r edges included) and outside
    [-r, r] in one axis or several."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-r, r, (n, 3))
    edges = np.linspace(-r, r, int(2 * r / vs) + 1)
    p[: n // 4, 0] = rng.choice(edges, n // 4)            # interior edges
    p[n // 4: n // 4 + 50, 1] = r                          # right edge
    p[n // 4 + 50: n // 4 + 100, 2] = -r                   # left edge
    p[n // 4 + 100: n // 4 + 150] = r                      # the far corner
    p[n // 4 + 150: n // 4 + 250, 0] = rng.uniform(r, 2 * r, 100)
    p[n // 4 + 250: n // 4 + 300] *= 3.0                    # out in all axes
    return p.astype(np.float32)


def test_occupied_bins_match_histogramdd():
    r, bins = 5.0, 50
    p = _edge_cloud(3, r, 2 * r / bins)
    dense = np.histogramdd(p, bins=bins, range=([-r, r],) * 3)[0] > 0
    np.testing.assert_array_equal(tmetrics.occupied_bins(p, bins, r),
                                  np.flatnonzero(dense))


def test_completion_iou_matches_jax_exactly():
    """At a 5 m range, where the JAX class's dense histograms are small,
    with all three voxel sizes and points on and outside the edges."""
    r = 5.0
    j = jmetrics.CompletionIoU(max_range=r)
    t = tmetrics.CompletionIoU(max_range=r)
    rng = np.random.default_rng(4)
    for seed in (5, 6):
        gt = _edge_cloud(seed, r, 0.1)
        pred = np.concatenate([gt[::2] + rng.normal(0, 0.05, gt[::2].shape),
                               _edge_cloud(seed + 10, r, 0.2)[:500]])
        j.update(gt, pred.astype(np.float32))
        t.update(gt, pred.astype(np.float32))
    np.testing.assert_array_equal(t.conf, j.conf)
    assert t.compute() == j.compute()
    assert all(0 < v < 1 for v in t.compute().values())


@pytest.mark.parametrize("normals", [False, True])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ply_binary_round_trip_across_packages(tmp_path, writer, normals):
    rng = np.random.default_rng(7)
    pts = rng.normal(0, 10, (500, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (500, 3)).astype(np.float32) if normals else None
    path = str(tmp_path / "c.ply")
    (tply if writer == "port" else jply).write_ply(path, pts, nrm)
    with open(path, "rb") as f:
        data = f.read()
    other = str(tmp_path / "d.ply")
    (jply if writer == "port" else tply).write_ply(other, pts, nrm)
    with open(other, "rb") as f:
        assert f.read() == data
    for mod in (tply, jply):
        got = mod.read_ply(path)
        np.testing.assert_array_equal(got["points"], pts)
        if normals:
            np.testing.assert_array_equal(got["normals"], nrm)
        else:
            assert got["normals"] is None


@pytest.mark.parametrize("fmt", ["ascii", "binary_big_endian"])
def test_ply_ascii_and_big_endian_read_the_same(tmp_path, fmt):
    rng = np.random.default_rng(8)
    pts = rng.normal(0, 10, (40, 3)).astype(np.float32)
    inten = rng.integers(0, 255, 40).astype(np.uint8)
    header = ("ply\nformat " + fmt + " 1.0\nelement vertex 40\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar intensity\nelement face 0\n"
              "property list uchar int vertex_indices\nend_header\n")
    path = str(tmp_path / f"{fmt}.ply")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if fmt == "ascii":
            for p, i in zip(pts, inten):
                f.write((" ".join(repr(float(x)) for x in p)
                         + f" {i}\n").encode())
        else:
            rec = np.zeros(40, [("x", ">f4"), ("y", ">f4"), ("z", ">f4"),
                                ("i", "u1")])
            rec["x"], rec["y"], rec["z"], rec["i"] = *pts.T, inten
            f.write(rec.tobytes())
    got, ref = tply.read_ply(path), jply.read_ply(path)
    np.testing.assert_array_equal(got["points"], ref["points"])
    np.testing.assert_array_equal(got["points"], pts)
    assert got["normals"] is None and ref["normals"] is None


def test_estimate_normals_match_jax():
    rng = np.random.default_rng(9)
    pts = rng.normal(0, 5, (800, 3)).astype(np.float32)
    pts[:, 2] *= 0.05
    np.testing.assert_array_equal(tply.estimate_normals(pts),
                                  jply.estimate_normals(pts))
