"""The port's host tools on the CPU against the JAX package's modules:

  * `utils/prof.py`: `trace` writes a Chrome trace holding the `annotate`
    region; `block_and_time` returns the result and a duration;
  * `tools/compute_data_stats.py` on a synthetic KITTI tree: the JAX tool's
    values within 1e-12 and its YAML file byte for byte; the port's dataset
    reads the file;
  * `data/clustering.py`: the labels of each backend the JAX module reaches
    here (sklearn's HDBSCAN, the grid components) equal its labels, and
    `overlap_clusters`, `clusterize_pcd` and `point_set_to_coord_feats`
    equal its outputs; `data/data_map.py`'s tables equal its tables;
  * `tools/vis_pcd.py`: `crop` equals the JAX crop, `--save` writes a
    PNG through matplotlib, and without open3d and matplotlib it raises.
Everything is compared exactly but the statistics (float64 sums over the
same points in the same order: 1e-12 relative)."""

import os

import numpy as np
import pytest
import torch
import yaml

from lidiff_tpu.data import clustering as jclust
from lidiff_tpu.data import data_map as jmap
from lidiff_tpu.tools import compute_data_stats as jstats
from lidiff_tpu.tools import vis_pcd as jvis
from lidiff_tpu_torch.data import clustering as tclust
from lidiff_tpu_torch.data import data_map as tmap
from lidiff_tpu_torch.data.kitti import TemporalKITTIDataset
from lidiff_tpu_torch.tools import compute_data_stats as tstats
from lidiff_tpu_torch.tools import vis_pcd as tvis
from lidiff_tpu_torch.utils import prof as tprof
from tests.helpers import make_kitti_tree


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small tensor ops, which a
    thread pool slows down many times over when the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_trace_annotate_and_block_and_time(tmp_path):
    import json

    with tprof.trace(str(tmp_path)):
        with tprof.annotate("lidiff_region"):
            out, secs = tprof.block_and_time(
                lambda: {"y": torch.ones(64, 64) @ torch.ones(64, 64)})
    assert float(out["y"][0, 0]) == 64.0 and secs >= 0.0
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "lidiff_region" for e in events)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stats"))
    make_kitti_tree(root, "00", n_scans=4, n_points=1500)
    make_kitti_tree(root, "01", n_scans=3, n_points=1200, seed=1)
    return os.path.join(root, "dataset", "sequences")


def test_compute_data_stats_matches_jax(tree, tmp_path):
    args = ["-p", tree, "-s", "00,01", "--stride", "2", "-m", "37"]
    j_out, t_out = str(tmp_path / "jax.yml"), str(tmp_path / "torch.yml")
    jstats.main(args + ["-o", j_out], standalone_mode=False)
    stats = tstats.main(args + ["-o", t_out])
    with open(j_out) as f:
        j_text = f.read()
    with open(t_out) as f:
        t_text = f.read()
    want = yaml.safe_load(j_text)
    assert yaml.safe_load(t_text) == stats
    assert stats["n_points"] == want["n_points"] > 0
    assert stats["max_range"] == want["max_range"] == 37.0
    for sec in ("mean_axis", "std_axis"):
        for k in "xyz":
            np.testing.assert_allclose(stats[sec][k], want[sec][k],
                                       rtol=1e-12)
    np.testing.assert_allclose(stats["std"], want["std"], rtol=1e-12)
    assert t_text == j_text

    # the port's dataset reads the file where the tool writes it by default
    seq_root = os.path.dirname(os.path.dirname(tree))
    default = os.path.join(os.path.dirname(tstats.__file__), "..", "utils",
                           "data_stats_range_37m.yml")
    try:
        assert tstats.main(args) == stats
        for axis_norm in (False, True):
            ds = TemporalKITTIDataset(seq_root, ["00"], "train", 0.1, 512,
                                      37.0, dataset_norm=True,
                                      std_axis_norm=axis_norm)
            mean = [stats["mean_axis"][k] for k in "xyz"]
            std = ([stats["std_axis"][k] for k in "xyz"] if axis_norm
                   else [stats["std"]] * 3)
            np.testing.assert_array_equal(ds.data_stats["mean"], mean)
            np.testing.assert_array_equal(ds.data_stats["std"], std)
    finally:
        os.remove(default)


def _blobs(seed=0):
    """Three dense blobs, one sparse one and scattered noise, with a flat
    ground of label 9 under them."""
    rng = np.random.default_rng(seed)
    parts = [rng.normal(c, 0.3, (n, 3)) for c, n in
             (((0, 0, 1), 300), ((5, 5, 1), 200), ((-6, 4, 1), 120),
              ((8, -8, 1), 15))]
    noise = rng.uniform(-15, 15, (40, 3))
    ground = np.c_[rng.uniform(-15, 15, (400, 2)), np.zeros(400)]
    pts = np.concatenate(parts + [noise, ground]).astype(np.float32)
    labels = np.r_[np.zeros(len(pts) - 400, int), np.full(400, 9)]
    return pts, labels


def test_clustering_matches_jax():
    pts, ground = _blobs()
    obj = pts[ground != 9]
    np.testing.assert_array_equal(tclust.clusters_hdbscan(obj),
                                  jclust.clusters_hdbscan(obj))
    np.testing.assert_array_equal(tclust.clusters_hdbscan(obj, n_clusters=2),
                                  jclust.clusters_hdbscan(obj, n_clusters=2))
    for cell, size in ((0.5, 20), (1.0, 5)):
        np.testing.assert_array_equal(
            tclust._grid_components(obj, cell, size),
            jclust._grid_components(obj, cell, size))
    got = tclust.clusterize_pcd(pts, ground)
    np.testing.assert_array_equal(got, jclust.clusterize_pcd(pts, ground))
    assert got.shape == (len(pts), 1) and (got[ground == 9] == -1).all()
    assert len(np.unique(got[got >= 0])) >= 3


def test_overlap_and_coord_feats_match_jax():
    rng = np.random.default_rng(3)
    ci = rng.integers(-1, 8, 500)
    cj = rng.integers(-1, 6, 400)
    for m in (5, 10, 60):
        for a, b in zip(tclust.overlap_clusters(ci, cj, m),
                        jclust.overlap_clusters(ci, cj, m)):
            np.testing.assert_array_equal(a, b)
    pts, _ = _blobs(1)
    labels = rng.integers(0, 5, len(pts))
    for n in (100, 10_000):
        for a, b in zip(tclust.point_set_to_coord_feats(pts, labels, 0.2, n),
                        jclust.point_set_to_coord_feats(pts, labels, 0.2, n)):
            np.testing.assert_array_equal(a, b)


def test_data_map_tables_equal():
    for name in ("LEARNING_MAP", "LABELS", "COLOR_MAP_BGR",
                 "MOVING_CLASS_START"):
        assert getattr(tmap, name) == getattr(jmap, name), name


def test_vis_pcd_crop_and_save(tmp_path, monkeypatch):
    import sys
    pts, _ = _blobs(2)
    pts = pts * 4
    for radius, z_min in ((50.0, -4.0), (20.0, 0.5)):
        np.testing.assert_array_equal(tvis.crop(pts, radius, z_min),
                                      jvis.crop(pts, radius, z_min))
    path = str(tmp_path / "cloud.npy")
    np.save(path, pts)
    png = str(tmp_path / "cloud.png")
    tvis.main(["-p", path, "-r", "30", "--save", png])
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    # with neither open3d nor matplotlib (the card machine) it raises
    monkeypatch.setitem(sys.modules, "open3d", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="open3d or matplotlib"):
        tvis.main(["-p", path, "--save", png])
