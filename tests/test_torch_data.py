"""The port's host-side data path against the JAX package's, on the same
synthetic KITTI tree and seeds: the port keeps its own numpy copy of these
modules, so the outputs must be equal. Where the JAX package takes its host
C++ (`lidiff_tpu.native`: farthest point sampling, viewpoint filter) the
same points are selected; float32 values are compared exactly."""

import json

import numpy as np
import pytest

from lidiff_tpu.config import finalize_config as jax_finalize
from lidiff_tpu.data import collation as jcoll
from lidiff_tpu.data import preprocess as jpre
from lidiff_tpu.data import transforms as jtr
from lidiff_tpu.data.datasets import dataloaders as jax_dataloaders
from lidiff_tpu.data.datasets import dataloaders_refine as jax_dataloaders_refine
from lidiff_tpu.data.kitti import TemporalKITTIAggrDataset as JaxAggrDataset
from lidiff_tpu.ops.fps import fps as jax_fps
from lidiff_tpu.utils.natsort import natsorted as jax_natsorted
from lidiff_tpu_torch.config import finalize_config, load_config
from lidiff_tpu_torch.data import collation as tcoll
from lidiff_tpu_torch.data import preprocess as tpre
from lidiff_tpu_torch.data import transforms as ttr
from lidiff_tpu_torch.data.datasets import dataloaders, dataloaders_refine
from lidiff_tpu_torch.data.kitti import TemporalKITTIAggrDataset
from lidiff_tpu_torch.ops.fps import fps
from lidiff_tpu_torch.utils.natsort import natsorted
from tests.helpers import make_kitti_tree

NF = 600


def _cfg(data_dir, batch_size=2):
    return {
        "experiment": {"id": "torch_data"},
        "data": {"data_dir": data_dir, "resolution": 0.05,
                 "dataloader": "KITTI", "split": "train", "train": ["00"],
                 "validation": ["00"], "test": [], "num_points": NF,
                 "max_range": 50.0, "dataset_norm": False,
                 "std_axis_norm": False},
        "train": {"uncond_prob": 0.1, "uncond_w": 6.0, "n_gpus": 1,
                  "num_workers": 2, "max_epoch": 1, "lr": 1e-4,
                  "batch_size": batch_size},
        "diff": {"beta_start": 3.5e-5, "beta_end": 0.007,
                 "beta_func": "linear", "t_steps": 100, "s_steps": 2,
                 "reg_weight": 5.0},
        "model": {"out_dim": 96},
    }


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    make_kitti_tree(root, "00", n_scans=4, n_points=2000)
    return root


@pytest.mark.parametrize("loader", ["val_dataloader", "test_dataloader"])
def test_data_module_batches_equal(tree, loader):
    """The seeded (validation-split) loaders give the same batches."""
    cfg = _cfg(tree)
    ref = list(getattr(jax_dataloaders["KITTI"](jax_finalize(cfg)), loader)())
    got = list(getattr(dataloaders["KITTI"](finalize_config(cfg)), loader)())
    assert len(got) == len(ref) == (4 if loader == "val_dataloader" else 2)
    for g, r in zip(got, ref):
        assert g["filename"] == r["filename"]
        assert set(g) == set(r)
        for k in ("pcd_full", "pcd_part", "mean", "std"):
            assert g[k].dtype == np.float32 and g[k].shape == r[k].shape
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def test_train_loader_shapes_and_shuffle(tree):
    cfg = finalize_config(_cfg(tree))
    loader = dataloaders["KITTI"](cfg).train_dataloader()
    assert len(loader) == 2
    names = []
    for batch in loader:
        assert batch["pcd_full"].shape == (2, NF, 3)
        assert batch["pcd_part"].shape == (2, NF // 10, 3)
        assert np.isfinite(batch["pcd_full"]).all()
        names += batch["filename"]
    assert len(set(names)) == 4


def test_collation_pieces_equal():
    rng = np.random.default_rng(0)
    full = rng.normal(0, 25, (4000, 3))
    part = rng.normal(0, 15, (350, 3))
    np.testing.assert_array_equal(tcoll.viewpoint_filter(full, part),
                                  jcoll.viewpoint_filter(full, part))
    pts = rng.normal(0, 10, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(fps(pts, 60), jax_fps(pts, 60))
    np.testing.assert_array_equal(fps(pts, 600), pts)       # k >= n
    item_t = tcoll.point_set_to_sparse(full, part, 512, 64, "a.bin",
                                       rng=np.random.default_rng(5))
    item_j = jcoll.point_set_to_sparse(full, part, 512, 64, "a.bin",
                                       rng=np.random.default_rng(5))
    for k in ("pcd_full", "pcd_part", "mean", "std"):
        np.testing.assert_array_equal(item_t[k], item_j[k], err_msg=k)


def test_transforms_and_preprocess_equal(tree):
    pts = np.random.default_rng(1).normal(0, 10, (300, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        ttr.train_transforms(pts, np.random.default_rng(3)),
        jtr.train_transforms(pts, np.random.default_rng(3)))
    sdir = f"{tree}/dataset/sequences/00"
    tp = tpre.load_poses(f"{sdir}/calib.txt", f"{sdir}/poses.txt")
    jp = jpre.load_poses(f"{sdir}/calib.txt", f"{sdir}/poses.txt")
    np.testing.assert_array_equal(np.stack(tp), np.stack(jp))
    scan = f"{sdir}/velodyne/000001.bin"
    np.testing.assert_array_equal(tpre.read_scan(scan), jpre.read_scan(scan))
    label = f"{sdir}/labels/000001.label"
    np.testing.assert_array_equal(
        tpre.static_mask(tpre.read_labels(label)),
        jpre.static_mask(jpre.read_labels(label)))
    seq_map = np.load(f"{sdir}/map_clean.npy")
    np.testing.assert_array_equal(
        tpre.crop_map_to_scan(seq_map, tp[2], 30.0),
        jpre.crop_map_to_scan(seq_map, jp[2], 30.0))
    names = ["10.bin", "9.bin", "000100.bin", "2.bin"]
    assert natsorted(names) == jax_natsorted(names)


def test_load_config_json_and_yaml(tree, tmp_path, monkeypatch):
    import yaml
    cfg = _cfg(tree)
    with open(tmp_path / "c.json", "w") as f:
        json.dump(cfg, f)
    with open(tmp_path / "c.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    a = load_config(str(tmp_path / "c.json"))
    b = load_config(str(tmp_path / "c.yaml"))
    assert a == b
    assert a["tpu"]["full_capacities"] == \
        jax_finalize(cfg)["tpu"]["full_capacities"]
    monkeypatch.setenv("TRAIN_DATABASE", "/somewhere/else")
    assert load_config(str(tmp_path / "c.json"))["data"]["data_dir"] == \
        "/somewhere/else"


# ---------------- the refiner's data path ----------------

def _refine_cfg(data_dir, batch_size=2):
    cfg = _cfg(data_dir, batch_size)
    cfg["data"] = {**cfg["data"], "scan_window": 2, "num_points": 500}
    cfg["train"] = {**cfg["train"], "up_factor": 2}
    return cfg


def test_refine_transforms_and_preprocess_equal(tree):
    pts = np.random.default_rng(1).normal(0, 10, (300, 3)).astype(np.float32)
    for kw in ({}, {"sigma": 0.2, "clip": 0.3}):
        np.testing.assert_array_equal(
            ttr.jitter(pts, np.random.default_rng(3), **kw),
            jtr.jitter(pts, np.random.default_rng(3), **kw))
    pose = np.eye(4)
    pose[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    pose[:3, 3] = [2.0, -1.0, 0.5]
    np.testing.assert_array_equal(tpre.apply_transform(pts, pose),
                                  jpre.apply_transform(pts, pose))
    np.testing.assert_array_equal(tpre.undo_transform(pts, pose),
                                  jpre.undo_transform(pts, pose))
    np.testing.assert_allclose(
        tpre.undo_transform(tpre.apply_transform(pts, pose), pose), pts,
        atol=1e-5)
    for voxel in (0.1, 2.0):
        keep = tpre.voxel_unique_index(pts, voxel)
        np.testing.assert_array_equal(keep,
                                      jpre.voxel_unique_index(pts, voxel))
        cells = np.floor(pts[keep] / voxel).astype(np.int64)
        assert len(np.unique(cells, axis=0)) == len(keep)   # one per voxel
        assert (np.diff(keep) > 0).all()                    # order-stable
    sdir = f"{tree}/dataset/sequences/00"
    paths = [f"{sdir}/velodyne/{i:06d}.bin" for i in range(1, 4)]
    got = tpre.aggregate_pcds(paths, tree, 1)
    ref = jpre.aggregate_pcds(paths, tree, 1)
    for g, r in zip(got, ref):
        assert len(g) > 0
        np.testing.assert_array_equal(g, r)


def test_refine_collation_equal():
    rng = np.random.default_rng(0)
    full = rng.normal(0, 25, (900, 3))
    noise = rng.normal(0, 25, (1300, 3))
    item_t = tcoll.point_set_to_sparse_refine(full, noise, 1024, 512, "a.bin",
                                              rng=np.random.default_rng(5))
    item_j = jcoll.point_set_to_sparse_refine(full, noise, 1024, 512, "a.bin",
                                              rng=np.random.default_rng(5))
    assert set(item_t) == set(item_j)
    assert item_t["pcd_full"].shape == (1024, 3)       # tiled up
    assert item_t["pcd_noise"].shape == (512, 3)       # cut down
    for k in ("pcd_full", "pcd_noise", "mean", "std"):
        assert item_t[k].dtype == np.float32
        np.testing.assert_array_equal(item_t[k], item_j[k], err_msg=k)


@pytest.mark.parametrize("window,n_items", [(2, 2), (3, 1), (40, 1)])
def test_refine_dataset_items_equal(tree, window, n_items):
    """Seeded validation items, and the tail-merge rule of the windows."""
    kw = dict(data_dir=tree, scan_window=window, seqs=["00"],
              split="validation", resolution=0.05, num_points=500)
    got, ref = TemporalKITTIAggrDataset(**kw), JaxAggrDataset(**kw)
    assert len(got) == len(ref) == n_items
    assert got.points_datapath == ref.points_datapath
    for i in range(len(got)):
        g, r = got[i], ref[i]
        assert g["filename"] == r["filename"]
        assert g["pcd_full"].shape == (1000, 3)
        assert g["pcd_noise"].shape == (500, 3)
        for k in ("pcd_full", "pcd_noise", "mean", "std"):
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
        assert (np.linalg.norm(g["pcd_noise"], axis=-1) < 50.0).all()


@pytest.mark.parametrize("loader", ["val_dataloader", "test_dataloader"])
def test_refine_data_module_batches_equal(tree, loader):
    cfg = _refine_cfg(tree)
    ref = list(getattr(jax_dataloaders_refine["KITTI"](jax_finalize(cfg)),
                       loader)())
    got = list(getattr(dataloaders_refine["KITTI"](finalize_config(cfg)),
                       loader)())
    assert len(got) == len(ref) == (2 if loader == "val_dataloader" else 1)
    for g, r in zip(got, ref):
        assert g["filename"] == r["filename"] and set(g) == set(r)
        for k in ("pcd_full", "pcd_noise", "mean", "std"):
            assert g[k].dtype == np.float32
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def test_refine_train_loader_shapes(tree):
    cfg = finalize_config(_refine_cfg(tree, batch_size=1))
    loader = dataloaders_refine["KITTI"](cfg).train_dataloader()
    assert len(loader) == 2
    for batch in loader:
        assert batch["pcd_full"].shape == (1, 1000, 3)
        assert batch["pcd_noise"].shape == (1, 500, 3)
        assert np.isfinite(batch["pcd_noise"]).all()


def test_refine_default_config_matches_the_yaml():
    """`config/config_refine.json` carries the values of the JAX package's
    `config_refine.yaml`, less the keys nothing in the port reads."""
    import os

    import yaml

    import lidiff_tpu
    import lidiff_tpu_torch
    with open(os.path.join(os.path.dirname(lidiff_tpu.__file__),
                           "config/config_refine.yaml")) as f:
        ref = yaml.safe_load(f)
    with open(os.path.join(os.path.dirname(lidiff_tpu_torch.__file__),
                           "config/config_refine.json")) as f:
        got = json.load(f)
    for key in ("knn_block", "remat", "capacity_shrink"):
        ref["tpu"].pop(key)
    assert got == ref
    cfg = load_config(os.path.join(os.path.dirname(lidiff_tpu_torch.__file__),
                                   "config/config_refine.json"))
    assert cfg["train"]["up_factor"] == 6
    assert cfg["data"]["num_points"] == 180000
    assert cfg["tpu"]["full_capacities"] == \
        jax_finalize(ref)["tpu"]["full_capacities"]
