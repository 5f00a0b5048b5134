"""SemanticKITTI dataset for diffusion training (counterpart of
lidiff_tpu/data/kitti.py; the refine dataset comes with the refiner).

`TemporalKITTIDataset` is a numpy re-implementation of the reference
dataloader lidiff/datasets/dataloader/SemanticKITTITemporal.py: per-scan
diffusion items as fixed-shape float32 arrays via data/collation.py.
"""

from __future__ import annotations

import os

import numpy as np

from lidiff_tpu_torch.data import collation, preprocess, transforms
from lidiff_tpu_torch.utils.natsort import natsorted


def _seq_dir(data_dir: str, seq: str) -> str:
    return os.path.join(data_dir, "dataset", "sequences", seq)


class TemporalKITTIDataset:
    """Diffusion items: (dense map crop, partial scan) pairs.

    Reference semantics (SemanticKITTITemporal.py:78-128): static-label mask
    (1 < label < 252), range crop (3.5, max_range), z > -4; GT = cached
    map_clean.npy cropped to max_range around the pose, re-expressed in the
    scan frame; joint augmentation in train; n_part = num_points / 10.
    """

    def __init__(self, data_dir: str, seqs: list[str], split: str,
                 resolution: float, num_points: int, max_range: float,
                 dataset_norm: bool = False, std_axis_norm: bool = False,
                 seed: int = 42):
        self.data_dir = data_dir
        self.split = split
        self.resolution = resolution
        self.num_points = int(num_points)
        self.n_part = int(num_points // 10)
        self.max_range = max_range
        self.seed = seed
        self.cache_maps: dict[str, np.ndarray] = {}
        self.points_datapath: list[str] = []
        self.seq_poses: list[np.ndarray] = []

        for seq in seqs:
            sdir = _seq_dir(data_dir, seq)
            scans = natsorted(os.listdir(os.path.join(sdir, "velodyne")))
            poses = preprocess.load_poses(os.path.join(sdir, "calib.txt"),
                                          os.path.join(sdir, "poses.txt"))
            if split != "test":
                self.cache_maps[seq] = np.load(
                    os.path.join(sdir, "map_clean.npy"))
            for i, s in enumerate(scans):
                self.points_datapath.append(
                    os.path.join(sdir, "velodyne", s))
                self.seq_poses.append(poses[i])

        # optional dataset-level normalization stats
        self.data_stats = {"mean": None, "std": None}
        stats_file = os.path.join(
            os.path.dirname(__file__), "..", "utils",
            f"data_stats_range_{int(max_range)}m.yml")
        if dataset_norm and os.path.isfile(stats_file):
            import yaml    # only the optional stats file needs PyYAML
            with open(stats_file) as f:
                stats = yaml.safe_load(f)
            mean = np.array([stats["mean_axis"]["x"],
                             stats["mean_axis"]["y"],
                             stats["mean_axis"]["z"]])
            if std_axis_norm:
                std = np.array([stats["std_axis"]["x"],
                                stats["std_axis"]["y"],
                                stats["std_axis"]["z"]])
            else:
                std = np.array([stats["std"]] * 3)
            self.data_stats = {"mean": mean, "std": std}

    def __len__(self):
        return len(self.points_datapath)

    def __getitem__(self, index: int) -> dict:
        path = self.points_datapath[index]
        seq = path.split("/")[-3]
        p_part = preprocess.read_scan(path)
        if self.split != "test":
            lbl = preprocess.read_labels(
                path.replace("velodyne", "labels").replace(".bin", ".label"))
            p_part = p_part[preprocess.static_mask(lbl)]
        dist = np.linalg.norm(p_part, axis=-1)
        p_part = p_part[(dist < self.max_range) & (dist > 3.5)]
        p_part = p_part[p_part[:, 2] > -4.0]

        pose = self.seq_poses[index]
        if self.split != "test":
            p_full = preprocess.crop_map_to_scan(
                self.cache_maps[seq], pose, self.max_range)
        else:
            p_full = p_part

        rng = np.random.default_rng(
            None if self.split == "train" else self.seed + index)
        if self.split == "train":
            cat = np.concatenate((p_full, p_part), 0).astype(np.float32)
            cat = transforms.train_transforms(cat, rng)
            p_full = cat[:-len(p_part)]
            p_part = cat[-len(p_part):]

        return collation.point_set_to_sparse(
            p_full, p_part, self.num_points, self.n_part, path,
            p_mean=self.data_stats["mean"], p_std=self.data_stats["std"],
            rng=rng)
