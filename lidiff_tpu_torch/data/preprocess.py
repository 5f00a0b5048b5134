"""KITTI pose/calib parsing, scan reading and map crops on the host
(counterpart of lidiff_tpu/data/preprocess.py; scan aggregation and voxel
dedup come with the refiner).

Numpy re-implementation of the reference geometry preprocessing
(lidiff/utils/pcd_preprocess.py): calibration-conjugated poses
(Tr^-1 @ P @ Tr) and static-point masks.
"""

from __future__ import annotations

import os

import numpy as np


def parse_calibration(filename: str) -> dict:
    calib = {}
    with open(filename) as f:
        for line in f:
            if ":" not in line:
                continue
            key, content = line.strip().split(":", 1)
            values = [float(v) for v in content.strip().split()]
            pose = np.zeros((4, 4))
            pose[0, :4] = values[0:4]
            pose[1, :4] = values[4:8]
            pose[2, :4] = values[8:12]
            pose[3, 3] = 1.0
            calib[key] = pose
    return calib


def load_poses(calib_fname: str, poses_fname: str) -> list[np.ndarray]:
    """Velodyne-frame poses: Tr^-1 @ P @ Tr when calib exists
    (reference pcd_preprocess.py:45-68)."""
    use_calib = os.path.exists(calib_fname)
    if use_calib:
        Tr = parse_calibration(calib_fname)["Tr"]
        Tr_inv = np.linalg.inv(Tr)
    poses = []
    with open(poses_fname) as f:
        for line in f:
            values = [float(v) for v in line.strip().split()]
            if not values:
                continue
            pose = np.zeros((4, 4))
            pose[0, :4] = values[0:4]
            pose[1, :4] = values[4:8]
            pose[2, :4] = values[8:12]
            pose[3, 3] = 1.0
            poses.append(Tr_inv @ pose @ Tr if use_calib else pose)
    return poses


def read_scan(path: str) -> np.ndarray:
    """KITTI .bin -> [N, 3] float32 (drops remission)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)[:, :3]


def read_labels(path: str) -> np.ndarray:
    """KITTI .label -> [N] uint16 semantic labels (low 16 bits)."""
    l = np.fromfile(path, dtype=np.uint32).reshape(-1)
    return (l & 0xFFFF).astype(np.uint32)


def static_mask(labels: np.ndarray, drop_outliers: bool = True) -> np.ndarray:
    """Drop moving classes (>= 252) and, optionally, outlier/unlabeled
    classes (<= 1) — reference SemanticKITTITemporal.py:90."""
    m = labels < 252
    if drop_outliers:
        m &= labels > 1
    return m


def crop_map_to_scan(seq_map: np.ndarray, pose: np.ndarray,
                     max_range: float, z_min: float = -4.0,
                     z_max: float | None = None) -> np.ndarray:
    """Crop the sequence map around a pose and express it in the scan frame
    (reference SemanticKITTITemporal.py:97-105 / eval_path.py:84-92)."""
    trans = pose[:-1, -1]
    dist = np.linalg.norm(seq_map - trans, axis=-1)
    m = seq_map[dist < max_range]
    m = np.concatenate((m, np.ones((len(m), 1))), axis=-1)
    m = (m @ np.linalg.inv(pose).T)[:, :3]
    sel = m[:, 2] > z_min
    if z_max is not None:
        sel &= m[:, 2] < z_max
    return m[sel]
