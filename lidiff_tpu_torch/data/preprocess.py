"""KITTI pose/calib parsing, scan reading, map crops, scan aggregation and
voxel dedup on the host (counterpart of lidiff_tpu/data/preprocess.py).

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


def apply_transform(points: np.ndarray, pose: np.ndarray) -> np.ndarray:
    h = np.hstack((points[:, :3], np.ones_like(points[:, :1])))
    return (h @ pose.T)[:, :3]


def undo_transform(points: np.ndarray, pose: np.ndarray) -> np.ndarray:
    return apply_transform(points, np.linalg.inv(pose))


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


def voxel_unique_index(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """First-point-per-voxel indices at `voxel_size` (floor grid), the
    semantics of ME.utils.sparse_quantize(return_index=True). Deterministic
    and order-stable."""
    c = np.floor(points[:, :3] / voxel_size).astype(np.int64)
    # one int64 key per voxel (coords bounded by scene size / voxel)
    c = c - c.min(0)
    span = c.max(0) + 1
    key = (c[:, 0] * span[1] + c[:, 1]) * span[2] + c[:, 2]
    _, idx = np.unique(key, return_index=True)
    return np.sort(idx)


def aggregate_pcds(scan_paths: list[str], data_dir: str,
                   t_frame: int) -> tuple[np.ndarray, np.ndarray]:
    """Aggregate a window of scans into a static map expressed in the frame
    of the window's last scan (reference pcd_preprocess.py:78-129).

    Returns (pcd_full: all scans but `t_frame` aggregated, pcd_part: scan
    `t_frame`)."""
    datapath = scan_paths[0].split("velodyne")[0]
    poses = load_poses(os.path.join(datapath, "calib.txt"),
                       os.path.join(datapath, "poses.txt"))
    full = []
    part = None
    fname = None
    for t, path in enumerate(scan_paths):
        fname = os.path.basename(path).split(".")[0]
        p = read_scan(path)
        lbl = read_labels(path.replace("velodyne", "labels")
                          .replace(".bin", ".label"))
        p = p[lbl < 252]                       # keep static points (ref :105)
        dist = np.linalg.norm(p, axis=-1)
        p = p[dist > 3.5]                      # flying artifacts (ref :111)
        p = apply_transform(p, poses[int(fname)])
        if t == t_frame:
            part = p.copy()
        else:
            full.append(p)

    pose_last = poses[int(fname)]
    pcd_full = undo_transform(np.concatenate(full, 0), pose_last)
    pcd_part = undo_transform(part, pose_last)
    return pcd_full, pcd_part


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
