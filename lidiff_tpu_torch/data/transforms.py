"""Point-cloud augmentations (numpy), reference parity with
the reference lidiff/utils/pcd_transforms.py (train path only: full-yaw
rotation, small-angle perturbation, scale 0.95-1.05, y-flip p=0.5, jitter);
counterpart of lidiff_tpu/data/transforms.py.

All functions take/return [N, 3] and use an explicit np.random.Generator so
the input pipeline is seedable end to end (the reference relies on global
numpy state).
"""

from __future__ import annotations

import numpy as np


def rotate_yaw(points: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    a = rng.uniform() * 2 * np.pi
    c, s = np.cos(a), np.sin(a)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], points.dtype)
    return points @ R


def rotate_perturbation(points: np.ndarray, rng: np.random.Generator,
                        angle_sigma: float = 0.06,
                        angle_clip: float = 0.18) -> np.ndarray:
    ax, ay, az = np.clip(angle_sigma * rng.standard_normal(3),
                         -angle_clip, angle_clip)
    Rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)],
                   [0, np.sin(ax), np.cos(ax)]])
    Ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0],
                   [-np.sin(ay), 0, np.cos(ay)]])
    Rz = np.array([[np.cos(az), -np.sin(az), 0],
                   [np.sin(az), np.cos(az), 0], [0, 0, 1]])
    return points @ (Rz @ Ry @ Rx).astype(points.dtype)


def random_scale(points: np.ndarray, rng: np.random.Generator,
                 low: float = 0.95, high: float = 1.05) -> np.ndarray:
    return points * rng.uniform(low, high)


def random_flip_y(points: np.ndarray, rng: np.random.Generator,
                  p: float = 0.5) -> np.ndarray:
    if rng.random() > p:
        points = points.copy()
        points[:, 1] *= -1
    return points


def jitter(points: np.ndarray, rng: np.random.Generator,
           sigma: float = 0.01, clip: float = 0.05) -> np.ndarray:
    noise = np.clip(sigma * rng.standard_normal(points.shape), -clip, clip)
    return points + noise.astype(points.dtype)


def train_transforms(points: np.ndarray,
                     rng: np.random.Generator) -> np.ndarray:
    """The diffusion/refine train augmentation stack
    (SemanticKITTITemporal.py:69-76)."""
    points = rotate_yaw(points, rng)
    points = rotate_perturbation(points, rng)
    points = random_scale(points, rng)
    points = random_flip_y(points, rng)
    return points
