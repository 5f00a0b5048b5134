"""Per-item preparation and batching to fixed shapes (counterpart of
lidiff_tpu/data/collation.py).

Numpy re-design of the reference lidiff/utils/collations.py:

  * `point_set_to_sparse`       (ref :41-63)  — diffusion items: tile the
    partial scan, build the 10 m viewpoint grid from it, FPS to n_part
    (the host C++ kernel: a loader worker's FPS stays on the host),
    viewpoint-filter the GT map crop, shuffle+tile GT to exactly n_full,
    per-item mean/std.
  * `point_set_to_sparse_refine` (ref :66-82) — refine items: shuffle+tile
    both clouds to fixed sizes.
  * `collate`                   (ref :85-99)  — stack to a batch dict.

Everything returns fixed-size float32 arrays.
"""

from __future__ import annotations

import numpy as np

from lidiff_tpu_torch.native import viewpoint_filter_native
from lidiff_tpu_torch.ops.fps import fps


def viewpoint_filter(full: np.ndarray, part: np.ndarray,
                     voxel: float = 10.0) -> np.ndarray:
    """Boolean mask of `full` points lying in `voxel`-sized cells occupied
    by `part` (Open3D VoxelGrid.check_if_included parity: grid origin at the
    partial cloud's min bound), by the host C++ kernel as in the JAX
    package."""
    return viewpoint_filter_native(full, part, voxel)


def viewpoint_filter_numpy(full: np.ndarray, part: np.ndarray,
                           voxel: float = 10.0) -> np.ndarray:
    """`viewpoint_filter` in numpy, its cells computed in float32 (the C++
    kernel's in float64: a point within rounding of a cell's face may fall
    on the other side)."""
    origin = part[:, :3].min(0)

    def cells(p):
        return np.floor((p[:, :3] - origin) / voxel).astype(np.int64)

    occ, c = cells(part), cells(full)
    # one int64 key per cell over the joint bounding box of both clouds
    lo = np.minimum(occ.min(0), c.min(0)) if len(c) else occ.min(0)
    span = (np.maximum(occ.max(0), c.max(0)) if len(c) else occ.max(0)) \
        - lo + 1

    def key(x):
        x = x - lo
        return (x[:, 0] * span[1] + x[:, 1]) * span[2] + x[:, 2]

    return np.isin(key(c), np.unique(key(occ)))


def _tile_to(points: np.ndarray, n: int,
             rng: np.random.Generator | None) -> np.ndarray:
    """Shuffle (optional) then repeat-tile to exactly n rows (ref :54-55)."""
    if rng is not None:
        points = points[rng.permutation(len(points))]
    reps = int(np.ceil(n / max(len(points), 1)))
    return np.tile(points, (reps, 1))[:n]


def point_set_to_sparse(p_full: np.ndarray, p_part: np.ndarray, n_full: int,
                        n_part: int, filename: str,
                        p_mean=None, p_std=None,
                        rng: np.random.Generator | None = None) -> dict:
    rng = rng or np.random.default_rng()
    # tile partial up to >= n_part before FPS (ref :42-47)
    reps = int(np.ceil(n_part / max(len(p_part), 1)))
    p_part_t = np.tile(p_part, (reps, 1))
    p_part_out = fps(p_part_t.astype(np.float32), n_part)

    keep = viewpoint_filter(p_full, p_part_t)
    p_full = p_full[keep]
    p_full = _tile_to(p_full.astype(np.float32), n_full, rng)

    mean = p_full.mean(0) if p_mean is None else np.asarray(p_mean)
    std = p_full.std(0) if p_std is None else np.asarray(p_std)
    return {
        "pcd_full": p_full.astype(np.float32),
        "mean": mean.astype(np.float32),
        "std": std.astype(np.float32),
        "pcd_part": p_part_out.astype(np.float32),
        "filename": filename,
    }


def point_set_to_sparse_refine(p_full: np.ndarray, p_part: np.ndarray,
                               n_full: int, n_part: int, filename: str,
                               rng: np.random.Generator | None = None
                               ) -> dict:
    rng = rng or np.random.default_rng()
    p_full = _tile_to(p_full.astype(np.float32), n_full, rng)
    p_part = _tile_to(p_part.astype(np.float32), n_part, rng)
    return {
        "pcd_full": p_full,
        "mean": p_full.mean(0).astype(np.float32),
        "std": p_full.std(0).astype(np.float32),
        "pcd_noise": p_part,
        "filename": filename,
    }


def collate(items: list[dict], part_key: str = "pcd_part") -> dict:
    """Stack per-item dicts into a fixed-shape batch
    (SparseSegmentCollation parity, ref :85-99)."""
    return {
        "pcd_full": np.stack([it["pcd_full"] for it in items]),
        "mean": np.stack([it["mean"] for it in items]),
        "std": np.stack([it["std"] for it in items]),
        part_key: np.stack([it[part_key] for it in items]),
        "filename": [it["filename"] for it in items],
    }
