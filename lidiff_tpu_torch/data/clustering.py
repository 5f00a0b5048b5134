"""Clustering support utilities, off the train and eval path (counterpart
of lidiff_tpu/data/clustering.py).

Instance clustering of non-ground points and cross-scan cluster overlap
bookkeeping, as the reference's support code has them. The backends, in
the JAX package's order: sklearn's HDBSCAN, else sklearn's DBSCAN, else
connected components of an occupancy grid (scipy), all behind one API.
"""

from __future__ import annotations

import numpy as np


def overlap_clusters(cluster_i: np.ndarray, cluster_j: np.ndarray,
                     min_cluster_point: int = 10):
    """Keep only cluster labels present (with enough points) in BOTH scans;
    everything else becomes -1."""
    uniq_i, cnt_i = np.unique(cluster_i, return_counts=True)
    uniq_i = uniq_i[cnt_i > min_cluster_point]
    uniq_j, cnt_j = np.unique(cluster_j, return_counts=True)
    uniq_j = uniq_j[cnt_j > min_cluster_point]
    common = np.intersect1d(uniq_i, uniq_j)
    common = common[common >= 0]
    cluster_i = np.where(np.isin(cluster_i, common), cluster_i, -1)
    cluster_j = np.where(np.isin(cluster_j, common), cluster_j, -1)
    return cluster_i, cluster_j


def _grid_components(points: np.ndarray, cell: float = 0.5,
                     min_cluster_size: int = 20) -> np.ndarray:
    """Fallback clustering: connected components over an occupancy grid
    (26-connectivity), labels sorted by size."""
    from scipy import ndimage
    c = np.floor(points / cell).astype(np.int64)
    cmin = c.min(0)
    c = c - cmin
    shape = c.max(0) + 1
    grid = np.zeros(shape, bool)
    grid[c[:, 0], c[:, 1], c[:, 2]] = True
    lbl, n = ndimage.label(grid, structure=np.ones((3, 3, 3), int))
    labels = lbl[c[:, 0], c[:, 1], c[:, 2]].astype(np.int64) - 1
    # drop small clusters
    uniq, cnt = np.unique(labels, return_counts=True)
    return np.where(np.isin(labels, uniq[cnt < min_cluster_size]), -1,
                    labels)


def clusters_hdbscan(points_set: np.ndarray,
                     n_clusters: int = 50) -> np.ndarray:
    """Cluster a point set; keep the n_clusters largest, label rest -1."""
    # a backend that is missing (ImportError) or refuses the input
    # (ValueError) hands over to the next
    try:
        from sklearn.cluster import HDBSCAN
        labels = HDBSCAN(min_cluster_size=20).fit(points_set).labels_
    except (ImportError, ValueError):
        try:
            from sklearn.cluster import DBSCAN
            labels = DBSCAN(eps=0.5, min_samples=20).fit(points_set).labels_
        except (ImportError, ValueError):
            labels = _grid_components(points_set)
    lbls, counts = np.unique(labels, return_counts=True)
    keep = lbls[lbls >= 0]
    cnts = counts[lbls >= 0]
    order = np.argsort(cnts)[::-1][:n_clusters]
    chosen = set(keep[order].tolist())
    return np.where(np.isin(labels, list(chosen)), labels, -1)


def clusterize_pcd(points: np.ndarray, ground: np.ndarray) -> np.ndarray:
    """Cluster non-ground points (ground label 9 excluded); returns [N,1]
    labels with -1 for ground/unclustered."""
    inliers = ground == 9
    labels = np.full((len(points), 1), -1.0)
    outlier_pts = points[~inliers][:, :3]
    if len(outlier_pts):
        labels[~inliers, 0] = clusters_hdbscan(outlier_pts)
    return labels


def point_set_to_coord_feats(point_set: np.ndarray, labels: np.ndarray,
                             resolution: float, num_points: int,
                             deterministic: bool = False):
    """Deterministic voxel downsample: first-per-voxel mapping, optionally
    subsampled to num_points with a fixed seed."""
    p_coord = np.round(point_set[:, :3] / resolution)
    p_coord -= p_coord.min(0, keepdims=True)
    from lidiff_tpu_torch.data.preprocess import voxel_unique_index
    mapping = voxel_unique_index(p_coord, 1.0)
    if len(mapping) > num_points:
        rng = np.random.default_rng(42)
        mapping = rng.choice(mapping, num_points, replace=False)
    return p_coord[mapping], point_set[mapping], labels[mapping]
