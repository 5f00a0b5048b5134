"""Occupancy-histogram Jensen-Shannon metrics (counterpart of
lidiff_tpu/utils/histogram_metrics.py): the JSD between the ground truth's
and the prediction's occupancy over +-50 m at 0.5 m, in 3D or in bird's-eye
view. The dense 200^3 float64 histogram is 64 MB."""

from __future__ import annotations

import numpy as np
from scipy.spatial.distance import jensenshannon

from lidiff_tpu_torch.utils.metrics import ChamferDistance, PrecisionRecall


def histogram_point_cloud(points: np.ndarray, resolution: float,
                          max_range: float, bev: bool = False) -> np.ndarray:
    bins = int(2 * max_range / resolution)
    hist = np.histogramdd(
        points[:, :3], bins=bins,
        range=([-max_range, max_range], [-max_range, max_range],
               [-max_range, max_range]))[0]
    return np.clip(hist, 0.0, 1.0) if bev else hist


def compute_jsd(hist_gt: np.ndarray, hist_pred: np.ndarray,
                bev: bool = False) -> float:
    g = hist_gt.sum(-1) if bev else hist_gt
    p = hist_pred.sum(-1) if bev else hist_pred
    g = (g / g.sum()).flatten()
    p = (p / p.sum()).flatten()
    return float(jensenshannon(g, p))


def compute_hist_metrics(gt: np.ndarray, pred: np.ndarray,
                         bev: bool = False) -> float:
    h_pred = histogram_point_cloud(pred, 0.5, 50.0, bev)
    h_gt = histogram_point_cloud(gt, 0.5, 50.0, bev)
    return compute_jsd(h_gt, h_pred, bev)


def compute_chamfer(pred: np.ndarray, gt: np.ndarray) -> float:
    cd = ChamferDistance()
    cd.update(gt, pred)
    return cd.compute()[0]


def compute_precision_recall(pred: np.ndarray, gt: np.ndarray,
                             resolution: float = 0.05):
    pr = PrecisionRecall(resolution, 2 * resolution, 100)
    pr.update(gt, pred)
    return pr.compute_auc()
