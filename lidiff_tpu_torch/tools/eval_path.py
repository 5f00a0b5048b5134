"""Full-sequence evaluation (counterpart of lidiff_tpu/tools/eval_path.py,
argparse in place of click).

    python -m lidiff_tpu_torch.tools.eval_path --data SEQ_DIR
        (-p SAVED_PLY_DIR | -d DIFF_EXP [-r REFINE_EXP] [-t T] [-s W])
        [-m MAX_RANGE] [--max_scans N] [--device cpu]

Takes each scan's completion, from the .ply files of a pipeline run (`-p`)
or completed live (`-d`, `-r`; LIDIFF_COMPUTE_DTYPE=bf16 computes in
bfloat16, LIDIFF_CONV_QUANT=int8 selects the int8 convs), rebuilds its
ground truth from the sequence's map_clean.npy (range crop, scan frame, z
in (-4, 4.4), the 10 m viewpoint filter), and
accumulates JSD 3D and BEV, RMSE, IoU at 0.5/0.2/0.1 m, Chamfer distance
and PR-AUC. It writes res_log.yaml (a JSON body, with the JAX package's
keys) into the `-p` directory, or the current one.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from lidiff_tpu_torch.config import (compute_dtype_from_env,
                                     conv_quant_from_env)
from lidiff_tpu_torch.data import preprocess
from lidiff_tpu_torch.data.collation import viewpoint_filter
from lidiff_tpu_torch.tools.diff_completion_pipeline import DiffCompletion
from lidiff_tpu_torch.utils import ply
from lidiff_tpu_torch.utils.histogram_metrics import compute_hist_metrics
from lidiff_tpu_torch.utils.metrics import (RMSE, ChamferDistance,
                                            CompletionIoU, PrecisionRecall)
from lidiff_tpu_torch.utils.natsort import natsorted


def get_scan_completion(scan_path: str, saved_path: str, diff_completion,
                        max_range: float):
    """(prediction, the scan cropped to max_range)."""
    points = preprocess.read_scan(scan_path)
    dist = np.linalg.norm(points, axis=-1)
    input_points = points[dist < max_range]
    if diff_completion is None:
        pred_file = os.path.join(
            saved_path,
            os.path.basename(scan_path).split(".")[0] + ".ply")
        pred = ply.read_ply(pred_file)["points"]
        pred = pred[np.linalg.norm(pred, axis=-1) < max_range]
    else:
        pred = diff_completion.complete_scan_diff(points)
    return pred, input_points


def get_ground_truth(pose: np.ndarray, cur_scan: np.ndarray,
                     seq_map: np.ndarray, max_range: float) -> np.ndarray:
    gt = preprocess.crop_map_to_scan(seq_map, pose, max_range,
                                     z_min=-4.0, z_max=4.4)
    keep = viewpoint_filter(gt, cur_scan, voxel=10.0)
    return gt[keep]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="lidiff_tpu_torch.tools.eval_path",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--path", "-p", type=str, default="",
                    help="path to pre-saved completions (skip inference)")
    ap.add_argument("--data", type=str,
                    default="./Datasets/SemanticKITTI/dataset/sequences/08",
                    help="sequence directory")
    ap.add_argument("--max_range", "-m", type=float, default=50.0)
    ap.add_argument("--denoising_steps", "-t", type=int, default=50)
    ap.add_argument("--cond_weight", "-s", type=float, default=6.0)
    ap.add_argument("--diff", "-d", type=str, default=None,
                    help="diffusion experiment dir (live completion)")
    ap.add_argument("--refine", "-r", type=str, default=None)
    ap.add_argument("--max_scans", type=int, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="'cpu' for the plain PyTorch path (default: cuda)")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    diff_completion = None
    if args.diff:
        diff_completion = DiffCompletion(
            args.diff, args.refine, args.denoising_steps, args.cond_weight,
            device=args.device, compute_dtype=compute_dtype_from_env(),
            conv_quant=conv_quant_from_env())

    data = args.data
    poses = preprocess.load_poses(os.path.join(data, "calib.txt"),
                                  os.path.join(data, "poses.txt"))
    seq_map = np.load(os.path.join(data, "map_clean.npy"))

    iou = CompletionIoU()
    rmse = RMSE()
    cd = ChamferDistance()
    pr = PrecisionRecall(0.05, 0.10, 100)
    jsd_3d, jsd_bev = [], []

    scans = natsorted(os.listdir(os.path.join(data, "velodyne")))
    pairs = list(zip(poses, scans))
    if args.max_scans:
        pairs = pairs[:args.max_scans]
    for pose, scan in pairs:
        pred, cur = get_scan_completion(
            os.path.join(data, "velodyne", scan), args.path, diff_completion,
            args.max_range)
        gt = get_ground_truth(pose, cur, seq_map, args.max_range)
        jsd_3d.append(compute_hist_metrics(gt, pred, bev=False))
        jsd_bev.append(compute_hist_metrics(gt, pred, bev=True))
        rmse.update(gt, pred)
        iou.update(gt, pred)
        cd.update(gt, pred)
        pr.update(gt, pred)
        print(f"{scan}: JSD3D {jsd_3d[-1]:.4f} JSDBEV {jsd_bev[-1]:.4f}")

    rmse_mean, rmse_std = rmse.compute()
    ious = iou.compute()
    cd_mean, cd_std = cd.compute()
    p, r, f1 = pr.compute_auc()

    print("\n=================== FINAL RESULTS ===================")
    print(f"JSD 3D: {np.mean(jsd_3d)}")
    print(f"JSD BEV: {np.mean(jsd_bev)}")
    print(f"RMSE: {rmse_mean} +- {rmse_std}")
    for v, x in ious.items():
        print(f"Voxel {v}m IoU: {x}")
    print(f"CD: {cd_mean} +- {cd_std}")
    print(f"Precision {p} Recall {r} F-Score {f1}")

    res = {
        "jsd": float(np.mean(jsd_bev)),
        "jsd_noclip_3d": float(np.mean(jsd_3d)),
        "rmse_mean": rmse_mean, "rmse_std": rmse_std,
        "ious": {str(k): v for k, v in ious.items()},
        "cd_mean": cd_mean, "cd_std": cd_std,
        "pr": p, "re": r, "f1": f1,
    }
    with open(os.path.join(args.path or ".", "res_log.yaml"), "w") as f:
        json.dump(res, f)
    return res


if __name__ == "__main__":
    main()
