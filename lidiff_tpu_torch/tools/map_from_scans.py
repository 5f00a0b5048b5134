"""The ground-truth map of a sequence, from its scans (counterpart of
lidiff_tpu/tools/map_from_scans.py, argparse in place of click).

    python -m lidiff_tpu_torch.tools.map_from_scans -p .../dataset/sequences
        [-v VOXEL_SIZE] [-s 00,01,...]

For each sequence: pose-transform every scan into the world frame, drop
moving and outlier classes and points nearer than 3.5 m, keep the first
point of each voxel of `voxel_size` not seen before (a persistent voxel set,
O(scan) per scan), and save `map_clean.npy` in the sequence directory, the
map that `lidiff_tpu_torch.tools.eval_path` reads.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from lidiff_tpu_torch.data import preprocess
from lidiff_tpu_torch.utils.natsort import natsorted

SEQS = ["00", "01", "02", "03", "04", "05", "06", "07", "08", "09", "10"]


def build_map(seq_dir: str, voxel_size: float,
              progress: bool = True) -> np.ndarray:
    poses = preprocess.load_poses(os.path.join(seq_dir, "calib.txt"),
                                  os.path.join(seq_dir, "poses.txt"))
    scans = natsorted(os.listdir(os.path.join(seq_dir, "velodyne")))
    seen: set[tuple] = set()
    chunks: list[np.ndarray] = []
    for i, (pose, fname) in enumerate(zip(poses, scans)):
        p = preprocess.read_scan(os.path.join(seq_dir, "velodyne", fname))
        lbl = preprocess.read_labels(
            os.path.join(seq_dir, "labels", fname.replace(".bin", ".label")))
        p = p[preprocess.static_mask(lbl)]
        p = p[np.linalg.norm(p, axis=-1) > 3.5]
        p = preprocess.apply_transform(p, pose).astype(np.float32)

        cells = np.floor(p / voxel_size).astype(np.int64)
        # incremental dedup: the first point of each cell not seen before
        keep = np.zeros(len(p), bool)
        local: set[tuple] = set()
        for j, c in enumerate(map(tuple, cells)):
            if c not in seen and c not in local:
                local.add(c)
                keep[j] = True
        seen.update(local)
        chunks.append(p[keep])
        if progress and i % 100 == 0:
            print(f"  scan {i}/{len(scans)}, map size "
                  f"{sum(len(c) for c in chunks)}")
    return np.concatenate(chunks, 0)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="lidiff_tpu_torch.tools.map_from_scans",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--path", "-p", type=str, required=True,
                    help="path to .../dataset/sequences")
    ap.add_argument("--voxel_size", "-v", type=float, default=0.1)
    ap.add_argument("--seqs", "-s", type=str, default=",".join(SEQS))
    return ap


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    for seq in args.seqs.split(","):
        seq_dir = os.path.join(args.path, seq)
        print(f"building map for sequence {seq}")
        m = build_map(seq_dir, args.voxel_size)
        np.save(os.path.join(seq_dir, "map_clean.npy"), m)
        print(f"saved {len(m)} points")


if __name__ == "__main__":
    main()
