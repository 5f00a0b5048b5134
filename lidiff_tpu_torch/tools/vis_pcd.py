"""Point-cloud viewer (counterpart of lidiff_tpu/tools/vis_pcd.py, argparse
in place of click).

    python -m lidiff_tpu_torch.tools.vis_pcd -p CLOUD [-r 50] [-z -4]
        [-s OUT.png]

Reads a .bin, .ply or .npy cloud, keeps the points within `radius` of the
sensor in x-y and above `z_min`, and shows them with Open3D where it is
installed, else as a matplotlib scatter (`--save` writes a PNG instead of
opening a window). Without either package it raises.
"""

from __future__ import annotations

import argparse

import numpy as np

from lidiff_tpu_torch.tools.diff_completion_pipeline import load_pcd


def crop(points: np.ndarray, radius: float, z_min: float) -> np.ndarray:
    d = np.linalg.norm(points[:, :2], axis=-1)
    return points[(d < radius) & (points[:, 2] > z_min)]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="lidiff_tpu_torch.tools.vis_pcd",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--pcd", "-p", type=str, required=True)
    ap.add_argument("--radius", "-r", type=float, default=50.0)
    ap.add_argument("--z_min", "-z", type=float, default=-4.0)
    ap.add_argument("--save", "-s", type=str, default=None,
                    help="save a PNG instead of opening a window")
    return ap


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    points = crop(load_pcd(args.pcd), args.radius, args.z_min)
    try:
        import open3d as o3d
    except ImportError:
        o3d = None
    if o3d is not None:
        cloud = o3d.geometry.PointCloud()
        cloud.points = o3d.utility.Vector3dVector(points)
        o3d.visualization.draw_geometries([cloud])
        return
    try:
        import matplotlib
    except ImportError:
        raise RuntimeError("vis_pcd needs open3d or matplotlib; neither is "
                           "installed") from None
    if args.save:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure(figsize=(10, 10))
    ax = fig.add_subplot(projection="3d")
    sub = points[:: max(1, len(points) // 200000)]
    ax.scatter(sub[:, 0], sub[:, 1], sub[:, 2], s=0.1, c=sub[:, 2],
               cmap="viridis")
    ax.set_box_aspect((1, 1, 0.2))
    if args.save:
        fig.savefig(args.save, dpi=150)
        plt.close(fig)
        print(f"saved {args.save}")
    else:
        plt.show()


if __name__ == "__main__":
    main()
