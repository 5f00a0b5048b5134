"""Dataset normalization statistics (counterpart of
lidiff_tpu/tools/compute_data_stats.py, argparse in place of click).

    python -m lidiff_tpu_torch.tools.compute_data_stats -p TREE/dataset/sequences
        [-s 00,01,...] [-m 50] [--stride 10] [-o OUT.yml]

Over every `stride`-th scan of the sequences, the points at a range in
(3.5, max_range): the per-axis mean and standard deviation, their mean
(`std`), the point count and the range. Written as YAML, by default to
`lidiff_tpu_torch/utils/data_stats_range_{R}m.yml`, which the diffusion
dataset reads when `data.dataset_norm` is on (`data/kitti.py`). The file is
two flat maps of floats and three scalars, so it is written without
PyYAML, in the form `yaml.safe_dump` gives (sorted keys, floats that read
back exactly).
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np

from lidiff_tpu_torch.data import preprocess
from lidiff_tpu_torch.utils.natsort import natsorted

DEFAULT_SEQS = "00,01,02,03,04,05,06,07,09,10"


def compute_stats(path: str, seqs: str = DEFAULT_SEQS,
                  max_range: float = 50.0, stride: int = 10) -> dict:
    """The statistics of the scans under `path` (.../dataset/sequences)."""
    n = 0
    s1 = np.zeros(3)
    s2 = np.zeros(3)
    for seq in seqs.split(","):
        vdir = os.path.join(path, seq, "velodyne")
        for fname in natsorted(os.listdir(vdir))[::stride]:
            p = preprocess.read_scan(os.path.join(vdir, fname))
            d = np.linalg.norm(p, axis=-1)
            p = p[(d < max_range) & (d > 3.5)]
            s1 += p.sum(0)
            s2 += (p ** 2).sum(0)
            n += len(p)
    mean = s1 / n
    var = s2 / n - mean ** 2
    std_axis = np.sqrt(np.maximum(var, 0))
    return {
        "mean_axis": {k: float(v) for k, v in zip("xyz", mean)},
        "std_axis": {k: float(v) for k, v in zip("xyz", std_axis)},
        "std": float(std_axis.mean()),
        "n_points": int(n),
        "max_range": float(max_range),
    }


def _yaml_scalar(v) -> str:
    """A float or int as yaml.safe_dump writes it."""
    if isinstance(v, int):
        return str(v)
    if math.isnan(v):
        return ".nan"
    if math.isinf(v):
        return ".inf" if v > 0 else "-.inf"
    s = repr(float(v)).lower()
    if "." not in s and "e" in s:
        s = s.replace("e", ".0e", 1)
    return s


def to_yaml(stats: dict) -> str:
    """Block YAML of a map of scalars and flat maps of scalars, keys
    sorted."""
    lines = []
    for k in sorted(stats):
        v = stats[k]
        if isinstance(v, dict):
            lines.append(f"{k}:")
            lines += [f"  {kk}: {_yaml_scalar(v[kk])}" for kk in sorted(v)]
        else:
            lines.append(f"{k}: {_yaml_scalar(v)}")
    return "\n".join(lines) + "\n"


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="lidiff_tpu_torch.tools.compute_data_stats",
        description=__doc__.split("\n")[0])
    ap.add_argument("--path", "-p", type=str, required=True,
                    help="path to .../dataset/sequences")
    ap.add_argument("--seqs", "-s", type=str, default=DEFAULT_SEQS)
    ap.add_argument("--max_range", "-m", type=float, default=50.0)
    ap.add_argument("--stride", type=int, default=10,
                    help="use every Nth scan")
    ap.add_argument("--out", "-o", type=str, default=None)
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    stats = compute_stats(args.path, args.seqs, args.max_range, args.stride)
    out = args.out or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "utils",
        f"data_stats_range_{int(args.max_range)}m.yml")
    with open(out, "w") as f:
        f.write(to_yaml(stats))
    print(f"wrote {out}: {stats}")
    return stats


if __name__ == "__main__":
    main()
