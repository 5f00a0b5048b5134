#!/usr/bin/env python3
"""How the pruned 1-NN matcher of the PyTorch port (kernel C2) answers to
the size of its upper-bound window and of its prunable blocks, on one GPU.

    python3 scripts/torch_c2_window_sweep.py

At the refiner's chamfer shape (1.08M jittered ring points against a
360k-point ring scan, both quantized and sorted as the grid chamfer does,
and back), for each (window rows, block rows): the share of (tile, block)
pairs the intervals keep, the longest interval, and the times of the
prolog and of the kernel by CUDA events. `lidiff_tpu_torch/ops/knn.py`
`window_rows` and `RBLK` were chosen from this table. Also times kernel C1
on the same calls, and one forward + backward of the grid chamfer.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SWEEP = ((512, 512), (1024, 512), (2048, 512), (4096, 512), (8192, 512),
         (4096, 256), (4096, 1024))


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from lidiff_tpu_torch.ops import chamfer, knn
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev, n = "cuda", cs.N_PART * cs.TILE
    noisy = cs.jittered(cs.ring_scan(n, seed=31), 32)
    offsets = np.random.default_rng(1).normal(0, 0.3, (1, n, cs.REFINE_UP, 3))
    up = torch.from_numpy((noisy[:, :, None, :] + offsets).reshape(-1, 3)
                          .astype(np.float32)).to(dev)
    gt = torch.from_numpy(cs.ring_scan(2 * n, seed=33)[0]).to(dev)
    res = chamfer._adaptive_res([(up, None), (gt, None)])
    xs, xm, _ = chamfer.grid_sort(up, None, res, 1)
    ys, ym, _ = chamfer.grid_sort(gt, None, res, 1)
    cases = (("upsampled -> target", (xs, xm, ys, ym)),
             ("target -> upsampled", (ys, ym, xs, xm)))
    for label, (q, qm, r, rm) in cases:
        c1_ms = cs._time_ms(lambda: knn.nn_match(q, r, rm, 1), 2)
        print(f"C1 {label}: {q.shape[0]} x {r.shape[0]}: {c1_ms:.3f} ms")
    # prune_intervals reads both names from its module at each call
    window_rows, rblk = knn.window_rows, knn.RBLK
    try:
        for window, block in SWEEP:
            knn.window_rows, knn.RBLK = (lambda n_refs, w=window: w), block
            for label, (q, qm, r, rm) in cases:
                start, cnt = knn.prune_intervals(q, qm, r, rm, 1)
                if int((start % block).max()) or int(
                        (cnt[start + cnt < r.shape[0]] % block).max()):
                    raise AssertionError(f"block {block} was not applied")
                ref = knn.nn_match(q, r, rm, 1)
                got = knn.nn_match_intervals(q, r, rm, start, cnt, 1)
                if not torch.equal(got[qm], ref[qm]):
                    raise AssertionError(f"window {window}, block {block}, "
                                         f"{label}: C2 differs from C1")
                p_ms = cs._time_ms(lambda: knn.prune_intervals(q, qm, r, rm,
                                                               1), 3)
                k_ms = cs._time_ms(lambda: knn.nn_match_intervals(
                    q, r, rm, start, cnt, 1), 3)
                kept = float(cnt.sum()) / (len(cnt) * r.shape[0])
                print(f"window {window:5d} block {block:5d} {label}: keeps "
                      f"{100 * kept:6.2f}%, longest {int(cnt.max()):8d} rows, "
                      f"prolog {p_ms:.3f} ms, kernel {k_ms:.3f} ms, together "
                      f"{p_ms + k_ms:.3f} ms")
    finally:
        knn.window_rows, knn.RBLK = window_rows, rblk

    a = up.reshape(1, -1, 3).clone().requires_grad_(True)
    b = gt.reshape(1, -1, 3).clone().requires_grad_(True)

    def step():
        chamfer.chamfer_distance(a, b).backward()
    print(f"grid chamfer, forward + backward, {a.shape[1]} x {b.shape[1]}: "
          f"{cs._time_ms(step, 3):.3f} ms")
    print(f"grid_sort of {up.shape[0]} points: "
          f"{cs._time_ms(lambda: chamfer.grid_sort(up, None, res, 1), 3):.3f}"
          " ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
