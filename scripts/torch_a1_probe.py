#!/usr/bin/env python3
"""Kernel A1, the 27-tap column conv of the PyTorch port, at the sampling
path's widths on one GPU, without the rest of chip_smoke.py.

    python3 scripts/torch_a1_probe.py [--all] [--a4] [--backward] [--c1]

Builds the kernels (printing ptxas's registers, shared memory and spills
per kernel), makes the sampling path's 180k-point pyramid (t ~ T) as
chip_smoke.py does, prints the tile plan's redundancy and build time per
level, and holds A1 against its plain version at (384, 256) L3 (every
width with --all), G in {1, 2}, float32 and bf16, with chip_smoke.py's
tolerances, then times it. --a4 adds kernel A4 (the int8 conv) at the
same widths, --backward A3 and A2's feats gradient, --c1 kernel C1 at
every level against both conditioning banks (chip_smoke.py's check_c1).
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--all", action="store_true",
                    help="every width of the path, not only (384, 256) L3")
    ap.add_argument("--a4", action="store_true", help="also kernel A4")
    ap.add_argument("--backward", action="store_true",
                    help="also A3 and A2's feats gradient")
    ap.add_argument("--c1", action="store_true",
                    help="also C1 at every level and both banks")
    args = ap.parse_args()
    import subprocess

    import torch

    import chip_smoke as cs
    from lidiff_tpu_torch import config as cfg_mod
    from lidiff_tpu_torch.models import diffusion
    from lidiff_tpu_torch.ops import knn, native, sparse_conv
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t0 = time.time()
    reports = native.build_all()
    cs.log(f"build: {len(reports)} libraries in {time.time() - t0:.1f} s")
    for name in ("conv3_columns", "conv3_columns_q", "conv3_columns_dw",
                 "nn_match"):
        if name in reports:
            cs.log_ptxas(name, reports[name])
    if not args.all:
        cs.A1_WIDTHS = [w for w in cs.A1_WIDTHS if w == cs.A1_TIMED[:3]]
    dev = "cuda"
    cfg = cfg_mod.finalize_config(cs.make_cfg(
        cs.N_PART * cs.TILE, 4, caps={"capacity_fractions": [1.0] * 5}))
    task = diffusion.DiffusionTask(cfg, device=dev,
                                   compute_dtype=torch.bfloat16, seed=0)
    part = torch.from_numpy(cs.ring_scan(cs.N_PART)).to(dev)
    x_init = part.repeat(1, cs.TILE, 1)
    gen = torch.Generator(device=dev).manual_seed(9)
    pyr = task.pyramid_full(x_init + torch.randn(x_init.shape, generator=gen,
                                                 device=dev))
    stats = cs.plan_stats(pyr, dev, "t~T")
    res = cs.check_a1(pyr, sparse_conv, dev, stats)
    cs.log(f"A1 {cs.A1_TIMED}: {res}")
    if args.a4:
        cs.log(f"A4 {cs.A1_TIMED}: {cs.check_a4(pyr, sparse_conv, dev)}")
    if args.c1:
        banks = {"cond": task.pyramid_part(part).levels[-1].geom,
                 "uncond": task.pyramid_part_tiny(
                     torch.zeros_like(part)).levels[-1].geom}
        cs.log(f"C1: {cs.check_c1(pyr, banks, knn)}")
    if args.backward:
        cs.log(f"A2/A3: {cs.check_backward(pyr, sparse_conv, dev)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
