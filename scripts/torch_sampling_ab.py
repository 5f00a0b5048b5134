#!/usr/bin/env python3
"""Kernel B1 with the tile plan, and the guided bf16 solver step, timed the
same way for any checkout of the port, on one GPU.

    python3 scripts/torch_sampling_ab.py [--tree DIR] [--steps N]
                                         [--repeat R]

--tree names the checkout whose `lidiff_tpu_torch` and `chip_smoke.py` are
timed (default: this one). The script uses only what every slice of the
port has: chip_smoke.py's `make_cfg`, `ring_scan`, `N_PART` and `TILE`;
`grid.kmap3_columns`, `grid.build_kmap3_columns` and
`ColumnKernelMap.plan()`; `DiffusionTask.sample`. To compare two trees,
run it once per tree, alternating (parent, change, change, parent), within
one call on one machine.

Per level of the sampling path's 180k-point pyramid (t ~ T): B1 alone, and
B1 with the tile plan as the path builds them (`build_kmap3_columns(geom)`
then `.plan()`), each by CUDA events around 20 back-to-back calls ("paced":
the card waits for the host between small kernels, as on the path) and
queued behind a spin kernel ("device": the card's own time). Then R
completions of N guided steps: ms per step by the host clock, the
completion less one encoding of the scan, as chip_smoke.py reports it.
Prints the card's name and power limit first.
"""

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPIN_HZ = 2e9   # spin cycles a second: above the H100's clock


def paced_ms(fn, iters: int = 20) -> float:
    """Mean time per call by CUDA events around `iters` back-to-back calls,
    after a warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """The same calls queued behind a spin kernel that outlasts their issue
    on the host: the gaps in which the card waits for the host drop out.
    fn() must not make the host wait for the card."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    issue_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * issue_s + 1e-3) * SPIN_HZ))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout to time (default: this one)")
    ap.add_argument("--steps", type=int, default=4,
                    help="guided steps per completion (default 4)")
    ap.add_argument("--repeat", type=int, default=3,
                    help="timed completions (default 3)")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from lidiff_tpu_torch import config as cfg_mod
    from lidiff_tpu_torch.diffusion.dpm_solver import make_dpm_solver
    from lidiff_tpu_torch.models import diffusion
    from lidiff_tpu_torch.ops import grid, native
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print(f"tree {tree}", flush=True)
    native.build_all()
    cfg = cfg_mod.finalize_config(cs.make_cfg(
        cs.N_PART * cs.TILE, args.steps,
        caps={"capacity_fractions": [1.0] * 5}))
    task = diffusion.DiffusionTask(cfg, device="cuda",
                                   compute_dtype=torch.bfloat16, seed=0)
    part = torch.from_numpy(cs.ring_scan(cs.N_PART)).cuda()
    x_init = part.repeat(1, cs.TILE, 1)
    gen = torch.Generator(device="cuda").manual_seed(9)
    pyr = task.pyramid_full(x_init + torch.randn(x_init.shape, generator=gen,
                                                 device="cuda"))
    for li, lvl in enumerate(pyr.levels):
        g = lvl.geom

        def b1():
            return grid.kmap3_columns(g.key, g.coords, g.mask, g.stride)

        def b1_plan():
            return grid.build_kmap3_columns(g).plan()
        print(f"L{li} V={g.capacity}: B1 paced {paced_ms(b1):.4f} ms, device "
              f"{device_ms(b1):.4f} ms; B1 and the plan paced "
              f"{paced_ms(b1_plan):.4f} ms, device {device_ms(b1_plan):.4f} "
              f"ms", flush=True)
    del pyr

    solver = make_dpm_solver("linear", 1000, args.steps, 3.5e-5, 0.007,
                             device="cuda")
    task.sample(x_init, part, torch.Generator(device="cuda").manual_seed(2),
                solver=solver)
    torch.cuda.synchronize()
    for k in range(args.repeat):
        t0 = time.time()
        task.sample(x_init, part,
                    torch.Generator(device="cuda").manual_seed(1),
                    solver=solver)
        torch.cuda.synchronize()
        total_s = time.time() - t0
        t0 = time.time()
        task.encode_banks(part)
        torch.cuda.synchronize()
        enc_s = time.time() - t0
        print(f"completion {k}: {args.steps} guided steps, "
              f"{(total_s - enc_s) / args.steps * 1e3:.2f} ms per step, "
              f"encoder {enc_s * 1e3:.1f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
