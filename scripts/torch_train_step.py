#!/usr/bin/env python3
"""Diffusion training steps at full width on one GPU, timed as
chip_smoke.py times them, without the rest of chip_smoke.py.

    python3 scripts/torch_train_step.py [--refiner] [--syncs]

Builds the kernels, then takes chip_smoke.py's TRAIN_WARMUP + TRAIN_STEPS
optimizer steps on the 180k-point synthetic scan (bf16 compute, float32
activations, batch 1): per-step forward, backward and optimizer ms by CUDA
events, launches per step (checked), peak memory and a profile of one
step. --refiner runs the refiner's steps instead (C2 checks included).
--syncs counts, for every step, the calls that make the host wait for the
card (torch's CUDA sync debug mode warns at each), by the line that made
them; the steps' times are then not comparable. Prints the card's name
and power limit first. To compare two trees, run each in its own process,
alternating, within one call on one machine.
"""

import argparse
import collections
import os
import subprocess
import sys
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def count_syncs() -> None:
    """Wrap `Trainer.train_step` so that each step prints how many calls
    made the host wait for the card, and the lines that made most."""
    import torch
    from lidiff_tpu_torch.training.trainer import Trainer
    step = Trainer.train_step

    def counted(self, *a, **kw):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return step(self, *a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                where = collections.Counter(
                    f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                    for w in seen if "synchroniz" in str(w.message))
                print(f"host syncs in one step: {sum(where.values())}; "
                      f"{where.most_common(8)}", flush=True)

    Trainer.train_step = counted


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--refiner", action="store_true",
                    help="the refiner's training steps")
    ap.add_argument("--syncs", action="store_true",
                    help="count the host syncs of each step")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from lidiff_tpu_torch import config as cfg_mod
    from lidiff_tpu_torch.ops import native
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    native.build_all()
    cfg = cfg_mod.finalize_config(cs.make_cfg(
        cs.N_PART * cs.TILE, 4, caps={"capacity_fractions": [1.0] * 5}))
    part = torch.from_numpy(cs.ring_scan(cs.N_PART)).cuda()
    x_init = part.repeat(1, cs.TILE, 1)
    kernels = cs.kernel_table()
    if args.syncs:
        count_syncs()
    if args.refiner:
        cs.run_refine(cfg, kernels, "cuda")
    else:
        cs.run_training(cfg, kernels, x_init, part, "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
