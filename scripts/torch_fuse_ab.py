#!/usr/bin/env python3
"""The guided bf16 solver step with the classifier-free pair fused (one
G=2 forward) and unfused (`tpu.fuse_classfree: false`, two G=1 forwards
over one pyramid), timed in turns on one GPU.

    python3 scripts/torch_fuse_ab.py [--steps N] [--repeat R]

At chip_smoke.py's sampling shapes (180k points, full width, w=6, its
capacities), one task of each form from the same seed (the same weights),
the same offset and noise: R rounds of completions in the order fused,
unfused, unfused, fused, N guided steps each, ms per step by the host
clock (the completion less one encoding of the scan, as chip_smoke.py
reports it); then one step of each form under torch.profiler
(`chip_smoke.profile_step`: device time by kernel category, the busy
share, and the A1 kernels the profile holds beside the launches counted),
and two fused steps in one profile, which tells whether a profile holds
every kernel of a call that runs the model twice. Prints the card's name
and power limit first.
"""

import argparse
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=4,
                    help="guided steps per completion (default 4)")
    ap.add_argument("--repeat", type=int, default=3,
                    help="rounds of four completions (default 3)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from lidiff_tpu_torch import config as cfg_mod
    from lidiff_tpu_torch.diffusion.dpm_solver import make_dpm_solver
    from lidiff_tpu_torch.models import diffusion
    from lidiff_tpu_torch.ops import native
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    native.build_all()
    cfg = cfg_mod.finalize_config(cs.make_cfg(
        cs.N_PART * cs.TILE, args.steps,
        caps={"capacity_fractions": [1.0] * 5}))
    tasks = {form: diffusion.DiffusionTask(
        dict(cfg, tpu=dict(cfg["tpu"], fuse_classfree=form == "fused")),
        device="cuda", compute_dtype=torch.bfloat16, seed=0)
        for form in ("fused", "unfused")}
    part = torch.from_numpy(cs.ring_scan(cs.N_PART)).cuda()
    x_init = part.repeat(1, cs.TILE, 1)
    solver = make_dpm_solver("linear", 1000, args.steps, 3.5e-5, 0.007,
                             device="cuda")

    def step_ms(task) -> float:
        t0 = time.perf_counter()
        task.sample(x_init, part,
                    torch.Generator(device="cuda").manual_seed(1),
                    solver=solver)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        task.encode_banks(part)
        torch.cuda.synchronize()
        return (total_s - (time.perf_counter() - t0)) / args.steps * 1e3

    for task in tasks.values():             # warm-up
        step_ms(task)
    ms = {form: [] for form in tasks}
    for r in range(args.repeat):
        for form in ("fused", "unfused", "unfused", "fused"):
            ms[form].append(step_ms(tasks[form]))
        print(f"round {r}: fused {ms['fused'][-2]:.2f}, unfused "
              f"{ms['unfused'][-2]:.2f}, {ms['unfused'][-1]:.2f}, fused "
              f"{ms['fused'][-1]:.2f} ms per step", flush=True)
    med = {form: statistics.median(v) for form, v in ms.items()}
    print(f"median ms per step over {2 * args.repeat} completions each: "
          f"fused {med['fused']:.2f} (range {min(ms['fused']):.2f}-"
          f"{max(ms['fused']):.2f}), unfused {med['unfused']:.2f} (range "
          f"{min(ms['unfused']):.2f}-{max(ms['unfused']):.2f}), unfused / "
          f"fused {med['unfused'] / med['fused']:.3f}", flush=True)

    noisy = x_init + torch.randn(
        x_init.shape, generator=torch.Generator(device="cuda").manual_seed(9),
        device="cuda")
    t = int(solver.timesteps[0])
    for form, task in tasks.items():
        banks = task.encode_banks(part)
        cs.profile_step(lambda: task.denoise_pair(noisy, *banks, t),
                        f"one {form} guided step (t={t})")
    fused = tasks["fused"]
    banks = fused.encode_banks(part)
    cs.profile_step(lambda: [fused.denoise_pair(noisy, *banks, t)
                             for _ in range(2)],
                    f"two fused guided steps (t={t})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
