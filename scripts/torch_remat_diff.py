#!/usr/bin/env python3
"""Remat on against remat off at full width in float32 on one GPU: how far
the two training steps are apart, beside how far two runs of one mode are,
and where the difference comes from.

    python3 scripts/torch_remat_diff.py [--runs N] [--syncs]

For the diffusion step (chip_smoke.py's 180k-point ring scan, batch 1) and
the refiner step (180k jittered points, up_factor 6, a 360k-point target),
float32 compute, each run one loss and backward pass of a fresh task of one
seed on the same inputs and draws: N runs with remat off and N with remat
on (default 2 each), first with torch's default scatter-adds (`index_add_`
and the index backward add in atomic order on the card), then under
`torch.use_deterministic_algorithms(True)` (both sorted). For every pair of
runs it prints the loss's relative difference and the worst gradient leaves
in units of check_small_train's tolerance (chip_smoke.step_differences),
and for every remat run whether each stage's recompute gave its first
forward's output (the largest |difference|). --syncs then runs 2 + 3
full-width diffusion steps (bf16, remat on) through `Trainer.train_step`
and prints each step's host syncs by the port's frame nearest each sync
(chip_smoke._host_syncs), with the whole stack of any sync outside the
port. Prints the card's name and power limit first.
"""

import argparse
import itertools
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def watch_recompute(model):
    """Forward hooks on every DownStage and UpStage: the first call's
    output is kept, and a second call (the recompute) records the largest
    |difference| from it. Returns that {stage: difference} dict."""
    import torch

    from lidiff_tpu_torch.models.blocks import DownStage, UpStage
    first, diff = {}, {}

    def hook(name):
        @torch.no_grad()
        def fn(_m, _a, out):
            if name in first:
                diff[name] = float((out - first.pop(name)).abs().max())
            else:
                first[name] = out.clone()
        return fn

    for name, m in model.named_modules():
        if isinstance(m, (DownStage, UpStage)):
            m.register_forward_hook(hook(name))
    return diff


def worst_leaves(got, ref, k: int = 4):
    """The k gradient leaves of `got` farthest from `ref` in units of
    check_small_train's tolerance, and how many leaves are equal bit for
    bit."""
    import chip_smoke as cs
    g_got, g_ref = got[1], ref[1]
    top = max(float(g.abs().max()) for g in g_ref.values())
    ratios = sorted(((float((g_got[n] - r).abs().max())
                      / (cs.TRAIN_GRAD_TOL * float(r.abs().max())
                         + cs.TRAIN_GRAD_ATOL * top), n)
                     for n, r in g_ref.items()), reverse=True)
    same = sum(bool((g_got[n] == r).all()) for n, r in g_ref.items())
    return ratios[:k], same, len(g_ref)


def compare(what, make_task, batch, draws, runs: int) -> None:
    import torch
    from torch.utils import checkpoint

    import chip_smoke as cs
    for det in (False, True):
        torch.use_deterministic_algorithms(det, warn_only=True)
        # new tensors as the step makes them otherwise (not filled with NaN)
        torch.utils.deterministic.fill_uninitialized_memory = False
        mode = "deterministic" if det else "atomic"
        steps = {}
        for remat in (False, True):
            for i in range(runs):
                task = make_task(remat)
                diff = watch_recompute(task.model) if remat else {}
                # every recompute runs its stage to the end (no early stop)
                with checkpoint.set_checkpoint_early_stop(False):
                    steps[f"{'on' if remat else 'off'}{i}"] = cs.grad_step(
                        task, batch, draws)
                if remat:
                    cs.log(f"{what}, {mode}, remat run {i}: the recompute "
                           f"against the first forward, largest |difference|"
                           f" of a stage's output "
                           f"{max(diff.values()):.3e} "
                           f"({sum(v == 0 for v in diff.values())} of "
                           f"{len(diff)} stages equal)")
                del task
        for a, b in itertools.combinations(steps, 2):
            loss_d, worst, name, stats = cs.step_differences(steps[a],
                                                             steps[b])
            leaves, same, n = worst_leaves(steps[a], steps[b])
            cs.log(f"{what}, {mode}, {a} vs {b}: loss {steps[a][0]:.7f} vs "
                   f"{steps[b][0]:.7f} (relative {loss_d:.2e}); running "
                   f"statistics at {stats:.3f} of theirs; {same} of {n} "
                   f"gradients equal; worst "
                   + ", ".join(f"{r:.3f} {nm}" for r, nm in leaves))
    torch.use_deterministic_algorithms(False)


def syncs(cfg, x_init, part) -> None:
    import torch

    import chip_smoke as cs
    from lidiff_tpu_torch.models import diffusion
    from lidiff_tpu_torch.training.trainer import Trainer
    task = diffusion.DiffusionTask(cfg, device="cuda", seed=0,
                                   compute_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(3)
    batch = {"pcd_full": x_init, "pcd_part": part}
    with tempfile.TemporaryDirectory() as exp:
        trainer = Trainer(task, cfg, exp)
        for i in range(cs.TRAIN_WARMUP + cs.TRAIN_STEPS):
            _, where = cs._host_syncs(lambda: trainer.train_step(batch, gen),
                                      stacks=True)
            torch.cuda.synchronize()
            cs.log(f"training step {i}: {sum(where.values())} host syncs: "
                   f"{dict(where)}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=2,
                    help="runs of each mode (default 2)")
    ap.add_argument("--syncs", action="store_true",
                    help="also count the host syncs of full-width steps")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from lidiff_tpu_torch import config as cfg_mod
    from lidiff_tpu_torch.models import diffusion, refine
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
    gen = torch.Generator(device="cuda").manual_seed(4)
    draws = {"noise": torch.randn(x_init.shape, generator=gen,
                                  device="cuda"),
             "t": torch.tensor([500], device="cuda"), "drop": False}
    compare("diffusion, float32",
            lambda r: diffusion.DiffusionTask(
                {**cfg, "tpu": {**cfg["tpu"], "remat": r}}, device="cuda",
                compute_dtype=torch.float32, seed=0),
            {"pcd_full": x_init, "pcd_part": part}, draws, args.runs)
    rcfg, task, noisy, gt = cs.refine_inputs(cfg, "cuda")
    del task
    compare("refiner, float32",
            lambda r: refine.RefineTask(rcfg, device="cuda",
                                        compute_dtype=torch.float32, seed=0,
                                        remat=r),
            {"pcd_noise": noisy, "pcd_full": gt}, {}, args.runs)
    if args.syncs:
        syncs(cfg, x_init, part)
    return 0


if __name__ == "__main__":
    sys.exit(main())
