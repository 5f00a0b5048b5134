"""Driver of the refiner training cells: a closed loop of the port's
`Trainer.train_step` over `RefineTask.loss_fn`.

Set-up makes the traffic's items and the weights on the card from the
seed, builds the task and its trainer (Adam, the config's lr), and drives
that trainer through its first three steps on three different batches:
those steps are the warm-up, and what the check follows. Then the peak
memory counter is reset, with the weights, the optimizer state and the
input pool left allocated, and the window runs steps over the pool, in
turn, until `seconds` have passed. With `--trace 1` the window is two
steps under torch.profiler.

The check: the plain float32 reference (TF32 off) runs the same three
steps from the same weights on the same batches, with its own network,
chamfer matches (the grid rule), chamfer loss and Adam. It verifies every
chamfer match the program made in those steps by the rule, and compares
the first step's loss, the first gradient (read from Adam's first moment
after one step) by the worst and by the median leaf, and the parameters'
change after three steps by the worst leaf. With `run.control ==
"lower"` the check judges the reference's steps from operands in float8
(e4m3, one scale a tensor), below the configuration's bfloat16, in the
program's place.
"""

from __future__ import annotations

import copy
import gc
from contextlib import nullcontext
import statistics
import tempfile
import time

import torch

from benchmark import scene, weights, work
from benchmark import trace as tr
from benchmark.reference import nets, params, training, voxel

SETUP_STEPS = 3
FP8 = torch.float8_e4m3fn


def _config(run):
    cfg = copy.deepcopy(run.config["config"])
    for section, values in run.overrides.get("config", {}).items():
        cfg[section] = {**cfg.get(section, {}), **values}
    return cfg


def _weights(run, cfg, device):
    gen = scene.generator(2 * run.seed + 1, device)
    return weights.make(params.refiner_shapes(
        3 * int(cfg["train"]["up_factor"]),
        float(cfg["model"].get("cr", 1.0))), gen, device)


def run(run) -> "harness.Outcome":  # noqa: F821
    from benchmark.harness import Outcome, environ
    dev = run.device
    cfg = _config(run)
    env = {**run.config.get("env", {}), **run.overrides.get("env", {})}
    traffic = copy.deepcopy(run.traffic)
    for k, v in run.overrides.get("traffic", {}).items():
        traffic[k] = {**traffic[k], **v} if isinstance(v, dict) else v
    B = int(cfg["train"]["batch_size"])

    # ---- set-up: inputs and weights from the seed, on the device
    items = scene.refine_items(traffic, run.seed, dev)
    n_batches = items["pcd_noise"].shape[0] // B
    batches = [{k: v[i * B:(i + 1) * B] for k, v in items.items()}
               for i in range(n_batches)]
    w0 = _weights(run, cfg, dev)
    from lidiff_tpu_torch.config import finalize_config
    from lidiff_tpu_torch.models.refine import RefineTask
    from lidiff_tpu_torch.ops import chamfer as chamfer_mod
    from lidiff_tpu_torch.training.trainer import Trainer
    with environ(env):
        task = RefineTask(finalize_config(cfg), device=dev,
                          remat=bool(cfg["tpu"].get("remat", True)))
    task.model.load_state_dict(w0)
    tmp = tempfile.TemporaryDirectory()
    trainer = Trainer(task, cfg, tmp.name,
                      steps_per_epoch=int(run.config["steps_per_epoch"]))
    # the benchmark's view of the step: the pyramid's occupancy and, in
    # the first steps, the chamfer's inputs and matches
    acc, seen = {}, {"on": True, "calls": []}
    from lidiff_tpu_torch.models import refine as rmod
    pyr_orig, match_orig = rmod.build_pyramid, chamfer_mod.nn_indices_grid

    def build_pyramid(points, resolution, capacities, num_levels, *a, **k):
        pyr = pyr_orig(points, resolution, capacities, num_levels, *a, **k)
        raw = torch.stack([l.geom.num_raw for l in pyr.levels])
        acc["raw"] = raw if "raw" not in acc else torch.maximum(acc["raw"],
                                                                raw)
        acc["caps"] = tuple(capacities[:num_levels])
        return pyr

    def nn_indices_grid(query, target, *a, **k):
        idx = match_orig(query, target, *a, **k)
        if seen["on"]:
            seen["calls"].append((query.detach(), idx))
        return idx

    rmod.build_pyramid = build_pyramid
    chamfer_mod.nn_indices_grid = nn_indices_grid

    losses, first_grad, matches = [], None, []
    up_rows = int(cfg["train"]["up_factor"]) * items["pcd_noise"].shape[1]
    for s in range(SETUP_STEPS):
        seen["calls"] = []
        m = trainer.train_step(batches[s % n_batches])
        losses.append(m["cd_loss"])
        # chamfer_distance matches up -> gt, then gt -> up
        (up, ix), (_, iy) = seen["calls"]
        matches.append((up.reshape(-1, up_rows, 3).cpu(), ix.cpu(),
                        iy.cpu()))
        if s == 0:
            st = trainer.optimizer.state
            first_grad = {n: (st[p]["exp_avg"] / 0.1).norm()
                          for n, p in task.model.named_parameters()
                          if p in st}
    change = {n: (p.detach() - w0[n]).norm()
              for n, p in task.model.named_parameters()}
    seen["on"] = False
    del w0, seen["calls"]
    losses = [float(v) for v in losses]
    first_grad = {n: float(v) for n, v in first_grad.items()}
    change = {n: float(v) for n, v in change.items()}
    if dev != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    # ---- the window
    rec = tr.Recorder() if run.trace else None
    count0 = tr.launches() if run.trace else None
    steps, failed, metrics = 0, 0, []
    t_start = time.perf_counter()

    def one(i):
        with tr.annotate("bench.step", run.trace):
            return trainer.train_step(batches[i % n_batches])

    if rec is not None:
        with rec.window():
            for i in range(2):
                metrics.append(one(SETUP_STEPS + i))
        steps = 2
    else:
        while True:
            metrics.append(one(SETUP_STEPS + steps))
            steps += 1
            if time.perf_counter() - t_start >= run.seconds:
                break
        if dev != "cpu":
            torch.cuda.synchronize()
    t_end = time.perf_counter()
    setup_s = t_start - run.t0
    peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    count1 = tr.launches() if run.trace else None
    failed = sum(1 for m in metrics if not torch.isfinite(m["cd_loss"]))
    rmod.build_pyramid, chamfer_mod.nn_indices_grid = pyr_orig, match_orig
    raw = [int(v) for v in acc["raw"]]
    dropped = sum(max(0, r - c) for r, c in zip(raw, acc["caps"]))
    notes = [f"occupancy max {raw} of capacities {list(acc['caps'])}: "
             f"{dropped} voxels dropped"]
    del trainer, task, metrics
    gc.collect()
    tmp.cleanup()
    if dev != "cpu":
        torch.cuda.empty_cache()

    layer: dict = {}
    out_trace = None
    if run.trace:
        out_trace = rec.read()
        lost = tr.guard(out_trace, tr.launched(count0, count1))
        if lost:
            raise RuntimeError(
                "the profile lost kernels (kind, seen, launched): "
                f"{lost}: its times would read short")
        res = float(cfg["data"]["resolution"])
        occ = [work.occupancy(batches[(SETUP_STEPS + i) % n_batches]
                              ["pcd_noise"], res) for i in range(2)]
        layer.update(trace=out_trace, occupancy=occ, steps=2,
                     ops=work.refiner_ops(float(cfg["model"].get("cr", 1.0)),
                                          3 * int(cfg["train"]["up_factor"])))

    checks = reference_checks(run, cfg, batches, losses, first_grad, change,
                              matches)
    checks.append(("dropped_voxels", dropped, 0))
    e2e = {"train_step_ms": 1e3 * (t_end - t_start) / steps,
           "train_peak_gib": peak / 2 ** 30, "setup_s": setup_s}
    out = Outcome(e2e=e2e, attempted=steps, failed=failed, checks=checks,
                  peak_bytes=peak, layer=layer, notes=notes)
    if run.trace:
        out.busy_s = out_trace.busy_s()
        out.window_s = out_trace.wall_s
        out.breakdown = {"device_ops": out_trace.device_ops(),
                         "idle_gaps": out_trace.idle_gaps()}
    return out


def reference_steps(run, cfg, batches, lowp=None):
    """The reference's three steps: (losses, first gradient norms by leaf,
    parameter change norms by leaf)."""
    dev = run.device
    res = float(cfg["data"]["resolution"])
    w = _weights(run, cfg, dev)
    leaves = {k: v for k, v in w.items()
              if not k.endswith((".mean", ".var"))}
    start = {k: v.clone() for k, v in leaves.items()}
    adam = training.Adam(float(cfg["train"]["lr"]))
    ups = int(cfg["train"]["up_factor"])
    losses, first = [], None
    for s in range(SETUP_STEPS):
        b = batches[s % len(batches)]
        noisy, gt = b["pcd_noise"], b["pcd_full"]
        for v in leaves.values():
            v.requires_grad_(True)
        with torch.enable_grad():
            ctx = nets.lower_precision(lowp) if lowp else nullcontext()
            with ctx:
                offs = nets.refiner(w, voxel.pyramid(noisy, res), train=True)
                up = (noisy[:, :, None, :] + offs.reshape(
                    noisy.shape[0], noisy.shape[1], ups, 3)).reshape(
                        noisy.shape[0], -1, 3)
                ix, iy = training.rule_matches(up.detach(), gt)
                loss = training.chamfer(up, gt, ix, iy)
                grads = torch.autograd.grad(loss, list(leaves.values()))
        for v in leaves.values():
            v.requires_grad_(False)
        grads = dict(zip(leaves, grads))
        losses.append(float(loss.detach()))
        if s == 0:
            first = {k: float(g.norm()) for k, g in grads.items()}
        adam.step(leaves, grads)
        del offs, up, loss, grads, ix, iy
    change = {k: float((leaves[k] - start[k]).norm()) for k in leaves}
    return losses, first, change


def reference_checks(run, cfg, batches, losses, first_grad, change,
                     matches) -> list:
    lim = run.workload["limits"]
    up_rows = int(cfg["train"]["up_factor"]) * batches[0]["pcd_noise"].shape[1]
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        inf = float("inf")
        if any(up.shape != (b["pcd_noise"].shape[0], up_rows, 3)
               for (up, _, _), b in zip(matches, batches)):
            # the program's step matched other rows than the batch's
            bad = inf
        else:
            bad = 0
            for s, (up, ix, iy) in enumerate(matches):
                with torch.no_grad():
                    rx, ry = training.rule_matches(
                        up.to(run.device),
                        batches[s % len(batches)]["pcd_full"])
                bad += int((ix.to(rx.device) != rx).sum()
                           + (iy.to(ry.device) != ry).sum())
        out = [("matches_differ", bad, lim["matches_differ"])]
        ref = reference_steps(run, cfg, batches)
        if run.control == "lower":
            losses, first_grad, change = reference_steps(run, cfg, batches,
                                                         FP8)
        return out + _gaps(ref, losses, first_grad, change, lim)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def leaf_gaps(got: dict, ref: dict, keep) -> dict:
    """Per leaf, the gap between its norm in the program and in the
    reference, over the larger of the reference's norm of that leaf and
    of the median leaf."""
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(got.get(k, 0.0) - ref[k]) / max(ref[k], med)
            for k in keep}


def _gaps(ref, losses, first_grad, change, lim) -> list:
    r_loss, r_grad, r_change = ref
    # leaves the reference moves: a gradient under a thousandth of the
    # median leaf's is nought to rounding
    med = statistics.median(r_grad.values())
    moving = [k for k, g in r_grad.items() if g >= 1e-3 * med]
    grad = leaf_gaps(first_grad, r_grad, moving)
    return [("loss_gap", abs(losses[0] - r_loss[0]) / abs(r_loss[0]),
             lim["loss_gap"]),
            ("grad_gap", max(grad.values()), lim["grad_gap"]),
            ("grad_median_gap", statistics.median(grad.values()),
             lim["grad_median_gap"]),
            ("update_gap", max(leaf_gaps(change, r_change,
                                         moving).values()),
             lim["update_gap"])]
