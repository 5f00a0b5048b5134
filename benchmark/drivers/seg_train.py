"""Driver of the segmentation training cells: a closed loop of the port's
`Trainer.train_step` over `SegTask.loss_fn` (Point Transformer V3).

Set-up makes the traffic's labelled scans on the card (the mix's own, the
strength from the seed), runs them through the port's train transforms and Mix3D collation
(`data/seg.py`) into batches of the config's global batch, makes the
weights from the seed, builds the task and its trainer (AdamW with the
"block" group under OneCycleLR), and drives it through three steps on
three batches: the warm-up, and what the check follows. The order
shuffles and DropPath masks come from a generator of the seed; the
program's draws, and the orders and patch maps it used, are recorded.
Then the peak memory counter is reset and the window runs steps over the
batches in turn until `seconds` have passed. With `--trace 1` the window
is two steps under torch.profiler.

The check: the plain reference first redoes the augmentation and Mix3D
collation from the scans and the program's recorded draws
(`reference/seg_data.py`) and compares the program's batches with its own
bit for bit (`batch_differ`). On its own batches, in float32 (TF32 off),
it serializes with the recorded order permutations and compares the
program's patch maps (`pad_differ`) and the rows of its orders' patches
(`orders_differ`) entry by entry; it then runs the same three steps from
the same weights with the recorded draws (its own network, loss, AdamW
and OneCycle), and compares the first gradient (read from the
parameters' .grad after step one) by the worst and by the median leaf,
and the parameters' change after three steps by the worst leaf. The
first step's relative loss gap goes to the notes: it does not separate
bf16 from the control (PERF.md). With `run.control == "lower"` the check
judges the reference's steps from operands in float8 (e4m3, one scale a
tensor) in the program's place.
"""

from __future__ import annotations

import copy
import gc
import tempfile
import time

import numpy as np
import torch

from benchmark import scene, train_scenes, work_ptv3
from benchmark import trace as tr
from benchmark.drivers.train import _gaps, leaf_gaps
from benchmark.reference import ptv3 as R
from benchmark.reference import seg_data

SETUP_STEPS = 3
FP8 = torch.float8_e4m3fn


def _config(run):
    cfg = copy.deepcopy(run.config["config"])
    for section, values in run.overrides.get("config", {}).items():
        cfg[section] = {**cfg.get(section, {}), **values}
    return cfg


def _weights(run, cfg, device):
    m = cfg["model"]
    gen = scene.generator(2 * run.seed + 1, device)
    return R.make_weights(R.shapes(m["in_channels"], m["num_classes"],
                                   m["enc_channels"], m["dec_channels"]),
                          gen, device)


def _batches(run, cfg, traffic, device) -> tuple:
    """(the batches of the traffic's scans through the port's transforms
    and collation (host numpy), what the reference redoes them from: the
    scans on the CPU, each scan's draws and each batch's). The draws
    (rotation, scale, flips, jitter, the voxels' picks, the crops'
    centres, the Mix3D coins) come from the mix's `scene_seed`: a step's
    work follows its voxels, which the scale and the crops set, so every
    run's batches are the same size; the run's seed draws the strength,
    the weights and the steps' shuffles and DropPath masks."""
    from lidiff_tpu_torch.data import seg
    rng = np.random.default_rng([int(traffic["scene_seed"]), 17])
    items, scans, scan_draws = [], [], []
    for i, scan in enumerate(
            train_scenes.labeled_scans(traffic, run.seed, device)):
        pts, raw, strength = (t.cpu() for t in scan)
        d = {"coord": pts.numpy(), "strength": strength.numpy(),
             "segment": seg.learning_map(raw.numpy())}
        dr = {}
        d = seg.train_transforms(d, rng, draws=dr)
        d["index"] = i
        items.append(d)
        scans.append((pts, raw, strength))
        scan_draws.append(dr)
    B = int(cfg["train"]["batch_size"])
    mix = float(cfg["data"]["mix_prob"])
    out, batch_draws = [], []
    for k in range(len(items) // B):
        dr = {}
        b = seg.collate(items[k * B:(k + 1) * B], mix, rng, draws=dr)
        out.append({n: torch.from_numpy(v).to(device) for n, v in b.items()})
        batch_draws.append(dr)
    return out, (scans, scan_draws, batch_draws)


def run(run) -> "harness.Outcome":  # noqa: F821
    from benchmark.harness import Outcome, environ
    dev = run.device
    cfg = _config(run)
    env = {**run.config.get("env", {}), **run.overrides.get("env", {})}
    traffic = copy.deepcopy(run.traffic)
    for k, v in run.overrides.get("traffic", {}).items():
        traffic[k] = {**traffic[k], **v} if isinstance(v, dict) else v
    patch = run.overrides.get("patch")

    # ---- set-up: inputs and weights from the seed
    batches, recorded = _batches(run, cfg, traffic, dev)
    w0 = _weights(run, cfg, dev)
    from lidiff_tpu_torch.models import ptv3 as pmod
    from lidiff_tpu_torch.ops import grid as grid_ops
    from lidiff_tpu_torch.ops import serialize
    from lidiff_tpu_torch.training.trainer import Trainer
    saved_patch = serialize.MAX_PATCH
    if patch:
        serialize.MAX_PATCH = R.MAX_PATCH = patch
    with environ(env):
        task = pmod.SegTask(cfg, device=dev)
    task.model.load_state_dict(w0)
    tmp = tempfile.TemporaryDirectory()
    trainer = Trainer(task, cfg, tmp.name,
                      steps_per_epoch=int(run.config["steps_per_epoch"]))
    gen = scene.generator(3 * run.seed + 7, dev)
    # the benchmark's view of the step: occupancy, and in the first steps
    # the draws and the orders the program used
    acc, seen = {}, {"on": True, "draws": [], "orders": []}
    pyr_orig = grid_ops.build_pyramid_grid
    draw_orig, ser_orig = pmod.draw, serialize.serialize_level

    def build_pyramid_grid(grid, element, feats, capacities, num_levels):
        pyr = pyr_orig(grid, element, feats, capacities, num_levels)
        raw = torch.stack([l.geom.num_raw for l in pyr.levels])
        acc["raw"] = raw if "raw" not in acc else torch.maximum(acc["raw"],
                                                                raw)
        acc["caps"] = tuple(capacities[:num_levels])
        return pyr

    def draw(*a, **k):
        d = draw_orig(*a, **k)
        if seen["on"]:
            seen["draws"].append(d)
        return d

    def serialize_level(*a, **k):
        o = ser_orig(*a, **k)
        if seen["on"]:
            seen["orders"].append(o)
        return o

    grid_ops.build_pyramid_grid = build_pyramid_grid
    pmod.draw, serialize.serialize_level = draw, serialize_level
    nb = len(batches)
    losses, first_grad = [], None
    try:
        for s in range(SETUP_STEPS):
            m = trainer.train_step(batches[s % nb], gen)
            losses.append(m["loss"])
            if s == 0:
                first_grad = {n: p.grad.norm() for n, p in
                              task.model.named_parameters()
                              if p.grad is not None}
        change = {n: (p.detach() - w0[n]).norm()
                  for n, p in task.model.named_parameters()}
        seen["on"] = False
        losses = [float(v) for v in losses]
        first_grad = {n: float(v) for n, v in first_grad.items()}
        change = {n: float(v) for n, v in change.items()}
        if dev != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

        # ---- the window
        rec = tr.Recorder() if run.trace else None
        count0 = tr.launches() if run.trace else None
        c0 = dict(serialize.counters)
        steps, metrics = 0, []
        t_start = time.perf_counter()

        def one(i):
            with tr.annotate("bench.step", run.trace):
                return trainer.train_step(batches[i % nb], gen)

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
        c1 = dict(serialize.counters)
    finally:
        grid_ops.build_pyramid_grid = pyr_orig
        pmod.draw, serialize.serialize_level = draw_orig, ser_orig
    setup_s = t_start - run.t0
    peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    count1 = tr.launches() if run.trace else None
    failed = sum(1 for m in metrics if not torch.isfinite(m["loss"]))
    raw = [int(v) for v in acc["raw"]]
    dropped = sum(max(0, r - c) for r, c in zip(raw, acc["caps"]))
    notes = [f"occupancy max {raw} of capacities {list(acc['caps'])}: "
             f"{dropped} voxels dropped",
             f"host syncs a step {(c1['syncs'] - c0['syncs']) / steps:g}"]
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
        cnt = [work_ptv3.counts(batches[(SETUP_STEPS + i) % nb])
               for i in range(2)]
        layer.update(trace=out_trace, steps=2, ptv3_counts=cnt,
                     ptv3_model=cfg["model"],
                     ptv3_counters={k: c1[k] - c0[k] for k in c1})

    checks = reference_checks(run, cfg, batches, recorded, seen, losses,
                              first_grad, change, notes)
    checks.append(("dropped_voxels", dropped, 0))
    serialize.MAX_PATCH = R.MAX_PATCH = saved_patch
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


def _maps_differ(batches, seen) -> tuple:
    """(pad_differ, orders_differ): entries of the program's patch maps,
    and of the rows its orders' patches gather, that differ from the
    reference's, over the set-up steps."""
    inf = float("inf")
    pad = order = 0
    levels = len(seen["orders"]) // SETUP_STEPS if seen["orders"] else 0
    if len(seen["draws"]) != SETUP_STEPS or levels == 0:
        return inf, inf
    for s in range(SETUP_STEPS):
        b = batches[s % len(batches)]
        with torch.no_grad():
            pyr = R.pyramid(b["grid_coord"], b["offset"], b["feat"])
            ref = R.serialize(pyr, seen["draws"][s]["perms"])
        got = seen["orders"][s * levels:(s + 1) * levels]
        if len(got) != len(ref):
            return inf, inf
        for o, r in zip(got, ref):
            if o.maps.pad.shape != r.pad.shape \
                    or o.gather.shape[1] != r.gather[0].shape[0]:
                return inf, inf
            pad += int((o.maps.pad != r.pad).sum())
            order += sum(int((o.gather[k] != r.gather[k]).sum())
                         for k in range(4))
    return pad, order


def reference_checks(run, cfg, batches, recorded, seen, losses,
                     first_grad, change, notes) -> list:
    lim = run.workload["limits"]
    gaps = ("grad_gap", "grad_median_gap", "update_gap")
    inf = float("inf")
    scans, scan_draws, batch_draws = recorded
    B = int(cfg["train"]["batch_size"])
    ref_batches = seg_data.batches(scans, scan_draws, batch_draws, B)
    out = [("batch_differ", sum(seg_data.differ(b, r) for b, r in
                                zip(batches, ref_batches)),
            lim["batch_differ"])]
    if out[0][1]:
        return out + [(n, inf, lim[n]) for n in
                      ("pad_differ", "orders_differ") + gaps]
    batches = [{k: v.to(run.device) for k, v in b.items()}
               for b in ref_batches]
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        pad, order = _maps_differ(batches, seen)
        out += [("pad_differ", pad, lim["pad_differ"]),
                ("orders_differ", order, lim["orders_differ"])]
        if pad or order:
            return out + [(n, inf, lim[n]) for n in gaps]
        tr_cfg = cfg["train"]
        args = ([batches[s % len(batches)] for s in range(SETUP_STEPS)],
                seen["draws"], tr_cfg["optimizer"],
                tr_cfg["scheduler"],
                int(tr_cfg["max_epoch"]) * int(run.config["steps_per_epoch"]),
                int(cfg["data"]["ignore_index"]),
                float(cfg["model"]["drop_path"]))
        w = _weights(run, cfg, run.device)
        ref = R.train_steps(w, *args)
        if run.control == "lower":
            losses, first_grad, change = R.train_steps(w, *args, lowp=FP8)
        notes.append(worst_leaves(ref, first_grad))
        read = _gaps(ref, losses, first_grad, change,
                     {"loss_gap": None, **lim})
        notes.append(f"loss_gap {read[0][1]!r} (not a limit)")
        return out + read[1:]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def worst_leaves(ref, first_grad, n: int = 3) -> str:
    """The leaves whose first gradient is farthest from the reference's,
    for the notes."""
    r_grad = ref[1]
    gaps = leaf_gaps(first_grad, r_grad, list(r_grad))
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
    return "worst gradient leaves: " + ", ".join(
        f"{k} {v:.3g}" for k, v in top)
