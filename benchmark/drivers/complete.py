"""Driver of the scan-completion cells: one client completes the traffic's
scans back to back through the port's `DiffCompletion.complete_scan`.

Set-up makes the scans and both networks' weights on the card from the
seed, builds the pipeline on them (its checkpoints served from memory) and
warms it up on one scan with a two-step solver. The window completes scans
until `seconds` have passed, the last one to its end. With `--trace 1` the
window is one scan under torch.profiler.

While it runs, the benchmark keeps references to what the pipeline made on
one scan drawn from the seed (the FPS picks, the cloud and guided noise
prediction at the checked solver steps with each step's state and noise,
the refiner's input and offsets) and the largest occupancy of every level
of every pyramid. Once the window has closed and the pipeline is freed,
the plain reference (`benchmark/reference/`, float32, TF32 off) recomputes
those stages from the scan and the weights and the program's state at each
checked step.

With `run.control == "lower"` the check judges the reference computed one
precision below the configuration's in the program's place (the control):
the networks' products in float8 (e4m3, one scale a tensor) below their
bfloat16, FPS and the solver step in bfloat16 below their float32.
"""

from __future__ import annotations

import copy
import gc
import os
import random
import tempfile
import time

import numpy as np
import torch

from benchmark import scene, weights, work
from benchmark import trace as tr
from benchmark.reference import nets, params, sampling, voxel

FP8 = torch.float8_e4m3fn


class Capture:
    """References to what the pipeline made on the scan being captured."""

    def __init__(self, steps: set):
        self.steps = steps
        self.on = False
        self.all_points = False
        self.reset(-1)

    def reset(self, scan_index: int):
        self.scan_index = scan_index
        self.fps = None
        self.denoise: dict = {}
        self.solver: dict = {}
        self.refine = None
        self.bank = None
        self.points: list = []
        self.step = 0


def _memory_store(entries: dict):
    """A stand-in for the pipeline's checkpoint manager that serves
    {directory: (hparams, state dict)} from memory."""

    class Store:
        def __init__(self, path):
            self.dir = os.path.abspath(path)
            self._hparams, self._state = entries[self.dir]

        def load_hparams(self):
            return copy.deepcopy(self._hparams)

        def restore(self, step=None, map_location=None):
            return {"model": self._state}, 0

    return Store


def _weights(run, cfg, rcfg, device):
    gen = scene.generator(2 * run.seed + 1, device)
    cr = float(cfg["model"].get("cr", 1.0))
    w = weights.make(params.diffusion_shapes(cfg["model"]["out_dim"], cr),
                     gen, device)
    rw = weights.make(params.refiner_shapes(
        3 * int(rcfg["train"]["up_factor"]),
        float(rcfg["model"].get("cr", 1.0))), gen, device)
    return w, rw


def _configs(run):
    """The diffusion config and the pipeline's refiner config, with the
    sections a test overrides (`overrides["config"]`, `["refine"]`)."""
    c = run.config
    cfg = copy.deepcopy(c["config"])
    rcfg = copy.deepcopy(run.config_named(c["pipeline"]["refine_config"])
                         ["config"])
    rcfg["tpu"].update(c["pipeline"]["refine_tpu"])
    for conf, key in ((cfg, "config"), (rcfg, "refine")):
        for section, values in run.overrides.get(key, {}).items():
            conf[section] = {**conf.get(section, {}), **values}
    return cfg, rcfg


def _install(dc, cap: Capture, run, acc: dict, trace_on: bool):
    """Wrap the pipeline's stages to keep references and count
    occupancy; returns a function that takes the wrappers off."""
    from lidiff_tpu_torch.models import diffusion as dmod
    from lidiff_tpu_torch.models import refine as rmod
    from lidiff_tpu_torch.tools import diff_completion_pipeline as dcp
    undo = []

    def patch(obj, name, new):
        old = getattr(obj, name)
        setattr(obj, name, new)
        undo.append((obj, name, old))
        return old

    def make_pyramid(orig):
        def build_pyramid(points, resolution, capacities, num_levels,
                          *a, **k):
            pyr = orig(points, resolution, capacities, num_levels, *a, **k)
            key = tuple(capacities[:num_levels])
            raw = torch.stack([l.geom.num_raw for l in pyr.levels])
            acc[key] = raw if key not in acc else torch.maximum(acc[key],
                                                                raw)
            return pyr
        return build_pyramid

    patch(dmod, "build_pyramid", make_pyramid(dmod.build_pyramid))
    patch(rmod, "build_pyramid", make_pyramid(rmod.build_pyramid))

    fps_cuda_orig, fps_orig = dcp.fps_cuda, dcp.fps

    def fps_cuda(points, k, *a, **kw):
        with tr.annotate("bench.fps", trace_on):
            idx = fps_cuda_orig(points, k, *a, **kw)
        if cap.on:
            cap.fps = points[idx]
        return idx

    def fps(points, k):     # the pipeline's CPU path
        picked = fps_orig(points, k)
        if cap.on:
            cap.fps = torch.from_numpy(picked)
        return picked

    patch(dcp, "fps_cuda", fps_cuda)
    patch(dcp, "fps", fps)

    task = dc.task
    enc_orig = task.encode_banks

    def encode_banks(part):
        cap.step = 0
        with tr.annotate("bench.encode", trace_on):
            banks = enc_orig(part)
        if cap.on:
            cap.bank = (banks[0], banks[1].coords, banks[1].mask)
        return banks

    task.encode_banks = encode_banks
    den_orig = task.denoise_pair

    def denoise_pair(points, *a, **kw):
        with tr.annotate("bench.denoise", trace_on):
            eps = den_orig(points, *a, **kw)
        if cap.on:
            if cap.step in cap.steps:
                cap.denoise[cap.step] = (points, int(a[4]), eps)
            if cap.all_points:
                cap.points.append(points)
        return eps

    task.denoise_pair = denoise_pair
    step_orig = dmod.solver_step

    def solver_step(solver, state, eps, noise):
        with tr.annotate("bench.solver", trace_on):
            out = step_orig(solver, state, eps, noise)
        if cap.on and cap.step in cap.steps:
            cap.solver[cap.step] = (state.sample, state.prev_m, eps, noise,
                                    out.sample, out.prev_m)
        cap.step += 1
        return out

    patch(dmod, "solver_step", solver_step)

    if dc.refine_task is not None:
        ref_orig = dc.refine_task.forward

        def forward(points):
            with tr.annotate("bench.refine", trace_on):
                offs = ref_orig(points)
            if cap.on:
                cap.refine = (points, offs)
            return offs

        dc.refine_task.forward = forward

    def remove():
        for obj, name, old in reversed(undo):
            setattr(obj, name, old)
        for attr in ("encode_banks", "denoise_pair"):
            task.__dict__.pop(attr, None)
        if dc.refine_task is not None:
            dc.refine_task.__dict__.pop("forward", None)

    return remove


def check_steps(run, n_steps: int) -> list:
    """The solver steps whose output is checked: the first two, two drawn
    from the seed and the last two."""
    r = random.Random(run.seed)
    mid = r.randrange(2, n_steps - 3)
    return sorted({0, 1, mid, mid + 1, n_steps - 2, n_steps - 1})


def run(run) -> "harness.Outcome":  # noqa: F821
    from benchmark.harness import Outcome, environ
    dev = run.device
    cfg, rcfg = _configs(run)
    env = {**run.config.get("env", {}), **run.overrides.get("env", {})}
    pipe = run.config["pipeline"]
    traffic = copy.deepcopy(run.traffic)
    traffic.update(run.overrides.get("traffic", {}))

    # ---- set-up: inputs and weights from the seed, on the device
    scans = [s.cpu().numpy() for s in scene.drive_scans(traffic, run.seed,
                                                        dev)]
    w, rw = _weights(run, cfg, rcfg, dev)
    from lidiff_tpu_torch.diffusion.dpm_solver import make_dpm_solver
    from lidiff_tpu_torch.tools import diff_completion_pipeline as dcp
    with tempfile.TemporaryDirectory() as tmp:
        dirs = [os.path.join(tmp, d) for d in ("diff", "refine")]
        for d in dirs:
            os.makedirs(d)
        saved = dcp.CheckpointManager
        dcp.CheckpointManager = _memory_store({dirs[0]: (cfg, w),
                                               dirs[1]: (rcfg, rw)})
        try:
            with environ(env):
                dc = dcp.DiffCompletion(
                    dirs[0], dirs[1], int(cfg["diff"]["s_steps"]),
                    float(pipe["cond_weight"]), seed=run.seed, device=dev)
        finally:
            dcp.CheckpointManager = saved
    del w, rw
    n_steps = dc.task.solver.num_steps
    cap = Capture(set(check_steps(run, n_steps)))
    acc: dict = {}
    remove = _install(dc, cap, run, acc, run.trace)
    # warm-up: one scan with a two-step solver: every kernel and shape
    solver = dc.task.solver
    dc.task.solver = make_dpm_solver(
        cfg["diff"]["beta_func"], cfg["diff"]["t_steps"], 2,
        cfg["diff"]["beta_start"], cfg["diff"]["beta_end"], device=dc.device)
    dc.complete_scan(scans[-1])
    dc.task.solver = solver
    if dc.device.type == "cuda":
        torch.cuda.synchronize()

    # ---- the window
    pool = len(scans)
    k_capture = random.Random(run.seed ^ 0x5CA7).randrange(
        min(4, pool)) if not run.trace else 0
    rec = tr.Recorder() if run.trace else None
    stage_times, failed, n = [], 0, 0
    count0 = tr.launches() if run.trace else None
    t_start = time.perf_counter()
    while True:
        cap.on = n <= k_capture
        if cap.on:
            cap.reset(n % pool)
            cap.all_points = run.trace
        if rec is not None:
            with rec.window():
                refined, post = dc.complete_scan(scans[n % pool])
        else:
            refined, post = dc.complete_scan(scans[n % pool])
        ok = (len(post) > 0 and refined.shape == (len(post) * int(
            rcfg["train"]["up_factor"]), 3) and np.isfinite(refined).all())
        failed += not ok
        stage_times.append(dict(dc.times))
        n += 1
        if run.trace or time.perf_counter() - t_start >= run.seconds:
            break
    t_end = time.perf_counter()
    setup_s = t_start - run.t0
    cap.on = False
    peak = torch.cuda.max_memory_allocated() if dc.device.type == "cuda" \
        else 0
    count1 = tr.launches() if run.trace else None
    remove()

    # ---- occupancy and drops per pyramid
    notes, dropped = [], 0
    for caps, raw in acc.items():
        raw = [int(v) for v in raw]
        drop = sum(max(0, r - c) for r, c in zip(raw, caps))
        dropped += drop
        notes.append(f"occupancy max {raw} of capacities {list(caps)}: "
                     f"{drop} voxels dropped")
    ups = int(rcfg["train"]["up_factor"])
    del dc, solver
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    layer: dict = {"stage_times": stage_times[-1:] if run.trace else []}
    out_trace = None
    if run.trace:
        out_trace = rec.read()
        lost = tr.guard(out_trace, tr.launched(count0, count1))
        if lost:
            raise RuntimeError(
                "the profile lost kernels (kind, seen, launched): "
                f"{lost}: its times would read short")
        occ = [work.occupancy(p, float(cfg["data"]["resolution"]))
               for p in cap.points]
        notes += [f"occupancy of the traced scan at step {i}: voxels "
                  f"{occ[i].voxels}, hits {occ[i].hits}"
                  for i in (0, len(occ) - 1)]
        layer.update(trace=out_trace, occupancy=occ, steps=len(occ),
                     ops=work.denoiser_ops(float(cfg["model"].get("cr", 1.0))))

    checks = reference_checks(run, cfg, rcfg, scans[cap.scan_index], cap,
                              ups)
    checks.append(("dropped_voxels", dropped, 0))
    e2e = {"scan_s": (t_end - t_start) / n, "setup_s": setup_s}
    out = Outcome(e2e=e2e, attempted=n, failed=failed, checks=checks,
                  peak_bytes=peak, layer=layer, notes=notes)
    if run.trace:
        out.busy_s = out_trace.busy_s()
        out.window_s = out_trace.wall_s
        out.breakdown = {"device_ops": out_trace.device_ops(),
                         "idle_gaps": out_trace.idle_gaps()}
    return out


def _rel_rms(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return float((got - ref).norm() / ref.norm().clamp(min=1e-30))


def _rows_differ(got, ref) -> int:
    if got is None or got.shape != ref.shape:
        return int(ref.shape[0])
    return int((got.to(ref.device) != ref).any(1).sum())


def reference_checks(run, cfg, rcfg, scan_np, cap: Capture,
                     ups: int) -> list:
    """The plain reference over what the pipeline made on the captured
    scan: (name, value, limit) of each number compared."""
    lim = run.workload["limits"]
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _checks(run, cfg, rcfg, scan_np, cap, lim,
                           run.control == "lower")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _checks(run, cfg, rcfg, scan_np, cap, lim, lower: bool):
    dev = run.device
    w, rw = _weights(run, cfg, rcfg, dev)
    res = float(cfg["data"]["resolution"])
    n_part = int(cfg["data"]["num_points"]) // 10
    out = []
    # crop and FPS
    crop = torch.from_numpy(sampling.crop(scan_np)).to(dev)
    picks = sampling.fps(crop, n_part)
    got = crop[sampling.fps(crop, n_part, torch.bfloat16)] if lower \
        else cap.fps
    out.append(("fps_picks_differ", _rows_differ(got, crop[picks]),
                lim["fps_picks_differ"]))
    # the conditioning banks
    part = crop[picks][None]
    pp = voxel.pyramid(part, res)
    pz = voxel.pyramid(torch.zeros_like(part), res)
    bank_c = (pp.levels[-1].coords, nets.encoder(w, pp))
    bank_u = (pz.levels[-1].coords, nets.encoder(w, pz))
    if lower:
        with nets.lower_precision(FP8):
            lo_c = (bank_c[0], nets.encoder(w, pp))
            lo_u = (bank_u[0], nets.encoder(w, pz))
    del pp, pz
    # the encoder's output: the conditioning bank, row by row
    gap = float("inf")
    if lower:
        gap = _rel_rms(lo_c[1], bank_c[1])
    elif cap.bank is not None:
        feats, coords, mask = cap.bank
        if torch.equal(coords[mask].long().to(dev), bank_c[0]):
            gap = _rel_rms(feats[mask].float(), bank_c[1])
    out.append(("bank_gap", gap, lim["bank_gap"]))
    # the guided noise prediction at the checked steps
    wu = float(run.config["pipeline"]["cond_weight"])
    od = cfg["model"]["out_dim"]
    gaps, far = [], 0
    for step, (points, t, eps) in sorted(cap.denoise.items()):
        pyr = voxel.pyramid(points.float(), res)
        ec = nets.denoiser(w, pyr, bank_c, t, od)
        eu = nets.denoiser(w, pyr, bank_u, t, od)
        ref = eu + wu * (ec - eu)
        if lower:
            with nets.lower_precision(FP8):
                ec = nets.denoiser(w, pyr, lo_c, t, od)
                eu = nets.denoiser(w, pyr, lo_u, t, od)
            eps = eu + wu * (ec - eu)
        gaps.append(_rel_rms(eps, ref))
        far += int((torch.round(points / res).abs() > 2047).any(-1).sum())
        del pyr, ec, eu, ref
    out.append(("eps_gap", max(gaps) if gaps else float("inf"),
                lim["eps_gap"]))
    # points the program's keys cannot hold (|voxel coordinate| > 2047)
    # would leave its pyramid unseen by the occupancy counts
    out.append(("points_out_of_range", far, 0))
    # the solver's update, and the state it carries to the next step
    d = cfg["diff"]
    sch = sampling.Schedule(d["beta_start"], d["beta_end"], d["t_steps"],
                            d["s_steps"])
    sgaps, m0s = [], {}
    for i, (x, m1, eps, z, x_out, m_out) in sorted(cap.solver.items()):
        ref, m0 = sch.step(i, x, m1, eps, z)
        if lower:
            x_out, m_out = sch.step(i, x, m1, eps, z, dtype=torch.bfloat16)
        scale = float(ref.abs().max())
        sgaps.append(max(float((x_out.double() - ref).abs().max()),
                         float((m_out.double() - m0).abs().max())) / scale)
        if i - 1 in m0s and not lower:
            sgaps.append(float((m1.double() - m0s[i - 1]).abs().max())
                         / scale)
        m0s[i] = m0
    out.append(("solver_gap", max(sgaps) if sgaps else float("inf"),
                lim["solver_gap"]))
    # the refiner's offsets
    if cap.refine is None:
        out.append(("refine_gap", float("inf"), lim["refine_gap"]))
    else:
        pts, offs = cap.refine
        pyr = voxel.pyramid(pts.float(), res)
        ref = nets.refiner(rw, pyr)
        if lower:
            with nets.lower_precision(FP8):
                offs = nets.refiner(rw, pyr)
        out.append(("refine_gap", _rel_rms(offs.reshape(ref.shape), ref),
                    lim["refine_gap"]))
    return out
