#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`lidiff_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--steps S]

From the root of a checkout, on a machine with one CUDA card (Hopper:
the kernels are built for sm_90a):
  1. builds the hand-written kernels from `lidiff_tpu_torch/csrc/` with nvcc;
  2. holds each kernel against its plain PyTorch version on the card at the
     shapes of the sampling path (B1 and C1 exactly, A1 within the stated
     tolerances), and times both;
  3. runs one classifier-free completion through `DiffusionTask.sample` at
     full width (cr=1, out_dim 96, bf16) on a 180k-point synthetic ring
     scan, G=2 fused cond/uncond, w=6, S steps of the 1000-step linear
     schedule, counting each kernel's launches in that run;
  4. checks the output (finite, shape, zero capacity overflow) and a small
     f32 denoise on the card against the same weights on the CPU.
It prints one line per phase, then a {"kernels": [...]} JSON line, the
card's name and power limit, and last {"ok": true, "device": {...}}. Any
failure raises and exits non-zero; so does a run without a CUDA device or
outside a checkout.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
N_PART = 18_000           # partial scan points; the cloud is N_PART x 10
TILE = 10
PEAK_BF16 = 989e12        # H100 SXM dense tensor-core bf16, FLOP/s
PEAK_F32 = 67e12          # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3, bytes/s
# A1 widths of the sampling path: (Cin, Cout, pyramid level it runs at)
A1_WIDTHS = [(3, 32, 0), (32, 32, 0), (32, 64, 2), (64, 64, 2),
             (64, 128, 3), (128, 128, 3), (128, 256, 4), (256, 256, 4),
             (384, 256, 3), (192, 128, 2), (128, 96, 0), (96, 96, 0)]
A1_TIMED = (384, 256, 3, 2)  # (Cin, Cout, level, G): the kernels line's A1
A1_BF16_RTOL = 2.0 ** -7    # one bf16 ulp, relative
A1_BF16_ATOL = 1e-4         # x max|ref|: float32 sums taken in other orders
A1_F32_TOL = 1e-5           # x max|ref|


def log(msg: str) -> None:
    print(msg, flush=True)


def _time_ms(fn, iters: int = 10) -> float:
    """Mean device time of fn() over `iters` runs, after a warm-up run."""
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


def _bound_ms(ops: float, op_rate: float, nbytes: float):
    t_ops, t_bytes = ops / op_rate, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def ring_scan(n: int, seed: int = 0):
    """Synthetic LiDAR rings, the shape of bench.py's fallback scan."""
    import numpy as np
    rng = np.random.default_rng(seed)
    az = rng.uniform(0, 2 * np.pi, n)
    el = rng.choice(np.linspace(-0.4, 0.05, 64), n)
    r = rng.uniform(3.5, 50.0, n)
    return np.stack([r * np.cos(az) * np.cos(el), r * np.sin(az) * np.cos(el),
                     r * np.sin(el)], -1).astype(np.float32)[None]


def make_cfg(num_points: int, s_steps: int, cr: float = 1.0,
             caps: dict | None = None) -> dict:
    cfg = {
        "experiment": {"id": "chip-smoke"},
        "data": {"resolution": 0.05, "num_points": num_points},
        "train": {"uncond_prob": 0.1, "uncond_w": 6.0},
        "diff": {"beta_start": 3.5e-5, "beta_end": 0.007,
                 "beta_func": "linear", "t_steps": 1000, "s_steps": s_steps},
        "model": {"out_dim": 96, "cr": cr},
        "tpu": dict(caps or {}),
    }
    return cfg


def check_b1(pyr, grid):
    """B1 against its plain version on every level: bit-exact."""
    import torch
    for li, lvl in enumerate(pyr.levels):
        g = lvl.geom
        col, hit = grid.kmap3_columns(g.key, g.coords, g.mask, g.stride)
        pcol, phit = grid.kmap3_columns_plain(g.key, g.coords, g.mask,
                                              g.stride)
        if not (torch.equal(hit, phit) and torch.equal(col, pcol)):
            raise AssertionError(f"B1 differs from its plain version at L{li}")
    g = pyr.levels[0].geom
    V = g.capacity
    ms = _time_ms(lambda: grid.kmap3_columns(g.key, g.coords, g.mask, 1))
    plain_ms = _time_ms(lambda: grid.kmap3_columns_plain(g.key, g.coords,
                                                         g.mask, 1), 3)
    probes = math.ceil(math.log2(V)) + 3
    bound, by = _bound_ms(9 * V * probes, PEAK_F32,
                          V * (8 + 16 + 1 + 9 * 4 + 27))
    log(f"B1 kmap3_columns: 5 levels bit-exact; L0 V={V}: {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    return dict(max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None)


def check_c1(pyr, banks, knn):
    """C1 against its plain version for the L0 queries and each bank:
    indices equal on valid queries. Returns the main path's cond bank."""
    import torch
    g = pyr.levels[0].geom
    out = {}
    for name, bank in banks.items():
        idx = knn.nn_match(g.coords, bank.coords, bank.mask, n_batch=1)
        ref = knn.nn_match_plain(g.coords, bank.coords, bank.mask)
        if not torch.equal(idx[g.mask], ref[g.mask]):
            bad = int((idx != ref)[g.mask].sum())
            raise AssertionError(f"C1 differs from its plain version on "
                                 f"{bad} valid queries ({name} bank)")
        ms = _time_ms(lambda: knn.nn_match(g.coords, bank.coords, bank.mask,
                                           n_batch=1))
        plain_ms = _time_ms(lambda: knn.nn_match_plain(
            g.coords, bank.coords, bank.mask), 3)
        nq, nr = int(g.mask.sum()), int(bank.mask.sum())
        # per (query, valid ref) pair: 3 multiply-adds, a subtract, a compare
        bound, by = _bound_ms(nq * nr * 8, PEAK_F32,
                              g.capacity * 20 + bank.capacity * 17)
        log(f"C1 nn_match: {g.capacity} queries x {bank.capacity}-row "
            f"{name} bank ({nr} valid): exact; {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by})")
        out[name] = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by, library_ms=None)
    return out["cond"]


def check_a1(pyr, sc, dev):
    """A1 against its plain version at every width of the path, G in {1, 2},
    float32 and bf16, with bias, ReLU and the mask."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(1)
    cases, timed = [], None
    for cin, cout, li in A1_WIDTHS:
        lvl = pyr.levels[li]
        g, km = lvl.geom, lvl.kmap3
        V = g.capacity
        for G in (1, 2):
            for dt in (torch.float32, torch.bfloat16):
                f = torch.randn(V, G * cin, generator=gen, device=dev)
                f = (f * g.mask[:, None]).to(dt)
                w = (torch.randn(27, cin, cout, generator=gen, device=dev)
                     / math.sqrt(27 * cin)).to(dt)
                b = 0.1 * torch.randn(cout, generator=gen, device=dev)
                args = (f, km.col_idx, km.hit, w, g.mask, G)
                got = sc.conv3_columns(*args, bias=b, relu=True,
                                       nvalid=km.nvalid).float()
                ref = sc.conv3_columns_plain(*args, bias=b, relu=True).float()
                err = (got - ref).abs()
                scale = float(ref.abs().max())
                if dt == torch.float32:
                    ok = float(err.max()) <= A1_F32_TOL * scale
                else:
                    ok = bool((err <= A1_BF16_RTOL * ref.abs()
                               + A1_BF16_ATOL * scale).all())
                if not ok:
                    raise AssertionError(
                        f"A1 ({cin},{cout}) G={G} {dt}: max err "
                        f"{float(err.max()):.3g} at scale {scale:.3g}")
                rel = float(err.max()) / max(scale, 1e-30)
                log(f"A1 conv3_columns ({cin:3d},{cout:3d}) L{li} V={V} "
                    f"G={G} {str(dt)[6:]:8s}: max err {float(err.max()):.3g}"
                    f" ({rel:.2e} of max|ref|)")
                if dt == torch.bfloat16 and G == (1 if cin == 3 else 2):
                    cases.append((cin, cout, li, G, args, b, km, g,
                                  float(err.max())))
    # time each width at the group count and dtype of the sampling path
    for cin, cout, li, G, args, b, km, g, err in cases:
        V = g.capacity
        ms = _time_ms(lambda: sc.conv3_columns(*args, bias=b, relu=True,
                                               nvalid=km.nvalid))
        hits = int(km.hit[g.mask].sum())
        flops = 2.0 * hits * cin * cout * G
        nbytes = (V * G * cin * 2 + V * 9 * 4 + V * 27 + V
                  + 27 * cin * cout * 2 + cout * 4 + V * G * cout * 2)
        bound, by = _bound_ms(flops, PEAK_BF16, nbytes)
        log(f"A1 time ({cin:3d},{cout:3d}) L{li} G={G} bf16, "
            f"{hits / int(g.mask.sum()):.2f} hit taps/voxel: {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), bound {bound:.4f} ms ({by})")
        if (cin, cout, li, G) == A1_TIMED:
            plain_ms = _time_ms(lambda: sc.conv3_columns_plain(
                *args, bias=b, relu=True), 3)
            timed = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by, library_ms=None)
    log(f"A1 {A1_TIMED}: plain version {timed['plain_ms']:.4f} ms")
    return timed


def check_small_reference(cfg_mod, diffusion, dev):
    """A small f32 guided denoise on the card (kernels) against the same
    weights and input on the CPU (plain versions)."""
    import numpy as np
    import torch
    caps = {"full_capacities": [4096] * 3 + [3072, 2048],
            "part_capacities": [512] * 5}
    cfg = cfg_mod.finalize_config(make_cfg(4000, 2, cr=0.25, caps=caps))
    part = ring_scan(400, seed=3)
    x = np.tile(part, (1, TILE, 1)) + np.random.default_rng(4).normal(
        0, 0.5, (1, 400 * TILE, 3)).astype(np.float32)
    eps = {}
    for d in (dev, "cpu"):
        task = diffusion.DiffusionTask(cfg, device=d,
                                       compute_dtype=torch.float32, seed=2)
        banks = task.encode_banks(torch.from_numpy(part).to(d))
        eps[d] = task.denoise_pair(torch.from_numpy(x).to(d), *banks,
                                   500).cpu()
    err = float((eps[dev] - eps["cpu"]).abs().max())
    scale = float(eps["cpu"].abs().max())
    log(f"small f32 guided denoise, card vs CPU: max err {err:.3g} "
        f"(max|eps| {scale:.3g})")
    if not err <= 1e-3 * max(scale, 1.0):
        raise AssertionError("card and CPU disagree on the small denoise")


def run(steps: int, dev: str = "cuda"):
    """Phases 2-4 on `dev`; returns (kernel results, main-path launches)."""
    import torch
    from lidiff_tpu_torch import config as cfg_mod
    from lidiff_tpu_torch.diffusion.dpm_solver import make_dpm_solver
    from lidiff_tpu_torch.models import diffusion
    from lidiff_tpu_torch.ops import grid, knn, sparse_conv

    # ---- inputs of the sampling path (180k points, res 0.05) ----
    # The synthetic rings merge less at the coarse levels than the scans the
    # default capacity table was measured on (lidiff_tpu/config.py), so
    # every level gets the full point count: no voxel is dropped.
    cfg = cfg_mod.finalize_config(make_cfg(
        N_PART * TILE, steps, caps={"capacity_fractions": [1.0] * 5}))
    task = diffusion.DiffusionTask(cfg, device=dev,
                                   compute_dtype=torch.bfloat16, seed=0)
    part = torch.from_numpy(ring_scan(N_PART)).to(dev)
    x_init = part.repeat(1, TILE, 1)
    gen = torch.Generator(device=dev).manual_seed(9)
    noisy = x_init + torch.randn(x_init.shape, generator=gen, device=dev)
    pyr = task.pyramid_full(noisy)            # the t ~ T regime
    pyr_c = task.pyramid_part(part)
    pyr_u = task.pyramid_part_tiny(torch.zeros_like(part))
    ovf = [int(v) for v in pyr.overflows()]
    ovf_c = [int(v) for v in pyr_c.overflows()]
    log(f"capacities full {cfg['tpu']['full_capacities']} part "
        f"{cfg['tpu']['part_capacities']}; voxels per level "
        f"{[int(l.geom.num) for l in pyr.levels]}; overflow full {ovf} "
        f"part {ovf_c}")
    if any(ovf) or any(ovf_c):
        raise AssertionError("capacity overflow on the sampling input")

    # ---- 2. kernels against their plain versions ----
    # C1 also at the cond bank the default capacity table gives (11264
    # rows at 180k points): the enlarged bank cut to it, which drops the
    # highest keys as a capacity overflow does
    cond = pyr_c.levels[-1].geom
    cap = cfg_mod.derive_capacities(N_PART, clean=True)[-1]
    cond_default = types.SimpleNamespace(coords=cond.coords[:cap].contiguous(),
                                         mask=cond.mask[:cap].contiguous(),
                                         capacity=cap)
    t0 = time.time()
    res = {"B1": check_b1(pyr, grid),
           "C1": check_c1(pyr, {"cond": cond,
                                "cond at the default capacity": cond_default,
                                "uncond": pyr_u.levels[-1].geom}, knn),
           "A1": check_a1(pyr, sparse_conv, dev)}
    log(f"kernel checks: {time.time() - t0:.1f} s")
    check_small_reference(cfg_mod, diffusion, dev)
    del pyr, pyr_c, pyr_u

    # ---- 3. the main path: one completion ----
    kernels = {"A1": sparse_conv._conv3_kernel, "B1": grid._kmap3_kernel,
               "C1": knn._nn_kernel}
    solver = make_dpm_solver("linear", 1000, steps, 3.5e-5, 0.007, device=dev)
    # a first completion warms the allocator and the library kernels'
    # first-use set-up; the second is the one timed and counted
    task.sample(x_init, part, torch.Generator(device=dev).manual_seed(2),
                solver=solver)
    _sync(dev)
    for k in kernels.values():
        k.launches = 0
    t0 = time.time()
    out = task.sample(x_init, part,
                      torch.Generator(device=dev).manual_seed(1),
                      solver=solver)
    _sync(dev)
    total_s = time.time() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    t0 = time.time()
    task.encode_banks(part)
    _sync(dev)
    enc_s = time.time() - t0
    step_ms = (total_s - enc_s) / steps * 1e3
    log(f"completion: {steps} steps of the 1000-step linear schedule, "
        f"{N_PART * TILE} points, bf16, G=2, w=6: {total_s:.3f} s, encoder "
        f"{enc_s * 1e3:.1f} ms, {step_ms:.1f} ms/step; launches {launches}")

    if dev == "cuda":
        # at the first step's cloud: anchors plus unit noise
        profile_step(task, noisy, task.encode_banks(part),
                     int(solver.timesteps[0]))

    # ---- 4. the output ----
    if tuple(out.shape) != (1, N_PART * TILE, 3) or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError("completion output is not finite or has the "
                             "wrong shape")
    return res, launches


_CATEGORIES = (("A1 conv3_columns", ("conv3_columns",)),
               ("B1 kmap3_columns", ("kmap3_columns",)),
               ("C1 nn_match", ("nn_match",)),
               ("GEMM (cuBLAS)", ("gemm", "xmma", "cutlass", "cublas",
                                  "nvjet")),
               ("sort", ("sort", "radix")),
               ("scatter/gather/index", ("index", "scatter", "gather")),
               ("copy/cast/concat", ("copy",)))


def profile_step(task, x_init, banks, t: int) -> None:
    """Device time by kernel over one guided denoise step (torch.profiler),
    and the device's busy share of the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        task.denoise_pair(x_init, *banks, t)
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    busy = sum(by_name.values())
    if not by_name:
        log("profile: the profiler saw no device events")
        return
    cats: dict[str, float] = {}
    for name, us in by_name.items():
        low = name.lower()
        cat = next((c for c, keys in _CATEGORIES
                    if any(k in low for k in keys)), "other")
        cats[cat] = cats.get(cat, 0.0) + us
    log(f"profile of one step (t={t}): wall {wall_us / 1e3:.1f} ms, device "
        f"busy {busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%)")
    for cat, us in sorted(cats.items(), key=lambda kv: -kv[1]):
        log(f"  {cat:22s} {us / 1e3:9.2f} ms  {100 * us / busy:5.1f}%")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"    {us / 1e3:8.2f} ms  {name[:110]}")


def _sync(dev: str) -> None:
    import torch
    if dev == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=4,
                    help="solver steps of the completion (default 4)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from lidiff_tpu_torch.ops import native
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 1. build ----
    t0 = time.time()
    reports = native.build_all()
    log(f"build: {len(reports)} kernel libraries in {time.time() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    res, launches = run(args.steps)
    for n, c in launches.items():
        if c == 0:
            raise AssertionError(f"kernel {n} was not launched on the main "
                                 "path")
    sources = {"A1": ("conv3_columns", "lidiff_tpu/ops/pallas_conv.py:840"),
               "B1": ("kmap3_columns", "lidiff_tpu/ops/pallas_kmap.py:120"),
               "C1": ("nn_match", "lidiff_tpu/ops/pallas_knn.py:289")}
    line = {"kernels": [
        {"name": f"{n} {src}", "route": "cuda",
         "source": f"lidiff_tpu_torch/csrc/{src}.cu", "replaces": rep,
         "launches": launches[n], **res[n]}
        for n, (src, rep) in sources.items()]}
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
