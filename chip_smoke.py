#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`lidiff_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--steps S]

From the root of a checkout, on a machine with one CUDA card (Hopper:
the kernels are built for sm_90a):
  1. builds the hand-written kernels from `lidiff_tpu_torch/csrc/` with nvcc;
  2. holds each kernel against its plain PyTorch version on the card at the
     shapes of the sampling path (B1 and C1 exactly, C1 at all five levels
     against both conditioning banks over each bank's index, with the
     index's build time and the rows examined per query; A1 within the
     stated tolerances), and times both;
  3. runs one classifier-free completion through `DiffusionTask.sample` at
     full width (cr=1, out_dim 96, bf16) on a 180k-point synthetic ring
     scan, G=2 fused cond/uncond, w=6, S steps of the 1000-step linear
     schedule, counting each kernel's launches in that run (C1: 10 per
     step, 5 of them the uncond bank's scan, and 2 index builds);
  4. checks the output (finite, shape, zero capacity overflow) and a small
     f32 denoise on the card against the same weights on the CPU;
  5. holds the conv's backward kernels against their plain versions at the
     same widths (A3, the weight gradient, over the map's tile plan in
     bf16, and A2, the feats gradient through the autograd Function), and a
     small f32 training step on the card against the CPU (loss and every
     parameter's gradient);
  6. takes 2 + 3 optimizer steps through `Trainer.train_step` at full width
     on the same 180k-point scan (bf16 compute, float32 activations, batch
     1), split into forward, backward and optimizer time, with launch
     counts, peak memory and a profile of one step;
  7. runs the `lidiff_tpu_torch.train` CLI on a small synthetic KITTI tree:
     two steps, then a resume that takes a third;
  8. holds the pruned 1-NN matcher (kernel C2 and its window-bound kernel)
     against kernel C1 on every valid query and against the plain versions
     on 65,536 queries, at the refiner's chamfer shape (1.08M x 360k and
     back), on a two-item batch with invalid rows, and at the sampling
     shapes; holds the chamfer loss (exact and grid) against the CPU, and a
     small f32 refiner training step on the card against the CPU;
  9. takes 2 + 3 optimizer steps on `RefineTask` through
     `Trainer.train_step` at full width (180k jittered points, up_factor 6,
     a 360k-point target), split into model forward, chamfer index passes,
     the rest of the loss, backward and optimizer;
 10. holds kernel A4 (the int8 eval conv) against its plain version at every
     sampling width with Cin >= 32, beside A1, with its prologue timed
     apart, and on integer feats against A1; runs the same completion with
     `conv_quant` on (the same weights, offset and noise; launch counts, the
     chamfer distance to the bf16 output) and a small f32 int8 denoise on
     the card against the CPU;
 11. runs the completion pipeline at full width through
     `DiffCompletion.complete_scan` on random-init checkpoints saved as a
     user's are, bf16 and int8 (on the bf16 run's crop and FPS), 4 solver
     steps and the refiner (180k -> 1.08M points), with the time of each
     stage, then the metrics of
     `eval_path` against a synthetic ground truth;
 12. runs the CLIs on one small synthetic KITTI tree: `train` (two steps,
     a resume to step 3, `--test`), `train_refine` (sanity validation, two
     steps, a resume to step 3, `--test`), `map_from_scans`, the pipeline
     on both trained checkpoints with LIDIFF_CONV_QUANT=int8, and
     `eval_path` on its .ply files and live.
It prints one line per phase, then a {"kernels": [...]} JSON line, the
card's name and power limit, and last {"ok": true, "device": {...}}. Any
failure raises and exits non-zero; so does a run without a CUDA device or
outside a checkout.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
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
# A3 sums float32 products over up to 180k rows and 2 groups: in float32
# across blocks with atomics in an order that changes from run to run, in
# bf16 per chunk of the tile plan and then the chunks in a fixed order; the
# plain version sums inside one float32 GEMM. x max|ref|. In bf16 the
# products are the same, but the tensor cores truncate where they add to the
# float32 accumulator, which biases a long sum: 8.7e-5 seen at 2 x 158k rows.
A3_F32_TOL = 1e-4
A3_BF16_TOL = 5e-4
A3_TIMED = (384, 256, 3, 1)  # (C, Co, level, G): the kernels line's A2, A3
# small float32 training step, card against CPU: sums in other orders over
# about 100 layers forward and backward, and BatchNorm over a few hundred
# voxels on the coarse levels divides by small variances
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 2e-3       # x that parameter's max|grad| ...
TRAIN_GRAD_ATOL = 1e-4      # ... plus this x the largest max|grad| of all
TRAIN_WARMUP = 2            # untimed optimizer steps first: the first
                            # step after them still ran up to 2.5x slower in
                            # its forward phase with one warm-up step
TRAIN_STEPS = 3             # timed optimizer steps
CONVS_PER_STEP = 52         # column convs: 34 in the denoiser, 18 encoder
PIPE_SCAN = 120_000         # points of the pipeline's synthetic scan, about
                            # a KITTI scan before the range crop and FPS
SMALL_DENOISE_TOL = 1e-3    # small f32 guided denoise (float32 or int8
                            # convs), card against CPU, x max(max|eps|, 1)
REFINE_UP = 6               # offsets per point: 180k points -> 1.08M
C2_SUBSET_TILES = 256       # whole query tiles (65,536 queries) held
                            # against the plain versions
PLAIN_PAIRS = 1 << 28       # (query, ref) pairs per block of nn_match_plain
CHAMFER_GRID_RTOL = 1e-3    # grid against exact loss, as tests/test_chamfer.py
CHAMFER_CPU_RTOL = 1e-5     # card against CPU: float32 sums in other orders
CHOICES_DIFFER = 1e-4       # share of ReLU signs, and of chamfer picks, that
                            # may fall the other way on the CPU: inputs
                            # within float32 rounding of zero, resp. points
                            # within it of a grid cell's edge


# kernels whose entry point is not named after their source file
NAMES = {"C2w": "nn_window_bound"}


def log(msg: str) -> None:
    print(msg, flush=True)


class Count:
    """A counter kept as an attribute of `obj`, read and reset as a kernel
    wrapper's `launches` is."""

    def __init__(self, obj, attr: str):
        self.obj, self.attr = obj, attr

    @property
    def launches(self) -> int:
        return getattr(self.obj, self.attr)

    @launches.setter
    def launches(self, value: int) -> None:
        setattr(self.obj, self.attr, value)


def kernel_table() -> dict:
    """The launch counters of every kernel the main paths run, by name:
    each has a `launches` that its wrapper raises at a launch."""
    from lidiff_tpu_torch.ops import grid, knn, sparse_conv
    return {"A1": sparse_conv._conv3_kernel,
            "A4": sparse_conv._conv3_q_kernel,
            "A2": sparse_conv.Conv3ColumnsFunction,
            "A3": sparse_conv._conv3_dw_kernel,
            "B1": grid._kmap3_kernel, "C1": knn._nn_kernel,
            "C1 scan": Count(knn._nn_kernel, "scans"),
            "C1 index": Count(knn.NNIndex, "builds"),
            "C2": knn._pruned_kernel, "C2w": knn._bound_kernel}


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
        "train": {"uncond_prob": 0.1, "uncond_w": 6.0, "n_gpus": 1,
                  "lr": 1e-4, "batch_size": 1},
        "diff": {"beta_start": 3.5e-5, "beta_end": 0.007,
                 "beta_func": "linear", "t_steps": 1000, "s_steps": s_steps,
                 "reg_weight": 5.0},
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
    """C1 against its plain version at every level's queries and each bank,
    over the bank's index as the main path builds it: indices equal on
    valid queries, 0 on invalid ones. Times the index build and each
    level; counts the rows examined per valid query. Returns the main
    path's L0 x cond bank result."""
    import torch
    out = {}
    for name, bank in banks.items():
        index = knn.build_nn_index(bank.coords, bank.mask, 1)
        build_ms = _time_ms(lambda: knn.build_nn_index(bank.coords,
                                                       bank.mask, 1), 3)
        nr = int(bank.mask.sum())
        log(f"C1 index of the {name} bank: {nr} valid of {bank.capacity} "
            f"rows, cell {index.cell}, grid {index.dims}"
            f"{' (one cell: a scan)' if index.scan else ''}, built in "
            f"{build_ms:.4f} ms")
        for li, lvl in enumerate(pyr.levels):
            g = lvl.geom
            idx, pairs = knn.nn_match(g.coords, bank.coords, bank.mask, 1,
                                      g.mask, index, pairs=True)
            ref = knn.nn_match_plain(g.coords, bank.coords, bank.mask,
                                     g.mask)
            if not torch.equal(idx, ref):
                bad = int((idx != ref)[g.mask].sum())
                raise AssertionError(
                    f"C1 differs from its plain version on {bad} valid "
                    f"queries (L{li} x {name} bank)")
            ms = _time_ms(lambda: knn.nn_match(g.coords, bank.coords,
                                               bank.mask, 1, g.mask, index))
            nq = int(g.mask.sum())
            examined = float(pairs[g.mask].double().sum())
            # The bound is the bytes: the queries and their mask, the index
            # and the output, each moved once; no count of operations
            # follows from the inputs alone. For comparison, at 8
            # operations per (query, ref) pair (3 multiply-adds, a
            # subtract, a compare): the pairs this search examined (which
            # depend on its design) and those of a full scan.
            nbytes = g.capacity * 21 + nr * 16 + \
                index.cell_start.shape[0] * 4
            bound, by = _bound_ms(0, PEAK_F32, nbytes)
            scan_bound, _ = _bound_ms(nq * nr * 8, PEAK_F32, 0)
            examined_bound, _ = _bound_ms(examined * 8, PEAK_F32, 0)
            plain_ms = (_time_ms(lambda: knn.nn_match_plain(
                g.coords, bank.coords, bank.mask, g.mask), 3)
                if li == 0 else None)
            log(f"C1 nn_match L{li}: {g.capacity} queries ({nq} valid) x "
                f"{name} bank: exact; {ms:.4f} ms, "
                f"{examined / max(nq, 1):.1f} rows examined per valid "
                f"query; bound {bound:.4f} ms ({by}); the examined pairs' "
                f"operations {examined_bound:.4f} ms, a full scan's "
                f"{scan_bound:.4f} ms"
                + (f"; plain {plain_ms:.4f} ms" if plain_ms else ""))
            if li == 0:
                out[name] = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound, bound_by=by,
                                 library_ms=None,
                                 scan_bound_ms=scan_bound,
                                 examined_bound_ms=examined_bound,
                                 index_ms=build_ms,
                                 pairs_per_query=examined / max(nq, 1))
    return out["cond"]


def _computed_taps(pattern):
    """Tap products the bf16 kernel computes for rows in this order: 64 per
    tap that some row of each 64-row tile hits."""
    import torch
    from lidiff_tpu_torch.ops import grid
    taps = grid.tile_taps(pattern)
    bits = (taps[:, None] >> torch.arange(27, device=taps.device)) & 1
    return grid.TILE_ROWS * int(bits.sum())


def plan_stats(pyr, dev, what: str):
    """Per level of `pyr`: the tile plan's build time, and the computed tap
    products over hit taps (the redundancy) with 64-row tiles in key order
    and in plan order. Returns {level: (hit taps, computed in key order,
    computed in plan order)}."""
    import torch
    from lidiff_tpu_torch.ops import grid
    stats = {}
    for li, lvl in enumerate(pyr.levels):
        km, g = lvl.kmap3, lvl.geom
        ms = (_time_ms(lambda: grid.tile_plan(km.hit), 5) if dev == "cuda"
              else float("nan"))
        pattern = grid.hit_patterns(km.hit, g.mask)
        plan = km.plan()
        hits = int(km.hit.sum())
        before = _computed_taps(pattern)
        after = _computed_taps(pattern[plan.order.long()])
        zero = int((plan.tile_taps == 0).sum())
        stats[li] = (hits, before, after)
        log(f"tile plan {what} L{li}: V={g.capacity}, "
            f"{hits / max(int(g.mask.sum()), 1):.2f} hit taps/voxel; "
            f"computed/hit taps {before / max(hits, 1):.2f}x in key order, "
            f"{after / max(hits, 1):.2f}x in plan order; "
            f"{zero} of {plan.tile_taps.shape[0]} tiles with no tap; "
            f"build {ms:.4f} ms")
    return stats


def check_a1(pyr, sc, dev, stats):
    """A1 against its plain version at every width of the path, G in {1, 2},
    float32 and bf16, with bias, ReLU and the mask; bf16 over the map's
    tile plan. `stats` from plan_stats(pyr)."""
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
                                       nvalid=km.nvalid,
                                       plan=km.plan()).float()
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
        plan = km.plan()
        ms = _time_ms(lambda: sc.conv3_columns(*args, bias=b, relu=True,
                                               nvalid=km.nvalid, plan=plan))
        hits = int(km.hit[g.mask].sum())
        flops = 2.0 * hits * cin * cout * G
        _, before, after = stats[li]
        nbytes = (V * G * cin * 2 + V * 9 * 4 + V * 27 + V
                  + 27 * cin * cout * 2 + cout * 4 + V * G * cout * 2)
        bound, by = _bound_ms(flops, PEAK_BF16, nbytes)
        log(f"A1 time ({cin:3d},{cout:3d}) L{li} G={G} bf16, "
            f"{hits / int(g.mask.sum()):.2f} hit taps/voxel: {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s over hit taps, "
            f"{flops * after / hits / ms / 1e9:.1f} over computed taps; "
            f"computed/hit {before / hits:.2f}x key order, "
            f"{after / hits:.2f}x plan), bound {bound:.4f} ms ({by})")
        if (cin, cout, li, G) == A1_TIMED:
            plain_ms = _time_ms(lambda: sc.conv3_columns_plain(
                *args, bias=b, relu=True), 3)
            timed = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by, library_ms=None)
    log(f"A1 {A1_TIMED}: plain version {timed['plain_ms']:.4f} ms")
    return timed


def check_prologue(f, w, G, q, w_q):
    """The prologue on the card against the Pallas kernel's formula
    (lidiff_tpu/ops/pallas_conv.py:911-927), exactly: one scale per channel
    over all rows and both groups, times the float32 reciprocal of 127,
    round half to even, the scale folded into the weights."""
    import torch
    V, C = f.shape[0], w.shape[1]
    f3 = f.float().reshape(V, G, C)
    scale = torch.maximum(f3.abs().amax(dim=(0, 1)),
                          torch.tensor(1e-12, device=f.device)) \
        * torch.tensor(1.0 / 127.0, dtype=torch.float32, device=f.device)
    want_q = torch.round(f3 / scale[None, None, :]).clamp(-127, 127)
    want_w = (w.float() * scale[None, :, None]).to(w.dtype)
    if not (q.dtype == torch.int8
            and torch.equal(q.float().reshape(V, G, C), want_q)
            and torch.equal(w_q, want_w)):
        raise AssertionError("the A4 prologue differs from the Pallas "
                             "kernel's formula")


def check_a4(pyr, sc, dev):
    """A4 against its plain version on the same int8 feats and folded
    weights at every width of the path with Cin >= 32, G in {1, 2}, float32
    and bf16, with bias, ReLU and the mask; integer feats with amax 127
    against A1 (scale 1: the same function, bit for bit). Times A4, A1 and
    the prologue at G=2 bf16, the sampling path's case."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(4)
    timed = None
    for cin, cout, li in A1_WIDTHS:
        if cin < sc.QUANT_MIN_CIN:
            continue
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
                q, w_q = sc.quantize_feats(f, w, G)
                check_prologue(f, w, G, q, w_q)
                qargs = (q, km.col_idx, km.hit, w_q, g.mask, G, b, True, dt)
                got = sc._conv3_q_run(*qargs, km.nvalid,
                                      km.plan()).float()
                ref = sc.conv3_columns_q_plain(*qargs).float()
                err = (got - ref).abs()
                scale = float(ref.abs().max())
                if dt == torch.float32:
                    ok = float(err.max()) <= A1_F32_TOL * scale
                else:
                    ok = bool((err <= A1_BF16_RTOL * ref.abs()
                               + A1_BF16_ATOL * scale).all())
                if not ok:
                    raise AssertionError(
                        f"A4 ({cin},{cout}) G={G} {dt}: max err "
                        f"{float(err.max()):.3g} at scale {scale:.3g}")
                if G == 1 or dt == torch.float32:
                    continue
                ms = _time_ms(lambda: sc._conv3_q_run(*qargs, km.nvalid,
                                                      km.plan()))
                a1_ms = _time_ms(lambda: sc.conv3_columns(
                    f, km.col_idx, km.hit, w, g.mask, G, bias=b, relu=True,
                    nvalid=km.nvalid, plan=km.plan()))
                pro_ms = _time_ms(lambda: sc.quantize_feats(f, w, G))
                hits = int(km.hit[g.mask].sum())
                flops = 2.0 * hits * cin * cout * G
                # int8 feats, the map, bf16 folded weights, bias, bf16 out
                nbytes = (V * G * cin + V * 9 * 4 + V * 27 + V
                          + 27 * cin * cout * 2 + cout * 4 + V * G * cout * 2)
                bound, by = _bound_ms(flops, PEAK_BF16, nbytes)
                log(f"A4 conv3_columns_q ({cin:3d},{cout:3d}) L{li} G=2 bf16:"
                    f" max err {float(err.max()):.3g} "
                    f"({float(err.max()) / max(scale, 1e-30):.2e} of "
                    f"max|ref|; float32 and G=1 checked too); {ms:.4f} ms "
                    f"({flops / ms / 1e9:.1f} TFLOP/s), A1 {a1_ms:.4f} ms, "
                    f"prologue {pro_ms:.4f} ms, bound {bound:.4f} ms ({by})")
                if (cin, cout, li, G) == A1_TIMED:
                    plain_ms = _time_ms(lambda: sc.conv3_columns_q_plain(
                        *qargs), 3)
                    timed = dict(max_abs_err=float(err.max()), ms=ms,
                                 plain_ms=plain_ms, bound_ms=bound,
                                 bound_by=by, library_ms=None,
                                 prologue_ms=pro_ms, a1_ms=a1_ms)
    # integer feats: q = feats, folded weights = weights
    lvl = pyr.levels[0]
    g, km = lvl.geom, lvl.kmap3
    for dt in (torch.float32, torch.bfloat16):
        f = torch.randint(-127, 128, (g.capacity, 64), generator=gen,
                          device=dev).float() * g.mask[:, None]
        f[0] = 127.0                  # every channel's amax is 127
        f = f.to(dt)
        w = (0.1 * torch.randn(27, 32, 32, generator=gen, device=dev)).to(dt)
        args = (f, km.col_idx, km.hit, w, g.mask, 2)
        got = sc.conv3_columns_q(*args, bias=None, relu=True,
                                 nvalid=km.nvalid)
        ref = sc.conv3_columns(*args, relu=True, nvalid=km.nvalid)
        if not torch.equal(got, ref):
            raise AssertionError(f"A4 on integer feats ({dt}) differs from "
                                 f"A1 by {float((got - ref).abs().max())}")
    log(f"A4 {A1_TIMED}: plain version {timed['plain_ms']:.4f} ms; integer "
        "feats equal A1 bit for bit (float32 and bf16)")
    return timed


def _conv_inputs(lvl, cin, cout, G, dt, gen, dev):
    """Masked feats, a cotangent with non-zero masked rows, weights."""
    import torch
    g = lvl.geom
    V = g.capacity
    f = torch.randn(V, G * cin, generator=gen, device=dev)
    f = (f * g.mask[:, None]).to(dt)
    cot = torch.randn(V, G * cout, generator=gen, device=dev)
    w = (torch.randn(27, cin, cout, generator=gen, device=dev)
         / math.sqrt(27 * cin)).to(dt)
    return f, cot, w


def check_backward(pyr, sc, dev):
    """The conv's backward at every width of the path, G in {1, 2}, float32
    and bf16: A3 against its plain version, and A2's feats gradient (through
    the autograd Function) against the plain conv of the masked cotangent
    with flipped, transposed weights. Times at G=1, training's group
    count."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(5)
    cases, res = [], {}
    for cin, cout, li in A1_WIDTHS:
        lvl = pyr.levels[li]
        g, km = lvl.geom, lvl.kmap3
        for G in (1, 2):
            for dt in (torch.float32, torch.bfloat16):
                f, cot, w = _conv_inputs(lvl, cin, cout, G, dt, gen, dev)
                # --- A3
                a3 = (f, cot.to(dt), km.col_idx, km.hit, g.mask, G)
                # bf16 runs over the map's plan, as the training path does
                kw3 = dict(nvalid=km.nvalid,
                           plan=km.plan() if dt == torch.bfloat16 else None)
                dw = sc.conv3_columns_dw(*a3, **kw3)
                dw_ref = sc.conv3_columns_dw_plain(*a3)
                scale3 = float(dw_ref.abs().max())
                err3 = float((dw - dw_ref).abs().max())
                tol3 = A3_F32_TOL if dt == torch.float32 else A3_BF16_TOL
                if not (scale3 > 0 and err3 <= tol3 * scale3):
                    raise AssertionError(
                        f"A3 ({cin},{cout}) G={G} {dt}: max err {err3:.3g} "
                        f"at scale {scale3:.3g}")
                # --- A2: feats gradient through the Function; forward
                # output float32, as in training
                ff = f.clone().requires_grad_(True)
                out = sc.conv3_columns(ff, km.col_idx, km.hit, w, g.mask, G,
                                       out_dtype=torch.float32,
                                       nvalid=km.nvalid)
                if out.grad_fn is None:
                    raise AssertionError("conv3_columns built no graph")
                df, = torch.autograd.grad(out, ff, cot, retain_graph=True)
                cot_m = torch.where(g.mask[:, None], cot, 0.0).to(dt)
                w_rev = w.flip(0).transpose(1, 2).contiguous()
                a2 = (cot_m, km.col_idx, km.hit, w_rev, g.mask, G)
                df_ref = sc.conv3_columns_plain(*a2).float()
                err = (df.float() - df_ref).abs()
                scale2 = float(df_ref.abs().max())
                if dt == torch.float32:
                    ok = float(err.max()) <= A1_F32_TOL * scale2
                else:
                    ok = bool((err <= A1_BF16_RTOL * df_ref.abs()
                               + A1_BF16_ATOL * scale2).all())
                if not (ok and df.dtype == dt):
                    raise AssertionError(
                        f"A2 df ({cin},{cout}) G={G} {dt}: max err "
                        f"{float(err.max()):.3g} at scale {scale2:.3g}")
                log(f"A3 dW / A2 df ({cin:3d},{cout:3d}) L{li} G={G} "
                    f"{str(dt)[6:]:8s}: dW max err {err3:.3g} "
                    f"({err3 / scale3:.2e} of max|ref|), df max err "
                    f"{float(err.max()):.3g} "
                    f"({float(err.max()) / max(scale2, 1e-30):.2e})")
                if dt == torch.bfloat16 and G == 1:
                    cases.append((cin, cout, li, a3, kw3, a2, out, ff, cot,
                                  km, g, err3, float(err.max())))
    for cin, cout, li, a3, kw3, a2, out, ff, cot, km, g, err3, err2 in cases:
        V = g.capacity
        hits = int(km.hit[g.mask].sum())
        flops = 2.0 * hits * cin * cout
        kmap_bytes = V * 9 * 4 + V * 27 + V
        ms3 = _time_ms(lambda: sc.conv3_columns_dw(*a3, **kw3))
        b3, by3 = _bound_ms(flops, PEAK_BF16,
                            V * cin * 2 + V * cout * 2 + kmap_bytes
                            + 27 * cin * cout * 4)
        # the Function's backward for feats alone: mask and cast of the
        # float32 cotangent, weight flip, one A1 launch
        ms2 = _time_ms(lambda: torch.autograd.grad(out, ff, cot,
                                                   retain_graph=True))
        b2, by2 = _bound_ms(flops, PEAK_BF16,
                            V * cout * 4 + kmap_bytes + 27 * cin * cout * 2
                            + V * cin * 2)
        log(f"A3 time ({cin:3d},{cout:3d}) L{li} G=1 bf16: {ms3:.4f} ms "
            f"({flops / ms3 / 1e9:.1f} TFLOP/s), bound {b3:.4f} ms ({by3}); "
            f"A2 df time {ms2:.4f} ms, bound {b2:.4f} ms ({by2})")
        if (cin, cout, li, 1) == A3_TIMED:
            p3 = _time_ms(lambda: sc.conv3_columns_dw_plain(*a3), 3)
            p2 = _time_ms(lambda: sc.conv3_columns_plain(*a2), 3)
            res["A3"] = dict(max_abs_err=err3, ms=ms3, plain_ms=p3,
                             bound_ms=b3, bound_by=by3, library_ms=None)
            res["A2"] = dict(max_abs_err=err2, ms=ms2, plain_ms=p2,
                             bound_ms=b2, bound_by=by2, library_ms=None)
    log(f"A3 {A3_TIMED}: plain version {res['A3']['plain_ms']:.4f} ms; "
        f"A2 df plain version {res['A2']['plain_ms']:.4f} ms")
    return res


def check_small_train(cfg_mod, diffusion, dev):
    """A small f32 training step on the card (kernels) against the same
    weights, noise, timesteps and coin on the CPU (plain versions): the
    loss and every parameter's gradient."""
    import numpy as np
    import torch
    caps = {"full_capacities": [4096] * 3 + [3072, 2048],
            "part_capacities": [512] * 5}
    cfg = cfg_mod.finalize_config(make_cfg(4000, 2, cr=0.25, caps=caps))
    rng = np.random.default_rng(6)
    part = np.concatenate([ring_scan(400, seed=3), ring_scan(400, seed=4)])
    full = np.tile(part, (1, TILE, 1)) + rng.normal(
        0, 0.05, (2, 400 * TILE, 3)).astype(np.float32)
    noise = rng.normal(size=full.shape).astype(np.float32)
    t = np.array([700, 150])
    out = {}
    for d in (dev, "cpu"):
        task = diffusion.DiffusionTask(cfg, device=d,
                                       compute_dtype=torch.float32, seed=2)
        batch = {"pcd_full": torch.from_numpy(full).to(d),
                 "pcd_part": torch.from_numpy(part).to(d)}
        loss, _ = task.loss_fn(batch, noise=torch.from_numpy(noise).to(d),
                               t=torch.from_numpy(t).to(d), drop=False)
        loss.backward()
        out[d] = (float(loss.detach()), {n: p.grad.cpu() for n, p in
                                task.model.named_parameters()})
    (l_card, g_card), (l_cpu, g_cpu) = out[dev], out["cpu"]
    top = max(float(g.abs().max()) for g in g_cpu.values())
    worst, worst_name = 0.0, ""
    for n, ref in g_cpu.items():
        err = float((g_card[n] - ref).abs().max())
        lim = TRAIN_GRAD_TOL * float(ref.abs().max()) + TRAIN_GRAD_ATOL * top
        if err / lim > worst:
            worst, worst_name = err / lim, n
    log(f"small f32 training step, card vs CPU: loss {l_card:.6f} vs "
        f"{l_cpu:.6f}; {len(g_cpu)} gradients, worst at {worst:.3f} of its "
        f"tolerance ({worst_name}), max|grad| {top:.3g}")
    if not abs(l_card - l_cpu) <= TRAIN_LOSS_RTOL * abs(l_cpu):
        raise AssertionError("card and CPU disagree on the training loss")
    if not worst <= 1.0:
        raise AssertionError(f"card and CPU disagree on the gradient of "
                             f"{worst_name}")


def check_small_reference(cfg_mod, diffusion, dev, conv_quant=False):
    """A small f32 guided denoise on the card (kernels) against the same
    weights and input on the CPU (plain versions); with `conv_quant` the
    int8 convs (A4), and the count of outputs off by more than 1e-4 of
    max|eps|, where an int8 step rounded the other way would show."""
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
                                       compute_dtype=torch.float32, seed=2,
                                       conv_quant=conv_quant)
        banks = task.encode_banks(torch.from_numpy(part).to(d))
        eps[d] = task.denoise_pair(torch.from_numpy(x).to(d), *banks,
                                   500).cpu()
    diff = (eps[dev] - eps["cpu"]).abs()
    err, scale = float(diff.max()), float(eps["cpu"].abs().max())
    what = "int8" if conv_quant else "f32"
    log(f"small {what} guided denoise, card vs CPU: max err {err:.3g} "
        f"(max|eps| {scale:.3g}); {int((diff > 1e-4 * scale).sum())} of "
        f"{diff.numel()} outputs off by more than 1e-4 of max|eps|")
    if not err <= SMALL_DENOISE_TOL * max(scale, 1.0):
        raise AssertionError(f"card and CPU disagree on the small {what} "
                             "denoise")


def run_int8_completion(task, x_init, part, solver, out_bf16, bf16, kernels,
                        steps, dev):
    """The completion of phase 3 with `conv_quant` on: the same weights,
    offset and noise (the same generator seed). Checks zero overflow, a
    finite output and the launches (A1 only for the stem's Cin=3 conv: once
    per step and once per bank); reports ms per step and the chamfer
    distance to the bf16 output. Returns the launches."""
    import torch
    from lidiff_tpu_torch.ops import chamfer
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
    # per guided step one match per level and bank, the uncond bank's a
    # scan; one index per bank and completion
    want = {"C1": 10 * steps, "C1 scan": 5 * steps, "C1 index": 2}
    if dev == "cuda" and any(launches[n] != c for n, c in want.items()):
        raise AssertionError(f"completion launches {launches}, expected "
                             f"{want}")
    t0 = time.time()
    task.encode_banks(part)
    _sync(dev)
    enc_s = time.time() - t0
    step_ms = (total_s - enc_s) / steps * 1e3
    ovf = [int(v) for v in task.pyramid_full(out).overflows()]
    cd = float(chamfer.chamfer_distance(out, out_bf16))
    log(f"int8 completion (conv_quant): {total_s:.3f} s, encoder "
        f"{enc_s * 1e3:.1f} ms, {step_ms:.1f} ms/step (bf16 "
        f"{bf16['step_ms']:.1f} ms/step, encoder {bf16['enc_ms']:.1f} ms); "
        f"launches {launches}; chamfer distance to the bf16 output {cd:.5f} "
        f"(random weights); overflow at the output {ovf}")
    if tuple(out.shape) != tuple(out_bf16.shape) or \
            not bool(torch.isfinite(out).all()) or any(ovf):
        raise AssertionError("int8 completion output is not finite, has the "
                             "wrong shape or overflows")
    if dev == "cuda":
        want = {"A1": steps + 2,
                "A4": bf16["launches"]["A1"] - steps - 2,
                "B1": bf16["launches"]["B1"], "C1": bf16["launches"]["C1"]}
        for n, c in want.items():
            if launches[n] != c:
                raise AssertionError(f"int8 completion: kernel {n}: "
                                     f"{launches[n]} launches, expected {c}")
        banks = task.encode_banks(part)
        t_first = int(solver.timesteps[0])
        profile_step(lambda: task.denoise_pair(x_init + torch.randn(
            x_init.shape, generator=torch.Generator(device=dev).manual_seed(9),
            device=dev), *banks, t_first),
            f"one int8 guided sampling step (t={t_first})")
    return launches


def run(steps: int, dev: str = "cuda"):
    """Phases 2-12 on `dev`; returns (kernel results, {path: launches} for
    the sampling, int8 sampling, training, refiner training and pipeline
    paths)."""
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
    stats = plan_stats(pyr, dev, "t~T")
    plan_stats(task.pyramid_full(x_init + 0.01 * torch.randn(
        x_init.shape, generator=torch.Generator(device=dev).manual_seed(10),
        device=dev)), dev, "t~0")
    res = {"B1": check_b1(pyr, grid),
           "C1": check_c1(pyr, {"cond": cond,
                                "cond at the default capacity": cond_default,
                                "uncond": pyr_u.levels[-1].geom}, knn),
           "A1": check_a1(pyr, sparse_conv, dev, stats),
           "A4": check_a4(pyr, sparse_conv, dev)}
    # C2 at the sampling shapes, beside C1 (the sampling path keeps C1)
    g0 = pyr.levels[0].geom
    for name, bank in (("cond", cond),
                       ("cond at the default capacity", cond_default)):
        check_c2_case(knn, f"sampling, L0 queries x {name} bank", g0.coords,
                      g0.mask, bank.coords, bank.mask, 1)
    res.update(check_backward(pyr, sparse_conv, dev))
    log(f"kernel checks: {time.time() - t0:.1f} s")
    check_small_reference(cfg_mod, diffusion, dev)
    check_small_reference(cfg_mod, diffusion, dev, conv_quant=True)
    check_small_train(cfg_mod, diffusion, dev)
    check_c2_case(knn, "two items, invalid rows", *batched_match_inputs(dev),
                  2)
    check_chamfer(dev)
    check_small_refine_train(cfg_mod, dev)
    del pyr, pyr_c, pyr_u, g0

    # ---- 3. the main path: one completion ----
    kernels = kernel_table()
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
    # per guided step one match per level and bank, the uncond bank's a
    # scan; one index per bank and completion
    want = {"C1": 10 * steps, "C1 scan": 5 * steps, "C1 index": 2}
    if dev == "cuda" and any(launches[n] != c for n, c in want.items()):
        raise AssertionError(f"completion launches {launches}, expected "
                             f"{want}")
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
        banks = task.encode_banks(part)
        t_first = int(solver.timesteps[0])
        profile_step(lambda: task.denoise_pair(noisy, *banks, t_first),
                     f"one guided sampling step (t={t_first})")
        del banks

    # ---- 4. the output ----
    if tuple(out.shape) != (1, N_PART * TILE, 3) or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError("completion output is not finite or has the "
                             "wrong shape")
    del task
    # ---- 10. the same completion with the int8 convs ----
    task_q = diffusion.DiffusionTask(cfg, device=dev,
                                     compute_dtype=torch.bfloat16, seed=0,
                                     conv_quant=True)
    int8_launches = run_int8_completion(
        task_q, x_init, part, solver, out, {
            "step_ms": step_ms, "enc_ms": enc_s * 1e3, "launches": launches},
        kernels, steps, dev)
    del task_q, out

    # ---- 6. the training path at full width ----
    train_launches = run_training(cfg, kernels, x_init, part, dev)
    # ---- 8, 9. the refiner at full width ----
    c2_res, refine_launches = run_refine(cfg, kernels, dev)
    res.update(c2_res)
    # ---- 11. the pipeline at full width ----
    pipe_launches = run_pipeline(cfg, kernels, steps, dev)
    # ---- 7, 10, 12. the CLIs on one small tree ----
    with tempfile.TemporaryDirectory() as tree:
        make_kitti_tree(tree)
        run_cli(dev, tree)
        run_refine_cli(dev, tree)
        run_eval_clis(dev, tree, kernels)
    return res, {"sampling": launches, "int8 sampling": int8_launches,
                 "training": train_launches,
                 "refiner training": refine_launches,
                 "pipeline": pipe_launches}


def train_steps(task, cfg, batch, gen, kernels, dev, what: str,
                loss_key: str, want: dict, describe, instrument=None):
    """TRAIN_WARMUP + TRAIN_STEPS optimizer steps through
    Trainer.train_step, each timed step split by device events into forward
    (the task's loss_fn), backward and optimizer. Checks a finite loss, a
    finite gradient for every parameter, that every parameter and running
    statistic moved and, on the card, the launches per step in `want`;
    then profiles one more step. `describe(metrics)` words a step's
    metrics; `instrument(mark)` may set further marks inside the forward
    phase and returns (undo, split) with split(marks of one step, elapsed)
    wording them. Returns the kernels' launches over the timed steps."""
    import torch
    from lidiff_tpu_torch.training.trainer import Trainer
    cuda = dev == "cuda"
    model = task.model
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    marks = []

    def mark(name):
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.time()
        marks.append((name, ev))

    def elapsed(a, b):
        return a.elapsed_time(b) if cuda else (b - a) * 1e3

    with tempfile.TemporaryDirectory() as exp_dir:
        trainer = Trainer(task, cfg, exp_dir)
        for _ in range(TRAIN_WARMUP):
            trainer.train_step(batch, gen)
        _sync(dev)
        for k in kernels.values():
            k.launches = 0
        # a device event where each phase of a step has been enqueued: the
        # loss function's return, and the optimizer's step hooks
        loss_fn = task.loss_fn

        def timed_loss_fn(*a, **kw):
            out = loss_fn(*a, **kw)
            mark("forward")
            return out

        task.loss_fn = timed_loss_fn
        hooks = [trainer.optimizer.register_step_pre_hook(
                     lambda *_: mark("backward")),
                 trainer.optimizer.register_step_post_hook(
                     lambda *_: mark("optimizer"))]
        undo, split = instrument(mark) if instrument else (None, None)
        losses = []
        try:
            for _ in range(TRAIN_STEPS):
                mark("start")
                losses.append(trainer.train_step(batch, gen))
            _sync(dev)
        finally:
            del task.loss_fn              # back to the class's method
            for h in hooks:
                h.remove()
            if undo:
                undo()
        launches = {n: k.launches for n, k in kernels.items()}
        per_step = {n: c / TRAIN_STEPS for n, c in launches.items() if c}
        starts = [i for i, (n, _) in enumerate(marks) if n == "start"]
        for i, s in enumerate(starts):
            step = marks[s:starts[i + 1] if i + 1 < len(starts) else None]
            at = dict(step)
            fwd, bwd, opt = (elapsed(at[a], at[b]) for a, b in (
                ("start", "forward"), ("forward", "backward"),
                ("backward", "optimizer")))
            log(f"{what} step {i + 1}: {fwd + bwd + opt:.1f} ms (forward "
                f"{fwd:.1f}{split(step, elapsed) if split else ''}, backward "
                f"{bwd:.1f}, optimizer {opt:.1f}); {describe(losses[i])}")
        total = elapsed(marks[0][1], marks[-1][1]) / TRAIN_STEPS
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
        log(f"{what}: {total:.1f} ms/step over {TRAIN_STEPS} steps; launches "
            f"per step {per_step}; peak device memory {peak:.2f} GiB")

        # ---- checks ----
        if not all(math.isfinite(float(m[loss_key])) for m in losses):
            raise AssertionError(f"{what}: the loss is not finite")
        for n, p in model.named_parameters():
            if p.grad is None or not bool(torch.isfinite(p.grad).all()):
                raise AssertionError(f"{what}: no finite gradient for {n}")
        same = [k for k, v in model.state_dict().items()
                if torch.equal(v, before[k])]
        if same:
            raise AssertionError(f"{what}: {len(same)} parameters or running "
                                 f"statistics did not change: {same[:5]}")
        if cuda:
            for n, c in want.items():
                if per_step.get(n, 0) != c:
                    raise AssertionError(
                        f"{what}: kernel {n}: {per_step.get(n, 0)} launches "
                        f"per step, expected {c}")
            profile_step(lambda: trainer.train_step(batch, gen),
                         f"one {what} step")
    return launches


def run_training(cfg, kernels, x_init, part, dev):
    """Diffusion training at full width; returns the kernels' launches over
    the timed steps."""
    import torch
    from lidiff_tpu_torch.models import diffusion
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    task = diffusion.DiffusionTask(cfg, device=dev,
                                   compute_dtype=torch.bfloat16, seed=0)
    overflow = []

    def describe(m):
        overflow.append(int(m["overflow_vox"]))
        return f"loss {float(m['loss']):.4f}, overflow {overflow[-1]}"

    log(f"training: {N_PART * TILE} points, batch 1, bf16 compute with "
        "float32 activations, lr 1e-4")
    launches = train_steps(
        task, cfg, {"pcd_full": x_init, "pcd_part": part},
        torch.Generator(device=dev).manual_seed(3), kernels, dev, "training",
        "loss", {"A3": CONVS_PER_STEP, "A2": CONVS_PER_STEP - 2,
                 "A1": 2 * CONVS_PER_STEP - 2, "C1": 5, "C1 index": 1},
        describe)
    if any(overflow):
        raise AssertionError("capacity overflow on the training input")
    return launches


# ---------------------------------------------------------------------------
# the refiner: kernel C2, the chamfer loss, RefineTask
# ---------------------------------------------------------------------------

def jittered(points, seed: int):
    """points + N(0, 0.2) noise clipped at 0.3, the refine dataset's input
    (lidiff_tpu_torch/data/kitti.py)."""
    import numpy as np
    noise = np.random.default_rng(seed).normal(0, 0.2, points.shape)
    return (points + np.clip(noise, -0.3, 0.3)).astype(np.float32)


def batched_match_inputs(dev, n_q: int = 100_000, n_r: int = 40_000):
    """Two items of n_q query and n_r reference points, a tenth of each
    invalid, quantized and sorted as the grid chamfer does: about 200k x
    80k, so that the batch compare and the pruning across items run."""
    import numpy as np
    import torch
    from lidiff_tpu_torch.ops import chamfer
    rng = np.random.default_rng(21)
    x = np.concatenate([jittered(ring_scan(n_q, seed=s), s) for s in (22, 23)])
    y = np.concatenate([ring_scan(n_r, seed=s) for s in (24, 25)])
    xf = torch.from_numpy(x).reshape(-1, 3).to(dev)
    yf = torch.from_numpy(y).reshape(-1, 3).to(dev)
    mx = torch.from_numpy(rng.random(2 * n_q) < 0.9).to(dev)
    my = torch.from_numpy(rng.random(2 * n_r) < 0.9).to(dev)
    res = chamfer._adaptive_res([(xf, mx), (yf, my)])
    q, qm, _ = chamfer.grid_sort(xf, mx, res, 2)
    r, rm, _ = chamfer.grid_sort(yf, my, res, 2)
    return q, qm, r, rm


def check_c2_case(knn, label, q, qm, r, rm, n_batch, c1_iters: int = 10):
    """Kernel C2 and its window-bound kernel on one (queries, refs) pair:
    C2 against C1 on every valid query; against `nn_match_pruned_plain`
    (same intervals) and `nn_match_plain` (all refs) on C2_SUBSET_TILES
    whole query tiles; the bound kernel against `window_bound_plain` on
    every tile. All exact. Then the times of the prolog, the kernel and C1,
    what the intervals keep, and the bound for the pairs inside them."""
    import torch
    import torch.nn.functional as F
    T = knn.QTILE
    Vq, Vr = q.shape[0], r.shape[0]
    dev = q.device
    nt = -(-Vq // T)
    start, cnt = knn.prune_intervals(q, qm, r, rm, n_batch)
    idx = knn.nn_match_intervals(q, r, rm, start, cnt, n_batch)
    c1 = knn.nn_match(q, r, rm, n_batch)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    if not torch.equal(idx[qm], c1[qm]):
        raise AssertionError(f"C2 ({label}) differs from C1 on "
                             f"{int((idx != c1)[qm].sum())} valid queries")
    if Vr < knn.UWND_MIN or -(-Vr // knn.RBLK) < 3:
        raise AssertionError(f"C2 ({label}): too few refs for the pruning "
                             "this check is about")
    window = knn.window_rows(Vr)
    win = knn.window_starts(q, r, window)
    u2 = knn.window_bound(q, qm, r, rm, win, window, n_batch)
    u2_plain = knn.window_bound_plain(q, qm, r, rm, win, window,
                                      n_batch != 1)
    if not torch.equal(u2, u2_plain):
        raise AssertionError(f"the window bound ({label}) differs from its "
                             f"plain version on {int((u2 != u2_plain).sum())}"
                             " tiles")
    # whole tiles, drawn with a fixed seed (not the ragged last one)
    full_tiles = Vq // T
    tiles = torch.randperm(full_tiles, generator=torch.Generator()
                           .manual_seed(17))[:C2_SUBSET_TILES].sort().values
    tiles = tiles.to(dev)
    rows = (tiles[:, None] * T + torch.arange(T, device=dev)).reshape(-1)
    q_sub, qm_sub, got = q[rows], qm[rows], idx[rows]

    def pruned_plain():
        return knn.nn_match_pruned_plain(
            q_sub, qm_sub, r, rm, n_batch, intervals=(start[tiles],
                                                      cnt[tiles]))
    plain = pruned_plain()
    scan_all = knn.nn_match_plain(q_sub, r, rm,
                                  block=max(64, PLAIN_PAIRS // Vr))
    for name, ref in (("its plain version", plain),
                      ("the plain scan of every ref", scan_all)):
        if not torch.equal(got[qm_sub], ref[qm_sub]):
            raise AssertionError(
                f"C2 ({label}) differs from {name} on "
                f"{int((got != ref)[qm_sub].sum())} of {int(qm_sub.sum())} "
                "valid queries")

    prolog_ms = _time_ms(lambda: knn.prune_intervals(q, qm, r, rm, n_batch), 5)
    ms = _time_ms(lambda: knn.nn_match_intervals(q, r, rm, start, cnt,
                                                 n_batch), 5)
    c1_ms = _time_ms(lambda: knn.nn_match(q, r, rm, n_batch), c1_iters)
    bound_kernel_ms = _time_ms(lambda: knn.window_bound(q, qm, r, rm, win,
                                                        window, n_batch))
    plain_ms = _time_ms(pruned_plain, 1)
    bound_plain_ms = _time_ms(lambda: knn.window_bound_plain(
        q, qm, r, rm, win, window, n_batch != 1), 1)

    # valid (query, ref) pairs inside the intervals, and in all
    q_valid = F.pad(qm, (0, nt * T - Vq)).reshape(nt, T).sum(1)
    r_before = F.pad(rm.long().cumsum(0), (1, 0))
    r_valid = r_before[(start + cnt).long()] - r_before[start.long()]
    pairs = float((q_valid * r_valid).sum())
    all_pairs = float(qm.sum()) * float(rm.sum())
    kept = float(cnt.sum()) / (nt * Vr)
    # per pair: 3 multiply-adds, a subtract, a compare, as C1's bound
    bound, by = _bound_ms(pairs * 8, PEAK_F32,
                          Vq * (16 + 4) + Vr * 17 + nt * 8)
    w_valid = r_before[(win + window).long()] - r_before[win.long()]
    w_bound, w_by = _bound_ms(float((q_valid * w_valid).sum()) * 8, PEAK_F32,
                              Vq * 17 + Vr * 17 + nt * 8)
    log(f"C2 nn_match_pruned, {label}: {Vq} queries x {Vr} refs, exact "
        f"against C1 (all valid queries) and both plain versions "
        f"({rows.shape[0]} queries); prolog {prolog_ms:.4f} ms ({window}-row "
        f"window bound kernel {bound_kernel_ms:.4f} ms, its plain version "
        f"{bound_plain_ms:.2f} ms, bound {w_bound:.4f} ms ({w_by})), kernel "
        f"{ms:.4f} ms, C1 for the same call {c1_ms:.4f} ms; intervals keep "
        f"{100 * kept:.2f}% of the (tile, block) pairs, longest "
        f"{int(cnt.max())} of {Vr} rows; {pairs:.4g} valid pairs inside them "
        f"of {all_pairs:.4g}: bound {bound:.4f} ms ({by}), plain version on "
        f"the subset {plain_ms:.2f} ms")
    return dict(
        kept=kept,
        C2=dict(max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None, prolog_ms=prolog_ms, c1_ms=c1_ms,
                kept_share=kept, pairs=pairs, unpruned_pairs=all_pairs),
        C2w=dict(max_abs_err=0, ms=bound_kernel_ms, plain_ms=bound_plain_ms,
                 bound_ms=w_bound, bound_by=w_by, library_ms=None))


def check_chamfer(dev):
    """The chamfer loss on the card: grid against exact on clouds small
    enough for the exact path, the card against the CPU for both, finite
    gradients to both clouds; and the two ways to write the gather whose
    backward adds 1.08M rows into 360k, timed."""
    import torch
    from lidiff_tpu_torch.ops import chamfer
    x = torch.from_numpy(ring_scan(40_000, seed=11))
    y = torch.from_numpy(ring_scan(20_000, seed=12))
    loss = {}
    for method in ("exact", "grid"):
        for d in (dev, "cpu"):
            a = x.clone().to(d).requires_grad_(True)
            b = y.clone().to(d).requires_grad_(True)
            val = chamfer.chamfer_distance(a, b, method=method)
            val.backward()
            if not (bool(torch.isfinite(a.grad).all())
                    and bool(torch.isfinite(b.grad).all())
                    and float(a.grad.abs().sum()) > 0
                    and float(b.grad.abs().sum()) > 0):
                raise AssertionError(f"chamfer ({method}, {d}): no finite "
                                     "gradient to both clouds")
            loss[method, d] = float(val.detach())
        if not abs(loss[method, dev] - loss[method, "cpu"]) \
                <= CHAMFER_CPU_RTOL * loss[method, "cpu"]:
            raise AssertionError(f"chamfer ({method}): card "
                                 f"{loss[method, dev]} vs CPU "
                                 f"{loss[method, 'cpu']}")
    rel = abs(loss["grid", dev] - loss["exact", dev]) / loss["exact", dev]
    log(f"chamfer, 40000 x 20000 points, float32: exact {loss['exact', dev]:.6f}"
        f" (CPU {loss['exact', 'cpu']:.6f}), grid {loss['grid', dev]:.6f} "
        f"(CPU {loss['grid', 'cpu']:.6f}); grid against exact {rel:.2e} "
        "relative; gradients finite")
    if not rel <= CHAMFER_GRID_RTOL:
        raise AssertionError("the grid chamfer is off the exact one")
    if dev != "cuda":
        return
    # forward + backward of a [rows, 3] gather at the refiner's sizes
    gen = torch.Generator(device=dev).manual_seed(13)
    n_up, n_gt = N_PART * TILE * REFINE_UP, 2 * N_PART * TILE
    for rows, n_idx in ((n_gt, n_up), (n_up, n_gt)):
        pts = torch.randn(rows, 3, generator=gen, device=dev,
                          requires_grad=True)
        idx = torch.randint(0, rows, (n_idx,), generator=gen, device=dev)
        cot = torch.randn(n_idx, 3, generator=gen, device=dev)
        t_sel = _time_ms(lambda: torch.autograd.grad(
            pts.index_select(0, idx), pts, cot))
        t_adv = _time_ms(lambda: torch.autograd.grad(pts[idx], pts, cot))
        log(f"gather of {n_idx} rows from {rows}, forward + backward: "
            f"index_select {t_sel:.4f} ms, points[idx] {t_adv:.4f} ms")


def make_refine_cfg(num_points: int, cr: float, up_factor: int,
                    caps: dict) -> dict:
    return {"experiment": {"id": "chip-smoke-refine"},
            "data": {"resolution": 0.05, "num_points": num_points},
            "train": {"n_gpus": 1, "lr": 1e-4, "batch_size": 1,
                      "up_factor": up_factor},
            "model": {"out_dim": 96, "cr": cr},
            "tpu": dict(caps)}


@contextlib.contextmanager
def discrete_choices(tape: list, replay: bool, differ: dict):
    """Record (replay=False) or replay the discrete choices of a training
    step: the sign pattern at every ReLU and LeakyReLU, and the picks of
    every chamfer index pass. A replaying run takes the recorded choices in
    place of its own and counts in `differ` how many of its own differed.

    The refiner's loss is piecewise smooth in the weights, and at a random
    init a few voxels far from the target carry much of the gradient: one
    unit of such a voxel whose input lies within float32 rounding of zero,
    or one point that picks another neighbour, moves dozens of gradients by
    up to 6e-2 of their size. Two devices are compared on the same piece."""
    import torch
    import torch.nn.functional as F
    from lidiff_tpu_torch.ops import chamfer
    played = iter(tape)

    def choose(own, kind):
        if not replay:
            tape.append(own)
            return own
        rec = next(played).to(own.device)
        differ[kind] = differ.get(kind, 0) + int((own != rec).sum())
        differ[kind + " in all"] = differ.get(kind + " in all", 0) \
            + own.numel()
        return rec

    def relu(x, inplace=False):
        return torch.where(choose(x > 0, "signs"), x, 0.0)

    def leaky_relu(x, negative_slope=0.01, inplace=False):
        return torch.where(choose(x > 0, "signs"), x, negative_slope * x)

    def picks(fn):
        return lambda *a, **kw: choose(fn(*a, **kw), "picks")

    saved = (F.relu, F.leaky_relu, chamfer.nn_indices_grid,
             chamfer.nn_indices)
    F.relu, F.leaky_relu = relu, leaky_relu
    chamfer.nn_indices_grid = picks(saved[2])
    chamfer.nn_indices = picks(saved[3])
    try:
        yield
    finally:
        (F.relu, F.leaky_relu, chamfer.nn_indices_grid,
         chamfer.nn_indices) = saved


def check_small_refine_train(cfg_mod, dev):
    """A small f32 refiner training step on the card (kernels) against the
    same weights and batch on the CPU (plain versions), the CPU run taking
    the card run's discrete choices (`discrete_choices`): the loss and
    every parameter's gradient at the tolerances of the diffusion step, and
    the share of choices that the CPU would have made differently."""
    import numpy as np
    import torch
    from lidiff_tpu_torch.models import refine
    # 2 x 4000 distinct points, every level holds them all; the target is
    # the clean cloud and two more jittered copies (12,000 points an item:
    # enough pairs for the grid chamfer, so the step runs kernel C2)
    cfg = cfg_mod.finalize_config(make_refine_cfg(
        4000, 0.25, 2, {"full_capacities": [8192] * 5}))
    clean = np.concatenate([ring_scan(4000, seed=3), ring_scan(4000, seed=4)])
    noisy = jittered(clean, 5)
    gt = np.concatenate([clean, jittered(clean, 6), jittered(clean, 7)], 1)
    out, tape, differ = {}, [], {}
    for d in (dev, "cpu"):
        task = refine.RefineTask(cfg, device=d, compute_dtype=torch.float32,
                                 seed=2)
        with discrete_choices(tape, bool(tape), differ):
            loss, _ = task.loss_fn(
                {"pcd_noise": torch.from_numpy(noisy).to(d),
                 "pcd_full": torch.from_numpy(gt).to(d)})
        loss.backward()
        out[d] = (float(loss.detach()), {n: p.grad.cpu() for n, p in
                                         task.model.named_parameters()})
    (l_card, g_card), (l_cpu, g_cpu) = out[dev], out["cpu"]
    top = max(float(g.abs().max()) for g in g_cpu.values())
    worst, worst_name = 0.0, ""
    for n, ref in g_cpu.items():
        err = float((g_card[n] - ref).abs().max())
        lim = TRAIN_GRAD_TOL * float(ref.abs().max()) + TRAIN_GRAD_ATOL * top
        if err / lim > worst:
            worst, worst_name = err / lim, n
    log(f"small f32 refiner training step, card vs CPU on the card's "
        f"discrete choices: loss {l_card:.6f} vs {l_cpu:.6f}; {len(g_cpu)} "
        f"gradients, worst at {worst:.3f} of its tolerance ({worst_name}), "
        f"max|grad| {top:.3g}; the CPU's own choices differ in {differ}")
    if not abs(l_card - l_cpu) <= TRAIN_LOSS_RTOL * abs(l_cpu):
        raise AssertionError("card and CPU disagree on the refiner's loss")
    if not (worst <= 1.0 and top > 0):
        raise AssertionError(f"card and CPU disagree on the refiner's "
                             f"gradient of {worst_name}")
    for kind in ("signs", "picks"):
        if not differ[kind] <= CHOICES_DIFFER * differ[kind + " in all"]:
            raise AssertionError(f"card and CPU disagree on {differ[kind]} "
                                 f"{kind} of the refiner's step")


def run_refine(cfg, kernels, dev):
    """The refiner at full width: `MinkUNet` with 18 output channels, 180k
    jittered points, 1.08M upsampled points against a 360k-point target.
    First C2 at that shape, both directions, on the clouds of this very
    step (the model's eval forward, quantized and sorted as
    `nn_indices_grid` does); then TRAIN_WARMUP + TRAIN_STEPS optimizer
    steps. Returns (C2's results, the kernels' launches over the timed
    steps)."""
    import torch
    from lidiff_tpu_torch import config as cfg_mod
    from lidiff_tpu_torch.models import refine
    from lidiff_tpu_torch.models.blocks import SparseConv
    from lidiff_tpu_torch.ops import chamfer, knn
    cuda = dev == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    n = N_PART * TILE
    # dense clouds without tiled duplicates, as the aggregated dataset
    # gives after its 0.1 m voxel-unique step (copies would make every
    # window bound zero and flatter the pruning); every level gets the full
    # point count, as the diffusion phases do: no voxel is dropped
    rcfg = cfg_mod.finalize_config(make_refine_cfg(
        n, cfg["model"]["cr"], REFINE_UP, {"capacity_fractions": [1.0] * 5}))
    task = refine.RefineTask(rcfg, device=dev, compute_dtype=torch.bfloat16,
                             seed=0)
    noisy = torch.from_numpy(jittered(ring_scan(n, seed=31), 32)).to(dev)
    gt = torch.from_numpy(ring_scan(2 * n, seed=33)).to(dev)
    pyr = task.pyramid(noisy)
    ovf = [int(v) for v in pyr.overflows()]
    log(f"refiner: capacities {rcfg['tpu']['full_capacities']}; voxels per "
        f"level {[int(l.geom.num) for l in pyr.levels]}; overflow {ovf}")
    if any(ovf):
        raise AssertionError("capacity overflow on the refiner's input")
    del pyr

    # ---- 8. C2 at the chamfer's shape ----
    up = task.upsample(noisy, task.forward(noisy)).reshape(-1, 3)
    res = chamfer._adaptive_res([(up, None), (gt[0], None)])
    xs, xm, _ = chamfer.grid_sort(up, None, res, 1)
    ys, ym, _ = chamfer.grid_sort(gt[0], None, res, 1)
    fwd = check_c2_case(knn, "chamfer, upsampled -> target", xs, xm, ys, ym,
                        1, c1_iters=2)
    back = check_c2_case(knn, "chamfer, target -> upsampled", ys, ym, xs, xm,
                         1, c1_iters=2)
    if cuda and (fwd["kept"] >= 1.0 or back["kept"] >= 1.0):
        raise AssertionError("the intervals prune nothing at the chamfer's "
                             "shape")
    c2 = {"C2": {**fwd["C2"], "ms_reverse": back["C2"]["ms"],
                 "prolog_ms_reverse": back["C2"]["prolog_ms"],
                 "c1_ms_reverse": back["C2"]["c1_ms"],
                 "kept_share_reverse": back["kept"]},
          "C2w": {**fwd["C2w"], "ms_reverse": back["C2w"]["ms"]}}
    del up, xs, xm, ys, ym, fwd, back

    # ---- 9. training steps ----
    def instrument(mark):
        """Marks where the model's forward ends (the chamfer begins) and
        around each index pass."""
        loss_chamfer, grid_idx = refine.chamfer_distance, \
            chamfer.nn_indices_grid

        def timed_chamfer(*a, **kw):
            mark("chamfer")
            return loss_chamfer(*a, **kw)

        def timed_idx(*a, **kw):
            mark("idx_s")
            out = grid_idx(*a, **kw)
            mark("idx_e")
            return out

        refine.chamfer_distance = timed_chamfer
        chamfer.nn_indices_grid = timed_idx

        def undo():
            refine.chamfer_distance = loss_chamfer
            chamfer.nn_indices_grid = grid_idx

        def split(step, elapsed):
            at = dict(step)
            idx = sum(elapsed(a[1], b[1]) for a, b in zip(
                [m for m in step if m[0] == "idx_s"],
                [m for m in step if m[0] == "idx_e"]))
            model = elapsed(at["start"], at["chamfer"])
            loss = elapsed(at["chamfer"], at["forward"])
            return (f": model {model:.1f}, chamfer index passes {idx:.1f}, "
                    f"rest of the chamfer {loss - idx:.1f}")
        return undo, split

    convs = sum(1 for m in task.model.modules()
                if isinstance(m, SparseConv) and m.kernel.shape[0] == 27)
    log(f"refiner training: {n} points -> {n * REFINE_UP} upsampled against "
        f"a {2 * n}-point target, batch 1, bf16 compute with float32 "
        f"activations, lr 1e-4; {convs} column convs")
    # every column conv but the first (its input needs no gradient) has a
    # feats gradient; one pyramid of 5 levels; one match per direction
    launches = train_steps(
        task, rcfg, {"pcd_noise": noisy, "pcd_full": gt}, None, kernels, dev,
        "refiner training", "cd_loss",
        {"A3": convs, "A2": convs - 1, "A1": 2 * convs - 1, "B1": 5, "C2": 2,
         "C2w": 2, "C1": 0},
        lambda m: f"cd_loss {float(m['cd_loss']):.4f}", instrument)
    return c2, launches


def run_refine_cli(dev: str, tmp: str) -> None:
    """`lidiff_tpu_torch.train_refine` on the small synthetic KITTI tree
    `tmp`: the sanity validation, two steps, a resume that takes a third,
    `--test`."""
    from lidiff_tpu_torch import train_refine
    cfg = {
        "experiment": {"id": "chip-smoke-refine-cli"},
        "data": {"resolution": 0.05, "dataloader": "KITTI", "split": "train",
                 "train": ["00"], "validation": ["00"], "test": [],
                 "scan_window": 2, "num_points": 600},
        "train": {"n_gpus": 1, "num_workers": 1, "max_epoch": 2, "lr": 1e-4,
                  "batch_size": 1, "up_factor": 2},
        "model": {"out_dim": 96, "cr": 0.5},
        "tpu": {"full_capacities": [768, 512, 384, 256, 256]},
    }
    cwd = os.getcwd()
    cfg["data"]["data_dir"] = tmp
    cfg_path = os.path.join(tmp, "cfg_refine.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    argv = ["-c", cfg_path] + (["--device", "cpu"] if dev == "cpu" else [])
    exp = os.path.join(tmp, "experiments", "chip-smoke-refine-cli")
    ckpts = os.path.join(exp, "checkpoints")
    said = io.StringIO()
    os.chdir(tmp)                     # the CLI writes ./experiments/<id>
    try:
        with contextlib.redirect_stdout(said):
            # 4 scans, window 2: two windows, two steps an epoch
            train_refine.main(argv + ["--max_steps", "2"])
            first = sorted(os.listdir(ckpts))
            train_refine.main(argv + ["-ckpt", exp, "--max_steps", "3"])
            second = sorted(os.listdir(ckpts))
            train_refine.main(argv + ["-w", exp, "--test"])
    finally:
        os.chdir(cwd)
    lines = said.getvalue().splitlines()
    sanity = [l for l in lines if l.startswith("sanity: cd_loss")]
    mean = [l for l in lines if l.startswith("mean test cd_loss")]
    log(f"train_refine CLI: {sanity[:1]}, checkpoints after 2 steps {first}, "
        f"after the resume {second}, {mean[:1]}")
    if len(sanity) != 2 or not all(math.isfinite(float(l.split()[2]))
                                   for l in sanity):
        raise AssertionError("the train_refine CLI printed no finite sanity "
                             "validation loss")
    if "step_00000002.pt" not in first or "hparams.json" not in first \
            or "step_00000003.pt" not in second:
        raise AssertionError("the train_refine CLI did not checkpoint step 2 "
                             "and resume to step 3")
    if len(mean) != 1 or not math.isfinite(float(mean[0].split()[-1])):
        raise AssertionError("train_refine --test printed no finite mean")


def make_kitti_tree(root: str, seq: str = "00", n_scans: int = 4,
                    n_points: int = 2000, seed: int = 0) -> None:
    """A synthetic mini SemanticKITTI sequence under
    root/dataset/sequences/<seq>: velodyne scans, labels, calib.txt,
    poses.txt and map_clean.npy."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sdir = os.path.join(root, "dataset", "sequences", seq)
    os.makedirs(os.path.join(sdir, "velodyne"))
    os.makedirs(os.path.join(sdir, "labels"))
    with open(os.path.join(sdir, "calib.txt"), "w") as f:
        for key in ["P0", "P1", "P2", "P3", "Tr"]:
            f.write(f"{key}: 1 0 0 0 0 1 0 0 0 0 1 0\n")
    with open(os.path.join(sdir, "poses.txt"), "w") as f:
        for i in range(n_scans):            # forward motion along x
            f.write(f"1 0 0 {i * 2.0} 0 1 0 0 0 0 1 0\n")
    world = []
    for i in range(n_scans):
        az = rng.uniform(0, 2 * np.pi, n_points)
        r = rng.uniform(4.0, 45.0, n_points)
        z = rng.uniform(-1.8, 2.0, n_points)
        pts = np.stack([r * np.cos(az), r * np.sin(az), z],
                       -1).astype(np.float32)
        np.concatenate([pts, np.ones((n_points, 1), np.float32)], 1).tofile(
            os.path.join(sdir, "velodyne", f"{i:06d}.bin"))
        labels = rng.choice([40, 50, 70, 10], n_points).astype(np.uint32)
        labels[: n_points // 20] = 252                  # moving
        labels[n_points // 20: n_points // 10] = 0      # outliers
        labels.tofile(os.path.join(sdir, "labels", f"{i:06d}.label"))
        keep = (labels < 252) & (labels > 1)
        p = pts[keep]
        p = p[np.linalg.norm(p, axis=-1) > 3.5]
        world.append(p + np.array([i * 2.0, 0, 0], np.float32))
    np.save(os.path.join(sdir, "map_clean.npy"),
            np.concatenate(world, 0).astype(np.float32))


def run_cli(dev: str, tmp: str) -> None:
    """`lidiff_tpu_torch.train` on the small synthetic KITTI tree `tmp`:
    two steps, then a resume from the experiment directory that takes a
    third, then `--test` on its checkpoint."""
    from lidiff_tpu_torch import train
    cfg = {
        "experiment": {"id": "chip-smoke-cli"},
        "data": {"resolution": 0.05, "dataloader": "KITTI", "split": "train",
                 "train": ["00"], "validation": ["00"], "test": [],
                 "num_points": 600, "max_range": 50.0,
                 "dataset_norm": False, "std_axis_norm": False},
        "train": {"uncond_prob": 0.1, "uncond_w": 6.0, "n_gpus": 1,
                  "num_workers": 1, "max_epoch": 2, "lr": 1e-4,
                  "batch_size": 1},
        "diff": {"beta_start": 3.5e-5, "beta_end": 0.007,
                 "beta_func": "linear", "t_steps": 100, "s_steps": 2,
                 "reg_weight": 5.0},
        "model": {"out_dim": 96, "cr": 0.5},
        "tpu": {"full_capacities": [768, 512, 384, 256, 256],
                "part_capacities": [128] * 5},
    }
    cwd = os.getcwd()
    cfg["data"]["data_dir"] = tmp
    cfg_path = os.path.join(tmp, "cfg_diff.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    argv = ["-c", cfg_path] + (["--device", "cpu"] if dev == "cpu" else [])
    exp = os.path.join(tmp, "experiments", "chip-smoke-cli")
    ckpts = os.path.join(exp, "checkpoints")
    said = io.StringIO()
    os.chdir(tmp)                     # the CLI writes ./experiments/<id>
    try:
        train.main(argv + ["--max_steps", "2"])
        first = sorted(os.listdir(ckpts))
        train.main(argv + ["-ckpt", exp, "--max_steps", "3"])
        second = sorted(os.listdir(ckpts))
        with contextlib.redirect_stdout(said):
            train.main(argv + ["-w", exp, "--test"])
    finally:
        os.chdir(cwd)
    gen_dir = os.path.join(exp, "generated_pcd", "00")
    plys = sorted(os.listdir(gen_dir)) if os.path.isdir(gen_dir) else []
    scores = [l for l in said.getvalue().splitlines() if " CD " in l]
    log(f"train CLI: checkpoints after 2 steps {first}, after the resume "
        f"{second}; --test wrote {len(plys)} .ply files, {scores[-1:]}")
    if "step_00000002.pt" not in first or "hparams.json" not in first \
            or "step_00000003.pt" not in second:
        raise AssertionError("the train CLI did not checkpoint step 2 and "
                             "resume to step 3")
    if not plys or len(plys) != said.getvalue().count("Saving "):
        raise AssertionError("train --test wrote no .ply per scan")


# ---------------------------------------------------------------------------
# the completion pipeline and its evaluation
# ---------------------------------------------------------------------------

def run_pipeline(cfg, kernels, steps: int, dev):
    """`DiffCompletion.complete_scan` at full width: random-init diffusion
    and refiner checkpoints saved as the trainers save them, a PIPE_SCAN-
    point synthetic ring scan as .bin; bf16, then int8 on the bf16 run's
    crop and FPS (the same scan's). Host time of each stage (crop and FPS,
    encoder and sampling, postprocess, refine; the bf16 run's .ply files
    with normals), launches, refined = diff x up_factor; then the
    metrics of `eval_path` against a synthetic ground truth, each with its
    host time. Returns the int8 run's launches."""
    import numpy as np
    import torch
    from lidiff_tpu_torch import config as cfg_mod
    from lidiff_tpu_torch.models import diffusion, refine
    from lidiff_tpu_torch.tools import diff_completion_pipeline as pipe
    from lidiff_tpu_torch.training.trainer import CheckpointManager
    from lidiff_tpu_torch.utils import histogram_metrics, metrics
    n = N_PART * TILE
    dcfg = dict(cfg, tpu=dict(cfg["tpu"], compute_dtype="bfloat16"))
    rcfg = cfg_mod.finalize_config(make_refine_cfg(
        n, cfg["model"]["cr"], REFINE_UP,
        {"capacity_fractions": [1.0] * 5, "compute_dtype": "bfloat16"}))
    gt = ring_scan(2 * n, seed=42)[0]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        exps = {}
        for name, task in (
                ("diff_net", diffusion.DiffusionTask(dcfg, device=dev)),
                ("refine_net", refine.RefineTask(rcfg, device=dev))):
            exps[name] = os.path.join(tmp, name)
            CheckpointManager(os.path.join(exps[name], "checkpoints")).save(
                0, {"model": task.model.state_dict(), "step": 0},
                hparams=task.cfg)
            del task
        scan = ring_scan(PIPE_SCAN, seed=41)[0]
        bin_path = os.path.join(tmp, "000000.bin")
        np.concatenate([scan, np.ones((len(scan), 1), np.float32)],
                       1).tofile(bin_path)
        x_init = {}
        for quant in (False, True):
            what = "int8" if quant else "bf16"
            dc = pipe.DiffCompletion(exps["diff_net"], exps["refine_net"],
                                     steps, 6.0, device=dev,
                                     conv_quant=quant)
            points = pipe.load_pcd(bin_path)
            refine_counts = {}
            refine_fn, preprocess_fn = dc.refine, dc.preprocess_scan
            if quant:
                # the host's crop and FPS are the bf16 run's: the same
                # scan gives the same x_init
                dc.preprocess_scan = lambda s: x_init["bf16"].copy()
            else:
                dc.preprocess_scan = lambda s: x_init.setdefault(
                    "bf16", preprocess_fn(s))

            def counted(p):
                before = {k: v.launches for k, v in kernels.items()}
                r = refine_fn(p)
                refine_counts.update({k: v.launches - before[k]
                                      for k, v in kernels.items()})
                return r
            dc.refine = counted
            for k in kernels.values():
                k.launches = 0
            t0 = time.perf_counter()
            refined, diff = dc.complete_scan(points)
            total = time.perf_counter() - t0
            launches = {k: v.launches for k, v in kernels.items()}
            st = dc.times
            crop, written = "crop + FPS reused from the bf16 run", ""
            if not quant:
                t0 = time.perf_counter()
                out_dir = os.path.join(tmp, "out")
                for sub in ("refine", "diff"):
                    os.makedirs(os.path.join(out_dir, sub))
                pipe.write_outputs(out_dir, "000000.bin", refined, diff)
                crop = f"crop + FPS {st['preprocess']:.3f} s"
                written = (".ply files with normals "
                           f"{time.perf_counter() - t0:.3f} s; ")
            log(f"pipeline {what}, {len(points)}-point scan, {steps} steps: "
                f"{total:.3f} s = {crop}, encoder + sampling "
                f"{st['sample']:.3f} s, postprocess {st['postprocess']:.3f} "
                f"s, refine {st['refine']:.3f} s; {written}{len(diff)} diff "
                f"points -> {len(refined)} refined; launches {launches}, of "
                f"them in refine {refine_counts}")
            if not (0 < len(diff) <= n
                    and len(refined) == REFINE_UP * len(diff)
                    and np.isfinite(refined).all()):
                raise AssertionError(f"pipeline {what}: refined count or "
                                     "values wrong")
            if dev == "cuda" and quant and not (
                    refine_counts["A4"] > 0 and refine_counts["B1"] == 5):
                raise AssertionError("pipeline int8: the refiner did not "
                                     "run A4 and B1")
            out[what] = (refined, launches)
            del dc
    pred = out["int8"][0]
    times, vals = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        vals[name] = fn()
        times[name] = time.perf_counter() - t0

    cd, rmse, iou = metrics.ChamferDistance(), metrics.RMSE(), \
        metrics.CompletionIoU()
    pr = metrics.PrecisionRecall(0.05, 0.10, 100)
    timed("CD", lambda: (cd.update(gt, pred), cd.compute()[0])[1])
    timed("RMSE", lambda: (rmse.update(gt, pred), rmse.compute()[0])[1])
    timed("PR-AUC F1", lambda: (pr.update(gt, pred), pr.compute_auc()[2])[1])
    timed("IoU 0.5/0.2/0.1", lambda: (iou.update(gt, pred),
                                      tuple(iou.compute().values()))[1])
    timed("JSD 3D", lambda: histogram_metrics.compute_hist_metrics(
        gt, pred, bev=False))
    timed("JSD BEV", lambda: histogram_metrics.compute_hist_metrics(
        gt, pred, bev=True))
    log("pipeline metrics, int8 refined cloud against a "
        f"{len(gt)}-point synthetic ground truth (host seconds): "
        + "; ".join(f"{k} {vals[k]} ({times[k]:.3f} s)" for k in vals))
    flat = [x for v in vals.values()
            for x in (v if isinstance(v, tuple) else (v,))]
    if not all(math.isfinite(x) for x in flat):
        raise AssertionError("pipeline metrics are not finite")
    return out["int8"][1]


def run_eval_clis(dev: str, tree: str, kernels) -> None:
    """The evaluation CLIs on the small tree `tree`, after the train and
    train_refine CLI phases: `map_from_scans`, the pipeline on both
    trained checkpoints with LIDIFF_CONV_QUANT=int8, and `eval_path` on its
    .ply files (-p) and live (-d, -r)."""
    import numpy as np
    from lidiff_tpu_torch.tools import diff_completion_pipeline as pipe
    from lidiff_tpu_torch.tools import eval_path, map_from_scans
    dev_args = ["--device", "cpu"] if dev == "cpu" else []
    seqs = os.path.join(tree, "dataset", "sequences")
    seq_dir = os.path.join(seqs, "00")
    diff_exp = os.path.join(tree, "experiments", "chip-smoke-cli")
    refine_exp = os.path.join(tree, "experiments", "chip-smoke-refine-cli")
    out = os.path.join(tree, "results")
    said = io.StringIO()
    cwd = os.getcwd()
    os.remove(os.path.join(seq_dir, "map_clean.npy"))
    os.chdir(tree)                    # eval_path -d writes ./res_log.yaml
    os.environ["LIDIFF_CONV_QUANT"] = "int8"
    try:
        with contextlib.redirect_stdout(said):
            map_from_scans.main(["-p", seqs, "-s", "00"])
            for k in kernels.values():
                k.launches = 0
            pipe.main(["-d", diff_exp, "-r", refine_exp, "-T", "2", "-s",
                       "6.0", "-p", os.path.join(seq_dir, "velodyne"), "-o",
                       out] + dev_args)
            a4 = kernels["A4"].launches
            saved = os.path.join(out, "chip-smoke-cli_T2_s6.0", "refine")
            res_p = eval_path.main(["-p", saved, "--data", seq_dir])
            res_d = eval_path.main(["-d", diff_exp, "-r", refine_exp, "-t",
                                    "2", "--data", seq_dir, "--max_scans",
                                    "2"] + dev_args)
    finally:
        del os.environ["LIDIFF_CONV_QUANT"]
        os.chdir(cwd)
    seq_map = np.load(os.path.join(seq_dir, "map_clean.npy"))
    n_ply = len([f for f in os.listdir(saved) if f.endswith(".ply")])
    log(f"eval CLIs: map_from_scans {len(seq_map)} points; pipeline CLI "
        f"(LIDIFF_CONV_QUANT=int8) {n_ply} refined .ply files, {a4} A4 "
        f"launches; eval_path -p {json.dumps(res_p)}; eval_path -d -r "
        f"{json.dumps(res_d)}")
    for res in (res_p, res_d):
        vals = [v for k, v in res.items() if k != "ious"] + list(
            res["ious"].values())
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError("eval_path wrote a value that is not finite")
    if not (len(seq_map) and n_ply == 4) or (dev == "cuda" and a4 == 0):
        raise AssertionError("map_from_scans or the int8 pipeline CLI did "
                             "not run")
    with open(os.path.join(saved, "res_log.yaml")) as f:
        if json.load(f) != res_p:
            raise AssertionError("eval_path -p wrote another res_log.yaml")


_CATEGORIES = (("A3 conv3_columns_dw", ("conv3_columns_dw",)),
               ("A1 conv3_columns", ("conv3_columns",)),
               ("B1 kmap3_columns", ("kmap3_columns",)),
               ("C2 nn_match_pruned", ("nn_match_pruned",
                                       "nn_window_bound")),
               ("C1 nn_match", ("nn_match",)),
               ("GEMM (cuBLAS)", ("gemm", "xmma", "cutlass", "cublas",
                                  "nvjet")),
               ("optimizer (Adam)", ("multi_tensor",)),
               ("sort", ("sort", "radix")),
               ("scatter/gather/index", ("index", "scatter", "gather")),
               ("copy/cast/concat", ("copy",)))


def _category(kernel_name: str) -> str:
    low = kernel_name.lower()
    # A4 runs A1's tile kernels on int8 (`signed char`) feats
    if "conv3_columns" in low and "kernel<signed char" in low:
        return "A4 conv3_columns_q"
    return next((c for c, keys in _CATEGORIES
                 if any(k in low for k in keys)), "other")


def profile_step(step, label: str) -> None:
    """Device time by kernel over one call of `step` (torch.profiler), and
    the device's busy share of the call's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        step()
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
        cat = _category(name)
        cats[cat] = cats.get(cat, 0.0) + us
    log(f"profile of {label}: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%)")
    for cat, us in sorted(cats.items(), key=lambda kv: -kv[1]):
        log(f"  {cat:22s} {us / 1e3:9.2f} ms  {100 * us / busy:5.1f}%")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"    {us / 1e3:8.2f} ms  {name[:110]}")


def log_ptxas(name: str, report: str) -> None:
    """The ptxas lines of one library: each kernel's registers, shared
    memory and spills under its (mangled) name, and any warning about
    wgmma (serialized instructions lose the overlap)."""
    entry = ""
    for line in report.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "registers" in line or "spill" in line:
            log(f"  ptxas {name} {entry}: {line.split('ptxas info    :')[-1]}")
        elif "wgmma" in line or "arning" in line:
            log(f"  ptxas {name}: {line}")


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
        log_ptxas(name, rep)

    res, paths = run(args.steps)
    # kernel: (source, TPU kernel it replaces, the path its count is from)
    sources = {
        "A1": ("conv3_columns", "lidiff_tpu/ops/pallas_conv.py:840",
               "sampling"),
        "B1": ("kmap3_columns", "lidiff_tpu/ops/pallas_kmap.py:120",
               "sampling"),
        "C1": ("nn_match", "lidiff_tpu/ops/pallas_knn.py:289", "sampling"),
        "A2": ("conv3_columns", "lidiff_tpu/ops/pallas_conv.py:667",
               "training"),
        "A3": ("conv3_columns_dw", "lidiff_tpu/ops/pallas_conv.py:568",
               "training"),
        "C2": ("nn_match_pruned", "lidiff_tpu/ops/pallas_knn.py:403",
               "refiner training"),
        # the prolog's distance bound: XLA code in the JAX package, a
        # kernel of the same source here
        "C2w": ("nn_match_pruned", "lidiff_tpu/ops/pallas_knn.py:198",
                "refiner training"),
        "A4": ("conv3_columns_q",
               "lidiff_tpu/ops/pallas_conv.py:840 (quant=True)",
               "int8 sampling")}
    for path, names in (
            ("sampling", ("A1", "B1", "C1")),
            ("int8 sampling", ("A1", "A4", "B1", "C1")),
            ("training", ("A1", "A2", "A3", "B1", "C1")),
            ("refiner training", ("A1", "A2", "A3", "B1", "C2", "C2w")),
            ("pipeline", ("A4", "B1", "C1"))):
        for n in names:
            if paths[path][n] == 0:
                raise AssertionError(f"kernel {n} was not launched on the "
                                     f"{path} path")
    line = {"kernels": [
        {"name": f"{n} {NAMES.get(n, src)}", "route": "cuda",
         "source": f"lidiff_tpu_torch/csrc/{src}.cu", "replaces": rep,
         "launches": paths[path][n], **res[n]}
        for n, (src, rep, path) in sources.items()]}
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
