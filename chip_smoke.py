#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`lidiff_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--steps S] [--phase NAME]

From the root of a checkout, on a machine with one CUDA card (Hopper: the
kernels are built for sm_90a), it builds the hand-written kernels from
`lidiff_tpu_torch/csrc/` with nvcc (printing ptxas's registers, shared
memory and spills per kernel), then runs its phases in this order;
`--phase NAME` builds the kernels and runs that phase alone. It holds each
kernel against its plain PyTorch version at the main paths' shapes and
times both (the times that PERF.md's kernel table reads), and runs the
main paths with their checks: launches, finiteness, parameters moved,
remat, CPU parity, no capacity overflow, collectives, the CLIs. It times
no whole path: the benchmark (`benchmark/run.py`) does, and a path's
profile is taken with `lidiff_tpu_torch.utils.prof.trace` (README
"Tracing").

  kernels   on the sampling path's inputs (a 180k-point synthetic ring scan
            at res 0.05, cr=1, out_dim 96, no capacity overflow): B1 with
            its plan key at all five levels, the tile plan from that key
            against the tensor-op plan on the t ~ T and t ~ 0 pyramids; C1
            at all five levels against both conditioning banks over each
            bank's index (the index's build time, the rows examined per
            query); A1 at every width of the path, G in {1, 2}, float32 and
            bf16; A4 (the int8 eval conv) at every width with Cin >= 32,
            its prologue against the Pallas formula, integer feats against
            A1; C2 at the sampling shapes; A3 (the weight gradient, over
            the map's tile plan in bf16) and A2 (the feats gradient through
            autograd); the gather-form kernel-map API (`build_kernel_map`
            against B1's map, `down_kmap_from_pooling`, the 27-tap gather
            conv against A1, the 8-tap gather down conv);
  tg        TG, the transpose conv's parent-row gather, forward and
            backward, bit for bit at the refiner's four up-stage shapes at
            batch 8, beside the plain backward's `indexing_backward_kernel`;
  bn        training-mode BatchNorm with its ReLU (kernels masked_bn_*) at
            the refiner's shapes at batch 8 against the eager version: the
            output bit for bit given the kernels' moments and between two
            calls, the moments and gradients within BN_F32_TOL;
  gate      GA, the eval gate's apply step (`ops/gate.py` `gate_apply`),
            bit for bit against `gate_apply_plain` and timed at the
            `diff.complete` cell's eight gate shapes; then one guided
            denoise on the sampling inputs through the gate tables against
            per-voxel gates (float32 and bf16, deterministic algorithms),
            with GA's launches and the table and gated rows;
  fps       F1 (farthest-point sampling) against `fps_plain` index for
            index in eleven cases and against the host C++ copy at 18k of
            120k;
  parity    small float32 runs on the card against the CPU: a guided
            denoise (float32 and int8 convs), a diffusion training step, a
            refiner training step on the card's discrete choices
            (`discrete_choices`), the chamfer loss (exact and grid);
  sampling  one classifier-free completion through `DiffusionTask.sample`
            (bf16, G=2 fused, w=6, S steps of the 1000-step linear
            schedule) with each kernel's launches counted; the same with
            `tpu.fuse_classfree: false` (launches, the nearest-neighbour
            distance to the fused cloud, the float32 unfused guided eps
            against the fused one) and with `conv_quant` (launches, no
            overflow);
  training  diffusion training at full width: remat on against off under
            deterministic algorithms (`compare_remat`), then optimizer
            steps through `Trainer.train_step` each way and at the
            config's batch of 2 (launches per step, finite loss and
            gradients, every parameter and running statistic moved, no
            overflow);
  ddp       a one-rank NCCL group (`parallel/mesh.py`): a small float32
            step against the plain step (collectives with remat and
            without), full-width steps with and without the group (host
            syncs and collectives per step);
  c2        C2 at the refiner's chamfer shapes (1.08M x 360k and back) on
            the clouds of its eval forward, and on a two-item batch with
            invalid rows: against C1, its plain version and the plain scan;
  refiner   the same remat comparison and steps on `RefineTask` (180k
            jittered points, up_factor 6, a 360k-point target), then at
            the config's batch of 8;
  pipeline  `DiffCompletion.complete_scan` on random-init checkpoints, bf16
            and int8 (launches, refined = diff x 6), the metrics of
            `eval_path`; `complete_scans` over two replicas on the one card
            against `complete_scan` with each replica's generator; the
            pipeline CLI's multi-card branch;
  clis      on one small synthetic KITTI tree: `train` (two steps, a resume
            to step 3, `--test`), `train_refine` (sanity validation, two
            steps, a resume, `--test`), `map_from_scans`, the pipeline CLI
            with LIDIFF_CONV_QUANT=int8 and with LIDIFF_COMPUTE_DTYPE,
            `eval_path` on its .ply files and live;
  ptv3      on the `ptv3.train` benchmark cell's first batch: kernel
            `serial_codes` against the bit loops; xCPE's convs at (256,
            256) L3 and (512, 512) L4 in bf16 (A1 with its bias, A2, A3 and
            the bias gradient through autograd); optimizer steps of
            `SegTask` with their launches.

Each main path's launches are checked: C1 10 a guided step, A1 once more
per stage conv and TG's forward once more per transpose conv with remat,
`masked_bn_apply` once per BatchNorm of a training forward and none in eval
mode, GA 8 a denoiser call (16 a guided step unfused) and none in
training. It prints one line per check, then a {"kernels": [...]} JSON line
(the kernels of the phases run), the card's name and power limit, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; so
does a run without a CUDA device or outside a checkout.
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

from benchmark.work import PEAK_BF16, PEAK_BYTES

ROOT = os.path.dirname(os.path.abspath(__file__))
N_PART = 18_000           # partial scan points; the cloud is N_PART x 10
TILE = 10
PEAK_F32 = 67e12          # H100 SXM float32 outside the tensor cores
SPIN_HZ = 2e9             # spin cycles a second: above the H100's clock, so a
                          # spin of n cycles lasts at least n / SPIN_HZ s
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
# the gather form (`sparse_conv` over a KernelMap): float32 checks against
# A1 at these (Cin, Cout, level), within A1_F32_TOL of max|ref|; the first
# is timed in bf16 at G=1 beside A1
GATHER_WIDTHS = [(384, 256, 3), (96, 96, 0)]
GATHER_DOWN = (32, 32)      # the first down conv (DownStage_0, cs[0] -> cs[0])
BF16_U = 2.0 ** -8          # bf16 unit roundoff
# TG (the transpose conv's parent-row gather) at the refiner's four up
# stages at batch 8: capacities 8 x the one-item table, valid voxels as
# many as the benchmark's aggregated windows reach at most. (stage, Vc,
# valid coarse rows, V_fine, valid fine rows, Cout); G = 1, y in bf16, the
# activations float32
TG_STAGES = (("UpStage_0", 576_512, 89_431, 1_152_000, 305_562, 256),
             ("UpStage_1", 1_152_000, 305_562, 1_440_768, 833_661, 128),
             ("UpStage_2", 1_440_768, 833_661, 1_440_768, 1_313_116, 96),
             ("UpStage_3", 1_440_768, 1_313_116, 1_440_768, 1_422_246, 96))
# training-mode BatchNorm (kernels masked_bn_*) at the refiner's shapes at
# batch 8: (level, capacity rows, valid rows as TG_STAGES has them, C)
BN_SHAPES = (("L0", 1_440_768, 1_422_246, 96), ("L3", 1_152_000, 305_562, 256),
             ("L4", 576_512, 89_431, 256))
BN_F32_TOL = 1e-4           # fused against eager float32 BatchNorm, x the
                            # largest |ref| (1 + it for the output): the same
                            # values summed in other orders
# GA (the eval gate's apply step) at the `diff.complete` cell's shapes:
# every level at capacity 180,096, the fused pair G = 2, one item, the
# cond bank's 16,256 L4 rows and the uncond bank's 8; (gate, C) in the
# order the denoiser runs them. The kernels line's GA row is gate_u1's.
GATE_V = 180_096
GATE_BANK = 16_256 + 8
GATE_SHAPES = (("gate_s1", 32), ("gate_s2", 32), ("gate_s3", 64),
               ("gate_s4", 128), ("gate_u1", 256), ("gate_u2", 256),
               ("gate_u3", 128), ("gate_u4", 96))
GATE_VALID = 0.9            # share of valid rows
GATE_EPS_F32_TOL = 1e-4     # the guided eps through the gate tables against
                            # per-voxel gates, x max|eps|: float32, the same
                            # products, the table's GEMMs over fewer rows
GATE_EPS_BF16_TOL = 2.0 ** -5   # the same in bf16, x max|eps|: a gate value
                            # rounded the other way moves the eps through
                            # about 40 bf16 layers and the guidance's 2w + 1
# PTv3's xCPE convs held and timed at the `ptv3.train` cell's widest
# shapes: (Cin, Cout, pyramid level); the last is the kernels line's
PTV3_WIDTHS = ((256, 256, 3), (512, 512, 4))
PTV3_BLOCKS = 22            # Blocks of PT-v3m1: an xCPE conv each
PTV3_DB_TOL = 1e-5          # bias gradient: float32 column sums over up to
                            # 76k rows against float64, x the sum of |cot|
# small float32 training step, card against CPU: sums in other orders over
# about 100 layers forward and backward, and BatchNorm over a few hundred
# voxels on the coarse levels divides by small variances
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 2e-3       # x that parameter's max|grad| ...
TRAIN_GRAD_ATOL = 1e-4      # ... plus this x the largest max|grad| of all
TRAIN_WARMUP = 1            # optimizer steps before the counted ones
TRAIN_STEPS = 2             # optimizer steps whose launches are counted
DENOISER_CONVS = 34         # column convs of one denoiser forward
CONVS_PER_STEP = DENOISER_CONVS + 18    # and the encoder's 18
REMAT_STATS_TOL = 1e-4      # BN running statistics, remat on vs off on the
                            # card, x (1 + |value|)
DIFF_BATCH = 2              # the configs' batch sizes (config.json,
REFINE_BATCH = 8            # config_refine.json)
PIPE_SCAN = 120_000         # points of the pipeline's synthetic scan, about
                            # a KITTI scan before the range crop and FPS
SMALL_DENOISE_TOL = 1e-3    # small f32 guided denoise (float32 or int8
                            # convs), card against CPU, x max(max|eps|, 1)
REFINE_UP = 6               # offsets per point: 180k points -> 1.08M
C2_SUBSET_TILES = 512       # whole query tiles (16,384 queries) held
                            # against the plain versions
PLAIN_PAIRS = 1 << 28       # (query, ref) pairs per block of nn_match_plain
CHAMFER_GRID_RTOL = 1e-3    # grid against exact loss, as tests/test_chamfer.py
CHAMFER_CPU_RTOL = 1e-5     # card against CPU: float32 sums in other orders
UNFUSED_EPS_TOL = 1e-4      # the unfused guided eps against the fused one,
                            # float32 on the card, x max|eps|: the same
                            # products, summed in another order where the
                            # card adds by atomics (the voxel features, the
                            # down convs' scatter) or cuBLAS picks another
                            # GEMM for the G=2 shapes; ulp-level noise
                            # through about 40 layers, scaled by 2w + 1 = 13
SCANS_NN_TOL = 1e-2         # complete_scans' replicas against complete_scan
SCANS_COUNT_TOL = 5e-3      # on the card: mean nearest-neighbour distance
                            # each way (m; a fifth of the 0.05 m voxel),
                            # relative point count: the voxel features are
                            # summed by atomics in another order each run,
                            # and a bf16 rounding may fall the other way.
                            # Sound runs gave at most 0.00088 m and the other
                            # replica's generator at least 0.387 m on an H100
                            # 80GB HBM3 at 700 W (PERF.md): the limit is 11x
                            # the one, 1/39 the other
# the warning of torch's CUDA sync debug mode at each host sync (its notice
# on being first switched on, "Synchronization debug mode is a prototype
# feature ...", is not one)
SYNC_WARNING = "called a synchronizing CUDA operation"
CHOICES_DIFFER = 1e-4       # share of ReLU signs, and of chamfer picks, that
                            # may fall the other way on the CPU: inputs
                            # within float32 rounding of zero, resp. points
                            # within it of a grid cell's edge


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
    from lidiff_tpu_torch.ops import (batchnorm, fps, gate, grid, knn,
                                      serialize, sparse_conv)
    return {"A1": sparse_conv._conv3_kernel,
            "A4": sparse_conv._conv3_q_kernel,
            "A2": sparse_conv.Conv3ColumnsFunction,
            "A3": sparse_conv._conv3_dw_kernel,
            "B1": grid._kmap3_kernel, "B1 taps": grid._taps_kernel,
            "C1": knn._nn_kernel,
            "C1 scan": Count(knn._nn_kernel, "scans"),
            "C1 index": Count(knn.NNIndex, "builds"),
            "C2": knn._tile_kernel, "F1": fps._fps_kernel,
            "TG": sparse_conv._gather_fwd_kernel,
            "TG bwd": sparse_conv._scatter_bwd_kernel,
            "SC": serialize._codes_kernel,
            "BN": batchnorm._apply_kernel, "BN bwd": batchnorm._dx_kernel,
            "GA": gate._apply_kernel}


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


def _device_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() over `iters` runs, queued behind a spin
    kernel that outlasts their issue on the host, so that the gaps in
    which the card waits for the host (a small kernel's launch costs more
    host time than its run) do not count. fn() must not make the host
    wait for the card."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    issue_s = time.perf_counter() - t0      # at least the issue time
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * issue_s + 1e-3) * SPIN_HZ))
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
    """B1 against its plain version on every level: col_idx, hit and the
    plan key bit-exact, the plan key also against the hit patterns. Times
    B1 at L0 beside its plain version and `torch.searchsorted` over the
    same 9 V column keys (col_idx only)."""
    import torch
    for li, lvl in enumerate(pyr.levels):
        g = lvl.geom
        got = grid.kmap3_columns(g.key, g.coords, g.mask, g.stride)
        want = grid.kmap3_columns_plain(g.key, g.coords, g.mask, g.stride)
        pattern = grid.hit_patterns(want[1], g.mask)
        if not all(torch.equal(a, b) for a, b in zip(got, want)) or \
                not torch.equal(got[2], torch.where(pattern == 0,
                                                    grid.NO_TAP, pattern)):
            raise AssertionError(f"B1 differs from its plain version at L{li}")
    g = pyr.levels[0].geom
    V = g.capacity
    ms = _device_ms(lambda: grid.kmap3_columns(g.key, g.coords, g.mask, 1))
    host_ms = _time_ms(lambda: grid.kmap3_columns(g.key, g.coords, g.mask,
                                                  1))
    plain_ms = _time_ms(lambda: grid.kmap3_columns_plain(g.key, g.coords,
                                                         g.mask, 1), 3)
    # the library call: the lower bounds of the same 9 V column keys
    # (col_idx; hit needs three more gathers)
    from lidiff_tpu_torch.ops import keys as K
    off = torch.tensor([[dx, dy, -1] for dx in (-1, 0, 1) for dy in (-1, 0, 1)],
                       dtype=torch.int32, device=g.key.device)
    q, _ = K.pack(g.coords[:, None, 0].expand(V, 9),
                  g.coords[:, None, 1:] + off[None])
    q = torch.where(g.mask[:, None], q, K.PAD_KEY).contiguous()
    lib_ms = _device_ms(lambda: torch.searchsorted(g.key, q))
    probes = math.ceil(math.log2(V)) + 3
    bound, by = _bound_ms(9 * V * probes, PEAK_F32,
                          V * (8 + 16 + 1 + 9 * 4 + 27 + 4))
    log(f"B1 kmap3_columns: 5 levels bit-exact, plan key = hit patterns; "
        f"L0 V={V}: {ms:.4f} ms on the card ({host_ms:.4f} ms paced by "
        f"the host), plain {plain_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({by}); torch.searchsorted over the 9 V column "
        f"keys (col_idx only) {lib_ms:.4f} ms")
    return dict(max_abs_err=0, ms=ms, host_paced_ms=host_ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms)


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


def _tensor_plan(grid, hit, mask):
    """The tile plan as tensor ops build it from the hits alone (hit
    patterns, a sort, the OR tree): the reference of B1's plan key and
    kmap3_tile_taps."""
    import torch
    pattern = grid.hit_patterns(hit, mask)
    key = torch.where(pattern == 0, grid.NO_TAP, pattern)
    order = torch.sort(key, stable=True).indices
    return order.to(torch.int32), grid.tile_taps(pattern[order])


def plan_stats(pyr, dev, what: str):
    """Per level of `pyr`: the tile plan from B1's plan key (`plan()`)
    against the tensor-op plan from the hits (order and tile taps equal),
    the times of B1, B1 with the plan and the tensor-op plan, and the
    computed tap products over hit taps (the redundancy) with 64-row tiles
    in key order and in plan order. Returns ({level: (hit taps, computed in
    key order, computed in plan order)}, {level: ms of B1 with the plan on
    the card})."""
    import torch
    from lidiff_tpu_torch.ops import grid
    stats, b1_plan = {}, {}
    for li, lvl in enumerate(pyr.levels):
        km, g = lvl.kmap3, lvl.geom
        plan = km.plan()
        order, taps = _tensor_plan(grid, km.hit, g.mask)
        if not (torch.equal(plan.order, order)
                and torch.equal(plan.tile_taps, taps)):
            raise AssertionError(f"the tile plan from B1's key differs from "
                                 f"the tensor-op plan ({what}, L{li})")
        if dev == "cuda":
            def b1_and_plan():
                key = grid.kmap3_columns(g.key, g.coords, g.mask, g.stride)[2]
                return grid.plan_from_keys(key)
            b1_ms = _device_ms(lambda: grid.kmap3_columns(
                g.key, g.coords, g.mask, g.stride))
            b1_plan[li] = _device_ms(b1_and_plan)
            old_ms = _device_ms(lambda: _tensor_plan(grid, km.hit, g.mask))
        else:
            b1_ms = b1_plan[li] = old_ms = float("nan")
        pattern = grid.hit_patterns(km.hit, g.mask)
        hits = int(km.hit.sum())
        before = _computed_taps(pattern)
        after = _computed_taps(pattern[plan.order.long()])
        zero = int((plan.tile_taps == 0).sum())
        stats[li] = (hits, before, after)
        log(f"tile plan {what} L{li}: V={g.capacity}, "
            f"{hits / max(int(g.mask.sum()), 1):.2f} hit taps/voxel; "
            f"computed/hit taps {before / max(hits, 1):.2f}x in key order, "
            f"{after / max(hits, 1):.2f}x in plan order; "
            f"{zero} of {plan.tile_taps.shape[0]} tiles with no tap; the "
            f"plan from B1's key equals the tensor-op plan; on the card B1 "
            f"{b1_ms:.4f} ms, B1 and the plan {b1_plan[li]:.4f} ms, the "
            f"tensor-op plan from the hits {old_ms:.4f} ms")
    return stats, b1_plan


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


def _kernel_ms(fn, key: str) -> float:
    """Device ms of the kernels whose names hold `key` in one call of fn(),
    by torch.profiler, after a warm-up call."""
    import torch
    from lidiff_tpu_torch.utils import prof
    fn()
    torch.cuda.synchronize()
    with prof.trace() as p:
        fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in p.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and key in e.name) / 1e3


def check_transpose_gather(dev):
    """TG, the transpose conv's parent-row gather (`sparse_conv.
    transpose_gather` on a CUDA tensor: `TransposeGatherFunction`), at
    TG_STAGES, on maps made as `grid.up_maps` makes them (each valid fine
    row its own (parent, tap) slot among the valid parents, in key order;
    the padding rows parent_idx == Vc, tap 0): the output and, through
    autograd, the bf16 gradient of y against `transpose_gather_plain` on
    the same tensors bit for bit. Times both ways beside the plain
    version, the bound by bytes (the forward: the ok rows of y, the output
    and the maps; the backward: dy, the ok rows' cotangents and the maps)
    and the plain backward's `indexing_backward_kernel`. Returns the
    kernels line's "TG" and "TG bwd", summed over the four stages."""
    import torch
    from lidiff_tpu_torch.ops import sparse_conv as sc
    gen = torch.Generator(device=dev).manual_seed(15)
    f32 = torch.float32
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    fwd, bwd = dict.fromkeys(keys, 0.0), dict.fromkeys(keys, 0.0)
    for stage, Vc, nc, Vf, nf, cout in TG_STAGES:
        slots = torch.randperm(nc * 8, generator=gen, device=dev)[:nf]
        slots = slots.sort().values.to(torch.int32)
        parent = torch.full((Vf,), Vc, dtype=torch.int32, device=dev)
        tap = torch.zeros_like(parent)
        parent[:nf], tap[:nf] = slots // 8, slots % 8
        ok = torch.zeros(Vf, dtype=torch.bool, device=dev)
        ok[:nf] = True
        del slots
        y = torch.randn(Vc, 1, 8, cout, generator=gen, device=dev,
                        dtype=torch.bfloat16).requires_grad_()
        g = torch.randn(Vf, cout, generator=gen, device=dev)
        args = (parent, tap, ok, f32)
        out = sc.transpose_gather(y, *args)
        ref = sc.transpose_gather_plain(y, *args)
        dy, = torch.autograd.grad(out, y, g, retain_graph=True)
        dy_ref, = torch.autograd.grad(ref, y, g, retain_graph=True)
        if not (out.dtype == ref.dtype == f32
                and torch.equal(out.view(torch.int32), ref.view(torch.int32))
                and dy.dtype == dy_ref.dtype == torch.bfloat16
                and torch.equal(dy.view(torch.int16),
                                dy_ref.view(torch.int16))):
            raise AssertionError(f"TG {stage}: output or dy differs from "
                                 f"transpose_gather_plain")
        del dy, dy_ref
        yd = y.detach()
        maps = Vf * 9
        times = {
            "fwd": _time_ms(lambda: sc.transpose_gather(yd, *args), 5),
            "bwd": _time_ms(lambda: torch.autograd.grad(
                out, y, g, retain_graph=True), 5),
            "plain_fwd": _time_ms(
                lambda: sc.transpose_gather_plain(yd, *args), 3),
            "plain_bwd": _time_ms(lambda: torch.autograd.grad(
                ref, y, g, retain_graph=True), 2),
            "index_bwd": _kernel_ms(lambda: torch.autograd.grad(
                ref, y, g, retain_graph=True), "indexing_backward_kernel")}
        fwd_b, _ = _bound_ms(0, PEAK_F32, nf * cout * 2 + Vf * cout * 4
                             + maps)
        bwd_b, _ = _bound_ms(0, PEAK_F32, Vc * 8 * cout * 2
                             + nf * cout * 4 + maps)
        for d, ms, plain, bound, lib in (
                (fwd, times["fwd"], times["plain_fwd"], fwd_b, 0.0),
                (bwd, times["bwd"], times["plain_bwd"], bwd_b,
                 times["index_bwd"])):
            for k, v in zip(keys, (ms, plain, bound, lib)):
                d[k] += v
        log(f"TG {stage} Vc={Vc} V_fine={Vf} ok rows {nf} Cout={cout}: "
            f"output and dy = plain bit for bit; forward {times['fwd']:.4f} "
            f"ms (bound {fwd_b:.4f}, plain {times['plain_fwd']:.4f}), "
            f"backward {times['bwd']:.4f} ms (bound {bwd_b:.4f}, plain "
            f"{times['plain_bwd']:.4f}, of it indexing_backward_kernel "
            f"{times['index_bwd']:.4f})")
        del out, ref, y, yd, g, parent, tap, ok
        torch.cuda.empty_cache()
    fwd["library_ms"] = None
    res = {n: dict(max_abs_err=0, **d, bound_by="bytes")
           for n, d in (("TG", fwd), ("TG bwd", bwd))}
    log(f"TG over the four up stages: forward {fwd['ms']:.4f} ms (bound "
        f"{fwd['bound_ms']:.4f}, plain {fwd['plain_ms']:.4f}), backward "
        f"{bwd['ms']:.4f} ms (bound {bwd['bound_ms']:.4f}, plain "
        f"{bwd['plain_ms']:.4f}, indexing_backward_kernel "
        f"{bwd['library_ms']:.4f})")
    return res


def check_masked_bn(dev):
    """Training-mode BatchNorm with its ReLU (`ops/batchnorm.py`
    `masked_bn_train` on a CUDA tensor: kernels masked_bn_*) at BN_SHAPES,
    float32 as the refiner runs it: against the eager version on the same
    tensors (the output bit for bit given the kernels' moments, within
    BN_F32_TOL with the eager moments; the gradients of x, scale and bias,
    the eager ReLU on the kernels' signs, within BN_F32_TOL of their
    largest; a repeated call bit for bit), then
    timed forward and backward (through autograd) beside the eager
    version and the bound by bytes: forward x read twice over the valid
    rows and out written over all (12 bytes an element when all are
    valid), backward x, out and dy read twice over the valid rows and dx
    written over all (28). Returns the kernels line's "BN" and "BN bwd",
    summed over the three shapes."""
    import torch
    from lidiff_tpu_torch.ops import batchnorm as bn
    gen = torch.Generator(device=dev).manual_seed(19)
    keys = ("ms", "plain_ms", "bound_ms")
    fwd, bwd = dict.fromkeys(keys, 0.0), dict.fromkeys(keys, 0.0)
    worst = 0.0      # the output's largest error against the eager one
    for level, V, n, C in BN_SHAPES:
        x = torch.randn(V, C, generator=gen, device=dev) * 2.0 + 0.5
        mask = torch.zeros(V, dtype=torch.bool, device=dev)
        mask[torch.randperm(V, generator=gen, device=dev)[:n]] = True
        scale = 1.0 + 0.1 * torch.randn(C, generator=gen, device=dev)
        bias = 0.1 * torch.randn(C, generator=gen, device=dev)
        cot = torch.randn(V, C, generator=gen, device=dev)
        xt, st, bt = (t.clone().requires_grad_() for t in (x, scale, bias))
        out, mean, var, cnt = bn.masked_bn_train(xt, mask, st, bt, 1e-5,
                                                 relu=True)
        grads = torch.autograd.grad(out, (xt, st, bt), cot,
                                    retain_graph=True)
        again = bn.masked_bn_train(x, mask, scale, bias, 1e-5, relu=True)[0]
        # the eager code with its ReLU on the kernels' signs: moments that
        # differ in the last bit flip the ReLU of an input within rounding
        # of 0, and that element's gradient with it
        xr, sr, br = (t.clone().requires_grad_() for t in (x, scale, bias))
        rm, rv, rc = bn.masked_moments(xr, mask)
        ref = torch.where(out > 0, bn.normalize_plain(xr, mask, rm, rv, sr,
                                                      br, 1e-5), 0.0)
        ref_grads = torch.autograd.grad(ref, (xr, sr, br), cot,
                                        retain_graph=True)
        same = bn.normalize_plain(x, mask, mean, var, scale, bias, 1e-5,
                                  relu=True)
        if not (torch.equal(out, same) and torch.equal(out, again)
                and float(cnt) == float(rc) == n):
            raise AssertionError(f"BN {level}: the output differs from the "
                                 f"eager code's on the kernels' moments, or "
                                 f"between two calls")
        errs = [float((a - b).abs().max()) / (float(b.abs().max()) + extra)
                for a, b, extra in ((out.detach(), ref.detach(), 1.0),
                                    (mean, rm.detach(), 1.0),
                                    (var, rv.detach(), 1.0),
                                    *((g, r, 0.0) for g, r in
                                      zip(grads, ref_grads)))]
        worst = max(worst, float((out - ref).detach().abs().max()))
        if not max(errs) <= BN_F32_TOL:
            raise AssertionError(f"BN {level}: relative errors (out, mean, "
                                 f"var, dx, dscale, dbias) {errs}")
        del grads, ref_grads, same, again
        xd = x
        eager = bn.normalize_plain(xr, mask, rm, rv, sr, br, 1e-5, relu=True)
        times = {
            "fwd": _time_ms(lambda: bn.masked_bn_train(
                xd, mask, scale, bias, 1e-5, relu=True), 5),
            "bwd": _time_ms(lambda: torch.autograd.grad(
                out, (xt, st, bt), cot, retain_graph=True), 5),
            "plain_fwd": _time_ms(lambda: bn.normalize_plain(
                xd, mask, *bn.masked_moments(xd, mask)[:2], scale, bias,
                1e-5, relu=True), 3),
            "plain_bwd": _time_ms(lambda: torch.autograd.grad(
                eager, (xr, sr, br), cot, retain_graph=True), 3)}
        fwd_b, _ = _bound_ms(0, PEAK_F32, n * C * 8 + V * C * 4 + 2 * V)
        bwd_b, _ = _bound_ms(0, PEAK_F32, n * C * 24 + V * C * 4 + 2 * V)
        for d, ms, plain, bound in (
                (fwd, times["fwd"], times["plain_fwd"], fwd_b),
                (bwd, times["bwd"], times["plain_bwd"], bwd_b)):
            for k, v in zip(keys, (ms, plain, bound)):
                d[k] += v
        log(f"BN {level} rows={V} valid {n} C={C} float32, ReLU: out = "
            f"eager on the kernels' moments and between calls bit for bit, "
            f"relative errors (out, mean, var, dx, dscale, dbias) "
            f"{', '.join(f'{e:.2e}' for e in errs)}; forward "
            f"{times['fwd']:.4f} ms (bound {fwd_b:.4f}, eager "
            f"{times['plain_fwd']:.4f}), backward {times['bwd']:.4f} ms "
            f"(bound {bwd_b:.4f}, eager {times['plain_bwd']:.4f})")
        del out, ref, eager, x, xt, xr, xd, cot, mask
        torch.cuda.empty_cache()
    log(f"BN over the three shapes: forward {fwd['ms']:.4f} ms (bound "
        f"{fwd['bound_ms']:.4f}, eager {fwd['plain_ms']:.4f}), backward "
        f"{bwd['ms']:.4f} ms (bound {bwd['bound_ms']:.4f}, eager "
        f"{bwd['plain_ms']:.4f})")
    return {n: dict(max_abs_err=worst, **d, bound_by="bytes",
                    library_ms=None)
            for n, d in (("BN", fwd), ("BN bwd", bwd))}


def check_gate_apply(dev):
    """GA, the eval gate's apply step (`ops/gate.py` `gate_apply` on CUDA
    tensors), at GATE_SHAPES in bf16: against `gate_apply_plain` on the
    same tensors bit for bit (a share 1 - GATE_VALID of the rows masked,
    their items and bank rows out of range), then timed beside the plain
    version, the library yardstick (`index_select` of the table rows, then
    `where` and `mul`; the flat row indices made outside the timing) and
    the bound by bytes: feats read and out written (2 C bytes a row and
    group each), the int32 bank row a row and group, the row's item and
    mask byte, the table once. Returns the kernels line's "GA" (gate_u1's
    shape) with the eight gates' sums beside it."""
    import torch
    from lidiff_tpu_torch.ops import gate
    gen = torch.Generator(device=dev).manual_seed(23)
    bf16, V, G, nb = torch.bfloat16, GATE_V, 2, GATE_BANK
    mask = torch.rand(V, generator=gen, device=dev) < GATE_VALID
    coords = torch.zeros(V, 4, dtype=torch.int32, device=dev)
    coords[:, 1:] = torch.randint(-500, 500, (V, 3), generator=gen,
                                  device=dev, dtype=torch.int32)
    coords[~mask, 0] = 3
    rows = torch.randint(0, nb, (V, G), generator=gen, device=dev,
                         dtype=torch.int32)
    rows[~mask] = nb + 7
    flat = torch.where(mask[:, None], rows.long(), 0).reshape(-1)
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    res = None
    for name, C in GATE_SHAPES:
        feats = torch.randn(V, G * C, generator=gen, device=dev).to(bf16)
        table = torch.randn(nb, C, generator=gen, device=dev).to(bf16)
        args = (feats, table, rows, coords, mask, nb)
        out = gate.gate_apply(*args)
        ref = gate.gate_apply_plain(*args)
        if not (out.dtype == ref.dtype == bf16
                and torch.equal(out.view(torch.int16), ref.view(torch.int16))):
            raise AssertionError(f"GA {name}: differs from gate_apply_plain")

        def library():
            w = torch.index_select(table, 0, flat).view(V, G, C)
            w = torch.where(mask[:, None, None], w, 0.0)
            return (feats.view(V, G, C) * w).view(V, -1)
        if not torch.equal(library().view(torch.int16), ref.view(torch.int16)):
            raise AssertionError(f"GA {name}: the yardstick differs")
        times = {"ms": _time_ms(lambda: gate.gate_apply(*args), 20),
                 "plain_ms": _time_ms(lambda: gate.gate_apply_plain(*args),
                                      5),
                 "library_ms": _time_ms(library, 5)}
        times["bound_ms"], _ = _bound_ms(
            0, PEAK_F32, V * G * (4 * C + 4) + V * 5 + nb * C * 2)
        for k, v in times.items():
            total[k] += v
        log(f"GA {name} V={V} G={G} C={C} bank {nb} rows, valid "
            f"{int(mask.sum())}: = plain bit for bit; {times['ms']:.4f} ms "
            f"(bound {times['bound_ms']:.4f}, plain {times['plain_ms']:.4f}, "
            f"index_select + where + mul {times['library_ms']:.4f})")
        if name == "gate_u1":
            res = dict(max_abs_err=0, **times, bound_by="bytes")
        del feats, table, out, ref
    log(f"GA over the eight gates: {total['ms']:.4f} ms (bound "
        f"{total['bound_ms']:.4f}, plain {total['plain_ms']:.4f}, "
        f"index_select + where + mul {total['library_ms']:.4f})")
    res["eight_gates"] = total
    return res


def check_gate_denoise(steps: int, dev):
    """One guided denoise on the sampling inputs (180k points, G = 2)
    through the gate tables (`StageGate.apply_table`) against per-voxel
    gates on the same weights, banks and cloud (`apply_table` replaced by
    the training formula on match = bank[rows]), under deterministic
    algorithms (the down conv's scatter adds in a fixed order): float32
    within GATE_EPS_F32_TOL of max|eps|, bf16 within GATE_EPS_BF16_TOL.
    Checks GA's launches (8 a call, and 8 of its kernels and 8
    `lidiff.model.gate` spans in the call's profile) and that the tables'
    rows are under a tenth of the gated rows."""
    import torch
    from lidiff_tpu_torch.models import minkunet
    from lidiff_tpu_torch.ops import gate
    from lidiff_tpu_torch.utils import prof
    from lidiff_tpu_torch.diffusion.dpm_solver import make_dpm_solver
    from lidiff_tpu_torch.models import diffusion
    s = sampling_inputs(steps, dev)
    t = int(make_dpm_solver("linear", 1000, steps, 3.5e-5, 0.007,
                            device=dev).timesteps[0])
    del s.task, s.pyr, s.pyr_c

    def per_voxel(module, feats, geom, rows, bank, temp_emb):
        G = rows.shape[1]
        match = torch.where(geom.mask[:, None, None], bank[rows.long()], 0)
        return module(feats, geom, match[:, 0] if G == 1 else match,
                      temp_emb, G)

    table_path = minkunet.StageGate.apply_table
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        for dt, tol in ((torch.bfloat16, GATE_EPS_BF16_TOL),
                        (torch.float32, GATE_EPS_F32_TOL)):
            task = diffusion.DiffusionTask(s.cfg, device=dev,
                                           compute_dtype=dt, seed=0)
            banks = task.encode_banks(s.part)
            launches = gate._apply_kernel.launches
            before = dict(gate.counters)
            with prof.trace() as p:
                eps = task.denoise_pair(s.noisy, *banks, t)
                _sync(dev)
            n = gate._apply_kernel.launches - launches
            rows = {k: gate.counters[k] - before[k] for k in before}
            # in the trace: GA's kernels, and the gate spans on the host
            traced = sum(1 for e in p.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and "gate_apply_kernel" in e.name)
            spans = sum(1 for e in p.events()
                        if e.name == "lidiff.model.gate"
                        and e.device_type != torch.autograd.DeviceType.CUDA)
            try:
                minkunet.StageGate.apply_table = per_voxel
                ref = task.denoise_pair(s.noisy, *banks, t)
            finally:
                minkunet.StageGate.apply_table = table_path
            top = float(ref.float().abs().max())
            err = float((eps.float() - ref.float()).abs().max()) / top
            share = rows["table_rows"] / rows["gated_rows"]
            log(f"gate tables against per-voxel gates, {dt}, t={t}: max|diff| "
                f"{err:.3e} of max|eps| {top:.3f} (limit {tol:.3e}); GA "
                f"launches {n} ({traced} in the trace, {spans} "
                f"lidiff.model.gate spans), tables {rows['table_calls']} of "
                f"{rows['table_rows']} rows for {rows['gated_rows']} gated "
                f"rows ({share:.4f})")
            if dev == "cuda" and not n == traced == 8:
                raise AssertionError(f"GA: {n} launches a denoiser call, "
                                     f"{traced} in its trace, expected 8")
            if spans != 8:
                raise AssertionError(f"{spans} lidiff.model.gate spans in "
                                     f"a denoiser call, expected 8")
            if rows["table_calls"] != 8 or not share < 0.1:
                raise AssertionError("the gate tables' rows are not under a "
                                     "tenth of the gated rows")
            if not err <= tol:
                raise AssertionError(f"{dt} eps through the gate tables "
                                     f"differs from per-voxel gates")
            del task, banks, eps, ref
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def check_gather_form(pyr, dev):
    """The gather-form kernel-map API on the sampling pyramid, with the
    launch counts of its run: (a) `build_kernel_map` at every level against
    B1's map, built here (hit equal, idx equal on the hit taps); (b)
    `down_kmap_from_pooling` L0 -> L1 against `build_kernel_map` exactly;
    (c) the 27-tap gather conv, per tap at G=1 and G=2 and fused at G=1,
    against A1 through `sparse_conv` over the ColumnKernelMap, float32 with
    bias and ReLU within A1_F32_TOL of max|ref|, and bf16 within the bound
    of the per-tap bf16 sums (2 (K + 2) u A, A = the conv of |feats| and
    |W| plus |bias|: each tap's product and each partial sum rounds to
    bf16, A1 rounds once); (d) the 8-tap gather down conv over (b)'s map
    against `sparse_conv_down`, float32; (e) the bf16 gather at G=1 per tap
    and fused beside A1, timed, with the fused form's peak memory."""
    import torch
    from lidiff_tpu_torch.ops import grid, sparse_conv as sc
    kernels = kernel_table()
    before = {n: k.launches for n, k in kernels.items()}
    t0 = time.time()
    kmaps = []
    for li, lvl in enumerate(pyr.levels):
        g = lvl.geom
        col = grid.build_kmap3_columns(g)
        km = grid.build_kernel_map(g, g, grid.cube_offsets(3, g.stride))
        if not (torch.equal(km.hit, col.hit)
                and torch.equal(km.idx[km.hit], col.idx[col.hit])):
            raise AssertionError(f"gather form: build_kernel_map differs "
                                 f"from B1's map at L{li}")
        kmaps.append(km)
    fine, coarse = pyr.levels[0], pyr.levels[1]
    down = grid.down_kmap_from_pooling(fine.geom, fine.parent_idx,
                                       coarse.geom.capacity)
    ref_down = grid.build_kernel_map(fine.geom, coarse.geom,
                                     grid.cube_offsets(2, 1))
    if not (torch.equal(down.hit, ref_down.hit)
            and torch.equal(down.idx[down.hit], ref_down.idx[ref_down.hit])):
        raise AssertionError("gather form: down_kmap_from_pooling differs "
                             "from build_kernel_map at L0 -> L1")
    log(f"gather form: build_kernel_map = B1's map at L0-L4, "
        f"down_kmap_from_pooling = build_kernel_map at L0 -> L1 "
        f"({int(down.hit.sum())} children) ({time.time() - t0:.1f} s)")

    gen = torch.Generator(device=dev).manual_seed(11)
    timed = None
    for cin, cout, li in GATHER_WIDTHS:
        lvl = pyr.levels[li]
        g, col, km = lvl.geom, lvl.kmap3, kmaps[li]
        b = 0.1 * torch.randn(cout, generator=gen, device=dev)
        w32 = torch.randn(27, cin, cout, generator=gen, device=dev) \
            / math.sqrt(27 * cin)
        f32 = torch.randn(g.capacity, 2 * cin, generator=gen, device=dev) \
            * g.mask[:, None]
        for dt in (torch.float32, torch.bfloat16):
            for G, fused in ((1, False), (1, True), (2, False)):
                if dt == torch.bfloat16 and G == 2:
                    continue
                f, w = f32[:, :G * cin].to(dt), w32.to(dt)
                kw = dict(groups=G, bias=b, relu=True, compute_dtype=dt)
                ref = sc.sparse_conv(f, col, w, g.mask, **kw).float()
                got = sc.sparse_conv(f, km, w, g.mask, fused=fused,
                                     **kw).float()
                err = (got - ref).abs()
                scale = float(ref.abs().max())
                if dt == torch.float32:
                    bound = A1_F32_TOL * scale
                    ok = scale > 0 and float(err.max()) <= bound
                    what = f"{bound:.3g}"
                else:
                    A = sc.sparse_conv(f.float().abs(), km, w.float().abs(),
                                       g.mask, groups=G, bias=b.abs())
                    ok = bool((err <= 2 * 29 * BF16_U * A).all())
                    what = (f"2 (K+2) u A, largest err/A "
                            f"{float((err / A.clamp(min=1e-30)).max()):.3g}")
                form = "fused" if fused else "per tap"
                log(f"gather form ({cin:3d},{cout:3d}) L{li} G={G} {form:7s}"
                    f" {str(dt)[6:]:8s}: max err {float(err.max()):.3g} "
                    f"({float(err.max()) / max(scale, 1e-30):.2e} of "
                    f"max|ref|), bound {what}")
                if not ok:
                    raise AssertionError(
                        f"gather form ({cin},{cout}) L{li} G={G} {form} "
                        f"{dt}: max err {float(err.max()):.3g} at scale "
                        f"{scale:.3g}")
        if (cin, cout, li) == GATHER_WIDTHS[0]:
            timed = (g, col, km, f32[:, :cin].bfloat16(), w32.bfloat16(), b)

    cin, cout = GATHER_DOWN
    f = torch.randn(fine.geom.capacity, cin, generator=gen, device=dev) \
        * fine.geom.mask[:, None]
    w = torch.randn(8, cin, cout, generator=gen, device=dev) \
        / math.sqrt(8 * cin)
    b = 0.1 * torch.randn(cout, generator=gen, device=dev)
    ref = sc.sparse_conv_down(f, fine.parent_idx, fine.up_tap, w,
                              coarse.geom.mask, bias=b, relu=True)
    got = sc.sparse_conv(f, down, w, coarse.geom.mask, bias=b, relu=True)
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    log(f"gather form down conv ({cin},{cout}) L0 -> L1 float32: max err "
        f"{err:.3g} ({err / max(scale, 1e-30):.2e} of max|ref|)")
    if not (scale > 0 and err <= A1_F32_TOL * scale):
        raise AssertionError(f"gather down conv: max err {err:.3g} at scale "
                             f"{scale:.3g}")

    g, col, km, f, w, b = timed
    cin, cout, li = GATHER_WIDTHS[0]
    kw = dict(bias=b, relu=True, compute_dtype=torch.bfloat16)
    a1_ms = _time_ms(lambda: sc.sparse_conv(f, col, w, g.mask, **kw))
    tap_ms = _time_ms(lambda: sc.sparse_conv(f, km, w, g.mask, **kw), 5)
    _sync(dev)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fused_ms = _time_ms(lambda: sc.sparse_conv(f, km, w, g.mask, fused=True,
                                               **kw), 5)
    peak = torch.cuda.max_memory_allocated() - base
    V = g.capacity
    gemm = 2.0 * V * 27 * cin * cout      # every tap, hit or not
    log(f"gather form time ({cin},{cout}) L{li} V={V} G=1 bf16: per tap "
        f"{tap_ms:.4f} ms, fused {fused_ms:.4f} ms ({gemm / fused_ms / 1e9:.1f}"
        f" TFLOP/s over all 27 taps; peak memory {peak / 2**30:.2f} GiB above "
        f"the inputs); A1 {a1_ms:.4f} ms, {tap_ms / a1_ms:.2f}x and "
        f"{fused_ms / a1_ms:.2f}x its time ({time.time() - t0:.1f} s)")
    launches = {n: k.launches - before[n] for n, k in kernels.items()}
    log(f"gather form launches {launches}")
    return launches


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


def run_int8_completion(task, x_init, part, solver, out_bf16, bf16_launches,
                        kernels, steps, dev):
    """The completion of the sampling phase with `conv_quant` on: the same
    weights, offset and noise (the same generator seed). Checks zero
    overflow, a finite output and the launches (A1 only for the stem's
    Cin=3 conv: once per step and once per bank); reports the chamfer
    distance to the bf16 output. Returns the launches."""
    import torch
    from lidiff_tpu_torch.ops import chamfer
    for k in kernels.values():
        k.launches = 0
    out = task.sample(x_init, part, torch.Generator(device=dev).manual_seed(1),
                      solver=solver)
    _sync(dev)
    launches = {n: k.launches for n, k in kernels.items()}
    # per guided step one match per level and bank, the uncond bank's a
    # scan, and TG's forward once per transpose conv; one index per bank
    # and completion
    want = {"C1": 10 * steps, "C1 scan": 5 * steps, "C1 index": 2,
            "TG": up_convs(task.model) * steps, "TG bwd": 0}
    if dev == "cuda" and any(launches[n] != c for n, c in want.items()):
        raise AssertionError(f"completion launches {launches}, expected "
                             f"{want}")
    ovf = [int(v) for v in task.pyramid_full(out).overflows()]
    cd = float(chamfer.chamfer_distance(out, out_bf16))
    log(f"int8 completion (conv_quant): launches {launches}; chamfer "
        f"distance to the bf16 output {cd:.5f} (random weights); overflow "
        f"at the output {ovf}")
    if tuple(out.shape) != tuple(out_bf16.shape) or \
            not bool(torch.isfinite(out).all()) or any(ovf):
        raise AssertionError("int8 completion output is not finite, has the "
                             "wrong shape or overflows")
    if dev == "cuda":
        want = {"A1": steps + 2, "A4": bf16_launches["A1"] - steps - 2,
                **{n: bf16_launches[n] for n in ("B1", "C1", "TG", "GA")},
                "TG bwd": 0}
        for n, c in want.items():
            if launches[n] != c:
                raise AssertionError(f"int8 completion: kernel {n}: "
                                     f"{launches[n]} launches, expected {c}")
    return launches


def run_unfused_completion(cfg, x_init, part, noisy, solver, out_fused,
                           fused_launches, kernels, steps, dev):
    """The completion of the sampling phase with `tpu.fuse_classfree` off,
    on a task of the same seed (the same weights) and the same offset and
    noise: the guided pair as two G=1 forwards over one pyramid a step.
    Checks the launches against the fused run's (A1 twice per denoiser
    conv, the stem's included, so DENOISER_CONVS more a step, the
    encoder's unchanged; B1 and its plan taps unchanged, one pyramid a
    step; C1 unchanged, 5 matches against each bank), zero overflow and a
    finite output, and that the mean nearest-neighbour distance between
    the two clouds each way lies within SCANS_NN_TOL (the limit of two
    sound runs of one computation); then holds the float32 unfused guided
    eps against the fused one at the first step's t, within
    UNFUSED_EPS_TOL of max|eps|. Returns the launches."""
    import torch
    from scipy.spatial import cKDTree
    from lidiff_tpu_torch.models import diffusion
    ucfg = dict(cfg, tpu=dict(cfg["tpu"], fuse_classfree=False))
    task = diffusion.DiffusionTask(ucfg, device=dev,
                                   compute_dtype=torch.bfloat16, seed=0)
    if task.fuse_classfree:
        raise AssertionError("tpu.fuse_classfree: false was not read")
    for k in kernels.values():
        k.launches = 0
    out = task.sample(x_init, part, torch.Generator(device=dev).manual_seed(1),
                      solver=solver)
    _sync(dev)
    launches = {n: k.launches for n, k in kernels.items()}
    ovf = [int(v) for v in task.pyramid_full(out).overflows()]
    a, b = out[0].float().cpu().numpy(), out_fused[0].float().cpu().numpy()
    nn = max(float(cKDTree(b).query(a)[0].mean()),
             float(cKDTree(a).query(b)[0].mean()))
    # the encoders' convs and pyramids: once per bank and completion
    a1_step = (launches["A1"] - 2 * (CONVS_PER_STEP - DENOISER_CONVS)) / steps
    b1_step = (launches["B1"] - 2 * task.num_levels) / steps
    log(f"unfused completion (tpu.fuse_classfree false, two G=1 forwards a "
        f"step): launches {launches}, per step A1 {a1_step:g} B1 "
        f"{b1_step:g} C1 {launches['C1'] / steps:g}; mean "
        f"nearest-neighbour distance to the fused cloud {nn:.6f} m (limit "
        f"{SCANS_NN_TOL} m); overflow at the output {ovf}")
    if tuple(out.shape) != tuple(out_fused.shape) or \
            not bool(torch.isfinite(out).all()) or any(ovf):
        raise AssertionError("unfused completion output is not finite, has "
                             "the wrong shape or overflows")
    if nn > SCANS_NN_TOL:
        raise AssertionError("the unfused completion lies beyond "
                             "SCANS_NN_TOL of the fused one")
    if dev == "cuda":
        want = {"A1": fused_launches["A1"] + DENOISER_CONVS * steps,
                "TG": 2 * fused_launches["TG"], "TG bwd": 0,
                "GA": 2 * fused_launches["GA"],
                **{n: fused_launches[n]
                   for n in ("B1", "B1 taps", "C1", "C1 scan", "C1 index")}}
        for n, c in want.items():
            if launches[n] != c:
                raise AssertionError(f"unfused completion: kernel {n}: "
                                     f"{launches[n]} launches, expected {c}")
    del task, out
    # float32: the unfused guided eps against the fused one at one t
    task = diffusion.DiffusionTask(cfg, device=dev,
                                   compute_dtype=torch.float32, seed=0)
    banks = task.encode_banks(part)
    t_first = int(solver.timesteps[0])
    eps_f = task.denoise_pair(noisy, *banks, t_first)
    task.fuse_classfree = False
    eps_u = task.denoise_pair(noisy, *banks, t_first)
    top = float(eps_f.abs().max())
    err = float((eps_u - eps_f).abs().max()) / top
    log(f"unfused guided eps against fused, float32, t={t_first}: max|diff| "
        f"{err:.3e} of max|eps| {top:.3f} (limit {UNFUSED_EPS_TOL})")
    if not err <= UNFUSED_EPS_TOL:
        raise AssertionError("the unfused guided eps differs from the fused "
                             "one")
    return launches


def sampling_inputs(steps: int, dev: str):
    """The sampling path's config (180k points, res 0.05, `steps` solver
    steps), a bf16 task of seed 0, its partial scan, the anchors x_init
    (the scan tiled) and the first step's cloud (x_init plus unit noise);
    the pyramids of that cloud and of the scan, held to zero overflow."""
    import torch
    from lidiff_tpu_torch import config as cfg_mod
    from lidiff_tpu_torch.models import diffusion
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
    ovf = [int(v) for v in pyr.overflows()]
    ovf_c = [int(v) for v in pyr_c.overflows()]
    log(f"capacities full {cfg['tpu']['full_capacities']} part "
        f"{cfg['tpu']['part_capacities']}; voxels per level "
        f"{[int(l.geom.num) for l in pyr.levels]}; overflow full {ovf} "
        f"part {ovf_c}")
    if any(ovf) or any(ovf_c):
        raise AssertionError("capacity overflow on the sampling input")
    return types.SimpleNamespace(cfg=cfg, task=task, part=part,
                                 x_init=x_init, noisy=noisy, pyr=pyr,
                                 pyr_c=pyr_c)


def phase_kernels(steps: int, dev: str):
    """The kernels against their plain versions on the sampling path's
    inputs. Returns (kernel results, {"gather form": launches})."""
    import torch
    from lidiff_tpu_torch import config as cfg_mod
    from lidiff_tpu_torch.ops import grid, knn, sparse_conv
    s = sampling_inputs(steps, dev)
    pyr, task, x_init = s.pyr, s.task, s.x_init
    pyr_u = task.pyramid_part_tiny(torch.zeros_like(s.part))
    # C1 also at the cond bank the default capacity table gives (11264
    # rows at 180k points): the enlarged bank cut to it, which drops the
    # highest keys as a capacity overflow does
    cond = s.pyr_c.levels[-1].geom
    cap = cfg_mod.derive_capacities(N_PART, clean=True)[-1]
    cond_default = types.SimpleNamespace(coords=cond.coords[:cap].contiguous(),
                                         mask=cond.mask[:cap].contiguous(),
                                         capacity=cap)
    stats, b1_plan_ms = plan_stats(pyr, dev, "t~T")
    plan_stats(task.pyramid_full(x_init + 0.01 * torch.randn(
        x_init.shape, generator=torch.Generator(device=dev).manual_seed(10),
        device=dev)), dev, "t~0")
    res = {"B1": {**check_b1(pyr, grid), "with_plan_ms": b1_plan_ms},
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
    return res, {"gather form": check_gather_form(pyr, dev)}


def phase_parity(steps: int, dev: str):
    """Small float32 runs on the card against the CPU."""
    from lidiff_tpu_torch import config as cfg_mod
    from lidiff_tpu_torch.models import diffusion
    check_small_reference(cfg_mod, diffusion, dev)
    check_small_reference(cfg_mod, diffusion, dev, conv_quant=True)
    check_small_train(cfg_mod, diffusion, dev)
    check_chamfer(dev)
    check_small_refine_train(cfg_mod, dev)
    return {}, {}


def phase_sampling(steps: int, dev: str):
    """One completion, then the same unfused and with the int8 convs.
    Returns ({}, their launches)."""
    import torch
    from lidiff_tpu_torch.diffusion.dpm_solver import make_dpm_solver
    from lidiff_tpu_torch.models import diffusion
    s = sampling_inputs(steps, dev)
    kernels = kernel_table()
    solver = make_dpm_solver("linear", 1000, steps, 3.5e-5, 0.007, device=dev)
    for k in kernels.values():
        k.launches = 0
    out = s.task.sample(s.x_init, s.part,
                        torch.Generator(device=dev).manual_seed(1),
                        solver=solver)
    _sync(dev)
    launches = {n: k.launches for n, k in kernels.items()}
    # per guided step one match per level and bank, the uncond bank's a
    # scan; one index per bank and completion
    want = {"C1": 10 * steps, "C1 scan": 5 * steps, "C1 index": 2,
            "BN": 0, "BN bwd": 0,     # eval mode: BatchNorm folded
            "GA": 8 * steps}          # a gate table per gate and call
    if dev == "cuda" and any(launches[n] != c for n, c in want.items()):
        raise AssertionError(f"completion launches {launches}, expected "
                             f"{want}")
    log(f"completion: {steps} steps of the 1000-step linear schedule, "
        f"{N_PART * TILE} points, bf16, G=2, w=6; launches {launches}")
    if tuple(out.shape) != (1, N_PART * TILE, 3) or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError("completion output is not finite or has the "
                             "wrong shape")
    del s.task, s.pyr, s.pyr_c
    unfused = run_unfused_completion(s.cfg, s.x_init, s.part, s.noisy, solver,
                                     out, launches, kernels, steps, dev)
    task_q = diffusion.DiffusionTask(s.cfg, device=dev,
                                     compute_dtype=torch.bfloat16, seed=0,
                                     conv_quant=True)
    int8 = run_int8_completion(task_q, s.x_init, s.part, solver, out,
                               launches, kernels, steps, dev)
    return {}, {"sampling": launches, "sampling unfused": unfused,
                "int8 sampling": int8}


def phase_training(steps: int, dev: str):
    s = sampling_inputs(steps, dev)
    cfg, x_init, part = s.cfg, s.x_init, s.part
    del s
    kernels = kernel_table()
    return {}, {"training": run_training(cfg, kernels, x_init, part, dev),
                f"training at batch {DIFF_BATCH}":
                    run_training_batch(cfg, kernels, dev)}


def phase_ddp(steps: int, dev: str):
    from lidiff_tpu_torch import config as cfg_mod
    from lidiff_tpu_torch.models import diffusion
    s = sampling_inputs(steps, dev)
    cfg, x_init, part = s.cfg, s.x_init, s.part
    del s
    run_ddp(cfg, cfg_mod, diffusion, x_init, part, dev)
    return {}, {}


def phase_pipeline(steps: int, dev: str):
    cfg = sampling_inputs(steps, dev).cfg
    return {}, {"pipeline": run_pipeline(cfg, kernel_table(), steps, dev)}


def phase_clis(steps: int, dev: str):
    with tempfile.TemporaryDirectory() as tree:
        make_kitti_tree(tree)
        run_cli(dev, tree)
        run_refine_cli(dev, tree)
        run_eval_clis(dev, tree, kernel_table())
    return {}, {}


def train_steps(task, cfg, batch, gen, kernels, dev, what: str,
                loss_key: str, want: dict, describe, draws=None):
    """TRAIN_WARMUP + TRAIN_STEPS optimizer steps through
    Trainer.train_step, the launches counted over the last TRAIN_STEPS.
    Checks a finite loss, a finite gradient for every parameter, that
    every parameter and running statistic moved and, on the card, the
    launches per step in `want`. `describe(metrics)` words a step's
    metrics; `draws` go to every step's loss_fn. Returns the kernels'
    launches over the counted steps."""
    import torch
    from lidiff_tpu_torch.training.trainer import Trainer
    draws = draws or {}
    model = task.model
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with tempfile.TemporaryDirectory() as exp_dir:
        trainer = Trainer(task, cfg, exp_dir)
        for _ in range(TRAIN_WARMUP):
            trainer.train_step(batch, gen, **draws)
        _sync(dev)
        for k in kernels.values():
            k.launches = 0
        losses = [trainer.train_step(batch, gen, **draws)
                  for _ in range(TRAIN_STEPS)]
        _sync(dev)
    launches = {n: k.launches for n, k in kernels.items()}
    per_step = {n: c / TRAIN_STEPS for n, c in launches.items() if c}
    log(f"{what}: {'; '.join(describe(m) for m in losses)}; launches per "
        f"step {per_step}")
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
    if dev == "cuda":
        for n, c in want.items():
            if per_step.get(n, 0) != c:
                raise AssertionError(
                    f"{what}: kernel {n}: {per_step.get(n, 0)} launches "
                    f"per step, expected {c}")
    return launches


def stage_convs(model) -> int:
    """The column convs inside the model's DownStages and UpStages: with
    remat a training step runs each forward once more, in the backward
    pass (4 a stage, in its two residual blocks)."""
    from lidiff_tpu_torch.models.blocks import DownStage, SparseConv, UpStage
    return sum(1 for st in model.modules()
               if isinstance(st, (DownStage, UpStage))
               for m in st.modules()
               if isinstance(m, SparseConv) and m.kernel.shape[0] == 27)


def up_convs(model) -> int:
    """The transpose convs of the model, one in each UpStage: TG's forward
    runs once for each in a forward pass (once more with remat, in the
    backward pass), its backward once for each in a backward pass."""
    from lidiff_tpu_torch.models.blocks import SparseConvTranspose
    return sum(1 for m in model.modules()
               if isinstance(m, SparseConvTranspose))


def bn_sites(model) -> tuple:
    """(the model's BatchNorms, those inside a DownStage or UpStage): a
    training forward calls each once, and with remat the backward pass
    calls those of the stages once more (each a fused launch of
    `masked_bn_apply` on the card); the backward, `masked_bn_dx` once
    each."""
    from lidiff_tpu_torch.models.blocks import (DownStage, MaskedBatchNorm,
                                                UpStage)
    staged = sum(1 for st in model.modules()
                 if isinstance(st, (DownStage, UpStage))
                 for m in st.modules() if isinstance(m, MaskedBatchNorm))
    return (sum(1 for m in model.modules()
                if isinstance(m, MaskedBatchNorm)), staged)


def grad_step(task, batch, draws):
    """One loss and backward pass of a fresh task: (loss, the gradients and
    the BN running statistics on the host)."""
    task.model.zero_grad()
    loss, _ = task.loss_fn(batch, **draws)
    loss.backward()
    return (float(loss.detach()),
            {n: p.grad.float().cpu() for n, p in
             task.model.named_parameters()},
            {n: b.float().cpu() for n, b in task.model.named_buffers()})


def step_differences(got, ref):
    """How far step `got` is from step `ref` (both `grad_step`'s): the
    loss's relative difference, the worst gradient leaf in units of
    check_small_train's tolerance (2e-3 of its max|grad| plus 1e-4 of the
    largest) and its name, and the worst running statistic in units of
    REMAT_STATS_TOL x (1 + |value|). A NaN counts as the worst."""
    import torch
    (l_got, g_got, s_got), (l_ref, g_ref, s_ref) = got, ref
    top = max(float(g.abs().max()) for g in g_ref.values())
    worst, worst_name = -1.0, ""
    for n, r in g_ref.items():
        err = float((g_got[n] - r).abs().max())
        lim = TRAIN_GRAD_TOL * float(r.abs().max()) + TRAIN_GRAD_ATOL * top
        if not err / lim <= worst:
            worst, worst_name = err / lim, n
    stats = float(torch.stack([
        ((s_got[n] - r).abs() / (REMAT_STATS_TOL * (1 + r.abs()))).max()
        for n, r in s_ref.items()]).max())
    return abs(l_got - l_ref) / abs(l_ref), worst, worst_name, stats


def compare_remat(make_task, batch, draws, what: str):
    """At full width in float32, one loss and backward pass with remat off
    and one with it: fresh tasks of one seed (`make_task(remat)`, float32
    compute), the same batch and `draws`, under
    `torch.use_deterministic_algorithms` (the scatter-adds sorted: with the
    card's atomic adds, two runs of one step already differ at this size).
    The remat run is held
    to the other at check_small_train's tolerances: the loss within
    TRAIN_LOSS_RTOL, every gradient within TRAIN_GRAD_TOL of its max|grad|
    plus TRAIN_GRAD_ATOL of the largest, the running statistics within
    REMAT_STATS_TOL. Logs how many gradients are equal
    bit for bit (A3's float32 weight gradient keeps its atomic adds)."""
    import warnings

    import torch
    fill = torch.utils.deterministic.fill_uninitialized_memory
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        # new tensors as the step makes them otherwise (not filled with NaN)
        torch.utils.deterministic.fill_uninitialized_memory = False
        try:
            off, on = (grad_step(make_task(r), batch, draws)
                       for r in (False, True))
        finally:
            torch.use_deterministic_algorithms(False)
            torch.utils.deterministic.fill_uninitialized_memory = fill
    nondet = sorted({"cuBLAS" if "CuBLAS" in str(w.message) else
                     str(w.message).split(" does not have")[0]
                     for w in seen if "deterministic" in str(w.message)})
    loss_d, worst, name, stats = step_differences(on, off)
    same = sum(bool(torch.equal(on[1][n], g)) for n, g in off[1].items())
    log(f"{what}, float32, deterministic adds, remat on vs off: loss "
        f"{on[0]:.7f} vs {off[0]:.7f} (relative {loss_d:.2e}); {same} of "
        f"{len(off[1])} gradients equal, the worst at {worst:.4f} of "
        f"check_small_train's tolerance ({name}); running statistics at "
        f"{stats:.4f} of theirs; ops without a deterministic version: "
        f"{nondet or 'none'}")
    if not (loss_d <= TRAIN_LOSS_RTOL and worst <= 1.0 and stats <= 1.0):
        raise AssertionError(f"{what}: remat changes the loss, a gradient "
                             "or the running statistics at full width")


def run_training(cfg, kernels, x_init, part, dev):
    """Diffusion training at full width, batch 1: one step with remat off
    and on compared (`compare_remat`), then the steps of each, the remat
    run last. Returns the remat run's launches over its counted steps."""
    import torch
    from lidiff_tpu_torch.models import diffusion

    def make_task(remat, dtype=torch.bfloat16):
        return diffusion.DiffusionTask(
            {**cfg, "tpu": {**cfg["tpu"], "remat": remat}}, device=dev,
            compute_dtype=dtype, seed=0)

    batch = {"pcd_full": x_init, "pcd_part": part}
    gen = torch.Generator(device=dev).manual_seed(4)
    draws = {"noise": torch.randn(x_init.shape, generator=gen, device=dev),
             "t": torch.tensor([500], device=dev), "drop": False}
    compare_remat(lambda r: make_task(r, torch.float32), batch, draws,
                  "training")
    log(f"training: {N_PART * TILE} points, batch 1, bf16 compute with "
        "float32 activations, lr 1e-4")
    for remat in (False, True):
        task = make_task(remat)
        launches = diffusion_steps(task, cfg, batch, kernels, dev,
                                   "training" + ("" if remat else
                                                 ", remat off"), remat)
        del task
    return launches


def diffusion_steps(task, cfg, batch, kernels, dev, what: str, remat: bool,
                    draws=None):
    """`train_steps` of the diffusion task, with the launches per step that
    its convs give (A1 once more for each stage conv with remat) and no
    overflow."""
    import torch
    overflow = []

    def describe(m):
        overflow.append(int(m["overflow_vox"]))
        return f"loss {float(m['loss']):.4f}, overflow {overflow[-1]}"

    extra = stage_convs(task.model) if remat else 0
    ups = up_convs(task.model)
    out = train_steps(
        task, cfg, batch, torch.Generator(device=dev).manual_seed(3),
        kernels, dev, what, "loss",
        {"A3": CONVS_PER_STEP, "A2": CONVS_PER_STEP - 2,
         "A1": 2 * CONVS_PER_STEP - 2 + extra, "C1": 5, "C1 index": 1,
         "TG": ups * (2 if remat else 1), "TG bwd": ups, "GA": 0},
        describe, draws=draws)
    if any(overflow):
        raise AssertionError(f"{what}: capacity overflow on the input")
    return out


def batch_cfg(cfg, n: int) -> dict:
    """`cfg` for a batch of n: every capacity n times the one-item value
    (both packages quantize a batch's points into one set of voxels)."""
    tpu = dict(cfg["tpu"])
    for key in ("full_capacities", "part_capacities"):
        if key in tpu:
            tpu[key] = [n * c for c in tpu[key]]
    return {**cfg, "tpu": tpu, "train": {**cfg["train"], "batch_size": n}}


def run_training_batch(cfg, kernels, dev, n: int = DIFF_BATCH):
    """Diffusion training at the config's batch size with remat: n ring
    scans (the first the batch-1 scan), the capacities n times the
    one-item ones, zero overflow. The classifier-free coin is held off:
    set, it zeroes the partial scans, and with two items train BatchNorm
    over equal voxels gives NaN encoder gradients in both packages
    (ROADMAP.md Queue C)."""
    import numpy as np
    import torch
    from lidiff_tpu_torch.models import diffusion
    bcfg = batch_cfg(cfg, n)
    part = torch.from_numpy(np.concatenate(
        [ring_scan(N_PART, seed=s) for s in range(n)])).to(dev)
    task = diffusion.DiffusionTask(bcfg, device=dev,
                                   compute_dtype=torch.bfloat16, seed=0)
    log(f"training at batch {n}: {n} x {N_PART * TILE} points, capacities "
        f"full {bcfg['tpu']['full_capacities']} part "
        f"{bcfg['tpu']['part_capacities']}, remat on, the coin held off")
    return diffusion_steps(
        task, bcfg, {"pcd_full": part.repeat(1, TILE, 1), "pcd_part": part},
        kernels, dev, f"training at batch {n}", True, draws={"drop": False})


def _host_syncs(fn, stacks: bool = False):
    """(fn(), the calls in it that made the host wait for the card, by
    torch's CUDA sync debug mode: a Counter of "file:line" of the port's
    frame nearest each sync on its stack, else of the innermost frame
    outside torch); (fn(), an empty Counter) off the card. A sync's warning
    carries only its innermost Python frame, which may be torch's own.
    `stacks` logs the whole stack of a sync with no port frame on it."""
    import collections
    import traceback
    import warnings

    import torch
    where = collections.Counter()
    if not torch.cuda.is_available():
        return fn(), where
    port = os.sep + "lidiff_tpu_torch" + os.sep
    torch_dir = os.path.dirname(torch.__file__)

    def show(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if not f.filename.endswith("warnings.py")]
        ours = [f for f in stack if port in f.filename]
        frame = (ours or [f for f in stack if not f.filename.startswith(
            torch_dir)] or stack)[-1]
        where[f"{os.path.relpath(frame.filename, ROOT)}:{frame.lineno}"] += 1
        if stacks and not ours:
            log("a host sync with no port frame on its stack:\n"
                + "".join(traceback.format_list(stack)))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, where


def _collectives(fn):
    """(fn(), the number of all-reduces it issued): every collective of
    the port is a `torch.distributed.all_reduce` (`parallel/mesh.py`)."""
    import torch.distributed as dist
    calls = 0
    all_reduce = dist.all_reduce

    def counted(*a, **kw):
        nonlocal calls
        calls += 1
        return all_reduce(*a, **kw)

    dist.all_reduce = counted
    try:
        return fn(), calls
    finally:
        dist.all_reduce = all_reduce


def run_ddp(cfg, cfg_mod, diffusion, x_init, part, dev):
    """Data-parallel training at world 1: a one-rank group through a file
    store (NCCL on the card, gloo on the CPU; `parallel/mesh.py`). A small
    float32 step through the distributed trainer (synced BN, the
    regularizer over the group, averaged gradients) against
    `Trainer.train_step` without a group, the same weights and draws,
    within check_small_train's tolerances, with its collectives counted
    with remat on and off (remat adds one all-reduce per BatchNorm inside
    a stage: the recompute's moments); then TRAIN_WARMUP + TRAIN_STEPS
    full-width diffusion steps (remat on) without and with the group, the
    last TRAIN_STEPS with their host syncs (at most 2 a step, every one
    counted: the recompute adds none) and collectives."""
    import numpy as np
    import torch
    from lidiff_tpu_torch.parallel import mesh
    from lidiff_tpu_torch.training.trainer import Trainer
    backend = "NCCL" if dev == "cuda" else "gloo"
    group = mesh.init_ranks(0, 1, mesh.file_init_method(), dev)
    try:
        caps = {"full_capacities": [4096] * 3 + [3072, 2048],
                "part_capacities": [512] * 5}
        small = cfg_mod.finalize_config(make_cfg(4000, 2, cr=0.25, caps=caps))
        rng = np.random.default_rng(6)
        p_np = np.concatenate([ring_scan(400, seed=3), ring_scan(400, seed=4)])
        f_np = np.tile(p_np, (1, TILE, 1)) + rng.normal(
            0, 0.05, (2, 400 * TILE, 3)).astype(np.float32)
        batch = {"pcd_full": torch.from_numpy(f_np).to(dev),
                 "pcd_part": torch.from_numpy(p_np).to(dev)}
        draws = {"noise": torch.from_numpy(rng.normal(size=f_np.shape).astype(
                     np.float32)).to(dev),
                 "t": torch.tensor([700, 150], device=dev), "drop": False}
        out, calls = {}, {}
        with tempfile.TemporaryDirectory() as exp:
            for name, g, remat in (("plain", None, True),
                                   ("distributed", group, True),
                                   ("distributed, remat off", group, False)):
                scfg = {**small, "tpu": {**small["tpu"], "remat": remat}}
                task = diffusion.DiffusionTask(scfg, device=dev, seed=2,
                                               compute_dtype=torch.float32,
                                               group=g)
                m, calls[name] = _collectives(lambda: Trainer(
                    task, scfg, exp, group=g).train_step(batch, **draws))
                out[name] = (float(m["loss"]), {n: p.grad.cpu() for n, p in
                                                task.model.named_parameters()})
        (l_ref, g_ref), (l_ddp, g_ddp) = out["plain"], out["distributed"]
        from lidiff_tpu_torch.models.blocks import (DownStage,
                                                    MaskedBatchNorm, UpStage)
        stage_bns = sum(1 for st in task.model.modules()
                        if isinstance(st, (DownStage, UpStage))
                        for m in st.modules()
                        if isinstance(m, MaskedBatchNorm))
        log(f"world-1 {backend} collectives a step: "
            f"{calls['distributed']} with remat, "
            f"{calls['distributed, remat off']} without; {stage_bns} "
            f"BatchNorms inside the stages")
        if calls["plain"] or calls["distributed"] - \
                calls["distributed, remat off"] != stage_bns:
            raise AssertionError("remat should add one all-reduce per "
                                 "BatchNorm inside a stage")
        top = max(float(g.abs().max()) for g in g_ref.values())
        worst, worst_name = 0.0, ""
        for n, ref in g_ref.items():
            err = float((g_ddp[n] - ref).abs().max())
            lim = TRAIN_GRAD_TOL * float(ref.abs().max()) + \
                TRAIN_GRAD_ATOL * top
            if err / lim > worst:
                worst, worst_name = err / lim, n
        log(f"world-1 {backend} step, small f32, distributed vs "
            f"plain: loss {l_ddp:.6f} vs {l_ref:.6f}; worst gradient at "
            f"{worst:.3f} of its tolerance ({worst_name})")
        if not abs(l_ddp - l_ref) <= TRAIN_LOSS_RTOL * abs(l_ref) or \
                not worst <= 1.0:
            raise AssertionError("the world-1 distributed step differs from "
                                 "the plain step")

        # full width: plain, then distributed, one task at a time
        rows = {}
        for name, g in (("plain", None), ("distributed", group)):
            task = diffusion.DiffusionTask(cfg, device=dev, seed=0,
                                           compute_dtype=torch.bfloat16,
                                           group=g)
            gen = mesh.rank_generator(3, 0, dev)
            full = {"pcd_full": x_init, "pcd_part": part}
            with tempfile.TemporaryDirectory() as exp:
                trainer = Trainer(task, cfg, exp, group=g)
                for _ in range(TRAIN_WARMUP):
                    trainer.train_step(full, gen)
                # the step's host syncs and collectives counted inside it
                rows[name] = [(n, c, float(m["loss"])) for (m, n), c in (
                    _collectives(lambda: _host_syncs(
                        lambda: trainer.train_step(full, gen), stacks=True))
                    for _ in range(TRAIN_STEPS))]
            del task, trainer
        for name, steps in rows.items():
            log(f"world-1 training step at full width, remat on, {name}: "
                + "; ".join(f"{sum(n.values())} host syncs {dict(n)}, {c} "
                            f"collectives, loss {loss:.4f}"
                            for n, c, loss in steps))
        if not all(math.isfinite(r[2]) for steps in rows.values()
                   for r in steps):
            raise AssertionError("world-1 training: a loss is not finite")
        # every sync of the step counts: the two are the bank index's build
        # (ops/knn.py); the recompute adds none
        if any(sum(r[0].values()) > 2 for steps in rows.values()
               for r in steps):
            raise AssertionError("world-1 training: more than 2 host syncs "
                                 "in a step")
    finally:
        mesh.shutdown()


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
    invalid, quantized as the grid chamfer does (the references sorted):
    about 200k x 80k, so that the batch compare and tiles across items
    run."""
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
    q, qm = chamfer.grid_coords(xf, mx, res, 2)
    r, rm, _ = chamfer.grid_sort(yf, my, res, 2)
    return q, qm, r, rm


def check_c2_case(knn, label, q, qm, r, rm, n_batch, c1_iters: int = 10):
    """Kernel C2 on one (queries, refs) pair: against C1 on every valid
    query; against its plain version (indices and rows staged) and
    `nn_match_plain` (all refs) on C2_SUBSET_TILES whole tiles. All exact.
    Then the times of the index build (with the tile order) and the
    kernel, beside C1 over its own index, the rows staged per tile and the
    pairs they make, the bound by bytes and, for comparison, the staged
    pairs' operations."""
    import torch
    T = knn.QTILE
    Vq, Vr = q.shape[0], r.shape[0]
    dev = q.device
    nt = -(-Vq // T)
    index = knn.build_tile_index(r, rm, n_batch)
    order = knn.tile_order(q, qm, index)
    idx, staged = knn.nn_tiles(q, qm, index, order)
    if not torch.equal(idx, knn.nn_match_tiled(q, qm, r, rm, n_batch)):
        raise AssertionError(f"C2 ({label}): the entry point differs")
    c1 = knn.nn_match(q, r, rm, n_batch)
    if not torch.equal(idx[qm], c1[qm]):
        raise AssertionError(f"C2 ({label}) differs from C1 on "
                             f"{int((idx != c1)[qm].sum())} valid queries")
    # whole tiles, drawn with a fixed seed (not the ragged last one)
    tiles = torch.randperm(Vq // T, generator=torch.Generator()
                           .manual_seed(17))[:C2_SUBSET_TILES].sort().values
    rows = (order.long()[tiles.to(dev)[:, None] * T
                         + torch.arange(T, device=dev)]).reshape(-1)
    plain, plain_staged = knn.nn_tiles_plain(q, qm, index, order, tiles)
    if not torch.equal(plain_staged, staged[tiles.to(dev)]):
        raise AssertionError(f"C2 ({label}): rows staged differ from its "
                             "plain version")
    scan_all = knn.nn_match_plain(q[rows], r, rm, qm[rows],
                                  block=max(64, PLAIN_PAIRS // Vr))
    for name, ref in (("its plain version", plain[rows]),
                      ("the plain scan of every ref", scan_all)):
        if not torch.equal(idx[rows], ref):
            raise AssertionError(
                f"C2 ({label}) differs from {name} on "
                f"{int((idx[rows] != ref).sum())} of {int(qm[rows].sum())} "
                "valid queries")

    def build():
        ix = knn.build_tile_index(r, rm, n_batch)
        return knn.tile_order(q, qm, ix)
    # on the card (no host read for n_batch >= 1); the whole call also
    # paced by the host, as a lone call runs
    timer = _device_ms if n_batch >= 1 else _time_ms
    index_ms = timer(build, 5)
    ms = timer(lambda: knn.nn_tiles(q, qm, index, order), 10)
    total_ms = timer(lambda: knn.nn_match_tiled(q, qm, r, rm, n_batch), 5)
    host_total_ms = _time_ms(lambda: knn.nn_match_tiled(q, qm, r, rm,
                                                        n_batch), 5)
    c1_index = knn.build_nn_index(r, rm, n_batch)
    c1_index_ms = _time_ms(lambda: knn.build_nn_index(r, rm, n_batch), 3)
    c1_ms = _device_ms(lambda: knn.nn_match(q, r, rm, n_batch, qm, c1_index),
                       c1_iters)
    plain_ms = _time_ms(lambda: knn.nn_tiles_plain(q, qm, index, order,
                                                   tiles), 1)

    nq = int(qm.sum())
    # (query, row) pairs the kernel evaluates: each staged row against the
    # tile's queries of its item, at most the tile's live queries
    live = torch.zeros(nt * T, dtype=torch.bool, device=dev)
    live[:Vq] = qm[order.long()]
    per_tile = live.reshape(nt, T).sum(1)
    pairs = float((staged.double() * per_tile).sum())
    # The bound is the bytes: the queries and their mask, the index and
    # the output, each moved once. For comparison, at 8 operations a pair
    # (3 multiply-adds, a subtract, a compare): the staged pairs (which
    # depend on the design) and those of a full scan.
    nbytes = Vq * (16 + 1 + 4) + Vr * 16 + index.cell_start.shape[0] * 4
    bound, by = _bound_ms(0, PEAK_F32, nbytes)
    staged_bound, _ = _bound_ms(pairs * 8, PEAK_F32, 0)
    scan_bound, _ = _bound_ms(float(nq) * float(rm.sum()) * 8, PEAK_F32, 0)
    g = index.geo.tolist()
    log(f"C2 nn_match_tiled, {label}: {Vq} queries ({nq} valid) x {Vr} refs,"
        f" exact against C1 (all valid queries), its plain version (rows "
        f"staged too) and the plain scan ({rows.shape[0]} queries); index "
        f"cell {g[3]}, grid {g[4:7]}, {g[7]} items; on the card: index and "
        f"tile order {index_ms:.4f} ms, kernel {ms:.4f} ms, both "
        f"{total_ms:.4f} ms ({host_total_ms:.4f} ms paced by the host); "
        f"C1 index {c1_index_ms:.4f} ms (its "
        f"host reads wait for the card), kernel {c1_ms:.4f} ms; "
        f"{float(staged.double().sum()) / nt:.1f} rows staged per tile, "
        f"{pairs / max(nq, 1):.1f} pairs per valid query; bound "
        f"{bound:.4f} ms ({by}); the staged pairs' operations "
        f"{staged_bound:.4f} ms, a full scan's {scan_bound:.4f} ms; plain "
        f"version on the subset {plain_ms:.2f} ms")
    return dict(max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None, index_ms=index_ms,
                with_index_ms=total_ms, host_paced_with_index_ms=host_total_ms,
                c1_ms=c1_ms, c1_index_ms=c1_index_ms,
                pairs_per_query=pairs / max(nq, 1), pairs=pairs,
                scan_pairs=float(nq) * float(rm.sum()),
                staged_bound_ms=staged_bound)


def check_chamfer(dev):
    """The chamfer loss on the card: grid against exact on clouds small
    enough for the exact path, the card against the CPU for both, finite
    gradients to both clouds."""
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
    up to 6e-2 of their size. Two devices are compared on the same piece.
    The fused BatchNorm of a card run takes its ReLU inside its kernels:
    its signs are recorded from its output, and a replaying run must take
    the plain path (a CPU run), whose ReLU is F.relu."""
    import torch
    import torch.nn.functional as F
    from lidiff_tpu_torch.ops import batchnorm, chamfer
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

    fused = batchnorm.MaskedBatchNormFunction

    class RecordedBN:
        @staticmethod
        def apply(*a):
            out = fused.apply(*a)
            if a[6]:                     # relu
                if replay:
                    raise AssertionError("a replaying run took the fused "
                                         "BatchNorm")
                choose(out[0] > 0, "signs")
            return out

    saved = (F.relu, F.leaky_relu, chamfer.nn_indices_grid,
             chamfer.nn_indices)
    F.relu, F.leaky_relu = relu, leaky_relu
    chamfer.nn_indices_grid = picks(saved[2])
    chamfer.nn_indices = picks(saved[3])
    batchnorm.MaskedBatchNormFunction = RecordedBN
    try:
        yield
    finally:
        (F.relu, F.leaky_relu, chamfer.nn_indices_grid,
         chamfer.nn_indices) = saved
        batchnorm.MaskedBatchNormFunction = fused


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
        # without remat: its recompute, in the backward pass, would call
        # the ReLUs again after the choices are restored
        # (compare_remat holds remat to this step without it)
        task = refine.RefineTask(cfg, device=d, compute_dtype=torch.float32,
                                 seed=2, remat=False)
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


def refine_inputs(dev, n_items: int = 1, remat: bool = True):
    """The refiner's config, task (`MinkUNet` with 18 output channels, full
    width, `remat`) and batch: n_items x 180k jittered points against
    n_items x 360k-point targets (item 0 the same at every batch size),
    the capacities n_items times the one-item ones."""
    import numpy as np
    import torch
    from lidiff_tpu_torch import config as cfg_mod
    from lidiff_tpu_torch.models import refine
    n = N_PART * TILE
    # dense clouds without tiled duplicates, as the aggregated dataset
    # gives after its 0.1 m voxel-unique step (copies would put every
    # target point's twin at distance 0 and flatter the match); every level
    # gets the full point count, as the diffusion phases do: no voxel is
    # dropped
    rcfg = batch_cfg(cfg_mod.finalize_config(make_refine_cfg(
        n, 1.0, REFINE_UP, {"capacity_fractions": [1.0] * 5})), n_items)
    task = refine.RefineTask(rcfg, device=dev, compute_dtype=torch.bfloat16,
                             seed=0, remat=remat)
    noisy = torch.from_numpy(np.concatenate(
        [jittered(ring_scan(n, seed=31 + 3 * i), 32 + 3 * i)
         for i in range(n_items)])).to(dev)
    gt = torch.from_numpy(np.concatenate(
        [ring_scan(2 * n, seed=33 + 3 * i) for i in range(n_items)])).to(dev)
    pyr = task.pyramid(noisy)
    ovf = [int(v) for v in pyr.overflows()]
    log(f"refiner at batch {n_items}: capacities "
        f"{rcfg['tpu']['full_capacities']}; voxels per level "
        f"{[int(l.geom.num) for l in pyr.levels]}; overflow {ovf}")
    if any(ovf):
        raise AssertionError("capacity overflow on the refiner's input")
    del pyr
    return rcfg, task, noisy, gt


def chamfer_match_inputs(task, noisy, gt):
    """The two matches of the refiner's grid chamfer on the model's eval
    forward, quantized as `nn_indices_grid` does (the references sorted):
    ((queries, mask, refs, mask) upsampled -> target, the same target ->
    upsampled)."""
    from lidiff_tpu_torch.ops import chamfer
    up = task.upsample(noisy, task.forward(noisy)).reshape(-1, 3)
    res = chamfer._adaptive_res([(up, None), (gt[0], None)])
    x, xm = chamfer.grid_coords(up, None, res, 1)
    y, ym = chamfer.grid_coords(gt[0], None, res, 1)
    xs, _, _ = chamfer.grid_sort(up, None, res, 1)
    ys, _, _ = chamfer.grid_sort(gt[0], None, res, 1)
    return (x, xm, ys, ym), (y, ym, xs, xm)


def phase_c2(steps: int, dev: str):
    """C2 at the refiner's chamfer shape (180k jittered points upsampled to
    1.08M against a 360k-point target), both directions, on the clouds of
    the model's eval forward (`chamfer_match_inputs`), then on a two-item
    batch with invalid rows. Returns ({"C2": its results}, {})."""
    from lidiff_tpu_torch.ops import knn
    _, task, noisy, gt = refine_inputs(dev)
    fwd_in, back_in = chamfer_match_inputs(task, noisy, gt)
    del task, noisy, gt
    fwd = check_c2_case(knn, "chamfer, upsampled -> target", *fwd_in, 1,
                        c1_iters=2)
    back = check_c2_case(knn, "chamfer, target -> upsampled", *back_in, 1,
                         c1_iters=2)
    if dev == "cuda" and any(c["pairs"] >= 0.01 * c["scan_pairs"]
                             for c in (fwd, back)):
        raise AssertionError("C2's tiles stage more than 1% of a full "
                             "scan's pairs at the chamfer's shape")
    del fwd_in, back_in
    check_c2_case(knn, "two items, invalid rows", *batched_match_inputs(dev),
                  2)
    return {"C2": {**fwd, **{k + "_reverse": back[k] for k in (
        "ms", "index_ms", "with_index_ms", "host_paced_with_index_ms",
        "c1_ms", "c1_index_ms", "pairs_per_query")}}}, {}


def phase_refiner(steps: int, dev: str):
    """Refiner training at full width: one step with remat off and on
    compared (`compare_remat`), the steps of each (the remat run last),
    then the steps at the config's batch of REFINE_BATCH (C2 over all its
    items at once). Returns ({}, the remat runs' launches)."""
    import torch
    from lidiff_tpu_torch.models import refine
    kernels = kernel_table()
    n = N_PART * TILE
    rcfg, task, noisy, gt = refine_inputs(dev)
    del task
    batch = {"pcd_noise": noisy, "pcd_full": gt}

    def make_task(remat, dtype=torch.bfloat16):
        return refine.RefineTask(rcfg, device=dev, compute_dtype=dtype,
                                 seed=0, remat=remat)

    compare_remat(lambda r: make_task(r, torch.float32), batch, {},
                  "refiner training")
    log(f"refiner training: {n} points -> {n * REFINE_UP} upsampled against "
        f"a {2 * n}-point target, batch 1, bf16 compute with float32 "
        f"activations, lr 1e-4")
    for remat in (False, True):
        task = make_task(remat)
        launches = refine_steps(
            task, rcfg, batch, kernels, dev,
            "refiner training" + ("" if remat else ", remat off"), remat)
        del task
    del batch, noisy, gt
    m = REFINE_BATCH
    rcfg, task, noisy, gt = refine_inputs(dev, m)
    log(f"refiner training at batch {m}: {m} x {n} points -> {m} x "
        f"{n * REFINE_UP} upsampled against {m} x {2 * n}-point targets, "
        f"remat on")
    return {}, {"refiner training": launches,
                f"refiner training at batch {m}": refine_steps(
                    task, rcfg, {"pcd_noise": noisy, "pcd_full": gt},
                    kernels, dev, f"refiner training at batch {m}", True)}


def refine_steps(task, rcfg, batch, kernels, dev, what: str, remat: bool):
    """`train_steps` of the refiner, with the launches per step that its
    convs give: every column conv but the first (its input needs no
    gradient) has a feats gradient, and with remat A1 runs once more for
    each stage conv and TG's forward for each transpose conv; one pyramid
    of 5 levels; one match per direction."""
    from lidiff_tpu_torch.models.blocks import SparseConv
    convs = sum(1 for m in task.model.modules()
                if isinstance(m, SparseConv) and m.kernel.shape[0] == 27)
    extra = stage_convs(task.model) if remat else 0
    ups = up_convs(task.model)
    bns, staged = bn_sites(task.model)
    return train_steps(
        task, rcfg, batch, None, kernels, dev, what, "cd_loss",
        {"A3": convs, "A2": convs - 1, "A1": 2 * convs - 1 + extra,
         "B1": 5, "C2": 2, "C1": 0, "TG": ups * (2 if remat else 1),
         "TG bwd": ups, "BN": bns + (staged if remat else 0),
         "BN bwd": bns},
        lambda m: f"cd_loss {float(m['cd_loss']):.4f}")


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

def check_f1(dev):
    """Kernel F1 (farthest-point sampling) against `fps_plain` on the
    device, index for index: 18k picks of a PIPE_SCAN-point ring scan (the
    pipeline's shape), k >= N, a cloud of duplicated points (ties: after
    its distinct points every distance is 0 and each pick is index 0), an
    N that is not a multiple of the block, a few points, slices too large
    for shared memory and the 8-block cluster; at 18k of
    PIPE_SCAN also against the host C++ copy. Times F1 (CUDA events
    around back-to-back calls, and queued behind a spin kernel),
    `fps_plain` and the host C++ copy; the bound and the latency of the
    k - 1 dependent rounds."""
    import numpy as np
    import torch
    from lidiff_tpu_torch.native import fps_native
    from lidiff_tpu_torch.ops import fps as F
    ring = ring_scan(PIPE_SCAN, seed=41)[0]
    dup = np.tile(ring_scan(2_000, seed=5)[0], (3, 1))
    big = ring_scan(300_000, seed=43)[0]
    # (name, points, k, the largest cluster to try): a block's slice stays
    # in shared memory up to about 14.5k points; beyond (300k over 16
    # blocks, 140k over 8) F1 reads the points from global memory. 8 takes
    # the cluster F1 falls back to where 16 blocks do not fit.
    cases = [("18k of a ring scan", ring, N_PART, 16),
             ("k >= N", ring[:1000], 1000, 16),
             ("k > N", ring[:1000], 1500, 16),
             ("duplicated points", dup, 2_500, 16),
             ("N = 100,003", ring[:100_003], 700, 16),
             ("N = 37", ring[:37], 5, 16), ("k = 1", ring[:500], 1, 16),
             ("N = 0", ring[:0], 4, 16),
             ("N = 300,000, slices in global memory", big, 500, 16),
             ("8 blocks, N = 100,003", ring[:100_003], 700, 8),
             ("8 blocks, N = 140,000, slices in global memory",
              big[:140_000], 500, 8)]
    for name, pts, k, cluster in cases:
        t = torch.from_numpy(np.ascontiguousarray(pts)).to(dev)
        got = F.fps_cuda(t, k, max_cluster=cluster)
        want = F.fps_plain(t, k)
        if k < len(pts) and F._fps_kernel.cluster != cluster:
            raise AssertionError(f"F1 ({name}) took a cluster of "
                                 f"{F._fps_kernel.cluster}, not {cluster}")
        if not torch.equal(got, want):
            bad = int((got != want).sum()) if got.shape == want.shape else -1
            raise AssertionError(f"F1 differs from fps_plain ({name}): {bad} "
                                 "picks")
    t = torch.from_numpy(ring).to(dev)
    got = F.fps_cuda(t, N_PART).cpu().numpy()
    fps_native(ring[:8], 2)                   # the host library's build
    t0 = time.perf_counter()
    host = fps_native(ring, N_PART)
    host_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(got, host):
        raise AssertionError(f"F1 differs from the host C++ copy: "
                             f"{int((got != host).sum())} picks")
    ms = _time_ms(lambda: F.fps_cuda(t, N_PART), 3)
    dev_ms = _device_ms(lambda: F.fps_cuda(t, N_PART), 3)
    plain_ms = _time_ms(lambda: F.fps_plain(t, N_PART), 1)
    n, k = PIPE_SCAN, N_PART
    bound, by = _bound_ms(9 * n * (k - 1), PEAK_F32, 12 * n + 8 * k)
    pick_us = ms / (k - 1) * 1e3
    log(f"F1 fps: equal to fps_plain in {len(cases)} cases and to the host "
        f"C++ copy at {k} of {n}; a cluster of {F._fps_kernel.cluster} "
        f"blocks; {ms:.3f} ms by events ({pick_us:.2f} us a pick), "
        f"{dev_ms:.3f} ms on the card, plain {plain_ms:.1f} ms, host C++ "
        f"{host_ms:.1f} ms, bound {bound:.4f} ms ({by})")
    return dict(max_abs_err=0, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                host_cpp_ms=host_ms, bound_ms=bound, bound_by=by,
                library_ms=None)


def run_pipeline(cfg, kernels, steps: int, dev):
    """`DiffCompletion.complete_scan` at full width: random-init diffusion
    and refiner checkpoints saved as the trainers save them, a PIPE_SCAN-
    point synthetic ring scan as .bin; bf16, then int8 on the bf16 run's
    crop and FPS (the same scan's). Launches, refined = diff x up_factor,
    the bf16 run's .ply files with normals; then the metrics of
    `eval_path` against a synthetic ground truth. Both runs ask for bf16
    by `compute_dtype` (the checkpoints' `tpu.compute_dtype` is not read)
    and check that both tasks got it. Returns the int8 run's launches."""
    import numpy as np
    import torch
    from lidiff_tpu_torch import config as cfg_mod
    from lidiff_tpu_torch.models import diffusion, refine
    from lidiff_tpu_torch.tools import diff_completion_pipeline as pipe
    from lidiff_tpu_torch.training.trainer import CheckpointManager
    from lidiff_tpu_torch.utils import histogram_metrics, metrics
    n = N_PART * TILE
    rcfg = cfg_mod.finalize_config(make_refine_cfg(
        n, cfg["model"]["cr"], REFINE_UP, {"capacity_fractions": [1.0] * 5}))
    gt = ring_scan(2 * n, seed=42)[0]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        exps = {}
        for name, task in (
                ("diff_net", diffusion.DiffusionTask(cfg, device=dev)),
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
                                     compute_dtype=torch.bfloat16,
                                     conv_quant=quant)
            if not (dc.task.compute_dtype is torch.bfloat16
                    and dc.refine_task.compute_dtype is torch.bfloat16):
                raise AssertionError(f"pipeline {what}: not bf16")
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
            refined, diff = dc.complete_scan(points)
            launches = {k: v.launches for k, v in kernels.items()}
            if not quant:
                out_dir = os.path.join(tmp, "out")
                for sub in ("refine", "diff"):
                    os.makedirs(os.path.join(out_dir, sub))
                pipe.write_outputs(out_dir, "000000.bin", refined, diff)
            log(f"pipeline {what}, {len(points)}-point scan, {steps} steps"
                f"{', crop + FPS reused from the bf16 run' if quant else ''}"
                f": {len(diff)} diff points -> {len(refined)} refined; "
                f"launches {launches}, of them in refine {refine_counts}")
            if not (0 < len(diff) <= n
                    and len(refined) == REFINE_UP * len(diff)
                    and np.isfinite(refined).all()):
                raise AssertionError(f"pipeline {what}: refined count or "
                                     "values wrong")
            if dev == "cuda" and quant and not (
                    refine_counts["A4"] > 0 and refine_counts["B1"] == 5):
                raise AssertionError("pipeline int8: the refiner did not "
                                     "run A4 and B1")
            # TG's forward once per transpose conv of each denoiser call
            # and of the refiner, no backward
            ups = up_convs(dc.refine_task.model)
            if dev == "cuda" and not (
                    refine_counts["TG"] == ups and launches["TG bwd"] == 0
                    and launches["TG"] == up_convs(dc.task.model) * steps
                    + ups):
                raise AssertionError(f"pipeline {what}: TG launches "
                                     f"{launches['TG']}, {launches['TG bwd']}"
                                     f" backward, {refine_counts['TG']} in "
                                     f"refine")
            out[what] = (refined, launches)
            del dc
        # ---- 15. complete_scans over two replicas on the one card ----
        scans = [scan, ring_scan(PIPE_SCAN, seed=43)[0]]
        check_complete_scans(pipe, exps, scans, steps, dev)
        check_cli_devices(pipe, exps, scans, steps, dev, tmp)
    pred = out["int8"][0]
    cd, rmse, iou = metrics.ChamferDistance(), metrics.RMSE(), \
        metrics.CompletionIoU()
    pr = metrics.PrecisionRecall(0.05, 0.10, 100)
    for m in (cd, rmse, pr, iou):
        m.update(gt, pred)
    vals = {"CD": cd.compute()[0], "RMSE": rmse.compute()[0],
            "PR-AUC F1": pr.compute_auc()[2],
            "IoU 0.5/0.2/0.1": tuple(iou.compute().values()),
            "JSD 3D": histogram_metrics.compute_hist_metrics(gt, pred,
                                                            bev=False),
            "JSD BEV": histogram_metrics.compute_hist_metrics(gt, pred,
                                                             bev=True)}
    log("pipeline metrics, int8 refined cloud against a "
        f"{len(gt)}-point synthetic ground truth: "
        + "; ".join(f"{k} {v}" for k, v in vals.items()))
    flat = [x for v in vals.values()
            for x in (v if isinstance(v, tuple) else (v,))]
    if not all(math.isfinite(x) for x in flat):
        raise AssertionError("pipeline metrics are not finite")
    # F1 runs in the bf16 run (the int8 run reuses its crop and FPS)
    return {**out["int8"][1], "F1": out["bf16"][1]["F1"]}


def check_complete_scans(pipe, exps, scans, steps: int, dev) -> None:
    """`DiffCompletion.complete_scans(devices=[dev, dev])`: two replicas of
    the bf16 pipeline on the one card, one scan each, at once. Each output
    (diff and refined) against `complete_scan` of a pipeline whose
    generator is that replica's (`mesh.rank_generator(42, j)`), run twice:
    the replica's output against each run and the two runs against each
    other are three sound readings, each within SCANS_NN_TOL and
    SCANS_COUNT_TOL. The control, the replica's output against
    `complete_scan` of the same scan with the other replica's generator,
    must lie beyond SCANS_NN_TOL: the limit tells a swapped or shared
    generator from the atomics' noise. Every pipeline and replica computes
    in bf16."""
    import numpy as np
    import torch
    from scipy.spatial import cKDTree
    from lidiff_tpu_torch.parallel import mesh

    def make(replica=None):
        p = pipe.DiffCompletion(exps["diff_net"], exps["refine_net"],
                                steps, 6.0, seed=42, device=dev,
                                compute_dtype=torch.bfloat16)
        if replica is not None:
            p.generator = mesh.rank_generator(42, replica, dev)
        return p

    def nn_dist(a, b):
        return max(float(cKDTree(b).query(a)[0].mean()),
                   float(cKDTree(a).query(b)[0].mean()))

    dc = make()
    got = dc.complete_scans(scans, devices=[dev, dev])
    if {r.task.compute_dtype for rs in dc._replicas.values()
            for r in rs} != {torch.bfloat16}:
        raise AssertionError("complete_scans' replicas are not bf16")
    sound, control = [], []
    for j, scan in enumerate(scans):
        own = [make(j).complete_scan(scan) for _ in range(2)]
        other = make(1 - j).complete_scan(scan)
        for w, what in enumerate(("refined", "diff")):
            a = got[j][w]
            pairs = [(a, own[0][w]), (a, own[1][w]), (own[0][w], own[1][w])]
            nns = [nn_dist(x, y) for x, y in pairs]
            counts = [abs(len(x) - len(y)) / max(len(y), 1)
                      for x, y in pairs]
            sound += list(zip(nns, counts))
            control.append(nn_dist(a, other[w]))
            same = a.shape == own[0][w].shape and np.array_equal(a,
                                                                 own[0][w])
            log(f"complete_scans, replica {j} ({what}): {len(a)} points, "
                f"{'equal' if same else 'not equal'} to complete_scan; mean "
                f"nearest-neighbour distance to its two runs and between "
                f"them {', '.join(f'{v:.6f}' for v in nns)} m, relative "
                f"counts {', '.join(f'{c:.2e}' for c in counts)}; with the "
                f"other replica's generator {control[-1]:.6f} m")
    log(f"complete_scans: 2 scans over 2 replicas on one card; sound "
        f"readings at most "
        f"{max(n for n, _ in sound):.6f} m, the control at least "
        f"{min(control):.6f} m, limit {SCANS_NN_TOL} m")
    if not all(nn <= SCANS_NN_TOL and c <= SCANS_COUNT_TOL
               for nn, c in sound):
        raise AssertionError("complete_scans' replicas differ from "
                             "complete_scan with their generators")
    if min(control) <= SCANS_NN_TOL:
        raise AssertionError("a replica's output lies within SCANS_NN_TOL "
                             "of complete_scan with the other replica's "
                             "generator: the limit does not tell them apart")


@contextlib.contextmanager
def pipeline_cli(pipe, env: dict, devices=None):
    """Around calls of the pipeline CLI's `main`: `env` set in the
    environment, every `DiffCompletion` it builds recorded in the list
    yielded, and `_devices` giving `devices` where they are given; all put
    back afterwards."""
    built = []
    cls, devs = pipe.DiffCompletion, pipe._devices

    class Recorded(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    old = {k: os.environ.get(k) for k in env}
    pipe.DiffCompletion = Recorded
    if devices is not None:
        pipe._devices = lambda dc: list(devices)
    os.environ.update(env)
    try:
        yield built
    finally:
        pipe.DiffCompletion, pipe._devices = cls, devs
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def check_cli_devices(pipe, exps, scans, steps: int, dev, tmp: str) -> None:
    """The pipeline CLI's multi-card branch on the one card: `main` over
    two .bin scans with `_devices` giving [dev, dev] and
    LIDIFF_COMPUTE_DTYPE=bfloat16: one "s/scan" line per scan, both scans'
    .ply outputs with refined = diff x REFINE_UP, and the pipeline and its
    two replicas in bf16."""
    import numpy as np
    import torch
    from lidiff_tpu_torch.utils.ply import read_ply
    scan_dir, out = os.path.join(tmp, "cli_scans"), os.path.join(tmp, "cli")
    os.makedirs(scan_dir)
    names = [f"{i:06d}.bin" for i in range(len(scans))]
    for name, s in zip(names, scans):
        np.concatenate([s, np.ones((len(s), 1), np.float32)], 1).tofile(
            os.path.join(scan_dir, name))
    said = io.StringIO()
    with pipeline_cli(pipe, {"LIDIFF_COMPUTE_DTYPE": "bfloat16"},
                      [dev, dev]) as built, contextlib.redirect_stdout(said):
        pipe.main(["-d", exps["diff_net"], "-r", exps["refine_net"], "-T",
                   str(steps), "-s", "6.0", "-p", scan_dir, "-o", out]
                  + (["--device", "cpu"] if dev == "cpu" else []))
    lines = [l for l in said.getvalue().splitlines() if "s/scan" in l]
    dc = built[0]
    tasks = [dc.task, dc.refine_task] + [
        t for rs in dc._replicas.values() for r in rs
        for t in (r.task, r.refine_task)]
    exp = os.path.join(out, f"diff_net_T{steps}_s6.0")
    counts = []
    for name in names:
        stem = name.split(".")[0]
        counts.append(tuple(
            len(read_ply(os.path.join(exp, sub, f"{stem}.ply"))["points"])
            for sub in ("diff", "refine")))
    log(f"pipeline CLI over [{dev}, {dev}] (LIDIFF_COMPUTE_DTYPE=bfloat16): "
        f"{lines}; (diff, refined) "
        f"points {counts}; {len(tasks)} tasks in "
        f"{sorted({str(t.compute_dtype) for t in tasks})}")
    if len(lines) != len(names) or len(tasks) != 6 or any(
            t.compute_dtype is not torch.bfloat16 for t in tasks):
        raise AssertionError("the pipeline CLI did not complete each scan "
                             "in bf16 over two replicas")
    if not all(0 < d and r == REFINE_UP * d for d, r in counts):
        raise AssertionError("the pipeline CLI over two replicas wrote "
                             "wrong .ply files")


def run_eval_clis(dev: str, tree: str, kernels) -> None:
    """The evaluation CLIs on the small tree `tree`, after the train and
    train_refine CLI phases: `map_from_scans`, the pipeline on both
    trained checkpoints with LIDIFF_CONV_QUANT=int8, and `eval_path` on its
    .ply files (-p) and live (-d, -r); then the pipeline once more with
    LIDIFF_COMPUTE_DTYPE=bfloat16, whose tasks must compute in bf16."""
    import numpy as np
    import torch
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
            with pipeline_cli(pipe, {}) as built:
                pipe.main(["-d", diff_exp, "-r", refine_exp, "-T", "2", "-s",
                           "6.0", "-p", os.path.join(seq_dir, "velodyne"),
                           "-o", out] + dev_args)
            int8_dtype = built[0].task.compute_dtype
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
    out_bf16 = os.path.join(tree, "results_bf16")
    with pipeline_cli(pipe, {"LIDIFF_COMPUTE_DTYPE": "bfloat16"}) as built, \
            contextlib.redirect_stdout(said):
        pipe.main(["-d", diff_exp, "-r", refine_exp, "-T", "2", "-s", "6.0",
                   "-p", os.path.join(seq_dir, "velodyne"), "-o", out_bf16]
                  + dev_args)
    dtypes = (built[0].task.compute_dtype, built[0].refine_task.compute_dtype)
    n_bf16 = len([f for f in os.listdir(os.path.join(
        out_bf16, "chip-smoke-cli_T2_s6.0", "refine")) if f.endswith(".ply")])
    log(f"pipeline CLI: with LIDIFF_CONV_QUANT=int8 alone in {int8_dtype}; "
        f"with LIDIFF_COMPUTE_DTYPE=bfloat16 the diffusion and refine tasks "
        f"in {dtypes[0]}, {dtypes[1]}, {n_bf16} refined .ply files")
    if n_bf16 != 4 or any(d is not torch.bfloat16 for d in dtypes):
        raise AssertionError("the pipeline CLI did not take its compute "
                             "dtype from LIDIFF_COMPUTE_DTYPE")


def phase_ptv3(steps: int, dev: str):
    """On the `ptv3.train` cell's first batch: kernel serial_codes, xCPE's
    convs, the training steps. Returns ({kernel: result} for the kernels
    line, {"ptv3 training": the steps' launches})."""
    import torch
    from benchmark import harness
    from benchmark.drivers import seg_train
    from lidiff_tpu_torch.models import ptv3
    from lidiff_tpu_torch.ops import grid, serialize
    from lidiff_tpu_torch.ops import sparse_conv as sc
    run = harness.make_run("ptv3.train", 18, 0.0, False, time.perf_counter())
    cfg = seg_train._config(run)
    batch = seg_train._batches(run, cfg, run.traffic, dev)[0][0]
    task = ptv3.SegTask(cfg, device=dev, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        pyr = task.pyramid(batch)
        levels, _ = task.levels(pyr, task.counts(
            pyr, batch["offset"].shape[0]))
    log(f"PTv3: {batch['offset'].shape[0]} elements, voxels per level "
        f"{[lvl.n for lvl in levels]}")
    # level 0's four codes: kernel serial_codes against the bit loops
    rows = levels[0].geom.geom.coords[:levels[0].n]
    depth = int(rows[:, 1:].max() + max(grid.GRID_SHIFT)).bit_length()
    codes = serialize.level_codes(rows, grid.GRID_SHIFT, depth)
    if not torch.equal(codes.cpu(), serialize.level_codes(
            rows.cpu(), grid.GRID_SHIFT, depth)):
        raise AssertionError("PTv3: kernel serial_codes differs from the "
                             "bit loops at level 0")
    ms = _time_ms(lambda: serialize.level_codes(rows, grid.GRID_SHIFT,
                                                depth))
    xyz = rows[:, 1:].long() + torch.tensor(grid.GRID_SHIFT, device=dev)
    plain_ms = _time_ms(lambda: [serialize.encode(xyz, rows[:, 0], depth, o)
                                 for o in serialize.ORDERS], 3)
    bound, by = _bound_ms(0, PEAK_BF16, rows.shape[0] * (16 + 32))
    log(f"PTv3: serial_codes = the bit loops at level 0 ({rows.shape[0]} "
        f"rows, depth {depth}), {ms:.4f} ms (bound {bound:.4f}, {by}; the "
        f"bit loops {plain_ms:.4f})")
    res = {"SC": dict(max_abs_err=0, ms=ms, plain_ms=plain_ms,
                      bound_ms=bound, bound_by=by, library_ms=None)}
    gen = torch.Generator(device=dev).manual_seed(18)
    for cin, cout, li in PTV3_WIDTHS:
        lvl = levels[li]
        km, mask, n = lvl.kmap, lvl.mask, lvl.n
        f = torch.randn(n, cin, generator=gen, device=dev).to(
            torch.bfloat16).requires_grad_()
        w = (torch.randn(27, cin, cout, generator=gen, device=dev)
             / math.sqrt(27 * cin)).to(torch.bfloat16).requires_grad_()
        b = (0.1 * torch.randn(cout, generator=gen,
                               device=dev)).requires_grad_()
        cot = torch.randn(n, cout, generator=gen, device=dev)
        maps = (km.col_idx, km.hit)
        kw = dict(out_dtype=torch.float32, nvalid=km.nvalid, plan=km.plan())
        out = sc.conv3_columns(f, *maps, w, mask, 1, bias=b, **kw)
        df, dw, db = torch.autograd.grad(out, (f, w, b), cot)
        fd, wd, bd = f.detach(), w.detach(), b.detach()
        ref = sc.conv3_columns_plain(fd, *maps, wd, mask, 1, bias=bd).float()
        cot_m = torch.where(mask[:, None], cot, 0.0)
        w_rev = wd.flip(0).transpose(1, 2).contiguous()
        df_ref = sc.conv3_columns_plain(cot_m.to(torch.bfloat16), *maps,
                                        w_rev, mask, 1).float()
        dw_ref = sc.conv3_columns_dw_plain(fd, cot_m.to(torch.bfloat16),
                                           *maps, mask, 1)
        db_ref = cot_m.double().sum(0)
        errs = {}
        for name, got, want in (("A1", out.detach(), ref),
                                ("A2", df.float(), df_ref)):
            err = (got - want).abs()
            scale = float(want.abs().max())
            errs[name] = float(err.max())
            if not bool((err <= A1_BF16_RTOL * want.abs()
                         + A1_BF16_ATOL * scale).all()):
                raise AssertionError(
                    f"PTv3 {name} ({cin},{cout}) L{li}: max err "
                    f"{errs[name]:.3g} at scale {scale:.3g}")
        # dW comes back in the weights' dtype, bf16: one rounding more
        err3 = (dw.float() - dw_ref).abs()
        errs["A3"] = float(err3.max())
        if not bool((err3 <= A3_BF16_TOL * dw_ref.abs().max()
                     + BF16_U * dw_ref.abs()).all()):
            raise AssertionError(f"PTv3 A3 ({cin},{cout}) L{li}: max err "
                                 f"{errs['A3']:.3g}")
        err_b = (db.double() - db_ref).abs()
        if not bool((err_b <= PTV3_DB_TOL * cot_m.abs().sum(0)).all()):
            raise AssertionError(f"PTv3 bias gradient ({cin},{cout}) L{li}:"
                                 f" max err {float(err_b.max()):.3g}")
        hits = int(km.hit[:n][mask].sum())
        flops = 2.0 * hits * cin * cout
        kmap_bytes = n * (9 * 4 + 27 + 1)
        fx = fd.requires_grad_()
        o2 = sc.conv3_columns(fx, *maps, wd, mask, 1, **kw)
        g_bf = cot_m.to(torch.bfloat16)
        times = {
            "A1": _time_ms(lambda: sc.conv3_columns(fd, *maps, wd, mask, 1,
                                                    bias=bd, **kw)),
            "A2": _time_ms(lambda: torch.autograd.grad(o2, fx, cot,
                                                       retain_graph=True)),
            "A3": _time_ms(lambda: sc.conv3_columns_dw(
                fd, g_bf, *maps, mask, 1, nvalid=km.nvalid,
                plan=km.plan()))}
        nbytes = {"A1": n * cin * 2 + kmap_bytes + 27 * cin * cout * 2
                  + cout * 4 + n * cout * 4,
                  "A2": n * cout * 4 + kmap_bytes + 27 * cin * cout * 2
                  + n * cin * 2,
                  "A3": n * cin * 2 + n * cout * 2 + kmap_bytes
                  + 27 * cin * cout * 4}
        for k in ("A1", "A2", "A3"):
            bound, by = _bound_ms(flops, PEAK_BF16, nbytes[k])
            res[f"{k} xCPE"] = dict(max_abs_err=errs[k], ms=times[k],
                                    plain_ms=None, bound_ms=bound,
                                    bound_by=by, library_ms=None)
        log(f"PTv3 xCPE ({cin},{cout}) L{li} n={n} bf16, "
            f"{hits / n:.2f} hit taps/voxel: A1 with bias max err "
            f"{errs['A1']:.3g}, A2 {errs['A2']:.3g}, A3 {errs['A3']:.3g}, "
            f"bias gradient {float(err_b.max()):.3g}; A1 {times['A1']:.4f} "
            f"ms, A2 {times['A2']:.4f}, A3 {times['A3']:.4f} (bound "
            f"{res['A1 xCPE']['bound_ms']:.4f} each, {flops / 1e9:.1f} "
            f"GFLOP over hit taps)")
        del f, w, b, out, df, dw, db, ref, df_ref, dw_ref, o2, fx
    del pyr, levels
    torch.cuda.empty_cache()
    # A3 launches once per DW_MAX_CO output channels of a conv
    a3 = sum(-(-b.cpe.conv_kernel.shape[2] // sc.DW_MAX_CO)
             for b in task.model.blocks())
    bns = bn_sites(task.model)[0]       # no remat: each BatchNorm once
    want = {"A1": 2 * PTV3_BLOCKS, "A2": PTV3_BLOCKS, "A3": a3, "SC": 1,
            "BN": bns, "BN bwd": bns}
    launches = train_steps(
        task, cfg, batch, torch.Generator(device=dev).manual_seed(19),
        kernel_table(), dev, "PTv3 training", "loss", want,
        lambda m: f"loss {float(m['loss']):.4f}")
    return res, {"ptv3 training": {
        (k if k in ("SC", "BN", "BN bwd") else f"{k} xCPE"): launches[k]
        for k in want}}


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


def phase_tg(steps: int, dev: str):
    return check_transpose_gather(dev), {}


def phase_bn(steps: int, dev: str):
    return check_masked_bn(dev), {}


def phase_gate(steps: int, dev: str):
    res = {"GA": check_gate_apply(dev)}
    check_gate_denoise(steps, dev)
    return res, {}


def phase_fps(steps: int, dev: str):
    return {"F1": check_f1(dev)}, {}


# name: fn(steps, dev) -> ({kernel: result for the kernels line},
# {path: launches}), in the order a whole run takes them
PHASES = {"kernels": phase_kernels, "tg": phase_tg, "bn": phase_bn,
          "gate": phase_gate, "fps": phase_fps, "parity": phase_parity,
          "sampling": phase_sampling, "training": phase_training,
          "ddp": phase_ddp, "c2": phase_c2, "refiner": phase_refiner,
          "pipeline": phase_pipeline, "clis": phase_clis,
          "ptv3": phase_ptv3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=4,
                    help="solver steps of the completion (default 4)")
    ap.add_argument("--phase", choices=list(PHASES), default=None,
                    help="build the kernels and run this phase alone")
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

    t0 = time.time()
    reports = native.build_all()
    log(f"build: {len(reports)} kernel libraries in {time.time() - t0:.1f} s")
    for name, rep in reports.items():
        log_ptxas(name, rep)

    res, paths = {}, {}
    kernels = kernel_table()
    for name in [args.phase] if args.phase else PHASES:
        t0 = time.time()
        for k in kernels.values():
            k.launches = 0
        r, p = PHASES[name](args.steps, "cuda")
        res.update(r)
        paths.update(p)
        # a phase's own launches: what the kernels line reports where the
        # path a kernel's count is from did not run
        paths.setdefault(name, {n: k.launches for n, k in kernels.items()})
        log(f"phase {name}: {time.time() - t0:.1f} s")
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
        "C2": ("nn_match_tiled", "lidiff_tpu/ops/pallas_knn.py:403",
               "refiner training"),
        "A4": ("conv3_columns_q",
               "lidiff_tpu/ops/pallas_conv.py:840 (quant=True)",
               "int8 sampling"),
        "F1": ("fps",
               "lidiff_tpu/native/src/lidiff_native.cpp:54 (lidiff_fps, "
               "host C++)", "pipeline"),
        "TG": ("transpose_gather",
               "none: XLA's gather, lidiff_tpu/ops/sparse_conv.py:377-431",
               "refiner training"),
        "TG bwd": ("transpose_gather",
                   "none: XLA's transpose of that gather",
                   "refiner training"),
        "A1 xCPE": ("conv3_columns", "lidiff_tpu/ops/pallas_conv.py:840",
                    "ptv3 training"),
        "A2 xCPE": ("conv3_columns", "lidiff_tpu/ops/pallas_conv.py:667",
                    "ptv3 training"),
        "A3 xCPE": ("conv3_columns_dw", "lidiff_tpu/ops/pallas_conv.py:568",
                    "ptv3 training"),
        "SC": ("serial_codes", "none: the JAX package has no PTv3",
               "ptv3 training"),
        "BN": ("masked_bn",
               "none: XLA's fusion, lidiff_tpu/models/blocks.py:67-100",
               "refiner training"),
        "BN bwd": ("masked_bn", "none: XLA's fusion of its transpose",
                   "refiner training"),
        "GA": ("gate_apply",
               "none: XLA's per-voxel gate MLPs, "
               "lidiff_tpu/models/minkunet.py:83-122", "sampling")}
    def launches(path: str) -> dict:
        return paths[path if path in paths else args.phase]

    if "B1" in res:
        # the plan's taps: a second entry point of B1's source
        res["B1"]["taps_launches"] = launches("sampling")["B1 taps"]
    for path, names in (
            ("sampling", ("A1", "B1", "B1 taps", "C1", "TG", "GA")),
            ("sampling unfused", ("A1", "B1", "B1 taps", "C1", "TG", "GA")),
            ("int8 sampling", ("A1", "A4", "B1", "B1 taps", "C1", "TG",
                               "GA")),
            ("gather form", ("A1", "B1")),
            ("training", ("A1", "A2", "A3", "B1", "B1 taps", "C1", "TG",
                          "TG bwd", "BN", "BN bwd")),
            (f"training at batch {DIFF_BATCH}",
             ("A1", "A2", "A3", "B1", "B1 taps", "C1", "TG", "TG bwd", "BN",
              "BN bwd")),
            ("refiner training", ("A1", "A2", "A3", "B1", "B1 taps", "C2",
                                  "TG", "TG bwd", "BN", "BN bwd")),
            (f"refiner training at batch {REFINE_BATCH}",
             ("A1", "A2", "A3", "B1", "B1 taps", "C2", "TG", "TG bwd", "BN",
              "BN bwd")),
            ("pipeline", ("A4", "B1", "B1 taps", "C1", "F1", "TG", "GA")),
            ("ptv3 training", ("A1 xCPE", "A2 xCPE", "A3 xCPE", "SC", "BN",
                               "BN bwd")),
            ("tg", ("TG", "TG bwd")), ("bn", ("BN", "BN bwd")),
            ("gate", ("GA",)),
            ("fps", ("F1",))):
        if path not in paths:
            continue
        for n in names:
            if paths[path][n] == 0:
                raise AssertionError(f"kernel {n} was not launched on the "
                                     f"{path} path")
    line = {"kernels": [
        {"name": f"{n} {src}", "route": "cuda",
         "source": f"lidiff_tpu_torch/csrc/{src}.cu", "replaces": rep,
         "launches": launches(path)[n], **res[n]}
        for n, (src, rep, path) in sources.items() if n in res]}
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
