"""End-to-end scan completion (counterpart of
lidiff_tpu/tools/diff_completion_pipeline.py, argparse in place of click).

    python -m lidiff_tpu_torch.tools.diff_completion_pipeline -d DIFF_EXP
        -r REFINE_EXP -T 50 -s 6.0 -p SCANS -o OUT [--max_scans N]
        [--device cpu]

Loads the diffusion and refinement checkpoints that the port's trainers write
(`hparams.json` and `checkpoints/step_<n>.pt`), then for each scan of SCANS
(.bin, .ply or .npy): range crop on the host and FPS to num_points / 10 (kernel
F1 on the card), tile 10x, classifier-free DPM-Solver sampling, range and
z-window crop, refinement offsets (up_factor points per point), and .ply
outputs with normals under OUT/<exp>/{diff,refine}/, plus
OUT/<exp>/exp_config.yaml.
It runs on the card unless `--device cpu` is given; with more than one card
and more than one scan it completes the scans in groups, one scan per card
at a time (`complete_scans`), and prints the time per scan of each group.
LIDIFF_COMPUTE_DTYPE=bf16 (or bfloat16) computes in bfloat16 (default
float32; the checkpoint's `tpu.compute_dtype` is not read),
LIDIFF_CONV_QUANT=int8 runs every eval column conv with Cin >= 32 as the
int8 conv (kernel A4), and the sampler runs LIDIFF_SAMPLE_CHUNK solver
steps a chunk (default 10), as the JAX pipeline does.
`complete_scan` returns (refined, diff), the tuple the JAX package's
eval_path fix expects.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from lidiff_tpu_torch.config import (compute_dtype_from_env,
                                     conv_quant_from_env, finalize_config,
                                     save_config)
from lidiff_tpu_torch.models.diffusion import DiffusionTask
from lidiff_tpu_torch.models.refine import RefineTask
from lidiff_tpu_torch.ops.fps import fps, fps_cuda
from lidiff_tpu_torch.parallel import mesh
from lidiff_tpu_torch.training.trainer import CheckpointManager
from lidiff_tpu_torch.utils import ply, prof
from lidiff_tpu_torch.utils.natsort import natsorted


def load_pcd(path: str) -> np.ndarray:
    if path.endswith(".bin"):
        return np.fromfile(path, dtype=np.float32).reshape(-1, 4)[:, :3]
    if path.endswith(".ply"):
        return ply.read_ply(path)["points"]
    if path.endswith(".npy"):
        return np.load(path)[:, :3].astype(np.float32)
    raise ValueError(f"unsupported point cloud format: {path}")


def _ckpt_dir(path: str) -> str:
    """Accept either the checkpoints/ dir or the experiment dir."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory {path}")
    if os.path.isdir(os.path.join(path, "checkpoints")):
        return os.path.join(path, "checkpoints")
    return path


def _restore(ckpt: CheckpointManager, model, device, what: str) -> None:
    state, _ = ckpt.restore(map_location=device)
    if state is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt.dir} ({what})")
    model.load_state_dict(state["model"])


class DiffCompletion:
    """Loads both checkpoints and serves `complete_scan`.

    Runs on `device` (default: the card) in `compute_dtype` (default: the
    one LIDIFF_COMPUTE_DTYPE names). `conv_quant` selects the int8 eval
    conv for the encoder, the denoiser and the refiner. The sampler runs
    LIDIFF_SAMPLE_CHUNK solver steps a chunk (default 10; the output of a
    scan is the same whatever the chunk). With several devices
    `complete_scans` keeps one replica of both tasks on each, with its own
    generator, and completes the scans in groups, one scan per device at a
    time."""

    def __init__(self, diff_ckpt_dir: str, refine_ckpt_dir: str | None,
                 denoising_steps: int, cond_weight: float, seed: int = 42,
                 device=None, compute_dtype=None, conv_quant: bool = False):
        ckpt = CheckpointManager(_ckpt_dir(diff_ckpt_dir))
        hparams = ckpt.load_hparams()
        if hparams is None:
            raise FileNotFoundError(
                f"no hparams.json next to checkpoint {diff_ckpt_dir}")
        self.cfg = finalize_config(hparams)
        t_steps = int(self.cfg["diff"]["t_steps"])
        if denoising_steps > t_steps:
            raise ValueError(f"denoising steps {denoising_steps} cannot "
                             f"exceed T={t_steps}")
        self.cfg["diff"]["s_steps"] = int(denoising_steps)
        self.cfg["train"]["uncond_w"] = float(cond_weight)
        self.cfg["data"]["max_range"] = 50.0

        self.seed, self.conv_quant = seed, conv_quant
        self.task = DiffusionTask(self.cfg, device=device,
                                  compute_dtype=compute_dtype,
                                  conv_quant=conv_quant)
        self.device = self.task.device
        self.compute_dtype = self.task.compute_dtype
        _restore(ckpt, self.task.model, self.device, "diffusion")

        self.refine_task = None
        if refine_ckpt_dir:
            rckpt = CheckpointManager(_ckpt_dir(refine_ckpt_dir))
            rh = rckpt.load_hparams()
            rcfg = finalize_config(rh) if rh else self.cfg
            self.refine_task = RefineTask(rcfg, device=self.device,
                                          compute_dtype=self.compute_dtype,
                                          conv_quant=conv_quant)
            _restore(rckpt, self.refine_task.model, self.device, "refine")

        self.num_points = int(self.cfg["data"]["num_points"])
        self.n_part = self.num_points // 10
        self.max_range = float(self.cfg["data"]["max_range"])
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._chunk = int(os.environ.get("LIDIFF_SAMPLE_CHUNK", 10))
        self._overflow_checked = False
        self.times: dict[str, float] = {}   # host seconds per stage, last scan
        self._replicas: dict[tuple, list] = {}   # devices -> replicas

    # ---------------- host pre/post ----------------

    def preprocess_scan(self, scan: np.ndarray) -> np.ndarray:
        """Crop (3.5, max_range) on the host, FPS to n_part on the task's
        device (kernel F1 on the card, the host C++ kernel on the CPU), tile
        10x."""
        dist = np.linalg.norm(scan[:, :3], axis=-1)
        scan = np.ascontiguousarray(
            scan[(dist < self.max_range) & (dist > 3.5)][:, :3], np.float32)
        if self.device.type == "cuda":
            idx = fps_cuda(torch.from_numpy(scan).to(self.device),
                           self.n_part)
            scan = scan[idx.cpu().numpy()]
        else:
            scan = fps(scan, self.n_part)
        if len(scan) < self.n_part:            # degenerate tiny scans
            reps = int(np.ceil(self.n_part / max(len(scan), 1)))
            scan = np.tile(scan, (reps, 1))[:self.n_part]
        return np.tile(scan, (10, 1))[None]    # [1, num_points, 3]

    def postprocess_scan(self, completed: np.ndarray,
                         x_init: np.ndarray) -> np.ndarray:
        """Range crop and a z window from the input's statistics."""
        dist = np.linalg.norm(completed, axis=-1)
        out = completed[dist < self.max_range]
        z = x_init[..., 2]
        max_z = z.max()
        min_z = z.mean() - 2 * z.std()
        return out[(out[:, 2] < max_z) & (out[:, 2] > min_z)]

    # ---------------- main entry ----------------

    def complete_scan(self, scan: np.ndarray):
        """Returns (refined [M * up_factor, 3], diff [M, 3]) and records
        the host seconds of each stage in `times`; the device stages end in
        a copy to the host, so their times include the device's work. In a
        trace each stage is the span `lidiff.pipeline.<stage>`."""
        t0 = time.perf_counter()
        with prof.annotate("lidiff.pipeline.preprocess"):
            x_init = self.preprocess_scan(scan)
            part = np.ascontiguousarray(x_init[:, :self.n_part])
            self._check_overflow(x_init)
        t1 = time.perf_counter()
        with prof.annotate("lidiff.pipeline.sample"):
            completed = self.task.sample_chunked(
                torch.from_numpy(x_init).to(self.device),
                torch.from_numpy(part).to(self.device),
                self.generator, chunk=self._chunk).cpu().numpy()[0]
        t2 = time.perf_counter()
        with prof.annotate("lidiff.pipeline.postprocess"):
            post = self.postprocess_scan(completed, x_init)
        t3 = time.perf_counter()
        with prof.annotate("lidiff.pipeline.refine"):
            refined = post if self.refine_task is None else self.refine(post)
        t4 = time.perf_counter()
        self.times = {"preprocess": t1 - t0, "sample": t2 - t1,
                      "postprocess": t3 - t2, "refine": t4 - t3}
        return refined, post

    def _replica(self, device, index: int) -> "DiffCompletion":
        """This pipeline on `device`: the same configuration and weights,
        and its own generator seeded from (seed, index) (`mesh.rank_seed`;
        replica 0 draws what this pipeline's fresh generator draws)."""
        r = copy.copy(self)
        r.task = DiffusionTask(self.cfg, device=device,
                               compute_dtype=self.compute_dtype,
                               conv_quant=self.conv_quant)
        r.task.model.load_state_dict(self.task.model.state_dict())
        r.device = r.task.device
        if self.refine_task is not None:
            r.refine_task = RefineTask(self.refine_task.cfg, device=r.device,
                                       compute_dtype=self.compute_dtype,
                                       conv_quant=self.conv_quant)
            r.refine_task.model.load_state_dict(
                self.refine_task.model.state_dict())
        r.generator = mesh.rank_generator(self.seed, index, r.device)
        r.times, r._replicas = {}, {}
        return r

    def complete_scans(self, scans: list, devices=None):
        """(refined, diff) for each scan, in input order. With n > 1
        `devices` (default: `_devices`, every card when this pipeline is on
        the card) the scans go in groups of n, scan j of a group to replica
        j, the replicas running at once; the last group is padded with
        copies of its last scan, whose outputs are dropped (lidiff_tpu's
        `complete_scans`). Replica j's outputs equal `complete_scan` of a
        pipeline whose generator is `mesh.rank_generator(seed, j)`, on the
        scans j, j + n, ... and the padding in that order. With one device,
        or one scan, one scan after the other here."""
        devices = [str(torch.device(d))
                   for d in (_devices(self) if devices is None else devices)]
        n = len(devices)
        if n <= 1 or len(scans) <= 1:
            return [self.complete_scan(s) for s in scans]
        key = tuple(devices)
        if key not in self._replicas:
            self._replicas[key] = [self._replica(d, i)
                                   for i, d in enumerate(devices)]
        replicas = self._replicas[key]

        def run(rep, scan):
            ctx = (torch.cuda.device(rep.device) if rep.device.type == "cuda"
                   else contextlib.nullcontext())
            with ctx:
                return rep.complete_scan(scan)

        results = []
        with ThreadPoolExecutor(n) as pool:
            for i0 in range(0, len(scans), n):
                group = list(scans[i0:i0 + n])
                pad = n - len(group)
                group += [group[-1]] * pad
                futures = [pool.submit(run, rep, s)
                           for rep, s in zip(replicas, group)]
                outs = [f.result() for f in futures]
                results.extend(outs[:n - pad])
        return results

    def complete_scan_diff(self, scan: np.ndarray) -> np.ndarray:
        """The single output eval harnesses take: the refined cloud."""
        refined, _ = self.complete_scan(scan)
        return refined

    def _check_overflow(self, x_init: np.ndarray) -> None:
        """Warn (once) when this scan's geometry exceeds the static voxel
        capacities at the t ~ T noise regime: dropped voxels silently
        degrade completion quality."""
        if self._overflow_checked:
            return
        self._overflow_checked = True
        gen = torch.Generator(device=self.device).manual_seed(9)
        x = torch.from_numpy(x_init).to(self.device)
        pyr = self.task.pyramid_full(
            x + torch.randn(x.shape, generator=gen, device=self.device))
        ov = [int(v) for v in pyr.overflows()]
        if any(ov):
            print(f"WARNING: voxel-capacity overflow {ov} on this scan: "
                  "completions will silently drop geometry; raise "
                  "tpu.full_capacities")

    def refine(self, points: np.ndarray) -> np.ndarray:
        """Tile to the refiner's static size, predict offsets, upsample."""
        n_static = self.num_points
        m = len(points)
        reps = int(np.ceil(n_static / max(m, 1)))
        tiled = np.ascontiguousarray(np.tile(points, (reps, 1))[:n_static])
        offs = self.refine_task.forward(
            torch.from_numpy(tiled[None]).to(self.device))
        offs = offs[0, :m].cpu().numpy()
        up = points[:, None, :] + offs
        return up.reshape(-1, 3)


def _devices(dc: DiffCompletion) -> list[str]:
    """The devices `main` and `complete_scans` spread scans over: every
    card when the pipeline is on the card, else its one device."""
    if dc.device.type == "cuda":
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [str(dc.device)]


def write_outputs(out_dir: str, fname: str, refined: np.ndarray,
                  diff_scan: np.ndarray) -> None:
    """<out_dir>/{refine,diff}/<stem>.ply with PCA normals."""
    stem = fname.split(".")[0]
    for sub, pts in (("refine", refined), ("diff", diff_scan)):
        ply.write_ply(os.path.join(out_dir, sub, f"{stem}.ply"), pts,
                      ply.estimate_normals(pts) if len(pts) else None)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="lidiff_tpu_torch.tools.diff_completion_pipeline",
        description=__doc__.split("\n")[0])
    ap.add_argument("--diff", "-d", type=str, default="checkpoints/diff_net",
                    help="diffusion experiment or checkpoint directory")
    ap.add_argument("--refine", "-r", type=str,
                    default="checkpoints/refine_net",
                    help="refinement experiment or checkpoint directory")
    ap.add_argument("--denoising_steps", "-T", type=int, default=50)
    ap.add_argument("--cond_weight", "-s", type=float, default=6.0)
    ap.add_argument("--path", "-p", type=str, default="./Datasets/test/",
                    help="directory of input scans (.bin/.ply/.npy)")
    ap.add_argument("--out", "-o", type=str, default="./results")
    ap.add_argument("--max_scans", type=int, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="'cpu' for the plain PyTorch path (default: cuda)")
    return ap


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    exp = (os.path.basename(os.path.normpath(args.diff)).replace("=", "")
           + f"_T{args.denoising_steps}_s{args.cond_weight}")
    dc = DiffCompletion(args.diff, args.refine, args.denoising_steps,
                        args.cond_weight, device=args.device,
                        compute_dtype=compute_dtype_from_env(),
                        conv_quant=conv_quant_from_env())
    out_dir = os.path.join(args.out, exp)
    os.makedirs(os.path.join(out_dir, "refine"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "diff"), exist_ok=True)
    save_config(dc.cfg, os.path.join(out_dir, "exp_config.yaml"))

    files = [f for f in natsorted(os.listdir(args.path))
             if f.endswith((".bin", ".ply", ".npy"))]
    if args.max_scans:
        files = files[:args.max_scans]
    devices = _devices(dc)
    n = len(devices)
    if n > 1 and len(files) > 1:
        # one scan per device at a time, as lidiff_tpu's main
        for i0 in range(0, len(files), n):
            group = files[i0:i0 + n]
            scans = [load_pcd(os.path.join(args.path, f)) for f in group]
            start = time.time()
            results = dc.complete_scans(scans, devices)
            dt = time.time() - start
            for fname, (refined, diff_scan) in zip(group, results):
                print(f"{fname}: {dt / len(group):.3f}s/scan "
                      f"({len(diff_scan)} diff pts, {len(refined)} refined "
                      f"pts)")
                write_outputs(out_dir, fname, refined, diff_scan)
        return
    for fname in files:
        points = load_pcd(os.path.join(args.path, fname))
        start = time.time()
        refined, diff_scan = dc.complete_scan(points)
        print(f"{fname}: {time.time() - start:.3f}s ({len(diff_scan)} diff "
              f"pts, {len(refined)} refined pts)")
        write_outputs(out_dir, fname, refined, diff_scan)


if __name__ == "__main__":
    main()
