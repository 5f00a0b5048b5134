"""The frozen reference against the port's plain CPU path, at a tiny size:
the guided denoiser, the encoder banks, the refiner, FPS and one solver
step; and the chamfer rule's cell search against its brute force. The
port runs in float32 on the CPU (its plain PyTorch versions of every
kernel), so the two agree to float32 rounding."""

import copy

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import nets, params, sampling, voxel

N_PART = 120
CR = 0.25


def _cfg():
    from lidiff_tpu_torch.config import finalize_config, load_config
    import os
    import lidiff_tpu_torch
    root = os.path.dirname(lidiff_tpu_torch.__file__)
    cfg = load_config(os.path.join(root, "config", "config.json"))
    cfg = copy.deepcopy(cfg)
    cfg["data"]["num_points"] = N_PART * 10
    cfg["model"]["cr"] = CR
    cfg["tpu"]["full_capacities"] = None
    cfg["tpu"]["part_capacities"] = None
    return finalize_config(cfg)


def _cloud(seed, n=N_PART):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, 3, generator=g) * torch.tensor([8.0, 8.0, 1.5])
            - torch.tensor([4.0, 4.0, 1.0]))


@pytest.fixture(scope="module")
def diffusion():
    from lidiff_tpu_torch.models.diffusion import DiffusionTask
    cfg = _cfg()
    task = DiffusionTask(cfg, device="cpu", compute_dtype=torch.float32)
    W = weights.make(params.diffusion_shapes(96, CR),
                     torch.Generator().manual_seed(3), "cpu")
    task.model.load_state_dict(W)
    return task, W


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_guided_denoiser_matches_port(diffusion):
    task, W = diffusion
    part = _cloud(0)[None]
    x = part.repeat(1, 10, 1) + 0.3 * torch.randn(
        1, N_PART * 10, 3, generator=torch.Generator().manual_seed(1))
    banks = task.encode_banks(part)
    eps = task.denoise_pair(x, *banks, 731)
    res = task.resolution
    pp = voxel.pyramid(part, res)
    bank_c = (pp.levels[-1].coords, nets.encoder(W, pp))
    pz = voxel.pyramid(torch.zeros_like(part), res)
    bank_u = (pz.levels[-1].coords, nets.encoder(W, pz))
    pyr = voxel.pyramid(x, res)
    ec = nets.denoiser(W, pyr, bank_c, 731)
    eu = nets.denoiser(W, pyr, bank_u, 731)
    ref = eu + task.w_uncond * (ec - eu)
    assert _rel(eps, ref) < 1e-5


def test_refiner_matches_port():
    from lidiff_tpu_torch.config import finalize_config
    from lidiff_tpu_torch.models.refine import RefineTask
    cfg = _cfg()
    cfg["train"]["up_factor"] = 6
    task = RefineTask(finalize_config(cfg), device="cpu",
                      compute_dtype=torch.float32)
    W = weights.make(params.refiner_shapes(18, CR),
                     torch.Generator().manual_seed(4), "cpu")
    task.model.load_state_dict(W)
    pts = _cloud(5, N_PART * 10)[None]
    offs = task.forward(pts)
    ref = nets.refiner(W, voxel.pyramid(pts, task.resolution))
    assert _rel(offs.reshape(1, -1, 18), ref) < 1e-5


def test_fps_matches_port():
    from lidiff_tpu_torch.ops.fps import fps_numpy
    pts = _cloud(6, 3000)
    assert torch.equal(sampling.fps(pts, 300),
                       torch.from_numpy(fps_numpy(pts.numpy(), 300)))


def test_solver_step_matches_port():
    from lidiff_tpu_torch.diffusion.dpm_solver import (SolverState,
                                                       make_dpm_solver,
                                                       solver_step)
    sol = make_dpm_solver("linear", 1000, 50, 3.5e-5, 0.007)
    sch = sampling.Schedule(3.5e-5, 0.007, 1000, 50)
    assert np.array_equal(sch.ts, sol.timesteps)
    g = torch.Generator().manual_seed(7)
    x, m, e, z = (torch.randn(500, 3, generator=g) for _ in range(4))
    for i in (0, 7, 49):
        lam_prev = sol.lambda_t[int(sol.timesteps[i - 1])] if i else \
            torch.zeros(())
        st = SolverState(sample=x, prev_m=m, prev_lambda=lam_prev, step=i)
        out = solver_step(sol, st, e, z)
        ref, m0 = sch.step(i, x, m, e, z)
        assert float((out.sample - ref).abs().max()) < 1e-5
        assert float((out.prev_m - m0).abs().max()) < 1e-5


@pytest.mark.parametrize("spread", [0.05, 0.8, "ties"])
def test_chamfer_rule_matches_every_row_as_brute_force(spread):
    """`match_all`, the cell search the training check matches every row
    with, picks what the rule's brute force picks, ties included."""
    from benchmark.reference import training
    g = torch.Generator().manual_seed(5)
    gt = torch.randn(1500, 3, generator=g) * torch.tensor([20.0, 20.0, 1.0])
    up = gt[torch.randint(0, 1500, (2500,), generator=g)]
    up = up + torch.randn(2500, 3, generator=g) * (0.3 if spread == "ties"
                                                   else spread)
    if spread == "ties":
        gt, up = torch.round(gt * 4) / 4, torch.round(up * 4) / 4
    step = training.grid_step(up[None], gt[None])
    for q, t in ((up, gt), (gt, up)):
        assert torch.equal(training.match_all(q, t, step, budget=1 << 14),
                           training.grid_match(q, t, step))
