"""Whole runs of each cell on the CPU at a tiny size: a sound run comes out
correct, and each fault the cell can have, planted under the timed path,
makes `correct` come out false. Also the traffic repeats by seed, and a run
reports its occupancy and fails on a dropped voxel."""

import copy
import json
import os

import pytest
import torch

from benchmark import harness, scene
from benchmark.tests.conftest import TINY


def test_completion_sound_run_is_correct(tiny_run):
    out = tiny_run("diff.complete")
    assert out.correct, out.checks
    assert out.attempted == 1 and out.failed == 0
    assert {"scan_s", "setup_s"} <= set(out.e2e)
    assert any("0 voxels dropped" in n for n in out.notes)


def _fps_altered(mp):
    from lidiff_tpu_torch.tools import diff_completion_pipeline as dcp
    orig = dcp.fps

    def fps(points, k):
        picked = orig(points, k).copy()
        picked[k // 2] = picked[k // 2 + 1]
        return picked
    mp.setattr(dcp, "fps", fps)


def _bank_altered(mp):
    from lidiff_tpu_torch.models.diffusion import DiffusionTask
    orig = DiffusionTask.encode_banks

    def encode_banks(self, part):
        banks = orig(self, part)
        return (banks[0] * 1.1,) + tuple(banks[1:])
    mp.setattr(DiffusionTask, "encode_banks", encode_banks)


def _eps_altered(mp):
    from lidiff_tpu_torch.models.diffusion import DiffusionTask
    orig = DiffusionTask.denoise_pair
    mp.setattr(DiffusionTask, "denoise_pair",
               lambda self, *a, **k: orig(self, *a, **k) * 1.1)


def _solver_unchanged(mp):
    from lidiff_tpu_torch.models import diffusion as dmod
    orig = dmod.solver_step

    def solver_step(solver, state, eps, noise):
        out = orig(solver, state, eps, noise)
        return type(out)(sample=state.sample, prev_m=out.prev_m,
                         prev_lambda=out.prev_lambda, step=out.step)
    mp.setattr(dmod, "solver_step", solver_step)


def _refine_altered(mp):
    from lidiff_tpu_torch.models.refine import RefineTask
    orig = RefineTask.forward
    mp.setattr(RefineTask, "forward",
               lambda self, points: orig(self, points) * 1.1)


@pytest.mark.parametrize("plant", [_solver_unchanged, _eps_altered,
                                   _fps_altered, _refine_altered,
                                   _bank_altered],
                         ids=lambda f: f.__name__[1:])
def test_completion_fault_is_caught(tiny_run, monkeypatch, plant):
    """A fault planted in the port, under the timed path."""
    plant(monkeypatch)
    out = tiny_run("diff.complete")
    assert not out.correct


def test_training_sound_run_is_correct(tiny_run):
    out = tiny_run("refine.train")
    assert out.correct, out.checks
    assert {"train_step_ms", "train_peak_gib", "setup_s"} <= set(out.e2e)


def _step_unchanged(mp):
    mp.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)


def _half_batch(mp):
    from lidiff_tpu_torch.models.refine import RefineTask
    orig = RefineTask.loss_fn
    mp.setattr(RefineTask, "loss_fn", lambda self, batch, *a, **k: orig(
        self, {n: v[:v.shape[0] // 2] for n, v in batch.items()}, *a, **k))


def _loss_altered(mp):
    from lidiff_tpu_torch.models.refine import RefineTask
    orig = RefineTask.loss_fn

    def loss_fn(self, *a, **k):
        loss, m = orig(self, *a, **k)
        return loss * 1.1, {**m, "cd_loss": m["cd_loss"] * 1.1}
    mp.setattr(RefineTask, "loss_fn", loss_fn)


def _matches_altered(mp):
    from lidiff_tpu_torch.ops import chamfer
    orig = chamfer.nn_indices_grid

    def nn_indices_grid(*a, **k):
        idx = orig(*a, **k).clone()
        sel = torch.arange(0, idx.numel() - 1, 1000, device=idx.device)
        idx[sel] = idx[sel + 1]
        return idx
    mp.setattr(chamfer, "nn_indices_grid", nn_indices_grid)


@pytest.mark.parametrize("plant", [_step_unchanged, _half_batch,
                                   _loss_altered, _matches_altered],
                         ids=lambda f: f.__name__[1:])
def test_training_fault_is_caught(tiny_run, monkeypatch, plant):
    """A fault planted in the port, under the timed path."""
    plant(monkeypatch)
    out = tiny_run("refine.train")
    assert not out.correct


def test_dropped_voxels_fail_the_run(tiny_run):
    tiny = copy.deepcopy(TINY["diff.complete"])
    tiny["config"]["tpu"]["full_capacities"] = [1280, 1280, 1280, 1280,
                                                256]
    out = tiny_run("diff.complete", overrides=tiny)
    assert dict((n, v) for n, v, _ in out.checks)["dropped_voxels"] > 0
    assert not out.correct


def test_traffic_repeats_by_seed():
    p = json.load(open(os.path.join(harness.HERE, "traffic",
                                    "street_drive.json")))
    p.update(TINY["diff.complete"]["traffic"])
    a, b = (scene.drive_scans(p, 2 ** 31 + 5, "cpu") for _ in range(2))
    c = scene.drive_scans(p, 2 ** 31 + 6, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(x.shape == y.shape and torch.equal(x, y)
                   for x, y in zip(a, c))
    r = json.load(open(os.path.join(harness.HERE, "traffic",
                                    "aggregated_windows.json")))
    r.update(TINY["refine.train"]["traffic"])
    i1, i2 = (scene.refine_items(r, 9, "cpu") for _ in range(2))
    assert torch.equal(i1["pcd_noise"], i2["pcd_noise"])
    assert i1["pcd_full"].shape == (6, 600, 3)
