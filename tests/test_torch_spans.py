"""The port's spans (`lidiff_tpu_torch.utils.prof.annotate` and
`annotate_backward`) on the CPU, at a quarter of the width (`cr` 0.25):

  * a two-step `DiffusionTask.sample` under `prof.trace` records one
    `lidiff.sample.step` a step, each holding its denoiser pass, its solver
    update and a pyramid build;
  * a refiner `Trainer.train_step` with remat records the chamfer in the
    forward pass, and the recompute and both gathers' backward nodes
    within `loss.backward()` (on the CPU autograd runs the backward on the
    caller's thread: the card's autograd thread is seen only on a card);
  * with the profiler off, `annotate` hands back one shared no-op context
    and `annotate_backward` registers no hook, and the loss and every
    gradient are the same bits with the profiler on and off.
"""

import tempfile
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from lidiff_tpu_torch.config import finalize_config
from lidiff_tpu_torch.diffusion.dpm_solver import make_dpm_solver
from lidiff_tpu_torch.models.diffusion import DiffusionTask
from lidiff_tpu_torch.models.refine import RefineTask
from lidiff_tpu_torch.training.trainer import Trainer
from lidiff_tpu_torch.utils import prof

B, NP, TILE, N_REF = 2, 64, 8, 384
DIFF_CFG = {
    "experiment": {"id": "torch-spans"},
    "data": {"data_dir": "", "resolution": 0.25, "num_points": NP * TILE,
             "max_range": 50.0},
    "train": {"uncond_prob": 0.1, "uncond_w": 6.0},
    "diff": {"beta_start": 3.5e-5, "beta_end": 0.007, "beta_func": "linear",
             "t_steps": 100, "s_steps": 2, "reg_weight": 5.0},
    "model": {"out_dim": 96, "cr": 0.25},
    "tpu": {"full_capacities": [1024, 1024, 1024, 768, 512],
            "part_capacities": [256, 256, 256, 256, 256]},
}
REFINE_CFG = {
    "experiment": {"id": "torch-spans-refine"},
    "data": {"data_dir": "", "resolution": 0.25, "num_points": N_REF},
    "train": {"up_factor": 2, "lr": 1e-3, "n_gpus": 1, "batch_size": B},
    "model": {"out_dim": 96, "cr": 0.25},
    "tpu": {"full_capacities": [B * N_REF] * 3 + [512, 384]},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small tensor ops, which a thread pool
    slows down when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan(rng, n: int) -> np.ndarray:
    """[B, n, 3] points on rings, as a LiDAR sweep lays them."""
    az = rng.uniform(0, 2 * np.pi, (B, n))
    el = rng.choice(np.linspace(-0.4, 0.05, 16), (B, n))
    r = rng.uniform(1.5, 12.0, (B, n))
    return np.stack([r * np.cos(az) * np.cos(el), r * np.sin(az) * np.cos(el),
                     r * np.sin(el)], -1).astype(np.float32)


def _host(p, name: str) -> list:
    """(start, end) ns of the host events `name` of profile `p`, read from
    the profiler's raw results (`p.events()` would build an object for
    each of the ~100k operator events first)."""
    return sorted((e.start_ns(), e.end_ns())
                  for e in p.profiler.kineto_results.events()
                  if e.name() == name
                  and e.device_type() == torch.autograd.DeviceType.CPU)


def _within(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _refine_batch():
    rng = np.random.default_rng(3)
    clean = _scan(rng, N_REF)
    noisy = clean + np.clip(rng.normal(0, 0.2, clean.shape), -0.3, 0.3)
    gt = np.concatenate([clean, _scan(rng, N_REF)], 1)
    return {"pcd_noise": torch.from_numpy(noisy.astype(np.float32)),
            "pcd_full": torch.from_numpy(gt)}


def _refine_task():
    return RefineTask(finalize_config(REFINE_CFG), device="cpu", seed=7,
                      compute_dtype=torch.float32, remat=True)


def test_sampler_steps_hold_denoise_solver_and_pyramid():
    task = DiffusionTask(finalize_config(DIFF_CFG), device="cpu", seed=5,
                         compute_dtype=torch.float32)
    rng = np.random.default_rng(8)
    part = torch.from_numpy(_scan(rng, NP))
    x_init = part.repeat(1, TILE, 1)
    gen = torch.Generator().manual_seed(1)
    solver = make_dpm_solver("linear", 100, 2, 3.5e-5, 0.007)
    with prof.trace() as p:
        out = task.sample(x_init, part, gen, solver=solver)
    assert out.shape == x_init.shape and torch.isfinite(out).all()
    steps = _host(p, "lidiff.sample.step")
    assert len(steps) == 2
    for name in ("lidiff.sample.denoise", "lidiff.sample.solver",
                 "lidiff.geom.pyramid"):
        inner = _host(p, name)
        for step in steps:
            assert any(_within(x, step) for x in inner), (name, step)
    # the encoder's two pyramids lie outside the steps
    outside = [x for x in _host(p, "lidiff.geom.pyramid")
               if not any(_within(x, s) for s in steps)]
    assert len(outside) == 2


def test_train_step_spans_lie_in_backward(monkeypatch):
    task = _refine_task()
    trainer = Trainer(task, REFINE_CFG, tempfile.mkdtemp())
    backward = torch.Tensor.backward

    def timed_backward(self, *a, **kw):
        with torch.profiler.record_function("test.backward"):
            return backward(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "backward", timed_backward)
    with prof.trace() as p:
        m = trainer.train_step(_refine_batch())
    assert torch.isfinite(m["cd_loss"])
    (bwd,) = _host(p, "test.backward")
    (chamfer,) = _host(p, "lidiff.train.chamfer")
    assert chamfer[1] <= bwd[0]
    # the refiner runs 8 stages under remat; 4 up stages gather their
    # parents' rows, and the head gathers once from the voxels
    for name, n in (("lidiff.model.recompute", 8),
                    ("lidiff.grad.transpose_gather", 4),
                    ("lidiff.grad.slice_to_points", 1)):
        got = _host(p, name)
        assert len(got) == n, (name, got)
        assert all(_within(x, bwd) for x in got), name
    # each stage's recompute runs before its gather's backward node (the
    # gather is the up stage's first op), so no gather span holds one
    for g in _host(p, "lidiff.grad.transpose_gather"):
        assert not any(_within(r, g)
                       for r in _host(p, "lidiff.model.recompute"))


def test_spans_off_register_nothing():
    assert not torch._C._autograd._profiler_enabled()
    off = prof.annotate("lidiff.sample.step", "i=0 t=999")
    assert prof.annotate("lidiff.geom.pyramid") is off
    with off:
        pass
    node = mock.Mock()
    t = SimpleNamespace(grad_fn=node)
    assert prof.annotate_backward(t, "lidiff.grad.transpose_gather") is t
    node.register_prehook.assert_not_called()
    node.register_hook.assert_not_called()
    with prof.trace():
        assert prof.annotate("lidiff.geom.pyramid") is not off
        prof.annotate_backward(t, "lidiff.grad.transpose_gather")
    node.register_prehook.assert_called_once()
    node.register_hook.assert_called_once()


def test_spans_change_no_bits():
    batch = _refine_batch()

    def step(traced: bool):
        task = _refine_task()
        task.model.zero_grad()
        if traced:
            with prof.trace():
                loss, _ = task.loss_fn(batch)
                loss.backward()
        else:
            loss, _ = task.loss_fn(batch)
            loss.backward()
        return loss.detach(), {n: q.grad for n, q in
                               task.model.named_parameters()}

    loss_off, grads_off = step(False)
    loss_on, grads_on = step(True)
    assert torch.equal(loss_on, loss_off)
    assert grads_on.keys() == grads_off.keys()
    for n, g in grads_off.items():
        assert torch.equal(grads_on[n], g), n
