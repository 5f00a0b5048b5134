"""Rematerialization in the port's training (`tpu.remat`, the refiner's
`remat` argument; `lidiff_tpu_torch.models.blocks.remat`), on the CPU at
a quarter of the width (`cr` 0.25), a batch of two, for each model: the
diffusion task (`MinkGlobalEnc` + `MinkUNetDiff`) and the refiner
(`MinkUNet`), on the same seeded weights (BatchNorm statistics included)
and inputs.

  * remat on against remat off: the loss to 1e-6 relative, every gradient
    within 1e-5 of that leaf's max|grad| (the recompute is the same float32
    code on the same inputs, and on the CPU it gives the same bits), the
    BatchNorm running statistics equal (the recompute leaves them alone:
    the momentum is applied once); every `DownStage` and `UpStage` runs its
    forward twice with remat and once without;
  * eval mode runs each stage once, with the same output, whatever `remat`
    says.

The port with remat is held against the JAX package's `loss_fn` (remat
on, its default) at batch 2 in tests/test_torch_train_model.py and
tests/test_torch_refine.py, beside the same step without remat: one JAX
compile serves both.
"""

import numpy as np
import pytest
import torch

from lidiff_tpu_torch.config import finalize_config
from lidiff_tpu_torch.models.blocks import DownStage, MaskedBatchNorm, UpStage
from lidiff_tpu_torch.models.diffusion import DiffusionTask
from lidiff_tpu_torch.models.refine import RefineTask
from tests.torch_parity_helpers import B, CFG, NP, TILE, ring_scan

REMAT_LOSS_RTOL, REMAT_GRAD_TOL = 1e-6, 1e-5
N_REF, UP = 384, 2
REFINE_CFG = {
    "experiment": {"id": "torch-remat-refine"},
    "data": {"data_dir": "", "resolution": 0.25, "num_points": N_REF},
    "train": {"up_factor": UP, "lr": 1e-3, "n_gpus": 1, "batch_size": B},
    "model": {"out_dim": 96, "cr": 0.25},
    # B x N_REF points: every level holds both items
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


@pytest.fixture(scope="module")
def inputs():
    """Per model: the batch and the draws, as numpy arrays."""
    rng = np.random.default_rng(8)
    part = ring_scan(rng, NP)
    full = (np.tile(part, (1, TILE, 1))
            + rng.normal(0, 0.05, (B, NP * TILE, 3))).astype(np.float32)
    draws = {"noise": rng.normal(size=full.shape).astype(np.float32),
             "t": rng.integers(0, CFG["diff"]["t_steps"], B)}
    rng = np.random.default_rng(3)
    clean = ring_scan(rng, N_REF)
    noisy = (clean + np.clip(rng.normal(0, 0.2, clean.shape), -0.3, 0.3)
             ).astype(np.float32)
    gt = np.concatenate([clean, ring_scan(rng, N_REF)], 1)
    return {"diffusion": ({"pcd_full": full, "pcd_part": part}, draws),
            "refine": ({"pcd_noise": noisy, "pcd_full": gt}, {})}


def _task(kind, remat):
    """The model's task on the CPU, its weights from one seed and its
    BatchNorm parameters and statistics filled with seeded values."""
    if kind == "diffusion":
        cfg = finalize_config({**CFG, "tpu": {**CFG["tpu"], "remat": remat}})
        task = DiffusionTask(cfg, device="cpu", seed=5)
    else:
        task = RefineTask(finalize_config(REFINE_CFG), device="cpu", seed=7,
                          remat=remat)
    rng = np.random.default_rng(2)
    with torch.no_grad():
        for m in task.model.modules():
            if isinstance(m, MaskedBatchNorm):
                n = m.scale.shape
                m.scale.copy_(torch.from_numpy(1.0 + 0.1 * rng.normal(size=n)))
                m.bias.copy_(torch.from_numpy(0.1 * rng.normal(size=n)))
                m.mean.copy_(torch.from_numpy(0.1 * rng.normal(size=n)))
                m.var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n)))
    return task


def _stage_calls(model):
    """A dict that counts each DownStage's and UpStage's forward calls (a
    pre-hook: a recompute may stop before a stage's forward returns)."""
    calls = {}
    for name, m in model.named_modules():
        if isinstance(m, (DownStage, UpStage)):
            calls[name] = 0

            def hook(_m, _a, name=name):
                calls[name] += 1
            m.register_forward_pre_hook(hook)
    return calls


def _port_step(inputs, kind, remat):
    """One loss and backward pass of the port on the model's batch; returns
    the loss, the metrics, the gradients and the running statistics by
    name, each stage's forward calls and the statistics before the step."""
    batch, draws = inputs[kind]
    task = _task(kind, remat)
    before = {n: b.clone() for n, b in task.model.named_buffers()}
    calls = _stage_calls(task.model)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    kw = {k: torch.from_numpy(v) for k, v in draws.items()}
    if kind == "diffusion":
        kw["drop"] = False
    else:
        assert not task.pyramid(tb["pcd_noise"]).overflows().any()
    task.model.zero_grad()
    loss, metrics = task.loss_fn(tb, **kw)
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in task.model.named_parameters()}
    stats = {n: b.numpy() for n, b in task.model.named_buffers()}
    return (float(loss.detach()), {k: float(v) for k, v in metrics.items()},
            grads, stats, calls, before)


@pytest.mark.parametrize("kind", ["diffusion", "refine"])
def test_remat_matches_no_remat(inputs, kind):
    loss_on, metrics_on, grads_on, stats_on, calls_on, _ = _port_step(
        inputs, kind, True)
    loss, metrics, grads, stats, calls, before = _port_step(inputs, kind,
                                                            False)
    n_stages = 12 if kind == "diffusion" else 8
    assert len(calls) == n_stages
    assert all(c == 2 for c in calls_on.values()), calls_on
    assert all(c == 1 for c in calls.values()), calls

    assert abs(loss_on - loss) <= REMAT_LOSS_RTOL * abs(loss)
    for k, v in metrics.items():
        assert abs(metrics_on[k] - v) <= REMAT_LOSS_RTOL * abs(v) + 1e-12, k
    assert set(grads_on) == set(grads)
    for n, g in grads.items():
        assert np.isfinite(g).all(), n
        assert np.abs(grads_on[n] - g).max() <= \
            REMAT_GRAD_TOL * np.abs(g).max(), n
    assert set(stats_on) == set(stats)
    for n, s in stats.items():
        np.testing.assert_array_equal(stats_on[n], s, err_msg=n)
    assert any(not torch.allclose(before[n], torch.from_numpy(stats[n]))
               for n in before)


@pytest.mark.parametrize("kind", ["diffusion", "refine"])
def test_eval_mode_does_not_remat(inputs, kind):
    """In eval mode (under no_grad, as the sampling and eval entry points
    run it: the eval convs have no gradient) each stage runs once, and the
    output is the one without remat."""
    batch, _ = inputs[kind]
    outs = {}
    for remat in (True, False):
        task = _task(kind, remat)
        calls = _stage_calls(task.model)
        task.model.eval()
        with torch.no_grad():
            outs[remat] = _eval_forward(task, kind, batch)
        assert all(c == 1 for c in calls.values()), calls
    assert torch.equal(outs[True], outs[False])


def _eval_forward(task, kind, batch):
    if kind == "diffusion":
        pyr = task.pyramid_part(torch.from_numpy(batch["pcd_part"]))
        feats = task.model.encode_partial(pyr)
        return task.model.denoise(
            task.pyramid_full(torch.from_numpy(batch["pcd_full"])),
            [(feats, pyr.levels[-1].geom)], torch.tensor([10, 60]))
    return task._offsets(torch.from_numpy(batch["pcd_noise"]))
