"""The port's refiner against the JAX package on the CPU: `MinkUNet` in eval
and train mode, `RefineTask.loss_fn` against
`jax.value_and_grad(rtask.loss_fn, has_aux=True)`, one `Trainer.train_step`
against optax Adam, and the `lidiff_tpu_torch.train_refine` CLI on a
synthetic KITTI tree.

The JAX model rematerializes its stages in training (`MinkUNet`'s
default); the port's loss is compared without remat and with it (the
stages under activation checkpointing). Both sides run float32 at a
quarter of the width (`cr` 0.25; the JAX task
always builds the full-width model, so the test hands it a narrow one),
`up_factor` 2, two items of 384 points against 768-point targets, weights
carried across by `convert.load_jax_variables`.

Tolerances, as tests/test_torch_train_model.py (sums of about 60 layers
forward and backward run in other orders; train-mode BatchNorm over the few
dozen voxels of the coarse levels divides by small variances): forward
outputs atol 2e-4 (they are tanh values, at most 1); loss rtol 1e-4; a
gradient leaf within 2e-3 of that leaf's max|grad| plus 1e-4 of the largest
max|grad| of the tree; running statistics rtol/atol 1e-4. After one Adam
step an update is lr * g / (|g| + eps): within 2% of the learning rate
where the JAX gradient is not tiny, and within 2 lr (a sign flip of a
near-zero gradient) everywhere."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidiff_tpu.config import finalize_config as jax_finalize
from lidiff_tpu.models.minkunet import MinkUNet as JaxMinkUNet
from lidiff_tpu.models.refine import RefineTask as JaxRefineTask
from lidiff_tpu.training import trainer as jtrainer
from lidiff_tpu_torch import train_refine
from lidiff_tpu_torch.config import finalize_config
from lidiff_tpu_torch.convert import load_jax_variables, state_dict_to_flax
from lidiff_tpu_torch.models.refine import RefineTask
from lidiff_tpu_torch.training.trainer import Trainer
from tests.helpers import make_kitti_tree
from tests.test_torch_train_model import _leaves
from tests.torch_parity_helpers import random_variables, ring_scan, to_jax

B, N, UP = 2, 384, 2
CR = 0.25
LR = 1e-3
CFG = {
    "experiment": {"id": "torch-refine-parity"},
    "data": {"data_dir": "", "resolution": 0.25, "num_points": N},
    "train": {"up_factor": UP, "lr": LR, "n_gpus": 1, "batch_size": B},
    "model": {"out_dim": 96, "cr": CR},
    # B x N points: every level holds both items
    "tpu": {"full_capacities": [B * N] * 3 + [512, 384]},
}
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-4


@pytest.fixture(scope="module")
def setup():
    jt = JaxRefineTask(jax_finalize(CFG))
    jt.model = JaxMinkUNet(out_channels=3 * UP, cr=CR)
    assert jt.model.remat
    variables = random_variables(jt, seed=7, n_points=256)
    tt = RefineTask(finalize_config(CFG), device="cpu", remat=False)
    rng = np.random.default_rng(3)
    clean = ring_scan(rng, N, batch=B)
    noisy = (clean + np.clip(rng.normal(0, 0.2, clean.shape), -0.3, 0.3)
             ).astype(np.float32)
    gt = np.concatenate([clean, ring_scan(rng, N, batch=B)], 1)
    return jt, variables, tt, noisy, gt


@pytest.fixture(scope="module")
def jax_step(setup):
    """The JAX side's loss, new batch_stats and gradients, computed once."""
    jt, variables, _, noisy, gt = setup
    jv = to_jax(variables)
    batch = {"pcd_noise": jnp.asarray(noisy), "pcd_full": jnp.asarray(gt)}
    (loss, (stats, metrics)), grads = jax.jit(jax.value_and_grad(
        jt.loss_fn, has_aux=True))(jv["params"], jv["batch_stats"], batch)
    return float(loss), stats, metrics, grads


@pytest.mark.parametrize("train", [False, True])
def test_minkunet_forward_matches_jax(setup, train):
    jt, variables, tt, noisy, _ = setup
    jv = to_jax(variables)
    pts = jnp.asarray(noisy)
    # jitted: one compile in place of an op-by-op one
    if train:
        ref, _ = jax.jit(lambda v, p: jt.forward(
            v, p, train=True, mutable=["batch_stats"]))(jv, pts)
    else:
        ref = jax.jit(jt.forward)(jv, pts)
    load_jax_variables(tt.model, variables)
    if train:
        tt.model.train()
        with torch.no_grad():
            got = tt._offsets(torch.from_numpy(noisy))
        tt.model.eval()
    else:
        got = tt.forward(torch.from_numpy(noisy))
        assert not tt.model.training and not got.requires_grad
    assert tuple(got.shape) == (B, N, UP, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)
    up = tt.upsample(torch.from_numpy(noisy), got)
    np.testing.assert_allclose(
        up.numpy(), np.asarray(jt.upsample(pts, ref)), atol=2e-4)
    assert tuple(up.shape) == (B, N * UP, 3)


def test_loss_fn_matches_jax_value_and_grad(setup, jax_step):
    _check_step(setup, jax_step, setup[2])


def test_remat_loss_fn_matches_jax_value_and_grad(setup, jax_step):
    """The port with remat against the same JAX step, at batch 2 with the
    capacities of both items (no voxel overflows)."""
    tt = RefineTask(finalize_config(CFG), device="cpu", remat=True)
    assert tt.model.remat
    assert not tt.pyramid(torch.from_numpy(setup[3])).overflows().any()
    _check_step(setup, jax_step, tt)


def _check_step(setup, jax_step, tt):
    """One loss and backward pass of the port task `tt` on the JAX side's
    weights and batch, held against the JAX step."""
    _, variables, _, noisy, gt = setup
    j_loss, j_stats, j_metrics, j_grads = jax_step
    load_jax_variables(tt.model, variables)
    tt.model.zero_grad()
    loss, metrics = tt.loss_fn({"pcd_noise": torch.from_numpy(noisy),
                                "pcd_full": torch.from_numpy(gt)})
    loss.backward()
    assert tt.model.training
    np.testing.assert_allclose(float(loss.detach()), j_loss, rtol=1e-4)
    assert set(metrics) == set(j_metrics) == {"cd_loss"}
    np.testing.assert_allclose(float(metrics["cd_loss"]), j_loss, rtol=1e-4)

    grads = state_dict_to_flax({n: p.grad for n, p in
                                tt.model.named_parameters()})["params"]
    got, ref = dict(_leaves(grads)), dict(_leaves(j_grads))
    assert set(got) == set(ref)
    top = max(np.abs(r).max() for r in ref.values())
    assert top > 1e-3
    worst = max((np.abs(got[n] - r).max()
                 / (GRAD_RTOL * np.abs(r).max() + GRAD_ATOL * top), n)
                for n, r in ref.items())
    print(f"worst gradient leaf at {worst[0]:.3f} of its tolerance "
          f"({worst[1]}), max|grad| {top:.3g}")
    assert worst[0] <= 1.0, worst

    stats = state_dict_to_flax(tt.model.state_dict())["batch_stats"]
    got_s, ref_s = dict(_leaves(stats)), dict(_leaves(j_stats))
    assert set(got_s) == set(ref_s)
    old = dict(_leaves(variables["batch_stats"]))
    for name, r in ref_s.items():
        np.testing.assert_allclose(got_s[name], r, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    assert any(not np.allclose(old[n], got_s[n]) for n in old)


def test_train_step_matches_optax_adam(setup, jax_step, tmp_path):
    _, variables, tt, noisy, gt = setup
    _, _, _, j_grads = jax_step
    jopt, _ = jtrainer.make_optimizer(LR)
    jparams = to_jax(variables)["params"]
    updates, _ = jax.jit(lambda g, p: jopt.update(g, jopt.init(p), p))(
        j_grads, jparams)
    ref_u = dict(_leaves(updates))
    ref_g = dict(_leaves(j_grads))

    load_jax_variables(tt.model, variables)
    before = {k: v.clone() for k, v in tt.model.state_dict().items()}
    trainer = Trainer(tt, finalize_config(CFG), str(tmp_path / "exp"))
    metrics = trainer.train_step({"pcd_noise": torch.from_numpy(noisy),
                                  "pcd_full": torch.from_numpy(gt)})
    assert trainer.global_step == 1 and np.isfinite(float(metrics["cd_loss"]))
    after = tt.model.state_dict()
    got_u = dict(_leaves(state_dict_to_flax(
        {k: after[k] - before[k] for k in after})["params"]))
    assert set(got_u) == set(ref_u)
    top = max(np.abs(g).max() for g in ref_g.values())
    for name, r in ref_u.items():
        err = np.abs(got_u[name] - r)
        assert err.max() <= 2.0 * LR * (1 + 1e-3), name
        firm = np.abs(ref_g[name]) > 1e-3 * top
        if firm.any():
            assert err[firm].max() <= 0.02 * LR, name
    assert not any(torch.equal(before[k], after[k]) for k in before)


def _cli_cfg(data_dir):
    return {
        "experiment": {"id": "cli_refine"},
        "data": {"data_dir": data_dir, "resolution": 0.1,
                 "dataloader": "KITTI", "split": "train", "train": ["00"],
                 "validation": ["00"], "test": [], "scan_window": 2,
                 "num_points": 300},
        "train": {"n_gpus": 1, "num_workers": 1, "max_epoch": 2, "lr": 1e-4,
                  "batch_size": 1, "up_factor": UP},
        "model": {"out_dim": 96, "cr": CR},
        "tpu": {"full_capacities": [384, 256, 256, 256, 256]},
    }


def test_train_refine_cli_steps_resume_and_test(tmp_path, monkeypatch,
                                                capsys):
    tree = str(tmp_path / "kitti")
    make_kitti_tree(tree, "00", n_scans=4, n_points=1500)
    monkeypatch.chdir(tmp_path)
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(_cli_cfg(tree), f)

    # 4 scans, window 2: two windows (the tail-merge rule joins the last
    # three scans), so an epoch has two steps
    train_refine.main(["-c", cfg_path, "--max_steps", "2", "--device", "cpu"])
    exp = tmp_path / "experiments" / "cli_refine"
    ckpts = exp / "checkpoints"
    assert (exp / "hparams.json").is_file()
    assert sorted(os.listdir(ckpts)) == ["hparams.json", "step_00000002.pt"]
    out = capsys.readouterr().out
    assert "TRAINING MODE (cpu)" in out
    sanity = [l for l in out.splitlines() if l.startswith("sanity: cd_loss")]
    assert len(sanity) == 1 and "over 1 batches" in sanity[0]
    assert np.isfinite(float(sanity[0].split()[2]))

    train_refine.main(["-c", cfg_path, "-ckpt", str(exp), "--max_steps", "3",
                       "--device", "cpu"])
    state = torch.load(ckpts / "step_00000003.pt", weights_only=True)
    assert state["step"] == 3 and state["epoch"] == 1
    capsys.readouterr()

    train_refine.main(["-c", cfg_path, "-w", str(exp), "--test", "--device",
                       "cpu"])
    out = capsys.readouterr().out
    assert "TESTING MODE" in out
    assert len([l for l in out.splitlines()
                if l.startswith("test cd_loss")]) == 2
    mean = [l for l in out.splitlines() if l.startswith("mean test cd_loss")]
    assert len(mean) == 1 and np.isfinite(float(mean[0].split()[-1]))


def test_refine_task_defaults_to_the_card():
    """Without a card `RefineTask(cfg)` and the CLI raise; they do not fall
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RefineTask(finalize_config(CFG))
