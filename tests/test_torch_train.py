"""The port's training harness on the CPU: `q_sample` and Adam with the
stepped schedule against the JAX package (optax chain of
`lidiff_tpu.training.trainer.make_optimizer`), then `Trainer` and the
`lidiff_tpu_torch.train` CLI on a synthetic KITTI tree.

Tolerances: `q_sample` rtol 1e-6 (one float32 multiply-add); Adam
parameters after each of 12 steps on given gradients rtol 1e-5, atol 1e-4
of the learning rate (an update is about one learning rate; both sides do
the same float32 arithmetic in another operation order, optax's bias
corrections in float32 and torch's in float64, and the differences of the
12 steps add up). The optimizer is
held to optax on given gradients, and the loss and gradients to
`jax.value_and_grad` in tests/test_torch_train_model.py, separately: Adam
turns a sign flip of a near-zero gradient into a 2 * lr difference, so
parameters after end-to-end steps are not compared."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidiff_tpu.diffusion import ddpm as jddpm
from lidiff_tpu.training import trainer as jtrainer
from lidiff_tpu_torch import train as train_mod
from lidiff_tpu_torch.config import finalize_config, load_config
from lidiff_tpu_torch.data.datasets import dataloaders
from lidiff_tpu_torch.diffusion import ddpm as tddpm
from lidiff_tpu_torch.models.diffusion import DiffusionTask
from lidiff_tpu_torch.training.trainer import (CheckpointManager, Trainer,
                                               make_optimizer)
from tests.helpers import make_kitti_tree

NF = 512


def _cfg(data_dir, exp_id="torch_train", **train):
    return {
        "experiment": {"id": exp_id},
        "data": {"data_dir": data_dir, "resolution": 0.1,
                 "dataloader": "KITTI", "split": "train", "train": ["00"],
                 "validation": ["00"], "test": [], "num_points": NF,
                 "max_range": 50.0, "dataset_norm": False,
                 "std_axis_norm": False},
        "train": {"uncond_prob": 0.1, "uncond_w": 6.0, "n_gpus": 1,
                  "num_workers": 1, "max_epoch": 2, "lr": 1e-3,
                  "batch_size": 2, "decay_lr": 1e-4, **train},
        "diff": {"beta_start": 3.5e-5, "beta_end": 0.007,
                 "beta_func": "linear", "t_steps": 50, "s_steps": 2,
                 "reg_weight": 5.0},
        "model": {"out_dim": 96, "cr": 0.25},
        "tpu": {"full_capacities": [NF, 256, 256, 256, 256],
                "part_capacities": [64, 64, 64, 64, 64], "remat": False},
    }


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    make_kitti_tree(root, "00", n_scans=4, n_points=1500)
    return root


def test_q_sample():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 40, 3)).astype(np.float32)
    noise = rng.normal(size=x.shape).astype(np.float32)
    t = np.array([0, 57, 99])
    jc = jddpm.make_ddpm("linear", 100, 3.5e-5, 0.007)
    tc = tddpm.make_ddpm("linear", 100, 3.5e-5, 0.007)
    ref = jddpm.q_sample(jc, jnp.asarray(x), jnp.asarray(t),
                         jnp.asarray(noise))
    got = tddpm.q_sample(tc, torch.from_numpy(x), torch.from_numpy(t),
                         torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


def test_lr_schedule():
    p = [torch.nn.Parameter(torch.zeros(2))]
    opt, sched, schedule = make_optimizer(p, 1e-4, decay_every_epochs=5,
                                          steps_per_epoch=10)
    assert schedule(0) == pytest.approx(1e-4)
    assert schedule(49) == pytest.approx(1e-4)      # epoch 4
    assert schedule(50) == pytest.approx(5e-5)      # epoch 5
    assert schedule(100) == pytest.approx(2.5e-5)   # epoch 10
    # the scheduler object follows the same function, stepped per step
    for step in range(52):
        assert opt.param_groups[0]["lr"] == pytest.approx(schedule(step))
        opt.step()
        sched.step()


def test_adam_and_schedule_match_optax():
    """12 steps on given gradients, 2 steps per epoch: the decay boundary
    of epoch 5 falls at step 10."""
    import jax
    rng = np.random.default_rng(1)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 3, 5)}
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-4, 2))
              .astype(np.float32) for k, s in shapes.items()}
             for _ in range(12)]
    lr = 1e-2
    jopt, jsched = jtrainer.make_optimizer(lr, steps_per_epoch=2)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jopt.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in init.items()}
    topt, tsched, schedule = make_optimizer(tparams.values(), lr,
                                            steps_per_epoch=2)
    for step, g in enumerate(grads):
        assert schedule(step) == pytest.approx(float(jsched(step)))
        updates, jstate = jopt.update(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                         updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        topt.step()
        tsched.step()
        for k in shapes:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jparams[k]), rtol=1e-5,
                                       atol=1e-4 * lr,
                                       err_msg=f"{k} step {step}")
    assert schedule(9) == pytest.approx(lr)
    assert schedule(10) == pytest.approx(lr / 2)


def test_trainer_steps_and_checkpoint(tree, tmp_path):
    cfg = finalize_config(_cfg(tree))
    task = DiffusionTask(cfg, device="cpu", seed=1)
    data = dataloaders["KITTI"](cfg)
    exp = str(tmp_path / "exp")
    trainer = Trainer(task, cfg, exp, steps_per_epoch=2)
    gen = torch.Generator().manual_seed(1)
    before = {k: v.clone() for k, v in task.model.state_dict().items()}
    losses = []
    for i, batch in enumerate(data.train_dataloader()):
        if i >= 2:
            break
        batch = {k: torch.from_numpy(v) for k, v in batch.items()
                 if k != "filename"}
        assert batch["pcd_full"].shape == (2, NF, 3)
        assert batch["pcd_part"].shape == (2, NF // 10, 3)
        metrics = trainer.train_step(batch, gen)
        losses.append(float(metrics["loss"]))
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert trainer.global_step == 2
    after = task.model.state_dict()
    assert not any(torch.equal(before[k], after[k]) for k in before)
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in task.model.parameters())

    trainer.save(0)
    state, step = trainer.ckpt.restore()
    assert step == 2 and state["epoch"] == 0 and state["step"] == 2
    k0 = next(iter(after))
    assert torch.equal(state["model"][k0], after[k0])
    assert trainer.ckpt.load_hparams()["experiment"]["id"] == "torch_train"

    # a fresh trainer restores model, optimizer, scheduler, step and epoch
    task2 = DiffusionTask(cfg, device="cpu", seed=2)
    trainer2 = Trainer(task2, cfg, exp, steps_per_epoch=2)
    assert trainer2.maybe_restore()
    assert trainer2.global_step == 2 and trainer2.last_epoch == 0
    assert all(torch.equal(v, after[k])
               for k, v in task2.model.state_dict().items())
    s1 = trainer.optimizer.state_dict()["state"]
    s2 = trainer2.optimizer.state_dict()["state"]
    assert all(torch.equal(s1[i]["exp_avg"], s2[i]["exp_avg"]) for i in s1)
    assert trainer2.scheduler.last_epoch == 2


def test_checkpoint_manager_keeps_all_and_restores_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "c"))
    assert mgr.restore() == (None, None) and mgr.load_hparams() is None
    for step in (3, 12, 7):
        mgr.save(step, {"x": torch.full((2,), float(step)), "step": step})
    assert mgr.latest_step() == 12
    state, step = mgr.restore()
    assert step == 12 and float(state["x"][0]) == 12.0
    state, step = mgr.restore(3)
    assert step == 3 and float(state["x"][0]) == 3.0
    assert len([f for f in os.listdir(mgr.dir) if f.endswith(".pt")]) == 3


def test_trainer_refuses_multi_gpu(tree, tmp_path):
    cfg = finalize_config(_cfg(tree, n_gpus=2))
    task = DiffusionTask(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        Trainer(task, cfg, str(tmp_path / "exp"))


def test_train_cli_steps_then_resume(tree, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(_cfg(tree, "cli_diff", batch_size=1, lr=1e-4), f)
    assert load_config(cfg_path)["tpu"]["num_levels"] == 5

    train_mod.main(["-c", cfg_path, "--max_steps", "2", "--device", "cpu"])
    exp = tmp_path / "experiments" / "cli_diff"
    assert (exp / "hparams.json").is_file()
    ckpts = exp / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["hparams.json", "step_00000002.pt"]

    # resume from the experiment dir: restores step 2 (epoch 0), trains
    # one more step in epoch 1
    train_mod.main(["-c", cfg_path, "-ckpt", str(exp), "--max_steps", "3",
                    "--device", "cpu"])
    assert "step_00000003.pt" in os.listdir(ckpts)
    state = torch.load(ckpts / "step_00000003.pt", weights_only=True)
    assert state["step"] == 3 and state["epoch"] == 1
    assert "TRAINING MODE (cpu)" in capsys.readouterr().out


def test_train_cli_test_mode_is_not_ported(tree, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(_cfg(tree, "cli_test"), f)
    with pytest.raises(NotImplementedError, match="item 8"):
        train_mod.main(["-c", cfg_path, "--test", "--device", "cpu"])
