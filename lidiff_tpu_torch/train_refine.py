"""Refinement-network training CLI (counterpart of
lidiff_tpu/train_refine.py).

Usage: python -m lidiff_tpu_torch.train_refine -c CONFIG
       [-w weights_ckpt_dir] [-ckpt resume_dir] [--test] [--max_steps N]
       [--device cpu]

CONFIG is a `.json` or YAML file with the reference schema. Training runs
on the card unless `--device cpu` is given; train.n_gpus > 1 starts one
process per card, as `lidiff_tpu_torch.train` does. One validation batch runs
before training, 5% of the validation split every five epochs, and `--test`
evaluates the whole split. A validation that fails raises: the JAX CLI
prints the error and trains on. LIDIFF_COMPUTE_DTYPE=bf16 (or bfloat16)
computes the convs in bfloat16 (default float32; the config's
`tpu.compute_dtype` is not read); LIDIFF_CONV_QUANT=int8 runs the eval
forward's convs as the int8 conv (kernel A4); training never quantizes.
"""

from __future__ import annotations

import argparse
import os
import signal
import time

import numpy as np
import torch

from lidiff_tpu_torch.config import (compute_dtype_from_env,
                                     conv_quant_from_env, load_config,
                                     save_config)
from lidiff_tpu_torch.data.datasets import dataloaders_refine
from lidiff_tpu_torch.models.refine import RefineTask
from lidiff_tpu_torch.ops.chamfer import chamfer_distance
from lidiff_tpu_torch.parallel import mesh
from lidiff_tpu_torch.training.trainer import CheckpointManager, Trainer


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="lidiff_tpu_torch.train_refine",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--config", "-c", type=str,
                    default=os.path.join(
                        os.path.dirname(os.path.abspath(__file__)),
                        "config/config_refine.json"))
    ap.add_argument("--weights", "-w", type=str, default=None,
                    help="checkpoint dir to load weights from (no resume)")
    ap.add_argument("--checkpoint", "-ckpt", type=str, default=None,
                    help="experiment dir to resume training from")
    ap.add_argument("--test", "-t", action="store_true")
    ap.add_argument("--max_steps", type=int, default=None,
                    help="cap on total optimizer steps (smoke runs)")
    ap.add_argument("--device", type=str, default=None,
                    help="'cpu' for the plain PyTorch path (default: cuda)")
    return ap


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    cfg = load_config(args.config)
    world = 1 if args.test else mesh.world_size(cfg, args.device)
    mesh.launch(_run, world, args.device, args, cfg)


def _run(rank: int, world: int, group, device, args, cfg) -> None:
    """One rank of the run (the whole run at world 1): rank 0 writes the
    hparams, checkpoints, logs and validations."""
    np.random.seed(42)
    task = RefineTask(cfg, device=device, seed=42,
                      compute_dtype=compute_dtype_from_env(),
                      conv_quant=conv_quant_from_env(), group=group)
    data = dataloaders_refine[cfg["data"]["dataloader"]](cfg)

    exp_dir = os.path.join("experiments", cfg["experiment"]["id"])
    if rank == 0:
        os.makedirs(exp_dir, exist_ok=True)
        save_config(cfg, os.path.join(exp_dir, "hparams.json"))

    loader = data.train_dataloader(rank, world)
    trainer = Trainer(task, cfg, exp_dir, steps_per_epoch=max(len(loader), 1),
                      group=group)

    src = args.checkpoint or args.weights
    if src:
        trainer.ckpt = CheckpointManager(os.path.join(src, "checkpoints"))
        trainer.maybe_restore()
        trainer.ckpt = CheckpointManager(os.path.join(exp_dir, "checkpoints"))
        if args.weights and not args.checkpoint:
            trainer.global_step = 0          # weights-only load

    if args.test:
        print("TESTING MODE")
        run_test(task, data)
        return

    if rank == 0:
        procs = f", {world} processes" if world > 1 else ""
        print(f"TRAINING MODE ({task.device}{procs})")
        old_handlers = {s: signal.getsignal(s)
                        for s in (signal.SIGTERM, signal.SIGINT)}
        trainer.install_signal_checkpointing()
    try:
        _train_loop(trainer, loader, data, cfg, args)
    finally:
        if rank == 0:
            for s, h in old_handlers.items():
                signal.signal(s, h)
    trainer.logger.flush()


def _train_loop(trainer, loader, data, cfg, args) -> None:
    task = trainer.task
    step = trainer.global_step
    # one validation batch before training: a broken validation path shows
    # before hours of training (the reference's num_sanity_val_steps=1)
    if trainer.is_main:
        run_validation(task, data, trainer, step, max_batches=1,
                       tag="sanity")
    # epoch-aware resume, as lidiff_tpu_torch/train.py
    if args.checkpoint and trainer.last_epoch >= 0:
        start_epoch = trainer.last_epoch + 1
    else:
        start_epoch = step // max(trainer.steps_per_epoch, 1)
    max_steps = args.max_steps
    for epoch in range(start_epoch, int(cfg["train"]["max_epoch"])):
        for batch in loader:
            batch = {k: torch.from_numpy(v).to(task.device)
                     for k, v in batch.items() if k != "filename"}
            t0 = time.time()
            metrics = trainer.train_step(batch)
            step += 1
            if step % 10 == 0 and trainer.is_main:
                m = {f"train/{k}": float(v) for k, v in metrics.items()}
                m["train/step_time"] = time.time() - t0
                trainer.logger.log(step, m)
                print(f"epoch {epoch} step {step} "
                      + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
            if max_steps and step >= max_steps:
                break
        trainer.save(epoch)
        # the reference validates every 5 epochs on 5% of the split
        if (epoch + 1) % 5 == 0 and trainer.is_main:
            run_validation(task, data, trainer, step)
        if max_steps and step >= max_steps:
            break


def _eval_losses(task, loader, max_batches: int | None = None):
    """Chamfer loss of the upsampled noisy cloud against the ground truth,
    per batch of `loader`, with the model in eval mode."""
    for i, batch in enumerate(loader):
        if max_batches is not None and i >= max_batches:
            break
        noisy = torch.from_numpy(batch["pcd_noise"]).to(task.device)
        gt = torch.from_numpy(batch["pcd_full"]).to(task.device)
        up = task.upsample(noisy, task.forward(noisy))
        yield float(chamfer_distance(up, gt))


def run_validation(task, data, trainer, step: int,
                   max_batches: int | None = None, tag: str = "val") -> None:
    """Refine validation, logged as val/cd_loss; by default on 5% of the
    validation split (at least one batch)."""
    loader = data.val_dataloader()
    if max_batches is None:
        max_batches = max(1, int(0.05 * len(loader)))
    losses = list(_eval_losses(task, loader, max_batches))
    if losses:
        cd = float(np.mean(losses))
        trainer.logger.log(step, {"val/cd_loss": cd})
        print(f"{tag}: cd_loss {cd:.5f} over {len(losses)} batches")


def run_test(task, data) -> None:
    losses = []
    for loss in _eval_losses(task, data.test_dataloader()):
        losses.append(loss)
        print(f"test cd_loss {loss:.5f}")
    print(f"mean test cd_loss {np.mean(losses):.5f}")


if __name__ == "__main__":
    main()
