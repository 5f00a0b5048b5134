"""Diffusion training CLI (counterpart of lidiff_tpu/train.py).

Usage: python -m lidiff_tpu_torch.train -c CONFIG [-w weights_ckpt_dir]
       [-ckpt resume_dir] [--max_steps N] [--device cpu]

CONFIG is a `.json` or YAML file with the reference schema. Training runs
on the card unless `--device cpu` is given. `--test` and the validation
every five epochs need the metrics and PLY modules, which are not ported
yet (ROADMAP.md, Queue A item 8).
"""

from __future__ import annotations

import argparse
import os
import signal
import time

import numpy as np
import torch

from lidiff_tpu_torch.config import load_config, save_config
from lidiff_tpu_torch.data.datasets import dataloaders
from lidiff_tpu_torch.models.diffusion import DiffusionTask
from lidiff_tpu_torch.training.trainer import CheckpointManager, Trainer

_NOT_PORTED = ("sampling evaluation needs utils/metrics.py and utils/ply.py, "
               "which are not ported yet (ROADMAP.md, Queue A item 8)")


def set_deterministic(seed: int = 42):
    np.random.seed(seed)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="lidiff_tpu_torch.train",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--config", "-c", type=str,
                    default=os.path.join(
                        os.path.dirname(os.path.abspath(__file__)),
                        "config/config.json"))
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
    set_deterministic()
    cfg = load_config(args.config)
    if args.test:
        raise NotImplementedError(f"--test: {_NOT_PORTED}")

    task = DiffusionTask(cfg, device=args.device, seed=42)
    dev = task.device
    data = dataloaders[cfg["data"]["dataloader"]](cfg)

    exp_dir = os.path.join("experiments", cfg["experiment"]["id"])
    os.makedirs(exp_dir, exist_ok=True)
    save_config(cfg, os.path.join(exp_dir, "hparams.json"))

    loader = data.train_dataloader()
    trainer = Trainer(task, cfg, exp_dir, steps_per_epoch=max(len(loader), 1))
    gen = torch.Generator(device=dev).manual_seed(42)

    src = args.checkpoint or args.weights
    if src:
        trainer.ckpt = CheckpointManager(os.path.join(src, "checkpoints"))
        trainer.maybe_restore()
        trainer.ckpt = CheckpointManager(os.path.join(exp_dir, "checkpoints"))
        if args.weights and not args.checkpoint:
            trainer.global_step = 0          # weights-only load

    print(f"TRAINING MODE ({dev})")
    old_handlers = {s: signal.getsignal(s)
                    for s in (signal.SIGTERM, signal.SIGINT)}
    trainer.install_signal_checkpointing()
    try:
        _train_loop(trainer, loader, cfg, gen, args)
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)
    trainer.logger.flush()


def _train_loop(trainer, loader, cfg, gen, args) -> None:
    dev = trainer.task.device
    step = trainer.global_step
    # resume at the epoch after the restored one (without this a run
    # resumed at epoch 15/20 would train 20 more epochs and misalign the
    # LR-decay boundaries); mid-epoch signal checkpoints record epoch=-1
    # and fall back to step arithmetic
    if args.checkpoint and trainer.last_epoch >= 0:
        start_epoch = trainer.last_epoch + 1
    else:
        start_epoch = step // max(trainer.steps_per_epoch, 1)
    max_steps = args.max_steps
    for epoch in range(start_epoch, int(cfg["train"]["max_epoch"])):
        for batch in loader:
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in batch.items() if k != "filename"}
            t0 = time.time()
            metrics = trainer.train_step(batch, gen)
            step += 1
            if step % 10 == 0:
                m = {f"train/{k}": float(v) for k, v in metrics.items()}
                m["train/step_time"] = time.time() - t0
                trainer.logger.log(step, m)
                print(f"epoch {epoch} step {step} "
                      + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
                dropped = m["train/overflow_vox"]
                if dropped:
                    print(f"WARNING: step {step}: {int(dropped)} voxels "
                          "dropped (capacity exceeded): raise "
                          "tpu.full_capacities / part_capacities for this "
                          "dataset")
            if max_steps and step >= max_steps:
                break
        trainer.save(epoch)
        # the reference validates every 5 epochs on about one batch
        if (epoch + 1) % 5 == 0:
            print(f"validation skipped: {_NOT_PORTED}")
        if max_steps and step >= max_steps:
            break


if __name__ == "__main__":
    main()
