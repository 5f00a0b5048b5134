"""The run loop the training CLIs share (`train`, `train_refine`,
`train_seg`): their parser, the experiment directory, restoring from
`-ckpt`/`-w`, the `--test` dispatch, checkpointing on SIGTERM/SIGINT and
the epoch loop. Each CLI brings its task, its data module, its per-step
generator and its validation and test functions."""

from __future__ import annotations

import argparse
import os
import signal
import time

import torch

from lidiff_tpu_torch.config import save_config
from lidiff_tpu_torch.parallel import mesh
from lidiff_tpu_torch.training.trainer import CheckpointManager, Trainer


def parser(prog: str, doc: str, config: str) -> argparse.ArgumentParser:
    """The CLIs' flags; `config` is the default config, relative to the
    package."""
    ap = argparse.ArgumentParser(prog=prog, description=doc.split("\n")[0])
    ap.add_argument("--config", "-c", type=str,
                    default=os.path.join(
                        os.path.dirname(os.path.dirname(
                            os.path.abspath(__file__))), config))
    ap.add_argument("--weights", "-w", type=str, default=None,
                    help="checkpoint dir to load weights from (no resume)")
    ap.add_argument("--checkpoint", "-ckpt", type=str, default=None,
                    help="experiment dir to resume training from")
    ap.add_argument("--test", "-t", action="store_true",
                    help="evaluate instead of training")
    ap.add_argument("--max_steps", type=int, default=None,
                    help="cap on total optimizer steps (smoke runs)")
    ap.add_argument("--device", type=str, default=None,
                    help="'cpu' for the plain PyTorch path (default: cuda)")
    return ap


def launch(run, args, cfg) -> None:
    """run(rank, world, group, device, args, cfg) on every rank: one
    process for `--test`, else one per card (`mesh.world_size`)."""
    world = 1 if args.test else mesh.world_size(cfg, args.device)
    mesh.launch(run, world, args.device, args, cfg)


def run(rank: int, world: int, group, args, cfg: dict, task, data, *,
        test, validate, validate_every: int = 1, generator=None,
        sanity=None) -> None:
    """One rank of a run (the whole run at world 1); rank 0 writes the
    hparams, checkpoints, logs and validations. `test(trainer)` runs for
    `--test`; `validate(trainer, epoch, step)` after every
    `validate_every`-th epoch and `sanity(trainer, step)` before the first
    one, both on rank 0 alone; `generator` goes to every step."""
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
        test(trainer)
        return

    if rank == 0:
        procs = f", {world} processes" if world > 1 else ""
        print(f"TRAINING MODE ({task.device}{procs})")
        old_handlers = {s: signal.getsignal(s)
                        for s in (signal.SIGTERM, signal.SIGINT)}
        trainer.install_signal_checkpointing()
    try:
        _epochs(trainer, loader, cfg, args, generator, validate,
                validate_every, sanity)
    finally:
        if rank == 0:
            for s, h in old_handlers.items():
                signal.signal(s, h)
    trainer.logger.flush()


def _epochs(trainer, loader, cfg, args, generator, validate, validate_every,
            sanity) -> None:
    dev = trainer.task.device
    step = trainer.global_step
    if sanity is not None and trainer.is_main:
        sanity(trainer, step)
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
            metrics = trainer.train_step(batch, generator)
            step += 1
            if step % 10 == 0 and trainer.is_main:
                m = {f"train/{k}": float(v) for k, v in metrics.items()}
                m["train/step_time"] = time.time() - t0
                trainer.logger.log(step, m)
                print(f"epoch {epoch} step {step} "
                      + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
                dropped = m.get("train/overflow_vox", 0.0)
                if dropped:
                    print(f"WARNING: step {step}: {int(dropped)} voxels "
                          "dropped (capacity exceeded): raise "
                          "tpu.full_capacities / part_capacities for this "
                          "dataset")
            if max_steps and step >= max_steps:
                break
        trainer.save(epoch)
        if (epoch + 1) % validate_every == 0 and trainer.is_main:
            validate(trainer, epoch, step)
        if max_steps and step >= max_steps:
            break
