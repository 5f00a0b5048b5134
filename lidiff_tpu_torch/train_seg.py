"""Point Transformer V3 semantic segmentation training CLI (SemanticKITTI).

Usage: python -m lidiff_tpu_torch.train_seg -c CONFIG
       [-w weights_ckpt_dir] [-ckpt resume_dir] [--max_steps N]
       [--device cpu] [--test]

CONFIG is a `.json` file like `config/config_ptv3.json` (Pointcept's
`semseg-pt-v3m1-0-base`): the data under `data.data_dir`
(`dataset/sequences/<seq>/velodyne/*.bin` and `labels/*.label`), the
global batch `train.batch_size` (divided over train.n_gpus cards, one
process each), AdamW with its "block" group under OneCycleLR. Training
runs on the card unless `--device cpu` is given; LIDIFF_COMPUTE_DTYPE=bf16
(or bfloat16) computes the Linears, convs and attention in bfloat16. The
mean IoU over the validation split is reported after every epoch and by
`--test`.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import time

import numpy as np
import torch

from lidiff_tpu_torch.config import compute_dtype_from_env, save_config
from lidiff_tpu_torch.data.seg import SegDataModule
from lidiff_tpu_torch.models.ptv3 import SegTask
from lidiff_tpu_torch.parallel import mesh
from lidiff_tpu_torch.training.trainer import CheckpointManager, Trainer


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="lidiff_tpu_torch.train_seg",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--config", "-c", type=str,
                    default=os.path.join(
                        os.path.dirname(os.path.abspath(__file__)),
                        "config/config_ptv3.json"))
    ap.add_argument("--weights", "-w", type=str, default=None,
                    help="checkpoint dir to load weights from (no resume)")
    ap.add_argument("--checkpoint", "-ckpt", type=str, default=None,
                    help="experiment dir to resume training from")
    ap.add_argument("--test", "-t", action="store_true",
                    help="only evaluate the validation split")
    ap.add_argument("--max_steps", type=int, default=None,
                    help="cap on total optimizer steps (smoke runs)")
    ap.add_argument("--device", type=str, default=None,
                    help="'cpu' for the plain PyTorch path (default: cuda)")
    return ap


def load_config(path: str) -> dict:
    """The JSON config; TRAIN_DATABASE overrides `data.data_dir`."""
    with open(path) as f:
        cfg = json.load(f)
    if os.environ.get("TRAIN_DATABASE"):
        cfg["data"]["data_dir"] = os.environ["TRAIN_DATABASE"]
    return cfg


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    cfg = load_config(args.config)
    world = 1 if args.test else mesh.world_size(cfg, args.device)
    mesh.launch(_run, world, args.device, args, cfg)


def _run(rank: int, world: int, group, device, args, cfg) -> None:
    """One rank of the run; rank 0 writes the config, checkpoints and
    logs."""
    task = SegTask(cfg, device=device, seed=42,
                   compute_dtype=compute_dtype_from_env(), group=group)
    data = SegDataModule(cfg, seed=42)
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
            trainer.global_step = 0
    if args.test:
        print(f"mean IoU {run_validation(task, data):.4f}")
        return
    gen = torch.Generator(device=task.device).manual_seed(1000 + rank)
    if rank == 0:
        print(f"TRAINING MODE ({task.device}, {world} processes)")
        old = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
        trainer.install_signal_checkpointing()
    try:
        _train_loop(trainer, loader, data, gen, cfg, args)
    finally:
        if rank == 0:
            for s, h in old.items():
                signal.signal(s, h)
    trainer.logger.flush()


def _train_loop(trainer, loader, data, gen, cfg, args) -> None:
    task = trainer.task
    step = trainer.global_step
    start_epoch = (trainer.last_epoch + 1 if args.checkpoint
                   and trainer.last_epoch >= 0
                   else step // max(trainer.steps_per_epoch, 1))
    for epoch in range(start_epoch, int(cfg["train"]["max_epoch"])):
        for batch in loader:
            t0 = time.time()
            metrics = trainer.train_step(to_device(batch, task.device), gen)
            step += 1
            if step % 10 == 0 and trainer.is_main:
                m = {f"train/{k}": float(v) for k, v in metrics.items()}
                m["train/step_time"] = time.time() - t0
                trainer.logger.log(step, m)
                print(f"epoch {epoch} step {step} "
                      + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
            if args.max_steps and step >= args.max_steps:
                break
        trainer.save(epoch)
        if trainer.is_main:
            miou = run_validation(task, data)
            trainer.logger.log(step, {"val/miou": miou})
            print(f"epoch {epoch}: val mIoU {miou:.4f}")
        if args.max_steps and step >= args.max_steps:
            break


def run_validation(task: SegTask, data: SegDataModule) -> float:
    """Mean IoU over the classes the validation split or the predictions
    hold (eval forward, one scan a batch)."""
    C = task.model.num_classes
    conf = np.zeros((C, C), dtype=np.int64)
    for batch in data.val_dataloader():
        b = to_device(batch, task.device)
        pred = task.forward(b).argmax(1)
        seg = b["segment"]
        keep = seg != task.ignore
        idx = (seg[keep] * C + pred[keep]).cpu().numpy()
        conf += np.bincount(idx, minlength=C * C).reshape(C, C)
    inter = np.diag(conf)
    union = conf.sum(0) + conf.sum(1) - inter
    seen = union > 0
    return float((inter[seen] / union[seen]).mean()) if seen.any() else 0.0


if __name__ == "__main__":
    main()
