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

import numpy as np
import torch

from lidiff_tpu_torch.config import (compute_dtype_from_env,
                                     conv_quant_from_env, load_config)
from lidiff_tpu_torch.data.datasets import dataloaders_refine
from lidiff_tpu_torch.models.refine import RefineTask
from lidiff_tpu_torch.ops.chamfer import chamfer_distance
from lidiff_tpu_torch.training import loop


def main(argv=None) -> None:
    args = loop.parser("lidiff_tpu_torch.train_refine", __doc__,
                       "config/config_refine.json").parse_args(argv)
    loop.launch(_run, args, load_config(args.config))


def _run(rank: int, world: int, group, device, args, cfg) -> None:
    """One rank of the run (`loop.run`): one validation batch before
    training, 5% of the validation split every five epochs."""
    np.random.seed(42)
    task = RefineTask(cfg, device=device, seed=42,
                      compute_dtype=compute_dtype_from_env(),
                      conv_quant=conv_quant_from_env(), group=group)
    data = dataloaders_refine[cfg["data"]["dataloader"]](cfg)
    loop.run(rank, world, group, args, cfg, task, data,
             test=lambda tr: run_test(task, data),
             validate=lambda tr, epoch, step: run_validation(
                 task, data, tr, step),
             validate_every=5,
             # a broken validation path shows before hours of training
             # (the reference's num_sanity_val_steps=1)
             sanity=lambda tr, step: run_validation(
                 task, data, tr, step, max_batches=1, tag="sanity"))


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
