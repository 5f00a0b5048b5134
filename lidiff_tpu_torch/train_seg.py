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

import json
import os

import numpy as np
import torch

from lidiff_tpu_torch.config import compute_dtype_from_env
from lidiff_tpu_torch.data.seg import SegDataModule
from lidiff_tpu_torch.models.ptv3 import SegTask
from lidiff_tpu_torch.training import loop


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
    args = loop.parser("lidiff_tpu_torch.train_seg", __doc__,
                       "config/config_ptv3.json").parse_args(argv)
    loop.launch(_run, args, load_config(args.config))


def _run(rank: int, world: int, group, device, args, cfg) -> None:
    """One rank of the run (`loop.run`): the mean IoU over the validation
    split after every epoch."""
    task = SegTask(cfg, device=device, seed=42,
                   compute_dtype=compute_dtype_from_env(), group=group)
    data = SegDataModule(cfg, seed=42)

    def validate(trainer, epoch, step):
        miou = run_validation(task, data)
        trainer.logger.log(step, {"val/miou": miou})
        print(f"epoch {epoch}: val mIoU {miou:.4f}")

    loop.run(rank, world, group, args, cfg, task, data,
             generator=torch.Generator(device=task.device).manual_seed(
                 1000 + rank),
             test=lambda tr: print(
                 f"mean IoU {run_validation(task, data):.4f}"),
             validate=validate)


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
