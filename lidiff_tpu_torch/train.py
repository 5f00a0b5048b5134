"""Diffusion training CLI (counterpart of lidiff_tpu/train.py).

Usage: python -m lidiff_tpu_torch.train -c CONFIG [-w weights_ckpt_dir]
       [-ckpt resume_dir] [--test] [--max_steps N] [--device cpu]

CONFIG is a `.json` or YAML file with the reference schema. Training runs
on the card unless `--device cpu` is given; train.n_gpus > 1 starts one
process per card (min(n_gpus, cards); one process on the CPU), each on its
rows of every batch with synced BatchNorm and averaged gradients, rank 0
alone checkpointing and logging. Every five epochs one
validation batch is sampled and scored (Chamfer distance, PR-AUC); a
validation that fails raises, where the JAX CLI prints the error and trains
on. `--test` samples the validation split with the reference's test
protocol and writes one .ply per scan under
experiments/<id>/generated_pcd/<seq>/; with `-w` it takes the
checkpoint's hparams and grafts this config's inference settings onto
them. LIDIFF_COMPUTE_DTYPE=bf16 (or bfloat16) computes the convs, gates
and matches in bfloat16, as in the JAX package (default float32; the
config's `tpu.compute_dtype` is not read). LIDIFF_CONV_QUANT=int8 runs the
sampling's eval convs as the int8 conv (kernel A4); training never
quantizes.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from lidiff_tpu_torch.config import (compute_dtype_from_env,
                                     conv_quant_from_env, finalize_config,
                                     load_config)
from lidiff_tpu_torch.data.datasets import dataloaders
from lidiff_tpu_torch.models.diffusion import DiffusionTask
from lidiff_tpu_torch.parallel import mesh
from lidiff_tpu_torch.training import loop
from lidiff_tpu_torch.training.trainer import CheckpointManager
from lidiff_tpu_torch.utils.metrics import ChamferDistance, PrecisionRecall
from lidiff_tpu_torch.utils.ply import write_ply


def set_deterministic(seed: int = 42):
    np.random.seed(seed)


def _parser():
    return loop.parser("lidiff_tpu_torch.train", __doc__, "config/config.json")


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    cfg = load_config(args.config)
    if args.weights is not None and args.test:
        cfg = _graft_test_config(cfg, args.weights)
    loop.launch(_run, args, cfg)


def _run(rank: int, world: int, group, device, args, cfg) -> None:
    """One rank of the run (`loop.run`): one validation batch sampled and
    scored every five epochs."""
    set_deterministic()
    task = DiffusionTask(cfg, device=device, seed=42,
                         compute_dtype=compute_dtype_from_env(),
                         conv_quant=conv_quant_from_env(), group=group)
    data = dataloaders[cfg["data"]["dataloader"]](cfg)
    loop.run(rank, world, group, args, cfg, task, data,
             generator=mesh.rank_generator(42, rank, task.device),
             test=lambda tr: run_test(task, cfg, data, tr.exp_dir),
             validate=lambda tr, epoch, step: run_validation(
                 task, cfg, data, tr, step),
             # the reference validates every 5 epochs on about one batch
             validate_every=5)


def _graft_test_config(cfg: dict, weights: str) -> dict:
    """The checkpoint's hparams with this config's inference settings
    grafted on (lidiff_tpu/train.py:44-66)."""
    wc = CheckpointManager(os.path.join(weights, "checkpoints"))
    ckpt_cfg = wc.load_hparams() or dict(cfg)
    for sec, key in [("train", "num_workers"), ("train", "n_gpus"),
                     ("train", "batch_size"), ("train", "uncond_w"),
                     ("data", "num_points"), ("data", "data_dir"),
                     ("diff", "s_steps"), ("experiment", "id")]:
        ckpt_cfg.setdefault(sec, {})[key] = cfg[sec][key]
    ckpt_cfg["data"].setdefault("dataset_norm", False)
    ckpt_cfg["data"].setdefault("std_axis_norm", False)
    ckpt_cfg["data"].setdefault("max_range", 50.0)
    return finalize_config(ckpt_cfg)


def _sample_batch(task, batch, generator):
    """(completions [B, N, 3], x_init [B, N, 3]) of one validation batch:
    the partial scan tiled 10x as anchors."""
    part = torch.from_numpy(batch["pcd_part"]).to(task.device)
    x_init = part.repeat(1, 10, 1)
    out = task.sample(x_init, part, generator)
    return out.cpu().numpy(), x_init.cpu().numpy()


def run_validation(task, cfg, data, trainer, step: int,
                   max_batches: int = 1) -> None:
    """Sample `max_batches` validation batches and log the Chamfer
    distance and PR-AUC against the ground truth."""
    res = float(cfg["data"]["resolution"])
    cd, pr = ChamferDistance(), PrecisionRecall(res, 2 * res, 100)
    gen = torch.Generator(device=task.device).manual_seed(7)
    for i, batch in enumerate(data.val_dataloader()):
        if i >= max_batches:
            break
        out, _ = _sample_batch(task, batch, gen)
        for b in range(out.shape[0]):
            cd.update(batch["pcd_full"][b], out[b])
            pr.update(batch["pcd_full"][b], out[b])
    cdm, cds = cd.compute()
    p, r, f = pr.compute_auc()
    trainer.logger.log(step, {"val/cd_mean": cdm, "val/cd_std": cds,
                              "val/precision": p, "val/recall": r,
                              "val/fscore": f})
    print(f"val: CD {cdm:.4f}+-{cds:.4f} P {p:.3f} R {r:.3f} F {f:.3f}")


def _test_output_paths(exp_dir: str, filenames) -> tuple[bool, list[str]]:
    """One .ply per scan under <exp_dir>/generated_pcd/<seq>/, and whether
    every output of the batch exists already (then the batch is skipped)."""
    out_paths, skip = [], []
    for fname in filenames:
        parts = fname.replace("\\", "/").split("/")
        seq = parts[-3] if len(parts) >= 3 else "seq"
        seq_dir = os.path.join(exp_dir, "generated_pcd", seq)
        os.makedirs(seq_dir, exist_ok=True)
        base = os.path.splitext(os.path.basename(fname))[0]
        p = os.path.join(seq_dir, f"{base}.ply")
        skip.append(os.path.isfile(p))
        out_paths.append(p)
    return bool(np.all(skip)), out_paths


def postprocess_test_pred(pred: np.ndarray, x_init: np.ndarray,
                          max_range: float) -> np.ndarray:
    """Range crop to max_range, then the z window (mean_z - 2 std_z,
    max_z) of the sampler's anchors (the tiled partial scan)."""
    dist = np.sqrt(np.sum(pred ** 2, axis=-1))
    pred = pred[dist < max_range]
    zi = x_init[..., 2]
    max_z = float(zi.max())
    min_z = float(zi.mean() - 2.0 * zi.std())
    return pred[(pred[:, 2] < max_z) & (pred[:, 2] > min_z)]


def run_test(task, cfg, data, exp_dir: str) -> None:
    """Sampling evaluation over the validation split with the reference's
    test protocol: per scan the range and z crop of the prediction, its
    .ply (scans already generated are skipped), then the cumulative
    Chamfer distance and PR-AUC against the ground truth."""
    res = float(cfg["data"]["resolution"])
    cd, pr = ChamferDistance(), PrecisionRecall(res, 2 * res, 100)
    max_range = float(cfg["data"]["max_range"])
    gen = torch.Generator(device=task.device).manual_seed(0)
    for i, batch in enumerate(data.val_dataloader()):
        fnames = batch.get("filename",
                           [f"unknown/seq/{i}_{b}.bin"
                            for b in range(len(batch["pcd_part"]))])
        skip, out_paths = _test_output_paths(exp_dir, fnames)
        if skip:
            print(f"Skipping generation from {out_paths[0]} "
                  f"to {out_paths[-1]}")
            continue
        out, x_init = _sample_batch(task, batch, gen)
        for b in range(out.shape[0]):
            pred = postprocess_test_pred(out[b], x_init[b], max_range)
            print(f"Saving {out_paths[b]}")
            write_ply(out_paths[b], pred)
            cd.update(batch["pcd_full"][b], pred)
            pr.update(batch["pcd_full"][b], pred)
        cdm, cds = cd.compute()
        p, r, f = pr.compute_auc()
        print(f"[{i}] CD {cdm:.4f}+-{cds:.4f} P {p:.3f} R {r:.3f} F {f:.3f}")


if __name__ == "__main__":
    main()
