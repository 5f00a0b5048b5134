"""Convert reference (PyTorch Lightning / MinkowskiEngine) checkpoints to
the port's checkpoints (counterpart of lidiff_tpu/tools/convert_checkpoint.py,
argparse in place of click).

    python -m lidiff_tpu_torch.tools.convert_checkpoint --ckpt REF.ckpt
        --out EXP_DIR [--kind diffusion|refine] [--tap_order x|z] [--dry_run]

The reference stores the `state_dict` of DiffusionPoints or RefineDiffusion
(ckpt["state_dict"]). Tensors map by role onto the JAX package's parameter
tree, as its converter does, and that tree goes through
`lidiff_tpu_torch.convert.flax_to_state_dict` into the port's `state_dict`:

  * ME MinkowskiConvolution kernels are [K, Cin, Cout], our layout, but ME
    enumerates cube offsets with the FIRST coordinate fastest where we
    enumerate z fastest; the tap axis is permuted (`--tap_order`);
  * torch Linear weights are [out, in]: [in, out] in the tree, [out, in]
    again in the port's state_dict;
  * BatchNorm {weight, bias, running_mean, running_var} map to
    MaskedBatchNorm {scale, bias} and its {mean, var} buffers.

The output is EXP_DIR/checkpoints/step_00000000.pt ({"model": state_dict,
"step": 0}) with the Lightning hyper-parameters as hparams.json, which
`lidiff_tpu_torch.tools.diff_completion_pipeline` loads. This is a semantic
converter; exact parity of outputs also depends on voxelization ties.
"""

from __future__ import annotations

import argparse
import itertools
import os

import numpy as np
import torch

from lidiff_tpu_torch.convert import flax_to_state_dict
from lidiff_tpu_torch.training.trainer import CheckpointManager


def cube_perm(k: int, src_fastest: str = "x") -> np.ndarray:
    """Permutation taking OUR tap order (x slowest, z fastest) to indices
    in a source enumeration where `src_fastest` varies fastest."""
    if k % 2 == 1:
        rng = range(-(k // 2), k // 2 + 1)
    else:
        rng = range(k)
    ours = list(itertools.product(rng, rng, rng))       # (x, y, z), z fastest
    if src_fastest == "x":
        src = [(x, y, z) for z in rng for y in rng for x in rng]
    elif src_fastest == "z":
        src = ours
    else:
        raise ValueError(src_fastest)
    index = {off: i for i, off in enumerate(src)}
    return np.array([index[o] for o in ours], np.int64)


def _linear(sd, prefix):
    return {"kernel": np.asarray(sd[f"{prefix}.weight"]).T,
            "bias": np.asarray(sd[f"{prefix}.bias"])}


def _mlp(sd, p0, p1):
    return {"Dense_0": _linear(sd, p0), "Dense_1": _linear(sd, p1)}


def _conv(sd, prefix, k, tap_src_fastest):
    w = np.asarray(sd[f"{prefix}.kernel"])
    if w.ndim == 2:                      # 1x1 conv stored [in, out]
        return {"kernel": w}
    perm = cube_perm(k, tap_src_fastest)
    return {"kernel": w[perm]}


def _bn(sd, prefix):
    params = {"scale": np.asarray(sd[f"{prefix}.weight"]),
              "bias": np.asarray(sd[f"{prefix}.bias"])}
    stats = {"mean": np.asarray(sd[f"{prefix}.running_mean"]),
             "var": np.asarray(sd[f"{prefix}.running_var"])}
    return params, stats


class TreeBuilder:
    def __init__(self):
        self.params: dict = {}
        self.stats: dict = {}

    def put(self, path: list[str], params, stats=None):
        d = self.params
        for p in path[:-1]:
            d = d.setdefault(p, {})
        d[path[-1]] = params
        if stats is not None:
            d = self.stats
            for p in path[:-1]:
                d = d.setdefault(p, {})
            d[path[-1]] = stats


def _conv_bn_relu(sd, b: TreeBuilder, path, prefix, k, tap):
    b.put(path + ["SparseConv_0"], _conv(sd, f"{prefix}.0", k, tap))
    p, s = _bn(sd, f"{prefix}.1")
    b.put(path + ["MaskedBatchNorm_0"], p, s)


def _residual(sd, b, path, prefix, tap, has_short):
    b.put(path + ["SparseConv_0"], _conv(sd, f"{prefix}.net.0", 3, tap))
    p, s = _bn(sd, f"{prefix}.net.1")
    b.put(path + ["MaskedBatchNorm_0"], p, s)
    b.put(path + ["SparseConv_1"], _conv(sd, f"{prefix}.net.3", 3, tap))
    p, s = _bn(sd, f"{prefix}.net.4")
    b.put(path + ["MaskedBatchNorm_1"], p, s)
    if has_short:
        b.put(path + ["Dense_0"],
              {"kernel": np.asarray(sd[f"{prefix}.downsample.0.kernel"])})
        p, s = _bn(sd, f"{prefix}.downsample.1")
        b.put(path + ["MaskedBatchNorm_2"], p, s)


def _stem(sd, b, path, prefix, tap):
    # reference stem Sequential: conv,bn,relu,conv,bn,relu -> indices 0,1
    _conv_bn_relu(sd, b, path + ["ConvBNReLU_0"], prefix, 3, tap)
    # reference stem Sequential: conv,bn,relu,conv,bn,relu -> indices 3,4
    b.put(path + ["ConvBNReLU_1", "SparseConv_0"],
          _conv(sd, f"{prefix}.3", 3, tap))
    p, s = _bn(sd, f"{prefix}.4")
    b.put(path + ["ConvBNReLU_1", "MaskedBatchNorm_0"], p, s)


def _down_stage(sd, b, path, prefix, ch_change, tap):
    _conv_bn_relu(sd, b, path + ["ConvBNReLU_0"], f"{prefix}.0.net", 2, tap)
    _residual(sd, b, path + ["ResidualBlock_0"], f"{prefix}.1",
              tap, has_short=ch_change)
    _residual(sd, b, path + ["ResidualBlock_1"], f"{prefix}.2",
              tap, has_short=False)


def _up_stage(sd, b, path, prefix, tap):
    # up = ModuleList([deconv_block, Sequential(res, res)])
    b.put(path + ["DeconvBNReLU_0", "SparseConvTranspose_0"],
          _conv(sd, f"{prefix}.0.net.0", 2, tap))
    p, s = _bn(sd, f"{prefix}.0.net.1")
    b.put(path + ["DeconvBNReLU_0", "MaskedBatchNorm_0"], p, s)
    _residual(sd, b, path + ["ResidualBlock_0"], f"{prefix}.1.0",
              tap, has_short=True)   # concat changes channels
    _residual(sd, b, path + ["ResidualBlock_1"], f"{prefix}.1.1",
              tap, has_short=False)


CS = (32, 32, 64, 128, 256, 256, 128, 96, 96)


def convert_diffusion(sd: dict, tap: str = "x"):
    """state_dict of DiffusionPoints -> (params, batch_stats) trees."""
    b = TreeBuilder()
    # partial encoder
    _stem(sd, b, ["partial_enc", "Stem_0"], "partial_enc.stem", tap)
    for i in range(1, 5):
        ch_change = CS[i - 1] != CS[i]
        _down_stage(sd, b, ["partial_enc", f"DownStage_{i-1}"],
                    f"partial_enc.stage{i}", ch_change, tap)
    # denoiser
    _stem(sd, b, ["denoiser", "Stem_0"], "model.stem", tap)
    for i in range(1, 5):
        ch_change = CS[i - 1] != CS[i]
        _down_stage(sd, b, ["denoiser", f"DownStage_{i-1}"],
                    f"model.stage{i}", ch_change, tap)
    for i in range(1, 5):
        _up_stage(sd, b, ["denoiser", f"UpStage_{i-1}"], f"model.up{i}", tap)
    # gates: latent_*, *_temp, latemp_* triplets
    gate_specs = [
        ("gate_s1", "latent_stage1", "stage1_temp", "latemp_stage1"),
        ("gate_s2", "latent_stage2", "stage2_temp", "latemp_stage2"),
        ("gate_s3", "latent_stage3", "stage3_temp", "latemp_stage3"),
        ("gate_s4", "latent_stage4", "stage4_temp", "latemp_stage4"),
        ("gate_u1", "latent_up1", "up1_temp", "latemp_up1"),
        ("gate_u2", "latent_up2", "up2_temp", "latemp_up2"),
        ("gate_u3", "latent_up3", "up3_temp", "latemp_up3"),
        ("gate_u4", "latent_up4", "up4_temp", "latemp_up4"),
    ]
    for ours, lat, tmp, latemp in gate_specs:
        b.put(["denoiser", ours, "latent"],
              _mlp(sd, f"model.{lat}.0", f"model.{lat}.2"))
        b.put(["denoiser", ours, "temp"],
              _mlp(sd, f"model.{tmp}.0", f"model.{tmp}.2"))
        b.put(["denoiser", ours, "latemp"],
              _mlp(sd, f"model.{latemp}.0", f"model.{latemp}.2"))
    b.put(["denoiser", "head"], _mlp(sd, "model.last.0", "model.last.2"))
    return b.params, b.stats


def convert_refine(sd: dict, tap: str = "x"):
    """state_dict of RefineDiffusion (or the refine part of the combined
    pipeline module, prefix model_refine) -> (params, batch_stats)."""
    pre = "model_refine" if any(k.startswith("model_refine")
                                for k in sd) else "model"
    b = TreeBuilder()
    _stem(sd, b, ["Stem_0"], f"{pre}.stem", tap)
    for i in range(1, 5):
        ch_change = CS[i - 1] != CS[i]
        _down_stage(sd, b, [f"DownStage_{i-1}"], f"{pre}.stage{i}",
                    ch_change, tap)
    for i in range(1, 5):
        _up_stage(sd, b, [f"UpStage_{i-1}"], f"{pre}.up{i}", tap)
    b.put(["head"], _mlp(sd, f"{pre}.last.0", f"{pre}.last.2"))
    return b.params, b.stats


def convert(sd: dict, kind: str = "diffusion", tap: str = "x") -> dict:
    """A reference state_dict (numpy values) -> the port's state_dict."""
    fn = convert_diffusion if kind == "diffusion" else convert_refine
    params, stats = fn(sd, tap)
    return flax_to_state_dict({"params": params, "batch_stats": stats})


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="lidiff_tpu_torch.tools.convert_checkpoint",
        description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", type=str, required=True,
                    help="reference Lightning .ckpt path")
    ap.add_argument("--out", type=str, required=True,
                    help="output experiment dir")
    ap.add_argument("--kind", choices=["diffusion", "refine"],
                    default="diffusion")
    ap.add_argument("--tap_order", choices=["x", "z"], default="x",
                    help="which axis varies fastest in the source kernels")
    ap.add_argument("--dry_run", action="store_true")
    return ap


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    # a Lightning checkpoint holds more than tensors (its hyper-parameters)
    raw = torch.load(args.ckpt, map_location="cpu", weights_only=False)
    sd = {k: v.numpy() for k, v in raw["state_dict"].items()}
    model = convert(sd, args.kind, args.tap_order)
    if args.dry_run:
        for k, v in list(model.items())[:20]:
            print(k, tuple(v.shape))
        return
    cm = CheckpointManager(os.path.join(args.out, "checkpoints"))
    hparams = raw.get("hyper_parameters")
    cm.save(0, {"model": model, "step": 0},
            hparams=dict(hparams) if hparams else None)
    print(f"wrote converted checkpoint to {args.out}")


if __name__ == "__main__":
    main()
