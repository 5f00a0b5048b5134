"""The refinement task (counterpart of lidiff_tpu/models/refine.py): a
plain MinkUNet regresses `up_factor` offsets per point, and the upsampled
cloud (point + each offset) is trained with a Chamfer loss against the dense
ground truth.
"""

from __future__ import annotations

import torch

from lidiff_tpu_torch import resolve_device
from lidiff_tpu_torch.config import compute_dtype_from_env
from lidiff_tpu_torch.models.blocks import init_weights, set_bn_group
from lidiff_tpu_torch.models.diffusion import eval_no_grad
from lidiff_tpu_torch.models.minkunet import MinkUNet
from lidiff_tpu_torch.ops.chamfer import chamfer_distance
from lidiff_tpu_torch.ops.grid import Pyramid, build_pyramid


class RefineTask:
    """Config, model, the training loss and the eval forward.

    Runs on `device` (default: the card) with `compute_dtype` (default: the
    one LIDIFF_COMPUTE_DTYPE names, `config.compute_dtype_from_env`; the
    config's `tpu.compute_dtype` is not read). The weights are a seeded
    random init (`seed`); `lidiff_tpu_torch.convert.load_jax_variables`
    replaces them with a JAX checkpoint's. `group`, a torch.distributed
    process group, syncs the training BatchNorm moments over its ranks
    (None: this process alone). `conv_quant` selects the int8 eval conv
    (kernel A4) for `forward`; training never quantizes. `remat` (default
    True, the JAX `MinkUNet`'s default: the JAX refiner reads no config key
    for it) recomputes the stages' activations in the backward pass of
    training; False keeps them, for comparison."""

    def __init__(self, cfg, device=None, compute_dtype=None, seed: int = 0,
                 conv_quant: bool = False, group=None, remat: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        if compute_dtype is None:
            compute_dtype = compute_dtype_from_env()
        self.compute_dtype = compute_dtype
        self.up_factor = int(cfg["train"]["up_factor"])
        self.model = MinkUNet(out_channels=3 * self.up_factor,
                              cr=float(cfg.get("model", {}).get("cr", 1.0)),
                              compute_dtype=compute_dtype,
                              conv_quant=conv_quant, remat=remat)
        init_weights(self.model, torch.Generator().manual_seed(seed))
        set_bn_group(self.model, group)
        self.model.to(self.device).eval()
        self.resolution = float(cfg["data"]["resolution"])
        self.caps = list(cfg["tpu"]["full_capacities"])
        self.num_levels = int(cfg["tpu"]["num_levels"])

    def pyramid(self, points) -> Pyramid:
        return build_pyramid(points, self.resolution, self.caps,
                             self.num_levels)

    def _offsets(self, points):
        out = self.model(self.pyramid(points))
        return out.reshape(points.shape[0], points.shape[1], self.up_factor,
                           3)

    @eval_no_grad
    def forward(self, points):
        """points [B, N, 3] -> offsets [B, N, up_factor, 3], in eval mode
        and without autograd."""
        return self._offsets(points)

    def upsample(self, points, offsets):
        """point + offset_k for each k: [B, N * up_factor, 3]."""
        up = points[:, :, None, :] + offsets
        return up.reshape(points.shape[0], -1, 3)

    def loss_fn(self, batch: dict, generator=None):
        """Chamfer loss between the upsampled noisy cloud and the dense
        ground truth; puts the model in train mode, so the BatchNorm
        running statistics move. Nothing is drawn: `generator` is there for
        `Trainer.train_step`.

        batch: {'pcd_noise': [B, N, 3], 'pcd_full': [B, M, 3]} on the
        task's device. Returns (loss, metrics), the metrics detached."""
        noisy, gt = batch["pcd_noise"], batch["pcd_full"]
        self.model.train()
        up = self.upsample(noisy, self._offsets(noisy))
        loss = chamfer_distance(up, gt)
        return loss, {"cd_loss": loss.detach()}
