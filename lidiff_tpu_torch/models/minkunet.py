"""Sparse-voxel networks (counterpart of lidiff_tpu/models/minkunet.py):
the partial-scan encoder `MinkGlobalEnc`, the conditional denoiser
`MinkUNetDiff` and the refiner's unconditional `MinkUNet`. In train mode
(`module.training`) the activations stay float32 and only the convs and
GEMMs cast to the compute dtype. With `remat` (the default, as in the JAX
modules; `tpu.remat` of the diffusion config) training runs every
`DownStage` and `UpStage` under activation checkpointing
(`blocks.remat`): the backward pass recomputes each stage's activations
from its input. The stem, the conditioning gates, the 1-NN matches, the
slice back to the points and the head keep theirs, as in
lidiff_tpu/models/minkunet.py:69,157-159,240-242. Eval mode never
rematerializes.

The conditioning gates run per voxel in train mode, as the JAX module does.
In eval mode the 1-NN matches give bank rows, and each gate evaluates its
MLPs once per (batch item, bank row) pair into a table that `ops/gate.py`
`gate_apply` indexes per voxel (kernel GA on the card): the same
operations on the same values, computed once per distinct input.

Channel plan cs = [32, 32, 64, 128, 256, 256, 128, 96, 96] scaled by `cr`.
`conv_quant` selects the int8 eval conv (kernel A4) for every eval column
conv with Cin >= 32 (`lidiff_tpu_torch.ops.sparse_conv`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from lidiff_tpu_torch.models.blocks import (MLP, DownStage, Stem, UpStage,
                                           remat)
from lidiff_tpu_torch.ops.gate import counters as gate_counters
from lidiff_tpu_torch.ops.gate import gate_apply
from lidiff_tpu_torch.ops.grid import Pyramid, VoxelGeom, slice_to_points
from lidiff_tpu_torch.ops.knn import match_features, nn_match
from lidiff_tpu_torch.utils import prof

CS = (32, 32, 64, 128, 256, 256, 128, 96, 96)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding [B, dim], float32."""
    half = dim // 2
    freqs = torch.exp(math.log(10000.0) / (half - 1) *
                      -torch.arange(half, dtype=torch.float32,
                                    device=t.device))
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def _channels(cr: float) -> list[int]:
    return [int(cr * c) for c in CS]


class _Stages(nn.Module):
    """Runs the `DownStage`s and `UpStage`s: under `remat` in train mode
    when `self.remat` is set, as they are otherwise."""

    def stage(self, stage: nn.Module, *args):
        if self.remat and self.training:
            return remat(stage, *args)
        return stage(*args)


class MinkGlobalEnc(_Stages):
    """Partial-scan encoder: stem + 4 down stages -> stage-4 features."""

    def __init__(self, cr: float = 1.0, compute_dtype=torch.float32,
                 conv_quant: bool = False, remat: bool = True):
        super().__init__()
        cs = _channels(cr)
        cd, cq = compute_dtype, conv_quant
        self.remat = remat
        self.Stem_0 = Stem(3, cs[0], cd, cq)
        self.DownStage_0 = DownStage(cs[0], cs[0], cs[1], cd, cq)
        self.DownStage_1 = DownStage(cs[1], cs[1], cs[2], cd, cq)
        self.DownStage_2 = DownStage(cs[2], cs[2], cs[3], cd, cq)
        self.DownStage_3 = DownStage(cs[3], cs[3], cs[4], cd, cq)

    def forward(self, pyr: Pyramid):
        # the encoder keeps float32 activations; each conv casts its input
        # to the compute dtype (as lidiff_tpu/models/minkunet.py:70)
        lv = pyr.levels
        x = self.Stem_0(pyr.vox_feats, lv[0], 1)
        x = self.stage(self.DownStage_0, x, lv[0], lv[1], 1)
        x = self.stage(self.DownStage_1, x, lv[1], lv[2], 1)
        x = self.stage(self.DownStage_2, x, lv[2], lv[3], 1)
        return self.stage(self.DownStage_3, x, lv[3], lv[4], 1)  # [V4, cs4]


class StageGate(nn.Module):
    """Per-voxel conditioning gate w = latemp(cat(latent(match), temp(t))).
    `swap` concatenates (t, p), the reference's up1 order. With G groups,
    `match` is [V, G, c4] and feats [V, G*C]; the MLPs are shared.
    `forward` gates each voxel through the MLPs (training); `apply_table`
    is the eval form."""

    def __init__(self, gate_out: int, latemp_hidden: int, c4: int,
                 temb_dim: int, swap: bool = False,
                 compute_dtype=torch.float32):
        super().__init__()
        cd = compute_dtype
        self.latent = MLP(c4, c4, c4, cd)
        self.temp = MLP(temb_dim, temb_dim, c4, cd)
        self.latemp = MLP(2 * c4, latemp_hidden, gate_out, cd)
        self.swap = swap

    def forward(self, feats, geom: VoxelGeom, match, temp_emb, groups: int):
        p = self.latent(match)                         # [V, (G,) c4]
        # each voxel takes its batch item's row of temp(t). Written as a
        # one-hot product (exact: one 1.0 per row) and not as an indexed
        # gather, whose backward adds all V rows into B rows one after the
        # other on the card; this one's backward is one GEMM over the voxels
        t_emb = self.temp(temp_emb)                    # [B, c4]
        items = torch.arange(t_emb.shape[0], device=t_emb.device)
        onehot = (geom.coords[:, :1] == items).to(t_emb.dtype)    # [V, B]
        t_vox = onehot @ t_emb
        if groups > 1:
            t_vox = t_vox[:, None, :].expand(p.shape)
        w = self.latemp(torch.cat([t_vox, p] if self.swap else [p, t_vox],
                                  dim=-1)).to(feats.dtype)
        V = feats.shape[0]
        w = torch.where(geom.mask.reshape((V,) + (1,) * (w.dim() - 1)), w,
                        0.0)
        return (feats.reshape(V, groups, -1)
                * w.reshape(V, groups, -1)).reshape(V, -1)

    def apply_table(self, feats, geom: VoxelGeom, rows, bank, temp_emb):
        """`forward` with match = bank[rows] (zeros off the mask), computed
        as in eval mode: a voxel's gate depends only on its matched bank
        row, its item and t, so the MLPs run once per (item, bank row)
        pair, the same operations on the same values as per voxel, and
        `ops/gate.py` `gate_apply` takes each voxel's row of that table.
        rows [V, G] int32 indexes bank [Nb, c4]; temp_emb [B, temb]."""
        with prof.annotate("lidiff.model.gate"):
            p = self.latent(bank)                          # [Nb, c4]
            t_emb = self.temp(temp_emb)                    # [B, c4]
            B, Nb = t_emb.shape[0], p.shape[0]
            pb = p[None].expand(B, Nb, -1)
            tb = t_emb[:, None].expand(B, Nb, -1)
            table = self.latemp(torch.cat([tb, pb] if self.swap else [pb, tb],
                                          dim=-1)).to(feats.dtype)
            gate_counters["table_calls"] += 1
            gate_counters["table_rows"] += B * Nb
            return gate_apply(feats, table.reshape(B * Nb, -1), rows,
                              geom.coords, geom.mask, Nb)


class MinkUNetDiff(_Stages):
    """Conditional denoiser; per-point noise prediction [B, N, 3], or
    [B, N, G, 3] for G conditioning banks fused into one grouped pass."""

    def __init__(self, out_dim: int = 96, cr: float = 1.0,
                 compute_dtype=torch.float32, conv_quant: bool = False,
                 remat: bool = True):
        super().__init__()
        cs = _channels(cr)
        cd, cq = compute_dtype, conv_quant
        self.out_dim = out_dim
        self.compute_dtype = cd
        self.remat = remat

        def gate(out, hidden, swap=False):
            return StageGate(out, hidden, cs[4], out_dim, swap, cd)

        self.Stem_0 = Stem(3, cs[0], cd, cq)
        self.gate_s1 = gate(cs[0], cs[4])
        self.DownStage_0 = DownStage(cs[0], cs[0], cs[1], cd, cq)
        self.gate_s2 = gate(cs[1], cs[4])
        self.DownStage_1 = DownStage(cs[1], cs[1], cs[2], cd, cq)
        self.gate_s3 = gate(cs[2], cs[4])
        self.DownStage_2 = DownStage(cs[2], cs[2], cs[3], cd, cq)
        self.gate_s4 = gate(cs[3], cs[4])
        self.DownStage_3 = DownStage(cs[3], cs[3], cs[4], cd, cq)
        self.gate_u1 = gate(cs[4], cs[4], swap=True)
        self.UpStage_0 = UpStage(cs[4], cs[3], cs[5], cd, cq)
        self.gate_u2 = gate(cs[5], cs[5])
        self.UpStage_1 = UpStage(cs[5], cs[2], cs[6], cd, cq)
        self.gate_u3 = gate(cs[6], cs[6])
        self.UpStage_2 = UpStage(cs[6], cs[1], cs[7], cd, cq)
        self.gate_u4 = gate(cs[7], cs[7])
        self.UpStage_3 = UpStage(cs[7], cs[0], cs[8], cd, cq)
        self.head = MLP(cs[8], 20, 3, cd)

    def forward(self, pyr: Pyramid, banks, t: torch.Tensor):
        """banks: list of (part_feats [V4, c4], part_geom VoxelGeom), one per
        group; t: [B] int timesteps."""
        G = len(banks)
        cd = self.compute_dtype
        # bf16 eval: the activation stream runs in the compute dtype;
        # training keeps float32 activations
        # (lidiff_tpu/models/minkunet.py:153,188)
        vox_feats = pyr.vox_feats
        if not self.training:
            banks = [(pf.to(cd), pg) for pf, pg in banks]
            vox_feats = vox_feats.to(cd)
        lv = pyr.levels
        temp = timestep_embedding(t, self.out_dim)

        # one 1-NN match per level and bank, shared by the down and up
        # stages on that level; each bank's index is built once and kept
        nb = pyr.point2voxel.shape[0]
        if self.training:
            def level_match(l):
                ms = [match_features(l.geom.coords, l.geom.mask, pg.coords,
                                     pg.mask, pf, n_batch=nb,
                                     compute_dtype=cd, index=pg.nn_index(nb))
                      for pf, pg in banks]
                return ms[0] if G == 1 else torch.stack(ms, dim=1)
            match = [level_match(l) for l in lv]

            def gate_at(module, x, i):
                return module(x, lv[i].geom, match[i], temp, G)
        else:
            # eval: the matches give rows of the banks stacked into one,
            # and each gate is a table over (item, bank row) pairs
            bank = torch.cat([pf for pf, _ in banks])

            def level_rows(l):
                rs, start = [], 0
                for pf, pg in banks:
                    r = nn_match(l.geom.coords, pg.coords, pg.mask, nb,
                                 l.geom.mask, pg.nn_index(nb))
                    rs.append(r + start if start else r)
                    start += pf.shape[0]
                return torch.stack(rs, dim=1)
            rows = [level_rows(l) for l in lv]

            def gate_at(module, x, i):
                return module.apply_table(x, lv[i].geom, rows[i], bank, temp)

        # the stem input is the same for every group: run it once, tile
        x0 = self.Stem_0(vox_feats, lv[0])
        x0 = x0.repeat(1, G)
        g0 = gate_at(self.gate_s1, x0, 0)
        x1 = self.stage(self.DownStage_0, g0, lv[0], lv[1], G)
        g1 = gate_at(self.gate_s2, x1, 1)
        x2 = self.stage(self.DownStage_1, g1, lv[1], lv[2], G)
        g2 = gate_at(self.gate_s3, x2, 2)
        x3 = self.stage(self.DownStage_2, g2, lv[2], lv[3], G)
        g3 = gate_at(self.gate_s4, x3, 3)
        x4 = self.stage(self.DownStage_3, g3, lv[3], lv[4], G)

        g4 = gate_at(self.gate_u1, x4, 4)
        y1 = self.stage(self.UpStage_0, g4, x3, lv[3], G)
        g5 = gate_at(self.gate_u2, y1, 3)
        y2 = self.stage(self.UpStage_1, g5, x2, lv[2], G)
        g6 = gate_at(self.gate_u3, y2, 2)
        y3 = self.stage(self.UpStage_2, g6, x1, lv[1], G)
        g7 = gate_at(self.gate_u4, y3, 1)
        y4 = self.stage(self.UpStage_3, g7, x0, lv[0], G)

        pt = slice_to_points(y4, pyr.point2voxel)         # [B, N, G*C]
        if G > 1:
            pt = pt.reshape(pt.shape[0], pt.shape[1], G, -1)
        return self.head(pt)


class MinkUNet(_Stages):
    """Unconditional UNet of the refiner: per-point head Linear ->
    LeakyReLU -> Linear -> Tanh with out_channels = 3 * up_factor; returns
    [B, N, out_channels] float32."""

    def __init__(self, out_channels: int = 18, cr: float = 1.0,
                 compute_dtype=torch.float32, conv_quant: bool = False,
                 remat: bool = True):
        super().__init__()
        cs = _channels(cr)
        cd, cq = compute_dtype, conv_quant
        self.compute_dtype = cd
        self.remat = remat
        self.Stem_0 = Stem(3, cs[0], cd, cq)
        self.DownStage_0 = DownStage(cs[0], cs[0], cs[1], cd, cq)
        self.DownStage_1 = DownStage(cs[1], cs[1], cs[2], cd, cq)
        self.DownStage_2 = DownStage(cs[2], cs[2], cs[3], cd, cq)
        self.DownStage_3 = DownStage(cs[3], cs[3], cs[4], cd, cq)
        self.UpStage_0 = UpStage(cs[4], cs[3], cs[5], cd, cq)
        self.UpStage_1 = UpStage(cs[5], cs[2], cs[6], cd, cq)
        self.UpStage_2 = UpStage(cs[6], cs[1], cs[7], cd, cq)
        self.UpStage_3 = UpStage(cs[7], cs[0], cs[8], cd, cq)
        self.head = MLP(cs[8], 20, out_channels, cd)

    def forward(self, pyr: Pyramid):
        lv = pyr.levels
        # the eval stream runs in the compute dtype, training keeps float32
        # activations (lidiff_tpu/models/minkunet.py:245-246)
        vox_feats = pyr.vox_feats
        if not self.training:
            vox_feats = vox_feats.to(self.compute_dtype)
        x0 = self.Stem_0(vox_feats, lv[0])
        x1 = self.stage(self.DownStage_0, x0, lv[0], lv[1], 1)
        x2 = self.stage(self.DownStage_1, x1, lv[1], lv[2], 1)
        x3 = self.stage(self.DownStage_2, x2, lv[2], lv[3], 1)
        x4 = self.stage(self.DownStage_3, x3, lv[3], lv[4], 1)
        y1 = self.stage(self.UpStage_0, x4, x3, lv[3], 1)
        y2 = self.stage(self.UpStage_1, y1, x2, lv[2], 1)
        y3 = self.stage(self.UpStage_2, y2, x1, lv[1], 1)
        y4 = self.stage(self.UpStage_3, y3, x0, lv[0], 1)
        return torch.tanh(self.head(slice_to_points(y4, pyr.point2voxel)))
