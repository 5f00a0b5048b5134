"""Building blocks over the sparse engine (counterpart of
lidiff_tpu/models/blocks.py).

Submodules carry the flax names of the JAX package (`SparseConv_0`,
`MaskedBatchNorm_1`, `Dense_0`, ...) so that `lidiff_tpu_torch.convert`
maps a JAX parameter tree onto them one to one. Grouped modules take the
group count G at call time: G feature sets, group-major in [V, G*C], share
every parameter. `module.training` takes the place of the JAX modules'
`train` argument. In eval mode BatchNorm runs with its running statistics
and, where it follows a conv, is folded into the conv's weights and bias. In
train mode the conv, BatchNorm over the batch moments and ReLU run one after
the other, the convs differentiate through `Conv3ColumnsFunction`, and a
group count above 1 raises: grouped BatchNorm is inference-only.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from lidiff_tpu_torch.ops.grid import ColumnKernelMap, DownMap, LevelGeom
from lidiff_tpu_torch.ops.sparse_conv import (masked_moments,
                                              sparse_conv_columns,
                                              sparse_conv_down,
                                              sparse_conv_transpose)


def he_uniform_(t: torch.Tensor, fan_in: int, gen: torch.Generator):
    """He-uniform over the fan-in, as lidiff_tpu/models/blocks.py:22-27."""
    bound = math.sqrt(6.0 / fan_in)
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=gen) * (2 * bound) - bound)


class SparseConv(nn.Module):
    """27-tap conv over a column kernel map, or the ks=2/stride-2 down conv
    over a DownMap; kernel [taps, Cin, Cout]."""

    def __init__(self, cin: int, cout: int, taps: int = 27,
                 compute_dtype=torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(taps, cin, cout))
        self.compute_dtype = compute_dtype

    def forward(self, feats, kmap, out_mask, groups: int, w_scale=None,
                bias=None, relu: bool = False):
        w = self.kernel if w_scale is None else self.kernel * w_scale
        if isinstance(kmap, ColumnKernelMap):
            return sparse_conv_columns(feats, kmap, w, out_mask,
                                       groups=groups, bias=bias, relu=relu,
                                       compute_dtype=self.compute_dtype)
        if isinstance(kmap, DownMap):
            return sparse_conv_down(feats, kmap.parent_idx, kmap.tap, w,
                                    out_mask, groups=groups, bias=bias,
                                    relu=relu,
                                    compute_dtype=self.compute_dtype)
        raise TypeError(f"unsupported kernel map {type(kmap).__name__}")


class SparseConvTranspose(nn.Module):
    """ks=2 / stride-2 transpose conv onto the finer level."""

    def __init__(self, cin: int, cout: int, compute_dtype=torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(8, cin, cout))
        self.compute_dtype = compute_dtype

    def forward(self, coarse_feats, parent_idx, tap, fine_mask, groups: int):
        return sparse_conv_transpose(coarse_feats, parent_idx, tap,
                                     self.kernel, fine_mask, groups=groups,
                                     compute_dtype=self.compute_dtype)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over valid voxels, torch BatchNorm1d semantics: in train
    mode the batch's biased variance normalizes and the running estimates
    take the unbiased one with momentum 0.1; in eval mode the running
    statistics normalize."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def affine(self):
        """(k, c) with y = x * k + c, used to fold BN into a conv."""
        k = self.scale * torch.rsqrt(self.var + self.eps)
        return k, self.bias - self.mean * k

    def forward(self, feats, mask, groups: int):
        if self.training:
            if groups != 1:
                raise ValueError("grouped BatchNorm is inference-only")
            # the gradient flows through the batch moments
            mean, var, cnt = masked_moments(feats, mask)
            with torch.no_grad():
                m = self.momentum
                unbiased = var * cnt / (cnt - 1.0).clamp(min=1.0)
                self.mean.copy_((1 - m) * self.mean + m * mean)
                self.var.copy_((1 - m) * self.var + m * unbiased)
        else:
            mean, var = self.mean.repeat(groups), self.var.repeat(groups)
        scale, bias = self.scale.repeat(groups), self.bias.repeat(groups)
        if feats.dtype == torch.float32:
            y = (feats - mean) * torch.rsqrt(var + self.eps) * scale + bias
        else:
            # low-precision activations: the affine runs in their dtype
            # (lidiff_tpu/models/blocks.py:111-121)
            k = scale * torch.rsqrt(var + self.eps)
            c = bias - mean * k
            y = feats * k.to(feats.dtype) + c.to(feats.dtype)
        return torch.where(mask[:, None], y, 0.0)


class ConvBNReLU(nn.Module):
    """Conv + BN + ReLU, BN folded into the conv in eval mode; taps=8 is
    the ks=2/stride-2 down conv."""

    def __init__(self, cin: int, cout: int, taps: int = 27,
                 compute_dtype=torch.float32):
        super().__init__()
        self.SparseConv_0 = SparseConv(cin, cout, taps, compute_dtype)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(cout)

    def forward(self, feats, kmap, out_mask, groups: int):
        if self.training:
            x = self.SparseConv_0(feats, kmap, out_mask, groups)
            return F.relu(self.MaskedBatchNorm_0(x, out_mask, groups))
        k, c = self.MaskedBatchNorm_0.affine()
        return self.SparseConv_0(feats, kmap, out_mask, groups, w_scale=k,
                                 bias=c, relu=True)


class DeconvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, compute_dtype=torch.float32):
        super().__init__()
        self.SparseConvTranspose_0 = SparseConvTranspose(cin, cout,
                                                         compute_dtype)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(cout)

    def forward(self, coarse_feats, parent_idx, tap, fine_mask, groups: int):
        x = self.SparseConvTranspose_0(coarse_feats, parent_idx, tap,
                                       fine_mask, groups)
        return F.relu(self.MaskedBatchNorm_0(x, fine_mask, groups))


class ResidualBlock(nn.Module):
    """Two 27-tap conv+BN (the first with ReLU) plus a shortcut: identity,
    or a bias-free 1x1 Dense + BN (not folded) when the width changes."""

    def __init__(self, cin: int, cout: int, compute_dtype=torch.float32):
        super().__init__()
        self.SparseConv_0 = SparseConv(cin, cout, 27, compute_dtype)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(cout)
        self.SparseConv_1 = SparseConv(cout, cout, 27, compute_dtype)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(cout)
        if cin != cout:
            self.Dense_0 = nn.Linear(cin, cout, bias=False)
            self.MaskedBatchNorm_2 = MaskedBatchNorm(cout)

    def forward(self, feats, kmap, mask, groups: int):
        if self.training:
            x = self.SparseConv_0(feats, kmap, mask, groups)
            x = F.relu(self.MaskedBatchNorm_0(x, mask, groups))
            x = self.SparseConv_1(x, kmap, mask, groups)
            x = self.MaskedBatchNorm_1(x, mask, groups)
        else:
            k1, c1 = self.MaskedBatchNorm_0.affine()
            x = self.SparseConv_0(feats, kmap, mask, groups, w_scale=k1,
                                  bias=c1, relu=True)
            k2, c2 = self.MaskedBatchNorm_1.affine()
            x = self.SparseConv_1(x, kmap, mask, groups, w_scale=k2, bias=c2)
        if hasattr(self, "Dense_0"):
            # 1x1 conv per group, in the activation dtype
            V = feats.shape[0]
            fin = feats.reshape(V, groups, -1)
            short = F.linear(fin, self.Dense_0.weight.to(fin.dtype))
            short = self.MaskedBatchNorm_2(short.reshape(V, -1), mask, groups)
        else:
            short = feats
        return F.relu(x + short)


class MLP(nn.Module):
    """Linear -> LeakyReLU(0.1) -> Linear; the GEMMs run in the compute
    dtype and the output is float32."""

    def __init__(self, cin: int, hidden: int, out: int,
                 compute_dtype=torch.float32, negative_slope: float = 0.1):
        super().__init__()
        self.Dense_0 = nn.Linear(cin, hidden)
        self.Dense_1 = nn.Linear(hidden, out)
        self.compute_dtype = compute_dtype
        self.negative_slope = negative_slope

    def forward(self, x):
        dt = self.compute_dtype
        d0, d1 = self.Dense_0, self.Dense_1
        x = F.linear(x.to(dt), d0.weight.to(dt), d0.bias.to(dt))
        x = F.leaky_relu(x, self.negative_slope)
        x = F.linear(x, d1.weight.to(dt), d1.bias.to(dt))
        return x.float()


def group_concat(a, b, groups: int):
    """[V, G*Ca] ++ [V, G*Cb] -> [V, G*(Ca+Cb)], concatenating per group."""
    V = a.shape[0]
    return torch.cat([a.reshape(V, groups, -1), b.reshape(V, groups, -1)],
                     dim=-1).reshape(V, -1)


class DownStage(nn.Module):
    """ks=2/stride-2 down conv (child form) + two residual blocks on the
    coarser level."""

    def __init__(self, cin: int, mid: int, out: int,
                 compute_dtype=torch.float32):
        super().__init__()
        self.ConvBNReLU_0 = ConvBNReLU(cin, mid, 8, compute_dtype)
        self.ResidualBlock_0 = ResidualBlock(mid, out, compute_dtype)
        self.ResidualBlock_1 = ResidualBlock(out, out, compute_dtype)

    def forward(self, feats, fine: LevelGeom, coarse: LevelGeom,
                groups: int):
        mask = coarse.geom.mask
        x = self.ConvBNReLU_0(feats, DownMap(fine.parent_idx, fine.up_tap),
                              mask, groups)
        x = self.ResidualBlock_0(x, coarse.kmap3, mask, groups)
        return self.ResidualBlock_1(x, coarse.kmap3, mask, groups)


class UpStage(nn.Module):
    """Transpose conv onto the finer level, concat with the skip, two
    residual blocks."""

    def __init__(self, cin: int, skip: int, up_ch: int,
                 compute_dtype=torch.float32):
        super().__init__()
        self.DeconvBNReLU_0 = DeconvBNReLU(cin, up_ch, compute_dtype)
        self.ResidualBlock_0 = ResidualBlock(up_ch + skip, up_ch,
                                             compute_dtype)
        self.ResidualBlock_1 = ResidualBlock(up_ch, up_ch, compute_dtype)

    def forward(self, coarse_feats, skip_feats, fine: LevelGeom,
                groups: int):
        mask = fine.geom.mask
        y = self.DeconvBNReLU_0(coarse_feats, fine.parent_idx, fine.up_tap,
                                mask, groups)
        y = group_concat(y, skip_feats, groups)
        y = self.ResidualBlock_0(y, fine.kmap3, mask, groups)
        return self.ResidualBlock_1(y, fine.kmap3, mask, groups)


class Stem(nn.Module):
    """Two 27-tap conv+BN+ReLU at stride 1."""

    def __init__(self, cin: int, features: int, compute_dtype=torch.float32):
        super().__init__()
        self.ConvBNReLU_0 = ConvBNReLU(cin, features, 27, compute_dtype)
        self.ConvBNReLU_1 = ConvBNReLU(features, features, 27, compute_dtype)

    def forward(self, feats, level: LevelGeom, groups: int = 1):
        mask = level.geom.mask
        x = self.ConvBNReLU_0(feats, level.kmap3, mask, groups)
        return self.ConvBNReLU_1(x, level.kmap3, mask, groups)


def init_weights(module: nn.Module, gen: torch.Generator) -> None:
    """Seeded random init: He-uniform sparse-conv kernels and shortcut
    Dense layers (fan-in = taps * Cin, resp. Cin), LeCun-normal MLP layers
    with zero bias, BatchNorm as identity. Draws on the CPU generator, so
    a seed gives the same weights on every device."""
    for m in module.modules():
        if isinstance(m, (SparseConv, SparseConvTranspose)):
            taps, cin, _ = m.kernel.shape
            he_uniform_(m.kernel, taps * cin, gen)
        elif isinstance(m, ResidualBlock) and hasattr(m, "Dense_0"):
            he_uniform_(m.Dense_0.weight, m.Dense_0.in_features, gen)
        elif isinstance(m, MLP):
            for d in (m.Dense_0, m.Dense_1):
                with torch.no_grad():
                    d.weight.copy_(torch.randn(d.weight.shape, generator=gen)
                                   / math.sqrt(d.in_features))
                    d.bias.zero_()
        elif isinstance(m, MaskedBatchNorm):
            with torch.no_grad():
                m.scale.fill_(1.0)
                m.bias.zero_()
                m.mean.zero_()
                m.var.fill_(1.0)
