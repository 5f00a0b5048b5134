"""Building blocks over the sparse engine (counterpart of
lidiff_tpu/models/blocks.py).

Submodules carry the flax names of the JAX package (`SparseConv_0`,
`MaskedBatchNorm_1`, `Dense_0`, ...) so that `lidiff_tpu_torch.convert`
maps a JAX parameter tree onto them one to one. Grouped modules take the
group count G at call time: G feature sets, group-major in [V, G*C], share
every parameter. `module.training` takes the place of the JAX modules'
`train` argument. In eval mode BatchNorm runs with its running statistics
and, where it follows a conv, is folded into the conv's weights and bias. In
train mode the conv runs, then BatchNorm over the batch moments with the
ReLU (and a residual block's add) as its epilogue (`ops/batchnorm.py`
`masked_bn_train`); the convs differentiate through `Conv3ColumnsFunction`,
and a group count above 1 raises: grouped BatchNorm is inference-only.
`conv_quant` selects the int8 eval conv (kernel A4) for the 27-tap convs
with a folded BN in eval mode (see `sparse_conv_columns` for the gate).
`remat` runs a stage under activation checkpointing: its activations are
recomputed in the backward pass, and its BatchNorm running statistics move
in the first forward only.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from lidiff_tpu_torch.ops.batchnorm import masked_bn_train, normalize_plain
from lidiff_tpu_torch.ops.grid import DownMap, LevelGeom
from lidiff_tpu_torch.ops.sparse_conv import sparse_conv, sparse_conv_transpose
from lidiff_tpu_torch.utils import prof


def he_uniform_(t: torch.Tensor, fan_in: int, gen: torch.Generator):
    """He-uniform over the fan-in, as lidiff_tpu/models/blocks.py:22-27."""
    bound = math.sqrt(6.0 / fan_in)
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=gen) * (2 * bound) - bound)


class SparseConv(nn.Module):
    """Sparse conv over any kernel map (`sparse_conv`): the 27-tap column
    conv, the ks=2/stride-2 down conv over a DownMap, or the gather form
    over a KernelMap; kernel [taps, Cin, Cout]."""

    def __init__(self, cin: int, cout: int, taps: int = 27,
                 compute_dtype=torch.float32, conv_quant: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(taps, cin, cout))
        self.compute_dtype = compute_dtype
        self.conv_quant = conv_quant

    def forward(self, feats, kmap, out_mask, groups: int, w_scale=None,
                bias=None, relu: bool = False):
        w = self.kernel if w_scale is None else self.kernel * w_scale
        return sparse_conv(feats, kmap, w, out_mask, groups=groups,
                           bias=bias, relu=relu,
                           compute_dtype=self.compute_dtype,
                           quant=self.conv_quant)


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


# True while `remat` recomputes a stage's forward in the backward pass
_RECOMPUTING = contextvars.ContextVar("lidiff_recomputing", default=False)


def remat(stage: nn.Module, *args):
    """stage(*args) under non-reentrant activation checkpointing (the
    counterpart of nn.remat in lidiff_tpu/models/minkunet.py:47-56): the
    stage keeps only its inputs, and the backward pass runs its forward
    again to get the tensors its gradient needs. The recompute leaves the
    BatchNorm running statistics as the first forward left them, as JAX
    keeps the first forward's `batch_stats`. Nothing in a stage draws
    random numbers, so no RNG state is stashed. In a trace the recompute
    is the span `lidiff.model.recompute`."""
    calls = 0

    def run(*a):
        nonlocal calls
        token = _RECOMPUTING.set(calls > 0)
        span = prof.annotate("lidiff.model.recompute") if calls > 0 \
            else contextlib.nullcontext()
        calls += 1
        try:
            with span:
                return stage(*a)
        finally:
            _RECOMPUTING.reset(token)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over valid voxels, torch BatchNorm1d semantics: in train
    mode the batch's biased variance normalizes and the running estimates
    take the unbiased one with momentum 0.1 (not while `remat` recomputes
    the forward); in eval mode the running statistics normalize. Invalid
    rows are 0; then `residual` is added and a ReLU applied where the call
    asks for them. Train mode is `ops/batchnorm.py` `masked_bn_train`: on
    CUDA tensors one autograd function on hand-written kernels, the
    epilogue included."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.group = None      # process group of synced BN (set_bn_group)

    def affine(self):
        """(k, c) with y = x * k + c, used to fold BN into a conv."""
        k = self.scale * torch.rsqrt(self.var + self.eps)
        return k, self.bias - self.mean * k

    def forward(self, feats, mask, groups: int, relu: bool = False,
                residual=None):
        if self.training:
            if groups != 1:
                raise ValueError("grouped BatchNorm is inference-only")
            # the gradient flows through the batch moments
            y, mean, var, cnt = masked_bn_train(
                feats, mask, self.scale, self.bias, self.eps, self.group,
                relu=relu, residual=residual)
            if not _RECOMPUTING.get():
                with torch.no_grad():
                    m = self.momentum
                    unbiased = var * cnt / (cnt - 1.0).clamp(min=1.0)
                    self.mean.copy_((1 - m) * self.mean + m * mean)
                    self.var.copy_((1 - m) * self.var + m * unbiased)
            return y
        # the running statistics, shared by the groups
        return normalize_plain(feats, mask, self.mean.repeat(groups),
                               self.var.repeat(groups),
                               self.scale.repeat(groups),
                               self.bias.repeat(groups), self.eps, relu,
                               residual)


def set_bn_group(model: nn.Module, group) -> None:
    """Every MaskedBatchNorm of `model` takes its training moments over the
    ranks of the process `group` (synced BN, the counterpart of the JAX
    modules' `axis_name`); None keeps them to this process."""
    for m in model.modules():
        if isinstance(m, MaskedBatchNorm):
            m.group = group


class ConvBNReLU(nn.Module):
    """Conv + BN + ReLU, BN folded into the conv in eval mode; taps=8 is
    the ks=2/stride-2 down conv."""

    def __init__(self, cin: int, cout: int, taps: int = 27,
                 compute_dtype=torch.float32, conv_quant: bool = False):
        super().__init__()
        self.SparseConv_0 = SparseConv(cin, cout, taps, compute_dtype,
                                       conv_quant)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(cout)

    def forward(self, feats, kmap, out_mask, groups: int):
        if self.training:
            x = self.SparseConv_0(feats, kmap, out_mask, groups)
            return self.MaskedBatchNorm_0(x, out_mask, groups, relu=True)
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
        return self.MaskedBatchNorm_0(x, fine_mask, groups, relu=True)


class ResidualBlock(nn.Module):
    """Two 27-tap conv+BN (the first with ReLU) plus a shortcut: identity,
    or a bias-free 1x1 Dense + BN (not folded) when the width changes."""

    def __init__(self, cin: int, cout: int, compute_dtype=torch.float32,
                 conv_quant: bool = False):
        super().__init__()
        self.SparseConv_0 = SparseConv(cin, cout, 27, compute_dtype,
                                       conv_quant)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(cout)
        self.SparseConv_1 = SparseConv(cout, cout, 27, compute_dtype,
                                       conv_quant)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(cout)
        if cin != cout:
            self.Dense_0 = nn.Linear(cin, cout, bias=False)
            self.MaskedBatchNorm_2 = MaskedBatchNorm(cout)

    def forward(self, feats, kmap, mask, groups: int):
        if self.training:
            x = self.SparseConv_0(feats, kmap, mask, groups)
            x = self.MaskedBatchNorm_0(x, mask, groups, relu=True)
            x = self.SparseConv_1(x, kmap, mask, groups)
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
        if self.training:
            # the shortcut's add and the ReLU in BatchNorm's epilogue
            return self.MaskedBatchNorm_1(x, mask, groups, relu=True,
                                          residual=short)
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
                 compute_dtype=torch.float32, conv_quant: bool = False):
        super().__init__()
        self.ConvBNReLU_0 = ConvBNReLU(cin, mid, 8, compute_dtype)
        self.ResidualBlock_0 = ResidualBlock(mid, out, compute_dtype,
                                             conv_quant)
        self.ResidualBlock_1 = ResidualBlock(out, out, compute_dtype,
                                             conv_quant)

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
                 compute_dtype=torch.float32, conv_quant: bool = False):
        super().__init__()
        self.DeconvBNReLU_0 = DeconvBNReLU(cin, up_ch, compute_dtype)
        self.ResidualBlock_0 = ResidualBlock(up_ch + skip, up_ch,
                                             compute_dtype, conv_quant)
        self.ResidualBlock_1 = ResidualBlock(up_ch, up_ch, compute_dtype,
                                             conv_quant)

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

    def __init__(self, cin: int, features: int, compute_dtype=torch.float32,
                 conv_quant: bool = False):
        super().__init__()
        self.ConvBNReLU_0 = ConvBNReLU(cin, features, 27, compute_dtype,
                                       conv_quant)
        self.ConvBNReLU_1 = ConvBNReLU(features, features, 27, compute_dtype,
                                       conv_quant)

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
