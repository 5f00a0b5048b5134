"""Training-mode masked BatchNorm, with its epilogue (a residual added, then
a ReLU), in one autograd function.

`masked_bn_train` normalizes x [V, C] over its valid rows (`mask`) by the
batch's one-pass moments (lidiff_tpu/ops/sparse_conv.py:434-460: cnt =
max(cnt, 1), mean = s1 / cnt, var = max(s2 / cnt - mean^2, 0)), applies
the affine, zeroes the invalid rows, adds `residual` if one is given and
then applies a ReLU if `relu` is asked for. A CUDA tensor (float32 or
bf16) goes through `MaskedBatchNormFunction` on the hand-written kernels
of `csrc/masked_bn.cu`; a CPU tensor through the plain PyTorch version
(`masked_moments`, `normalize_plain`), differentiated by autograd. The
plain backward in closed form, which the kernels compute, is
`masked_bn_backward_plain`.

`counters` counts the training-mode calls by path; each kernel wrapper
also counts its launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from lidiff_tpu_torch.ops import native

# dtype codes of csrc/masked_bn.cu
_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_BLOCKS = 2048   # rows of the reductions' partials (kMaxBlocks)

counters = {"fused": 0, "plain": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_stats_kernel = native.Kernel(
    "masked_bn", "masked_bn_stats",
    [_I, _P, _P, _I, _I, _P, _P, _P])      # code x mask rows C partial sums s
_moments_kernel = native.Kernel(
    "masked_bn", "masked_bn_moments",
    [_P, _I, ctypes.c_float, _P, _P, _P])  # sums C eps stats cnt stream
_apply_kernel = native.Kernel(
    "masked_bn", "masked_bn_apply",
    [_I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P])
    # code x mask stats scale bias residual relu out rows C stream
_grad_kernel = native.Kernel(
    "masked_bn", "masked_bn_grad",
    [_I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P])
    # code x out dy mask stats relu rows C partial sums stream
_dx_kernel = native.Kernel(
    "masked_bn", "masked_bn_dx",
    [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _P])
    # code x out dy mask stats scale sums cnt relu dx dres rows C stream


def _one_pass(x, mask, group):
    """(mean, s2 / cnt - mean^2 before the clamp, cnt), differentiable."""
    mv = mask.to(x.dtype)
    fm = x * mv[:, None]
    s1 = fm.float().sum(0)
    s2 = (fm * x).float().sum(0)
    cnt = mv.float().sum()
    if group is not None:
        from lidiff_tpu_torch.parallel.mesh import all_reduce_sum
        C = s1.shape[0]
        sums = all_reduce_sum(torch.cat([cnt[None], s1, s2]), group)
        cnt, s1, s2 = sums[0], sums[1:C + 1], sums[C + 1:]
    cnt = cnt.clamp(min=1.0)
    mean = s1 / cnt
    return mean, s2 / cnt - mean * mean, cnt


def masked_moments(feats, mask, group=None):
    """Per-channel mean and biased variance over the valid voxels, and
    their count (counterpart of lidiff_tpu/ops/sparse_conv.py:434-460).
    The sums are float32 whatever feats' dtype. With a process `group`
    (the counterpart of `axis_name`) the count and both sums are summed
    over its ranks by one all-reduce whose backward all-reduces the
    gradient, as JAX's psum transposes to a psum, so the gradient flows
    through the global moments. Then cnt = max(cnt, 1),
    var = max(s2 / cnt - mean^2, 0)."""
    mean, raw, cnt = _one_pass(feats, mask, group)
    return mean, raw.clamp(min=0.0), cnt


def moments_plain(x, mask, eps: float, group=None):
    """(mean, var, rstd, vok, cnt) as `masked_bn_stats` and
    `masked_bn_moments` compute them: `masked_moments`, rstd =
    rsqrt(var + eps), and vok 1 where the variance clamp passed the
    gradient (s2 / cnt - mean^2 >= 0), else 0."""
    mean, raw, cnt = _one_pass(x, mask, group)
    var = raw.clamp(min=0.0)
    return mean, var, torch.rsqrt(var + eps), (raw >= 0).float(), cnt


def normalize_plain(x, mask, mean, var, scale, bias, eps: float,
                    relu: bool = False, residual=None):
    """where(mask, (x - mean) * rsqrt(var + eps) * scale + bias, 0), then
    + residual, then ReLU, in plain PyTorch: `MaskedBatchNorm` in eval
    mode, and in train mode on CPU tensors. float32 x runs the affine in
    float32; other dtypes run it as x * k + c in x's dtype
    (lidiff_tpu/models/blocks.py:111-121)."""
    if x.dtype == torch.float32:
        y = (x - mean) * torch.rsqrt(var + eps) * scale + bias
    else:
        k = scale * torch.rsqrt(var + eps)
        c = bias - mean * k
        y = x * k.to(x.dtype) + c.to(x.dtype)
    y = torch.where(mask[:, None], y, 0.0)
    if residual is not None:
        y = y + residual
    return F.relu(y) if relu else y


def masked_bn_backward_plain(dout, x, mask, out, mean, rstd, vok, cnt,
                             scale, relu: bool = False,
                             residual: bool = False, group=None):
    """The gradients of `masked_bn_train` in closed form, as
    `masked_bn_grad` and `masked_bn_dx` compute them, in plain PyTorch.
    With g = dout, zeroed where `relu` and out <= 0, xh = (x - mean) *
    rstd and m the mask, over the valid rows:

        dbias = sum m g,  dscale = sum m g xh,
        dx = m rstd scale (g - Sg / n - xh vok Sgx / n),  dresidual = g,

    n the forward's count, vok 0 where the variance clamp was active. Sg
    and Sgx are dbias and dscale, summed over the `group`'s ranks where
    there is one (the transpose of the forward's all-reduce); dbias and
    dscale stay this rank's. Returns (dx, dscale, dbias, dresidual or
    None)."""
    g = dout.float()
    if relu:
        g = torch.where(out <= 0, 0.0, g)
    m = mask[:, None]
    xh = (x.float() - mean) * rstd
    dbias = torch.where(m, g, 0.0).sum(0)
    dscale = torch.where(m, g * xh, 0.0).sum(0)
    sg, sgx = dbias, dscale
    if group is not None:
        import torch.distributed as dist
        sums = torch.cat([dbias, dscale])
        dist.all_reduce(sums, group=group)
        sg, sgx = sums.split(dbias.shape[0])
    dx = torch.where(m, rstd * scale * (g - sg / cnt - xh * (sgx * vok / cnt)),
                     0.0)
    return (dx.to(x.dtype), dscale, dbias,
            g.to(dout.dtype) if residual else None)


class MaskedBatchNormFunction(torch.autograd.Function):
    """Training-mode masked BatchNorm with its epilogue on the card
    (`csrc/masked_bn.cu`). Forward: `masked_bn_stats` (the count and both
    sums, in a fixed order), an all-reduce of them over `group` where
    there is one, `masked_bn_moments`, `masked_bn_apply`. Backward:
    `masked_bn_grad` (dbias and dscale, this rank's), their all-reduce
    over the group, `masked_bn_dx` (dx, and dresidual with a residual).
    Saves x, the output (where `relu`: the ReLU's gate) and the [C]
    moments. Returns (out, mean, var, cnt); only out has a gradient."""

    @staticmethod
    def forward(ctx, x, mask, scale, bias, eps, group, relu, residual):
        V, C = x.shape
        if mask.shape != (V,) or mask.dtype != torch.bool:
            raise ValueError("masked_bn: want a bool mask [V]")
        if scale.shape != (C,) or bias.shape != (C,) or \
                scale.dtype != torch.float32 or bias.dtype != torch.float32:
            raise ValueError("masked_bn: want float32 scale and bias [C]")
        x, mask = x.contiguous(), mask.contiguous()
        scale, bias = scale.contiguous(), bias.contiguous()
        if residual is not None:
            residual = residual.contiguous()
        native.check_cuda("masked_bn", x, mask, scale, bias,
                          *([] if residual is None else [residual]))
        code, stream = _CODE[x.dtype], native.stream(x.device)
        f32 = {"dtype": torch.float32, "device": x.device}
        partial = torch.empty(MAX_BLOCKS, 2 * C + 1, **f32)
        sums = torch.empty(2 * C + 1, **f32)
        _stats_kernel(code, native.ptr(x), native.ptr(mask), V, C,
                      native.ptr(partial), native.ptr(sums), stream)
        if group is not None:
            import torch.distributed as dist
            dist.all_reduce(sums, group=group)
        stats = torch.empty(4, C, **f32)         # mean, var, rstd, vok
        cnt = torch.empty((), **f32)
        _moments_kernel(native.ptr(sums), C, ctypes.c_float(eps),
                        native.ptr(stats), native.ptr(cnt), stream)
        out = torch.empty_like(x)
        _apply_kernel(code, native.ptr(x), native.ptr(mask),
                      native.ptr(stats), native.ptr(scale), native.ptr(bias),
                      native.ptr(residual), int(relu), native.ptr(out), V, C,
                      stream)
        ctx.save_for_backward(x, mask, out if relu else None, stats, cnt,
                              scale)
        ctx.group, ctx.relu = group, relu
        ctx.residual = residual is not None
        mean, var = stats[0], stats[1]
        ctx.mark_non_differentiable(mean, var, cnt)
        return out, mean, var, cnt

    @staticmethod
    def backward(ctx, dout, *_):
        x, mask, out, stats, cnt, scale = ctx.saved_tensors
        V, C = x.shape
        dout = dout.contiguous()
        code, stream = _CODE[x.dtype], native.stream(x.device)
        f32 = {"dtype": torch.float32, "device": x.device}
        partial = torch.empty(MAX_BLOCKS, 2 * C, **f32)
        sums = torch.empty(2 * C, **f32)          # [dbias, dscale]
        _grad_kernel(code, native.ptr(x), native.ptr(out), native.ptr(dout),
                     native.ptr(mask), native.ptr(stats), int(ctx.relu), V,
                     C, native.ptr(partial), native.ptr(sums), stream)
        dbias, dscale = sums[:C], sums[C:]
        if ctx.group is not None:
            import torch.distributed as dist
            sums = sums.clone()
            dist.all_reduce(sums, group=ctx.group)
        dx = torch.empty_like(x)
        dres = torch.empty_like(x) if ctx.residual else None
        _dx_kernel(code, native.ptr(x), native.ptr(out), native.ptr(dout),
                   native.ptr(mask), native.ptr(stats), native.ptr(scale),
                   native.ptr(sums), native.ptr(cnt), int(ctx.relu),
                   native.ptr(dx), native.ptr(dres), V, C, stream)
        return dx, None, dscale, dbias, None, None, None, dres


def masked_bn_train(x, mask, scale, bias, eps: float, group=None,
                    relu: bool = False, residual=None):
    """Training-mode masked BatchNorm of x [V, C] over its valid rows,
    then + `residual` ([V, C], x's dtype) and ReLU where asked: returns
    (out, mean, var, cnt), the moments over the `group`'s ranks where
    there is one. CUDA tensors of float32 or bf16 go through
    `MaskedBatchNormFunction`, other CUDA dtypes raise; CPU tensors take
    the plain version."""
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype):
        raise ValueError("masked_bn: the residual must match x")
    if x.device.type == "cpu":
        counters["plain"] += 1
        mean, var, cnt = masked_moments(x, mask, group)
        out = normalize_plain(x, mask, mean, var, scale, bias, eps, relu,
                              residual)
        return out, mean, var, cnt
    if x.device.type != "cuda" or x.dtype not in _CODE or x.dim() != 2:
        raise ValueError(f"masked_bn: unsupported x ({x.dtype} "
                         f"{tuple(x.shape)} on {x.device})")
    counters["fused"] += 1
    return MaskedBatchNormFunction.apply(x, mask, scale, bias, eps, group,
                                         relu, residual)
