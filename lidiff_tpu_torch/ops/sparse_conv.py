"""Sparse convolutions over precomputed kernel maps (counterpart of
lidiff_tpu/ops/sparse_conv.py:92-460).

`feats` of a grouped conv is [V, G*C], group-major: G independent feature
sets over the same geometry, convolved with the same weights. The sampler
runs the classifier-free cond and uncond streams as G=2.

The 27-tap column conv is kernel A1 (`csrc/conv3_columns.cu`) for CUDA
tensors and its plain PyTorch version, `conv3_columns_plain`, for CPU
tensors. Both accumulate all 27 taps in float32 and cast once, as the TPU
kernel does (lidiff_tpu/ops/pallas_conv.py:800-832). The down and transpose
convs are one dense GEMM each plus a gather or scatter, in plain PyTorch,
and differentiate through autograd.

Training differentiates the column conv through `Conv3ColumnsFunction`
(kernel A2, counterpart of conv_columns_pallas_ad,
lidiff_tpu/ops/pallas_conv.py:667-719): the feats gradient is kernel A1 on
the masked cotangent with tap-reversed, transposed weights over the same
map, and the weight gradient is kernel A3 (`csrc/conv3_columns_dw.cu`),
with `conv3_columns_dw_plain` as its plain version.
"""

from __future__ import annotations

import ctypes

import torch

from lidiff_tpu_torch.ops import native
from lidiff_tpu_torch.ops.grid import ColumnKernelMap

# Kernel A1 takes these (input, output) dtype pairs; the codes match
# csrc/conv3_columns.cu.
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.float32)}
MAX_CIN = 384

_conv3_kernel = native.Kernel(
    "conv3_columns", "conv3_columns",
    [ctypes.c_int, ctypes.c_int,                       # dtype codes
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # feats, col, hit
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # w, bias, mask
     ctypes.c_void_p, ctypes.c_void_p,                   # nvalid, out
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # V C Co G
     ctypes.c_int, ctypes.c_void_p])                     # relu, stream

_conv3_dw_kernel = native.Kernel(
    "conv3_columns_dw", "conv3_columns_dw",
    [ctypes.c_int,                                       # dtype code
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # feats, g, col
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # hit, mask, nvalid
     ctypes.c_void_p,                                    # dw
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # V C Co G
     ctypes.c_void_p])                                   # stream


def _column_slabs(f, col_idx, hit):
    """For each of the 9 columns, the slab [V, 3, G, C] of float32 feats
    `f` [V, G, C]: the rows p, p+m0, p+m0+m1 of the column's three z-taps,
    zeroed where the tap's hit is 0."""
    V = f.shape[0]
    m0 = hit[:, 0::3].long()
    m1 = hit[:, 1::3].long()
    p = col_idx.long()
    for col in range(9):
        rows = torch.stack([p[:, col], p[:, col] + m0[:, col],
                            p[:, col] + m0[:, col] + m1[:, col]], 1)
        rows = rows.clamp(max=V - 1)
        yield f[rows] * hit[:, 3 * col:3 * col + 3, None, None]


def conv3_columns_plain(feats, col_idx, hit, weights, out_mask, groups,
                        bias=None, relu=False, out_dtype=None):
    """Plain PyTorch version of kernel A1; the same function as the XLA
    path lidiff_tpu/ops/sparse_conv.py:170-232 with no window, but with
    float32 accumulation over all 27 taps and one final cast.

    feats [V, G*C] and weights [27, C, Co] in the compute dtype; bias [Co]
    float32 or None; out_mask [V] bool. Returns [V, G*Co] in out_dtype."""
    V = feats.shape[0]
    _, C, Co = weights.shape
    G = groups
    w3 = weights.float().reshape(9, 3 * C, Co)
    acc = torch.zeros(V * G, Co, dtype=torch.float32, device=feats.device)
    slabs = _column_slabs(feats.float().reshape(V, G, C), col_idx, hit)
    for col, slab in enumerate(slabs):
        slab = slab.permute(0, 2, 1, 3).reshape(V * G, 3 * C)
        acc += slab @ w3[col]
    out = acc.reshape(V, G, Co)
    if bias is not None:
        out = out + bias.float()
    if relu:
        out = out.clamp(min=0)
    out = torch.where(out_mask[:, None, None], out, 0.0)
    return out.reshape(V, G * Co).to(out_dtype or feats.dtype)


def conv3_columns(feats, col_idx, hit, weights, out_mask, groups, *,
                  bias=None, relu=False, out_dtype=None, nvalid=None):
    """Kernel A1 on CUDA tensors, its plain version on CPU tensors.

    `nvalid` ([] int32 on the device) lets the kernel write whole tiles of
    rows at or past it as zeros without reading anything; those rows must
    be masked out by `out_mask` (valid voxels come first).

    With autograd enabled and feats or weights requiring a gradient, the
    call goes through `Conv3ColumnsFunction`; the bias/ReLU epilogue is the
    eval-only BN fold and raises there."""
    out_dtype = out_dtype or feats.dtype
    if torch.is_grad_enabled() and (feats.requires_grad
                                    or weights.requires_grad):
        if bias is not None or relu:
            raise ValueError("conv3_columns: the bias/ReLU epilogue is "
                             "eval-only and has no gradient")
        return Conv3ColumnsFunction.apply(feats, weights, col_idx, hit,
                                          out_mask, nvalid, groups, out_dtype)
    return _conv3_run(feats, col_idx, hit, weights, out_mask, groups, bias,
                      relu, out_dtype, nvalid)


def _conv3_run(feats, col_idx, hit, weights, out_mask, groups, bias, relu,
               out_dtype, nvalid):
    """One launch of kernel A1 (CUDA) or one plain conv (CPU); no autograd."""
    if feats.device.type == "cpu":
        return conv3_columns_plain(feats, col_idx, hit, weights, out_mask,
                                   groups, bias, relu, out_dtype)
    if feats.device.type != "cuda":
        raise ValueError(f"conv3_columns: unsupported device {feats.device}")
    V = feats.shape[0]
    Kt, C, Co = weights.shape
    G = groups
    if (feats.dtype, out_dtype) not in _PAIRS or weights.dtype != feats.dtype:
        raise ValueError(f"conv3_columns: dtypes {feats.dtype}->{out_dtype}, "
                         f"weights {weights.dtype}")
    if Kt != 27 or feats.shape != (V, G * C) or col_idx.shape != (V, 9) \
            or hit.shape != (V, 27) or out_mask.shape != (V,) or V == 0:
        raise ValueError("conv3_columns: shape mismatch")
    if C > MAX_CIN or G not in (1, 2):
        raise ValueError(f"conv3_columns: C={C} > {MAX_CIN} or G={G}")
    if col_idx.dtype != torch.int32 or hit.dtype != torch.bool \
            or out_mask.dtype != torch.bool:
        raise ValueError("conv3_columns: want int32 col_idx, bool hit/mask")
    if (feats.data_ptr() | weights.data_ptr()) % 16:
        raise ValueError("conv3_columns: feats and weights must start on a "
                         "16-byte boundary (the kernel's vector loads)")
    if nvalid is None:
        nvalid = torch.full((), V, dtype=torch.int32, device=feats.device)
    if bias is not None:
        bias = bias.float().contiguous()
        if bias.shape != (Co,):
            raise ValueError("conv3_columns: bias shape")
    nvalid = nvalid.to(torch.int32)
    native.check_cuda("conv3_columns", feats, col_idx, hit, weights,
                      out_mask, nvalid, *([bias] if bias is not None else []))
    out = torch.empty(V, G * Co, dtype=out_dtype, device=feats.device)
    _conv3_kernel(_DTYPE_CODE[feats.dtype], _DTYPE_CODE[out_dtype],
                  native.ptr(feats), native.ptr(col_idx), native.ptr(hit),
                  native.ptr(weights), native.ptr(bias), native.ptr(out_mask),
                  native.ptr(nvalid), native.ptr(out), V, C, Co, G,
                  int(relu), native.stream(feats.device))
    return out


def conv3_columns_dw_plain(feats, g, col_idx, hit, out_mask, groups):
    """Plain PyTorch version of kernel A3, the column conv's weight
    gradient (the math of conv_columns_pallas_dw_v2,
    lidiff_tpu/ops/pallas_conv.py:568):

        dW[k, c, co] = sum_o sum_g hit(o, k) feats_g[idx(o, k), c] g_g[o, co]

    with the cotangent `g` [V, G*Co] masked by `out_mask`: per column and
    group one slab^T @ g product, float32 throughout. Returns [27, C, Co]
    float32."""
    V = feats.shape[0]
    G = groups
    C = feats.shape[1] // G
    Co = g.shape[1] // G
    gm = torch.where(out_mask[:, None], g.float(), 0.0).reshape(V, G, Co)
    dw = torch.zeros(9, 3 * C, Co, dtype=torch.float32, device=feats.device)
    slabs = _column_slabs(feats.float().reshape(V, G, C), col_idx, hit)
    for col, slab in enumerate(slabs):
        for gi in range(G):
            dw[col] += slab[:, :, gi].reshape(V, 3 * C).T @ gm[:, gi]
    return dw.reshape(27, C, Co)


def conv3_columns_dw(feats, g, col_idx, hit, out_mask, groups, *,
                     nvalid=None):
    """Kernel A3 on CUDA tensors, its plain version on CPU tensors.

    feats [V, G*C] in the compute dtype; the cotangent `g` [V, G*Co] is
    cast to feats' dtype first, as the TPU kernel does
    (lidiff_tpu/ops/pallas_conv.py:604). Rows at or past `nvalid` must be
    masked out by `out_mask`. Returns dW [27, C, Co] float32; blocks add
    their partial sums with float32 atomics, so the order of the sum over
    rows changes from run to run."""
    g = g.to(feats.dtype).contiguous()
    if feats.device.type == "cpu":
        return conv3_columns_dw_plain(feats, g, col_idx, hit, out_mask,
                                      groups)
    if feats.device.type != "cuda":
        raise ValueError(f"conv3_columns_dw: unsupported device "
                         f"{feats.device}")
    V, G = feats.shape[0], groups
    if feats.dtype not in _DTYPE_CODE:
        raise ValueError(f"conv3_columns_dw: dtype {feats.dtype}")
    if G not in (1, 2) or feats.shape[1] % G or g.shape[1] % G:
        raise ValueError(f"conv3_columns_dw: G={G} does not split the "
                         "channels")
    C, Co = feats.shape[1] // G, g.shape[1] // G
    if g.shape[0] != V or col_idx.shape != (V, 9) or hit.shape != (V, 27) \
            or out_mask.shape != (V,) or V == 0:
        raise ValueError("conv3_columns_dw: shape mismatch")
    if C > MAX_CIN or Co > MAX_CIN:
        raise ValueError(f"conv3_columns_dw: C={C} or Co={Co} > {MAX_CIN}")
    if col_idx.dtype != torch.int32 or hit.dtype != torch.bool \
            or out_mask.dtype != torch.bool:
        raise ValueError("conv3_columns_dw: want int32 col_idx, bool "
                         "hit/mask")
    if (feats.data_ptr() | g.data_ptr()) % 16:
        raise ValueError("conv3_columns_dw: feats and g must start on a "
                         "16-byte boundary (the kernel's vector loads)")
    if nvalid is None:
        nvalid = torch.full((), V, dtype=torch.int32, device=feats.device)
    nvalid = nvalid.to(torch.int32)
    native.check_cuda("conv3_columns_dw", feats, g, col_idx, hit, out_mask,
                      nvalid)
    dw = torch.zeros(27, C, Co, dtype=torch.float32, device=feats.device)
    _conv3_dw_kernel(_DTYPE_CODE[feats.dtype], native.ptr(feats),
                     native.ptr(g), native.ptr(col_idx), native.ptr(hit),
                     native.ptr(out_mask), native.ptr(nvalid), native.ptr(dw),
                     V, C, Co, G, native.stream(feats.device))
    return dw


class Conv3ColumnsFunction(torch.autograd.Function):
    """Kernel A2: the differentiable column conv, no epilogue (BN runs
    separately in training).

    The backward rule is the TPU package's (_ad_bwd,
    lidiff_tpu/ops/pallas_conv.py:691-716), not autograd of the plain conv:
    the cotangent is masked by `out_mask` and cast to feats' dtype; the
    feats gradient is the same conv on it with the weights tap-reversed and
    transposed, over the same map, in feats' dtype; the weight gradient is
    kernel A3, cast to the weights' dtype. The flipped conv is the exact
    gradient where the map is symmetric (voxel i is o's tap k exactly when
    o is i's tap 26 - k), which holds for a level's own 27-tap map with
    `out_mask` the level's mask. CPU tensors take the plain versions of both
    kernels under the same rule."""

    # feats-gradient launches of kernel A1 made by `backward` (they also
    # count as launches of A1)
    launches = 0

    @staticmethod
    def forward(ctx, feats, weights, col_idx, hit, out_mask, nvalid, groups,
                out_dtype):
        ctx.save_for_backward(feats, weights, col_idx, hit, out_mask, nvalid)
        ctx.groups = groups
        return _conv3_run(feats, col_idx, hit, weights, out_mask, groups,
                          None, False, out_dtype, nvalid)

    @staticmethod
    def backward(ctx, g):
        feats, weights, col_idx, hit, out_mask, nvalid = ctx.saved_tensors
        g = torch.where(out_mask[:, None], g, 0.0).to(feats.dtype)
        g = g.contiguous()
        df = dw = None
        if ctx.needs_input_grad[0]:
            w_rev = weights.flip(0).transpose(1, 2).contiguous()
            before = _conv3_kernel.launches
            df = _conv3_run(g, col_idx, hit, w_rev, out_mask, ctx.groups,
                            None, False, feats.dtype, nvalid)
            Conv3ColumnsFunction.launches += _conv3_kernel.launches - before
        if ctx.needs_input_grad[1]:
            dw = conv3_columns_dw(feats, g, col_idx, hit, out_mask,
                                  ctx.groups, nvalid=nvalid)
            dw = dw.to(weights.dtype)
        return df, dw, None, None, None, None, None, None


def sparse_conv_columns(feats, kmap: ColumnKernelMap, weights, out_mask, *,
                        groups: int = 1, bias=None, relu: bool = False,
                        compute_dtype=torch.float32):
    """27-tap sparse conv over a column kernel map with the fused
    bias/ReLU/mask epilogue. Inputs and weights are cast to
    `compute_dtype`; the output keeps feats' dtype."""
    return conv3_columns(feats.to(compute_dtype).contiguous(), kmap.col_idx,
                         kmap.hit, weights.to(compute_dtype).contiguous(),
                         out_mask, groups, bias=bias, relu=relu,
                         out_dtype=feats.dtype, nvalid=kmap.nvalid)


def sparse_conv_down(feats, parent_idx, tap, weights, out_mask, *,
                     groups: int = 1, bias=None, relu: bool = False,
                     compute_dtype=torch.float32):
    """ks=2 / stride-2 down conv in child form: one GEMM against all 8 tap
    weights, a tap select, and a scatter-add into the parents.

    As in the JAX package (sparse_conv.py:363-369) the selected products
    are cast to the compute dtype BEFORE the scatter-add, so in bf16 a
    parent's n <= 8 children sum in bf16. On CUDA `index_add_` adds them in
    atomic order, so two runs, or the card and the CPU, may differ. With
    A = the sum over the parent's children and input channels of
    |feat| * |weight|, each child's GEMM output is within one bf16 ulp
    (2^-7 A) and each of the n - 1 bf16 adds within half an ulp of its
    partial sum, so a bf16 result is within n * 2^-7 * A of any other
    order, plus one ulp of the output when it is bf16 as well."""
    Kt, Cin, Cout = weights.shape
    G = groups
    Vf = feats.shape[0]
    Vc = out_mask.shape[0]
    out_dtype = feats.dtype
    cf = feats.to(compute_dtype)
    w_all = weights.to(compute_dtype).permute(1, 0, 2).reshape(Cin, Kt * Cout)
    ok = parent_idx < Vc
    y = torch.matmul(cf.reshape(Vf * G, Cin), w_all).float()
    y = y.reshape(Vf, G, Kt, Cout)
    sel = tap.long().clamp(0, Kt - 1)[:, None, None, None].expand(Vf, G, 1,
                                                                  Cout)
    ysel = torch.gather(y, 2, sel)[:, :, 0] * ok[:, None, None]
    ysel = ysel.reshape(Vf, G * Cout).to(compute_dtype)
    out = torch.zeros(Vc + 1, G * Cout, dtype=compute_dtype,
                      device=feats.device)
    out.index_add_(0, parent_idx.long().clamp(max=Vc), ysel)
    out = out[:Vc].float()
    if bias is not None:
        out = out + bias.float().repeat(G)
    if relu:
        out = out.clamp(min=0)
    return (out * out_mask[:, None]).to(out_dtype)


def sparse_conv_transpose(coarse_feats, parent_idx, tap, weights, fine_mask,
                          *, groups: int = 1, compute_dtype=torch.float32):
    """ks=2 / stride-2 transpose conv: out[v] = coarse[parent(v)] @
    W[tap(v)], as one GEMM of all 8 taps per coarse voxel and a row gather.
    G > 1 runs each group through the same GEMM as extra rows, which
    computes what the JAX package's block-diagonal GEMM does
    (sparse_conv.py:413-429)."""
    Kt, Cin, Cout = weights.shape
    G = groups
    Vc = coarse_feats.shape[0]
    out_dtype = coarse_feats.dtype
    cf = coarse_feats.to(compute_dtype).reshape(Vc * G, Cin)
    w_all = weights.to(compute_dtype).permute(1, 0, 2).reshape(Cin, Kt * Cout)
    y = torch.matmul(cf, w_all).to(out_dtype).reshape(Vc, G, Kt, Cout)
    pidx = parent_idx.long().clamp(max=Vc - 1)
    o = y[pidx, :, tap.long()]                        # [V_f, G, Cout]
    ok = (parent_idx < Vc) & fine_mask
    return (o * ok[:, None, None]).reshape(-1, G * Cout)


def masked_moments(feats, mask):
    """Per-channel mean and biased variance over the valid voxels, and
    their count (counterpart of lidiff_tpu/ops/sparse_conv.py:434-460,
    one device). The sums are float32 whatever feats' dtype;
    var = max(s2 / cnt - mean^2, 0) and cnt = max(sum(mask), 1)."""
    mv = mask.to(feats.dtype)
    fm = feats * mv[:, None]
    s1 = fm.float().sum(0)
    s2 = (fm * feats).float().sum(0)
    cnt = mv.float().sum().clamp(min=1.0)
    mean = s1 / cnt
    var = (s2 / cnt - mean * mean).clamp(min=0.0)
    return mean, var, cnt
