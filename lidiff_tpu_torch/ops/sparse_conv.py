"""Sparse convolutions over precomputed kernel maps, eval paths
(counterpart of lidiff_tpu/ops/sparse_conv.py:92-431).

`feats` of a grouped conv is [V, G*C], group-major: G independent feature
sets over the same geometry, convolved with the same weights. The sampler
runs the classifier-free cond and uncond streams as G=2.

The 27-tap column conv is kernel A1 (`csrc/conv3_columns.cu`) for CUDA
tensors and its plain PyTorch version, `conv3_columns_plain`, for CPU
tensors. Both accumulate all 27 taps in float32 and cast once, as the TPU
kernel does (lidiff_tpu/ops/pallas_conv.py:800-832). The down and transpose
convs are one dense GEMM each plus a gather or scatter, in plain PyTorch.
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
    f = feats.float().reshape(V, G, C)
    w3 = weights.float().reshape(9, 3 * C, Co)
    m0 = hit[:, 0::3].long()
    m1 = hit[:, 1::3].long()
    p = col_idx.long()
    acc = torch.zeros(V * G, Co, dtype=torch.float32, device=feats.device)
    for col in range(9):
        rows = torch.stack([p[:, col], p[:, col] + m0[:, col],
                            p[:, col] + m0[:, col] + m1[:, col]], 1)
        rows = rows.clamp(max=V - 1)
        slab = f[rows] * hit[:, 3 * col:3 * col + 3, None, None]  # [V,3,G,C]
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
    be masked out by `out_mask` (valid voxels come first)."""
    out_dtype = out_dtype or feats.dtype
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
