"""Batched 1-NN coordinate matching (counterpart of lidiff_tpu/ops/knn.py).

For every query voxel, the index of the nearest valid reference voxel of
the same batch item, ranked by |r|^2 - 2 q.r (the per-query |q|^2 never
changes an argmin), ties to the first index; a batch item with no valid
reference gives index 0, as the XLA path's argmin over all-penalized rows
does. Kernel C1 (`csrc/nn_match.cu`) computes it for CUDA tensors, its
plain PyTorch version `nn_match_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from lidiff_tpu_torch.ops import native

_BIG = 1e18

_nn_kernel = native.Kernel(
    "nn_match", "nn_match",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])


def nn_match_plain(q_coords, r_coords, r_mask, block: int = 8192):
    """Plain PyTorch version of kernel C1. Distances are formed in float64,
    which holds them exactly (|c| <= 2047 keeps them below 2^27)."""
    Vq = q_coords.shape[0]
    rc = r_coords.double()
    r_xyz = rc[:, 1:]
    r_sq = (r_xyz * r_xyz).sum(-1)
    out = torch.empty(Vq, dtype=torch.int32, device=q_coords.device)
    for s in range(0, Vq, block):
        q = q_coords[s:s + block].double()
        d = r_sq[None, :] - 2.0 * (q[:, 1:] @ r_xyz.T)
        penal = (q[:, 0:1] != rc[None, :, 0]) | ~r_mask[None, :]
        d = torch.where(penal, torch.full_like(d, _BIG), d)
        out[s:s + block] = torch.argmin(d, dim=1).to(torch.int32)
    return out


def nn_match(q_coords, r_coords, r_mask, n_batch: int = 0):
    """Kernel C1 on CUDA tensors, its plain version on CPU tensors.

    q_coords [Vq, 4] and r_coords [Vr, 4] int32 (batch, x, y, z), r_mask
    [Vr] bool. `n_batch == 1` lets the kernel drop the batch compare.
    Returns [Vq] int32."""
    if q_coords.device.type == "cpu":
        return nn_match_plain(q_coords, r_coords, r_mask)
    if q_coords.device.type != "cuda":
        raise ValueError(f"nn_match: unsupported device {q_coords.device}")
    Vq, Vr = q_coords.shape[0], r_coords.shape[0]
    if q_coords.dtype != torch.int32 or r_coords.dtype != torch.int32 \
            or r_mask.dtype != torch.bool:
        raise ValueError("nn_match: want int32 coords and a bool mask")
    if q_coords.shape != (Vq, 4) or r_coords.shape != (Vr, 4) \
            or r_mask.shape != (Vr,) or Vq == 0 or Vr == 0:
        raise ValueError("nn_match: shape mismatch")
    native.check_cuda("nn_match", q_coords, r_coords, r_mask)
    out = torch.empty(Vq, dtype=torch.int32, device=q_coords.device)
    _nn_kernel(native.ptr(q_coords), Vq, native.ptr(r_coords),
               native.ptr(r_mask), Vr, int(n_batch != 1), native.ptr(out),
               native.stream(q_coords.device))
    return out


def match_features(q_coords, q_mask, r_coords, r_mask, r_feats,
                   n_batch: int = 0, compute_dtype=torch.float32):
    """Nearest reference voxel's features per query, zeros for invalid
    queries; the gather runs in the compute dtype."""
    idx = nn_match(q_coords, r_coords, r_mask, n_batch)
    out = r_feats.to(compute_dtype)[idx.long()].to(r_feats.dtype)
    return out * q_mask[:, None]
