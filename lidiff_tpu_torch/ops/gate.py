"""The eval-mode conditioning gate's apply step (kernel GA).

In eval mode a `StageGate`'s value at a voxel depends only on the bank row
its 1-NN match picked, its batch item and the step's timestep; the model
evaluates the gate's MLPs once per (item, bank row) pair into a table
[B * n_bank, C] (`models/minkunet.py` `StageGate.apply_table`) and
`gate_apply` applies it:

    w = mask[v] ? table[coords[v, 0] * n_bank + rows[v, g]] : 0
    out[v, g * C:(g + 1) * C] = feats[v, g * C:(g + 1) * C] * w

CUDA tensors (float32 or bf16) go through `csrc/gate_apply.cu`, one launch;
CPU tensors through `gate_apply_plain` (index, `where`, multiply), which is
the definition. Both give the same bits: the product in float32, rounded
once to feats' dtype.

`counters` counts the mechanism's work: the tables built (`table_calls`),
the rows the gate MLPs ran on for them (`table_rows`: B * n_bank each) and
the V * G rows gated (`gated_rows`); the kernel wrapper counts its
launches.
"""

from __future__ import annotations

import ctypes

import torch

from lidiff_tpu_torch.ops import native

# dtype codes of csrc/gate_apply.cu
_CODE = {torch.float32: 0, torch.bfloat16: 1}

counters = {"table_calls": 0, "table_rows": 0, "gated_rows": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_apply_kernel = native.Kernel(
    "gate_apply", "gate_apply",
    [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P])
    # code feats table rows coords mask out V G C n_bank stream


def gate_apply_plain(feats, table, rows, coords, mask, n_bank: int):
    """Plain PyTorch version of `gate_apply`, and its definition: each
    valid row's table rows gathered, the masked rows' weights zeroed, the
    product taken in feats' dtype."""
    V, G = rows.shape
    r = coords[:, :1].long() * n_bank + rows.long()             # [V, G]
    w = table[torch.where(mask[:, None], r, 0)]                  # [V, G, C]
    w = torch.where(mask[:, None, None], w, 0.0)
    return (feats.reshape(V, G, -1) * w).reshape(V, -1)


def gate_apply(feats, table, rows, coords, mask, n_bank: int):
    """Gate feats [V, G * C] by the table [B * n_bank, C] (feats' dtype):
    row v, group g takes table row coords[v, 0] * n_bank + rows[v, g]
    where mask[v], and 0 elsewhere. rows [V, G] int32 (bank rows in
    [0, n_bank)), coords [V, 4] int32 (the item first, in [0, B) on valid
    rows), mask [V] bool. CUDA tensors go through kernel GA, CPU tensors
    through `gate_apply_plain`."""
    V, G = rows.shape
    counters["gated_rows"] += V * G
    if feats.device.type == "cpu":
        return gate_apply_plain(feats, table, rows, coords, mask, n_bank)
    if feats.device.type != "cuda" or feats.dtype not in _CODE \
            or table.dtype != feats.dtype:
        raise ValueError(f"gate_apply: unsupported feats {feats.dtype} on "
                         f"{feats.device}, table {table.dtype}")
    if rows.dtype != torch.int32 or coords.dtype != torch.int32 \
            or mask.dtype != torch.bool:
        raise ValueError("gate_apply: want int32 rows and coords, bool mask")
    if feats.dim() != 2 or feats.shape[0] != V or table.dim() != 2 \
            or feats.shape[1] != G * table.shape[1] \
            or coords.shape != (V, 4) or mask.shape != (V,) \
            or n_bank < 1 or table.shape[0] % n_bank:
        raise ValueError(f"gate_apply: shape mismatch (feats "
                         f"{tuple(feats.shape)}, table {tuple(table.shape)}, "
                         f"rows {tuple(rows.shape)}, coords "
                         f"{tuple(coords.shape)}, mask {tuple(mask.shape)}, "
                         f"n_bank {n_bank})")
    native.check_cuda("gate_apply", feats, table, rows, coords, mask)
    out = torch.empty_like(feats)
    _apply_kernel(_CODE[feats.dtype], native.ptr(feats), native.ptr(table),
                  native.ptr(rows), native.ptr(coords), native.ptr(mask),
                  native.ptr(out), V, G, table.shape[1], n_bank,
                  native.stream(feats.device))
    return out
