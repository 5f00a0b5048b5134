"""Voxel-coordinate keys (counterpart of lidiff_tpu/ops/keys.py).

The JAX package packs (batch, x, y, z) into a lexicographic pair of int32
keys because the TPU emulates int64:

    hi = batch * 2^12 + (x + 2048)
    lo = (y + 2048) * 2^12 + (z + 2048)

The GPU has native int64, so the port keeps ONE key `(hi << 32) | lo`.
Both halves are non-negative int32, so int64 order equals the pair's
lexicographic order, and the padding sentinel (HI_PAD, LO_PAD) =
(INT32_MAX, INT32_MAX) stays the largest key: padding rows sort last.
"""

from __future__ import annotations

import torch

COORD_BITS = 12
COORD_SPAN = 1 << COORD_BITS          # 4096
COORD_OFF = COORD_SPAN // 2           # 2048
COORD_MIN = -COORD_OFF
COORD_MAX = COORD_OFF - 1
INT32_MAX = 2 ** 31 - 1
HI_PAD = INT32_MAX
LO_PAD = INT32_MAX
PAD_KEY = (HI_PAD << 32) | LO_PAD


def key_of(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Combine an int32 (hi, lo) pair into the int64 key."""
    return (hi.to(torch.int64) << 32) | lo.to(torch.int64)


def pack(batch: torch.Tensor, coords: torch.Tensor):
    """(batch [..], coords [.., 3]) -> (key [..] int64, valid [..] bool).

    Out-of-range coordinates give PAD_KEY and valid=False, so they sort to
    the end and never match a lookup.
    """
    c = coords.to(torch.int64)
    valid = ((c >= COORD_MIN) & (c <= COORD_MAX)).all(dim=-1)
    hi = batch.to(torch.int64) * COORD_SPAN + (c[..., 0] + COORD_OFF)
    lo = (c[..., 1] + COORD_OFF) * COORD_SPAN + (c[..., 2] + COORD_OFF)
    key = (hi << 32) | lo
    return torch.where(valid, key, torch.full_like(key, PAD_KEY)), valid


def unpack(key: torch.Tensor):
    """Inverse of `pack` (valid keys only): returns (batch, coords[.., 3])
    as int32."""
    hi = key >> 32
    lo = key & 0xFFFFFFFF
    b = hi // COORD_SPAN
    x = hi % COORD_SPAN - COORD_OFF
    y = lo // COORD_SPAN - COORD_OFF
    z = lo % COORD_SPAN - COORD_OFF
    return b.to(torch.int32), torch.stack([x, y, z], dim=-1).to(torch.int32)


def lexsort(key: torch.Tensor, *values: torch.Tensor):
    """Stable sort of the int64 keys; co-sorts `values`.
    Returns (key_sorted, *values_sorted)."""
    key_s, order = torch.sort(key, stable=True)
    return (key_s,) + tuple(v[order] for v in values)


def pair_less(ah, al, bh, bl):
    """Lexicographic (ah, al) < (bh, bl) on int32 pairs: the JAX package's
    comparison, which the int64 key order reproduces."""
    return key_of(ah, al) < key_of(bh, bl)


def searchsorted_pair(keys: torch.Tensor, q: torch.Tensor):
    """Lower bound of `q` in the sorted `keys`. Returns (idx, found); idx is
    clamped to len-1 as in the JAX package (keys.py:116)."""
    n = keys.shape[0]
    idx = torch.searchsorted(keys, q).clamp(max=n - 1)
    return idx, keys[idx] == q
