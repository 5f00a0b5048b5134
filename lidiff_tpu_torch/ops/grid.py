"""Fixed-capacity sparse voxel geometry (counterpart of
lidiff_tpu/ops/grid.py).

Every level has a static capacity V: valid voxels come first in key order,
padding rows carry PAD_KEY and mask=False. Coordinates stay in
original-resolution units at every level (multiples of the stride).

The 27-tap column kernel map is kernel B1 (`csrc/kmap3_columns.cu`) for
CUDA tensors and its plain PyTorch version, `kmap3_columns_plain`, for CPU
tensors. Each map carries the tile plan of the column conv's bf16 kernel
(`tile_plan`), and a level used as a conditioning bank its 1-NN index
(`VoxelGeom.nn_index`), each built on first use and kept.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Sequence

import torch

from lidiff_tpu_torch.ops import keys as K
from lidiff_tpu_torch.ops import native
from lidiff_tpu_torch.ops.knn import NNIndex, build_nn_index


@dataclass
class VoxelGeom:
    """One pyramid level: sorted int64 keys, int coords, mask."""
    key: torch.Tensor      # [V] int64, sorted, PAD_KEY for padding
    coords: torch.Tensor   # [V, 4] int32 (batch, x, y, z)
    mask: torch.Tensor     # [V] bool
    num: torch.Tensor      # [] int32, valid voxels (<= capacity)
    num_raw: torch.Tensor  # [] int32, unique voxels before the capacity clip
    stride: int = 1
    _nn: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def capacity(self) -> int:
        return self.key.shape[0]

    @property
    def overflow(self) -> torch.Tensor:
        """Voxels dropped by the capacity clip (the highest keys go)."""
        return (self.num_raw - self.capacity).clamp(min=0)

    def nn_index(self, n_batch: int = 0) -> NNIndex:
        """The level as a 1-NN bank: its kernel C1 index
        (`knn.build_nn_index`), built on first use and kept, one per batch
        mode (n_batch == 1 or not)."""
        batched = n_batch != 1
        if batched not in self._nn:
            self._nn[batched] = build_nn_index(self.coords, self.mask,
                                               n_batch)
        return self._nn[batched]


TILE_ROWS = 64   # rows of one tile of the column conv's bf16 kernel


@dataclass
class TilePlan:
    """Which products the column conv's bf16 kernel computes: the rows in
    plan order and, per 64 of them, the taps any of them hits. It changes
    no result, only which products are skipped (a tap no row of a tile
    hits adds zeros)."""
    order: torch.Tensor      # [V] int32, a permutation of the rows
    tile_taps: torch.Tensor  # [ceil(V / 64)] int32, bit k = tap k
    # kernel A3's state over the plan, made on first use
    # (`sparse_conv.DwPlan`)
    dw: object = field(default=None, repr=False, compare=False)


def hit_patterns(hit: torch.Tensor, mask: torch.Tensor | None = None):
    """[V] int32: bit k set where the row hits tap k (0 for masked rows)."""
    bits = torch.ones(27, dtype=torch.int32, device=hit.device) << \
        torch.arange(27, dtype=torch.int32, device=hit.device)
    pattern = (hit.to(torch.int32) * bits).sum(1, dtype=torch.int32)
    if mask is not None:
        pattern = torch.where(mask, pattern, 0)
    return pattern


def tile_taps(pattern: torch.Tensor):
    """[ceil(V / 64)] int32: the OR of the hit patterns of each 64
    consecutive rows (an OR tree of six steps)."""
    V = pattern.shape[0]
    T = -(-V // TILE_ROWS)
    taps = torch.zeros(T * TILE_ROWS, dtype=torch.int32,
                       device=pattern.device)
    taps[:V] = pattern
    taps = taps.view(T, TILE_ROWS)
    while taps.shape[1] > 1:
        taps = taps[:, 0::2] | taps[:, 1::2]
    return taps[:, 0].contiguous()


def tile_plan(hit: torch.Tensor, mask: torch.Tensor | None = None):
    """The tile plan of a map: `order` is a stable sort of the rows by
    their 27-bit hit pattern read as an integer (bit k = tap k, so tap 26
    is the most significant), rows that hit nothing last; stability keeps
    the key order, and so the locality of the gathers, within a pattern.
    `tile_taps` is the OR of the patterns of each 64 consecutive rows of
    `order`. Tensor ops on the map's device: one sort, one OR tree."""
    pattern = hit_patterns(hit, mask)
    key = torch.where(pattern == 0, 1 << 27, pattern)
    order = torch.sort(key, stable=True).indices.to(torch.int32)
    return TilePlan(order=order, tile_taps=tile_taps(pattern[order.long()]))


@dataclass
class ColumnKernelMap:
    """27-tap kernel map in column form. For each voxel and (dx, dy) column,
    `col_idx` is the lower bound of (b, x+dx*s, y+dy*s, z-s) in the level's
    keys; the column's z-taps z-s, z, z+s are hits m0, m1, m2 at rows p,
    p+m0, p+m0+m1. Tap order is x slowest, z fastest."""
    col_idx: torch.Tensor  # [V, 9] int32
    hit: torch.Tensor      # [V, 27] bool
    nvalid: torch.Tensor   # [] int32, valid rows (they come first)
    _plan: TilePlan | None = field(default=None, repr=False, compare=False)

    def plan(self) -> TilePlan:
        """The map's tile plan, built on first use and kept: every conv
        over the map shares it. The hits of invalid rows are 0, so no mask
        is needed."""
        if self._plan is None:
            self._plan = tile_plan(self.hit)
        return self._plan


@dataclass
class DownMap:
    """ks=2/stride-2 down-conv map in child form: every fine voxel's
    (parent, tap) slot."""
    parent_idx: torch.Tensor  # [V_fine] int32 (== V_coarse when invalid)
    tap: torch.Tensor         # [V_fine] int32 in [0, 8)


@dataclass
class LevelGeom:
    geom: VoxelGeom
    kmap3: ColumnKernelMap
    parent_idx: torch.Tensor | None = None  # [V] fine -> coarse
    up_tap: torch.Tensor | None = None      # [V] tap for the transpose conv


@dataclass
class Pyramid:
    levels: tuple             # LevelGeom, finest -> coarsest
    point2voxel: torch.Tensor  # [B, N] int32 into level-0 voxels
    vox_feats: torch.Tensor    # [V0, C] per-voxel mean features

    def overflows(self) -> torch.Tensor:
        """Dropped voxels per level [num_levels] int32."""
        return torch.stack([l.geom.overflow for l in self.levels])

    def window_overflows(self) -> torch.Tensor:
        """Always zero: a GPU row gather has no DMA window (the TPU kernels
        drop taps outside theirs, lidiff_tpu/ops/grid.py:410-420)."""
        return torch.zeros(len(self.levels), dtype=torch.int32,
                           device=self.point2voxel.device)


def _unique_sorted(key: torch.Tensor, capacity: int):
    """Shared tail of quantize/pool_geom: stable-sort `key`, number the
    unique valid keys, clip to `capacity` (overflow and invalid -> the
    sentinel `capacity`). Returns (key_s, order, vid, n_unique)."""
    key_s, order = torch.sort(key, stable=True)
    valid_s = key_s != K.PAD_KEY
    first = torch.ones_like(valid_s)
    first[1:] = key_s[1:] != key_s[:-1]
    head = first & valid_s
    n_unique = head.sum(dtype=torch.int32)
    vid = torch.cumsum(head, 0, dtype=torch.int32) - 1
    vid = torch.where(valid_s & (vid < capacity) & (vid >= 0), vid,
                      torch.full_like(vid, capacity))
    return key_s, order, vid, n_unique


def _level_from_keys(capacity: int, vid, key_s, n_unique, stride: int):
    key = torch.full((capacity + 1,), K.PAD_KEY, dtype=torch.int64,
                     device=key_s.device)
    key[vid.long()] = key_s
    key = key[:capacity].contiguous()
    mask = key != K.PAD_KEY
    b, c = K.unpack(key)
    coords = torch.cat([b[:, None], c], dim=1)
    coords = torch.where(mask[:, None], coords, torch.zeros_like(coords))
    return VoxelGeom(key=key, coords=coords.contiguous(), mask=mask,
                     num=n_unique.clamp(max=capacity),
                     num_raw=n_unique, stride=stride)


def quantize(points: torch.Tensor, resolution: float, capacity: int,
             feats: torch.Tensor | None = None):
    """Voxelize [B, N, 3] points with UNWEIGHTED_AVERAGE features.

    Voxel coordinate = round(p / resolution), half to even as in the JAX
    package. Returns (geom, vox_feats [V, C], point2voxel [B, N] int32,
    == capacity for points out of range or over capacity)."""
    B, N, _ = points.shape
    if feats is None:
        feats = points
    C = feats.shape[-1]
    dev = points.device
    flat_p = points.reshape(B * N, 3)
    flat_f = feats.reshape(B * N, C)
    c = torch.round(flat_p / resolution).to(torch.int32)
    b = torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(N)
    key, _ = K.pack(b, c)
    key_s, order, vid, n_unique = _unique_sorted(key, capacity)

    p2v = torch.empty(B * N, dtype=torch.int32, device=dev)
    p2v[order] = vid
    geom = _level_from_keys(capacity, vid, key_s, n_unique, stride=1)

    vidl = vid.long()
    sums = torch.zeros(capacity + 1, C, dtype=feats.dtype, device=dev)
    sums.index_add_(0, vidl, flat_f[order])
    cnts = torch.zeros(capacity + 1, dtype=torch.float32, device=dev)
    cnts.index_add_(0, vidl, torch.ones_like(vidl, dtype=torch.float32))
    vox_feats = sums[:capacity] / cnts[:capacity].clamp(min=1.0)[:, None]
    return geom, vox_feats, p2v.reshape(B, N)


def slice_to_points(vox_feats: torch.Tensor, point2voxel: torch.Tensor):
    """Per-point gather of voxel features; out-of-range points get zeros."""
    V = vox_feats.shape[0]
    idx = point2voxel.clamp(max=V - 1).long()
    ok = (point2voxel < V)[..., None]
    return torch.where(ok, vox_feats[idx], torch.zeros((), dtype=vox_feats.dtype,
                                                       device=vox_feats.device))


def pool_geom(geom: VoxelGeom, out_capacity: int):
    """Stride-2 coordinate pooling. Returns (geom_out with stride 2s,
    child2parent [V_in] int32, == out_capacity for invalid/overflow)."""
    s2 = geom.stride * 2
    parent_c = torch.div(geom.coords[:, 1:], s2, rounding_mode="floor") * s2
    key, valid = K.pack(geom.coords[:, 0], parent_c)
    key = torch.where(geom.mask & valid, key, torch.full_like(key, K.PAD_KEY))
    key_s, order, vid, n_unique = _unique_sorted(key, out_capacity)
    c2p = torch.empty(geom.capacity, dtype=torch.int32, device=key.device)
    c2p[order] = vid
    return _level_from_keys(out_capacity, vid, key_s, n_unique, s2), c2p


def up_maps(fine: VoxelGeom, child2parent: torch.Tensor):
    """Transpose-conv maps: (parent_idx [V_fine], tap [V_fine] in [0, 8)),
    tap order x slowest, z fastest."""
    bits = torch.remainder(
        torch.div(fine.coords[:, 1:], fine.stride, rounding_mode="floor"), 2)
    tap = bits[:, 0] * 4 + bits[:, 1] * 2 + bits[:, 2]
    return child2parent, tap.to(torch.int32)


# ---------------------------------------------------------------------------
# Kernel B1: the 27-tap column kernel map
# ---------------------------------------------------------------------------

_kmap3_kernel = native.Kernel(
    "kmap3_columns", "kmap3_columns",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])


def kmap3_columns_plain(key: torch.Tensor, coords: torch.Tensor,
                        mask: torch.Tensor, stride: int):
    """Plain PyTorch version of kernel B1; the same function as
    lidiff_tpu/ops/grid.py:309-354. Returns (col_idx [V, 9] int32,
    hit [V, 27] bool)."""
    s = stride
    V = key.shape[0]
    dev = key.device
    cols = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
    off = torch.tensor([[dx * s, dy * s, -s] for dx, dy in cols],
                       dtype=torch.int32, device=dev)          # [9, 3]
    base = coords[:, None, 1:] + off[None]                     # [V, 9, 3]
    b = coords[:, None, 0].expand(V, 9)
    q, q_valid = K.pack(b, base)
    q = torch.where(mask[:, None], q, torch.full_like(q, K.PAD_KEY))
    p, m0 = K.searchsorted_pair(key, q)
    # an out-of-range query packs to PAD_KEY, which equals the padding
    # rows' keys: q_valid keeps it from "hitting" them
    m0 = m0 & q_valid
    p1 = (p + m0).clamp(max=V - 1)
    m1 = key[p1] == q + s
    p2 = (p1 + m1).clamp(max=V - 1)
    m2 = key[p2] == q + 2 * s
    ok = mask[:, None] & q_valid
    hit = torch.stack([m0 & ok, m1 & ok, m2 & ok], dim=2).reshape(V, 27)
    return p.to(torch.int32), hit


def kmap3_columns(key: torch.Tensor, coords: torch.Tensor,
                  mask: torch.Tensor, stride: int):
    """Kernel B1 on CUDA tensors, its plain version on CPU tensors."""
    if key.device.type == "cpu":
        return kmap3_columns_plain(key, coords, mask, stride)
    if key.device.type != "cuda":
        raise ValueError(f"kmap3_columns: unsupported device {key.device}")
    V = key.shape[0]
    if key.dtype != torch.int64 or coords.dtype != torch.int32 \
            or mask.dtype != torch.bool:
        raise ValueError("kmap3_columns: want int64 keys, int32 coords, "
                         "bool mask")
    if coords.shape != (V, 4) or mask.shape != (V,) or V == 0:
        raise ValueError("kmap3_columns: shape mismatch")
    native.check_cuda("kmap3_columns", key, coords, mask)
    col_idx = torch.empty(V, 9, dtype=torch.int32, device=key.device)
    hit = torch.empty(V, 27, dtype=torch.bool, device=key.device)
    _kmap3_kernel(native.ptr(key), native.ptr(coords), native.ptr(mask), V,
                  int(stride), native.ptr(col_idx), native.ptr(hit),
                  native.stream(key.device))
    return col_idx, hit


def build_kmap3_columns(geom: VoxelGeom) -> ColumnKernelMap:
    col_idx, hit = kmap3_columns(geom.key, geom.coords, geom.mask,
                                 geom.stride)
    return ColumnKernelMap(col_idx=col_idx, hit=hit, nvalid=geom.num)


def build_pyramid(points: torch.Tensor, resolution: float,
                  capacities: Sequence[int], num_levels: int,
                  feats: torch.Tensor | None = None) -> Pyramid:
    """Quantize points and assemble `num_levels` levels (stride 1, 2, ...,
    2^(num_levels-1)) with their kernel maps."""
    assert len(capacities) >= num_levels
    geom0, vox_feats, p2v = quantize(points, resolution, capacities[0], feats)
    geoms, c2ps = [geom0], []
    for li in range(1, num_levels):
        g, c2p = pool_geom(geoms[-1], capacities[li])
        geoms.append(g)
        c2ps.append(c2p)
    levels = []
    for li, g in enumerate(geoms):
        parent_idx, up_tap = (up_maps(g, c2ps[li]) if li + 1 < num_levels
                              else (None, None))
        levels.append(LevelGeom(geom=g, kmap3=build_kmap3_columns(g),
                                parent_idx=parent_idx, up_tap=up_tap))
    return Pyramid(levels=tuple(levels), point2voxel=p2v, vox_feats=vox_feats)
