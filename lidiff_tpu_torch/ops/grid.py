"""Fixed-capacity sparse voxel geometry (counterpart of
lidiff_tpu/ops/grid.py).

Every level has a static capacity V: valid voxels come first in key order,
padding rows carry PAD_KEY and mask=False. Coordinates stay in
original-resolution units at every level (multiples of the stride).

The 27-tap column kernel map is kernel B1 (`csrc/kmap3_columns.cu`) for
CUDA tensors and its plain PyTorch version, `kmap3_columns_plain`, for CPU
tensors; both also give the sort key of the map's tile plan (`plan_keys`).
Each map carries the tile plan of the column conv's bf16 kernel
(`ColumnKernelMap.plan`: a sort of that key, then the taps of each tile,
B1's `kmap3_tile_taps` on the card), and a level used as a conditioning
bank its 1-NN index (`VoxelGeom.nn_index`), each built on first use and
kept.

The gather-form map (`KernelMap`: for each output voxel and tap, the input
row and a hit flag) is built by binary search (`build_kernel_map`) or, for
the down conv, by a scatter of the pooling's children
(`down_kmap_from_pooling`). No conv of the models runs over it: it is the
brute-force reference the tests hold the column and child-form maps to.
"""

from __future__ import annotations

import ctypes
import itertools
from dataclasses import dataclass, field
from typing import Sequence

import torch

from lidiff_tpu_torch.ops import keys as K
from lidiff_tpu_torch.ops import native
from lidiff_tpu_torch.ops.knn import NNIndex, build_nn_index
from lidiff_tpu_torch.utils import prof


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
NO_TAP = 1 << 27  # plan key of a row that hits no tap: it sorts last


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


def plan_keys(hit: torch.Tensor, mask: torch.Tensor | None = None):
    """[V] int32: the tile plan's sort key, the hit pattern read as an
    integer (bit k = tap k), 1 << 27 for a row that hits nothing. Kernel
    B1 writes it beside the map."""
    pattern = hit_patterns(hit, mask)
    return torch.where(pattern == 0, NO_TAP, pattern)


def tile_taps(pattern: torch.Tensor):
    """[ceil(V / 64)] int32: the OR of the hit patterns of each 64
    consecutive rows (an OR tree of six steps): the plain version of B1's
    `kmap3_tile_taps`."""
    V = pattern.shape[0]
    T = -(-V // TILE_ROWS)
    taps = torch.zeros(T * TILE_ROWS, dtype=torch.int32,
                       device=pattern.device)
    taps[:V] = pattern
    taps = taps.view(T, TILE_ROWS)
    while taps.shape[1] > 1:
        taps = taps[:, 0::2] | taps[:, 1::2]
    return taps[:, 0].contiguous()


def plan_from_keys(key: torch.Tensor) -> TilePlan:
    """The tile plan of a map from its `plan_keys`: `order` is a stable
    sort of the rows by their 27-bit hit pattern read as an integer (bit k
    = tap k, so tap 26 is the most significant), rows that hit nothing
    last; stability keeps the key order, and so the locality of the
    gathers, within a pattern. `tile_taps` is the OR of the patterns of
    each 64 consecutive rows of `order` (`kmap3_tile_taps`)."""
    sorted_key, order = torch.sort(key, stable=True)
    return TilePlan(order=order.to(torch.int32),
                    tile_taps=kmap3_tile_taps(sorted_key))


def tile_plan(hit: torch.Tensor, mask: torch.Tensor | None = None):
    """The tile plan of a map given only its hits (`plan_from_keys`)."""
    return plan_from_keys(plan_keys(hit, mask))


@dataclass
class KernelMap:
    """Gather-form kernel map: for each output voxel and tap, the input row
    (clamped into the input) and whether the tap hits."""
    idx: torch.Tensor  # [V_out, K] int32
    hit: torch.Tensor  # [V_out, K] bool


@dataclass
class ColumnKernelMap:
    """27-tap kernel map in column form. For each voxel and (dx, dy) column,
    `col_idx` is the lower bound of (b, x+dx*s, y+dy*s, z-s) in the level's
    keys; the column's z-taps z-s, z, z+s are hits m0, m1, m2 at rows p,
    p+m0, p+m0+m1. Tap order is x slowest, z fastest."""
    col_idx: torch.Tensor  # [V, 9] int32
    hit: torch.Tensor      # [V, 27] bool
    nvalid: torch.Tensor   # [] int32, valid rows (they come first)
    plan_key: torch.Tensor  # [V] int32, the tile plan's key (`plan_keys`)
    _plan: TilePlan | None = field(default=None, repr=False, compare=False)

    def plan(self) -> TilePlan:
        """The map's tile plan, built on first use and kept: every conv
        over the map shares it: a sort of the plan key B1 wrote beside the
        map."""
        if self._plan is None:
            with prof.annotate("lidiff.geom.pyramid"):
                self._plan = plan_from_keys(self.plan_key)
        return self._plan

    @property
    def idx(self) -> torch.Tensor:
        """The dense [V, 27] int32 view: tap col*3 + r reads row p, p+m0 or
        p+m0+m1 of its column. A tap that misses may point one past the
        last row; a gather clamps it."""
        hit = self.hit.to(torch.int32)
        p, m0, m1 = self.col_idx, hit[:, 0::3], hit[:, 1::3]
        return torch.stack([p, p + m0, p + m0 + m1], dim=2).reshape(
            p.shape[0], 27)


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
    # the gather-form down-conv map (`down_kmap_from_pooling`);
    # `build_pyramid` leaves it None: the down conv runs over the DownMap
    down_kmap: KernelMap | None = None
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
    rows = prof.annotate_backward(vox_feats[idx],
                                  "lidiff.grad.slice_to_points")
    return torch.where(ok, rows, torch.zeros((), dtype=vox_feats.dtype,
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


def cube_offsets(kernel_size: int, stride_units: int) -> torch.Tensor:
    """The taps' offsets [ks^3, 3] int32: {-s, 0, s}^3 for ks = 3 (odd
    sizes are centred), {0, s}^3 for ks = 2 (even sizes span [0, ks)); x
    slowest, z fastest."""
    if kernel_size % 2 == 1:
        r = range(-(kernel_size // 2), kernel_size // 2 + 1)
    else:
        r = range(kernel_size)
    return torch.tensor(list(itertools.product(r, r, r)),
                        dtype=torch.int32) * stride_units


def build_kernel_map(geom_in: VoxelGeom, geom_out: VoxelGeom,
                     offsets: torch.Tensor) -> KernelMap:
    """For each output voxel and tap, the input voxel at its coordinates
    plus offsets[k], by binary search in the input's sorted keys. A masked
    output row, or a query that leaves the packable range (it packs to
    PAD_KEY, the padding rows' key), finds nothing."""
    V = geom_out.capacity
    off = offsets.to(device=geom_out.coords.device, dtype=torch.int32)
    q, q_valid = K.pack(geom_out.coords[:, None, 0].expand(V, off.shape[0]),
                        geom_out.coords[:, None, 1:] + off[None])
    q = torch.where(geom_out.mask[:, None], q, K.PAD_KEY)
    idx, found = K.searchsorted_pair(geom_in.key, q)
    return KernelMap(idx=idx.to(torch.int32),
                     hit=found & geom_out.mask[:, None] & q_valid)


def down_kmap_from_pooling(fine: VoxelGeom, child2parent: torch.Tensor,
                           out_capacity: int) -> KernelMap:
    """The ks=2/stride-2 down conv's gather map from the pooling, with no
    search: each valid child fills its one (parent, tap) slot. Children
    that are masked or whose parent was dropped go to a sentinel row
    `out_capacity`, cut off afterwards. Tap order as cube_offsets(2, s)."""
    _, tap = up_maps(fine, child2parent)
    ok = fine.mask & (child2parent < out_capacity)
    parent = torch.where(ok, child2parent, out_capacity).long()
    tap = tap.long()
    child = torch.arange(fine.capacity, dtype=torch.int32,
                         device=child2parent.device)
    idx = torch.zeros(out_capacity + 1, 8, dtype=torch.int32,
                      device=child2parent.device)
    idx[parent, tap] = torch.where(ok, child, 0)
    hit = torch.zeros(out_capacity + 1, 8, dtype=torch.bool,
                      device=child2parent.device)
    hit[parent, tap] = ok
    return KernelMap(idx=idx[:out_capacity], hit=hit[:out_capacity])


# ---------------------------------------------------------------------------
# Kernel B1: the 27-tap column kernel map
# ---------------------------------------------------------------------------

_kmap3_kernel = native.Kernel(
    "kmap3_columns", "kmap3_columns",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p])
_taps_kernel = native.Kernel(
    "kmap3_columns", "kmap3_tile_taps",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])


def kmap3_columns_plain(key: torch.Tensor, coords: torch.Tensor,
                        mask: torch.Tensor, stride: int):
    """Plain PyTorch version of kernel B1; the same function as
    lidiff_tpu/ops/grid.py:309-354. Returns (col_idx [V, 9] int32,
    hit [V, 27] bool, the tile plan's key [V] int32 (`plan_keys`))."""
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
    return p.to(torch.int32), hit, plan_keys(hit)


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
    plan_key = torch.empty(V, dtype=torch.int32, device=key.device)
    _kmap3_kernel(native.ptr(key), native.ptr(coords), native.ptr(mask), V,
                  int(stride), native.ptr(col_idx), native.ptr(hit),
                  native.ptr(plan_key), native.stream(key.device))
    return col_idx, hit, plan_key


def kmap3_tile_taps(sorted_key: torch.Tensor):
    """The taps of each 64-row tile of a plan from its sorted plan keys [V]
    int32: B1's `kmap3_tile_taps` on a CUDA tensor, its plain version
    (`tile_taps` of the patterns) on a CPU one. [ceil(V / 64)] int32."""
    if sorted_key.device.type == "cpu":
        return tile_taps(sorted_key & (NO_TAP - 1))
    V = sorted_key.shape[0]
    if sorted_key.dtype != torch.int32 or sorted_key.dim() != 1 or V == 0:
        raise ValueError("kmap3_tile_taps: want [V] int32 plan keys")
    native.check_cuda("kmap3_tile_taps", sorted_key)
    taps = torch.empty(-(-V // TILE_ROWS), dtype=torch.int32,
                       device=sorted_key.device)
    _taps_kernel(native.ptr(sorted_key), V, native.ptr(taps),
                 native.stream(sorted_key.device))
    return taps


def build_kmap3_columns(geom: VoxelGeom) -> ColumnKernelMap:
    col_idx, hit, plan_key = kmap3_columns(geom.key, geom.coords, geom.mask,
                                           geom.stride)
    return ColumnKernelMap(col_idx=col_idx, hit=hit, nvalid=geom.num,
                           plan_key=plan_key)


def build_pyramid(points: torch.Tensor, resolution: float,
                  capacities: Sequence[int], num_levels: int,
                  feats: torch.Tensor | None = None) -> Pyramid:
    """Quantize points and assemble `num_levels` levels (stride 1, 2, ...,
    2^(num_levels-1)) with their kernel maps."""
    assert len(capacities) >= num_levels
    with prof.annotate("lidiff.geom.pyramid"):
        geom0, vox_feats, p2v = quantize(points, resolution, capacities[0],
                                         feats)
        geoms, c2ps = [geom0], []
        for li in range(1, num_levels):
            g, c2p = pool_geom(geoms[-1], capacities[li])
            geoms.append(g)
            c2ps.append(c2p)
        levels = []
        for li, g in enumerate(geoms):
            parent_idx, up_tap = (up_maps(g, c2ps[li])
                                  if li + 1 < num_levels else (None, None))
            levels.append(LevelGeom(geom=g, kmap3=build_kmap3_columns(g),
                                    parent_idx=parent_idx, up_tap=up_tap))
    return Pyramid(levels=tuple(levels), point2voxel=p2v, vox_feats=vox_feats)


# grid coordinates are kept shifted into the keys' signed range: x and y
# from [0, 4096) by 2048, z from [0, 3072) by 1024 (a column map's lowest
# query, z - 1, must stay in range). The shifts are multiples of every
# level's stride, so pooling is unchanged.
GRID_SHIFT = (K.COORD_OFF, K.COORD_OFF, K.COORD_OFF // 2)


_grid_shift: dict = {}


def grid_shift(device) -> torch.Tensor:
    """GRID_SHIFT as an int32 tensor on `device`, made once a device: a
    copy from the host each call would make the host wait for the card."""
    device = torch.device(device)
    if device not in _grid_shift:
        _grid_shift[device] = torch.tensor(GRID_SHIFT, dtype=torch.int32,
                                           device=device)
    return _grid_shift[device]


def build_pyramid_grid(grid: torch.Tensor, element: torch.Tensor,
                       feats: torch.Tensor, capacities: Sequence[int],
                       num_levels: int) -> Pyramid:
    """The pyramid of points already on an integer grid (Pointcept's
    `grid_coord`: floor(coord / grid size) minus the item's minimum, in
    [0, 4096) in x and y, [0, 3072) in z): `grid` [N, 3], the element of each point `element` [N]
    (a batch item, or a Mix3D pair) and its features `feats` [N, C]. Level
    0 holds one voxel per distinct (element, coordinate) with the mean of
    its points' features, its coordinates stored as grid - GRID_SHIFT;
    level l + 1 pools level l by floor(c / 2^(l+1)), which on the grid is
    PTv3's pooling by `code >> 3`. point2voxel is [1, N]."""
    assert len(capacities) >= num_levels
    N, C = feats.shape
    dev = feats.device
    with prof.annotate("lidiff.geom.pyramid"):
        key, _ = K.pack(element, grid.to(torch.int32) - grid_shift(dev))
        key_s, order, vid, n_unique = _unique_sorted(key, capacities[0])
        p2v = torch.empty(N, dtype=torch.int32, device=dev)
        p2v[order] = vid
        geom0 = _level_from_keys(capacities[0], vid, key_s, n_unique,
                                 stride=1)
        vidl = vid.long()
        sums = torch.zeros(capacities[0] + 1, C, dtype=feats.dtype,
                           device=dev)
        sums.index_add_(0, vidl, feats[order])
        cnts = torch.zeros(capacities[0] + 1, dtype=torch.float32,
                           device=dev)
        cnts.index_add_(0, vidl, torch.ones_like(vidl, dtype=torch.float32))
        vox_feats = sums[:capacities[0]] \
            / cnts[:capacities[0]].clamp(min=1.0)[:, None]
        geoms, c2ps = [geom0], []
        for li in range(1, num_levels):
            g, c2p = pool_geom(geoms[-1], capacities[li])
            geoms.append(g)
            c2ps.append(c2p)
        levels = []
        for li, g in enumerate(geoms):
            parent_idx, up_tap = (up_maps(g, c2ps[li])
                                  if li + 1 < num_levels else (None, None))
            levels.append(LevelGeom(geom=g, kmap3=build_kmap3_columns(g),
                                    parent_idx=parent_idx, up_tap=up_tap))
    return Pyramid(levels=tuple(levels), point2voxel=p2v[None],
                   vox_feats=vox_feats)
