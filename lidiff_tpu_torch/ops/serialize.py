"""Serialization of a voxel level for Point Transformer V3 (Wu et al.,
CVPR 2024; Pointcept `pointcept/models/utils/serialization` and
`point_transformer_v3m1_base.py`): space-filling-curve codes, the orders
they sort the voxels into, and the patch maps of serialized attention.

- Codes. `z_code` interleaves the bits of (x, y, z), x the most
  significant of each triple. `hilbert_code` is Skilling's transform
  ("Programming the Hilbert curve", AIP Conf. Proc. 707, 2004) from the
  axes to the transposed index, then the index's bits interleaved with x
  the most significant of each triple: written here from the published
  algorithm, in integer arithmetic, not copied. It gives Pointcept's
  Hilbert code, which runs the same transform on bit tensors. Both are
  hierarchical: the code of a voxel at depth d, shifted right by 3, is the
  code of its parent at depth d - 1. The "-trans" orders swap x and y.
  The element (batch item, or a Mix3D pair) sits above the 3 d bits.
- Orders. A level sorts its voxels by each of the four codes
  (`ORDERS`); training shuffles which block takes which order, one draw a
  level (Pointcept's `shuffle_orders`). Level 0's codes are encoded, a
  coarser level's taken from its children's (`parent_codes`), as
  Pointcept's pooling takes `code >> 3`. On the card level 0's four
  codes come from one launch of `csrc/serial_codes.cu` (the same integer
  arithmetic, a thread a row) in place of the bit loops.
- Patch maps (Pointcept's `get_padding_and_inverse`, with the patch size
  of its non-flash path): every element is cut into patches of
  K = min(1024, the level's smallest element) rows in serialized order;
  an element whose count is not a multiple of K fills the rest of its last
  patch with copies of the rows K places before (the previous patch's
  last rows), not with masked rows.

The counts of every level come to the host in one transfer a step
(`level_counts`): the only host sync of the maps, counted in `counters`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from lidiff_tpu_torch.ops import native

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")
MAX_PATCH = 1024

# the program's counters: host syncs taken by the patch maps, and, per
# attention call, its rows (padded) and the filler rows among them
counters = {"syncs": 0, "attn_rows": 0, "attn_filler": 0}


def z_code(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
           depth: int) -> torch.Tensor:
    """Morton code of int64 coordinates in [0, 2^depth): bit i of x, y, z
    goes to bit 3i + 2, 3i + 1, 3i."""
    code = torch.zeros_like(x)
    for i in range(depth):
        code |= ((x >> i) & 1) << (3 * i + 2)
        code |= ((y >> i) & 1) << (3 * i + 1)
        code |= ((z >> i) & 1) << (3 * i)
    return code


def hilbert_code(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                 depth: int) -> torch.Tensor:
    """Hilbert index of int64 coordinates in [0, 2^depth) (Skilling 2004,
    AxestoTranspose, then the transposed index's bits interleaved from the
    most significant level down, x first)."""
    X = [x.clone(), y.clone(), z.clone()]
    q = 1 << (depth - 1)
    while q > 1:
        p = q - 1
        for i in range(3):
            on = (X[i] & q) != 0
            # where the bit is set invert the low bits of X[0], else
            # exchange the low bits of X[0] and X[i]
            t = torch.where(on, 0, (X[0] ^ X[i]) & p)
            X[0] = torch.where(on, X[0] ^ p, X[0] ^ t)
            if i:
                X[i] = X[i] ^ t
        q >>= 1
    # Gray encode
    X[1] = X[1] ^ X[0]
    X[2] = X[2] ^ X[1]
    t = torch.zeros_like(x)
    q = 1 << (depth - 1)
    while q > 1:
        t = torch.where((X[2] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    X = [v ^ t for v in X]
    return z_code(X[0], X[1], X[2], depth)


def encode(grid: torch.Tensor, element: torch.Tensor, depth: int,
           order: str) -> torch.Tensor:
    """[V] int64 code of order `order` for grid coordinates [V, 3]
    (non-negative, < 2^depth) of the elements `element` [V]."""
    g = grid.long()
    x, y, z = g[:, 0], g[:, 1], g[:, 2]
    if order.endswith("-trans"):
        x, y = y, x
    fn = z_code if order.startswith("z") else hilbert_code
    return (element.long() << (3 * depth)) | fn(x, y, z, depth)


@dataclass
class LevelCounts:
    """What the host knows of a level after the step's one sync."""
    counts: list      # valid voxels of each element
    depth: int        # bits of the level's grid coordinates
    dev: torch.Tensor  # the counts [elements] int64 on the device

    @property
    def total(self) -> int:
        return sum(self.counts)


def level_counts(elements: list, masks: list, n_elements: int,
                 grid0: torch.Tensor, mask0: torch.Tensor):
    """LevelCounts of every level from the element of each row [V_l] and
    the masks [V_l] of every level, and level 0's grid coordinates: one
    transfer to the host. Level l's depth is level 0's
    minus l (Pointcept: the bit length of the largest grid coordinate of
    the batch)."""
    rows = []
    for e, m in zip(elements, masks):
        idx = torch.where(m, e.long(), n_elements)
        c = torch.zeros(n_elements + 1, dtype=torch.int64, device=e.device)
        rows.append(c.scatter_add_(0, idx, torch.ones_like(idx))[:n_elements])
    top = torch.where(mask0[:, None], grid0.long(), 0).amax()
    host = torch.cat(rows + [top.reshape(1)]).tolist()
    counters["syncs"] += 1
    depth0 = max(int(host[-1]).bit_length(), 1)
    out = []
    for li in range(len(masks)):
        counts = host[li * n_elements:(li + 1) * n_elements]
        out.append(LevelCounts(counts=counts, depth=max(depth0 - li, 1),
                               dev=rows[li]))
    return out


@dataclass
class PatchMaps:
    """A level's patch maps, shared by its four orders: `pad` [n_pad] is
    the serialized position each padded row reads, `unpad` [n] the padded
    row of each serialized position."""
    pad: torch.Tensor
    unpad: torch.Tensor
    patch: int

    @property
    def rows(self) -> int:
        return self.pad.shape[0]


def patch_size(counts: list) -> int:
    return min(MAX_PATCH, min(counts))


def pad_maps(lc: LevelCounts) -> PatchMaps:
    """The padded rows of a level's elements, in serialized order: each
    element's rows are rounded up to a whole number of patches; the rows of
    a last patch past the element's end read the row K before. Sizes come
    from the host's counts, indices from the device's: no sync."""
    K = patch_size(lc.counts)
    B = len(lc.counts)
    n, n_pad = lc.total, sum(-(-c // K) * K for c in lc.counts)
    c, device = lc.dev, lc.dev.device
    cp = (c + K - 1) // K * K
    off, off_pad = torch.cumsum(c, 0) - c, torch.cumsum(cp, 0) - cp
    el = torch.arange(B, device=device)
    e = torch.repeat_interleave(el, cp, output_size=n_pad)
    j = torch.arange(n_pad, device=device) - off_pad[e]
    pad = torch.where(j < c[e], j, j - K) + off[e]
    e = torch.repeat_interleave(el, c, output_size=n)
    unpad = torch.arange(n, device=device) - off[e] + off_pad[e]
    return PatchMaps(pad=pad, unpad=unpad, patch=K)


@dataclass
class LevelOrders:
    """A level's serialization: for each of its four orders, in the
    shuffled order the blocks take them (block i takes row i % 4), the
    level's rows it gathers into padded patches (`gather` [4, n_pad]) and
    the padded row each valid row reads back (`scatter` [4, n])."""
    gather: torch.Tensor
    scatter: torch.Tensor
    maps: PatchMaps


_codes_kernel = native.Kernel(
    "serial_codes", "serial_codes",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,          # coords, n, depth
     ctypes.c_int, ctypes.c_int, ctypes.c_int,             # the shift
     ctypes.c_void_p, ctypes.c_void_p])                    # out, stream


def level_codes(coords: torch.Tensor, shift, depth: int) -> torch.Tensor:
    """[4, V] codes of the four `ORDERS` of a level's rows `coords` [V, 4]
    int32 (element, x, y, z), whose grid coordinates are (x, y, z) plus
    `shift` (three ints), at `depth`: kernel `serial_codes` on the card,
    the bit loops (`encode`) on the CPU."""
    if not coords.is_cuda:
        grid = coords[:, 1:].long() + torch.tensor(shift)
        return torch.stack([encode(grid, coords[:, 0], depth, name)
                            for name in ORDERS])
    native.check_cuda("serial_codes", coords)
    if coords.dtype != torch.int32 or coords.dim() != 2 \
            or coords.shape[1] != 4:
        raise ValueError("level_codes: want int32 coords [V, 4]")
    n = coords.shape[0]
    out = torch.empty(4, n, dtype=torch.int64, device=coords.device)
    _codes_kernel(native.ptr(coords), n, depth, *(int(v) for v in shift),
                  native.ptr(out), native.stream(coords.device))
    return out


def parent_codes(codes: torch.Tensor, parent: torch.Tensor,
                 n_coarse: int) -> torch.Tensor:
    """[4, n_coarse]: the codes of the coarser level's rows from the finer
    level's [4, n] and the parent row of each [n]: a child's code shifted
    right by 3, as every child gives its parent (the codes are
    hierarchical). One scatter, in place of a level's bit loops."""
    out = codes.new_empty(codes.shape[0], n_coarse)
    return out.scatter_(1, parent[None].expand(codes.shape[0], -1),
                        codes >> 3)


def serialize_level(codes: torch.Tensor, lc: LevelCounts,
                    perm: torch.Tensor) -> LevelOrders:
    """The four orders of a level's valid rows (its first lc.total rows,
    as the pyramid keeps them) from their codes [4, lc.total]; `perm` [4]
    (on the device) shuffles which block takes which."""
    n = lc.total
    maps = pad_maps(lc)
    order = torch.argsort(codes, dim=1)
    inverse = torch.empty_like(order).scatter_(
        1, order, torch.arange(n, device=order.device).expand(4, n))
    return LevelOrders(gather=order[:, maps.pad][perm],
                       scatter=maps.unpad[inverse][perm], maps=maps)
