"""Batched 1-NN coordinate matching (counterpart of lidiff_tpu/ops/knn.py).

For every valid query voxel, the index of the nearest valid reference voxel
of the same batch item, ranked by |r|^2 - 2 q.r (the per-query |q|^2 never
changes an argmin), ties to the first index; a batch item with no valid
reference gives index 0, as the XLA path's argmin over all-penalized rows
does. Invalid queries (`q_mask` False) get index 0; only valid queries
carry the JAX function's index. `nn_match_plain` is the function's
definition: a scan of every reference row in float64.

Kernel C1 (`csrc/nn_match.cu`) computes it for CUDA tensors over an index
of the reference side (`NNIndex`, `build_nn_index`): the valid rows sorted
into a uniform grid of cubic cells per batch item. Each query visits the
cells in shells of growing Chebyshev radius around its own cell and stops
once no unvisited cell can hold a row at a distance less than or equal to
the best one. `nn_grid_plain` is the same search in tensor code. A bank
keeps its index on its `VoxelGeom` (`VoxelGeom.nn_index`), so a
completion builds it once for all its solver steps and levels.

`nn_match_tiled` computes the same function for the grid chamfer's large
matches (1.08M x 360k and back) without a host read: `build_tile_index`
builds C1's layout over the references with the grid kept on the device
(`TileIndex`), `tile_order` orders the queries by the index cell they lie
in, and kernel C2 (`csrc/nn_match_tiled.cu`) lets each tile of QTILE
consecutive queries in that order search the cells around its box
together, in shells, staging their rows through shared memory.
`nn_tiles_plain` is the same tile search in tensor code, rows staged
included. Every distance and stop test is an exact integer, so the result
equals `nn_match` on every valid query; a tie goes to the lowest row.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from lidiff_tpu_torch.ops import native

_BIG = 1e18

_nn_kernel = native.Kernel(
    "nn_match", "nn_match",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
_nn_kernel.scans = 0  # of its launches, those over a one-cell-per-item index


@dataclass
class NNIndex:
    """The valid reference rows in a uniform grid of cubic cells, per batch
    item: cell (x, y, z) of item b holds the rows with coordinates in
    [lo + (x, y, z) * cell, lo + (x, y, z + 1) * cell), and its rows are
    pts[cell_start[i] : cell_start[i + 1]], i = ((b * nx + x) * ny + y) * nz
    + z, in ascending row order. `items` is 1 where the batch ids are not
    compared (n_batch == 1)."""
    pts: torch.Tensor         # [n, 4] int32: x, y, z, row in the bank
    cell_start: torch.Tensor  # [items * nx * ny * nz + 1] int32
    lo: tuple                 # (x, y, z) of cell (0, 0, 0)'s corner
    cell: int                 # cell edge, in coordinate units
    dims: tuple               # (nx, ny, nz)
    items: int
    batched: bool

    builds = 0                # indexes built (all instances)

    @property
    def scan(self) -> bool:
        """One cell per item: the search is a plain scan of the item's
        rows."""
        return self.dims == (1, 1, 1)


def build_nn_index(r_coords, r_mask, n_batch: int = 0) -> NNIndex:
    """The bank's `NNIndex`, in tensor ops on its device: two host reads
    (the valid rows' count, then their bounding box and batch ids), one
    stable sort by cell, one search for the cells' first rows.

    The cell edge makes the bounding box hold about one valid row per cell
    (per item), so the cells number about the rows. A bank whose items
    share one voxel (the uncond bank) comes out as one cell per item, and
    its search is a scan of its rows."""
    NNIndex.builds += 1
    dev = r_coords.device
    batched = n_batch != 1
    rows = torch.nonzero(r_mask).squeeze(1)
    c = r_coords[rows].long()
    n = rows.shape[0]
    if n == 0:
        return NNIndex(pts=torch.zeros(0, 4, dtype=torch.int32, device=dev),
                       cell_start=torch.zeros(2, dtype=torch.int32,
                                              device=dev),
                       lo=(0, 0, 0), cell=1, dims=(1, 1, 1), items=1,
                       batched=batched)
    b = c[:, 0] if batched else torch.zeros_like(c[:, 0])
    lo_t, hi_t = c[:, 1:].amin(0), c[:, 1:].amax(0)
    stats = torch.cat([lo_t, hi_t, b.amin()[None], b.amax()[None]]).tolist()
    lo, hi, b_lo, items = stats[:3], stats[3:6], stats[6], stats[7] + 1
    if b_lo < 0:
        raise ValueError("build_nn_index: negative batch id")
    ext = [h - l + 1 for l, h in zip(lo, hi)]
    vol = ext[0] * ext[1] * ext[2] * items
    cell = max(1, math.ceil((vol / n) ** (1 / 3)))
    dims = tuple(-(-e // cell) for e in ext)
    cxyz = torch.div(c[:, 1:] - lo_t, cell, rounding_mode="floor")
    cid = ((b * dims[0] + cxyz[:, 0]) * dims[1] + cxyz[:, 1]) * dims[2] \
        + cxyz[:, 2]
    ncells = items * dims[0] * dims[1] * dims[2]
    cid, order = torch.sort(cid, stable=True)
    pts = torch.cat([c[order, 1:], rows[order, None]], 1).to(torch.int32)
    # cell i's rows start at the number of rows in cells below i
    start = torch.searchsorted(cid, torch.arange(ncells + 1, device=dev)) \
        .to(torch.int32)
    return NNIndex(pts=pts.contiguous(), cell_start=start, lo=tuple(lo),
                   cell=cell, dims=dims, items=items, batched=batched)


def nn_grid_plain(q_coords, q_mask, index: NNIndex, block: int = 4096):
    """Plain version of kernel C1's search over `index`, in tensor code:
    the same query cells, shells, lexicographic (distance, row) minimum and
    stop rule, on any device; the rows of shell r are those whose cell is r
    away from the query's in the Chebyshev norm. Memory goes as `block`
    queries x the index's rows. Returns (idx [Vq] int32, pairs [Vq] int32:
    the rows each query examined)."""
    dev = q_coords.device
    Vq = q_coords.shape[0]
    out = torch.zeros(Vq, dtype=torch.int32, device=dev)
    pairs = torch.zeros(Vq, dtype=torch.int32, device=dev)
    dims = torch.tensor(index.dims, device=dev)
    lo = torch.tensor(index.lo, device=dev)
    nxyz = index.dims[0] * index.dims[1] * index.dims[2]
    start = index.cell_start.long()
    pts = index.pts.long()
    n = pts.shape[0]
    # each row's cell and batch item
    p_cell = torch.div(pts[:, :3] - lo, index.cell, rounding_mode="floor")
    p_item = (torch.searchsorted(start, torch.arange(n, device=dev),
                                 right=True) - 1) // nxyz
    q = q_coords.long()
    b = q[:, 0] if index.batched else torch.zeros_like(q[:, 0])
    live = b.ge(0) & b.lt(index.items)
    if q_mask is not None:
        live &= q_mask
    bc = b.clamp(0, index.items - 1) * nxyz
    live &= start[bc + nxyz] > start[bc]
    for s in range(0, Vq, block):
        qi = torch.nonzero(live[s:s + block]).squeeze(1) + s
        qq = q[qi, 1:]
        qc = torch.div(qq - lo, index.cell, rounding_mode="floor")
        r = torch.maximum(-qc, qc - (dims - 1)).clamp(min=0).amax(1)
        cheb = (p_cell[None] - qc[:, None]).abs().amax(2)          # [s, n]
        mine = p_item[None] == b[qi, None]
        d = ((pts[None, :, :3] - qq[:, None]) ** 2).sum(2)
        key = (d << 32) + pts[None, :, 3]
        best = torch.full_like(qi, 1 << 62)      # distance * 2^32 + row
        while qi.numel():
            shell = mine & (cheb == r[:, None])
            pairs[qi] += shell.sum(1, dtype=torch.int32)
            best = torch.minimum(best, torch.where(shell, key, 1 << 62)
                                 .amin(1))
            # a lower bound on the distance of every row outside radius r
            gap_lo = qq - (lo + (qc - r[:, None]) * index.cell) + 1
            gap_hi = lo + (qc + r[:, None] + 1) * index.cell - qq
            inf = torch.full_like(gap_lo, 1 << 40)
            gap_lo = torch.where(qc - r[:, None] - 1 >= 0, gap_lo, inf)
            gap_hi = torch.where(qc + r[:, None] + 1 <= dims - 1, gap_hi,
                                 inf)
            m = torch.minimum(gap_lo, gap_hi).amin(1)
            done = (m == 1 << 40) | (m * m > (best >> 32))
            out[qi[done]] = (best[done] & 0xFFFFFFFF).to(torch.int32)
            keep = ~done
            qi, qq, qc, r, best = (qi[keep], qq[keep], qc[keep], r[keep] + 1,
                                   best[keep])
            cheb, mine, key = cheb[keep], mine[keep], key[keep]
    return out, pairs


def nn_match_plain(q_coords, r_coords, r_mask, q_mask=None,
                   block: int = 8192):
    """Plain PyTorch version of kernel C1, and the function's definition: a
    scan of every reference row. Distances are formed in float64, which
    holds them exactly (|c| <= 2047 keeps them below 2^27). Queries outside
    `q_mask` (if given) get index 0."""
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
    if q_mask is not None:
        out = torch.where(q_mask, out, 0)
    return out


def nn_match(q_coords, r_coords, r_mask, n_batch: int = 0, q_mask=None,
             index: NNIndex | None = None, pairs: bool = False):
    """Kernel C1 on CUDA tensors, its plain version on CPU tensors.

    q_coords [Vq, 4] and r_coords [Vr, 4] int32 (batch, x, y, z), r_mask
    [Vr] bool, q_mask [Vq] bool or None (every query valid). `n_batch == 1`
    drops the batch compare. `index` is the bank's `NNIndex` (built here,
    and not kept, if None; it must be of these refs and of n_batch).
    Returns [Vq] int32, 0 for invalid queries; with `pairs` (CUDA only)
    also the rows each query examined, [Vq] int32."""
    if q_coords.device.type == "cpu":
        if pairs:
            raise ValueError("nn_match: pairs are counted by the kernel")
        return nn_match_plain(q_coords, r_coords, r_mask, q_mask)
    if q_coords.device.type != "cuda":
        raise ValueError(f"nn_match: unsupported device {q_coords.device}")
    Vq, Vr = q_coords.shape[0], r_coords.shape[0]
    if q_coords.dtype != torch.int32 or r_coords.dtype != torch.int32 \
            or r_mask.dtype != torch.bool \
            or (q_mask is not None and q_mask.dtype != torch.bool):
        raise ValueError("nn_match: want int32 coords and bool masks")
    if q_coords.shape != (Vq, 4) or r_coords.shape != (Vr, 4) \
            or r_mask.shape != (Vr,) or Vq == 0 or Vr == 0 \
            or (q_mask is not None and q_mask.shape != (Vq,)):
        raise ValueError("nn_match: shape mismatch")
    if index is None:
        index = build_nn_index(r_coords, r_mask, n_batch)
    if index.batched != (n_batch != 1):
        raise ValueError("nn_match: index built for another n_batch")
    native.check_cuda("nn_match", q_coords, r_coords, index.pts,
                      index.cell_start,
                      *([q_mask] if q_mask is not None else []))
    out = torch.empty(Vq, dtype=torch.int32, device=q_coords.device)
    cnt = torch.empty_like(out) if pairs else None
    _nn_kernel(native.ptr(q_coords), native.ptr(q_mask), Vq,
               native.ptr(index.pts), native.ptr(index.cell_start),
               *index.lo, index.cell, *index.dims, index.items,
               int(index.batched), native.ptr(out), native.ptr(cnt),
               native.stream(q_coords.device))
    if index.scan:
        _nn_kernel.scans += 1
    return (out, cnt) if pairs else out


def match_features(q_coords, q_mask, r_coords, r_mask, r_feats,
                   n_batch: int = 0, compute_dtype=torch.float32,
                   index: NNIndex | None = None):
    """Nearest reference voxel's features per query, zeros for invalid
    queries whatever the bank holds; the gather runs in the compute dtype.
    `index` as for `nn_match`."""
    idx = nn_match(q_coords, r_coords, r_mask, n_batch, q_mask, index)
    out = r_feats.to(compute_dtype)[idx.long()].to(r_feats.dtype)
    return torch.where(q_mask[:, None], out, 0)


# ---------------------------------------------------------------------------
# kernel C2: tiles of queries searching a grid index of the references
# ---------------------------------------------------------------------------

QTILE = 32           # queries per tile: one warp of the kernel
_FAR = 1 << 20       # a gap beyond every grid: no cell left on that side
_MAX_CELL = 4096     # a cell this wide holds every |c| <= 2047 on its axis

_tile_kernel = native.Kernel(
    "nn_match_tiled", "nn_match_tiled",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])


@dataclass
class TileIndex:
    """Kernel C2's index of the reference rows: `NNIndex`'s layout, built
    without a host read. Every row is sorted in, the valid ones by cell
    (ascending row order within a cell), the others after them; the grid
    stays on the device in `geo`, and it has at most `cap` cells, a bound
    known from the shapes (cells past the grid's own count are empty)."""
    pts: torch.Tensor         # [Vr, 4] int32: x, y, z, row
    cell_start: torch.Tensor  # [cap + 1] int32
    geo: torch.Tensor         # [8] int32: lo x, y, z; cell; nx, ny, nz; items
    cap: int
    batched: bool


def _check_match_inputs(name, q_coords, q_mask, r_coords, r_mask):
    Vq, Vr = q_coords.shape[0], r_coords.shape[0]
    if q_coords.dtype != torch.int32 or r_coords.dtype != torch.int32 \
            or r_mask.dtype != torch.bool or q_mask.dtype != torch.bool:
        raise ValueError(f"{name}: want int32 coords and bool masks")
    if q_coords.shape != (Vq, 4) or r_coords.shape != (Vr, 4) \
            or r_mask.shape != (Vr,) or q_mask.shape != (Vq,) \
            or Vq == 0 or Vr == 0:
        raise ValueError(f"{name}: shape mismatch")
    if q_coords.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q_coords.device}")


def build_tile_index(r_coords, r_mask, n_batch: int = 0) -> TileIndex:
    """The references' `TileIndex`, in tensor ops on their device.

    Items: `n_batch` of them (batch ids in [0, n_batch); rows outside are
    left out), one for n_batch == 1 (no batch compare); n_batch == 0 reads
    the largest valid batch id back, the one host read. The cell is C1's
    (`build_nn_index`: about one valid row per cell of the bounding box,
    the least edge c with c^3 n >= its volume, here in exact integers),
    widened where needed to keep the cells within cap = 2 Vr + items: the
    least edge that meets both is found among all 4096 at once."""
    dev = r_coords.device
    Vr = r_coords.shape[0]
    batched = n_batch != 1
    b = r_coords[:, 0] if batched else torch.zeros_like(r_coords[:, 0])
    if n_batch >= 1:
        items = n_batch
    else:
        b_lo, b_hi = torch.stack([torch.where(r_mask, b, 0).amin(),
                                  torch.where(r_mask, b, -1).amax()]).tolist()
        if b_lo < 0:
            raise ValueError("build_tile_index: negative batch id")
        items = max(b_hi + 1, 1)
    cap = 2 * Vr + items
    valid = r_mask & b.ge(0) & b.lt(items)
    n = valid.sum()
    xyz = r_coords[:, 1:]
    # lo and -hi in one reduction; an empty index gets a one-voxel box
    ends = torch.where(valid[:, None], torch.cat([xyz, -xyz], 1), _FAR) \
        .amin(0)
    ends = torch.where(n > 0, ends, 0)
    lo = ends[:3]
    ext = (-ends[3:] - lo + 1).long()
    widths = torch.arange(1, _MAX_CELL + 1, device=dev)
    cells = items * torch.div(ext + widths[:, None] - 1, widths[:, None],
                              rounding_mode="floor").prod(1)
    fits = (widths ** 3 * n.clamp(min=1) >= ext.prod() * items) \
        & (cells <= cap)
    cell = (~fits).sum() + 1
    dims = torch.div(ext + cell - 1, cell, rounding_mode="floor")
    cell32, d32 = cell.to(torch.int32), dims.to(torch.int32)
    cxyz = torch.div(xyz - lo, cell32, rounding_mode="floor")
    cid = ((b * d32[0] + cxyz[:, 0]) * d32[1] + cxyz[:, 1]) * d32[2] \
        + cxyz[:, 2]
    cid, order = torch.sort(torch.where(valid, cid, cap), stable=True)
    pts = torch.cat([xyz[order], order[:, None].to(torch.int32)], 1)
    start = torch.searchsorted(cid, torch.arange(
        cap + 1, dtype=torch.int32, device=dev), out_int32=True)
    geo = torch.cat([lo, cell32[None], d32,
                     torch.full((1,), items, dtype=torch.int32, device=dev)])
    return TileIndex(pts=pts.contiguous(), cell_start=start, geo=geo,
                     cap=cap, batched=batched)


def _query_cells(q_coords, q_mask, index: TileIndex):
    """Per query: its item, its cell (x, y, z; outside the grid for a
    query beyond it) and whether it is searched (valid, its item in
    range)."""
    g = index.geo
    b = q_coords[:, 0] if index.batched else \
        torch.zeros_like(q_coords[:, 0])
    live = q_mask & b.ge(0) & b.lt(g[7])
    cell = torch.div(q_coords[:, 1:] - g[:3], g[3], rounding_mode="floor")
    return b, cell, live


def tile_order(q_coords, q_mask, index: TileIndex):
    """The order in which kernel C2 takes the queries, QTILE at a time: by
    the index cell they lie in (item first, x, y, z; a query beyond the
    grid by the cell nearest to it), the searched queries before the
    others; stable. In lex order a tile would be a slab one x wide and
    long in y; in cell order it is a few cells. [Vq] int32."""
    b, cell, live = _query_cells(q_coords, q_mask, index)
    dims = index.geo[4:7]
    cell = torch.minimum(cell.clamp(min=0), dims - 1)
    key = ((b * dims[0] + cell[:, 0]) * dims[1] + cell[:, 1]) * dims[2] \
        + cell[:, 2]
    key = torch.where(live, key, index.cap)
    return torch.sort(key, stable=True).indices.to(torch.int32)


def _shell_rows(start, base, dims, box0, box1, r: int, inner: bool):
    """Index rows of the cells of item `base` (its first cell) that lie in
    the box [box0, box1] grown by r and not in it grown by r - 1 (not
    when `inner` is False: nothing of it is in the grid), both cut to the
    grid. A column (x, y) gives one run of cells along z, or two where it
    crosses the inner box."""
    dev = start.device
    _, ny, nz = dims
    a0 = [max(v - r, 0) for v in box0]
    a1 = [min(v + r, d - 1) for v, d in zip(box1, dims)]
    xs = torch.arange(a0[0], a1[0] + 1, device=dev)
    ys = torch.arange(a0[1], a1[1] + 1, device=dev)
    x, y = (t.reshape(-1) for t in torch.meshgrid(xs, ys, indexing="ij"))
    col = base + (x * ny + y) * nz
    z0 = torch.full_like(x, a0[2])
    z1 = torch.full_like(x, a1[2])
    runs = [(z0, z1)]
    if inner:
        b0 = [max(v - r + 1, 0) for v in box0]
        b1 = [min(v + r - 1, d - 1) for v, d in zip(box1, dims)]
        cross = (x >= b0[0]) & (x <= b1[0]) & (y >= b0[1]) & (y <= b1[1])
        runs = [(z0, torch.where(cross, b0[2] - 1, z1)),
                (torch.where(cross, b1[2] + 1, z1 + 1), z1)]
    s = torch.cat([start[col + za] for za, zb in runs])
    e = torch.cat([start[col + zb + 1] for za, zb in runs])
    n = e - s                             # a run z0 > z1 is one past: 0
    first = torch.repeat_interleave(s - (torch.cumsum(n, 0) - n), n)
    return first + torch.arange(int(n.sum()), device=dev)


def nn_tiles_plain(q_coords, q_mask, index: TileIndex, order, tiles=None,
                   chunk: int = 8192, keep_rows: bool = False):
    """Plain version of kernel C2's tile search, in tensor code on any
    device: the same tiles of `order`, groups of a tile's queries (one per
    item and cell x), boxes, shells and stop rule, and the lexicographic
    (distance, row) minimum. `tiles`: the tiles to search (all by default;
    the other queries get 0). Returns (idx [Vq] int32, staged [tiles]
    int32: the index rows each tile staged), and with `keep_rows` a list
    of those rows (positions in `index.pts`) per tile."""
    dev = q_coords.device
    Vq = q_coords.shape[0]
    nt = -(-Vq // QTILE)
    tiles = range(nt) if tiles is None else [int(t) for t in tiles]
    g = index.geo.tolist()
    lo, cell, dims, items = torch.tensor(g[:3], device=dev), g[3], g[4:7], \
        g[7]
    d_t = torch.tensor(dims, device=dev)
    nxyz = dims[0] * dims[1] * dims[2]
    start, pts = index.cell_start.long(), index.pts.long()
    b, qcell, live = _query_cells(q_coords, q_mask, index)
    b, qcell = b.long(), qcell.long()
    q = q_coords.long()[:, 1:]
    order = order.long()
    out = torch.zeros(Vq, dtype=torch.int32, device=dev)
    staged = torch.zeros(len(tiles), dtype=torch.int32, device=dev)
    kept = []
    for k, t in enumerate(tiles):
        kept.append([])
        rows = order[t * QTILE:(t + 1) * QTILE]
        rows = rows[live[rows]]
        # one group per (item, cell x): a tile that runs from one cell x
        # into the next would otherwise take a box as long as the grid in y
        groups = b[rows] * (1 << 32) + qcell[rows, 0] + (1 << 31)
        for group in torch.unique(groups).tolist():
            sel = rows[groups == group]
            item = group >> 32
            base = item * nxyz
            if int(start[base + nxyz]) == int(start[base]):
                continue                       # an item without valid refs
            box0, box1 = qcell[sel].amin(0), qcell[sel].amax(0)
            # the first radius whose box reaches the grid on every axis
            r0 = int(torch.maximum(-box1, box0 - (d_t - 1)).clamp(min=0)
                     .max())
            qq = q[sel]
            # the shells r0 .. R at once, R doubling until one stops the
            # search: shell r holds the rows whose cell is r cells from
            # the box (within r0: shell r0), and the search stops after the
            # first shell past which every query is done
            R = r0 + 1
            while True:
                found = _shell_rows(start, base, dims, box0.tolist(),
                                    box1.tolist(), R, False)
                p = pts[found]
                pc = torch.div(p[:, :3] - lo, cell, rounding_mode="floor")
                shell = torch.maximum((box0 - pc).amax(1),
                                      (pc - box1).amax(1)) \
                    .clamp(min=r0) - r0
                best = torch.full((sel.shape[0], R - r0 + 1), 1 << 62,
                                  device=dev)
                for s in range(0, found.shape[0], chunk):
                    ps = p[s:s + chunk]
                    d = ((qq[:, None] - ps[None, :, :3]) ** 2).sum(2)
                    best.scatter_reduce_(
                        1, shell[None, s:s + chunk].expand_as(d),
                        (d << 32) + ps[None, :, 3], "amin")
                best = torch.cummin(best, 1).values
                # the least gap from each query to a cell outside the box
                # grown by r; done once it exceeds the best distance
                r = torch.arange(r0, R + 1, device=dev)[:, None, None]
                gap_lo = torch.where(box0 - r - 1 >= 0,
                                     qq - (lo + (box0 - r) * cell) + 1, _FAR)
                gap_hi = torch.where(box1 + r + 1 <= d_t - 1,
                                     lo + (box1 + r + 1) * cell - qq, _FAR)
                m = torch.minimum(gap_lo, gap_hi).amin(2)
                done = ((m == _FAR) | (m * m > (best.T >> 32))).all(1)
                if bool(done.any()):
                    last = int(done.nonzero()[0])
                    break
                R = 2 * R - r0 + 1
            inside = shell <= last
            staged[k] += int(inside.sum())
            if keep_rows:
                kept[k].append(found[inside])
            out[sel] = (best[:, last] & 0xFFFFFFFF).to(torch.int32)
    if keep_rows:
        return out, staged, [torch.cat(r) if r else
                             torch.zeros(0, dtype=torch.long, device=dev)
                             for r in kept]
    return out, staged


def nn_tiles(q_coords, q_mask, index: TileIndex, order):
    """Kernel C2 on CUDA tensors, its plain version on CPU tensors: the
    1-NN of every searched query over `index`, the queries taken QTILE at
    a time in `order`. Returns (idx [Vq] int32, 0 for the others; staged
    [tiles] int32, the index rows each tile staged)."""
    if q_coords.device.type == "cpu":
        return nn_tiles_plain(q_coords, q_mask, index, order)
    Vq = q_coords.shape[0]
    if q_coords.dtype != torch.int32 or q_coords.shape != (Vq, 4) \
            or q_mask.dtype != torch.bool or q_mask.shape != (Vq,) \
            or order.dtype != torch.int32 or order.shape != (Vq,):
        raise ValueError("nn_tiles: want int32 coords [Vq, 4], a bool mask "
                         "and an int32 order of the queries")
    native.check_cuda("nn_tiles", q_coords, q_mask, index.pts,
                      index.cell_start, index.geo, order)
    out = torch.empty(Vq, dtype=torch.int32, device=q_coords.device)
    staged = torch.empty(-(-Vq // QTILE), dtype=torch.int32,
                         device=q_coords.device)
    _tile_kernel(native.ptr(q_coords), native.ptr(q_mask), Vq,
                 native.ptr(order), native.ptr(index.pts),
                 native.ptr(index.cell_start), native.ptr(index.geo),
                 int(index.batched), native.ptr(out), native.ptr(staged),
                 native.stream(q_coords.device))
    return out, staged


def nn_match_tiled(q_coords, q_mask, r_coords, r_mask, n_batch: int = 0):
    """The 1-NN of `nn_match` on every valid query (0 for the others),
    for the grid chamfer's large matches: `build_tile_index` over the
    references, `tile_order`, then kernel C2 (CUDA tensors) or its plain
    version (CPU tensors). No host read for n_batch >= 1. [Vq] int32."""
    _check_match_inputs("nn_match_tiled", q_coords, q_mask, r_coords, r_mask)
    index = build_tile_index(r_coords, r_mask, n_batch)
    order = tile_order(q_coords, q_mask, index)
    return nn_tiles(q_coords, q_mask, index, order)[0]
