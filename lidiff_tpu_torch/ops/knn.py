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

`nn_match_pruned` computes the same function for large, lex-sorted inputs
(the grid chamfer's 1.08M x 360k matches): each tile of QTILE queries scans
only the contiguous interval of reference rows that an exact key-gap bound
cannot rule out. `prune_intervals` finds the intervals (kernel
`nn_window_bound` plus a little tensor code), kernel C2 `nn_match_pruned`
of `csrc/nn_match_pruned.cu` scans them; `nn_match_pruned_plain` and
`window_bound_plain` are their plain versions. Every distance and bound is
an exact integer, so the result equals `nn_match` on every valid query,
sorted input or not (unsorted input only prunes less).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from lidiff_tpu_torch.ops import keys as K
from lidiff_tpu_torch.ops import native

_BIG = 1e18
QTILE = 256           # queries per interval (the kernel's block size)
RBLK = 512            # reference rows per prunable block (read at call time)
UWND_MIN, UWND_MAX = 512, 4096   # reference rows of the upper-bound window
NO_BOUND = 2 ** 31 - 1   # window bound of a query with no valid ref in it

_nn_kernel = native.Kernel(
    "nn_match", "nn_match",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
_nn_kernel.scans = 0  # of its launches, those over a one-cell-per-item index
_bound_kernel = native.Kernel(
    "nn_match_pruned", "nn_window_bound",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
_pruned_kernel = native.Kernel(
    "nn_match_pruned", "nn_match_pruned",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p])


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
# pruned 1-NN: survivor intervals (prolog) + interval scan (kernel C2)
# ---------------------------------------------------------------------------

_NO_PRUNE = 1 << 62      # "no bound" as an int64 squared distance
_HI_INF = 1 << 30        # beyond every hi key; its square stays below 2^62


def _check_pruned_inputs(name, q_coords, q_mask, r_coords, r_mask):
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


def window_rows(n_refs: int) -> int:
    """Rows of the upper-bound window for `n_refs` reference rows: a 64th
    of them in steps of 512, between UWND_MIN and UWND_MAX. A wider window
    costs queries x rows distance tests and gives tighter bounds, so
    shorter intervals; a 64th keeps its cost near 1.6% of a full scan."""
    return min(UWND_MAX, max(UWND_MIN, n_refs // 64 // 512 * 512))


def window_bound_plain(q_coords, q_mask, r_coords, r_mask, win_start,
                       window: int, batched: bool = True,
                       tile: int = QTILE, chunk: int = 16):
    """Plain PyTorch version of kernel `nn_window_bound`, in int64.

    Per tile of `tile` queries: the largest, over its valid queries, of the
    squared distance to the nearest valid same-batch reference among rows
    [win_start, win_start + window) -- an upper bound on every such query's
    true 1-NN distance. NO_BOUND where a valid query finds no such row; 0
    for a tile without valid queries. Returns [tiles] int32."""
    Vq = q_coords.shape[0]
    nt = -(-Vq // tile)
    pad = nt * tile - Vq
    q = F.pad(q_coords.long(), (0, 0, 0, pad)).reshape(nt, tile, 4)
    qm = F.pad(q_mask, (0, pad)).reshape(nt, tile)
    r = r_coords.long()
    rows = torch.arange(window, device=q_coords.device)
    out = torch.empty(nt, dtype=torch.int32, device=q_coords.device)
    for s in range(0, nt, chunk):
        idx = win_start[s:s + chunk].long()[:, None] + rows       # [c, U]
        w, qq = r[idx], q[s:s + chunk]                  # [c, U, 4], [c, T, 4]
        d = ((qq[:, :, None, 1:] - w[:, None, :, 1:]) ** 2).sum(-1)
        bad = ~r_mask[idx][:, None, :]
        if batched:
            bad = bad | (qq[:, :, None, 0] != w[:, None, :, 0])
        u2 = d.masked_fill(bad, NO_BOUND).min(dim=2).values       # [c, T]
        u2 = u2.masked_fill(~qm[s:s + chunk], 0)
        out[s:s + chunk] = u2.max(dim=1).values.to(torch.int32)
    return out


def window_bound(q_coords, q_mask, r_coords, r_mask, win_start,
                 window: int, n_batch: int = 0):
    """Kernel `nn_window_bound` on CUDA tensors (tiles of QTILE queries),
    its plain version on CPU tensors."""
    if q_coords.device.type == "cpu":
        return window_bound_plain(q_coords, q_mask, r_coords, r_mask,
                                  win_start, window, n_batch != 1)
    Vq, Vr = q_coords.shape[0], r_coords.shape[0]
    nt = -(-Vq // QTILE)
    if win_start.dtype != torch.int32 or win_start.shape != (nt,) \
            or not 0 < window <= Vr:
        raise ValueError("window_bound: want one int32 window start per "
                         "query tile and a window of at most Vr rows")
    native.check_cuda("window_bound", q_coords, q_mask, r_coords, r_mask,
                      win_start)
    out = torch.empty(nt, dtype=torch.int32, device=q_coords.device)
    _bound_kernel(native.ptr(q_coords), native.ptr(q_mask), Vq,
                  native.ptr(r_coords), native.ptr(r_mask), Vr,
                  native.ptr(win_start), window, int(n_batch != 1),
                  native.ptr(out), native.stream(q_coords.device))
    return out


def window_starts(q_coords, r_coords, window: int):
    """First row of each query tile's upper-bound window: the position of
    the tile's first query (of QTILE) in the reference keys, a quarter
    window back, kept in range. [tiles] int32. On unsorted rows the binary
    search lands anywhere in range, which still gives a valid bound."""
    Vr = r_coords.shape[0]
    r_key, _ = K.pack(r_coords[:, 0], r_coords[:, 1:])
    first = q_coords[::QTILE]
    a_key, _ = K.pack(first[:, 0], first[:, 1:])
    pos = torch.searchsorted(r_key, a_key)
    return (pos - window // 4).clamp(0, Vr - window).to(torch.int32)


def _hi_key(coords):
    """batch * COORD_SPAN + (x + COORD_OFF): the high half of the packed
    key. Within a batch item a difference of hi keys is a difference in x,
    which no distance undercuts; across items it is at least COORD_SPAN
    minus the x range, so far items prune themselves."""
    return coords[:, 0].long() * K.COORD_SPAN + coords[:, 1].long() \
        + K.COORD_OFF


def prune_intervals(q_coords, q_mask, r_coords, r_mask, n_batch: int = 0):
    """Per tile of QTILE queries, the contiguous range of reference rows
    that can hold a 1-NN of one of its valid queries: (start, cnt), [tiles]
    int32 each, in rows, `start` a multiple of RBLK.

    The argument of lidiff_tpu/ops/pallas_knn.py `_prune_mask`, in exact
    integers (so without its float margin):
      * u2[tile]: an upper bound on the squared 1-NN distance of every
        valid query of the tile, from a window of `window_rows(Vr)` rows
        around the position of the tile's first query in the reference
        keys (`window_bound`); any in-range window gives a valid bound;
      * gap[tile, block]: the distance between the tile's and the block's
        ranges of the hi key, a lower bound on the distance of every
        (query, row) pair of the two;
      * a block survives iff gap^2 <= u2: a row of a block with
        gap^2 > u2 is strictly farther than a row of the window, so it is
        no argmin, ties included.
    The interval runs from the first to the last surviving block (a
    superset of the survivors: exact for unsorted input too), cnt = 0 where
    no block survives (a tile without valid queries). With fewer than 3
    blocks or fewer than UWND_MIN rows nothing is pruned: every tile gets
    all rows, as the JAX package then runs its unpruned grid."""
    _check_pruned_inputs("prune_intervals", q_coords, q_mask, r_coords,
                         r_mask)
    Vq, Vr = q_coords.shape[0], r_coords.shape[0]
    dev = q_coords.device
    tile, block = QTILE, RBLK
    nt, nr = -(-Vq // tile), -(-Vr // block)
    if nr < 3 or Vr < UWND_MIN:
        return (torch.zeros(nt, dtype=torch.int32, device=dev),
                torch.full((nt,), Vr, dtype=torch.int32, device=dev))
    window = window_rows(Vr)
    win_start = window_starts(q_coords, r_coords, window)
    u2 = window_bound(q_coords, q_mask, r_coords, r_mask, win_start, window,
                      n_batch).long()
    u2 = torch.where(u2 == NO_BOUND, _NO_PRUNE, u2)

    q_hi = F.pad(_hi_key(q_coords), (0, nt * tile - Vq)).reshape(nt, tile)
    qm = F.pad(q_mask, (0, nt * tile - Vq)).reshape(nt, tile)
    th0 = q_hi.masked_fill(~qm, _HI_INF).min(dim=1).values
    th1 = q_hi.masked_fill(~qm, -_HI_INF).max(dim=1).values
    # min and max (not first and last): right for unsorted rows too
    r_hi = _hi_key(r_coords)
    bh0 = F.pad(r_hi, (0, nr * block - Vr), value=_HI_INF) \
        .reshape(nr, block).min(dim=1).values
    bh1 = F.pad(r_hi, (0, nr * block - Vr), value=-_HI_INF) \
        .reshape(nr, block).max(dim=1).values
    gap = torch.maximum(bh0[None, :] - th1[:, None],
                        th0[:, None] - bh1[None, :]).clamp_(min=0)
    ok = gap * gap <= u2[:, None]                           # [tiles, blocks]
    any_ok = ok.any(dim=1)
    lo = ok.int().argmax(dim=1)                  # first surviving block
    hi = nr - ok.flip(1).int().argmax(dim=1)     # one past the last
    start = torch.where(any_ok, lo * block, 0)
    end = torch.where(any_ok, (hi * block).clamp(max=Vr), 0)
    return start.to(torch.int32), (end - start).to(torch.int32)


def _match_intervals_plain(q_coords, r_coords, r_mask, start, cnt):
    """Per tile of QTILE queries, the argmin over its interval of rows only,
    distances in float64 (exact, as `nn_match_plain`); index 0 where the
    interval holds no valid same-batch row."""
    Vq = q_coords.shape[0]
    tile = QTILE
    out = torch.zeros(Vq, dtype=torch.int32, device=q_coords.device)
    for i, (s, c) in enumerate(zip(start.tolist(), cnt.tolist())):
        if c == 0:
            continue
        q = q_coords[i * tile:(i + 1) * tile].double()
        rc = r_coords[s:s + c].double()
        r_xyz = rc[:, 1:]
        d = (r_xyz * r_xyz).sum(-1)[None, :] - 2.0 * (q[:, 1:] @ r_xyz.T)
        penal = (q[:, 0:1] != rc[None, :, 0]) | ~r_mask[None, s:s + c]
        d = d.masked_fill(penal, _BIG)
        idx = torch.argmin(d, dim=1)
        found = d.gather(1, idx[:, None])[:, 0] < _BIG
        out[i * tile:(i + 1) * tile] = torch.where(found, idx + s, 0)
    return out


def nn_match_intervals(q_coords, r_coords, r_mask, start, cnt,
                       n_batch: int = 0):
    """Kernel C2 on CUDA tensors, its plain version on CPU tensors: the
    1-NN of `nn_match`, tile i of QTILE queries scanning the reference rows
    [start[i], start[i] + cnt[i]) only. Returns [Vq] int32."""
    if q_coords.device.type == "cpu":
        return _match_intervals_plain(q_coords, r_coords, r_mask, start, cnt)
    Vq, Vr = q_coords.shape[0], r_coords.shape[0]
    nt = -(-Vq // QTILE)
    if start.dtype != torch.int32 or cnt.dtype != torch.int32 \
            or start.shape != (nt,) or cnt.shape != (nt,):
        raise ValueError("nn_match_intervals: want one int32 (start, cnt) "
                         "per query tile")
    native.check_cuda("nn_match_intervals", q_coords, r_coords, r_mask,
                      start, cnt)
    out = torch.empty(Vq, dtype=torch.int32, device=q_coords.device)
    _pruned_kernel(native.ptr(q_coords), Vq, native.ptr(r_coords),
                   native.ptr(r_mask), Vr, native.ptr(start),
                   native.ptr(cnt), int(n_batch != 1), native.ptr(out),
                   native.stream(q_coords.device))
    return out


def nn_match_pruned(q_coords, q_mask, r_coords, r_mask, n_batch: int = 0):
    """`nn_match` with exact interval pruning: `prune_intervals`, then
    kernel C2 (CUDA tensors) or its plain version (CPU tensors). Equal to
    `nn_match` on every valid query; meant for lex-sorted inputs, where the
    intervals are short."""
    start, cnt = prune_intervals(q_coords, q_mask, r_coords, r_mask, n_batch)
    return nn_match_intervals(q_coords, r_coords, r_mask, start, cnt,
                              n_batch)


def nn_match_pruned_plain(q_coords, q_mask, r_coords, r_mask,
                          n_batch: int = 0, intervals=None):
    """Plain PyTorch version of `nn_match_pruned` on any device: the same
    intervals (or the given ones, one per QTILE queries), then per query
    tile an argmin over its interval only."""
    if intervals is None:
        intervals = prune_intervals(q_coords, q_mask, r_coords, r_mask,
                                    n_batch)
    return _match_intervals_plain(q_coords, r_coords, r_mask, *intervals)
