"""Batched 1-NN coordinate matching (counterpart of lidiff_tpu/ops/knn.py).

For every query voxel, the index of the nearest valid reference voxel of
the same batch item, ranked by |r|^2 - 2 q.r (the per-query |q|^2 never
changes an argmin), ties to the first index; a batch item with no valid
reference gives index 0, as the XLA path's argmin over all-penalized rows
does. Kernel C1 (`csrc/nn_match.cu`) computes it for CUDA tensors, its
plain PyTorch version `nn_match_plain` for CPU tensors.

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
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
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
