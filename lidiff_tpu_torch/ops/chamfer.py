"""Differentiable Chamfer distance (counterpart of
lidiff_tpu/ops/chamfer.py): squared L2, mean over points per direction, sum
of the two directions, mean over the batch.

A 1-NN *index* pass without gradient, then a differentiable gather of the
true float coordinates and the distance, so gradients reach both clouds
without differentiating through an argmin. Two index passes:

* "exact": a blocked running argmin of |t|^2 - 2 q.t over target tiles,
  O(N * M) pairs in float32 GEMMs.
* "grid": both clouds are quantized to an integer grid, the target
  lex-sorted by packed key, and matched by the tiled voxel matcher
  (`ops.knn.nn_match_tiled`: a grid index of the sorted target, then kernel
  C2 on the card, whose tiles of queries search the index's cells around
  them). Ties go to the lowest row of the sorted target, as in the JAX
  package, which matches the sorted arrays too. The pick is the argmin of
  voxel-centre distances, so it can differ from the true neighbour only
  among targets within 2 * sqrt(3) * res of it; the loss gathers true
  coordinates, which bounds its error by O(res * d). By default the grid
  step is adaptive: the joint extent of both (masked) clouds is scaled to
  +-(COORD_LIM - 1), so the error is relative to the extent.
  LIDIFF_CHAMFER_RES (or `grid_res`) sets an absolute step instead.

`method="auto"` (the default) takes "grid" from 2^26 pairs per item up and
"exact" below; LIDIFF_CHAMFER=exact|grid overrides it.
"""

from __future__ import annotations

import os

import torch

from lidiff_tpu_torch.ops import keys as K
from lidiff_tpu_torch.ops.knn import nn_match_tiled
from lidiff_tpu_torch.utils import prof

_BIG = 1e30
_FAR = 1e15               # coordinates of a masked-out target
_AUTO_GRID_PAIRS = 1 << 26
# The grid of the reference: the JAX package clamps quantized coordinates
# to +-(COORD_LIM - 1) because its TPU matcher is exact only up to there.
# The port's integer kernel is exact up to +-2047, but the clamp and the
# adaptive step derived from it decide which point is picked, so the port
# keeps them.
COORD_LIM = 1280


def nn_indices(query: torch.Tensor, target: torch.Tensor,
               target_mask: torch.Tensor | None = None,
               q_block: int = 4096, t_tile: int = 8192) -> torch.Tensor:
    """[N, 3] x [M, 3] -> [N] int64 indices of the nearest target, exact:
    a running argmin over target tiles, first index on ties."""
    with torch.no_grad():
        tgt = target
        if target_mask is not None:
            tgt = torch.where(target_mask[:, None], tgt,
                              torch.full_like(tgt, _FAR))
        N, M = query.shape[0], tgt.shape[0]
        t_sq = (tgt * tgt).sum(-1)
        out = torch.empty(N, dtype=torch.int64, device=query.device)
        for s in range(0, N, q_block):
            q = query[s:s + q_block]
            best_d = torch.full((q.shape[0],), _BIG, dtype=q.dtype,
                                device=q.device)
            best_i = torch.zeros(q.shape[0], dtype=torch.int64,
                                 device=q.device)
            for j in range(0, M, t_tile):
                t = tgt[j:j + t_tile]
                d = t_sq[None, j:j + t_tile] - 2.0 * (q @ t.T)
                i_min = torch.argmin(d, dim=1)
                d_min = d.gather(1, i_min[:, None])[:, 0]
                upd = d_min < best_d
                best_d = torch.where(upd, d_min, best_d)
                best_i = torch.where(upd, i_min + j, best_i)
            out[s:s + q_block] = best_i
        return out


def _grid_lim() -> int:
    """Largest quantized |coordinate|: the tighter of the reference's grid
    bound and the 12-bit span of the packed keys."""
    return min(COORD_LIM - 1, K.COORD_MAX)


def _adaptive_res(clouds_and_masks) -> torch.Tensor:
    """Grid step that scales the joint (masked) extent of the clouds to the
    usable integer range, as a 0-d float32 tensor."""
    m = None
    for pts, mask in clouds_and_masks:
        a = pts.abs().amax(dim=-1)
        if mask is not None:
            a = torch.where(mask, a, 0.0)
        m = a.max() if m is None else torch.maximum(m, a.max())
    return m.clamp(min=1e-9) / _grid_lim()


def grid_coords(points: torch.Tensor, mask: torch.Tensor | None, res,
                n_batch: int = 1):
    """Quantize `points` [B*N, 3] (flattened batch-major: row i belongs to
    item i * n_batch // rows) with step `res`. Returns (coords [B*N, 4]
    int32 (batch, x, y, z), mask [B*N] bool), in input order. Coordinates
    beyond the grid are clamped to its edge."""
    n = points.shape[0]
    dev = points.device
    batch = (torch.arange(n, device=dev) * n_batch) // n
    lim = _grid_lim()
    # torch.round is round-half-even, as jnp.round
    ci = torch.round(points / res).to(torch.int32).clamp(-lim, lim)
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    return torch.cat([batch[:, None].to(torch.int32), ci], dim=1), mask


def grid_sort(points: torch.Tensor, mask: torch.Tensor | None, res,
              n_batch: int = 1):
    """`grid_coords`, lex-sorted by packed key. Returns (coords, mask, perm
    [B*N] int64), all in sorted order: sorted row k is input row
    perm[k]."""
    coords, mask = grid_coords(points, mask, res, n_batch)
    key, _ = K.pack(coords[:, 0], coords[:, 1:])
    _, perm = torch.sort(key, stable=True)
    return coords[perm], mask[perm], perm


def nn_indices_grid(query: torch.Tensor, target: torch.Tensor,
                    target_mask: torch.Tensor | None = None,
                    query_mask: torch.Tensor | None = None,
                    res=None, n_batch: int = 1) -> torch.Tensor:
    """Near-1-NN indices through the tiled voxel matcher.

    query [B*N, 3] and target [B*M, 3] float, flattened batch-major.
    Returns [B*N] int64 indices into the flattened target (same item
    whenever the item has a valid target). `res`: the grid step, a float or
    a 0-d tensor, None for the adaptive step. A point beyond the grid picks
    a candidate near its edge and is not dropped."""
    with torch.no_grad():
        if res is None:
            res = _adaptive_res([(query, query_mask), (target, target_mask)])
        # the target lex-sorted, as the JAX package matches it: the index
        # is built over the sorted target, so a tie goes to its lowest
        # sorted row (an index over the unsorted target would break ties
        # by another row). A query's match does not depend on where the
        # query stands, so the queries keep their order (the JAX package
        # sorts them too; the matcher orders them by cell itself).
        t_sorted, tm, t_perm = grid_sort(target, target_mask, res, n_batch)
        q, qm = grid_coords(query, query_mask, res, n_batch)
        idx = nn_match_tiled(q, qm, t_sorted, tm, n_batch=n_batch)
        return t_perm[idx.long()]


def chamfer_distance(x: torch.Tensor, y: torch.Tensor,
                     x_mask: torch.Tensor | None = None,
                     y_mask: torch.Tensor | None = None,
                     method: str | None = None,
                     grid_res: float | None = None) -> torch.Tensor:
    """Batched symmetric squared-L2 chamfer of x [B, N, 3] and y [B, M, 3],
    pytorch3d semantics. `method`: "exact" | "grid" | "auto" (None reads
    LIDIFF_CHAMFER, default "auto"). `grid_res`: the grid path's step; None
    reads LIDIFF_CHAMFER_RES and, without it, takes the adaptive step."""
    with prof.annotate("lidiff.train.chamfer"):
        if method is None:
            method = os.environ.get("LIDIFF_CHAMFER", "auto")
        if method == "auto":
            method = ("grid" if x.shape[1] * y.shape[1] >= _AUTO_GRID_PAIRS
                      else "exact")
        if method not in ("grid", "exact"):
            raise ValueError(f"chamfer_distance: unknown method {method!r}")
        B, N = x.shape[:2]
        M = y.shape[1]
        xf, yf = x.reshape(B * N, 3), y.reshape(B * M, 3)
        mx = None if x_mask is None else x_mask.reshape(B * N)
        my = None if y_mask is None else y_mask.reshape(B * M)
        if method == "grid":
            if grid_res is None and os.environ.get("LIDIFF_CHAMFER_RES"):
                grid_res = float(os.environ["LIDIFF_CHAMFER_RES"])
            if grid_res is None:
                # one step for both directions: the two matches must quantize
                # alike, or the symmetric loss would mix two grids
                with torch.no_grad():
                    grid_res = _adaptive_res([(xf, mx), (yf, my)])
            ix = nn_indices_grid(xf, yf, my, mx, grid_res, n_batch=B)
            iy = nn_indices_grid(yf, xf, mx, my, grid_res, n_batch=B)
        else:
            # one item at a time, indices shifted into the flattened arrays
            ix = torch.cat([b * M + nn_indices(
                x[b], y[b], None if y_mask is None else y_mask[b])
                for b in range(B)])
            iy = torch.cat([b * N + nn_indices(
                y[b], x[b], None if x_mask is None else x_mask[b])
                for b in range(B)])
        # index_select and not points[idx]: its backward adds the rows with
        # atomics, the indexed form's sorts them first (0.44 against 0.58 ms
        # forward + backward for 1.08M rows out of 360k on an H100, 0.41
        # against 0.73 ms the other way round; chip_smoke.py times both)
        d_xy = ((xf - yf.index_select(0, ix)) ** 2).sum(-1).reshape(B, N)
        d_yx = ((yf - xf.index_select(0, iy)) ** 2).sum(-1).reshape(B, M)
        if x_mask is not None:
            d_xy = torch.where(x_mask, d_xy, 0.0)
            nx = x_mask.sum(dim=1).clamp(min=1)
        else:
            nx = N
        if y_mask is not None:
            d_yx = torch.where(y_mask, d_yx, 0.0)
            ny = y_mask.sum(dim=1).clamp(min=1)
        else:
            ny = M
        return (d_xy.sum(dim=1) / nx + d_yx.sum(dim=1) / ny).mean()

