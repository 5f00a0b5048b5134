"""Plain references of LiDiff's refiner training step: the chamfer loss of
the upsampled cloud against the dense target, the rule by which the
port's grid chamfer picks each point's match, and Adam.

The grid chamfer (`lidiff_tpu/ops/chamfer.py`'s method, which the port
keeps) matches each point to the nearest target of its batch item after
both clouds are quantized with one step: the larger |coordinate| of either
cloud over 1279, coordinates rounded half to even. Ties go to the target
whose quantized (x, y, z) is lowest, then to its lowest row.
"""

from __future__ import annotations

import torch

LIM = 1279


def grid_step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(x.abs().amax(), y.abs().amax())
    return (m.clamp(min=1e-9) / LIM).float()


def quantize(p: torch.Tensor, step) -> torch.Tensor:
    return torch.round(p / step).long().clamp(-LIM, LIM)


def grid_match(queries: torch.Tensor, target: torch.Tensor, step,
               block: int = 128) -> torch.Tensor:
    """Row of `target` [M, 3] that the rule picks for each of
    `queries` [S, 3], each query against every target."""
    t = quantize(target, step)
    key = _key(t)
    rows = torch.arange(t.shape[0], device=t.device)
    big = torch.iinfo(torch.int64).max
    out = []
    for s in range(0, queries.shape[0], block):
        q = quantize(queries[s:s + block], step)
        d = ((q[:, None, :] - t[None]) ** 2).sum(2)
        near = d == d.amin(1, keepdim=True)
        kmin = torch.where(near, key[None], big).amin(1, keepdim=True)
        near &= key[None] == kmin
        out.append(torch.where(near, rows[None], t.shape[0]).amin(1))
    return torch.cat(out)


_OFFS = torch.tensor([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                      for k in (-1, 0, 1)])


def _key(t: torch.Tensor) -> torch.Tensor:
    return ((t[:, 0] + 2048) << 24) | ((t[:, 1] + 2048) << 12) \
        | (t[:, 2] + 2048)


def match_all(queries: torch.Tensor, target: torch.Tensor, step,
              cells=(8, 32, 128), budget: int = 1 << 24) -> torch.Tensor:
    """`grid_match` for every row of `queries`, without comparing each
    query with every target. A query's candidates are the targets in the
    3x3x3 block of cells (`cells[0]` grid steps wide) around it; its pick
    is final when every target outside the block lies farther than the
    best candidate. The others try the next, wider cells, and what is left
    goes to `grid_match`."""
    dev = queries.device
    q, t = quantize(queries, step), quantize(target, step)
    tkey = _key(t)
    big = torch.iinfo(torch.int64).max
    out = torch.full((q.shape[0],), -1, dtype=torch.int64, device=dev)
    todo = torch.arange(q.shape[0], device=dev)
    offs = _OFFS.to(dev)
    for c in cells:
        if todo.numel() == 0:
            break
        g = (2 * LIM) // c + 1
        tc = (t + LIM) // c
        order = torch.argsort((tc[:, 0] * g + tc[:, 1]) * g + tc[:, 2])
        skey = ((tc[:, 0] * g + tc[:, 1]) * g + tc[:, 2])[order]
        qc = (q[todo] + LIM) // c
        nb = qc[:, None, :] + offs[None]
        inside = ((nb >= 0) & (nb < g)).all(2)
        nkey = (nb[..., 0] * g + nb[..., 1]) * g + nb[..., 2]
        lo = torch.searchsorted(skey, nkey)
        cnt = (torch.searchsorted(skey, nkey, right=True) - lo) * inside
        # the squared distance beyond which a target outside the block may
        # lie (no bound on a side with no cell past the block)
        qq = q[todo]
        low = torch.where(qc > 0, qq - (qc - 1) * c + LIM + 1, big)
        high = torch.where(qc < g - 1, (qc + 2) * c - LIM - qq, big)
        reach = torch.minimum(low, high).amin(1).clamp(max=1 << 30) ** 2
        total = cnt.sum(1)
        ends = torch.cumsum(total, 0)
        done = torch.zeros_like(todo, dtype=torch.bool)
        s = 0
        while s < todo.numel():
            e = int(torch.searchsorted(ends, ends[s] - total[s] + budget,
                                       right=True))
            e = max(e, s + 1)
            n_c = cnt[s:e].reshape(-1)
            rep = torch.repeat_interleave(
                torch.arange(e - s, device=dev).repeat_interleave(27), n_c)
            first = torch.repeat_interleave(lo[s:e].reshape(-1), n_c)
            start = torch.repeat_interleave(torch.cumsum(n_c, 0) - n_c, n_c)
            cand = order[first + torch.arange(first.numel(), device=dev)
                         - start]
            d = ((qq[s:e][rep] - t[cand]) ** 2).sum(1)
            m = e - s
            dmin = torch.full((m,), big, dtype=torch.int64, device=dev)
            dmin = dmin.scatter_reduce(0, rep, d, "amin")
            near = d == dmin[rep]
            kmin = torch.full_like(dmin, big).scatter_reduce(
                0, rep, torch.where(near, tkey[cand], big), "amin")
            near &= tkey[cand] == kmin[rep]
            row = torch.full_like(dmin, big).scatter_reduce(
                0, rep, torch.where(near, cand, big), "amin")
            ok = dmin < reach[s:e]
            out[todo[s:e][ok]] = row[ok]
            done[s:e] = ok
            s = e
        todo = todo[~done]
    if todo.numel():
        out[todo] = grid_match(queries[todo], target, step)
    return out


def rule_matches(up: torch.Tensor, gt: torch.Tensor):
    """(ix, iy) of the rule for a batch: up [B, N, 3] to gt [B, M, 3] and
    back, as indices into the flattened other cloud."""
    B, N, _ = up.shape
    M = gt.shape[1]
    step = grid_step(up, gt)
    ix = torch.cat([match_all(up[b], gt[b], step) + b * M for b in range(B)])
    iy = torch.cat([match_all(gt[b], up[b], step) + b * N for b in range(B)])
    return ix, iy


def chamfer(up: torch.Tensor, gt: torch.Tensor, ix: torch.Tensor,
            iy: torch.Tensor) -> torch.Tensor:
    """Squared-L2 chamfer on given matches: per item the mean over up of
    |u - gt[ix]|^2 plus the mean over gt of |g - up[iy]|^2, then the mean
    over items."""
    B, N, _ = up.shape
    M = gt.shape[1]
    uf, gf = up.reshape(-1, 3), gt.reshape(-1, 3)
    d_xy = ((uf - gf[ix]) ** 2).sum(1).reshape(B, N)
    d_yx = ((gf - uf[iy]) ** 2).sum(1).reshape(B, M)
    return (d_xy.mean(1) + d_yx.mean(1)).mean()


class Adam:
    """Adam (Kingma and Ba 2015) with bias correction; eps added to the
    corrected root."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m, self.v, self.t = {}, {}, 0

    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        with torch.no_grad():
            for k, g in grads.items():
                m = self.m.get(k, torch.zeros_like(g))
                v = self.v.get(k, torch.zeros_like(g))
                self.m[k] = m = self.b1 * m + (1 - self.b1) * g
                self.v[k] = v = self.b2 * v + (1 - self.b2) * g * g
                params[k] -= self.lr * (m / c1) / ((v / c2).sqrt()
                                                   + self.eps)
