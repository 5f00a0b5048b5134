"""Plain voxelization, pooling and kernel maps of the LiDiff networks.

The semantics of MinkowskiEngine as LiDiff uses it: a point goes to the
voxel round(p / res) (half to even), a voxel's feature is the mean of its
points, level l+1 pools level l's coordinates to floor(c / 2s) * 2s, and
coordinates stay in level-0 units. Rows of a level are in (batch, x, y, z)
order. Plain PyTorch; no capacities, padding or tiles.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_BITS = 20
_OFF = 1 << (_BITS - 1)


def pack(coords: torch.Tensor) -> torch.Tensor:
    """[.., 4] int64 (batch, x, y, z) -> [..] int64 keys in that order."""
    c = coords.long()
    key = c[..., 0]
    for i in (1, 2, 3):
        key = (key << _BITS) | (c[..., i] + _OFF)
    return key


@dataclass
class Level:
    coords: torch.Tensor   # [V, 4] int64, rows in key order
    key: torch.Tensor      # [V] int64, ascending
    stride: int

    @property
    def size(self) -> int:
        return self.key.shape[0]

    def lookup(self, coords: torch.Tensor) -> torch.Tensor:
        """Row of each [.., 4] coordinate, -1 where the level has none."""
        q = pack(coords)
        idx = torch.searchsorted(self.key, q).clamp(max=self.size - 1)
        return torch.where(self.key[idx] == q, idx, -1)


def _level(coords: torch.Tensor, stride: int):
    """Unique rows of [n, 4] coords: (Level, inverse [n])."""
    key, inv = torch.unique(pack(coords), sorted=True, return_inverse=True)
    uc = torch.zeros(key.shape[0], 4, dtype=torch.int64,
                     device=coords.device)
    uc[inv] = coords.long()
    return Level(coords=uc, key=key, stride=stride), inv


def voxelize(points: torch.Tensor, res: float):
    """points [B, N, 3] -> (level 0, mean point per voxel [V, 3] float32,
    voxel of each point [B, N])."""
    B, N, _ = points.shape
    c = torch.round(points.reshape(B * N, 3) / res).long()
    b = torch.arange(B, device=points.device).repeat_interleave(N)
    lvl, inv = _level(torch.cat([b[:, None], c], 1), 1)
    sums = torch.zeros(lvl.size, 3, dtype=torch.float32,
                       device=points.device)
    sums.index_add_(0, inv, points.reshape(B * N, 3).float())
    cnt = torch.bincount(inv, minlength=lvl.size).float()
    return lvl, sums / cnt[:, None], inv.reshape(B, N)


def pool(fine: Level):
    """(coarser level, parent row of each fine row)."""
    s2 = fine.stride * 2
    c = fine.coords.clone()
    c[:, 1:] = torch.div(c[:, 1:], s2, rounding_mode="floor") * s2
    return _level(c, s2)


def child_tap(fine: Level) -> torch.Tensor:
    """Tap of each fine row in its parent's 2x2x2 cell: x*4 + y*2 + z of
    (c / s) mod 2."""
    bits = torch.remainder(torch.div(fine.coords[:, 1:], fine.stride,
                                     rounding_mode="floor"), 2)
    return bits[:, 0] * 4 + bits[:, 1] * 2 + bits[:, 2]


_CUBE = torch.tensor([[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                      for dz in (-1, 0, 1)], dtype=torch.int64)


def neighbours(lvl: Level) -> torch.Tensor:
    """[V, 27] row of the voxel at c + o_k * stride (x slowest, z fastest),
    -1 where there is none."""
    off = _CUBE.to(lvl.coords.device) * lvl.stride
    q = lvl.coords[:, None, :].repeat(1, 27, 1)
    q[:, :, 1:] += off[None]
    return lvl.lookup(q)


@dataclass
class Pyramid:
    levels: list           # Level, finest first
    parents: list          # parent row of each row of levels[l], l < L-1
    taps: list             # child_tap of levels[l], l < L-1
    nbrs: list             # neighbours of each level
    feats: torch.Tensor    # [V0, 3] mean point per voxel
    p2v: torch.Tensor      # [B, N] voxel of each point


def pyramid(points: torch.Tensor, res: float, num_levels: int = 5,
            maps: bool = True) -> Pyramid:
    """Voxelize and pool `num_levels` levels; `maps` adds the 27-tap
    neighbour maps (the work counts need only the levels)."""
    lvl, feats, p2v = voxelize(points, res)
    levels, parents, taps = [lvl], [], []
    for _ in range(num_levels - 1):
        coarse, par = pool(levels[-1])
        taps.append(child_tap(levels[-1]))
        parents.append(par)
        levels.append(coarse)
    nbrs = [neighbours(l) for l in levels] if maps else []
    return Pyramid(levels, parents, taps, nbrs, feats, p2v)
