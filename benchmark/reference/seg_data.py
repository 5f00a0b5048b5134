"""Plain PyTorch reference of the segmentation cells' data: SemanticKITTI's
learning map, Pointcept's train transforms (`pointcept/datasets/
transform.py`, the order of `configs/semantic_kitti/semseg-pt-v3m1-0-base.py`)
and its Mix3D collation, redone on the CPU from the random draws the
program recorded (its `draws` dicts), so that the check's batches do not
come from the code under test.

A scan's draws: "rotate" (the angle about z, or None), "scale", "flip"
(x, y), "jitter" (standard normals [N, 3]), "pick" (one integer a voxel,
in the voxels' key order), "crop" (the uniform draw of each of the two
sphere crops); a batch's: "mix". Every step is float32 where the
transform is, one operation at a time, so that the points and their
voxels come out bit for bit as a float32 implementation gives them.
"""

from __future__ import annotations

import math

import torch

IGNORE = -1
GRID = 0.05
CLIP = (-51.2, -51.2, -4.0, 51.2, 51.2, 2.4)
POINT_MAX = 120_000
CROP_RATE = 0.8
JITTER = (0.005, 0.02)          # sigma, clip

# SemanticKITTI raw label -> training class (Pointcept's learning map)
LEARNING_MAP = {0: IGNORE, 1: IGNORE, 10: 0, 11: 1, 13: 4, 15: 2, 16: 4,
                18: 3, 20: 4, 30: 5, 31: 6, 32: 7, 40: 8, 44: 9, 48: 10,
                49: 11, 50: 12, 51: 13, 52: IGNORE, 60: 8, 70: 14, 71: 15,
                72: 16, 80: 17, 81: 18, 99: IGNORE, 252: 0, 253: 6, 254: 5,
                255: 7, 256: 4, 257: 4, 258: 3, 259: 4}


def classes(raw: torch.Tensor) -> torch.Tensor:
    lut = torch.full((1 << 16,), IGNORE, dtype=torch.int64)
    for k, v in LEARNING_MAP.items():
        lut[k] = v
    return lut[raw.long() & 0xFFFF]


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _lex_key(g: torch.Tensor) -> torch.Tensor:
    """A key that sorts int64 coordinates [N, 3] as (x, y, z)."""
    span = g.max(0).values + 1
    return (g[:, 0] * span[1] + g[:, 1]) * span[2] + g[:, 2]


def _crop(c, rest, u: float, k: int):
    n = c.shape[0]
    if n <= k:
        return c, rest
    e = c - c[min(int(u * n), n - 1)]
    dist = (e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1]) + e[:, 2] * e[:, 2]
    keep = torch.sort(dist, stable=True).indices[:k]
    return c[keep], [r[keep] for r in rest]


def transform(coord, strength, segment, dr: dict) -> dict:
    """One scan's points after the train transforms: 'coord' [n, 3]
    float32, 'strength' [n, 1], 'segment' [n], 'grid_coord' [n, 3] int64.
    `coord` [N, 3] float32 as scanned, `segment` the training classes."""
    c = coord.float().clone()
    if dr["rotate"] is not None:
        cs, sn = _f32(math.cos(dr["rotate"])), _f32(math.sin(dr["rotate"]))
        x, y, z = c.unbind(1)
        c = torch.stack([x * cs - y * sn, x * sn + y * cs, z], 1)
    c = c * _f32(float(dr["scale"]))
    for axis, on in enumerate(dr["flip"]):
        if on:
            c[:, axis] = -c[:, axis]
    sigma, clip = JITTER
    z = torch.as_tensor(dr["jitter"], dtype=torch.float64)
    c = c + (sigma * z).clamp(-clip, clip).float()
    # grid sample: one point a voxel, the pick-th of its points in their
    # scan order
    g = torch.floor(c / torch.full_like(c, GRID)).long()
    g = g - g.min(0).values
    order = torch.sort(_lex_key(g), stable=True).indices
    _, count = torch.unique_consecutive(_lex_key(g)[order],
                                        return_counts=True)
    first = torch.cumsum(count, 0) - count
    pick = torch.as_tensor(dr["pick"], dtype=torch.int64)
    idx = order[first + pick % count]
    c, rest = c[idx], [strength[idx], segment[idx], g[idx]]
    lo, hi = _f32(CLIP[:3]), _f32(CLIP[3:])
    c = torch.maximum(torch.minimum(c, hi), lo)
    c, rest = _crop(c, rest, dr["crop"][0], int(CROP_RATE * c.shape[0]))
    c, rest = _crop(c, rest, dr["crop"][1], POINT_MAX)
    lo, hi = c.min(0).values, c.max(0).values
    shift = torch.stack([(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2,
                         torch.zeros((), dtype=torch.float32)])
    return {"coord": c - shift, "strength": rest[0], "segment": rest[1],
            "grid_coord": rest[2]}


def collate(items: list, mix: bool) -> dict:
    """The batch of `items` (transform's dicts): merged pairwise when
    `mix` (Mix3D), a voxel both items of a pair hold keeping the first's
    point."""
    groups = [items[i:i + 2] for i in range(0, len(items), 2)] if mix \
        else [[it] for it in items]
    gc, feat, seg, offset, total = [], [], [], [], 0
    for grp in groups:
        g = torch.cat([it["grid_coord"] for it in grp])
        f = torch.cat([torch.cat([it["coord"], it["strength"]], 1)
                       for it in grp])
        s = torch.cat([it["segment"] for it in grp])
        if len(grp) > 1:
            key = _lex_key(g)
            srt, order = torch.sort(key, stable=True)
            head = torch.ones_like(srt, dtype=torch.bool)
            head[1:] = srt[1:] != srt[:-1]
            keep = torch.sort(order[head]).values
            g, f, s = g[keep], f[keep], s[keep]
        gc.append(g)
        feat.append(f)
        seg.append(s)
        total += g.shape[0]
        offset.append(total)
    return {"grid_coord": torch.cat(gc).int(), "feat": torch.cat(feat),
            "segment": torch.cat(seg),
            "offset": torch.tensor(offset, dtype=torch.int64)}


def batches(scans: list, scan_draws: list, batch_draws: list,
            batch_size: int) -> list:
    """The batches of `scans` ((coord [N, 3], raw labels [N], strength
    [N, 1]) on the CPU) in groups of `batch_size`, from the recorded
    draws of each scan and each batch."""
    items = [transform(c, st, classes(raw), dr)
             for (c, raw, st), dr in zip(scans, scan_draws)]
    return [collate(items[k * batch_size:(k + 1) * batch_size], dr["mix"])
            for k, dr in enumerate(batch_draws)]


def differ(got: dict, ref: dict) -> float:
    """Entries of a batch (the program's) that are not bit for bit the
    reference's; inf where a shape differs."""
    out = 0
    for k in ("grid_coord", "feat", "segment", "offset"):
        a, b = got[k].cpu(), ref[k]
        if a.shape != b.shape:
            return float("inf")
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        out += int((a.long() != b.long()).sum())
    return out
