"""SemanticKITTI semantic segmentation data for Point Transformer V3:
the dataset, Pointcept's train transforms and its Mix3D collation
(Pointcept `pointcept/datasets/semantic_kitti.py`, `transform.py` and
`utils.point_collate_fn`; the config
`configs/semantic_kitti/semseg-pt-v3m1-0-base.py`).

Items are dicts of numpy arrays: 'coord' [N, 3] float32, 'strength'
[N, 1] float32 (the scan's remission), 'segment' [N] int64 (0..18, or
IGNORE). Every random draw comes from an explicit np.random.Generator;
given a dict `draws`, each random step keeps its draws there under its
name, which is all another implementation needs to redo the
augmentation.

Train transforms, in Pointcept's order: a rotation about z by an angle
uniform in [-pi, pi] with p 0.5, a scale uniform in [0.9, 1.1], flips of
x and of y each with p 0.5, a jitter N(0, 0.005) clipped at 0.02, then
GridSample at 0.05 m (one random point per voxel, and the grid coordinate
floor(coord / 0.05) minus the item's minimum), PointClip to (-51.2,
-51.2, -4, 51.2, 51.2, 2.4), SphereCrop to 80% of the points around a
random point, then to 120,000 points, and CenterShift of x and y. The
features are (coord, strength). Validation: GridSample and PointClip.

`collate` joins items into one batch and, with probability `mix_prob`,
merges them pairwise into one element each (Mix3D, as Pointcept merges the
offsets of consecutive items); a voxel both items of a pair occupy keeps
the first item's point.
"""

from __future__ import annotations

import math
import os

import numpy as np

from lidiff_tpu_torch.data.loader import DataLoader
from lidiff_tpu_torch.utils.natsort import natsorted

IGNORE = -1
GRID = 0.05
CLIP = (-51.2, -51.2, -4.0, 51.2, 51.2, 2.4)
POINT_MAX = 120_000

# SemanticKITTI raw label -> training class (Pointcept's learning map):
# 19 classes, the rest ignored
LEARNING_MAP = {0: IGNORE, 1: IGNORE, 10: 0, 11: 1, 13: 4, 15: 2, 16: 4,
                18: 3, 20: 4, 30: 5, 31: 6, 32: 7, 40: 8, 44: 9, 48: 10,
                49: 11, 50: 12, 51: 13, 52: IGNORE, 60: 8, 70: 14, 71: 15,
                72: 16, 80: 17, 81: 18, 99: IGNORE, 252: 0, 253: 6, 254: 5,
                255: 7, 256: 4, 257: 4, 258: 3, 259: 4}


def learning_map(raw: np.ndarray) -> np.ndarray:
    """Training classes of raw `.label` values (lower 16 bits)."""
    lut = np.full(1 << 16, IGNORE, dtype=np.int64)
    for k, v in LEARNING_MAP.items():
        lut[k] = v
    return lut[raw.astype(np.int64) & 0xFFFF]


def _keep(draws: dict | None, name: str, value):
    if draws is not None:
        draws[name] = value


def random_rotate_z(d: dict, rng, p: float = 0.5, draws=None) -> dict:
    """With probability p a rotation about z by an angle uniform in
    [-pi, pi] (draws["rotate"]: the angle, or None), in float32 as x c -
    y s, x s + y c."""
    a = rng.uniform(-1.0, 1.0) * np.pi if rng.random() < p else None
    _keep(draws, "rotate", a)
    if a is not None:
        c, s = np.float32(math.cos(a)), np.float32(math.sin(a))
        x, y, z = d["coord"].T
        d["coord"] = np.stack([x * c - y * s, x * s + y * c, z], 1)
    return d


def random_scale(d: dict, rng, low: float = 0.9, high: float = 1.1,
                 draws=None):
    scale = np.float32(rng.uniform(low, high))
    _keep(draws, "scale", scale)
    d["coord"] = d["coord"] * scale
    return d


def random_flip(d: dict, rng, p: float = 0.5, draws=None) -> dict:
    flips = [bool(rng.random() < p) for _ in (0, 1)]
    _keep(draws, "flip", flips)
    for axis, on in enumerate(flips):
        if on:
            d["coord"] = d["coord"].copy()
            d["coord"][:, axis] = -d["coord"][:, axis]
    return d


def random_jitter(d: dict, rng, sigma: float = 0.005, clip: float = 0.02,
                  draws=None):
    """draws["jitter"]: the standard normals [N, 3] (float64)."""
    z = rng.standard_normal(d["coord"].shape)
    _keep(draws, "jitter", z)
    j = np.clip(sigma * z, -clip, clip)
    d["coord"] = d["coord"] + j.astype(np.float32)
    return d


def _take(d: dict, idx: np.ndarray) -> dict:
    return {k: (v[idx] if isinstance(v, np.ndarray) else v)
            for k, v in d.items()}


def grid_sample(d: dict, rng, grid: float = GRID,
                train: bool = True, draws=None) -> dict:
    """One point per voxel of edge `grid` (a random one in train mode, the
    first otherwise, as Pointcept's `randint(0, count.max()) % count`;
    draws["pick"]: those integers, a voxel each in key order) and
    'grid_coord' = floor(coord / grid) minus the item's minimum."""
    g = np.floor(d["coord"] / grid).astype(np.int64)
    g -= g.min(0)
    span = g.max(0) + 1
    key = (g[:, 0] * span[1] + g[:, 1]) * span[2] + g[:, 2]
    order = np.argsort(key, kind="stable")
    _, count = np.unique(key[order], return_counts=True)
    first = np.cumsum(np.insert(count, 0, 0)[:-1])
    if train:
        pick = rng.integers(0, count.max(), count.size)
        _keep(draws, "pick", pick)
        first = first + pick % count
    idx = order[first]
    out = _take(d, idx)
    out["grid_coord"] = g[idx].astype(np.int32)
    return out


def point_clip(d: dict, lim=CLIP) -> dict:
    d["coord"] = np.clip(d["coord"], np.float32(lim[:3]),
                         np.float32(lim[3:])).astype(np.float32)
    return d


def sphere_crop(d: dict, rng, point_max: int | None = None,
                rate: float | None = None, draws=None) -> dict:
    """The `point_max` (or `rate` of the) points nearest a random one
    (draws["crop"]: the uniform draw of each crop, in turn)."""
    n = d["coord"].shape[0]
    k = int(rate * n) if rate is not None else point_max
    u = rng.random()
    if draws is not None:
        draws.setdefault("crop", []).append(u)
    if n <= k:
        return d
    e = d["coord"] - d["coord"][min(int(u * n), n - 1)]
    dist = (e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1]) + e[:, 2] * e[:, 2]
    return _take(d, np.argsort(dist, kind="stable")[:k])


def center_shift(d: dict) -> dict:
    lo, hi = d["coord"].min(0), d["coord"].max(0)
    shift = np.array([(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2, 0.0],
                     np.float32)
    d["coord"] = d["coord"] - shift
    return d


def train_transforms(d: dict, rng, draws: dict | None = None) -> dict:
    """The scan's own draws (rotation, scale, flips, the crops' centres)
    come from `rng` in a fixed number, the points' (jitter, the voxels'
    picks) from a generator drawn from it: a scan's augmentation does not
    shift with its point count. `draws`: see the module's docstring."""
    points = np.random.default_rng(rng.integers(1 << 63))
    d = random_rotate_z(d, rng, draws=draws)
    d = random_scale(d, rng, draws=draws)
    d = random_flip(d, rng, draws=draws)
    d = random_jitter(d, points, draws=draws)
    d = grid_sample(d, points, draws=draws)
    d = point_clip(d)
    d = sphere_crop(d, rng, rate=0.8, draws=draws)
    d = sphere_crop(d, rng, point_max=POINT_MAX, draws=draws)
    return center_shift(d)


def val_transforms(d: dict, rng) -> dict:
    return point_clip(grid_sample(d, rng))


def collate(items: list, mix_prob: float = 0.0, rng=None,
            draws: dict | None = None) -> dict:
    """One batch of numpy arrays: 'grid_coord' [N, 3] int32, 'feat' [N, 4]
    float32 (coord, strength), 'segment' [N] int64 and 'offset' [B] int64
    (the end of each element's points). With probability `mix_prob` the
    items are merged pairwise (Mix3D; draws["mix"]); a voxel both occupy
    keeps the first item's point."""
    mix = rng is not None and mix_prob > 0 and rng.random() < mix_prob
    _keep(draws, "mix", bool(mix))
    groups = [items[i:i + 2] for i in range(0, len(items), 2)] if mix \
        else [[it] for it in items]
    gc, feat, seg, offset = [], [], [], []
    total = 0
    for grp in groups:
        g = np.concatenate([it["grid_coord"] for it in grp])
        f = np.concatenate([np.concatenate([it["coord"], it["strength"]], 1)
                            for it in grp])
        s = np.concatenate([it["segment"] for it in grp])
        if len(grp) > 1:
            span = g.max(0).astype(np.int64) + 1
            key = (g[:, 0].astype(np.int64) * span[1] + g[:, 1]) * span[2] \
                + g[:, 2]
            _, first = np.unique(key, return_index=True)
            keep = np.sort(first)
            g, f, s = g[keep], f[keep], s[keep]
        gc.append(g)
        feat.append(f)
        seg.append(s)
        total += g.shape[0]
        offset.append(total)
    return {"grid_coord": np.concatenate(gc).astype(np.int32),
            "feat": np.concatenate(feat).astype(np.float32),
            "segment": np.concatenate(seg).astype(np.int64),
            "offset": np.asarray(offset, np.int64)}


class SemanticKITTISeg:
    """SemanticKITTI scans with their point labels:
    `<data_dir>/dataset/sequences/<seq>/velodyne/*.bin` (x, y, z,
    remission float32) and `labels/*.label` (uint32, class in the lower
    16 bits). Item i's draws come from a generator seeded by (seed, i,
    how often item i was read)."""

    def __init__(self, data_dir: str, seqs: list, split: str = "train",
                 seed: int = 0):
        self.split = split
        self.seed = seed
        self.reads: dict = {}
        self.files = []
        for seq in seqs:
            d = os.path.join(data_dir, "dataset", "sequences", str(seq))
            for f in natsorted(os.listdir(os.path.join(d, "velodyne"))):
                stem = os.path.splitext(f)[0]
                self.files.append((os.path.join(d, "velodyne", f),
                                   os.path.join(d, "labels",
                                                stem + ".label")))

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index: int) -> dict:
        scan_f, label_f = self.files[index]
        scan = np.fromfile(scan_f, dtype=np.float32).reshape(-1, 4)
        if os.path.isfile(label_f):
            seg = learning_map(np.fromfile(label_f, dtype=np.uint32))
        else:
            seg = np.full(scan.shape[0], IGNORE, dtype=np.int64)
        n = self.reads.get(index, 0)
        self.reads[index] = n + 1
        rng = np.random.default_rng((self.seed, index, n))
        d = {"coord": scan[:, :3].copy(), "strength": scan[:, 3:4].copy(),
             "segment": seg}
        d = train_transforms(d, rng) if self.split == "train" \
            else val_transforms(d, rng)
        d["index"] = index
        return d


class SegDataModule:
    """The train and validation loaders of a PTv3 config: the `data`
    section's data_dir, train/validation sequences and mix_prob, the
    `train` section's batch_size (the global batch) and num_workers."""

    def __init__(self, cfg, seed: int = 0):
        self.cfg = cfg
        self.seed = seed

    def _collate(self, mix_prob: float):
        def fn(items):
            rng = np.random.default_rng(
                [self.seed] + [int(it["index"]) for it in items])
            return collate(items, mix_prob, rng)
        return fn

    def train_dataloader(self, rank: int = 0, world: int = 1):
        d, t = self.cfg["data"], self.cfg["train"]
        ds = SemanticKITTISeg(d["data_dir"], d["train"], "train", self.seed)
        return DataLoader(ds, int(t["batch_size"]), shuffle=True,
                          num_workers=int(t["num_workers"]), rank=rank,
                          world=world, seed=self.seed,
                          collate_fn=self._collate(
                              float(d.get("mix_prob", 0.0))))

    def val_dataloader(self):
        d, t = self.cfg["data"], self.cfg["train"]
        ds = SemanticKITTISeg(d["data_dir"], d["validation"], "validation",
                              self.seed)
        return DataLoader(ds, 1, num_workers=int(t["num_workers"]),
                          drop_last=False, collate_fn=self._collate(0.0))
