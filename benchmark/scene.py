"""The traffic generator: a seeded street scene, ray-cast by a rotating
64-beam LiDAR along a seeded drive.

Every traffic mix under `benchmark/traffic/` is a JSON file of parameters
that this module reads. The mix's `scene_seed` makes the street and the
drive; the seed of the run draws the order of the poses and every draw of
the scans themselves. The scene is a ground plane below the sensor, façades of
buildings on both sides of a street, parked cars along the curbs, poles and
trees (a trunk and a crown), all as axis-aligned boxes and vertical
cylinders. Each scan is the first return of every beam and azimuth step
within the sensor's range window, with Gaussian range noise, in the frame of
its pose (the sensor at the origin, x ahead). All of it runs in a few large
tensor operations on the given device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


def uniform(gen, lo, hi, n, device):
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device,
                                       dtype=torch.float64)


@dataclass
class Scene:
    boxes: torch.Tensor      # [nb, 6] float64: min xyz, max xyz
    cyls: torch.Tensor       # [nc, 5] float64: cx, cy, r, zmin, zmax
    ground_z: float


def _row(gen, dev, x0, x1, spacing):
    """Positions along x from x0 to x1 at a seeded spacing."""
    n = int((x1 - x0) / spacing[0]) + 2
    steps = uniform(gen, spacing[0], spacing[1], n, dev)
    xs = x0 + torch.cumsum(steps, 0)
    return xs[xs < x1]


def make_scene(p: dict, gen: torch.Generator, device) -> Scene:
    """The street of traffic parameters `p` (section "scene")."""
    s = p["scene"]
    dev = device
    x0, x1 = s["extent_x"]
    g = s["ground_z"]
    half = float(uniform(gen, *s["street_half_width"], 1, dev))
    boxes, cyls = [], []
    for side in (-1.0, 1.0):
        # façades: buildings of seeded length and height, with gaps
        b = s["buildings"]
        x = x0
        while x < x1:
            ln, dp, ht, gap, back = (float(v) for v in torch.cat([
                uniform(gen, *b["length"], 1, dev),
                uniform(gen, *b["depth"], 1, dev),
                uniform(gen, *b["height"], 1, dev),
                uniform(gen, *b["gap"], 1, dev),
                uniform(gen, *b["setback"], 1, dev)]))
            y_in = side * (half + back)
            y_out = side * (half + back + dp)
            boxes.append([x, min(y_in, y_out), g, x + ln, max(y_in, y_out),
                          g + ht])
            x += ln + gap
        # parked cars along the curb, some places left empty
        c = s["cars"]
        xs = _row(gen, dev, x0, x1, c["spacing"])
        keep = torch.rand(xs.shape[0], generator=gen, device=dev,
                          dtype=torch.float64) >= c["empty_share"]
        off = uniform(gen, *c["curb_offset"], xs.shape[0], dev)
        L, W, H = c["size"]
        for xc, o in zip(xs[keep].tolist(), off[keep].tolist()):
            y_in = side * (half - c["lane"] - o)
            y_out = y_in - side * W
            boxes.append([xc, min(y_in, y_out), g, xc + L, max(y_in, y_out),
                          g + H])
        # poles and trees on the pavement
        for kind in ("poles", "trees"):
            t = s[kind]
            xs = _row(gen, dev, x0, x1, t["spacing"])
            n = xs.shape[0]
            r = uniform(gen, *t["radius"], n, dev)
            h = uniform(gen, *t["height"], n, dev)
            y = side * (half - uniform(gen, *t["inset"], n, dev))
            for xc, yc, rc, hc in zip(xs.tolist(), y.tolist(), r.tolist(),
                                      h.tolist()):
                cyls.append([xc, yc, rc, g, g + hc])
            if kind == "trees":
                cw = uniform(gen, *t["crown"], n, dev)
                ch = uniform(gen, *t["crown_height"], n, dev)
                for xc, yc, hc, w, d in zip(xs.tolist(), y.tolist(),
                                            h.tolist(), cw.tolist(),
                                            ch.tolist()):
                    boxes.append([xc - w / 2, yc - w / 2, g + hc, xc + w / 2,
                                  yc + w / 2, g + hc + d])
    f64 = dict(dtype=torch.float64, device=dev)
    return Scene(boxes=torch.tensor(boxes, **f64),
                 cyls=torch.tensor(cyls, **f64).reshape(-1, 5), ground_z=g)


def drive(p: dict, gen: torch.Generator, n: int, device) -> torch.Tensor:
    """[n, 3] poses (x, y, yaw), `step` m apart along the street with a
    seeded lateral drift and heading."""
    d = p["drive"]
    dev = device
    x = d["start"] + d["step"] * torch.arange(n, dtype=torch.float64,
                                              device=dev)
    phase = uniform(gen, 0.0, 2 * math.pi, 2, dev)
    t = torch.arange(n, dtype=torch.float64, device=dev)
    y = d["lateral"] * torch.sin(t / d["period"] + phase[0])
    yaw = d["yaw"] * torch.sin(t / d["period"] + phase[1])
    return torch.stack([x, y, yaw], 1)


def beam_directions(p: dict, az0: float, device) -> torch.Tensor:
    """[beams * steps, 3] unit directions in the sensor frame."""
    s = p["sensor"]
    el = torch.cat([torch.linspace(*s["upper"][:2], s["upper"][2],
                                   dtype=torch.float64),
                    torch.linspace(*s["lower"][:2], s["lower"][2],
                                   dtype=torch.float64)]).to(device)
    el = el * math.pi / 180
    az = az0 + torch.arange(s["azimuth_steps"], dtype=torch.float64,
                            device=device) * (2 * math.pi
                                              / s["azimuth_steps"])
    el, az = torch.meshgrid(el, az, indexing="ij")
    return torch.stack([torch.cos(el) * torch.cos(az),
                        torch.cos(el) * torch.sin(az),
                        torch.sin(el)], -1).reshape(-1, 3)


def _first_hit(scene: Scene, o: torch.Tensor, d: torch.Tensor,
               block: int = 16384) -> torch.Tensor:
    """[R] distance along each unit ray from `o` to its first surface, inf
    for none."""
    out = []
    inv = 1.0 / torch.where(d == 0, 1e-30, d)
    for s in range(0, d.shape[0], block):
        dd, iv = d[s:s + block], inv[s:s + block]
        best = torch.where(dd[:, 2] < 0, (scene.ground_z - o[2]) / dd[:, 2],
                           math.inf)
        if scene.boxes.shape[0]:
            t1 = (scene.boxes[None, :, :3] - o) * iv[:, None, :]
            t2 = (scene.boxes[None, :, 3:] - o) * iv[:, None, :]
            tn = torch.minimum(t1, t2).amax(2)
            tf = torch.maximum(t1, t2).amin(2)
            hit = (tn <= tf) & (tn > 0)
            best = torch.minimum(best, torch.where(hit, tn, math.inf)
                                 .amin(1))
        if scene.cyls.shape[0]:
            c = scene.cyls
            ox, oy = o[0] - c[:, 0], o[1] - c[:, 1]
            a = (dd[:, 0] ** 2 + dd[:, 1] ** 2)[:, None]
            b = 2 * (ox[None] * dd[:, :1] + oy[None] * dd[:, 1:2])
            cc = (ox ** 2 + oy ** 2 - c[:, 2] ** 2)[None]
            disc = b * b - 4 * a * cc
            t = (-b - torch.sqrt(disc.clamp(min=0))) / (2 * a.clamp(
                min=1e-30))
            z = o[2] + t * dd[:, 2:3]
            hit = (disc >= 0) & (t > 0) & (z >= c[None, :, 3]) \
                & (z <= c[None, :, 4])
            best = torch.minimum(best, torch.where(hit, t, math.inf)
                                 .amin(1))
        out.append(best)
    return torch.cat(out)


def scan(p: dict, scene: Scene, pose: torch.Tensor, gen: torch.Generator,
         frame: bool = True) -> torch.Tensor:
    """One scan from `pose`: [n, 3] float32 points in the pose's frame
    (`frame`) or in the world frame."""
    s = p["sensor"]
    dev = scene.boxes.device
    az0 = float(uniform(gen, 0.0, 2 * math.pi, 1, dev))
    d_local = beam_directions(p, az0, dev)
    cy, sy = math.cos(float(pose[2])), math.sin(float(pose[2]))
    rot = torch.tensor([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]],
                       dtype=torch.float64, device=dev)
    o = torch.stack([pose[0], pose[1], torch.zeros_like(pose[0])])
    rng = _first_hit(scene, o, d_local @ rot.T)
    rng = rng + s["range_noise"] * torch.randn(rng.shape, generator=gen,
                                               device=dev,
                                               dtype=torch.float64)
    keep = (rng > s["min_range"]) & (rng < s["max_range"])
    pts = d_local[keep] * rng[keep, None]
    if not frame:
        pts = pts @ rot.T + o
    return pts.float()


def to_frame(points: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """World points into the frame of `pose`."""
    cy, sy = math.cos(float(pose[2])), math.sin(float(pose[2]))
    rot = torch.tensor([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]],
                       dtype=torch.float64, device=points.device)
    o = torch.stack([pose[0], pose[1], torch.zeros_like(pose[0])])
    return ((points.double() - o) @ rot).float()


def generator(seed: int, device) -> torch.Generator:
    """The seed of the run: any whole number, folded into 63 bits."""
    return torch.Generator(device=device).manual_seed(
        int(seed) % (1 << 63))


def _street(p: dict, n_poses: int, device):
    """The mix's street and drive, from its own `scene_seed`: every run's
    seed sees the same geometry, so the work a run does depends on the
    seed only through the order of the poses and the draws of each
    scan."""
    gen = generator(p["scene_seed"], device)
    scene = make_scene(p, gen, device)
    return scene, drive(p, gen, n_poses, device)


def drive_scans(p: dict, seed: int, device) -> list[torch.Tensor]:
    """`pool` scans of the mix's drive, each in its pose's frame, the
    poses in an order drawn from `seed`, which also draws each scan's
    first azimuth and range noise."""
    scene, poses = _street(p, p["pool"], device)
    gen = generator(seed, device)
    order = torch.randperm(p["pool"], generator=gen, device=device)
    return [scan(p, scene, poses[int(i)], gen) for i in order]


def _tile_to(points: torch.Tensor, n: int, gen) -> torch.Tensor:
    """`n` rows: a seeded subset of more, whole copies and a seeded subset
    of fewer."""
    m = points.shape[0]
    dev = points.device
    if m >= n:
        return points[torch.randperm(m, generator=gen, device=dev)[:n]]
    reps = points.repeat(n // m, 1)
    rest = points[torch.randperm(m, generator=gen, device=dev)[:n - len(
        reps)]]
    return torch.cat([reps, rest])


def voxel_unique(points: torch.Tensor, size: float) -> torch.Tensor:
    """The first point of each voxel of edge `size` (floor grid), in the
    points' order."""
    c = torch.floor(points.double() / size).long()
    c = c - c.amin(0)
    span = c.amax(0) + 1
    key = (c[:, 0] * span[1] + c[:, 1]) * span[2] + c[:, 2]
    _, inv = torch.unique(key, return_inverse=True)
    first = torch.full((int(inv.max()) + 1,), points.shape[0],
                       dtype=torch.int64, device=points.device)
    first.scatter_reduce_(0, inv, torch.arange(points.shape[0],
                                                device=points.device),
                          "amin")
    return points[torch.sort(first).values]


def refine_items(p: dict, seed: int, device) -> dict:
    """`items` refiner training items of the mix's drive, stacked in an
    order drawn from `seed`: {'pcd_noise': [items, n_noise, 3],
    'pcd_full': [items, n_full, 3]}. Item i aggregates the `window` scans
    of poses i*stride .. in the frame of the window's last scan (as
    LiDiff's TemporalKITTIAggrDataset); the input is the window jittered
    (sigma, clip) within `max_range`, the target the window voxel-unique
    at `voxel` within `max_range`, each tiled or subsampled to its size.
    The seed draws the scans' azimuths and noise, the jitter and the
    subsamples."""
    r = p["refine"]
    n_poses = (r["items"] - 1) * r["stride"] + r["window"]
    scene, poses = _street(p, n_poses, device)
    gen = generator(seed, device)
    world = [scan(p, scene, poses[i], gen, frame=False)
             for i in range(n_poses)]
    noise, full = [], []
    order = torch.randperm(r["items"], generator=gen, device=device)
    for it in order.tolist():
        i0 = it * r["stride"]
        last = poses[i0 + r["window"] - 1]
        cat = to_frame(torch.cat(world[i0:i0 + r["window"]]), last)
        jit = (r["sigma"] * torch.randn(cat.shape, generator=gen,
                                        device=device)).clamp(-r["clip"],
                                                              r["clip"])
        pn = cat + jit
        pn = pn[pn.norm(dim=1) < r["max_range"]]
        pf = voxel_unique(cat, r["voxel"])
        pf = pf[pf.norm(dim=1) < r["max_range"]]
        noise.append(_tile_to(pn, r["noise_points"], gen))
        full.append(_tile_to(pf, r["full_points"], gen))
    return {"pcd_noise": torch.stack(noise), "pcd_full": torch.stack(full)}
