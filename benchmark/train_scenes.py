"""Training traffic made from `benchmark/scene.py`'s street: labelled
scans for segmentation.

- `labeled_scans`: scans of the drive in their poses' frames, each point
  labelled by the surface its ray hit, as a SemanticKITTI raw label: the
  ground 40 (road), a façade 50 (building), a parked car 10 (car), a
  tree's crown 70 (vegetation), its trunk 71 (trunk), a pole 80 (pole),
  with a strength (remission) drawn uniform in [0, 1). The scene keeps
  no kinds, so they are read from the traffic's own ranges: a box that
  starts above the ground is a crown, one as high as the cars is a car,
  the rest are façades; a cylinder taller than the trees' trunks can be
  is a pole.

Unlike `scene.py`'s mixes, these take their scans from the mix's own
`scene_seed` too (order, azimuths, noise): a training step's work follows
its voxels down to the coarsest level, which the scans' draws move by a
percent or two, beyond the cells' 1% bounds. The run's seed draws the
strength here, and the weights and every draw of the steps in the
driver.
"""

from __future__ import annotations

import math

import torch

from benchmark import scene

ROAD, BUILDING, CAR, VEGETATION, TRUNK, POLE = 40, 50, 10, 70, 71, 80


def _kinds(p: dict, sc: scene.Scene):
    """(label of each box, label of each cylinder)."""
    s = p["scene"]
    g = sc.ground_z
    b = sc.boxes
    car_h = s["cars"]["size"][2]
    box = torch.where(b[:, 2] > g + 0.5, VEGETATION,
                      torch.where(b[:, 5] - b[:, 2] <= car_h + 1e-6, CAR,
                                  BUILDING))
    cut = 0.5 * (s["trees"]["height"][1] + s["poles"]["height"][0])
    c = sc.cyls
    cyl = torch.where(c[:, 4] - c[:, 3] > cut, POLE, TRUNK)
    return box, cyl


def _sub(sc: scene.Scene, boxes, cyls) -> scene.Scene:
    """The scene's `boxes` and `cyls` alone, with no ground in reach."""
    return scene.Scene(boxes=sc.boxes[boxes], cyls=sc.cyls[cyls],
                       ground_z=-1e12)


def labeled_scan(p: dict, sc: scene.Scene, pose: torch.Tensor,
                 gen: torch.Generator, strength_gen: torch.Generator):
    """One scan from `pose` in its frame: (points [n, 3] float32, raw
    labels [n] int64, strength [n, 1] float32); `gen` draws the scan,
    `strength_gen` the strength."""
    s = p["sensor"]
    dev = sc.boxes.device
    az0 = float(scene.uniform(gen, 0.0, 2 * math.pi, 1, dev))
    d_local = scene.beam_directions(p, az0, dev)
    cy, sy = math.cos(float(pose[2])), math.sin(float(pose[2]))
    rot = torch.tensor([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]],
                       dtype=torch.float64, device=dev)
    o = torch.stack([pose[0], pose[1], torch.zeros_like(pose[0])])
    d = d_local @ rot.T
    rng = scene._first_hit(sc, o, d)
    box_kind, cyl_kind = _kinds(p, sc)
    kinds = [ROAD]
    dist = [torch.where(d[:, 2] < 0, (sc.ground_z - o[2]) / d[:, 2],
                        math.inf)]
    none_b = torch.zeros(box_kind.shape[0], dtype=torch.bool, device=dev)
    none_c = torch.zeros(cyl_kind.shape[0], dtype=torch.bool, device=dev)
    for k in (BUILDING, CAR, VEGETATION):
        kinds.append(k)
        dist.append(scene._first_hit(_sub(sc, box_kind == k, none_c), o, d))
    for k in (TRUNK, POLE):
        kinds.append(k)
        dist.append(scene._first_hit(_sub(sc, none_b, cyl_kind == k), o, d))
    which = torch.stack(dist, 1).argmin(1)
    label = torch.tensor(kinds, device=dev)[which]
    rng = rng + s["range_noise"] * torch.randn(rng.shape, generator=gen,
                                               device=dev,
                                               dtype=torch.float64)
    keep = (rng > s["min_range"]) & (rng < s["max_range"])
    pts = (d_local[keep] * rng[keep, None]).float()
    strength = torch.rand(pts.shape[0], 1, generator=strength_gen,
                          device=dev)
    return pts, label[keep], strength


def _scans_gen(p: dict, device) -> torch.Generator:
    """The mix's own draws of its scans (order, first azimuths, range
    noise): a step's work follows its scans' voxels, down to the coarsest
    level, so every run takes the same scans, as it takes the same
    street."""
    return scene.generator(p["scene_seed"] + 1, device)


def labeled_scans(p: dict, seed: int, device) -> list:
    """`pool` labelled scans of the mix's drive: [(points, raw labels,
    strength)], the scans the mix's own (`_scans_gen`); `seed` draws the
    strength."""
    sc, poses = scene._street(p, p["pool"], device)
    gen = _scans_gen(p, device)
    order = torch.randperm(p["pool"], generator=gen, device=device)
    sgen = scene.generator(seed, device)
    return [labeled_scan(p, sc, poses[int(i)], gen, sgen) for i in order]

