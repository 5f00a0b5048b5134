"""Useful work of a LiDiff network on a given cloud, counted from the
benchmark's own voxelization (`reference.voxel`), never from the program's
capacities, tile plans or launches.

- a 27-tap conv: 2 Cin Cout G per tap that hits (an occupied neighbour);
- the ks=2 stride-2 down and transpose convs: 2 Cin Cout G per parent-child
  pair (one per occupied voxel of the finer level);
- 1x1 shortcuts, gate MLPs and the head: 2 in out G per occupied row
  (voxel, batch item or point).
Bytes count each input and output once: feats in and out, weights, bias.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from benchmark.reference import voxel
from benchmark.reference.nets import channels

PEAK_BF16 = 989e12        # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bytes/s


@dataclass
class Occupancy:
    voxels: list    # occupied voxels per level
    hits: list      # taps that hit, summed over the level's voxels
    items: int      # batch items
    points: int     # points (rows of the head)


def occupancy(points: torch.Tensor, res: float, num_levels: int = 5):
    """Occupied voxels and 27-tap hits per level of [B, N, 3] points."""
    pyr = voxel.pyramid(points, res, num_levels)
    return Occupancy(voxels=[l.size for l in pyr.levels],
                     hits=[int((n >= 0).sum()) for n in pyr.nbrs],
                     items=points.shape[0],
                     points=points.shape[0] * points.shape[1])


@dataclass
class Op:
    kind: str       # conv27 | down | up | dense | mlp_item | head
    cin: int
    cout: int
    level: int      # the level its rows live on (the finer for down/up)
    groups: int


def _unet(cs, groups, stem_groups, gates: bool, head_out: int):
    ops = [Op("conv27", 3, cs[0], 0, stem_groups),
           Op("conv27", cs[0], cs[0], 0, stem_groups)]
    c4 = cs[4]

    def gate(out, hidden, lvl):
        if gates:
            ops.extend([Op("dense", c4, c4, lvl, groups),
                        Op("dense", c4, c4, lvl, groups),
                        Op("dense", 2 * c4, hidden, lvl, groups),
                        Op("dense", hidden, out, lvl, groups),
                        Op("mlp_item", 96, 96, lvl, 1),
                        Op("mlp_item", 96, c4, lvl, 1)])

    def residual(cin, cout, lvl):
        ops.append(Op("conv27", cin, cout, lvl, groups))
        ops.append(Op("conv27", cout, cout, lvl, groups))
        if cin != cout:
            ops.append(Op("dense", cin, cout, lvl, groups))

    gate_s = [(cs[0], c4), (cs[1], c4), (cs[2], c4), (cs[3], c4)]
    for i in range(4):
        gate(*gate_s[i], i)
        ops.append(Op("down", cs[i], cs[i], i, groups))
        residual(cs[i], cs[i + 1], i + 1)
        residual(cs[i + 1], cs[i + 1], i + 1)
    gate_u = [(c4, c4), (cs[5], cs[5]), (cs[6], cs[6]), (cs[7], cs[7])]
    for i in range(4):
        gate(*gate_u[i], 4 - i)
        fine = 3 - i
        ops.append(Op("up", cs[4 + i], cs[5 + i], fine, groups))
        residual(cs[5 + i] + cs[3 - i], cs[5 + i], fine)
        residual(cs[5 + i], cs[5 + i], fine)
    ops.append(Op("head", cs[8], 20, 0, groups))
    ops.append(Op("head", 20, head_out, 0, groups))
    return ops


def denoiser_ops(cr: float = 1.0, groups: int = 2):
    """MinkUNetDiff with `groups` conditioning banks (the stem runs once)."""
    return _unet(channels(cr), groups, 1, True, 3)


def refiner_ops(cr: float = 1.0, out_channels: int = 18):
    return _unet(channels(cr), 1, 1, False, out_channels)


def flops(op: Op, occ: Occupancy) -> float:
    rows = {"conv27": occ.hits[op.level], "down": occ.voxels[op.level],
            "up": occ.voxels[op.level], "dense": occ.voxels[op.level],
            "mlp_item": occ.items, "head": occ.points}[op.kind]
    return 2.0 * op.cin * op.cout * op.groups * rows


def total_flops(ops, occ: Occupancy) -> float:
    return sum(flops(op, occ) for op in ops)


def conv_bound_s(op: Op, occ: Occupancy, elem: int = 2,
                 weight_grad: bool = False) -> float:
    """Least time of one 27-tap conv (or its weight gradient) on the card:
    the larger of its FLOPs over the bf16 peak and its bytes over the HBM
    rate. Forward: feats in and out at `elem` bytes, bf16 weights, float32
    bias. Weight gradient: feats and cotangent in, float32 dW out."""
    v = occ.voxels[op.level]
    if weight_grad:
        nbytes = v * op.groups * (op.cin + op.cout) * elem \
            + 27 * op.cin * op.cout * 4
    else:
        nbytes = v * op.groups * (op.cin + op.cout) * elem \
            + 27 * op.cin * op.cout * 2 + op.cout * 4
    return max(flops(op, occ) / PEAK_BF16, nbytes / PEAK_BYTES)
