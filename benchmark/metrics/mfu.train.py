"""mfu.train: three times the forward's useful FLOPs of the traced
training steps (forward, data gradient, weight gradient; the recompute of
remat is not useful work), counted by `benchmark/work.py` from the voxels
each batch occupies, over the traced window's wall time (host clock,
synchronised at both ends; the window holds those steps and nothing else)
times the H100's dense bf16 peak (989 TFLOP/s)."""

from benchmark import work


def read(layer: dict):
    t, occ, ops = layer.get("trace"), layer.get("occupancy"), \
        layer.get("ops")
    if t is None or not occ or ops is None:
        return None
    wall = t.wall_s
    if wall <= 0:
        return None
    flops = 3 * sum(work.total_flops(ops, o) for o in occ)
    return 100.0 * flops / (wall * work.PEAK_BF16)
