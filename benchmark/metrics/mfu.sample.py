"""mfu.sample: the useful FLOPs of the traced guided solver steps (counted
by `benchmark/work.py` from the voxels each step's input cloud occupies)
over the steps' time on the card, from the first operation of the first
step's denoiser pass to the end of the last step's solver update, times the
H100's dense bf16 peak (989 TFLOP/s)."""

from benchmark import work


def read(layer: dict):
    tr, occ, ops = layer.get("trace"), layer.get("occupancy"), \
        layer.get("ops")
    if tr is None or not occ or ops is None:
        return None
    wall = tr.extent_s("bench.denoise", "bench.solver")
    if wall <= 0:
        return None
    flops = sum(work.total_flops(ops, o) for o in occ)
    return 100.0 * flops / (wall * work.PEAK_BF16)
