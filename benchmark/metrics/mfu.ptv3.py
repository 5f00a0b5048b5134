"""mfu.ptv3: three times the forward's useful FLOPs of the traced Point
Transformer V3 training steps (attention, Linears, and convs over the
taps that hit; `benchmark/work_ptv3.py`, counted on the reference's own
voxel hash of each batch) over the traced window's wall time (host
clock, synchronised at both ends; the window holds those steps and
nothing else) times the H100's dense bf16 peak (989 TFLOP/s)."""

from benchmark import work_ptv3


def read(layer: dict):
    t, cnt, model = (layer.get("trace"), layer.get("ptv3_counts"),
                     layer.get("ptv3_model"))
    if t is None or not cnt or model is None or t.wall_s <= 0:
        return None
    flops = 3 * sum(work_ptv3.model_flops(c, model) for c in cnt)
    return 100.0 * flops / (t.wall_s * work_ptv3.PEAK_BF16)
