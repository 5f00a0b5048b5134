"""A1_roofline.sample: the least time of the traced guided steps' 27-tap
convs on the card (for each, the larger of its hit-tap FLOPs over the dense
bf16 peak and its bytes over 3.35 TB/s; `benchmark/work.py`) over the device
time of the A1 kernels inside those steps' denoiser passes."""

from benchmark import work


def read(layer: dict):
    t, occ, ops = layer.get("trace"), layer.get("occupancy"), \
        layer.get("ops")
    if t is None or not occ or ops is None:
        return None
    a1 = sum(k.end - k.start for k in t.inside("bench.denoise")
             if k.cat == "A1") * 1e-6
    if a1 <= 0:
        return None
    bound = sum(work.conv_bound_s(op, o) for o in occ for op in ops
                if op.kind == "conv27")
    return 100.0 * bound / a1
