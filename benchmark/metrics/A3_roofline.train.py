"""A3_roofline.train: the least time of the traced training steps' conv
weight gradients on the card (for each 27-tap conv, the larger of its
hit-tap FLOPs over the dense bf16 peak and its bytes, bf16 feats and
cotangent in and float32 dW out, over 3.35 TB/s; `benchmark/work.py`) over
the device time of the A3 kernels in the traced window, which holds those
steps and nothing else (the backward pass runs on autograd's own thread,
outside the host annotations)."""

from benchmark import work


def read(layer: dict):
    t, occ, ops = layer.get("trace"), layer.get("occupancy"), \
        layer.get("ops")
    if t is None or not occ or ops is None:
        return None
    a3 = sum(k.end - k.start for k in t.kernels if k.cat == "A3") * 1e-6
    if a3 <= 0:
        return None
    bound = sum(work.conv_bound_s(op, o, weight_grad=True) for o in occ
                for op in ops if op.kind == "conv27")
    return 100.0 * bound / a3
