"""gather_bwd_ms.train: device milliseconds per training step in the
backward of the model's two row gathers, the transpose convs' parent rows
(`lidiff.grad.transpose_gather`) and the head's voxel rows
(`lidiff.grad.slice_to_points`): the kernels inside those spans' device
extents, which autograd's thread opens and closes around each gather's
backward node, over the traced steps."""

SPANS = ("lidiff.grad.transpose_gather", "lidiff.grad.slice_to_points")


def read(layer: dict):
    t, steps = layer.get("trace"), layer.get("steps")
    if t is None or not steps or not any(s in t.spans for s in SPANS):
        return None
    ks = {id(k): k for s in SPANS for k in t.inside(s)}
    return sum(k.end - k.start for k in ks.values()) * 1e-3 / steps
