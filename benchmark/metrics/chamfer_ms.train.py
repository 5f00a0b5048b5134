"""chamfer_ms.train: device milliseconds per training step in the chamfer
loss's forward (grid step, index, tile order, C2 both ways, the distances
and their means): the kernels inside the `lidiff.train.chamfer` device
extents of the traced steps, over the steps."""


def read(layer: dict):
    t, steps = layer.get("trace"), layer.get("steps")
    if t is None or not steps or "lidiff.train.chamfer" not in t.spans:
        return None
    ks = t.inside("lidiff.train.chamfer")
    return sum(k.end - k.start for k in ks) * 1e-3 / steps
