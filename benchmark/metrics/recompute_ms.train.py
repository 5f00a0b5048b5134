"""recompute_ms.train: device milliseconds per training step in remat's
recompute of the UNet stages' forward inside the backward pass: the
kernels inside the `lidiff.model.recompute` device extents of the traced
steps, over the steps."""


def read(layer: dict):
    t, steps = layer.get("trace"), layer.get("steps")
    if t is None or not steps or "lidiff.model.recompute" not in t.spans:
        return None
    ks = t.inside("lidiff.model.recompute")
    return sum(k.end - k.start for k in ks) * 1e-3 / steps
