"""serialize_ms.ptv3: device milliseconds per training step in Point
Transformer V3's serialization: the kernels inside the
`lidiff.ptv3.serialize` device extents (each level's four codes, their
sorts and inverses, the patch maps and the shuffle) of the traced steps,
over the steps."""


def read(layer: dict):
    t, steps = layer.get("trace"), layer.get("steps")
    if t is None or not steps or "lidiff.ptv3.serialize" not in t.spans:
        return None
    return sum(k.end - k.start for k in t.inside("lidiff.ptv3.serialize")) \
        * 1e-3 / steps
