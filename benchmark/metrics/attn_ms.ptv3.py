"""attn_ms.ptv3: device milliseconds per training step in Point
Transformer V3's serialized attention, both ways: the kernels inside the
`lidiff.ptv3.attn` device extents (the gather of the patches' qkv rows,
SDPA and the rows' return, in the forward pass and, on autograd's
thread, in the backward pass) of the traced steps, over the steps."""


def read(layer: dict):
    t, steps = layer.get("trace"), layer.get("steps")
    if t is None or not steps or "lidiff.ptv3.attn" not in t.spans:
        return None
    return sum(k.end - k.start for k in t.inside("lidiff.ptv3.attn")) \
        * 1e-3 / steps
