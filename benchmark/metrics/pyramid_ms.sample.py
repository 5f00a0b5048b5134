"""pyramid_ms.sample: device milliseconds per guided solver step in the
pyramid builds (quantize, pooling, transpose maps, B1 and its tile plan):
the kernels inside the `lidiff.geom.pyramid` extents that lie in the
traced scan's solver loop (`benchmark/spans.py` `window` of
`lidiff.sample.step`), over its steps. The encoder's and the refiner's
pyramids lie outside the loop."""

from benchmark import spans
from benchmark import trace as tr


def read(layer: dict):
    t, steps = layer.get("trace"), layer.get("steps")
    if t is None or not steps or "lidiff.geom.pyramid" not in t.spans:
        return None
    w = spans.window(t, "lidiff.sample.step")
    if w is None:
        return None
    ext = [(s, e) for s, e in t.spans["lidiff.geom.pyramid"]
           if w[0] <= s and e <= w[1]]
    loop = tr.Trace(kernels=t.kernels, spans={"pyramid": ext},
                    host_spans=[], wall_s=t.wall_s, t0=t.t0)
    return sum(k.end - k.start for k in loop.inside("pyramid")) * 1e-3 \
        / steps
