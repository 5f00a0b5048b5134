"""glue_ms.sample: device milliseconds per guided solver step in the
model's glue (copies, casts, concatenations, elementwise kernels and
reductions: the categories `benchmark/trace.py` files as "copy" and
"other"), over the kernels of the traced steps' denoiser passes and solver
updates."""

from benchmark import trace as tr


def read(layer: dict):
    t, steps = layer.get("trace"), layer.get("steps")
    if t is None or not steps:
        return None
    ks = t.inside("bench.denoise") + t.inside("bench.solver")
    if not ks:
        return None
    glue = sum(k.end - k.start for k in ks if k.cat in tr.GLUE)
    return glue * 1e-3 / steps
