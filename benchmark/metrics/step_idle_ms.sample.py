"""step_idle_ms.sample: device milliseconds per guided solver step in
which no operation ran on the card, over the traced scan's solver loop
from its first kernel to its last (`benchmark/spans.py` `window` of
`lidiff.sample.step`: the steps and every span nested in them, chunk
boundaries included), over its steps."""

from benchmark import spans


def read(layer: dict):
    t, steps = layer.get("trace"), layer.get("steps")
    if t is None or not steps:
        return None
    w = spans.window(t, "lidiff.sample.step")
    if w is None:
        return None
    s0, e0 = w
    busy, cur_s, cur_e = 0.0, None, None
    for k in sorted(t.kernels, key=lambda k: k.start):
        s, e = max(k.start, s0), min(k.end, e0)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return (e0 - s0 - busy) * 1e-3 / steps
