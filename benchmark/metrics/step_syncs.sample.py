"""step_syncs.sample: host calls into the CUDA runtime that wait for the
card (stream, device and event synchronisations and blocking copies)
inside the traced scan's `lidiff.sample.step` host spans, per guided
solver step."""

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def read(layer: dict):
    t, steps = layer.get("trace"), layer.get("steps")
    if t is None or not steps:
        return None
    spans = sorted((s, e) for n, s, e in t.host_spans
                   if n == "lidiff.sample.step")
    if not spans:
        return None
    n = sum(1 for name, s, _ in t.host_ops if name in SYNCS
            and any(a <= s <= b for a, b in spans))
    return n / steps
