"""The device-side window of a program span together with the spans nested
in it.

The profiler credits each kernel to the innermost span open on its
launching thread alone, and a span's device extent runs from the first to
the last kernel credited to it. So the extent of a span that encloses
others (a solver step around its denoiser pass and its update) can miss
the kernels of those inner spans. `window` takes the nested spans'
extents too: those of every span whose host instances all lie inside a
host instance of the outer one.
"""

from __future__ import annotations


def window(t, outer: str):
    """(start, end) device us from the first to the last kernel of the
    spans `outer` and of the spans always nested in them; None when the
    trace holds no host span `outer`."""
    hosts = [(s, e) for n, s, e in t.host_spans if n == outer]
    if not hosts:
        return None
    by_name: dict = {}
    for n, s, e in t.host_spans:
        by_name.setdefault(n, []).append((s, e))
    names = {n for n, spans in by_name.items()
             if all(any(a <= s and e <= b for a, b in hosts)
                    for s, e in spans)}
    ext = [x for n in names for x in t.spans.get(n, [])]
    if not ext:
        return None
    return min(s for s, _ in ext), max(e for _, e in ext)
