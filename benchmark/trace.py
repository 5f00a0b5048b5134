"""Reading a torch.profiler trace of the card: kernels by category, the
device's busy time, the benchmark's own annotated spans, the completeness
guard and the breakdown that a traced run prints.

`category` is a frozen copy of the kernel-name rules of the repository's
`chip_smoke.py` (`_category`): the port's kernels by the names of their
CUDA entry points, cuBLAS GEMMs, sorts, scatters and gathers, copies, and
the rest (elementwise kernels and reductions) as "other".
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

_CATEGORIES = (("A3", ("conv3_columns_dw",)),
               ("A1", ("conv3_columns",)),
               ("B1", ("kmap3_",)),
               ("C2", ("nn_match_tiled",)),
               ("C1", ("nn_match",)),
               ("F1", ("fps_cluster",)),
               ("gemm", ("gemm", "xmma", "cutlass", "cublas", "nvjet")),
               ("adam", ("multi_tensor",)),
               ("nccl", ("nccl",)),
               ("sort", ("sort", "radix")),
               ("memcpy", ("memcpy",)),
               ("memset", ("memset",)),
               ("scatter_gather", ("index", "scatter", "gather")),
               ("copy", ("copy",)))

GLUE = ("copy", "other")    # copies, casts, concats, elementwise, reductions


def category(name: str) -> str:
    low = name.lower()
    # A4 runs A1's tile kernels on int8 (`signed char`) feats
    if "conv3_columns" in low and "kernel<signed char" in low:
        return "A4"
    return next((c for c, keys in _CATEGORIES
                 if any(k in low for k in keys)), "other")


@dataclass
class Kernel:
    name: str
    start: float     # us on the profiler's clock
    end: float
    cat: str


@dataclass
class Trace:
    """One traced window: its device kernels, the device extents of the
    benchmark's annotations by name, the host's annotations, and the host
    wall time of the window."""
    kernels: list
    spans: dict                     # name -> [(start, end)] device us
    host_spans: list                # (name, start, end) host us
    wall_s: float
    t0: float                       # profiler us at the window's start
    host_ops: list = field(default_factory=list)  # every host op, likewise

    def busy_s(self) -> float:
        """Seconds in which at least one operation ran on the device."""
        total, cur_s, cur_e = 0.0, None, None
        for k in sorted(self.kernels, key=lambda k: k.start):
            if cur_e is None or k.start > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = k.start, k.end
            else:
                cur_e = max(cur_e, k.end)
        if cur_e is not None:
            total += cur_e - cur_s
        return total * 1e-6

    def inside(self, span: str) -> list:
        """Kernels that start within a device extent of annotation
        `span`."""
        ext = sorted(self.spans.get(span, []))
        out, j = [], 0
        for k in sorted(self.kernels, key=lambda k: k.start):
            while j < len(ext) and ext[j][1] < k.start:
                j += 1
            if j < len(ext) and ext[j][0] <= k.start <= ext[j][1]:
                out.append(k)
        return out

    def extent_s(self, *names: str) -> float:
        """From the first device extent of the spans `names` to the end of
        their last."""
        ext = [x for n in names for x in self.spans.get(n, [])]
        if not ext:
            return 0.0
        return (max(e for _, e in ext) - min(s for s, _ in ext)) * 1e-6

    def device_ops(self, n: int = 10) -> list:
        by: dict = {}
        for k in self.kernels:
            by[k.name] = by.get(k.name, 0.0) + (k.end - k.start) * 1e-6
        return [[name[:200], s] for name, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest stretches with no device operation, each named by
        the innermost host annotation under way at its start."""
        ks = sorted(self.kernels, key=lambda k: k.start)
        gaps, end = [], self.t0
        for k in ks:
            if k.start > end:
                gaps.append((end, k.start))
            end = max(end, k.end)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            under = [h for h in self.host_spans if h[1] <= s <= h[2]]
            name = min(under, key=lambda h: h[2] - h[1])[0] if under \
                else "host outside the benchmark's annotations"
            ops = [h for h in self.host_ops if h[1] <= s <= h[2]]
            if ops:
                name += " / " + min(ops, key=lambda h: h[2] - h[1])[0]
            out.append([name[:200], (e - s) * 1e-6])
        return out


class Recorder:
    """torch.profiler over a window, with the benchmark's annotations."""

    def __init__(self):
        self.prof = None
        self.wall_s = 0.0

    @contextlib.contextmanager
    def window(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function("bench.window"):
                t = time.perf_counter()
                yield
                torch.cuda.synchronize()
                self.wall_s = time.perf_counter() - t
        self.prof = prof

    def read(self, names=("bench.",)) -> Trace:
        kernels, spans, host, ops = [], {}, [], []
        t0 = None
        for e in self.prof.events():
            s = e.time_range.start
            en = e.time_range.end
            on_device = e.device_type == torch.autograd.DeviceType.CUDA
            if e.name.startswith(names) or getattr(
                    e, "is_user_annotation", False):
                if on_device:
                    spans.setdefault(e.name, []).append((s, en))
                else:
                    host.append((e.name, s, en))
                    if e.name == "bench.window":
                        t0 = s
                continue
            if on_device:
                kernels.append(Kernel(e.name, s, en, category(e.name)))
            else:
                ops.append((e.name, s, en))
        if t0 is None:
            t0 = min((k.start for k in kernels), default=0.0)
        return Trace(kernels=kernels, spans=spans, host_spans=host,
                     wall_s=self.wall_s, t0=t0, host_ops=ops)


def annotate(name: str, on: bool):
    return torch.profiler.record_function(name) if on \
        else contextlib.nullcontext()


# the program's launch counters (the `launches` of its `ops.*` kernel
# wrappers), by the category their kernels fall in
COUNTERS = {"A1": ("sparse_conv", "_conv3_kernel"),
            "A4": ("sparse_conv", "_conv3_q_kernel"),
            "A3": ("sparse_conv", "_conv3_dw_kernel"),
            "B1": ("grid", "_kmap3_kernel"),
            "B1 taps": ("grid", "_taps_kernel"),
            "C1": ("knn", "_nn_kernel"),
            "C2": ("knn", "_tile_kernel"),
            "F1": ("fps", "_fps_kernel")}


def launches() -> dict:
    import importlib
    out = {}
    for kind, (mod, attr) in COUNTERS.items():
        m = importlib.import_module(f"lidiff_tpu_torch.ops.{mod}")
        out[kind] = getattr(m, attr).launches
    return out


def launched(before: dict, after: dict) -> dict:
    """Launches by category between two readings of `launches`."""
    d = {k: after[k] - before[k] for k in after}
    d["B1"] += d.pop("B1 taps")
    return {k: v for k, v in d.items() if v}


def guard(trace: Trace, launched: dict) -> list:
    """The kinds whose kernels the trace holds fewer of than their launch
    counters counted in the window: (kind, seen, launched)."""
    seen: dict = {}
    for k in trace.kernels:
        seen[k.cat] = seen.get(k.cat, 0) + 1
    return [(kind, seen.get(kind, 0), n) for kind, n in launched.items()
            if seen.get(kind, 0) < n]
