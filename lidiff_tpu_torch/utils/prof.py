"""Timing and profiling hooks (counterpart of lidiff_tpu/utils/prof.py).

`StepTimer` keeps a step's wall time and an exponential moving average of
steps a second; `trace(log_dir)` captures a torch.profiler trace of the
enclosed region (host and, where a card is present, device activity) and
writes it as a Chrome trace; `annotate(name)` names a sub-region of an
active trace; `block_and_time` runs a function and waits for the card
before it stops the clock. `device_time_by_kernel` sums a finished
profile's device time by kernel name.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


class StepTimer:
    """Tracks step wall time and an exponential moving average of
    steps/sec."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.rate = None
        self._t = None

    def tic(self):
        self._t = time.perf_counter()

    def toc(self, steps: int = 1) -> float:
        dt = time.perf_counter() - self._t
        r = steps / max(dt, 1e-9)
        self.rate = r if self.rate is None else (
            self.ema * self.rate + (1 - self.ema) * r)
        return dt


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the enclosed region with torch.profiler (the card's kernels
    too where there is one) and yield the profiler; with `log_dir`, write
    the region as a Chrome trace `trace_<pid>_<n>.json` there afterwards
    (open it in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        n = len([f for f in os.listdir(log_dir) if f.startswith("trace_")])
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named sub-region inside an active trace."""
    with torch.profiler.record_function(name):
        yield


def block_and_time(fn, *args, **kwargs):
    """Run fn, wait for the card when any tensor of its output lies on
    one, and return (result, seconds)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    devices = {t.device for t in _tensors(out) if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def device_time_by_kernel(prof) -> dict[str, float]:
    """Device microseconds by kernel name over a finished profile. The
    device-side spans of `annotate` regions are not kernels and are left
    out (they would count their kernels' time twice)."""
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    return by_name
