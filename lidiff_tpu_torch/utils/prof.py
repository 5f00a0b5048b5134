"""Timing and profiling hooks (counterpart of lidiff_tpu/utils/prof.py).

`trace(log_dir)` captures a torch.profiler trace of the enclosed region
(host and, where a card is present, device activity) and writes it as a
Chrome trace. `annotate(name)` is the program's one span call: inside a
trace it records a named range on the profiler's clock, which also gets a
device-side extent over the kernels launched inside it; outside a trace it
costs one check and records nothing. `annotate_backward(t, name)` names the
backward of the autograd node that made `t` the same way, and
`annotate_backward_region(first, last, name)` the backward of the nodes
from the one that made `last` down to the one that made `first`.
`block_and_time` runs a function and waits for the card before it stops
the clock.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

_OFF = contextlib.nullcontext()


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


def annotate(name: str, args: str | None = None):
    """A span `name` (with the string `args` beside it) over the enclosed
    region while the profiler records; otherwise one shared no-op
    context, which allocates and registers nothing."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name, args)


def annotate_backward(t: torch.Tensor, name: str) -> torch.Tensor:
    """Return `t`; while the profiler records, the backward of the node
    that made `t` runs inside a span `name`. A pre-hook enters the span
    and a post-hook leaves it, both on the thread that runs the node
    (autograd's own for a card), so the span's device extent holds that
    node's kernels."""
    return annotate_backward_region(t, t, name)


def annotate_backward_region(first: torch.Tensor, last: torch.Tensor,
                             name: str) -> torch.Tensor:
    """Return `last`; while the profiler records, the backward pass from
    the node that made `last` down to the node that made `first` runs
    inside a span `name`: a pre-hook of the one enters it and a post-hook
    of the other leaves it. The nodes made between them in the forward
    pass run between them in the backward pass (the engine runs the later
    made first), so the span holds the region's kernels."""
    start, end = last.grad_fn, first.grad_fn
    if start is None or end is None \
            or not torch._C._autograd._profiler_enabled():
        return last
    entered = []

    def enter(grad_outputs):
        entered.append(torch.ops.profiler._record_function_enter_new(
            name, None))

    def leave(grad_inputs, grad_outputs):
        if entered:
            torch.ops.profiler._record_function_exit._RecordFunction(
                entered.pop())

    start.register_prehook(enter)
    end.register_hook(leave)
    return last


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
