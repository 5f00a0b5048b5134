"""The readers of the program's spans (`benchmark/metrics/*`, source
`program_span`) on hand-built traces: the numbers each reads from a trace
that holds the port's `lidiff.*` spans, and nothing (None) from one that
holds only the benchmark's own, as a checkout without the spans records."""

import os

import pytest

from benchmark import harness, spans
from benchmark import trace as tr

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _metric(name):
    return harness.load_module(os.path.join(HERE, "metrics", name + ".py"),
                               "benchmark_metric_" + name.replace(".", "_"))


def _k(name, s, e, cat="other"):
    return tr.Kernel(name, s, e, cat)


def _sample_trace():
    """Two solver steps on the device at 100-160 and 200-250 us, each
    crediting its kernels to the innermost span as the profiler does: the
    step's own input add and noise draw, the denoiser pass around a
    pyramid build (and, in step 2, a tile plan), the solver update; an
    encoder pyramid before them and the refiner's after them."""
    kernels = [_k("enc_sort", 10, 20, "sort"),             # encoder pyramid
               _k("add", 100, 101), _k("fill", 101, 102),
               _k("q", 102, 104, "sort"), _k("kmap3", 104, 106, "B1"),
               _k("conv", 110, 150, "A1"), _k("randn", 151, 152),
               _k("upd", 152, 160),
               _k("add", 200, 201), _k("fill", 201, 202),
               _k("q", 202, 205, "sort"), _k("plan", 220, 221, "sort"),
               _k("conv", 222, 245, "A1"), _k("randn", 245, 246),
               _k("upd", 246, 250),
               _k("ref_sort", 300, 305, "sort")]            # refiner
    spans = {"lidiff.sample.step": [(100, 152), (200, 246)],
             "lidiff.sample.denoise": [(101, 150), (201, 245)],
             "lidiff.sample.solver": [(152, 160), (246, 250)],
             "lidiff.geom.pyramid": [(10, 20), (102, 106), (202, 205),
                                     (220, 221), (300, 305)]}
    host_spans = [("bench.window", 0, 400),
                  ("lidiff.geom.pyramid", 5, 8),
                  ("lidiff.sample.step", 90, 140),
                  ("lidiff.sample.denoise", 92, 130),
                  ("lidiff.geom.pyramid", 93, 100),
                  ("lidiff.sample.solver", 135, 139),
                  ("lidiff.sample.step", 180, 230),
                  ("lidiff.sample.denoise", 182, 225),
                  ("lidiff.geom.pyramid", 183, 190),
                  ("lidiff.geom.pyramid", 195, 196),
                  ("lidiff.sample.solver", 228, 229),
                  ("lidiff.geom.pyramid", 260, 270)]
    host_ops = [("cudaLaunchKernel", 95, 96),
                ("cudaStreamSynchronize", 120, 150),   # in step 1
                ("cudaMemcpyAsync", 185, 186),
                ("cudaMemcpy", 190, 200),              # in step 2
                ("cudaStreamSynchronize", 300, 320)]   # after the steps
    return tr.Trace(kernels=kernels, spans=spans, host_spans=host_spans,
                    wall_s=400e-6, t0=0, host_ops=host_ops)


def _train_trace():
    """Two training steps' kernels: a chamfer, a recompute, two gather
    backward nodes of each kind, and kernels outside every span."""
    kernels = [_k("nn_match_tiled", 10, 14, "C2"), _k("sum", 14, 16),
               _k("conv", 20, 60, "A1"),
               _k("recompute_conv", 100, 130, "A1"),
               _k("indexing_backward_kernel", 140, 190, "scatter_gather"),
               _k("indexing_backward_kernel", 200, 220, "scatter_gather"),
               _k("sort", 220, 222, "sort"),
               _k("dw", 230, 260, "A3"),
               _k("nn_match_tiled", 300, 303, "C2"),
               _k("recompute_conv", 310, 330, "A1"),
               _k("indexing_backward_kernel", 340, 380, "scatter_gather")]
    spans = {"lidiff.train.chamfer": [(10, 16), (300, 303)],
             "lidiff.model.recompute": [(100, 130), (310, 330)],
             "lidiff.grad.transpose_gather": [(140, 190), (340, 380)],
             "lidiff.grad.slice_to_points": [(200, 222)],
             "bench.step": [(0, 290)]}
    return tr.Trace(kernels=kernels, spans=spans,
                    host_spans=[("bench.step", 0, 100)], wall_s=400e-6,
                    t0=0)


def _bench_only(trace):
    """The same trace as a checkout without the program's spans records
    it: the benchmark's own annotations alone."""
    return tr.Trace(
        kernels=trace.kernels,
        spans={n: v for n, v in trace.spans.items()
               if n.startswith("bench.")},
        host_spans=[h for h in trace.host_spans
                    if h[0].startswith("bench.")],
        wall_s=trace.wall_s, t0=trace.t0, host_ops=trace.host_ops)


# (metric, trace, steps, value): ms are us * 1e-3 over the steps
CASES = [
    # the pyramids' kernels in the loop: 2 + 2, 3, 1 us
    ("pyramid_ms.sample", _sample_trace, 2, 8e-3 / 2),
    # the loop from 100 to 250 us (the last update included, though the
    # step's own extent ends at its noise draw): 150 us less 6 + 40 + 9
    # + 5 + 1 + 28 busy
    ("step_idle_ms.sample", _sample_trace, 2, (150 - 89) * 1e-3 / 2),
    # one stream synchronise and one blocking copy inside the host steps
    ("step_syncs.sample", _sample_trace, 2, 2 / 2),
    # 50 + 40 us in the transpose gathers, 20 + 2 in slice_to_points
    ("gather_bwd_ms.train", _train_trace, 2, 112e-3 / 2),
    ("recompute_ms.train", _train_trace, 2, 50e-3 / 2),
    ("chamfer_ms.train", _train_trace, 2, 9e-3 / 2),
]


@pytest.mark.parametrize("name,make,steps,value", CASES,
                         ids=[c[0] for c in CASES])
def test_reader_reads_the_program_spans(name, make, steps, value):
    got = _metric(name).read({"trace": make(), "steps": steps})
    assert got == pytest.approx(value, rel=1e-12)


@pytest.mark.parametrize("name,make", [c[:2] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_reader_finds_nothing_without_the_spans(name, make):
    assert _metric(name).read({"trace": _bench_only(make()),
                               "steps": 2}) is None


def test_window_takes_the_spans_nested_in_the_steps():
    assert spans.window(_sample_trace(), "lidiff.sample.step") == (100, 250)
    assert spans.window(_train_trace(), "lidiff.sample.step") is None


def test_syncs_read_zero_where_steps_wait_for_nothing():
    t = _sample_trace()
    t.host_ops = [op for op in t.host_ops if op[1] >= 300]
    assert _metric("step_syncs.sample").read({"trace": t, "steps": 2}) == 0


def test_every_program_span_metric_is_declared():
    bench = harness.spec()
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name, *_ in CASES:
        m = declared[name]
        assert m["source"] == "program_span" and m["better"] == "lower"
        assert len(m["workloads"]) == 1
