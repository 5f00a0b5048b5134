"""The work counts against brute force at a tiny size, and the trace's
arithmetic on a made-up trace."""

import itertools

import torch

from benchmark import trace as tr
from benchmark import work


def _brute(points, res, levels=5):
    """Voxels and hit taps per level by Python sets."""
    pts = points.reshape(-1, 3).tolist()
    B, N = points.shape[:2]
    cells = {(i // N, *(int(round(c / res)) for c in p))
             for i, p in enumerate(pts)}
    # torch.round is half to even, as Python's round
    vox, hits = [], []
    s = 1
    for _ in range(levels):
        vox.append(len(cells))
        hits.append(sum((b, x + dx * s, y + dy * s, z + dz * s) in cells
                        for (b, x, y, z) in cells
                        for dx, dy, dz in itertools.product((-1, 0, 1),
                                                            repeat=3)))
        cells = {(b, x // (2 * s) * 2 * s, y // (2 * s) * 2 * s,
                  z // (2 * s) * 2 * s) for (b, x, y, z) in cells}
        s *= 2
    return vox, hits


def test_occupancy_matches_brute_force():
    g = torch.Generator().manual_seed(0)
    pts = torch.rand(2, 400, 3, generator=g) * 1.5
    occ = work.occupancy(pts, 0.05)
    vox, hits = _brute(pts, 0.05)
    assert occ.voxels == vox and occ.hits == hits
    assert occ.items == 2 and occ.points == 800


def test_flops_of_one_conv_and_its_bound():
    occ = work.Occupancy(voxels=[10, 5, 3, 2, 1], hits=[40, 20, 9, 4, 1],
                         items=1, points=12)
    op = work.Op("conv27", 64, 128, 1, 2)
    assert work.flops(op, occ) == 2.0 * 64 * 128 * 2 * 20
    b = work.conv_bound_s(op, occ)
    nbytes = 5 * 2 * (64 + 128) * 2 + 27 * 64 * 128 * 2 + 128 * 4
    assert b == max(work.flops(op, occ) / work.PEAK_BF16,
                    nbytes / work.PEAK_BYTES)
    assert work.flops(work.Op("head", 96, 20, 0, 2), occ) \
        == 2.0 * 96 * 20 * 2 * 12


def test_denoiser_plan_has_the_models_convs():
    ops = work.denoiser_ops()
    convs = [o for o in ops if o.kind == "conv27"]
    assert len(convs) == 34
    assert (convs[0].cin, convs[0].cout, convs[0].groups) == (3, 32, 1)
    assert sum(o.kind == "down" for o in ops) == 4
    assert any((o.cin, o.cout, o.level) == (384, 256, 3) for o in convs)
    assert len([o for o in work.refiner_ops() if o.kind == "conv27"]) == 34


def test_trace_busy_union_and_spans():
    k = [tr.Kernel("a", 0, 10, "A1"), tr.Kernel("b", 5, 12, "other"),
         tr.Kernel("c", 20, 30, "copy"), tr.Kernel("d", 40, 41, "A1")]
    t = tr.Trace(kernels=k, spans={"bench.denoise": [(0, 12), (39, 42)]},
                 host_spans=[("bench.window", 0, 50)], wall_s=50e-6, t0=0)
    assert abs(t.busy_s() - 23e-6) < 1e-12
    assert [x.name for x in t.inside("bench.denoise")] == ["a", "b", "d"]
    assert abs(t.extent_s("bench.denoise") - 42e-6) < 1e-12
    assert t.idle_gaps(2)[0][0].startswith("bench.window")
    assert tr.guard(t, {"A1": 2, "C1": 1}) == [("C1", 0, 1)]
    assert tr.category("void conv3_columns_dw_kernel<bf16>") == "A3"
    assert tr.category("conv3_columns_wgmma_kernel<signed char, x>") == "A4"
