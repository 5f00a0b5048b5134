"""The tile plan of the column conv's bf16 kernel (lidiff_tpu_torch/ops/
grid.py `tile_plan`), on the CPU, on small synthetic LiDAR rings.

The kernel computes, for each 64-row tile of the plan, only the taps in
that tile's `tile_taps`; a tap that some row hits and the mask lacks would
be a silently dropped product. These tests hold the plan's invariants and
a float32 emulation of the kernel's schedule (active taps only, rows in
plan order, written back through `order`) against the plain conv, within
1e-6 of max|ref|: the same float32 products summed in another order."""

import numpy as np
import pytest
import torch

from lidiff_tpu_torch.ops import grid, sparse_conv

EMU_TOL = 1e-6


def ring_points(n, seed, noise):
    """LiDAR-like rings (64 elevations, 3.5-50 m), plus N(0, noise)."""
    rng = np.random.default_rng(seed)
    az = rng.uniform(0, 2 * np.pi, n)
    el = rng.choice(np.linspace(-0.4, 0.05, 64), n)
    r = rng.uniform(3.5, 50.0, n)
    p = np.stack([r * np.cos(az) * np.cos(el), r * np.sin(az) * np.cos(el),
                  r * np.sin(el)], -1)
    p = p + rng.normal(0, noise, p.shape)
    return torch.from_numpy(p.astype(np.float32))[None]


@pytest.fixture(scope="module", params=[(0, 1.0), (1, 0.01)],
                ids=["noisy", "clean"])
def pyramid(request):
    seed, noise = request.param
    # capacities above the voxel count: padding rows exist at every level
    return grid.build_pyramid(ring_points(1500, seed, noise), 0.5,
                              [2048, 2048], 2)


def _row_taps(hit):
    return [set(np.flatnonzero(h)) for h in hit.numpy()]


@pytest.mark.parametrize("level", [0, 1])
def test_order_is_a_stable_permutation_with_empty_rows_last(pyramid, level):
    km, g = pyramid.levels[level].kmap3, pyramid.levels[level].geom
    V = g.capacity
    plan = grid.tile_plan(km.hit, g.mask)
    order = plan.order.long()
    assert plan.order.dtype == torch.int32 and order.shape == (V,)
    assert torch.equal(torch.sort(order).values, torch.arange(V))
    pattern = grid.hit_patterns(km.hit, g.mask)[order]
    n_empty = int((pattern == 0).sum())
    assert 0 < n_empty < V                       # both kinds exist here
    assert bool((pattern[V - n_empty:] == 0).all())
    assert bool((pattern[:V - n_empty] != 0).all())
    # sorted by pattern; stable: key order within one pattern
    head = pattern[:V - n_empty]
    assert bool((head[1:] >= head[:-1]).all())
    same = head[1:] == head[:-1]
    assert bool((order[1:V - n_empty][same] > order[:V - n_empty - 1][same])
                .all())


@pytest.mark.parametrize("level", [0, 1])
def test_tile_taps_cover_every_hit_tap(pyramid, level):
    km, g = pyramid.levels[level].kmap3, pyramid.levels[level].geom
    plan = grid.tile_plan(km.hit, g.mask)
    V = g.capacity
    T = -(-V // grid.TILE_ROWS)
    assert plan.tile_taps.shape == (T,)
    taps = _row_taps(km.hit[plan.order.long()])
    for t in range(T):
        want = set().union(*taps[t * 64:(t + 1) * 64])
        got = {k for k in range(27) if (int(plan.tile_taps[t]) >> k) & 1}
        assert got == want, t                    # covers, and no more


@pytest.mark.parametrize("level", [0, 1])
def test_plan_is_deterministic_and_cached(pyramid, level):
    km, g = pyramid.levels[level].kmap3, pyramid.levels[level].geom
    a, b = grid.tile_plan(km.hit, g.mask), grid.tile_plan(km.hit.clone())
    assert torch.equal(a.order, b.order)
    assert torch.equal(a.tile_taps, b.tile_taps)
    km2 = grid.ColumnKernelMap(km.col_idx, km.hit, km.nvalid,
                                grid.plan_keys(km.hit))
    assert km2.plan() is km2.plan()
    assert torch.equal(km2.plan().order, a.order)


@pytest.mark.parametrize("level", [0, 1])
def test_plan_computes_fewer_products_than_key_order(pyramid, level):
    """Computed tap products over hit taps, the redundancy chip_smoke.py
    prints: the plan's tiles hit at most as many taps as the key-order
    tiles do here, and every hit tap is computed."""
    km, g = pyramid.levels[level].kmap3, pyramid.levels[level].geom
    plan = grid.tile_plan(km.hit, g.mask)
    hits = int(km.hit.sum())

    def computed(taps):
        return 64 * sum(bin(int(t)).count("1") for t in taps)

    pattern = grid.hit_patterns(km.hit, g.mask)
    V = pattern.shape[0]
    pad = torch.zeros(-(-V // 64) * 64, dtype=torch.int32)
    pad[:V] = pattern
    key_order = [int(np.bitwise_or.reduce(t)) for t in pad.view(-1, 64)
                 .numpy()]
    assert key_order == grid.tile_taps(pattern).tolist()
    assert hits <= computed(plan.tile_taps) <= computed(key_order)


def emulate(feats, col_idx, hit, weights, out_mask, G, plan, bias=None,
            relu=False):
    """The bf16 kernel's schedule in float32: per tile of the plan, only
    its active taps, each a [rows, C] x [C, Co] product of the gathered
    rows, zero where a row misses the tap; the epilogue; rows written
    back through `order`."""
    V = feats.shape[0]
    _, C, Co = weights.shape
    f = feats.float().reshape(V, G, C)
    w = weights.float()
    out = torch.full((V, G, Co), float("nan"))
    order = plan.order.long()
    for t, taps in enumerate(plan.tile_taps.tolist()):
        rows = order[t * 64:(t + 1) * 64]
        h = hit[rows]
        acc = torch.zeros(len(rows), G, Co)
        for k in range(27):
            if not (taps >> k) & 1:
                continue
            col, z = divmod(k, 3)
            p = col_idx[rows, col].long()
            if z > 0:
                p = p + h[:, 3 * col].long()
            if z > 1:
                p = p + h[:, 3 * col + 1].long()
            src = f[p.clamp(max=V - 1)] * h[:, k, None, None]
            acc += torch.einsum("rgc,cn->rgn", src, w[k])
        if bias is not None:
            acc = acc + bias.float()
        if relu:
            acc = acc.clamp(min=0)
        out[rows] = torch.where(out_mask[rows, None, None], acc, 0.0)
    return out.reshape(V, G * Co)


def _conv_inputs(g, G, cin, cout, seed):
    rng = np.random.default_rng(seed)
    V = g.capacity
    f = rng.normal(0, 1, (V, G * cin)).astype(np.float32)
    f = f * g.mask.numpy()[:, None]
    w = rng.normal(0, 0.3, (27, cin, cout)).astype(np.float32)
    b = rng.normal(0, 0.5, (cout,)).astype(np.float32)
    return torch.from_numpy(f), torch.from_numpy(w), torch.from_numpy(b)


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("G,cin,cout", [(1, 3, 8), (2, 5, 24), (2, 16, 8)])
@pytest.mark.parametrize("epilogue", [False, True])
def test_emulated_schedule_equals_plain_conv(pyramid, level, G, cin, cout,
                                             epilogue):
    km, g = pyramid.levels[level].kmap3, pyramid.levels[level].geom
    f, w, b = _conv_inputs(g, G, cin, cout, 10 * level + cin)
    kw = dict(bias=b, relu=True) if epilogue else {}
    args = (f, km.col_idx, km.hit, w, g.mask, G)
    ref = sparse_conv.conv3_columns_plain(*args, **kw)
    got = emulate(*args, km.plan(), **kw)
    assert bool(torch.isfinite(got).all())        # every row written once
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= EMU_TOL * scale


def test_a_missing_tap_drops_a_product(pyramid):
    """The invariant's teeth: drop one hit tap from one tile's mask and the
    emulation no longer equals the plain conv."""
    km, g = pyramid.levels[1].kmap3, pyramid.levels[1].geom
    f, w, _ = _conv_inputs(g, 1, 8, 8, 3)
    plan = grid.tile_plan(km.hit, g.mask)
    t = 0
    tap = (int(plan.tile_taps[t]) & -int(plan.tile_taps[t])).bit_length() - 1
    taps = plan.tile_taps.clone()
    taps[t] &= ~(1 << tap)
    cut = grid.TilePlan(order=plan.order, tile_taps=taps)
    args = (f, km.col_idx, km.hit, w, g.mask, 1)
    ref = sparse_conv.conv3_columns_plain(*args)
    assert float((emulate(*args, cut) - ref).abs().max()) > 1e-3


def test_wrapper_plan_arguments_and_padding():
    """What the CUDA wrapper does around the kernel, on the CPU: the
    channel padding and the K-major weights keep every value in place, and
    a plan of another map is refused."""
    f = torch.arange(2 * 2 * 3, dtype=torch.float32).reshape(2, 6)
    fp = sparse_conv._padded(f, 2, 8)
    assert fp.shape == (2, 16)
    assert torch.equal(fp.reshape(2, 2, 8)[:, :, :3], f.reshape(2, 2, 3))
    assert not bool(fp.reshape(2, 2, 8)[:, :, 3:].any())
    assert sparse_conv._padded(fp, 2, 8) is fp
    w = torch.randn(27, 5, 24)
    wt = sparse_conv._k_major(w, 16)
    assert wt.shape == (27, 24, 16) and wt.is_contiguous()
    assert torch.equal(wt[:, :, :5], w.transpose(1, 2))
    assert not bool(wt[:, :, 5:].any())
    hit = torch.zeros(70, 27, dtype=torch.bool)
    mask = torch.ones(70, dtype=torch.bool)
    order, taps = sparse_conv._plan_args(None, hit, mask)
    assert order.shape == (70,) and taps.shape == (2,)
    with pytest.raises(ValueError):
        sparse_conv._plan_args(grid.tile_plan(hit[:64]), hit, mask)


@pytest.mark.parametrize("level", [0, 1])
def test_plan_key_is_the_hit_pattern(pyramid, level):
    """Kernel B1's plan key (here its plain version, which the pyramid's
    map carries) is the hit pattern, 1 << 27 where no tap hits, and the
    plan sorted from it (`ColumnKernelMap.plan`) equals the plan that
    tensor ops build from the hits: `order` and `tile_taps` both."""
    lvl = pyramid.levels[level]
    km, g = lvl.kmap3, lvl.geom
    pattern = grid.hit_patterns(km.hit, g.mask)
    assert torch.equal(km.plan_key, torch.where(pattern == 0, 1 << 27,
                                                pattern))
    _, _, key = grid.kmap3_columns_plain(g.key, g.coords, g.mask, g.stride)
    assert torch.equal(key, km.plan_key)
    order = torch.sort(torch.where(pattern == 0, 1 << 27, pattern),
                       stable=True).indices
    plan = km.plan()
    assert torch.equal(plan.order, order.to(torch.int32))
    assert torch.equal(plan.tile_taps, grid.tile_taps(pattern[order]))
