"""Kernel A3's bf16 schedule over the tile plan (lidiff_tpu_torch/ops/
sparse_conv.py `dw_schedule`), emulated in tensor code: the blocks in
launch order, each the chunk of one tap's active tiles it covers (plan
order, taps skipped by `tile_taps`), a per-chunk float32 partial, then the
partials of each tap summed in chunk order, as the kernel's second pass
does. Held to the plain version `conv3_columns_dw_plain` within 1e-5 of
max|ref| (float32, sums in another order) at levels 0-3 of a small
pyramid, G 1 and 2; a plan whose tile drops a tap bit changes dW."""

import numpy as np
import pytest
import torch

from lidiff_tpu_torch.ops import grid, sparse_conv

TOL = 1e-5   # x max|ref|: float32 sums over rows in another order


@pytest.fixture(scope="module")
def pyr():
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.normal(0, 2.0, (2, 700, 3)).astype(np.float32))
    return grid.build_pyramid(pts, 0.2, [2048, 1024, 512, 256], 4)


def _inputs(level, C, Co, G, seed):
    g, km = level.geom, level.kmap3
    gen = torch.Generator().manual_seed(seed)
    f = torch.randn(g.capacity, G * C, generator=gen) * g.mask[:, None]
    # the cotangent's masked rows are not zero: the kernel must mask them
    cot = torch.randn(g.capacity, G * Co, generator=gen)
    return f, cot, km.col_idx, km.hit, g.mask


def emulate(feats, g, col_idx, hit, out_mask, G, plan, n_cblocks=1):
    """dW the way kernel A3's bf16 blocks and second pass compute it."""
    sched = sparse_conv.dw_schedule(plan, n_cblocks)
    V = feats.shape[0]
    C, Co = feats.shape[1] // G, g.shape[1] // G
    f = feats.float().reshape(V, G, C)
    gm = torch.where(out_mask[:, None], g.float(), 0.0).reshape(V, G, Co)
    order = plan.order.long()
    partial = torch.zeros(sched.tap.shape[0], C, Co)
    for i in sched.launch.tolist():
        k, lo, n = (int(t[i]) for t in (sched.tap, sched.lo, sched.len))
        col, z = divmod(k, 3)
        for tile in sched.act[k, lo:lo + n].tolist():
            assert (int(plan.tile_taps[tile]) >> k) & 1
            rows = order[tile * grid.TILE_ROWS:(tile + 1) * grid.TILE_ROWS]
            h = hit[rows, 3 * col:3 * col + 3].long()
            p = col_idx[rows, col].long() + (z > 0) * h[:, 0] \
                + (z > 1) * h[:, 1]
            ok = h[:, z].bool() & out_mask[rows]
            a = f[p.clamp(max=V - 1)] * ok[:, None, None]   # [64, G, C]
            for gi in range(G):
                partial[i] += a[:, gi].T @ gm[rows, gi]
    dw = torch.zeros(27, C, Co)
    first = sched.tap_first.tolist()
    for k in range(27):
        for i in range(first[k], first[k + 1]):
            dw[k] += partial[i]
    return dw


@pytest.mark.parametrize("li", [0, 1, 2, 3])
@pytest.mark.parametrize("G", [1, 2])
def test_schedule_matches_plain(pyr, li, G):
    lvl = pyr.levels[li]
    C, Co = (5, 3) if li % 2 else (16, 24)
    f, cot, col_idx, hit, mask = _inputs(lvl, C, Co, G, 10 * li + G)
    plan = lvl.kmap3.plan()
    ref = sparse_conv.conv3_columns_dw_plain(f, cot, col_idx, hit, mask, G)
    got = emulate(f, cot, col_idx, hit, mask, G, plan)
    scale = float(ref.abs().max())
    assert scale > 0
    assert float((got - ref).abs().max()) <= TOL * scale


def test_schedule_covers_every_active_tile_once(pyr):
    plan = pyr.levels[0].kmap3.plan()
    for n_cblocks in (1, 3):
        sched = sparse_conv.dw_schedule(plan, n_cblocks)
        assert sparse_conv.dw_schedule(plan, n_cblocks) is sched   # kept
        taps = plan.tile_taps.tolist()
        first = sched.tap_first.tolist()
        for k in range(27):
            want = [t for t, m in enumerate(taps) if (m >> k) & 1]
            got = []
            for i in range(first[k], first[k + 1]):
                assert int(sched.tap[i]) == k
                assert 0 < int(sched.len[i]) <= sched.tiles
                lo, n = int(sched.lo[i]), int(sched.len[i])
                got += sched.act[k, lo:lo + n].tolist()
            assert got == want
        # launch: every chunk once, ordered by its first tile
        launch = sched.launch.long()
        assert sorted(launch.tolist()) == list(range(first[27]))
        start = sched.act[sched.tap.long(), sched.lo.long()][launch]
        assert bool((start.diff() >= 0).all())


def test_a_dropped_tap_bit_changes_dw(pyr):
    """A tile whose tap mask loses a tap some of its rows hit drops their
    products from dW: the emulation follows the plan, so a wrong plan
    shows."""
    lvl = pyr.levels[1]
    f, cot, col_idx, hit, mask = _inputs(lvl, 8, 8, 1, 7)
    plan = lvl.kmap3.plan()
    ref = sparse_conv.conv3_columns_dw_plain(f, cot, col_idx, hit, mask, 1)
    # the highest tap but the centre of the tile with the most taps
    counts = [bin(m).count("1") for m in plan.tile_taps.tolist()]
    t = counts.index(max(counts))
    k = (int(plan.tile_taps[t]) & ~(1 << 13)).bit_length() - 1
    assert k >= 0
    cut = plan.tile_taps.clone()
    cut[t] &= ~(1 << k)
    bad = grid.TilePlan(order=plan.order, tile_taps=cut)
    got = emulate(f, cot, col_idx, hit, mask, 1, bad)
    err = float((got - ref).abs().max())
    assert err > 100 * TOL * float(ref.abs().max())
    # only tap k moved
    others = [j for j in range(27) if j != k]
    assert float((got[others] - ref[others]).abs().max()) <= \
        TOL * float(ref.abs().max())
