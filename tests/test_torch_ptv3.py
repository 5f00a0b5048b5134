"""Point Transformer V3's pieces against the plain reference
(`benchmark/reference/ptv3.py`) on the CPU at a tiny size: the four
serialization codes and their hierarchy, the patch maps, a level's
orders, the pyramid's pooling, one block, the pooling and the unpooling.

Tolerances: orders, codes and maps are compared exactly. The float32
pieces agree to 1e-5 relative to the largest output: the port's column
conv sums its 27 taps by column and its BatchNorm variance as E[x^2] -
E[x]^2, the reference by tap and as E[(x - mean)^2], which round
differently, and nothing else differs."""

import pytest
import torch

from benchmark.reference import nets
from benchmark.reference import ptv3 as R
from lidiff_tpu_torch.models import ptv3 as P
from lidiff_tpu_torch.ops import grid as G
from lidiff_tpu_torch.ops import serialize as SZ
from tests.ptv3_helpers import (PATCH, batch, one_thread,  # noqa: F401
                                small_patch, task, weights)


def _coords(n=500, depth=7, seed=0):
    g = torch.Generator().manual_seed(seed)
    grid = torch.randint(0, 1 << depth, (n, 3), generator=g)
    el = torch.randint(0, 3, (n,), generator=g)
    return grid, el


@pytest.mark.parametrize("order", SZ.ORDERS)
def test_codes_match_the_reference(order):
    grid, el = _coords()
    lvl = R.Level(grid=grid, element=el, key=R._key(el, grid))
    assert torch.equal(SZ.encode(grid, el, 7, order), R.code(lvl, 7, order))


def test_level_codes_of_a_levels_rows():
    """`level_codes` takes a level's rows (element, x, y, z) and the
    shift to its grid coordinates: the four orders' codes, in ORDERS."""
    grid, el = _coords(seed=3)
    shift = (2, 0, 1)
    coords = torch.cat([el[:, None], grid - torch.tensor(shift)], 1).int()
    got = SZ.level_codes(coords, shift, 7)
    assert got.shape == (4, grid.shape[0])
    for k, order in enumerate(SZ.ORDERS):
        assert torch.equal(got[k], SZ.encode(grid, el, 7, order))


@pytest.mark.parametrize("order", SZ.ORDERS)
def test_codes_are_hierarchical(order):
    """code >> 3 at depth d is the parent's code at depth d - 1: PTv3's
    pooling by code >> 3 is the pyramid's by coordinate >> 1."""
    grid, el = _coords(depth=9, seed=1)
    fine = SZ.encode(grid, el, 9, order)
    assert torch.equal(fine >> 3, SZ.encode(grid >> 1, el, 8, order))
    # and the codes are a bijection of the (element, coordinate) pairs
    assert torch.unique(fine).numel() == torch.unique(
        R._key(el, grid)).numel()


@pytest.mark.parametrize("counts,cap", [([130, 64, 200], 64),
                                        ([64, 128], 64),
                                        ([1500, 2100], 1024),
                                        ([70, 90], 1024)],
                         ids=["short-last", "whole", "published", "below"])
def test_pad_maps_match_the_reference(monkeypatch, counts, cap):
    """A short last patch reads the rows K before; K is min(cap, smallest
    element), so below 1024 when an element is smaller."""
    monkeypatch.setattr(SZ, "MAX_PATCH", cap)
    monkeypatch.setattr(R, "MAX_PATCH", cap)
    lc = SZ.LevelCounts(counts=counts, depth=4,
                        dev=torch.tensor(counts, dtype=torch.int64))
    maps = SZ.pad_maps(lc)
    pad, unpad, K = R.pad_maps(counts, "cpu")
    assert maps.patch == K == min(cap, min(counts))
    assert torch.equal(maps.pad, pad) and torch.equal(maps.unpad, unpad)
    assert maps.rows % K == 0
    # every row is read back from its own padded row
    assert torch.equal(maps.pad[maps.unpad], torch.arange(sum(counts)))
    # filler rows repeat rows of the element's previous patch
    start = start_pad = 0
    for c in counts:
        cp = -(-c // K) * K
        fill = maps.pad[start_pad + c:start_pad + cp]
        assert torch.equal(fill, torch.arange(start_pad + c - K,
                                              start_pad + cp - K)
                           - start_pad + start)
        start += c
        start_pad += cp


def _pyramids(b):
    t = task()
    pyr = t.pyramid(b)
    lcs = t.counts(pyr, b["offset"].shape[0])
    ref = R.pyramid(b["grid_coord"], b["offset"], b["feat"])
    return t, pyr, lcs, ref


def test_pyramid_matches_the_reference_levels(small_patch):  # noqa: F811
    """Rows, counts, depth and parents of every level; one sync."""
    b = batch(mix_prob=1.0)
    syncs = SZ.counters["syncs"]
    t, pyr, lcs, ref = _pyramids(b)
    assert SZ.counters["syncs"] == syncs + 1
    for li, (l, rl) in enumerate(zip(pyr.levels, ref.levels)):
        n = lcs[li].total
        assert n == rl.size and lcs[li].counts == ref.counts[li]
        assert lcs[li].depth == ref.depth - li
        g = (l.geom.coords[:n, 1:] + G.grid_shift("cpu")).long() >> li
        assert torch.equal(g, rl.grid)
        if rl.parent is not None:
            assert torch.equal(l.parent_idx[:n].long(), rl.parent)
    assert int(pyr.overflows().sum()) == 0


def test_level_orders_match_the_reference(small_patch):  # noqa: F811
    b = batch()
    t, pyr, lcs, ref = _pyramids(b)
    perms = [torch.randperm(4, generator=torch.Generator().manual_seed(i))
             for i in range(5)]
    levels, _ = t.levels(pyr, lcs, perms)
    for lvl, rs in zip(levels, R.serialize(ref, perms)):
        assert lvl.orders.maps.patch == rs.K <= PATCH
        assert torch.equal(lvl.orders.maps.pad, rs.pad)
        for slot in range(4):
            assert torch.equal(lvl.orders.gather[slot], rs.gather[slot])
            assert torch.equal(lvl.orders.scatter[slot], rs.scatter[slot])


def _close(a, b, tol=1e-5):
    assert (a - b).abs().max() <= tol * b.abs().max(), \
        float((a - b).abs().max() / b.abs().max())


def test_block_matches_the_reference(small_patch):  # noqa: F811
    """One block of level 1, forward and every gradient, DropPath on."""
    b = batch()
    t, pyr, lcs, ref = _pyramids(b)
    W = weights()
    levels, _ = t.levels(pyr, lcs)
    serials = R.serialize(ref, [torch.arange(4)] * 5)
    n = lcs[1].total
    x = torch.randn(n, 16, generator=torch.Generator().manual_seed(2))
    masks = ((torch.rand(n) < 0.8).float() / 0.8,
             (torch.rand(n) < 0.8).float() / 0.8)
    blk = t.model.enc["enc1"]["block1"]
    xp = x.clone().requires_grad_(True)
    out = blk(xp, levels[1], masks)
    xr = x.clone().requires_grad_(True)
    W = {k: v.requires_grad_(True) for k, v in W.items()}
    ref_out = R.block(xr, W, "enc.enc1.block1", ref.levels[1].neighbours(1),
                      serials[1], 1, masks)
    _close(out, ref_out)
    gy = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    out.backward(gy)
    ref_out.backward(gy)
    _close(xp.grad, xr.grad)
    for name, p in blk.named_parameters():
        _close(p.grad, W["enc.enc1.block1." + name].grad, 1e-4)


def test_pooling_and_unpooling_match_the_reference(small_patch):  # noqa: F811
    b = batch()
    t, pyr, lcs, ref = _pyramids(b)
    W = weights()
    t.model.train()
    n0, n1 = lcs[0].total, lcs[1].total
    x = torch.randn(n0, 16, generator=torch.Generator().manual_seed(4))
    parent = pyr.levels[0].parent_idx[:n0].long()
    down = t.model.enc["enc1"]["down"]
    pooled = down(x, parent, n1)
    y = R.linear(x, W, "enc.enc1.down.proj")
    idx = ref.levels[0].parent[:, None].expand(-1, y.shape[1])
    y = y.new_zeros(n1, y.shape[1]).scatter_reduce(0, idx, y, "amax",
                                                   include_self=False)
    _close(pooled, torch.nn.functional.gelu(
        R.batch_norm(y, W, "enc.enc1.down.norm")))
    up = t.model.dec["dec0"]["up"]
    coarse = torch.randn(n1, 16, generator=torch.Generator().manual_seed(5))
    got = up(coarse, x, parent)
    p = "dec.dec0.up"
    c = torch.nn.functional.gelu(R.batch_norm(R.linear(coarse, W,
                                                       p + ".proj"),
                                              W, p + ".proj_norm"))
    k = torch.nn.functional.gelu(R.batch_norm(R.linear(x, W, p + ".skip"),
                                              W, p + ".skip_norm"))
    _close(got, k + c[ref.levels[0].parent])


def test_stem_map_is_the_reference_125_taps(small_patch):  # noqa: F811
    b = batch()
    t, pyr, lcs, ref = _pyramids(b)
    _, stem = t.levels(pyr, lcs)
    nbr = ref.levels[0].neighbours(2)
    assert torch.equal(stem.hit, nbr >= 0)
    assert torch.equal(stem.idx.long()[stem.hit], nbr[nbr >= 0])


def test_reference_lower_precision_moves_attention():
    """The control's float8 products reach the attention too."""
    q, k, v = (torch.randn(2, 1, 8, 16, generator=torch.Generator()
                           .manual_seed(i)) for i in range(3))
    exact = R._PatchAttention.apply(q, k, v, 0.25, 1)
    with nets.lower_precision(torch.float8_e4m3fn):
        low = R._PatchAttention.apply(q, k, v, 0.25, 1)
    assert (exact - low).abs().max() > 1e-3
    ref = torch.softmax(q @ k.transpose(-1, -2) * 0.25, -1) @ v
    assert torch.allclose(exact, ref, atol=1e-6)


def test_drop_path_rates_are_pointcepts():
    enc, dec = P.drop_path_rates(0.3)
    assert enc[0][0] == 0.0 and enc[-1][-1] == pytest.approx(0.3)
    assert dec[0] == pytest.approx([0.3 / 7, 0.0])
    assert dec[-1] == pytest.approx([0.3, 0.3 * 6 / 7])
    got = [(s, r) for s, rs in enumerate(enc) for r in rs] + [
        (s, r) for s in reversed(range(4)) for r in dec[s]]
    want = R.drop_rates(0.3)
    assert [s for s, _ in got] == [s for s, _ in want]
    assert [r for _, r in got] == pytest.approx([r for _, r in want])
