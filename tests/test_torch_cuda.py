"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These skip without a CUDA device; run them on a machine with one:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

They cover what chip_smoke.py's main-path shapes do not: inputs smaller
than one tile, partial tiles past nvalid, tiles of the tile plan with no
active tap, input widths that are not multiples of 8 or 16 (zero-padded by
the wrappers) and K chunks with a tail, output widths that are not
multiples of 8 and Co = 384 (two blocks of 192 across the width), no
bias, no ReLU, and the float32 path. Tolerances as in chip_smoke.py: B1
(col_idx, hit, the plan key, and the plan's taps), C1 and C2 exact (C1
over its grid index also examines the rows its tensor-code search
examines, and C2's tiles stage the rows of their tensor-code search); A1 float32 within 1e-5 of max|ref| (sum order), bf16
within one bf16 ulp plus 1e-4 of max|ref|. The bf16 down and transpose
convs (plain PyTorch on both sides, atomic scatter order on the card)
are held to the bound stated in `sparse_conv_down`: n * 2^-7 * A per
parent of n children, A the sum of |feat| * |weight| over its children
and channels. The transpose conv through its gather kernels
(`TransposeGatherFunction`) is held to the same conv through the plain
gather on the same CUDA tensors bit for bit: output, coarse-feats and
weight gradients.

A3 (the weight gradient) is held to its plain version on the same bf16 or
float32 operands within 1e-4 of max|ref| in float32 and 5e-4 in bf16: both
sum float32 products, the kernel in float32 over blocks with atomics in an
order that changes from run to run, in bf16 over the tile plan's chunks in
a fixed order (two runs agree bit for bit) on the tensor cores, which
truncate where they add to the float32 accumulator.
A4 (the int8 eval conv) is held to its plain version on the same int8
feats and folded weights as A1 is to its own, on widths that are and are
not multiples of 16 (the wrapper pads them for the 16-byte int8 copies).
The differentiable conv (A2) is held to the same backward rule on the CPU:
its feats gradient like A1 (float32 1e-5 of max|ref|; bf16 one bf16 ulp
plus 1e-4 of max|ref|), its weight gradient like A3 plus, in bf16, the one
rounding of dW to the weights' dtype.
F1 (farthest-point sampling) is held to `fps_plain` on the card and to the
host C++ copy index for index, on clouds smaller than a block, larger than
the grid's first cover, with N not a multiple of the block, with
duplicated points, k = 1 and k >= N.
Training-mode masked BatchNorm (`ops/batchnorm.py`, `csrc/masked_bn.cu`) is
held to the eager code on the same tensors in float32 and bf16, at widths
32 to 384, with no, some and all rows valid, for each epilogue (none, ReLU,
residual + ReLU), at the tolerances stated at each test (sum order; in
bf16 the closed-form backward); two calls, and a one-rank NCCL group, give
the same bits; a small refiner step takes the fused path at every
BatchNorm.
GA (the eval gate's apply step, `ops/gate.py`, `csrc/gate_apply.cu`) is
held to `gate_apply_plain` bit for bit in bf16 and float32 at the
sampling path's gate widths, G = 1 and 2, with masked rows whose items and
bank rows are out of range, and at an unaligned address; one small guided
denoise gates through the tables with 8 launches, and matches per-voxel
gates at the tolerances stated in its test."""

import math

import numpy as np
import pytest
import torch

from lidiff_tpu_torch.ops import grid, knn, sparse_conv

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pyramid(dev, n, caps, seed=0, res=0.2):
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.normal(0, 2.0, (2, n, 3)).astype(np.float32))
    return grid.build_pyramid(pts.to(dev), res, caps, len(caps))


@pytest.mark.parametrize("n,caps", [(3, [8, 8]), (700, [2048, 1024, 512])])
def test_kmap3_columns(dev, n, caps):
    pyr = _pyramid(dev, n, caps)
    for lvl in pyr.levels:
        g = lvl.geom
        got = grid.kmap3_columns(g.key, g.coords, g.mask, g.stride)
        want = grid.kmap3_columns_plain(g.key, g.coords, g.mask, g.stride)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        # the plan from B1's key and its taps kernel, as on the CPU
        plan = grid.plan_from_keys(got[2])
        ref = grid.plan_from_keys(want[2].cpu())
        assert torch.equal(plan.order.cpu(), ref.order)
        assert torch.equal(plan.tile_taps.cpu(), ref.tile_taps)


def test_kmap3_columns_at_the_coordinate_limit(dev):
    """B1 where voxels reach +-2047 (queries past it pack to PAD_KEY and
    never hit), two batch items, most rows padding at the coarse levels."""
    pyr = _pyramid(dev, 3000, [8192, 4096, 2048, 1024], res=0.002)
    assert int(pyr.levels[0].geom.coords[:, 1:].abs().max()) > 2000
    for lvl in pyr.levels:
        g = lvl.geom
        got = grid.kmap3_columns(g.key, g.coords, g.mask, g.stride)
        want = grid.kmap3_columns_plain(g.key, g.coords, g.mask, g.stride)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("vq,vr,batched", [(5, 3, True), (3000, 700, True),
                                           (2000, 600, False)])
def test_nn_match(dev, vq, vr, batched):
    rng = np.random.default_rng(vq)
    nb = 2 if batched else 1

    def coords(v):
        return torch.from_numpy(np.concatenate(
            [rng.integers(0, nb, (v, 1)), rng.integers(-40, 40, (v, 3))],
            1).astype(np.int32)).to(dev)

    q, r = coords(vq), coords(vr)
    rm = torch.from_numpy(rng.random(vr) < 0.8).to(dev)
    got = knn.nn_match(q, r, rm, n_batch=0 if batched else 1)
    assert torch.equal(got, knn.nn_match_plain(q, r, rm))


def _c1_case(case, rng):
    """(q, q_mask, r, r_mask, n_batch) as numpy arrays, odd sizes."""
    def cloud(v, items, lo, hi):
        return np.concatenate([rng.integers(0, items, (v, 1)),
                               rng.integers(lo, hi, (v, 3))], 1)
    if case == "odd":
        q, r = cloud(4099, 2, -700, 700), cloud(1031, 2, -700, 700)
        return q, rng.random(4099) < 0.6, r, rng.random(1031) < 0.9, 0
    if case == "ties":      # a doubled lattice: equidistant refs everywhere
        g = np.arange(-20, 21, 4)
        xyz = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
        xyz = np.concatenate([xyz, xyz[::-1]])
        r = np.concatenate([np.zeros((len(xyz), 1), int), xyz], 1)
        return (cloud(2053, 1, -22, 23), np.ones(2053, bool), r,
                np.ones(len(r), bool), 1)
    if case == "far":       # far queries, one of them at the other corner
        r = cloud(517, 2, -80, 80)
        q = cloud(1001, 2, -2047, 2048)
        q[0, 1:] = 2047
        r[0, 1:] = -2047
        return q, np.ones(1001, bool), r, rng.random(517) < 0.9, 0
    if case == "uncond":    # 8 rows, one valid voxel per item: a scan
        r = np.zeros((8, 4), int)
        r[3] = [1, 0, 0, 0]
        rm = np.zeros(8, bool)
        rm[[0, 3]] = True
        return cloud(777, 2, -300, 300), rng.random(777) < 0.6, r, rm, 0
    # an item without a valid ref
    q, r = cloud(999, 2, -100, 100), cloud(301, 2, -100, 100)
    rm = rng.random(301) < 0.9
    rm[r[:, 0] == 0] = False
    return q, rng.random(999) < 0.9, r, rm, 0


@pytest.mark.parametrize("case", ["odd", "ties", "far", "uncond",
                                  "item_without_refs"])
def test_nn_match_grid(dev, case):
    """C1 over its grid index: equal to the plain scan on every query (0
    on invalid ones), and the rows each query examined equal to the
    search's tensor-code version, which follows the same shells and stop
    rule."""
    rng = np.random.default_rng(len(case))
    *arrays, n_batch = _c1_case(case, rng)
    q, qm, r, rm = (torch.from_numpy(np.asarray(a)).to(dev) for a in arrays)
    q, r = q.to(torch.int32).contiguous(), r.to(torch.int32).contiguous()
    index = knn.build_nn_index(r, rm, n_batch)
    assert index.scan == (case == "uncond")
    got, pairs = knn.nn_match(q, r, rm, n_batch, qm, index, pairs=True)
    assert torch.equal(got, knn.nn_match_plain(q, r, rm, qm))
    emu, emu_pairs = knn.nn_grid_plain(q, qm, index)
    assert torch.equal(got, emu) and torch.equal(pairs, emu_pairs)


@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("cin,cout,G", [(3, 8, 1), (5, 24, 2), (16, 72, 2),
                                        (40, 64, 1)])
@pytest.mark.parametrize("epilogue", [False, True])
def test_conv3_columns(dev, dtype, out_dtype, cin, cout, G, epilogue):
    pyr = _pyramid(dev, 300, [1024, 512], seed=cin)
    lvl = pyr.levels[0]
    g, km = lvl.geom, lvl.kmap3
    assert int(km.nvalid) < g.capacity          # tiles past nvalid exist
    gen = torch.Generator(device=dev).manual_seed(cin * cout)
    f = torch.randn(g.capacity, G * cin, generator=gen, device=dev)
    f = (f * g.mask[:, None]).to(dtype)
    w = (torch.randn(27, cin, cout, generator=gen, device=dev)
         / math.sqrt(27 * cin)).to(dtype)
    kw = {}
    if epilogue:
        kw = dict(bias=0.1 * torch.randn(cout, generator=gen, device=dev),
                  relu=True)
    args = (f, km.col_idx, km.hit, w, g.mask, G)
    got = sparse_conv.conv3_columns(*args, out_dtype=out_dtype,
                                    nvalid=km.nvalid, **kw)
    ref = sparse_conv.conv3_columns_plain(*args, out_dtype=out_dtype, **kw)
    assert got.dtype == out_dtype
    got, ref = got.float(), ref.float()
    scale = float(ref.abs().max())
    err = (got - ref).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-5 * scale
    else:
        ulp = 2.0 ** -7 if out_dtype == torch.bfloat16 else 0.0
        assert bool((err <= ulp * ref.abs() + 1e-4 * scale).all())


def test_conv3_columns_rejects_bad_input(dev):
    pyr = _pyramid(dev, 50, [128])
    g, km = pyr.levels[0].geom, pyr.levels[0].kmap3
    f = torch.zeros(g.capacity, 8, device=dev)
    w = torch.zeros(27, 8, 4, device=dev)
    with pytest.raises(ValueError):      # weights of another dtype
        sparse_conv.conv3_columns(f, km.col_idx, km.hit, w.bfloat16(),
                                  g.mask, 1)
    with pytest.raises(ValueError):      # channels do not split into G
        sparse_conv.conv3_columns(f, km.col_idx, km.hit, w, g.mask, 3)
    with pytest.raises(ValueError):      # tensors on two devices
        sparse_conv.conv3_columns(f, km.col_idx.cpu(), km.hit, w, g.mask, 1)


@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("cin,cout,G", [(32, 8, 1), (40, 24, 2), (48, 72, 2),
                                        (64, 64, 1)])
@pytest.mark.parametrize("epilogue", [False, True])
def test_conv3_columns_q(dev, dtype, out_dtype, cin, cout, G, epilogue):
    pyr = _pyramid(dev, 300, [1024, 512], seed=cin)
    lvl = pyr.levels[0]
    g, km = lvl.geom, lvl.kmap3
    assert int(km.nvalid) < g.capacity          # tiles past nvalid exist
    gen = torch.Generator(device=dev).manual_seed(cin * cout)
    f = torch.randn(g.capacity, G * cin, generator=gen, device=dev)
    f = (f * g.mask[:, None]).to(dtype)
    w = (torch.randn(27, cin, cout, generator=gen, device=dev)
         / math.sqrt(27 * cin)).to(dtype)
    bias = 0.1 * torch.randn(cout, generator=gen, device=dev) \
        if epilogue else None
    q, w_q = sparse_conv.quantize_feats(f, w, G)
    args = (q, km.col_idx, km.hit, w_q, g.mask, G, bias, epilogue, out_dtype)
    before = sparse_conv._conv3_q_kernel.launches
    got = sparse_conv._conv3_q_run(*args, km.nvalid)
    assert sparse_conv._conv3_q_kernel.launches == before + 1
    ref = sparse_conv.conv3_columns_q_plain(*args)
    assert got.dtype == out_dtype
    got, ref = got.float(), ref.float()
    scale = float(ref.abs().max())
    err = (got - ref).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-5 * scale
    else:
        ulp = 2.0 ** -7 if out_dtype == torch.bfloat16 else 0.0
        assert bool((err <= ulp * ref.abs() + 1e-4 * scale).all())


def test_conv3_columns_q_rejects_bad_input(dev):
    pyr = _pyramid(dev, 50, [128])
    g, km = pyr.levels[0].geom, pyr.levels[0].kmap3
    q = torch.zeros(g.capacity, 32, dtype=torch.int8, device=dev)
    w = torch.zeros(27, 32, 4, device=dev)
    run = sparse_conv._conv3_q_run
    with pytest.raises(ValueError):      # feats not int8
        run(q.float(), km.col_idx, km.hit, w, g.mask, 1, None, False,
            torch.float32, None)
    with pytest.raises(ValueError):      # channels do not split into G
        run(q, km.col_idx, km.hit, w, g.mask, 3, None, False, torch.float32,
            None)
    with pytest.raises(ValueError):      # tensors on two devices
        run(q, km.col_idx.cpu(), km.hit, w, g.mask, 1, None, False,
            torch.float32, None)


def _check_bf16(got, ref, out_dtype):
    scale = float(ref.abs().max())
    ulp = 2.0 ** -7 if out_dtype == torch.bfloat16 else 0.0
    err = (got.float() - ref.float()).abs()
    assert bool((err <= ulp * ref.float().abs() + 1e-4 * scale).all()), \
        float(err.max())


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ["A1", "A4"])
@pytest.mark.parametrize("cin,cout,G", [(5, 384, 1), (40, 384, 2),
                                        (64, 384, 1), (40, 8, 2),
                                        (136, 96, 1), (72, 3, 2)])
def test_conv3_columns_tile_plan(dev, out_dtype, kernel, cin, cout, G):
    """The bf16 kernel over the map's tile plan: Co = 384 splits into two
    192-wide blocks, C = 5 and 40 are padded and end in a K tail, Co = 3 is
    masked, the plan ends in tiles with no active tap (padding rows), and
    the plan passed by the map equals the one the wrapper builds."""
    pyr = _pyramid(dev, 300, [1024, 512], seed=cin + cout)
    lvl = pyr.levels[0]
    g, km = lvl.geom, lvl.kmap3
    plan = km.plan()
    assert int(km.nvalid) < g.capacity
    assert bool((plan.tile_taps == 0).any())     # tiles with no active tap
    gen = torch.Generator(device=dev).manual_seed(cin * cout + G)
    f = torch.randn(g.capacity, G * cin, generator=gen, device=dev)
    f = (f * g.mask[:, None]).to(torch.bfloat16)
    w = (torch.randn(27, cin, cout, generator=gen, device=dev)
         / math.sqrt(27 * cin)).to(torch.bfloat16)
    bias = 0.1 * torch.randn(cout, generator=gen, device=dev)
    if kernel == "A1":
        args = (f, km.col_idx, km.hit, w, g.mask, G)
        kw = dict(bias=bias, relu=True, out_dtype=out_dtype,
                  nvalid=km.nvalid)
        got = sparse_conv.conv3_columns(*args, plan=plan, **kw)
        again = sparse_conv.conv3_columns(*args, **kw)
        ref = sparse_conv.conv3_columns_plain(*args, bias=bias, relu=True,
                                              out_dtype=out_dtype)
    else:
        q, w_q = sparse_conv.quantize_feats(f, w, G)
        args = (q, km.col_idx, km.hit, w_q, g.mask, G, bias, True, out_dtype)
        got = sparse_conv._conv3_q_run(*args, km.nvalid, plan)
        again = sparse_conv._conv3_q_run(*args, km.nvalid)
        ref = sparse_conv.conv3_columns_q_plain(*args)
    assert got.dtype == out_dtype and got.shape == (g.capacity, G * cout)
    assert torch.equal(got, again)               # no atomics: deterministic
    _check_bf16(got, ref, out_dtype)


@pytest.mark.parametrize("cin,cout,G", [(40, 384, 1), (5, 24, 2),
                                        (384, 64, 1)])
def test_conv3_feats_gradient_runs_over_the_saved_plan(dev, cin, cout, G):
    """A2's feats gradient through `sparse_conv_columns`, whose forward
    saves the map's plan for the backward: equal to the plain conv of the
    masked cotangent with flipped, transposed weights."""
    g, km, f, w, cot = _grad_inputs(dev, torch.bfloat16, cin, cout, G)
    ff = f.clone().requires_grad_(True)
    before = sparse_conv.Conv3ColumnsFunction.launches
    out = sparse_conv.sparse_conv_columns(
        ff, km, w, g.mask, groups=G, compute_dtype=torch.bfloat16)
    assert km._plan is not None                  # built by the forward
    df, = torch.autograd.grad(out, ff, cot.to(out.dtype))
    assert sparse_conv.Conv3ColumnsFunction.launches == before + 1
    cot_m = torch.where(g.mask[:, None], cot, 0.0).to(torch.bfloat16)
    w_rev = w.flip(0).transpose(1, 2).contiguous()
    ref = sparse_conv.conv3_columns_plain(cot_m, km.col_idx, km.hit, w_rev,
                                          g.mask, G)
    assert df.dtype == torch.bfloat16
    _check_bf16(df, ref, torch.bfloat16)


BF16_ULP = 2.0 ** -7


def _grad_inputs(dev, dtype, cin, cout, G, n=300, caps=(1024, 512)):
    """A level with tiles past nvalid, masked feats, a cotangent whose
    masked rows are non-zero."""
    pyr = _pyramid(dev, n, list(caps), seed=cin + cout)
    lvl = pyr.levels[0]
    g, km = lvl.geom, lvl.kmap3
    gen = torch.Generator(device=dev).manual_seed(cin * cout + G)
    f = torch.randn(g.capacity, G * cin, generator=gen, device=dev)
    f = (f * g.mask[:, None]).to(dtype)
    cot = torch.randn(g.capacity, G * cout, generator=gen, device=dev)
    w = (torch.randn(27, cin, cout, generator=gen, device=dev)
         / math.sqrt(27 * cin)).to(dtype)
    return g, km, f, w, cot


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,G,n,caps", [
    (3, 8, 1, 300, (1024, 512)), (5, 24, 2, 300, (1024, 512)),
    (16, 72, 2, 300, (1024, 512)), (40, 64, 1, 300, (1024, 512)),
    (136, 8, 2, 300, (1024, 512)), (72, 130, 1, 300, (1024, 512)),
    (16, 24, 1, 5, (16, 8)), (3, 32, 1, 300, (1024, 512)),
    (384, 256, 1, 300, (1024, 512)), (8, 3, 2, 300, (1024, 512)),
    (24, 384, 1, 300, (1024, 512))])
def test_conv3_columns_dw(dev, dtype, cin, cout, G, n, caps):
    g, km, f, _, cot = _grad_inputs(dev, dtype, cin, cout, G, n, caps)
    assert int(km.nvalid) < g.capacity
    assert bool((cot[~g.mask] != 0).any())     # the kernel must mask these
    args = (f, cot.to(dtype), km.col_idx, km.hit, g.mask, G)
    got = sparse_conv.conv3_columns_dw(*args, nvalid=km.nvalid)
    ref = sparse_conv.conv3_columns_dw_plain(*args)
    assert got.dtype == torch.float32 and got.shape == (27, cin, cout)
    scale = float(ref.abs().max())
    assert scale > 0
    tol = 1e-4 if dtype == torch.float32 else 5e-4
    assert float((got - ref).abs().max()) <= tol * scale


@pytest.mark.parametrize("cin,cout,G", [(3, 32, 1), (5, 24, 2),
                                        (384, 256, 1), (8, 3, 2)])
def test_conv3_columns_dw_plan(dev, cin, cout, G):
    """bf16 A3 runs over the plan it is given and sums in a fixed order:
    two runs agree bit for bit, and a plan whose busiest tile drops a tap
    its rows hit changes that tap's dW and no other."""
    g, km, f, _, cot = _grad_inputs(dev, torch.bfloat16, cin, cout, G)
    args = (f, cot.to(torch.bfloat16), km.col_idx, km.hit, g.mask, G)
    plan = km.plan()
    got = sparse_conv.conv3_columns_dw(*args, plan=plan)
    assert torch.equal(got, sparse_conv.conv3_columns_dw(*args, plan=plan))
    ref = sparse_conv.conv3_columns_dw_plain(*args)
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 5e-4 * scale
    taps = plan.tile_taps.tolist()
    t = max(range(len(taps)), key=lambda i: bin(taps[i]).count("1"))
    k = (taps[t] & ~(1 << 13)).bit_length() - 1
    assert k >= 0
    cut = plan.tile_taps.clone()
    cut[t] &= ~(1 << k)
    bad = sparse_conv.conv3_columns_dw(
        *args, plan=grid.TilePlan(order=plan.order, tile_taps=cut))
    others = [j for j in range(27) if j != k]
    assert torch.equal(bad[others], got[others])
    assert float((bad[k] - ref[k]).abs().max()) > 5e-3 * scale


@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("cin,cout,G", [(5, 24, 2), (16, 72, 1),
                                        (136, 16, 2)])
def test_conv3_function_backward(dev, dtype, out_dtype, cin, cout, G):
    """forward, df and dW through the Function on the card against the
    Function on the CPU (the plain versions under the same rule)."""
    g, km, f, w, cot = _grad_inputs(dev, dtype, cin, cout, G)
    launches = (sparse_conv._conv3_kernel.launches,
                sparse_conv._conv3_dw_kernel.launches)

    def run(device):
        ff = f.clone().to(device).requires_grad_(True)
        ww = w.clone().to(device).requires_grad_(True)
        out = sparse_conv.conv3_columns(
            ff, km.col_idx.to(device), km.hit.to(device), ww,
            g.mask.to(device), G, out_dtype=out_dtype,
            nvalid=km.nvalid.to(device))
        assert out.grad_fn is not None and out.dtype == out_dtype
        out.backward(cot.to(device).to(out_dtype))
        return [t.detach().float().cpu() for t in (out, ff.grad, ww.grad)]

    got, ref = run(dev), run("cpu")
    assert sparse_conv._conv3_kernel.launches == launches[0] + 2
    assert sparse_conv._conv3_dw_kernel.launches == launches[1] + 1
    for name, a, b in zip(("out", "df", "dw"), got, ref):
        scale = float(b.abs().max())
        err = (a - b).abs()
        if dtype == torch.float32:
            tol = 1e-4 if name == "dw" else 1e-5
            assert float(err.max()) <= tol * scale, name
        else:
            ulp = 0.0 if name == "out" else BF16_ULP
            tol = 5e-4 if name == "dw" else 1e-4
            assert bool((err <= ulp * b.abs() + tol * scale).all()), name


def test_conv3_function_skips_df_and_rejects_epilogue(dev):
    g, km, f, w, _ = _grad_inputs(dev, torch.float32, 8, 16, 1)
    w.requires_grad_(True)
    n = sparse_conv._conv3_kernel.launches
    out = sparse_conv.conv3_columns(f, km.col_idx, km.hit, w, g.mask, 1,
                                    nvalid=km.nvalid)
    out.sum().backward()
    assert w.grad is not None
    assert sparse_conv._conv3_kernel.launches == n + 1   # no df launch
    with pytest.raises(ValueError):
        sparse_conv.conv3_columns(f, km.col_idx, km.hit, w, g.mask, 1,
                                  relu=True)


def _down_inputs(dev, cin, cout, G, dtype, seed):
    pyr = _pyramid(dev, 300, [1024, 512], seed=seed)
    fine, coarse = pyr.levels[0], pyr.levels[1].geom
    gen = torch.Generator(device=dev).manual_seed(seed)
    f = torch.randn(fine.geom.capacity, G * cin, generator=gen, device=dev)
    f = (f * fine.geom.mask[:, None]).to(dtype)
    w = torch.randn(8, cin, cout, generator=gen, device=dev) / math.sqrt(cin)
    return fine, coarse, f, w


def _abs_products(f, w, tap, G):
    """|feat| @ |W[tap]| per child and group in float64, from the bf16
    operands both sides multiply: [V_fine, G, Cout]."""
    V, (_, cin, cout) = f.shape[0], w.shape
    a = f.bfloat16().double().abs().reshape(V * G, cin)
    a = a @ w.bfloat16().double().abs().permute(1, 0, 2).reshape(cin,
                                                                   8 * cout)
    a = a.reshape(V, G, 8, cout)
    return a[torch.arange(V, device=f.device), :, tap.long()]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,G", [(16, 32, 1), (32, 64, 2)])
def test_sparse_conv_down_bf16(dev, dtype, cin, cout, G):
    fine, coarse, f, w = _down_inputs(dev, cin, cout, G, dtype, cin + G)
    Vc = coarse.capacity
    args = (fine.parent_idx, fine.up_tap, w, coarse.mask)
    kw = dict(groups=G, bias=0.1 * torch.ones(cout, device=dev), relu=True,
              compute_dtype=torch.bfloat16)
    got = sparse_conv.sparse_conv_down(f, *args, **kw).float().cpu()
    ref = sparse_conv.sparse_conv_down(
        f.cpu(), *(t.cpu() for t in args), **{**kw, "bias": kw["bias"].cpu()})
    ref = ref.float()
    ok = fine.parent_idx < Vc
    pidx = fine.parent_idx.long().clamp(max=Vc)
    a = _abs_products(f, w, fine.up_tap, G).reshape(-1, G * cout)
    A = torch.zeros(Vc + 1, G * cout, dtype=torch.float64, device=dev)
    A.index_add_(0, pidx, a * ok[:, None])
    n = torch.zeros(Vc + 1, dtype=torch.float64, device=dev)
    n.index_add_(0, pidx, ok.double())
    A, n = A[:Vc].cpu(), n[:Vc, None].cpu()
    bound = n * BF16_ULP * A
    if dtype == torch.bfloat16:
        bound = bound + BF16_ULP * ref.abs().double()
    err = (got - ref).abs().double()
    assert bool((err <= bound + 1e-6 * float(A.max())).all()), \
        float((err - bound).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,G", [(32, 16, 1), (64, 32, 2)])
def test_sparse_conv_transpose_bf16(dev, dtype, cin, cout, G):
    fine, coarse, _, w = _down_inputs(dev, cin, cout, G, dtype, cin + G)
    gen = torch.Generator(device=dev).manual_seed(cin)
    c = torch.randn(coarse.capacity, G * cin, generator=gen, device=dev)
    c = (c * coarse.mask[:, None]).to(dtype)
    args = (fine.parent_idx, fine.up_tap, w, fine.geom.mask)
    got = sparse_conv.sparse_conv_transpose(
        c, *args, groups=G, compute_dtype=torch.bfloat16).float().cpu()
    ref = sparse_conv.sparse_conv_transpose(
        c.cpu(), *(t.cpu() for t in args), groups=G,
        compute_dtype=torch.bfloat16).float()
    # one bf16 ulp of each output's |products| sum: the GEMMs accumulate in
    # float32 in other orders and round to bf16 once
    pidx = fine.parent_idx.long().clamp(max=coarse.capacity - 1)
    a = _abs_products(c[pidx], w, fine.up_tap, G).reshape(-1, G * cout).cpu()
    err = (got - ref).abs().double()
    assert bool((err <= BF16_ULP * a + 1e-6 * float(a.max())).all())


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


# (activations' dtype, G, Cin, Cout): training (float32 activations) and
# eval (bf16 in and out, the guided pair); Cout 96, 32 take 8 channels a
# thread, 20 four, 6 two, 5 one
@pytest.mark.parametrize("act,G,cin,cout", [
    (torch.float32, 1, 32, 96), (torch.float32, 1, 16, 20),
    (torch.bfloat16, 2, 64, 32), (torch.bfloat16, 2, 24, 6),
    (torch.bfloat16, 2, 8, 5)])
def test_transpose_gather_function(dev, monkeypatch, act, G, cin, cout):
    """The transpose conv through `TransposeGatherFunction` against the
    same conv through the plain gather on the same CUDA tensors, bf16
    compute: output, coarse-feats gradient and weight gradient bit for bit
    (the kernels change no arithmetic: the GEMMs are the same calls). The
    fine level holds padding rows and the coarse level overflowed, so rows
    with parent_idx == Vc occur; their cotangents are NaN and must not
    reach a gradient. One forward and one backward launch a call."""
    pyr = _pyramid(dev, 700, [2048, 1024, 512])
    fine, coarse = pyr.levels[0], pyr.levels[1].geom
    Vc = coarse.capacity
    assert int(coarse.num_raw) > Vc and bool((~fine.geom.mask).any())
    assert bool((fine.geom.mask & (fine.parent_idx == Vc)).any())
    gen = torch.Generator(device=dev).manual_seed(cin + cout)
    c = torch.randn(Vc, G * cin, generator=gen, device=dev)
    c = (c * coarse.mask[:, None]).to(act)
    w = torch.randn(8, cin, cout, generator=gen, device=dev) / math.sqrt(cin)
    g = torch.randn(fine.geom.capacity, G * cout, generator=gen, device=dev)
    ok = (fine.parent_idx < Vc) & fine.geom.mask
    g = torch.where(ok[:, None], g, float("nan")).to(act)

    def conv():
        a, b = c.clone().requires_grad_(), w.clone().requires_grad_()
        out = sparse_conv.sparse_conv_transpose(
            a, fine.parent_idx, fine.up_tap, b, fine.geom.mask, groups=G,
            compute_dtype=torch.bfloat16)
        out.backward(g)
        torch.cuda.synchronize()
        return out, a.grad, b.grad

    fwd, bwd = sparse_conv._gather_fwd_kernel, sparse_conv._scatter_bwd_kernel
    launches = (fwd.launches, bwd.launches)
    got = conv()
    assert (fwd.launches, bwd.launches) == (launches[0] + 1, launches[1] + 1)
    monkeypatch.setattr(sparse_conv, "transpose_gather",
                        sparse_conv.transpose_gather_plain)
    ref = conv()
    assert (fwd.launches, bwd.launches) == (launches[0] + 1, launches[1] + 1)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and bool(torch.isfinite(a.float()).all())
        assert torch.equal(_bits(a), _bits(b))


def test_transpose_gather_rejects_bad_input(dev):
    pyr = _pyramid(dev, 300, [1024, 512])
    fine = pyr.levels[0]
    y = torch.randn(512, 1, 8, 16, device=dev, dtype=torch.bfloat16)
    ok = (fine.parent_idx < 512) & fine.geom.mask
    run = sparse_conv.transpose_gather
    with pytest.raises(ValueError, match="int32"):
        run(y, fine.parent_idx.long(), fine.up_tap, ok, torch.float32)
    with pytest.raises(ValueError, match="shape"):
        run(y[:, :, :4], fine.parent_idx, fine.up_tap, ok, torch.float32)
    with pytest.raises(ValueError, match="dtypes"):
        run(y.half(), fine.parent_idx, fine.up_tap, ok, torch.float32)
    with pytest.raises(ValueError, match="non-contiguous"):
        run(y.transpose(0, 3), fine.parent_idx, fine.up_tap, ok,
            torch.float32)


# ---------------- the refiner: kernel C2, chamfer, RefineTask ----------------

def _sorted_coords(rng, v, nb, lim):
    c = np.concatenate([rng.integers(0, nb, (v, 1)),
                        rng.integers(-lim, lim, (v, 3))], 1).astype(np.int32)
    return c[np.lexsort((c[:, 3], c[:, 2], c[:, 1], c[:, 0]))]


# vq, vr, items, |coord| limit, valid share of refs
C2_CASES = {
    "random": (5000, 9000, 1, 1000, 0.9),
    "ties": (3000, 6000, 1, 6, 1.0),
    "two_items": (6000, 9000, 2, 900, 0.9),
    "coords_at_the_key_limit": (3000, 9000, 1, 2047, 1.0),
    "many_refs": (3000, 140_000, 1, 1279, 0.95),
    "fewer_refs_than_a_cell": (700, 3, 2, 50, 1.0),
    "ragged_last_tile": (257, 2000, 1, 300, 1.0),
}


@pytest.mark.parametrize("case", list(C2_CASES))
def test_nn_match_tiled(dev, case):
    """C2 against its plain version (indices and rows staged per tile) and
    C1: exact on every valid query; one launch."""
    vq, vr, nb, lim, r_valid = C2_CASES[case]
    rng = np.random.default_rng(len(case))
    q = torch.from_numpy(_sorted_coords(rng, vq, nb, lim)).to(dev)
    r = torch.from_numpy(_sorted_coords(rng, vr, nb, lim)).to(dev)
    qm = torch.from_numpy(rng.random(vq) < 0.9).to(dev)
    rm = torch.from_numpy(rng.random(vr) < r_valid).to(dev)
    n_batch = nb
    launches = knn._tile_kernel.launches
    got = knn.nn_match_tiled(q, qm, r, rm, n_batch)
    assert knn._tile_kernel.launches == launches + 1
    index = knn.build_tile_index(r, rm, n_batch)
    order = knn.tile_order(q, qm, index)
    idx, staged = knn.nn_tiles(q, qm, index, order)
    plain, plain_staged = knn.nn_tiles_plain(q.cpu(), qm.cpu(),
                                             _index_to(index, "cpu"),
                                             order.cpu())
    assert torch.equal(idx, got)
    assert torch.equal(idx.cpu(), plain)
    assert torch.equal(staged.cpu(), plain_staged)
    assert torch.equal(got[qm], knn.nn_match(q, r, rm, n_batch)[qm])
    assert bool((got[~qm] == 0).all())


def _index_to(index, device):
    return knn.TileIndex(pts=index.pts.to(device),
                         cell_start=index.cell_start.to(device),
                         geo=index.geo.to(device), cap=index.cap,
                         batched=index.batched)


def test_nn_match_tiled_no_valid_ref_in_an_item(dev):
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_sorted_coords(rng, 4000, 2, 500)).to(dev)
    r = torch.from_numpy(_sorted_coords(rng, 6000, 2, 500)).to(dev)
    qm = torch.ones(4000, dtype=torch.bool, device=dev)
    rm = r[:, 0] == 0                         # item 1 has no valid ref
    got = knn.nn_match_tiled(q, qm, r, rm, 2)
    assert torch.equal(got, knn.nn_match(q, r, rm, 0))
    assert bool((got[q[:, 0] == 1] == 0).all())


def test_nn_match_tiled_rejects_bad_input(dev):
    rng = np.random.default_rng(4)
    q = torch.from_numpy(_sorted_coords(rng, 600, 1, 100)).to(dev)
    r = torch.from_numpy(_sorted_coords(rng, 3000, 1, 100)).to(dev)
    qm = torch.ones(600, dtype=torch.bool, device=dev)
    rm = torch.ones(3000, dtype=torch.bool, device=dev)
    index = knn.build_tile_index(r, rm, 1)
    order = knn.tile_order(q, qm, index)
    with pytest.raises(ValueError):          # tensors on two devices
        knn.nn_tiles(q, qm.cpu(), index, order)
    with pytest.raises(ValueError):          # an order of the wrong length
        knn.nn_tiles(q, qm, index, order[:-1])
    with pytest.raises(ValueError):          # non-contiguous coords
        knn.nn_tiles(q.T.contiguous().T, qm, index, order)


def _clouds(n, m, B, seed):
    rng = np.random.default_rng(seed)
    az = rng.uniform(0, 2 * np.pi, (B, n))
    rad = rng.uniform(3, 45, (B, n))
    x = np.stack([rad * np.cos(az), rad * np.sin(az),
                  rng.uniform(-2, 2, (B, n))], -1).astype(np.float32)
    y = (x[:, rng.permutation(n)[:m]]
         + rng.normal(scale=0.3, size=(B, m, 3))).astype(np.float32)
    return x, y


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("method", ["grid", "exact"])
def test_chamfer_card_against_cpu(dev, method, masked):
    """Loss within 1e-5 relative, gradients to both clouds within 1e-5 of
    max|grad| (float32 sums in other orders). The grid path's indices are
    exact integers on both sides; the exact path ranks float32 GEMM
    outputs, where a near-tie may fall the other way on the card and turn
    that point's gradient to another neighbour: up to 2 rows in 1000 may
    differ there."""
    from lidiff_tpu_torch.ops import chamfer
    x, y = _clouds(6000, 4000, 2, 5)
    rng = np.random.default_rng(6)
    mx = rng.random(x.shape[:2]) < 0.8 if masked else None
    my = rng.random(y.shape[:2]) < 0.8 if masked else None
    launches = knn._tile_kernel.launches
    out = {}
    for d in (dev, "cpu"):
        a = torch.from_numpy(x).to(d).requires_grad_(True)
        b = torch.from_numpy(y).to(d).requires_grad_(True)
        masks = [None if m is None else torch.from_numpy(m).to(d)
                 for m in (mx, my)]
        loss = chamfer.chamfer_distance(a, b, *masks, method=method)
        loss.backward()
        out[d] = (float(loss.detach()), a.grad.cpu(), b.grad.cpu())
    assert knn._tile_kernel.launches == launches + (2 if method == "grid"
                                                    else 0)
    (l_card, ga, gb), (l_cpu, ra, rb) = out[dev], out["cpu"]
    assert abs(l_card - l_cpu) <= 1e-5 * l_cpu
    for got, ref in ((ga, ra), (gb, rb)):
        assert float(ref.abs().max()) > 0
        off = (got - ref).abs().amax(dim=-1) > 1e-5 * float(ref.abs().max())
        assert float(off.float().mean()) <= (2e-3 if method == "exact"
                                             else 0.0)


def test_refiner_small_training_step(dev):
    """chip_smoke.py's small float32 `RefineTask.loss_fn` step, card against
    CPU on the card's discrete choices (ReLU signs, chamfer picks): loss
    rtol 1e-4, each gradient within 2e-3 of its max|grad| plus 1e-4 of the
    largest (sums of about 60 layers in other orders), at most 1e-4 of the
    choices differing. The step takes the grid chamfer, so it runs C2."""
    import chip_smoke
    from lidiff_tpu_torch import config as cfg_mod
    launches = knn._tile_kernel.launches
    chip_smoke.check_small_refine_train(cfg_mod, "cuda")
    assert knn._tile_kernel.launches == launches + 2


def _fps_cloud(n, seed, dup=1):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 10.0, (n, 3)).astype(np.float32)
    return np.tile(pts, (dup, 1))


# (N, k, copies of the cloud, the largest cluster to try). A block's slice
# stays in shared memory up to about 226 KB, 14.5k points: beyond (300k
# points over 16 blocks, 140k over 8) F1 reads the points from global
# memory, and max_cluster 8 takes the cluster F1 falls back to where 16
# blocks do not fit.
F1_CASES = {"one block": (200, 50, 1, 16),
            "N % 256 != 0": (12_345, 400, 1, 16),
            "four points a thread": (140_000, 60, 1, 16),
            "duplicated points": (500, 900, 3, 16), "k = 1": (300, 1, 1, 16),
            "k >= N": (300, 300, 1, 16),
            "slices in global memory": (300_000, 500, 1, 16),
            "8-block cluster": (100_003, 700, 1, 8),
            "8-block cluster, slices in global memory": (140_000, 60, 1, 8)}


@pytest.mark.parametrize("case", list(F1_CASES))
def test_fps_kernel(dev, case):
    from lidiff_tpu_torch.native import fps_native
    from lidiff_tpu_torch.ops import fps
    n, k, dup, cluster = F1_CASES[case]
    pts = _fps_cloud(n, 11, dup)
    t = torch.from_numpy(pts).to(dev)
    got = fps.fps_cuda(t, k, max_cluster=cluster)
    torch.cuda.synchronize()
    if k < len(pts):
        assert fps._fps_kernel.cluster == cluster
    assert got.dtype == torch.int64 and got.device == t.device
    assert torch.equal(got, fps.fps_plain(t, k))
    np.testing.assert_array_equal(got.cpu().numpy(), fps_native(pts, k))


# ---------------------------------------------------------------------------
# Training-mode masked BatchNorm (`ops/batchnorm.py`, csrc/masked_bn.cu)
# ---------------------------------------------------------------------------

BN_EPILOGUES = {"none": (False, False), "relu": (True, False),
                "residual_relu": (True, True)}
BN_MASKS = {"none valid": 0.0, "some valid": 0.6, "all valid": 1.0}
BN_ROWS = 5003            # not a multiple of any block's rows
BN_F32_TOL = 1e-4         # float32, x max|ref| (1 + it for out and var):
                          # the same values summed in other orders over up
                          # to 5,003 rows


def _bn_inputs(dev, dtype, V, C, share, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(V, C, generator=g, device=dev) * 2.0 + 0.5).to(dtype)
    mask = torch.rand(V, generator=g, device=dev) < share
    scale = 1.0 + 0.1 * torch.randn(C, generator=g, device=dev)
    bias = 0.1 * torch.randn(C, generator=g, device=dev)
    res = torch.randn(V, C, generator=g, device=dev).to(dtype)
    cot = torch.randn(V, C, generator=g, device=dev).to(dtype)
    return x, mask, scale, bias, res, cot


def _bn_run(x, mask, scale, bias, res, cot, eps, relu, residual, fused,
            group=None, signs=None):
    """Output, moments and gradients (x, scale, bias, residual) of one
    call, through the kernels or the plain eager code on the same tensors;
    the eager code's ReLU takes `signs` (the kernels' out > 0) where given:
    moments that differ in the last bit flip the ReLU of an input within
    rounding of 0, and that element's gradient with it."""
    from lidiff_tpu_torch.ops import batchnorm as bn
    xt = x.clone().requires_grad_()
    st, bt = scale.clone().requires_grad_(), bias.clone().requires_grad_()
    rt = res.clone().requires_grad_() if residual else None
    if fused:
        out, mean, var, cnt = bn.masked_bn_train(
            xt, mask, st, bt, eps, group, relu=relu, residual=rt)
    else:
        mean, var, cnt = bn.masked_moments(xt, mask)
        out = bn.normalize_plain(xt, mask, mean, var, st, bt, eps,
                                 relu and signs is None, rt)
        if relu and signs is not None:
            out = torch.where(signs, out, 0.0)
    out.backward(cot)
    return {"out": out.detach(), "mean": mean.detach(), "var": var.detach(),
            "cnt": cnt.detach(), "dx": xt.grad, "dscale": st.grad,
            "dbias": bt.grad, "dres": rt.grad if residual else None}


def _close(got, ref, tol, name):
    err = float((got.float() - ref.float()).abs().max()) if got.numel() \
        else 0.0
    assert err <= tol, f"{name}: {err} > {tol}"


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
@pytest.mark.parametrize("epilogue", list(BN_EPILOGUES))
@pytest.mark.parametrize("masked", list(BN_MASKS))
@pytest.mark.parametrize("C", [32, 96, 256, 384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_bn_fused_matches_plain(dev, dtype, C, masked, epilogue,
                                       eps):
    """The fused function against the plain eager code on the card.

    The moments: the count exact; mean and var within BN_F32_TOL (the sums'
    order). The output: with the fused moments, the plain code's output
    equals the kernel's bit for bit (the same float32 operations in the
    same order, or in bf16 the same roundings); with its own moments
    within BN_F32_TOL of max|out|, and one bf16 ulp of it more in bf16.
    The gradients in float32: the eager code's autograd, its ReLU on the
    kernels' signs, within BN_F32_TOL of each gradient's largest (sums in
    other orders). In bf16 the eager backward is another function: it
    differentiates the bf16 affine x * k + c, whose k = rstd * scale is
    rounded to bf16, and rounds its products g * x to bf16, which in a
    gradient summed over thousands of rows leaves far more than one
    rounding. The kernels compute the closed form in float32, so in bf16
    the gradients are held to `masked_bn_backward_plain` on the same bf16
    tensors and the kernels' output and moments: dx within one bf16 ulp of
    max|dx| plus BN_F32_TOL, dscale and dbias within BN_F32_TOL of their
    largest. The residual's gradient is the gated cotangent: equal."""
    from lidiff_tpu_torch.ops import batchnorm as bn
    relu, residual = BN_EPILOGUES[epilogue]
    x, mask, scale, bias, res, cot = _bn_inputs(
        dev, dtype, BN_ROWS, C, BN_MASKS[masked], C)
    got = _bn_run(x, mask, scale, bias, res, cot, eps, relu, residual, True)
    ref = _bn_run(x, mask, scale, bias, res, cot, eps, relu, residual, False,
                  signs=got["out"] > 0)
    assert float(got["cnt"]) == float(ref["cnt"]) == max(int(mask.sum()), 1)
    top_x2 = float((x.float() ** 2).max())
    _close(got["mean"], ref["mean"], BN_F32_TOL * top_x2 ** 0.5, "mean")
    _close(got["var"], ref["var"], BN_F32_TOL * (1 + top_x2), "var")
    same = bn.normalize_plain(x, mask, got["mean"], got["var"], scale, bias,
                              eps, relu, res if residual else None)
    assert got["out"].dtype == dtype and torch.equal(got["out"], same)
    top = float(ref["out"].abs().max())
    ulp = 2.0 ** -7 * top if dtype == torch.bfloat16 else 0.0
    _close(got["out"], ref["out"], BN_F32_TOL * (1 + top) + ulp, "out")
    if dtype == torch.float32:
        for k in ("dx", "dscale", "dbias"):
            _close(got[k], ref[k], BN_F32_TOL * float(ref[k].abs().max()), k)
        if residual:
            assert torch.equal(got["dres"], ref["dres"])
        return
    _, _, rstd, vok, _ = bn.moments_plain(x, mask, eps)
    dx, dscale, dbias, dres = bn.masked_bn_backward_plain(
        cot, x, mask, got["out"], got["mean"],
        torch.rsqrt(got["var"] + eps), vok, got["cnt"], scale, relu,
        residual)
    _close(got["dx"], dx, 2.0 ** -7 * float(dx.float().abs().max())
           + BN_F32_TOL, "dx")
    for k, want in (("dscale", dscale), ("dbias", dbias)):
        _close(got[k], want, BN_F32_TOL * float(want.abs().max()) + 1e-6, k)
    if residual:
        assert torch.equal(got["dres"], dres)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_bn_repeats_bit_for_bit(dev, dtype):
    """Two calls on the same inputs, forward and backward, agree bit for
    bit: no atomics, and the row blocks are fixed by the shape."""
    x, mask, scale, bias, res, cot = _bn_inputs(dev, dtype, 200_003, 96,
                                                0.7, 3)
    a, b = (_bn_run(x, mask, scale, bias, res, cot, 1e-5, True, True, True)
            for _ in range(2))
    for k in a:
        assert torch.equal(_bits(a[k]), _bits(b[k])), k


def test_masked_bn_variance_clamp(dev):
    """Seven valid rows. Channel 0: four of 1 + 2^-11 and three of 1, whose
    sums are exact in any order and whose one-pass variance rounds to
    -2^-23: the clamp is active, the variance 0 and the gradient's last
    term dropped. Channel 1: the constant 1.5, variance exactly 0. Both
    sides then agree bit for bit on the moments and the output, and the
    gradients within BN_F32_TOL of max|grad|."""
    from lidiff_tpu_torch.ops import batchnorm as bn
    x, mask, scale, bias, res, cot = _bn_inputs(dev, torch.float32, 40, 32,
                                                0.0, 9)
    mask[torch.arange(3, 40, 5, device=dev)[:7]] = True
    rows = torch.nonzero(mask).flatten()
    x[:, 0] = 1.0
    x[rows[:4], 0] = 1.0 + 2.0 ** -11
    x[:, 1] = 1.5
    _, var, _, vok, _ = bn.moments_plain(x, mask, 1e-3)
    assert vok[:2].tolist() == [0.0, 1.0] and var[:2].tolist() == [0.0, 0.0]
    for relu, residual in BN_EPILOGUES.values():
        got = _bn_run(x, mask, scale, bias, res, cot, 1e-3, relu, residual,
                      True)
        ref = _bn_run(x, mask, scale, bias, res, cot, 1e-3, relu, residual,
                      False, signs=got["out"] > 0)
        for k in ("mean", "var"):
            assert torch.equal(got[k][:2], ref[k][:2]), k
        assert torch.equal(got["out"][:, :2], ref["out"][:, :2])
        for k in ("dx", "dscale", "dbias"):
            _close(got[k], ref[k], BN_F32_TOL * float(ref[k].abs().max()), k)


def test_masked_bn_one_rank_group(dev):
    """Through a one-rank NCCL group the forward's sums and the backward's
    are all-reduced over one rank: every output and gradient equals the
    call without a group bit for bit."""
    from lidiff_tpu_torch.parallel import mesh
    x, mask, scale, bias, res, cot = _bn_inputs(dev, torch.float32, 30_001,
                                                64, 0.5, 4)
    group = mesh.init_ranks(0, 1, mesh.file_init_method(), dev)
    try:
        a = _bn_run(x, mask, scale, bias, res, cot, 1e-5, True, True, True,
                    group)
    finally:
        mesh.shutdown()
    b = _bn_run(x, mask, scale, bias, res, cot, 1e-5, True, True, True)
    for k in a:
        assert torch.equal(_bits(a[k]), _bits(b[k])), k


def test_masked_bn_rejects_bad_input(dev):
    from lidiff_tpu_torch.ops import batchnorm as bn
    x, mask, scale, bias, res, _ = _bn_inputs(dev, torch.float32, 10, 8,
                                              0.5, 0)
    with pytest.raises(ValueError):
        bn.masked_bn_train(x.half(), mask, scale, bias, 1e-5)
    with pytest.raises(ValueError):
        bn.masked_bn_train(x, mask, scale, bias, 1e-5, residual=res.bfloat16())
    with pytest.raises(ValueError):
        bn.masked_bn_train(x, mask.int(), scale, bias, 1e-5)
    with pytest.raises(ValueError):
        bn.masked_bn_train(x, mask, scale.cpu(), bias, 1e-5)


def test_masked_bn_refiner_step_takes_the_fused_path(dev):
    """A small float32 refiner step on the card with remat: every
    training-mode BatchNorm call is fused (49 sites, 47 of them recomputed
    in the backward pass), none plain, and the kernels launch once a call
    forward (stats, moments, apply) and once a site backward (grad,
    dx)."""
    import chip_smoke
    from lidiff_tpu_torch import config as cfg_mod
    from lidiff_tpu_torch.models import refine
    from lidiff_tpu_torch.ops import batchnorm as bn
    cfg = cfg_mod.finalize_config(chip_smoke.make_refine_cfg(
        4000, 0.25, 2, {"full_capacities": [8192] * 5}))
    clean = np.concatenate([chip_smoke.ring_scan(4000, seed=3),
                            chip_smoke.ring_scan(4000, seed=4)])
    gt = np.concatenate([clean, chip_smoke.jittered(clean, 6)], 1)
    task = refine.RefineTask(cfg, device=dev, compute_dtype=torch.float32,
                             seed=2, remat=True)
    kernels = (bn._stats_kernel, bn._moments_kernel, bn._apply_kernel,
               bn._grad_kernel, bn._dx_kernel)
    counts, launches = dict(bn.counters), [k.launches for k in kernels]
    loss, _ = task.loss_fn(
        {"pcd_noise": torch.from_numpy(chip_smoke.jittered(clean, 5)).to(dev),
         "pcd_full": torch.from_numpy(gt).to(dev)})
    loss.backward()
    torch.cuda.synchronize()
    assert bn.counters["fused"] - counts["fused"] == 49 + 47
    assert bn.counters["plain"] == counts["plain"]
    assert [k.launches - n for k, n in zip(kernels, launches)] == \
        [96, 96, 96, 49, 49]
    assert all(torch.isfinite(p.grad).all()
               for p in task.model.parameters())


# ---------------------------------------------------------------------------
# GA: the eval gate's apply step (`ops/gate.py`, `csrc/gate_apply.cu`)
# ---------------------------------------------------------------------------

def _gate_args(dev, dtype, V, G, C, n_bank, B=2, seed=0):
    """feats, table, rows, coords, mask; 30% of the rows masked, their
    items and bank rows out of range (the kernel must not read them)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    mask = torch.rand(V, generator=gen, device=dev) < 0.7
    coords = torch.randint(0, B, (V, 4), generator=gen, device=dev,
                           dtype=torch.int32)
    rows = torch.randint(0, n_bank, (V, G), generator=gen, device=dev,
                         dtype=torch.int32)
    coords[~mask, 0] = -3
    rows[~mask] = n_bank + 100
    feats = torch.randn(V, G * C, generator=gen, device=dev).to(dtype)
    table = torch.randn(B * n_bank, C, generator=gen, device=dev).to(dtype)
    return feats, table, rows, coords, mask, n_bank


def _same_bits(a, b):
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("C", [32, 64, 96, 128, 256, 12])
def test_gate_apply(dev, dtype, G, C):
    """GA against `gate_apply_plain` bit for bit: the product in float32
    rounded once, the masked rows feats * 0 (-0 where feats < 0); C = 12
    takes 4-channel vectors in bf16."""
    from lidiff_tpu_torch.ops import gate
    args = _gate_args(dev, dtype, 1001, G, C, 37)
    launches = gate._apply_kernel.launches
    out = gate.gate_apply(*args)
    assert gate._apply_kernel.launches == launches + 1
    assert _same_bits(out, gate.gate_apply_plain(*args))


def test_gate_apply_unaligned(dev):
    """feats and out at an address 2 bytes past 16: one channel a thread,
    the same bits."""
    from lidiff_tpu_torch.ops import gate
    feats, *rest = _gate_args(dev, torch.bfloat16, 300, 2, 32, 11)
    buf = torch.empty(feats.numel() + 1, dtype=feats.dtype, device=dev)
    off = buf[1:].view(feats.shape)
    off.copy_(feats)
    assert off.data_ptr() % 16 and off.is_contiguous()
    assert _same_bits(gate.gate_apply(off, *rest),
                      gate.gate_apply_plain(feats, *rest))


def test_gate_apply_rejects_bad_input(dev):
    from lidiff_tpu_torch.ops import gate
    feats, table, rows, coords, mask, nb = _gate_args(dev, torch.bfloat16,
                                                      64, 2, 32, 5)
    bad = [
        (feats.half(), table.half(), rows, coords, mask, nb),
        (feats, table.float(), rows, coords, mask, nb),
        (feats, table, rows.long(), coords, mask, nb),
        (feats, table, rows, coords.long(), mask, nb),
        (feats, table, rows, coords, mask.int(), nb),
        (feats, table, rows, coords[:, :3].contiguous(), mask, nb),
        (feats, table, rows, coords, mask[:-1], nb),
        (feats[:, :48].contiguous(), table, rows, coords, mask, nb),
        (feats, table, rows, coords, mask, 3),
        (feats, table, rows, coords, mask, 0),
        (feats.t().contiguous().t(), table, rows, coords, mask, nb),
        (feats, table.cpu(), rows, coords, mask, nb)]
    for case in bad:
        with pytest.raises(ValueError):
            gate.gate_apply(*case)


def test_denoise_pair_gates_by_table(dev, monkeypatch):
    """One guided denoise on the card (small config, G = 2) launches GA
    once per gate (8), its tables hold under a tenth of the gated rows,
    and its eps matches per-voxel gates on the same weights and inputs
    (deterministic algorithms: the down conv's adds in a fixed order):
    float32 within test_torch_sampling.py's guided-eps tolerance, 13e-4 of
    max(1, max|eps|); bf16 within 2^-5 of max|eps|, where a gate value
    rounded the other way moves the eps through about 40 bf16 layers and
    the guidance's 2w + 1 = 13."""
    import chip_smoke
    from lidiff_tpu_torch import config as cfg_mod
    from lidiff_tpu_torch.models import diffusion, minkunet
    from lidiff_tpu_torch.ops import gate
    caps = {"full_capacities": [4096] * 3 + [3072, 2048],
            "part_capacities": [512] * 5}
    cfg = cfg_mod.finalize_config(chip_smoke.make_cfg(4000, 2, cr=0.25,
                                                      caps=caps))
    part = torch.from_numpy(chip_smoke.ring_scan(400, seed=3)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    x = part.repeat(1, 10, 1) + 0.5 * torch.randn(1, 4000, 3, generator=gen,
                                                  device=dev)

    def per_voxel(module, feats, geom, rows, bank, temp_emb):
        match = torch.where(geom.mask[:, None, None], bank[rows.long()], 0)
        return module(feats, geom, match, temp_emb, rows.shape[1])

    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        for dtype in (torch.float32, torch.bfloat16):
            task = diffusion.DiffusionTask(cfg, device=dev,
                                           compute_dtype=dtype, seed=2)
            banks = task.encode_banks(part)
            launches, before = gate._apply_kernel.launches, \
                dict(gate.counters)
            eps = task.denoise_pair(x, *banks, 500)
            assert gate._apply_kernel.launches - launches == 8
            assert gate.counters["table_calls"] - before["table_calls"] == 8
            share = (gate.counters["table_rows"] - before["table_rows"]) / \
                (gate.counters["gated_rows"] - before["gated_rows"])
            assert share < 0.1, share
            with monkeypatch.context() as m:
                m.setattr(minkunet.StageGate, "apply_table", per_voxel)
                ref = task.denoise_pair(x, *banks, 500)
            top = float(ref.float().abs().max())
            tol = 13e-4 * max(1.0, top) if dtype == torch.float32 \
                else 2.0 ** -5 * top
            err = float((eps.float() - ref.float()).abs().max())
            assert err <= tol, (dtype, err, tol)
            assert top > 0.1
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
