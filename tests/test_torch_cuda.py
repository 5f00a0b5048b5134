"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These skip without a CUDA device; run them on a machine with one:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

They cover what chip_smoke.py's main-path shapes do not: inputs smaller
than one tile, partial tiles past nvalid, tiles of the tile plan with no
active tap, input widths that are not multiples of 8 or 16 (zero-padded by
the wrappers) and K chunks with a tail, output widths that are not
multiples of 8 and Co = 384 (two blocks of 192 across the width), no
bias, no ReLU, and the float32 path. Tolerances as in chip_smoke.py: B1
and C1 exact (C1 over its grid index also examines the rows its
tensor-code search examines); A1 float32 within 1e-5 of max|ref| (sum order), bf16
within one bf16 ulp plus 1e-4 of max|ref|. The bf16 down and transpose
convs (plain PyTorch on both sides, atomic scatter order on the card)
are held to the bound stated in `sparse_conv_down`: n * 2^-7 * A per
parent of n children, A the sum of |feat| * |weight| over its children
and channels.

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
rounding of dW to the weights' dtype."""

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
        col, hit = grid.kmap3_columns(g.key, g.coords, g.mask, g.stride)
        pcol, phit = grid.kmap3_columns_plain(g.key, g.coords, g.mask,
                                              g.stride)
        assert torch.equal(hit, phit) and torch.equal(col, pcol)


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


# ---------------- the refiner: kernel C2, chamfer, RefineTask ----------------

def _sorted_coords(rng, v, nb, lim):
    c = np.concatenate([rng.integers(0, nb, (v, 1)),
                        rng.integers(-lim, lim, (v, 3))], 1).astype(np.int32)
    return c[np.lexsort((c[:, 3], c[:, 2], c[:, 1], c[:, 0]))]


# vq, vr, items, |coord| limit, valid share of refs, what the case is about
C2_CASES = {
    "random": (5000, 9000, 1, 1000, 0.9),
    "ties": (3000, 6000, 1, 6, 1.0),
    "two_items": (6000, 9000, 2, 900, 0.9),
    "coords_at_the_key_limit": (3000, 9000, 1, 2047, 1.0),
    "wide_window": (3000, 140_000, 1, 1279, 0.95),
    "trivial_interval": (700, 300, 2, 50, 0.8),
    "ragged_last_tile": (257, 2000, 1, 300, 1.0),
}


@pytest.mark.parametrize("case", list(C2_CASES))
def test_nn_match_pruned(dev, case):
    """C2 and the window-bound kernel against their plain versions and
    C1: exact on every valid query."""
    vq, vr, nb, lim, r_valid = C2_CASES[case]
    rng = np.random.default_rng(len(case))
    q = torch.from_numpy(_sorted_coords(rng, vq, nb, lim)).to(dev)
    r = torch.from_numpy(_sorted_coords(rng, vr, nb, lim)).to(dev)
    qm = torch.from_numpy(rng.random(vq) < 0.9).to(dev)
    rm = torch.from_numpy(rng.random(vr) < r_valid).to(dev)
    n_batch = 1 if nb == 1 else 0
    launches = (knn._pruned_kernel.launches, knn._bound_kernel.launches)
    got = knn.nn_match_pruned(q, qm, r, rm, n_batch)
    pruning = case != "trivial_interval"
    assert knn._pruned_kernel.launches == launches[0] + 1
    assert knn._bound_kernel.launches == launches[1] + int(pruning)
    start, cnt = knn.prune_intervals(q, qm, r, rm, n_batch)
    plain = knn.nn_match_pruned_plain(q.cpu(), qm.cpu(), r.cpu(), rm.cpu(),
                                      n_batch)
    assert torch.equal(got.cpu()[qm.cpu()], plain[qm.cpu()])
    assert torch.equal(got[qm], knn.nn_match(q, r, rm, n_batch)[qm])
    if pruning:
        window = knn.window_rows(vr)
        win = knn.window_starts(q, r, window)
        assert torch.equal(
            knn.window_bound(q, qm, r, rm, win, window, n_batch),
            knn.window_bound_plain(q, qm, r, rm, win, window, n_batch != 1))
        assert int(cnt.min()) < vr
    else:
        assert bool((cnt == vr).all()) and bool((start == 0).all())


def test_nn_match_pruned_no_valid_ref_in_an_item(dev):
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_sorted_coords(rng, 4000, 2, 500)).to(dev)
    r = torch.from_numpy(_sorted_coords(rng, 6000, 2, 500)).to(dev)
    qm = torch.ones(4000, dtype=torch.bool, device=dev)
    rm = r[:, 0] == 0                         # item 1 has no valid ref
    got = knn.nn_match_pruned(q, qm, r, rm, 0)
    assert torch.equal(got, knn.nn_match(q, r, rm, 0))
    assert bool((got[q[:, 0] == 1] == 0).all())


def test_nn_match_pruned_rejects_bad_input(dev):
    rng = np.random.default_rng(4)
    q = torch.from_numpy(_sorted_coords(rng, 600, 1, 100)).to(dev)
    r = torch.from_numpy(_sorted_coords(rng, 3000, 1, 100)).to(dev)
    qm = torch.ones(600, dtype=torch.bool, device=dev)
    rm = torch.ones(3000, dtype=torch.bool, device=dev)
    start, cnt = knn.prune_intervals(q, qm, r, rm, 1)
    with pytest.raises(ValueError):          # tensors on two devices
        knn.nn_match_intervals(q, r, rm.cpu(), start, cnt, 1)
    with pytest.raises(ValueError):          # one interval too few
        knn.nn_match_intervals(q, r, rm, start[:-1], cnt[:-1], 1)
    with pytest.raises(ValueError):          # non-contiguous coords
        knn.nn_match_intervals(q.T.contiguous().T, r, rm, start, cnt, 1)


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
    launches = knn._pruned_kernel.launches
    out = {}
    for d in (dev, "cpu"):
        a = torch.from_numpy(x).to(d).requires_grad_(True)
        b = torch.from_numpy(y).to(d).requires_grad_(True)
        masks = [None if m is None else torch.from_numpy(m).to(d)
                 for m in (mx, my)]
        loss = chamfer.chamfer_distance(a, b, *masks, method=method)
        loss.backward()
        out[d] = (float(loss.detach()), a.grad.cpu(), b.grad.cpu())
    assert knn._pruned_kernel.launches == launches + (2 if method == "grid"
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
    launches = knn._pruned_kernel.launches
    chip_smoke.check_small_refine_train(cfg_mod, "cuda")
    assert knn._pruned_kernel.launches == launches + 2
