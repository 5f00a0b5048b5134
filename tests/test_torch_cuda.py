"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These skip without a CUDA device; run them on a machine with one:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

They cover what chip_smoke.py's main-path shapes do not: inputs smaller
than one tile, partial tiles past nvalid, widths that are not multiples of
8 (the scalar-load path of A1's tensor-core variant), no bias, no ReLU,
and the float32 path. Tolerances as in chip_smoke.py: B1 and C1 exact;
A1 float32 within 1e-5 of max|ref| (sum order), bf16 within one bf16 ulp
plus 1e-4 of max|ref|. The bf16 down and transpose convs (plain PyTorch on
both sides, atomic scatter order on the card) are held to the bound stated
in `sparse_conv_down`: n * 2^-7 * A per parent of n children, A the sum of
|feat| * |weight| over its children and channels.

A3 (the weight gradient) is held to its plain version on the same bf16 or
float32 operands within 1e-4 of max|ref| in float32 and 5e-4 in bf16: both
sum float32 products, the kernel over blocks with atomics in an order that
changes from run to run, and in bf16 on the tensor cores, which truncate
where they add to the float32 accumulator.
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
    (16, 24, 1, 5, (16, 8))])
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
