"""Parity of the port's gather-form kernel-map API with the JAX package:
`cube_offsets`, `build_kernel_map`, `down_kmap_from_pooling`,
`ColumnKernelMap.idx`, the `sparse_conv` dispatcher and its gather body
(per tap, fused, G=2, with autograd), `global_pool` and `SparseConv` over a
KernelMap; the masking of the down and transpose convs on rows under which
the value is not finite; `sample_chunked` against `sample`; and
`enable_compile_cache`.

Maps compare exactly: `hit` in full, `idx` on the hit taps (a missed tap's
row is never read). Float32 convs: rtol 1e-5, atol 1e-6 (the same products
summed in other orders by the GEMMs). bf16 convs: see BF16_U."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidiff_tpu.ops import grid as jgrid
from lidiff_tpu.ops import sparse_conv as jsc
from lidiff_tpu_torch import native as host_native
from lidiff_tpu_torch.config import finalize_config
from lidiff_tpu_torch.models.blocks import SparseConv
from lidiff_tpu_torch.models.diffusion import DiffusionTask
from lidiff_tpu_torch.ops import grid as tgrid
from lidiff_tpu_torch.ops import keys as tkeys
from lidiff_tpu_torch.ops import native as cuda_native
from lidiff_tpu_torch.ops import sparse_conv as tsc
from lidiff_tpu_torch.utils.cache import enable_compile_cache
from tests.torch_parity_helpers import CFG, NP, TILE, ring_scan

RES = 0.3
CAP = 700
# the JAX side, each function compiled once: cheaper than its ops one by one
J_QUANTIZE = jax.jit(jgrid.quantize, static_argnums=(1, 2))
J_POOL = jax.jit(jgrid.pool_geom, static_argnums=1)
J_KMAP = jax.jit(jgrid.build_kernel_map)
J_DOWN = jax.jit(jgrid.down_kmap_from_pooling, static_argnums=2)
J_KMAP3 = jax.jit(jgrid.build_kmap3_columns)
TOL = dict(rtol=1e-5, atol=1e-6)
# bf16 feats, bf16 compute: each tap's GEMM result and each partial sum
# round to bf16 (unit roundoff u = 2^-8) on both sides, in possibly other
# places. With A = sum_k |g_k| @ |W_k| + |bias|, either side is within
# (K + 2) u A of the exact sum (K tap roundings, K - 1 adds, bias, output),
# so the two are within 2 (K + 2) u A of each other.
BF16_U = 2.0 ** -8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's torch ops on one intra-op thread, restored afterwards:
    its inputs are tiny, and when the suite's workers share the cores the
    thread pool's hand-offs cost far more than the ops (a 4-step sample of
    the tiny task: 55 s on 8 threads under load, 1.6 s on one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _points(seed, B=2, N=300):
    """The blobs of tests/test_kmap_fast.py:_grid, with points at the edge
    of the packable range (x = 2047 and y = -2048 voxels: some of their
    queries leave it) and beyond it (dropped as invalid)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 1.5, size=(B, N, 3)).astype(np.float32)
    pts[:, :3, 0] = 2047 * RES
    pts[:, 3:5, 1] = -2048 * RES
    pts[:, 5:7, 2] = 3000 * RES
    return pts


@pytest.fixture(scope="module")
def geoms():
    """(geom, child2parent) of level 0 (capacity above the voxel count:
    masked rows; child2parent None) and of its pooling to level 1, in the
    order JAX L0, port L0, JAX L1, port L1."""
    pts = _points(0)
    jg, _, _ = J_QUANTIZE(jnp.asarray(pts), RES, CAP)
    tg, _, _ = tgrid.quantize(torch.from_numpy(pts), RES, CAP)
    assert not bool(tg.mask.all())
    return (jg, None), (tg, None), J_POOL(jg, CAP), \
        tgrid.pool_geom(tg, CAP)


def _assert_same_map(t, j):
    hit = np.asarray(j.hit)
    np.testing.assert_array_equal(t.hit.numpy(), hit)
    np.testing.assert_array_equal(t.idx.numpy()[hit], np.asarray(j.idx)[hit])


@pytest.mark.parametrize("ks", [3, 2])
@pytest.mark.parametrize("stride", [1, 2])
def test_cube_offsets(ks, stride):
    got = tgrid.cube_offsets(ks, stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jgrid.cube_offsets(ks, stride)))


@pytest.mark.parametrize("case", ["stride 1", "stride 2", "down"])
def test_build_kernel_map(geoms, case):
    """Masked rows and queries past the packable range find nothing on
    both sides."""
    (jg, _), (tg, _), (jp, _), (tp, _) = geoms
    (ja, jb, ta, tb, ks, s) = {
        "stride 1": (jg, jg, tg, tg, 3, 1),
        "stride 2": (jp, jp, tp, tp, 3, 2),
        "down": (jg, jp, tg, tp, 2, 1)}[case]
    ref = J_KMAP(ja, jb, jgrid.cube_offsets(ks, s))
    got = tgrid.build_kernel_map(ta, tb, tgrid.cube_offsets(ks, s))
    assert got.idx.dtype == torch.int32 and got.hit.dtype == torch.bool
    _assert_same_map(got, ref)
    # the case is exercised: valid rows whose queries leave the range (the
    # down map's taps, from the parent's corner, never do)
    off = tgrid.cube_offsets(ks, s)
    _, q_valid = tkeys.pack(tb.coords[:, None, 0].expand(-1, off.shape[0]),
                            tb.coords[:, None, 1:] + off[None])
    assert bool((tb.mask[:, None] & ~q_valid).any()) == (ks == 3)


@pytest.mark.parametrize("out_cap,level", [(CAP, 0), (120, 0), (60, 1)])
def test_down_kmap_from_pooling(geoms, out_cap, level):
    """Capacity overflow (120 and 60 parents drop children) and negative
    coordinates (the blobs straddle 0), from stride 1 and stride 2;
    idx and hit equal in full."""
    (jg, _), (tg, _) = geoms[2 * level:2 * level + 2]
    assert int(tg.coords[tg.mask][:, 1:].min()) < 0
    jp, jc2p = J_POOL(jg, out_cap)
    tp, tc2p = tgrid.pool_geom(tg, out_cap)
    ref = J_DOWN(jg, jc2p, out_cap)
    got = tgrid.down_kmap_from_pooling(tg, tc2p, out_cap)
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    assert (int(tp.num_raw) > out_cap) == (out_cap < CAP)
    # and the search builder's map over the same levels
    _assert_same_map(got, J_KMAP(
        jg, jp, jgrid.cube_offsets(2, jg.stride)))


@pytest.mark.parametrize("level", [0, 1])
def test_column_map_dense_view(geoms, level):
    (jg, _), (tg, _) = geoms[2 * level:2 * level + 2]
    ref = J_KMAP3(jg)
    got = tgrid.build_kmap3_columns(tg)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))


def test_pyramid_leaves_down_kmap_none():
    pts = torch.from_numpy(_points(2))
    pyr = tgrid.build_pyramid(pts, RES, [CAP] * 3, 3)
    assert all(l.down_kmap is None for l in pyr.levels)


def _conv_inputs(seed, V, mask, G, cin, cout, taps=27):
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 1, (V, G * cin)).astype(np.float32)
    f = np.where(np.asarray(mask)[:, None], f, 0).astype(np.float32)
    w = rng.normal(0, 0.3, (taps, cin, cout)).astype(np.float32)
    b = rng.normal(0, 0.5, (cout,)).astype(np.float32)
    cot = rng.normal(0, 1, (V, G * cout)).astype(np.float32)
    return f, w, b, cot


@pytest.fixture(scope="module")
def maps(geoms):
    """{kind: (JAX map, port map, JAX out mask, port out mask, the input's
    mask as numpy, taps)} for the 27-tap map of level 0 and the down map
    from level 0 to level 1."""
    (jg, _), (tg, _), (jp, jc2p), (tp, tc2p) = geoms
    return {
        "27 taps": (J_KMAP(jg, jg, jgrid.cube_offsets(3, 1)),
                    tgrid.build_kernel_map(tg, tg, tgrid.cube_offsets(3, 1)),
                    jg.mask, tg.mask, tg.mask.numpy(), 27),
        "down": (J_DOWN(jg, jc2p, CAP),
                 tgrid.down_kmap_from_pooling(tg, tc2p, CAP), jp.mask,
                 tp.mask, tg.mask.numpy(), 8)}


@pytest.mark.parametrize("kind", ["27 taps", "down"])
@pytest.mark.parametrize("fused,G", [(False, 1), (True, 1), (False, 2),
                                     (True, 2)])
def test_gather_conv_and_grads(maps, kind, fused, G):
    """Forward with bias and ReLU, and the feats and weight gradients of
    sum(out * cot) against jax.grad. fused with G=2 runs per tap, as in
    the JAX package."""
    jm, tm, jmask, tmask, in_mask, taps = maps[kind]
    f, w, b, cot = _conv_inputs(taps + G, CAP, in_mask, G, 5, 4, taps)

    def jloss(f_, w_):
        out = jsc.sparse_conv(f_, jm, w_, jmask, fused=fused, groups=G,
                              bias=jnp.asarray(b), relu=True)
        return jnp.sum(out * cot), out

    (_, ref), (jdf, jdw) = jax.value_and_grad(jloss, argnums=(0, 1),
                                              has_aux=True)(
        jnp.asarray(f), jnp.asarray(w))
    tf = torch.from_numpy(f).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = tsc.sparse_conv(tf, tm, tw, tmask, fused=fused, groups=G,
                          bias=torch.from_numpy(b), relu=True)
    (out * torch.from_numpy(cot)).sum().backward()
    assert out.dtype == torch.float32
    assert bool((out[~tmask] == 0).all())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jdf), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **TOL)


@pytest.mark.parametrize("feats_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True])
def test_gather_conv_bf16(maps, feats_dtype, fused):
    """bf16 compute against the JAX package under
    set_compute_dtype("bfloat16"). float32 feats: the bf16 products are
    exact in float32 on both sides, so the float32 tolerance holds. bf16
    feats: within BF16_BOUND."""
    jm, tm, jmask, tmask, in_mask, taps = maps["27 taps"]
    f, w, b, _ = _conv_inputs(7, CAP, in_mask, 1, 16, 8)
    jdt = jnp.bfloat16 if feats_dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, feats_dtype)
    old = jsc.COMPUTE_DTYPE
    jsc.set_compute_dtype("bfloat16")
    try:
        ref = jsc.sparse_conv(jnp.asarray(f).astype(jdt), jm,
                              jnp.asarray(w), jmask, fused=fused,
                              bias=jnp.asarray(b), relu=True)
    finally:
        jsc.COMPUTE_DTYPE = old
    got = tsc.sparse_conv(torch.from_numpy(f).to(tdt), tm,
                          torch.from_numpy(w), tmask, fused=fused,
                          bias=torch.from_numpy(b), relu=True,
                          compute_dtype=torch.bfloat16)
    assert got.dtype == tdt
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    if feats_dtype == "float32":
        np.testing.assert_allclose(got, ref, **TOL)
        return
    # A from the bf16-rounded inputs, the bound of the module docstring
    fb = torch.from_numpy(f).bfloat16().float().abs()
    wb = torch.from_numpy(w).bfloat16().float().abs()
    idx = tm.idx.long()
    A = sum(torch.where(tm.hit[:, k, None], fb[idx[:, k]], 0.0) @ wb[k]
            for k in range(taps)) + torch.from_numpy(b).abs()
    bound = 2 * (taps + 2) * BF16_U * A.numpy()
    assert (np.abs(got - ref) <= bound).all()


def _pyramid(seed):
    pts = torch.from_numpy(_points(seed))
    return tgrid.build_pyramid(pts, RES, [CAP, CAP], 2)


def test_dispatch_column_and_down_maps():
    pyr = _pyramid(5)
    l0, l1 = pyr.levels
    f, w, b, _ = _conv_inputs(5, CAP, l0.geom.mask.numpy(), 2, 6, 3)
    f, w, b = (torch.from_numpy(a) for a in (f, w, b))
    kw = dict(groups=2, bias=b, relu=True)
    assert torch.equal(
        tsc.sparse_conv(f, l0.kmap3, w, l0.geom.mask, **kw),
        tsc.sparse_conv_columns(f, l0.kmap3, w, l0.geom.mask, **kw))
    down = tgrid.DownMap(l0.parent_idx, l0.up_tap)
    assert torch.equal(
        tsc.sparse_conv(f, down, w[:8], l1.geom.mask, **kw),
        tsc.sparse_conv_down(f, l0.parent_idx, l0.up_tap, w[:8],
                             l1.geom.mask, **kw))
    with pytest.raises(TypeError):
        tsc.sparse_conv(f, object(), w, l0.geom.mask)


def test_global_pool():
    rng = np.random.default_rng(6)
    f = rng.normal(0, 1, (50, 7)).astype(np.float32)
    m = rng.random(50) < 0.6
    ref = jsc.global_pool(jnp.asarray(f), jnp.asarray(m))
    got = tsc.global_pool(torch.from_numpy(f), torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    empty = tsc.global_pool(torch.from_numpy(f), torch.zeros(50, dtype=bool))
    assert bool((empty == 0).all())


def test_sparse_conv_module_over_kernel_map(geoms):
    tg = geoms[1][0]
    km = tgrid.build_kernel_map(tg, tg, tgrid.cube_offsets(3, 1))
    conv = SparseConv(4, 6)
    torch.nn.init.normal_(conv.kernel)
    f = torch.from_numpy(_conv_inputs(8, CAP, tg.mask.numpy(), 1, 4, 6)[0])
    scale = torch.linspace(0.5, 1.5, 6)
    bias = torch.linspace(-0.2, 0.2, 6)
    got = conv(f, km, tg.mask, 1, w_scale=scale, bias=bias, relu=True)
    want = tsc.sparse_conv(f, km, conv.kernel * scale, tg.mask, bias=bias,
                           relu=True)
    assert torch.equal(got, want)


INF = float("inf")


def test_transpose_masks_rows_over_non_finite_values():
    """Invalid fine voxels read the clamped coarse row V_c - 1, here inf:
    the mask gives 0 there, as JAX's jnp.where does."""
    cf = np.array([[1, 1], [1, 1], [INF, INF]], np.float32)
    w = np.ones((8, 2, 2), np.float32)
    parent = np.array([0, 1, 3, 3], np.int32)
    tap = np.array([0, 1, 2, 3], np.int32)
    fine = np.array([True, True, False, False])
    ref = jsc.sparse_conv_transpose(*(jnp.asarray(a) for a in
                                      (cf, parent, tap, w, fine)))
    got = tsc.sparse_conv_transpose(*(torch.from_numpy(a) for a in
                                      (cf, parent, tap, w, fine)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy()[2:], 0)


def test_down_masks_rows_over_non_finite_values():
    f = np.array([[1, 1], [INF, INF]], np.float32)
    w = np.ones((8, 2, 2), np.float32)
    parent = np.array([0, 1], np.int32)
    tap = np.array([0, 0], np.int32)
    out_mask = np.array([True, False])
    ref = jsc.sparse_conv_down(*(jnp.asarray(a) for a in
                                 (f, parent, tap, w, out_mask)))
    got = tsc.sparse_conv_down(*(torch.from_numpy(a) for a in
                                 (f, parent, tap, w, out_mask)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy()[1], 0)


@pytest.fixture(scope="module")
def tiny_sampling():
    """A port-only 4-step task and its `sample` output."""
    cfg = {**CFG, "diff": {**CFG["diff"], "s_steps": 4}}
    task = DiffusionTask(finalize_config(cfg), device="cpu", seed=3)
    part = torch.from_numpy(ring_scan(np.random.default_rng(12), NP))
    x_init = part.repeat(1, TILE, 1)
    ref = task.sample(x_init, part, torch.Generator().manual_seed(4))
    return task, x_init, part, ref


@pytest.mark.parametrize("chunk", [1, 3, 4])
def test_sample_chunked_equals_sample(tiny_sampling, chunk):
    """Bit for bit at 4 steps; chunk 3 runs a last chunk with two steps
    past the end, which draw their noise and change nothing. At chunk 3
    also through the (prepare, run_chunk, finish) triple."""
    task, x_init, part, ref = tiny_sampling
    assert task.solver.num_steps == 4 and bool(torch.isfinite(ref).all())
    got = task.sample_chunked(x_init, part, torch.Generator().manual_seed(4),
                              chunk=chunk)
    assert torch.equal(got, ref)
    if chunk != 3:
        return
    prepare, run_chunk, finish, n = task.make_chunked_sampler(chunk=chunk)
    assert n == 4
    ctx = prepare(x_init, part, torch.Generator().manual_seed(4))
    for i0 in range(0, n, chunk):
        ctx = run_chunk(ctx, i0)
    assert torch.equal(finish(ctx), ref)


def test_enable_compile_cache(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(cuda_native, "BUILD_DIR", cuda_native.BUILD_DIR)
    monkeypatch.setattr(host_native, "BUILD_DIR", host_native.BUILD_DIR)
    cache = tmp_path / "kernels"
    assert enable_compile_cache(str(cache))
    assert os.path.dirname(host_native.library_path()) == str(cache)
    assert os.path.dirname(cuda_native._lib_path("conv3_columns")) == \
        str(cache)
    assert os.listdir(cache) == []
    blocker = tmp_path / "a file"
    blocker.write_text("")
    assert not enable_compile_cache(str(blocker / "kernels"))
    assert len(capsys.readouterr().err.strip().splitlines()) == 1
    assert cuda_native.BUILD_DIR == host_native.BUILD_DIR == str(cache)
