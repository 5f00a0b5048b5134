"""Parity of the PyTorch port's sparse convs with the JAX package: the
27-tap column conv (plain version of kernel A1), the child-form down conv
and the transpose conv, G=1 and G=2, with and without the bias/ReLU
epilogue.

Tolerance in float32: rtol 1e-5, atol 1e-5. Both sides sum the same
products in float32, in other orders (per-column GEMMs vs one float32
accumulator, GEMM blocking, scatter-add)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidiff_tpu.ops import grid as jgrid
from lidiff_tpu.ops import sparse_conv as jsc
from lidiff_tpu_torch.ops import grid as tgrid
from lidiff_tpu_torch.ops import sparse_conv as tsc

TOL = dict(rtol=1e-5, atol=1e-5)
CAPS = [1024, 512, 256, 128, 64]      # level 1 and up overflow a little


@pytest.fixture(scope="module")
def pyramids():
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 2.0, (2, 500, 3)).astype(np.float32)
    j = jax.jit(functools.partial(jgrid.build_pyramid, resolution=0.25,
                                  capacities=CAPS, num_levels=5))(
        jnp.asarray(pts))
    t = tgrid.build_pyramid(torch.from_numpy(pts), 0.25, CAPS, 5)
    return j, t


def _inputs(seed, V, mask, G, cin, cout):
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 1, (V, G * cin)).astype(np.float32)
    f = np.where(np.asarray(mask)[:, None], f, 0).astype(np.float32)
    w = rng.normal(0, 0.3, (27, cin, cout)).astype(np.float32)
    b = rng.normal(0, 0.5, (cout,)).astype(np.float32)
    return f, w, b


@pytest.mark.parametrize("level", [0, 2])
@pytest.mark.parametrize("G,cin,cout", [(1, 3, 8), (2, 5, 4), (2, 16, 24)])
@pytest.mark.parametrize("epilogue", [False, True])
def test_column_conv(pyramids, level, G, cin, cout, epilogue):
    j, t = pyramids
    jl, tl = j.levels[level], t.levels[level]
    f, w, b = _inputs(level * 7 + cin, jl.geom.capacity, jl.geom.mask, G,
                      cin, cout)
    kw = dict(bias=b, relu=True) if epilogue else {}
    ref = jsc.sparse_conv_columns(
        jnp.asarray(f), jgrid.build_kmap3_columns(jl.geom), jnp.asarray(w),
        jl.geom.mask, groups=G,
        **{k: (jnp.asarray(v) if k == "bias" else v) for k, v in kw.items()})
    got = tsc.sparse_conv_columns(
        torch.from_numpy(f), tl.kmap3, torch.from_numpy(w), tl.geom.mask,
        groups=G,
        **{k: (torch.from_numpy(v) if k == "bias" else v)
           for k, v in kw.items()})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("G,cin,cout", [(1, 3, 8), (2, 5, 4)])
def test_down_conv(pyramids, G, cin, cout):
    j, t = pyramids
    f, w, b = _inputs(cin, CAPS[0], j.levels[0].geom.mask, G, cin, cout)
    w = w[:8]
    jl, tl = j.levels[0], t.levels[0]
    ref = jsc.sparse_conv_down(jnp.asarray(f), jl.parent_idx, jl.up_tap,
                               jnp.asarray(w), j.levels[1].geom.mask,
                               groups=G, bias=jnp.asarray(b), relu=True)
    got = tsc.sparse_conv_down(torch.from_numpy(f), tl.parent_idx, tl.up_tap,
                               torch.from_numpy(w), t.levels[1].geom.mask,
                               groups=G, bias=torch.from_numpy(b), relu=True)
    assert int(t.levels[1].geom.overflow) > 0    # dropped parents covered
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_down_conv_bf16():
    """bf16 compute: the selected products are cast to bf16 before the
    scatter-add, on both sides (lidiff_tpu sparse_conv.py:363-369). The
    products' f32 sums round once to bf16, then <= 8 children add in bf16:
    tolerance 2^-6 of the output scale (a few bf16 ulps)."""
    rng = np.random.default_rng(4)
    pts = rng.normal(0, 2.0, (2, 500, 3)).astype(np.float32)
    jg, _, _ = jgrid.quantize(jnp.asarray(pts), 0.25, 1024)
    jp, jc2p = jgrid.pool_geom(jg, 512)
    tg, _, _ = tgrid.quantize(torch.from_numpy(pts), 0.25, 1024)
    tp, tc2p = tgrid.pool_geom(tg, 512)
    f, w, b = _inputs(9, 1024, jg.mask, 2, 16, 16)
    w = w[:8]
    _, jtap = jgrid.up_maps(jg, jc2p)
    _, ttap = tgrid.up_maps(tg, tc2p)
    jsc.set_compute_dtype("bfloat16")
    try:
        ref = np.asarray(jsc.sparse_conv_down(
            jnp.asarray(f), jc2p, jtap, jnp.asarray(w), jp.mask, groups=2,
            bias=jnp.asarray(b), relu=True))
    finally:
        jsc.set_compute_dtype("float32")
    got = tsc.sparse_conv_down(torch.from_numpy(f), tc2p, ttap,
                               torch.from_numpy(w), tp.mask, groups=2,
                               bias=torch.from_numpy(b), relu=True,
                               compute_dtype=torch.bfloat16).numpy()
    assert np.abs(got - ref).max() <= 2 ** -6 * np.abs(ref).max()


@pytest.mark.parametrize("G,cin,cout", [(1, 4, 8), (2, 6, 5)])
def test_transpose_conv(pyramids, G, cin, cout):
    j, t = pyramids
    jc, tc = j.levels[2], t.levels[2]
    jf, tf = j.levels[1], t.levels[1]
    f, w, _ = _inputs(cin + 1, CAPS[2], jc.geom.mask, G, cin, cout)
    w = w[:8]
    ref = jsc.sparse_conv_transpose(jnp.asarray(f), jf.parent_idx, jf.up_tap,
                                    jnp.asarray(w), jf.geom.mask, groups=G)
    got = tsc.sparse_conv_transpose(torch.from_numpy(f), tf.parent_idx,
                                    tf.up_tap, torch.from_numpy(w),
                                    tf.geom.mask, groups=G)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("G,cin,cout", [(1, 4, 8), (2, 6, 5)])
def test_transpose_conv_gradients(pyramids, G, cin, cout):
    """The CPU path's gradients (coarse feats, weights) against jax.vjp of
    the JAX package's transpose conv, float32, on levels whose coarse level
    overflows (fine rows with parent_idx == capacity). Both sum the same
    products in other orders: rtol 1e-5, atol 1e-5 of the largest."""
    j, t = pyramids
    jc, tc = j.levels[2], t.levels[2]
    jf, tf = j.levels[1], t.levels[1]
    assert int(tc.geom.overflow) > 0 and bool((tf.parent_idx
                                               == CAPS[2]).any())
    f, w, _ = _inputs(cin + 2, CAPS[2], jc.geom.mask, G, cin, cout)
    w = w[:8]
    g = np.random.default_rng(cin).normal(
        0, 1, (CAPS[1], G * cout)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jsc.sparse_conv_transpose(
        a, jf.parent_idx, jf.up_tap, b, jf.geom.mask, groups=G),
        jnp.asarray(f), jnp.asarray(w))
    ref_df, ref_dw = (np.asarray(r) for r in vjp(jnp.asarray(g)))
    tf_, tw = (torch.from_numpy(a).requires_grad_() for a in (f, w))
    tsc.sparse_conv_transpose(tf_, tf.parent_idx, tf.up_tap, tw,
                              tf.geom.mask, groups=G).backward(
        torch.from_numpy(g))
    for got, ref in ((tf_.grad, ref_df), (tw.grad, ref_dw)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_up_maps_give_ok_rows_distinct_slots(pyramids, level):
    """The precondition of the transpose gather's card kernels: on a
    pyramid of two items whose levels 1 and up overflow (level 0 holds
    padding rows, level 1 children of dropped parents), the rows with
    parent_idx < Vc (and the fine mask) have pairwise distinct slots
    parent_idx * 8 + tap, so its backward's plain stores never collide."""
    _, t = pyramids
    fine, coarse = t.levels[level], t.levels[level + 1].geom
    ok = (fine.parent_idx < coarse.capacity) & fine.geom.mask
    slots = fine.parent_idx[ok].long() * 8 + fine.up_tap[ok].long()
    assert int(ok.sum()) > 0
    assert slots.unique().numel() == slots.numel()
    assert bool(((fine.up_tap >= 0) & (fine.up_tap < 8))[ok].all())
    if level == 0:     # padding rows
        assert bool((~fine.geom.mask).any())
    if level == 1:     # children of dropped parents: valid, not ok
        assert bool((fine.geom.mask & ~ok).any())


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("G,y_dtype,out_dtype", [
    (1, torch.bfloat16, torch.float32), (2, torch.bfloat16, torch.bfloat16),
    (1, torch.float32, torch.float32), (2, torch.float32, torch.bfloat16)])
def test_transpose_gather_plain_is_a_slot_copy(pyramids, G, y_dtype,
                                               out_dtype):
    """What the card kernels compute, held against the plain version on
    the CPU bit for bit: the output is y's ok slot widened or rounded once
    to the output dtype and +0 elsewhere; the gradient of y is +0 in every
    slot but the ok rows', which hold 0 + the row's cotangent rounded once
    to y's dtype. Rows that are not ok carry NaN cotangents, which must not
    reach the gradient. CPU tensors launch no kernel."""
    _, t = pyramids
    fine, Vc, cout = t.levels[1], CAPS[2], 12
    ok = (fine.parent_idx < Vc) & fine.geom.mask
    gen = torch.Generator().manual_seed(G)
    y = torch.randn(Vc, G, 8, cout, generator=gen).to(y_dtype)
    y[0, 0, 0, 0] = -0.0
    g = torch.randn(CAPS[1], G * cout, generator=gen).to(out_dtype)
    g[~ok] = float("nan")
    g[ok.nonzero()[0, 0], 0] = -0.0
    launches = (tsc._gather_fwd_kernel.launches,
                tsc._scatter_bwd_kernel.launches)
    y.requires_grad_()
    out = tsc.transpose_gather(y, fine.parent_idx, fine.up_tap, ok,
                               out_dtype)
    out.backward(g)
    assert (tsc._gather_fwd_kernel.launches,
            tsc._scatter_bwd_kernel.launches) == launches
    p, tap = fine.parent_idx[ok].long(), fine.up_tap[ok].long()
    want = torch.zeros(CAPS[1], G, cout, dtype=out_dtype)
    want[ok] = y.detach()[p, :, tap].to(out_dtype)
    assert out.dtype == out_dtype
    assert torch.equal(_bits(out), _bits(want.reshape(-1, G * cout)))
    dy = torch.zeros(Vc, G, 8, cout, dtype=torch.float32)
    dy[p, :, tap] = g[ok].float().reshape(-1, G, cout) + 0.0
    assert y.grad.dtype == y_dtype
    assert torch.equal(_bits(y.grad), _bits(dy.to(y_dtype)))
