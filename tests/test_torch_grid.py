"""Bit-exact parity of the PyTorch port's voxel geometry with the JAX
package: keys, quantize, pool_geom, the pyramid and the plain version of
kernel B1 (the 27-tap column kernel map), overflow and out-of-range cases
included. Keys compare as the port's int64 (hi << 32) | lo."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidiff_tpu.ops import grid as jgrid
from lidiff_tpu.ops import keys as jkeys
from lidiff_tpu.ops.pallas_kmap import build_kmap3_columns_pallas
from lidiff_tpu_torch.ops import grid as tgrid
from lidiff_tpu_torch.ops import keys as tkeys

RES = 0.2


def _key64(hi, lo):
    return (np.asarray(hi).astype(np.int64) << 32) | np.asarray(lo)


def _points(seed, B=2, N=600):
    """Gaussian blobs plus points at the coordinate-range edge (x = 2047
    voxels: the +x queries of their kernel map fall out of range) and
    beyond it (dropped as invalid)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 3.0, (B, N, 3)).astype(np.float32)
    pts[:, :4, 0] = 2047 * RES
    pts[:, 4:6, 1] = -2048 * RES
    pts[:, 6:8, 2] = 3000 * RES
    return pts


def _assert_geom_equal(t, j):
    np.testing.assert_array_equal(t.key.numpy(), _key64(j.key_hi, j.key_lo))
    np.testing.assert_array_equal(t.coords.numpy(), np.asarray(j.coords))
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    assert int(t.num) == int(j.num) and int(t.num_raw) == int(j.num_raw)
    assert t.stride == j.stride


def test_keys_pack_unpack_search():
    rng = np.random.default_rng(0)
    b = rng.integers(0, 3, 500).astype(np.int32)
    c = rng.integers(-2100, 2100, (500, 3)).astype(np.int32)
    jh, jl, jv = jkeys.pack(jnp.asarray(b), jnp.asarray(c))
    key, valid = tkeys.pack(torch.from_numpy(b), torch.from_numpy(c))
    np.testing.assert_array_equal(key.numpy(), _key64(jh, jl))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    tb, tc = tkeys.unpack(key[valid])
    np.testing.assert_array_equal(tb.numpy(), b[np.asarray(jv)])
    np.testing.assert_array_equal(tc.numpy(), c[np.asarray(jv)])

    sh, sl = jkeys.lexsort(jh, jl)
    (ks,) = tkeys.lexsort(key)
    np.testing.assert_array_equal(ks.numpy(), _key64(sh, sl))
    qh, ql, _ = jkeys.pack(jnp.asarray(b[::-1].copy()),
                           jnp.asarray(c[::-1] + 1))
    ji, jf = jkeys.searchsorted_pair(sh, sl, qh, ql)
    ti, tf = tkeys.searchsorted_pair(ks, torch.from_numpy(_key64(qh, ql)))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(
        tkeys.pair_less(*(torch.tensor(np.asarray(a))
                          for a in (jh, jl, qh, ql))).numpy(),
        np.asarray(jkeys.pair_less(jh, jl, qh, ql)))


@pytest.mark.parametrize("cap", [2048, 512])     # 512 overflows
def test_quantize(cap):
    pts = _points(1)
    jg, jf, jp = jgrid.quantize(jnp.asarray(pts), RES, cap)
    tg, tf, tp = tgrid.quantize(torch.from_numpy(pts), RES, cap)
    _assert_geom_equal(tg, jg)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # per-voxel means: float32 sums of the same points in the same sorted
    # order on both sides
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6,
                               atol=1e-6)
    assert (int(tg.overflow) > 0) == (cap == 512)


CAPS = {"roomy": [2048, 1536, 1024, 768, 512],
        "overflow": [1024, 1024, 256, 128, 64]}


@pytest.fixture(scope="module", params=sorted(CAPS))
def pyramids(request):
    caps = CAPS[request.param]
    pts = _points(2)
    j = jax.jit(functools.partial(jgrid.build_pyramid, resolution=RES,
                                  capacities=caps, num_levels=5))(
        jnp.asarray(pts))
    t = tgrid.build_pyramid(torch.from_numpy(pts), RES, caps, 5)
    return j, t


def test_pyramid_geometry(pyramids):
    j, t = pyramids
    np.testing.assert_array_equal(t.point2voxel.numpy(),
                                  np.asarray(j.point2voxel))
    np.testing.assert_array_equal(t.overflows().numpy(),
                                  np.asarray(j.overflows()))
    assert not t.window_overflows().any()
    for tl, jl in zip(t.levels, j.levels):
        _assert_geom_equal(tl.geom, jl.geom)
        if jl.parent_idx is not None:
            np.testing.assert_array_equal(tl.parent_idx.numpy(),
                                          np.asarray(jl.parent_idx))
            np.testing.assert_array_equal(tl.up_tap.numpy(),
                                          np.asarray(jl.up_tap))


def test_kmap3_plain_matches_search_builder(pyramids):
    """Plain version of kernel B1 == lidiff_tpu build_kmap3_columns, bit for
    bit on every row (padding rows included)."""
    j, t = pyramids
    for li, (tl, jl) in enumerate(zip(t.levels, j.levels)):
        ref = jgrid.build_kmap3_columns(jl.geom)
        np.testing.assert_array_equal(tl.kmap3.hit.numpy(),
                                      np.asarray(ref.hit), err_msg=f"L{li}")
        np.testing.assert_array_equal(tl.kmap3.col_idx.numpy(),
                                      np.asarray(ref.col_idx),
                                      err_msg=f"L{li}")
        assert int(tl.kmap3.nvalid) == int(jl.geom.num)
    # voxels at the coordinate-range edge exist, so out-of-range queries
    # (masked by q_valid) were part of the comparison
    g0 = t.levels[0].geom
    assert ((g0.coords[:, 1] == 2047) & g0.mask).any()


def test_kmap3_plain_matches_pallas_interpret(pyramids):
    """...and the TPU kernel itself, in interpret mode: hits everywhere,
    col_idx in every column where a tap hits. (In a column with no hit the
    TPU kernel leaves its own window-relative bound, which no conv reads:
    out-of-range queries at the coordinate edge show it.)"""
    j, t = pyramids
    for li in (0, 4):
        got = build_kmap3_columns_pallas(j.levels[li].geom, interpret=True)
        hit = t.levels[li].kmap3.hit.numpy()
        np.testing.assert_array_equal(hit, np.asarray(got.hit))
        col_hit = hit.reshape(-1, 9, 3).any(axis=2)
        np.testing.assert_array_equal(
            t.levels[li].kmap3.col_idx.numpy()[col_hit],
            np.asarray(got.col_idx)[col_hit])
