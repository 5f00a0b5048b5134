"""Parity of the port's differentiable column conv (kernel A2's backward
rule and kernel A3's plain version), `masked_moments` and train-mode
`MaskedBatchNorm` with the JAX package, float32 on the CPU.

The JAX side is `jax.grad` of the XLA conv, and the Pallas kernels
(`conv_columns_pallas_ad`, `conv_columns_pallas_dw_v2`, and the legacy
`conv_columns_pallas` / `conv_columns_pallas_dw`) in interpret mode, as
tests/test_pallas_conv.py runs them.

Tolerances: gradients atol 2e-4 (5e-4 at C > 128) on values of order 1-30,
the bounds tests/test_pallas_conv.py holds the Pallas kernels to: every side
sums the same float32 products in another order (per-column GEMMs, one
accumulator over 27 taps, a sum over all rows). Forward and BatchNorm
outputs atol 1e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidiff_tpu.models import blocks as jblocks
from lidiff_tpu.ops import grid as jgrid
from lidiff_tpu.ops import sparse_conv as jsc
from lidiff_tpu.ops.pallas_conv import (conv_columns_pallas,
                                        conv_columns_pallas_ad,
                                        conv_columns_pallas_dw,
                                        conv_columns_pallas_dw_v2)
from lidiff_tpu_torch.models import blocks as tblocks
from lidiff_tpu_torch.ops import grid as tgrid
from lidiff_tpu_torch.ops import sparse_conv as tsc

CAPS = [1280, 896, 640, 512, 384]
# a second pyramid whose coarse levels overflow: dropped voxels are in
# neither role of the map, so the flipped-conv rule stays exact there
CAPS_OVF = [1024, 512, 256, 128, 64]


def _pyramids(pts, caps):
    j = jax.jit(functools.partial(jgrid.build_pyramid, resolution=0.25,
                                  capacities=caps, num_levels=5))(
        jnp.asarray(pts))
    t = tgrid.build_pyramid(torch.from_numpy(pts), 0.25, caps, 5)
    return j, t


@pytest.fixture(scope="module")
def pyramids():
    rng = np.random.default_rng(0)
    return _pyramids(rng.normal(0, 4, (1, 1600, 3)).astype(np.float32), CAPS)


@pytest.fixture(scope="module")
def pyramids_ovf():
    rng = np.random.default_rng(1)
    return _pyramids(rng.normal(0, 2.0, (2, 500, 3)).astype(np.float32),
                     CAPS_OVF)


def _inputs(seed, mask, G, cin, cout):
    rng = np.random.default_rng(seed)
    mask = np.asarray(mask)
    V = mask.shape[0]
    f = rng.normal(0, 1, (V, G * cin)).astype(np.float32)
    f[~mask] = 0.0
    w = rng.normal(0, 0.1, (27, cin, cout)).astype(np.float32)
    cot = rng.normal(0, 1, (V, G * cout)).astype(np.float32)  # masked rows too
    return f, w, cot


def _function_grads(tl, f, w, cot, G):
    ff = torch.from_numpy(f).requires_grad_(True)
    ww = torch.from_numpy(w).requires_grad_(True)
    out = tsc.sparse_conv_columns(ff, tl.kmap3, ww, tl.geom.mask, groups=G)
    assert type(out.grad_fn).__name__.startswith("Conv3ColumnsFunction")
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), ff.grad.numpy(), ww.grad.numpy()


@pytest.mark.parametrize("level,G,cin,cout,atol", [
    (0, 1, 16, 24, 2e-4), (2, 2, 5, 4, 2e-4), (3, 2, 136, 8, 5e-4)])
def test_function_grads_match_jax_grad(pyramids, level, G, cin, cout, atol):
    """(a) df and dW of the Function against jax.grad of the XLA conv."""
    j, t = pyramids
    jl, tl = j.levels[level], t.levels[level]
    f, w, cot = _inputs(40 + level, jl.geom.mask, G, cin, cout)

    def loss(ff, ww):
        out = jsc.sparse_conv_columns(ff, jl.kmap3, ww, jl.geom.mask,
                                      groups=G, allow_pallas=False)
        return jnp.sum(out * cot), out

    (_, ref_out), (df_x, dw_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(f), jnp.asarray(w))
    out, df, dw = _function_grads(tl, f, w, cot, G)
    np.testing.assert_allclose(out, np.asarray(ref_out), rtol=0, atol=1e-5)
    np.testing.assert_allclose(df, np.asarray(df_x), rtol=0, atol=atol)
    np.testing.assert_allclose(dw, np.asarray(dw_x), rtol=0, atol=atol)
    assert np.abs(dw).max() > 1.0 and np.abs(df).max() > 0.1


@pytest.mark.parametrize("level,G,cin,cout", [(0, 1, 16, 24), (1, 2, 5, 4),
                                              (2, 2, 136, 8), (4, 1, 8, 8)])
def test_function_rule_equals_autograd_of_plain(pyramids_ovf, level, G, cin,
                                                cout):
    """(a) The flipped-conv rule against torch autograd of the plain conv,
    on a pyramid whose coarse levels overflowed their capacity: the map of
    one level over itself is symmetric, so the two agree."""
    _, t = pyramids_ovf
    tl = t.levels[level]
    if level in (1, 2):
        assert int(tl.geom.overflow) > 0
    f, w, cot = _inputs(level, tl.geom.mask, G, cin, cout)
    _, df, dw = _function_grads(tl, f, w, cot, G)
    ff = torch.from_numpy(f).requires_grad_(True)
    ww = torch.from_numpy(w).requires_grad_(True)
    out = tsc.conv3_columns_plain(ff, tl.kmap3.col_idx, tl.kmap3.hit, ww,
                                  tl.geom.mask, G)
    df_a, dw_a = torch.autograd.grad(out, (ff, ww), torch.from_numpy(cot))
    np.testing.assert_allclose(df, df_a.numpy(), rtol=0, atol=2e-4)
    np.testing.assert_allclose(dw, dw_a.numpy(), rtol=0, atol=5e-4)


def test_function_matches_pallas_ad_interpret(pyramids):
    """(b) Forward, df and dW against conv_columns_pallas_ad in interpret
    mode (kernel A2 as the TPU runs it)."""
    j, t = pyramids
    jl, tl = j.levels[0], t.levels[0]
    f, w, cot = _inputs(7, jl.geom.mask, 1, 16, 24)

    def loss(ff, ww):
        out = conv_columns_pallas_ad(1, 4, True, ff, ww, jl.kmap3.col_idx,
                                     jl.kmap3.hit, jl.geom.mask)
        return jnp.sum(out * cot), out

    (_, ref_out), (df_p, dw_p) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(f), jnp.asarray(w))
    out, df, dw = _function_grads(tl, f, w, cot, 1)
    np.testing.assert_allclose(out, np.asarray(ref_out), rtol=0, atol=1e-5)
    np.testing.assert_allclose(df, np.asarray(df_p), rtol=0, atol=2e-4)
    np.testing.assert_allclose(dw, np.asarray(dw_p), rtol=0, atol=2e-4)


@pytest.mark.parametrize("kernel", ["dw_v2", "dw_legacy"])
@pytest.mark.parametrize("G,cin,cout", [(1, 16, 24), (2, 8, 16)])
def test_dw_plain_matches_pallas_dw_interpret(pyramids, kernel, G, cin, cout):
    """(b) A3's plain version against conv_columns_pallas_dw_v2 and the
    legacy conv_columns_pallas_dw (kernel A0dw), both in interpret mode."""
    j, t = pyramids
    jl, tl = j.levels[0], t.levels[0]
    f, _, cot = _inputs(11 + G, jl.geom.mask, G, cin, cout)
    fn = conv_columns_pallas_dw_v2 if kernel == "dw_v2" \
        else conv_columns_pallas_dw
    ref = fn(jnp.asarray(f), jnp.asarray(cot), jl.kmap3.col_idx,
             jl.kmap3.hit, jl.geom.mask, groups=G, interpret=True)
    got = tsc.conv3_columns_dw(torch.from_numpy(f), torch.from_numpy(cot),
                               tl.kmap3.col_idx, tl.kmap3.hit, tl.geom.mask,
                               G)
    assert got.dtype == torch.float32 and got.shape == (27, cin, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-4)
    assert np.abs(np.asarray(ref)).max() > 1.0


@pytest.mark.parametrize("G,cin,cout", [(1, 16, 24), (2, 8, 16)])
def test_conv_plain_matches_legacy_pallas_interpret(pyramids, G, cin, cout):
    """(b) A1's plain version against the legacy conv_columns_pallas
    (kernel A0) in interpret mode."""
    j, t = pyramids
    jl, tl = j.levels[0], t.levels[0]
    f, w, _ = _inputs(21 + G, jl.geom.mask, G, cin, cout)
    ref, ov = conv_columns_pallas(jnp.asarray(f), jl.kmap3.col_idx,
                                  jl.kmap3.hit, jnp.asarray(w), jl.geom.mask,
                                  groups=G, interpret=True)
    assert int(ov) == 0
    got = tsc.conv3_columns_plain(torch.from_numpy(f), tl.kmap3.col_idx,
                                  tl.kmap3.hit, torch.from_numpy(w),
                                  tl.geom.mask, G)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_function_skips_df_and_rejects_epilogue(pyramids):
    _, t = pyramids
    tl = t.levels[0]
    f, w, cot = _inputs(3, tl.geom.mask, 1, 3, 8)
    ff = torch.from_numpy(f)                    # the stem's input: no grad
    ww = torch.from_numpy(w).requires_grad_(True)
    out = tsc.sparse_conv_columns(ff, tl.kmap3, ww, tl.geom.mask)
    out.backward(torch.from_numpy(cot))
    assert ff.grad is None and ww.grad is not None
    with pytest.raises(ValueError):
        tsc.sparse_conv_columns(ff, tl.kmap3, ww, tl.geom.mask, relu=True)
    with torch.no_grad():                       # eval: the epilogue is fine
        tsc.sparse_conv_columns(ff, tl.kmap3, ww, tl.geom.mask, relu=True)


def test_bf16_backward_rounding_points(pyramids):
    """bf16 compute: the cotangent is cast to bf16 before both backward
    products, dW is rounded to bf16 before it reaches the float32
    parameter, and df is bf16. Held to the same rule written out with the
    plain versions: exact equality."""
    _, t = pyramids
    tl = t.levels[2]
    km, mask = tl.kmap3, tl.geom.mask
    f, w, cot = _inputs(5, mask, 1, 16, 24)
    ff = torch.from_numpy(f).requires_grad_(True)
    ww = torch.from_numpy(w).requires_grad_(True)
    out = tsc.sparse_conv_columns(ff, km, ww, mask,
                                  compute_dtype=torch.bfloat16)
    assert out.dtype == torch.float32
    out.backward(torch.from_numpy(cot))
    fb, wb = ff.detach().bfloat16(), ww.detach().bfloat16()
    g = torch.where(mask[:, None], torch.from_numpy(cot), 0.0).bfloat16()
    df = tsc.conv3_columns_plain(g, km.col_idx, km.hit,
                                 wb.flip(0).transpose(1, 2).contiguous(),
                                 mask, 1)
    dw = tsc.conv3_columns_dw_plain(fb, g, km.col_idx, km.hit, mask, 1)
    assert df.dtype == torch.bfloat16
    assert torch.equal(ff.grad, df.float())
    assert torch.equal(ww.grad, dw.bfloat16().float())


# ---------------------------------------------------------------------------
# (c) masked_moments and train-mode MaskedBatchNorm
# ---------------------------------------------------------------------------

def _bn_inputs(seed, V=700, C=12, n_valid=450):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 2.0, (V, C)).astype(np.float32)
    mask = np.arange(V) < n_valid
    x[~mask] = 0.0
    return x, mask


@pytest.mark.parametrize("n_valid", [450, 1, 0])
def test_masked_moments(n_valid):
    x, mask = _bn_inputs(0, n_valid=n_valid)
    jm, jv, jc = jsc.masked_moments(jnp.asarray(x), jnp.asarray(mask))
    tm, tv, tc = tsc.masked_moments(torch.from_numpy(x),
                                    torch.from_numpy(mask))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    assert float(tc) == float(jc) == max(n_valid, 1)


def test_masked_batchnorm_train_mode():
    """Output, gradients of input, scale and bias, and the running
    statistics after two train-mode calls, against the flax module."""
    rng = np.random.default_rng(2)
    C = 12
    scale = (1.0 + 0.1 * rng.normal(size=C)).astype(np.float32)
    bias = (0.1 * rng.normal(size=C)).astype(np.float32)
    mean0 = (0.1 * rng.normal(size=C)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, C).astype(np.float32)
    jbn = jblocks.MaskedBatchNorm()
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}
    tbn = tblocks.MaskedBatchNorm(C)
    with torch.no_grad():
        tbn.scale.copy_(torch.from_numpy(scale))
        tbn.bias.copy_(torch.from_numpy(bias))
        tbn.mean.copy_(torch.from_numpy(mean0))
        tbn.var.copy_(torch.from_numpy(var0))
    tbn.train()
    for call in range(2):
        x, mask = _bn_inputs(10 + call)
        cot = rng.normal(size=x.shape).astype(np.float32)

        def loss(p, xx):
            y, mut = jbn.apply({"params": p, "batch_stats": stats}, xx,
                               jnp.asarray(mask), True,
                               mutable=["batch_stats"])
            return jnp.sum(y * cot), (y, mut["batch_stats"])

        (_, (jy, stats)), (jgp, jgx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
        tx = torch.from_numpy(x).requires_grad_(True)
        ty = tbn(tx, torch.from_numpy(mask), 1)
        tbn.zero_grad()
        ty.backward(torch.from_numpy(cot))
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(tbn.scale.grad.numpy(),
                                   np.asarray(jgp["scale"]), rtol=1e-5,
                                   atol=1e-3)
        np.testing.assert_allclose(tbn.bias.grad.numpy(),
                                   np.asarray(jgp["bias"]), rtol=1e-5,
                                   atol=1e-3)
        np.testing.assert_allclose(tbn.mean.numpy(), np.asarray(stats["mean"]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(tbn.var.numpy(), np.asarray(stats["var"]),
                                   rtol=1e-6, atol=1e-6)
    assert not np.allclose(tbn.mean.numpy(), mean0)


def test_masked_batchnorm_grouped_train_raises_and_eval_keeps_stats():
    tbn = tblocks.MaskedBatchNorm(4)
    x = torch.randn(10, 8, generator=torch.Generator().manual_seed(0))
    mask = torch.ones(10, dtype=torch.bool)
    tbn.train()
    with pytest.raises(ValueError):
        tbn(x, mask, 2)
    tbn.eval()
    tbn(x, mask, 2)
    assert torch.equal(tbn.mean, torch.zeros(4))
    assert torch.equal(tbn.var, torch.ones(4))
