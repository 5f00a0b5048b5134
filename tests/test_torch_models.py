"""Parity of the PyTorch port's networks with the JAX package: the weight
bridge, the partial-scan encoder and the fused classifier-free denoiser,
on seeded numpy inputs and seeded random weights (float32, CPU).

Tolerance: atol 1e-4 on outputs of order 1. Both sides compute in float32;
sums run in other orders (GEMMs, scatter-adds), which leaves differences of
a few float32 ulps per layer over ~40 layers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidiff_tpu.config import finalize_config as jax_finalize
from lidiff_tpu.models.diffusion import DiffusionModel as JaxModel
from lidiff_tpu.models.diffusion import DiffusionTask as JaxTask
from lidiff_tpu_torch.config import finalize_config
from lidiff_tpu_torch.convert import flax_to_state_dict, load_jax_variables
from lidiff_tpu_torch.models.diffusion import DiffusionTask
from tests.torch_parity_helpers import (B, CFG, NP, TILE, one_thread,
                                        random_variables, ring_scan, to_jax)

ATOL = 1e-4


@pytest.fixture(scope="module")
def tasks():
    jt = JaxTask(jax_finalize(CFG))
    variables = random_variables(jt, seed=3)
    tt = DiffusionTask(finalize_config(CFG), device="cpu")
    load_jax_variables(tt.model, variables)
    return jt, to_jax(variables), tt, variables


@pytest.fixture(scope="module")
def scan():
    rng = np.random.default_rng(7)
    part = ring_scan(rng, NP)
    x = np.tile(part, (1, TILE, 1)) + rng.normal(0, 0.3, (B, NP * TILE, 3))
    return part, x.astype(np.float32)


@pytest.fixture(scope="module")
def banks(tasks, scan):
    jt, jv, tt, _ = tasks
    part = scan[0]
    pyr_c = jax.jit(jt.pyramid_part)(jnp.asarray(part))
    pyr_u = jax.jit(jt.pyramid_part_tiny)(jnp.zeros_like(jnp.asarray(part)))
    enc = jax.jit(lambda v, p: jt.model.apply(
        v, p, False, method=JaxModel.encode_partial))
    j_banks = (enc(jv, pyr_c), pyr_c.levels[-1].geom,
               enc(jv, pyr_u), pyr_u.levels[-1].geom)
    t_banks = tt.encode_banks(torch.from_numpy(part))
    return j_banks, t_banks


def test_bridge_maps_every_key(tasks):
    _, _, tt, variables = tasks
    sd = flax_to_state_dict(variables)
    assert set(sd) == set(tt.model.state_dict())
    k = "denoiser.head.Dense_0.weight"
    np.testing.assert_array_equal(
        sd[k].numpy(), variables["params"]["denoiser"]["head"]["Dense_0"]
        ["kernel"].T)


def test_bridge_rejects_missing_and_extra_keys(tasks):
    _, _, tt, variables = tasks
    bad = {"params": dict(variables["params"]),
           "batch_stats": variables["batch_stats"]}
    bad["params"]["denoiser"] = dict(bad["params"]["denoiser"])
    del bad["params"]["denoiser"]["head"]
    with pytest.raises(KeyError):
        load_jax_variables(tt.model, bad)
    bad["params"]["denoiser"]["head"] = variables["params"]["denoiser"][
        "head"]
    bad["params"]["denoiser"]["stray"] = {"kernel": np.zeros((2, 2))}
    with pytest.raises(KeyError):
        load_jax_variables(tt.model, bad)


def test_partial_encoder(banks):
    (jf_c, jg_c, jf_u, _), (tf_c, tg_c, tf_u, _) = banks
    np.testing.assert_array_equal(tg_c.mask.numpy(), np.asarray(jg_c.mask))
    np.testing.assert_allclose(tf_c.numpy(), np.asarray(jf_c), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tf_u.numpy(), np.asarray(jf_u), atol=ATOL,
                               rtol=0)
    assert np.abs(np.asarray(jf_c)).max() > 0.1       # not trivially zero


@pytest.mark.parametrize("groups", [1, 2])
def test_denoiser_eps(tasks, scan, banks, groups):
    """One denoiser forward: G=1 on the cond bank, G=2 fused cond+uncond."""
    jt, jv, tt, _ = tasks
    (jf_c, jg_c, jf_u, jg_u), (tf_c, tg_c, tf_u, tg_u) = banks
    x = scan[1]
    # distinct per-item t (G=1) checks the gates' batch-id gather; the
    # guided pair takes one t for the batch
    t = np.array([37, 80] if groups == 1 else [55, 55], np.int32)
    j_bank = [(jf_c, jg_c), (jf_u, jg_u)][:groups]
    t_bank = [(tf_c, tg_c), (tf_u, tg_u)][:groups]
    pf, pg = zip(*j_bank)
    if groups == 1:
        pf, pg = pf[0], pg[0]
    pyr = jax.jit(jt.pyramid_full)(jnp.asarray(x))
    ref = np.asarray(jax.jit(lambda v, p, f, g, t: jt.model.apply(
        v, p, f, g, t, False, method=JaxModel.denoise))(
            jv, pyr, pf, pg, jnp.asarray(t)))
    with torch.no_grad():
        got = tt.model.denoise(tt.pyramid_full(torch.from_numpy(x)), t_bank,
                               torch.from_numpy(t)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    if groups == 2:
        # the guided pair of lidiff_tpu DiffusionTask.denoise_pair; w = 6
        # scales the eps difference, so atol grows with it
        w = CFG["train"]["uncond_w"]
        ref_pair = ref[..., 1, :] + w * (ref[..., 0, :] - ref[..., 1, :])
        got_pair = tt.denoise_pair(torch.from_numpy(x), tf_c, tg_c, tf_u,
                                   tg_u, 55).numpy()
        np.testing.assert_allclose(got_pair, ref_pair,
                                   atol=(2 * w + 1) * ATOL, rtol=0)


def test_unfused_denoise_pair(tasks, scan, banks, one_thread):
    """`tpu.fuse_classfree: false`: the guided pair as two G=1 forwards over
    one pyramid, against the JAX package's unfused `denoise_pair` on the
    same weights, banks, points and t within (2w + 1) ATOL (w = 6 scales
    the eps difference, as in test_denoiser_eps), and against the port's
    fused pair within (2w + 1) 1e-5: the same float32 products, the G=2
    GEMMs summing them in other blocks."""
    _, _, tt, variables = tasks
    (jf_c, jg_c, jf_u, jg_u), (tf_c, tg_c, tf_u, tg_u) = banks
    x, t = scan[1], 55
    cfg = dict(CFG, tpu=dict(CFG["tpu"], fuse_classfree=False))
    jt = JaxTask(jax_finalize(cfg))
    assert not jt.fuse_classfree
    ref = np.asarray(jax.jit(lambda v, p: jt.denoise_pair(
        v, p, jf_c, jg_c, jf_u, jg_u, t))(to_jax(variables), jnp.asarray(x)))

    tu = DiffusionTask(finalize_config(cfg), device="cpu")
    load_jax_variables(tu.model, variables)
    assert not tu.fuse_classfree and tt.fuse_classfree
    calls = []
    denoise = tu.model.denoise

    def spy(pyr, bank, tvec):
        calls.append((pyr, len(bank)))
        return denoise(pyr, bank, tvec)
    tu.model.denoise = spy
    got = tu.denoise_pair(torch.from_numpy(x), tf_c, tg_c, tf_u, tg_u,
                          t).numpy()
    assert [g for _, g in calls] == [1, 1] and calls[0][0] is calls[1][0]
    w = CFG["train"]["uncond_w"]
    assert got.shape == ref.shape == x.shape
    np.testing.assert_allclose(got, ref, atol=(2 * w + 1) * ATOL, rtol=0)
    fused = tt.denoise_pair(torch.from_numpy(x), tf_c, tg_c, tf_u, tg_u,
                            t).numpy()
    np.testing.assert_allclose(got, fused, atol=(2 * w + 1) * 1e-5, rtol=0)
    assert np.abs(got).max() > 0.1
