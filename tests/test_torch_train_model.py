"""Parity of the port's training loss with the JAX package on the whole
model: `DiffusionTask.loss_fn` against `jax.value_and_grad(task.loss_fn,
has_aux=True)` on the tiny config, same weights (through the bridge), same
scan, and the JAX side's own noise, timesteps and coin fed to the port.

Compared, for both values of the classifier-free coin: the loss, every
metric, every parameter's gradient and the updated BatchNorm running
statistics, leaf by leaf through `convert.state_dict_to_flax`. The JAX side
runs with its default `tpu.remat` (its stages rematerialized under
`nn.remat`); the port runs without remat, and again with it (`tpu.remat`,
the stages under activation checkpointing) with the coin kept.

Tolerances (float32 on both sides; the sums of about 100 layers forward and
backward run in other orders, and train-mode BatchNorm over the few dozen
voxels of the coarse levels divides by small variances): loss and metrics
rtol 1e-4; a gradient leaf within 2e-3 of that leaf's max|grad| plus 1e-4
of the largest max|grad| of the tree; running statistics atol 1e-4.

With the coin set (the partial scan zeroed) the encoder sees one voxel per
batch item, with zero features. Train-mode BatchNorm over two equal voxels
has zero variance, every such layer multiplies the gradient by eps^-1/2 =
316, and on both sides the encoder's gradients reach 1e29, with rounding
differences of their own size, and overflow to NaN in the stem's first
kernel. So in that case each encoder leaf is held to have its NaNs where
the JAX side has them and the JAX side's order of magnitude, and the
denoiser's gradients are compared as above."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidiff_tpu.config import finalize_config as jax_finalize
from lidiff_tpu.models.diffusion import DiffusionTask as JaxTask
from lidiff_tpu_torch.config import finalize_config
from lidiff_tpu_torch.convert import load_jax_variables, state_dict_to_flax
from lidiff_tpu_torch.models.diffusion import DiffusionTask
from tests.torch_parity_helpers import (B, CFG, NP, TILE, random_variables,
                                        ring_scan, to_jax)

TRAIN_CFG = {**CFG, "tpu": {**CFG["tpu"], "remat": False}}
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-4
# Seeds of the draws, by the coin's value. A ReLU input that lies within
# float32 rounding of zero takes the other side of the kink in one package,
# which moves the gradients upstream by one voxel's share (about 1e-2 of a
# leaf, seen with key 11 and the coin set); these keys give no such input.
KEYS = {False: 11, True: 12}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.fixture(scope="module")
def setup():
    jt = JaxTask(jax_finalize(CFG))
    assert jt.model.remat
    variables = random_variables(jt, seed=5)
    tt = DiffusionTask(finalize_config(TRAIN_CFG), device="cpu")
    rng = np.random.default_rng(8)
    part = ring_scan(rng, NP)
    full = (np.tile(part, (1, TILE, 1))
            + rng.normal(0, 0.05, (B, NP * TILE, 3))).astype(np.float32)

    @jax.jit
    def value_and_grad(params, batch_stats, batch, key, uncond_prob):
        # the coin's threshold as an argument: one compile serves both
        # values of the coin
        jt.uncond_prob = uncond_prob
        try:
            return jax.value_and_grad(jt.loss_fn, has_aux=True)(
                params, batch_stats, batch, key)
        finally:
            jt.uncond_prob = float(TRAIN_CFG["train"]["uncond_prob"])

    return jt, variables, tt, part, full, value_and_grad


@pytest.mark.parametrize("drop", [False, True])
def test_loss_fn_matches_jax_value_and_grad(setup, drop):
    _check_step(setup, setup[2], drop)


def test_remat_loss_fn_matches_jax_value_and_grad(setup):
    """The port with remat against the same JAX step, at batch 2 with the
    capacities of both items (no voxel overflows) and the coin kept."""
    tt = DiffusionTask(finalize_config(CFG), device="cpu")
    assert tt.model.partial_enc.remat and tt.model.denoiser.remat
    metrics = _check_step(setup, tt, False)
    assert metrics["overflow_vox"] == 0


def _check_step(setup, tt, drop):
    """One loss and backward pass of the port task `tt` on the JAX side's
    weights and draws, held against the JAX step; returns its metrics."""
    jt, variables, _, part, full, value_and_grad = setup
    key = jax.random.PRNGKey(KEYS[drop])
    jv = to_jax(variables)
    batch = {"pcd_full": jnp.asarray(full), "pcd_part": jnp.asarray(part)}
    (j_loss, (j_stats, j_metrics)), j_grads = value_and_grad(
        jv["params"], jv["batch_stats"], batch, key, 1.0 if drop else 0.0)

    # the draws of lidiff_tpu DiffusionTask.loss_fn from the same key
    k_noise, k_t, _ = jax.random.split(key, 3)
    noise = np.array(jax.random.normal(k_noise, full.shape, jnp.float32))
    t = np.array(jax.random.randint(k_t, (B,), 0, jt.coeffs.t_steps))

    load_jax_variables(tt.model, variables)
    tt.model.zero_grad()
    loss, metrics = tt.loss_fn(
        {"pcd_full": torch.from_numpy(full),
         "pcd_part": torch.from_numpy(part)},
        noise=torch.from_numpy(noise), t=torch.from_numpy(t), drop=drop)
    loss.backward()

    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-4)
    assert set(metrics) == set(j_metrics)
    for k, v in j_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)

    grads = state_dict_to_flax({n: p.grad for n, p in
                                tt.model.named_parameters()})["params"]
    got, ref = dict(_leaves(grads)), dict(_leaves(j_grads))
    assert set(got) == set(ref)
    if drop:
        enc = [n for n in ref if n.startswith("partial_enc/")]
        for name in enc:
            nan = np.isnan(ref[name])
            np.testing.assert_array_equal(np.isnan(got[name]), nan, name)
            if not nan.all():
                g_top = np.nanmax(np.abs(got[name]))
                r_top = np.nanmax(np.abs(ref[name]))
                assert 0.1 * r_top <= g_top <= 10.0 * r_top, name
        ref = {n: r for n, r in ref.items() if n not in enc}
    top = max(np.abs(r).max() for r in ref.values())
    assert top > 1e-2
    worst = max((np.abs(got[n] - r).max()
                 / (GRAD_RTOL * np.abs(r).max() + GRAD_ATOL * top), n)
                for n, r in ref.items())
    print(f"drop={drop}: worst gradient leaf at {worst[0]:.3f} of its "
          f"tolerance ({worst[1]}), max|grad| {top:.3g}")
    assert worst[0] <= 1.0, worst

    stats = state_dict_to_flax(tt.model.state_dict())["batch_stats"]
    got_s, ref_s = dict(_leaves(stats)), dict(_leaves(j_stats))
    assert set(got_s) == set(ref_s)
    old = dict(_leaves(variables["batch_stats"]))
    for name, r in ref_s.items():
        np.testing.assert_allclose(got_s[name], r, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    assert any(not np.allclose(old[n], got_s[n]) for n in old)
    return metrics


def test_sampling_after_training_keeps_running_statistics(setup):
    """`sample` runs the model in eval mode and restores train mode."""
    _, variables, tt, part, _, _ = setup
    load_jax_variables(tt.model, variables)
    tt.model.train()
    before = {k: v.clone() for k, v in tt.model.state_dict().items()}
    x_init = torch.from_numpy(np.tile(part, (1, TILE, 1)))
    out = tt.sample(x_init, torch.from_numpy(part),
                    torch.Generator().manual_seed(0))
    assert tt.model.training and bool(torch.isfinite(out).all())
    after = tt.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
