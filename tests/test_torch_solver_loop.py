"""The port's generic sampling loops against the JAX package's, mirroring
tests/test_diffusion.py:81-136: `ddpm.p_step` (the ancestral DDPM step) and
`dpm_solver.sample_loop` (DPM-Solver++ over a whole schedule), on the
exact epsilon-predictor of a point mass (or of x0 ~ N(0, I)), float32 on
the CPU.

Each case runs twice in the port: once with the normals JAX draws from its
key (taken out of JAX by the same splits, passed as numpy arrays) against
the JAX loop's output, once with a `torch.Generator` against the analytic
answer that tests/test_diffusion.py holds JAX to, at its bounds.

Tolerance of the port against JAX: max |error| <= 1e-5 of the output's
scale (max(1, max|ref|)); each step sums terms of the state's scale that
can cancel, in float32, in another order than XLA's fused loop, and the
loops run up to 200 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidiff_tpu.diffusion import ddpm as jddpm
from lidiff_tpu.diffusion import dpm_solver as jdpm
from lidiff_tpu_torch.diffusion import ddpm as tddpm
from lidiff_tpu_torch.diffusion import dpm_solver as tdpm

LOOP_TOL = 1e-5


def _assert_scaled_close(got, ref, tol=LOOP_TOL):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _exact_eps(alpha, sigma, target):
    """eps*(x_t, t) = (x_t - alpha_t * target) / sigma_t for x0 at
    `target`; works on jax and torch arrays alike."""
    def eps_fn(x, t):
        return (x - alpha[t] * target) / sigma[t]
    return eps_fn


def _jax_solver_noise(key, shape, steps):
    """The normals lidiff_tpu's sample_loop draws from `key`, step by
    step."""
    out = []
    for _ in range(steps):
        key, k1 = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(k1, shape, jnp.float32)))
    return torch.from_numpy(np.stack(out))


def _solvers(s_steps):
    args = ("linear", 1000, s_steps, 3.5e-5, 0.007)
    return jdpm.make_dpm_solver(*args), tdpm.make_dpm_solver(*args)


# (s_steps, target, points, x0 key, loop key, JAX's bound on the mean
# error, the bound's kind): test_dpm_solver_converges_to_point_mass and
# test_dpm_solver_short_schedule_lower_order_final
POINT_MASS = {
    "50 steps": (50, [1.7, -0.3, 0.9], 256, 0, 1, 0.05, "mean abs"),
    "8 steps": (8, [0.5], 512, 2, 3, 0.1, "abs mean"),
}


@pytest.mark.parametrize("case", sorted(POINT_MASS))
def test_sample_loop_point_mass(case):
    s_steps, target, n, k0, k1, bound, kind = POINT_MASS[case]
    js, ts = _solvers(s_steps)
    np.testing.assert_array_equal(ts.timesteps, np.asarray(js.timesteps))
    x0 = jax.random.normal(jax.random.PRNGKey(k0), (n, len(target)))
    key = jax.random.PRNGKey(k1)
    ref = jdpm.sample_loop(js, x0, _exact_eps(js.alpha_t, js.sigma_t,
                                              jnp.asarray(target)), key)
    eps_fn = _exact_eps(ts.alpha_t, ts.sigma_t, torch.tensor(target))
    x = torch.from_numpy(np.array(x0))
    got = tdpm.sample_loop(ts, x, eps_fn,
                           noise=_jax_solver_noise(key, x.shape, s_steps))
    _assert_scaled_close(got.numpy(), ref)

    drawn = tdpm.sample_loop(ts, x, eps_fn, torch.Generator().manual_seed(k1))
    err = (drawn - torch.tensor(target)).abs().mean() if kind == "mean abs" \
        else (drawn.mean() - torch.tensor(target)).abs().max()
    assert float(err) < bound, float(err)


def test_sample_loop_variance_matches_posterior():
    """The exact eps-predictor of x0 ~ N(0, I) keeps samples unit normal
    (test_solver_variance_matches_posterior)."""
    js, ts = _solvers(50)
    x0 = jax.random.normal(jax.random.PRNGKey(5), (4096, 1))
    key = jax.random.PRNGKey(6)
    ref = jdpm.sample_loop(js, x0, lambda x, t: js.sigma_t[t] * x, key)
    x = torch.from_numpy(np.array(x0))

    def eps_fn(x, t):
        return ts.sigma_t[t] * x
    got = tdpm.sample_loop(ts, x, eps_fn,
                           noise=_jax_solver_noise(key, x.shape, 50))
    _assert_scaled_close(got.numpy(), ref)
    std = float(tdpm.sample_loop(ts, x, eps_fn,
                                 torch.Generator().manual_seed(6)).std())
    assert 0.85 < std < 1.15, std


def test_sample_loop_needs_a_noise_source():
    _, ts = _solvers(4)
    with pytest.raises(ValueError, match="Generator"):
        tdpm.sample_loop(ts, torch.zeros(3), lambda x, t: x)


def test_p_step_matches_jax_and_converges():
    """The ancestral chain over all 200 steps (test_ddpm_ancestral_converges):
    every step's p_step against JAX's on the same state and normal, then
    the whole chain with a torch.Generator against the target."""
    T = 200
    jc = jddpm.make_ddpm("linear", T, 1e-4, 0.02)
    tc = tddpm.make_ddpm("linear", T, 1e-4, 0.02)
    target = np.asarray([0.8, -1.2], np.float32)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 512, 2)).astype(np.float32)
    step = jax.jit(jddpm.p_step)
    eps_j = _exact_eps(jc.sqrt_alphas_cumprod,
                       jc.sqrt_one_minus_alphas_cumprod, jnp.asarray(target))
    for t in range(T - 1, -1, -1):
        z = rng.normal(size=x.shape).astype(np.float32)
        tt = np.asarray([t])
        ref = np.asarray(step(jc, jnp.asarray(x), eps_j(jnp.asarray(x), t),
                              jnp.asarray(tt), jnp.asarray(z)))
        xt = torch.from_numpy(x)
        got = tddpm.p_step(
            tc, xt, (xt - tc.sqrt_alphas_cumprod[t] * torch.from_numpy(target))
            / tc.sqrt_one_minus_alphas_cumprod[t], torch.from_numpy(tt),
            torch.from_numpy(z))
        _assert_scaled_close(got.numpy(), ref)
        x = np.array(ref)
    # t = 0 adds no noise
    xt = torch.from_numpy(x)
    assert torch.equal(tddpm.p_step(tc, xt, xt, torch.tensor([0]),
                                    torch.ones_like(xt)),
                       tddpm.p_step(tc, xt, xt, torch.tensor([0]),
                                    torch.zeros_like(xt)))

    gen = torch.Generator().manual_seed(4)
    xt = torch.randn((1, 512, 2), generator=gen)
    eps_t = _exact_eps(tc.sqrt_alphas_cumprod,
                       tc.sqrt_one_minus_alphas_cumprod,
                       torch.from_numpy(target))
    for t in range(T - 1, -1, -1):
        xt = tddpm.p_step(tc, xt, eps_t(xt, t), torch.tensor([t]),
                          torch.randn(xt.shape, generator=gen))
    err = (xt.mean((0, 1)) - torch.from_numpy(target)).abs().max()
    assert float(err) < 0.05, float(err)
