"""Parity of the PyTorch port's sampling side with the JAX package: config
capacities, DDPM tables, `solver_step` for both algorithms, a teacher-forced
sampling loop over every step of a short schedule, and a 2-step end-to-end
sample with the same injected numpy noise (float32, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidiff_tpu.config import derive_capacities as jax_derive
from lidiff_tpu.config import finalize_config as jax_finalize
from lidiff_tpu.diffusion import dpm_solver as jdpm
from lidiff_tpu.diffusion.ddpm import make_ddpm as jax_make_ddpm
from lidiff_tpu.models.diffusion import DiffusionModel as JaxModel
from lidiff_tpu.models.diffusion import DiffusionTask as JaxTask
from lidiff_tpu_torch.config import derive_capacities, finalize_config
from lidiff_tpu_torch.convert import load_jax_variables
from lidiff_tpu_torch.diffusion import dpm_solver as tdpm
from lidiff_tpu_torch.diffusion.ddpm import make_ddpm
from lidiff_tpu_torch.models.diffusion import DiffusionTask
from tests.torch_parity_helpers import (B, CFG, NP, TILE, random_variables,
                                        ring_scan, to_jax)

# eps of one guided denoise agrees to atol 1e-4 per stream (float32 sums
# in other orders, tests/test_torch_models.py); the guidance w = 6 turns
# that into (2w + 1) * 1e-4 on the guided eps
EPS_ATOL = 13e-4
# solver_step: max |error| <= 1e-6 of the state's largest entry. The update
# sums terms of the state's scale that can cancel, so a bound relative to
# each element would ask for more than float32 gives either side.
SOLVER_TOL = 1e-6


def _assert_scaled_close(got, ref, tol):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def test_capacities_at_180k_points():
    cfg = finalize_config({"data": {"num_points": 180_000}})
    assert cfg["tpu"]["full_capacities"] == [180096, 180096, 180096, 144000,
                                             72064]
    assert cfg["tpu"]["part_capacities"] == [18048, 18048, 18048, 15360,
                                             11264]
    ref = jax_finalize({"data": {"num_points": 180_000}})
    for key in ("full_capacities", "part_capacities", "num_levels"):
        assert cfg["tpu"][key] == ref["tpu"][key]
    for n in (3000, 30_000, 60_000):
        for clean in (False, True):
            assert derive_capacities(n, clean=clean) == \
                jax_derive(n, clean=clean)


def test_ddpm_tables_match():
    ref = jax_make_ddpm("linear", 1000, 3.5e-5, 0.007)
    got = make_ddpm("linear", 1000, 3.5e-5, 0.007)
    for name in ("betas", "alphas_cumprod", "sqrt_recip_alphas",
                 "posterior_variance", "posterior_mean_coef2"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))


@pytest.mark.parametrize("algorithm", ["sde-dpmsolver++", "dpmsolver++"])
@pytest.mark.parametrize("s_steps", [5, 20])
def test_solver_step_matches(algorithm, s_steps):
    """Every step of a schedule (first-order first step, 2M steps, and the
    lower_order_final drop below 15 steps) on scripted eps and noise."""
    js = jdpm.make_dpm_solver("linear", 1000, s_steps, 3.5e-5, 0.007,
                              algorithm=algorithm)
    ts = tdpm.make_dpm_solver("linear", 1000, s_steps, 3.5e-5, 0.007,
                              algorithm=algorithm)
    np.testing.assert_array_equal(ts.timesteps, np.asarray(js.timesteps))
    rng = np.random.default_rng(s_steps)
    x = rng.normal(size=(2, 50, 3)).astype(np.float32)
    jstate = jdpm.init_state(jnp.asarray(x))
    tstate = tdpm.init_state(torch.from_numpy(x))
    step = jax.jit(lambda st, e, z: jdpm.solver_step(js, st, e, z))
    for _ in range(s_steps):
        eps = rng.normal(size=x.shape).astype(np.float32)
        z = rng.normal(size=x.shape).astype(np.float32)
        jstate = step(jstate, jnp.asarray(eps), jnp.asarray(z))
        tstate = tdpm.solver_step(ts, tstate, torch.from_numpy(eps),
                                  torch.from_numpy(z))
        _assert_scaled_close(tstate.sample.numpy(), jstate.sample,
                             SOLVER_TOL)
        _assert_scaled_close(tstate.prev_m.numpy(), jstate.prev_m,
                             SOLVER_TOL)


@pytest.fixture(scope="module")
def setup():
    jt = JaxTask(jax_finalize(CFG))
    variables = random_variables(jt, seed=5)
    jv = to_jax(variables)
    tt = DiffusionTask(finalize_config(CFG), device="cpu")
    load_jax_variables(tt.model, variables)
    rng = np.random.default_rng(11)
    part = ring_scan(rng, NP)
    x_init = np.tile(part, (1, TILE, 1))
    noise = rng.normal(size=(CFG["diff"]["s_steps"] + 1,) + x_init.shape)
    noise = noise.astype(np.float32)

    enc = jax.jit(lambda v, p: jt.model.apply(
        v, p, False, method=JaxModel.encode_partial))
    pyr_c = jax.jit(jt.pyramid_part)(jnp.asarray(part))
    pyr_u = jax.jit(jt.pyramid_part_tiny)(jnp.zeros((B, NP, 3)))
    j_banks = (enc(jv, pyr_c), pyr_c.levels[-1].geom,
               enc(jv, pyr_u), pyr_u.levels[-1].geom)
    pair = jax.jit(lambda v, p, t: jt.denoise_pair(v, p, *j_banks, t))
    return jt, jv, tt, part, x_init, noise, pair


def _jax_loop(jt, jv, pair, solver, x_init, offset0, noise):
    """lidiff_tpu DiffusionTask.sample's loop body with injected noise;
    returns the state before every step and the eps of every step."""
    state = jdpm.init_state(jnp.asarray(offset0))
    states, epss = [], []
    step = jax.jit(lambda st, e, z: jdpm.solver_step(solver, st, e, z))
    for i in range(solver.num_steps):
        states.append(state)
        eps = pair(jv, jnp.asarray(x_init) + state.sample,
                   solver.timesteps[i])
        epss.append(eps)
        state = step(state, eps, jnp.asarray(noise[i]))
    states.append(state)
    return states, epss


def test_teacher_forced_sampling_loop(setup):
    """At every step of a 3-step schedule, the port's guided eps and its
    solver update, both from the JAX state, match the JAX step. Feeding
    the JAX state keeps a sub-ulp voxelization difference (scatter-add
    order) from flipping a voxel and compounding over steps."""
    jt, jv, tt, part, x_init, noise, pair = setup
    states, epss = _jax_loop(jt, jv, pair, jt.solver, x_init, noise[0],
                             noise[1:])
    t_banks = tt.encode_banks(torch.from_numpy(part))
    for i in range(jt.solver.num_steps):
        js = states[i]
        pts = torch.tensor(np.asarray(jnp.asarray(x_init) + js.sample))
        t = int(tt.solver.timesteps[i])
        eps = tt.denoise_pair(pts, *t_banks, t)
        np.testing.assert_allclose(eps.numpy(), np.asarray(epss[i]),
                                   atol=EPS_ATOL, rtol=0, err_msg=f"step {i}")
        ts = tdpm.SolverState(
            sample=torch.tensor(np.asarray(js.sample)),
            prev_m=torch.tensor(np.asarray(js.prev_m)),
            prev_lambda=torch.tensor(float(js.prev_lambda)), step=i)
        nxt = tdpm.solver_step(tt.solver, ts, eps,
                               torch.from_numpy(noise[1 + i]))
        # the update multiplies eps by at most |sigma_c * alpha_n / alpha_c
        # * (1 - e^-2h)| <= 1, so the eps tolerance carries over
        np.testing.assert_allclose(nxt.sample.numpy(),
                                   np.asarray(states[i + 1].sample),
                                   atol=EPS_ATOL, rtol=0, err_msg=f"step {i}")


def test_two_step_sample_end_to_end(setup):
    """DiffusionTask.sample with injected offset and noise against the JAX
    loop. Tolerance 2 * EPS_ATOL: the step-1 error enters the step-2
    voxelization; with these seeds no point crosses a voxel boundary, so
    the geometry stays identical and the errors only add."""
    jt, jv, tt, part, x_init, noise, pair = setup
    js = jdpm.make_dpm_solver("linear", 100, 2, 3.5e-5, 0.007)
    states, _ = _jax_loop(jt, jv, pair, js, x_init, noise[0], noise[1:])
    ref = x_init + np.asarray(states[-1].sample)
    got = tt.sample(torch.from_numpy(x_init), torch.from_numpy(part), None,
                    offset0=torch.from_numpy(noise[0]),
                    noise=torch.from_numpy(noise[1:]),
                    solver=tdpm.make_dpm_solver("linear", 100, 2, 3.5e-5,
                                                0.007))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), ref, atol=2 * EPS_ATOL, rtol=0)
