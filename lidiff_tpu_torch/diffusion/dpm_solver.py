"""DPM-Solver++(2M) with SDE noise injection (the reference's
'sde-dpmsolver++') or without it ('dpmsolver++'), as an eager multistep
state machine and the loop that drives it (counterpart of
lidiff_tpu/diffusion/dpm_solver.py:68-185).

Update rules (h = lam_next - lam_cur, lam = log(alpha / sigma)), with the
epsilon prediction converted to x0 first:
  1st order:  x <- (sig_n/sig_c) exp(-h) x + alpha_n (1 - exp(-2h)) x0
                   + sig_n sqrt(1 - exp(-2h)) z
  2nd order adds 0.5 alpha_n (1 - exp(-2h)) D1, D1 = (m0 - m1) / r.
The first step, and the last one of schedules shorter than 15 steps, are
first order. The scalar coefficients are float32 0-d tensors, computed in
the same float32 operations as the JAX solver.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lidiff_tpu_torch.diffusion.schedules import make_betas


@dataclass
class DPMSolver:
    timesteps: np.ndarray        # [S] int32, descending
    alpha_t: torch.Tensor        # [T] sqrt(alphas_cumprod), float32
    sigma_t: torch.Tensor        # [T] sqrt(1 - alphas_cumprod)
    lambda_t: torch.Tensor       # [T]
    lower_order_final: bool = True
    sde: bool = True

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def make_dpm_solver(name: str, t_steps: int, s_steps: int,
                    beta_start: float | None = None,
                    beta_end: float | None = None,
                    algorithm: str = "sde-dpmsolver++",
                    device=None) -> DPMSolver:
    if algorithm not in ("sde-dpmsolver++", "dpmsolver++"):
        raise ValueError(f"unknown solver algorithm {algorithm!r}")
    betas = make_betas(name, t_steps, beta_start, beta_end).astype(np.float64)
    ac = np.cumprod(1.0 - betas)
    alpha_t = np.sqrt(ac)
    sigma_t = np.sqrt(1.0 - ac)
    lam = np.log(alpha_t) - np.log(sigma_t)
    ts = (np.linspace(0, t_steps - 1, s_steps + 1).round()[::-1][:-1]
          .astype(np.int32))

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return DPMSolver(timesteps=ts, alpha_t=f32(alpha_t), sigma_t=f32(sigma_t),
                     lambda_t=f32(lam),
                     sde=(algorithm == "sde-dpmsolver++"))


@dataclass
class SolverState:
    sample: torch.Tensor       # current x (offset space in LiDiff)
    prev_m: torch.Tensor       # x0 prediction of the previous step
    prev_lambda: torch.Tensor  # [] lambda of the previous step
    step: int                  # index into solver.timesteps


def init_state(sample: torch.Tensor) -> SolverState:
    return SolverState(sample=sample, prev_m=torch.zeros_like(sample),
                       prev_lambda=torch.zeros((), dtype=torch.float32,
                                               device=sample.device),
                       step=0)


def solver_step(solver: DPMSolver, state: SolverState,
                eps_pred: torch.Tensor, noise: torch.Tensor) -> SolverState:
    """Advance one step, given the model's noise prediction at
    solver.timesteps[state.step] and a standard normal `noise`."""
    S = solver.num_steps
    i = state.step
    t_cur = int(solver.timesteps[i])
    t_next = 0 if i == S - 1 else int(solver.timesteps[i + 1])
    a_c, s_c, l_c = (solver.alpha_t[t_cur], solver.sigma_t[t_cur],
                     solver.lambda_t[t_cur])
    a_n, s_n, l_n = (solver.alpha_t[t_next], solver.sigma_t[t_next],
                     solver.lambda_t[t_next])

    m0 = (state.sample - s_c * eps_pred) / a_c
    h = l_n - l_c
    if solver.sde:
        one_m = 1.0 - torch.exp(-2.0 * h)
        lead = (s_n / s_c) * torch.exp(-h) * state.sample
        noise_term = s_n * torch.sqrt(one_m.clamp(min=0.0)) * noise
        x = lead + a_n * one_m * m0 + noise_term
    else:
        one_m = 1.0 - torch.exp(-h)
        x = (s_n / s_c) * state.sample + a_n * one_m * m0

    use_first = i == 0 or (solver.lower_order_final and S < 15
                           and i == S - 1)
    if not use_first:
        h_prev = l_c - state.prev_lambda
        r = h_prev / torch.where(h == 0, 1.0, h)
        d1 = (m0 - state.prev_m) / torch.where(r == 0, 1.0, r)
        x = x + 0.5 * a_n * one_m * d1
    return SolverState(sample=x, prev_m=m0, prev_lambda=l_c, step=i + 1)


def sample_loop(solver: DPMSolver, x_init: torch.Tensor, eps_fn,
                generator: torch.Generator | None = None, *,
                noise=None) -> torch.Tensor:
    """Run every step of the solver from `x_init` (offset space, any shape)
    and return the final sample (lidiff_tpu/diffusion/dpm_solver.py:160).
    eps_fn(sample, t) is the noise prediction at timestep t (an int). Each
    step's standard normal comes from `generator` (on x_init's device), or
    from `noise` ([S, *x_init.shape]: the i-th step takes noise[i]), so
    tests can feed the z that JAX draws from its key."""
    if noise is None and generator is None:
        raise ValueError("pass a torch.Generator or the noise of every step")
    state = init_state(x_init)
    for i in range(solver.num_steps):
        eps = eps_fn(state.sample, int(solver.timesteps[i]))
        z = noise[i] if noise is not None else torch.randn(
            x_init.shape, generator=generator, device=x_init.device,
            dtype=x_init.dtype)
        state = solver_step(solver, state, eps, z)
    return state.sample
