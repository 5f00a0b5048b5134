"""Beta schedules (counterpart of lidiff_tpu/diffusion/schedules.py); numpy
only, float64 math rounded to float32 as in the JAX package."""

from __future__ import annotations

import numpy as np


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    ac = np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = 1 - (ac[1:] / ac[:-1])
    return np.clip(betas, 0.0001, 0.9999).astype(np.float32)


def linear_beta_schedule(timesteps, beta_start, beta_end) -> np.ndarray:
    return np.linspace(beta_start, beta_end, timesteps,
                       dtype=np.float64).astype(np.float32)


def quadratic_beta_schedule(timesteps, beta_start, beta_end) -> np.ndarray:
    return (np.linspace(beta_start ** 0.5, beta_end ** 0.5, timesteps,
                        dtype=np.float64) ** 2).astype(np.float32)


def sigmoid_beta_schedule(timesteps, beta_start, beta_end) -> np.ndarray:
    x = np.linspace(-6, 6, timesteps, dtype=np.float64)
    sig = 1.0 / (1.0 + np.exp(-x))
    return (sig * (beta_end - beta_start) + beta_start).astype(np.float32)


beta_func = {
    "cosine": cosine_beta_schedule,
    "linear": linear_beta_schedule,
    "quadratic": quadratic_beta_schedule,
    "sigmoid": sigmoid_beta_schedule,
}


def make_betas(name: str, t_steps: int, beta_start: float | None = None,
               beta_end: float | None = None) -> np.ndarray:
    if name == "cosine":
        return beta_func[name](t_steps)
    return beta_func[name](t_steps, beta_start, beta_end)
