"""DDPM coefficient tables (counterpart of lidiff_tpu/diffusion/ddpm.py):
built in float64, stored as float32 tensors."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lidiff_tpu_torch.diffusion.schedules import make_betas


@dataclass
class DDPMCoeffs:
    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_var: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @property
    def t_steps(self) -> int:
        return self.betas.shape[0]


def make_ddpm(name: str, t_steps: int, beta_start: float | None = None,
              beta_end: float | None = None, device=None) -> DDPMCoeffs:
    betas = make_betas(name, t_steps, beta_start, beta_end).astype(np.float64)
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.append(1.0, ac[:-1])
    post_var = betas * (1.0 - ac_prev) / (1.0 - ac)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return DDPMCoeffs(
        betas=f32(betas),
        alphas=f32(alphas),
        alphas_cumprod=f32(ac),
        alphas_cumprod_prev=f32(ac_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(ac)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - ac)),
        sqrt_recip_alphas=f32(np.sqrt(1.0 / alphas)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / ac)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / ac - 1.0)),
        posterior_variance=f32(post_var),
        posterior_log_var=f32(np.log(np.maximum(post_var, 1e-20))),
        posterior_mean_coef1=f32(betas * np.sqrt(ac_prev) / (1.0 - ac)),
        posterior_mean_coef2=f32((1.0 - ac_prev) * np.sqrt(alphas)
                                 / (1.0 - ac)),
    )


def q_sample(coeffs: DDPMCoeffs, x: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward diffusion q(x_t | x_0) for x [B, N, 3] and t [B]. In the
    offset formulation the caller passes x = zeros and adds the result to
    the anchor points."""
    t = t.long()
    sa = coeffs.sqrt_alphas_cumprod[t][:, None, None]
    so = coeffs.sqrt_one_minus_alphas_cumprod[t][:, None, None]
    return sa * x + so * noise
