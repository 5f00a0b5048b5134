"""Plain references of the completion pipeline's other stages: the crop and
farthest-point sampling of a scan, and one step of DPM-Solver++(2M) with
SDE noise (Lu et al. 2022, `sde-dpmsolver++` as LiDiff runs it through
diffusers) over LiDiff's linear beta schedule."""

from __future__ import annotations

import numpy as np
import torch


def crop(scan: np.ndarray, max_range: float = 50.0,
         min_range: float = 3.5) -> np.ndarray:
    dist = np.linalg.norm(scan[:, :3], axis=-1)
    keep = (dist < max_range) & (dist > min_range)
    return np.ascontiguousarray(scan[keep][:, :3], np.float32)


def fps(points: torch.Tensor, k: int, dtype=torch.float32) -> torch.Tensor:
    """Indices [k]: start at row 0, then each time the first row of the
    largest squared distance (dx*dx + dy*dy) + dz*dz to the picks so far,
    in `dtype`."""
    p = points.to(dtype)
    n = p.shape[0]
    sel = torch.zeros(k, dtype=torch.int64, device=p.device)
    d = torch.full((n,), float("inf"), dtype=dtype, device=p.device)
    j = sel[:1]
    for i in range(1, k):
        sq = (p - p[j]) ** 2
        d = torch.minimum(d, (sq[:, 0] + sq[:, 1]) + sq[:, 2])
        j = torch.argmax(d).reshape(1)
        sel[i:i + 1] = j
    return sel


class Schedule:
    """alpha_t, sigma_t, lambda_t of the linear betas in float64, and the
    solver's timesteps: S of T, descending, the last step going to t=0."""

    def __init__(self, beta_start: float, beta_end: float, t_steps: int,
                 s_steps: int):
        betas = np.linspace(beta_start, beta_end, t_steps,
                            dtype=np.float64).astype(np.float32)
        ac = np.cumprod(1.0 - betas.astype(np.float64))
        self.alpha = np.sqrt(ac)
        self.sigma = np.sqrt(1.0 - ac)
        self.lam = np.log(self.alpha) - np.log(self.sigma)
        self.ts = (np.linspace(0, t_steps - 1, s_steps + 1).round()[::-1]
                   [:-1].astype(np.int64))

    def step(self, i: int, sample, prev_m, eps, z, dtype=torch.float64):
        """(next sample, x0 prediction) of step i from the sample, the
        previous step's x0 prediction, the noise prediction and the step's
        standard normal, computed in `dtype`."""
        S = len(self.ts)
        t = int(self.ts[i])
        tn = 0 if i == S - 1 else int(self.ts[i + 1])

        def c(x):
            return torch.tensor(float(x), dtype=dtype, device=sample.device)

        x, m1, e, z = (v.to(dtype) for v in (sample, prev_m, eps, z))
        a_c, s_c, a_n, s_n = (c(self.alpha[t]), c(self.sigma[t]),
                              c(self.alpha[tn]), c(self.sigma[tn]))
        h = c(self.lam[tn] - self.lam[t])
        m0 = (x - s_c * e) / a_c
        one_m = 1.0 - torch.exp(-2.0 * h)
        out = (s_n / s_c) * torch.exp(-h) * x + a_n * one_m * m0 \
            + s_n * torch.sqrt(one_m) * z
        if i > 0 and not (S < 15 and i == S - 1):
            r = c((self.lam[t] - self.lam[int(self.ts[i - 1])])
                  / (self.lam[tn] - self.lam[t]))
            out = out + 0.5 * a_n * one_m * (m0 - m1) / r
        return out, m0
