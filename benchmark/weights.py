"""Seeded random weights, made on the device in two large draws.

Sparse-conv kernels and the residual shortcuts are He-uniform over their
fan-in, MLP layers LeCun-normal with small uniform biases, and every
BatchNorm a little off identity (scale and variance in [0.9, 1.1], bias and
mean in [-0.05, 0.05]), so that folding it into a conv changes the numbers.
The same tensors go to the program and to the plain reference."""

from __future__ import annotations

import math

import torch


def _kind(name: str, shape: tuple) -> str:
    leaf = name.rsplit(".", 1)[1]
    if leaf == "kernel":
        return "he"
    if name.endswith("Dense_0.weight") and ".ResidualBlock_" in name \
            and ".latent." not in name:
        return "he"
    if leaf == "weight":
        return "lecun"
    return {"bias": "bias", "scale": "scale", "mean": "mean",
            "var": "var"}[leaf]


def make(shapes: dict, gen: torch.Generator, device) -> dict:
    """{name: float32 tensor} for `shapes` ({name: shape}), drawn from
    `gen` (on `device`): one uniform and one normal draw for all."""
    kinds = {n: _kind(n, s) for n, s in shapes.items()}
    sizes = {n: math.prod(s) for n, s in shapes.items()}
    n_u = sum(sizes[n] for n in shapes if kinds[n] != "lecun")
    n_n = sum(sizes[n] for n in shapes if kinds[n] == "lecun")
    u = torch.rand(n_u, generator=gen, device=device)
    g = torch.randn(n_n, generator=gen, device=device)
    out, iu, ig = {}, 0, 0
    for name, shape in shapes.items():
        k, m = kinds[name], sizes[name]
        if k == "lecun":
            out[name] = (g[ig:ig + m] / math.sqrt(shape[-1])).reshape(shape)
            ig += m
            continue
        x = u[iu:iu + m].reshape(shape)
        iu += m
        if k == "he":
            fan_in = shape[0] * shape[1] if len(shape) == 3 else shape[1]
            b = math.sqrt(6.0 / fan_in)
            out[name] = x * (2 * b) - b
        elif k in ("scale", "var"):
            out[name] = 0.9 + 0.2 * x
        else:
            out[name] = 0.1 * x - 0.05
    return out
