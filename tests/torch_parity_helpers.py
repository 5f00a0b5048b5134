"""Shared inputs for the parity tests of the PyTorch port against the JAX
package (tests/test_torch_*.py): seeded numpy scans, a tiny config, a
seeded random JAX variables tree for the weight bridge, the small conv
pyramid of tests/test_pallas_conv.py, a context that turns on the JAX
package's int8 eval conv, and a fixture that runs a test's torch ops on one
intra-op thread."""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

B, NP, TILE = 2, 64, 8           # batch, partial points, x_init = part x 8
NF = NP * TILE

CFG = {
    "experiment": {"id": "torch-parity"},
    "data": {"data_dir": "", "resolution": 0.25, "num_points": NF,
             "max_range": 50.0},
    "train": {"uncond_prob": 0.1, "uncond_w": 6.0},
    "diff": {"beta_start": 3.5e-5, "beta_end": 0.007, "beta_func": "linear",
             "t_steps": 100, "s_steps": 3, "reg_weight": 5.0},
    "model": {"out_dim": 96, "cr": 0.25},
    "tpu": {"full_capacities": [1024, 1024, 1024, 768, 512],
            "part_capacities": [256, 256, 256, 256, 256]},
}


def ring_scan(rng, n: int, batch: int = B, r_max: float = 12.0):
    """Synthetic LiDAR-like rings (the shape of bench.py:144-151, scaled
    down to the tiny config's resolution)."""
    az = rng.uniform(0, 2 * np.pi, (batch, n))
    el = rng.choice(np.linspace(-0.4, 0.05, 16), (batch, n))
    r = rng.uniform(1.5, r_max, (batch, n))
    return np.stack([r * np.cos(az) * np.cos(el), r * np.sin(az) * np.cos(el),
                     r * np.sin(el)], -1).astype(np.float32)


def random_variables(jax_task, seed: int = 0, **init_sizes):
    """A JAX variables tree of the task's model, filled with seeded numpy
    values (BatchNorm statistics included, so the BN folds are exercised).
    The structure comes from `eval_shape` of the JAX init: no compile.
    `init_sizes` are the size arguments of the task's `init` (default: the
    diffusion task's)."""
    init_sizes = init_sizes or {"n_full": 256, "n_part": 64}
    shapes = jax.eval_shape(lambda k: jax_task.init(k, batch_size=1,
                                                    **init_sizes),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        parent = str(getattr(path[-2], "key", path[-2]))
        shape = s.shape
        if name == "kernel" and len(shape) == 3:
            bound = np.sqrt(6.0 / (shape[0] * shape[1]))
            v = rng.uniform(-bound, bound, shape)
        elif name == "kernel":
            v = rng.normal(0, 1.0 / np.sqrt(shape[0]), shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name in ("bias", "mean"):
            v = 0.1 * rng.normal(size=shape)
        else:
            raise KeyError(f"{parent}/{name}")
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def to_jax(variables):
    return jax.tree_util.tree_map(jnp.asarray, variables)


# the pyramid of tests/test_pallas_conv.py:18-24: 1600 points, res 0.25
SMALL_CAPS = [1280, 896, 640, 512, 384]
SMALL_RES = 0.25


def small_pyramid_points() -> np.ndarray:
    return np.random.default_rng(0).normal(0, 4, (1, 1600, 3)).astype(
        np.float32)


@contextlib.contextmanager
def jax_conv_quant():
    """The JAX package's LIDIFF_CONV_QUANT=int8 for the calls traced inside
    (the flag is read while tracing), reset afterwards."""
    from lidiff_tpu.ops import sparse_conv as jsc
    jsc.set_conv_quant(True)
    try:
        yield
    finally:
        jsc.set_conv_quant(False)


@pytest.fixture
def one_thread():
    """One intra-op thread for the test: a tiny model's thread-pool
    hand-offs cost far more than its work when the test workers share the
    cores (tests/test_torch_kernel_map.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
