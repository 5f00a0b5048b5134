"""Config handling with the reference schema (counterpart of
lidiff_tpu/config.py:34-147).

The port keeps its own copy of the capacity tables: it imports nothing of
the JAX package. A config file is YAML or, by its `.json` suffix, JSON with
the same sections; `yaml` is imported only where a YAML file is read, so
JSON configs work where PyYAML is not installed.
"""

from __future__ import annotations

import json
import os


def _round128(x: int) -> int:
    """Capacities are multiples of 128 (the JAX package's kernel tile); kept
    so both packages size every level identically."""
    return max(128, (int(x) + 127) // 128 * 128)


# Worst-case per-level occupancy (unique voxels / num_points) of the noisy
# full cloud over the 50-step sampling trajectory, plus margin; the table
# and its derivation are documented in lidiff_tpu/config.py.
_FRACTION_TABLE = (
    (20_000, (1.0, 1.0, 1.0, 1.0, 1.0)),
    (50_000, (1.0, 1.0, 1.0, 1.0, 0.85)),
    (120_000, (1.0, 1.0, 1.0, 0.95, 0.6)),
    (10 ** 12, (1.0, 1.0, 1.0, 0.8, 0.4)),
)

# The same for the clean partial scan, keyed by its point count.
_PART_FRACTION_TABLE = (
    (5_000, (1.0, 1.0, 1.0, 1.0, 1.0)),
    (12_000, (1.0, 1.0, 1.0, 1.0, 0.9)),
    (10 ** 12, (1.0, 1.0, 1.0, 0.85, 0.62)),
)


def derive_capacities(num_points: int, fractions=None,
                      num_levels: int = 5, clean: bool = False) -> list[int]:
    """Static voxel capacities per pyramid level as occupancy fractions of
    the point count (`clean` selects the partial-scan table)."""
    if fractions is None:
        table = _PART_FRACTION_TABLE if clean else _FRACTION_TABLE
        fractions = next(f for lim, f in table if num_points <= lim)
    fractions = list(fractions) + [fractions[-1]] * num_levels
    return [_round128(max(int(num_points * fractions[i]), 1024))
            for i in range(num_levels)]


DEFAULT_TPU = {
    "full_capacities": None,     # derived from data.num_points if None
    "part_capacities": None,     # derived from data.num_points / 10
    "capacity_fractions": None,  # per-level fractions of num_points
    "num_levels": 5,
    "compute_dtype": "float32",  # or "bfloat16" for the fast path
}


def load_config(path: str) -> dict:
    """Read a `.json` or YAML config; the TRAIN_DATABASE environment
    variable overrides `data.data_dir`, as in the reference."""
    with open(path) as f:
        if path.endswith(".json"):
            cfg = json.load(f)
        else:
            import yaml
            cfg = yaml.safe_load(f)
    if os.environ.get("TRAIN_DATABASE"):
        cfg["data"]["data_dir"] = os.environ["TRAIN_DATABASE"]
    return finalize_config(cfg)


def save_config(cfg: dict, path: str) -> None:
    """Write `cfg` as JSON, which `load_config` reads back by its suffix."""
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2)


def finalize_config(cfg: dict) -> dict:
    cfg = dict(cfg)
    tpu = dict(DEFAULT_TPU)
    tpu.update(cfg.get("tpu", {}) or {})
    n = int(cfg["data"]["num_points"])
    if tpu["full_capacities"] is None:
        tpu["full_capacities"] = derive_capacities(
            n, tpu["capacity_fractions"], tpu["num_levels"])
    if tpu["part_capacities"] is None:
        tpu["part_capacities"] = derive_capacities(
            max(n // 10, 1024), tpu["capacity_fractions"],
            tpu["num_levels"], clean=True)
    cfg["tpu"] = tpu
    return cfg
