"""Tiny sizes at which the benchmark's cells run on the CPU, through the
same drivers as on the card (the harness's look for a chip is skipped)."""

import time

import pytest

from benchmark import harness

SENSOR = {"upper": [2.0, -8.33, 6], "lower": [-8.83, -24.9, 6],
          "azimuth_steps": 120, "min_range": 3.5, "max_range": 50.0,
          "range_noise": 0.02}

TINY = {
    "diff.complete": {
        "config": {"data": {"num_points": 1200}, "model": {"cr": 0.25},
                   "diff": {"s_steps": 6},
                   "tpu": {"full_capacities": None,
                           "part_capacities": None}},
        "refine": {"data": {"num_points": 1200}, "model": {"cr": 0.25},
                   "tpu": {"full_capacities": None}},
        "traffic": {"pool": 2, "sensor": SENSOR},
        "env": {"LIDIFF_COMPUTE_DTYPE": "float32"}},
    "refine.train": {
        "config": {"data": {"num_points": 300}, "model": {"cr": 0.25},
                   "train": {"batch_size": 2},
                   "tpu": {"full_capacities": [640] * 5}},
        "traffic": {"sensor": {**SENSOR, "upper": [2.0, -8.33, 4],
                               "lower": [-8.83, -24.9, 4],
                               "azimuth_steps": 80},
                    "refine": {"items": 6, "stride": 1, "window": 3,
                               "sigma": 0.2, "clip": 0.3,
                               "max_range": 50.0, "voxel": 0.1,
                               "noise_points": 300, "full_points": 600}},
        "env": {"LIDIFF_COMPUTE_DTYPE": "float32"}},
}


@pytest.fixture
def tiny_run(monkeypatch):
    """run(cell, seed, **kw) -> Outcome of one tiny CPU run. The refiner's
    chamfer takes the grid path, as at the cell's size."""
    monkeypatch.setenv("LIDIFF_CHAMFER", "grid")

    def run(cell, seed=2 ** 31 + 11, overrides=None, **kw):
        r = harness.make_run(cell, seed, 0.0, False, time.perf_counter(),
                             device="cpu", overrides=overrides or TINY[cell],
                             **kw)
        return harness.run_cell(r)
    return run
