"""The benchmark's harness, driven by data.

`BENCHMARK.json` at the root names every cell, configuration, traffic mix
and metric. Each of them lives in files of its own, found by name:

- `benchmark/workloads/<cell>.json`: the driver that runs the cell and the
  limits of the numbers its correctness check compares;
- `benchmark/drivers/<driver>.py`: `run(run: Run) -> Outcome`;
- `benchmark/configs/<config>.json`: the configuration as it is run;
- `benchmark/traffic/<mix>.json`: the parameters `benchmark/scene.py`
  makes the cell's inputs from;
- `benchmark/metrics/<metric>.py`: `read(layer: dict) -> float | None`,
  a per-layer metric read from what a traced run recorded.

A cell, a configuration, a traffic mix or a metric is added by adding its
files and its entry in `BENCHMARK.json`.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
from dataclasses import dataclass, field

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
# top-level module names the measured process must not hold: JAX and the
# JAX package (whose name the port's begins with)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "lidiff_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def environ(values: dict):
    """The process environment with `values` set, restored afterwards."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def spec(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def config_file(bench: dict, name: str, root: str = ROOT) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return load_json(os.path.join(root, entry["file"]))


@dataclass
class Run:
    """One run of a cell: what the driver needs."""
    cell: dict           # the cell's entry in BENCHMARK.json
    workload: dict       # benchmark/workloads/<cell>.json
    config: dict         # benchmark/configs/<config>.json
    traffic: dict        # benchmark/traffic/<mix>.json
    bench: dict          # BENCHMARK.json
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float            # perf_counter at the process's start
    # "lower": the check judges the plain reference one precision below
    # the configuration's, in the program's place (benchmark/control.py)
    control: str | None = None
    overrides: dict = field(default_factory=dict)   # tests: small sizes
    here: str = HERE     # the benchmark's folder

    def config_named(self, name: str) -> dict:
        """A configuration that this one runs beside it (the pipeline's
        refiner), by its file `benchmark/configs/<name>.json`."""
        return load_json(os.path.join(self.here, "configs", name + ".json"))


@dataclass
class Outcome:
    e2e: dict            # end-to-end metric -> value (trace off)
    attempted: int
    failed: int
    checks: list         # (name, value, limit): correct iff value <= limit
    peak_bytes: int
    layer: dict          # what the per-layer metric readers read
    notes: list = field(default_factory=list)   # lines for stderr
    busy_s: float | None = None
    window_s: float | None = None
    breakdown: dict | None = None

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(v <= lim for _, v, lim
                                        in self.checks if lim is not None)


def make_run(name: str, seed: int, seconds: float, trace: bool, t0: float,
             device: str = "cuda", root: str = ROOT, **kw) -> Run:
    """The run of cell `name` as the files under `root` describe it."""
    bench = spec(root)
    here = os.path.join(root, "benchmark")
    cell = next(c for c in bench["workloads"] if c["name"] == name)
    return Run(cell=cell,
               workload=load_json(os.path.join(here, "workloads",
                                               name + ".json")),
               config=config_file(bench, cell["config"], root),
               traffic=load_json(os.path.join(here, "traffic",
                                              cell["traffic"] + ".json")),
               bench=bench, seed=seed, seconds=seconds, trace=trace,
               device=device, t0=t0, here=here, **kw)


def driver(run: Run):
    name = run.workload["driver"]
    return load_module(os.path.join(run.here, "drivers", name + ".py"),
                       f"benchmark_driver_{name}")


def run_cell(run: Run) -> Outcome:
    return driver(run).run(run)


def end_to_end(run: Run, out: Outcome) -> dict:
    metrics = {}
    for m in run.bench["end_to_end"]:
        if "workloads" in m and run.cell["name"] not in m["workloads"]:
            continue
        if m["name"] in out.e2e:
            metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                  "unit": m["unit"]}
    return metrics


def per_layer(run: Run, out: Outcome) -> dict:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing to read returns None and the metric is left out."""
    metrics = {}
    for m in run.bench["per_layer"]:
        if run.cell["name"] not in m["workloads"]:
            continue
        mod = load_module(os.path.join(run.here, "metrics",
                                       m["name"] + ".py"),
                          "benchmark_metric_" + m["name"].replace(".", "_"))
        value = mod.read(out.layer)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def main(args, t0: float) -> int:
    import torch
    bench = spec()
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    card = power_limit()
    run = make_run(args.workload, args.seed, args.seconds,
                   bool(args.trace), t0)
    out = run_cell(run)
    metrics = per_layer(run, out) if run.trace else end_to_end(run, out)
    found = forbidden_modules()
    if found:
        print("the measured process holds " + ", ".join(found)
              + ": the benchmark measures the PyTorch port alone",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out.peak_bytes}
    if run.trace:
        device["busy_s"] = out.busy_s
        device["window_s"] = out.window_s
    result = {"correct": out.correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": device}
    if run.trace and out.breakdown:
        result["breakdown"] = out.breakdown
    result["card"] = card
    checks = [c for c in out.checks if c[2] is not None]
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    for line in out.notes:
        print(line, file=sys.stderr)
    print(f"card: {card}", file=sys.stderr)
    for name, v, lim in checks:
        print(f"check {name}: {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
