#!/usr/bin/env python3
"""Readings that the limits of a cell's correctness check are set from.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,...
        [--control-seeds 101,102,...]

runs the cell, one request a seed (`--seconds 0`: the window closes after
its first request), in one process: the program as the cell runs it on
`--seeds`, then the control on `--control-seeds`: the plain reference one
precision below the configuration's, judged in the program's place. Each
run prints one JSON line with every number its check compares. The lower
reading of a number is the largest over sound runs of the program; the
upper, the smallest over the control's runs.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    plan = [(int(s), None) for s in args.seeds.split(",") if s]
    plan += [(int(s), "lower") for s in args.control_seeds.split(",") if s]
    for seed, control in plan:
        t = time.perf_counter()
        run = harness.make_run(args.workload, seed, args.seconds, False, t,
                               control=control)
        out = harness.run_cell(run)
        print(json.dumps({"seed": seed, "control": control,
                          "correct": out.correct,
                          "seconds": time.perf_counter() - t,
                          "e2e": out.e2e,
                          "readings": {n: v for n, v, _ in out.checks}}),
              flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
