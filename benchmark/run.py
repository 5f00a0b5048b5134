#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch port on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: whether what the timed path produced was correct, the
requests attempted and failed, the cell's end-to-end metrics (`--trace 0`)
or its per-layer metrics (`--trace 1`), and the device; the numbers its
correctness check compared, each beside its limit, come last there and as
the last lines of standard error. Exits non-zero, printing no result, where
there is no card, or too few for the cell.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout
_CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE,
                                                  "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "nv")
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from benchmark import harness
    return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
