#!/usr/bin/env python3
"""Kernel F1, farthest-point sampling on the card, without the rest of
chip_smoke.py.

    python3 scripts/torch_fps_probe.py

Builds the kernels (printing ptxas's lines for `fps`), then runs
chip_smoke.py's `check_f1`: F1 against `fps_plain` in every case and
against the host C++ copy at 18k picks of a 120k-point ring scan, with the
times of all three. About a minute with the build.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke as cs
    from lidiff_tpu_torch.ops import native
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t0 = time.time()
    reports = native.build_all()
    cs.log(f"build: {len(reports)} libraries in {time.time() - t0:.1f} s")
    cs.log_ptxas("fps", reports.get("fps", ""))
    cs.check_f1("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
