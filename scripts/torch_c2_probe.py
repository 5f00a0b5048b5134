#!/usr/bin/env python3
"""Kernel C2, the grid chamfer's 1-NN, at the refiner's shapes on one GPU,
without the rest of chip_smoke.py.

    python3 scripts/torch_c2_probe.py [--repeat N]

Builds the kernels (printing ptxas's registers, shared memory and spills),
makes the refiner's full-width clouds as chip_smoke.py does (the model's
eval forward: 1.08M upsampled points against a 360k-point target), and
runs chip_smoke.py's check_c2_case in both directions and on its two-item
batch: C2 against C1 on every valid query, against its plain version
(rows staged too) and the plain scan on whole tiles, with the times of
the index, the kernel and C1 over its own index. Then, for the two
chamfer directions, what chip_smoke.py does not measure: the kernel over
tiles of consecutive queries in lex order (the order the tile order
replaces; exact too), its time and pairs per valid query, and the index
build's largest kernels by torch.profiler. --repeat runs the two chamfer
directions N times, to see the spread of the times.
"""

import argparse
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def kernel_ms(fn, iters: int = 10) -> dict:
    """Device time per call of fn() by kernel name (torch.profiler), the
    gaps between kernels left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # "(anonymous namespace)::name(args)" -> name
            found = re.search(r"(\w+)\(", e.name.split("::")[-1])
            name = found.group(1) if found else e.name[:40]
            out[name] = out.get(name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / iters
    return out


def lex_order_and_index_split(cs, knn, label, q, qm, r, rm) -> None:
    """C2 over tiles in lex order of the queries against the tile order:
    equal indices, the kernel's time and the pairs per valid query of
    each; and the index build's four largest kernels."""
    import torch
    from lidiff_tpu_torch.ops import keys as K
    T, Vq, dev = knn.QTILE, q.shape[0], q.device
    nt = -(-Vq // T)
    index = knn.build_tile_index(r, rm, 1)
    nq = max(int(qm.sum()), 1)
    out = {}
    lex = K.lexsort(K.pack(q[:, 0], q[:, 1:])[0],
                    torch.arange(Vq, device=dev))[1].to(torch.int32)
    for name, order in (("tile order", knn.tile_order(q, qm, index)),
                        ("lex order", lex)):
        idx, staged = knn.nn_tiles(q, qm, index, order)
        out[name] = idx
        live = torch.zeros(nt * T, dtype=torch.bool, device=dev)
        live[:Vq] = qm[order.long()]
        pairs = float((staged.double() * live.reshape(nt, T).sum(1)).sum())
        ms = cs._device_ms(lambda: knn.nn_tiles(q, qm, index, order), 3)
        cs.log(f"C2 {label}, tiles in {name}: kernel {ms:.4f} ms, "
               f"{pairs / nq:.1f} pairs per valid query")
    if not torch.equal(out["tile order"], out["lex order"]):
        raise AssertionError(f"C2 ({label}) in lex order differs")

    def build():
        return knn.tile_order(q, qm, knn.build_tile_index(r, rm, 1))
    split = sorted(kernel_ms(build, 5).items(), key=lambda kv: -kv[1])[:4]
    cs.log(f"C2 {label}: the index and tile order's largest kernels "
           f"{ {k: round(v, 4) for k, v in split} } ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeat", type=int, default=1,
                    help="runs of the two chamfer directions (default 1)")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from lidiff_tpu_torch.ops import knn, native
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t0 = time.time()
    reports = native.build_all()
    cs.log(f"build: {len(reports)} libraries in {time.time() - t0:.1f} s")
    if "nn_match_tiled" in reports:
        cs.log_ptxas("nn_match_tiled", reports["nn_match_tiled"])
    dev = "cuda"
    cfg = {"model": {"cr": 1.0}}
    _, task, noisy, gt = cs.refine_inputs(cfg, dev)
    fwd, back = cs.chamfer_match_inputs(task, noisy, gt)
    del task
    for _ in range(args.repeat):
        cs.check_c2_case(knn, "chamfer, upsampled -> target", *fwd, 1,
                         c1_iters=2)
        cs.check_c2_case(knn, "chamfer, target -> upsampled", *back, 1,
                         c1_iters=2)
        lex_order_and_index_split(cs, knn, "upsampled -> target", *fwd)
        lex_order_and_index_split(cs, knn, "target -> upsampled", *back)
    cs.check_c2_case(knn, "two items, invalid rows",
                     *cs.batched_match_inputs(dev), 2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
