#!/usr/bin/env python3
"""Kernel A3 (the column conv's bf16 weight gradient) built with other
values of its tuning constants, timed side by side on one GPU.

    python3 scripts/torch_a3_variants.py

Builds `csrc/conv3_columns_dw.cu` as it is and with each variant below
(the producer warpgroup's register budget, the ring's stage count), makes
the sampling path's 180k-point pyramid (t ~ T) as chip_smoke.py does, and
for each width holds every build to the plain version (the error is a
share of max|ref|) and times it by CUDA events, also at other block
targets (`sparse_conv.DW_BLOCKS`). Prints the card's name and power limit
first. Compare builds only within one run.
"""

import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

REGS = "static constexpr int kProducerRegs = 56;"
STAGES = "static constexpr int kStages = 3;"
WIDTHS = [(384, 256, 3), (128, 256, 4), (256, 256, 4), (64, 128, 3),
          (192, 128, 2), (32, 32, 0), (96, 96, 0)]
BLOCKS = (528, 1056)


def main() -> int:
    import torch

    import chip_smoke as cs
    from lidiff_tpu_torch import config as cfg_mod
    from lidiff_tpu_torch.models import diffusion
    from lidiff_tpu_torch.ops import native
    from lidiff_tpu_torch.ops import sparse_conv as sc
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    native.build_all()
    csrc = os.path.join(ROOT, "lidiff_tpu_torch", "csrc")
    with open(os.path.join(csrc, "conv3_columns_dw.cu")) as f:
        src = f.read()
    assert REGS in src and STAGES in src, "the constants moved"
    variants = {"as is": src,
                "producer 40 registers": src.replace(
                    REGS, REGS.replace("56", "40")),
                "4 stages": src.replace(STAGES, STAGES.replace("3", "4"))}
    fns = {}
    with tempfile.TemporaryDirectory() as d:
        for i, (name, text) in enumerate(variants.items()):
            path = os.path.join(d, f"v{i}.cu")
            with open(path, "w") as f:
                f.write(text)
            so = os.path.join(d, f"v{i}.so")
            subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-I", csrc,
                            "-o", so, path], check=True, capture_output=True)
            fn = ctypes.CDLL(so).conv3_columns_dw
            fn.argtypes = sc._conv3_dw_kernel.argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
        cfg = cfg_mod.finalize_config(cs.make_cfg(
            cs.N_PART * cs.TILE, 4, caps={"capacity_fractions": [1.0] * 5}))
        task = diffusion.DiffusionTask(cfg, device="cuda",
                                       compute_dtype=torch.bfloat16, seed=0)
        part = torch.from_numpy(cs.ring_scan(cs.N_PART)).cuda()
        x_init = part.repeat(1, cs.TILE, 1)
        gen = torch.Generator(device="cuda").manual_seed(9)
        pyr = task.pyramid_full(x_init + torch.randn(
            x_init.shape, generator=gen, device="cuda"))
        gen = torch.Generator(device="cuda").manual_seed(5)
        kernel = sc._conv3_dw_kernel
        for cin, cout, li in WIDTHS:
            lvl = pyr.levels[li]
            g, km = lvl.geom, lvl.kmap3
            f, cot, _ = cs._conv_inputs(lvl, cin, cout, 1, torch.bfloat16,
                                        gen, "cuda")
            a3 = (f, cot.to(torch.bfloat16), km.col_idx, km.hit, g.mask, 1)
            ref = sc.conv3_columns_dw_plain(*a3)
            scale = float(ref.abs().max())
            res = []
            for blocks in BLOCKS:
                sc.DW_BLOCKS = blocks
                for name, fn in fns.items():
                    kernel._fn = fn
                    err = float((sc.conv3_columns_dw(*a3, plan=km.plan())
                                 - ref).abs().max()) / scale
                    ms = cs._time_ms(lambda: sc.conv3_columns_dw(
                        *a3, plan=km.plan()))
                    res.append(f"{name}, {blocks} blocks: {ms:.4f} ms "
                               f"(err {err:.1e})")
            print(f"A3 ({cin},{cout}) L{li} G=1: " + "; ".join(res),
                  flush=True)
        kernel._fn = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
