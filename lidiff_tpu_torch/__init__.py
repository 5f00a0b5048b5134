"""PyTorch/CUDA port of lidiff_tpu for NVIDIA Hopper GPUs.

The layout mirrors `lidiff_tpu/` (ops/, models/, diffusion/, config.py) so
each module's counterpart is easy to find. The JAX package stays the
reference; this package imports torch, numpy and the standard library only.

Entry points run on `cuda` unless the caller passes `device="cpu"`; on the
CPU every hand-written kernel is replaced by its plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card. Asking for CUDA without one raises: no entry
    point silently falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path")
    return dev
