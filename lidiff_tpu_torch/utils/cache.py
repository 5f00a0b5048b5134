"""Where the port's compiled kernels live (counterpart of
lidiff_tpu/utils/cache.py).

The JAX package points XLA's persistent compilation cache at a directory.
The port compiles nothing at run time but its kernel libraries: the CUDA
kernels of `ops/native.py` and the host C++ kernels of `native/`, each
built on first use into a build directory and looked up there by a hash
of its source and flags. `enable_compile_cache` points both at one
directory, so a library built once is found by every later process that
points there. It changes where kernels are built and nothing else.
"""

from __future__ import annotations

import os
import sys

from lidiff_tpu_torch import native as host_native
from lidiff_tpu_torch.ops import native as cuda_native

DEFAULT_DIR = cuda_native.BUILD_DIR     # lidiff_tpu_torch/_build/


def enable_compile_cache(cache_dir: str | None = None) -> bool:
    """Build and look up the kernel libraries in `cache_dir` (default
    `lidiff_tpu_torch/_build/`). Returns True once the directory exists
    and is writable; otherwise prints one line to stderr, leaves the
    build directory as it was and returns False. Builds nothing."""
    cache = os.path.abspath(cache_dir or DEFAULT_DIR)
    try:
        os.makedirs(cache, exist_ok=True)
    except OSError as e:
        print(f"[lidiff_tpu_torch] kernel cache {cache} unusable ({e}); "
              "kernels keep building in "
              f"{cuda_native.BUILD_DIR}", file=sys.stderr)
        return False
    if not os.access(cache, os.W_OK | os.X_OK):
        print(f"[lidiff_tpu_torch] kernel cache {cache} is not writable; "
              f"kernels keep building in {cuda_native.BUILD_DIR}",
              file=sys.stderr)
        return False
    cuda_native.BUILD_DIR = cache
    host_native.BUILD_DIR = cache
    return True
