"""Build and load the hand-written CUDA kernels (see _build.py). The
kernels' wrappers live beside their ops: ops/attention.py (K1, K2, K4) and
ops/kv_cache.py (K3)."""
from ._build import (BUILD_DIR, SOURCES, build_all, cuda_tool, library_path,
                     load)

__all__ = ["BUILD_DIR", "SOURCES", "build_all", "cuda_tool", "library_path",
           "load"]
