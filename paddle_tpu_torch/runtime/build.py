"""Build the C++ host runtime (runtime.cc) on first use.

``g++ -O2 -std=c++17 -shared -fPIC -pthread runtime.cc -lz`` into the
port's build directory (``build/paddle_tpu_torch/``, beside the CUDA
kernels; never beside the source), as ``_ptrt_<hash>.so`` where the hash
is the source's, so an edited source rebuilds and an unchanged one is
reused. Each process compiles into a temporary file of its own and
renames it into place, so processes that build at once (test workers)
never load a half-written library. Where no compiler is found,
``lib_path()`` returns None and records why (``build_error()``):
runtime/recordio.py then runs its Python branch of the same on-disk
format.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import threading
import time
from typing import List, Optional, Tuple

from ..kernels._build import BUILD_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "runtime.cc")
_PREFIX = "_ptrt_"


def _build_cached(src: str, prefix: str, extra_args: List[str]
                  ) -> Tuple[Optional[str], Optional[str]]:
    """Compile ``src`` into ``BUILD_DIR/<prefix><contenthash>.so`` (kept
    across calls), removing stale builds of the same prefix. Returns
    (path, None) or (None, error)."""
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    name = "%s%s.so" % (prefix, digest)
    out = os.path.join(BUILD_DIR, name)
    if not os.path.exists(out):
        tmp = "%s.%d.tmp" % (out, os.getpid())
        cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
               src, "-o", tmp] + extra_args
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            os.replace(tmp, out)
        except (subprocess.CalledProcessError, OSError) as e:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None, getattr(e, "stderr", None) or str(e)
    for entry in os.listdir(BUILD_DIR):
        if (entry.startswith(prefix) and entry.endswith(".so")
                and entry != name and len(entry) == len(name)):
            try:
                os.remove(os.path.join(BUILD_DIR, entry))
            except OSError:
                pass
    return out, None


_lock = threading.Lock()
_lib_path = None
_build_error = None
build_seconds = None


def lib_path() -> Optional[str]:
    """The built runtime library's path, or None (with the error
    recorded) where it cannot be built."""
    global _lib_path, _build_error, build_seconds
    with _lock:
        if _lib_path is None and _build_error is None:
            t0 = time.perf_counter()
            _lib_path, _build_error = _build_cached(_SRC, _PREFIX, ["-lz"])
            build_seconds = time.perf_counter() - t0
        return _lib_path


def build_error() -> Optional[str]:
    return _build_error
