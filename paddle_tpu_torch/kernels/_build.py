"""Build and load the port's hand-written CUDA kernels.

Each source under ``paddle_tpu_torch/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library with a plain C interface,
and loaded with ``ctypes``. A library's file name carries a hash of its
source and of the shared headers there, so an edited source or header
rebuilds and an unchanged one is reused. The
build runs at first use, into ``build/paddle_tpu_torch/`` beside the
package; ``build_all()`` starts one ``nvcc`` per source, all at once.

Nothing here runs at import: the CPU tests import every module, and the
CPU has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Tuple

__all__ = ["SOURCES", "BUILD_DIR", "build_all", "load", "library_path",
           "cuda_tool", "launch_counts"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "paddle_tpu_torch")
SOURCES = ("flash_fwd", "decode_attn", "flash_bwd", "flash_bwd_fused",
           "flash_fwd_bf16", "flash_bwd_bf16", "flash_bwd_fused_bf16")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): "
            "the CUDA kernels build on a machine with the CUDA toolkit")
    return path


def cuda_tool(name: str) -> str:
    """The path of a CUDA toolkit program beside nvcc (``cuobjdump``)."""
    return os.path.join(os.path.dirname(_nvcc()), name)


def _flags(defines: Tuple[str, ...]) -> list:
    return [*NVCC_FLAGS, *("-D" + d for d in defines)]


def _target(name: str, defines: Tuple[str, ...] = ()) -> str:
    """The library's path, named by a hash of its source, the shared
    headers (``*.cuh``) it may include, and the flags."""
    digest = hashlib.sha256(" ".join(_flags(defines)).encode())
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu"] + headers:
        with open(os.path.join(_CSRC, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (name, digest.hexdigest()[:12]))


def build_all(names: Iterable[str] = SOURCES,
              defines: Tuple[str, ...] = ()) -> Dict[str, float]:
    """Build every library in ``names`` that is not built yet, one nvcc
    process per source, all started together, each with the macros
    ``defines`` ("NAME=VALUE") set. Returns the seconds each build took;
    raises with nvcc's output if one fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    started = {}
    for name in names:
        target = _target(name, defines)
        if os.path.exists(target):
            continue
        tmp = "%s.%d.tmp" % (target, os.getpid())
        cmd = [_nvcc(), *_flags(defines), "-o", tmp,
               os.path.join(_CSRC, name + ".cu")]
        started[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         tmp, target, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, target, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append("%s (exit %d):\n%s" % (name, proc.returncode, log))
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built on first use
    (with the macros ``defines`` set: a variant, in a library of its
    own)."""
    key = (name, tuple(defines))
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            build_all([name], key[1])
            lib = _LIBS[key] = ctypes.CDLL(_target(*key))
        return lib


def library_path(name: str) -> str:
    """The path of the built library of kernel source ``name``, built on
    first use."""
    load(name)
    return _target(name)


def launch_counts(name: str, reset: bool = False, device: int = 0,
                  defines: Tuple[str, ...] = ()) -> Tuple[int, ...]:
    """The launches of library ``name``'s kernels, as the device counts
    them (csrc/launch_count.cuh: a launch inside a replayed CUDA graph
    counts like one from the host), one per kernel in the order its
    source declares them; ``reset`` zeroes them after the read. Reads
    after the legacy default stream's work only: synchronize first."""
    lib = load(name, defines)
    n = getattr(lib, name + "_launch_kernels")()
    out = (ctypes.c_ulonglong * n)()
    fn = getattr(lib, name + "_launch_counts")
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    err = fn(device, out, int(reset))
    if err:
        raise RuntimeError("%s: reading its launch counters failed with "
                           "CUDA error %d" % (name, err))
    return tuple(out)
