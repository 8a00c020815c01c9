"""C++ host runtime (counterpart of paddle_tpu/runtime): runtime.cc,
built with g++ on first use into build/paddle_tpu_torch/ (build.py), bound
by recordio.py: recordio chunk IO, prefetch readers, bounded channels, the
staging arena, the array-frame codec and the threaded batch gather, with
a Python branch of the same on-disk format where no compiler is found.

Not ported: the embeddable C ABI (capi.cc, ptrt_capi.h) and the AOT
executable cache (aot_cache.py) of the JAX package's runtime."""
from .recordio import (  # noqa: F401
    Channel,
    PrefetchReader,
    RecordIOError,
    RecordIOReader,
    RecordIOWriter,
    StagingArena,
    native_available,
    recordio_convert,
    recordio_sample_reader,
)

__all__ = [
    "Channel",
    "PrefetchReader",
    "RecordIOError",
    "RecordIOReader",
    "RecordIOWriter",
    "StagingArena",
    "native_available",
    "recordio_convert",
    "recordio_sample_reader",
]
