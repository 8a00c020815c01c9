"""Op kernels of paddle_tpu_torch. Importing this package registers every
kernel with the registry."""
from . import (attention, decode, fused_loss, kv_cache, math,  # noqa: F401
               nn, optim, quant, sampling, sequence, speculative)
from .registry import KERNELS, get_kernel, register_op

__all__ = ["KERNELS", "get_kernel", "register_op"]
