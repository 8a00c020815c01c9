"""Op kernels of paddle_tpu_torch. Importing this package registers every
kernel with the registry."""
from . import (attention, fused_loss, kv_cache, math, nn,  # noqa: F401
               optim, sampling)
from .registry import KERNELS, get_kernel, register_op

__all__ = ["KERNELS", "get_kernel", "register_op"]
