"""paddle_tpu_torch.parallel (counterpart of paddle_tpu/parallel): the
mixture-of-experts FFN's single-device math (moe.py). The multi-device
paths (data, tensor, pipeline, sequence and expert parallelism) wait for
the port's multi-device slice."""
from . import moe  # noqa: F401
from .moe import MoEParams, moe_capacity, moe_ffn_local  # noqa: F401

__all__ = ["MoEParams", "moe_capacity", "moe_ffn_local"]
