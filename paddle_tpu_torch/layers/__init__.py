"""paddle_tpu_torch.layers (reference: python/paddle/fluid/layers/__init__.py):
the builders of the decoder LM's and the Transformer's programs, the
learning-rate schedules and the training surface around them."""
from . import nn, ops, tensor, io, learning_rate_scheduler
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403

__all__ = sorted(set(nn.__all__ + ops.__all__ + tensor.__all__ + io.__all__
                     + learning_rate_scheduler.__all__))
