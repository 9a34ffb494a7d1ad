"""Continuous-batching NMT serving — the port of the JAX package's serve/.

``queue``, ``blockpool``, ``prefix`` and ``metrics`` are copies of the JAX
package's jax-free host modules; ``engine`` and ``loader`` are ports.
"""

from .blockpool import BlockAllocator, BlockPoolExhausted  # noqa: F401
from .engine import Engine  # noqa: F401
from .metrics import ServeMetrics, percentile  # noqa: F401
from .prefix import PrefixCache  # noqa: F401
from .queue import (  # noqa: F401
    DeadlineExceededError,
    OverloadError,
    Request,
    RequestQueue,
    RequestState,
)
