"""Continuous-batching NMT serving — the port of the JAX package's serve/.

``queue``, ``blockpool``, ``prefix``, ``radix`` and ``metrics`` are copies of
the JAX package's jax-free host modules; ``engine``, ``loader`` and
``quant`` are ports (``quantize_model`` is the JAX ``quantized_model`` and
``quantize_variables`` in one: the port's model holds its weights).
"""

from .blockpool import BlockAllocator, BlockPoolExhausted  # noqa: F401
from .engine import Engine  # noqa: F401
from .metrics import ServeMetrics, percentile  # noqa: F401
from .prefix import PrefixCache  # noqa: F401
from .quant import (  # noqa: F401
    quantize_model,
    quantize_state_dict,
    variables_bytes,
)
from .queue import (  # noqa: F401
    DEFAULT_QOS_CLASS,
    DeadlineExceededError,
    OverloadError,
    QosSpec,
    RateLimitError,
    Request,
    RequestQueue,
    RequestState,
    default_qos_classes,
)
from .radix import RadixCache, RadixNode  # noqa: F401
