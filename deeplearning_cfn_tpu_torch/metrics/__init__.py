"""Metrics for the port (copies of the JAX package's jax-free ``jsonl.py``
and ``bleu.py``)."""

from .bleu import corpus_bleu  # noqa: F401
from .jsonl import MetricsWriter, read_metrics  # noqa: F401
