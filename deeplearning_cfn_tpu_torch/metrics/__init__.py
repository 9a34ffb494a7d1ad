"""Metrics output for the port (a copy of the JAX package's ``jsonl.py``)."""

from .jsonl import MetricsWriter, read_metrics  # noqa: F401
