"""Observability for the port: copies of the JAX package's jax-free
``obs/metrics.py`` (registry, percentiles) and ``obs/trace.py`` (spans)."""
