"""Observability for the port: copies of the JAX package's ``obs/`` modules,
all of which are pure Python (none imports JAX).

- :mod:`obs.metrics` — the :class:`MetricsRegistry` of typed instruments
  and the shared :func:`percentile`.
- :mod:`obs.trace` — the span tracer (``DLCFN_OBS_OFF=1`` turns it off).
- :mod:`obs.sinks` — the JSONL span sink, the Prometheus text snapshot, an
  in-memory sink for tests.
- :mod:`obs.report` — ``obs summarize``: the run report (step-time
  p50/p95, tokens/sec, checkpoint latency + retries, per-attempt launch
  outcomes), and the fleet report over a directory of replica run dirs.
- :mod:`obs.export` — ``obs export``: JSONL → Chrome/Perfetto
  ``trace.json``.
- :mod:`obs.slo` — ``obs check``: declarative SLO rules → alerts + an
  exit code.
- :mod:`obs.diff` — ``obs diff``: two runs' p50/p95 deltas and regressions.
- :mod:`obs.tail` — ``obs tail``: the live one-line status follower.
- :mod:`obs.signals` — the fleet signal bus (rolling-window aggregates).
"""

from .diff import diff_runs, render_diff  # noqa: F401
from .export import (  # noqa: F401
    build_fleet_trace,
    build_trace,
    export_fleet_trace,
    export_trace,
    validate_trace,
)
from .signals import RollingWindow, SignalBus  # noqa: F401
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    exponential_buckets,
    percentile,
)
from .report import render_report, summarize  # noqa: F401
from .slo import AlertingWriter, SloEngine, check_run, load_rules  # noqa: F401
from .tail import JsonlFollower, TailState, tail  # noqa: F401
from .sinks import (  # noqa: F401
    JsonlSink,
    MemorySink,
    render_prometheus,
    write_prometheus,
)
from .trace import (  # noqa: F401
    Tracer,
    configured,
    get_tracer,
    obs_enabled,
    set_enabled,
    span,
)

__all__ = [
    "AlertingWriter",
    "JsonlFollower",
    "RollingWindow",
    "SignalBus",
    "SloEngine",
    "TailState",
    "build_fleet_trace",
    "build_trace",
    "check_run",
    "diff_runs",
    "export_fleet_trace",
    "export_trace",
    "load_rules",
    "render_diff",
    "tail",
    "validate_trace",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "exponential_buckets",
    "percentile",
    "JsonlSink",
    "MemorySink",
    "render_prometheus",
    "write_prometheus",
    "render_report",
    "summarize",
    "Tracer",
    "configured",
    "get_tracer",
    "obs_enabled",
    "set_enabled",
    "span",
]
