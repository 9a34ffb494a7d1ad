"""Open-loop trace-replay load generation for the serving fleet.

The port's copy of the JAX package's ``loadgen/`` (pure Python: the same
names, defaults and seeded draws; the port never imports the JAX package).

Three layers, smallest first:

- :mod:`.arrivals` — seeded arrival processes (Poisson, bursty on/off,
  diurnal ramp) as pure functions of their parameters and the seed.
- :mod:`.spec` — :class:`TraceSpec` / :class:`RequestClass` and the
  ``--trace`` string parser (:func:`parse_trace_spec`).
- :mod:`.replay` — :class:`LoadGenerator` (schedule builder),
  :class:`VirtualClock`, and :func:`replay`, which drives
  ``Router.submit`` on the virtual clock and folds per-request outcomes
  into the router ledger.
"""

from .arrivals import bursty_arrivals, diurnal_arrivals, poisson_arrivals
from .replay import (LoadGenerator, ReplayReport, ScheduledRequest,
                     VirtualClock, replay)
from .spec import (MIXES, PROCESSES, RequestClass, TraceSpec,
                   parse_trace_spec)

__all__ = [
    "MIXES",
    "PROCESSES",
    "LoadGenerator",
    "ReplayReport",
    "RequestClass",
    "ScheduledRequest",
    "TraceSpec",
    "VirtualClock",
    "bursty_arrivals",
    "diurnal_arrivals",
    "parse_trace_spec",
    "poisson_arrivals",
    "replay",
]
