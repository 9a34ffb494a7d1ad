"""Low-overhead span tracer.

``with span("ckpt.save", step=N):`` brackets one operation and produces a
span record when it closes:

    {"span": "ckpt.save", "span_id": 7, "parent_id": 3,
     "t0_s": 1.0234, "dur_s": 0.112, "ok": true, "step": 400}

Design constraints, in order:

- **Deterministic ids.** ``span_id`` is a process-local monotonic counter
  — never wall-clock, never random — so two runs of the same code produce
  the same id sequence and tests can assert on it.
- **Monotonic clock.** ``t0_s`` is seconds since the tracer was created
  (``time.monotonic`` deltas); durations cannot go negative across NTP
  steps.
- **Nesting.** A thread-local stack links children to parents
  (``parent_id``); concurrent threads (checkpoint async writer, serve
  admission) each get their own stack, so cross-thread spans never
  corrupt each other's lineage.
- **Near-zero cost when off.** ``DLCFN_OBS_OFF=1`` (or ``set_enabled(False)``)
  makes ``span(...)`` return a shared no-op context manager: no clock
  read, no allocation beyond the call itself. The train hot loop pays
  one truthiness check.

Span durations also feed a per-name :class:`~.metrics.Histogram`
(``span_dur_s{name=...}``) in the tracer's registry, so ``obs summarize``
and the Prometheus snapshot see latency distributions without re-parsing
the JSONL stream.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

from .metrics import MetricsRegistry

_OFF_ENV = "DLCFN_OBS_OFF"


def obs_enabled() -> bool:
    """Env gate, read per call so subprocess workers and in-process bench
    toggles both behave; `set_enabled` overrides it."""
    if _FORCED is not None:
        return _FORCED
    return os.environ.get(_OFF_ENV, "") != "1"


_FORCED: Optional[bool] = None


def set_enabled(on: Optional[bool]) -> None:
    """Programmatic override of the env gate (None restores env control).
    The bench overhead smoke flips this to measure on-vs-off in one
    process."""
    global _FORCED
    _FORCED = on


class _NullSpan:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "span_id", "parent_id", "_t0",
                 "attrs")

    def __init__(self, tracer: "Tracer", name: str, span_id: int,
                 parent_id: Optional[int], attrs: Dict):
        self._tracer = tracer
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self._t0 = time.monotonic()

    def annotate(self, **attrs) -> None:
        """Attach attributes discovered mid-span (e.g. retry counts)."""
        self.attrs.update(attrs)

    def __enter__(self):
        self._tracer._push(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.monotonic() - self._t0
        self._tracer._pop(self, dur, ok=exc_type is None)
        return False


class Tracer:
    """Owns the id counter, the per-thread span stacks, the sinks, and a
    :class:`MetricsRegistry` fed with span durations."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry or MetricsRegistry()
        self._sinks: List = []
        self._next_id = 1
        self._id_lock = threading.Lock()
        self._local = threading.local()
        self._epoch = time.monotonic()
        self._dur_hist = self.registry.histogram(
            "span_dur_s", "span durations by name")

    # -- configuration -----------------------------------------------------

    def add_sink(self, sink) -> None:
        """``sink`` is anything with ``write(record: dict)``."""
        self._sinks.append(sink)

    def remove_sink(self, sink) -> None:
        try:
            self._sinks.remove(sink)
        except ValueError:
            pass

    # -- span lifecycle ----------------------------------------------------

    def span(self, name: str, **attrs):
        if not obs_enabled():
            return _NULL_SPAN
        with self._id_lock:
            sid = self._next_id
            self._next_id += 1
        stack = self._stack()
        parent = stack[-1].span_id if stack else None
        return _Span(self, name, sid, parent, attrs)

    def record_span(self, name: str, t0_monotonic: float, dur_s: float,
                    parent_id: Optional[int] = None, ok: bool = True,
                    **attrs) -> Optional[int]:
        """Emit a span retroactively from timestamps the caller already
        holds (``time.monotonic`` values on this tracer's clock). The
        serving engine uses this for per-request lifecycle spans — a
        request's queue wait and decode phases are only known at finish,
        long after a ``with span(...)`` block could have bracketed them.

        Returns the allocated span_id (so callers can parent children on
        it), or None when tracing is disabled."""
        if not obs_enabled():
            return None
        with self._id_lock:
            sid = self._next_id
            self._next_id += 1
        dur_s = max(float(dur_s), 0.0)
        self._dur_hist.observe(dur_s, name=name)
        if self._sinks:
            record = {
                "span": name,
                "span_id": sid,
                "parent_id": parent_id,
                "t0_s": round(t0_monotonic - self._epoch, 6),
                "dur_s": round(dur_s, 6),
                "ok": ok,
                **attrs,
            }
            for sink in list(self._sinks):
                sink.write(record)
        return sid

    def _stack(self) -> List[_Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, s: _Span) -> None:
        self._stack().append(s)

    def _pop(self, s: _Span, dur_s: float, ok: bool) -> None:
        stack = self._stack()
        if stack and stack[-1] is s:
            stack.pop()
        else:  # out-of-order exit (generator misuse); drop if present
            try:
                stack.remove(s)
            except ValueError:
                pass
        self._dur_hist.observe(dur_s, name=s.name)
        if not self._sinks:
            return
        record = {
            "span": s.name,
            "span_id": s.span_id,
            "parent_id": s.parent_id,
            "t0_s": round(s._t0 - self._epoch, 6),
            "dur_s": round(dur_s, 6),
            "ok": ok,
            **s.attrs,
        }
        for sink in list(self._sinks):
            sink.write(record)


_DEFAULT: Optional[Tracer] = None
_DEFAULT_LOCK = threading.Lock()


def get_tracer() -> Tracer:
    """The process-wide default tracer (created on first use)."""
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = Tracer()
    return _DEFAULT


def configured(tracer: Optional[Tracer]) -> None:
    """Swap the process default — tests install a fresh tracer so span ids
    restart at 1 and sinks don't leak across cases."""
    global _DEFAULT
    _DEFAULT = tracer


def span(name: str, **attrs):
    """Module-level convenience over the default tracer — the call sites
    in trainer/ckpt/serve/launcher all use this."""
    if not obs_enabled():
        return _NULL_SPAN
    return get_tracer().span(name, **attrs)
