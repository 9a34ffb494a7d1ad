"""The fleet signal bus: one rolling, time-windowed aggregator that
`obs tail --fleet`, `obs summarize --fleet`, and the (future) autoscale
controller all read from.

A copy of the JAX package's ``obs/signals.py``, which imports
nothing of JAX (the port never imports that package).

Before this module, the fleet aggregate was computed twice — once
post-hoc in :func:`~.report.summarize_fleet` and once live in
``obs tail`` — with separately maintained semantics. The bus is the
single fold: feed it the per-replica record streams (serve snapshots,
alert events, launch attempts, spans) in arrival order and it maintains

- **last-value state** per replica (queue depth, tokens/sec, admission
  counters, latency p95, retry-after hint, spec accept rate, slot
  occupancy) — exactly the values the old aggregations used, so the
  reported numbers are unchanged by construction;
- **rolling windows** over the headline series (latency p95, queue
  depth, tokens/sec), pruned to ``window_s`` of record time, each
  window honest about how many samples back it and what time span they
  cover;
- the **fleet aggregate** (sum tokens/sec, worst p95, done/submitted,
  alert count, launch health) consumed by the status line and report.

Determinism: the bus never reads a clock. Record time comes from the
record's own ``ts`` field (stamped by :class:`~..metrics.jsonl
.MetricsWriter` at write time); records without one advance a
monotonic per-bus sequence counter instead, so replaying the same
shards always yields the same snapshot.

``snapshot()`` returns the signal-snapshot dict (JSON-able; one per
line in a ``signals.jsonl`` stream) documented in
docs/OBSERVABILITY.md — the wire format the autoscaler reads.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .metrics import percentile

DEFAULT_WINDOW_S = 60.0

# serve_* snapshot keys folded into last-value replica state, keyed by
# the signal name they surface as.
_LAST_VALUE_KEYS: Tuple[Tuple[str, str], ...] = (
    ("queue_depth", "serve_queue_depth"),
    ("tokens_per_sec", "serve_tokens_per_sec"),
    ("tokens_generated", "serve_tokens_generated"),
    ("latency_p95_s", "serve_latency_p95_s"),
    ("completed", "serve_completed"),
    ("submitted", "serve_submitted"),
    ("rejected", "serve_rejected"),
    ("retry_after_hint_s", "serve_retry_after_hint_s"),
    ("spec_accept_rate", "serve_spec_accept_rate"),
    ("utilization", "serve_slot_occupancy"),
)

# Series that additionally get a rolling window.
_WINDOWED = ("latency_p95_s", "queue_depth", "tokens_per_sec")


class RollingWindow:
    """(ts, value) pairs pruned to the trailing ``window_s`` of record
    time. Percentiles are exact over the surviving samples; the
    snapshot always says how many samples and what time span back
    them."""

    def __init__(self, window_s: float = DEFAULT_WINDOW_S):
        if window_s <= 0:
            raise ValueError("window_s must be > 0")
        self.window_s = float(window_s)
        self._items: deque = deque()

    def add(self, ts: float, value: float) -> None:
        self._items.append((float(ts), float(value)))
        self._prune(ts)

    def _prune(self, now: float) -> None:
        cutoff = float(now) - self.window_s
        items = self._items
        while items and items[0][0] < cutoff:
            items.popleft()

    def values(self) -> List[float]:
        return [v for _, v in self._items]

    def count(self) -> int:
        return len(self._items)

    def last(self) -> Optional[float]:
        return self._items[-1][1] if self._items else None

    def percentile(self, q: float) -> Optional[float]:
        return percentile(self.values(), q)

    def bounds(self) -> Tuple[Optional[float], Optional[float]]:
        if not self._items:
            return None, None
        return self._items[0][0], self._items[-1][0]

    def snapshot(self) -> Dict[str, Any]:
        start, end = self.bounds()
        return {
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "last": self.last(),
            "samples": self.count(),
            "window_start_ts": start,
            "window_end_ts": end,
        }


class ReplicaSignal:
    """One replica's folded state: last values, rolling windows, alert
    and launch health. The fold rules are byte-compatible with the old
    ``TailState`` serve handling and ``summarize``'s last-snapshot
    semantics."""

    def __init__(self, window_s: float = DEFAULT_WINDOW_S):
        self.records = 0
        self.last: Dict[str, Any] = {name: None for name, _ in
                                     _LAST_VALUE_KEYS}
        self.windows: Dict[str, RollingWindow] = {
            name: RollingWindow(window_s) for name in _WINDOWED}
        self.alerts = 0
        self.last_alert: Optional[str] = None
        self.span_failures = 0
        self.launch_attempts = 0
        self.launch_outcomes: List[str] = []
        self.launch_outcome: Optional[str] = None
        self.launch_success: Optional[bool] = None

    def observe(self, rec: Dict[str, Any], ts: float) -> None:
        self.records += 1
        if rec.get("event") == "alert":
            self.alerts += 1
            self.last_alert = str(rec.get("rule", "?"))
            return
        if rec.get("event") == "launch_attempt":
            outcome = str(rec.get("outcome", "?"))
            self.launch_attempts += 1
            self.launch_outcomes.append(outcome)
            self.launch_outcome = outcome
            self.launch_success = bool(rec.get("success", outcome == "ok"))
            return
        if "span" in rec:
            if rec.get("ok") is False:
                self.span_failures += 1
            return
        if any(k.startswith("serve_") for k in rec):
            for name, key in _LAST_VALUE_KEYS:
                if key in rec:
                    self.last[name] = rec[key]
            for name in _WINDOWED:
                key = _key_of(name)
                if isinstance(rec.get(key), (int, float)):
                    self.windows[name].add(ts, rec[key])

    @property
    def launch_restarts(self) -> int:
        return max(0, self.launch_attempts - 1)

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"records": self.records, **self.last}
        out["windowed"] = {name: w.snapshot()
                          for name, w in self.windows.items()}
        out["alerts"] = self.alerts
        if self.last_alert is not None:
            out["last_alert"] = self.last_alert
        if self.span_failures:
            out["span_failures"] = self.span_failures
        if self.launch_attempts:
            out["launch"] = {
                "attempts": self.launch_attempts,
                "outcomes": list(self.launch_outcomes),
                "outcome": self.launch_outcome,
                "success": self.launch_success,
                "restarts": self.launch_restarts,
            }
        return out


def _key_of(name: str) -> str:
    for n, key in _LAST_VALUE_KEYS:
        if n == name:
            return key
    raise KeyError(name)


class SignalBus:
    """Fold per-replica record streams into the fleet aggregate.

    ``observe(replica, record)`` routes one record; ``fleet()`` is the
    aggregate dict; ``snapshot()`` is the serialized signal-snapshot
    (``{"event": "signal_snapshot", ...}``)."""

    def __init__(self, window_s: float = DEFAULT_WINDOW_S,
                 names: Optional[List[str]] = None):
        self.window_s = float(window_s)
        self.replicas: Dict[str, ReplicaSignal] = {}
        self._seq = 0
        for n in names or []:
            self.replica(n)

    def replica(self, name: str) -> ReplicaSignal:
        sig = self.replicas.get(name)
        if sig is None:
            sig = self.replicas[name] = ReplicaSignal(self.window_s)
        return sig

    def observe(self, replica: str, rec: Dict[str, Any],
                ts: Optional[float] = None) -> None:
        self._seq += 1
        if ts is None:
            ts = rec.get("ts")
        if not isinstance(ts, (int, float)):
            ts = float(self._seq)
        self.replica(replica).observe(rec, float(ts))

    # -- aggregate ---------------------------------------------------------

    def fleet(self) -> Dict[str, Any]:
        """The fleet aggregate. Sums/extrema are over replicas' last
        values (the semantics `summarize --fleet` and the status line
        always had); ``None`` means "no replica reported it", matching
        the null-over-zero convention."""

        def _vals(name):
            return [s.last[name] for s in self.replicas.values()
                    if isinstance(s.last[name], (int, float))]

        def _sum(name):
            vals = _vals(name)
            return sum(vals) if vals else None

        p95s = _vals("latency_p95_s")
        hints = _vals("retry_after_hint_s")
        accept = _vals("spec_accept_rate")
        util = _vals("utilization")
        launch_attempts = sum(s.launch_attempts
                              for s in self.replicas.values())
        failed = sorted(n for n, s in self.replicas.items()
                        if s.launch_attempts and not s.launch_success)
        return {
            "replicas": len(self.replicas),
            "replicas_live": sum(1 for s in self.replicas.values()
                                 if s.records),
            "queue_depth": _sum("queue_depth"),
            "tokens_per_sec": _sum("tokens_per_sec"),
            "tokens_generated": _sum("tokens_generated"),
            "submitted": _sum("submitted"),
            "completed": _sum("completed"),
            "rejected": _sum("rejected"),
            "worst_latency_p95_s": max(p95s) if p95s else None,
            "retry_after_pressure_s": max(hints) if hints else None,
            "spec_accept_rate_min": min(accept) if accept else None,
            "utilization_mean": (sum(util) / len(util)) if util else None,
            "alerts": sum(s.alerts for s in self.replicas.values()),
            "launch_attempts": launch_attempts,
            "launch_restarts": sum(s.launch_restarts
                                   for s in self.replicas.values()),
            "launch_failed_replicas": failed,
        }

    def snapshot(self) -> Dict[str, Any]:
        """One signal-snapshot record (JSON-able): the autoscaler wire
        format, also what ``bench --fleet`` serializes to
        ``signals.jsonl``."""
        return {
            "event": "signal_snapshot",
            "seq": self._seq,
            "window_s": self.window_s,
            "fleet": self.fleet(),
            "replicas": {n: s.snapshot()
                         for n, s in sorted(self.replicas.items())},
        }
