"""Declarative SLO rules over metric streams → ``alert`` events.

A copy of the JAX package's ``obs/slo.py``, which imports
nothing of JAX (the port never imports that package).

``dlcfn-tpu obs check <run> --rules rules.json`` evaluates a rules file
over a run's JSONL records and exits nonzero when any rule fired — the CI
gate the ROADMAP's "the system tells you when it got worse" line needs.
The same engine runs streaming (``SloEngine.observe`` per record, or an
:class:`AlertingWriter` wrapped around a live MetricsWriter), emitting
``{"event": "alert", ...}`` records **into the same JSONL stream** so
``obs summarize``, ``obs tail`` and the trace exporter all see alerts in
context.

Rules file (JSON — the repo's no-new-deps posture rules out YAML):

    {"rules": [
      {"name": "queue-wait-p95", "metric": "serve_queue_wait_p95_s",
       "kind": "threshold", "max": 0.5},
      {"name": "step-time-p95", "metric": "step_time_s",
       "kind": "percentile", "q": 95, "max": 1.0, "min_count": 5},
      {"name": "throughput-drop", "metric": "examples_per_sec",
       "kind": "drop", "max_drop_frac": 0.2, "warmup": 3}
    ]}

Three kinds:

- ``threshold`` — fires when the observed value is strictly above
  ``max`` / strictly below ``min``. A value exactly AT the limit does
  not fire (the limit is the contract, not a breach).
- ``percentile`` — maintains the sample series and fires when its
  ``q``-th percentile (exact, :func:`obs.metrics.percentile`) crosses
  ``max``/``min``; ``min_count`` (default 1) suppresses evaluation until
  enough samples exist.
- ``drop`` — rate-of-change guard for higher-is-better series: fires
  when the value falls more than ``max_drop_frac`` below the running
  peak, after ``warmup`` observations have established one.
- ``phase_budget`` — a latency SLO decomposed into per-phase budgets:

      {"name": "request-p95", "kind": "phase_budget",
       "metric": "serve_latency_p95_s", "max": 1.0,
       "phases": {
         "prefill": {"metric": "serve_phase_prefill_p95_s",
                     "budget": 0.2},
         "decode": {"metric": "serve_phase_decode_p95_s",
                    "budget": 0.7}}}

  fires exactly like ``threshold`` on ``metric`` > ``max``, but the
  alert carries a ``phase`` attribution: the phase whose last observed
  metric most exceeds its budget (largest observed/budget ratio above
  1), or ``"unattributed"`` when the total blew up with every phase
  inside budget — so `obs check` says WHICH stage of the request to go
  look at, not just that the p95 is bad.

Any rule may carry an optional ``"class"`` — the per-tenant QoS form:

    {"name": "latency-tenant-p95", "metric": "latency_p95_s",
     "class": "latency", "kind": "threshold", "max": 0.5}

instead of a top-level record key, the value is looked up through the
serve snapshot's nested ``serve_qos_by_class[<class>][<metric>]``
(``completed`` / ``latency_p50_s`` / ``latency_p95_s``), so each QoS
class gets its own SLO — the batch tenant's p95 budget can be 20x the
latency tenant's without either masking the other.

Alerts are **edge-triggered**: a rule that stays in breach emits one
alert at the ok→breach transition (and re-arms after recovering), so a
degraded run produces a handful of alert lines, not one per record.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from .metrics import percentile
from .report import collect

KINDS = ("threshold", "percentile", "drop", "phase_budget")


class RuleError(ValueError):
    """A rules file that cannot be evaluated (unknown kind, no limits)."""


class Rule:
    """One parsed rule plus its streaming evaluation state."""

    def __init__(self, spec: Dict[str, Any]):
        if not isinstance(spec, dict):
            raise RuleError(f"rule must be an object, got {spec!r}")
        self.metric = spec.get("metric")
        if not isinstance(self.metric, str) or not self.metric:
            raise RuleError(f"rule needs a 'metric' string: {spec!r}")
        self.kind = spec.get("kind", "threshold")
        if self.kind not in KINDS:
            raise RuleError(
                f"rule {self.metric!r}: unknown kind {self.kind!r} "
                f"(expected one of {', '.join(KINDS)})")
        self.qos_class = spec.get("class")
        if self.qos_class is not None and (
                not isinstance(self.qos_class, str) or not self.qos_class):
            raise RuleError(
                f"rule {self.metric!r}: 'class' must be a non-empty "
                f"string, got {self.qos_class!r}")
        self.name = str(spec.get("name") or f"{self.metric}-{self.kind}")
        self.max = spec.get("max")
        self.min = spec.get("min")
        self.q = float(spec.get("q", 95))
        self.min_count = int(spec.get("min_count", 1))
        self.warmup = int(spec.get("warmup", 1))
        self.max_drop_frac = spec.get("max_drop_frac")
        if self.kind in ("threshold", "percentile") \
                and self.max is None and self.min is None:
            raise RuleError(f"rule {self.name!r}: needs 'max' and/or 'min'")
        if self.kind == "drop":
            if self.max_drop_frac is None:
                raise RuleError(
                    f"rule {self.name!r}: drop rules need 'max_drop_frac'")
            self.max_drop_frac = float(self.max_drop_frac)
        self.phases: Dict[str, Dict[str, Any]] = {}
        if self.kind == "phase_budget":
            if self.max is None:
                raise RuleError(
                    f"rule {self.name!r}: phase_budget rules need 'max'")
            phases = spec.get("phases")
            if not isinstance(phases, dict) or not phases:
                raise RuleError(
                    f"rule {self.name!r}: phase_budget rules need a "
                    f"non-empty 'phases' object")
            for pname, p in phases.items():
                if not isinstance(p, dict) \
                        or not isinstance(p.get("metric"), str) \
                        or not isinstance(p.get("budget"), (int, float)) \
                        or isinstance(p.get("budget"), bool) \
                        or p["budget"] <= 0:
                    raise RuleError(
                        f"rule {self.name!r}: phase {pname!r} needs a "
                        f"'metric' string and a positive 'budget'")
                self.phases[str(pname)] = {
                    "metric": p["metric"], "budget": float(p["budget"])}
        # Streaming state.
        self.breached = False       # edge-trigger latch
        self.fired = 0              # total ok→breach transitions
        self._samples: List[float] = []
        self._peak: Optional[float] = None
        self._seen = 0
        self._phase_last: Dict[str, float] = {}

    def _evaluate(self, v: float) -> Optional[Dict[str, Any]]:
        """None when within SLO; otherwise {value, limit, detail}."""
        if self.kind == "threshold":
            if self.max is not None and v > self.max:
                return {"value": v, "limit": self.max,
                        "detail": f"{self.metric}={v:.6g} > max {self.max}"}
            if self.min is not None and v < self.min:
                return {"value": v, "limit": self.min,
                        "detail": f"{self.metric}={v:.6g} < min {self.min}"}
            return None
        if self.kind == "percentile":
            self._samples.append(v)
            if len(self._samples) < self.min_count:
                return None
            p = percentile(self._samples, self.q)
            if self.max is not None and p > self.max:
                return {"value": p, "limit": self.max,
                        "detail": f"p{self.q:g}({self.metric})={p:.6g} "
                                  f"> max {self.max} "
                                  f"over {len(self._samples)} samples"}
            if self.min is not None and p < self.min:
                return {"value": p, "limit": self.min,
                        "detail": f"p{self.q:g}({self.metric})={p:.6g} "
                                  f"< min {self.min} "
                                  f"over {len(self._samples)} samples"}
            return None
        if self.kind == "phase_budget":
            if v <= self.max:
                return None
            worst: Optional[str] = None
            worst_ratio = 0.0
            for pname, p in sorted(self.phases.items()):
                last = self._phase_last.get(pname)
                if last is None:
                    continue
                ratio = last / p["budget"]
                if ratio > worst_ratio:
                    worst, worst_ratio = pname, ratio
            if worst is not None and worst_ratio > 1.0:
                phase = worst
                why = (f"{phase} at "
                       f"{self._phase_last[phase]:.6g}s of "
                       f"{self.phases[phase]['budget']:g}s budget "
                       f"({worst_ratio:.2f}x)")
            else:
                phase = "unattributed"
                why = "every phase within budget"
            return {"value": v, "limit": self.max, "phase": phase,
                    "detail": f"{self.metric}={v:.6g} > max {self.max}; "
                              f"blown phase: {why}"}
        # drop
        self._seen += 1
        prev_peak = self._peak
        if self._peak is None or v > self._peak:
            self._peak = v
        if prev_peak is None or self._seen <= self.warmup:
            return None
        drop = (prev_peak - v) / prev_peak if prev_peak > 0 else 0.0
        if drop > self.max_drop_frac:
            return {"value": v, "limit": self.max_drop_frac,
                    "detail": f"{self.metric}={v:.6g} dropped "
                              f"{drop * 100:.1f}% below peak "
                              f"{prev_peak:.6g} (max "
                              f"{self.max_drop_frac * 100:g}%)"}
        return None

    def observe(self, record: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        if self.kind == "phase_budget":
            # Phase metrics ride in the same stream; remember the last
            # observation of each so a breach can be attributed even
            # when the total and the phases arrive in separate records.
            for pname, p in self.phases.items():
                pv = record.get(p["metric"])
                if isinstance(pv, (int, float)) \
                        and not isinstance(pv, bool):
                    self._phase_last[pname] = float(pv)
        if self.qos_class is not None:
            # Per-tenant form: the value lives in the serve snapshot's
            # nested per-class section, not at the record's top level.
            by_cls = record.get("serve_qos_by_class")
            cls_rec = by_cls.get(self.qos_class) \
                if isinstance(by_cls, dict) else None
            v = cls_rec.get(self.metric) \
                if isinstance(cls_rec, dict) else None
        else:
            v = record.get(self.metric)
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            return None
        breach = self._evaluate(float(v))
        if breach is None:
            self.breached = False
            return None
        if self.breached:        # still in breach — already alerted
            return None
        self.breached = True
        self.fired += 1
        alert = {"event": "alert", "rule": self.name,
                 "metric": self.metric, "kind": self.kind, **breach}
        if self.qos_class is not None:
            alert["class"] = self.qos_class
        if isinstance(record.get("step"), (int, float)):
            alert["step"] = record["step"]
        return alert


def load_rules(path: str) -> List[Rule]:
    """Parse a rules JSON file; raises :class:`RuleError` on anything the
    engine could not faithfully evaluate (a silently-skipped rule is a
    gate that always passes)."""
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except json.JSONDecodeError as e:
        raise RuleError(f"{path}: not valid JSON ({e})")
    specs = doc.get("rules") if isinstance(doc, dict) else None
    if not isinstance(specs, list) or not specs:
        raise RuleError(f"{path}: expected {{\"rules\": [...]}} with at "
                        f"least one rule")
    return [Rule(s) for s in specs]


class SloEngine:
    """Feed records in stream order; collect fired alerts."""

    def __init__(self, rules: List[Rule]):
        self.rules = rules
        self.alerts: List[Dict[str, Any]] = []

    @classmethod
    def from_file(cls, path: str) -> "SloEngine":
        return cls(load_rules(path))

    def observe(self, record: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Evaluate one record against every rule; returns (and retains)
        the alerts this record triggered."""
        fired = []
        for rule in self.rules:
            a = rule.observe(record)
            if a is not None:
                fired.append(a)
        self.alerts.extend(fired)
        return fired


class AlertingWriter:
    """Wrap a MetricsWriter (anything with ``write(dict)``) so alerts are
    emitted inline, right after the record that triggered them — live
    runs get SLO events in the same metrics.jsonl the post-hoc tools
    read."""

    def __init__(self, writer, engine: SloEngine):
        self._writer = writer
        self.engine = engine

    def write(self, record: Dict[str, Any]) -> None:
        self._writer.write(record)
        for alert in self.engine.observe(record):
            self._writer.write(alert)

    def close(self) -> None:
        close = getattr(self._writer, "close", None)
        if close is not None:
            close()


def check_run(path: str, rules_path: str) -> Dict[str, Any]:
    """Post-hoc gate: evaluate rules over a recorded run (file or dir).
    Existing ``alert`` records in the stream are skipped (re-checking a
    run that already alerted live must not double-count)."""
    engine = SloEngine.from_file(rules_path)
    records, files, skipped = collect(path)
    for r in records:
        if r.get("event") == "alert":
            continue
        engine.observe(r)
    return {
        "path": path,
        "rules": len(engine.rules),
        "records": len(records),
        "files": len(files),
        "skipped_lines": skipped,
        "alerts": engine.alerts,
        "ok": not engine.alerts,
    }
