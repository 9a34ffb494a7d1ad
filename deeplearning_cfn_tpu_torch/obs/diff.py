"""Cross-run regression diff: ``dlcfn-tpu obs diff <run_a> <run_b>``.

A copy of the JAX package's ``obs/diff.py``, which imports
nothing of JAX (the port never imports that package).

Aligns the metric series two runs share and reports per-metric p50/p95
deltas, flagging **regressions** — deltas in the bad direction beyond a
relative tolerance. Direction is metric-aware: throughputs
(``*_per_sec``, tokens/sec) regress when they fall, times/latencies
(``*_s`` series, span durations) and loss regress when they rise;
anything else is reported informationally and never gates. Comparing a
run against itself yields zero deltas and no regressions by construction
— the tier-1 self-diff smoke pins that.

The same comparator gates bench records: root ``bench.py`` calls
:func:`diff_bench_records` when ``DLCFN_BENCH_DIFF_AGAINST`` points at a
prior contract JSON, attaching the verdict to the new record.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from .metrics import percentile
from .report import collect

DEFAULT_TOLERANCE = 0.10

# Metrics where larger is better (everything matching LOWER_SUFFIXES is
# smaller-is-better; the rest is informational).
_HIGHER = ("examples_per_sec", "serve_tokens_per_sec", "value", "mfu",
           "serve_slot_occupancy", "serve_steps_per_window",
           "serve_prefix_hit_rate")
_LOWER = ("loss", "mean_step_s", "compile_s")
_LOWER_SUFFIXES = ("_time_s", "_wait_s", "_latency_s", "_ttft_s",
                   "_dur_s", "_step_s", "_p50_s", "_p95_s")


def direction(metric: str) -> Optional[str]:
    """'higher' | 'lower' (better) | None (informational)."""
    base = metric.split(":", 1)[-1]
    if base in _HIGHER or base.endswith("_per_sec"):
        return "higher"
    if base in _LOWER or base.endswith(_LOWER_SUFFIXES):
        return "lower"
    if base.startswith("span:"):
        return "lower"
    if metric.startswith("span:"):
        return "lower"
    return None


def run_series(records: List[Dict[str, Any]]) -> Dict[str, List[float]]:
    """Extract the comparable series from one run's records:

    - train series: ``step_time_s``, ``examples_per_sec``, ``loss``,
      ``compile_s`` from step records;
    - span durations: ``span:<name>`` per span name;
    - serve counters: every numeric ``serve_*`` key from the LAST
      snapshot (cumulative snapshots — the last one is the run total).
    """
    out: Dict[str, List[float]] = {}

    def _num(v: Any) -> bool:
        return isinstance(v, (int, float)) and not isinstance(v, bool)

    last_serve: Optional[Dict[str, Any]] = None
    for r in records:
        if "span" in r:
            if _num(r.get("dur_s")):
                out.setdefault(f"span:{r['span']}", []).append(
                    float(r["dur_s"]))
            continue
        if any(k.startswith("serve_") for k in r):
            last_serve = r
            continue
        for key in ("step_time_s", "examples_per_sec", "loss",
                    "compile_s"):
            if _num(r.get(key)):
                out.setdefault(key, []).append(float(r[key]))
    if last_serve is not None:
        for k, v in last_serve.items():
            if k.startswith("serve_") and _num(v):
                out.setdefault(k, []).append(float(v))
    return out


def _stats(xs: List[float]) -> Dict[str, Optional[float]]:
    return {"n": len(xs), "p50": percentile(xs, 50),
            "p95": percentile(xs, 95)}


def _rel(a: Optional[float], b: Optional[float]) -> Optional[float]:
    if a is None or b is None:
        return None
    if a == b:
        return 0.0
    if a == 0:
        return None
    return (b - a) / abs(a)


def diff_runs(path_a: str, path_b: str,
              tolerance: float = DEFAULT_TOLERANCE) -> Dict[str, Any]:
    """Full report dict for two recorded runs (files or directories)."""
    recs_a, _, _ = collect(path_a)
    recs_b, _, _ = collect(path_b)
    series_a = run_series(recs_a)
    series_b = run_series(recs_b)
    metrics: Dict[str, Dict[str, Any]] = {}
    regressions: List[str] = []
    for name in sorted(set(series_a) & set(series_b)):
        a, b = _stats(series_a[name]), _stats(series_b[name])
        rel50, rel95 = _rel(a["p50"], b["p50"]), _rel(a["p95"], b["p95"])
        d = direction(name)
        regressed = False
        if d == "lower":
            regressed = any(r is not None and r > tolerance
                            for r in (rel50, rel95))
        elif d == "higher":
            regressed = any(r is not None and r < -tolerance
                            for r in (rel50, rel95))
        metrics[name] = {
            "a": a, "b": b,
            "delta_p50": (None if a["p50"] is None or b["p50"] is None
                          else b["p50"] - a["p50"]),
            "delta_p95": (None if a["p95"] is None or b["p95"] is None
                          else b["p95"] - a["p95"]),
            "rel_p50": rel50, "rel_p95": rel95,
            "direction": d, "regressed": regressed,
        }
        if regressed:
            regressions.append(name)
    return {
        "run_a": path_a, "run_b": path_b, "tolerance": tolerance,
        "common_metrics": len(metrics),
        "only_a": sorted(set(series_a) - set(series_b)),
        "only_b": sorted(set(series_b) - set(series_a)),
        "metrics": metrics,
        "regressions": regressions,
        "ok": not regressions,
    }


def render_diff(report: Dict[str, Any]) -> str:
    """Human-readable rendering of :func:`diff_runs` output."""
    L: List[str] = []
    L.append(f"run diff: {report['run_a']}  vs  {report['run_b']}  "
             f"(tolerance {report['tolerance'] * 100:g}%)")

    def _f(v: Optional[float]) -> str:
        if v is None:
            return "-"
        return f"{v:.4g}"

    def _p(v: Optional[float]) -> str:
        if v is None:
            return "-"
        return f"{v * 100:+.1f}%"

    for name, m in report["metrics"].items():
        mark = "  << REGRESSED" if m["regressed"] else ""
        L.append(f"  {name:<28} p50 {_f(m['a']['p50'])} -> "
                 f"{_f(m['b']['p50'])} ({_p(m['rel_p50'])})   "
                 f"p95 {_f(m['a']['p95'])} -> {_f(m['b']['p95'])} "
                 f"({_p(m['rel_p95'])}){mark}")
    if report["only_a"]:
        L.append(f"  only in A: {', '.join(report['only_a'])}")
    if report["only_b"]:
        L.append(f"  only in B: {', '.join(report['only_b'])}")
    if not report["metrics"]:
        L.append("  (no common metric series)")
    L.append(f"regressions: {len(report['regressions'])}"
             + (f" ({', '.join(report['regressions'])})"
                if report["regressions"] else ""))
    return "\n".join(L)


# -- bench record gating -----------------------------------------------------

_BENCH_KEYS = ("value", "mean_step_s", "mfu", "value_with_input",
               "mean_step_s_with_input")


def diff_bench_records(prior: Dict[str, Any], current: Dict[str, Any],
                       tolerance: float = DEFAULT_TOLERANCE
                       ) -> Dict[str, Any]:
    """Compare two bench contract records key-by-key; same direction
    rules as the run diff. Unmeasured records never gate."""
    out: Dict[str, Any] = {"tolerance": tolerance, "regressions": [],
                           "metrics": {}}
    if not prior.get("measured", True) or not current.get("measured",
                                                          True):
        out["skipped"] = "one of the records is measured=false"
        out["ok"] = True
        return out
    for key in _BENCH_KEYS:
        a, b = prior.get(key), current.get(key)
        if not isinstance(a, (int, float)) or isinstance(a, bool) \
                or not isinstance(b, (int, float)) or isinstance(b, bool):
            continue
        rel = _rel(float(a), float(b))
        d = direction(key)
        regressed = (rel is not None
                     and ((d == "lower" and rel > tolerance)
                          or (d == "higher" and rel < -tolerance)))
        out["metrics"][key] = {"prior": a, "current": b, "rel": rel,
                               "direction": d, "regressed": regressed}
        if regressed:
            out["regressions"].append(key)
    out["ok"] = not out["regressions"]
    return out


def load_bench_record(path: str) -> Optional[Dict[str, Any]]:
    """Read a prior bench contract record: a JSON file holding one
    record, or a JSONL file whose last parseable line with a "metric"
    key wins."""
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        text = fh.read()
    try:
        doc = json.loads(text)
        if isinstance(doc, dict):
            return doc
    except json.JSONDecodeError:
        pass
    for line in reversed(text.strip().splitlines()):
        try:
            doc = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(doc, dict) and "metric" in doc:
            return doc
    return None
