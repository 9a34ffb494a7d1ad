"""Chrome/Perfetto trace-event export: span JSONL → ``trace.json``.

A copy of the JAX package's ``obs/export.py``, which imports
nothing of JAX (the port never imports that package).

``dlcfn-tpu obs export <run_dir>`` turns the run's JSONL streams into one
Trace Event Format file (the ``{"traceEvents": [...]}`` JSON object both
``chrome://tracing`` and https://ui.perfetto.dev load directly), so a
run's timeline — train dispatch/realize spans, checkpoint saves, serve
admission ticks and per-request lifecycles, launcher attempts — becomes a
zoomable flame view instead of grep output.

Mapping:

- **span records** (``{"span", "span_id", "parent_id", "t0_s", "dur_s",
  "ok", ...}``) become ``"X"`` complete events. Nesting is preserved by
  construction: every span lineage (a root span plus all descendants via
  ``parent_id``) is placed on one Perfetto track (``tid``), children
  clamped inside their parent's interval so rounding in the 6-decimal
  JSONL fields can never break the viewer's stack discipline. Root
  lineages share tracks greedily when they don't overlap. Per-request
  ``serve.request*`` lineages get their own process group so request
  gantt rows don't interleave with engine ticks.
- **launcher attempt events** (``{"event": "launch_attempt", ...}``) and
  **SLO alert events** (``{"event": "alert", ...}``, obs/slo.py) become
  ``"i"`` instant events.
- **numeric series** (train ``loss``/``examples_per_sec``, serve
  ``serve_queue_depth``/``serve_tokens_per_sec``/...) become ``"C"``
  counter events, one track each.

Timeline alignment: span ``t0_s`` is monotonic seconds since tracer
creation while every JSONL record's ``ts`` is wall clock, so the exporter
estimates the tracer's wall epoch as ``min(ts - dur_s - t0_s)`` over
spans carrying both (the write happens at span close, so each candidate
over-estimates by at most the write latency and min is tightest). All
event timestamps are microseconds relative to the earliest event.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

from .report import collect

# Counter keys exported as "C" tracks when present in non-span records.
COUNTER_KEYS = (
    "loss",
    "examples_per_sec",
    "step_time_s",
    "serve_queue_depth",
    "serve_tokens_per_sec",
    "serve_slot_occupancy",
    "serve_kv_blocks_in_use",
)

_PID_SPANS = 1
_PID_REQUESTS = 2
_PID_COUNTERS = 3

# Spans whose lineage belongs on the per-request process group.
_REQUEST_PREFIX = "serve.request"


class _SpanNode:
    __slots__ = ("rec", "start", "end", "tid", "children")

    def __init__(self, rec: Dict[str, Any]):
        self.rec = rec
        self.start = 0.0
        self.end = 0.0
        self.tid: Optional[int] = None
        self.children: List["_SpanNode"] = []


def _wall_epoch(spans: List[Dict[str, Any]],
                others: List[Dict[str, Any]]) -> float:
    """Wall-clock value of the tracer's monotonic epoch (t0_s == 0)."""
    candidates = [
        r["ts"] - float(r.get("dur_s") or 0.0) - float(r["t0_s"])
        for r in spans
        if isinstance(r.get("ts"), (int, float))
        and isinstance(r.get("t0_s"), (int, float))
    ]
    if candidates:
        return min(candidates)
    # No span carries wall clock (MemorySink records): anchor the span
    # timeline at the earliest wall ts seen, or zero.
    ts = [r["ts"] for r in others if isinstance(r.get("ts"), (int, float))]
    return min(ts) if ts else 0.0


def _shard_events(records: List[Dict[str, Any]], pid_spans: int,
                  pid_requests: int, pid_counters: int
                  ) -> Tuple[List[Dict[str, Any]], Dict[int, List[float]],
                             List[float]]:
    """Layout core shared by the single-run and fleet builders: records
    → (events, pools, t_base candidates), with ``ts``/``dur`` in
    ABSOLUTE wall-clock seconds (the caller rebases to relative µs —
    the fleet builder needs one GLOBAL base across shards, so rebasing
    cannot happen per shard)."""
    spans = [r for r in records if "span" in r
             and isinstance(r.get("t0_s"), (int, float))
             and isinstance(r.get("dur_s"), (int, float))]
    others = [r for r in records if "span" not in r]
    epoch = _wall_epoch(spans, others)

    nodes: Dict[int, _SpanNode] = {}
    anon: List[_SpanNode] = []   # spans without a usable span_id
    for r in spans:
        n = _SpanNode(r)
        n.start = epoch + float(r["t0_s"])
        n.end = n.start + max(float(r["dur_s"]), 0.0)
        sid = r.get("span_id")
        if isinstance(sid, int) and sid not in nodes:
            nodes[sid] = n
        else:
            anon.append(n)

    # Lineage: children under parents; unknown parents make roots.
    roots: List[_SpanNode] = list(anon)
    for sid, n in nodes.items():
        pid = n.rec.get("parent_id")
        parent = nodes.get(pid) if isinstance(pid, int) else None
        if parent is not None and parent is not n:
            parent.children.append(n)
        else:
            roots.append(n)

    # Track (tid) assignment: one tid per lineage; non-overlapping root
    # lineages reuse tracks greedily so the view stays compact.
    pools: Dict[int, List[float]] = {pid_spans: [], pid_requests: []}

    def _lineage_end(n: _SpanNode) -> float:
        return max([n.end] + [_lineage_end(c) for c in n.children])

    events: List[Dict[str, Any]] = []
    placed: List[Tuple[int, _SpanNode]] = []   # (pid, node)

    for root in sorted(roots, key=lambda n: (n.start, -n.end)):
        pid = (pid_requests
               if str(root.rec.get("span", "")).startswith(_REQUEST_PREFIX)
               or root.rec.get("span") == "fleet.request"
               else pid_spans)
        pool = pools[pid]
        end = _lineage_end(root)
        for tid, last_end in enumerate(pool):
            if last_end <= root.start + 1e-9:
                pool[tid] = end
                break
        else:
            tid = len(pool)
            pool.append(end)
        stack = [(root, None)]
        while stack:
            n, parent = stack.pop()
            n.tid = tid
            if parent is not None:
                # Clamp into the parent so 6-decimal rounding in the
                # JSONL can never produce viewer-visible mis-nesting.
                n.start = min(max(n.start, parent.start), parent.end)
                n.end = min(max(n.end, n.start), parent.end)
            placed.append((pid, n))
            for c in sorted(n.children, key=lambda c: (c.start, -c.end)):
                stack.append((c, n))

    times = [n.start for _, n in placed]
    times += [r["ts"] for r in others
              if isinstance(r.get("ts"), (int, float))]

    for pid, n in placed:
        r = n.rec
        args = {k: v for k, v in r.items()
                if k not in ("span", "t0_s", "dur_s", "ts")}
        events.append({
            "name": r["span"], "ph": "X", "pid": pid, "tid": n.tid,
            "ts": n.start, "dur": n.end - n.start,
            "cat": str(r["span"]).split(".")[0],
            "args": args,
        })

    for r in others:
        ts = r.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        ev = r.get("event")
        if ev in ("launch_attempt", "alert"):
            name = (f"launch_attempt:{r.get('outcome', '?')}"
                    if ev == "launch_attempt"
                    else f"alert:{r.get('rule', '?')}")
            events.append({
                "name": name, "ph": "i", "s": "g",
                "pid": pid_spans, "tid": 0, "ts": ts,
                "args": {k: v for k, v in r.items() if k != "ts"},
            })
            continue
        for key in COUNTER_KEYS:
            v = r.get(key)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                events.append({
                    "name": key, "ph": "C", "pid": pid_counters,
                    "ts": ts, "args": {key: v},
                })

    return events, pools, times


def _rebase(events: List[Dict[str, Any]], t_base: float
            ) -> List[Dict[str, Any]]:
    """Absolute seconds → relative microseconds, in place."""
    for e in events:
        e["ts"] = round((e["ts"] - t_base) * 1e6, 3)
        if e["ph"] == "X":
            e["dur"] = round(e["dur"] * 1e6, 3)
    return events


def _meta_events(names: Dict[int, str], pools: Dict[int, List[float]],
                 used_pids) -> List[Dict[str, Any]]:
    meta: List[Dict[str, Any]] = []
    for pid in sorted(used_pids):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": names.get(pid, f"pid {pid}")}})
    for pid in sorted(pools):
        for tid in range(len(pools[pid])):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": f"track {tid}"}})
    return meta


def build_trace(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Records (any mix of spans / train / serve / launch / alert lines)
    → a Trace Event Format object. Pure function of its input: no clock
    reads, so identical records yield an identical trace."""
    events, pools, times = _shard_events(
        records, _PID_SPANS, _PID_REQUESTS, _PID_COUNTERS)
    t_base = min(times) if times else 0.0
    events = _rebase(events, t_base)
    names = {_PID_SPANS: "process spans", _PID_REQUESTS: "serve requests",
             _PID_COUNTERS: "metrics"}
    meta = _meta_events(names, pools, {e["pid"] for e in events})
    events.sort(key=lambda e: (e.get("ts", 0.0), -e.get("dur", 0.0)))
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def _flow_events(events: List[Dict[str, Any]], start_id: int = 1
                 ) -> List[Dict[str, Any]]:
    """Cross-process flow arrows stitching one distributed request's
    spans into a chain: for every ``trace_id`` carried by a request-level
    X event (the router's ``fleet.request``, each replica's
    ``serve.request`` attempt), consecutive spans on DIFFERENT pids get
    an ``s``→``f`` pair — the Perfetto arrow from router submit to first
    attempt, and from an evacuated attempt to its re-placement."""
    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        name = str(e.get("name", ""))
        if name != "fleet.request" \
                and not name.startswith(_REQUEST_PREFIX):
            continue
        trace_id = (e.get("args") or {}).get("trace_id")
        if isinstance(trace_id, str):
            by_trace.setdefault(trace_id, []).append(e)
    flows: List[Dict[str, Any]] = []
    fid = start_id
    for trace_id in sorted(by_trace):
        chain = sorted(by_trace[trace_id],
                       key=lambda e: (e["ts"], e["pid"], e["tid"]))
        for a, b in zip(chain, chain[1:]):
            if a["pid"] == b["pid"]:
                continue
            common = {"name": f"trace/{trace_id}", "cat": "flow",
                      "id": fid}
            flows.append(dict(common, ph="s", pid=a["pid"],
                              tid=a["tid"], ts=a["ts"]))
            flows.append(dict(common, ph="f", bp="e", pid=b["pid"],
                              tid=b["tid"], ts=b["ts"]))
            fid += 1
    return flows


def build_fleet_trace(shards: List[Tuple[str, List[Dict[str, Any]]]]
                      ) -> Dict[str, Any]:
    """Merge per-process record shards — ``[(name, records)]``, one per
    router/replica — into ONE Trace Event Format object. Each shard gets
    its own pid block (spans / requests / counters) named after it; all
    shards share one time base (every in-process clock is the same
    ``time.monotonic``, and wall ``ts`` stamps anchor cross-process
    shards), so one request's hops line up on a single zoomable
    timeline, linked by flow arrows (:func:`_flow_events`)."""
    all_events: List[Dict[str, Any]] = []
    all_pools: Dict[int, List[float]] = {}
    names: Dict[int, str] = {}
    times: List[float] = []
    for i, (name, records) in enumerate(shards):
        base = 3 * i
        events, pools, ts = _shard_events(
            records, base + _PID_SPANS, base + _PID_REQUESTS,
            base + _PID_COUNTERS)
        all_events.extend(events)
        all_pools.update(pools)
        names[base + _PID_SPANS] = f"{name} spans"
        names[base + _PID_REQUESTS] = f"{name} requests"
        names[base + _PID_COUNTERS] = f"{name} metrics"
        times.extend(ts)
    t_base = min(times) if times else 0.0
    all_events = _rebase(all_events, t_base)
    flows = _flow_events(all_events)
    meta = _meta_events(names, all_pools,
                        {e["pid"] for e in all_events})
    all_events.extend(flows)
    all_events.sort(key=lambda e: (e.get("ts", 0.0), -e.get("dur", 0.0)))
    return {"traceEvents": meta + all_events, "displayTimeUnit": "ms"}


def validate_trace(trace: Any) -> List[str]:
    """Structural check of a Trace Event Format object; returns a list of
    problems (empty == valid). The cheap no-viewer gate the bench smoke
    and tests run: JSON shape, required fields, non-negative times, and
    per-track stack discipline for complete events."""
    problems: List[str] = []
    if not isinstance(trace, dict) or not isinstance(
            trace.get("traceEvents"), list):
        return ["not a {'traceEvents': [...]} object"]
    try:
        json.dumps(trace)
    except (TypeError, ValueError) as e:
        problems.append(f"not JSON-serializable: {e}")
    tracks: Dict[Tuple[Any, Any], List[Tuple[float, float]]] = {}
    for i, e in enumerate(trace["traceEvents"]):
        if not isinstance(e, dict) or "ph" not in e or "name" not in e:
            problems.append(f"event {i}: missing ph/name")
            continue
        if e["ph"] == "M":
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i} ({e['name']}): bad ts {ts!r}")
            continue
        if e["ph"] == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(
                    f"event {i} ({e['name']}): bad dur {dur!r}")
                continue
            tracks.setdefault((e.get("pid"), e.get("tid")), []).append(
                (float(ts), float(ts) + float(dur)))
    # Abutting sibling spans (queue → prefill → decode share their
    # boundary timestamps) have t0_s and dur_s rounded independently to
    # 6 decimals in the JSONL, so their rendered edges can disagree by
    # up to ~1.5 µs without any real mis-nesting.
    eps = 2.0
    for key, ivals in tracks.items():
        ivals.sort(key=lambda p: (p[0], -p[1]))
        stack: List[float] = []
        for start, end in ivals:
            while stack and stack[-1] <= start + eps:
                stack.pop()
            if stack and end > stack[-1] + eps:
                problems.append(
                    f"track pid={key[0]} tid={key[1]}: event "
                    f"[{start},{end}] overlaps span ending {stack[-1]}")
                break
            stack.append(end)
    return problems


def export_trace(path: str, out_path: str) -> Dict[str, Any]:
    """Read a run (file or directory, via report.collect), write
    ``out_path``, return a summary dict (events/spans/records counts plus
    any validation problems)."""
    records, files, skipped = collect(path)
    trace = build_trace(records)
    problems = validate_trace(trace)
    with open(out_path, "w") as fh:
        json.dump(trace, fh)
    n_spans = sum(1 for e in trace["traceEvents"] if e.get("ph") == "X")
    return {
        "out": out_path,
        "records": len(records),
        "files": len(files),
        "skipped_lines": skipped,
        "events": len(trace["traceEvents"]),
        "spans": n_spans,
        "problems": problems,
    }


def fleet_trace_shards(root: str
                       ) -> Tuple[List[Tuple[str, List[Dict[str, Any]]]],
                                  List[str], int]:
    """Discover a fleet run's trace shards: ``*.jsonl`` files directly
    at ``root`` form the ``router`` shard (the router's fleet.request
    spans and signal snapshots live at the fleet root, owning no
    replica), and every per-replica run dir is its own shard. Returns
    (shards, files, skipped_lines)."""
    from .report import fleet_replica_dirs

    if not os.path.isdir(root):
        raise FileNotFoundError(f"no fleet run directory at {root}")
    shards: List[Tuple[str, List[Dict[str, Any]]]] = []
    files: List[str] = []
    skipped = 0
    router_records: List[Dict[str, Any]] = []
    for f in sorted(os.listdir(root)):
        if not f.endswith(".jsonl"):
            continue
        recs, fs, sk = collect(os.path.join(root, f))
        router_records.extend(recs)
        files.extend(fs)
        skipped += sk
    if router_records:
        shards.append(("router", router_records))
    for name, sub in fleet_replica_dirs(root):
        recs, fs, sk = collect(sub)
        shards.append((name, recs))
        files.extend(fs)
        skipped += sk
    return shards, files, skipped


def export_fleet_trace(root: str, out_path: str) -> Dict[str, Any]:
    """Merge every shard under a fleet root into one ``trace.json``
    (see :func:`build_fleet_trace`); returns the summary dict with the
    per-shard breakdown and the cross-process ``flow_events`` count the
    smoke gate asserts on."""
    shards, files, skipped = fleet_trace_shards(root)
    trace = build_fleet_trace(shards)
    problems = validate_trace(trace)
    with open(out_path, "w") as fh:
        json.dump(trace, fh)
    n_spans = sum(1 for e in trace["traceEvents"] if e.get("ph") == "X")
    n_flows = sum(1 for e in trace["traceEvents"] if e.get("ph") == "s")
    return {
        "out": out_path,
        "shards": [name for name, _ in shards],
        "records": sum(len(recs) for _, recs in shards),
        "files": len(files),
        "skipped_lines": skipped,
        "events": len(trace["traceEvents"]),
        "spans": n_spans,
        "flow_events": n_flows,
        "problems": problems,
    }
