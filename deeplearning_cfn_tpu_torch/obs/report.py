"""Run reports: turn a metrics.jsonl (or a run directory) into answers.

A copy of the JAX package's ``obs/report.py``, which imports
nothing of JAX (the port never imports that package).

``dlcfn-tpu obs summarize <metrics.jsonl|dir>`` is the "what happened in
this run" verb the JSONL stream never had — before this, the answer was
hand-grepping. The summarizer is intentionally forgiving: it takes any
mix of train records, serve snapshots, span records, and launcher attempt
events in one stream (or across ``*.jsonl`` files in a directory),
skips torn/partial lines (a crash mid-write must not kill the post-mortem
tool), and reports only the sections it has data for.

Sections:

- **train** — steps reached, step-time p50/p95 (from the additive
  ``step_time_s`` boundary key), examples/sec (last + peak), compile
  time, eval/final-eval metrics, checkpoint store retries.
- **serve** — from the last ``serve_*`` snapshot: tokens/sec, queue
  wait / TTFT / latency / step-latency percentiles, admission counters.
- **spans** — per-name count and duration p50/p95 from span records
  (ckpt.save latency lives here).
- **launch** — per-attempt outcomes (``ok``/``hang``/``crash``) from
  launcher attempt events, mirroring ``JobResult.attempt_outcomes``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

from .metrics import percentile


def _iter_records(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """Lenient JSONL parse: (records, skipped_line_count)."""
    records, skipped = [], 0
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                skipped += 1
                continue
            if isinstance(rec, dict):
                records.append(rec)
            else:
                skipped += 1
    return records, skipped


def collect(path: str) -> Tuple[List[Dict[str, Any]], List[str], int]:
    """Load records from a file, or every ``*.jsonl`` under a directory
    (one level, plus ``logs/``). Returns (records, files, skipped).

    A nonexistent path raises :class:`FileNotFoundError` with a usable
    message; an unreadable individual file inside a directory is skipped
    (a half-deleted run must still summarize), and an existing-but-empty
    directory yields zero records rather than an exception.
    """
    if os.path.isdir(path):
        files = []
        for sub in ("", "logs"):
            d = os.path.join(path, sub) if sub else path
            if os.path.isdir(d):
                files.extend(
                    os.path.join(d, f) for f in sorted(os.listdir(d))
                    if f.endswith(".jsonl"))
        records, skipped = [], 0
        for f in files:
            try:
                rs, sk = _iter_records(f)
            except OSError:
                continue
            records.extend(rs)
            skipped += sk
        return records, files, skipped
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no metrics file or run directory at {path}")
    records, skipped = _iter_records(path)
    return records, [path], skipped


def _pct_pair(xs: List[float]) -> Dict[str, Optional[float]]:
    return {"p50": percentile(xs, 50), "p95": percentile(xs, 95)}


def summarize(path: str,
              since_step: Optional[int] = None) -> Dict[str, Any]:
    """Build the run-report dict. Always includes ``source``; train /
    serve / spans / launch sections appear only when present.

    ``since_step`` drops every record carrying a numeric ``step`` below
    it (train records and step-tagged spans alike); step-less records
    (serve snapshots, launch events) always pass — the filter narrows
    the timeline, it doesn't hide subsystems."""
    records, files, skipped = collect(path)
    if since_step is not None:
        records = [r for r in records
                   if not (isinstance(r.get("step"), (int, float))
                           and r["step"] < since_step)]
    out: Dict[str, Any] = {
        "source": {"path": path, "files": len(files),
                   "records": len(records), "skipped_lines": skipped},
    }
    if since_step is not None:
        out["source"]["since_step"] = since_step

    train = [r for r in records if "step" in r and "span" not in r
             and not any(k.startswith("serve_") for k in r)]
    serve = [r for r in records
             if any(k.startswith("serve_") for k in r)]
    spans = [r for r in records if "span" in r]
    launch = [r for r in records if r.get("event") == "launch_attempt"]
    alerts = [r for r in records if r.get("event") == "alert"]

    if train:
        steps = [r["step"] for r in train
                 if isinstance(r.get("step"), (int, float))]
        step_times = [r["step_time_s"] for r in train
                      if isinstance(r.get("step_time_s"), (int, float))]
        eps = [r["examples_per_sec"] for r in train
               if isinstance(r.get("examples_per_sec"), (int, float))]
        losses = [r["loss"] for r in train
                  if isinstance(r.get("loss"), (int, float))]
        compile_s = next(
            (r["compile_s"] for r in train
             if isinstance(r.get("compile_s"), (int, float))), None)
        retries = [r["ckpt_store_retries"] for r in train
                   if isinstance(r.get("ckpt_store_retries"), (int, float))]
        evals = {}
        for r in train:
            for k, v in r.items():
                if k.startswith(("eval_", "final_eval_")):
                    evals[k] = v
        out["train"] = {
            "last_step": max(steps) if steps else None,
            "records": len(train),
            "step_time_s": _pct_pair(step_times),
            "examples_per_sec": {
                "last": eps[-1] if eps else None,
                "peak": max(eps) if eps else None,
            },
            "loss": {
                "first": losses[0] if losses else None,
                "last": losses[-1] if losses else None,
            },
            "compile_s": compile_s,
            "ckpt_store_retries": retries[-1] if retries else None,
            "eval": evals or None,
        }

    if serve:
        last = serve[-1]
        out["serve"] = {
            "records": len(serve),
            # Disaggregated fleets tag each replica's emission with its
            # phase role; co-located snapshots carry no tag.
            "phase": last.get("phase"),
            "queue_depth": last.get("serve_queue_depth"),
            "submitted": last.get("serve_submitted"),
            "admitted": last.get("serve_admitted"),
            "completed": last.get("serve_completed"),
            "rejected": last.get("serve_rejected"),
            "cancelled": last.get("serve_cancelled"),
            "expired": last.get("serve_expired"),
            "tokens_generated": last.get("serve_tokens_generated"),
            "tokens_per_sec": last.get("serve_tokens_per_sec"),
            "slot_occupancy": last.get("serve_slot_occupancy"),
            "steps_per_window": last.get("serve_steps_per_window"),
            "ckpt_load_retries": last.get("serve_ckpt_load_retries"),
            "queue_wait_s": {
                "p50": last.get("serve_queue_wait_p50_s"),
                "p95": last.get("serve_queue_wait_p95_s"),
            },
            "ttft_s": {
                "p50": last.get("serve_ttft_p50_s"),
                "p95": last.get("serve_ttft_p95_s"),
            },
            "latency_s": {
                "p50": last.get("serve_latency_p50_s"),
                "p95": last.get("serve_latency_p95_s"),
            },
            "step_latency_s": {
                "p50": last.get("serve_step_latency_p50_s"),
                "p95": last.get("serve_step_latency_p95_s"),
            },
        }
        # Per-tenant QoS section — only when the snapshot carries the
        # QoS surface (single-tenant runs keep the exact pre-QoS keys).
        if last.get("serve_qos_by_class") is not None:
            out["serve"]["qos"] = {
                "by_class": last.get("serve_qos_by_class"),
                "preemptions": last.get("serve_preemptions"),
                "preempted_tokens_replayed":
                    last.get("serve_preempted_tokens_replayed"),
                "token_loss": last.get("serve_qos_token_loss"),
                "fair_share_violation_max":
                    last.get("serve_fair_share_violation_max"),
            }
        # Chunked-prefill section — only when the snapshot carries the
        # chunk surface (--prefill-chunk runs).
        if last.get("serve_chunk_size") is not None:
            out["serve"]["chunked_prefill"] = {
                "chunk_size": last.get("serve_chunk_size"),
                "chunk_ticks": last.get("serve_chunk_ticks"),
                "chunk_tokens": last.get("serve_chunk_tokens"),
                "chunks_per_tick": {
                    "p50": last.get("serve_chunks_per_tick_p50"),
                    "p95": last.get("serve_chunks_per_tick_p95"),
                },
                "partial_rows": last.get("serve_chunk_partial_rows"),
                "stall_ticks_avoided":
                    last.get("serve_chunk_stall_ticks_avoided"),
                "ticks_per_prefill": {
                    "p50": last.get("serve_chunk_ticks_per_prefill_p50"),
                    "p95": last.get("serve_chunk_ticks_per_prefill_p95"),
                },
            }
        # Radix token-prefix KV cache section — only when the snapshot
        # carries the radix surface (--radix-cache runs).
        if last.get("serve_radix_nodes") is not None:
            out["serve"]["radix"] = {
                "nodes": last.get("serve_radix_nodes"),
                "blocks": last.get("serve_radix_blocks"),
                "hits": last.get("serve_radix_hits"),
                "misses": last.get("serve_radix_misses"),
                "hit_rate": last.get("serve_radix_hit_rate"),
                "instant_completes":
                    last.get("serve_radix_instant_completes"),
                "hit_tokens": last.get("serve_radix_hit_tokens"),
                "shared_block_ratio":
                    last.get("serve_radix_shared_block_ratio"),
                "evictions": last.get("serve_radix_evictions"),
                "evictions_by_cause":
                    last.get("serve_radix_evictions_by_cause"),
            }

    if spans:
        by_name: Dict[str, List[float]] = {}
        fails: Dict[str, int] = {}
        for r in spans:
            name = r["span"]
            if isinstance(r.get("dur_s"), (int, float)):
                by_name.setdefault(name, []).append(r["dur_s"])
            if r.get("ok") is False:
                fails[name] = fails.get(name, 0) + 1
        out["spans"] = {
            name: {"count": len(durs), **_pct_pair(durs),
                   **({"failed": fails[name]} if name in fails else {})}
            for name, durs in sorted(by_name.items())
        }

    if launch:
        outcomes = [r.get("outcome") for r in launch]
        out["launch"] = {
            "attempts": len(launch),
            "outcomes": outcomes,
            "success": bool(launch[-1].get("success",
                                           outcomes[-1] == "ok")),
            "restarts": max(0, len(launch) - 1),
        }

    if alerts:
        out["alerts"] = {
            "count": len(alerts),
            "last_rule": str(alerts[-1].get("rule", "?")),
        }

    return out


def _fmt(v: Any, unit: str = "") -> str:
    if v is None:
        return "-"
    if isinstance(v, bool):
        return "yes" if v else "no"
    if isinstance(v, float):
        if v != 0 and abs(v) < 0.001:
            return f"{v:.2e}{unit}"
        return f"{v:.4g}{unit}"
    return f"{v}{unit}"


def render_report(summary: Dict[str, Any]) -> str:
    """Human-readable text rendering of :func:`summarize` output."""
    L: List[str] = []
    src = summary["source"]
    L.append(f"run report: {src['path']}")
    L.append(f"  files={src['files']} records={src['records']}"
             + (f" skipped_lines={src['skipped_lines']}"
                if src["skipped_lines"] else ""))

    t = summary.get("train")
    if t:
        L.append("train:")
        L.append(f"  last step           {_fmt(t['last_step'])}")
        st = t["step_time_s"]
        L.append(f"  step time p50/p95   {_fmt(st['p50'], 's')} / "
                 f"{_fmt(st['p95'], 's')}")
        e = t["examples_per_sec"]
        L.append(f"  examples/sec        last {_fmt(e['last'])}  "
                 f"peak {_fmt(e['peak'])}")
        lo = t["loss"]
        L.append(f"  loss                {_fmt(lo['first'])} -> "
                 f"{_fmt(lo['last'])}")
        L.append(f"  compile             {_fmt(t['compile_s'], 's')}")
        L.append(f"  ckpt store retries  {_fmt(t['ckpt_store_retries'])}")
        if t["eval"]:
            for k, v in sorted(t["eval"].items()):
                L.append(f"  {k:<19} {_fmt(v)}")

    s = summary.get("serve")
    if s:
        L.append("serve:")
        L.append(f"  submitted/admitted/completed  "
                 f"{_fmt(s['submitted'])}/{_fmt(s['admitted'])}/"
                 f"{_fmt(s['completed'])}")
        L.append(f"  rejected/cancelled/expired    "
                 f"{_fmt(s['rejected'])}/{_fmt(s['cancelled'])}/"
                 f"{_fmt(s['expired'])}")
        L.append(f"  tokens/sec          {_fmt(s['tokens_per_sec'])}  "
                 f"(total {_fmt(s['tokens_generated'])})")
        L.append(f"  slot occupancy      {_fmt(s['slot_occupancy'])}")
        L.append(f"  steps/window        {_fmt(s['steps_per_window'])}")
        L.append(f"  ckpt load retries   {_fmt(s['ckpt_load_retries'])}")
        for key, label in (("queue_wait_s", "queue wait"),
                           ("ttft_s", "ttft"),
                           ("latency_s", "latency"),
                           ("step_latency_s", "step latency")):
            p = s[key]
            L.append(f"  {label:<19} p50 {_fmt(p['p50'], 's')}  "
                     f"p95 {_fmt(p['p95'], 's')}")
        q = s.get("qos")
        if q:
            L.append(f"  preemptions         {_fmt(q['preemptions'])}  "
                     f"(replayed {_fmt(q['preempted_tokens_replayed'])}, "
                     f"lost {_fmt(q['token_loss'])})")
            L.append(f"  fair-share viol.    "
                     f"{_fmt(q['fair_share_violation_max'])}")
            for cls, v in sorted((q.get("by_class") or {}).items()):
                L.append(f"  qos {cls:<15} n={_fmt(v.get('completed')):<5} "
                         f"p50 {_fmt(v.get('latency_p50_s'), 's')}  "
                         f"p95 {_fmt(v.get('latency_p95_s'), 's')}")
        ck = s.get("chunked_prefill")
        if ck:
            tp = ck.get("ticks_per_prefill") or {}
            L.append(f"  chunked prefill     chunk {_fmt(ck['chunk_size'])} "
                     f"tok/tick  {_fmt(ck['chunk_ticks'])} ticks / "
                     f"{_fmt(ck['chunk_tokens'])} tokens")
            L.append(f"  chunk interleave    "
                     f"{_fmt(ck['stall_ticks_avoided'])} stall ticks "
                     f"avoided, ticks/prefill p50 {_fmt(tp.get('p50'))}  "
                     f"p95 {_fmt(tp.get('p95'))}")
        rx = s.get("radix")
        if rx:
            L.append(f"  radix cache         {_fmt(rx['nodes'])} nodes / "
                     f"{_fmt(rx['blocks'])} blocks  "
                     f"hit rate {_fmt(rx['hit_rate'])}")
            L.append(f"  radix reuse         {_fmt(rx['hits'])} hits "
                     f"({_fmt(rx['instant_completes'])} instant), "
                     f"{_fmt(rx['hit_tokens'])} tokens, "
                     f"shared-block ratio "
                     f"{_fmt(rx['shared_block_ratio'])}")
            causes = rx.get("evictions_by_cause") or {}
            cause_txt = ", ".join(f"{c}={n}"
                                  for c, n in sorted(causes.items()))
            L.append(f"  radix evictions     {_fmt(rx['evictions'])}"
                     + (f"  ({cause_txt})" if cause_txt else ""))

    sp = summary.get("spans")
    if sp:
        L.append("spans:")
        for name, v in sp.items():
            extra = f"  failed {v['failed']}" if "failed" in v else ""
            L.append(f"  {name:<19} n={v['count']:<5} "
                     f"p50 {_fmt(v['p50'], 's')}  "
                     f"p95 {_fmt(v['p95'], 's')}{extra}")

    la = summary.get("launch")
    if la:
        L.append("launch:")
        L.append(f"  attempts            {la['attempts']} "
                 f"({', '.join(str(o) for o in la['outcomes'])})")
        L.append(f"  success             {_fmt(la['success'])}  "
                 f"restarts {la['restarts']}")

    al = summary.get("alerts")
    if al:
        L.append("alerts:")
        L.append(f"  count               {al['count']} "
                 f"(last: {al['last_rule']})")

    if len(L) == 2:
        L.append("(no train, serve, span, or launch records found)")
    return "\n".join(L)


# -- fleet aggregate ---------------------------------------------------------


def fleet_replica_dirs(root: str) -> List[Tuple[str, str]]:
    """The per-replica run dirs under a fleet root: immediate
    subdirectories that contain any ``*.jsonl`` (top level or
    ``logs/``), sorted by name. Returns [(name, path)]."""
    if not os.path.isdir(root):
        raise FileNotFoundError(f"no fleet run directory at {root}")
    found = []
    for name in sorted(os.listdir(root)):
        sub = os.path.join(root, name)
        if not os.path.isdir(sub):
            continue
        has_jsonl = any(
            f.endswith(".jsonl") for f in os.listdir(sub)) or (
            os.path.isdir(os.path.join(sub, "logs"))
            and any(f.endswith(".jsonl")
                    for f in os.listdir(os.path.join(sub, "logs"))))
        if has_jsonl:
            found.append((name, sub))
    return found


def _autoscale_events(root: str,
                      event: str = "scale_event") -> List[Dict[str, Any]]:
    """Every ``event``-typed record (``scale_event`` by default; the
    brownout fold passes ``degrade_event``) in the fleet root's own
    top-level ``*.jsonl`` shards (the bench writes them to
    ``<root>/autoscale.jsonl`` / ``<root>/degrade.jsonl``), in
    record-time order."""
    events: List[Dict[str, Any]] = []
    for f in sorted(os.listdir(root)):
        p = os.path.join(root, f)
        if not f.endswith(".jsonl") or not os.path.isfile(p):
            continue
        try:
            recs, _ = _iter_records(p)
        except OSError:
            continue
        events.extend(r for r in recs if r.get("event") == event)
    events.sort(key=lambda r: r["ts"]
                if isinstance(r.get("ts"), (int, float)) else 0.0)
    return events


def fold_autoscale(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold a scale-event stream into the autoscale summary: counters,
    the derived controller state (steady / scaling-up / draining), and
    the last event's what/why — the same fold ``obs tail --fleet``
    applies live."""
    ups = sum(1 for e in events if e.get("action") == "scale_up")
    downs = sum(1 for e in events if e.get("action") == "scale_down")
    drained = sum(1 for e in events
                  if e.get("action") == "scale_down" and e.get("drained"))
    open_drains = set()
    for e in events:
        if e.get("action") == "drain_begin":
            open_drains.add(e.get("replica"))
        elif e.get("action") == "scale_down":
            open_drains.discard(e.get("replica"))
    if open_drains:
        state = "draining"
    elif events and events[-1].get("action") == "scale_up":
        state = "scaling-up"
    else:
        state = "steady"
    last = events[-1] if events else {}
    return {
        "events": len(events),
        "scale_ups": ups,
        "scale_downs": downs,
        "drained_scale_downs": drained,
        "state": state,
        "last_action": last.get("action"),
        "last_replica": last.get("replica"),
        "last_phase": last.get("phase"),
        "last_reason": last.get("reason"),
    }


def fold_degrade(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold a degrade-event stream into the brownout summary: the
    current level (the last transition's), transition counters, and
    the last what/why — the same fold ``obs tail --fleet`` applies
    live."""
    degrades = sum(1 for e in events if e.get("action") == "degrade")
    recovers = sum(1 for e in events if e.get("action") == "recover")
    last = events[-1] if events else {}
    return {
        "events": len(events),
        "degrades": degrades,
        "recovers": recovers,
        "level": last.get("level", 0),
        "level_name": last.get("level_name", "normal"),
        "last_action": last.get("action"),
        "last_reason": last.get("reason"),
    }


def summarize_fleet(root: str) -> Dict[str, Any]:
    """Fleet-wide report over a directory of per-replica run dirs (the
    ReplicaSupervisor layout: ``<root>/replica-<i>/``). Per-replica
    sections are full :func:`summarize` outputs; the ``fleet`` section
    is the aggregate an operator triages from — total tokens/sec across
    replicas, the WORST p95 request latency (the fleet is as slow as
    its slowest replica), and the total alert count.

    The aggregate is computed by replaying every replica's records
    through the :class:`~.signals.SignalBus` — the same fold
    ``obs tail --fleet`` and the autoscale controller consume — so the
    live and post-hoc views can never drift apart. The full
    signal-snapshot rides along under ``"signals"``."""
    from .signals import SignalBus

    dirs = fleet_replica_dirs(root)
    replicas: Dict[str, Any] = {}
    total_records = 0
    bus = SignalBus(names=[name for name, _ in dirs])
    for name, path in dirs:
        s = summarize(path)
        replicas[name] = s
        total_records += s["source"]["records"]
        records, _, _ = collect(path)
        for rec in records:
            bus.observe(name, rec)
    agg = bus.fleet()
    # Per-phase queue depth: a starved decode pool must be visible as
    # its own number, not folded into the fleet aggregate. Co-located
    # replicas (no phase tag) fold under "both".
    queue_by_phase: Dict[str, int] = {}
    for name, s in replicas.items():
        sv = s.get("serve") or {}
        phase = sv.get("phase") or "both"
        qd = sv.get("queue_depth")
        if isinstance(qd, (int, float)):
            queue_by_phase[phase] = \
                queue_by_phase.get(phase, 0) + int(qd)
    out: Dict[str, Any] = {
        "source": {"path": root, "replicas": len(dirs),
                   "records": total_records},
        "fleet": {
            "tokens_per_sec": round(agg["tokens_per_sec"], 2)
            if isinstance(agg["tokens_per_sec"], (int, float)) else None,
            "tokens_generated": agg["tokens_generated"] or None,
            "worst_latency_p95_s": agg["worst_latency_p95_s"],
            "alerts": agg["alerts"],
            "submitted": agg["submitted"] or None,
            "completed": agg["completed"] or None,
            "rejected": agg["rejected"] or None,
            "launch_attempts": agg["launch_attempts"] or None,
            "launch_restarts": agg["launch_restarts"],
            "launch_failed_replicas": agg["launch_failed_replicas"],
            "queue_depth_by_phase": queue_by_phase or None,
        },
        "signals": bus.snapshot(),
        "replicas": replicas,
    }
    # Autoscale section only when the run actually scaled — legacy
    # fixed-membership layouts summarize byte-identically.
    events = _autoscale_events(root)
    if events:
        out["autoscale"] = fold_autoscale(events)
    # Brownout section under the same rule: only when transitions were
    # actually audited.
    degrade_events = _autoscale_events(root, event="degrade_event")
    if degrade_events:
        out["degrade"] = fold_degrade(degrade_events)
    return out


def fleet_status_line(summary: Dict[str, Any]) -> str:
    """The one-line fleet status (`dlcfn-tpu fleet status`)."""
    f = summary["fleet"]
    n = summary["source"]["replicas"]
    line = (f"fleet {n} replica(s) | {_fmt(f['tokens_per_sec'])} tok/s | "
            f"done {_fmt(f['completed'])}/{_fmt(f['submitted'])} | "
            f"worst p95 {_fmt(f['worst_latency_p95_s'], 's')} | "
            f"alerts {f['alerts']}")
    a = summary.get("autoscale")
    if a:
        line += (f" | scale {a['state']} "
                 f"+{a['scale_ups']}/-{a['scale_downs']}")
    d = summary.get("degrade")
    if d:
        line += f" | brownout L{d['level']} ({d['level_name']})"
    return line


def render_fleet_report(summary: Dict[str, Any]) -> str:
    """Human rendering of :func:`summarize_fleet`: the aggregate line,
    then one compact line per replica."""
    L: List[str] = []
    src = summary["source"]
    L.append(f"fleet report: {src['path']}")
    L.append(f"  {fleet_status_line(summary)}")
    f = summary["fleet"]
    if f["launch_attempts"]:
        failed = (f" FAILED: {', '.join(f['launch_failed_replicas'])}"
                  if f["launch_failed_replicas"] else "")
        L.append(f"  launch: {f['launch_attempts']} attempt(s), "
                 f"{f['launch_restarts']} restart(s){failed}")
    a = summary.get("autoscale")
    if a:
        why = f" — {a['last_reason']}" if a.get("last_reason") else ""
        L.append(f"  autoscale: {a['state']} | "
                 f"+{a['scale_ups']} up / -{a['scale_downs']} down "
                 f"({a['drained_scale_downs']} drained) | last: "
                 f"{a['last_action']} {a['last_replica']}{why}")
    d = summary.get("degrade")
    if d:
        dwhy = f" — {d['last_reason']}" if d.get("last_reason") else ""
        L.append(f"  brownout: level {d['level']} ({d['level_name']}) | "
                 f"{d['degrades']} degrade(s) / {d['recovers']} "
                 f"recover(s) | last: {d['last_action']}{dwhy}")
    qbp = f.get("queue_depth_by_phase")
    if qbp and set(qbp) != {"both"}:
        L.append("  queue depth by phase: " + "  ".join(
            f"{phase}={qbp[phase]}" for phase in sorted(qbp)))
    for name, s in summary["replicas"].items():
        sv = s.get("serve") or {}
        la = s.get("launch") or {}
        al = s.get("alerts") or {}
        lat = sv.get("latency_s") or {}
        bits = [f"{_fmt(sv.get('tokens_per_sec'))} tok/s",
                f"done {_fmt(sv.get('completed'))}/"
                f"{_fmt(sv.get('submitted'))}",
                f"p95 {_fmt(lat.get('p95'), 's')}"]
        if sv.get("phase"):
            bits.insert(0, f"phase {sv['phase']} "
                           f"(q {_fmt(sv.get('queue_depth'))})")
        if la:
            bits.append(
                f"launch {','.join(str(o) for o in la['outcomes'])}")
        if al:
            bits.append(f"alerts {al['count']}")
        L.append(f"  {name:<16} " + " | ".join(bits))
    if not summary["replicas"]:
        L.append("  (no replica run dirs with records found)")
    return "\n".join(L)
