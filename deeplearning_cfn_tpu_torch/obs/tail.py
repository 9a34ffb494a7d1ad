"""Live run follower: ``dlcfn-tpu obs tail <run_dir>``.

A copy of the JAX package's ``obs/tail.py``, which imports
nothing of JAX (the port never imports that package).

Follows a run's JSONL streams as they grow and renders a one-line status
(step, step time, examples/sec, loss | queue depth, tokens/sec | alert
count) every time something changes — the "is it healthy right now"
glance `obs summarize` can only give post-hoc.

The follower is **truncation-tolerant** by construction:

- a trailing partial line (the writer is mid-``write()``, or the process
  crashed mid-line) is buffered until its newline arrives and is never
  parsed early — so a torn line can only delay one record, not corrupt
  the stream;
- unparseable complete lines are counted and skipped, same as
  ``obs summarize``;
- a file that shrinks (rotation, restart from scratch) resets the read
  offset to zero instead of erroring;
- files that don't exist yet (``logs/launch.jsonl`` before the first
  attempt finishes) are silently retried each poll.

Optionally evaluates SLO rules live (``--rules``): alerts print as their
own lines above the status, so a degrading run is visible the moment the
rule fires, not at the postmortem.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, List, Optional


class JsonlFollower:
    """Incremental reader of one JSONL file; ``poll()`` returns the
    complete records appended since the previous call."""

    def __init__(self, path: str):
        self.path = path
        self._pos = 0
        self._buf = ""
        self.skipped = 0

    def poll(self) -> List[Dict[str, Any]]:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size < self._pos:        # truncated/rotated: start over
            self._pos = 0
            self._buf = ""
        if size == self._pos:
            return []
        try:
            with open(self.path, "r") as fh:
                fh.seek(self._pos)
                chunk = fh.read()
                self._pos = fh.tell()
        except OSError:
            return []
        self._buf += chunk
        # Everything before the last newline is complete; the remainder
        # is a partial line held for the next poll.
        if "\n" in self._buf:
            complete, self._buf = self._buf.rsplit("\n", 1)
            lines = complete.split("\n")
        else:
            return []
        records = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                self.skipped += 1
                continue
            if isinstance(rec, dict):
                records.append(rec)
            else:
                self.skipped += 1
        return records


class TailState:
    """Folds the record stream into the current one-line status."""

    def __init__(self):
        self.step: Optional[Any] = None
        self.step_time_s: Optional[float] = None
        self.examples_per_sec: Optional[float] = None
        self.loss: Optional[float] = None
        self.queue_depth: Optional[Any] = None
        self.tokens_per_sec: Optional[float] = None
        self.latency_p95_s: Optional[float] = None
        self.completed: Optional[Any] = None
        self.submitted: Optional[Any] = None
        self.preemptions: Optional[Any] = None
        self.radix_hits: Optional[Any] = None
        self.radix_hit_rate: Optional[Any] = None
        self.chunk_ticks: Optional[Any] = None
        self.chunk_partial: Optional[Any] = None
        self.alerts = 0
        self.last_alert: Optional[str] = None
        self.launch_outcome: Optional[str] = None
        self.span_failures = 0
        self.records = 0

    def update(self, r: Dict[str, Any]) -> None:
        self.records += 1
        if r.get("event") == "alert":
            self.alerts += 1
            self.last_alert = str(r.get("rule", "?"))
            return
        if r.get("event") == "launch_attempt":
            self.launch_outcome = str(r.get("outcome", "?"))
            return
        if "span" in r:
            if r.get("ok") is False:
                self.span_failures += 1
            return
        if any(k.startswith("serve_") for k in r):
            for attr, key in (("queue_depth", "serve_queue_depth"),
                              ("tokens_per_sec", "serve_tokens_per_sec"),
                              ("latency_p95_s", "serve_latency_p95_s"),
                              ("completed", "serve_completed"),
                              ("submitted", "serve_submitted"),
                              ("preemptions", "serve_preemptions"),
                              ("radix_hits", "serve_radix_hits"),
                              ("radix_hit_rate", "serve_radix_hit_rate"),
                              ("chunk_ticks", "serve_chunk_ticks"),
                              ("chunk_partial",
                               "serve_chunk_partial_rows")):
                if key in r:
                    setattr(self, attr, r[key])
            return
        for key in ("step", "step_time_s", "examples_per_sec", "loss"):
            if key in r:
                setattr(self, key, r[key])

    def status_line(self) -> str:
        def _f(v: Any) -> str:
            if v is None:
                return "-"
            if isinstance(v, float):
                return f"{v:.4g}"
            return str(v)

        parts = []
        if self.step is not None or self.loss is not None:
            sps = None
            if isinstance(self.step_time_s, (int, float)) \
                    and self.step_time_s > 0:
                sps = 1.0 / self.step_time_s
            parts.append(f"step {_f(self.step)} "
                         f"({_f(sps)} steps/s, "
                         f"{_f(self.examples_per_sec)} ex/s) "
                         f"loss {_f(self.loss)}")
        if self.submitted is not None or self.queue_depth is not None:
            serve = (f"serve q={_f(self.queue_depth)} "
                     f"{_f(self.tokens_per_sec)} tok/s "
                     f"done {_f(self.completed)}/{_f(self.submitted)}")
            if self.preemptions is not None:
                # Only QoS-active engines emit serve_preemptions —
                # single-tenant status lines stay byte-identical.
                serve += f" preempt {_f(self.preemptions)}"
            if self.radix_hits is not None:
                # Only --radix-cache engines emit serve_radix_* — other
                # configurations' status lines stay byte-identical.
                serve += (f" radix {_f(self.radix_hits)}"
                          f"@{_f(self.radix_hit_rate)}")
            if self.chunk_ticks is not None:
                # Only --prefill-chunk engines emit serve_chunk_* —
                # unchunked status lines stay byte-identical.
                serve += (f" chunk {_f(self.chunk_ticks)}"
                          f"~{_f(self.chunk_partial)}p")
            parts.append(serve)
        if self.launch_outcome is not None:
            parts.append(f"launch {self.launch_outcome}")
        alerts = f"alerts {self.alerts}"
        if self.last_alert:
            alerts += f" (last: {self.last_alert})"
        if self.span_failures:
            alerts += f" span-failures {self.span_failures}"
        parts.append(alerts)
        if not parts:
            return "(no records yet)"
        return " | ".join(parts)


class FleetTailState:
    """A :class:`~.signals.SignalBus` folded live into ONE fleet status
    line: total tokens/sec and queue depth across replicas, aggregate
    done/submitted, the WORST per-replica latency p95, total alerts —
    the same aggregate `obs summarize --fleet` reports, because both
    read the identical bus fold."""

    def __init__(self, names: List[str]):
        from .signals import SignalBus

        # "#"-prefixed names are control streams (the fleet root's own
        # autoscale.jsonl), not replicas — they feed the scale fold
        # below, never the bus.
        self.bus = SignalBus(names=[n for n in names
                                    if not n.startswith("#")])
        # Live membership + autoscale fold. ``members`` maps replica →
        # phase and tracks scale events as they stream in: a fleet's
        # membership is no longer fixed for the life of one `fleet up`.
        self.members: Dict[str, Optional[str]] = {
            n: None for n in names if not n.startswith("#")}
        self.scale_ups = 0
        self.scale_downs = 0
        self.last_scale: Optional[Dict[str, Any]] = None
        self._open_drains: set = set()
        self._scale_seen = False
        # Per-replica preemption counters (QoS fleets only — the key is
        # absent from single-tenant snapshots).
        self._preemptions: Dict[str, int] = {}
        # Per-replica radix hit counters (--radix-cache fleets only).
        self._radix_hits: Dict[str, int] = {}
        # Per-replica chunk tick counters (--prefill-chunk fleets only).
        self._chunk_ticks: Dict[str, int] = {}
        # Brownout fold (--degrade fleets only): the last degrade_event
        # carries the current level.
        self.last_degrade: Optional[Dict[str, Any]] = None
        self.degrade_transitions = 0

    def update(self, name: str, rec: Dict[str, Any]) -> None:
        if rec.get("event") == "degrade_event":
            self.degrade_transitions += 1
            self.last_degrade = rec
            return
        if rec.get("event") == "scale_event":
            self._scale_seen = True
            action = rec.get("action")
            replica = rec.get("replica")
            phase = rec.get("phase")
            if action == "scale_up":
                self.scale_ups += 1
                self.members[replica] = phase
                self._open_drains.discard(replica)
            elif action == "drain_begin":
                self.members.setdefault(replica, phase)
                self._open_drains.add(replica)
            elif action == "scale_down":
                self.scale_downs += 1
                self._open_drains.discard(replica)
                self.members.pop(replica, None)
            self.last_scale = rec
            return
        if name.startswith("#"):
            return
        if name not in self.members:
            self.members[name] = rec.get("phase")
        elif self.members[name] is None and rec.get("phase"):
            self.members[name] = rec.get("phase")
        if isinstance(rec.get("serve_preemptions"), (int, float)):
            self._preemptions[name] = int(rec["serve_preemptions"])
        if isinstance(rec.get("serve_radix_hits"), (int, float)):
            self._radix_hits[name] = int(rec["serve_radix_hits"])
        if isinstance(rec.get("serve_chunk_ticks"), (int, float)):
            self._chunk_ticks[name] = int(rec["serve_chunk_ticks"])
        self.bus.observe(name, rec)

    def scale_state(self) -> str:
        if self._open_drains:
            return "draining"
        if self.last_scale is not None \
                and self.last_scale.get("action") == "scale_up":
            return "scaling-up"
        return "steady"

    def status_line(self) -> str:
        def _f(v: Any) -> str:
            if v is None:
                return "-"
            if isinstance(v, float):
                return f"{v:.4g}"
            return str(v)

        f = self.bus.fleet()
        if f["replicas_live"] == 0:
            return f"fleet {f['replicas']} replica(s) | (no records yet)"
        parts = [f"fleet {f['replicas_live']}/{f['replicas']} replica(s)",
                 f"q={_f(f['queue_depth'])} "
                 f"{_f(f['tokens_per_sec'])} tok/s",
                 f"done {_f(f['completed'])}/{_f(f['submitted'])}",
                 f"worst p95 {_f(f['worst_latency_p95_s'])}",
                 f"alerts {f['alerts']}"]
        if self._preemptions:
            parts.insert(3, f"preempt {sum(self._preemptions.values())}")
        if self._radix_hits:
            parts.insert(3, f"radix {sum(self._radix_hits.values())}")
        if self._chunk_ticks:
            parts.insert(3, f"chunk {sum(self._chunk_ticks.values())}")
        fails = {n: s.launch_outcome
                 for n, s in self.bus.replicas.items()
                 if s.launch_outcome not in (None, "ok")}
        if fails:
            parts.append("launch " + ",".join(
                f"{n}:{o}" for n, o in sorted(fails.items())))
        if self._scale_seen:
            # Autoscaled fleet: surface live membership (with phase)
            # and the controller state + last event reason. Fixed
            # fleets never see a scale_event, so the legacy line is
            # unchanged byte for byte.
            parts.append("members " + ",".join(
                f"{n}:{self.members[n] or '?'}"
                for n in sorted(self.members)))
            last = self.last_scale or {}
            why = f" — {last['reason']}" if last.get("reason") else ""
            parts.append(
                f"scale {self.scale_state()} "
                f"(last: {last.get('action')} {last.get('replica')}"
                f"{why})")
        if self.last_degrade is not None:
            # Browning-out fleet: surface the live level. Fleets that
            # never degrade see no degrade_event, so the legacy line
            # stays byte-identical.
            d = self.last_degrade
            parts.append(f"brownout L{d.get('level')} "
                         f"({d.get('level_name')}, "
                         f"{self.degrade_transitions} transition(s))")
        return " | ".join(parts)


def _follow_paths(path: str) -> List[str]:
    if os.path.isdir(path):
        return [os.path.join(path, "metrics.jsonl"),
                os.path.join(path, "logs", "launch.jsonl")]
    return [path]


def _fleet_followers(root: str) -> List[tuple]:
    """[(replica_name, JsonlFollower)] over every per-replica run dir
    under ``root`` (the same filter ``obs summarize --fleet`` uses),
    plus the ``#autoscale`` control stream (``<root>/autoscale.jsonl``,
    which may not exist yet — the follower retries silently). The tail
    loop re-runs this discovery every poll: an autoscaled fleet grows
    new replica dirs mid-follow."""
    from .report import fleet_replica_dirs

    pairs = []
    for name, sub in fleet_replica_dirs(root):
        for p in _follow_paths(sub):
            pairs.append((name, JsonlFollower(p)))
    pairs.append(("#autoscale",
                  JsonlFollower(os.path.join(root, "autoscale.jsonl"))))
    pairs.append(("#degrade",
                  JsonlFollower(os.path.join(root, "degrade.jsonl"))))
    return pairs


def tail(path: str, interval_s: float = 1.0,
         max_seconds: Optional[float] = None, once: bool = False,
         slo_engine=None, out=None, fleet: bool = False) -> int:
    """Follow ``path`` (a run dir or one JSONL file), printing the status
    line whenever it changes. ``once`` renders current state and returns
    (tests and scripts); ``max_seconds`` bounds a follow. ``fleet``
    treats ``path`` as a directory of per-replica run dirs and renders
    ONE aggregated fleet status line. Returns 0."""
    out = out if out is not None else sys.stdout
    if fleet:
        pairs = _fleet_followers(path)
        fstate = FleetTailState([n for n, _ in pairs])
    else:
        pairs = [(None, JsonlFollower(p)) for p in _follow_paths(path)]
        state = TailState()
    deadline = (time.monotonic() + max_seconds
                if max_seconds is not None else None)
    last_line = None
    while True:
        if fleet:
            # Membership can change under a live follow (autoscale):
            # pick up newly created replica dirs each poll.
            known = {f.path for _, f in pairs}
            for name, f in _fleet_followers(path):
                if f.path not in known:
                    pairs.append((name, f))
        for name, f in pairs:
            for rec in f.poll():
                def _fold(r):
                    if fleet:
                        fstate.update(name, r)
                    else:
                        state.update(r)
                if slo_engine is not None and rec.get("event") != "alert":
                    for alert in slo_engine.observe(rec):
                        _fold(alert)
                        print(f"ALERT {alert['rule']}: "
                              f"{alert.get('detail', '')}", file=out)
                _fold(rec)
        line = fstate.status_line() if fleet else state.status_line()
        if line != last_line:
            print(line, file=out)
            try:
                out.flush()
            except (AttributeError, OSError):
                pass
            last_line = line
        if once:
            return 0
        if deadline is not None and time.monotonic() >= deadline:
            return 0
        time.sleep(interval_s)
