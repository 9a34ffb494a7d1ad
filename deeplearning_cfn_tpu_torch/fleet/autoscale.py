"""Closed-loop fleet autoscaling: SignalBus pressure in, membership
changes out.

The controller closes the loop the SignalBus was built for: each fleet
tick it folds the bus's per-replica last values into per-pool pressure
signals (queue depth, retry-after pressure, worst decode p95,
speculation-acceptance collapse), pushes them through **hysteresis**
thresholds (the scale-up line sits strictly above the scale-down line,
and each decision must hold for a streak of consecutive ticks) plus a
per-pool **cooldown**, and emits at most one membership change per pool
per tick:

- **scale-up** — spawn a fresh replica (an ``EngineReplica`` from the
  injected spawner; process fleets use :class:`SupervisedSpawner`,
  which runs one single-spec :class:`~.replica.ReplicaSupervisor` per
  spawn) and ``Router.add`` it, so the very next placement can route to
  it.
- **scale-down** — the same zero-drop contract as ``fleet rollout``:
  ``Router.drain`` the victim (no NEW work routes to it), let in-flight
  streams finish, then ``Router.remove`` (which evacuates anything a
  drain grace period could not flush and snapshots finished-but-unread
  results). ``dropped_requests`` stays 0 by construction.

**Pools are phase-aware**: a disaggregated fleet scales its prefill and
decode pools independently — prefill pressure (queue depth, retry-after)
adds prefill replicas; decode pressure (worst p95, acceptance collapse)
adds decode replicas. A co-located fleet is a single ``both`` pool.

Determinism: the controller never reads a wall clock — ``clock`` is
injected (the bench passes the replay :class:`~..loadgen.VirtualClock`),
the bus is deterministic by construction, and thresholds that depend on
wall-time measurements (latency, retry hints) default to *disabled*
(``inf``) so a default-config bench makes identical decisions on every
run. Two runs with the same seed produce identical scale-event
sequences — the AUTOSCALE_SMOKE gate replays twice and diffs them.

A copy of the JAX package's ``fleet/autoscale.py`` (it imports nothing
of JAX).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional

from .replica import EngineReplica, ReplicaProcSpec, ReplicaSupervisor


def pool_signals(bus, replica_ids: List[str]) -> Dict[str, Any]:
    """Fold one pool's slice of the SignalBus into the four autoscale
    pressure signals, with the same null-over-zero convention as
    ``SignalBus.fleet()`` (None = "no member reported it")."""
    sigs = [bus.replicas[r] for r in replica_ids if r in bus.replicas]

    def _vals(name):
        return [s.last[name] for s in sigs
                if isinstance(s.last.get(name), (int, float))]

    depths = _vals("queue_depth")
    p95s = _vals("latency_p95_s")
    hints = _vals("retry_after_hint_s")
    accept = _vals("spec_accept_rate")
    return {
        "members_reporting": len(sigs),
        "queue_depth": sum(depths) if depths else None,
        "worst_latency_p95_s": max(p95s) if p95s else None,
        "retry_after_pressure_s": max(hints) if hints else None,
        "spec_accept_rate_min": min(accept) if accept else None,
    }


@dataclasses.dataclass
class AutoscalePolicy:
    """Thresholds and pacing for one controller (applied per pool).

    Hysteresis has two layers: the up thresholds sit strictly above the
    down thresholds (``up_queue_depth > down_queue_depth``, both
    per-routable-replica), and a decision only fires after holding for
    ``up_stable_ticks`` / ``down_stable_ticks`` consecutive ticks.
    ``cooldown_s`` (controller-clock seconds) then blocks the next
    action in either direction, so a burst edge cannot flap.

    The wall-time-derived signals (worst decode p95, retry-after
    pressure) and the acceptance-collapse trigger default to DISABLED
    (``inf`` / ``0``): they are real pressure signals an operator can
    opt into, but a deterministic bench must not key decisions off
    measured latencies.
    """

    min_replicas: int = 1
    max_replicas: int = 4
    # scale-up triggers (any one breaches)
    up_queue_depth: float = 1.5        # per routable replica
    up_retry_after_s: float = math.inf
    up_latency_p95_s: float = math.inf
    up_spec_accept_below: float = 0.0  # accept-rate collapse trigger
    # scale-down trigger (all must hold)
    down_queue_depth: float = 0.5      # per routable replica
    # pacing
    up_stable_ticks: int = 2
    down_stable_ticks: int = 8
    cooldown_s: float = 1.0
    drain_grace_ticks: int = 200       # force-evacuate after this many

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas ({self.max_replicas}) must be >= "
                f"min_replicas ({self.min_replicas})")
        if self.up_queue_depth <= self.down_queue_depth:
            raise ValueError(
                f"hysteresis requires up_queue_depth "
                f"({self.up_queue_depth}) > down_queue_depth "
                f"({self.down_queue_depth})")
        if self.up_stable_ticks < 1 or self.down_stable_ticks < 1:
            raise ValueError("stability streaks must be >= 1")
        if self.cooldown_s < 0:
            raise ValueError(
                f"cooldown_s must be >= 0, got {self.cooldown_s}")
        if self.drain_grace_ticks < 1:
            raise ValueError("drain_grace_ticks must be >= 1")


class Autoscaler:
    """One controller over one Router + SignalBus.

    Call :meth:`tick` once per fleet tick (after the bench has fed this
    tick's serve snapshots into the bus). Membership changes go through
    the router; every decision appends a ``scale_event`` record to
    :attr:`events` (and ``event_sink``, if given — the bench points it
    at ``autoscale.jsonl`` so ``obs summarize/tail --fleet`` replay the
    same stream).

    ``spawner(phase, replica_id) -> EngineReplica`` builds new
    replicas; an object with ``.spawn`` (and optionally ``.retire``,
    called after a scaled-down replica leaves the router) also works —
    that is the :class:`SupervisedSpawner` process-fleet shape.
    """

    def __init__(self, router, bus, spawner,
                 policy: Optional[AutoscalePolicy] = None,
                 clock: Callable[[], float] = time.monotonic,
                 event_sink: Optional[Callable[[Dict], Any]] = None):
        self.router = router
        self.bus = bus
        self.spawner = spawner
        self.policy = policy or AutoscalePolicy()
        self.clock = clock
        self.event_sink = event_sink
        self.events: List[Dict[str, Any]] = []
        self._spawn_seq: Dict[str, int] = {}
        self._spawned: Dict[str, List[str]] = {}
        self._draining: Dict[str, Dict[str, Any]] = {}  # rid → drain state
        self._up_streak: Dict[str, int] = {}
        self._down_streak: Dict[str, int] = {}
        self._last_action_ts: Dict[str, float] = {}

    @property
    def draining(self) -> List[str]:
        """Replica ids currently mid-drain (drain_begin emitted, not
        yet removed)."""
        return sorted(self._draining)

    # -- introspection -------------------------------------------------------

    def phases(self) -> List[str]:
        """The pools under control, derived live from router membership
        (plus any pool currently mid-drain)."""
        seen = {getattr(self.router.replica(rid), "phase", "both")
                for rid in self.router.replica_ids()}
        seen.update(d["phase"] for d in self._draining.values())
        return sorted(seen)

    def pool_members(self, phase: str) -> List[str]:
        return [rid for rid in self.router.replica_ids()
                if getattr(self.router.replica(rid), "phase", "both")
                == phase]

    def state(self, phase: Optional[str] = None) -> str:
        """steady | scaling-up | draining — what tail/status surface."""
        drains = [d for d in self._draining.values()
                  if phase is None or d["phase"] == phase]
        if drains:
            return "draining"
        for ev in reversed(self.events):
            if phase is not None and ev.get("phase") != phase:
                continue
            if ev["action"] == "scale_up":
                return "scaling-up"
            break
        return "steady"

    # -- the control loop ----------------------------------------------------

    def tick(self) -> List[Dict[str, Any]]:
        """One control decision per pool. Returns the events emitted
        this tick (possibly empty)."""
        emitted: List[Dict[str, Any]] = []
        now = self.clock()
        emitted.extend(self._advance_drains(now))
        p = self.policy
        for phase in self.phases():
            members = self.pool_members(phase)
            active = [rid for rid in members if rid not in self._draining]
            if not members:
                continue
            routable = sum(
                1 for rid in members
                if self.router.replica(rid).routable) or 1
            sig = pool_signals(self.bus, members)
            breach = self._breach(sig, routable)
            calm = breach is None and self._calm(sig, routable)
            self._up_streak[phase] = \
                self._up_streak.get(phase, 0) + 1 if breach else 0
            self._down_streak[phase] = \
                self._down_streak.get(phase, 0) + 1 if calm else 0
            if now - self._last_action_ts.get(phase, -math.inf) \
                    < p.cooldown_s:
                continue
            if breach and self._up_streak[phase] >= p.up_stable_ticks \
                    and len(active) < p.max_replicas:
                emitted.append(self._scale_up(phase, now, breach, sig))
            elif calm and not any(d["phase"] == phase
                                  for d in self._draining.values()) \
                    and self._down_streak[phase] >= p.down_stable_ticks \
                    and len(active) > p.min_replicas:
                emitted.append(self._begin_drain(phase, now, sig))
        return emitted

    def _breach(self, sig: Dict[str, Any],
                routable: int) -> Optional[str]:
        p = self.policy
        qd = sig["queue_depth"]
        if qd is not None and qd > p.up_queue_depth * routable:
            return (f"queue_depth {qd:g} > "
                    f"{p.up_queue_depth * routable:g}")
        retry = sig["retry_after_pressure_s"]
        if retry is not None and retry > p.up_retry_after_s:
            return (f"retry_after_pressure {retry:.3f}s > "
                    f"{p.up_retry_after_s:.3f}s")
        p95 = sig["worst_latency_p95_s"]
        if p95 is not None and p95 > p.up_latency_p95_s:
            return (f"worst_decode_p95 {p95:.3f}s > "
                    f"{p.up_latency_p95_s:.3f}s")
        accept = sig["spec_accept_rate_min"]
        if accept is not None and accept < p.up_spec_accept_below:
            return (f"spec_accept_rate {accept:.2f} < "
                    f"{p.up_spec_accept_below:.2f}")
        return None

    def _calm(self, sig: Dict[str, Any], routable: int) -> bool:
        qd = sig["queue_depth"]
        return qd is not None \
            and qd <= self.policy.down_queue_depth * routable

    # -- actions -------------------------------------------------------------

    def _scale_up(self, phase: str, now: float, reason: str,
                  sig: Dict[str, Any]) -> Dict[str, Any]:
        n = self._spawn_seq.get(phase, 0)
        self._spawn_seq[phase] = n + 1
        rid = f"auto-{phase}-{n}"
        spawn = getattr(self.spawner, "spawn", self.spawner)
        replica = spawn(phase, rid)
        self.router.add(replica)
        self._spawned.setdefault(phase, []).append(replica.id)
        self._last_action_ts[phase] = now
        self._up_streak[phase] = 0
        return self._emit({
            "event": "scale_event", "action": "scale_up", "ts": now,
            "phase": phase, "replica": replica.id, "reason": reason,
            "pool_size": len(self.pool_members(phase)),
            "signals": dict(sig),
        })

    def _begin_drain(self, phase: str, now: float,
                     sig: Dict[str, Any]) -> Dict[str, Any]:
        victim = self._pick_victim(phase)
        self.router.drain(victim)
        self._draining[victim] = {"phase": phase, "since": now,
                                  "ticks": 0}
        self._last_action_ts[phase] = now
        self._down_streak[phase] = 0
        qd = sig["queue_depth"]
        return self._emit({
            "event": "scale_event", "action": "drain_begin", "ts": now,
            "phase": phase, "replica": victim,
            "reason": f"pool calm (queue_depth "
                      f"{qd if qd is not None else 0:g} <= "
                      f"{self.policy.down_queue_depth:g}/replica)",
            "pool_size": len(self.pool_members(phase)),
            "signals": dict(sig),
        })

    def _pick_victim(self, phase: str) -> str:
        """Newest self-spawned member first (LIFO keeps the operator's
        seed replicas pinned), else the highest replica id."""
        candidates = [rid for rid in self.pool_members(phase)
                      if rid not in self._draining]
        for rid in reversed(self._spawned.get(phase, [])):
            if rid in candidates:
                return rid
        return max(candidates)

    def _advance_drains(self, now: float) -> List[Dict[str, Any]]:
        emitted = []
        for rid in sorted(self._draining):
            d = self._draining[rid]
            d["ticks"] += 1
            rep = self.router.replica(rid)
            idle = not rep.busy
            expired = d["ticks"] >= self.policy.drain_grace_ticks
            if not idle and not expired:
                continue
            if not idle:
                # Grace expired with streams still live: evacuate them
                # to the survivors (still zero-drop) before removal.
                self.router.evacuate(rid)
            self.router.remove(rid)
            retire = getattr(self.spawner, "retire", None)
            if retire is not None:
                retire(rid)
            del self._draining[rid]
            phase = d["phase"]
            spawned = self._spawned.get(phase, [])
            if rid in spawned:
                spawned.remove(rid)
            emitted.append(self._emit({
                "event": "scale_event", "action": "scale_down",
                "ts": now, "phase": phase, "replica": rid,
                "drained": idle, "drain_ticks": d["ticks"],
                "reason": ("drained idle" if idle else
                           f"drain grace expired after {d['ticks']} "
                           f"ticks, evacuated"),
                "pool_size": len(self.pool_members(phase)),
            }))
        return emitted

    def _emit(self, ev: Dict[str, Any]) -> Dict[str, Any]:
        self.events.append(ev)
        if self.event_sink is not None:
            self.event_sink(ev)
        return ev


class SupervisedSpawner:
    """Process-fleet spawner: one single-spec
    :class:`~.replica.ReplicaSupervisor` per scale-up, so each spawned
    replica gets the launcher's restart budget and its own
    ``logs/launch.jsonl`` stream (the same per-attempt records
    ``obs summarize --fleet`` already folds).

    ``spec_factory(phase, replica_id) -> ReplicaProcSpec`` describes the
    child process; ``replica_factory(phase, replica_id) ->
    EngineReplica`` builds the router-side handle for it (in-process
    benches return an engine-backed replica; cross-host fleets return a
    client-backed one).
    """

    def __init__(self, spec_factory: Callable[[str, str],
                                              ReplicaProcSpec],
                 replica_factory: Callable[[str, str], EngineReplica],
                 transport=None, max_restarts: int = 1):
        self.spec_factory = spec_factory
        self.replica_factory = replica_factory
        self.transport = transport
        self.max_restarts = max_restarts
        self.supervisors: Dict[str, ReplicaSupervisor] = {}

    def spawn(self, phase: str, replica_id: str) -> EngineReplica:
        spec = self.spec_factory(phase, replica_id)
        sup = ReplicaSupervisor([spec], transport=self.transport,
                                max_restarts=self.max_restarts)
        sup.start()
        self.supervisors[replica_id] = sup
        return self.replica_factory(phase, replica_id)

    def retire(self, replica_id: str) -> None:
        sup = self.supervisors.pop(replica_id, None)
        if sup is not None:
            sup.terminate()
            sup.close()

    def close(self) -> None:
        for rid in list(self.supervisors):
            self.retire(rid)
