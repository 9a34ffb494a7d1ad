"""Brownout graceful degradation: shed *work quality* before shedding
*traffic*.

Overload that outruns autoscaling (or hits a fixed-size fleet) should
not jump straight to rejecting requests. The brownout controller walks
the fleet through audited degradation levels, cheapest first, and walks
back up hysteretically once pressure clears:

- **level 0 — normal**: no intervention.
- **level 1 — no_spec**: disable speculative decoding. Speculation
  burns extra device FLOPs per emitted token for latency upside the
  fleet cannot afford under pressure; the plain path emits the exact
  same greedy tokens.
- **level 2 — window_cap**: cap fused decode windows at
  ``window_cap``. Shorter windows keep per-tick latency and admission
  freshness bounded at some throughput cost — again token-identical.
- **level 3 — shed_batch**: stop admitting the throughput-tier QoS
  classes (``shed_classes``, default ``batch``) so latency-tier
  traffic keeps its SLO. Shed submits raise ``OverloadError`` with an
  honest retry hint; nothing in flight is touched.

Latency-class rejections only ever come from real queue overflow —
the controller itself never rejects, it only narrows what gets in.

Every transition appends a ``degrade_event`` record to :attr:`events`
(and ``event_sink``, which the bench points at
``<trace_dir>/degrade.jsonl``) with the same shape discipline as
autoscale's ``scale_event`` stream, so ``obs summarize``/``tail
--fleet`` fold both.

Determinism mirrors :mod:`.autoscale`: decisions key ONLY off the
SignalBus queue-depth fold (never a measured latency), pacing is
tick-counted, and ``clock`` is injected solely to stamp events — two
replays of the same schedule emit identical transition sequences.

A copy of the JAX package's ``fleet/degrade.py`` (it imports nothing of
JAX).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

from .autoscale import pool_signals

LEVEL_NAMES = ("normal", "no_spec", "window_cap", "shed_batch")
MAX_LEVEL = len(LEVEL_NAMES) - 1


@dataclasses.dataclass
class DegradePolicy:
    """Thresholds and pacing for one brownout controller.

    The same two-layer hysteresis as autoscale: the degrade line sits
    strictly above the recover line (both per-routable-replica queue
    depth), each step must hold for a streak of consecutive ticks, and
    ``cooldown_ticks`` blocks the next step in either direction — so
    the fleet ratchets one level at a time and a burst edge cannot
    flap. ``level_recovery_s`` is the operator's estimate of how long
    one recovery step takes end to end; the router folds
    ``level * level_recovery_s`` into overload retry hints while
    degraded (see :meth:`DegradeController.recovery_horizon_s`).
    """

    up_queue_depth: float = 3.0     # per routable replica
    down_queue_depth: float = 1.0   # per routable replica
    up_stable_ticks: int = 2
    down_stable_ticks: int = 4
    cooldown_ticks: int = 2
    window_cap: int = 1             # level-2 fused-window ceiling
    shed_classes: tuple = ("batch",)  # level-3 admission cut
    level_recovery_s: float = 0.05  # expected seconds per recover step

    def __post_init__(self):
        if self.up_queue_depth <= self.down_queue_depth:
            raise ValueError(
                f"hysteresis requires up_queue_depth "
                f"({self.up_queue_depth}) > down_queue_depth "
                f"({self.down_queue_depth})")
        if self.up_stable_ticks < 1 or self.down_stable_ticks < 1:
            raise ValueError("stability streaks must be >= 1")
        if self.cooldown_ticks < 0:
            raise ValueError(
                f"cooldown_ticks must be >= 0, got {self.cooldown_ticks}")
        if self.window_cap < 1:
            raise ValueError(
                f"window_cap must be >= 1, got {self.window_cap}")
        if self.level_recovery_s < 0:
            raise ValueError(
                f"level_recovery_s must be >= 0, "
                f"got {self.level_recovery_s}")


class DegradeController:
    """One brownout loop over one Router + SignalBus.

    Attach with ``router.degrade = controller`` — ``Router.step`` then
    ticks it first thing each fleet tick (after the bench has fed the
    tick's serve snapshots into the bus) and ``Router._place`` adds
    :meth:`recovery_horizon_s` to overload hints while degraded.

    The level's knobs are re-applied to every current member each tick
    (idempotent assignments), so replicas that join mid-brownout —
    autoscale spawns, rollout replacements — inherit the active level
    immediately.
    """

    def __init__(self, router, bus,
                 policy: Optional[DegradePolicy] = None,
                 clock: Callable[[], float] = time.monotonic,
                 event_sink: Optional[Callable[[Dict], Any]] = None):
        self.router = router
        self.bus = bus
        self.policy = policy or DegradePolicy()
        self.clock = clock
        self.event_sink = event_sink
        self.level = 0
        self.events: List[Dict[str, Any]] = []
        self._ticks = 0
        self._up_streak = 0
        self._down_streak = 0
        self._last_action_tick: Optional[int] = None

    @property
    def level_name(self) -> str:
        return LEVEL_NAMES[self.level]

    @property
    def transitions(self) -> int:
        """Total level changes so far (the bench record field)."""
        return len(self.events)

    def recovery_horizon_s(self) -> float:
        """Expected time for the fleet to step back to normal from the
        current level — what an overloaded client should add to its
        backoff so it does not return mid-brownout."""
        return self.level * self.policy.level_recovery_s

    # -- the control loop ----------------------------------------------------

    def tick(self) -> List[Dict[str, Any]]:
        """One brownout decision; returns the events emitted this tick
        (at most one — levels ratchet singly)."""
        self._ticks += 1
        p = self.policy
        members = self.router.replica_ids()
        routable = sum(1 for rid in members
                       if self.router.replica(rid).routable) or 1
        sig = pool_signals(self.bus, members)
        qd = sig["queue_depth"]
        hot = qd is not None and qd > p.up_queue_depth * routable
        calm = qd is not None and qd <= p.down_queue_depth * routable
        self._up_streak = self._up_streak + 1 if hot else 0
        self._down_streak = self._down_streak + 1 if calm else 0
        emitted: List[Dict[str, Any]] = []
        in_cooldown = (self._last_action_tick is not None
                       and self._ticks - self._last_action_tick
                       <= p.cooldown_ticks)
        if not in_cooldown:
            if hot and self._up_streak >= p.up_stable_ticks \
                    and self.level < MAX_LEVEL:
                emitted.append(self._shift(
                    +1, f"queue_depth {qd:g} > "
                        f"{p.up_queue_depth * routable:g}", sig))
            elif calm and self._down_streak >= p.down_stable_ticks \
                    and self.level > 0:
                emitted.append(self._shift(
                    -1, f"queue_depth {qd:g} <= "
                        f"{p.down_queue_depth * routable:g}", sig))
        # Re-applied every tick so mid-brownout joiners inherit the
        # level; pure attribute writes, idempotent.
        self._apply()
        return emitted

    def _shift(self, delta: int, reason: str,
               sig: Dict[str, Any]) -> Dict[str, Any]:
        self.level += delta
        self._last_action_tick = self._ticks
        self._up_streak = 0
        self._down_streak = 0
        ev = {
            "event": "degrade_event",
            "action": "degrade" if delta > 0 else "recover",
            "ts": self.clock(),
            "level": self.level,
            "level_name": self.level_name,
            "reason": reason,
            "signals": dict(sig),
        }
        self.events.append(ev)
        if self.event_sink is not None:
            self.event_sink(ev)
        return ev

    def _apply(self) -> None:
        p = self.policy
        shed = set(p.shed_classes) if self.level >= 3 else set()
        for rid in self.router.replica_ids():
            eng = getattr(self.router.replica(rid), "engine", None)
            if eng is None:
                continue
            eng._degrade_no_spec = self.level >= 1
            eng._degrade_window_cap = p.window_cap if self.level >= 2 \
                else None
            eng.queue.shed_classes = shed
