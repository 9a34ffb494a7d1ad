"""NetRouter: the fleet router running over real processes.

Subclasses ``fleet.router.Router`` and overrides exactly three things —
everything else (policies, circuit breaker, backlog retry with jittered
backoff, QoS, brownout, evacuation, the phase ledger) runs unchanged
over :class:`~.client.RemoteReplica` objects, because they wear the
EngineReplica duck type:

- :meth:`step` first tends reconnections (a supervisor-restarted child
  re-binds its socket; a rate-limited ``try_connect`` readmits it) and
  polls the supervisor so hang-vs-crash classification and bounded
  restart happen on the fleet tick cadence;
- :meth:`_hand_off` moves the KV artifact as BYTES over the sockets
  (prefill export → decode import, no store round-trip — the wire IS
  the store here, and the npz member CRC still rejects corruption);
- :meth:`run_until_drained` replaces the base class's zero-progress
  wedge test with a WALL-CLOCK idle timeout: remote replicas compute
  between router ticks, so a tick that observed no tokens is normal,
  not a wedge. Only a continuous stretch of no progress, no placeable
  backlog, and no reconnectable replica counts as wedged.

A copy of the JAX package's ``net/router.py`` (it imports nothing of
JAX).
"""

from __future__ import annotations

import time
from typing import Optional

from .client import RemoteReplica
from ..fleet.replica import ReplicaCrashed, ReplicaState
from ..fleet.router import Router
from ..serve.handoff import HandoffCorruptError
from ..serve.queue import DeadlineExceededError, OverloadError


class NetRouter(Router):
    """Router over socket-backed replicas (plus an optional supervisor
    whose ``poll()`` is driven from the fleet tick)."""

    def __init__(self, replicas, supervisor=None, sleep=time.sleep,
                 idle_probe_interval_s: float = 1.0, **kwargs):
        super().__init__(replicas, **kwargs)
        self.supervisor = supervisor
        self._sleep = sleep
        self.reconnects = 0
        self.idle_probe_interval_s = idle_probe_interval_s
        self._last_probe: dict = {}

    # -- stepping ------------------------------------------------------------

    def step(self) -> int:
        if self.supervisor is not None:
            # Reap/classify/restart dead children first, so a replica
            # the supervisor just restarted can be readmitted (and
            # receive backlog) within this same tick.
            self.supervisor.poll()
        self._tend_reconnections()
        return super().step()

    def _tend_reconnections(self) -> None:
        now = time.monotonic()
        for r in self._replicas.values():
            if not isinstance(r, RemoteReplica):
                continue
            if r.state is ReplicaState.HEALTHY and not r.busy:
                # Idle liveness probe. A busy replica's own RPC traffic
                # detects a dead child immediately, but the base router
                # never steps an idle replica — so a child that dies
                # (and is restarted on a fresh socket) behind an idle
                # connection would stay stale-HEALTHY forever, invisible
                # until the next placement lands on it. health() does a
                # live RPC whose failure flips the client state machine
                # to DOWN, which is exactly the trigger tending needs;
                # rate-limited so the probe doesn't turn the hot drain
                # loop into a health storm.
                if now - self._last_probe.get(r.id, 0.0) \
                        >= self.idle_probe_interval_s:
                    self._last_probe[r.id] = now
                    r.health()
            if r.state is ReplicaState.DOWN:
                # Reconnecting CLEARS the client's mirror table, so
                # settle the books first: requests that FINISHED on the
                # replica before it died keep pointing at their mirror
                # (evacuation deliberately skips them) — detach their
                # results now or they become unreadable. And a crash
                # first observed inside a swallowing path (health()
                # answers from cache so stats() always works) never
                # reached _mark_down — evacuate stragglers before
                # their mirrors vanish too. _mark_down is a no-op when
                # the evacuation already ran.
                self._absorb_finished(r)
                self._mark_down(r)
                if r.try_connect():
                    self.reconnects += 1

    def _absorb_finished(self, r: RemoteReplica) -> None:
        for lr in self._requests.values():
            if lr.replica_id != r.id or lr.replica_rid is None \
                    or lr.rid in self._detached:
                continue
            try:
                req = r.poll(lr.replica_rid)
            except (KeyError, ReplicaCrashed):
                continue
            if req is None or not req.finished:
                continue
            self._finalize(lr, req)
            out = req.to_dict()
            out["id"] = lr.rid
            out["replica"] = lr.replica_id
            self._detached[lr.rid] = out

    # -- disaggregated handoff: bytes over sockets ---------------------------

    def _hand_off(self, lr, rep) -> int:
        """One prefill→decode hop across the process boundary: export
        the parked stream's packed KV bytes from the prefill server,
        import them on the best decode server. Same bookkeeping as the
        in-process hop (handoffs, bytes, latencies, phase_prefix
        snapshot BEFORE release); the store round-trip is gone because
        the bytes already crossed a real wire."""
        t0 = self._clock()
        old_rid = lr.replica_rid
        try:
            prefill_req = rep.poll(old_rid)
            data = rep.export_handoff_bytes(old_rid)
        except ReplicaCrashed:
            self._mark_down(rep)
            return 0
        except (TimeoutError, KeyError):
            self.handoff_deferred += 1
            return 0
        if self._fault_plan is not None:
            for spec in self._fault_plan.consult("handoff.export", lr.rid):
                if spec.kind == "corrupt":
                    # Bit-flip mid-wire: the decode side's npz CRC
                    # rejects it — detect-and-reject, stream stays
                    # parked, re-exported next tick.
                    raw = bytearray(data)
                    raw[len(raw) // 2] ^= 0xFF
                    data = bytes(raw)
                elif spec.kind == "drop":
                    self.handoff_lost_rejects += 1
                    return 0
                else:
                    self.handoff_deferred += 1
                    return 0
        nbytes = len(data)
        candidates = [r for r in self._routable()
                      if getattr(r, "phase", "both") in ("decode", "both")]
        ordered = self.policy.order_for(
            [(r.id, r.health()) for r in candidates],
            self._affinity_for(lr))
        for rep_id in ordered:
            d = self._replicas[rep_id]
            lr.attempts += 1
            new_rid = f"{lr.rid}#a{lr.attempts}"
            qos_kwargs = {k: lr.spec[k] for k in ("tenant", "qos_class")
                          if lr.spec.get(k) is not None}
            if self._fault_plan is not None and any(
                    self._fault_plan.consult("handoff.import", rep_id)):
                self.handoff_deferred += 1
                continue
            try:
                d.import_handoff_bytes(data, request_id=new_rid,
                                       trace_id=lr.rid, **qos_kwargs)
            except HandoffCorruptError:
                self.handoff_corrupt_rejects += 1
                return 0
            except DeadlineExceededError:
                self.deadline_rejects += 1
                return 0
            except (OverloadError, TimeoutError):
                continue
            except ReplicaCrashed:
                self._mark_down(d)
                continue
            t_sub, t_adm = (prefill_req.submitted_at,
                            prefill_req.admitted_at)
            lr.phase_prefix = {
                "queue_wait_s": max(t_adm - t_sub, 0.0)
                if t_adm is not None else None,
                "prefill_s": prefill_req.prefill_s,
            }
            try:
                rep.release_handoff(old_rid)
            except ReplicaCrashed:
                self._mark_down(rep)
            except TimeoutError:
                pass
            lr.replica_id = rep_id
            lr.replica_rid = new_rid
            lr.hops.append(rep_id)
            dt = max(self._clock() - t0, 0.0)
            lr.handoff_s = (lr.handoff_s or 0.0) + dt
            lr.handoff_bytes = nbytes
            self.handoffs += 1
            self.handoff_bytes_total += nbytes
            self.handoff_latencies.append(dt)
            self.policy.note_routed(rep_id)
            self.routed[rep_id] = self.routed.get(rep_id, 0) + 1
            return 1
        return 0

    # -- draining ------------------------------------------------------------

    def run_until_drained(self, max_steps: int = 1_000_000,
                          idle_timeout_s: float = 30.0,
                          poll=None) -> int:
        """Step until every logical request is terminal. The wedge test
        is wall-clock: remote replicas decode between ticks, so only
        ``idle_timeout_s`` continuous seconds with zero observed
        progress AND nothing placeable AND nothing reconnecting counts
        as wedged. ``poll`` (optional) runs every tick — the bench
        threads burst submission through it."""
        steps = 0
        idle_since: Optional[float] = None
        while self.pending() and steps < max_steps:
            if poll is not None:
                poll()
            progress = self.step()
            steps += 1
            if progress > 0 or self._backlog_can_move():
                # A supervisor restart produces no progress for a few
                # seconds, then readmission + re-placed backlog resets
                # the timer — idle_timeout_s just has to outlast one
                # restart, NOT be immune to a permanently dead child.
                idle_since = None
                continue
            now = self._clock()
            if idle_since is None:
                idle_since = now
            elif now - idle_since >= idle_timeout_s:
                break
            # Zero observed progress: the children are computing. Yield
            # the core instead of spinning the RPC pump hot.
            self._sleep(0.002)
        leftover = self.pending()
        if leftover:
            self.dropped_requests += len(leftover)
        return steps

    def close(self) -> None:
        for r in self._replicas.values():
            if isinstance(r, RemoteReplica):
                r.close()
