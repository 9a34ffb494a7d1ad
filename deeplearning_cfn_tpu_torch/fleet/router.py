"""In-process request router over N engine replicas.

The fleet's control plane: clients submit **logical requests** to the
router; the router places each on one replica chosen by a pluggable
policy, watches replica health, and guarantees the fleet-level contract
the single engine cannot — **no request is ever dropped**:

- *Overload*: when every routable replica rejects a submit, the router
  raises :class:`FleetOverloadError` — a subclass of the engine's own
  ``OverloadError`` carrying the **max** ``retry_after_s`` across the
  replicas' hints (the most pessimistic replica bounds when retrying is
  worth it), so existing backpressure loops (`except OverloadError`)
  work unchanged one level up. Shedding propagates a number upstream; it
  never silently drops.
- *Crash*: a replica that dies mid-decode (:class:`ReplicaCrashed`) is
  marked DOWN and every unfinished logical request it held is resubmitted
  to a surviving replica. Greedy decode is deterministic, so the re-run
  emits token-identical output — the fleet's aggregate answer matches a
  single-engine run over the same trace even across a mid-stream kill.
- *Circuit breaking*: ``breaker_threshold`` consecutive step failures on
  one replica open its breaker (state BROKEN): it stops being routed and
  stepped, its in-flight work is cancelled locally and resubmitted
  elsewhere. :meth:`readmit` (after an operator or rollout health check)
  closes the breaker.

Policies are deterministic by construction — they sort on health
snapshots and break ties by replica id, never wall-clock — so routing
decisions replay identically in tests (the tests/test_fleet.py policy
suite runs them over fake replicas with scripted loads).

A copy of the JAX package's ``fleet/router.py`` (it imports nothing of
JAX) over the port's store, obs, handoff and queue modules.
"""

from __future__ import annotations

import hashlib
import itertools
import time
import zlib
from typing import Dict, List, Optional, Tuple

from ..ckpt.store import RetryPolicy
from ..obs.trace import get_tracer, obs_enabled
from ..serve.handoff import HandoffCorruptError, drop_handoff, \
    load_handoff, save_handoff
from ..serve.queue import DeadlineExceededError, OverloadError
from .replica import EngineReplica, ReplicaCrashed, ReplicaState

#: Backlog retry pacing: deterministic-jitter exponential backoff (the
#: ckpt-store policy, re-scaled to fleet-tick time). Virtual-clock
#: friendly — the router never sleeps, it just skips a backlog entry
#: whose next-retry timestamp has not arrived.
BACKLOG_RETRY = RetryPolicy(max_attempts=0, backoff_s=0.02,
                            backoff_max_s=1.0, jitter=0.1,
                            op_timeout_s=0.0)


class FleetOverloadError(OverloadError):
    """Every routable replica is full. ``retry_after_s`` is the MAX of
    the per-replica hints — retrying sooner than the slowest replica's
    estimate would just bounce off the same walls. ``per_replica`` keeps
    the individual hints for diagnostics."""

    def __init__(self, depth: int, max_depth: int,
                 retry_after_s: Optional[float],
                 per_replica: Optional[Dict[str, Optional[float]]] = None):
        super().__init__(depth, max_depth, retry_after_s=retry_after_s)
        self.per_replica = dict(per_replica or {})


class NoReplicasError(RuntimeError):
    """Zero routable replicas — not an overload (no amount of waiting
    helps until a replica is readmitted or restarted)."""


# -- policies ----------------------------------------------------------------


class RoutingPolicy:
    """Orders routable replicas by preference for one submit. ``order``
    must be a pure function of the candidates' health snapshots (plus
    policy-internal state advanced only by ``note_routed``) — no clocks,
    no randomness — so selection is deterministic and testable."""

    name = "policy"

    def order(self, candidates: List[Tuple[str, Dict]]) -> List[str]:
        """``candidates`` is [(replica_id, health)] in sorted-id order;
        returns replica ids most-preferred first."""
        raise NotImplementedError

    def note_routed(self, replica_id: str) -> None:
        """Called after a submit lands on ``replica_id``."""

    def order_for(self, candidates: List[Tuple[str, Dict]],
                  affinity_key: Optional[str] = None) -> List[str]:
        """Request-aware ordering hook: like :meth:`order` but handed the
        request's cache-affinity key. The base policies ignore it."""
        return self.order(candidates)


class RoundRobinPolicy(RoutingPolicy):
    """Cycle through replica ids in sorted order, resuming after the last
    replica actually routed to. Stable under removal/re-admission: the
    cursor is an id, not an index, so a vanished replica just means the
    rotation starts at the next id above it."""

    name = "round_robin"

    def __init__(self):
        self._last: Optional[str] = None

    def order(self, candidates):
        ids = [rid for rid, _ in candidates]
        if not ids:
            return []
        if self._last is None:
            return ids
        start = 0
        for i, rid in enumerate(ids):
            if rid > self._last:
                start = i
                break
        else:
            start = 0
        return ids[start:] + ids[:start]

    def note_routed(self, replica_id):
        self._last = replica_id


class LeastLoadedPolicy(RoutingPolicy):
    """Prefer the replica with the least outstanding work (queued +
    running), breaking ties by decode-step latency p50 (the slower
    replica clears its backlog later even at equal depth) and finally by
    replica id — the total order that keeps tied loads deterministic."""

    name = "least_loaded"

    def order(self, candidates):
        def load_key(item):
            rid, h = item
            lat = h.get("step_latency_p50_s")
            return (h.get("queue_depth", 0) + h.get("active_requests", 0),
                    lat if lat is not None else 0.0,
                    rid)
        return [rid for rid, _ in sorted(candidates, key=load_key)]


class PrefixAffinityPolicy(RoutingPolicy):
    """Cache-aware placement: a request carrying an affinity key (the
    loadgen prefix-group id in the bench; a first-N-source-token hash
    otherwise) is steered to a preferred replica so per-replica radix
    trees stay hot, falling back to least-loaded order for the rest of
    the candidates (and entirely for keyless requests).

    The preferred replica is chosen by rendezvous (highest-random-weight)
    hashing of ``(key, replica_id)``: every key independently ranks the
    live replica set, so removing a replica (drain, autoscale-down,
    crash) remaps ONLY the keys that preferred it — no thundering
    re-hash of every group's placement, unlike modulo hashing. blake2b
    keeps the weights deterministic across processes and runs (the
    policy-determinism contract; ``hash()`` is salted per process)."""

    name = "prefix_affinity"
    # Keyless requests derive their affinity from this many leading
    # source tokens — "the longest expected prefix" a router can see
    # without protocol help.
    affinity_tokens = 8

    def __init__(self):
        self._fallback = LeastLoadedPolicy()

    @staticmethod
    def _weight(key: str, rid: str) -> int:
        digest = hashlib.blake2b(
            f"{key}\x00{rid}".encode(), digest_size=8).digest()
        return int.from_bytes(digest, "big")

    def order(self, candidates):
        return self._fallback.order(candidates)

    def order_for(self, candidates, affinity_key=None):
        rest = self._fallback.order(candidates)
        if affinity_key is None or not candidates:
            return rest
        key = str(affinity_key)
        preferred = max((rid for rid, _ in candidates),
                        key=lambda rid: (self._weight(key, rid), rid))
        return [preferred] + [rid for rid in rest if rid != preferred]


POLICIES = {
    RoundRobinPolicy.name: RoundRobinPolicy,
    LeastLoadedPolicy.name: LeastLoadedPolicy,
    PrefixAffinityPolicy.name: PrefixAffinityPolicy,
}


# -- the router --------------------------------------------------------------


class _LogicalRequest:
    """Router-side record of one client request: the submit spec (kept
    verbatim so failover can replay it), where it currently lives, and
    how many times it has been placed (the per-replica request id is
    suffixed per attempt so a re-placement can never collide with a
    cancelled copy's id)."""

    def __init__(self, rid: str, spec: Dict):
        self.rid = rid
        self.spec = spec
        self.replica_id: Optional[str] = None
        self.replica_rid: Optional[str] = None
        self.attempts = 0
        # Absolute deadline on the ROUTER clock (submitted_ts +
        # deadline_s). The honest-cancellation paths (_retry_backlog,
        # _evacuate) compare against it instead of re-anchoring the
        # relative deadline at every re-placement.
        self.deadline_ts: Optional[float] = None
        # -- latency ledger / trace context ---------------------------
        self.submitted_ts: Optional[float] = None   # router clock
        self.lost_at: Optional[float] = None        # evacuated, unplaced
        self.stall_s = 0.0          # time spent with no replica copy
        self.wasted_tokens = 0      # decoded on attempts we abandoned
        self.hops: List[str] = []   # every replica that held a copy
        self.finalized = False
        # -- disaggregated prefill/decode hop -------------------------
        # Set when the router moved this stream from a prefill replica
        # to a decode replica. ``phase_prefix`` preserves the prefill
        # side's queue_wait/prefill split (the decode-side Request was
        # born admitted, so its own timestamps can't reconstruct them).
        self.phase_prefix: Optional[Dict] = None
        self.handoff_s: Optional[float] = None
        self.handoff_bytes: Optional[int] = None


class Router:
    """Routes logical requests across :class:`EngineReplica`s.

    Drive it like an engine: ``submit`` (may raise
    :class:`FleetOverloadError`), ``step`` (steps every steppable
    replica once, handles failures), ``poll``/``results``,
    ``run_until_drained``. Rollouts use ``drain``/``readmit``;
    membership changes use ``add``/``remove``.
    """

    def __init__(self, replicas: List[EngineReplica],
                 policy="least_loaded", breaker_threshold: int = 3,
                 clock=time.monotonic, handoff_store=None,
                 fault_plan=None,
                 backlog_retry: Optional[RetryPolicy] = BACKLOG_RETRY):
        if breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {breaker_threshold}")
        self._replicas: Dict[str, EngineReplica] = {}
        for r in replicas:
            if r.id in self._replicas:
                raise ValueError(f"duplicate replica id {r.id!r}")
            self._replicas[r.id] = r
        self.policy = POLICIES[policy]() if isinstance(policy, str) \
            else policy
        self.breaker_threshold = breaker_threshold
        self._failures: Dict[str, int] = {}
        self._requests: Dict[str, _LogicalRequest] = {}
        self._backlog: List[str] = []   # placed nowhere, awaiting capacity
        self._auto_id = itertools.count()
        self.routed: Dict[str, int] = {r.id: 0 for r in replicas}
        self.evacuations = 0
        # Router-level fault surface (runtime/faults.py): consulted at
        # the fleet sites the replicas cannot see — ``handoff.export``
        # / ``handoff.import`` (artifact corruption, loss, deferral)
        # and ``router.cancel`` (cancellation deferral).
        self._fault_plan = fault_plan
        # Backlog retry pacing (None = retry every tick, the legacy
        # hot-spin). rid → (retries so far, earliest next retry ts).
        self._backlog_retry = backlog_retry
        self._backlog_retry_state: Dict[str, Tuple[int, float]] = {}
        self.backlog_retries = 0
        # Hang-vs-crash classification: a step that raises TimeoutError
        # (the watchdog class, or an injected hang) is counted here per
        # replica — it still feeds the consecutive-failure breaker, but
        # operators see hangs apart from crashes.
        self.replica_hangs: Dict[str, int] = {}
        # Handoff fault bookkeeping: artifacts the importer REJECTED
        # (corrupt vs lost — the exporter stays parked, the hop
        # retries) and hops deferred by injected export/import faults.
        self.handoff_corrupt_rejects = 0
        self.handoff_lost_rejects = 0
        self.handoff_deferred = 0
        # Deadline honesty: logical requests cancelled terminal-EXPIRED
        # by the router itself (expired in the backlog or at
        # evacuation) and handoff imports refused for expiry.
        self.deadline_cancelled = 0
        self.deadline_rejects = 0
        # Brownout controller (fleet/degrade.py) — attached by the
        # bench/operator; step() ticks it, _place() folds its recovery
        # horizon into overload hints.
        self.degrade = None
        # The fleet contract counter: logical requests lost with no
        # terminal state and no path to one. Stays 0 — the bench record
        # and the chaos tests assert it.
        self.dropped_requests = 0
        self._clock = clock
        # Fleet-level trace shard: when set (a sink from obs/sinks.py),
        # the router writes one retroactive ``fleet.request`` span per
        # finished logical request into it. All in-process engines share
        # ``time.monotonic``, so router spans and replica spans land on
        # one comparable timeline.
        self.trace_sink = None
        # Goodput accounting. goodput = tokens in DONE logical results;
        # wasted = tokens decoded on attempts the router abandoned
        # (evacuation re-decode). Per-request phase breakdowns live in
        # ``ledger`` (rid → dict), written when a request is first
        # OBSERVED finished.
        self.goodput_tokens = 0
        self.wasted_tokens = 0
        self.ledger: Dict[str, Dict] = {}
        # Disaggregated serving: transport for KV-handoff artifacts
        # (lazily a MemoryObjectStore — in-process fleets hand blocks
        # over through memory; cross-host fleets pass a PosixStore).
        self._handoff_store = handoff_store
        self.handoffs = 0
        self.handoff_bytes_total = 0
        self.handoff_latencies: List[float] = []
        # Results snapshotted off replicas that left the fleet (see
        # _detach_finished): rid → result dict. Without this, a
        # scale-down that removes a replica holding finished-but-unread
        # results would strand them — poll() would KeyError on the
        # vanished replica.
        self._detached: Dict[str, Dict] = {}

    @property
    def handoff_store(self):
        if self._handoff_store is None:
            from ..ckpt.store import MemoryObjectStore
            self._handoff_store = MemoryObjectStore()
        return self._handoff_store

    @property
    def disaggregated(self) -> bool:
        """True when any replica is phase-restricted — placement then
        targets prefill replicas and finished prefills hop to decode
        replicas each tick."""
        return any(getattr(r, "phase", "both") != "both"
                   for r in self._replicas.values())

    # -- membership ---------------------------------------------------------

    def replica_ids(self) -> List[str]:
        return sorted(self._replicas)

    def replica(self, replica_id: str) -> EngineReplica:
        return self._replicas[replica_id]

    def add(self, replica: EngineReplica) -> None:
        if replica.id in self._replicas:
            raise ValueError(f"duplicate replica id {replica.id!r}")
        self._replicas[replica.id] = replica
        self.routed.setdefault(replica.id, 0)

    def remove(self, replica_id: str) -> None:
        """Take a replica out of the fleet: snapshot its finished
        results (they stay readable through ``result``/``finished``
        after the replica is gone), then evacuate its in-flight work to
        the survivors."""
        r = self._replicas[replica_id]
        self._detach_finished(replica_id)
        # Take the leaver out of the routable set WHILE evacuating:
        # _place reads membership live, and a still-HEALTHY leaver with
        # a freshly-cancelled (empty) queue is exactly where
        # least-loaded would put the evacuated copy right back. The
        # prior state is restored afterwards so re-adding the same
        # handle later (readmission) works unchanged.
        prior = r.state
        if not r.crashed:
            r.state = ReplicaState.DRAINING
        try:
            self._evacuate(replica_id, cancel_on_replica=not r.crashed)
        finally:
            r.state = prior
        del self._replicas[replica_id]
        self._failures.pop(replica_id, None)

    def _detach_finished(self, rep_id: str) -> None:
        """Snapshot every finished-but-still-resident result on
        ``rep_id`` into the detached cache. Scale-down removes replicas
        with completed, unread results as a matter of course — the
        results must outlive the replica."""
        r = self._replicas[rep_id]
        for lr in list(self._requests.values()):
            if lr.replica_id != rep_id or lr.replica_rid is None:
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
            out["replica"] = rep_id
            self._detached[lr.rid] = out
            lr.replica_id = None
            lr.replica_rid = None

    def _routable(self) -> List[EngineReplica]:
        return [self._replicas[rid] for rid in self.replica_ids()
                if self._replicas[rid].routable]

    # -- submission / placement ---------------------------------------------

    def submit(self, src_ids, max_new_tokens: Optional[int] = None,
               beam_size: int = 1, deadline_s: Optional[float] = None,
               request_id: Optional[str] = None,
               tenant: Optional[str] = None,
               qos_class: Optional[str] = None,
               affinity_key: Optional[str] = None) -> str:
        """Place one logical request; returns its id. Raises
        :class:`FleetOverloadError` when every routable replica rejects
        it (the request is NOT retained — the caller owns the retry),
        :class:`NoReplicasError` when nothing is routable at all.
        ``tenant``/``qos_class`` ride in the replayed spec, so failover
        and the prefill→decode hop preserve the request's QoS identity.
        ``affinity_key`` names the request's expected shared prefix
        (loadgen prefix-group id) for cache-aware policies; it stays
        router-side — replicas never see it."""
        rid = request_id if request_id is not None \
            else f"fleet-{next(self._auto_id)}"
        if rid in self._requests:
            raise ValueError(f"duplicate request id {rid!r}")
        lr = _LogicalRequest(rid, dict(
            src_ids=list(src_ids), max_new_tokens=max_new_tokens,
            beam_size=beam_size, deadline_s=deadline_s,
            tenant=tenant, qos_class=qos_class,
            affinity_key=affinity_key))
        lr.submitted_ts = self._clock()
        if deadline_s is not None:
            lr.deadline_ts = lr.submitted_ts + float(deadline_s)
        self._requests[rid] = lr
        try:
            self._place(lr)
        except (FleetOverloadError, NoReplicasError, ValueError):
            del self._requests[rid]
            raise
        return rid

    def _affinity_for(self, lr: _LogicalRequest) -> Optional[str]:
        """The request's cache-affinity key: the caller-provided one
        (loadgen prefix-group id) when present, else — for policies that
        want one — a hash key over the leading source tokens, the
        longest shared prefix the router can infer on its own."""
        key = lr.spec.get("affinity_key")
        if key is not None:
            return str(key)
        n = int(getattr(self.policy, "affinity_tokens", 0) or 0)
        if n <= 0:
            return None
        return "tok:" + ",".join(
            str(int(t)) for t in lr.spec["src_ids"][:n])

    def _place(self, lr: _LogicalRequest) -> None:
        candidates = self._routable()
        if self.disaggregated:
            # New work always enters through prefill; decode-only
            # replicas receive streams via KV handoff, never submits.
            candidates = [r for r in candidates
                          if getattr(r, "phase", "both")
                          in ("both", "prefill")]
        if not candidates:
            raise NoReplicasError(
                "no routable replicas (all down, broken, or draining)")
        ordered = self.policy.order_for(
            [(r.id, r.health()) for r in candidates],
            self._affinity_for(lr))
        hints: Dict[str, Optional[float]] = {}
        depth = sum(r.engine.queue.depth for r in candidates)
        max_depth = sum(r.engine.queue.max_depth for r in candidates)
        for rep_id in ordered:
            r = self._replicas[rep_id]
            lr.attempts += 1
            replica_rid = f"{lr.rid}#a{lr.attempts}"
            # QoS identity is forwarded only when tagged, so pre-QoS
            # replica fakes (and single-tenant traffic) see the exact
            # historical call shape.
            qos_kwargs = {k: lr.spec[k] for k in ("tenant", "qos_class")
                          if lr.spec.get(k) is not None}
            # Deadline honesty across re-placements: hand the replica
            # the REMAINING budget against the original submit, not the
            # verbatim relative deadline (which would re-anchor — a
            # request evacuated twice would outlive its promise).
            deadline_s = lr.spec["deadline_s"]
            if lr.deadline_ts is not None:
                deadline_s = max(lr.deadline_ts - self._clock(), 0.0)
            try:
                r.submit(lr.spec["src_ids"],
                         max_new_tokens=lr.spec["max_new_tokens"],
                         beam_size=lr.spec["beam_size"],
                         deadline_s=deadline_s,
                         request_id=replica_rid,
                         trace_id=lr.rid, **qos_kwargs)
            except OverloadError as e:
                hints[rep_id] = e.retry_after_s
                continue
            except TimeoutError:
                # Injected (or real) submit hang: the replica did not
                # take the request — try the next candidate.
                self.replica_hangs[rep_id] = \
                    self.replica_hangs.get(rep_id, 0) + 1
                continue
            except OSError:
                # Transient submit fault (InjectedTransientError et
                # al.): the submit never landed — next candidate.
                continue
            except ReplicaCrashed:
                # Found it dead at submit time — handle like a step-time
                # crash, keep trying the rest.
                self._mark_down(r)
                continue
            lr.replica_id = rep_id
            lr.replica_rid = replica_rid
            lr.hops.append(rep_id)
            if lr.lost_at is not None:
                # Re-placed after an evacuation: the gap with no live
                # copy is stall time in the request's phase ledger.
                lr.stall_s += max(self._clock() - lr.lost_at, 0.0)
                lr.lost_at = None
            self.policy.note_routed(rep_id)
            self.routed[rep_id] = self.routed.get(rep_id, 0) + 1
            return
        retry_after = max((h for h in hints.values() if h is not None),
                          default=None)
        if self.degrade is not None and self.degrade.level > 0:
            # Brownout-honest hint: while degraded, per-replica hints
            # only measure queue drain — add the degradation level's
            # expected recovery horizon so clients back off long enough
            # for the fleet to actually step back up.
            retry_after = (retry_after or 0.0) \
                + self.degrade.recovery_horizon_s()
        raise FleetOverloadError(depth, max_depth, retry_after,
                                 per_replica=hints)

    # -- stepping / failure handling ----------------------------------------

    def step(self) -> int:
        """One fleet tick: tick the brownout controller, retry the
        backlog, step every steppable replica, absorb failures (crash →
        evacuate; hang → classified, counted; consecutive errors →
        breaker). Returns total decode steps run."""
        if self.degrade is not None:
            self.degrade.tick()
        self._retry_backlog()
        total = 0
        for rep_id in self.replica_ids():
            r = self._replicas[rep_id]
            if not r.steppable or not r.busy:
                continue
            try:
                total += r.step()
                self._failures[rep_id] = 0
            except ReplicaCrashed:
                self._mark_down(r)
            except TimeoutError:
                # Classified hang (injected or a real watchdog timeout):
                # counted apart from crashes so the operator surface can
                # tell "stuck" from "dead", but it feeds the same
                # consecutive-failure breaker — a replica that hangs
                # every tick is as useless as one that crashes.
                self.replica_hangs[rep_id] = \
                    self.replica_hangs.get(rep_id, 0) + 1
                n = self._failures.get(rep_id, 0) + 1
                self._failures[rep_id] = n
                if n >= self.breaker_threshold:
                    self._open_breaker(r)
            except Exception:
                n = self._failures.get(rep_id, 0) + 1
                self._failures[rep_id] = n
                if n >= self.breaker_threshold:
                    self._open_breaker(r)
        # Handoffs count as progress: a tick that only moved parked
        # streams to decode replicas must not read as "wedged" to
        # run_until_drained — the moved streams decode next tick.
        total += self._process_handoffs()
        return total

    def _retry_backlog(self) -> None:
        now = self._clock()
        still: List[str] = []
        for rid in self._backlog:
            lr = self._requests[rid]
            if self._deadline_expired(lr, now):
                # Deadline honesty: an expired backlog entry is
                # CANCELLED terminal-expired, never re-placed — placing
                # it would decode tokens nobody can use.
                if self._cancel_faulted(rid):
                    still.append(rid)   # cancel deferred; retried next tick
                else:
                    self._detach_terminal(lr, now, "expired")
                    self._backlog_retry_state.pop(rid, None)
                continue
            st = self._backlog_retry_state.get(rid)
            if st is not None and now < st[1]:
                still.append(rid)       # backing off — not due yet
                continue
            try:
                self._place(lr)
                self._backlog_retry_state.pop(rid, None)
            except (FleetOverloadError, NoReplicasError):
                retries = (st[0] if st is not None else 0) + 1
                self.backlog_retries += 1
                delay = 0.0 if self._backlog_retry is None else \
                    self._backlog_retry.backoff(
                        retries - 1, salt=zlib.crc32(rid.encode("utf-8")))
                self._backlog_retry_state[rid] = (retries, now + delay)
                still.append(rid)
        self._backlog = still

    def _deadline_expired(self, lr: _LogicalRequest, now: float) -> bool:
        return lr.deadline_ts is not None and now >= lr.deadline_ts

    # -- disaggregated prefill → decode handoff -----------------------------

    def _process_handoffs(self) -> int:
        """Move every stream parked on a prefill replica to a decode
        replica. Returns the number of hops completed this tick. A
        stream that finds no decode capacity stays parked (its KV blocks
        remain live on the prefill side) and is retried next tick —
        parked work is never dropped, mirroring the backlog contract."""
        if not self.disaggregated:
            return 0
        hops = 0
        for lr in list(self._requests.values()):
            if lr.replica_id is None or lr.replica_rid is None:
                continue
            rep = self._replicas.get(lr.replica_id)
            if rep is None or getattr(rep, "phase", "both") != "prefill":
                continue
            try:
                if not rep.handoff_ready(lr.replica_rid):
                    continue
            except ReplicaCrashed:
                self._mark_down(rep)
                continue
            hops += self._hand_off(lr, rep)
        return hops

    def _hand_off(self, lr: _LogicalRequest, rep: EngineReplica) -> int:
        """One prefill→decode hop: export the parked stream's KV blocks
        through the store codec, import on the best decode replica,
        release the prefill side. Returns 1 on success, 0 when no decode
        replica had capacity (the stream stays parked)."""
        t0 = self._clock()
        old_rid = lr.replica_rid
        try:
            prefill_req = rep.poll(old_rid)
            artifact = rep.export_handoff(old_rid)
        except ReplicaCrashed:
            self._mark_down(rep)
            return 0
        # Round-trip through the store codec even for in-memory fleets:
        # the decode side imports what crossed the wire, so codec bugs
        # fail parity tests instead of hiding behind an object share.
        store = self.handoff_store
        key = f"handoff/{lr.rid}-a{lr.attempts}"
        corrupt = lost = False
        if self._fault_plan is not None:
            for spec in self._fault_plan.consult("handoff.export", lr.rid):
                if spec.kind == "corrupt":
                    corrupt = True
                elif spec.kind == "drop":
                    lost = True
                else:
                    # transient/hang/fatal export fault: the hop never
                    # starts this tick — the stream stays parked on the
                    # prefill side and retries next tick.
                    self.handoff_deferred += 1
                    return 0
        nbytes = save_handoff(store, key, artifact)
        if corrupt:
            # Codec-level bit flip in the stored object: the npz
            # container's member CRC makes the importer REJECT it.
            raw = bytearray(store.get_bytes(key))
            raw[len(raw) // 2] ^= 0xFF
            store.put_bytes(key, bytes(raw))
        if lost:
            # The artifact vanishes between export and import (a torn
            # transport, an eager GC) — loss, not corruption.
            drop_handoff(store, key)
        try:
            loaded = load_handoff(store, key)
        except HandoffCorruptError:
            # Detect-and-reject: never import bytes that fail the codec
            # or structural validation. The exporter still holds the
            # parked stream — the hop re-exports a fresh artifact next
            # tick, so corruption costs latency, never tokens.
            self.handoff_corrupt_rejects += 1
            drop_handoff(store, key)
            return 0
        except FileNotFoundError:
            self.handoff_lost_rejects += 1
            return 0
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
                # Injected import fault on this candidate: skip it this
                # hop (same recovery as an OverloadError — another
                # candidate, or stay parked and retry next tick).
                self.handoff_deferred += 1
                continue
            try:
                d.import_handoff(loaded, request_id=new_rid,
                                 trace_id=lr.rid, **qos_kwargs)
            except DeadlineExceededError:
                # The stream outlived its deadline while parked: honest
                # refusal. Drop the artifact and leave the prefill-side
                # copy alone — its engine's reaper expires it, which
                # finalizes the logical request as EXPIRED with the
                # prefill-decoded token ledgered as deadline waste.
                drop_handoff(store, key)
                self.deadline_rejects += 1
                return 0
            except OverloadError:
                continue
            except ReplicaCrashed:
                self._mark_down(d)
                continue
            # Preserve the prefill side's phase split before releasing
            # it — the decode-side Request is born admitted, so its own
            # timestamps say queue_wait=0, prefill=None.
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
            drop_handoff(store, key)
            return 1
        drop_handoff(store, key)
        return 0

    def _mark_down(self, r: EngineReplica) -> None:
        r.state = ReplicaState.DOWN
        self._failures[r.id] = 0
        # Dead process: nothing to cancel over there, just re-place.
        self._evacuate(r.id, cancel_on_replica=False)

    def _open_breaker(self, r: EngineReplica) -> None:
        r.state = ReplicaState.BROKEN
        # The replica is alive but untrusted: cancel its copies so its
        # rows free up if it is ever stepped again, then re-place.
        self._evacuate(r.id, cancel_on_replica=True)

    def _evacuate(self, rep_id: str, cancel_on_replica: bool) -> None:
        """Move every unfinished logical request off ``rep_id``. Requests
        are re-placed immediately where capacity exists; the rest wait in
        the backlog, retried every tick — never dropped."""
        r = self._replicas[rep_id]
        for lr in list(self._requests.values()):
            if lr.replica_id != rep_id:
                continue
            req = None
            if lr.replica_rid is not None:
                try:
                    req = r.poll(lr.replica_rid)
                except (KeyError, ReplicaCrashed):
                    req = None
            if req is not None and req.finished:
                continue   # completed before the failure — keep it
            if cancel_on_replica and lr.replica_rid is not None:
                try:
                    r.cancel(lr.replica_rid)
                except (KeyError, ReplicaCrashed):
                    pass
            now = self._clock()
            if req is not None:
                # Tokens the abandoned attempt already decoded are waste:
                # the re-placed copy decodes them again elsewhere.
                n = len(getattr(req, "tokens", ()) or ())
                lr.wasted_tokens += n
                self.wasted_tokens += n
                recorder = getattr(r, "record_evacuation", None)
                if recorder is not None:
                    recorder(req, now)
            lr.replica_id = None
            lr.replica_rid = None
            lr.lost_at = now
            self.evacuations += 1
            if self._deadline_expired(lr, now):
                # Deadline honesty at evacuation: the copy we just
                # abandoned was this request's last chance — re-placing
                # it would burn decode on an already-broken promise.
                if self._cancel_faulted(lr.rid):
                    self._backlog.append(lr.rid)  # cancel deferred
                else:
                    self._detach_terminal(lr, now, "expired")
                continue
            try:
                self._place(lr)
            except (FleetOverloadError, NoReplicasError):
                self._backlog.append(lr.rid)

    # -- cancellation / deadline honesty ------------------------------------

    def _cancel_faulted(self, rid: str) -> bool:
        """Consult the ``router.cancel`` fault site; True = the
        cancellation is deferred this tick (retried next)."""
        if self._fault_plan is None:
            return False
        deferred = False
        for spec in self._fault_plan.consult("router.cancel", rid):
            if spec.kind != "latency":
                deferred = True
        return deferred

    def _detach_terminal(self, lr: _LogicalRequest, now: float,
                         state: str) -> None:
        """Finalize an UNPLACED logical request in a terminal state the
        fleet decided on its own (expired backlog entry, router-side
        cancel). The result lands in the detached cache — ``finished``
        / ``result`` / the ledger all see a terminal record, so the
        request is resolved, not dropped."""
        if lr.lost_at is not None:
            lr.stall_s += max(now - lr.lost_at, 0.0)
            lr.lost_at = None
        lr.finalized = True
        if state == "expired":
            self.deadline_cancelled += 1
        self._detached[lr.rid] = {"id": lr.rid, "state": state,
                                  "tokens": [], "replica": None}
        e2e = max(now - lr.submitted_ts, 0.0) \
            if lr.submitted_ts is not None else None
        entry = {
            "request_id": lr.rid, "state": state,
            "attempts": lr.attempts, "replicas": list(lr.hops),
            "goodput_tokens": 0, "wasted_tokens": lr.wasted_tokens,
            "e2e_s": e2e,
            "phases": {"queue_wait_s": None, "prefill_s": None,
                       "decode_s": None, "stall_s": lr.stall_s,
                       "emit_s": None},
        }
        if lr.spec.get("tenant") is not None \
                or lr.spec.get("qos_class") is not None:
            entry["tenant"] = lr.spec.get("tenant")
            entry["qos_class"] = lr.spec.get("qos_class") or "standard"
            entry["preemptions"] = 0
        self.ledger[lr.rid] = entry
        self._emit_request_span(lr, entry)

    def cancel(self, rid: str) -> bool:
        """Cancel a logical request fleet-wide. A placed request is
        cancelled on its replica (it reaches terminal CANCELLED through
        the normal poll path); a backlogged one is finalized directly.
        Returns True when the cancellation took effect, False when it
        was deferred by an injected ``router.cancel`` fault or the
        request is already finished/unknown."""
        lr = self._requests.get(rid)
        if lr is None or lr.finalized or rid in self._detached:
            return False
        if self._cancel_faulted(rid):
            return False
        if lr.replica_id is not None and lr.replica_rid is not None:
            try:
                self._replicas[lr.replica_id].cancel(lr.replica_rid)
            except (KeyError, ReplicaCrashed):
                pass
            return True
        if rid in self._backlog:
            self._backlog.remove(rid)
        self._backlog_retry_state.pop(rid, None)
        self._detach_terminal(lr, self._clock(), "cancelled")
        return True

    # -- rollout surface ----------------------------------------------------

    def drain(self, replica_id: str) -> None:
        """Stop routing NEW work to a replica; in-flight requests keep
        decoding (DRAINING replicas are still stepped)."""
        r = self._replicas[replica_id]
        if r.state is ReplicaState.HEALTHY:
            r.state = ReplicaState.DRAINING

    def readmit(self, replica_id: str) -> None:
        """Close the breaker / end the drain: the replica is routable
        again with a clean failure count."""
        r = self._replicas[replica_id]
        if r.crashed:
            raise ReplicaCrashed(
                f"replica {replica_id} is dead — restart it, don't "
                f"readmit it")
        r.state = ReplicaState.HEALTHY
        self._failures[replica_id] = 0

    def evacuate(self, replica_id: str) -> None:
        """Forcibly move a replica's unfinished work elsewhere (the
        rollout's drain-deadline escape hatch)."""
        r = self._replicas[replica_id]
        self._evacuate(replica_id, cancel_on_replica=not r.crashed)

    # -- results ------------------------------------------------------------

    def poll(self, rid: str):
        """The live Request object for a logical request (from whichever
        replica currently owns it); None while it waits in the backlog."""
        lr = self._requests[rid]
        if lr.replica_id is None or lr.replica_rid is None:
            return None
        return self._replicas[lr.replica_id].poll(lr.replica_rid)

    def finished(self, rid: str) -> bool:
        if rid in self._detached:
            return True
        req = self.poll(rid)
        done = req is not None and req.finished
        if done:
            self._finalize(self._requests[rid], req)
        return done

    def pending(self) -> List[str]:
        return [rid for rid in self._requests if not self.finished(rid)]

    def result(self, rid: str) -> Dict:
        if rid in self._detached:
            return dict(self._detached[rid])
        req = self.poll(rid)
        if req is None:
            return {"id": rid, "state": "backlogged", "tokens": []}
        if req.finished:
            self._finalize(self._requests[rid], req)
        out = req.to_dict()
        out["id"] = rid   # logical id, not the per-attempt replica id
        out["replica"] = self._requests[rid].replica_id
        return out

    def _finalize(self, lr: _LogicalRequest, req) -> None:
        """First observation of a terminal state: write the request's
        phase ledger entry, account goodput, emit the fleet.request
        span. Idempotent — every later poll is a no-op."""
        if lr.finalized:
            return
        lr.finalized = True
        now = self._clock()
        state = getattr(getattr(req, "state", None), "value",
                        getattr(req, "state", None))
        tokens = len(getattr(req, "tokens", ()) or ())
        goodput = tokens if state == "done" else 0
        self.goodput_tokens += goodput

        def _ts(name):
            v = getattr(req, name, None)
            return v if isinstance(v, (int, float)) else None

        t_sub, t_adm, t_fin = (_ts("submitted_at"), _ts("admitted_at"),
                               _ts("finished_at"))
        prefill = _ts("prefill_s")
        queue_wait = max(t_adm - t_sub, 0.0) \
            if t_sub is not None and t_adm is not None else None
        decode = max(t_fin - t_adm - (prefill or 0.0), 0.0) \
            if t_adm is not None and t_fin is not None else None
        if lr.phase_prefix is not None:
            # The stream hopped prefill→decode: the terminal Request is
            # the decode-side copy (born admitted, no prefill of its
            # own), so queue_wait/prefill come from the prefill side's
            # snapshot and decode is the decode replica's dwell time.
            queue_wait = lr.phase_prefix.get("queue_wait_s")
            prefill = lr.phase_prefix.get("prefill_s")
        emit = max(now - t_fin, 0.0) if t_fin is not None else None
        e2e = max(now - lr.submitted_ts, 0.0) \
            if lr.submitted_ts is not None else None
        phases = {"queue_wait_s": queue_wait, "prefill_s": prefill,
                  "decode_s": decode, "stall_s": lr.stall_s,
                  "emit_s": emit}
        if lr.handoff_s is not None:
            # Only hopped requests carry the extra phase — co-located
            # ledger entries keep the exact five-phase shape.
            phases["handoff_s"] = lr.handoff_s
        preempted_s = getattr(req, "preempted_s", 0.0) or 0.0
        if preempted_s > 0:
            # Same conditionality as handoff_s: only streams that were
            # actually evicted carry the parked-time phase.
            phases["preempted_s"] = preempted_s
        chunks = getattr(req, "prefill_chunks", 0) or 0
        if chunks > 0:
            # Chunked prefill: how many chunk ticks the source encode
            # took. prefill_s above already sums those ticks, and
            # queue_wait ends at admission — the same tick the first
            # chunk ran — so the phase split stays honest.
            phases["prefill_chunks"] = int(chunks)
        self.ledger[lr.rid] = {
            "request_id": lr.rid, "state": state,
            "attempts": lr.attempts, "replicas": list(lr.hops),
            "goodput_tokens": goodput, "wasted_tokens": lr.wasted_tokens,
            "e2e_s": e2e,
            "phases": phases,
        }
        if lr.spec.get("tenant") is not None \
                or lr.spec.get("qos_class") is not None:
            self.ledger[lr.rid]["tenant"] = lr.spec.get("tenant")
            self.ledger[lr.rid]["qos_class"] = \
                lr.spec.get("qos_class") or "standard"
            self.ledger[lr.rid]["preemptions"] = \
                getattr(req, "preemptions", 0)
        self._emit_request_span(lr, self.ledger[lr.rid])

    def _emit_request_span(self, lr: _LogicalRequest, entry: Dict) -> None:
        """Retroactive ``fleet.request`` span covering submit → observed
        finish, written into the router's own trace shard. Carries the
        trace context plus the phase ledger as attributes, so the merged
        Perfetto timeline shows the logical request above its
        per-replica attempts."""
        if not obs_enabled() or lr.submitted_ts is None:
            return
        tracer = get_tracer()
        if self.trace_sink is not None:
            tracer.add_sink(self.trace_sink)
        try:
            tracer.record_span(
                "fleet.request", lr.submitted_ts, entry["e2e_s"] or 0.0,
                ok=entry["state"] == "done",
                request_id=lr.rid, trace_id=lr.rid,
                state=entry["state"], attempts=lr.attempts,
                replicas=",".join(lr.hops),
                goodput_tokens=entry["goodput_tokens"],
                wasted_tokens=entry["wasted_tokens"],
                stall_s=entry["phases"]["stall_s"])
        finally:
            if self.trace_sink is not None:
                tracer.remove_sink(self.trace_sink)

    def run_until_drained(self, max_steps: int = 1_000_000) -> int:
        """Step until every logical request reaches a terminal state (or
        the step budget runs out — leftover unfinished requests are then
        counted as dropped, the number the zero-drop contract pins at 0).
        Returns fleet ticks taken."""
        steps = 0
        while self.pending() and steps < max_steps:
            before = self.step()
            steps += 1
            if before == 0 and not self._backlog_can_move() \
                    and not self._anything_stepping():
                # Wedged: nothing steppable and nothing placeable. A
                # zero-progress tick with live in-flight work is NOT a
                # wedge — a hanging replica either recovers or trips
                # the consecutive-failure breaker, and either way the
                # work moves on a later tick.
                break
        leftover = self.pending()
        if leftover:
            self.dropped_requests += len(leftover)
        return steps

    def _backlog_can_move(self) -> bool:
        return bool(self._backlog) and bool(self._routable())

    def _anything_stepping(self) -> bool:
        return any(r.steppable and r.busy
                   for r in self._replicas.values())

    def stats(self) -> Dict:
        per = {}
        for rid in self.replica_ids():
            r = self._replicas[rid]
            h = r.health()
            per[rid] = {
                "state": r.state.value,
                "phase": getattr(r, "phase", "both"),
                "routed": self.routed.get(rid, 0),
                "tokens_generated": h["tokens_generated"],
                "queue_depth": h["queue_depth"],
                "active_requests": h["active_requests"],
                "handoff_pending": h.get("handoff_pending", 0),
            }
        return {
            "replicas": per,
            "requests": len(self._requests),
            "backlog": len(self._backlog),
            "evacuations": self.evacuations,
            "dropped_requests": self.dropped_requests,
            "goodput_tokens": self.goodput_tokens,
            "wasted_tokens": self.wasted_tokens,
            "handoffs": self.handoffs,
            "handoff_bytes": self.handoff_bytes_total,
            "router_backlog_retries": self.backlog_retries,
            "replica_hangs": sum(self.replica_hangs.values()),
            "handoff_corrupt_rejects": self.handoff_corrupt_rejects,
            "handoff_lost_rejects": self.handoff_lost_rejects,
            "handoff_deferred": self.handoff_deferred,
            "deadline_cancelled": self.deadline_cancelled,
            "deadline_rejects": self.deadline_rejects,
            "degrade_level":
                self.degrade.level if self.degrade is not None else 0,
        }
