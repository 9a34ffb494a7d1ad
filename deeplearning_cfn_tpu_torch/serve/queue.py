"""Request lifecycle for the serving engine (serve/engine.py).

The queue is the engine's admission boundary and the only place a request's
state machine lives:

    QUEUED → RUNNING → DONE
       │         ├──→ CANCELLED   (cancel() while queued or running)
       │         ├──→ EXPIRED     (deadline passed; partial output kept)
       │         └──→ QUEUED      (preempted: parked + reinstated)
       └────────────→ CANCELLED / EXPIRED   (never admitted)

Overload is explicit: the queue is bounded and ``submit`` raises
:class:`OverloadError` when full — callers see backpressure immediately
instead of an unbounded queue silently growing until the host dies (the
north-star "heavy traffic" posture: shed load at the edge, never inside the
decode loop).

Budgets: every request carries ``max_new_tokens`` (decode-step budget) and
an optional ``deadline_s`` (wall-clock budget, relative to submit). The
engine enforces both; the queue only records them.

**Multi-tenant QoS**: every request belongs to a ``qos_class`` (``latency``,
``standard``, ``batch`` by default) and optionally a ``tenant``. Pending
work lives in one FIFO sub-queue per class, and :meth:`pop_ready` runs a
weighted fair-share admission pass over them — deficit round-robin over the
per-class sub-queues, where a request's cost is its worst-case token budget
(``max_new_tokens * beam_size``). DRR is starvation-free by construction
(an unserved class's deficit grows every round until its head fits) and
FIFO within a class. Classes may carry per-tenant rate limits (token
bucket; a throttled submit raises :class:`RateLimitError` with a
rate-derived retry hint) and overload rejections carry **per-class**
retry-after hints: a rate-limited class's hint grows with its own backlog
over its refill rate, so a flooding batch tenant is told to back off longer
than an interactive one. A single-class workload (everything default
``standard``) takes a fast path that is behavior-identical to the
pre-QoS queue — same pop order, same hints.

Thread-safe: a client thread may submit/poll/cancel while the engine thread
steps. All mutation happens under one lock; the engine takes requests out
via :meth:`pop_ready`.
"""

from __future__ import annotations

import collections
import enum
import itertools
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# The percentile math is the obs subsystem's shared implementation (the
# same function serve/metrics.py re-exports).
from ..obs.metrics import percentile


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    CANCELLED = "cancelled"
    EXPIRED = "expired"
    # Disaggregated serving: prefill finished on a prefill-phase engine
    # and the request is parked awaiting KV handoff to a decode replica.
    # NOT a terminal state — the stream resumes (as a new attempt) on the
    # decode side, so ``finished`` stays False.
    PREFILLED = "prefilled"
    # Chunked prefill: admitted (rows + worst-case KV commit held) but
    # the source encode is still proceeding chunk-by-chunk; flips to
    # RUNNING once the cursor covers the source and decode begins. Like
    # PREFILLED, non-terminal.
    PREFILLING = "prefilling"


class OverloadError(RuntimeError):
    """Bounded queue is full — the caller must back off or shed load.

    ``retry_after_s`` is the p50 of recent queue waits (submit → admit):
    the queue's own estimate of how long backing off for one "turn" takes.
    When the queue has admitted nothing yet (cold start) the hint falls
    back to the queue's configured floor — a fleet router load-balances on
    this number, so "retry later" with no number is not an answer. None
    only when the floor itself is disabled (``retry_after_floor_s=None``).
    Rate-limited classes stretch the hint by their own backlog over their
    refill rate (see :class:`QosSpec`).
    """

    def __init__(self, depth: int, max_depth: int,
                 retry_after_s: Optional[float] = None):
        hint = "retry later" if retry_after_s is None \
            else f"retry in ~{retry_after_s:.3f}s"
        super().__init__(
            f"request queue full ({depth}/{max_depth}); {hint}")
        self.depth = depth
        self.max_depth = max_depth
        self.retry_after_s = retry_after_s


class RateLimitError(OverloadError):
    """A per-tenant class rate limit rejected the submit. IS-A
    OverloadError so every existing backoff/shed path (router retry,
    loadgen replay, fleet overload propagation) handles it unchanged;
    the hint is purely rate-derived (time until the token bucket refills),
    not queue-wait-derived."""

    def __init__(self, qos_class: str, tenant: Optional[str],
                 retry_after_s: float, depth: int, max_depth: int):
        super().__init__(depth, max_depth, retry_after_s=retry_after_s)
        who = f"tenant {tenant!r} " if tenant else ""
        self.args = (
            f"rate limit for {who}class {qos_class!r} exceeded; "
            f"retry in ~{retry_after_s:.3f}s",)
        self.qos_class = qos_class
        self.tenant = tenant
        self.rate_limited = True


class DeadlineExceededError(RuntimeError):
    """The request's absolute deadline passed before the operation could
    commit (e.g. a KV-handoff import after the stream outlived its
    budget in the parked gap). Deliberately NOT an OverloadError —
    waiting does not help; the caller must cancel the stream and account
    its decoded tokens as deadline waste, never retry it."""


@dataclass(frozen=True)
class QosSpec:
    """One QoS class's scheduling contract.

    ``weight`` is the DRR fair-share weight (admitted token budget is
    proportional under contention). ``priority`` orders classes for the
    round-robin scan and for preemption: a pending request may trigger
    eviction only of RUNNING groups whose class has a strictly larger
    priority number AND ``preemptible`` True. ``rate_per_s`` is a
    per-tenant token-bucket submit limit (None = unlimited); ``burst``
    the bucket depth (defaults to max(1, rate)).
    """

    name: str
    weight: int = 4
    priority: int = 1
    rate_per_s: Optional[float] = None
    burst: Optional[float] = None
    preemptible: bool = False

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"weight must be positive, got {self.weight}")
        if self.rate_per_s is not None and self.rate_per_s <= 0:
            raise ValueError(
                f"rate_per_s must be positive, got {self.rate_per_s}")


DEFAULT_QOS_CLASS = "standard"

# The default three-class policy. ``latency`` (interactive) outweighs
# ``standard`` 2:1 and ``batch`` 8:1 under contention and is the only
# class that triggers preemptive eviction (priority 0 < batch's 2);
# ``batch`` is the only preemptible class and carries a default rate
# limit, so its overload hints are backlog/rate-derived and a flooding
# batch tenant is throttled rather than allowed to bury the queue.
def default_qos_classes() -> Dict[str, QosSpec]:
    return {
        "latency": QosSpec("latency", weight=8, priority=0),
        "standard": QosSpec("standard", weight=4, priority=1),
        "batch": QosSpec("batch", weight=1, priority=2,
                         rate_per_s=64.0, preemptible=True),
    }


# DRR quantum per weight unit, in budget tokens. One full round gives a
# weight-1 class 32 tokens of deficit — small enough that interleaving is
# fine-grained, large enough that a typical smoke request (budget ≤ 32)
# admits within one top-up.
DRR_QUANTUM_TOKENS = 32


@dataclass
class Request:
    """One inference request and its observed lifecycle timestamps."""

    id: str
    src_ids: List[int]
    max_new_tokens: int
    beam_size: int = 1
    deadline: Optional[float] = None  # absolute, engine-clock seconds
    state: RequestState = RequestState.QUEUED
    submitted_at: float = 0.0
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    tokens: List[int] = field(default_factory=list)
    cancel_requested: bool = False
    # Distributed trace context: the fleet-level request identity minted
    # at Router.submit. Stable across evacuation/rollout re-routes while
    # ``id`` is the per-replica attempt id (``<trace>#aN``). None for
    # requests submitted straight to an engine.
    trace_id: Optional[str] = None
    # Admission-prefill device time attributed to this request (set by
    # the engine's batched prefill; feeds the per-request phase ledger).
    # Under chunked prefill it accumulates across chunk ticks.
    prefill_s: Optional[float] = None
    # Chunked prefill: how many chunk ticks this request's source encode
    # took (0 = admitted through the one-shot prefill path).
    prefill_chunks: int = 0
    # Multi-tenant QoS identity. ``qos_class`` selects the sub-queue /
    # fair-share weight; ``tenant`` scopes rate limits and observability.
    tenant: Optional[str] = None
    qos_class: str = DEFAULT_QOS_CLASS
    # Preemption bookkeeping (engine-maintained). ``parked_tokens`` is
    # the longest token prefix ever emitted before an eviction — the
    # zero-token-loss audit compares the resumed stream against it.
    # ``preempted_s`` accumulates parked wall time (the ledger's
    # ``preempted`` phase); ``preempted_at`` is set while parked.
    preemptions: int = 0
    preempted_s: float = 0.0
    preempted_at: Optional[float] = None
    parked_tokens: List[int] = field(default_factory=list)

    @property
    def finished(self) -> bool:
        return self.state in (RequestState.DONE, RequestState.CANCELLED,
                              RequestState.EXPIRED)

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def latency_s(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "state": self.state.value,
            "tokens": list(self.tokens),
            "ttft_s": self.ttft_s,
            "latency_s": self.latency_s,
            "beam_size": self.beam_size,
        }


class _ClassState:
    """One QoS class's sub-queue + DRR/rate-limit/accounting state."""

    __slots__ = ("spec", "pending", "deficit", "buckets", "submitted",
                 "admitted", "rejected", "rate_limited", "admitted_cost")

    def __init__(self, spec: QosSpec):
        self.spec = spec
        self.pending: collections.deque = collections.deque()
        self.deficit = 0.0
        # Per-tenant token buckets: tenant (or None) → (tokens, last_ts).
        self.buckets: Dict[Optional[str], Tuple[float, float]] = {}
        self.submitted = 0
        self.admitted = 0
        self.rejected = 0
        self.rate_limited = 0
        self.admitted_cost = 0


def _cost(req: Request) -> int:
    """DRR service cost: the request's worst-case token budget."""
    return req.max_new_tokens * req.beam_size


class RequestQueue:
    """Bounded per-class FIFOs + registry of all known requests.

    ``max_depth`` bounds only the QUEUED set across all classes
    (running/finished requests stay pollable without counting against
    admission capacity). ``retry_after_floor_s`` is the cold-start
    OverloadError hint: until real queue-wait samples exist, rejections
    carry this number instead of None (pass None to restore the old
    hint-less cold-start behavior). ``qos_classes`` overrides the
    default three-class policy (a dict name → :class:`QosSpec`).
    """

    DEFAULT_RETRY_AFTER_FLOOR_S = 0.05

    def __init__(self, max_depth: int = 64, clock=time.monotonic,
                 retry_after_floor_s: Optional[float]
                 = DEFAULT_RETRY_AFTER_FLOOR_S,
                 qos_classes: Optional[Dict[str, QosSpec]] = None):
        if max_depth <= 0:
            raise ValueError(f"max_depth must be positive, got {max_depth}")
        if retry_after_floor_s is not None and retry_after_floor_s < 0:
            raise ValueError(
                f"retry_after_floor_s must be non-negative, got "
                f"{retry_after_floor_s}")
        self.max_depth = max_depth
        self.retry_after_floor_s = retry_after_floor_s
        self._clock = clock
        self._lock = threading.Lock()
        # qos_active flips True the moment a submit names a tenant or a
        # non-default class (or a custom policy was passed) — the engine
        # gates its QoS metric surface on it so single-tenant runs keep
        # emitting byte-identical records.
        self.qos_active = qos_classes is not None
        specs = qos_classes if qos_classes is not None \
            else default_qos_classes()
        if DEFAULT_QOS_CLASS not in specs:
            raise ValueError(
                f"qos_classes must include the default class "
                f"{DEFAULT_QOS_CLASS!r}")
        self._classes: Dict[str, _ClassState] = {
            name: _ClassState(spec) for name, spec in specs.items()}
        # DRR scan order: by priority, name as the deterministic tiebreak.
        self._order: List[_ClassState] = [
            self._classes[n] for n in sorted(
                specs, key=lambda n: (specs[n].priority, n))]
        self._drr_idx = 0
        # Whether the class under the scan pointer has received its
        # once-per-arrival deficit top-up. Topping up on every visit
        # instead would let a heavy class monopolize admission for as
        # long as it has backlog — the exact starvation DRR exists to
        # prevent.
        self._drr_topped = False
        self._by_id: dict = {}
        self._auto_id = itertools.count()
        # Recent admission waits (submit → pop_ready), feeding the
        # OverloadError retry-after hint. Bounded so the hint tracks
        # CURRENT load, not the whole process history.
        self._recent_waits = collections.deque(maxlen=64)
        # Recent decode-window device latencies, reported by the engine via
        # note_decode_window. The secondary retry-after source: before any
        # admission wait exists, one decode window is the soonest a slot can
        # free up — and with speculative decoding each window commits
        # several tokens, so this tracks the post-speculation rate rather
        # than the static floor.
        self._recent_decode_windows = collections.deque(maxlen=64)
        # Fair-share accounting: expected vs actual admitted cost per
        # class, accumulated only while ≥2 classes were contending.
        self._fair_expected: Dict[str, float] = {}
        self._fair_actual: Dict[str, float] = {}
        # Chunked prefill (engine-configured): the per-tick chunk token
        # quota and the engine's last-reported in-flight partial-prefill
        # backlog, in tokens. Both feed the overload retry-after hint —
        # under a prompt flood the honest wait includes draining the
        # prefill pipeline at ``chunk`` tokens per tick, not just the
        # decode queue-wait p50.
        self._prefill_chunk = 0
        self._prefill_backlog = 0
        # Brownout shedding (fleet/degrade.py): class names whose
        # admissions are refused while the fleet is degraded. Shedding
        # is an OverloadError — the standard back-off contract — so
        # shed traffic retries through the same paths it always had.
        self.shed_classes: set = set()

    @property
    def depth(self) -> int:
        with self._lock:
            return sum(len(s.pending) for s in self._classes.values())

    def qos_spec(self, qos_class: str) -> QosSpec:
        st = self._classes.get(qos_class)
        if st is None:
            raise ValueError(
                f"unknown qos_class {qos_class!r} (have "
                f"{sorted(self._classes)})")
        return st.spec

    # -- submit ------------------------------------------------------------

    def _base_hint(self) -> Optional[float]:
        """The class-agnostic retry-after estimate (p50 of recent waits,
        then p50 of decode windows, then the floor) — exactly the pre-QoS
        hint, so default-class rejections are unchanged. With chunked
        prefill configured, the hint additionally covers the prompt-token
        backlog: queued + in-flight partial-prefill source tokens drain
        at ``_prefill_chunk`` tokens per tick, so a prompt flood yields
        honestly longer hints than a decode-bound queue of equal depth."""
        hint = percentile(list(self._recent_waits), 50)
        if hint is None:
            hint = percentile(list(self._recent_decode_windows), 50)
        if hint is None:
            hint = self.retry_after_floor_s
        elif self.retry_after_floor_s is not None:
            hint = max(hint, self.retry_after_floor_s)
        if self._prefill_chunk > 0:
            queued_tokens = self._prefill_backlog + sum(
                len(r.src_ids)
                for st in self._classes.values() for r in st.pending)
            if queued_tokens > 0:
                ticks = math.ceil(queued_tokens / self._prefill_chunk)
                tick_s = percentile(
                    list(self._recent_decode_windows), 50)
                if tick_s is None:
                    tick_s = self.retry_after_floor_s or 0.0
                hint = (hint or 0.0) + ticks * tick_s
        return hint

    def _class_hint(self, st: _ClassState) -> Optional[float]:
        """Per-class retry-after: rate-limited classes wait out their own
        backlog at their refill rate (a flooding batch tenant is told the
        truth — its turn comes after its own queue drains), everyone else
        gets the base estimate."""
        hint = self._base_hint()
        rate = st.spec.rate_per_s
        if rate:
            backlog = max(len(st.pending), 1) / rate
            hint = max(hint or 0.0, backlog)
        return hint

    def _take_bucket_token(self, st: _ClassState, tenant: Optional[str],
                           now: float) -> Optional[float]:
        """Per-tenant token bucket for a rate-limited class. Returns None
        when a token was taken, else the seconds until one refills."""
        rate = st.spec.rate_per_s
        if not rate:
            return None
        burst = st.spec.burst if st.spec.burst is not None \
            else max(1.0, rate)
        tokens, last = st.buckets.get(tenant, (burst, now))
        tokens = min(burst, tokens + (now - last) * rate)
        if tokens >= 1.0:
            st.buckets[tenant] = (tokens - 1.0, now)
            return None
        st.buckets[tenant] = (tokens, now)
        return (1.0 - tokens) / rate

    def submit(self, src_ids: List[int], max_new_tokens: int,
               beam_size: int = 1, deadline_s: Optional[float] = None,
               request_id: Optional[str] = None,
               trace_id: Optional[str] = None,
               tenant: Optional[str] = None,
               qos_class: Optional[str] = None) -> Request:
        """Enqueue a request or raise :class:`OverloadError` (queue full)
        / :class:`RateLimitError` (per-tenant class rate limit)."""
        if max_new_tokens <= 0:
            raise ValueError("max_new_tokens must be positive")
        if beam_size < 1:
            raise ValueError("beam_size must be >= 1")
        if not src_ids:
            raise ValueError("src_ids must be non-empty")
        cls = qos_class if qos_class is not None else DEFAULT_QOS_CLASS
        now = self._clock()
        with self._lock:
            st = self._classes.get(cls)
            if st is None:
                raise ValueError(
                    f"unknown qos_class {cls!r} (have "
                    f"{sorted(self._classes)})")
            if tenant is not None or cls != DEFAULT_QOS_CLASS:
                self.qos_active = True
            st.submitted += 1
            depth = sum(len(s.pending) for s in self._classes.values())
            if cls in self.shed_classes:
                # Degraded mode sheds this class at the edge — a
                # rejection with an honest hint, exactly the posture an
                # overloaded queue already has, so every existing
                # backoff loop handles it unchanged.
                st.rejected += 1
                raise OverloadError(depth, self.max_depth,
                                    retry_after_s=self._class_hint(st))
            wait = self._take_bucket_token(st, tenant, now)
            if wait is not None:
                st.rate_limited += 1
                raise RateLimitError(cls, tenant, retry_after_s=wait,
                                     depth=depth, max_depth=self.max_depth)
            if depth >= self.max_depth:
                st.rejected += 1
                raise OverloadError(depth, self.max_depth,
                                    retry_after_s=self._class_hint(st))
            rid = request_id if request_id is not None \
                else f"req-{next(self._auto_id)}"
            if rid in self._by_id:
                raise ValueError(f"duplicate request id {rid!r}")
            req = Request(
                id=rid, src_ids=list(src_ids),
                max_new_tokens=max_new_tokens, beam_size=beam_size,
                deadline=None if deadline_s is None else now + deadline_s,
                submitted_at=now, trace_id=trace_id,
                tenant=tenant, qos_class=cls)
            st.pending.append(req)
            self._by_id[rid] = req
            return req

    # -- the fair-share admission pass -------------------------------------

    def _prune_head(self, st: _ClassState, now: float) -> Optional[Request]:
        """Finalize cancelled/expired requests at the head of one class's
        sub-queue; returns the live head (or None)."""
        while st.pending:
            req = st.pending[0]
            if req.cancel_requested:
                st.pending.popleft()
                req.state = RequestState.CANCELLED
                req.finished_at = now
                continue
            if req.deadline is not None and now >= req.deadline:
                st.pending.popleft()
                req.state = RequestState.EXPIRED
                req.finished_at = now
                continue
            return req
        return None

    def _account_pop(self, st: _ClassState, req: Request,
                     nonempty: List[_ClassState], now: float) -> None:
        cost = _cost(req)
        st.admitted += 1
        st.admitted_cost += cost
        if len(nonempty) > 1:
            # Contended pop: fold into the fair-share ledger. Expected
            # service is cost split by weight over the classes that had
            # pending work at this decision point.
            total_w = sum(s.spec.weight for s in nonempty)
            for s in nonempty:
                self._fair_expected[s.spec.name] = \
                    self._fair_expected.get(s.spec.name, 0.0) \
                    + cost * s.spec.weight / total_w
            self._fair_actual[st.spec.name] = \
                self._fair_actual.get(st.spec.name, 0.0) + cost
        # A reinstated (preempted) request's second wait is parked time,
        # not admission latency — keep it out of the hint samples.
        if req.preempted_at is None:
            self._recent_waits.append(now - req.submitted_at)

    def pop_ready(self, now: Optional[float] = None,
                  can_place=None) -> Optional[Request]:
        """Next admissible request under weighted fair share, skipping —
        and finalizing — requests that were cancelled or expired while
        queued. Returns None when nothing is admissible.

        ``can_place`` is an optional predicate the engine uses for
        capacity-aware admission (free rows, KV block budget). Within a
        class the head is PEEKED first and only popped if placeable: a
        non-placeable head blocks its own class (FIFO — a large request
        is never starved by smaller ones behind it) but NOT the other
        classes, which keep draining their fair share. With a single
        active class this degenerates to exactly the pre-QoS FIFO."""
        now = self._clock() if now is None else now
        with self._lock:
            nonempty = [s for s in self._order
                        if self._prune_head(s, now) is not None]
            if not nonempty:
                return None
            if len(nonempty) == 1:
                st = nonempty[0]
                req = st.pending[0]
                if can_place is not None and not can_place(req):
                    return None
                st.pending.popleft()
                self._account_pop(st, req, nonempty, now)
                return req
            # Deficit round-robin over the contending classes. When the
            # scan pointer ARRIVES at a class its deficit is topped up
            # by weight * quantum — exactly once per arrival, the
            # pointer then staying put while the deficit covers head
            # costs (so one pop_ready call serves one request, but a
            # class's burst spans calls). Topping up on every visit
            # would hand a backlogged heavy class the whole admission
            # stream. Placement-blocked classes are skipped without
            # top-up or charge, so their claim survives until capacity
            # frees.
            blocked: set = set()
            n = len(self._order)

            def _advance():
                self._drr_idx += 1
                self._drr_topped = False

            worst = max(_cost(s.pending[0]) for s in nonempty)
            for _ in range(100 * n * (1 + worst // DRR_QUANTUM_TOKENS)):
                st = self._order[self._drr_idx % n]
                head = self._prune_head(st, now)
                if head is None:
                    st.deficit = 0.0
                    _advance()
                    continue
                if can_place is not None and not can_place(head):
                    blocked.add(st.spec.name)
                    if all(s.spec.name in blocked for s in self._order
                           if s.pending):
                        return None
                    _advance()
                    continue
                cost = _cost(head)
                if not self._drr_topped:
                    st.deficit += st.spec.weight * DRR_QUANTUM_TOKENS
                    self._drr_topped = True
                if st.deficit < cost:
                    _advance()   # deficit persists to the next round
                    continue
                st.pending.popleft()
                st.deficit -= cost
                if not st.pending:
                    st.deficit = 0.0
                    _advance()
                nonempty = [s for s in self._order
                            if s.pending or s is st]
                self._account_pop(st, head, nonempty, now)
                return head
            # Unreachable with sane costs (the bound covers worst-case
            # deficit accumulation), but never spin: serve the highest-
            # priority placeable head.
            for st in self._order:
                head = self._prune_head(st, now)
                if head is None or st.spec.name in blocked:
                    continue
                st.pending.popleft()
                self._account_pop(st, head,
                                  [s for s in self._order
                                   if s.pending or s is st], now)
                return head
            return None

    def peek_priority_head(self, now: Optional[float] = None
                           ) -> Optional[Request]:
        """The head of the highest-priority non-empty class (pruning
        cancelled/expired heads on the way) — the request the engine
        checks when deciding whether a preemptive eviction is warranted.
        Does not pop and charges no deficit."""
        now = self._clock() if now is None else now
        with self._lock:
            for st in self._order:
                head = self._prune_head(st, now)
                if head is not None:
                    return head
            return None

    def configure_prefill_chunk(self, chunk: int) -> None:
        """Arm the chunk-backlog term of the retry-after hint (engine-
        called at construction when ``prefill_chunk > 0``)."""
        if chunk < 0:
            raise ValueError(f"chunk must be non-negative, got {chunk}")
        with self._lock:
            self._prefill_chunk = int(chunk)

    def note_prefill_backlog(self, tokens: int) -> None:
        """Engine-reported in-flight partial-prefill backlog: source
        tokens admitted to rows but not yet encoded. Folded into the
        overload hint alongside the queued prompt tokens."""
        with self._lock:
            self._prefill_backlog = max(0, int(tokens))

    def note_decode_window(self, seconds: float) -> None:
        """Record one decode-window device latency (engine-reported).

        Feeds the overload retry-after hint when no admission waits have
        been observed yet: a speculative window commits up to gamma+1
        tokens per row, so its measured latency — not the static floor —
        is the honest "one turn" estimate under speculation."""
        if seconds < 0:
            return
        with self._lock:
            self._recent_decode_windows.append(seconds)

    def requeue_front(self, req: Request) -> None:
        """Put back a request pop_ready returned but the engine could not
        place (e.g. a beam group larger than the free-slot count). FIFO
        order within its class is preserved: the engine stops admitting
        at the first request of a class that doesn't fit."""
        with self._lock:
            st = self._classes[req.qos_class]
            st.pending.appendleft(req)
            # The pop was provisional: roll back its accounting so a
            # requeued head doesn't inflate the class's admitted share.
            st.admitted -= 1
            st.admitted_cost -= _cost(req)
            actual = self._fair_actual.get(req.qos_class)
            if actual is not None:
                self._fair_actual[req.qos_class] = \
                    max(0.0, actual - _cost(req))

    def reinstate(self, req: Request) -> None:
        """Put a PREEMPTED running request back at the front of its class
        sub-queue for later re-admission. Engine-internal: never raises
        OverloadError (the request was already accepted once) and does
        not count as a fresh submit."""
        with self._lock:
            req.state = RequestState.QUEUED
            self._classes[req.qos_class].pending.appendleft(req)

    def adopt(self, req: Request) -> None:
        """Register an externally-constructed request (a KV-handoff import
        on a decode replica) so poll/cancel see it. The request never sat
        in a sub-queue — it was admitted the moment it was imported — so
        it doesn't count against ``max_depth``."""
        with self._lock:
            if req.id in self._by_id:
                raise ValueError(f"duplicate request id {req.id!r}")
            self._by_id[req.id] = req

    def poll(self, request_id: str) -> Request:
        with self._lock:
            if request_id not in self._by_id:
                raise KeyError(f"unknown request {request_id!r}")
            return self._by_id[request_id]

    def cancel(self, request_id: str) -> bool:
        """Request cancellation. Queued requests finalize at the next
        pop_ready; running ones are flagged and the engine frees their
        slots within one step. Returns False if already finished."""
        with self._lock:
            req = self._by_id.get(request_id)
            if req is None:
                raise KeyError(f"unknown request {request_id!r}")
            if req.finished:
                return False
            req.cancel_requested = True
            return True

    def all_requests(self) -> List[Request]:
        with self._lock:
            return list(self._by_id.values())

    # -- QoS observability -------------------------------------------------

    def pending_by_class(self) -> Dict[str, int]:
        with self._lock:
            return {name: len(st.pending)
                    for name, st in self._classes.items() if st.pending}

    def min_pending_priority(self) -> Optional[int]:
        """The smallest (most urgent) priority among pending requests —
        the engine's window planner drops to single-step ticks when this
        outranks a running preemptible group, so eviction latency never
        hides behind a fused window."""
        with self._lock:
            prios = [st.spec.priority
                     for st in self._classes.values() if st.pending]
            return min(prios) if prios else None

    def fair_share_violation_max(self) -> Optional[float]:
        """Worst per-class shortfall vs the weighted fair share, over
        every contended admission: max over classes of
        (expected - actual) / expected admitted token cost. 0.0 is
        perfect fairness; None when no contention was ever observed."""
        with self._lock:
            if not self._fair_expected:
                return None
            worst = 0.0
            for name, exp in self._fair_expected.items():
                if exp <= 0:
                    continue
                short = (exp - self._fair_actual.get(name, 0.0)) / exp
                worst = max(worst, short)
            return worst

    def qos_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-class lifecycle counters (submitted/admitted/rejected/
        rate_limited/pending/admitted_cost) for bench records and the
        obs surfaces."""
        with self._lock:
            return {
                name: {
                    "pending": len(st.pending),
                    "submitted": st.submitted,
                    "admitted": st.admitted,
                    "rejected": st.rejected,
                    "rate_limited": st.rate_limited,
                    "admitted_cost": st.admitted_cost,
                    "weight": st.spec.weight,
                }
                for name, st in self._classes.items()
                if st.submitted or st.pending
            }
