"""Trace replay: drive ``Router.submit`` from a schedule on a virtual
clock.

The generator is **open-loop**: arrival times come from the spec's
seeded process and never wait on completions. The only feedback the
fleet gets to exert is its own admission control — an
``OverloadError``'s ``retry_after_s`` hint defers that one submission,
it never slows the offered load behind it.

Determinism discipline (same as ``runtime/faults.py``): no wall clock
anywhere. :class:`VirtualClock` only moves when :func:`replay` advances
it one ``tick_s`` per fleet tick; the Router (and, in the bench, every
engine) reads the same clock, so queue waits, retry hints, ledger
phases, and autoscale decisions are all functions of the seed — two
runs produce identical schedules, identical submission sequences, and
identical scale-event sequences.

Per-request outcomes (admitted on first try / retried honoring the
hint / never admitted) are folded into the router's existing per-request
ledger under the ``"loadgen"`` key once the request finalizes — the
post-mortem answer to "was that p95 queueing or shedding".
"""

from __future__ import annotations

import dataclasses
import heapq
import random
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..serve.queue import OverloadError
from .spec import TraceSpec


class VirtualClock:
    """A clock that only moves when told to. Pass ``.read`` wherever a
    ``clock=`` callable is accepted (Router, Engine, Autoscaler)."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def read(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance a clock backwards ({dt})")
        self._now += dt
        return self._now


@dataclasses.dataclass(frozen=True)
class ScheduledRequest:
    """One row of the schedule: when, what class, which prompt."""

    index: int
    request_id: str
    at_s: float
    cls: str
    src_ids: Tuple[int, ...]
    max_new_tokens: int
    prefix_group: Optional[str] = None
    tenant: Optional[str] = None
    qos_class: Optional[str] = None


class LoadGenerator:
    """Builds the deterministic schedule for one :class:`TraceSpec`.

    Class assignment, prompt tokens, and prefix-group membership all
    come from one seeded RNG stream, so ``LoadGenerator(spec, seed)``
    is a pure function — the schedule-equality test in
    tests/test_loadgen.py pins that. ``prompt_corpus`` (a list of token
    lists, e.g. derived from the wmt_sliver fixture) replaces the random
    prompts: entry ``i % len(corpus)`` is truncated to the class prompt
    length. Per-class ``budget`` caps are honored by re-drawing the
    class; when every budget is exhausted the schedule simply ends.
    """

    def __init__(self, spec: TraceSpec, seed=0, vocab_size: int = 96,
                 reserved: int = 3,
                 prompt_corpus: Optional[Sequence[Sequence[int]]] = None):
        if vocab_size <= reserved:
            raise ValueError(
                f"vocab_size ({vocab_size}) must exceed reserved "
                f"({reserved})")
        self.spec = spec
        self.seed = seed
        rng = random.Random(f"loadgen/{spec.name}/{seed}")
        classes = list(spec.classes)
        weights = [c.weight for c in classes]
        remaining = {c.name: c.budget for c in classes}
        per_class_count = {c.name: 0 for c in classes}
        prefixes: Dict[str, Tuple[int, ...]] = {}

        def _draw_class():
            open_cls = [c for c in classes
                        if remaining[c.name] is None
                        or remaining[c.name] > 0]
            if not open_cls:
                return None
            total = sum(c.weight for c in open_cls)
            x = rng.random() * total
            acc = 0.0
            for c in open_cls:
                acc += c.weight
                if x <= acc:
                    return c
            return open_cls[-1]

        def _tokens(n: int) -> List[int]:
            return [rng.randrange(reserved, vocab_size)
                    for _ in range(n)]

        schedule: List[ScheduledRequest] = []
        for i, at_s in enumerate(spec.arrival_times(seed)):
            cls = _draw_class()
            if cls is None:
                break   # every class budget exhausted
            if remaining[cls.name] is not None:
                remaining[cls.name] -= 1
            group = None
            if prompt_corpus is not None:
                src = [int(t) for t in
                       prompt_corpus[i % len(prompt_corpus)]][:cls.src_len]
                if not src:
                    raise ValueError(
                        f"prompt_corpus entry {i % len(prompt_corpus)} "
                        f"is empty")
            elif cls.prefix_groups > 0:
                group = (f"{cls.name}/g"
                         f"{per_class_count[cls.name] % cls.prefix_groups}")
                if group not in prefixes:
                    prefixes[group] = tuple(_tokens(cls.prefix_len))
                src = list(prefixes[group]) \
                    + _tokens(cls.src_len - cls.prefix_len)
            else:
                src = _tokens(cls.src_len)
            per_class_count[cls.name] += 1
            schedule.append(ScheduledRequest(
                index=i, request_id=f"lg-{i:04d}", at_s=at_s,
                cls=cls.name, src_ids=tuple(src),
                max_new_tokens=cls.max_new_tokens, prefix_group=group,
                tenant=cls.tenant, qos_class=cls.qos_class))
        self.schedule: Tuple[ScheduledRequest, ...] = tuple(schedule)

    def pairs(self) -> List[Tuple[List[int], int]]:
        """The (src_ids, max_new_tokens) list in schedule order — the
        shape the bench's single-engine/fixed-fleet parity baselines
        consume."""
        return [(list(s.src_ids), s.max_new_tokens)
                for s in self.schedule]


@dataclasses.dataclass
class ReplayReport:
    """What one replay did: request ids in schedule order, per-request
    outcomes, and the offered-load accounting."""

    rids: List[str]
    outcomes: Dict[str, Dict[str, Any]]
    ticks: int
    duration_s: float
    offered_load_rps: Optional[float]
    rejections: int
    retries_honored: int


def replay(gen: LoadGenerator, router, clock: VirtualClock,
           tick_s: float = 0.05,
           on_tick: Optional[Callable[[float], Any]] = None,
           max_ticks: Optional[int] = None) -> ReplayReport:
    """Replay ``gen``'s schedule into ``router`` (which must read the
    same ``clock``), one fleet tick per ``tick_s`` of virtual time.

    Each tick: submit every arrival (and every due retry) whose time has
    come, ``router.step()``, call ``on_tick(now)`` (the autoscale hook),
    advance the clock. The loop runs to the LATER of schedule+drain
    completion and the spec's full ``duration_s`` — trailing quiet time
    is part of an open-loop trace (it is exactly where a controller
    proves it can scale back down).

    Overload handling honors the hint: a rejected submission is re-queued
    at ``now + retry_after_s`` (floored at one tick), never dropped —
    the request's outcome records how many rejections it absorbed and
    whether the hints were honored.
    """
    if tick_s <= 0:
        raise ValueError(f"tick_s must be > 0, got {tick_s}")
    spec = gen.spec
    if max_ticks is None:
        max_ticks = int(spec.duration_s / tick_s) + 100_000
    pending = deque(gen.schedule)
    retries: List[Tuple[float, int, ScheduledRequest]] = []
    retry_seq = 0
    outcomes: Dict[str, Dict[str, Any]] = {
        s.request_id: {
            "class": s.cls, "scheduled_s": s.at_s, "submitted_s": None,
            "rejections": 0, "retry_after_honored": False,
            "outcome": "never_admitted", "prefix_group": s.prefix_group,
            "tenant": s.tenant, "qos_class": s.qos_class,
        } for s in gen.schedule}
    rejections = 0
    ticks = 0
    while True:
        now = clock.read()
        due: List[ScheduledRequest] = []
        while pending and pending[0].at_s <= now:
            due.append(pending.popleft())
        while retries and retries[0][0] <= now:
            due.append(heapq.heappop(retries)[2])
        for s in due:
            o = outcomes[s.request_id]
            qos_kwargs: Dict[str, Any] = {}
            if s.tenant is not None:
                qos_kwargs["tenant"] = s.tenant
            if s.qos_class is not None:
                qos_kwargs["qos_class"] = s.qos_class
            if s.prefix_group is not None:
                # The loadgen knows the request's shared prefix by
                # construction — hand the group id to the router as its
                # cache-affinity key (cache-aware policies steer on it;
                # the others ignore it).
                qos_kwargs["affinity_key"] = s.prefix_group
            try:
                router.submit(list(s.src_ids),
                              max_new_tokens=s.max_new_tokens,
                              request_id=s.request_id, **qos_kwargs)
            except OverloadError as e:
                rejections += 1
                o["rejections"] += 1
                wait = e.retry_after_s
                if wait is not None:
                    o["retry_after_honored"] = True
                retry_seq += 1
                heapq.heappush(
                    retries,
                    (now + max(wait if wait is not None else tick_s,
                               tick_s), retry_seq, s))
                continue
            except Exception as e:
                # NoReplicasError (import-cycle-free duck check): the
                # fleet is mid-churn with nothing routable — back off one
                # tick, same zero-drop stance as the overload path.
                if type(e).__name__ != "NoReplicasError":
                    raise
                rejections += 1
                o["rejections"] += 1
                retry_seq += 1
                heapq.heappush(retries, (now + tick_s, retry_seq, s))
                continue
            o["submitted_s"] = now
            o["outcome"] = ("admitted" if o["rejections"] == 0
                            else "admitted_after_retry")
        router.step()
        if on_tick is not None:
            on_tick(now)
        ticks += 1
        clock.advance(tick_s)
        if not pending and not retries and not router.pending() \
                and clock.read() >= spec.duration_s:
            break
        if ticks >= max_ticks:
            break
    # Fold outcomes into the router's per-request ledger (finalized
    # entries only — a request that never reached a terminal state has
    # no ledger row to annotate; the bench counts it as a drop).
    for rid, o in outcomes.items():
        entry = router.ledger.get(rid)
        if entry is not None:
            entry["loadgen"] = dict(o)
    virtual_end = clock.read()
    offered = (len(gen.schedule) / spec.duration_s
               if spec.duration_s > 0 else None)
    return ReplayReport(
        rids=[s.request_id for s in gen.schedule],
        outcomes=outcomes, ticks=ticks, duration_s=virtual_end,
        offered_load_rps=offered, rejections=rejections,
        retries_honored=sum(1 for o in outcomes.values()
                            if o["retry_after_honored"]))
