"""Deterministic fault injection for the storage/recovery stack.

A copy of the JAX package's ``runtime/faults.py`` (it imports nothing of
JAX) over the port's own :class:`~..ckpt.store.Store`.

The durability claim this repo reproduces (SURVEY.md §6: rank 0 saves to
shared storage, the launcher restarts dead jobs, training auto-resumes) is
only as good as its behavior under faults — and real faults (a GCS 503
mid-save, a host SIGKILLed between the shard write and the COMMIT marker)
are exactly the events a test suite never sees by accident. This module
makes them first-class and *deterministic*:

- :class:`FaultPlan` / :class:`FaultSpec` — a declarative schedule of which
  store operations fail, how, and on which call. Matching is op-indexed
  (fire on the Nth call of each (op, key) site) or seeded (a
  ``random.Random(seed)`` coin) — never wall-clock — so every failure a
  test provokes replays identically.
- :class:`FaultInjectionStore` — a :class:`~..ckpt.store.Store` wrapper
  that consults the plan before every operation and injects transient
  errors (retriable), fatal errors, latency, or a *crash* (the store goes
  dead mid-protocol, leaving torn two-phase-commit state behind: shards
  without DONE, DONE without COMMIT, partial ranks).
- :func:`chaos_kill_hook_from_env` — the process-level analogue: a training
  hook that SIGKILLs the worker at a planned step on the first launch
  attempt only, so the launcher's kill → restart → resume loop can be
  exercised end to end (launch/chaos.py drives it).

Exception taxonomy mirrors the retry classification in ckpt/store.py:
:class:`InjectedTransientError` is an ``OSError`` (retriable),
:class:`InjectedFatalError` is a ``ValueError`` (fatal, fail fast),
:class:`InjectedHangError` is a ``TimeoutError`` (the hang class the
launcher's watchdog would classify), :class:`StoreCrashed` models process
death — nothing should retry it.

Beyond the store, the same plan addresses **fleet sites**: dotted op names
(``replica.step``, ``replica.submit``, ``handoff.export``,
``handoff.import``, ``router.cancel``) are consulted by fleet/replica.py
and fleet/router.py with the replica id or request id as the key. A bare
``op`` (no dot) written against the pre-fleet vocabulary still matches the
dotted site by its leaf name — ``op="step"`` matches ``replica.step`` —
so existing plans keep firing unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import signal
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..ckpt.store import Store

CHAOS_KILL_ENV = "DLCFN_CHAOS_KILL_AT_STEP"
CHAOS_KILL_PROCESS_ENV = "DLCFN_CHAOS_KILL_PROCESS"
ATTEMPT_ENV = "DLCFN_ATTEMPT"  # set by launch/launcher.py per attempt


class InjectedTransientError(OSError):
    """A transient storage fault (the GCS-503 role) — retriable."""


class InjectedFatalError(ValueError):
    """A permanent storage fault — classified fatal, never retried."""


class InjectedHangError(TimeoutError):
    """A classified hang (the watchdog-exit role): the operation timed
    out rather than failed. ``TimeoutError`` is an ``OSError``, so the
    store retry classifier treats it as retriable; the fleet router
    counts it distinctly (hang vs crash) before its breaker math."""


class StoreCrashed(RuntimeError):
    """The simulated process died mid-protocol; the store is gone. Every
    subsequent operation on the crashed store raises this too — a dead
    process never completes the writes after its crash point."""


@dataclasses.dataclass
class FaultSpec:
    """One rule: WHICH operations to fault and HOW.

    ``op`` is a prefix match on the store method name (``"put"`` matches
    both put_bytes and put_npz; ``"*"`` matches everything). ``key`` is a
    substring match on the object key ("" matches all). Firing is decided
    per (op, key) *site*: each site keeps its own 0-based call counter, so
    ``first_n=2`` means "the first two calls for each key" — the shape a
    retry loop sees as "two transient failures, then success".
    """

    op: str = "*"
    key: str = ""
    # transient | fatal | latency | crash  — the store-era kinds, plus the
    # fleet kinds: hang (classified TimeoutError), crash_mid (the step
    # RUNS, then the replica dies — torn state), corrupt (bit-flip the
    # stored handoff artifact), drop (delete it after export).
    kind: str = "transient"
    first_n: int = 0         # fire on the first N calls per site (0 = every)
    at_calls: Tuple[int, ...] = ()  # explicit per-site call indices instead
    probability: float = 0.0  # seeded coin (plan seed) instead of indexing
    latency_s: float = 0.0   # kind="latency": injected delay
    message: str = ""

    KINDS = ("transient", "fatal", "latency", "crash",
             "hang", "crash_mid", "corrupt", "drop")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")

    def matches_site(self, op: str, key: str) -> bool:
        if self.op != "*" and not op.startswith(self.op):
            # Back-compat across the fleet layering: a bare op written
            # before sites grew layer prefixes ("step") still addresses
            # the dotted site ("replica.step") by its leaf name. Store
            # ops have no dots, so store matching is unchanged.
            _, dot, leaf = op.partition(".")
            if not (dot and "." not in self.op and leaf.startswith(self.op)):
                return False
        return self.key in key

    def fires(self, call_index: int, rng: random.Random) -> bool:
        if self.probability > 0:
            return rng.random() < self.probability
        if self.at_calls:
            return call_index in self.at_calls
        if self.first_n > 0:
            return call_index < self.first_n
        return True


class FaultPlan:
    """An ordered set of :class:`FaultSpec` rules plus the deterministic
    state they fire against (per-site call counters, a seeded RNG)."""

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = seed
        self._rng = random.Random(seed)
        self._site_counts: Dict[Tuple[int, str, str], int] = {}
        # kind → times a spec of that kind fired, across all sites. The
        # fleet bench reports this as ``faults_injected`` so a chaos run
        # proves the plan actually bit (a plan that never fires passes
        # every contract vacuously).
        self.fired_counts: Dict[str, int] = {}

    def consult(self, op: str, key: str) -> List[FaultSpec]:
        """Advance the per-site counters and return the specs that fire
        for this call (usually zero or one)."""
        fired = []
        for i, spec in enumerate(self.specs):
            if not spec.matches_site(op, key):
                continue
            site = (i, op, key)
            idx = self._site_counts.get(site, 0)
            self._site_counts[site] = idx + 1
            if spec.fires(idx, self._rng):
                self.fired_counts[spec.kind] = \
                    self.fired_counts.get(spec.kind, 0) + 1
                fired.append(spec)
        return fired

    # -- serialized plans (`bench --fleet --chaos-plan plan.json`) ----------

    @classmethod
    def from_dict(cls, obj: Dict) -> "FaultPlan":
        """Build a plan from the committed-JSON shape::

            {"seed": 0, "specs": [{"op": "replica.step", "key": "r0",
                                   "kind": "hang", "at_calls": [4]}, ...]}

        Unknown spec fields are rejected (a typo'd field silently
        matching everything is the opposite of deterministic chaos).
        """
        specs = []
        known = {f.name for f in dataclasses.fields(FaultSpec)}
        for raw in obj.get("specs", []):
            extra = set(raw) - known
            if extra:
                raise ValueError(
                    f"unknown FaultSpec fields {sorted(extra)} in {raw!r}")
            kwargs = dict(raw)
            if "at_calls" in kwargs:
                kwargs["at_calls"] = tuple(int(c) for c in kwargs["at_calls"])
            specs.append(FaultSpec(**kwargs))
        return cls(specs, seed=int(obj.get("seed", 0)))

    @classmethod
    def from_json(cls, path: str) -> "FaultPlan":
        with open(path, "r", encoding="utf-8") as fh:
            return cls.from_dict(json.load(fh))

    # -- canned scenarios ---------------------------------------------------

    @classmethod
    def transient_puts(cls, failures_per_put: int = 2) -> "FaultPlan":
        """Every put fails ``failures_per_put`` times, then succeeds —
        the flaky-object-store scenario RetryingStore must absorb."""
        return cls([FaultSpec(op="put", kind="transient",
                              first_n=failures_per_put)])

    @classmethod
    def permanent_puts(cls) -> "FaultPlan":
        """Every put fails permanently — retrying must NOT happen."""
        return cls([FaultSpec(op="put", kind="fatal")])

    @classmethod
    def crash_before_done(cls) -> "FaultPlan":
        """Torn commit: die writing the first DONE marker — shard objects
        and manifests are durable, no DONE, no COMMIT."""
        return cls([FaultSpec(op="put", key="DONE_p", kind="crash")])

    @classmethod
    def crash_before_commit(cls) -> "FaultPlan":
        """Torn commit: die writing COMMIT — every per-process object and
        DONE marker is durable, but the checkpoint is uncommitted."""
        return cls([FaultSpec(op="put", key="COMMIT", kind="crash")])


class FaultInjectionStore(Store):
    """Store wrapper that injects the plan's faults before delegating.

    Counters (``op_counts``, ``injected``) expose what actually happened,
    so tests assert against observed injections, not assumptions. After a
    ``crash`` fault the store is dead: every later call raises
    :class:`StoreCrashed` without touching the inner store.
    """

    def __init__(self, inner: Store, plan: FaultPlan,
                 sleep: Callable[[float], None] = time.sleep):
        self.inner = inner
        self.plan = plan
        self._sleep = sleep
        self.crashed = False
        self.op_counts: Dict[str, int] = {}
        self.injected: Dict[str, int] = {}

    def _guard(self, op: str, key: str) -> None:
        if self.crashed:
            raise StoreCrashed(f"store crashed; {op}({key!r}) never ran")
        self.op_counts[op] = self.op_counts.get(op, 0) + 1
        for spec in self.plan.consult(op, key):
            self.injected[spec.kind] = self.injected.get(spec.kind, 0) + 1
            msg = spec.message or f"injected {spec.kind} on {op}({key!r})"
            if spec.kind == "latency":
                self._sleep(spec.latency_s)
            elif spec.kind == "transient":
                raise InjectedTransientError(msg)
            elif spec.kind == "fatal":
                raise InjectedFatalError(msg)
            elif spec.kind == "hang":
                raise InjectedHangError(msg)
            elif spec.kind in ("crash", "crash_mid"):
                self.crashed = True
                raise StoreCrashed(msg)

    def put_bytes(self, key, data):
        self._guard("put_bytes", key)
        return self.inner.put_bytes(key, data)

    def put_npz(self, key, arrays):
        self._guard("put_npz", key)
        return self.inner.put_npz(key, arrays)

    def get_bytes(self, key):
        self._guard("get_bytes", key)
        return self.inner.get_bytes(key)

    def get_npz(self, key):
        self._guard("get_npz", key)
        return self.inner.get_npz(key)

    def exists(self, key):
        self._guard("exists", key)
        return self.inner.exists(key)

    def list(self, prefix=""):
        self._guard("list", prefix)
        return self.inner.list(prefix)

    def list_subdirs(self, prefix=""):
        self._guard("list_subdirs", prefix)
        return self.inner.list_subdirs(prefix)

    def delete_prefix(self, prefix):
        self._guard("delete_prefix", prefix)
        return self.inner.delete_prefix(prefix)

    def describe(self):
        return f"fault-injection({self.inner.describe()})"


def chaos_kill_hook_from_env(
        committed: Optional[Callable[[int], bool]] = None
) -> Optional[Callable]:
    """Build the SIGKILL-at-step training hook when the chaos env contract
    is armed (test harness only — launch/chaos.py sets it).

    ``DLCFN_CHAOS_KILL_AT_STEP=<N>`` arms the kill; it fires only on launch
    attempt 0 (``DLCFN_ATTEMPT``, set by the launcher) so the restarted
    attempt runs to completion. SIGKILL — not sys.exit — because the point
    is an unclean death: no finalizers, no atexit, the exact failure the
    two-phase checkpoint commit must survive.

    ``DLCFN_CHAOS_KILL_PROCESS=<i>`` kills process ``i`` of a multi-process
    job only (``DLCFN_PROCESS_ID``), and only once ``committed(step)`` says
    the step's checkpoint is committed (up to two minutes): process 0
    commits once every process's marker is written, so the restarted job
    resumes from that step, whatever the processes' timing.
    """
    kill_at = int(os.environ.get(CHAOS_KILL_ENV, "0") or 0)
    if kill_at <= 0:
        return None
    if os.environ.get(ATTEMPT_ENV, "0") != "0":
        return None
    only = os.environ.get(CHAOS_KILL_PROCESS_ENV)
    if only is not None and \
            os.environ.get("DLCFN_PROCESS_ID", "0") != only:
        return None

    def hook(step: int, state, metrics) -> None:
        if step >= kill_at:
            if only is not None and committed is not None:
                deadline = time.monotonic() + 120.0
                while not committed(step) and time.monotonic() < deadline:
                    time.sleep(0.05)
            print(f"[dlcfn-tpu] CHAOS: SIGKILL self at step {step} "
                  f"(planned {kill_at})", file=sys.stderr, flush=True)
            sys.stdout.flush()
            os.kill(os.getpid(), signal.SIGKILL)

    return hook
