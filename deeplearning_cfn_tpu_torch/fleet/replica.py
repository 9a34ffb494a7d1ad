"""Replica layer: one serve engine behind a health/lifecycle surface.

Two granularities, same vocabulary:

- :class:`EngineReplica` — an **in-process** handle around one
  serve/engine.py Engine: routable state machine (HEALTHY → DRAINING /
  DOWN / BROKEN), a cheap :meth:`health` snapshot the router's
  least-loaded policy sorts on, deterministic crash injection through
  runtime/faults.py (a FaultPlan ``op="step"`` crash spec kills the
  replica mid-decode exactly like a SIGKILL would, without taking the
  test process with it), and the rollout primitives
  :meth:`swap_variables` / :meth:`probe`.
- :class:`ReplicaSupervisor` — the **process-level** fleet: N serve
  child processes started through the launcher's Transport abstraction
  (launch/launcher.py ``start()``/:class:`~..launch.JobHandle`), each a
  single-host ClusterSpec writing obs metrics/spans into its own run dir
  (``<root>/replica-<i>/``). The supervisor polls all handles without
  blocking, classifies each exit hang-vs-crash with the launcher's own
  ``classify_attempt`` (the watchdog's deliberate exit code 89 is a hang,
  not a fault), and restarts failed replicas up to ``max_restarts`` —
  the SURVEY.md §6 failure-detection contract, applied per replica
  instead of per job.

The split mirrors the serving systems this reproduces one level up:
the router (control plane) never touches a process; the supervisor
(lifecycle plane) never touches a request.

A copy of the JAX package's ``fleet/replica.py`` (it imports nothing of
JAX) over the port's launcher, obs, cluster and serve modules.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import time
from typing import Dict, List, Optional

from ..launch.launcher import JobHandle, JobLauncher, Transport, \
    classify_attempt
from ..metrics.jsonl import MetricsWriter
from ..obs.sinks import JsonlSink
from ..obs.trace import get_tracer, obs_enabled
from ..runtime.cluster import ClusterSpec
from ..serve.metrics import percentile


class ReplicaState(enum.Enum):
    HEALTHY = "healthy"      # routable, stepped
    DRAINING = "draining"    # not routable, still stepped (rollout)
    BROKEN = "broken"        # circuit open — not routable, not stepped
    DOWN = "down"            # crashed — gone until restarted/readmitted


class ReplicaCrashed(RuntimeError):
    """The replica's engine died mid-decode (injected or real). Its
    in-flight requests are lost from ITS point of view — the router
    resubmits them elsewhere; greedy decode is deterministic, so the
    re-run emits the identical tokens."""


class EngineReplica:
    """One in-process serve engine wearing a replica identity.

    ``fault_plan`` hooks runtime/faults.py into the decode loop: before
    every :meth:`step` the plan is consulted at site ``("replica.step",
    replica_id)`` (bare ``op="step"`` specs still match — see
    FaultSpec.matches_site); a ``crash`` spec marks the replica DOWN and
    raises :class:`ReplicaCrashed` (the deterministic stand-in for
    SIGKILL — same observable effect on the fleet, replayable
    in-process), ``crash_mid`` lets the step RUN first and then crashes
    (torn state: this tick's tokens exist on a dead replica), ``hang``
    raises the classified :class:`~..runtime.faults.InjectedHangError`,
    ``latency`` injects a slow tick, and :meth:`submit` consults
    ``("replica.submit", replica_id)`` the same way.
    """

    def __init__(self, replica_id: str, engine, fault_plan=None,
                 sleep=time.sleep):
        self.id = replica_id
        self.engine = engine
        self.state = ReplicaState.HEALTHY
        self.fault_plan = fault_plan
        self._sleep = sleep
        self.crashed = False
        self.steps = 0
        # Disaggregated phase role, read off the engine ("both" for
        # engines — and test fakes — that predate the phase split).
        self.phase = getattr(engine, "phase", "both")
        # Per-replica trace shard. The engine emits spans through the
        # process-global tracer; attaching this sink only for the
        # duration of THIS replica's step keeps its spans out of the
        # other replicas' shards even though all engines share one
        # tracer in-process.
        self.trace_sink = None

    @contextlib.contextmanager
    def _traced(self):
        if self.trace_sink is None:
            yield
            return
        tracer = get_tracer()
        tracer.add_sink(self.trace_sink)
        try:
            yield
        finally:
            tracer.remove_sink(self.trace_sink)

    # -- routing surface ----------------------------------------------------

    @property
    def routable(self) -> bool:
        return self.state is ReplicaState.HEALTHY and not self.crashed

    @property
    def steppable(self) -> bool:
        """DRAINING replicas are still stepped (in-flight work finishes);
        BROKEN/DOWN are not."""
        return self.state in (ReplicaState.HEALTHY, ReplicaState.DRAINING) \
            and not self.crashed

    @property
    def busy(self) -> bool:
        # Parked handoffs count: a prefill replica still holds rows and
        # KV blocks for them, so drain (rollout) must wait until the
        # router moves them to a decode replica.
        return self.engine.queue.depth > 0 \
            or self.engine.active_requests > 0 \
            or getattr(self.engine, "handoff_pending", 0) > 0

    def _consult(self, site: str):
        if self.fault_plan is None:
            return
        from ..runtime.faults import InjectedFatalError, InjectedHangError, \
            InjectedTransientError
        for spec in self.fault_plan.consult(site, self.id):
            if spec.kind == "crash":
                self._die(spec.message, site)
            elif spec.kind == "crash_mid":
                # Deferred: the caller runs the operation first, then
                # crashes — the torn-state variant. Only step() honours
                # it; elsewhere it degrades to an immediate crash.
                yield spec
            elif spec.kind == "transient":
                raise InjectedTransientError(
                    spec.message or f"injected transient on {self.id}")
            elif spec.kind == "fatal":
                raise InjectedFatalError(
                    spec.message or f"injected fatal on {self.id}")
            elif spec.kind == "hang":
                raise InjectedHangError(
                    spec.message
                    or f"injected hang on {self.id} ({site})")
            elif spec.kind == "latency":
                self._sleep(spec.latency_s)

    def _die(self, message: str, site: str):
        self.crashed = True
        self.state = ReplicaState.DOWN
        raise ReplicaCrashed(
            message or f"replica {self.id} killed mid-decode "
                       f"(injected, {site}, step {self.steps})")

    def submit(self, src_ids, **kwargs):
        if self.crashed:
            raise ReplicaCrashed(f"replica {self.id} is down")
        for _ in self._consult("replica.submit"):
            self._die("", "replica.submit")
        return self.engine.submit(src_ids, **kwargs)

    def poll(self, request_id: str):
        return self.engine.poll(request_id)

    def cancel(self, request_id: str) -> bool:
        if self.crashed:
            return False
        return self.engine.cancel(request_id)

    def step(self) -> int:
        if self.crashed:
            raise ReplicaCrashed(f"replica {self.id} is down")
        crash_mid = list(self._consult("replica.step"))
        with self._traced():
            n = self.engine.step()
        self.steps += 1
        if crash_mid:
            # crash_mid: the engine stepped — this tick's tokens are
            # real but live on a now-dead replica. The router evacuates
            # them as wasted work and re-decodes elsewhere.
            self._die(crash_mid[0].message, "replica.step")
        return n

    # -- KV handoff (disaggregated prefill/decode) ---------------------------

    def handoff_ready(self, request_id: str) -> bool:
        if self.crashed:
            return False
        return bool(getattr(self.engine, "handoff_ready",
                            lambda _rid: False)(request_id))

    def export_handoff(self, request_id: str):
        if self.crashed:
            raise ReplicaCrashed(f"replica {self.id} is down")
        return self.engine.export_handoff(request_id)

    def import_handoff(self, artifact, request_id: str, trace_id=None,
                       **qos_kwargs):
        if self.crashed:
            raise ReplicaCrashed(f"replica {self.id} is down")
        return self.engine.import_handoff(artifact, request_id,
                                          trace_id=trace_id, **qos_kwargs)

    def release_handoff(self, request_id: str) -> None:
        """Free the parked prefill state after a successful import. Runs
        under this replica's trace sink: the release emits the
        prefill-side ``serve.request`` span, which must land in THIS
        shard for the cross-process flow link to pair up."""
        if self.crashed:
            raise ReplicaCrashed(f"replica {self.id} is down")
        with self._traced():
            self.engine.release_handoff(request_id)

    def record_evacuation(self, req, now: float) -> None:
        """Write the abandoned attempt into THIS replica's trace shard.

        A replica that crashed or tripped its breaker is never stepped
        again, so the engine's own release path (which emits the
        ``serve.request`` span) cannot run for its in-flight copies. The
        router calls this at evacuation so the merged fleet timeline
        still shows the attempt — state ``evacuated``, with the tokens
        the fleet is about to re-decode elsewhere."""
        if not obs_enabled():
            return
        t0 = getattr(req, "submitted_at", None)
        if not isinstance(t0, (int, float)):
            return
        with self._traced():
            get_tracer().record_span(
                "serve.request", t0, max(now - t0, 0.0), ok=False,
                request_id=getattr(req, "id", None),
                trace_id=getattr(req, "trace_id", None)
                or getattr(req, "id", None),
                state="evacuated", replica=self.id,
                tokens=len(getattr(req, "tokens", ()) or ()))

    # -- health / rollout ---------------------------------------------------

    def health(self) -> Dict:
        """Load snapshot the router's policies sort on. Cheap on purpose
        (counters + one percentile), read every routing decision."""
        m = self.engine.metrics
        return {
            "replica": self.id,
            "state": self.state.value,
            "phase": self.phase,
            "queue_depth": self.engine.queue.depth,
            "active_requests": self.engine.active_requests,
            "handoff_pending": getattr(self.engine, "handoff_pending", 0),
            "capacity": self.engine.capacity,
            "step_latency_p50_s": percentile(m.step_latency_s, 50),
            "tokens_generated": m.tokens_generated,
            "retry_after_hint_s": m.last_retry_after_s,
        }

    def swap_variables(self, variables) -> None:
        """Checkpoint swap — delegates the idle-only contract (and the
        prefix-cache invalidation) to Engine.swap_variables."""
        self.engine.swap_variables(variables)

    def probe(self, src_ids=(5, 4, 3), max_new_tokens: int = 2,
              max_steps: int = 256) -> bool:
        """Post-swap health check: run one tiny request to completion on
        THIS replica only (it is out of rotation, so the probe can't
        collide with routed traffic). True iff it finishes DONE — or,
        on a prefill-phase replica, iff it parks PREFILLED (that IS the
        completed lifecycle there; the probe releases the parked state
        so the replica comes back idle)."""
        if self.crashed or self.busy:
            return False
        try:
            req = self.engine.submit(list(src_ids),
                                     max_new_tokens=max_new_tokens)
            self.engine.run_until_drained(max_steps=max_steps)
            if getattr(self.engine, "phase", "both") == "prefill" \
                    and self.engine.handoff_ready(req.id):
                self.engine.release_handoff(req.id)
                return True
        except Exception:
            return False
        return req.state.value == "done"


# -- process-level supervision ----------------------------------------------


@dataclasses.dataclass
class ReplicaProcSpec:
    """One child serve process: what to run and where its run dir lives."""

    replica_id: str
    argv: List[str]
    run_dir: str
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    cwd: Optional[str] = None


class _SupervisedReplica:
    def __init__(self, spec: ReplicaProcSpec, launcher: JobLauncher,
                 events: MetricsWriter):
        self.spec = spec
        self.launcher = launcher
        self.events = events
        self.handle: Optional[JobHandle] = None
        self.attempt = 0
        self.started_ts: Optional[float] = None
        self.outcomes: List[str] = []
        self.state = "pending"  # pending | running | ok | failed


class ReplicaSupervisor:
    """Run N serve replicas as child processes, each in its own run dir.

    Per replica: a single-host :class:`ClusterSpec` fanned through the
    launcher transport (LocalTransport in tests/simulation, SshTransport
    on a real slice), a non-blocking :class:`JobHandle`, and a
    ``logs/launch.jsonl`` event stream (``launch_attempt`` records with
    the hang/crash classification) so ``obs summarize --fleet`` sees the
    same per-attempt outcomes the single-job launcher records. A replica
    whose process exits non-zero is restarted in place up to
    ``max_restarts`` times; a hang exit (watchdog code 89) counts
    against the same budget but is recorded distinctly.
    """

    def __init__(self, specs: List[ReplicaProcSpec],
                 transport: Optional[Transport] = None,
                 max_restarts: int = 1,
                 poll_interval_s: float = 0.1):
        ids = [s.replica_id for s in specs]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {ids}")
        self.max_restarts = max_restarts
        self.poll_interval_s = poll_interval_s
        self._replicas: List[_SupervisedReplica] = []
        import os
        for spec in specs:
            os.makedirs(spec.run_dir, exist_ok=True)
            launcher = JobLauncher(transport=transport,
                                   max_restarts=0, tail_rank0=False)
            events = MetricsWriter(
                os.path.join(spec.run_dir, "logs", "launch.jsonl"),
                also_stdout=False, all_processes=True)
            self._replicas.append(
                _SupervisedReplica(spec, launcher, events))

    def _launch(self, sup: _SupervisedReplica) -> None:
        import os
        spec = sup.spec
        cluster = ClusterSpec(hosts=["localhost"])
        sup.handle = sup.launcher.start(
            cluster, spec.argv, os.path.join(spec.run_dir, "logs"),
            attempt=sup.attempt, extra_env=spec.env, cwd=spec.cwd)
        sup.started_ts = time.monotonic()
        sup.state = "running"

    def start(self) -> None:
        for sup in self._replicas:
            self._launch(sup)

    def poll(self) -> Dict[str, str]:
        """One supervision tick: reap exits, classify, restart within
        budget. Returns replica_id → state. Never blocks."""
        for sup in self._replicas:
            if sup.state != "running" or sup.handle is None:
                continue
            codes = sup.handle.poll()
            if any(c is None for c in codes):
                continue
            outcome = classify_attempt(codes)
            sup.handle.close()
            sup.outcomes.append(outcome)
            sup.events.write({
                "event": "launch_attempt", "attempt": sup.attempt,
                "replica": sup.spec.replica_id, "outcome": outcome,
                "exit_codes": codes, "success": outcome == "ok"})
            self._record_attempt_span(sup, outcome)
            if outcome == "ok":
                sup.state = "ok"
            elif sup.attempt < self.max_restarts:
                sup.attempt += 1
                self._launch(sup)
            else:
                sup.state = "failed"
        return self.status_states()

    def _record_attempt_span(self, sup: _SupervisedReplica,
                             outcome: str) -> None:
        """Retroactive ``launch.attempt`` span into the replica's own
        launch.jsonl, carrying the hang-vs-crash classification as a
        span attribute — `obs export` renders the attempt bar with the
        outcome attached, same shape as the single-job launcher's."""
        if not obs_enabled() or sup.started_ts is None:
            return
        tracer = get_tracer()
        sink = JsonlSink(sup.events)
        tracer.add_sink(sink)
        try:
            tracer.record_span(
                "launch.attempt", sup.started_ts,
                max(time.monotonic() - sup.started_ts, 0.0),
                ok=outcome == "ok", outcome=outcome,
                replica=sup.spec.replica_id, attempt=sup.attempt)
        finally:
            tracer.remove_sink(sink)

    def status_states(self) -> Dict[str, str]:
        return {sup.spec.replica_id: sup.state for sup in self._replicas}

    def status(self) -> List[Dict]:
        return [{"replica": sup.spec.replica_id, "state": sup.state,
                 "attempt": sup.attempt, "outcomes": list(sup.outcomes),
                 "run_dir": sup.spec.run_dir}
                for sup in self._replicas]

    def wait(self, timeout_s: Optional[float] = None) -> bool:
        """Poll until every replica is terminal (ok/failed) or the
        timeout; True iff all ended ok. On timeout the still-running
        replicas are left running (call :meth:`terminate` to reap)."""
        deadline = None if timeout_s is None else \
            time.time() + timeout_s
        while True:
            states = self.poll()
            if all(s in ("ok", "failed") for s in states.values()):
                return all(s == "ok" for s in states.values())
            if deadline is not None and time.time() >= deadline:
                return False
            time.sleep(self.poll_interval_s)

    def terminate(self) -> None:
        for sup in self._replicas:
            if sup.state == "running" and sup.handle is not None:
                sup.handle.terminate()
                sup.state = "failed"

    def close(self) -> None:
        for sup in self._replicas:
            sup.events.close()
