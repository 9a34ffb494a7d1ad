"""Client side of the network serving plane: RemoteReplica.

A :class:`RemoteReplica` wears the exact duck type of
``fleet.replica.EngineReplica`` — id/state/phase/crashed/steps, the
routable/steppable/busy properties, submit/poll/cancel/step, the
handoff quartet, ``record_evacuation`` and ``health()`` — so
``fleet/router.py`` (policies, circuit breaker, backlog retry, brownout,
disagg handoff orchestration) runs over sockets UNCHANGED. The router
never learns the replica is a different process.

Three impedance mismatches are absorbed here:

- **step() is a pump, not a compute tick.** The server steps its own
  engine autonomously (that is the whole point — real parallelism).
  The client's ``step()`` drains pending TOKENS pushes, applies them to
  client-side mirror ``Request`` objects, and returns the token
  progress it OBSERVED, which is all the router's wedge/progress
  accounting needs.
- **poll() reads a mirror.** Every TOKENS push carries a full request
  snapshot (tokens + lifecycle timestamps). CLOCK_MONOTONIC is
  system-wide on Linux, so the server-stamped ``admitted_at``/
  ``finished_at``/``prefill_s`` land directly in the router's phase
  ledger without translation.
- **a dead socket is a dead replica.** ConnectionClosed anywhere maps
  to ``ReplicaCrashed`` → the router marks the replica DOWN and
  evacuates, exactly as for an in-process injected crash. When the
  supervisor restarts the child, :meth:`try_connect` readmits it:
  state back to HEALTHY, mirrors cleared (the router already re-placed
  them), fresh framing.

A copy of the JAX package's ``net/client.py`` (it imports nothing of
JAX).
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, Optional

from .codec import FrameReader, FrameType, CodecError, encode_frame, \
    pack_artifact, raise_error_header, unpack_artifact
from .transport import Connection, ConnectionClosed, connect
from ..fleet.replica import ReplicaCrashed, ReplicaState
from ..obs.trace import get_tracer, obs_enabled
from ..serve.queue import Request, RequestState

_RID_COUNTER = itertools.count(1)


class _RemoteQueueView:
    """Backed by the last HEALTH_OK snapshot — Router._place reads
    ``r.engine.queue.depth``/``.max_depth`` directly."""

    def __init__(self, replica: "RemoteReplica"):
        self._replica = replica

    @property
    def depth(self) -> int:
        return int(self._replica.last_health.get("queue_depth", 0))

    @property
    def max_depth(self) -> int:
        return int(self._replica.last_health.get("queue_max_depth", 1))


class _RemoteEngineView:
    """The slice of the Engine surface the router actually touches,
    served from the cached health snapshot."""

    def __init__(self, replica: "RemoteReplica"):
        self._replica = replica
        self.queue = _RemoteQueueView(replica)

    @property
    def capacity(self) -> int:
        return int(self._replica.last_health.get("capacity", 1))

    @property
    def active_requests(self) -> int:
        return int(self._replica.last_health.get("active_requests", 0))

    @property
    def handoff_pending(self) -> int:
        return int(self._replica.last_health.get("handoff_pending", 0))

    @property
    def phase(self) -> str:
        return self._replica.phase


class RemoteReplica:
    """One replica-server connection, duck-typed as EngineReplica."""

    def __init__(self, replica_id: str, address: str, phase: str = "both",
                 connect_timeout_s: float = 5.0,
                 connect_retry_deadline_s: float = 60.0,
                 rpc_timeout_s: float = 30.0,
                 step_wait_s: float = 0.02,
                 reconnect_interval_s: float = 0.25,
                 clock=time.monotonic):
        self.id = replica_id
        self.address = address
        self.phase = phase
        self.state = ReplicaState.DOWN      # until connect() succeeds
        self.crashed = False
        self.steps = 0
        self.trace_sink = None              # router-side shard (evacuations)
        self.clock = clock
        self.connect_timeout_s = connect_timeout_s
        self.connect_retry_deadline_s = connect_retry_deadline_s
        self.rpc_timeout_s = rpc_timeout_s
        self.step_wait_s = step_wait_s
        self.reconnect_interval_s = reconnect_interval_s
        self.last_health: Dict = {}
        self.engine = _RemoteEngineView(self)
        self._conn: Optional[Connection] = None
        self._reader = FrameReader()
        self._mirrors: Dict[str, Request] = {}
        self._orphan_snaps: Dict[str, Dict] = {}
        self._last_reconnect = 0.0

    # -- connection lifecycle ------------------------------------------------

    def connect(self) -> "RemoteReplica":
        """Block until the replica server accepts — the readiness
        barrier: the server binds only after engine build + warmup, so
        the first successful connect means "warm and ready"."""
        self._conn = connect(self.address, timeout_s=self.connect_timeout_s,
                             retry_deadline_s=self.connect_retry_deadline_s)
        self._reader = FrameReader()
        self.crashed = False
        self.state = ReplicaState.HEALTHY
        self.health()                       # prime the engine/queue view
        return self

    def try_connect(self) -> bool:
        """One cheap reconnect attempt (rate-limited by the caller via
        ``reconnect_interval_s``) — readmits a supervisor-restarted
        child. Mirrors are dropped: the router evacuated those requests
        when the socket died; this process has no copy of them."""
        now = self.clock()
        if now - self._last_reconnect < self.reconnect_interval_s:
            return False
        self._last_reconnect = now
        try:
            conn = connect(self.address, timeout_s=self.connect_timeout_s,
                           retry_deadline_s=0.0)
        except OSError:
            return False
        if self._conn is not None:
            self._conn.close()
        self._conn = conn
        self._reader = FrameReader()
        self._mirrors = {}
        self._orphan_snaps = {}
        self.crashed = False
        self.state = ReplicaState.HEALTHY
        # Raw HEALTH round-trip — NOT self.health(), which swallows
        # RPC failures by design (stats must always render). True must
        # mean "verified round-trip": without this, a reconnect could
        # be counted while the very RPC that probed it flipped the
        # state machine back to DOWN.
        try:
            reply = self._rpc(FrameType.HEALTH, {},
                              timeout_s=min(self.rpc_timeout_s, 5.0))
            self.last_health = dict(reply.header.get("health") or {})
        except (ReplicaCrashed, TimeoutError):
            # Not readmitted. Close the socket and leave the state
            # machine DOWN so the router keeps tending this replica —
            # a half-ready connection must not look routable, and a
            # late reply on the next attempt's fresh stream would
            # desync the reader.
            if self._conn is not None:
                self._conn.close()
            self.crashed = True
            self.state = ReplicaState.DOWN
            return False
        return True

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()

    def _on_lost(self, why: str) -> ReplicaCrashed:
        """A dead socket is a dead replica — same observable effect as
        SIGKILL, because usually it IS SIGKILL."""
        if self._conn is not None:
            self._conn.close()
        self.crashed = True
        self.state = ReplicaState.DOWN
        return ReplicaCrashed(
            f"replica {self.id} lost ({why}) at {self.address}")

    # -- routing surface (EngineReplica duck type) ---------------------------

    @property
    def routable(self) -> bool:
        return self.state is ReplicaState.HEALTHY and not self.crashed

    @property
    def steppable(self) -> bool:
        return self.state in (ReplicaState.HEALTHY, ReplicaState.DRAINING) \
            and not self.crashed

    @property
    def busy(self) -> bool:
        # Any unfinished mirror — including parked PREFILLED streams
        # (released mirrors are dropped, so a completed handoff does
        # not pin this replica busy forever).
        return any(not r.finished for r in self._mirrors.values())

    # -- wire plumbing -------------------------------------------------------

    def _pump(self, timeout_s: float) -> int:
        """Read whatever the socket has, apply TOKENS pushes, queue the
        rest; returns observed token/state progress."""
        if self._conn is None or self._conn.closed:
            raise self._on_lost("not connected")
        progress = 0
        try:
            data = self._conn.recv(timeout_s=timeout_s)
            while data is not None:
                self._reader.feed(data)
                data = self._conn.recv(timeout_s=0.0) \
                    if self._conn.poll(0.0) else None
            for frame in self._drain_frames():
                progress += self._handle_push(frame)
        except ConnectionClosed as e:
            raise self._on_lost(str(e)) from e
        except CodecError as e:
            raise self._on_lost(f"corrupt stream: {e}") from e
        return progress

    def _drain_frames(self):
        frames = []
        while True:
            frame = self._reader.next()
            if frame is None:
                return frames
            frames.append(frame)

    def _handle_push(self, frame) -> int:
        if frame.ftype == FrameType.TOKENS:
            return self._apply(frame.header.get("req") or {})
        # Non-TOKENS frame outside an RPC wait: a straggler reply from
        # an RPC that timed out. Drop it — its rid matches nothing.
        return 0

    def _apply(self, snap: Dict) -> int:
        req = self._mirrors.get(snap.get("id"))
        if req is None:
            # A push can race ahead of its mirror: the server sends
            # SUBMIT_OK and may step the request to DONE (one fused
            # window can cover the whole budget) before this process is
            # scheduled again, so the terminal snapshot arrives in the
            # same batch as the reply — BEFORE _mirror() runs. Stash it;
            # _mirror() replays the latest stashed snapshot. Dropping it
            # would wedge the request forever: terminal snapshots are
            # sent exactly once.
            self._orphan_snaps[snap.get("id")] = snap
            return 0
        before = (len(req.tokens), req.state)
        req.state = RequestState(snap["state"])
        req.tokens = [int(t) for t in snap["tokens"]]
        req.submitted_at = snap["submitted_at"]
        req.admitted_at = snap["admitted_at"]
        req.first_token_at = snap["first_token_at"]
        req.finished_at = snap["finished_at"]
        req.prefill_s = snap.get("prefill_s")
        req.prefill_chunks = int(snap.get("prefill_chunks") or 0)
        req.preemptions = int(snap.get("preemptions") or 0)
        req.preempted_s = float(snap.get("preempted_s") or 0.0)
        delta = len(req.tokens) - before[0]
        # State transitions with no new tokens (→PREFILLED, →DONE on an
        # empty stream) still count as progress for wedge detection.
        return max(delta, 0) + (1 if req.state is not before[1] else 0)

    def _mirror(self, snap: Dict, src_ids=()) -> Request:
        req = Request(id=snap["id"], src_ids=list(src_ids),
                      max_new_tokens=int(snap.get("max_new_tokens") or 0),
                      beam_size=int(snap.get("beam_size") or 1),
                      deadline=snap.get("deadline"),
                      trace_id=snap.get("trace_id"))
        if snap.get("tenant") is not None:
            req.tenant = snap["tenant"]
        if snap.get("qos_class"):
            req.qos_class = snap["qos_class"]
        self._mirrors[req.id] = req
        self._apply(snap)
        # Snapshots are full-state, so the latest stashed push (if any
        # raced ahead of this mirror — see _apply) supersedes the reply
        # snapshot wholesale.
        orphan = self._orphan_snaps.pop(req.id, None)
        if orphan is not None:
            self._apply(orphan)
        return req

    def _rpc(self, ftype: int, header: Dict, body: bytes = b"",
             timeout_s: Optional[float] = None):
        """Send one request frame, pump until its reply arrives.
        TOKENS pushes interleaved with the reply are applied on the
        way. ERROR replies re-raise the server's typed exception."""
        if self._conn is None or self._conn.closed:
            raise self._on_lost("not connected")
        rid = f"{self.id}-{next(_RID_COUNTER)}"
        header = dict(header)
        header["rid"] = rid
        deadline = self.clock() + (timeout_s if timeout_s is not None
                                   else self.rpc_timeout_s)
        try:
            self._conn.send(encode_frame(ftype, header, body))
        except ConnectionClosed as e:
            raise self._on_lost(str(e)) from e
        while True:
            remaining = deadline - self.clock()
            if remaining <= 0:
                raise TimeoutError(
                    f"replica {self.id}: no reply to "
                    f"{FrameType.name(ftype)} within "
                    f"{timeout_s or self.rpc_timeout_s:.1f}s")
            try:
                data = self._conn.recv(timeout_s=min(remaining, 0.05))
                if data is not None:
                    self._reader.feed(data)
                # Apply EVERY non-reply frame before returning: a batch
                # can carry TOKENS pushes BEHIND the reply, and a
                # terminal snapshot is sent exactly once — returning
                # early would drop it on the floor and the mirror would
                # never finish.
                reply = None
                for frame in self._drain_frames():
                    if reply is None and frame.header.get("rid") == rid:
                        reply = frame
                    else:
                        self._handle_push(frame)
                if reply is not None:
                    if reply.ftype == FrameType.ERROR:
                        raise_error_header(reply.header)
                    return reply
            except ConnectionClosed as e:
                raise self._on_lost(str(e)) from e
            except CodecError as e:
                raise self._on_lost(f"corrupt stream: {e}") from e

    # -- request lifecycle ---------------------------------------------------

    def submit(self, src_ids, **kwargs):
        if self.crashed:
            raise ReplicaCrashed(f"replica {self.id} is down")
        header = {"src_ids": [int(t) for t in src_ids]}
        for key in ("max_new_tokens", "beam_size", "deadline_s",
                    "request_id", "trace_id", "tenant", "qos_class"):
            if kwargs.get(key) is not None:
                header[key] = kwargs[key]
        reply = self._rpc(FrameType.SUBMIT, header)
        return self._mirror(reply.header["req"], src_ids=src_ids)

    def poll(self, request_id: str) -> Request:
        return self._mirrors[request_id]

    def cancel(self, request_id: str) -> bool:
        if self.crashed:
            return False
        try:
            reply = self._rpc(FrameType.CANCEL, {"request_id": request_id})
        except (ReplicaCrashed, TimeoutError):
            return False
        return bool(reply.header.get("ok"))

    def step(self) -> int:
        """Pump the token stream. Waits up to ``step_wait_s`` for the
        first bytes (the server computes in parallel — a short poll
        keeps the router tick from spinning hot), then drains whatever
        arrived without waiting again."""
        if self.crashed:
            raise ReplicaCrashed(f"replica {self.id} is down")
        progress = self._pump(self.step_wait_s if self.busy else 0.0)
        self.steps += 1
        return progress

    # -- KV handoff (bytes travel the wire, no store round-trip) -------------

    def handoff_ready(self, request_id: str) -> bool:
        if self.crashed:
            return False
        req = self._mirrors.get(request_id)
        return req is not None and req.state is RequestState.PREFILLED

    def export_handoff_bytes(self, request_id: str) -> bytes:
        if self.crashed:
            raise ReplicaCrashed(f"replica {self.id} is down")
        reply = self._rpc(FrameType.HANDOFF_EXPORT,
                          {"request_id": request_id})
        return reply.body

    def export_handoff(self, request_id: str):
        return unpack_artifact(self.export_handoff_bytes(request_id))

    def import_handoff_bytes(self, data: bytes, request_id: str,
                             trace_id=None, **qos_kwargs) -> Request:
        if self.crashed:
            raise ReplicaCrashed(f"replica {self.id} is down")
        header = {"request_id": request_id}
        if trace_id is not None:
            header["trace_id"] = trace_id
        for key in ("tenant", "qos_class"):
            if qos_kwargs.get(key) is not None:
                header[key] = qos_kwargs[key]
        reply = self._rpc(FrameType.HANDOFF_IMPORT, header, body=data)
        return self._mirror(reply.header["req"])

    def import_handoff(self, artifact, request_id: str, trace_id=None,
                       **qos_kwargs) -> Request:
        return self.import_handoff_bytes(
            pack_artifact(artifact), request_id, trace_id=trace_id,
            **qos_kwargs)

    def release_handoff(self, request_id: str) -> None:
        if self.crashed:
            raise ReplicaCrashed(f"replica {self.id} is down")
        self._rpc(FrameType.HANDOFF_RELEASE, {"request_id": request_id})
        # Drop the mirror: the parked stream is gone server-side, and a
        # retained PREFILLED mirror would pin this replica busy forever.
        self._mirrors.pop(request_id, None)
        self._orphan_snaps.pop(request_id, None)

    # -- health / drain / observability --------------------------------------

    def health(self) -> Dict:
        """Live health RPC; falls back to the last snapshot when the
        replica is down (EngineReplica.health always answers — it reads
        a local engine — and Router.stats() relies on that), so a
        SIGKILL'd replica reports its final observed load, marked with
        the CLIENT-side state machine's DOWN."""
        if not self.crashed and self._conn is not None \
                and not self._conn.closed:
            try:
                reply = self._rpc(FrameType.HEALTH, {},
                                  timeout_s=min(self.rpc_timeout_s, 5.0))
                self.last_health = dict(reply.header.get("health") or {})
            except (ReplicaCrashed, TimeoutError):
                pass
        h = dict(self.last_health)
        # The router's policies key on the CLIENT-side state machine
        # (HEALTHY/DRAINING/...), not the server's self-report.
        h["state"] = self.state.value
        h["replica"] = self.id
        h.setdefault("queue_depth", 0)
        h.setdefault("active_requests", 0)
        h.setdefault("tokens_generated", 0)
        self.last_health = h
        return h

    def drain(self) -> None:
        """Ask the server to refuse new submits and exit when idle."""
        self._rpc(FrameType.DRAIN, {})

    def record_evacuation(self, req, now: float) -> None:
        """Same retroactive ``serve.request`` span EngineReplica writes,
        into the router-side sink for this replica's shard — the dead
        child can't write it, and the merged timeline still must show
        the abandoned attempt."""
        if not obs_enabled():
            return
        t0 = getattr(req, "submitted_at", None)
        if not isinstance(t0, (int, float)):
            return
        tracer = get_tracer()
        if self.trace_sink is not None:
            tracer.add_sink(self.trace_sink)
        try:
            tracer.record_span(
                "serve.request", t0, max(now - t0, 0.0), ok=False,
                request_id=getattr(req, "id", None),
                trace_id=getattr(req, "trace_id", None)
                or getattr(req, "id", None),
                state="evacuated", replica=self.id,
                tokens=len(getattr(req, "tokens", ()) or ()))
        finally:
            if self.trace_sink is not None:
                tracer.remove_sink(self.trace_sink)
