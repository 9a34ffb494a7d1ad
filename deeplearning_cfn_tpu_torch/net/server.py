"""Per-replica network server: one serve engine behind a socket.

Runs as a child process (``python -m deeplearning_cfn_tpu_torch.net.server``)
spawned through the launch/ Transport + ReplicaSupervisor machinery —
the supervisor's hang-vs-crash classification and bounded restart apply
to it unchanged, because from the launcher's point of view this is just
another single-host job.

Lifecycle (the readiness barrier):

1. resolve the device ``--accelerator`` names (``gpu``, the default —
   the CUDA card, raising without one — or ``cpu``),
2. build the tiny NMT engine of :func:`tiny_recipe_engine` on it, its
   weights drawn from a ``torch.Generator`` seeded with ``--seed`` (two
   children with the same seed on the same kind of device hold
   bit-identical weights → cross-process token parity is by
   construction),
3. warm it (submit one full-budget request, drain, release a parked
   prefill) so every fused decode shape is compiled OUTSIDE any timed
   window,
4. only THEN bind the listen socket. A client's first successful
   connect therefore means "engine ready" — no separate readiness RPC.

The serve loop is autonomous: the server steps its own engine whenever
it has work, which is the entire point of the net/ subsystem — N
replicas really do decode in parallel, one process each, instead of
taking turns inside one router thread. Clients observe progress through
TOKENS push frames (full request snapshot per update; budgets are tens
of tokens, so full-list is simpler than deltas and cannot drift).

Shutdown is deadline-honest: SIGTERM (or a DRAIN frame) stops new
admissions — submits are refused with a typed ``draining`` error —
while in-flight streams finish; the process exits 0 when idle or when
``--drain-grace-s`` expires, whichever is first. Its last line names the
attention kernel's launches in this process (the parent's counters do not
see a child's).

The port of the JAX package's ``net/server.py``: ``ReplicaServer`` is a
copy; the device comes from ``--accelerator`` where the JAX child pins
``JAX_PLATFORMS``, and the tiny recipe's weights are torch-seeded (they
are not the JAX package's, and nothing needs them to be).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time
from typing import Dict, List, Optional, Tuple

from .codec import FrameReader, FrameType, CodecError, encode_frame, \
    error_header, pack_artifact, unpack_artifact
from .transport import Connection, ConnectionClosed, listen
# The seeded bench-recipe geometry every server child builds; CLI
# callers validate request token ids against TINY_VOCAB.
from ..serve.bench import TINY_MAX_LEN, TINY_VOCAB  # noqa: F401
from ..serve.handoff import HandoffCorruptError
from ..serve.queue import DeadlineExceededError, OverloadError


class _Watch:
    """One client connection and the request streams it subscribed to."""

    def __init__(self, conn: Connection):
        self.conn = conn
        self.reader = FrameReader()
        # request_id → last published (state, n_tokens, preemptions,
        # prefill_chunks) so only actual progress crosses the wire.
        self.streams: Dict[str, Tuple] = {}


class ReplicaServer:
    """Serve one engine over a listening socket until drained."""

    def __init__(self, engine, address: str, replica_id: str = "replica",
                 drain_grace_s: float = 30.0, idle_wait_s: float = 0.01,
                 clock=time.monotonic):
        self.engine = engine
        self.replica_id = replica_id
        self.drain_grace_s = drain_grace_s
        self.idle_wait_s = idle_wait_s
        self.clock = clock
        self.steps = 0
        self._draining = False
        self._drain_deadline: Optional[float] = None
        self._watches: List[_Watch] = []
        # Bind LAST (see module docstring): the engine behind this
        # server is already built and warm when listen() succeeds.
        self._listen_sock, self.address = listen(address)

    # -- lifecycle ----------------------------------------------------------

    def install_signal_handlers(self) -> None:
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: self.request_drain())

    def request_drain(self) -> None:
        if not self._draining:
            self._draining = True
            self._drain_deadline = self.clock() + self.drain_grace_s

    def _busy(self) -> bool:
        """Work the engine can make progress on THIS tick. Parked
        handoffs deliberately excluded: stepping an engine whose only
        work is parked streams is a hot no-op."""
        return self.engine.queue.depth > 0 \
            or self.engine.active_requests > 0

    def _drained(self) -> bool:
        """Drain-exit: nothing running, queued, OR parked — a parked
        stream's KV blocks must stay alive until the router moves it."""
        return not self._busy() \
            and getattr(self.engine, "handoff_pending", 0) == 0

    def serve_forever(self) -> int:
        """The replica loop; returns the process exit code."""
        try:
            while True:
                if self._draining:
                    if self._drained():
                        return 0
                    if self.clock() >= self._drain_deadline:
                        return 0
                busy = self._busy()
                self._pump(0.0 if busy else self.idle_wait_s)
                if self._busy():
                    self.engine.step()
                    self.steps += 1
                self._publish()
        finally:
            self._close()

    def tick(self) -> None:
        """One loop iteration (tests drive the server in-process)."""
        self._pump(0.0)
        if self._busy():
            self.engine.step()
            self.steps += 1
        self._publish()

    def _close(self) -> None:
        for w in self._watches:
            w.conn.close()
        self._watches = []
        try:
            self._listen_sock.close()
        except OSError:
            pass

    # -- socket pump --------------------------------------------------------

    def _pump(self, wait_s: float) -> None:
        import select

        socks = [self._listen_sock] + [w.conn for w in self._watches
                                       if not w.conn.closed]
        try:
            ready, _, _ = select.select(socks, [], [], wait_s)
        except (ValueError, OSError):
            ready = []
        for sock in ready:
            if sock is self._listen_sock:
                self._accept()
            else:
                self._read(sock)
        self._watches = [w for w in self._watches if not w.conn.closed]

    def _accept(self) -> None:
        try:
            raw, _ = self._listen_sock.accept()
        except (BlockingIOError, OSError):
            return
        raw.setblocking(True)
        self._watches.append(
            _Watch(Connection(raw, name=f"{self.replica_id}-client")))

    def _read(self, conn: Connection) -> None:
        watch = next((w for w in self._watches if w.conn is conn), None)
        if watch is None:
            return
        try:
            while conn.poll(0.0):
                data = conn.recv()
                if data is None:
                    break
                watch.reader.feed(data)
            for frame in watch.reader:
                self._dispatch(watch, frame)
        except ConnectionClosed:
            # Client gone. Its in-flight streams keep decoding — the
            # router owns retry/evacuation policy, not this server.
            conn.close()
        except CodecError:
            # Framing lost (corrupt/oversized frame): the stream cannot
            # be re-synchronized — drop the connection.
            conn.close()

    def _send(self, watch: _Watch, data: bytes) -> None:
        try:
            watch.conn.send(data)
        except ConnectionClosed:
            pass

    def _error(self, watch: _Watch, exc: BaseException,
               rid: Optional[str]) -> None:
        self._send(watch, encode_frame(
            FrameType.ERROR, error_header(exc, rid=rid)))

    # -- frame dispatch ------------------------------------------------------

    def _dispatch(self, watch: _Watch, frame) -> None:
        h = frame.header
        rid = h.get("rid")
        try:
            if frame.ftype == FrameType.SUBMIT:
                self._on_submit(watch, h, rid)
            elif frame.ftype == FrameType.CANCEL:
                ok = self.engine.cancel(h["request_id"])
                self._send(watch, encode_frame(
                    FrameType.CANCEL_OK, {"rid": rid, "ok": bool(ok)}))
            elif frame.ftype == FrameType.HEALTH:
                self._send(watch, encode_frame(
                    FrameType.HEALTH_OK,
                    {"rid": rid, "health": self.health()}))
            elif frame.ftype == FrameType.HANDOFF_EXPORT:
                artifact = self.engine.export_handoff(h["request_id"])
                self._send(watch, encode_frame(
                    FrameType.HANDOFF_EXPORT_OK, {"rid": rid},
                    body=pack_artifact(artifact)))
            elif frame.ftype == FrameType.HANDOFF_IMPORT:
                artifact = unpack_artifact(frame.body)
                req = self.engine.import_handoff(
                    artifact, h["request_id"],
                    trace_id=h.get("trace_id"),
                    **{k: h[k] for k in ("tenant", "qos_class")
                       if h.get(k) is not None})
                watch.streams.setdefault(req.id, ())
                self._send(watch, encode_frame(
                    FrameType.HANDOFF_IMPORT_OK,
                    {"rid": rid, "req": self._snapshot(req)}))
            elif frame.ftype == FrameType.HANDOFF_RELEASE:
                self.engine.release_handoff(h["request_id"])
                self._send(watch, encode_frame(
                    FrameType.HANDOFF_RELEASE_OK, {"rid": rid}))
            elif frame.ftype == FrameType.DRAIN:
                self.request_drain()
                self._send(watch, encode_frame(
                    FrameType.DRAIN_OK, {"rid": rid}))
            else:
                self._error(watch, ValueError(
                    f"unexpected frame {frame.name}"), rid)
        except (OverloadError, DeadlineExceededError, KeyError,
                HandoffCorruptError, ValueError) as e:
            self._error(watch, e, rid)
        except Exception as e:  # noqa: BLE001 — protocol boundary
            self._error(watch, e, rid)

    def _on_submit(self, watch: _Watch, h: Dict,
                   rid: Optional[str]) -> None:
        if self._draining:
            # Typed refusal: to a router mid-placement this means "try
            # the next candidate" — OverloadError semantics, surfaced
            # with its own code so operators can tell drain from load.
            eh = error_header(
                OverloadError(self.engine.queue.depth,
                              self.engine.queue.max_depth), rid=rid)
            eh["code"] = "draining"
            eh["message"] = f"replica {self.replica_id} is draining"
            self._send(watch, encode_frame(FrameType.ERROR, eh))
            return
        kwargs = {k: h[k] for k in
                  ("max_new_tokens", "beam_size", "deadline_s",
                   "request_id", "trace_id", "tenant", "qos_class")
                  if h.get(k) is not None}
        req = self.engine.submit(list(h["src_ids"]), **kwargs)
        watch.streams.setdefault(req.id, ())
        self._send(watch, encode_frame(
            FrameType.SUBMIT_OK, {"rid": rid, "req": self._snapshot(req)}))

    # -- token streaming -----------------------------------------------------

    @staticmethod
    def _snapshot(req) -> Dict:
        """Full request snapshot: the tokens AND the lifecycle
        timestamps. CLOCK_MONOTONIC is system-wide on Linux, so these
        timestamps and the parent router's clock share one timeline —
        the phase ledger stays valid across the process boundary."""
        return {
            "id": req.id,
            "state": req.state.value,
            "tokens": [int(t) for t in req.tokens],
            "submitted_at": req.submitted_at,
            "admitted_at": req.admitted_at,
            "first_token_at": req.first_token_at,
            "finished_at": req.finished_at,
            "prefill_s": req.prefill_s,
            "prefill_chunks": req.prefill_chunks,
            "preemptions": req.preemptions,
            "preempted_s": req.preempted_s,
            "beam_size": req.beam_size,
            "max_new_tokens": req.max_new_tokens,
            "deadline": req.deadline,
            "tenant": req.tenant,
            "qos_class": req.qos_class,
            "trace_id": req.trace_id,
        }

    def _publish(self) -> None:
        for watch in self._watches:
            if watch.conn.closed:
                continue
            for req_id in list(watch.streams):
                self._publish_one(watch, req_id)

    def _publish_one(self, watch: _Watch, req_id: str) -> None:
        try:
            req = self.engine.poll(req_id)
        except KeyError:
            watch.streams.pop(req_id, None)
            return
        key = (req.state.value, len(req.tokens), req.preemptions,
               req.prefill_chunks)
        if key == watch.streams.get(req_id):
            return
        watch.streams[req_id] = key
        self._send(watch, encode_frame(
            FrameType.TOKENS, {"req": self._snapshot(req)}))
        if req.finished:
            watch.streams.pop(req_id, None)

    def health(self) -> Dict:
        m = self.engine.metrics
        from ..serve.metrics import percentile
        return {
            "replica": self.replica_id,
            "state": "draining" if self._draining else "healthy",
            "phase": getattr(self.engine, "phase", "both"),
            "queue_depth": self.engine.queue.depth,
            "queue_max_depth": self.engine.queue.max_depth,
            "active_requests": self.engine.active_requests,
            "handoff_pending": getattr(self.engine, "handoff_pending", 0),
            "capacity": self.engine.capacity,
            "step_latency_p50_s": percentile(m.step_latency_s, 50),
            "tokens_generated": m.tokens_generated,
            "retry_after_hint_s": m.last_retry_after_s,
            "steps": self.steps,
            "pid": os.getpid(),
        }


# -- child-process entry point -----------------------------------------------

def tiny_recipe_engine(slots: int = 2, src_len: int = 8,
                       max_new_tokens: int = 4, queue_depth: int = 16,
                       decode_window: int = 4, kv_block_size: int = 0,
                       phase: str = "both", seed: int = 0,
                       device="gpu"):
    """The seeded tiny-NMT engine every server child serves: the bench's
    tiny NMT (``serve.bench.tiny_model``: Flax's init distributions drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``) — the
    in-process reference of a process fleet builds the same engine."""
    from ..runtime.platform import resolve_device
    from ..serve.bench import tiny_model
    from ..serve.engine import Engine

    model = tiny_model(seed, resolve_device(device))
    return Engine(model, capacity=slots, max_src_len=src_len,
                  queue_depth=queue_depth,
                  default_max_new_tokens=max_new_tokens,
                  decode_window=decode_window,
                  kv_block_size=kv_block_size, phase=phase)


def _warmup(engine, args) -> None:
    """Compile every shape the timed run decodes through, before the
    listen socket exists (see the readiness barrier)."""
    src = [int(t) for t in args.warmup_src.split(",") if t.strip()] \
        if args.warmup_src else [5, 4, 3]
    req = engine.submit(src[:args.src_len],
                        max_new_tokens=args.max_new_tokens)
    engine.run_until_drained()
    if args.phase == "prefill" and engine.handoff_ready(req.id):
        engine.release_handoff(req.id)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="deeplearning_cfn_tpu_torch.net.server",
        description="one tiny-NMT serve engine behind a socket")
    ap.add_argument("--listen", required=True,
                    help="unix:///path.sock or tcp://host:port "
                         "(tcp port 0 = ephemeral)")
    ap.add_argument("--replica-id", default="replica")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--src-len", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=4)
    ap.add_argument("--queue-depth", type=int, default=16)
    ap.add_argument("--decode-window", type=int, default=4)
    ap.add_argument("--kv-block-size", type=int, default=0)
    ap.add_argument("--phase", default="both",
                    choices=["both", "prefill", "decode"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--accelerator", default="gpu", choices=["gpu", "cpu"],
                    help="the device the engine runs on (gpu: the CUDA "
                         "card, raising without one)")
    ap.add_argument("--warmup-src", default="",
                    help="comma-separated warmup token ids")
    ap.add_argument("--drain-grace-s", type=float, default=30.0)
    ap.add_argument("--run-dir", default="",
                    help="write this replica's span shard to "
                         "<run-dir>/metrics.jsonl")
    ap.add_argument("--address-file", default="",
                    help="write the resolved listen address here after "
                         "binding (ephemeral-port discovery)")
    args = ap.parse_args(argv)

    writer = None
    if args.run_dir:
        from ..metrics.jsonl import MetricsWriter
        from ..obs.sinks import JsonlSink
        from ..obs.trace import get_tracer

        os.makedirs(args.run_dir, exist_ok=True)
        # Append-mode writer: a supervisor-restarted replica continues
        # the same shard instead of truncating its predecessor's spans.
        writer = MetricsWriter(
            os.path.join(args.run_dir, "metrics.jsonl"),
            also_stdout=False, all_processes=True)
        get_tracer().add_sink(JsonlSink(writer))

    engine = tiny_recipe_engine(
        slots=args.slots, src_len=args.src_len,
        max_new_tokens=args.max_new_tokens, queue_depth=args.queue_depth,
        decode_window=args.decode_window, kv_block_size=args.kv_block_size,
        phase=args.phase, seed=args.seed, device=args.accelerator)
    _warmup(engine, args)
    from ..ops.attention import flash_attention_forward as fwd
    from ..ops.attention import zero_launch_counts

    # The exit line reports the requests' launches, not the warm-up's.
    zero_launch_counts()
    work0 = (engine.encoder_forwards, engine.decoder_steps)
    server = ReplicaServer(engine, args.listen,
                           replica_id=args.replica_id,
                           drain_grace_s=args.drain_grace_s)
    if args.address_file:
        tmp = args.address_file + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(server.address)
        os.replace(tmp, args.address_file)
    print(f"[net.server] {args.replica_id} ready on {server.address} "
          f"(pid {os.getpid()})", flush=True)
    server.install_signal_handlers()
    rc = server.serve_forever()
    if writer is not None:
        engine.metrics.emit(writer, replica=args.replica_id,
                            phase=args.phase)
        writer.close()
    print(f"[net.server] {args.replica_id} exiting rc {rc} after "
          f"{server.steps} steps; flash kernel launches {fwd.launches} "
          f"{dict(fwd.variant_launches)} over "
          f"{engine.encoder_forwards - work0[0]} encoder forwards and "
          f"{engine.decoder_steps - work0[1]} decoder steps", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
