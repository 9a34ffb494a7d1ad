"""Async front door: many client connections, one fleet, token streams.

The front door is the fleet's public socket. It multiplexes concurrent
client connections (loadgen drives it open-loop over real sockets) onto
the router, and streams tokens back as they decode — same frame
vocabulary as the per-replica servers, so one codec serves both planes:

    client ──SUBMIT──▶ front door ──router.submit──▶ replica sockets
    client ◀─TOKENS──  front door ◀──router.step───  (autonomous)

Concurrency model — one thread touches the router, ever:

- An asyncio event loop runs in a background thread. Connection
  handlers AND the stepping task are coroutines on that loop, so every
  router call happens loop-thread-only; no locks.
- The stepping task ticks ``router.step()`` continuously and publishes
  request snapshots to subscribed connections on change.
- Backpressure: each connection has a BOUNDED outbound queue. When a
  slow client fills it, intermediate snapshots are SKIPPED — every
  TOKENS frame carries the full cumulative token list, so dropping an
  intermediate frame loses granularity, never tokens.
- Overload is a first-class reply: ``FleetOverloadError`` /
  ``RateLimitError`` from ``router.submit`` become typed ERROR frames
  carrying ``retry_after_s`` and — while the fleet is browned out —
  the degradation controller's ``recovery_horizon_s``, round-tripped
  losslessly by :func:`~.codec.raise_error_header` client-side.

A copy of the JAX package's ``net/frontdoor.py`` (it imports nothing of
JAX).
"""

from __future__ import annotations

import asyncio
import threading
from typing import Dict, Optional, Tuple

from .codec import FrameReader, FrameType, CodecError, encode_frame, \
    error_header
from .transport import parse_address
from ..fleet.router import FleetOverloadError, NoReplicasError
from ..serve.queue import OverloadError


class _ClientConn:
    __slots__ = ("writer", "reader", "outbox", "streams")

    def __init__(self, writer, max_queue: int):
        self.writer = writer
        self.reader = FrameReader()
        self.outbox: asyncio.Queue = asyncio.Queue(maxsize=max_queue)
        # logical rid → last published (state, n_tokens)
        self.streams: Dict[str, Tuple] = {}


class FrontDoor:
    """Serve the fleet on one listening socket until :meth:`stop`."""

    def __init__(self, router, address: str, max_queue: int = 64,
                 tick_interval_s: float = 0.002, on_tick=None):
        self.router = router
        self._requested_address = address
        self.address: Optional[str] = None   # resolved after start()
        self.max_queue = max_queue
        self.tick_interval_s = tick_interval_s
        self.on_tick = on_tick
        self.skipped_publishes = 0           # backpressure drops (frames)
        self.overload_rejects = 0
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._server = None
        self._conns: Dict[int, _ClientConn] = {}
        self._stopping = threading.Event()
        self._ready = threading.Event()
        self._startup_error: Optional[BaseException] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self, timeout_s: float = 30.0) -> str:
        self._thread = threading.Thread(
            target=self._thread_main, name="net-frontdoor", daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout_s):
            raise TimeoutError("front door failed to start in time")
        if self._startup_error is not None:
            raise self._startup_error
        return self.address

    def stop(self, timeout_s: float = 10.0) -> None:
        if self._loop is None:
            return
        self._stopping.set()
        if self._thread is not None:
            self._thread.join(timeout_s)

    def call(self, fn, timeout_s: float = 30.0):
        """Run ``fn(router)`` ON the loop thread (the only thread
        allowed to touch the router) and return its result."""
        async def _run():
            return fn(self.router)
        fut = asyncio.run_coroutine_threadsafe(_run(), self._loop)
        return fut.result(timeout_s)

    # -- loop thread ---------------------------------------------------------

    def _thread_main(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        try:
            loop.run_until_complete(self._main())
        finally:
            loop.close()

    async def _main(self) -> None:
        try:
            scheme, target = parse_address(self._requested_address)
            if scheme == "unix":
                import os
                if os.path.exists(target):
                    os.unlink(target)
                os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
                self._server = await asyncio.start_unix_server(
                    self._handle_conn, path=target)
                self.address = f"unix://{target}"
            else:
                host, port = target
                self._server = await asyncio.start_server(
                    self._handle_conn, host=host, port=port)
                port = self._server.sockets[0].getsockname()[1]
                self.address = f"tcp://{host}:{port}"
        except BaseException as e:  # surface bind errors to start()
            self._startup_error = e
            self._ready.set()
            return
        self._ready.set()
        stepping = asyncio.ensure_future(self._drive())
        try:
            await stepping
        finally:
            self._server.close()
            for conn in list(self._conns.values()):
                conn.writer.close()

    async def _drive(self) -> None:
        """The router's only caller: tick, publish, yield."""
        while not self._stopping.is_set():
            if self.on_tick is not None:
                self.on_tick(self.router)
            progress = self.router.step()
            self._publish()
            # Zero observed progress means the replica processes are
            # computing — sleep a tick instead of spinning the pumps.
            await asyncio.sleep(0 if progress > 0 else self.tick_interval_s)

    # -- per-connection handling ---------------------------------------------

    async def _handle_conn(self, reader, writer) -> None:
        conn = _ClientConn(writer, self.max_queue)
        self._conns[id(conn)] = conn
        sender = asyncio.ensure_future(self._send_loop(conn))
        try:
            while not self._stopping.is_set():
                data = await reader.read(1 << 16)
                if not data:
                    break
                conn.reader.feed(data)
                for frame in conn.reader:
                    self._dispatch(conn, frame)
        except (ConnectionError, CodecError, asyncio.CancelledError):
            pass
        finally:
            self._conns.pop(id(conn), None)
            sender.cancel()
            try:
                writer.close()
            except Exception:
                pass

    async def _send_loop(self, conn: _ClientConn) -> None:
        try:
            while True:
                data = await conn.outbox.get()
                conn.writer.write(data)
                await conn.writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            pass

    def _enqueue(self, conn: _ClientConn, data: bytes,
                 must: bool = False) -> None:
        """Reply frames (``must``) always land — the queue is only
        bounded against runaway token streams; TOKENS publishes are
        skipped when the client reads too slowly."""
        try:
            conn.outbox.put_nowait(data)
        except asyncio.QueueFull:
            if must:
                # Evict one streamed snapshot to make room for a reply.
                try:
                    conn.outbox.get_nowait()
                except asyncio.QueueEmpty:
                    pass
                try:
                    conn.outbox.put_nowait(data)
                    return
                except asyncio.QueueFull:
                    pass
            self.skipped_publishes += 1

    # -- frame dispatch (loop thread — router access is safe) ----------------

    def _dispatch(self, conn: _ClientConn, frame) -> None:
        h = frame.header
        rid = h.get("rid")
        try:
            if frame.ftype == FrameType.SUBMIT:
                self._on_submit(conn, h, rid)
            elif frame.ftype == FrameType.CANCEL:
                ok = self.router.cancel(h["request_id"])
                self._enqueue(conn, encode_frame(
                    FrameType.CANCEL_OK, {"rid": rid, "ok": bool(ok)}),
                    must=True)
            elif frame.ftype == FrameType.HEALTH:
                self._enqueue(conn, encode_frame(
                    FrameType.HEALTH_OK,
                    {"rid": rid, "health": self.router.stats()}),
                    must=True)
            else:
                self._enqueue(conn, encode_frame(FrameType.ERROR,
                              error_header(ValueError(
                                  f"unexpected frame {frame.name}"),
                                  rid=rid)), must=True)
        except Exception as e:  # noqa: BLE001 — protocol boundary
            self._enqueue(conn, encode_frame(
                FrameType.ERROR, self._error_header(e, rid)), must=True)

    def _error_header(self, exc: BaseException, rid) -> Dict:
        horizon = None
        degrade = getattr(self.router, "degrade", None)
        if isinstance(exc, (OverloadError, FleetOverloadError,
                            NoReplicasError)) \
                and degrade is not None and degrade.level > 0:
            # Brownout honesty at the front door: tell the client how
            # long until the fleet expects to step back up, not just
            # how long until a queue drains.
            horizon = degrade.recovery_horizon_s()
        if isinstance(exc, OverloadError):
            self.overload_rejects += 1
        h = error_header(exc, rid=rid, recovery_horizon_s=horizon)
        if isinstance(exc, NoReplicasError):
            h["code"] = "no_replicas"
        return h

    def _on_submit(self, conn: _ClientConn, h: Dict, rid) -> None:
        kwargs = {k: h[k] for k in
                  ("max_new_tokens", "beam_size", "deadline_s",
                   "request_id", "tenant", "qos_class", "affinity_key")
                  if h.get(k) is not None}
        logical = self.router.submit(
            [int(t) for t in h["src_ids"]], **kwargs)
        conn.streams[logical] = ()
        self._enqueue(conn, encode_frame(
            FrameType.SUBMIT_OK,
            {"rid": rid, "req": {"id": logical, "state": "queued",
                                 "tokens": []}}), must=True)

    # -- publishing ----------------------------------------------------------

    def _publish(self) -> None:
        for conn in list(self._conns.values()):
            for logical in list(conn.streams):
                self._publish_one(conn, logical)

    def _publish_one(self, conn: _ClientConn, logical: str) -> None:
        try:
            snap = self.router.result(logical)
        except KeyError:
            conn.streams.pop(logical, None)
            return
        snap["id"] = logical
        key = (snap.get("state"), len(snap.get("tokens") or ()))
        if key == conn.streams.get(logical):
            return
        terminal = snap.get("state") in ("done", "cancelled", "expired")
        conn.streams[logical] = key
        self._enqueue(conn, encode_frame(
            FrameType.TOKENS, {"req": snap}), must=terminal)
        if terminal:
            conn.streams.pop(logical, None)


class FrontDoorClient:
    """Blocking client for the front door — what loadgen's open-loop
    load threads (and the tests) speak. One socket, any number of
    in-flight streams; TTFB is observed CLIENT-side (submit send →
    first TOKENS frame with a token), which is the only honest place
    to measure it: it includes the wire, the front-door queue, routing,
    and the replica round-trip."""

    def __init__(self, address: str, connect_timeout_s: float = 5.0,
                 retry_deadline_s: float = 30.0, clock=None):
        import time as _time

        from .transport import connect
        self.clock = clock or _time.monotonic
        self._conn = connect(address, timeout_s=connect_timeout_s,
                             retry_deadline_s=retry_deadline_s)
        self._reader = FrameReader()
        self._rid = 0
        self._results: Dict[str, Dict] = {}    # logical id → last snapshot
        self.ttfb_s: Dict[str, float] = {}     # logical id → observed TTFB
        self._sent_at: Dict[str, float] = {}

    def close(self) -> None:
        self._conn.close()

    def _next_rid(self) -> str:
        self._rid += 1
        return f"fd-{self._rid}"

    def _pump(self, timeout_s: float) -> list:
        frames = []
        data = self._conn.recv(timeout_s=timeout_s)
        if data is not None:
            self._reader.feed(data)
            while self._conn.poll(0.0):
                more = self._conn.recv(timeout_s=0.0)
                if more is None:
                    break
                self._reader.feed(more)
        for frame in self._reader:
            if frame.ftype == FrameType.TOKENS:
                self._absorb(frame.header.get("req") or {})
            else:
                frames.append(frame)
        return frames

    def _absorb(self, snap: Dict) -> None:
        logical = snap.get("id")
        if logical is None:
            return
        self._results[logical] = snap
        if logical not in self.ttfb_s and snap.get("tokens") \
                and logical in self._sent_at:
            self.ttfb_s[logical] = \
                max(self.clock() - self._sent_at[logical], 0.0)

    def _rpc(self, ftype: int, header: Dict, timeout_s: float = 30.0):
        rid = self._next_rid()
        header = dict(header)
        header["rid"] = rid
        self._conn.send(encode_frame(ftype, header))
        deadline = self.clock() + timeout_s
        while True:
            remaining = deadline - self.clock()
            if remaining <= 0:
                raise TimeoutError(
                    f"front door: no reply to {FrameType.name(ftype)}")
            for frame in self._pump(min(remaining, 0.05)):
                if frame.header.get("rid") == rid:
                    if frame.ftype == FrameType.ERROR:
                        from .codec import raise_error_header
                        raise_error_header(frame.header)
                    return frame

    def submit(self, src_ids, **kwargs) -> str:
        """Submit one request; returns its logical id. Raises the exact
        overload exception the router raised (FleetOverloadError /
        RateLimitError / NoReplicasError) with ``retry_after_s`` and —
        under brownout — ``recovery_horizon_s`` intact."""
        header = {"src_ids": [int(t) for t in src_ids]}
        for key in ("max_new_tokens", "beam_size", "deadline_s",
                    "request_id", "tenant", "qos_class", "affinity_key"):
            if kwargs.get(key) is not None:
                header[key] = kwargs[key]
        sent = self.clock()
        reply = self._rpc(FrameType.SUBMIT, header)
        logical = reply.header["req"]["id"]
        self._sent_at[logical] = sent
        return logical

    def cancel(self, logical: str) -> bool:
        reply = self._rpc(FrameType.CANCEL, {"request_id": logical})
        return bool(reply.header.get("ok"))

    def health(self) -> Dict:
        reply = self._rpc(FrameType.HEALTH, {})
        return reply.header.get("health") or {}

    def result(self, logical: str) -> Optional[Dict]:
        return self._results.get(logical)

    def finished(self, logical: str) -> bool:
        snap = self._results.get(logical)
        return snap is not None and snap.get("state") in (
            "done", "cancelled", "expired")

    def wait(self, logicals, timeout_s: float = 120.0) -> Dict[str, Dict]:
        """Pump the stream until every id in ``logicals`` is terminal
        (or the deadline passes); returns id → final snapshot."""
        deadline = self.clock() + timeout_s
        pending = [l for l in logicals if not self.finished(l)]
        while pending and self.clock() < deadline:
            self._pump(0.05)
            pending = [l for l in pending if not self.finished(l)]
        return {l: self._results.get(l) for l in logicals}
