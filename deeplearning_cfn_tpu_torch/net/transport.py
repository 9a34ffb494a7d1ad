"""Socket transport for the network serving plane.

Unix-domain sockets by default (``unix:///path/to.sock`` — one replica
per path, zero port arithmetic, and the path lives in the replica's run
dir next to its logs), TCP optional (``tcp://host:port``; port 0 binds
an ephemeral port and :func:`listen` returns the resolved address).

The transport is deliberately thin: blocking sockets with explicit
timeouts, a :class:`Connection` wrapper that distinguishes the three
things a read can mean (bytes / not-yet / peer-gone), and a connect
retry loop that doubles as the fleet's readiness barrier — a replica
server binds its listen socket only AFTER its engine is built and
warmed, so the first successful connect IS the readiness signal.

Failure model (docs/OPERATIONS.md "socket failure model"):

- connect timeout / refused → the replica is not up (yet); retry until
  ``retry_deadline_s``, then raise — the caller decides whether that is
  fatal (bench startup) or a DOWN replica (router reconnect).
- recv timeout → no data, nothing wrong; return ``None``.
- EOF / ECONNRESET / EPIPE → the peer is GONE: raise
  :class:`ConnectionClosed`. The client maps this to ReplicaCrashed —
  a dead socket is a dead replica, same as SIGKILL.

A copy of the JAX package's ``net/transport.py`` (it imports nothing of
JAX).
"""

from __future__ import annotations

import os
import select
import socket
import time
from typing import Optional, Tuple


class ConnectionClosed(ConnectionError):
    """The peer closed (or reset) the connection — distinct from a
    timeout, which only means "no bytes yet"."""


def parse_address(address: str) -> Tuple[str, object]:
    """``unix:///path`` → ("unix", path); ``tcp://host:port`` →
    ("tcp", (host, port)). A bare path is taken as a unix socket."""
    if address.startswith("unix://"):
        path = address[len("unix://"):]
        if not path:
            raise ValueError(f"empty unix socket path in {address!r}")
        return "unix", path
    if address.startswith("tcp://"):
        rest = address[len("tcp://"):]
        host, sep, port = rest.rpartition(":")
        if not sep or not host:
            raise ValueError(
                f"tcp address must be tcp://host:port, got {address!r}")
        return "tcp", (host, int(port))
    if address.startswith("/") or address.startswith("./"):
        return "unix", address
    raise ValueError(f"unsupported address {address!r} "
                     "(use unix:///path or tcp://host:port)")


def format_address(scheme: str, target) -> str:
    if scheme == "unix":
        return f"unix://{target}"
    host, port = target
    return f"tcp://{host}:{port}"


def listen(address: str, backlog: int = 16) -> Tuple[socket.socket, str]:
    """Bind + listen; returns ``(socket, resolved_address)``.

    Unix: a stale path from a previous (killed) server is unlinked
    before binding — the supervisor restarts replicas in place, and the
    restarted process must be able to reclaim its address. TCP with
    port 0 resolves to the kernel-assigned ephemeral port."""
    scheme, target = parse_address(address)
    if scheme == "unix":
        if os.path.exists(target):
            os.unlink(target)
        os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.bind(target)
        resolved = format_address("unix", target)
    else:
        host, port = target
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((host, port))
        resolved = format_address("tcp", (host, sock.getsockname()[1]))
    sock.listen(backlog)
    sock.setblocking(False)
    return sock, resolved


def connect(address: str, timeout_s: float = 5.0,
            retry_deadline_s: float = 0.0) -> "Connection":
    """Connect with a per-attempt timeout, retrying refusal/absence
    until ``retry_deadline_s`` wall seconds have passed (0 = a single
    attempt). Raises the last error when the deadline expires."""
    scheme, target = parse_address(address)
    deadline = time.monotonic() + retry_deadline_s
    while True:
        sock = socket.socket(
            socket.AF_UNIX if scheme == "unix" else socket.AF_INET,
            socket.SOCK_STREAM)
        sock.settimeout(timeout_s)
        try:
            sock.connect(target if scheme == "unix" else tuple(target))
            sock.settimeout(None)
            return Connection(sock, name=address)
        except (ConnectionRefusedError, FileNotFoundError,
                socket.timeout, TimeoutError, OSError):
            sock.close()
            if time.monotonic() >= deadline:
                raise
            time.sleep(min(0.05, max(deadline - time.monotonic(), 0.0)))


class Connection:
    """One established stream socket with explicit-timeout reads."""

    RECV_CHUNK = 1 << 16

    def __init__(self, sock: socket.socket, name: str = "?"):
        self._sock = sock
        self.name = name
        self.closed = False

    def fileno(self) -> int:
        return self._sock.fileno()

    def send(self, data: bytes) -> None:
        if self.closed:
            raise ConnectionClosed(f"{self.name}: connection closed")
        try:
            self._sock.sendall(data)
        except (BrokenPipeError, ConnectionResetError, OSError) as e:
            self.close()
            raise ConnectionClosed(f"{self.name}: send failed: {e}") from e

    def recv(self, timeout_s: Optional[float] = None) -> Optional[bytes]:
        """One read: bytes, ``None`` on timeout (no data — not an
        error), :class:`ConnectionClosed` on EOF or reset."""
        if self.closed:
            raise ConnectionClosed(f"{self.name}: connection closed")
        if timeout_s is not None and not self.poll(timeout_s):
            return None
        try:
            data = self._sock.recv(self.RECV_CHUNK)
        except (BlockingIOError, socket.timeout):
            return None
        except (ConnectionResetError, OSError) as e:
            self.close()
            raise ConnectionClosed(f"{self.name}: recv failed: {e}") from e
        if data == b"":
            self.close()
            raise ConnectionClosed(f"{self.name}: peer closed")
        return data

    def poll(self, timeout_s: float = 0.0) -> bool:
        """True when a read would return immediately (data or EOF)."""
        if self.closed:
            return False
        try:
            ready, _, _ = select.select([self._sock], [], [],
                                        max(timeout_s, 0.0))
        except (ValueError, OSError):
            return False
        return bool(ready)

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            try:
                self._sock.close()
            except OSError:
                pass
