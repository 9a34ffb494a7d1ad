"""net/: the network serving plane — real processes, real sockets. The
port of the JAX package's ``net/``.

Promotes the in-process fleet simulation to a multi-process system:

- :mod:`.codec` — length-prefixed wire frames (submit / token stream /
  cancel / typed overload with ``retry_after_s`` / health / KV handoff)
- :mod:`.transport` — unix-domain (default) or TCP sockets with
  explicit timeouts and a connect-retry readiness barrier
- :mod:`.server` — one serve engine per child process, spawned through
  the launch/ supervisor (``python -m
  deeplearning_cfn_tpu_torch.net.server``), on the device its
  ``--accelerator`` names
- :mod:`.client` — :class:`~.client.RemoteReplica`, the socket-backed
  EngineReplica duck type the unchanged fleet router drives
- :mod:`.router` — :class:`~.router.NetRouter`: reconnection tending,
  KV-handoff bytes over sockets, wall-clock drain
- :mod:`.frontdoor` — async front door multiplexing client connections
  with token streaming and bounded-queue backpressure
- :mod:`.bench` — the wall-clock fleet bench (``bench --fleet --net``)
  and the helpers that spawn a process fleet of servers
"""

from .client import RemoteReplica
from .codec import FrameReader, FrameType, encode_frame
from .frontdoor import FrontDoor, FrontDoorClient
from .router import NetRouter
from .server import ReplicaServer
from .transport import Connection, ConnectionClosed, connect, listen

__all__ = [
    "Connection", "ConnectionClosed", "connect", "listen",
    "FrameReader", "FrameType", "encode_frame",
    "RemoteReplica", "NetRouter", "ReplicaServer",
    "FrontDoor", "FrontDoorClient",
]
