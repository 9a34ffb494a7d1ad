"""Length-prefixed wire codec for the network serving plane.

One frame on the wire:

    u32 BE  payload length (bytes after this prefix)
    u8      protocol version (PROTOCOL_VERSION)
    u8      frame type (FrameType)
    u32 BE  header length
    bytes   JSON header (UTF-8)
    bytes   binary body (payload length - 6 - header length)

The header carries everything structured (request snapshots, health,
error details); the body carries bulk binary (the KV-handoff artifact,
packed with :func:`pack_artifact`). JSON over msgpack: the repo already
speaks JSONL everywhere (metrics, traces, ckpt manifests), the framed
binary body covers the one payload JSON would butcher, and a
reader can inspect a captured stream with nothing but stdlib.

Failure taxonomy, decided at the frame boundary so every caller agrees:

- **truncation is not an error** — :meth:`FrameReader.next` returns
  ``None`` until the bytes arrive (a half-open TCP stream looks exactly
  like a slow one until the transport says otherwise);
- :class:`FrameTooLarge` — the length prefix promises more than
  ``max_frame_bytes``; refused BEFORE buffering, so a corrupt or
  malicious prefix cannot balloon memory;
- :class:`VersionMismatch` — wrong protocol version; refuse, never
  guess;
- :class:`CorruptFrame` — the inner lengths disagree with the outer, or
  the header is not valid JSON: the stream is unusable from here on.

Typed error frames (:func:`error_header`/:func:`raise_error_header`)
round-trip the serve/fleet backpressure exceptions losslessly: a client
catching ``OverloadError`` sees the same ``retry_after_s``, the same
``FleetOverloadError.per_replica`` hint map, and the brownout
``recovery_horizon_s`` the router folded in — the wire changes the
transport, never the contract.

A copy of the JAX package's ``net/codec.py`` (it imports nothing of JAX)
over the port's serve/handoff.py codec, so a bfloat16 artifact crosses
the wire as torch tensors and the frame bytes equal the JAX package's.
"""

from __future__ import annotations

import io
import json
import struct
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from ..serve.handoff import HandoffCorruptError, _decode_extension_dtypes, \
    _encode_extension_dtypes, validate_artifact
from ..serve.queue import DeadlineExceededError, OverloadError, \
    RateLimitError

PROTOCOL_VERSION = 1

#: Refuse frames above this size before buffering them. Generous: the
#: largest real payload is a KV-handoff artifact (tens of KB at bench
#: scale), so 64 MiB flags corruption, not legitimate traffic.
MAX_FRAME_BYTES = 64 * 1024 * 1024

_PREFIX = struct.Struct(">I")        # payload length
_INNER = struct.Struct(">BBI")       # version, ftype, header length


class FrameType:
    """Wire frame types. Requests carry a client-minted correlation id
    (``rid`` in the header); the matching ``*_OK`` (or ERROR) response
    echoes it. TOKENS frames are server-initiated pushes — no ``rid``."""

    SUBMIT = 1
    SUBMIT_OK = 2
    TOKENS = 3               # server push: request snapshot (token stream)
    CANCEL = 4
    CANCEL_OK = 5
    HEALTH = 6
    HEALTH_OK = 7
    ERROR = 8                # typed failure (overload, rate limit, ...)
    HANDOFF_EXPORT = 9       # body of the _OK: packed artifact bytes
    HANDOFF_EXPORT_OK = 10
    HANDOFF_IMPORT = 11      # body: packed artifact bytes
    HANDOFF_IMPORT_OK = 12
    HANDOFF_RELEASE = 13
    HANDOFF_RELEASE_OK = 14
    DRAIN = 15               # graceful: refuse new submits, finish in-flight
    DRAIN_OK = 16

    _NAMES = None

    @classmethod
    def name(cls, ftype: int) -> str:
        if cls._NAMES is None:
            cls._NAMES = {v: k for k, v in vars(cls).items()
                          if isinstance(v, int)}
        return cls._NAMES.get(ftype, f"type-{ftype}")


_VALID_TYPES = frozenset(
    v for k, v in vars(FrameType).items()
    if isinstance(v, int) and not k.startswith("_"))


class CodecError(ValueError):
    """Base class for wire-level failures."""


class FrameTooLarge(CodecError):
    def __init__(self, length: int, limit: int):
        super().__init__(
            f"frame of {length} bytes exceeds the {limit}-byte limit")
        self.length = length
        self.limit = limit


class VersionMismatch(CodecError):
    def __init__(self, got: int):
        super().__init__(
            f"protocol version {got} != {PROTOCOL_VERSION}")
        self.got = got


class CorruptFrame(CodecError):
    """The frame's internal structure is inconsistent — the stream
    cannot be trusted past this point."""


class Frame:
    __slots__ = ("ftype", "header", "body")

    def __init__(self, ftype: int, header: Dict, body: bytes = b""):
        self.ftype = ftype
        self.header = header
        self.body = body

    @property
    def name(self) -> str:
        return FrameType.name(self.ftype)

    def __repr__(self):
        return (f"Frame({self.name}, header={self.header!r}, "
                f"body={len(self.body)}B)")


def encode_frame(ftype: int, header: Dict, body: bytes = b"") -> bytes:
    """Serialize one frame, length prefix included."""
    if ftype not in _VALID_TYPES:
        raise CodecError(f"unknown frame type {ftype}")
    hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
    payload_len = _INNER.size + len(hdr) + len(body)
    return b"".join((
        _PREFIX.pack(payload_len),
        _INNER.pack(PROTOCOL_VERSION, ftype, len(hdr)),
        hdr, body))


def decode_payload(payload: bytes) -> Frame:
    """Decode one frame's payload (the bytes AFTER the length prefix)."""
    if len(payload) < _INNER.size:
        raise CorruptFrame(
            f"payload of {len(payload)} bytes is shorter than the "
            f"{_INNER.size}-byte frame header")
    version, ftype, hdr_len = _INNER.unpack_from(payload)
    if version != PROTOCOL_VERSION:
        raise VersionMismatch(version)
    if ftype not in _VALID_TYPES:
        raise CorruptFrame(f"unknown frame type {ftype}")
    if _INNER.size + hdr_len > len(payload):
        raise CorruptFrame(
            f"header length {hdr_len} overruns the "
            f"{len(payload)}-byte payload")
    hdr_bytes = payload[_INNER.size:_INNER.size + hdr_len]
    try:
        header = json.loads(hdr_bytes.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CorruptFrame(f"header is not valid JSON: {e}") from e
    if not isinstance(header, dict):
        raise CorruptFrame(
            f"header must be a JSON object, got {type(header).__name__}")
    return Frame(ftype, header, payload[_INNER.size + hdr_len:])


class FrameReader:
    """Incremental frame parser over an arbitrary byte stream.

    Feed it whatever the socket produced; :meth:`next` yields complete
    frames and returns ``None`` on a partial one (truncation is a
    transport condition, not a codec error). Structural failures raise
    and poison the reader — after a :class:`CodecError` the stream
    framing is lost, so the connection must be dropped.
    """

    def __init__(self, max_frame_bytes: int = MAX_FRAME_BYTES):
        self.max_frame_bytes = max_frame_bytes
        self._buf = bytearray()
        self._dead = False

    @property
    def buffered(self) -> int:
        return len(self._buf)

    def feed(self, data: bytes) -> None:
        if data:
            self._buf.extend(data)

    def next(self) -> Optional[Frame]:
        if self._dead:
            raise CorruptFrame("frame stream already failed")
        if len(self._buf) < _PREFIX.size:
            return None
        (payload_len,) = _PREFIX.unpack_from(self._buf)
        if payload_len > self.max_frame_bytes:
            self._dead = True
            raise FrameTooLarge(payload_len, self.max_frame_bytes)
        if len(self._buf) < _PREFIX.size + payload_len:
            return None
        payload = bytes(self._buf[_PREFIX.size:_PREFIX.size + payload_len])
        del self._buf[:_PREFIX.size + payload_len]
        try:
            return decode_payload(payload)
        except CodecError:
            self._dead = True
            raise

    def __iter__(self) -> Iterator[Frame]:
        while True:
            frame = self.next()
            if frame is None:
                return
            yield frame


# -- KV-handoff artifact body ------------------------------------------------


def pack_artifact(artifact: Dict[str, np.ndarray]) -> bytes:
    """Artifact dict → npz bytes for a frame body. Same codec the ckpt
    store uses (validate + extension-dtype byte views + npz with
    per-member CRC32), so corruption on the wire is detected exactly
    like corruption in the store."""
    validate_artifact(artifact)
    buf = io.BytesIO()
    np.savez(buf, **_encode_extension_dtypes(artifact))
    return buf.getvalue()


def unpack_artifact(data: bytes) -> Dict[str, np.ndarray]:
    """npz bytes → validated artifact dict. Any decode or validation
    failure raises :class:`~..serve.handoff.HandoffCorruptError` — the
    importer rejects, the exporter stays parked, the hop retries."""
    try:
        with np.load(io.BytesIO(data)) as npz:
            raw = {k: npz[k] for k in npz.files}
        artifact = _decode_extension_dtypes(raw)
        validate_artifact(artifact)
    except Exception as e:
        raise HandoffCorruptError(
            f"handoff artifact bytes are corrupt: {e}") from e
    return artifact


# -- typed error frames ------------------------------------------------------

#: header ``code`` values an ERROR frame may carry.
ERROR_CODES = ("rate_limit", "fleet_overload", "overload", "deadline",
               "draining", "no_replicas", "unknown_request",
               "handoff_corrupt", "invalid", "internal")


def error_header(exc: BaseException, rid: Optional[str] = None,
                 recovery_horizon_s: Optional[float] = None) -> Dict:
    """Map a server/router-side exception onto the typed ERROR header.

    The overload family is encoded losslessly — depth, max_depth,
    retry_after_s, the per-replica hint map, the rate-limited class and
    tenant — so :func:`raise_error_header` can rebuild the exact
    exception client-side. ``recovery_horizon_s`` threads the brownout
    controller's estimate through (None when the fleet is not
    degraded)."""
    h: Dict = {"message": str(exc)}
    if rid is not None:
        h["rid"] = rid
    if recovery_horizon_s is not None:
        h["recovery_horizon_s"] = recovery_horizon_s
    if isinstance(exc, RateLimitError):
        h.update(code="rate_limit", qos_class=exc.qos_class,
                 tenant=exc.tenant, retry_after_s=exc.retry_after_s,
                 depth=exc.depth, max_depth=exc.max_depth)
    elif isinstance(exc, OverloadError):
        per = getattr(exc, "per_replica", None)
        h.update(code="fleet_overload" if per is not None else "overload",
                 retry_after_s=exc.retry_after_s, depth=exc.depth,
                 max_depth=exc.max_depth)
        if per is not None:
            h["per_replica"] = per
    elif isinstance(exc, DeadlineExceededError):
        h["code"] = "deadline"
    elif isinstance(exc, KeyError):
        h["code"] = "unknown_request"
    elif isinstance(exc, HandoffCorruptError):
        # Before ValueError: a corrupt-artifact reject must come back
        # as HandoffCorruptError so the exporter stays parked and the
        # hop retries, same as an in-process corrupt reject.
        h["code"] = "handoff_corrupt"
    elif isinstance(exc, ValueError):
        h["code"] = "invalid"
    else:
        h["code"] = "internal"
    return h


def raise_error_header(h: Dict):
    """Rebuild and raise the exception an ERROR header encodes.

    The overload family comes back as the same class with the same
    attributes (the lossless round-trip the backpressure loops depend
    on); ``recovery_horizon_s``/``rid`` are attached as attributes when
    present. ``draining`` raises a plain OverloadError — to a router
    mid-placement it means exactly "try the next candidate"."""
    from ..fleet.router import FleetOverloadError, NoReplicasError

    code = h.get("code", "internal")
    msg = h.get("message", "")
    if code == "rate_limit":
        exc: BaseException = RateLimitError(
            h.get("qos_class", "standard"), h.get("tenant"),
            h.get("retry_after_s") or 0.0,
            h.get("depth", 0), h.get("max_depth", 0))
    elif code == "fleet_overload":
        exc = FleetOverloadError(
            h.get("depth", 0), h.get("max_depth", 0),
            h.get("retry_after_s"), per_replica=h.get("per_replica"))
    elif code in ("overload", "draining"):
        exc = OverloadError(h.get("depth", 0), h.get("max_depth", 0),
                            retry_after_s=h.get("retry_after_s"))
    elif code == "deadline":
        exc = DeadlineExceededError(msg)
    elif code == "no_replicas":
        exc = NoReplicasError(msg)
    elif code == "unknown_request":
        exc = KeyError(msg)
    elif code == "handoff_corrupt":
        exc = HandoffCorruptError(msg)
    elif code == "invalid":
        exc = ValueError(msg)
    else:
        exc = RuntimeError(msg or f"remote error ({code})")
    if h.get("recovery_horizon_s") is not None:
        exc.recovery_horizon_s = h["recovery_horizon_s"]
    if h.get("rid") is not None:
        exc.rid = h["rid"]
    raise exc


def read_frames(data: bytes) -> Tuple[list, int]:
    """Convenience for tests/tools: parse as many complete frames as
    ``data`` holds; returns (frames, bytes_consumed)."""
    reader = FrameReader()
    reader.feed(data)
    frames = list(reader)
    return frames, len(data) - reader.buffered
