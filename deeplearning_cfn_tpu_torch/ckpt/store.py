"""Checkpoint storage backends: POSIX filesystem and object stores (a copy
of the JAX package's ``ckpt/store.py``, which imports nothing of JAX).

SURVEY.md §6: in the reference, durability came from every node mounting the
same EFS filesystem and rank 0 saving into it; "the EFS role is played by
GCS" in the TPU rebuild. This module makes that pluggable: checkpoint.py
speaks only the :class:`Store` interface (atomic whole-object put/get, list,
delete, existence), so the same two-phase commit protocol (per-process
DONE markers, then a COMMIT object) runs unchanged against:

- :class:`PosixStore` — local or NFS-style shared directories (atomic via
  write-to-tmp + rename);
- :class:`GcsStore` — ``gs://bucket/prefix`` via google-cloud-storage
  (object puts are already atomic — an object is never visible partially
  written, exactly the property the commit protocol needs);
- :class:`MemoryObjectStore` — an in-process fake with object-store
  semantics (no rename, no partial writes, flat keyspace) used to test the
  protocol without network.

Keys are ``/``-separated paths relative to the store root, e.g.
``step_00000100/shards_p0.npz``.
"""

from __future__ import annotations

import dataclasses
import io
import os
import shutil
import threading
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np

from ..obs.trace import span as _span


class Store:
    """Atomic whole-object storage. All implementations must guarantee a
    reader never observes a partially-written object — that property is
    what makes the DONE/COMMIT two-phase protocol correct."""

    def put_bytes(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get_bytes(self, key: str) -> bytes:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def list(self, prefix: str = "") -> List[str]:
        """All keys starting with ``prefix`` (recursive, unordered)."""
        raise NotImplementedError

    def delete_prefix(self, prefix: str) -> None:
        raise NotImplementedError

    def list_subdirs(self, prefix: str = "") -> List[str]:
        """Immediate child 'directory' names under ``prefix`` — e.g. the
        step_XXXXXXXX entries at the root. Default derives from a full
        list(); POSIX/GCS override with one-level listings so per-commit
        bookkeeping stays O(steps), not O(total objects)."""
        out = set()
        for k in self.list(prefix):
            rest = k[len(prefix):]
            if "/" in rest:
                out.add(rest.split("/", 1)[0])
        return sorted(out)

    # npz helpers: subclasses may override with streaming implementations.

    def put_npz(self, key: str, arrays: Dict[str, np.ndarray]) -> None:
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        self.put_bytes(key, buf.getvalue())

    def get_npz(self, key: str):
        """Returns an npz mapping (caller must .close())."""
        return np.load(io.BytesIO(self.get_bytes(key)))

    def describe(self) -> str:
        return type(self).__name__


class PosixStore(Store):
    """Filesystem-backed store; atomicity via tmp-file + ``os.replace``.
    Works on local disk and on POSIX-rename shared filesystems (NFS/EFS
    equivalents) — the reference's durability model.

    Tmp names carry a pid+thread suffix: on a SHARED filesystem several
    writers (ranks on different hosts re-saving the same step after a
    restart, or the async-save thread racing a sweep) may target the same
    key, and a fixed ``path + ".tmp"`` would have them truncating each
    other's half-written file before one of them renames it. Stale tmp
    files (a writer SIGKILLed mid-write) are swept on store open once they
    are older than ``sweep_tmp_age_s`` — young ones may belong to a live
    writer on another host and are left alone.
    """

    # Old enough that no live writer can still own it (a single object
    # write takes seconds, not an hour), young enough that crash debris
    # doesn't accumulate across restarts.
    STALE_TMP_AGE_S = 3600.0

    def __init__(self, root: str, sweep_tmp_age_s: float = STALE_TMP_AGE_S):
        self.root = root
        self._sweep_stale_tmp(sweep_tmp_age_s)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, *key.split("/"))

    @staticmethod
    def _is_tmp(name: str) -> bool:
        return name.endswith(".tmp") or name.endswith(".tmp.npz")

    def _tmp_suffix(self) -> str:
        return f".{os.getpid()}.{threading.get_ident()}.tmp"

    def _sweep_stale_tmp(self, max_age_s: float) -> None:
        if max_age_s <= 0 or not os.path.isdir(self.root):
            return
        cutoff = time.time() - max_age_s
        for dirpath, _, files in os.walk(self.root):
            for name in files:
                if not self._is_tmp(name):
                    continue
                full = os.path.join(dirpath, name)
                try:
                    if os.path.getmtime(full) < cutoff:
                        os.remove(full)
                except OSError:
                    pass  # raced another sweeper/writer; harmless

    def put_bytes(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + self._tmp_suffix()
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, path)

    def get_bytes(self, key: str) -> bytes:
        with open(self._path(key), "rb") as fh:
            return fh.read()

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def list(self, prefix: str = "") -> List[str]:
        # Walk only the deepest directory the prefix pins down — a
        # "step_000123/" listing must not scan every retained checkpoint
        # (the DONE-marker rendezvous polls this).
        walk_root = self.root
        if "/" in prefix:
            walk_root = self._path(prefix.rsplit("/", 1)[0])
        out = []
        if not os.path.isdir(walk_root):
            return out
        for dirpath, _, files in os.walk(walk_root):
            for name in files:
                if self._is_tmp(name):
                    continue
                full = os.path.join(dirpath, name)
                key = os.path.relpath(full, self.root).replace(os.sep, "/")
                if key.startswith(prefix):
                    out.append(key)
        return out

    def delete_prefix(self, prefix: str) -> None:
        # Fast path: a whole subdirectory.
        path = self._path(prefix.rstrip("/"))
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
            return
        for key in self.list(prefix):
            try:
                os.remove(self._path(key))
            except OSError:
                pass

    def list_subdirs(self, prefix: str = "") -> List[str]:
        base = self._path(prefix.rstrip("/")) if prefix else self.root
        if not os.path.isdir(base):
            return []
        return sorted(n for n in os.listdir(base)
                      if os.path.isdir(os.path.join(base, n)))

    def put_npz(self, key: str, arrays: Dict[str, np.ndarray]) -> None:
        # Stream straight to disk instead of staging the whole npz in RAM.
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # savez appends .npz unless present, hence the trailing .npz.
        tmp = path + self._tmp_suffix() + ".npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, path)

    def get_npz(self, key: str):
        return np.load(self._path(key))

    def describe(self) -> str:
        return f"posix:{self.root}"


class MemoryObjectStore(Store):
    """In-process object store with GCS-like semantics: flat keyspace,
    whole-object atomic puts, no rename. The protocol-correctness fake for
    tests — checkpoint round-trips against this prove the two-phase commit
    never depends on filesystem behaviors object stores lack."""

    def __init__(self):
        self._objects: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        self.put_count = 0

    def put_bytes(self, key: str, data: bytes) -> None:
        with self._lock:
            self._objects[key] = bytes(data)
            self.put_count += 1

    def get_bytes(self, key: str) -> bytes:
        with self._lock:
            if key not in self._objects:
                raise FileNotFoundError(f"memory object store: no key {key!r}")
            return self._objects[key]

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._objects

    def list(self, prefix: str = "") -> List[str]:
        with self._lock:
            return [k for k in self._objects if k.startswith(prefix)]

    def delete_prefix(self, prefix: str) -> None:
        with self._lock:
            for k in [k for k in self._objects if k.startswith(prefix)]:
                del self._objects[k]

    def describe(self) -> str:
        return "memory-object-store"


class GcsStore(Store):
    """``gs://bucket/prefix`` via google-cloud-storage (lazy import: the
    dependency is only needed when a gs:// path is actually used). GCS
    object creation is atomic, satisfying the Store contract directly."""

    def __init__(self, url: str):
        if not url.startswith("gs://"):
            raise ValueError(f"not a GCS url: {url!r}")
        rest = url[len("gs://"):]
        bucket, _, prefix = rest.partition("/")
        if not bucket:
            raise ValueError(f"no bucket in GCS url {url!r}")
        try:
            from google.cloud import storage  # type: ignore
            from google.cloud import exceptions as gcs_exceptions  # type: ignore
        except ImportError as e:  # pragma: no cover - env without the lib
            raise ImportError(
                "gs:// checkpoint paths need the google-cloud-storage "
                "package; install it or use a mounted/POSIX directory"
            ) from e
        self._not_found = gcs_exceptions.NotFound
        self._client = storage.Client()
        self._bucket = self._client.bucket(bucket)
        self._prefix = prefix.strip("/")
        self.url = url

    def _blob_name(self, key: str) -> str:
        return f"{self._prefix}/{key}" if self._prefix else key

    def put_bytes(self, key: str, data: bytes) -> None:
        self._bucket.blob(self._blob_name(key)).upload_from_string(data)

    def get_bytes(self, key: str) -> bytes:
        # Translate GCS NotFound into the Store contract's FileNotFoundError
        # (Posix raises it natively, MemoryObjectStore explicitly) — callers
        # like restore_or_none key their missing-checkpoint handling on it.
        try:
            return self._bucket.blob(self._blob_name(key)).download_as_bytes()
        except self._not_found as e:
            raise FileNotFoundError(
                f"{self.url}: no object for key {key!r}") from e

    def exists(self, key: str) -> bool:
        return self._bucket.blob(self._blob_name(key)).exists()

    def list(self, prefix: str = "") -> List[str]:
        full = self._blob_name(prefix)
        start = len(self._prefix) + 1 if self._prefix else 0
        return [b.name[start:]
                for b in self._client.list_blobs(self._bucket, prefix=full)]

    def delete_prefix(self, prefix: str) -> None:
        full = self._blob_name(prefix)
        for blob in list(self._client.list_blobs(self._bucket, prefix=full)):
            blob.delete()

    def list_subdirs(self, prefix: str = "") -> List[str]:
        # Delimiter listing: one API page of "directories", not a full
        # pagination over every shard object.
        full = self._blob_name(prefix)
        if full and not full.endswith("/"):
            full += "/"
        it = self._client.list_blobs(self._bucket, prefix=full,
                                     delimiter="/")
        list(it)  # drain to populate prefixes
        start = len(full)
        return sorted(p[start:].rstrip("/") for p in it.prefixes)

    def describe(self) -> str:
        return self.url


# -- retrying I/O -----------------------------------------------------------
#
# Every store operation above is one-shot: a single transient GCS 503 (or an
# NFS hiccup) mid-save would kill the whole run even though the launcher
# would then restart it and lose minutes of work for a fault that a 2-second
# retry absorbs. RetryingStore is the policy layer: transient errors retry
# with exponential backoff and DETERMINISTIC jitter (reproducible schedules
# — no wall-clock randomness, mirroring runtime/faults.py), permanent errors
# fail fast, and the retry counts are surfaced so operators see flakiness
# in metrics before it becomes an outage.

# HTTP codes GCS documents as retriable (plus 408/429 throttling).
GCS_TRANSIENT_CODES = frozenset({408, 429, 500, 502, 503, 504})

# google-cloud exception class names treated as transient without importing
# the library (it is an optional dependency — see GcsStore's lazy import).
_GCS_TRANSIENT_NAMES = frozenset({
    "TooManyRequests", "InternalServerError", "BadGateway",
    "ServiceUnavailable", "GatewayTimeout", "DeadlineExceeded",
    "TransportError", "RetryError",
})

# Checked BEFORE the OSError branch: FileNotFoundError IS an OSError, but a
# missing object is a protocol answer ("not committed yet"), not a fault —
# retrying it would turn every latest_checkpoint() probe into a backoff
# loop. ValueError/KeyError are corrupt-input classifications from the
# checkpoint layer itself.
_FATAL_TYPES = (FileNotFoundError, NotADirectoryError, IsADirectoryError,
                ValueError, KeyError, NotImplementedError)


def is_retriable(exc: BaseException) -> bool:
    """Transient (worth retrying) vs. permanent (fail fast now)."""
    if isinstance(exc, _FATAL_TYPES):
        return False
    code = getattr(exc, "code", None)
    if isinstance(code, int):
        return code in GCS_TRANSIENT_CODES
    if isinstance(exc, (OSError, ConnectionError, TimeoutError)):
        return True
    return type(exc).__name__ in _GCS_TRANSIENT_NAMES


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry schedule for store operations.

    ``max_attempts`` counts total tries (1 = no retry). Backoff is
    ``backoff_s * 2**retry`` capped at ``backoff_max_s``, stretched by a
    deterministic jitter in ``[0, jitter]`` derived from the (op sequence,
    attempt) pair — decorrelates concurrent rank retries without any
    wall-clock randomness. ``op_timeout_s`` bounds one logical operation
    across ALL its attempts (0 = unbounded): a save must fail in bounded
    time so the launcher's restart path can take over.
    """

    max_attempts: int = 3
    backoff_s: float = 0.5
    backoff_max_s: float = 8.0
    jitter: float = 0.1
    op_timeout_s: float = 60.0

    def backoff(self, retry_index: int, salt: int = 0) -> float:
        base = min(self.backoff_s * (2.0 ** retry_index), self.backoff_max_s)
        # Weyl-style hash of (salt, retry) → [0, 1): deterministic jitter.
        h = (salt * 2654435761 + retry_index * 40503 + 12345) % 997
        return base * (1.0 + self.jitter * (h / 996.0))


def retry_policy_from_config(ckpt_cfg) -> Optional["RetryPolicy"]:
    """Build a policy from CheckpointConfig's retry_* knobs (duck-typed so
    store.py stays independent of config.py); None = retries disabled."""
    attempts = int(getattr(ckpt_cfg, "retry_attempts", 1) or 1)
    if attempts <= 1:
        return None
    return RetryPolicy(
        max_attempts=attempts,
        backoff_s=float(getattr(ckpt_cfg, "retry_backoff_s", 0.5)),
        backoff_max_s=float(getattr(ckpt_cfg, "retry_backoff_max_s", 8.0)),
        jitter=float(getattr(ckpt_cfg, "retry_jitter", 0.1)),
        op_timeout_s=float(getattr(ckpt_cfg, "retry_timeout_s", 60.0)),
    )


class RetryingStore(Store):
    """Store wrapper applying a :class:`RetryPolicy` to every operation.

    Counters are public surface: ``retries_total`` (sleep-then-retry
    events), ``retries_by_op``, and ``gave_up`` (retriable errors that
    exhausted the budget) feed the train/serve metrics streams.
    """

    def __init__(self, inner: Store, policy: RetryPolicy,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        self.inner = inner
        self.policy = policy
        self._sleep = sleep
        self._clock = clock
        self.retries_total = 0
        self.retries_by_op: Dict[str, int] = {}
        self.gave_up = 0
        self._op_seq = 0
        self._lock = threading.Lock()

    def _call(self, op: str, fn: Callable):
        with self._lock:
            self._op_seq += 1
            salt = self._op_seq
        p = self.policy
        deadline = (self._clock() + p.op_timeout_s) \
            if p.op_timeout_s > 0 else None
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as e:
                attempt += 1
                retriable = is_retriable(e)
                out_of_time = deadline is not None \
                    and self._clock() >= deadline
                if not retriable or attempt >= p.max_attempts or out_of_time:
                    if retriable:
                        with self._lock:
                            self.gave_up += 1
                    raise
                delay = p.backoff(attempt - 1, salt=salt)
                if deadline is not None:
                    delay = min(delay, max(deadline - self._clock(), 0.0))
                with self._lock:
                    self.retries_total += 1
                    self.retries_by_op[op] = \
                        self.retries_by_op.get(op, 0) + 1
                # The span brackets the observable retry event (the
                # backoff sleep before the re-attempt) so a run report
                # shows retry counts and where the backoff time went.
                with _span("ckpt.store_retry", op=op, attempt=attempt,
                           delay_s=round(delay, 4)):
                    self._sleep(delay)

    def put_bytes(self, key, data):
        return self._call("put_bytes",
                          lambda: self.inner.put_bytes(key, data))

    def put_npz(self, key, arrays):
        return self._call("put_npz",
                          lambda: self.inner.put_npz(key, arrays))

    def get_bytes(self, key):
        return self._call("get_bytes", lambda: self.inner.get_bytes(key))

    def get_npz(self, key):
        return self._call("get_npz", lambda: self.inner.get_npz(key))

    def exists(self, key):
        return self._call("exists", lambda: self.inner.exists(key))

    def list(self, prefix=""):
        return self._call("list", lambda: self.inner.list(prefix))

    def list_subdirs(self, prefix=""):
        return self._call("list_subdirs",
                          lambda: self.inner.list_subdirs(prefix))

    def delete_prefix(self, prefix):
        return self._call("delete_prefix",
                          lambda: self.inner.delete_prefix(prefix))

    def describe(self):
        return f"retrying({self.inner.describe()})"


def open_store(directory_or_store: Union[str, Store],
               retry: Optional[RetryPolicy] = None) -> Store:
    """Resolve a checkpoint destination: a Store passes through; a
    ``gs://`` url opens GCS; anything else is a POSIX directory. With
    ``retry``, the resolved store is wrapped in a :class:`RetryingStore`
    (idempotent: an already-retrying store is never double-wrapped)."""
    if isinstance(directory_or_store, Store):
        store = directory_or_store
    elif isinstance(directory_or_store, str) and \
            directory_or_store.startswith("gs://"):
        store = GcsStore(directory_or_store)
    else:
        store = PosixStore(directory_or_store)
    if retry is not None and retry.max_attempts > 1 \
            and not isinstance(store, RetryingStore):
        store = RetryingStore(store, retry)
    return store
