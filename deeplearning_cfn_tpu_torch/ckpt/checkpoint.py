"""Atomic, optionally async checkpoints in the JAX package's on-disk format —
the port of ``deeplearning_cfn_tpu/ckpt/checkpoint.py``.

The port writes exactly what the JAX package writes, so each package
restores the other's checkpoints:

- layout ``<root>/step_<N:08d>/{manifest.json, manifest_p<i>.json,
  shards_p<i>.npz, DONE_p<i>, COMMIT}``, one ``_p<i>`` set per process;
- ``manifest.json`` (process 0's) lists every leaf by its flat name
  (``step``, ``params/...``, ``batch_stats/...``, ``opt_state/...``,
  ``ema_params/...``: the names ``utils/trees.py:flatten_with_names`` gives
  the JAX ``TrainState``) with its shape and dtype, and the process count;
  ``manifest_p<i>.json`` maps each name process ``i`` wrote to its array
  ``<name>::0`` in ``shards_p<i>.npz`` and the index range that array
  covers: the whole leaf for a replicated leaf (process 0's) or a ZeRO-1
  slot (its owner's), a range of one dim for a piece of a leaf split over
  ``pipe``, ``model`` or ``expert`` (a ``Rows``: its stage's layers, its
  heads' columns or rows, its experts).
  A leaf another process writes is an ``Elsewhere``, named in the
  manifest only;
- the two-phase commit: each process's shard object and manifest, then its
  ``DONE_p<i>`` marker; process 0 writes ``COMMIT`` once every process's
  marker exists. Restore sees committed steps only.

A state is a mapping ``{flat name: tensor or array}`` or an object with
``named_leaves()`` (the port's :class:`~..train.state.TrainState`, whose
leaves carry the JAX names). The device→host copy runs on the caller's
thread; ``async_write`` moves only the object writes to a background thread,
so the next step may change the live tensors while the write runs.

Restore merges every process's manifest as the JAX reader does, so a
checkpoint a multi-process JAX run wrote restores here too, as long as every
shard object is in the store.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from ..obs.trace import span
from ..parallel.mesh import process_count, process_index
from ..parallel.sharding import Elsewhere, Rows
from .store import RetryPolicy, Store, open_store

_MANIFEST = "manifest.json"
_COMMIT = "COMMIT"
_DONE_TIMEOUT_S = 600.0

StoreOrPath = Union[str, Store]


def _step_key(step: int) -> str:
    return f"step_{step:08d}"


def _host_leaves(state) -> List[Tuple[str, Any]]:
    """(name, host array, None, Rows or Elsewhere) for every leaf of
    ``state``. Tensors are
    copied now (a CPU tensor too: its numpy view would follow the next
    step); numpy leaves are the caller's, to leave unchanged until the
    write is done (``TrainState.named_leaves`` hands over fresh copies)."""
    items = state.named_leaves() if hasattr(state, "named_leaves") \
        else list(state.items())
    out = []
    for name, leaf in items:
        if isinstance(leaf, (Elsewhere, Rows)):
            out.append((name, leaf))
            continue
        if leaf is not None and hasattr(leaf, "detach"):
            leaf = leaf.detach().to("cpu", copy=True).numpy()
        out.append((name, None if leaf is None else np.asarray(leaf)))
    return out


# -- save -------------------------------------------------------------------


def save_checkpoint(directory: StoreOrPath, step: int, state,
                    keep: int = 0, async_write: bool = False,
                    _thread_holder: Optional[List[threading.Thread]] = None
                    ) -> str:
    """Write this process's part of one checkpoint (every process of the
    job calls it for the same step); returns its location (a path for a
    POSIX store, else ``<store> key``)."""
    store = open_store(directory)
    key = _step_key(step)
    pidx, pcount = process_index(), process_count()
    tree_manifest: Dict[str, Any] = {"step": step, "processes": pcount,
                                     "leaves": {}}
    proc_manifest: Dict[str, Any] = {"process": pidx, "leaves": {}}
    arrays: Dict[str, np.ndarray] = {}
    for name, data in _host_leaves(state):
        if data is None:
            tree_manifest["leaves"][name] = {"kind": "none"}
            continue
        start, dim, rows = 0, 0, data
        if isinstance(data, Rows):
            start, dim, rows = data.start, data.dim, np.asarray(data.data)
            data = Elsewhere(data.shape, str(rows.dtype))
        tree_manifest["leaves"][name] = {
            "kind": "array", "shape": list(data.shape),
            "dtype": str(data.dtype)}
        if isinstance(rows, Elsewhere):
            continue
        akey = f"{name}::0"
        arrays[akey] = rows
        index = [[0, int(s)] for s in rows.shape]
        if index:
            index[dim] = [start, start + int(rows.shape[dim])]
        proc_manifest["leaves"][name] = [{"key": akey, "index": index}]

    def write_files():
        retries_before = int(getattr(store, "retries_total", 0))
        with span("ckpt.save", step=step, async_write=async_write) as sp:
            store.put_npz(f"{key}/shards_p{pidx}.npz", arrays)
            store.put_bytes(f"{key}/manifest_p{pidx}.json",
                            json.dumps(proc_manifest).encode())
            if pidx == 0:
                store.put_bytes(f"{key}/{_MANIFEST}",
                                json.dumps(tree_manifest).encode())
            # The marker, then the storage-level commit rendezvous on
            # process 0. No collective here: this may run on the async
            # writer's thread, beside the training collectives.
            store.put_bytes(f"{key}/DONE_p{pidx}", str(step).encode())
            if pidx == 0:
                deadline = time.time() + _DONE_TIMEOUT_S
                sleep_s = 0.05
                while len([k for k in store.list(f"{key}/")
                           if k.rsplit("/", 1)[-1].startswith("DONE_p")]) \
                        < pcount:
                    if time.time() > deadline:  # pragma: no cover
                        print(f"[dlcfn-tpu] WARNING: checkpoint step {step} "
                              f"not committed: missing DONE markers after "
                              f"{_DONE_TIMEOUT_S}s")
                        sp.annotate(committed=False)
                        return
                    time.sleep(sleep_s)
                    sleep_s = min(sleep_s * 1.6, 2.0)
                store.put_bytes(f"{key}/{_COMMIT}", str(step).encode())
                if keep > 0:
                    _garbage_collect(store, keep)
            sp.annotate(retries=int(getattr(store, "retries_total", 0))
                        - retries_before)

    if async_write:
        t = threading.Thread(target=write_files, daemon=True)
        t.start()
        if _thread_holder is not None:
            _thread_holder.append(t)
    else:
        write_files()
    if isinstance(directory, str) and not directory.startswith("gs://"):
        return os.path.join(directory, key)
    return f"{store.describe()} {key}"


def _garbage_collect(store: Store, keep: int):
    steps = sorted(_committed_steps(store))
    for step in steps[:-keep]:
        store.delete_prefix(f"{_step_key(step)}/")


def _step_dirs(store: Store) -> List[Tuple[str, int]]:
    out = []
    for name in store.list_subdirs(""):
        if not name.startswith("step_"):
            continue
        try:
            out.append((name, int(name[len("step_"):])))
        except ValueError:
            continue
    return out


def rollback_checkpoints(directory: StoreOrPath, step: int) -> List[int]:
    """Delete every checkpoint directory past ``step`` (committed or not)
    and return the deleted steps, so the next auto-resume restores
    ``step``. One-shot and imperative (the ``ckpt rollback`` verb), never a
    training option: a persisted rollback would re-delete new progress on
    every restart."""
    store = open_store(directory)
    committed = _committed_steps(store)
    if step not in committed:
        raise FileNotFoundError(
            f"no committed checkpoint at step {step}; available: "
            f"{sorted(committed)}")
    deleted = []
    for name, s in _step_dirs(store):
        if s > step:
            store.delete_prefix(f"{name}/")
            deleted.append(s)
    return sorted(deleted)


def sweep_uncommitted(directory: StoreOrPath) -> List[int]:
    """Delete every ``step_<N>`` directory without a ``COMMIT`` (a torn
    commit of a dead attempt) and return the swept steps. Call it only when
    no save can be in flight: the resume path does, before its first
    save."""
    store = open_store(directory)
    swept = []
    for name, s in _step_dirs(store):
        if not store.exists(f"{name}/{_COMMIT}"):
            store.delete_prefix(f"{name}/")
            swept.append(s)
    return sorted(swept)


# -- restore ----------------------------------------------------------------


def _committed_steps(directory: StoreOrPath) -> List[int]:
    store = open_store(directory)
    return [s for name, s in _step_dirs(store)
            if store.exists(f"{name}/{_COMMIT}")]


def latest_checkpoint(directory: StoreOrPath) -> Optional[int]:
    steps = _committed_steps(directory)
    return max(steps) if steps else None


def committed_steps(directory: StoreOrPath) -> List[int]:
    """Sorted committed steps (the ``ckpt list`` verb). A local directory
    that does not exist is an error: "no checkpoints here" and "wrong path"
    must not look alike."""
    if isinstance(directory, str) and not directory.startswith("gs://") \
            and not os.path.isdir(directory):
        raise FileNotFoundError(
            f"no such checkpoint directory: {directory}")
    return sorted(_committed_steps(directory))


def read_leaves(directory: StoreOrPath, step: int,
                names=None) -> Dict[str, Optional[np.ndarray]]:
    """The leaves of committed checkpoint ``step``: those in ``names``
    (every one must be there) or, with ``names`` a callable, those whose
    name it accepts; ``None`` reads every leaf. Global arrays are
    reassembled from every process's shard object."""
    store = open_store(directory)
    key = _step_key(step)
    manifest = json.loads(store.get_bytes(f"{key}/{_MANIFEST}"))
    shard_entries: Dict[str, List[Tuple[int, Dict]]] = {}
    proc_manifests = sorted(
        k for k in store.list(f"{key}/")
        if k.rsplit("/", 1)[-1].startswith("manifest_p"))
    for mkey in proc_manifests:
        pm = json.loads(store.get_bytes(mkey))
        p = int(pm["process"])
        for name, entries in pm["leaves"].items():
            shard_entries.setdefault(name, []).extend((p, e)
                                                      for e in entries)
    expected = manifest.get("processes", 1)
    if len(proc_manifests) < expected:
        raise FileNotFoundError(
            f"checkpoint has {len(proc_manifests)}/{expected} process "
            f"manifests — incomplete copy in this store?")

    if names is None:
        wanted = list(manifest["leaves"])
    elif callable(names):
        wanted = [n for n in manifest["leaves"] if names(n)]
    else:
        wanted = list(names)
    shard_files: Dict[int, Any] = {}

    def load(p: int):
        if p not in shard_files:
            skey = f"{key}/shards_p{p}.npz"
            if not store.exists(skey):
                raise FileNotFoundError(
                    f"missing shard object {skey} — incomplete checkpoint "
                    f"copy?")
            shard_files[p] = store.get_npz(skey)
        return shard_files[p]

    def assemble(name: str, entry) -> Optional[np.ndarray]:
        if entry["kind"] == "none":
            return None
        shape = tuple(entry["shape"])
        entries = shard_entries.get(name, [])
        if not entries:
            raise KeyError(f"no shard data recorded for leaf {name!r}")
        if len(entries) == 1:
            p, e = entries[0]
            data = load(p)[e["key"]]
            if data.shape == shape:
                return data
        out = np.zeros(shape, dtype=entry["dtype"])
        covered = np.zeros(shape, dtype=bool)
        for p, e in entries:
            idx = tuple(slice(a, b) for a, b in e["index"])
            out[idx] = load(p)[e["key"]]
            covered[idx] = True
        if not covered.all():
            raise ValueError(
                f"leaf {name!r}: shards cover only {int(covered.sum())}/"
                f"{covered.size} entries — corrupt or incomplete "
                f"checkpoint")
        return out

    try:
        out = {}
        for name in wanted:
            entry = manifest["leaves"].get(name)
            if entry is None:
                raise KeyError(f"checkpoint missing leaf {name!r}")
            out[name] = assemble(name, entry)
        return out
    finally:
        for f in shard_files.values():
            f.close()


def restore_checkpoint(directory: StoreOrPath, target,
                       step: Optional[int] = None
                       ) -> Tuple[Dict[str, Optional[np.ndarray]], int]:
    """Read the leaves ``target`` names (a mapping, or an object with
    ``named_leaves()``) from committed ``step`` (None: the latest) →
    ``({name: host array}, step)``. Strict, as the JAX restore is: a leaf of
    the target that the checkpoint lacks raises ``KeyError``; leaves the
    target does not name are not read."""
    store = open_store(directory)
    if step is None:
        step = latest_checkpoint(store)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in "
                                    f"{store.describe()}")
    names = [n for n, _ in (target.named_leaves()
                            if hasattr(target, "named_leaves")
                            else target.items())]
    retries_before = int(getattr(store, "retries_total", 0))
    with span("ckpt.restore", step=step) as sp:
        leaves = read_leaves(store, step, names)
        sp.annotate(retries=int(getattr(store, "retries_total", 0))
                    - retries_before)
    return leaves, step


# -- manager ----------------------------------------------------------------


class CheckpointManager:
    """Policy wrapper: save every N steps, keep K, async writes, resume. The
    destination may be a POSIX directory, a gs:// url or a Store."""

    def __init__(self, directory: StoreOrPath, every_steps: int = 0,
                 keep: int = 3, async_write: bool = True,
                 retry: Optional[RetryPolicy] = None):
        self.directory = directory
        self.store = open_store(directory, retry=retry)
        self.every_steps = every_steps
        self.keep = keep
        self.async_write = async_write
        self._threads: List[threading.Thread] = []

    def should_save(self, step: int) -> bool:
        return self.every_steps > 0 and step % self.every_steps == 0

    def save(self, step: int, state, force: bool = False):
        if not (force or self.should_save(step)):
            return
        self.wait()  # one in-flight async save at a time
        save_checkpoint(self.store, step, state, keep=self.keep,
                        async_write=self.async_write,
                        _thread_holder=self._threads)

    def restore_or_none(self, target, step: int = 0):
        """``(leaves, step)`` of the latest committed checkpoint, or of an
        explicit ``step`` (> 0, which must be committed); ``(None, None)``
        when there is none. Loading the leaves into a state is the
        caller's (``TrainState.load_named``)."""
        if step > 0:
            committed = _committed_steps(self.store)
            if step not in committed:
                raise FileNotFoundError(
                    f"no committed checkpoint at step {step} in "
                    f"{self.directory}; available: {sorted(committed)}")
        else:
            step = latest_checkpoint(self.store)
            if step is None:
                return None, None
        return restore_checkpoint(self.store, target, step)

    def committed(self) -> List[int]:
        """The committed steps in the store, unsorted."""
        return _committed_steps(self.store)

    def store_retries(self) -> int:
        """Transient-fault retries the store absorbed so far."""
        return int(getattr(self.store, "retries_total", 0))

    def sweep_orphans(self) -> List[int]:
        """Sweep torn step directories (see :func:`sweep_uncommitted`)."""
        return sweep_uncommitted(self.store)

    def wait(self):
        for t in self._threads:
            t.join()
        self._threads.clear()

