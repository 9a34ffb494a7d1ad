"""Checkpoints in the JAX package's format (``checkpoint.py``) over pluggable
stores (``store.py``, a copy of the JAX package's)."""

from .checkpoint import (  # noqa: F401
    CheckpointManager,
    committed_steps,
    latest_checkpoint,
    read_leaves,
    restore_checkpoint,
    rollback_checkpoints,
    save_checkpoint,
    sweep_uncommitted,
)
from .store import (  # noqa: F401
    GcsStore,
    MemoryObjectStore,
    PosixStore,
    RetryingStore,
    RetryPolicy,
    Store,
    is_retriable,
    open_store,
    retry_policy_from_config,
)
