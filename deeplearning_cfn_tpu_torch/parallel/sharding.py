"""How tensors lay out over the mesh — the batch side of
``deeplearning_cfn_tpu/parallel/sharding.py``.

The JAX layout is a ``NamedSharding`` per tensor and the compiler inserts the
collectives. Here every process holds the whole parameters (replicated: the
reference's replica per GPU) and a contiguous block of the global batch's
rows — the ``data_index``-th of ``data_ways`` equal blocks, which is JAX's
``P(("dcn_data", "data", "expert"))`` layout of dim 0 over one device per
process. The processes of one ``seq`` group hold the same rows, and a
sequence-parallel trunk runs its ``seq_index``-th slice of each row's
sequence (:func:`seq_slice`), JAX's ``P(batch, "seq", None)`` layout of the
activations. JAX's param rules shard over the ``model`` axis, which a
multi-process mesh refuses (``mesh.py``), so every parameter is replicated
and no rule is read.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

from .mesh import BATCH_AXES, Mesh, local_batch_size


class Elsewhere(NamedTuple):
    """A state leaf that another process holds and writes: its global shape
    and dtype (a checkpoint's manifest names it; its data comes from that
    process's shard object). Replicated leaves are process 0's; a ZeRO-1
    slot is its owner's."""

    shape: Tuple[int, ...]
    dtype: str


def batch_sharding(mesh: Mesh, global_batch: int) -> slice:
    """This process's rows of a global batch of ``global_batch`` rows (the
    same rows for every process of a ``seq`` group)."""
    local = local_batch_size(global_batch, mesh)
    start = mesh.data_index * local
    return slice(start, start + local)


def seq_slice(mesh: Mesh, seq_len: int) -> slice:
    """This process's positions of a sequence of ``seq_len``: the
    ``seq_index``-th of ``seq_ways`` equal slices (all of it without a
    ``seq`` axis)."""
    n = mesh.seq_ways
    if seq_len % n:
        raise ValueError(f"sequence length {seq_len} not divisible by the "
                         f"seq axis ({n} ways)")
    local = seq_len // n
    return slice(mesh.seq_index * local, (mesh.seq_index + 1) * local)


def local_shard(array, mesh: Mesh):
    """This process's contiguous rows of a global-batch ``array`` (the
    inverse view of JAX's ``make_array_from_process_local_data``)."""
    return array[batch_sharding(mesh, array.shape[0])]


__all__ = ["BATCH_AXES", "Elsewhere", "batch_sharding", "local_shard",
           "seq_slice"]
