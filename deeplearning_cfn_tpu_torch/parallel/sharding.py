"""How tensors lay out over the mesh — the port of
``deeplearning_cfn_tpu/parallel/sharding.py``.

The JAX layout is a ``NamedSharding`` per tensor and the compiler inserts the
collectives. Here every process holds a contiguous block of the global
batch's rows — the ``data_index``-th of ``data_ways`` equal blocks, which is
JAX's ``P(("dcn_data", "data", "expert"))`` layout of dim 0 over one device
per process. The processes of one ``seq`` or ``pipe`` group hold the same
rows, and a sequence-parallel trunk runs its ``seq_index``-th slice of each
row's sequence (:func:`seq_slice`), JAX's ``P(batch, "seq", None)`` layout
of the activations.

Parameters are replicated (the reference's replica per GPU) except where
one of :data:`PARAM_RULES` — the port's copy of the JAX package's
``models/pipelined.py:PARAM_RULES`` and ``models/moe.py:MOE_PARAM_RULES`` —
splits a leaf's dim 0 over the ``pipe`` or ``expert`` axis: there each
process holds the :class:`Piece` at its coordinate on that axis (its
stage's layers of a ``[L, ...]`` stack, its experts of an ``[E, ...]``
stack), as JAX's ``P("pipe")`` and ``P("expert", ...)`` do; the processes
with the same coordinate hold the same piece (``Mesh.holders_group``). JAX's
``model``-axis rules shard over an axis that a multi-process mesh refuses
(``mesh.py``), so no copy of them is kept.
"""

from __future__ import annotations

import re
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

from .mesh import BATCH_AXES, Mesh, local_batch_size

# (regex searched in a leaf's Flax path, mesh axis its dim 0 splits over):
# the JAX package's rules for the pipe axis (``pipe_stack/ -> P("pipe")``)
# and the expert axis (the stacked expert weights; the router stays
# replicated).
PARAM_RULES: Tuple[Tuple[str, str], ...] = (
    (r"pipe_stack/", "pipe"),
    (r"moe_mlp/w_in", "expert"),
    (r"moe_mlp/w_out", "expert"),
    (r"moe_mlp/b_in", "expert"),
    (r"moe_mlp/b_out", "expert"),
)


class Elsewhere(NamedTuple):
    """A state leaf that another process holds and writes: its global shape
    and dtype (a checkpoint's manifest names it; its data comes from that
    process's shard object). Replicated leaves are process 0's; a ZeRO-1
    slot is its owner's; a piece of a split leaf is written by the first of
    its holders (or the owner of its slots)."""

    shape: Tuple[int, ...]
    dtype: str


class Rows(NamedTuple):
    """The rows ``start:start + len(data)`` of dim 0 of a state leaf of
    global ``shape`` that this process holds and writes (its piece of a
    leaf split over ``pipe`` or ``expert``)."""

    data: np.ndarray
    start: int
    shape: Tuple[int, ...]


class Piece(NamedTuple):
    """This process's piece of a parameter split over mesh ``axis``: rows
    ``start:stop`` of dim 0 of the logical leaf, which has ``whole`` rows.
    ``mesh`` gives its groups: ``mesh.holders_group(axis)`` holds the same
    piece, ``mesh.group((axis,))`` one of each piece."""

    axis: str
    start: int
    stop: int
    whole: int
    mesh: Mesh

    def of(self, whole: np.ndarray) -> np.ndarray:
        """This piece of a whole leaf."""
        return whole[self.start:self.stop]

    def holders(self):
        return self.mesh.holders_group(self.axis)

    def peers(self):
        return self.mesh.group((self.axis,))

    @property
    def writes(self) -> bool:
        """Whether this process writes the piece to a checkpoint: the first
        of its holders."""
        return self.mesh.holder_ranks(self.axis)[0] == \
            self.mesh.process_index


def leaf_axis(name: str) -> Optional[str]:
    """The mesh axis that :data:`PARAM_RULES` split leaf ``name``'s dim 0
    over (the first rule that matches), or None."""
    for pattern, axis in PARAM_RULES:
        if re.search(pattern, name):
            return axis
    return None


def param_pieces(model) -> Dict[int, Piece]:
    """``{id(parameter): Piece}`` for every parameter of ``model`` that
    holds a piece of its leaf: a leaf :data:`PARAM_RULES` splits, of a
    module whose ``mesh`` has that axis above 1 (the module sized the
    parameter to its piece)."""
    from ..convert import flax_layout

    meshes = {id(p): mod.mesh for mod in model.modules()
              if getattr(mod, "mesh", None) is not None
              for p in mod.parameters(recurse=False)}
    out = {}
    for name, _, t, _ in flax_layout(model):
        mesh, axis = meshes.get(id(t)), leaf_axis(name)
        if mesh is None or axis is None or mesh.shape[axis] == 1:
            continue
        rows, at = t.shape[0], mesh.coords[axis]
        out[id(t)] = Piece(axis, at * rows, (at + 1) * rows,
                           rows * mesh.shape[axis], mesh)
    return out


def piece_rows(mesh: Optional[Mesh], axis: str, whole: int) -> slice:
    """This process's rows of a leaf of ``whole`` rows split over ``axis``
    (all of them without a mesh or with one way)."""
    ways = 1 if mesh is None else mesh.shape[axis]
    if whole % ways:
        raise ValueError(f"{whole} rows do not split over the {axis} axis "
                         f"({ways} ways)")
    at = 0 if mesh is None else mesh.coords[axis]
    n = whole // ways
    return slice(at * n, (at + 1) * n)


def batch_sharding(mesh: Mesh, global_batch: int) -> slice:
    """This process's rows of a global batch of ``global_batch`` rows (the
    same rows for every process of a ``seq`` or ``pipe`` group)."""
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


__all__ = ["BATCH_AXES", "Elsewhere", "PARAM_RULES", "Piece", "Rows",
           "batch_sharding", "leaf_axis", "local_shard", "param_pieces",
           "piece_rows", "seq_slice"]
