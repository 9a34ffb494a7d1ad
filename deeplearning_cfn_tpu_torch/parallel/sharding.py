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
``models/pipelined.py:PARAM_RULES``, ``models/transformer.py:
TRANSFORMER_PARAM_RULES`` and ``models/moe.py:MOE_PARAM_RULES`` — splits
one dim of a leaf over the ``pipe``, ``model`` or ``expert`` axis: there
each process holds the :class:`Piece` at its coordinate on that axis (its
stage's layers of a ``[L, ...]`` stack, its heads' columns of a query
kernel or its rows of an ``attn_out`` kernel, its experts of an ``[E,
...]`` stack), as JAX's ``P("pipe")``, ``P(None, "model")``, ``P("model",
None)`` and ``P("expert", ...)`` do; the processes with the same coordinate
hold the same piece (``Mesh.holders_group``). A rule names the dim of the
leaf in Flax's layout (``convert.flax_layout``), where the JAX rules name
it; the port's ``Dense`` weight is the transposed ``[out, in]``. A model
with no leaf that a rule matches (ResNet, Mask R-CNN, the pipelined trunk
on a ``model`` axis) replicates over that axis, as in JAX.
"""

from __future__ import annotations

import re
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

from .mesh import BATCH_AXES, Mesh, local_batch_size

# (regex searched in a leaf's Flax path, mesh axis, the dim of the Flax
# leaf that splits over it): the JAX package's rules for the pipe axis
# (``pipe_stack/ -> P("pipe")``), the model axis (the Megatron column and
# row split: the attention and MLP input kernels split their output
# features, the output kernels their input features; they match
# ``/kernel`` only, so every bias stays replicated) and the expert axis
# (the stacked expert weights; the router stays replicated), the first
# match winning.
PARAM_RULES: Tuple[Tuple[str, str, int], ...] = (
    (r"pipe_stack/", "pipe", 0),
    (r"(query|key|value)/kernel", "model", 1),
    (r"attn_out/kernel", "model", 0),
    (r"mlp_in/kernel", "model", 1),
    (r"mlp_out/kernel", "model", 0),
    (r"moe_mlp/w_in", "expert", 0),
    (r"moe_mlp/w_out", "expert", 0),
    (r"moe_mlp/b_in", "expert", 0),
    (r"moe_mlp/b_out", "expert", 0),
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
    """The range ``start:start + data.shape[dim]`` of dim ``dim`` of a
    state leaf of global ``shape`` (Flax's layout) that this process holds
    and writes (its piece of a leaf split over ``pipe``, ``model`` or
    ``expert``)."""

    data: np.ndarray
    start: int
    shape: Tuple[int, ...]
    dim: int = 0


class Piece(NamedTuple):
    """This process's piece of a parameter split over mesh ``axis``: the
    range ``start:stop`` of dim ``dim`` of the logical leaf in Flax's
    layout, which has ``whole`` entries along it. ``mesh`` gives its
    groups: ``mesh.holders_group(axis)`` holds the same piece,
    ``mesh.group((axis,))`` one of each piece."""

    axis: str
    start: int
    stop: int
    whole: int
    mesh: Mesh
    dim: int = 0

    # Each of ``of``, ``shape`` and ``rows`` takes the dim that the piece
    # splits, ``dim`` (None: the piece's own): a tensor derived from the
    # leaf with one dim fewer (an Adafactor moment) splits at another.

    def of(self, whole: np.ndarray, dim: Optional[int] = None
           ) -> np.ndarray:
        """This piece of a whole leaf (Flax's layout)."""
        at = [slice(None)] * whole.ndim
        at[self.dim if dim is None else dim] = slice(self.start, self.stop)
        return whole[tuple(at)]

    def shape(self, piece_shape: Tuple[int, ...],
              dim: Optional[int] = None) -> Tuple[int, ...]:
        """The whole leaf's shape from this piece's (Flax's layout)."""
        out = list(piece_shape)
        out[self.dim if dim is None else dim] = self.whole
        return tuple(out)

    def rows(self, data: np.ndarray, dim: Optional[int] = None) -> Rows:
        """This piece's ``data`` (Flax's layout) as the :class:`Rows` of
        the whole leaf that a checkpoint writes."""
        dim = self.dim if dim is None else dim
        return Rows(data, self.start, self.shape(data.shape, dim), dim)

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


def leaf_axis(name: str) -> Optional[Tuple[str, int]]:
    """``(mesh axis, Flax dim)`` of the first of :data:`PARAM_RULES` that
    matches leaf ``name``, or None."""
    for pattern, axis, dim in PARAM_RULES:
        if re.search(pattern, name):
            return axis, dim
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
    for name, _, t, kind in flax_layout(model):
        mesh, rule = meshes.get(id(t)), leaf_axis(name)
        if mesh is None or rule is None or mesh.shape[rule[0]] == 1:
            continue
        axis, dim = rule
        # The port's Dense weight is Flax's kernel transposed.
        n, at = t.shape[1 - dim if kind == "dense" else dim], \
            mesh.coords[axis]
        out[id(t)] = Piece(axis, at * n, (at + 1) * n, n * mesh.shape[axis],
                           mesh, dim)
    return out


def piece_rows(mesh: Optional[Mesh], axis: str, whole: int) -> slice:
    """This process's range of a dim of ``whole`` entries split over
    ``axis`` (all of it without a mesh or with one way)."""
    ways = 1 if mesh is None else mesh.shape[axis]
    if whole % ways:
        raise ValueError(f"{whole} entries do not split over the {axis} "
                         f"axis ({ways} ways)")
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


def spatial_slice(array, mesh: Mesh, dim: int):
    """This process's slice of dim ``dim`` of ``array`` (an image's
    height): the ``spatial_index``-th of ``spatial_ways`` equal slices,
    JAX's ``P(batch, "spatial", ...)`` layout."""
    n, ways = array.shape[dim], mesh.spatial_ways
    if n % ways:
        raise ValueError(f"{n} rows do not split over the spatial axis "
                         f"({ways} ways)")
    at = [slice(None)] * array.ndim
    at[dim] = slice(mesh.spatial_index * n // ways,
                    (mesh.spatial_index + 1) * n // ways)
    return array[tuple(at)]


def local_shard(array, mesh: Mesh):
    """This process's contiguous rows of a global-batch ``array`` (the
    inverse view of JAX's ``make_array_from_process_local_data``)."""
    return array[batch_sharding(mesh, array.shape[0])]


__all__ = ["BATCH_AXES", "Elsewhere", "PARAM_RULES", "Piece", "Rows",
           "batch_sharding", "leaf_axis", "local_shard", "param_pieces",
           "piece_rows", "seq_slice", "spatial_slice"]
