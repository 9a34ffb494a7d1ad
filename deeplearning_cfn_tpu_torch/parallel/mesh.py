"""The mesh over the job's processes — the port of
``deeplearning_cfn_tpu/parallel/mesh.py``.

The JAX mesh is a ``jax.sharding.Mesh`` over every chip of the slice, and
XLA schedules the collectives along its axes. The port runs one process per
device (the reference's one rank per GPU), so its mesh is the process
group: :class:`Mesh` holds the axis sizes, this process's coordinates and
the count of processes, and the collectives go through
``torch.distributed`` (``parallel/collectives.py``).

What carries over exactly: :data:`AXIS_ORDER`, :data:`BATCH_AXES`,
:class:`MeshSpec` and its ``resolve`` (the same errors for the same
configs), :func:`data_axis_size`, :func:`local_batch_size`,
:func:`validate_batch`, :func:`describe` (JAX's ``mesh[...] over N
devices`` line), :func:`slice_chip_count` and :func:`hosts_for_slice`.

Scope. Across processes every axis is ported. The batch axes (``dcn_data``,
``data``, ``expert``) split the global batch's rows; the processes that
differ only outside them hold the same rows (:attr:`Mesh.data_index` of
:attr:`Mesh.data_ways`, :attr:`Mesh.replicas` of them each). Of those, a
``seq`` group (:meth:`Mesh.seq_group`) splits each row's sequence (ring or
Ulysses attention, ``ops/``); a ``pipe`` group (:meth:`Mesh.pipe_group`)
holds a stage each (``ops/pipeline.py``); a ``model`` group
(:meth:`Mesh.model_group`) splits the heads of each attention and the
hidden units of each MLP (tensor parallelism, ``models/transformer.py``);
a ``spatial`` group (:meth:`Mesh.spatial_group`) splits each image's rows
(Mask R-CNN's trunk and FPN with halo exchanges, ``models/resnet.py``).
The ``expert`` axis is a batch axis, as in JAX: the processes of an
``expert`` group read different rows and each holds its experts
(``models/moe.py``). A leaf split over an axis is held whole by the
processes that share this process's coordinate on it
(:meth:`Mesh.holders_group`). With one process the preset's mesh is
ignored, as it always was: every preset trains on the one device.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Tuple

from ..config import MeshConfig

# Axis order matters: 'dcn_data' outermost (slice boundaries are the
# slowest links — only the one gradient allreduce hop should cross them),
# then 'data' so per-host batches stay contiguous (each host feeds only its
# local shard of the batch), then 'expert', 'model' innermost.
AXIS_ORDER: Tuple[str, ...] = ("dcn_data", "pipe", "data", "expert",
                               "spatial", "seq", "model")
# Batch dim 0 shards over all of these jointly (JAX's rule). The other axes
# replicate the batch.
BATCH_AXES: Tuple[str, ...] = ("dcn_data", "data", "expert")

# The axes a multi-process mesh may not use yet, with the ROADMAP A.10 item
# that brings each: none.
UNPORTED_AXES: Dict[str, str] = {}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Resolved logical mesh shape (all axes concrete, product == #devices)."""

    data: int
    model: int = 1
    spatial: int = 1
    dcn_data: int = 1
    expert: int = 1
    pipe: int = 1
    seq: int = 1

    @property
    def num_devices(self) -> int:
        return (self.data * self.model * self.spatial * self.dcn_data
                * self.expert * self.pipe * self.seq)

    def axis_sizes(self) -> Dict[str, int]:
        return {"dcn_data": self.dcn_data, "pipe": self.pipe,
                "data": self.data, "expert": self.expert,
                "spatial": self.spatial, "seq": self.seq,
                "model": self.model}

    @classmethod
    def resolve(cls, cfg: MeshConfig, num_devices: int) -> "MeshSpec":
        """Resolve ``data = -1`` ("all remaining devices") against a device
        count and validate divisibility — the topology math the reference did
        by hand via ``$DEEPLEARNING_WORKERS_COUNT × GPUs``."""
        model = cfg.model
        spatial = cfg.spatial
        expert = getattr(cfg, "expert", 1)
        pipe = getattr(cfg, "pipe", 1)
        seq = getattr(cfg, "seq", 1)
        slices = getattr(cfg, "num_slices", 1)
        if min(model, spatial, slices, expert, pipe, seq) < 1:
            raise ValueError(f"mesh axes must be >=1, got {cfg}")
        if num_devices % slices != 0:
            raise ValueError(
                f"num_slices={slices} does not divide device count "
                f"{num_devices}")
        per_slice = num_devices // slices
        fixed = model * spatial * expert * pipe * seq
        if per_slice % fixed != 0:
            raise ValueError(
                f"pipe*model*spatial*seq*expert={fixed} does not divide "
                f"per-slice device count {per_slice}"
            )
        data = cfg.data
        if data == -1:
            data = per_slice // fixed
        if data * fixed != per_slice:
            raise ValueError(
                f"mesh {pipe}x{data}x{expert}x{spatial}x{seq}x{model} != "
                f"{per_slice} devices/slice; set data=-1 to auto-size"
            )
        return cls(data=data, model=model, spatial=spatial,
                   dcn_data=slices, expert=expert, pipe=pipe, seq=seq)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The job's mesh: one device per process. ``shape`` maps every axis of
    :data:`AXIS_ORDER` to its size; process ``process_index`` sits at
    ``coords`` (row-major over :data:`AXIS_ORDER`, as JAX lays the device
    array out), and its rows of a global batch are the
    ``process_index``-th contiguous block."""

    shape: Dict[str, int]
    process_index: int = 0
    process_count: int = 1

    @property
    def size(self) -> int:
        """Devices in the mesh (one per process)."""
        return math.prod(self.shape.values())

    @property
    def coords(self) -> Dict[str, int]:
        out, rest = {}, self.process_index
        for axis in reversed(AXIS_ORDER):
            out[axis] = rest % self.shape[axis]
            rest //= self.shape[axis]
        return {a: out[a] for a in AXIS_ORDER}

    @property
    def data_ways(self) -> int:
        """The blocks a global batch splits into (:func:`data_axis_size`)."""
        return data_axis_size(self)

    @property
    def data_index(self) -> int:
        """This process's block of a global batch: its coordinate over the
        batch axes jointly, row-major (JAX's ``P(BATCH_AXES)`` on dim 0).
        The processes of one ``seq`` or ``pipe`` group share it."""
        c, idx = self.coords, 0
        for axis in BATCH_AXES:
            idx = idx * self.shape[axis] + c[axis]
        return idx

    @property
    def seq_ways(self) -> int:
        return self.shape["seq"]

    @property
    def seq_index(self) -> int:
        """This process's place in the global sequence: its slice is the
        ``seq_index``-th of ``seq_ways`` equal slices."""
        return self.coords["seq"]

    def rank_of(self, coords: Dict[str, int]) -> int:
        """The process at ``coords`` (row-major over :data:`AXIS_ORDER`)."""
        rank = 0
        for axis in AXIS_ORDER:
            rank = rank * self.shape[axis] + coords[axis]
        return rank

    @property
    def pipe_ways(self) -> int:
        return self.shape["pipe"]

    @property
    def pipe_index(self) -> int:
        """This process's stage: it holds the ``pipe_index``-th of
        ``pipe_ways`` equal slices of each stacked layer leaf."""
        return self.coords["pipe"]

    @property
    def expert_ways(self) -> int:
        return self.shape["expert"]

    @property
    def expert_index(self) -> int:
        """This process's experts: the ``expert_index``-th of
        ``expert_ways`` equal slices of each stacked expert leaf."""
        return self.coords["expert"]

    @property
    def model_ways(self) -> int:
        return self.shape["model"]

    @property
    def model_index(self) -> int:
        """This process's heads and hidden units: the ``model_index``-th of
        ``model_ways`` equal slices of each tensor-parallel layer."""
        return self.coords["model"]

    @property
    def spatial_ways(self) -> int:
        return self.shape["spatial"]

    @property
    def spatial_index(self) -> int:
        """This process's rows of an image: the ``spatial_index``-th of
        ``spatial_ways`` equal slices of its height."""
        return self.coords["spatial"]

    @property
    def replicas(self) -> int:
        """The processes that hold each row of a batch (those that differ
        only outside :data:`BATCH_AXES`: the ``pipe``, ``spatial``,
        ``seq`` and ``model`` groups)."""
        return self.size // self.data_ways

    def ranks_along(self, axes: Tuple[str, ...]) -> List[int]:
        """The processes that share this one's coordinates outside
        ``axes``, row-major over ``axes`` (in :data:`AXIS_ORDER`)."""
        free = [a for a in AXIS_ORDER if a in axes]
        return [self.rank_of({**self.coords, **dict(zip(free, at))})
                for at in itertools.product(
                    *(range(self.shape[a]) for a in free))]

    @property
    def seq_ranks(self) -> List[int]:
        """The ranks of this process's ``seq`` group, in ``seq`` order."""
        return self.ranks_along(("seq",))

    @property
    def data_ranks(self) -> List[int]:
        """The ranks that hold this process's slice of the sequence and its
        stage, one per block of the batch, in :attr:`data_index` order."""
        return self.ranks_along(BATCH_AXES)

    @property
    def pipe_ranks(self) -> List[int]:
        """The ranks of this process's ``pipe`` group, in stage order."""
        return self.ranks_along(("pipe",))

    @property
    def model_ranks(self) -> List[int]:
        """The ranks of this process's ``model`` group, in ``model``
        order."""
        return self.ranks_along(("model",))

    @property
    def spatial_ranks(self) -> List[int]:
        """The ranks of this process's ``spatial`` group, in row order."""
        return self.ranks_along(("spatial",))

    @property
    def expert_ranks(self) -> List[int]:
        """The ranks of this process's ``expert`` group, in ``expert``
        order."""
        return self.ranks_along(("expert",))

    def holder_ranks(self, axis: str) -> List[int]:
        """The ranks that hold the same slice of a leaf split over
        ``axis`` as this process: those with its coordinate on ``axis``."""
        return self.ranks_along(_all_but(axis))

    def group(self, axes: Tuple[str, ...]):
        """The process group of :meth:`ranks_along` ``axes`` (one of
        :data:`_PARTITIONS`); None when this process is alone in it."""
        return _groups(self)[axes]

    def seq_group(self):
        """The process group of :attr:`seq_ranks` (ring and Ulysses
        attention, the heads' gather)."""
        return self.group(("seq",))

    def data_group(self):
        """The process group of :attr:`data_ranks` (the MoE router's
        statistics)."""
        return self.group(BATCH_AXES)

    def pipe_group(self):
        """The process group of :attr:`pipe_ranks` (the stage hops and the
        masked sum of the last stage's output)."""
        return self.group(("pipe",))

    def expert_group(self):
        """The process group of :attr:`expert_ranks` (the MoE
        all-to-alls)."""
        return self.group(("expert",))

    def model_group(self):
        """The process group of :attr:`model_ranks` (the sums after the
        row-parallel products)."""
        return self.group(("model",))

    def spatial_group(self):
        """The process group of :attr:`spatial_ranks` (the conv halos and
        the pyramid's gather)."""
        return self.group(("spatial",))

    def holders_group(self, axis: str):
        """The process group of :meth:`holder_ranks` (the gradient sum of a
        leaf split over ``axis``)."""
        return self.group(_all_but(axis))


def _all_but(axis: str) -> Tuple[str, ...]:
    return tuple(a for a in AXIS_ORDER if a != axis)


# The partitions of the processes that the port's collectives run over:
# each process belongs to one group of each.
_PARTITIONS: Tuple[Tuple[str, ...], ...] = (
    ("seq",), BATCH_AXES, ("pipe",), ("expert",), _all_but("pipe"),
    _all_but("expert"), ("model",), _all_but("model"), ("spatial",))
# (shape, world) -> {partition: this process's group or None}.
_GROUPS: Dict[tuple, dict] = {}


def _groups(mesh: Mesh) -> dict:
    """This process's group in each of :data:`_PARTITIONS`, all created at
    the first use of any, once per mesh shape. ``dist.new_group`` is
    collective over the world: every process creates every group of more
    than one process, in the same order, and keeps its own."""
    if mesh.process_count == 1:
        return dict.fromkeys(_PARTITIONS)
    key = (tuple(mesh.shape.items()), mesh.process_count)
    if key not in _GROUPS:
        import torch.distributed as dist

        mine = {}
        for axes in _PARTITIONS:
            groups = {}
            for r in range(mesh.process_count):
                ranks = tuple(dataclasses.replace(
                    mesh, process_index=r).ranks_along(axes))
                if len(ranks) > 1 and ranks not in groups:
                    groups[ranks] = dist.new_group(list(ranks))
            mine[axes] = groups.get(tuple(mesh.ranks_along(axes)))
        _GROUPS[key] = mine
    return _GROUPS[key]


def process_index() -> int:
    """This process's rank in the job (0 without a process group)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def process_count() -> int:
    """Processes in the job (1 without a process group)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def build_mesh(cfg: Optional[MeshConfig] = None,
               num_processes: Optional[int] = None,
               index: Optional[int] = None) -> Mesh:
    """The mesh of this job: ``cfg`` resolved over the processes of the
    process group (``num_processes`` and ``index`` default to it). One
    process ignores ``cfg`` (every axis 1, as the one-device port always
    trained); more resolve it as JAX does (:meth:`MeshSpec.resolve`). The
    groups are made at first use
    (:meth:`Mesh.group`), so a mesh can be resolved without a process
    group."""
    n = process_count() if num_processes is None else num_processes
    rank = process_index() if index is None else index
    if n == 1:
        return Mesh(shape=dict.fromkeys(AXIS_ORDER, 1))
    spec = MeshSpec.resolve(cfg or MeshConfig(), n)
    sizes = spec.axis_sizes()
    for axis, item in UNPORTED_AXES.items():
        if sizes[axis] > 1:
            raise NotImplementedError(
                f"mesh axis {axis}={sizes[axis]} over {n} processes needs "
                f"{item}, not ported yet (ROADMAP A.10) — set "
                f"mesh.{axis}=1")
    return Mesh(shape={a: sizes[a] for a in AXIS_ORDER},
                process_index=rank, process_count=n)


def data_axis_size(mesh: Mesh) -> int:
    """Total batch-sharding ways: the 'data' axis times the cross-slice
    'dcn_data' axis times the 'expert' axis."""
    return (mesh.shape["data"] * mesh.shape.get("dcn_data", 1)
            * mesh.shape.get("expert", 1))


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    """Per-process batch size: the global batch divided over the data ways
    (Horovod's per-rank batch); the processes of a ``seq``, ``pipe``,
    ``model`` or ``spatial`` group hold the same rows."""
    if global_batch % data_axis_size(mesh) != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by data-axis size "
            f"{data_axis_size(mesh)}"
        )
    return global_batch // data_axis_size(mesh)


def validate_batch(global_batch: int, mesh: Mesh) -> None:
    if global_batch % data_axis_size(mesh) != 0:
        raise ValueError(
            f"global batch {global_batch} must be divisible by the total "
            f"data-parallel ways ({data_axis_size(mesh)})"
        )


def describe(mesh: Mesh) -> str:
    """Human-readable topology line for logs (the JAX package's)."""
    axes = ", ".join(f"{a}={s}" for a, s in mesh.shape.items())
    return (f"mesh[{axes}] over {mesh.size} devices "
            f"({mesh.process_count} processes, 1 local)")


def slice_chip_count(slice_type: str) -> int:
    """Chips in a TPU slice type string like 'v5p-8' (the number suffix is
    the chip count for v5p/v4 naming)."""
    try:
        return int(slice_type.rsplit("-", 1)[1])
    except (IndexError, ValueError) as e:
        raise ValueError(f"cannot parse slice type {slice_type!r}") from e


def hosts_for_slice(slice_type: str, chips_per_host: int = 4) -> int:
    chips = slice_chip_count(slice_type)
    return max(1, math.ceil(chips / chips_per_host))
