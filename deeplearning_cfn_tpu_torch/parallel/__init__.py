"""Parallelism layer of the port: the mesh over the job's processes
(``mesh.py``), the batch and sequence layout (``sharding.py``) and the
collectives (``collectives.py``).

The JAX package's collectives are XLA's, scheduled over ICI inside the
compiled step. The port's are ``torch.distributed``'s over the process group
that ``runtime.cluster.initialize`` joins: NCCL when every process of a
machine has a card of its own, gloo otherwise. Data parallelism across
processes is ported (the ``dcn_data`` and ``data`` axes), and so are
sequence parallelism (the ``seq`` axis: ring and Ulysses attention in
``ops/``), pipeline parallelism (the ``pipe`` axis: ``ops/pipeline.py``'s
GPipe schedule) and expert parallelism (the ``expert`` axis:
``models/moe.py``'s all-to-all dispatch), tensor parallelism (the
``model`` axis: ``models/transformer.py``'s column and row pieces) and
Mask R-CNN's spatial shard (the ``spatial`` axis: ``models/resnet.py``'s
halos, ``models/maskrcnn.py``'s gathered pyramid).
"""

from .mesh import (  # noqa: F401
    AXIS_ORDER,
    BATCH_AXES,
    Mesh,
    MeshSpec,
    build_mesh,
    data_axis_size,
    describe,
    hosts_for_slice,
    local_batch_size,
    process_count,
    process_index,
    slice_chip_count,
    validate_batch,
)
from .sharding import (Elsewhere, Piece, Rows, batch_sharding,  # noqa: F401
                       local_shard, param_pieces, seq_slice, spatial_slice)
