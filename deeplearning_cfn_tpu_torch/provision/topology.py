"""TPU slice topology catalog.

A copy of the JAX package's ``provision/topology.py``, which imports
nothing of JAX (the port never imports that package).

The reference's cluster shape was two CFN Parameters (instance type × worker
count); on TPU the shape is the slice type itself. This table is the
rebuild's authority on what a slice type means physically: chip count, hosts,
chips per host, and the ICI torus dimensions — the inputs to mesh
construction (parallel/mesh.py) and to the provisioner's readiness check.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Tuple

# chips per host by generation. v4/v5p hosts expose 4 chips; v5e/v6e hosts 8
# (their inference-oriented boards); v2/v3 boards had 4 chips (8 cores).
_CHIPS_PER_HOST: Dict[str, int] = {
    "v2": 4, "v3": 4, "v4": 4, "v5p": 4, "v5e": 8, "v5litepod": 8, "v6e": 8,
}

# Max chips of a single slice per generation (pod size).
_POD_CHIPS: Dict[str, int] = {
    "v2": 512, "v3": 1024, "v4": 4096, "v5p": 8960, "v5e": 256,
    "v5litepod": 256, "v6e": 256,
}


@dataclasses.dataclass(frozen=True)
class SliceTopology:
    """Resolved physical shape of one slice type."""

    slice_type: str       # e.g. "v5p-256"
    generation: str       # e.g. "v5p"
    num_chips: int
    chips_per_host: int
    num_hosts: int
    ici_mesh: Tuple[int, ...]  # 3D torus dims for v4/v5p; 2D for v5e/v6e

    @property
    def accelerator_type(self) -> str:
        """The GCP API accelerator-type string."""
        return self.slice_type


def _torus_dims(num_chips: int, dims: int) -> Tuple[int, ...]:
    """Factor a chip count into a near-cubic (or near-square) torus — the
    physical ICI wiring is a torus of these dims; mesh_utils uses the same
    factorization when laying logical axes onto it."""
    if dims == 2:
        side = int(math.sqrt(num_chips))
        while side > 1 and num_chips % side:
            side -= 1
        return (side, num_chips // side)
    shape = [1, 1, 1]
    remaining = num_chips
    for i in range(3):
        target = round(remaining ** (1.0 / (3 - i)))
        f = max(1, target)
        while f > 1 and remaining % f:
            f -= 1
        shape[i] = f
        remaining //= f
    shape[2] *= remaining
    return tuple(sorted(shape))


def slice_topology(slice_type: str) -> SliceTopology:
    """Parse a slice type like ``v5p-256`` into its physical topology.

    The numeric suffix follows GCP naming: for v2/v3 it is TensorCore count
    (2 cores/chip), for v4/v5p/v5e/v6e it is chip count.
    """
    m = re.fullmatch(r"(v\d+[a-z]*|v5litepod)-(\d+)", slice_type.strip())
    if not m:
        raise ValueError(
            f"cannot parse slice type {slice_type!r} "
            "(expected e.g. 'v5p-8', 'v4-32', 'v5e-16')"
        )
    gen, n = m.group(1), int(m.group(2))
    if gen not in _CHIPS_PER_HOST:
        raise ValueError(
            f"unknown TPU generation {gen!r}; known: {sorted(_CHIPS_PER_HOST)}"
        )
    chips = n // 2 if gen in ("v2", "v3") else n
    if chips < 1:
        raise ValueError(f"slice {slice_type!r} has no chips")
    if chips > _POD_CHIPS[gen]:
        raise ValueError(
            f"{slice_type!r} exceeds the {gen} pod size "
            f"({_POD_CHIPS[gen]} chips)"
        )
    cph = _CHIPS_PER_HOST[gen]
    hosts = max(1, math.ceil(chips / cph))
    dims = 2 if gen in ("v5e", "v5litepod", "v6e") else 3
    return SliceTopology(
        slice_type=slice_type,
        generation=gen,
        num_chips=chips,
        chips_per_host=cph,
        num_hosts=hosts,
        ici_mesh=_torus_dims(chips, dims),
    )
