"""The weight bridge: Flax ``TransformerNMT`` params → the port's state_dict.

``params_from_flax`` takes the flat ``"a/b/c"`` numpy tree of the JAX
model's params (the leaf names the JAX checkpoint manifest uses) and
returns a ``state_dict`` for :class:`~.models.transformer_nmt.TransformerNMT`:

- ``nn.Dense`` kernels ``[in, out]`` become ``Dense.weight`` ``[out, in]``;
- LayerNorm ``scale``/``bias`` become ``weight``/``bias``;
- the tied ``embed/token/embedding`` table becomes ``embed.token.weight``,
  and ``embed/src_position``/``embed/tgt_position`` keep their names;
- Flax's setup-list layer names ``enc_3``/``dec_3`` become ``enc.3``/``dec.3``.

``load_flax_checkpoint`` reads a committed single-process JAX checkpoint
(``step_<N>/{manifest.json, manifest_p0.json, shards_p0.npz, COMMIT}``,
arrays stored as ``<leaf name>::<i>`` shards with their global index ranges)
with numpy only — no JAX, no Flax.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_LAYER = re.compile(r"^(enc|dec)_(\d+)$")
_STEP = re.compile(r"^step_(\d+)$")


def _torch_key(flax_key: str) -> Tuple[str, bool]:
    """Port state_dict key for one Flax leaf name, and whether the value
    must be transposed."""
    parts = flax_key.split("/")
    if parts and parts[0] == "params":
        parts = parts[1:]
    out = []
    for p in parts:
        m = _LAYER.match(p)
        out.extend([m.group(1), m.group(2)] if m else [p])
    leaf = out[-1]
    transpose = False
    if leaf == "kernel":
        out[-1], transpose = "weight", True
    elif leaf == "scale":
        out[-1] = "weight"
    elif leaf == "embedding":
        out[-1] = "weight"
    return ".".join(out), transpose


def params_from_flax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat ``{"a/b/c": array}`` Flax params (an optional leading ``params/``
    is stripped) → state_dict of f32 CPU tensors."""
    state = {}
    for name, value in flat.items():
        key, transpose = _torch_key(name)
        arr = np.array(value, dtype=np.float32)
        if transpose:
            if arr.ndim != 2:
                raise ValueError(f"{name}: Dense kernel must be 2-D, got "
                                 f"{arr.shape}")
            arr = arr.T
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def committed_steps(ckpt_dir: str):
    """Sorted committed checkpoint steps under ``ckpt_dir`` (``[]`` when the
    directory does not exist)."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        m = _STEP.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "COMMIT")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def load_flax_checkpoint(ckpt_dir: str, step: Optional[int] = None
                         ) -> Tuple[Dict[str, np.ndarray], int]:
    """Read the ``params`` leaves of a committed JAX checkpoint → (flat
    ``{"a/b/c": array}`` without the ``params/`` prefix, step). ``step``
    None/0 means the latest committed one."""
    steps = committed_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    if step:
        if step not in steps:
            raise FileNotFoundError(
                f"step {step} is not a committed checkpoint in {ckpt_dir} "
                f"(committed: {steps})")
    else:
        step = steps[-1]
    root = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(root, "manifest.json")) as fh:
        manifest = json.load(fh)
    if int(manifest.get("processes", 1)) > 1:
        raise ValueError(
            f"checkpoint {root} was written by {manifest['processes']} "
            f"processes; the port reads single-process checkpoints only "
            f"(restore it with the JAX package and save it from one "
            f"process first)")
    with open(os.path.join(root, "manifest_p0.json")) as fh:
        shard_index = json.load(fh)["leaves"]
    flat = {}
    with np.load(os.path.join(root, "shards_p0.npz")) as npz:
        for name, meta in manifest["leaves"].items():
            if meta.get("kind") != "array" or not name.startswith("params/"):
                continue
            out = np.empty(tuple(meta["shape"]), dtype=np.dtype(meta["dtype"]))
            for entry in shard_index[name]:
                region = tuple(slice(a, b) for a, b in entry["index"])
                out[region] = npz[entry["key"]]
            flat[name[len("params/"):]] = out
    if not flat:
        raise ValueError(f"checkpoint {root} holds no params/ leaves")
    return flat, step
