"""The weight bridge: Flax params (and batch stats) → the port's state_dict.

``params_from_flax`` takes the flat ``"a/b/c"`` numpy tree of a JAX model's
params (the leaf names the JAX checkpoint manifest uses) and returns a
``state_dict`` for the port's model of the same family:

- ``nn.Dense`` kernels ``[in, out]`` become ``weight`` ``[out, in]``;
- ``nn.Conv`` kernels HWIO ``[kh, kw, in, out]`` become OIHW ``weight``;
- LayerNorm and BatchNorm ``scale``/``bias`` become ``weight``/``bias``;
- the ``batch_stats`` collection's BatchNorm ``mean``/``var`` become the
  ``running_mean``/``running_var`` buffers (pass it as ``batch_stats``, or
  as ``batch_stats/...`` leaves of ``flat``);
- the tied ``embed/token/embedding`` table becomes ``embed.token.weight``,
  and ``embed/src_position``/``embed/tgt_position`` keep their names;
- Flax's layer names map to the port's modules: the NMT's setup-list
  ``enc_3``/``dec_3`` become ``enc.3``/``dec.3``; the ResNet's auto-names
  ``BottleneckBlock_N``/``BasicBlock_N`` become ``blocks.N``, ``Conv_i``
  ``convs.i`` and ``BatchNorm_i`` ``norms.i`` (``conv_init``,
  ``conv_init_s2d``, ``norm_init``, ``conv_proj``, ``norm_proj`` and
  ``head`` keep their names).

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
_RESNET = {"BottleneckBlock": "blocks", "BasicBlock": "blocks",
           "Conv": "convs", "BatchNorm": "norms"}
_AUTO_NAME = re.compile(r"^(%s)_(\d+)$" % "|".join(_RESNET))
_STATS = {"mean": "running_mean", "var": "running_var"}
_STEP = re.compile(r"^step_(\d+)$")


def _torch_key(flax_key: str) -> Tuple[str, bool]:
    """Port state_dict key for one Flax leaf name (``params/...`` or
    ``batch_stats/...``; a bare name is a param), and whether the value is
    a kernel to transpose."""
    parts = flax_key.split("/")
    stats = parts[0] == "batch_stats"
    if parts[0] in ("params", "batch_stats"):
        parts = parts[1:]
    out = []
    for p in parts:
        m = _LAYER.match(p) or _AUTO_NAME.match(p)
        if m is None:
            out.append(p)
        else:
            out.extend([_RESNET.get(m.group(1), m.group(1)), m.group(2)])
    leaf = out[-1]
    transpose = False
    if stats:
        if leaf not in _STATS:
            raise ValueError(f"{flax_key}: unknown batch_stats leaf")
        out[-1] = _STATS[leaf]
    elif leaf == "kernel":
        out[-1], transpose = "weight", True
    elif leaf in ("scale", "embedding"):
        out[-1] = "weight"
    return ".".join(out), transpose


def params_from_flax(flat: Dict[str, np.ndarray],
                     batch_stats: Optional[Dict[str, np.ndarray]] = None
                     ) -> Dict[str, torch.Tensor]:
    """Flat ``{"a/b/c": array}`` Flax params (an optional leading ``params/``
    is stripped; ``batch_stats/...`` leaves are stats) and the optional flat
    ``batch_stats`` collection → state_dict of f32 CPU tensors."""
    leaves = dict(flat)
    for name, value in (batch_stats or {}).items():
        if not name.startswith("batch_stats/"):
            name = f"batch_stats/{name}"
        leaves[name] = value
    state = {}
    for name, value in leaves.items():
        key, transpose = _torch_key(name)
        arr = np.array(value, dtype=np.float32)
        if transpose:
            if arr.ndim == 2:    # Dense [in, out] → [out, in]
                arr = arr.T
            elif arr.ndim == 4:  # Conv HWIO → OIHW
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"{name}: a kernel must be 2-D (Dense) or "
                                 f"4-D (Conv), got {arr.shape}")
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
    """Read the ``params`` and ``batch_stats`` leaves of a committed JAX
    checkpoint → (flat ``{"a/b/c": array}`` — params without their
    ``params/`` prefix, batch stats with their ``batch_stats/`` prefix, as
    ``params_from_flax`` takes them — and the step). ``step`` None/0 means
    the latest committed one."""
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
            if meta.get("kind") != "array" or not name.startswith(
                    ("params/", "batch_stats/")):
                continue
            out = np.empty(tuple(meta["shape"]), dtype=np.dtype(meta["dtype"]))
            for entry in shard_index[name]:
                region = tuple(slice(a, b) for a, b in entry["index"])
                out[region] = npz[entry["key"]]
            key = name[len("params/"):] if name.startswith("params/") \
                else name
            flat[key] = out
    if not any(not k.startswith("batch_stats/") for k in flat):
        raise ValueError(f"checkpoint {root} holds no params/ leaves")
    return flat, step
