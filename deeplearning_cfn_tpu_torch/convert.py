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

- BERT's setup-free auto-names ``layer_3`` become ``layer.3``, and its
  ``embed``, ``mlm_transform``, ``mlm_norm``, ``mlm_bias``, ``pooler`` and
  ``nsp_head`` keep their names.
- The causal LM's ``layer_3`` becomes ``layer.3`` too; its tied
  ``token/embedding`` becomes ``token.weight`` (one parameter for the
  lookup and the logits), and ``position`` (a raw [max_len, hidden] table),
  ``embed_norm`` and ``final_norm`` keep their names.
- ViT: ``patch_embed`` is a conv (HWIO ↔ OIHW), ``head`` a Dense,
  ``final_norm`` a LayerNorm; ``pos_embed`` (a raw [N, hidden] table) and
  ``layer_3`` → ``layer.3`` as above.
- A MoE layer's ``moe_mlp/router/kernel`` is a Dense kernel (transposed);
  its stacked ``moe_mlp/w_in``, ``b_in``, ``w_out`` and ``b_out`` keep the
  JAX layout, untransposed.
- The pipelined BERT's ``pipe_stack/*`` leaves (every trunk kernel
  [L, in, out], biases and LayerNorm scales [L, F]) keep the JAX layout,
  untransposed; ``embed`` and the heads keep their names.
- An int8 tree (the JAX ``serve/quant.py:quantize_variables`` output) maps
  to the port's quantized NMT copy (``serve/quant.py:quantize_model``): a
  ``scale`` beside a 2-D ``kernel`` or ``embedding`` is that layer's
  per-channel scale and keeps its name (a LayerNorm's ``scale``, which has
  no such sibling, still becomes ``weight``), and int8 codes stay int8 —
  a ``kernel``'s transposed to ``[out, in]`` like any Dense kernel.

``flax_layout`` is the inverse: every parameter and BatchNorm buffer of a
port model with its Flax leaf name (``params/...``, ``batch_stats/...``)
and the layout change between the two (``to_flax``/``from_flax``). The
checkpoint bridge (``train/state.py``) names the port's leaves with it.

``load_flax_checkpoint`` reads the ``params`` and ``batch_stats`` leaves of a
committed JAX checkpoint (``step_<N>/{manifest.json, manifest_p<K>.json,
shards_p<K>.npz, COMMIT}``) through ``ckpt/checkpoint.py`` — numpy only, no
JAX, no Flax.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import ckpt

_LAYER = re.compile(r"^(enc|dec|layer)_(\d+)$")
_LISTS = {"enc", "dec", "layer"}
_RESNET = {"BottleneckBlock": "blocks", "BasicBlock": "blocks",
           "Conv": "convs", "BatchNorm": "norms"}
_AUTO_NAME = re.compile(r"^(%s)_(\d+)$" % "|".join(_RESNET))
_STATS = {"mean": "running_mean", "var": "running_var"}
_KERNEL_MODULES = ("Dense", "Conv")
_SCALE_MODULES = ("LayerNorm", "BatchNorm")


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
    ``batch_stats`` collection → state_dict of f32 CPU tensors (int8 codes
    of a quantized tree stay int8)."""
    leaves = dict(flat)
    for name, value in (batch_stats or {}).items():
        if not name.startswith("batch_stats/"):
            name = f"batch_stats/{name}"
        leaves[name] = value
    # Layers whose ``scale`` is a quantization scale, not a LayerNorm's.
    quantized = {name.rpartition("/")[0] for name, value in leaves.items()
                 if name.rpartition("/")[2] in ("kernel", "embedding")
                 and np.ndim(value) == 2}
    state = {}
    for name, value in leaves.items():
        key, transpose = _torch_key(name)
        parent, _, leaf = name.rpartition("/")
        if leaf == "scale" and parent in quantized:
            key = key[:-len("weight")] + "scale"
        arr = np.array(value, dtype=np.int8 if np.asarray(value).dtype
                       == np.int8 else np.float32)
        if transpose:
            if arr.ndim not in (2, 4):
                raise ValueError(f"{name}: a kernel must be 2-D (Dense) or "
                                 f"4-D (Conv), got {arr.shape}")
            arr = from_flax(arr, "dense" if arr.ndim == 2 else "conv")
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def to_flax(value: np.ndarray, kind: str) -> np.ndarray:
    """A port leaf in Flax's layout (``kind`` from :func:`flax_layout`)."""
    if kind == "dense":
        return value.T  # [out, in] → [in, out]
    if kind == "conv":
        return value.transpose(2, 3, 1, 0)  # OIHW → HWIO
    return value


def from_flax(value: np.ndarray, kind: str) -> np.ndarray:
    """A Flax leaf in the port's layout (the inverse of :func:`to_flax`)."""
    if kind == "dense":
        return value.T  # [in, out] → [out, in]
    if kind == "conv":
        return value.transpose(3, 2, 0, 1)  # HWIO → OIHW
    return value


def _flax_module_path(model: torch.nn.Module, mod_name: str) -> List[str]:
    parts = mod_name.split(".") if mod_name else []
    out: List[str] = []
    for i, p in enumerate(parts):
        if not p.isdigit():
            out.append(p)
            continue
        owner = parts[i - 1]
        if owner in _LISTS:
            out[-1] = f"{owner}_{p}"
        elif owner == "blocks":
            block = model.get_submodule(".".join(parts[:i + 1]))
            out[-1] = f"{type(block).__name__}_{p}"
        elif owner in ("convs", "norms"):
            out[-1] = f"{'Conv' if owner == 'convs' else 'BatchNorm'}_{p}"
        else:
            raise ValueError(f"{mod_name}: no Flax name for list {owner!r}")
    return out


def flax_layout(model: torch.nn.Module
                ) -> List[Tuple[str, str, torch.Tensor, str]]:
    """``(flax name, port state_dict key, tensor, kind)`` for every
    parameter and BatchNorm running statistic of ``model``, in the model's
    order. ``kind`` is ``"dense"``/``"conv"`` for kernels (transposed
    between the layouts) and ``"none"`` otherwise."""
    out = []
    for mod_name, mod in model.named_modules():
        path = _flax_module_path(model, mod_name)
        cls = type(mod).__name__
        own = list(mod.named_parameters(recurse=False)) + \
            list(mod.named_buffers(recurse=False))
        for name, t in own:
            key = f"{mod_name}.{name}" if mod_name else name
            kind, collection = "none", "params"
            if name in ("running_mean", "running_var"):
                collection = "batch_stats"
                leaf = "mean" if name == "running_mean" else "var"
            elif name == "weight" and cls in _KERNEL_MODULES:
                leaf, kind = "kernel", "dense" if t.ndim == 2 else "conv"
            elif name == "weight" and cls in _SCALE_MODULES:
                leaf = "scale"
            elif name == "weight" and isinstance(mod, torch.nn.Embedding):
                leaf = "embedding"
            else:
                leaf = name
            out.append(("/".join([collection, *path, leaf]), key, t, kind))
    return out


def committed_steps(ckpt_dir: str):
    """Sorted committed checkpoint steps under ``ckpt_dir`` (``[]`` when the
    directory does not exist)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return ckpt.committed_steps(ckpt_dir)


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
    leaves = ckpt.read_leaves(ckpt_dir, step, lambda n: n.startswith(
        ("params/", "batch_stats/")))
    flat = {(n[len("params/"):] if n.startswith("params/") else n): v
            for n, v in leaves.items() if v is not None}
    if not any(not k.startswith("batch_stats/") for k in flat):
        raise ValueError(f"checkpoint {ckpt_dir} step {step} holds no "
                         f"params/ leaves")
    return flat, step
