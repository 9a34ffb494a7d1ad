"""Weight-only int8 quantization and the int8 KV pool's helpers.

The port of ``deeplearning_cfn_tpu/serve/quant.py``. Decode re-reads every
weight per generated token, so int8 weights shrink the per-token bytes:

- every 2-D weight (the attention Q/K/V/out and MLP projections, and the
  tied token table) is stored as int8 codes plus a per-output-channel f32
  ``scale`` (symmetric absmax, ``scale = amax / 127``; codes in
  ``[-127, 127]``, rounded half to even as ``np.rint`` rounds);
- biases, LayerNorms and the two position tables stay f32;
- the scale multiplies after the product (``models.transformer.QuantDense``
  / ``QuantEmbed``), so the int8 tensor is what the model holds.

The channel is the JAX layout's last axis: a Flax ``kernel`` is ``[in,
out]`` where the port's ``weight`` is ``[out, in]``, so a Dense weight is
quantized transposed; the token table is ``[V, H]`` in both, one scale per
hidden channel.

The JAX package quantizes a variables tree for a ``quantized=True`` clone.
The port's model holds its weights, so :func:`quantize_model` returns the
quantized copy of a model (its weights quantized from the source's) and
:func:`quantize_state_dict` quantizes an f32 state_dict into that copy's
key layout (``swap_variables`` loads it). The int8 KV pool is a cache
layout, chosen by ``TransformerNMT.init_paged_cache(..., kv_quant=)``.
"""

from __future__ import annotations

import copy
from typing import Dict, Tuple

import torch

QUANT_DTYPES = ("int8",)

# KV-cache quantization dtypes (``--kv-quant``). Separate from the weight
# list because the two knobs compose but gate independently.
KV_QUANT_DTYPES = ("int8",)

# Symmetric int8 code range. +-127 (not -128) keeps the grid symmetric so
# scale * code is an odd function of the weight: no zero-point.
_QMAX = 127.0


def check_quant_dtype(dtype: str) -> None:
    if dtype not in QUANT_DTYPES:
        raise ValueError(
            f"unsupported quantization dtype {dtype!r} "
            f"(supported: {', '.join(QUANT_DTYPES)})")


def check_kv_quant_dtype(dtype: str) -> None:
    if dtype not in KV_QUANT_DTYPES:
        raise ValueError(
            f"unsupported KV quantization dtype {dtype!r} "
            f"(supported: {', '.join(KV_QUANT_DTYPES)})")


def _quantize_array(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absmax-symmetric int8 codes + f32 scales per channel of the LAST
    axis (the JAX layout's output axis)."""
    w = w.detach().float()
    amax = w.abs().amax(dim=tuple(range(w.ndim - 1)))
    scale = torch.where(amax > 0.0, amax / _QMAX, torch.ones_like(amax))
    # A true division, as numpy divides: a multiply by 1/scale rounds some
    # codes the other way.
    q = torch.clamp(torch.round(w / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale


def quantize_weight(weight: torch.Tensor, transposed: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes in ``weight``'s layout, f32 scales). ``transposed``: the
    port's ``[out, in]`` Dense weight, quantized per output channel."""
    if transposed:
        q, scale = _quantize_array(weight.t())
        return q.t().contiguous(), scale
    return _quantize_array(weight)


def quantize_model(model: torch.nn.Module, dtype: str = "int8"
                   ) -> torch.nn.Module:
    """A quantized copy of ``model`` (which stays untouched): every
    ``Dense`` becomes a ``QuantDense`` and the NMT's token table a
    ``QuantEmbed``, each holding the int8 codes and scales of the source's
    weights. The JAX package's ``quantized_model`` + ``quantize_variables``
    in one step. ``model`` must expose a ``quantized`` attribute (the NMT
    does)."""
    from ..models.transformer import Dense, QuantDense, QuantEmbed
    from ..models.transformer_nmt import NmtEmbeddings

    check_quant_dtype(dtype)
    if not hasattr(model, "quantized"):
        raise ValueError(
            f"{type(model).__name__} has no 'quantized' field — int8 "
            "serving needs the shared transformer blocks")
    out = copy.deepcopy(model)
    for parent in list(out.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, Dense):
                setattr(parent, name, QuantDense.from_dense(child))
            elif isinstance(parent, NmtEmbeddings) and name == "token":
                setattr(parent, name, QuantEmbed.from_embedding(child))
    out.quantized = True
    return out.requires_grad_(False)


def quantize_state_dict(state: Dict[str, torch.Tensor], dtype: str = "int8"
                        ) -> Dict[str, torch.Tensor]:
    """An f32 state_dict in the port's key layout (what
    ``convert.params_from_flax`` returns) → the quantized copy's: every 2-D
    ``weight`` becomes int8 codes plus a sibling ``scale``, everything else
    passes through. The rule is the JAX one (a 2-D ``kernel`` or
    ``embedding``): LayerNorm weights are 1-D, the position tables are not
    named ``weight``, and the token table ``embed.token.weight`` is the one
    2-D weight that is not a Dense kernel."""
    check_quant_dtype(dtype)
    out = {}
    for key, val in state.items():
        if key.endswith(".weight") and val.ndim == 2:
            q, scale = quantize_weight(
                val, transposed=key != "embed.token.weight")
            out[key] = q
            out[key[:-len("weight")] + "scale"] = scale
        else:
            out[key] = val
    return out


def variables_bytes(model_or_state) -> int:
    """Weight bytes as stored (int8 codes count 1 byte each): the number
    the JAX bench reports as ``weight_bytes``."""
    state = model_or_state.state_dict() \
        if isinstance(model_or_state, torch.nn.Module) else model_or_state
    return int(sum(t.numel() * t.element_size() for t in state.values()))


def dequantize_kv_blocks(codes: torch.Tensor,
                         scales: torch.Tensor) -> torch.Tensor:
    """Dequantized pool blocks: ``codes`` [..., H, block, D] int8 times
    ``scales`` [..., H], in f32 — the inverse of the per-block absmax
    write."""
    return codes.float() * scales.float()[..., :, None, None]


def kv_pool_bytes(cache, num_blocks: int) -> Tuple[int, int]:
    """(bytes as stored, f32-equivalent bytes) over the block-pool tensors
    of a paged cache (per layer: the K/V pools and, for an int8 pool, their
    scale sidecars). Scales count into the stored bytes but not into the
    f32 equivalent, which is the plain pool's."""
    from .blockpool import is_pool_leaf

    stored = fp32 = 0
    for layer in cache:
        for t in layer:
            if not is_pool_leaf(t, num_blocks):
                continue
            stored += t.numel() * t.element_size()
            if t.ndim == 4:  # the code/value pool, not a scale sidecar
                fp32 += t.numel() * 4
    return stored, fp32
