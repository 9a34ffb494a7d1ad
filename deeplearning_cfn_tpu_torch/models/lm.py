"""Decoder-only causal language models (the GPT family) — the port of
``deeplearning_cfn_tpu/models/lm.py``.

``TransformerCausalLm``: token embedding plus a learned [max_len, hidden]
f32 position table, ``embed_norm`` (then dropout), N pre-LN causal
``TransformerLayer`` blocks, ``final_norm``, and tied logits — the f32
product of the final activations with the f32 token table (Flax's
``Embed.attend`` on an f32 query), so one parameter feeds the lookup and the
output projection. Training and eval run the whole sequence, causal inside
the attention (on the card: the flash kernels forward and backward).
Generation runs :meth:`TransformerCausalLm.decode_step`, one position
against the per-layer KV caches of :meth:`TransformerCausalLm.init_cache`
[B, H, max_len, D], updated in place; every row sits at the same position,
the JAX scalar ``cache_index`` contract.

With ``num_experts > 0`` every ``moe_every``-th block's FFN is a
Mixture-of-Experts FFN (``models/moe.py``) and ``forward`` returns
``(logits, moe_aux)``, the per-layer mean of the MoE layers' aux losses, as
the JAX module does; ``decode_step`` drops the aux (at one position each
expert has one slot), so ``lm_generate`` drives a MoE GPT unchanged.

Module names follow the Flax tree (``layer.3`` for ``layer_3``, ``token``,
``position``, ``embed_norm``, ``final_norm``), so ``convert.params_from_flax``
and ``convert.flax_layout`` carry the weights both ways. Not ported:
``gpt_long``'s sequence-parallel trunk (ROADMAP A.10), which raises.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from . import register_model
from .transformer import (KvCache, LayerNorm, MoeAuxAccumulator,
                          TransformerLayer, dropout, init_flax_defaults,
                          is_moe_layer)


class TransformerCausalLm(nn.Module):
    """Embed → N pre-LN causal blocks → LN → tied logits."""

    def __init__(self, vocab_size: int, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, max_len: int = 1024,
                 dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.0, attention_impl: str = "auto",
                 num_experts: int = 0, moe_every: int = 2,
                 moe_capacity_factor: float = 1.25, moe_top_k: int = 2):
        super().__init__()
        self.num_experts = num_experts
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.mlp_dim = mlp_dim
        self.max_len = max_len
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.token = nn.Embedding(vocab_size, hidden_size)
        self.position = nn.Parameter(torch.empty(max_len, hidden_size))
        self.embed_norm = LayerNorm(hidden_size, dtype)
        self.layer = nn.ModuleList([
            TransformerLayer(hidden_size, num_heads, mlp_dim, dtype,
                             prenorm=True, attention_impl=attention_impl,
                             dropout_rate=dropout_rate,
                             num_experts=num_experts if is_moe_layer(
                                 i, num_experts, moe_every) else 0,
                             moe_capacity_factor=moe_capacity_factor,
                             moe_top_k=moe_top_k)
            for i in range(num_layers)])
        self.final_norm = LayerNorm(hidden_size, dtype)

    @property
    def device(self) -> torch.device:
        return self.token.weight.device

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.final_norm(x).float(), self.token.weight.t())

    def forward(self, tokens: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """f32 logits [B, S, V] of ``tokens`` [B, S] (with MoE layers:
        ``(logits, moe_aux)``). ``train`` applies dropout with masks from
        ``generator``, which a nonzero rate then requires."""
        if not train:
            generator = None
        elif generator is None and self.dropout_rate > 0:
            raise ValueError(
                f"train=True with dropout_rate={self.dropout_rate} needs a "
                f"torch.Generator for the dropout masks")
        x = self.token(tokens) + self.position[None, :tokens.shape[1], :]
        x = dropout(self.embed_norm(x.to(self.dtype)), self.dropout_rate,
                    generator)
        acc = MoeAuxAccumulator(x.device)
        for lyr in self.layer:
            x = lyr(x, causal=True, generator=generator)
            if lyr.num_experts:
                x, aux = x
                acc.add(aux)
        if self.num_experts > 0:
            return self._logits(x), acc.mean()
        return self._logits(x)

    def init_cache(self, batch: int) -> List[KvCache]:
        """Per-layer KV caches [B, H, max_len, D] (zeros, compute dtype)."""
        shape = (batch, self.num_heads, self.max_len,
                 self.hidden_size // self.num_heads)
        return [(torch.zeros(shape, dtype=self.dtype, device=self.device),
                 torch.zeros(shape, dtype=self.dtype, device=self.device))
                for _ in range(self.num_layers)]

    def decode_step(self, token: torch.Tensor, pos: int,
                    cache: List[KvCache]) -> torch.Tensor:
        """``token`` [B, 1] at position ``pos`` → logits [B, 1, V] for
        position ``pos + 1``; this position's K/V land in ``cache``."""
        pos_t = torch.full((token.shape[0],), int(pos), dtype=torch.long,
                           device=token.device)
        x = self.token(token) + self.position[pos_t][:, None, :]
        x = self.embed_norm(x.to(self.dtype))
        for lyr, c in zip(self.layer, cache):
            x = lyr(x, cache=c, pos=pos_t)
            if lyr.num_experts:
                x = x[0]
        return self._logits(x)


def _build(dtype, device, **kw):
    with torch.device(device or "cpu"):
        return TransformerCausalLm(dtype=dtype, **kw)


@register_model("gpt_small")
def gpt_small(num_classes: int = 0, dtype=torch.bfloat16, *,
              vocab_size: int = 32768, max_len: int = 1024,
              device: Optional[torch.device] = None, **kw):
    """GPT-2-small dims (111M parameters with the 32k vocab); ``num_classes``
    is unused (the vocab plays that role)."""
    del num_classes
    return _build(dtype, device, vocab_size=vocab_size, hidden_size=768,
                  num_layers=12, num_heads=12, mlp_dim=3072,
                  max_len=max_len, **kw)


@register_model("gpt_tiny")
def gpt_tiny(num_classes: int = 0, dtype=torch.float32, *,
             vocab_size: int = 512, max_len: int = 128,
             device: Optional[torch.device] = None, **kw):
    """Test-scale config (2 layers, hidden 64, 4 heads) for CPU parity."""
    del num_classes
    return _build(dtype, device, vocab_size=vocab_size, hidden_size=64,
                  num_layers=2, num_heads=4, mlp_dim=128, max_len=max_len,
                  **kw)


@register_model("gpt_long")
def gpt_long(num_classes: int = 0, dtype=torch.bfloat16, **kw):
    raise NotImplementedError(
        "gpt_long's sequence-parallel trunk (ring or Ulysses attention over "
        "the seq mesh axis) is not ported yet (ROADMAP A.10)")


def init_weights(model: TransformerCausalLm,
                 generator: torch.Generator) -> None:
    """Seeded init with Flax's distributions (``init_flax_defaults``): the
    token table and the position table ``normal(0.02)``."""
    init_flax_defaults(model, generator,
                       (model.token.weight, model.position))


def forward_flops(model: TransformerCausalLm, seq_len: int) -> int:
    """Multiply-add FLOPs (2 per MAC) of one sequence's forward, counted from
    the model's shapes: per layer the four attention projections and the
    two MLP products, QKᵀ and PV over the (query, key) pairs the causal
    mask keeps, and the tied logits."""
    h, s = model.hidden_size, seq_len
    pairs = s * (s + 1) // 2
    per_layer = 2 * s * (4 * h * h + 2 * h * model.mlp_dim) \
        + 2 * 2 * pairs * h
    return model.num_layers * per_layer + 2 * s * h * model.vocab_size
