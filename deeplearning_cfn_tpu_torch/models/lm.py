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
expert has one slot), so ``lm_generate`` drives a MoE GPT unchanged. Its
``mesh`` (the task's) goes down to the MoE layers, as in ``models/bert.py``
(JAX ``lm.py`` shares BERT's MoE rules).

Module names follow the Flax tree (``layer.3`` for ``layer_3``, ``token``,
``position``, ``embed_norm``, ``final_norm``), so ``convert.params_from_flax``
and ``convert.flax_layout`` carry the weights both ways.

``LongCausalLm`` (``gpt_long``) is the same trunk with sequence-parallel
attention over the mesh's ``seq`` axis (``models/bert_long.py``), its
layers at JAX's flat root names; it has no decode step, so generation
recomputes the whole causal forward each step.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from . import register_model
from .bert_long import add_seq_layers, seq_layer, seq_positions
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
                 moe_capacity_factor: float = 1.25, moe_top_k: int = 2,
                 mesh=None):
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
                             moe_top_k=moe_top_k, mesh=mesh)
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
        """Per-layer KV caches [B, H, max_len, D] (zeros, compute dtype; H
        the heads each attention of this process holds)."""
        shape = (batch, self.layer[0].self_attn.num_heads, self.max_len,
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


class LongCausalLm(nn.Module):
    """Long-context causal LM: the GPT trunk with sequence-parallel
    attention over the mesh's ``seq`` axis (``bert_long``'s
    ``SeqParallelAttention``: ring or Ulysses, both causal-exact, or the
    flash kernels with ``seq`` = 1). Pre-LN blocks, tied f32 logits,
    post-embedding dropout: ``TransformerCausalLm``'s contract, with JAX's
    flat root names (``token``, ``position``, ``embed_norm``,
    ``layer_{i}_self_attn``, ``layer_{i}_self_attn_norm``, ``layer_{i}_mlp``,
    ``layer_{i}_mlp_norm``, ``final_norm``).

    With ``seq`` > 1 a process embeds its slice of each row (the position
    table at the slice's offset), runs the layers on it and returns the
    logits of its own positions, ``[B, S/n, V]``; :meth:`seq_slice` names
    them, so the task takes the matching targets. There is no
    ``decode_step``: ``lm_generate`` drives it in recompute mode."""

    def __init__(self, vocab_size: int, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, max_len: int = 4096,
                 dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.0, seq_impl: str = "ring",
                 mesh=None, attention_impl: str = "auto"):
        super().__init__()
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.mlp_dim = mlp_dim
        self.max_len = max_len
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.mesh = mesh
        self.token = nn.Embedding(vocab_size, hidden_size)
        self.position = nn.Parameter(torch.empty(max_len, hidden_size))
        self.embed_norm = LayerNorm(hidden_size, dtype)
        add_seq_layers(self, num_layers, hidden_size, num_heads, mlp_dim,
                       dtype, dropout_rate, seq_impl, mesh, attention_impl)
        self.final_norm = LayerNorm(hidden_size, dtype)

    def seq_slice(self, seq_len: int) -> slice:
        """The positions of a row of ``seq_len`` whose logits
        :meth:`forward` returns on this process."""
        return seq_positions(self.mesh, seq_len)

    def forward(self, tokens: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """f32 logits ``[B, S/n, V]`` of this process's positions of
        ``tokens`` [B, S] (``[B, S, V]`` without a ``seq`` axis)."""
        if not train:
            generator = None
        elif generator is None and self.dropout_rate > 0:
            raise ValueError(
                f"train=True with dropout_rate={self.dropout_rate} needs a "
                f"torch.Generator for the dropout masks")
        mine = self.seq_slice(tokens.shape[1])
        x = self.token(tokens[:, mine]) + self.position[None, mine, :]
        x = dropout(self.embed_norm(x.to(self.dtype)), self.dropout_rate,
                    generator)
        for i in range(self.num_layers):
            attn, attn_norm, mlp, mlp_norm = seq_layer(self, i)
            x = x + attn(attn_norm(x), causal=True, generator=generator)
            x = x + mlp(mlp_norm(x), generator)
        return torch.matmul(self.final_norm(x).float(), self.token.weight.t())


@register_model("gpt_long")
def gpt_long(num_classes: int = 0, dtype=torch.bfloat16, *,
             vocab_size: int = 32768, hidden_size: int = 768,
             num_layers: int = 12, num_heads: int = 12, mlp_dim: int = 3072,
             max_len: int = 4096, dropout_rate: float = 0.0,
             seq_impl: str = "ring", mesh=None, attention_impl: str = "auto",
             device: Optional[torch.device] = None):
    """``LongCausalLm``; ``num_classes`` is unused (the vocab plays that
    role)."""
    del num_classes
    with torch.device(device or "cpu"):
        return LongCausalLm(vocab_size=vocab_size, hidden_size=hidden_size,
                            num_layers=num_layers, num_heads=num_heads,
                            mlp_dim=mlp_dim, max_len=max_len, dtype=dtype,
                            dropout_rate=dropout_rate, seq_impl=seq_impl,
                            mesh=mesh, attention_impl=attention_impl)


def init_weights(model, generator: torch.Generator) -> None:
    """Seeded init with Flax's distributions (``init_flax_defaults``): the
    token table and the position table ``normal(0.02)``."""
    init_flax_defaults(model, generator,
                       (model.token.weight, model.position))


def forward_flops(model, seq_len: int) -> int:
    """Multiply-add FLOPs (2 per MAC) of one sequence's forward, counted from
    the model's shapes (a ``TransformerCausalLm`` without MoE layers or a
    ``LongCausalLm``): per layer the four attention projections and the two
    MLP products, QKᵀ and PV over the (query, key) pairs the causal mask
    keeps, and the tied logits."""
    h, s = model.hidden_size, seq_len
    pairs = s * (s + 1) // 2
    per_layer = 2 * s * (4 * h * h + 2 * h * model.mlp_dim) \
        + 2 * 2 * pairs * h
    return model.num_layers * per_layer + 2 * s * h * model.vocab_size
