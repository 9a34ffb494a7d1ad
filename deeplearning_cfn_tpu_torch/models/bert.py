"""BERT for MLM+NSP pretraining — the port of
``deeplearning_cfn_tpu/models/bert.py``.

The encoder is the shared ``TransformerLayer`` stack in the post-LN
(original BERT) layout, every self-attention carrying the padding bias of
``input_mask`` (on the card: the flash forward kernel, and under grad the
reference-VJP recompute, as the JAX custom VJP does for a biased call). The
heads follow Flax's numerics:

- MLM: gather the encoder output at ``mlm_positions`` (static P), then
  ``mlm_transform`` (Dense in the compute dtype), ``gelu`` (the tanh
  approximation, Flax's default), ``mlm_norm``, and the tied decoder — the
  f32 product with the token table — plus the f32 ``mlm_bias``;
- NSP: the f32 ``tanh`` pooler over [CLS], then the f32 ``nsp_head``.

With ``num_experts > 0`` every ``moe_every``-th layer's FFN is a
Mixture-of-Experts FFN (``models/moe.py``; GShard's every-other-layer
convention at the default 2), and the outputs gain ``moe_load_balance`` and
``moe_router_z``, the per-layer means of the MoE layers' aux losses. Its
``mesh`` (the task's) goes down to every layer: across processes the MoE
layers split the experts over the ``expert`` axis and take the router's
statistics over the global batch, and the attention and MLP split their
heads and hidden units over the ``model`` axis.

Module names follow the Flax tree (``encoder.layer.3`` for ``layer_3``), so
``convert.params_from_flax`` and ``convert.flax_layout`` carry the weights
both ways. The pipelined trunk is ``models/pipelined.py`` and the
long-context one ``models/bert_long.py``, both with the same heads
(:class:`PretrainHeads`).

Batch contract (``data/text.py``): input_ids, input_mask, segment_ids
[B, S]; mlm_positions [B, P].
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import register_model
from .moe import init_moe_, moe_flops
from .transformer import Dense, Embed, LayerNorm, MoeAuxAccumulator, \
    TransformerLayer, is_moe_layer, padding_bias, xavier_uniform_


class BertEncoder(nn.Module):
    """``num_experts > 0`` turns every ``moe_every``-th layer into a MoE
    layer; ``forward`` returns (activations, token table, the MoE aux
    losses' per-layer mean)."""

    def __init__(self, vocab_size: int, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, max_len: int = 512,
                 dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.0, attention_impl: str = "auto",
                 num_experts: int = 0, moe_every: int = 2,
                 moe_capacity_factor: float = 1.25, moe_top_k: int = 2,
                 mesh=None):
        super().__init__()
        self.embed = Embed(vocab_size, hidden_size, max_len, num_segments=2,
                           dtype=dtype, dropout_rate=dropout_rate)
        self.layer = nn.ModuleList([
            TransformerLayer(hidden_size, num_heads, mlp_dim, dtype,
                             prenorm=False, attention_impl=attention_impl,
                             dropout_rate=dropout_rate,
                             num_experts=num_experts if is_moe_layer(
                                 i, num_experts, moe_every) else 0,
                             moe_capacity_factor=moe_capacity_factor,
                             moe_top_k=moe_top_k, mesh=mesh)
            for i in range(num_layers)])

    def forward(self, input_ids, input_mask, segment_ids,
                generator: Optional[torch.Generator] = None):
        x, token_table = self.embed(input_ids, segment_ids, generator)
        bias = padding_bias(input_mask)
        acc = MoeAuxAccumulator(x.device)
        for lyr in self.layer:
            x = lyr(x, self_bias=bias, generator=generator)
            if lyr.num_experts:
                x, aux = x
                acc.add(aux)
        return x, token_table, acc.mean()


class PretrainHeads(nn.Module):
    """The BERT pretraining heads, shared by the encoder variants (plain
    and pipelined): ``mlm_transform``, ``mlm_norm``, ``mlm_bias``,
    ``pooler`` and ``nsp_head`` at the model's root, as in the Flax tree.
    A subclass calls :meth:`_init_heads` after building its trunk (so the
    parameters keep the trunk-first order) and :meth:`_heads` on the
    trunk's output."""

    def _init_heads(self, vocab_size: int, hidden_size: int,
                    num_classes: int, dtype: torch.dtype) -> None:
        self.mlm_transform = Dense(hidden_size, hidden_size, dtype)
        self.mlm_norm = LayerNorm(hidden_size, dtype)
        self.mlm_bias = nn.Parameter(torch.zeros(vocab_size))
        self.pooler = Dense(hidden_size, hidden_size, torch.float32)
        self.nsp_head = Dense(hidden_size, num_classes, torch.float32)

    def _heads(self, x, token_table, mlm_positions) -> Dict[str, torch.Tensor]:
        idx = mlm_positions.long()[:, :, None].expand(-1, -1, x.shape[-1])
        h = F.gelu(self.mlm_transform(torch.gather(x, 1, idx)),
                   approximate="tanh")
        h = self.mlm_norm(h)
        mlm_logits = torch.matmul(h.float(), token_table.t()) + self.mlm_bias
        pooled = torch.tanh(self.pooler(x[:, 0, :].float()))
        return {"mlm_logits": mlm_logits, "nsp_logits": self.nsp_head(pooled)}


class BertPretrain(PretrainHeads):
    """Encoder + MLM head (tied decoder) + NSP head."""

    def __init__(self, vocab_size: int, num_classes: int = 2,
                 hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, mlp_dim: int = 3072,
                 max_len: int = 512, dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.0, attention_impl: str = "auto",
                 num_experts: int = 0, moe_every: int = 2,
                 moe_capacity_factor: float = 1.25, moe_top_k: int = 2,
                 mesh=None):
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.mlp_dim = mlp_dim
        self.num_experts = num_experts
        self.encoder = BertEncoder(vocab_size, hidden_size, num_layers,
                                   num_heads, mlp_dim, max_len, dtype,
                                   dropout_rate, attention_impl, num_experts,
                                   moe_every, moe_capacity_factor, moe_top_k,
                                   mesh)
        self._init_heads(vocab_size, hidden_size, num_classes, dtype)

    def forward(self, input_ids, input_mask, segment_ids, mlm_positions,
                train: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """``{"mlm_logits": [B, P, V], "nsp_logits": [B, classes]}``, both
        f32, plus ``moe_load_balance`` and ``moe_router_z`` for a MoE trunk.
        ``train`` applies dropout with masks from ``generator``, which a
        nonzero rate then requires."""
        if not train:
            generator = None
        elif generator is None and self.dropout_rate > 0:
            raise ValueError(
                f"train=True with dropout_rate={self.dropout_rate} needs a "
                f"torch.Generator for the dropout masks")
        x, token_table, moe_aux = self.encoder(input_ids, input_mask,
                                               segment_ids, generator)
        out = self._heads(x, token_table, mlm_positions)
        if self.num_experts > 0:
            out["moe_load_balance"] = moe_aux["load_balance"]
            out["moe_router_z"] = moe_aux["router_z"]
        return out


def _build(num_classes, dtype, device, **kw):
    with torch.device(device or "cpu"):
        return BertPretrain(num_classes=num_classes, dtype=dtype, **kw)


@register_model("bert_base")
def bert_base(num_classes: int = 2, dtype=torch.bfloat16, *,
              vocab_size: int = 30522, hidden_size: int = 768,
              num_layers: int = 12, num_heads: int = 12,
              mlp_dim: int = 3072, max_len: int = 512,
              dropout_rate: float = 0.0, attention_impl: str = "auto",
              num_experts: int = 0, moe_every: int = 2,
              moe_capacity_factor: float = 1.25, moe_top_k: int = 2,
              mesh=None, device: Optional[torch.device] = None):
    return _build(num_classes, dtype, device, vocab_size=vocab_size,
                  hidden_size=hidden_size, num_layers=num_layers,
                  num_heads=num_heads, mlp_dim=mlp_dim, max_len=max_len,
                  dropout_rate=dropout_rate, attention_impl=attention_impl,
                  num_experts=num_experts, moe_every=moe_every,
                  moe_capacity_factor=moe_capacity_factor,
                  moe_top_k=moe_top_k, mesh=mesh)


@register_model("bert_tiny")
def bert_tiny(num_classes: int = 2, dtype=torch.float32, **kw):
    """Test-scale config (2 layers, 128 hidden) for CPU smoke/parity."""
    device = kw.pop("device", None)
    defaults = dict(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=4, mlp_dim=256, max_len=128)
    defaults.update(kw)
    return _build(num_classes, dtype, device, **defaults)


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's default Dense kernel init: a normal truncated at ±2σ, scaled so
    its variance is 1/fan_in (the weight is [out, in])."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=generator)


def init_weights(model: PretrainHeads, generator: torch.Generator) -> None:
    """Seeded init with Flax's distributions: xavier-uniform attention and
    MLP kernels, lecun-normal ``mlm_transform``/``pooler``/``nsp_head``
    kernels, zero biases (``mlm_bias`` too), ``normal(0.02)`` embeddings and
    positions, LayerNorm ones/zeros, and the MoE layers' own init
    (``moe.init_moe_``). Runs on the model's device with ``generator``
    (which must live there too). The pipelined model's stacked trunk is
    ``pipelined.init_weights``'s."""
    heads = (model.mlm_transform, model.pooler, model.nsp_head)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Dense):
                if any(mod is h for h in heads):
                    _lecun_normal_(mod.weight, generator)
                else:
                    xavier_uniform_(mod, generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        emb = model.get_submodule("encoder.embed") \
            if hasattr(model, "encoder") else model.embed
        for t in (emb.token.weight, emb.position, emb.segment.weight):
            t.normal_(0.0, 0.02, generator=generator)
        model.mlm_bias.zero_()
    init_moe_(model, generator)


def forward_flops(model: BertPretrain, seq_len: int,
                  num_predictions: int) -> int:
    """Multiply-add FLOPs (2 per MAC) of one sequence's forward, counted from
    the model's shapes: per layer the four attention projections, QKᵀ and
    PV, and the two MLP products (a MoE layer's FFN as it executes, at
    every capacity slot: ``moe.moe_flops``); the MLM transform and the tied
    decoder at ``num_predictions`` positions; the pooler and the NSP
    head."""
    h, s, p = model.hidden_size, seq_len, num_predictions
    attn = 2 * s * 4 * h * h + 2 * 2 * s * s * h
    total = 0
    for lyr in model.encoder.layer:
        if lyr.num_experts > 0:
            moe = lyr.moe_mlp
            total += attn + moe_flops(s, h, model.mlp_dim, moe.num_experts,
                                      moe.capacity(s))
        else:
            total += attn + 2 * s * 2 * h * model.mlp_dim
    heads = 2 * p * (h * h + h * model.vocab_size) \
        + 2 * (h * h + h * model.nsp_head.weight.shape[0])
    return total + heads
