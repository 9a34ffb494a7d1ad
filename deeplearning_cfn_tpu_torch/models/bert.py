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

Module names follow the Flax tree (``encoder.layer.3`` for ``layer_3``), so
``convert.params_from_flax`` and ``convert.flax_layout`` carry the weights
both ways. The Mixture-of-Experts trunk (``num_experts > 0``) belongs to
ROADMAP A.9b; the pipelined and long-context trunks to A.10.

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
from .transformer import Dense, Embed, LayerNorm, TransformerLayer, \
    padding_bias


class BertEncoder(nn.Module):
    def __init__(self, vocab_size: int, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, max_len: int = 512,
                 dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.0, attention_impl: str = "auto"):
        super().__init__()
        self.embed = Embed(vocab_size, hidden_size, max_len, num_segments=2,
                           dtype=dtype, dropout_rate=dropout_rate)
        self.layer = nn.ModuleList([
            TransformerLayer(hidden_size, num_heads, mlp_dim, dtype,
                             prenorm=False, attention_impl=attention_impl,
                             dropout_rate=dropout_rate)
            for _ in range(num_layers)])

    def forward(self, input_ids, input_mask, segment_ids,
                generator: Optional[torch.Generator] = None):
        x, token_table = self.embed(input_ids, segment_ids, generator)
        bias = padding_bias(input_mask)
        for lyr in self.layer:
            x = lyr(x, self_bias=bias, generator=generator)
        return x, token_table


class BertPretrain(nn.Module):
    """Encoder + MLM head (tied decoder) + NSP head."""

    def __init__(self, vocab_size: int, num_classes: int = 2,
                 hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, mlp_dim: int = 3072,
                 max_len: int = 512, dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.0, attention_impl: str = "auto"):
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.mlp_dim = mlp_dim
        self.encoder = BertEncoder(vocab_size, hidden_size, num_layers,
                                   num_heads, mlp_dim, max_len, dtype,
                                   dropout_rate, attention_impl)
        self.mlm_transform = Dense(hidden_size, hidden_size, dtype)
        self.mlm_norm = LayerNorm(hidden_size, dtype)
        self.mlm_bias = nn.Parameter(torch.zeros(vocab_size))
        self.pooler = Dense(hidden_size, hidden_size, torch.float32)
        self.nsp_head = Dense(hidden_size, num_classes, torch.float32)

    def forward(self, input_ids, input_mask, segment_ids, mlm_positions,
                train: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """``{"mlm_logits": [B, P, V], "nsp_logits": [B, classes]}``, both
        f32. ``train`` applies dropout with masks from ``generator``, which
        a nonzero rate then requires."""
        if not train:
            generator = None
        elif generator is None and self.dropout_rate > 0:
            raise ValueError(
                f"train=True with dropout_rate={self.dropout_rate} needs a "
                f"torch.Generator for the dropout masks")
        x, token_table = self.encoder(input_ids, input_mask, segment_ids,
                                      generator)
        idx = mlm_positions.long()[:, :, None].expand(-1, -1, x.shape[-1])
        h = F.gelu(self.mlm_transform(torch.gather(x, 1, idx)),
                   approximate="tanh")
        h = self.mlm_norm(h)
        mlm_logits = torch.matmul(h.float(), token_table.t()) + self.mlm_bias
        pooled = torch.tanh(self.pooler(x[:, 0, :].float()))
        return {"mlm_logits": mlm_logits, "nsp_logits": self.nsp_head(pooled)}


def _build(num_classes, dtype, device, num_experts=0, **kw):
    if num_experts:
        raise NotImplementedError(
            "BERT with Mixture-of-Experts FFNs (num_experts > 0) is not "
            "ported yet (ROADMAP A.9b)")
    for key in ("moe_every", "moe_capacity_factor", "moe_top_k"):
        kw.pop(key, None)
    with torch.device(device or "cpu"):
        return BertPretrain(num_classes=num_classes, dtype=dtype, **kw)


@register_model("bert_base")
def bert_base(num_classes: int = 2, dtype=torch.bfloat16, *,
              vocab_size: int = 30522, hidden_size: int = 768,
              num_layers: int = 12, num_heads: int = 12,
              mlp_dim: int = 3072, max_len: int = 512,
              dropout_rate: float = 0.0, attention_impl: str = "auto",
              device: Optional[torch.device] = None, **moe):
    return _build(num_classes, dtype, device, vocab_size=vocab_size,
                  hidden_size=hidden_size, num_layers=num_layers,
                  num_heads=num_heads, mlp_dim=mlp_dim, max_len=max_len,
                  dropout_rate=dropout_rate, attention_impl=attention_impl,
                  **moe)


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


def init_weights(model: BertPretrain, generator: torch.Generator) -> None:
    """Seeded init with Flax's distributions: xavier-uniform attention and
    MLP kernels, lecun-normal ``mlm_transform``/``pooler``/``nsp_head``
    kernels, zero biases (``mlm_bias`` too), ``normal(0.02)`` embeddings and
    positions, LayerNorm ones/zeros. Runs on the model's device with
    ``generator`` (which must live there too)."""
    heads = (model.mlm_transform, model.pooler, model.nsp_head)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Dense):
                if any(mod is h for h in heads):
                    _lecun_normal_(mod.weight, generator)
                else:
                    fan_out, fan_in = mod.weight.shape
                    limit = (6.0 / (fan_in + fan_out)) ** 0.5
                    mod.weight.uniform_(-limit, limit, generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        emb = model.encoder.embed
        for t in (emb.token.weight, emb.position, emb.segment.weight):
            t.normal_(0.0, 0.02, generator=generator)
        model.mlm_bias.zero_()


def forward_flops(model: BertPretrain, seq_len: int,
                  num_predictions: int) -> int:
    """Multiply-add FLOPs (2 per MAC) of one sequence's forward, counted from
    the model's shapes: per layer the four attention projections, QKᵀ and
    PV, and the two MLP products; the MLM transform and the tied decoder at
    ``num_predictions`` positions; the pooler and the NSP head."""
    h, s, p = model.hidden_size, seq_len, num_predictions
    per_layer = 2 * s * (4 * h * h + 2 * h * model.mlp_dim) \
        + 2 * 2 * s * s * h
    heads = 2 * p * (h * h + h * model.vocab_size) \
        + 2 * (h * h + h * model.nsp_head.weight.shape[0])
    return model.num_layers * per_layer + heads
