"""Vision Transformer (ViT) image classifiers — the port of
``deeplearning_cfn_tpu/models/vit.py``.

- The patch embedding is a P×P convolution with stride P and a bias,
  computed in the compute dtype (``resnet.Conv``, named ``patch_embed``; a
  VALID conv, since SAME pads nothing when P divides the image). Its
  [B, D, H/P, W/P] output is flattened to tokens in the Flax order, the
  row-major flatten of NHWC: ``flatten(2).transpose(1, 2)``.
- An f32 ``pos_embed`` [N, D], added in the compute dtype; dropout after
  the add.
- Pre-LN ``TransformerLayer`` blocks with neither a bias nor causality in
  their attention (on the card: the flash forward kernel, and under grad
  both backward kernels), then ``final_norm``, the mean over tokens (no
  CLS token) and an f32 ``head`` (zero-initialised).

Input: NHWC f32 images [B, H, W, 3], as the ImageNet pipeline gives them.
Module names follow the Flax tree (``layer.3`` for ``layer_3``), so
``convert.params_from_flax`` and ``convert.flax_layout`` carry the weights
both ways.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from . import register_model
from .resnet import Conv
from .transformer import Dense, LayerNorm, TransformerLayer, dropout, \
    init_flax_defaults


class VisionTransformer(nn.Module):
    def __init__(self, num_classes: int, image_size: int = 224,
                 patch_size: int = 16, hidden_size: int = 384,
                 num_layers: int = 12, num_heads: int = 6,
                 mlp_dim: int = 1536, dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.0, attention_impl: str = "auto",
                 mesh=None):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(f"image {image_size}x{image_size} not divisible "
                             f"by patch size {patch_size}")
        self.patch_size, self.hidden_size = patch_size, hidden_size
        self.num_layers, self.mlp_dim = num_layers, mlp_dim
        self.num_tokens = (image_size // patch_size) ** 2
        self.dtype, self.dropout_rate = dtype, dropout_rate
        self.patch_embed = Conv(3, hidden_size, patch_size, patch_size,
                                dtype, bias=True)
        self.pos_embed = nn.Parameter(
            torch.empty(self.num_tokens, hidden_size))
        self.layer = nn.ModuleList([
            TransformerLayer(hidden_size, num_heads, mlp_dim, dtype,
                             prenorm=True, attention_impl=attention_impl,
                             dropout_rate=dropout_rate, mesh=mesh)
            for _ in range(num_layers)])
        self.final_norm = LayerNorm(hidden_size, dtype)
        self.head = Dense(hidden_size, num_classes, torch.float32)

    def forward(self, x: torch.Tensor, train: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """f32 logits [B, classes] of NHWC images ``x``. ``train`` applies
        dropout with masks from ``generator``, which a nonzero rate then
        requires."""
        if not train:
            generator = None
        elif generator is None and self.dropout_rate > 0:
            raise ValueError(
                f"train=True with dropout_rate={self.dropout_rate} needs a "
                f"torch.Generator for the dropout masks")
        b, h, w, _ = x.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"image {h}x{w} not divisible by patch size {p}")
        x = self.patch_embed(x.permute(0, 3, 1, 2))       # [B, D, H/P, W/P]
        x = x.flatten(2).transpose(1, 2)                   # [B, N, D]
        if x.shape[1] != self.num_tokens:
            raise ValueError(f"{x.shape[1]} patches; the position table "
                             f"holds {self.num_tokens}")
        x = dropout(x + self.pos_embed.to(self.dtype)[None],
                    self.dropout_rate, generator)
        for lyr in self.layer:
            x = lyr(x, generator=generator)
        x = self.final_norm(x).mean(dim=1)                 # GAP head
        return self.head(x).float()


def _build(device, **kw):
    with torch.device(device or "cpu"):
        return VisionTransformer(**kw)


@register_model("vit_s16")
def vit_s16(num_classes: int = 1000, dtype=torch.bfloat16,
            device: Optional[torch.device] = None, **kw):
    """ViT-Small/16 (22M parameters), the standard from-scratch ImageNet
    ViT."""
    return _build(device, num_classes=num_classes, patch_size=16,
                  hidden_size=384, num_layers=12, num_heads=6, mlp_dim=1536,
                  dtype=dtype, **kw)


@register_model("vit_b16")
def vit_b16(num_classes: int = 1000, dtype=torch.bfloat16,
            device: Optional[torch.device] = None, **kw):
    return _build(device, num_classes=num_classes, patch_size=16,
                  hidden_size=768, num_layers=12, num_heads=12, mlp_dim=3072,
                  dtype=dtype, **kw)


@register_model("vit_tiny")
def vit_tiny(num_classes: int = 10, dtype=torch.float32,
             device: Optional[torch.device] = None, **kw):
    """Test-scale config (2 layers, hidden 64, 4 heads, patch 4)."""
    kw.setdefault("patch_size", 4)
    return _build(device, num_classes=num_classes, hidden_size=64,
                  num_layers=2, num_heads=4, mlp_dim=128, dtype=dtype, **kw)


def init_weights(model: VisionTransformer,
                 generator: torch.Generator) -> None:
    """Seeded init with ViT's Flax distributions: the patch kernel
    ``variance_scaling(1, "fan_in", "truncated_normal")`` (fan-in
    P·P·3; a normal truncated at ±2σ, rescaled to the target variance), its
    bias 0, ``pos_embed`` ``normal(0.02)``, the layers as
    ``init_flax_defaults`` (xavier-uniform kernels, zero biases, LayerNorm
    ones/zeros) and a zero head. Runs on the model's device with
    ``generator`` (which must live there too)."""
    init_flax_defaults(model, generator, (model.pos_embed,))
    with torch.no_grad():
        w = model.patch_embed.weight
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                    generator=generator)
        model.patch_embed.bias.zero_()
        model.head.weight.zero_()
        model.head.bias.zero_()


def forward_flops(model: VisionTransformer) -> int:
    """Multiply-add FLOPs (2 per MAC) of one image's forward, counted from
    the model's shapes: the patch embedding, per layer the four attention
    projections, QKᵀ and PV over all N² pairs, and the two MLP products,
    and the head."""
    n, d = model.num_tokens, model.hidden_size
    patch = 2 * n * d * 3 * model.patch_size ** 2
    per_layer = 2 * n * (4 * d * d + 2 * d * model.mlp_dim) + 2 * 2 * n * n * d
    return patch + model.num_layers * per_layer \
        + 2 * d * model.head.weight.shape[0]
