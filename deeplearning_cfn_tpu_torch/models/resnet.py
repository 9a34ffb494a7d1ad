"""ResNets: ResNet-20 (CIFAR-10) and ResNet-50 (ImageNet) — the port of
``deeplearning_cfn_tpu/models/resnet.py``.

The model takes the pipeline's NHWC ``[B, H, W, 3]`` f32 images and computes
in NCHW with the ``torch.channels_last`` memory format (the NHWC input seen
through ``permute(0, 3, 1, 2)`` already has that layout), which is what
cuDNN's tensor-core convolutions want. What it keeps of Flax, exactly:

- **"SAME" padding is asymmetric.** Flax pads ``total // 2`` before and the
  rest after; PyTorch's ``padding=k // 2`` is symmetric, which gives the same
  output size but windows shifted by a pixel (the 7×7/s2 stem on 224 pads
  2 / 3, every 3×3/s2 conv on an even input 0 / 1, the 4×4 s2d stem 1 / 2,
  the 3×3/s2 max-pool 0 / 1 with −∞). :func:`same_pads` computes Flax's rule
  from the input size; an asymmetric pad goes through ``F.pad``.
- **Flax's BatchNorm** (:class:`BatchNorm`, ``use_fast_variance=True``):
  statistics in f32 even on bf16 activations, the biased
  ``var = max(E[x²] − E[x]², 0)`` (also what the running var stores),
  ``running = 0.9·running + 0.1·batch``, and
  ``y = (x − mean)·(scale·rsqrt(var + 1e-5)) + bias`` in f32, cast to the
  compute dtype. ``train=False`` reads the running buffers.
- **Dtypes.** Convs cast their f32 weights to the compute dtype per call;
  the global mean over H and W accumulates in f32 and yields the compute
  dtype; the head is an f32 Dense, so logits are f32.
- **Initialisation** (:func:`init_weights`, from an explicit
  ``torch.Generator``): convs ``variance_scaling(2.0, "fan_out",
  "normal")``, every block's last BN scale zero, the head kernel zero.
- **Names.** Flax's auto-names map one to one (``convert.py``):
  ``BottleneckBlock_N``/``BasicBlock_N`` → ``blocks.N``, ``Conv_i`` →
  ``convs.i``, ``BatchNorm_i`` → ``norms.i``; ``conv_proj``, ``norm_proj``,
  ``conv_init``, ``conv_init_s2d``, ``norm_init`` and ``head`` keep theirs.

BatchNorm normalises over the whole batch on one device; the JAX package's
mesh-wide (sync) statistics come with data parallelism (ROADMAP A.10).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import register_model


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """Flax/XLA "SAME" padding of one spatial dim: output ``ceil(size /
    stride)``, total padding split ``total // 2`` before, the rest after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int,
              value: float = 0.0) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """``x`` [B,C,H,W] and the symmetric padding left for the op: a
    symmetric SAME pad stays the op's own ``padding``; an asymmetric one is
    applied here with ``value``."""
    (h0, h1), (w0, w1) = (same_pads(x.shape[2], kernel, stride),
                          same_pads(x.shape[3], kernel, stride))
    if h0 == h1 and w0 == w1:
        return x, (h0, w0)
    return F.pad(x, (w0, w1, h0, h1), value=value), (0, 0)


class Conv(nn.Module):
    """Flax ``nn.Conv(use_bias=False, padding="SAME", dtype=dtype)``: f32
    weight (OIHW), cast to ``dtype`` at every call."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.weight = nn.Parameter(
            torch.empty(features, in_features, kernel, kernel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.dtype, memory_format=torch.channels_last)
        if self.kernel == 1 and self.stride > 1:
            # A strided 1×1 conv (SAME pads it by 0) reads every s-th
            # pixel: slice, then a stride-1 conv. The same numbers, and it
            # keeps clear of PyTorch's CPU backward of a strided 1×1 conv
            # on a channels_last input, which corrupts the heap (torch
            # 2.13).
            s = self.stride
            return F.conv2d(x[:, :, ::s, ::s], w)
        x, pad = _pad_same(x, self.kernel, self.stride)
        return F.conv2d(x, w, stride=self.stride, padding=pad)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=dtype,
    param_dtype=f32)`` over [B,C,H,W] (see the module docstring). Not
    ``nn.BatchNorm2d``, which stores the unbiased variance and uses
    PyTorch's momentum convention."""

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16,
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.dtype, self.momentum, self.eps = dtype, momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        xf = x.float()
        if train:
            mean = xf.mean((0, 2, 3))
            var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[None, :, None, None]) * mul[None, :, None, None] \
            + self.bias[None, :, None, None]
        return y.to(self.dtype)


class Dense(nn.Module):
    """Flax ``nn.Dense(dtype=f32)``: ``y = x @ W.T + b`` in f32."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.weight, self.bias)


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (ResNet-18/20/34 style)."""

    expansion = 1

    def __init__(self, in_features: int, filters: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        self.convs = nn.ModuleList([
            Conv(in_features, filters, 3, stride, dtype),
            Conv(filters, filters, 3, 1, dtype)])
        self.norms = nn.ModuleList([BatchNorm(filters, dtype),
                                    BatchNorm(filters, dtype)])
        self.project = in_features != filters or stride != 1
        if self.project:
            self.conv_proj = Conv(in_features, filters, 1, stride, dtype)
            self.norm_proj = BatchNorm(filters, dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = torch.relu(self.norms[0](self.convs[0](x), train))
        y = self.norms[1](self.convs[1](y), train)
        residual = self.norm_proj(self.conv_proj(x), train) \
            if self.project else x
        return torch.relu(residual + y)


class BottleneckBlock(nn.Module):
    """1x1 → 3x3 → 1x1 bottleneck (ResNet-50/101/152); the stride sits on
    the 3x3 conv, as in the JAX model."""

    expansion = 4

    def __init__(self, in_features: int, filters: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        out = filters * 4
        self.convs = nn.ModuleList([
            Conv(in_features, filters, 1, 1, dtype),
            Conv(filters, filters, 3, stride, dtype),
            Conv(filters, out, 1, 1, dtype)])
        self.norms = nn.ModuleList([BatchNorm(filters, dtype),
                                    BatchNorm(filters, dtype),
                                    BatchNorm(out, dtype)])
        self.project = in_features != out or stride != 1
        if self.project:
            self.conv_proj = Conv(in_features, out, 1, stride, dtype)
            self.norm_proj = BatchNorm(out, dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = torch.relu(self.norms[0](self.convs[0](x), train))
        y = torch.relu(self.norms[1](self.convs[1](y), train))
        y = self.norms[2](self.convs[2](y), train)
        residual = self.norm_proj(self.conv_proj(x), train) \
            if self.project else x
        return torch.relu(residual + y)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """[B,H,W,C] → [B,H/b,W/b,C·b²]: fold b×b spatial blocks into channels,
    ordered (row-in-block, col-in-block, channel) — channel
    ``(bh·b + bw)·C + c``, as the JAX function orders them, so a bridged
    ``conv_init_s2d`` kernel lines up. Runs on the NHWC input, before the
    model turns it into NCHW."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, c * block * block)


def max_pool_same(x: torch.Tensor, kernel: int = 3,
                  stride: int = 2) -> torch.Tensor:
    """Flax ``nn.max_pool(x, (k, k), (s, s), padding="SAME")``: the pad is
    −∞, asymmetric as the convs'."""
    x, pad = _pad_same(x, kernel, stride, value=-math.inf)
    return F.max_pool2d(x, kernel, stride, padding=pad)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 cifar_stem: bool = False, stem: str = "conv7"):
        super().__init__()
        if stem not in ("conv7", "s2d"):
            raise ValueError(
                f"unknown stem {stem!r}; expected 'conv7' or 's2d'")
        self.dtype = dtype
        self.cifar_stem, self.stem = cifar_stem, stem
        self.stage_sizes = list(stage_sizes)
        if cifar_stem:
            self.conv_init = Conv(3, num_filters, 3, 1, dtype)
        elif stem == "s2d":
            self.conv_init_s2d = Conv(12, num_filters, 4, 1, dtype)
        else:
            self.conv_init = Conv(3, num_filters, 7, 2, dtype)
        self.norm_init = BatchNorm(num_filters, dtype)
        blocks = []
        features = num_filters
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                block = block_cls(features, num_filters * 2**i, stride,
                                  dtype)
                features = num_filters * 2**i * block_cls.expansion
                blocks.append(block)
        self.blocks = nn.ModuleList(blocks)
        self.head = Dense(features, num_classes)

    def forward(self, images: torch.Tensor, train: bool = True
                ) -> torch.Tensor:
        """NHWC f32 images [B,H,W,3] → f32 logits [B, num_classes];
        ``train`` normalises with the batch's statistics and updates the
        running ones."""
        x = images.to(self.dtype)
        if not self.cifar_stem and self.stem == "s2d":
            x = space_to_depth(x, 2)
        # NHWC seen as NCHW is channels_last already; contiguous() pins it
        # for an input that arrived in another layout.
        x = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        if self.cifar_stem:
            x = torch.relu(self.norm_init(self.conv_init(x), train))
        else:
            conv = self.conv_init_s2d if self.stem == "s2d" \
                else self.conv_init
            x = torch.relu(self.norm_init(conv(x), train))
            x = max_pool_same(x, 3, 2)
        for block in self.blocks:
            x = block(x, train)
        x = x.mean((2, 3), dtype=torch.float32).to(self.dtype)
        return self.head(x)


def init_weights(model: ResNet, generator: torch.Generator) -> None:
    """Seeded init with Flax's distributions: convs
    ``variance_scaling(2.0, "fan_out", "normal")`` (std √(2/(kh·kw·out))),
    BatchNorm scale 1 and bias 0 except every block's last BN scale, which
    starts at 0 (each block starts as the identity), running stats 0 / 1,
    and the head zero. Runs on the model's device with ``generator``."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Conv):
                out, _, kh, kw = mod.weight.shape
                mod.weight.normal_(0.0, math.sqrt(2.0 / (kh * kw * out)),
                                   generator=generator)
            elif isinstance(mod, BatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
            elif isinstance(mod, Dense):
                mod.weight.zero_()
                mod.bias.zero_()
        for block in model.blocks:
            block.norms[-1].weight.zero_()


def _build(device: Optional[torch.device], **kw) -> ResNet:
    with torch.device(device or "cpu"):
        return ResNet(**kw)


@register_model("resnet20")
def resnet20(num_classes: int = 10, dtype=torch.float32, device=None, **kw):
    # 3 stages × 3 BasicBlocks, 16/32/64 filters — He et al.'s CIFAR
    # ResNet-20.
    return _build(device, stage_sizes=[3, 3, 3], block_cls=BasicBlock,
                  num_classes=num_classes, num_filters=16, dtype=dtype,
                  cifar_stem=True, **kw)


@register_model("resnet32")
def resnet32(num_classes: int = 10, dtype=torch.float32, device=None, **kw):
    return _build(device, stage_sizes=[5, 5, 5], block_cls=BasicBlock,
                  num_classes=num_classes, num_filters=16, dtype=dtype,
                  cifar_stem=True, **kw)


@register_model("resnet18")
def resnet18(num_classes: int = 1000, dtype=torch.bfloat16, device=None,
             **kw):
    return _build(device, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock,
                  num_classes=num_classes, dtype=dtype, **kw)


@register_model("resnet50")
def resnet50(num_classes: int = 1000, dtype=torch.bfloat16, device=None,
             **kw):
    return _build(device, stage_sizes=[3, 4, 6, 3],
                  block_cls=BottleneckBlock, num_classes=num_classes,
                  dtype=dtype, **kw)


@register_model("resnet50_s2d")
def resnet50_s2d(num_classes: int = 1000, dtype=torch.bfloat16, device=None,
                 **kw):
    # resnet50 with the space-to-depth stem.
    kw.setdefault("stem", "s2d")
    return _build(device, stage_sizes=[3, 4, 6, 3],
                  block_cls=BottleneckBlock, num_classes=num_classes,
                  dtype=dtype, **kw)


@register_model("resnet101")
def resnet101(num_classes: int = 1000, dtype=torch.bfloat16, device=None,
              **kw):
    return _build(device, stage_sizes=[3, 4, 23, 3],
                  block_cls=BottleneckBlock, num_classes=num_classes,
                  dtype=dtype, **kw)


def forward_flops(model: ResNet, image_size: int) -> int:
    """Forward multiply-adds ×2 of one image, counted from the model's own
    conv and Dense shapes (each conv: 2·kh·kw·in·out·Ho·Wo, with Flax's
    SAME output size ``ceil(H / stride)``; the head: 2·in·out). BatchNorm,
    ReLU, pooling and the residual adds are left out, as the published
    ~4.1 GMAC (8.2 GFLOP) of ResNet-50 at 224² leaves them out."""
    flops = 0
    size = image_size

    def conv_flops(conv: Conv, size: int) -> Tuple[int, int]:
        out, cin, kh, kw = conv.weight.shape
        o = -(-size // conv.stride)
        return 2 * kh * kw * cin * out * o * o, o

    if model.cifar_stem:
        f, size = conv_flops(model.conv_init, size)
    elif model.stem == "s2d":
        f, size = conv_flops(model.conv_init_s2d, size // 2)
    else:
        f, size = conv_flops(model.conv_init, size)
    flops += f
    if not model.cifar_stem:
        size = -(-size // 2)  # the 3×3/s2 max-pool
    for block in model.blocks:
        s_in = size
        for conv in block.convs:
            f, size = conv_flops(conv, size)
            flops += f
        if block.project:
            flops += conv_flops(block.conv_proj, s_in)[0]
    out, cin = model.head.weight.shape
    return flops + 2 * cin * out
