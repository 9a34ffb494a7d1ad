"""Mask R-CNN: ResNet-50-FPN backbone, RPN, box head, mask head — the port of
``deeplearning_cfn_tpu/models/maskrcnn.py``.

The module maps images to the feature pyramid and the flattened RPN outputs;
proposals, targets, ROI-align and the two heads' losses belong to
``train/detection_task.py``, which calls :meth:`MaskRCNN.run_box_head` and
:meth:`MaskRCNN.run_mask_head` in between, as in the JAX package.

Layout and what is kept of Flax:

- The trunk is the port's ResNet-50 (``models/resnet.py``: its
  ``BottleneckBlock``, Flax's BatchNorm and asymmetric SAME padding,
  ``max_pool_same``), computing in NCHW with the channels_last memory
  format; the pyramid levels are [B, C, H, W] channels_last tensors, whose
  memory is NHWC.
- FPN, RPN and mask-head convs carry a bias (Flax's ``nn.Conv`` default):
  ``resnet.Conv(bias=True)``.
- FPN upsampling is a nearest 2× repeat cropped to the lateral's size; P6
  is ``P5[..., ::2, ::2]`` (Flax's 1×1 stride-2 VALID max-pool).
- The RPN outputs are flattened in NHWC order ([B, H, W, A] and
  [B, H, W, A·4]), the order ``ops.detection.generate_anchors`` lays the
  anchors out in.
- ``BoxHead`` flattens each RoI as (s, s, C), the order ``fc1``'s weight
  expects; ``MaskHead``'s 2× upsample is a Dense ``[C, 4·C]`` and a
  depth-to-space, not a transposed conv, so the weights carry across.
- Mixed precision: the RPN conv, ``fc1``/``fc2`` and the mask convs and
  upsample compute in the model dtype; ``rpn_logits``, ``rpn_deltas``,
  ``cls``, ``box`` and ``mask_logits`` in f32.
- Names follow Flax's (``convert.py`` maps them without special cases):
  ``backbone.blocks.N`` ↔ ``backbone/BottleneckBlock_N``, and ``fpn.lateral_L``,
  ``fpn.post_L``, ``rpn.rpn_conv``, ``box_head.fc1``, ``mask_head.conv_i``,
  ``mask_head.upsample`` … keep theirs.

``init_weights`` draws Flax's initial distributions from an explicit
generator; ``forward_flops`` counts the forward FLOPs from the shapes.

The ``spatial`` axis (``maskrcnn_coco``'s ``MeshConfig(data=-1,
spatial=2)``): with a ``mesh`` whose ``spatial`` axis is above 1, each
process gets its rows of every image (the trainer's ``local_batch``), the
trunk and the FPN run on them (their convs and the pool with halos,
``models/resnet.py``; the FPN's upsample and P6's ``[::2]`` are local),
and then each pyramid level is gathered over the ``spatial`` group
(``parallel.collectives.gather_rows``, whose backward is a
reduce-scatter). The RPN and everything after it (anchors, proposals,
ROI-align, the heads) run on the whole pyramid, the same on each process
of the group. Every level must split evenly and P5's rows must stay even
for P6's stride, so each process's rows must be a multiple of 64: the
image size a multiple of 64 × ``spatial``, which is refused otherwise
(128 is the smallest over two processes).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import register_model
from . import resnet
from ..parallel.collectives import gather_rows
from .resnet import BatchNorm, BottleneckBlock, Conv, max_pool_same
from .transformer import Dense

MIN_LEVEL = 2
MAX_LEVEL = 6
FPN_DIM = 256
ROI_SIZE = 7        # box-head RoIs, ROI_SIZE² per box
MASK_ROI_SIZE = 14  # mask-head RoIs; the masks come out at 2× this

Pyramid = Dict[int, torch.Tensor]


class ResNetFeatures(nn.Module):
    """ResNet-50 trunk returning C2..C5 (the port's ResNet blocks)."""

    def __init__(self, stage_sizes=(3, 4, 6, 3), num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16, mesh=None):
        super().__init__()
        self.dtype = dtype
        self.split_mesh = mesh
        self.stage_sizes = list(stage_sizes)
        self.conv_init = Conv(3, num_filters, 7, 2, dtype)
        self.norm_init = BatchNorm(num_filters, dtype)
        blocks = []
        features = num_filters
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(BottleneckBlock(features, num_filters * 2**i,
                                              stride, dtype))
                features = num_filters * 2**i * BottleneckBlock.expansion
        self.blocks = nn.ModuleList(blocks)
        self.out_features = [num_filters * 2**i * BottleneckBlock.expansion
                             for i in range(len(self.stage_sizes))]

    def forward(self, images: torch.Tensor, train: bool = True) -> Pyramid:
        """NHWC f32 images → {2: C2 (stride 4), …, 5: C5 (stride 32)}."""
        x = images.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = torch.relu(self.norm_init(self.conv_init(x), train))
        x = max_pool_same(x, 3, 2, self.split_mesh)
        feats = {}
        k = 0
        for i, count in enumerate(self.stage_sizes):
            for _ in range(count):
                x = self.blocks[k](x, train)
                k += 1
            feats[i + 2] = x
        return feats


class FPN(nn.Module):
    """Top-down feature pyramid: C2..C5 → P2..P6 at FPN_DIM channels."""

    def __init__(self, in_features, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        for lvl, c in zip(range(2, 6), in_features):
            setattr(self, f"lateral_{lvl}",
                    Conv(c, FPN_DIM, 1, 1, dtype, bias=True))
        for lvl in range(2, 6):
            setattr(self, f"post_{lvl}",
                    Conv(FPN_DIM, FPN_DIM, 3, 1, dtype, bias=True))

    def forward(self, feats: Pyramid) -> Pyramid:
        laterals = {lvl: getattr(self, f"lateral_{lvl}")(feats[lvl])
                    for lvl in range(2, 6)}
        out = {5: laterals[5]}
        for lvl in range(4, 1, -1):
            up = F.interpolate(out[lvl + 1], scale_factor=2, mode="nearest")
            # Crop in case the lower level isn't exactly 2× (odd sizes).
            th, tw = laterals[lvl].shape[2:]
            out[lvl] = laterals[lvl] + up[:, :, :th, :tw]
        pyramid = {lvl: getattr(self, f"post_{lvl}")(out[lvl])
                   for lvl in range(2, 6)}
        # P6: stride-2 subsample of P5 (Mask R-CNN convention for the RPN).
        pyramid[6] = pyramid[5][:, :, ::2, ::2].contiguous(
            memory_format=torch.channels_last)
        return pyramid


class RpnHead(nn.Module):
    """Shared 3×3 conv + objectness/box-delta 1×1s, applied to every level."""

    def __init__(self, num_anchors: int = 3,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.rpn_conv = Conv(FPN_DIM, FPN_DIM, 3, 1, dtype, bias=True)
        self.rpn_logits = Conv(FPN_DIM, num_anchors, 1, 1, torch.float32,
                               bias=True)
        self.rpn_deltas = Conv(FPN_DIM, num_anchors * 4, 1, 1,
                               torch.float32, bias=True)

    def forward(self, feat: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.relu(self.rpn_conv(feat))
        b = feat.shape[0]
        # NHWC order before flattening: the anchors' (y, x, ratio) layout.
        logits = self.rpn_logits(x).permute(0, 2, 3, 1).reshape(b, -1)
        deltas = self.rpn_deltas(x).permute(0, 2, 3, 1).reshape(b, -1, 4)
        return logits, deltas


class BoxHead(nn.Module):
    """2-FC head → class logits + class-specific box deltas."""

    def __init__(self, num_classes: int, hidden: int = 1024,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.fc1 = Dense(ROI_SIZE * ROI_SIZE * FPN_DIM, hidden, dtype)
        self.fc2 = Dense(hidden, hidden, dtype)
        self.cls = Dense(hidden, num_classes, torch.float32)
        self.box = Dense(hidden, num_classes * 4, torch.float32)

    def forward(self, rois: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """rois [B, N, s, s, C] → logits [B, N, K] f32, deltas [B, N, K, 4]
        f32."""
        b, n = rois.shape[:2]
        x = rois.reshape(b, n, -1)  # (s, s, C) order, as fc1 expects
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        return self.cls(x), self.box(x).reshape(b, n, self.num_classes, 4)


class MaskHead(nn.Module):
    """4 convs + 2× upsample → per-class mask logits at 2×RoI resolution.

    The upsample is Mask R-CNN's 2×2/stride-2 transposed conv written, as
    in the JAX package, as Dense(4·C) + depth-to-space: with kernel ==
    stride there is no tap overlap, so it is one [C, 4·C] product."""

    def __init__(self, num_classes: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        for i in range(4):
            setattr(self, f"conv_{i}",
                    Conv(FPN_DIM, FPN_DIM, 3, 1, dtype, bias=True))
        self.upsample = Dense(FPN_DIM, 4 * FPN_DIM, dtype)
        self.mask_logits = Conv(FPN_DIM, num_classes, 1, 1, torch.float32,
                                bias=True)

    def forward(self, rois: torch.Tensor) -> torch.Tensor:
        """rois [B, N, s, s, C] → mask logits [B, N, 2s, 2s, K] f32."""
        b, n, s, _, c = rois.shape
        # NHWC seen as NCHW is channels_last.
        x = rois.reshape(b * n, s, s, c).permute(0, 3, 1, 2)
        for i in range(4):
            x = torch.relu(getattr(self, f"conv_{i}")(x))
        # y[2i+a, 2j+b, o] = Σ_c x[i,j,c]·W[(a,b,o),c]: one product, then
        # the pixel shuffle.
        x = self.upsample(x.permute(0, 2, 3, 1))  # [bn, s, s, 4C]
        x = x.reshape(b * n, s, s, 2, 2, FPN_DIM).permute(0, 1, 3, 2, 4, 5)
        x = torch.relu(x.reshape(b * n, 2 * s, 2 * s, FPN_DIM))
        x = self.mask_logits(x.permute(0, 3, 1, 2))  # [bn, K, 2s, 2s]
        return x.permute(0, 2, 3, 1).reshape(b, n, 2 * s, 2 * s,
                                             self.num_classes)


def convert_deconv_to_upsample(w_convt: np.ndarray) -> np.ndarray:
    """A pre-rework Flax MaskHead ``deconv`` ConvTranspose kernel
    ([2, 2, C, Cout]) → the ``upsample`` Dense kernel ([C, 4·Cout]).

    Flax's ConvTranspose with kernel == stride == 2 and SAME padding places
    kernel tap (a, b) at output offset (1-a, 1-b) within each 2×2 block, so
    the taps are flipped before they are flattened into the (a, b, out)
    ordered Dense columns that the depth-to-space expects."""
    k_h, k_w, c, c_out = w_convt.shape
    if (k_h, k_w) != (2, 2):
        raise ValueError(
            f"expected a 2x2 ConvTranspose kernel, got {w_convt.shape}")
    return w_convt[::-1, ::-1].transpose(2, 0, 1, 3).reshape(c, 4 * c_out)


class MaskRCNN(nn.Module):
    """Backbone + FPN + RPN forward; the heads are run by the task between
    its ROI-aligns."""

    def __init__(self, num_classes: int, dtype: torch.dtype = torch.bfloat16,
                 num_anchors_per_cell: int = 3, mesh=None):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        # Split rows only where the axis is real: a one-way mesh runs the
        # plain path.
        self.split_mesh = mesh if mesh is not None and \
            mesh.spatial_ways > 1 else None
        self.backbone = ResNetFeatures(dtype=dtype, mesh=self.split_mesh)
        self.fpn = FPN(self.backbone.out_features, dtype)
        for trunk in (self.backbone, self.fpn):
            for mod in trunk.modules():
                if isinstance(mod, Conv):
                    mod.mesh = self.split_mesh
        self.rpn = RpnHead(num_anchors_per_cell, dtype)
        self.box_head = BoxHead(num_classes, dtype=dtype)
        self.mask_head = MaskHead(num_classes, dtype)

    def forward(self, images: torch.Tensor, train: bool = True
                ) -> Dict[str, object]:
        """images [B,H,W,3] → {"pyramid": {2..6: [B,C,H,W]},
        "rpn_logits": [B, A] f32, "rpn_deltas": [B, A, 4] f32}, the levels
        concatenated in ascending order (``generate_anchors``' layout).
        Over a ``spatial`` axis ``images`` are this process's rows and the
        pyramid comes back whole."""
        mesh = self.split_mesh
        if mesh is not None and images.shape[1] % 64:
            ways = mesh.spatial_ways
            raise ValueError(
                f"images of {images.shape[1] * ways} rows over the spatial "
                f"axis ({ways} ways): each process's rows must be a "
                f"multiple of 64, so the image size a multiple of "
                f"{64 * ways} (the smallest is {64 * ways})")
        pyramid = self.fpn(self.backbone(images, train))
        if mesh is not None:
            pyramid = {lvl: gather_rows(p, mesh).contiguous(
                memory_format=torch.channels_last)
                for lvl, p in pyramid.items()}
        outs = [self.rpn(pyramid[lvl])
                for lvl in range(MIN_LEVEL, MAX_LEVEL + 1)]
        return {"pyramid": pyramid,
                "rpn_logits": torch.cat([o[0] for o in outs], 1),
                "rpn_deltas": torch.cat([o[1] for o in outs], 1)}

    def run_box_head(self, rois: torch.Tensor):
        return self.box_head(rois)

    def run_mask_head(self, rois: torch.Tensor) -> torch.Tensor:
        return self.mask_head(rois)


def _variance_scaling_(w: torch.Tensor, scale: float,
                       generator: torch.Generator) -> None:
    """Flax ``variance_scaling(scale, "fan_in", "truncated_normal")`` (the
    default ``lecun_normal`` at scale 1): a normal truncated at ±2σ with
    variance scale/fan_in; ``w`` is [out, in, ...]."""
    fan_in = w[0].numel()
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=generator)


def init_weights(model: MaskRCNN, generator: torch.Generator) -> None:
    """Seeded init with Flax's distributions: the trunk as the ResNet's
    (``resnet.init_weights``: fan-out normal convs, each block's last BN
    scale 0), every other conv and Dense kernel ``lecun_normal`` with a zero
    bias, and the mask head's ``upsample`` kernel
    ``variance_scaling(0.25, "fan_in", "truncated_normal")``. Runs on the
    model's device with ``generator``."""
    resnet.init_weights(model.backbone, generator)
    with torch.no_grad():
        for head in (model.fpn, model.rpn, model.box_head, model.mask_head):
            for mod in head.modules():
                if isinstance(mod, (Conv, Dense)):
                    scale = 0.25 if mod is model.mask_head.upsample else 1.0
                    _variance_scaling_(mod.weight, scale, generator)
                    mod.bias.zero_()


def forward_flops(model: MaskRCNN, image_size: int, num_rois: int,
                  num_mask_rois: int) -> int:
    """Forward multiply-adds ×2 of one image, counted from the model's conv
    and Dense shapes: the trunk as ``resnet.forward_flops`` counts it, the
    FPN's laterals and 3×3 posts, the RPN at every level, the box head on
    ``num_rois`` RoIs and the mask head on ``num_mask_rois``. BatchNorm,
    activations, ROI-align, NMS and the losses are left out."""
    trunk = model.backbone

    def conv_flops(conv: Conv, size: int) -> int:
        out, cin, kh, kw = conv.weight.shape
        return 2 * kh * kw * cin * out * size * size

    size = -(-image_size // 2)
    flops = conv_flops(trunk.conv_init, size)
    size = -(-size // 2)  # the 3×3/s2 max-pool
    for block in trunk.blocks:
        s_in = size
        for conv in block.convs:
            size = -(-size // conv.stride)
            flops += conv_flops(conv, size)
        if block.project:
            flops += conv_flops(block.conv_proj, -(-s_in //
                                                  block.conv_proj.stride))
    sizes = {lvl: -(-image_size // 2**lvl)
             for lvl in range(MIN_LEVEL, MAX_LEVEL + 1)}
    for lvl in range(2, 6):
        flops += conv_flops(getattr(model.fpn, f"lateral_{lvl}"), sizes[lvl])
        flops += conv_flops(getattr(model.fpn, f"post_{lvl}"), sizes[lvl])
    rpn = model.rpn
    for lvl in range(MIN_LEVEL, MAX_LEVEL + 1):
        flops += sum(conv_flops(c, sizes[lvl]) for c in
                     (rpn.rpn_conv, rpn.rpn_logits, rpn.rpn_deltas))
    dense = lambda d: 2 * d.weight.shape[0] * d.weight.shape[1]
    box = model.box_head
    flops += num_rois * sum(dense(d) for d in
                            (box.fc1, box.fc2, box.cls, box.box))
    mask = model.mask_head
    s = MASK_ROI_SIZE
    per_mask = sum(conv_flops(getattr(mask, f"conv_{i}"), s)
                   for i in range(4))
    per_mask += s * s * dense(mask.upsample)
    per_mask += conv_flops(mask.mask_logits, 2 * s)
    return flops + num_mask_rois * per_mask


@register_model("maskrcnn_resnet50")
def maskrcnn_resnet50(num_classes: int = 91, dtype=torch.bfloat16,
                      device: Optional[torch.device] = None, **kw):
    # image_size/max_boxes ride in ModelConfig.kwargs for the task, not the
    # module (shapes come in with the data).
    kw.pop("image_size", None)
    kw.pop("max_boxes", None)
    with torch.device(device or "cpu"):
        return MaskRCNN(num_classes=num_classes, dtype=dtype, **kw)
