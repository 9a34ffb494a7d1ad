"""Detection ops in static-shape form — the port of
``deeplearning_cfn_tpu/ops/detection.py``.

The JAX module is plain ``jnp`` that XLA lowers (no Pallas kernel), so this
is plain PyTorch on tensors. Every op keeps the JAX formulation and its
fixed shapes: boxes padded to a fixed count with a validity mask, NMS as a
K×K suppression matrix walked by a fixed-length loop, ROI-align as row
gathers from one flattened pyramid table. What the port adds is a batch
dimension: where the JAX task ``vmap``s an op over images (and, at eval,
over classes), these functions take the leading dims directly, so nothing
loops in Python over boxes, images or classes.

Kept exactly:

- **Ties break to the lowest index.** ``jax.lax.top_k`` returns the lower
  index first among equal values; ``torch.topk`` promises no order for
  ties, so :func:`top_k` is a stable descending sort.
- **NMS is greedy and sequential** (:func:`nms_static`): ``k`` steps on the
  device, each one masking what box ``i`` suppresses if ``i`` is still
  kept — no host sync inside the loop. Scores below ``-5e29`` (the
  ``-1e30`` padding convention, and ``-inf``) never survive.
- **ROI-align gathers in the features' dtype and computes in f32**
  (:func:`multilevel_roi_align`): rows of the bf16 table are gathered, the
  separable bilinear weights are f32 with the outside-the-map mask folded
  in, the 2×2 samples are averaged in f32 and cast back. The gradient
  reaches the features through the gather (an ``index_add`` on the way
  back — atomics on the card, so card results agree to a tolerance, not bit
  for bit); the boxes carry none.

Boxes are ``[y0, x0, y1, x1]`` in image (or feature) coordinates.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

EPS = 1e-8


# -- box math ---------------------------------------------------------------


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return torch.clamp(boxes[..., 2] - boxes[..., 0], min=0) * \
        torch.clamp(boxes[..., 3] - boxes[..., 1], min=0)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: a [..., N, 4], b [..., M, 4] → [..., N, M] (leading
    dims broadcast)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / torch.clamp(union, min=EPS)


def encode_boxes(boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Box → (dy, dx, dh, dw) deltas w.r.t. anchors (R-CNN
    parameterization)."""
    ah = anchors[..., 2] - anchors[..., 0]
    aw = anchors[..., 3] - anchors[..., 1]
    ay = anchors[..., 0] + 0.5 * ah
    ax = anchors[..., 1] + 0.5 * aw
    bh = boxes[..., 2] - boxes[..., 0]
    bw = boxes[..., 3] - boxes[..., 1]
    by = boxes[..., 0] + 0.5 * bh
    bx = boxes[..., 1] + 0.5 * bw
    ah_, aw_ = torch.clamp(ah, min=EPS), torch.clamp(aw, min=EPS)
    return torch.stack([
        (by - ay) / ah_,
        (bx - ax) / aw_,
        torch.log(torch.clamp(bh, min=EPS) / ah_),
        torch.log(torch.clamp(bw, min=EPS) / aw_),
    ], dim=-1)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 clip_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    ah = anchors[..., 2] - anchors[..., 0]
    aw = anchors[..., 3] - anchors[..., 1]
    ay = anchors[..., 0] + 0.5 * ah
    ax = anchors[..., 1] + 0.5 * aw
    # Clamp dh/dw as in Detectron (the exp overflow guard).
    dh = torch.clamp(deltas[..., 2], -4.0, 4.0)
    dw = torch.clamp(deltas[..., 3], -4.0, 4.0)
    by = deltas[..., 0] * ah + ay
    bx = deltas[..., 1] * aw + ax
    bh = torch.exp(dh) * ah
    bw = torch.exp(dw) * aw
    boxes = torch.stack([by - 0.5 * bh, bx - 0.5 * bw,
                         by + 0.5 * bh, bx + 0.5 * bw], dim=-1)
    if clip_hw is not None:
        h, w = clip_hw
        hi = device_values([h, w, h, w], boxes.dtype, boxes.device)
        boxes = torch.minimum(torch.clamp(boxes, min=0.0), hi)
    return boxes


def device_values(values: Sequence[float], dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)`` written by one
    fill per value: no copy from host memory, which a CUDA graph capture
    refuses (``train/graphs.py``). Each value is rounded to ``dtype`` as
    ``torch.tensor`` rounds it."""
    out = torch.empty(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out


# -- anchors ----------------------------------------------------------------


def generate_anchors(
    image_hw: Tuple[int, int],
    strides: Sequence[int],
    scales: Sequence[float],
    ratios: Sequence[float] = (0.5, 1.0, 2.0),
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Static anchor grid, concatenated over levels → [A_total, 4] f32, laid
    out per level as (y, x, ratio) — the RPN head's NHWC flattening order.

    One scale per level (FPN convention), ``len(ratios)`` anchors per cell.
    Computed in f32 numpy with the JAX function's operation order, so the
    anchors are bit-equal to it.
    """
    all_anchors: List[np.ndarray] = []
    for stride, scale in zip(strides, scales):
        # Ceil division: stride-2 SAME convs produce ceil-sized feature
        # maps, and nested ceils collapse (ceil(ceil(H/32)/2) == ceil(H/64)).
        fh = max(1, -(-image_hw[0] // stride))
        fw = max(1, -(-image_hw[1] // stride))
        f32 = np.float32
        cy = (np.arange(fh, dtype=f32) + f32(0.5)) * f32(stride)
        cx = (np.arange(fw, dtype=f32) + f32(0.5)) * f32(stride)
        shapes = np.asarray([(scale * (r ** 0.5), scale / (r ** 0.5))
                             for r in ratios], f32)  # [R, 2]
        r = len(ratios)
        grid_y = np.broadcast_to(cy[:, None, None], (fh, fw, r))
        grid_x = np.broadcast_to(cx[None, :, None], (fh, fw, r))
        hh = np.broadcast_to(shapes[None, None, :, 0], (fh, fw, r))
        ww = np.broadcast_to(shapes[None, None, :, 1], (fh, fw, r))
        half_h, half_w = hh / f32(2), ww / f32(2)
        anchors = np.stack([grid_y - half_h, grid_x - half_w,
                            grid_y + half_h, grid_x + half_w], axis=-1)
        all_anchors.append(anchors.reshape(-1, 4))
    return torch.from_numpy(np.concatenate(all_anchors, 0)).to(device)


# -- top-k and static NMS ---------------------------------------------------


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the ``k`` largest values in
    descending order, equal values by ascending index (a stable sort; the
    order ``torch.topk`` gives ties is unspecified)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx, :]`` per leading index: x [*L, N, *F], idx [*L, K] →
    [*L, K, *F] (``jnp.take_along_axis`` on the row axis)."""
    lead = idx.dim()
    tail = x.shape[lead:]
    index = idx.reshape(idx.shape + (1,) * len(tail)).expand(
        idx.shape + tail)
    return torch.gather(x, lead - 1, index)


def nms_static(boxes: torch.Tensor, scores: torch.Tensor,
               iou_threshold: float, max_outputs: int,
               valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-shape NMS over the top ``max_outputs`` candidates, batched over
    leading dims: boxes [*L, N, 4], scores [*L, N] → (indices [*L, K] into
    the input, keep [*L, K] bool).

    Greedy: box ``i`` (in score order) suppresses every later box whose IoU
    with it exceeds the threshold, if ``i`` itself survived. ``k`` device
    steps over a K×K suppression matrix — no host sync. Padding: ``valid``
    (bool [*L, N]) marks real candidates; otherwise any score at or below
    the ``-5e29`` sentinel threshold (``-inf`` and the ``-1e30``
    convention) is padding.
    """
    k = max_outputs
    if valid is not None:
        scores = torch.where(valid, scores,
                             torch.full_like(scores, -float("inf")))
    top_scores, top_idx = top_k(scores, k)
    top_boxes = take_rows(boxes, top_idx)
    iou = iou_matrix(top_boxes, top_boxes)
    ar = torch.arange(k, device=boxes.device)
    # (iou > thr) & ~eye & (j > i): only later boxes can be suppressed.
    suppress = (iou > iou_threshold) & (ar[None, :] > ar[:, None])
    keep = torch.ones(top_scores.shape, dtype=torch.bool,
                      device=boxes.device)
    for i in range(k):
        keep = keep & ~(suppress[..., i, :] & keep[..., i:i + 1])
    keep = keep & (top_scores > -5e29)
    return top_idx, keep


# -- ROI-align --------------------------------------------------------------


def _bilinear_sample(feat: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor
                     ) -> torch.Tensor:
    """Gather-based bilinear sampling: feat [*L, H, W, C], sample points
    ys/xs [*L, *S] (the leading dims ``L`` index the maps) → [*L, *S, C].
    Samples fully outside the map are zero."""
    h, w, c = feat.shape[-3:]
    lead = feat.shape[:-3]
    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    y1, x1 = y0 + 1, x0 + 1
    wy1 = ys - y0.to(ys.dtype)
    wx1 = xs - x0.to(xs.dtype)
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    y0c, y1c = y0.clamp(0, h - 1), y1.clamp(0, h - 1)
    x0c, x1c = x0.clamp(0, w - 1), x1.clamp(0, w - 1)
    n_maps = int(np.prod(lead, dtype=np.int64))
    flat = feat.reshape(n_maps * h * w, c)
    base = (torch.arange(n_maps, device=feat.device) * (h * w)).reshape(
        tuple(lead) + (1,) * (ys.dim() - len(lead)))

    def at(yc, xc):
        idx = base + yc * w + xc
        return flat.index_select(0, idx.reshape(-1)).reshape(
            idx.shape + (c,))

    out = (at(y0c, x0c) * (wy0 * wx0)[..., None]
           + at(y0c, x1c) * (wy0 * wx1)[..., None]
           + at(y1c, x0c) * (wy1 * wx0)[..., None]
           + at(y1c, x1c) * (wy1 * wx1)[..., None])
    inside = (ys >= -1) & (ys <= h) & (xs >= -1) & (xs <= w)
    return out * inside[..., None]


def roi_align(feat: torch.Tensor, boxes: torch.Tensor, out_size: int,
              spatial_scale: float = 1.0, sampling_ratio: int = 2
              ) -> torch.Tensor:
    """ROI-align one feature map: feat [H,W,C], boxes [N,4] (image coords)
    → [N, out_size, out_size, C]. 2×2 bilinear samples per output bin,
    averaged (Detectron's sampling_ratio=2)."""
    boxes = boxes * spatial_scale
    s = sampling_ratio
    size = out_size * s
    bh = torch.clamp(boxes[:, 2] - boxes[:, 0], min=EPS)
    bw = torch.clamp(boxes[:, 3] - boxes[:, 1], min=EPS)
    cell_h, cell_w = bh / out_size, bw / out_size
    iy = (torch.arange(size, dtype=feat.dtype, device=feat.device)
          + 0.5) / s
    ys = boxes[:, 0:1] + iy[None, :] * cell_h[:, None] - 0.5  # [N, S]
    xs = boxes[:, 1:2] + iy[None, :] * cell_w[:, None] - 0.5
    n = boxes.shape[0]
    yy = ys[:, :, None].expand(n, size, size)
    xx = xs[:, None, :].expand(n, size, size)
    samples = _bilinear_sample(feat, yy, xx)  # [N, S, S, C]
    c = samples.shape[-1]
    return samples.reshape(n, out_size, s, out_size, s, c).mean((2, 4))


def multilevel_roi_align(
    feats: Dict[int, torch.Tensor],
    boxes: torch.Tensor,
    out_size: int,
    strides: Dict[int, int],
    canonical_level: int = 4,
    canonical_size: float = 224.0,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """FPN ROI-align over a batch: each box goes to the pyramid level its
    size picks (``k = k0 + log2(√area / 224)``) and is sampled there only.

    ``feats``: level → [B, C, Hₗ, Wₗ] (the model's NCHW, ideally
    channels_last, whose memory is NHWC); ``boxes`` [B, N, 4] in image
    coordinates → [B, N, out_size, out_size, C] in the features' dtype.

    The whole batch's pyramid is one [B·ΣHₗWₗ, C] row table (per image the
    levels in ascending order, as the JAX function's per-image table); a
    sample point is the row ``b·ΣHₗWₗ + offₗ + y·Wₗ + x``, so the op is four
    row gathers and separable bilinear weights whatever the level count.
    """
    levels = sorted(feats)
    if levels != list(range(levels[0], levels[-1] + 1)):
        raise ValueError(
            f"pyramid levels must be contiguous integers (the level->table "
            f"index mapping assumes it), got {levels}")
    first = feats[levels[0]]
    bsz, c = first.shape[0], first.shape[1]
    n = boxes.shape[1]
    s = sampling_ratio
    size = out_size * s
    dev = boxes.device

    sqrt_area = torch.sqrt(torch.clamp(box_area(boxes), min=EPS))
    target = torch.floor(canonical_level +
                         torch.log2(sqrt_area / canonical_size + EPS))
    tidx = target.clamp(levels[0], levels[-1]).long() - levels[0]  # [B, N]

    hs = [feats[l].shape[2] for l in levels]
    ws = [feats[l].shape[3] for l in levels]
    offs = np.concatenate([[0], np.cumsum(np.asarray(hs, np.int64)
                                          * np.asarray(ws))])
    rows = int(offs[-1])  # ΣHₗWₗ, one image's table
    # [B, C, H, W] → [B, H·W, C] (a view for channels_last), levels
    # concatenated per image, images stacked.
    flat = torch.cat([feats[l].permute(0, 2, 3, 1).reshape(bsz, -1, c)
                      for l in levels], dim=1).reshape(bsz * rows, c)

    lut = lambda vals, dtype: device_values(vals, dtype, dev)[tidx]
    inv_stride = lut([1.0 / strides[l] for l in levels], torch.float32)
    hl = lut(hs, torch.float32)
    wl = lut(ws, torch.float32)
    off = lut(offs[:-1].tolist(), torch.int64) + \
        torch.arange(bsz, device=dev)[:, None] * rows  # [B, N]

    bl = boxes.float() * inv_stride[..., None]  # level coordinates
    cell_h = torch.clamp(bl[..., 2] - bl[..., 0], min=EPS) / out_size
    cell_w = torch.clamp(bl[..., 3] - bl[..., 1], min=EPS) / out_size
    grid = (torch.arange(size, dtype=torch.float32, device=dev) + 0.5) / s
    ys = bl[..., 0:1] + grid * cell_h[..., None] - 0.5  # [B, N, S]
    xs = bl[..., 1:2] + grid * cell_w[..., None] - 0.5

    def axis_taps(coords, extent):
        """coords [B,N,S], per-box extent [B,N] → (i0, i1 clipped int64;
        w0, w1 f32 with the outside-map mask folded in)."""
        i0 = torch.floor(coords)
        frac = coords - i0
        inside = (coords >= -1) & (coords <= extent[..., None])
        i0i = i0.long()
        hi = (extent - 1).long()[..., None]
        zero = torch.zeros_like(hi)
        i0c = torch.minimum(torch.maximum(i0i, zero), hi)
        i1c = torch.minimum(torch.maximum(i0i + 1, zero), hi)
        w1 = frac * inside
        w0 = (1.0 - frac) * inside
        return i0c, i1c, w0, w1

    y0c, y1c, wy0, wy1 = axis_taps(ys, hl)
    x0c, x1c, wx0, wx1 = axis_taps(xs, wl)
    wli = wl.long()

    def corner(yc, xc):
        """Row-gather one corner: [B,N,S] y × [B,N,S] x → [B,N,S,S,C]."""
        idx = (off[..., None, None] + yc[..., :, None] * wli[..., None, None]
               + xc[..., None, :])
        return flat.index_select(0, idx.reshape(-1)).reshape(
            bsz, n, size, size, c)

    wy0_, wy1_ = wy0[..., :, None, None], wy1[..., :, None, None]
    wx0_, wx1_ = wx0[..., None, :, None], wx1[..., None, :, None]
    samples = (corner(y0c, x0c) * (wy0_ * wx0_)
               + corner(y0c, x1c) * (wy0_ * wx1_)
               + corner(y1c, x0c) * (wy1_ * wx0_)
               + corner(y1c, x1c) * (wy1_ * wx1_))  # [B,N,S,S,C] f32
    pooled = samples.reshape(bsz, n, out_size, s, out_size, s, c).mean(
        (3, 5))
    return pooled.to(first.dtype)
