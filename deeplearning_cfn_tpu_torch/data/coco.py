"""Real COCO ingestion: annotation JSON + image dir → detection npz — a
copy of ``deeplearning_cfn_tpu/data/coco.py`` (numpy; PIL imported only
inside the functions that draw and resize, so nothing on the training path
needs it).

The reference's Mask R-CNN workload (TensorPack — SURVEY.md §3.1) consumed
COCO's instances_*.json + JPEG directories directly, with dynamic-shape
per-image annotation lists. This converter runs that ingestion ONCE
offline and writes the rebuild's static-shape detection contract
(data/detection.py): square f32 images, boxes padded to ``max_boxes``,
labels (0 = padding, COCO category ids kept 1-based as-is — the
maskrcnn_coco preset's num_classes=91 covers the sparse id space), and
GT masks stored **box-aligned at 28×28** — the mask-head target
resolution, sampled with the same box-frame convention
metrics/coco_map.py's PastedMask pastes back with.

Geometry: aspect-preserving resize by ``image_size / max(H, W)`` with
bottom/right zero padding (boxes/polygons scale by one factor — no
distortion). iscrowd annotations are skipped (standard training practice;
RLE crowds are eval-only in the reference too). Objects beyond
``max_boxes`` are dropped largest-first-kept and counted.

Scale note: npz holds the whole split in one array — right for the
fixture-scale and fine-tuning datasets this repo can test offline
(convert at a reduced ``--image-size`` or ``--limit`` for smoke runs);
pod-scale COCO would use the same converter sharded per file-range, one
npz per shard.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

MASK_SIZE = 28
_SUPERSAMPLE = 2  # rasterize polygons at 2x then average-pool to 28


def _polygons_to_box_mask(polys: List[List[float]], y0: float, x0: float,
                          bh: float, bw: float) -> np.ndarray:
    """COCO polygons (image coords, [x1,y1,x2,y2,...] flat lists) → one
    box-aligned [28, 28] float mask. Drawn with PIL at 2× supersample and
    average-pooled, so partial-coverage cells get fractional values the
    bilinear paste-back reproduces smoothly."""
    from PIL import Image, ImageDraw

    s = MASK_SIZE * _SUPERSAMPLE
    canvas = Image.new("L", (s, s), 0)
    draw = ImageDraw.Draw(canvas)
    drew = False
    for poly in polys:
        if len(poly) < 6:
            continue
        pts = [
            (
                (poly[i] - x0) / max(bw, 1e-3) * s,
                (poly[i + 1] - y0) / max(bh, 1e-3) * s,
            )
            for i in range(0, len(poly) - 1, 2)
        ]
        draw.polygon(pts, fill=255)
        drew = True
    if not drew:
        return np.zeros((MASK_SIZE, MASK_SIZE), np.float32)
    arr = np.asarray(canvas, np.float32) / 255.0
    return arr.reshape(MASK_SIZE, _SUPERSAMPLE, MASK_SIZE,
                       _SUPERSAMPLE).mean((1, 3))


def prepare_coco(annotations_path: str, images_dir: str, out_dir: str,
                 split: str, image_size: int = 1024, max_boxes: int = 100,
                 limit: int = 0) -> Dict[str, int]:
    """instances_*.json + image dir → ``<out_dir>/<split>.npz`` in the
    detection contract. Returns counts (images, objects, skipped_crowd,
    dropped_over_max)."""
    from PIL import Image

    if split not in ("train", "eval"):
        raise ValueError(f"split must be 'train' or 'eval', got {split!r}")
    with open(annotations_path) as f:
        coco = json.load(f)
    by_image: Dict[int, List[dict]] = {}
    skipped_crowd = 0
    for ann in coco.get("annotations", []):
        if ann.get("iscrowd", 0):
            skipped_crowd += 1
            continue
        by_image.setdefault(ann["image_id"], []).append(ann)

    images_meta = coco.get("images", [])
    if limit:
        images_meta = images_meta[:limit]
    n = len(images_meta)
    if n == 0:
        raise ValueError(f"{annotations_path}: no images listed")
    est_gib = n * image_size * image_size * 3 / 2 ** 30
    if est_gib > 8.0:
        raise ValueError(
            f"{n} images at {image_size}² is ~{est_gib:.0f} GiB in one npz "
            f"— beyond the single-file contract. Convert a subset "
            f"(--limit), reduce --image-size, or run per file-range shard "
            f"(one npz each) for pod-scale COCO.")

    images = np.zeros((n, image_size, image_size, 3), np.uint8)
    boxes = np.zeros((n, max_boxes, 4), np.float32)
    labels = np.zeros((n, max_boxes), np.int32)
    masks = np.zeros((n, max_boxes, MASK_SIZE, MASK_SIZE), np.float32)
    total_objects = 0
    dropped = 0
    skipped_degenerate = 0

    for i, meta in enumerate(images_meta):
        path = os.path.join(images_dir, meta["file_name"])
        with Image.open(path) as im:
            im = im.convert("RGB")
            w0, h0 = im.size
            scale = image_size / max(w0, h0)
            nw, nh = max(1, round(w0 * scale)), max(1, round(h0 * scale))
            im = im.resize((nw, nh), Image.BILINEAR)
            images[i, :nh, :nw] = np.asarray(im, np.uint8)

        anns = by_image.get(meta["id"], [])
        # Degenerate (sub-pixel after scaling) boxes go first, BEFORE the
        # cap — a dud must never consume a slot a real object needed.
        scaled = []
        for ann in anns:
            x, y, bw, bh = [float(v) * scale for v in ann["bbox"]]
            y1 = min(y + bh, image_size)
            x1 = min(x + bw, image_size)
            if y1 - y < 1.0 or x1 - x < 1.0:
                skipped_degenerate += 1
                continue
            scaled.append((ann, (y, x, y1, x1)))
        # Largest objects first: when the cap bites, small instances are
        # the standard sacrifice (they are also the least learnable).
        scaled.sort(key=lambda p: -float(p[0].get("area", 0.0)))
        if len(scaled) > max_boxes:
            dropped += len(scaled) - max_boxes
            scaled = scaled[:max_boxes]
        for j, (ann, (y0, x0, y1, x1)) in enumerate(scaled):
            boxes[i, j] = (y0, x0, y1, x1)
            labels[i, j] = int(ann["category_id"])
            seg = ann.get("segmentation")
            if isinstance(seg, list) and seg:
                polys = [[v * scale for v in poly] for poly in seg]
                masks[i, j] = _polygons_to_box_mask(
                    polys, y0, x0, y1 - y0, x1 - x0)
            else:
                # No polygon (or RLE on a non-crowd, rare): whole-box mask.
                masks[i, j] = 1.0
            total_objects += 1

    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, f"{split}.npz"), image=images,
             boxes=boxes, labels=labels, masks=masks)
    return {"images": n, "objects": total_objects,
            "skipped_crowd": skipped_crowd,
            "skipped_degenerate": skipped_degenerate,
            "dropped_over_max": dropped,
            "image_size": image_size, "max_boxes": max_boxes}
