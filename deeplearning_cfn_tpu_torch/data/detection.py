"""Detection source: COCO-style batches with static shapes — a copy of
``deeplearning_cfn_tpu/data/detection.py`` (numpy only; the same arrays for
the same arguments).

Replaces the reference Mask R-CNN's COCO data layer (TensorPack image/anno
loading). Two paths, same contract as the other sources:

- **Real data**: ``<data_dir>/<split>.npz`` with the keys below (COCO
  converted offline; masks stored box-aligned at 28×28 — the mask-head
  target resolution, which is also how the TPU reference implementations
  shipped their targets).
- **Synthetic**: deterministic scenes of colored ellipses/rectangles on
  noise; class = shape×color. Learnable: the RPN can localize the shapes
  and the heads can classify/segment them, so detection losses fall fast
  enough for convergence smoke tests.

Batch contract (all static; label 0 = padding, classes are 1-based):
  image [H, W, 3] f32 | boxes [N, 4] f32 (y0,x0,y1,x1 pixels)
  labels [N] i32     | masks [N, 28, 28] f32 (box-aligned)
"""

from __future__ import annotations

import os

import numpy as np

from ..config import DataConfig
from .pipeline import ArraySource

MASK_SIZE = 28
_KEYS = ("image", "boxes", "labels", "masks")


def make_detection_source(num_examples: int, image_size: int,
                          num_classes: int, max_boxes: int,
                          seed: int) -> ArraySource:
    rng = np.random.RandomState(seed)
    # class = 1 + shape * n_colors + color; shape 0 = rectangle, 1 = ellipse.
    n_fg = max(2, num_classes - 1)
    n_colors = max(1, n_fg // 2)
    palette = rng.rand(n_colors, 3).astype(np.float32) * 0.8 + 0.2

    images = rng.normal(0.0, 0.05, (num_examples, image_size, image_size, 3)
                        ).astype(np.float32)
    boxes = np.zeros((num_examples, max_boxes, 4), np.float32)
    labels = np.zeros((num_examples, max_boxes), np.int32)
    masks = np.zeros((num_examples, max_boxes, MASK_SIZE, MASK_SIZE),
                     np.float32)

    yy, xx = np.mgrid[0:MASK_SIZE, 0:MASK_SIZE]
    unit_y = (yy + 0.5) / MASK_SIZE * 2 - 1  # [-1, 1] box coords
    unit_x = (xx + 0.5) / MASK_SIZE * 2 - 1

    min_sz = max(6, image_size // 8)
    max_sz = max(min_sz + 2, image_size // 3)
    for i in range(num_examples):
        n_obj = rng.randint(1, min(max_boxes, 4) + 1)
        for j in range(n_obj):
            h = rng.randint(min_sz, max_sz)
            w = rng.randint(min_sz, max_sz)
            y0 = rng.randint(0, image_size - h)
            x0 = rng.randint(0, image_size - w)
            shape = rng.randint(0, 2)
            color = rng.randint(0, n_colors)
            cls = 1 + (shape * n_colors + color) % n_fg
            if shape == 0:
                mask28 = np.ones((MASK_SIZE, MASK_SIZE), np.float32)
            else:
                mask28 = ((unit_y ** 2 + unit_x ** 2) <= 1.0) \
                    .astype(np.float32)
            # Paint the object into the image at box resolution.
            obj_y = np.clip((np.arange(h) + 0.5) / h * MASK_SIZE - 0.5,
                            0, MASK_SIZE - 1).astype(int)
            obj_x = np.clip((np.arange(w) + 0.5) / w * MASK_SIZE - 0.5,
                            0, MASK_SIZE - 1).astype(int)
            stamp = mask28[np.ix_(obj_y, obj_x)][:, :, None] * palette[color]
            region = images[i, y0:y0 + h, x0:x0 + w]
            images[i, y0:y0 + h, x0:x0 + w] = np.where(
                stamp.sum(-1, keepdims=True) > 0, stamp, region)
            boxes[i, j] = [y0, x0, y0 + h, x0 + w]
            labels[i, j] = cls
            masks[i, j] = mask28
    return ArraySource({"image": images, "boxes": boxes, "labels": labels,
                        "masks": masks})


def _load_npz(data_dir: str, split: str) -> ArraySource:
    path = os.path.join(data_dir, f"{split}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found; expected an .npz with keys {list(_KEYS)} "
            "(COCO converted offline, masks box-aligned 28x28)"
        )
    with np.load(path) as z:
        missing = [k for k in _KEYS if k not in z]
        if missing:
            raise KeyError(f"{path} missing keys {missing}")
        arrays = {k: np.asarray(z[k]) for k in _KEYS}
    # data prepare-coco stores images uint8 (4x smaller on disk); the batch
    # contract is f32 in [0, 1].
    if arrays["image"].dtype == np.uint8:
        arrays["image"] = arrays["image"].astype(np.float32) / 255.0
    return ArraySource(arrays)


def build_detection_source(cfg: DataConfig, train: bool,
                           num_classes: int = 91,
                           max_boxes: int = 16) -> ArraySource:
    if cfg.data_dir and not cfg.synthetic:
        return _load_npz(cfg.data_dir, "train" if train else "eval")
    n = cfg.num_train_examples or 512
    if not train:
        n = cfg.num_eval_examples or max(64, n // 8)
    return make_detection_source(n, cfg.image_size, num_classes, max_boxes,
                                 seed=47 if train else 53)
