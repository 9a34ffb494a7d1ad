"""COCO-style mean average precision over fixed-K detections — a copy of
``deeplearning_cfn_tpu/metrics/coco_map.py`` (numpy only).

The reference's Mask R-CNN workload (TensorPack on COCO — SURVEY.md §3.1;
BASELINE.md tracking row 5) was judged by COCO box/mask AP. This implements
the cocoeval protocol on the rebuild's static-shape detection outputs:

- AP = average over IoU thresholds 0.50:0.05:0.95 of the 101-point
  interpolated precision-recall area, averaged over classes with ≥1 GT;
- greedy score-ordered matching, one detection per GT, per threshold;
- mask AP uses mask IoU on image-space pasted masks (predictions are
  proposal-aligned 28×28, GT are GT-box-aligned 28×28 — both are pasted
  through the same bilinear resample so the comparison is symmetric).

Pure numpy/host code: it runs once per experiment over realized arrays.
Boxes are [y0, x0, y1, x1] pixels; class 0 means invalid/padding.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
RECALL_GRID = np.linspace(0.0, 1.0, 101)


def box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU: a [N,4], b [M,4] → [N,M]."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda x: np.clip(x[:, 2] - x[:, 0], 0, None) * \
        np.clip(x[:, 3] - x[:, 1], 0, None)
    union = area(a)[:, None] + area(b)[None, :] - inter
    return inter / np.maximum(union, 1e-9)


class PastedMask:
    """A box-aligned mask pasted into image space, stored as only its own
    integer-extent crop (patch + offset). Keeps mask IoU at the real
    workload's scale (1024² images, 100 detections) feasible: pairwise IoU
    touches only the overlap window of two crops, never full-image arrays.
    """

    __slots__ = ("y0", "x0", "patch", "count")

    def __init__(self, mask: np.ndarray, box: np.ndarray, height: int,
                 width: int, threshold: float = 0.5):
        m = mask.shape[0]
        y0, x0, y1, x1 = [float(v) for v in box]
        bh, bw = y1 - y0, x1 - x0
        self.y0, self.x0 = 0, 0
        self.patch = np.zeros((0, 0), bool)
        if bh <= 0 or bw <= 0:
            self.count = 0
            return
        iy0, iy1 = max(int(np.floor(y0)), 0), min(int(np.ceil(y1)), height)
        ix0, ix1 = max(int(np.floor(x0)), 0), min(int(np.ceil(x1)), width)
        if iy1 <= iy0 or ix1 <= ix0:
            self.count = 0
            return
        # Pixel centers of the target window in mask coordinates (bilinear,
        # like Detectron's paste_masks_in_image).
        ys = (np.arange(iy0, iy1) + 0.5 - y0) / bh * m - 0.5
        xs = (np.arange(ix0, ix1) + 0.5 - x0) / bw * m - 0.5
        yf = np.clip(np.floor(ys).astype(int), 0, m - 1)
        xf = np.clip(np.floor(xs).astype(int), 0, m - 1)
        yc = np.clip(yf + 1, 0, m - 1)
        xc = np.clip(xf + 1, 0, m - 1)
        wy = np.clip(ys - yf, 0.0, 1.0)[:, None]
        wx = np.clip(xs - xf, 0.0, 1.0)[None, :]
        patch = (mask[np.ix_(yf, xf)] * (1 - wy) * (1 - wx) +
                 mask[np.ix_(yf, xc)] * (1 - wy) * wx +
                 mask[np.ix_(yc, xf)] * wy * (1 - wx) +
                 mask[np.ix_(yc, xc)] * wy * wx)
        self.y0, self.x0 = iy0, ix0
        self.patch = patch >= threshold
        self.count = int(self.patch.sum())

    def iou(self, other: "PastedMask") -> float:
        ay1 = self.y0 + self.patch.shape[0]
        ax1 = self.x0 + self.patch.shape[1]
        by1 = other.y0 + other.patch.shape[0]
        bx1 = other.x0 + other.patch.shape[1]
        oy0, oy1 = max(self.y0, other.y0), min(ay1, by1)
        ox0, ox1 = max(self.x0, other.x0), min(ax1, bx1)
        if oy1 <= oy0 or ox1 <= ox0:
            return 0.0
        a = self.patch[oy0 - self.y0:oy1 - self.y0,
                       ox0 - self.x0:ox1 - self.x0]
        b = other.patch[oy0 - other.y0:oy1 - other.y0,
                        ox0 - other.x0:ox1 - other.x0]
        inter = int(np.logical_and(a, b).sum())
        union = self.count + other.count - inter
        return inter / max(union, 1e-9)


def paste_mask(mask: np.ndarray, box: np.ndarray, height: int, width: int,
               threshold: float = 0.5) -> np.ndarray:
    """Full-image [H,W] boolean paste — reference form of PastedMask, kept
    for tests and small-scale callers."""
    pm = PastedMask(mask, box, height, width, threshold)
    out = np.zeros((height, width), bool)
    if pm.count or pm.patch.size:
        out[pm.y0:pm.y0 + pm.patch.shape[0],
            pm.x0:pm.x0 + pm.patch.shape[1]] = pm.patch
    return out


def mask_iou_np(pred_masks: List, gt_masks: List) -> np.ndarray:
    """Pairwise IoU → [N,M]. Accepts PastedMask crops or raw boolean
    image-space arrays (auto-wrapped at offset 0)."""
    wrap = lambda x: x if isinstance(x, PastedMask) else _from_full(x)
    preds = [wrap(p) for p in pred_masks]
    gts = [wrap(g) for g in gt_masks]
    out = np.zeros((len(preds), len(gts)), np.float64)
    for i, p in enumerate(preds):
        for j, g in enumerate(gts):
            out[i, j] = p.iou(g)
    return out


def _from_full(arr: np.ndarray) -> PastedMask:
    pm = PastedMask.__new__(PastedMask)
    pm.y0, pm.x0 = 0, 0
    pm.patch = np.asarray(arr, bool)
    pm.count = int(pm.patch.sum())
    return pm


def _average_precision(tp: np.ndarray, fp: np.ndarray, n_gt: int) -> float:
    """101-point interpolated AP from score-ordered tp/fp indicator arrays."""
    if n_gt == 0:
        return float("nan")
    if len(tp) == 0:
        return 0.0
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / n_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    # Monotone non-increasing precision envelope (right-to-left max).
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    # Precision at each recall grid point: first index where recall >= r.
    idx = np.searchsorted(recall, RECALL_GRID, side="left")
    p_at_r = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
    return float(p_at_r.mean())


class DetectionAccumulator:
    """Streamed per-image accumulation → COCO AP summary.

    add_image() takes one image's fixed-K predictions (invalid slots have
    class 0 or score below the caller's floor) and its padded GT; compute()
    returns {"map", "map50", "mask_map", ...}. Keeping only (score, iou-row)
    tuples per class keeps memory flat in the eval-set size.
    """

    def __init__(self, iou_thresholds: np.ndarray = IOU_THRESHOLDS):
        self.thresholds = np.asarray(iou_thresholds, np.float64)
        # class → list of (score, box_iou_row [G_img], mask_iou_row, img_id)
        self._dets: Dict[int, list] = {}
        self._gt_counts: Dict[int, int] = {}
        self._next_img = 0

    def add_image(
        self,
        pred_boxes: np.ndarray, pred_scores: np.ndarray,
        pred_classes: np.ndarray,
        gt_boxes: np.ndarray, gt_labels: np.ndarray,
        pred_masks: Optional[np.ndarray] = None,
        gt_masks: Optional[np.ndarray] = None,
        image_hw: Optional[Tuple[int, int]] = None,
    ) -> None:
        img_id = self._next_img
        self._next_img += 1
        gt_keep = gt_labels > 0
        gt_boxes = np.asarray(gt_boxes, np.float64)[gt_keep]
        gt_labels = np.asarray(gt_labels)[gt_keep]
        for c in gt_labels:
            self._gt_counts[int(c)] = self._gt_counts.get(int(c), 0) + 1

        keep = np.asarray(pred_classes) > 0
        pred_boxes = np.asarray(pred_boxes, np.float64)[keep]
        pred_scores = np.asarray(pred_scores, np.float64)[keep]
        pred_classes = np.asarray(pred_classes)[keep]

        with_masks = pred_masks is not None and gt_masks is not None
        if with_masks:
            if image_hw is None:
                raise ValueError("image_hw required for mask AP")
            h, w = image_hw
            pred_masks = np.asarray(pred_masks)[keep]
            gm = np.asarray(gt_masks)[gt_keep]
            gt_pasted = [PastedMask(gm[j], gt_boxes[j], h, w)
                         for j in range(len(gm))]

        for c in np.unique(pred_classes):
            c = int(c)
            sel = pred_classes == c
            gsel = gt_labels == c
            ious = box_iou_np(pred_boxes[sel], gt_boxes[gsel])
            if with_masks:
                pp = [PastedMask(pm, pb, h, w) for pm, pb in
                      zip(pred_masks[sel], pred_boxes[sel])]
                gg = [gt_pasted[j] for j in np.flatnonzero(gsel)]
                mious = mask_iou_np(pp, gg)
            else:
                mious = None
            rows = self._dets.setdefault(c, [])
            for i, score in enumerate(pred_scores[sel]):
                rows.append((float(score), ious[i],
                             None if mious is None else mious[i], img_id))

    def _class_ap(self, rows: list, n_gt: int, thr: float,
                  use_mask: bool) -> float:
        """AP for one class at one IoU threshold; `rows` must already be
        sorted by descending score (compute() sorts once per class)."""
        matched: Dict[int, set] = {}
        tp = np.zeros(len(rows))
        fp = np.zeros(len(rows))
        for i, (_, iou_row, miou_row, img) in enumerate(rows):
            row = miou_row if use_mask else iou_row
            taken = matched.setdefault(img, set())
            best_j, best_iou = -1, thr
            for j in range(len(row)):
                if j in taken:
                    continue
                if row[j] >= best_iou:
                    best_iou, best_j = row[j], j
            if best_j >= 0:
                taken.add(best_j)
                tp[i] = 1
            else:
                fp[i] = 1
        return _average_precision(tp, fp, n_gt)

    def compute(self, with_masks: bool = False) -> Dict[str, float]:
        classes = sorted(self._gt_counts)
        per_thr = {float(t): [] for t in self.thresholds}
        per_thr_mask = {float(t): [] for t in self.thresholds}
        for c in classes:
            rows = sorted(self._dets.get(c, []), key=lambda r: -r[0])
            n_gt = self._gt_counts[c]
            for t in self.thresholds:
                per_thr[float(t)].append(
                    self._class_ap(rows, n_gt, float(t), False))
                if with_masks:
                    per_thr_mask[float(t)].append(
                        self._class_ap(rows, n_gt, float(t), True))
        if not classes:
            empty = {"map": 0.0, "map50": 0.0}
            if with_masks:
                empty.update({"mask_map": 0.0, "mask_map50": 0.0})
            return empty
        mean = lambda d, t: float(np.mean(d[float(t)]))
        out = {
            "map": float(np.mean([mean(per_thr, t) for t in self.thresholds])),
            "map50": mean(per_thr, self.thresholds[0]),
        }
        if with_masks:
            out["mask_map"] = float(
                np.mean([mean(per_thr_mask, t) for t in self.thresholds]))
            out["mask_map50"] = mean(per_thr_mask, self.thresholds[0])
        return out
