"""Mask R-CNN training task: proposals, target assignment, losses, and the
COCO-style acceptance metric — the port of
``deeplearning_cfn_tpu/train/detection_task.py``.

Every stage keeps the JAX task's fixed shapes and semantics; where the JAX
task ``vmap``s a per-image function, the port's function takes the batch
dimension itself (``ops/detection.py`` ops are batched), so no stage loops
in Python over images, boxes or classes:

1. RPN targets — dense anchor↔GT IoU assignment (no anchor sampling:
   positives and negatives are averaged separately). The best anchor of
   each valid GT is forced positive by a max-scatter, so two GTs sharing a
   best anchor cannot un-force it.
2. Proposals — decode → top ``pre_nms_topk`` → ``nms_static``, which keeps
   only the top ``min(post_nms_topk, k)`` of those before suppressing; the
   GT boxes are appended at train time; no gradient flows into them.
3. RoI heads — multilevel ROI-align, class and box losses over every valid
   proposal, the mask loss over the top ``num_mask_rois`` positives by IoU
   (a top-k over mostly zeros: ties go to the lowest index, as
   ``jax.lax.top_k`` breaks them), with the GT masks resampled from the
   GT-box frame to the proposal's.

All losses are means over their own weight sums, with ``eval_mask`` (the
padded eval tail) zero-weighting padded images. ``train.remat`` is ignored,
as the JAX task ignores it.

Over a ``spatial`` axis (``spatial_dim``, ``spatial_keys``: the trainer
gives each process its rows of ``image``; the GT boxes and masks stay
whole), the model returns the whole pyramid on every process of the group,
so the losses, the proposals and the predictions are the whole images'
on each of them: their weights are divided by ``Mesh.replicas``, and the
decoded eval set counts each image once.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import ExperimentConfig
from ..models import build_model
from ..models.maskrcnn import MASK_ROI_SIZE, ROI_SIZE
from ..parallel.collectives import gather_batches, global_total
from ..parallel.mesh import Mesh, build_mesh
from ..parallel.sharding import spatial_slice
from ..ops.detection import (_bilinear_sample, decode_boxes, encode_boxes,
                             generate_anchors, iou_matrix,
                             multilevel_roi_align, nms_static, take_rows,
                             top_k)
from .task import Batch, cross_entropy, example_mask

STRIDES = {2: 4, 3: 8, 4: 16, 5: 32, 6: 64}
LEVELS = (2, 3, 4, 5, 6)
MASK_SIZE = 28


def _huber(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax <= delta, 0.5 * x * x, delta * (ax - 0.5 * delta))


def _mean_where(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The weighted mean over the global batch (this process's share of it
    across processes: ``train/task.py``)."""
    return (values * weights).sum() / torch.clamp(
        global_total(weights.sum()), min=1.0)


def _sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``."""
    return -labels * F.logsigmoid(logits) - \
        (1.0 - labels) * F.logsigmoid(-logits)


def _at_class(mask_logits: torch.Tensor, classes: torch.Tensor
              ) -> torch.Tensor:
    """Each RoI's mask at its class: [B,N,M,M,K] at [B,N] → [B,N,M,M]."""
    b, n, h, w, _ = mask_logits.shape
    idx = classes[:, :, None, None, None].expand(b, n, h, w, 1)
    return torch.gather(mask_logits, 4, idx)[..., 0]


class DetectionTask:
    """Loss-producing task for ``maskrcnn_*`` models (preset
    ``maskrcnn_coco``). Batch contract: ``image`` [B,H,W,3] f32, ``boxes``
    [B,G,4] f32 (y0,x0,y1,x1 pixels), ``labels`` [B,G] (0 = padding),
    ``masks`` [B,G,28,28] f32 box-aligned."""

    exact_eval = True  # consume the padded full eval set (COCO protocol)

    def __init__(self, cfg: ExperimentConfig, device: torch.device,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.device = device
        self.mesh = mesh if mesh is not None else build_mesh(cfg.mesh)
        # JAX's: shard image H over the 'spatial' mesh axis (the masks'
        # dim 1 is a box count).
        self.spatial_dim = 1
        self.spatial_keys = ("image",)
        dtype = torch.bfloat16 if cfg.train.dtype == "bfloat16" \
            else torch.float32
        kw = dict(cfg.model.kwargs)
        self.image_size = int(kw.pop("image_size", cfg.data.image_size))
        kw.pop("max_boxes", None)
        self.pre_nms_topk = int(kw.pop("pre_nms_topk", 1024))
        self.post_nms_topk = int(kw.pop("post_nms_topk", 256))
        self.num_mask_rois = int(kw.pop("num_mask_rois", 64))
        self.nms_iou = float(kw.pop("nms_iou", 0.7))
        anchor_scale = float(kw.pop("anchor_scale", 8.0))
        self.model = build_model(cfg.model.name, cfg.model.num_classes,
                                 dtype, device=device, mesh=self.mesh, **kw)
        s = self.image_size
        self.anchors = generate_anchors(
            (s, s), strides=[STRIDES[l] for l in LEVELS],
            scales=[anchor_scale * STRIDES[l] for l in LEVELS],
            device=device)

    def init(self, generator: torch.Generator) -> None:
        """Seeded init with Flax's distributions, on the model's device."""
        from ..models.maskrcnn import init_weights

        init_weights(self.model, generator)

    # -- targets and proposals (batched over images) -------------------------

    def _rpn_targets(self, gt_boxes: torch.Tensor, gt_valid: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """gt [B,G,4], valid [B,G] → cls target [B,A] (1 pos / 0 neg / -1
        ignore) and box deltas [B,A,4]."""
        iou = iou_matrix(self.anchors, gt_boxes) * gt_valid[:, None, :]
        max_iou = iou.amax(2)
        matched = iou.argmax(2)
        pos = max_iou >= 0.7
        # Force-match: the best anchor of each valid GT is positive even
        # below the threshold. A max-scatter, not an assignment: two GTs
        # sharing a best anchor must not un-force it.
        best_anchor = iou.argmax(1)  # [B, G]
        force = torch.zeros_like(max_iou).scatter_reduce(
            1, best_anchor, (gt_valid > 0).to(max_iou.dtype), "amax")
        pos = pos | (force > 0)
        neg = (max_iou < 0.3) & ~pos
        cls_t = torch.where(pos, 1.0, torch.where(neg, 0.0, -1.0))
        box_t = encode_boxes(take_rows(gt_boxes, matched), self.anchors)
        return cls_t, box_t

    def _proposals_infer(self, rpn_logits: torch.Tensor,
                         rpn_deltas: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
        """Inference proposals: decode → top-K → NMS (no GT append) →
        (boxes [B,P,4], keep [B,P], the anchor index of each [B,P])."""
        scores = torch.sigmoid(rpn_logits)
        s = self.image_size
        boxes = decode_boxes(rpn_deltas, self.anchors, clip_hw=(s, s))
        k = min(self.pre_nms_topk, scores.shape[-1])
        top_scores, top_idx = top_k(scores, k)
        top_boxes = take_rows(boxes, top_idx)
        keep_idx, keep = nms_static(top_boxes, top_scores, self.nms_iou,
                                    min(self.post_nms_topk, k))
        return (take_rows(top_boxes, keep_idx), keep,
                torch.gather(top_idx, 1, keep_idx))

    def _proposals(self, rpn_logits, rpn_deltas, gt_boxes, gt_valid
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ boxes [B,P,4], valid [B,P] with P = post_nms_topk + max_boxes:
        the inference proposals plus the GT boxes (the train-time
        stabilizer), carrying no gradient."""
        props, keep, _ = self._proposals_infer(rpn_logits.detach(),
                                               rpn_deltas.detach())
        return (torch.cat([props, gt_boxes], 1),
                torch.cat([keep, gt_valid > 0], 1))

    def _roi_targets(self, props, valid, gt_boxes, gt_labels, gt_valid):
        iou = iou_matrix(props, gt_boxes) * gt_valid[:, None, :]
        max_iou = iou.amax(2)
        matched = iou.argmax(2)
        pos = (max_iou >= 0.5) & valid
        cls_t = torch.where(pos, torch.gather(gt_labels, 1, matched), 0)
        box_t = encode_boxes(take_rows(gt_boxes, matched), props)
        return cls_t, box_t, pos, matched, max_iou

    @staticmethod
    def _resample_mask(gt_mask: torch.Tensor, gt_box: torch.Tensor,
                       prop: torch.Tensor) -> torch.Tensor:
        """GT-box-aligned [..., 28, 28] masks → proposal-aligned targets
        [..., 28, 28] (boxes [..., 4])."""
        ar = (torch.arange(MASK_SIZE, device=gt_mask.device) + 0.5) \
            / MASK_SIZE
        gh = torch.clamp(gt_box[..., 2:3] - gt_box[..., 0:1], min=1e-3)
        gw = torch.clamp(gt_box[..., 3:4] - gt_box[..., 1:2], min=1e-3)
        py = prop[..., 0:1] + ar * torch.clamp(
            prop[..., 2:3] - prop[..., 0:1], min=1e-3)
        px = prop[..., 1:2] + ar * torch.clamp(
            prop[..., 3:4] - prop[..., 1:2], min=1e-3)
        ys = (py - gt_box[..., 0:1]) / gh * MASK_SIZE - 0.5
        xs = (px - gt_box[..., 1:2]) / gw * MASK_SIZE - 0.5
        shape = ys.shape + (MASK_SIZE,)
        yy = ys[..., :, None].expand(shape)
        xx = xs[..., None, :].expand(shape)
        return _bilinear_sample(gt_mask[..., None], yy, xx)[..., 0]

    # -- inference ------------------------------------------------------------

    def _detect(self, cls_probs, box_deltas, props, valid, topk: int,
                score_thr: float, nms_iou: float):
        """The JAX ``_detect_one`` over a batch: class-specific box decode,
        per-class NMS (batched over images and classes), global top-K →
        boxes [B,K,4], scores [B,K], classes [B,K] (0 = empty slot)."""
        b, p, num_classes = cls_probs.shape
        s = self.image_size
        fg_probs = cls_probs[:, :, 1:].transpose(1, 2)             # [B,C-1,P]
        fg_deltas = box_deltas[:, :, 1:, :].transpose(1, 2)        # [B,C-1,P,4]
        boxes_c = decode_boxes(fg_deltas, props[:, None], clip_hw=(s, s))
        ok = valid[:, None, :] & (fg_probs >= score_thr)
        idx, keep = nms_static(boxes_c, fg_probs, nms_iou, min(topk, p),
                               valid=ok)
        boxes_pc = take_rows(boxes_c, idx)
        scores_pc = torch.where(keep, torch.gather(fg_probs, 2, idx), 0.0)
        classes_pc = torch.arange(1, num_classes, device=props.device)[
            None, :, None].expand(scores_pc.shape)
        flat_boxes = boxes_pc.reshape(b, -1, 4)
        flat_scores = scores_pc.reshape(b, -1)
        flat_classes = classes_pc.reshape(b, -1)
        top_scores, top_i = top_k(flat_scores, min(topk,
                                                   flat_scores.shape[1]))
        out_classes = torch.where(top_scores > 0.0,
                                  torch.gather(flat_classes, 1, top_i), 0)
        return take_rows(flat_boxes, top_i), top_scores, out_classes

    def predict_fn(self, topk: int, score_thr: float, nms_iou: float
                   ) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
        """The full inference step: images [B,H,W,3] → {boxes [B,K,4],
        scores [B,K], classes [B,K], masks [B,K,28,28]} (eval-mode
        BatchNorm, no gradient)."""

        @torch.no_grad()
        def predict(images: torch.Tensor) -> Dict[str, torch.Tensor]:
            mdl = self.model
            out = mdl(images, train=False)
            props, valid, _ = self._proposals_infer(out["rpn_logits"],
                                                    out["rpn_deltas"])
            rois = multilevel_roi_align(out["pyramid"], props, ROI_SIZE,
                                        STRIDES)
            cls_logits, box_deltas = mdl.run_box_head(rois)
            cls_probs = torch.softmax(cls_logits.float(), -1)
            boxes, scores, classes = self._detect(
                cls_probs, box_deltas, props, valid, topk, score_thr,
                nms_iou)
            m_rois = multilevel_roi_align(out["pyramid"], boxes,
                                          MASK_ROI_SIZE, STRIDES)
            mask_logits = mdl.run_mask_head(m_rois)
            masks = torch.sigmoid(_at_class(mask_logits, classes).float())
            return {"boxes": boxes, "scores": scores, "classes": classes,
                    "masks": masks}

        return predict

    def final_eval(self, state, eval_iter_fn: Callable[[], Iterator]
                   ) -> Dict[str, float]:
        """COCO-style box and mask mAP over the eval set (the TensorPack
        Mask R-CNN workload's acceptance metric): the inference path per
        batch, each real image's detections streamed into
        ``metrics/coco_map.DetectionAccumulator``."""
        from ..metrics.coco_map import DetectionAccumulator

        ev = self.cfg.eval
        if not ev.enabled:
            return {}
        predict = self.predict_fn(ev.detect_topk, ev.detect_score_threshold,
                                  ev.detect_nms_iou)
        acc = DetectionAccumulator()
        s = self.image_size
        per_batch = []
        with state.eval_weights():
            for batch in eval_iter_fn():
                images = torch.from_numpy(batch["image"])
                if self.mesh.spatial_ways > 1:
                    images = spatial_slice(images, self.mesh,
                                           self.spatial_dim)
                images = images.to(self.device)
                det = {k: v.cpu().numpy()
                       for k, v in predict(images).items()}
                emask = batch.get("eval_mask")
                per_batch.append([
                    (det["boxes"][i], det["scores"][i], det["classes"][i],
                     batch["boxes"][i], batch["labels"][i],
                     det["masks"][i], batch["masks"][i])
                    for i in range(det["boxes"].shape[0])
                    if emask is None or emask[i] != 0])
        # Across processes every one scores the whole eval set, in the
        # global batch's order, each image once.
        for box, score, cls, gt_box, gt_label, mask, gt_mask in \
                gather_batches(per_batch, self.mesh):
            acc.add_image(box, score, cls, gt_box, gt_label,
                          pred_masks=mask, gt_masks=gt_mask, image_hw=(s, s))
        return acc.compute(with_masks=True)

    # -- loss -----------------------------------------------------------------

    def loss_fn(self, batch: Batch, train: bool,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        del generator  # no dropout in Mask R-CNN
        nmr = self.num_mask_rois
        images = batch["image"]
        gt_boxes = batch["boxes"].float()
        gt_labels = batch["labels"]
        gt_valid = (gt_labels > 0).float()
        # Padded eval-tail images weigh zero in every loss and metric;
        # matching stays per image, so they never touch real ones.
        ex = example_mask(batch, images.shape[0]) / self.mesh.replicas
        out = self.model(images, train=train)

        with torch.no_grad():
            cls_t, box_t = self._rpn_targets(gt_boxes, gt_valid)
        rpn_bce = _sigmoid_bce(out["rpn_logits"], torch.clamp(cls_t, min=0))
        pos_w = (cls_t == 1.0).float() * ex[:, None]
        neg_w = (cls_t == 0.0).float() * ex[:, None]
        rpn_cls_loss = _mean_where(rpn_bce, pos_w) + \
            _mean_where(rpn_bce, neg_w)
        rpn_box_loss = _mean_where(
            _huber(out["rpn_deltas"] - box_t).sum(-1), pos_w)

        with torch.no_grad():
            props, valid = self._proposals(out["rpn_logits"],
                                           out["rpn_deltas"], gt_boxes,
                                           gt_valid)
            roi_cls_t, roi_box_t, roi_pos, matched, max_iou = \
                self._roi_targets(props, valid, gt_boxes, gt_labels,
                                  gt_valid)

        # Box head on every proposal.
        rois = multilevel_roi_align(out["pyramid"], props, ROI_SIZE, STRIDES)
        cls_logits, box_deltas = self.model.run_box_head(rois)
        valid_f = valid.float() * ex[:, None]
        pos_f = roi_pos.float() * ex[:, None]
        roi_cls_loss = _mean_where(cross_entropy(cls_logits, roi_cls_t),
                                   valid_f)
        # Class-specific deltas at the target class.
        sel = torch.gather(box_deltas, 2, roi_cls_t[:, :, None, None].expand(
            -1, -1, 1, 4))[:, :, 0]
        roi_box_loss = _mean_where(_huber(sel - roi_box_t).sum(-1), pos_f)

        # Mask head on the top positives (a static top-k by match score).
        _, mask_sel = top_k(max_iou * pos_f, nmr)  # [B, nmr]
        m_props = take_rows(props, mask_sel)
        m_pos = torch.gather(pos_f, 1, mask_sel)
        m_cls = torch.gather(roi_cls_t, 1, mask_sel)
        m_matched = torch.gather(matched, 1, mask_sel)
        m_rois = multilevel_roi_align(out["pyramid"], m_props, MASK_ROI_SIZE,
                                      STRIDES)
        mask_logits = self.model.run_mask_head(m_rois)  # [B,nmr,28,28,K]
        with torch.no_grad():
            mask_t = self._resample_mask(take_rows(batch["masks"], m_matched),
                                         take_rows(gt_boxes, m_matched),
                                         m_props)
        mask_bce = _sigmoid_bce(_at_class(mask_logits, m_cls),
                                mask_t).mean((-1, -2))
        mask_loss = _mean_where(mask_bce, m_pos)

        with torch.no_grad():
            # Proposal recall @0.5 — the convergence signal.
            best = (iou_matrix(props, gt_boxes) * valid_f[:, :, None]).amax(1)
            recall = _mean_where((best >= 0.5).float(),
                                 gt_valid * ex[:, None])

        losses = {"rpn_cls_loss": rpn_cls_loss,
                  "rpn_box_loss": rpn_box_loss,
                  "roi_cls_loss": roi_cls_loss,
                  "roi_box_loss": roi_box_loss,
                  "mask_loss": mask_loss}
        total = sum(losses.values())
        metrics = {**losses, "proposal_recall": recall}
        if not train:
            metrics["eval_weight"] = ex.sum()
        return total, metrics
