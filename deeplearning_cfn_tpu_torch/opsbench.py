"""Op-level microbenchmarks: where does a train step's time actually go?

The port of the JAX package's ``opsbench.py``. The preset benches
(``bench.py``) time whole train steps; this module times the *pieces* —
backbone fwd+bwd, RPN top-k, static NMS, ROI-align, mask head — at the
exact shapes the maskrcnn preset uses, plus A/B variants (classic vs
space-to-depth ResNet stem), on the device ``--accelerator`` names.

Run: ``python -m deeplearning_cfn_tpu_torch.opsbench [--suite
detection|resnet|all] [--accelerator gpu|cpu]``. Prints one JSON line per
timing (CPU numbers are for relative sanity only; the point is the card).

Timing contract: every timed function returns a scalar; the loop chains a
data-dependent token through successive calls (each call's input depends
on the last call's result) and syncs with ONE trailing host read.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict

import torch


def timed_scalar(fn: Callable, *args, steps: int = 10, warmup: int = 2
                 ) -> float:
    """Mean ms/call of ``fn(*args, token)`` where fn returns an f32 scalar
    tensor. The token (0.0) is derived from the previous call's result,
    making every call data-dependent on the last; one host read at the
    end waits for all of them."""
    tok = torch.zeros((), dtype=torch.float32)
    for _ in range(max(warmup, 1)):
        out = fn(*args, tok)
    float(out)  # sync: warmup finished, queue empty
    t0 = time.perf_counter()
    for _ in range(steps):
        out = fn(*args, (out * 0).float())
    float(out)
    return (time.perf_counter() - t0) / steps * 1000.0


def _scalarize(tensors) -> torch.Tensor:
    """Reduce tensors (a tensor, a list or a dict of them) to one f32
    scalar (keeps them all live)."""
    if isinstance(tensors, torch.Tensor):
        tensors = [tensors]
    elif isinstance(tensors, dict):
        tensors = list(tensors.values())
    return sum(t.float().sum() for t in tensors)


def _emit(name: str, ms: float, **extra) -> None:
    print(json.dumps({"op": name, "ms": round(ms, 2), **extra}), flush=True)


def _fwd_bwd(loss_fn, params) -> Callable[[], torch.Tensor]:
    """``loss + Σ grads`` of ``loss_fn()`` over ``params``: the forward,
    the backward and a read of every gradient."""
    def run():
        loss = loss_fn()
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach() + _scalarize([g for g in grads
                                           if g is not None])
    return run


def suite_resnet(batch: int = 512, steps: int = 10, image_size: int = 224,
                 device="gpu") -> Dict[str, float]:
    """Classic 7×7 stem vs space-to-depth stem, full fwd+bwd, bf16.
    Defaults to the imagenet_resnet50 bench shape (224²); ``image_size``
    shrinks it for CPU smoke runs — stem-comparison numbers are only
    meaningful at 224."""
    import torch.nn.functional as F

    from .models import build_model
    from .models.resnet import init_weights
    from .runtime.platform import resolve_device

    dev = resolve_device(device)
    if image_size % 2:
        raise ValueError(
            f"image_size must be even (s2d folds 2x2 blocks), got "
            f"{image_size}")
    results = {}
    x = torch.zeros((batch, image_size, image_size, 3), dtype=torch.bfloat16,
                    device=dev)
    y = torch.zeros((batch,), dtype=torch.long, device=dev)
    for name in ("resnet50", "resnet50_s2d"):
        model = build_model(name, num_classes=1000, dtype=torch.bfloat16,
                            device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        init_weights(model, gen)
        params = [p for p in model.parameters() if p.requires_grad]

        def step(x, y, tok, model=model, params=params):
            return _fwd_bwd(lambda: F.cross_entropy(
                model(x + tok, train=True).float(), y), params)()

        ms = timed_scalar(step, x, y, steps=steps)
        results[name] = ms
        _emit(f"{name}_fwd_bwd", ms, batch=batch,
              img_per_s=round(batch / ms * 1000, 1))
        del model, params
    return results


def suite_detection(batch: int = 4, steps: int = 5, image_size: int = 0,
                    device="gpu") -> Dict[str, float]:
    """Time the maskrcnn_coco train step's pieces at preset shapes."""
    from .models.maskrcnn import MASK_ROI_SIZE, ROI_SIZE
    from .ops.detection import multilevel_roi_align, nms_static, top_k
    from .presets import get_preset
    from .runtime.platform import resolve_device
    from .train.detection_task import STRIDES
    from .train.task import build_task

    dev = resolve_device(device)
    cfg = get_preset("maskrcnn_coco")
    cfg.train.global_batch = batch
    if image_size:  # shrink for CPU smoke runs
        cfg.model.kwargs["image_size"] = image_size
        cfg.data.image_size = image_size
    task = build_task(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    task.init(gen)
    model = task.model
    params = [p for p in model.parameters() if p.requires_grad]
    B, S = batch, task.image_size
    results = {}

    max_boxes = cfg.data.max_boxes
    batch_data = {
        "image": torch.zeros((B, S, S, 3), device=dev),
        "boxes": torch.tensor([[10.0, 10.0, 200.0, 200.0]],
                              device=dev).repeat(B, max_boxes, 1),
        "labels": torch.ones((B, max_boxes), dtype=torch.long, device=dev),
        "masks": torch.ones((B, max_boxes, 28, 28), device=dev),
    }

    def run(name, fn, *args, n=steps, **extra):
        ms = timed_scalar(fn, *args, steps=n)
        results[name] = ms
        _emit(name, ms, **extra)

    # 1. Backbone + FPN + RPN heads, fwd+bwd (the conv compute).
    def bb(images, tok):
        def lf():
            out = model(images + tok, train=True)
            return (_scalarize(out["pyramid"]) + _scalarize(out["rpn_logits"])
                    + _scalarize(out["rpn_deltas"]))
        return _fwd_bwd(lf, params)()

    run("backbone_rpn_fwd_bwd", bb, batch_data["image"], batch=B)

    # Fixed RPN-shaped inputs for the post-backbone pieces.
    A = task.anchors.shape[0]
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    rl = torch.randn((B, A), generator=g, device=dev)
    rd = 0.1 * torch.randn((B, A, 4), generator=g, device=dev)

    # 2. Proposal path: decode + top-k(pre_nms) + NMS. Forward-only (no
    # gradient flows through it in the loss).
    def props(rl, rd, tok):
        with torch.no_grad():
            p, v, _ = task._proposals_infer(rl + tok, rd)
            return _scalarize(p) + _scalarize(v)

    run("proposals_decode_topk_nms", props, rl, rd,
        anchors=int(A), pre_nms=task.pre_nms_topk,
        post_nms=task.post_nms_topk)

    # 3. top_k alone over the anchor scores (the sort-ish candidate).
    def topk_only(rl, tok):
        s, i = top_k(rl + tok, task.pre_nms_topk)
        return _scalarize(s) + _scalarize(i)

    run("rpn_top_k", topk_only, rl, anchors=int(A), k=task.pre_nms_topk)

    # 4. NMS alone at post-NMS width.
    kb = torch.rand((B, task.pre_nms_topk, 4), generator=g, device=dev)
    ks = torch.rand((B, task.pre_nms_topk), generator=g, device=dev)

    def nms_only(kb, ks, tok):
        idx, keep = nms_static(kb, ks + tok, task.nms_iou,
                               task.post_nms_topk)
        return _scalarize(idx) + _scalarize(keep)

    run("nms_static", nms_only, kb, ks, k=task.post_nms_topk)

    # 5. ROI-align fwd+bwd at box-head and mask-head shapes. P = post-NMS
    # proposals + appended GT (the train-path width).
    P = task.post_nms_topk + max_boxes
    pyramid = {
        lvl: torch.zeros((B, 256, max(1, S // st), max(1, S // st)),
                         dtype=torch.bfloat16, device=dev).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        for lvl, st in STRIDES.items()
    }
    boxes = torch.tensor([[8.0, 8.0, 264.0, 264.0]],
                         device=dev).repeat(B, P, 1)

    def roi(pyr, boxes, tok, out_size=ROI_SIZE):
        return _fwd_bwd(lambda: _scalarize(multilevel_roi_align(
            pyr, boxes, out_size=out_size, strides=STRIDES)) + tok,
            list(pyr.values()))()

    run("roi_align_box_fwd_bwd", roi, pyramid, boxes,
        P=int(P), out=ROI_SIZE)

    m_boxes = boxes[:, :task.num_mask_rois]
    run("roi_align_mask_fwd_bwd",
        lambda pyr, b, tok: roi(pyr, b, tok, MASK_ROI_SIZE), pyramid,
        m_boxes, P=int(task.num_mask_rois), out=MASK_ROI_SIZE)

    # 6. Box + mask heads fwd+bwd at ROI shapes.
    rois = torch.zeros((B, P, ROI_SIZE, ROI_SIZE, 256), dtype=torch.bfloat16,
                       device=dev)
    m_rois = torch.zeros((B, task.num_mask_rois, MASK_ROI_SIZE,
                          MASK_ROI_SIZE, 256), dtype=torch.bfloat16,
                         device=dev)
    head_params = [p for m in (model.box_head, model.mask_head)
                   for p in m.parameters()]

    def heads(rois, m_rois, tok):
        def lf():
            cls_logits, box_deltas = model.run_box_head(rois + tok)
            mask_logits = model.run_mask_head(m_rois)
            return (_scalarize(cls_logits) + _scalarize(box_deltas)
                    + _scalarize(mask_logits))
        return _fwd_bwd(lf, head_params)()

    run("box_and_mask_heads_fwd_bwd", heads, rois, m_rois)

    # 7. Full loss fwd+bwd — the whole step minus the optimizer.
    def full(batch_data, tok):
        def lf():
            loss, _ = task.loss_fn(batch_data, True)
            return loss + tok
        return _fwd_bwd(lf, params)()

    run("full_loss_fwd_bwd", full, batch_data, batch=B)

    accounted = sum(v for k, v in results.items()
                    if k not in ("full_loss_fwd_bwd", "rpn_top_k"))
    _emit("sum_of_pieces", accounted, full=results.get("full_loss_fwd_bwd"))
    return results


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--suite", default="detection",
                        choices=["detection", "resnet", "all"])
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--batch", type=int, default=0)
    parser.add_argument("--image-size", type=int, default=0,
                        help="override the input image size for BOTH suites "
                             "(CPU smoke; card numbers should use the "
                             "defaults: resnet 224, detection 1024)")
    parser.add_argument("--accelerator", default="gpu",
                        choices=["gpu", "cpu"],
                        help="the device (gpu: the CUDA card, raising "
                             "without one)")
    args = parser.parse_args(argv)
    if args.suite in ("resnet", "all"):
        suite_resnet(batch=args.batch or 512, steps=args.steps,
                     image_size=args.image_size or 224,
                     device=args.accelerator)
    if args.suite in ("detection", "all"):
        suite_detection(batch=args.batch or 4, steps=args.steps,
                        image_size=args.image_size,
                        device=args.accelerator)


if __name__ == "__main__":
    main()
