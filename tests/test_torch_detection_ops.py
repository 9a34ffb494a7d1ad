"""The port's detection ops and jax-free detection modules against the JAX
package's, on the CPU: the same numpy inputs, made from a seed, through
both.

- The box math (``box_area``, ``iou_matrix``, ``encode_boxes``,
  ``decode_boxes`` with its clip) within 1e-5; ``generate_anchors`` bit for
  bit at the tiny config and at the preset's 1024² (261,888 anchors).
- ``top_k`` and ``nms_static`` (batched over leading dims, against
  ``jax.vmap`` of the JAX function): plain, with ``valid``, with ``-1e30``
  sentinels and with tied scores — indices and keep flags equal.
- ``_bilinear_sample``, ``roi_align``, ``multilevel_roi_align`` on a batch
  of random boxes that lands on every level (forward, and the gradient
  that reaches the features) and ``DetectionTask._resample_mask``: within
  1e-5 of the largest value.
- ``DetectionTask._detect`` (the JAX ``_detect_one`` over a batch) on the
  JAX test's hand-made head outputs and on random ones: equal classes,
  boxes and scores within 1e-6.
- ``convert_deconv_to_upsample`` equal to the JAX function.
- The copied modules: ``data/detection.py`` (synthetic sources, the npz
  path with uint8 images, and the ``coco`` pipeline's batches), ``data/
  coco.py:prepare_coco`` on a mini COCO the test writes, and
  ``metrics/coco_map.py`` on random detections — outputs equal.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_cfn_tpu.config import DataConfig as JDataConfig
from deeplearning_cfn_tpu.config import ExperimentConfig as JCfg
from deeplearning_cfn_tpu.config import ModelConfig as JModel
from deeplearning_cfn_tpu.data import coco as jcoco
from deeplearning_cfn_tpu.data import detection as jdet
from deeplearning_cfn_tpu.data import pipeline as jpipe
from deeplearning_cfn_tpu.metrics import coco_map as jmap
from deeplearning_cfn_tpu.models.maskrcnn import \
    convert_deconv_to_upsample as j_convert
from deeplearning_cfn_tpu.ops import detection as jops
from deeplearning_cfn_tpu.train.detection_task import DetectionTask as JTask
from deeplearning_cfn_tpu_torch.config import DataConfig, ExperimentConfig, \
    ModelConfig
from deeplearning_cfn_tpu_torch.data import coco as tcoco
from deeplearning_cfn_tpu_torch.data import detection as tdet
from deeplearning_cfn_tpu_torch.data import pipeline as tpipe
from deeplearning_cfn_tpu_torch.metrics import coco_map as tmap
from deeplearning_cfn_tpu_torch.models.maskrcnn import \
    convert_deconv_to_upsample as t_convert
from deeplearning_cfn_tpu_torch.ops import detection as tops
from deeplearning_cfn_tpu_torch.train.detection_task import DetectionTask

TOL = 1e-5  # of the largest value, for every f32 comparison here
KW = dict(image_size=64, pre_nms_topk=64, post_nms_topk=16, num_mask_rois=4,
          anchor_scale=4.0)



@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One worker's share of the cores. Under pytest-xdist every worker's
    torch would start a thread per core, and the oversubscribed machine
    runs this full-depth model ~5× slower (measured with the CPU busy)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, tol=TOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _boxes(rng, n, extent=64.0, lo=2.0, hi=30.0, lead=()):
    y0 = rng.uniform(-4, extent, lead + (n,))
    x0 = rng.uniform(-4, extent, lead + (n,))
    h = rng.uniform(lo, hi, lead + (n,))
    w = rng.uniform(lo, hi, lead + (n,))
    return np.stack([y0, x0, y0 + h, x0 + w], -1).astype(np.float32)


def _tasks():
    """(JAX task, port task) of the tiny config: cheap, no model init."""
    jcfg = JCfg(model=JModel(name="maskrcnn_resnet50", num_classes=7,
                             kwargs=dict(KW)),
                data=JDataConfig(name="coco", image_size=64, max_boxes=4))
    tcfg = ExperimentConfig(model=ModelConfig(name="maskrcnn_resnet50",
                                              num_classes=7,
                                              kwargs=dict(KW)),
                            data=DataConfig(name="coco", image_size=64,
                                            max_boxes=4))
    tcfg.train.dtype = jcfg.train.dtype = "float32"
    return JTask(jcfg), DetectionTask(tcfg, torch.device("cpu"))


# -- box math and anchors -------------------------------------------------------


def test_box_math_matches_jax():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 24), _boxes(rng, 17)
    a[3] = [5, 5, 5, 9]  # zero area
    _close(tops.box_area(_t(a)), jops.box_area(a))
    _close(tops.iou_matrix(_t(a), _t(b)), jops.iou_matrix(a, b))
    anchors = _boxes(rng, 24)
    deltas = tops.encode_boxes(_t(a), _t(anchors))
    _close(deltas, jops.encode_boxes(a, anchors))
    d = rng.normal(0, 2, (24, 4)).astype(np.float32)  # some past the clamp
    for clip in (None, (64, 48)):
        _close(tops.decode_boxes(_t(d), _t(anchors), clip),
               jops.decode_boxes(d, anchors, clip))
    # Leading dims broadcast: [2, N] against [M].
    batched = _boxes(rng, 5, lead=(2,))
    _close(tops.iou_matrix(_t(batched), _t(b)),
           jax.vmap(lambda x: jops.iou_matrix(x, b))(batched))


@pytest.mark.parametrize("size,scale", [(64, 4.0), (1024, 8.0), (100, 8.0)])
def test_anchors_match_jax_bit_for_bit(size, scale):
    strides = [4, 8, 16, 32, 64]
    got = tops.generate_anchors((size, size), strides,
                                [scale * s for s in strides]).numpy()
    want = np.asarray(jops.generate_anchors((size, size), strides,
                                            [scale * s for s in strides]))
    np.testing.assert_array_equal(got, want)
    if size == 1024:
        assert got.shape == (261_888, 4)


# -- top-k and NMS --------------------------------------------------------------


def test_top_k_breaks_ties_to_the_lowest_index():
    x = np.asarray([[0.5, 0.9, 0.5, 0.0, 0.9, 0.5, 0.0, 0.0]], np.float32)
    values, idx = tops.top_k(_t(x), 6)
    jv, ji = jax.lax.top_k(x, 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(values.numpy(), np.asarray(jv))
    assert idx.tolist() == [[1, 4, 0, 2, 5, 3]]


def _nms_case(kind, rng):
    """[2, 3, N] boxes and scores for ``kind`` (batched over 6 problems)."""
    n = 40
    boxes = _boxes(rng, n, extent=40, lo=6, hi=20, lead=(2, 3))
    scores = rng.uniform(0, 1, (2, 3, n)).astype(np.float32)
    valid = None
    if kind == "ties":
        scores = np.round(scores * 4) / 4  # 5 distinct values
        boxes[..., 7, :] = boxes[..., 3, :]  # exact duplicates
    elif kind == "valid":
        valid = rng.uniform(0, 1, (2, 3, n)) > 0.4
        valid[1, 2] = False  # an all-invalid problem
    elif kind == "sentinel":
        scores[..., n - 12:] = -1e30
        scores[0, 0, :] = -np.inf  # all padding
    return boxes, scores, valid


@pytest.mark.parametrize("kind", ["plain", "ties", "valid", "sentinel"])
@pytest.mark.parametrize("k", [16, 40])
def test_nms_static_matches_jax(kind, k):
    rng = np.random.RandomState(
        ["plain", "ties", "valid", "sentinel"].index(kind) * 100 + k)
    boxes, scores, valid = _nms_case(kind, rng)
    idx, keep = tops.nms_static(_t(boxes), _t(scores), 0.5, k,
                                None if valid is None else _t(valid))
    if valid is None:
        jfn = lambda b, s: jops.nms_static(b, s, 0.5, k)
        ji, jk = jax.vmap(jax.vmap(jfn))(boxes, scores)
    else:
        jfn = lambda b, s, v: jops.nms_static(b, s, 0.5, k, valid=v)
        ji, jk = jax.vmap(jax.vmap(jfn))(boxes, scores, valid)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))
    assert 0 < keep.sum() < keep.numel()  # both suppression and survivors


# -- ROI-align ------------------------------------------------------------------


def test_bilinear_sample_and_roi_align_match_jax():
    rng = np.random.RandomState(1)
    feat = jnp.asarray(rng.normal(0, 1, (9, 11, 5)).astype(np.float32))
    ys = rng.uniform(-2.5, 11, (6, 7)).astype(np.float32)  # some outside
    xs = rng.uniform(-2.5, 13, (6, 7)).astype(np.float32)
    tfeat = _t(np.asarray(feat))
    _close(tops._bilinear_sample(tfeat, _t(ys), _t(xs)),
           jops._bilinear_sample(feat, ys, xs))
    boxes = _boxes(rng, 8, extent=40, lo=1, hi=30)
    for scale in (1.0, 0.25):
        _close(tops.roi_align(tfeat, _t(boxes), 7, spatial_scale=scale),
               jops.roi_align(feat, boxes, 7, spatial_scale=scale))


STRIDES = {2: 4, 3: 8, 4: 16, 5: 32, 6: 64}


def test_multilevel_roi_align_matches_jax_forward_and_backward():
    """A batch of 2 over a 5-level pyramid of a 512² image, with boxes
    from 4 to 1100 pixels a side, so every level takes boxes (and some
    sample points fall off their map)."""
    rng = np.random.RandomState(2)
    b, n, c, out = 2, 48, 4, 7
    feats = {l: rng.normal(0, 1, (b, 512 // s, 512 // s, c)).astype(
        np.float32) for l, s in STRIDES.items()}
    y0 = rng.uniform(-20, 500, (b, n))
    x0 = rng.uniform(-20, 500, (b, n))
    side = np.exp(rng.uniform(np.log(4), np.log(1100), (b, n)))
    boxes = np.stack([y0, x0, y0 + side, x0 + side * rng.uniform(
        0.5, 2, (b, n))], -1).astype(np.float32)
    area = np.sqrt(jops.box_area(boxes))
    levels = np.clip(np.floor(4 + np.log2(area / 224 + 1e-8)), 2, 6)
    assert set(levels.ravel().tolist()) == {2, 3, 4, 5, 6}
    ct = rng.normal(0, 1, (b, n, out, out, c)).astype(np.float32)

    def jfn(fs):
        return jax.vmap(lambda f, bx: jops.multilevel_roi_align(
            f, bx, out, STRIDES))(fs, boxes)

    want, vjp = jax.jit(lambda fs: jax.vjp(jfn, fs))(feats)
    (jgrads,) = vjp(jnp.asarray(ct))
    # The port takes [B, C, H, W] (channels_last, as the model makes them).
    tfeats = {l: _t(f).permute(0, 3, 1, 2).requires_grad_()
              for l, f in feats.items()}
    got = tops.multilevel_roi_align(tfeats, _t(boxes), out, STRIDES)
    _close(got, want)
    got.backward(_t(ct))
    for l in feats:
        _close(tfeats[l].grad.permute(0, 2, 3, 1), jgrads[l])
        assert float(tfeats[l].grad.abs().sum()) > 0, l


def test_resample_mask_matches_jax():
    rng = np.random.RandomState(3)
    masks = (rng.uniform(0, 1, (2, 5, 28, 28)) > 0.5).astype(np.float32)
    gt = _boxes(rng, 5, lo=4, hi=40, lead=(2,))
    props = gt + rng.normal(0, 4, gt.shape).astype(np.float32)
    want = jax.vmap(jax.vmap(JTask._resample_mask))(masks, gt, props)
    _close(DetectionTask._resample_mask(_t(masks), _t(gt), _t(props)), want)


# -- inference post-processing --------------------------------------------------


def test_detect_matches_jax_detect_one():
    jtask, task = _tasks()
    # The JAX test's hand-made case: a duplicate suppressed within a class,
    # the same box in another class kept, one under the score floor and
    # one invalid proposal dropped.
    props = np.array([[0, 0, 10, 10], [0, 1, 10, 11], [30, 30, 40, 40],
                      [0, 0, 10, 10], [50, 50, 60, 60], [70, 70, 80, 80]],
                     np.float32)
    valid = np.array([True] * 5 + [False])
    probs = np.full((6, 3), 0.01, np.float32)
    probs[0, 1], probs[1, 1], probs[2, 2], probs[3, 2] = 0.9, 0.8, 0.7, 0.6
    probs[4, 1], probs[5, 1] = 0.04, 0.9
    rng = np.random.RandomState(4)
    cases = [(props, valid, probs, np.zeros((6, 3, 4), np.float32), 4)]
    p, c = 20, 7
    rprops = _boxes(rng, p, lo=4, hi=30)
    logits = rng.normal(0, 2, (p, c)).astype(np.float32)
    rprobs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    cases.append((rprops, rng.uniform(0, 1, p) > 0.2, rprobs,
                  rng.normal(0, 0.5, (p, c, 4)).astype(np.float32), 8))
    kept = []
    detect_one = jax.jit(jtask._detect_one, static_argnums=(4, 5, 6))
    for props, valid, probs, deltas, topk in cases:
        jb, js, jc = detect_one(probs, deltas, props, valid, topk, 0.05, 0.5)
        tb, ts, tc = task._detect(*(_t(x)[None] for x in (probs, deltas,
                                                          props, valid)),
                                  topk, 0.05, 0.5)
        np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc))
        _close(ts[0], js, 1e-6)
        _close(tb[0], jb, 1e-6)
        kept.append([(int(k), round(float(v), 3))
                     for k, v in zip(tc[0], ts[0]) if k > 0])
    assert kept[0] == [(1, 0.9), (2, 0.7), (2, 0.6)]


def test_deconv_to_upsample_conversion_matches_jax():
    w = np.random.RandomState(5).normal(0, 1, (2, 2, 5, 7)).astype(
        np.float32)
    np.testing.assert_array_equal(t_convert(w), np.asarray(j_convert(w)))
    with pytest.raises(ValueError):
        t_convert(np.zeros((3, 3, 5, 7), np.float32))


# -- the copied modules ---------------------------------------------------------


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_detection_sources_match_jax(tmp_path):
    _same(tdet.make_detection_source(6, 64, 7, 4, seed=0).arrays,
          jdet.make_detection_source(6, 64, 7, 4, seed=0).arrays)
    cfg, jcfg = (DataConfig(name="coco", image_size=32, num_train_examples=9,
                            num_eval_examples=5),
                 JDataConfig(name="coco", image_size=32,
                             num_train_examples=9, num_eval_examples=5))
    for train in (True, False):  # seeds 47 and 53
        _same(tdet.build_detection_source(cfg, train, 7, 3).arrays,
              jdet.build_detection_source(jcfg, train, 7, 3).arrays)
    # The real-data path: <data_dir>/{train,eval}.npz, uint8 images.
    arrays = jdet.make_detection_source(4, 16, 5, 2, seed=1).arrays
    arrays["image"] = (arrays["image"].clip(0, 1) * 255).astype(np.uint8)
    np.savez(tmp_path / "train.npz", **arrays)
    cfg.data_dir = jcfg.data_dir = str(tmp_path)
    got = tdet.build_detection_source(cfg, True).arrays
    _same(got, jdet.build_detection_source(jcfg, True).arrays)
    assert got["image"].dtype == np.float32
    with pytest.raises(FileNotFoundError, match="eval.npz"):
        tdet.build_detection_source(cfg, False)


@pytest.mark.parametrize("train", [True, False])
def test_coco_pipeline_batches_match_jax(train):
    over = dict(name="coco", image_size=32, num_train_examples=10,
                num_eval_examples=6, max_boxes=3, prefetch=0)
    tp = tpipe.build_pipeline(DataConfig(**over), 4, 7, seed=3, train=train,
                              drop_remainder=train)
    jp = jpipe.build_pipeline(JDataConfig(**over), 4, 7, seed=3, train=train,
                              drop_remainder=train)
    got, want = list(tp.one_epoch()), list(jp.one_epoch())
    assert len(got) == len(want) == (2 if train else 2)
    for g, w in zip(got, want):
        _same(g, w)
    if not train:
        assert got[-1]["eval_mask"].tolist() == [1, 1, 0, 0]


def _mini_coco(tmp_path):
    """Two images with polygons, a crowd, an RLE non-crowd and a degenerate
    box, and one image with no annotations."""
    from PIL import Image

    rng = np.random.RandomState(6)
    (tmp_path / "imgs").mkdir()
    sizes = {"a.png": (90, 70), "b.png": (50, 60), "c.png": (30, 80)}
    for name, (w, h) in sizes.items():
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            tmp_path / "imgs" / name)
    anns = [
        {"id": 1, "image_id": 1, "category_id": 5, "bbox": [10, 8, 30, 25],
         "area": 600.0, "iscrowd": 0,
         "segmentation": [[10, 8, 40, 8, 25, 33]]},
        {"id": 2, "image_id": 1, "category_id": 9, "bbox": [0, 0, 20, 20],
         "area": 400.0, "iscrowd": 1, "segmentation": {"counts": "x"}},
        {"id": 3, "image_id": 2, "category_id": 2, "bbox": [5, 5, 30, 40],
         "area": 1000.0, "iscrowd": 0, "segmentation": {"counts": "y"}},
        {"id": 4, "image_id": 2, "category_id": 3, "bbox": [1, 1, 0.5, 9],
         "area": 4.0, "iscrowd": 0, "segmentation": []},
        {"id": 5, "image_id": 2, "category_id": 4, "bbox": [20, 30, 25, 20],
         "area": 300.0, "iscrowd": 0,
         "segmentation": [[20, 30, 45, 30, 45, 50, 20, 50]]},
    ]
    images = [{"id": i + 1, "file_name": n, "width": w, "height": h}
              for i, (n, (w, h)) in enumerate(sizes.items())]
    path = tmp_path / "instances.json"
    path.write_text(json.dumps({"images": images, "annotations": anns}))
    return str(path), str(tmp_path / "imgs")


def test_prepare_coco_matches_jax(tmp_path):
    ann, imgs = _mini_coco(tmp_path)
    kw = dict(image_size=48, max_boxes=2)
    info = tcoco.prepare_coco(ann, imgs, str(tmp_path / "t"), "train", **kw)
    assert info == jcoco.prepare_coco(ann, imgs, str(tmp_path / "j"),
                                      "train", **kw)
    assert info["skipped_crowd"] == 1 and info["skipped_degenerate"] == 1
    with np.load(tmp_path / "t" / "train.npz") as t, \
            np.load(tmp_path / "j" / "train.npz") as j:
        _same(dict(t), dict(j))


def test_coco_map_matches_jax():
    rng = np.random.RandomState(7)
    t_acc, j_acc = tmap.DetectionAccumulator(), jmap.DetectionAccumulator()
    for _ in range(3):
        gt = _boxes(rng, 4, lo=6, hi=30)
        gt_labels = np.array([1, 2, 2, 0])
        pred = np.concatenate([gt + rng.normal(0, 2, gt.shape),
                               _boxes(rng, 4, lo=6, hi=30)]).astype(
                                   np.float32)
        scores = rng.uniform(0, 1, 8).astype(np.float32)
        classes = rng.randint(0, 3, 8)
        pm = rng.uniform(0, 1, (8, 28, 28)).astype(np.float32)
        gm = (rng.uniform(0, 1, (4, 28, 28)) > 0.3).astype(np.float32)
        for acc in (t_acc, j_acc):
            acc.add_image(pred, scores, classes, gt, gt_labels,
                          pred_masks=pm, gt_masks=gm, image_hw=(64, 64))
    got, want = t_acc.compute(with_masks=True), j_acc.compute(
        with_masks=True)
    assert got == want and 0 < got["map50"] <= 1
