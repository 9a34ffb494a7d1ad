"""The port's Mask R-CNN training run on the CPU: ``run_experiment``, the
``train`` CLI, and checkpoints.

- (f) ``run_experiment`` on the tiny config of ``tests/test_detection.py``
  (64² images, 7 classes, the full ResNet-50-FPN, momentum with weight
  decay and the clip) for 5 steps: every loss and ``proposal_recall``
  finite in every record, the total falling from the first two steps to
  the last two, and ``final_eval_map``, ``final_eval_map50`` and
  ``final_eval_mask_map`` in ``metrics.jsonl``, in [0, 1].
- The same run killed after step 2 (its step-2 checkpoint committed) and
  resumed to step 5 repeats the uninterrupted run bit for bit: every loss,
  and every leaf of the final checkpoint, ``batch_stats`` and the momentum
  trace included.
- ``TrainState.named_leaves`` of the tiny Mask R-CNN under ``momentum``
  names every leaf of the JAX ``TrainState`` of the same config, with the
  same shapes (the JAX state's shapes from ``jax.eval_shape``, no
  compile).
- ``cli train --preset maskrcnn_coco`` runs on the CPU when asked, and
  without a card and without ``--accelerator cpu`` it refuses (exit 1);
  ``cli data prepare-coco`` raises, naming ROADMAP A.13.
"""

import os

import jax
import numpy as np
import pytest
import torch

from deeplearning_cfn_tpu.config import MeshConfig
from deeplearning_cfn_tpu.config import apply_overrides as j_overrides
from deeplearning_cfn_tpu.parallel import build_mesh
from deeplearning_cfn_tpu.presets import get_preset as j_preset
from deeplearning_cfn_tpu.train import create_train_state as j_create_state
from deeplearning_cfn_tpu.train import optim as joptim
from deeplearning_cfn_tpu.train.detection_task import DetectionTask as JTask
from deeplearning_cfn_tpu.utils.trees import flatten_with_names
from deeplearning_cfn_tpu_torch.ckpt import read_leaves
from deeplearning_cfn_tpu_torch.config import apply_overrides
from deeplearning_cfn_tpu_torch.metrics import read_metrics
from deeplearning_cfn_tpu_torch.presets import get_preset
from deeplearning_cfn_tpu_torch.train import optim as toptim
from deeplearning_cfn_tpu_torch.train.run import run_experiment
from deeplearning_cfn_tpu_torch.train.state import create_train_state
from deeplearning_cfn_tpu_torch.train.task import build_task

# The maskrcnn_coco preset (momentum 0.9, weight decay 1e-4, clip 10) cut
# to tests/test_detection.py's tiny config.
TINY = ["model.num_classes=7", "model.kwargs.image_size=64",
        "model.kwargs.pre_nms_topk=64", "model.kwargs.post_nms_topk=16",
        "model.kwargs.num_mask_rois=4", "model.kwargs.anchor_scale=4.0",
        "data.image_size=64", "data.max_boxes=4",
        "data.num_train_examples=32", "data.num_eval_examples=4",
        "data.prefetch=0", "train.global_batch=4", "train.eval_batch=4",
        "train.dtype=float32", "train.seed=0", "schedule.name=constant",
        "schedule.base_lr=0.01", "schedule.warmup_steps=2",
        "eval.detect_topk=8"]
STEPS = 5
RUN = TINY + [f"train.steps={STEPS}", "train.log_every_steps=1",
              "train.eval_every_steps=1000000",
              "checkpoint.async_write=false"]
LOSSES = ("rpn_cls_loss", "rpn_box_loss", "roi_cls_loss", "roi_box_loss",
          "mask_loss", "proposal_recall")



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


class _Killed(Exception):
    pass


def _run(workdir, kill_after=None, extra=()):
    cfg = apply_overrides(get_preset("maskrcnn_coco"),
                          RUN + [f"workdir={workdir}", *extra])
    losses = {}

    def hook(step, state, record):
        losses[step] = record["loss"]
        if step == kill_after:
            raise _Killed()

    try:
        final = run_experiment(cfg, device="cpu", hooks=(hook,))
    except _Killed:
        final = None
    return losses, final


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("straight")
    losses, final = _run(workdir, extra=["checkpoint.every_steps=1000"])
    return workdir, losses, final


def test_run_experiment_trains_and_scores_map(straight):
    workdir, losses, final = straight
    records = [r for r in read_metrics(os.path.join(
        workdir, "maskrcnn_coco", "metrics.jsonl")) if "grad_norm" in r]
    assert [r["step"] for r in records] == list(range(1, STEPS + 1))
    for r in records:
        for key in LOSSES + ("loss", "grad_norm"):
            assert np.isfinite(r[key]), (key, r)
    first = np.mean([losses[1], losses[2]])
    last = np.mean([losses[STEPS - 1], losses[STEPS]])
    assert last < first, losses
    logged = [r for r in read_metrics(os.path.join(
        workdir, "maskrcnn_coco", "metrics.jsonl")) if "final_eval_map" in r]
    assert logged, "no final eval record"
    for key in ("map", "map50", "mask_map"):
        assert 0.0 <= logged[-1][f"final_eval_{key}"] <= 1.0
        assert final[key] == logged[-1][f"final_eval_{key}"]


def test_resume_equals_the_uninterrupted_run(straight, tmp_path):
    workdir, losses, _ = straight
    head, _ = _run(tmp_path, kill_after=2,
                   extra=["checkpoint.every_steps=2"])
    assert sorted(head) == [1, 2]
    tail, _ = _run(tmp_path, extra=["checkpoint.every_steps=1000"])
    assert sorted(tail) == list(range(3, STEPS + 1))
    assert {**head, **tail} == losses  # bit for bit
    a = read_leaves(str(workdir / "maskrcnn_coco" / "ckpt"), STEPS)
    b = read_leaves(str(tmp_path / "maskrcnn_coco" / "ckpt"), STEPS)
    assert a.keys() == b.keys()
    assert any(k.startswith("batch_stats/") for k in a)
    assert any(k.startswith("opt_state/") and "/trace/" in k for k in a)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_named_leaves_match_the_jax_train_state():
    jcfg = j_overrides(j_preset("maskrcnn_coco"), TINY)
    jtask = JTask(jcfg)
    tx = joptim.build_optimizer(jcfg.optimizer, joptim.build_schedule(
        jcfg.schedule, 10, jcfg.train.global_batch))
    mesh = build_mesh(MeshConfig(data=1, model=1), devices=jax.devices()[:1])
    shapes = jax.eval_shape(
        lambda rng: j_create_state(rng, jtask.init, tx, mesh),
        jax.random.PRNGKey(0))
    want = {n: tuple(v.shape) for n, v in flatten_with_names(shapes)[0]}

    cfg = apply_overrides(get_preset("maskrcnn_coco"), TINY)
    task = build_task(cfg, torch.device("cpu"))
    opt = toptim.build_optimizer(cfg.optimizer, toptim.build_schedule(
        cfg.schedule, 10, cfg.train.global_batch), task.model)
    got = {n: tuple(np.shape(v))
           for n, v in create_train_state(task.model, opt).named_leaves()}
    assert got == want
    # The momentum trace sits after the clip and the weight decay.
    assert "opt_state/2/0/trace/box_head/fc1/kernel" in got


def test_cli_trains_maskrcnn_on_cpu_and_refuses_without_a_card(
        tmp_path, capsys, monkeypatch):
    from deeplearning_cfn_tpu_torch.cli.main import main

    over = [f"workdir={tmp_path}", "data.num_train_examples=8",
            "data.num_eval_examples=2", "train.global_batch=2",
            "train.eval_batch=2"]
    argv = ["train", "--preset", "maskrcnn_coco", "--max-steps", "2",
            *TINY, *over]
    assert main(argv[:3] + ["--accelerator", "cpu"] + argv[3:]) == 0
    out = capsys.readouterr().out
    assert "final metrics:" in out and "'mask_map'" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(argv) == 1
    assert "CUDA card" in capsys.readouterr().err


def test_the_data_verbs_name_their_roadmap_item():
    from deeplearning_cfn_tpu_torch.cli.main import main

    with pytest.raises(NotImplementedError, match="ROADMAP A.13"):
        main(["data", "prepare-coco", "--annotations", "x.json"])
