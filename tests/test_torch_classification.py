"""The port's classification training (LARS, ClassificationTask, the trainer
with BatchNorm statistics) against the JAX package's, on the CPU.

- ``Lars`` against ``optax.lars`` (through each package's
  ``build_optimizer``) over 6 updates under a warmup-then-cosine learning
  rate, with and without Nesterov, among them a zero-norm 2-D parameter and
  1-D parameters (no weight decay, no trust ratio): parameters within 1e-6;
- a 5-step trajectory of the ``imagenet_resnet50`` recipe (LARS + cosine
  with warmup, label smoothing 0.1) on a tiny f32 ResNet (``resnet18`` at 8
  filters, 32×32 synthetic ImageNet) from one Flax init bridged with
  ``params_from_flax``: the port's ``ClassificationTask`` + ``Trainer``
  against the JAX ``ClassificationTask`` + ``Trainer`` on a one-device
  mesh, at ``grad_accum_steps`` 1 and 2 (the running statistics thread
  through the microbatches in order). Losses within 1e-4 relative, final
  running statistics within 1e-5, and the full-set eval's top-1 and top-5
  equal;
- top-5 by the rank comparison, the eval mask, the ViT refusal, and the
  ``train`` CLI on ``cifar10_resnet20`` on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning_cfn_tpu.config import MeshConfig
from deeplearning_cfn_tpu.config import OptimizerConfig as JOpt
from deeplearning_cfn_tpu.config import ScheduleConfig as JSched
from deeplearning_cfn_tpu.config import apply_overrides as j_overrides
from deeplearning_cfn_tpu.parallel import build_mesh
from deeplearning_cfn_tpu.presets import get_preset as j_preset
from deeplearning_cfn_tpu.train import create_train_state
from deeplearning_cfn_tpu.train import optim as joptim
from deeplearning_cfn_tpu.train.task import ClassificationTask as JaxTask
from deeplearning_cfn_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning_cfn_tpu.utils.trees import flatten_with_names
from deeplearning_cfn_tpu_torch.config import (OptimizerConfig,
                                               ScheduleConfig, apply_overrides)
from deeplearning_cfn_tpu_torch.convert import params_from_flax
from deeplearning_cfn_tpu_torch.data.pipeline import build_pipeline, to_device
from deeplearning_cfn_tpu_torch.presets import get_preset
from deeplearning_cfn_tpu_torch.train import optim as toptim
from deeplearning_cfn_tpu_torch.train.state import create_train_state \
    as t_create_state
from deeplearning_cfn_tpu_torch.train.task import (ClassificationTask,
                                                   build_task)
from deeplearning_cfn_tpu_torch.train.trainer import Trainer

# -- LARS ----------------------------------------------------------------------

LARS_SCHED = dict(name="cosine", base_lr=0.8, warmup_steps=3,
                  end_lr_factor=0.1)


@pytest.mark.parametrize("nesterov", [False, True])
def test_lars_matches_optax(nesterov):
    spec = dict(name="lars", momentum=0.9, weight_decay=1e-2,
                trust_coefficient=0.05, nesterov=nesterov)
    rng = np.random.RandomState(0)
    params = {"w": rng.normal(0, 1, (5, 3)).astype(np.float32),
              "conv": rng.normal(0, 1, (2, 3, 3, 4)).astype(np.float32),
              "zero": np.zeros((4, 2), np.float32),  # a zero-init head
              "b": rng.normal(0, 1, (3,)).astype(np.float32),
              "scale": np.zeros((4,), np.float32)}  # a zero BN scale
    grads = [{k: rng.normal(0, 1, v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(6)]
    j_sched = joptim.build_schedule(JSched(**LARS_SCHED), 6, 64)
    t_sched = toptim.build_schedule(ScheduleConfig(**LARS_SCHED), 6, 64)
    tx = joptim.build_optimizer(JOpt(**spec), j_sched)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = toptim.Optimizer(OptimizerConfig(**spec), t_sched,
                           list(tp.values()))
    assert isinstance(opt.inner, toptim.Lars)
    lrs = set()
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        lrs.add(round(t_sched(opt.count), 9))
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{k} {opt.count}")
    assert len(lrs) == 6  # the lr changed at every update
    # The 2-D zero parameter moved (trust ratio 1 at step 0, then ‖p‖ > 0);
    # 1-D parameters took neither decay nor trust ratio.
    assert tp["zero"].abs().sum() > 0


def test_lars_applies_the_lr_before_the_momentum():
    """With a changing lr, lr-before-momentum (optax) and lr-after-momentum
    (torch-style LARS) part after the second update."""
    p = torch.nn.Parameter(torch.ones(2, 2))
    sched = lambda step: [1.0, 0.1][step]
    opt = toptim.Optimizer(OptimizerConfig(name="lars", momentum=0.9,
                                           weight_decay=0.0,
                                           trust_coefficient=1.0), sched, [p])
    for _ in range(2):
        p.grad = torch.ones(2, 2)
        opt.step()
    # Trust ratio ‖p‖/‖g‖ = 1 at step 0 (p = g = 1), so u0 = −1 and
    # p = 0; at step 1 ‖p‖ = 0 → ratio 1, u1 = −0.1, trace = −0.1 − 0.9.
    np.testing.assert_allclose(p.detach().numpy(), np.full((2, 2), -1.0),
                               rtol=1e-6)
    # torch-style would give 0 − 0.1·(1 + 0.9·1) = −0.19.


# -- the task -----------------------------------------------------------------

TINY = ["model.name=resnet18", "model.num_classes=10",
        "model.kwargs.num_filters=8", "data.image_size=32",
        "train.dtype=float32", "data.num_train_examples=80",
        "data.num_eval_examples=24", "train.eval_batch=16",
        "train.global_batch=16", "data.prefetch=0", "train.seed=0",
        "schedule.scale_with_batch=false", "schedule.base_lr=1.0",
        "schedule.warmup_steps=2", "schedule.warmup_epochs=0"]


def test_top5_rank_comparison_and_eval_mask():
    cfg = apply_overrides(get_preset("imagenet_resnet50"), TINY)
    task = ClassificationTask(cfg, torch.device("cpu"))
    logits = torch.tensor([[9., 8., 7., 6., 5., 4.],
                           [9., 8., 7., 6., 5., 4.],
                           [0., 1., 2., 3., 4., 5.]])
    task.model = lambda images, train: logits
    batch = {"image": torch.zeros(3, 1), "label": torch.tensor([4, 5, 0]),
             "eval_mask": torch.tensor([1., 1., 0.])}
    loss, aux = task.loss_fn(batch, False)
    # Label 4 has rank 4 (top-5), label 5 rank 5 (not); row 3 is padding.
    assert aux["accuracy_top5"].item() == 0.5
    assert aux["accuracy"].item() == 0.0
    assert aux["eval_weight"].item() == 2.0
    assert torch.isfinite(loss)


def test_vit_names_its_roadmap_item():
    cfg = apply_overrides(get_preset("imagenet_vit_s16"), [])
    with pytest.raises(NotImplementedError, match="ROADMAP A.9"):
        build_task(cfg, torch.device("cpu"))


def _jax_trajectory(jcfg, batches, eval_batches):
    mesh = build_mesh(MeshConfig(data=1, model=1),
                      devices=jax.devices()[:1])
    task = JaxTask(jcfg)
    sched = joptim.build_schedule(jcfg.schedule, len(batches),
                                  jcfg.train.global_batch)
    tx = joptim.build_optimizer(jcfg.optimizer, sched)
    state = create_train_state(jax.random.PRNGKey(0), task.init, tx, mesh)
    init = (jax.device_get(state.params), jax.device_get(state.batch_stats))
    trainer = JaxTrainer(jcfg, task.loss_fn, tx, mesh=mesh, donate=False)
    losses = []
    for b in batches:
        state, metrics = trainer.train_step(state, trainer.device_batch(b),
                                            jax.random.PRNGKey(1))
        losses.append(float(metrics["loss"]))
    final = trainer.evaluate(state, iter(eval_batches))
    return init, losses, jax.device_get(state.batch_stats), final


@pytest.mark.parametrize("accum", [1, 2])
def test_training_trajectory_matches_jax(accum):
    over = TINY + [f"train.grad_accum_steps={accum}"]
    cfg = apply_overrides(get_preset("imagenet_resnet50"), over)
    jcfg = j_overrides(j_preset("imagenet_resnet50"), over)
    assert cfg.optimizer.name == "lars" and cfg.train.label_smoothing == 0.1
    train_pipe = build_pipeline(cfg.data, 16, 10, seed=0)
    batches = [b for _, b in zip(range(5), train_pipe.one_epoch())]
    eval_pipe = build_pipeline(cfg.data, 16, 10, train=False,
                               drop_remainder=False)
    eval_batches = list(eval_pipe.one_epoch())
    assert len(eval_batches) == 2 and eval_batches[1]["eval_mask"].sum() == 8
    (params, stats), j_losses, j_stats, j_final = _jax_trajectory(
        jcfg, batches, eval_batches)

    dev = torch.device("cpu")
    task = ClassificationTask(cfg, dev)
    flat = lambda tree: {n: np.asarray(v)
                         for n, v in flatten_with_names(tree)[0]}
    task.model.load_state_dict(params_from_flax(
        flat(params), batch_stats=flat(stats)), strict=True)
    sched = toptim.build_schedule(cfg.schedule, 5, 16)
    state = t_create_state(task.model, toptim.build_optimizer(
        cfg.optimizer, sched, task.model))
    trainer = Trainer(cfg, task, dev)
    t_losses = [float(trainer.train_step(state, to_device(b, dev))["loss"])
                for b in batches]
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert t_losses[-1] < t_losses[0]
    want = params_from_flax({}, batch_stats=flat(j_stats))
    got = task.model.state_dict()
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    t_final = trainer.evaluate(state, iter(eval_batches))
    assert t_final["examples"] == j_final["examples"] == 24
    assert t_final["accuracy"] == j_final["accuracy"]
    assert t_final["accuracy_top5"] == j_final["accuracy_top5"]
    np.testing.assert_allclose(t_final["loss"], j_final["loss"], rtol=1e-4)


def test_cli_trains_cifar10_resnet20_on_cpu(tmp_path, capsys):
    from deeplearning_cfn_tpu_torch.cli.main import main

    argv = ["train", "--preset", "cifar10_resnet20", "--accelerator", "cpu",
            "--max-steps", "3", f"workdir={tmp_path}",
            "train.global_batch=16", "train.log_every_steps=1",
            "data.num_train_examples=64", "data.num_eval_examples=16",
            "schedule.name=constant", "schedule.base_lr=1.0",
            "schedule.warmup_epochs=0"]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "final metrics:" in out and "'accuracy_top5'" in out
    assert '"examples_per_sec"' in out
