"""The port's checkpoints (deeplearning_cfn_tpu_torch.ckpt, the TrainState
bridge, resume in ``train.run``, the ``ckpt`` and ``eval`` verbs) against the
JAX package's, on the CPU.

- Interchange, for each optimizer the port has (AdamW on the NMT, LARS on a
  ResNet with BatchNorm statistics, LAMB on BERT): from one Flax init, both
  packages train 4 steps and save at step 2. The JAX ``restore_checkpoint``
  reads the port's step-2 checkpoint into the JAX ``TrainState`` (strict:
  every leaf of its target must be there, ``opt_state`` included) and the
  JAX ``Trainer`` continues; the port restores the JAX checkpoint and
  continues. Both continuations repeat the losses of steps 3–4 within 1e-4
  relative (the tolerance of the two packages' trajectories).
- Resume: a run killed after step 3 (mid-epoch) and resumed to step 6
  (into the next epoch) equals the uninterrupted run exactly — every loss, and every leaf of the
  final checkpoint — for BERT (dropout 0.1, so the per-step generator
  matters) and a ResNet (BatchNorm statistics, LARS momentum).
- The store protocol as ``tests/test_checkpoint.py`` holds the JAX one to:
  round trip, uncommitted steps invisible, keep-K, sweep, rollback, async
  saves through the manager, the strict restore, an object store.
- The ``ckpt list``/``ckpt rollback`` and ``eval`` verbs on the CPU.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from deeplearning_cfn_tpu.ckpt import restore_checkpoint as j_restore
from deeplearning_cfn_tpu.ckpt import save_checkpoint as j_save
from deeplearning_cfn_tpu.config import MeshConfig
from deeplearning_cfn_tpu.config import apply_overrides as j_overrides
from deeplearning_cfn_tpu.parallel import build_mesh
from deeplearning_cfn_tpu.presets import get_preset as j_preset
from deeplearning_cfn_tpu.train import create_train_state as j_create_state
from deeplearning_cfn_tpu.train import optim as joptim
from deeplearning_cfn_tpu.train.task import build_task as j_build_task
from deeplearning_cfn_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning_cfn_tpu.utils.trees import flatten_with_names
from deeplearning_cfn_tpu_torch.ckpt import (CheckpointManager,
                                             MemoryObjectStore,
                                             committed_steps,
                                             latest_checkpoint, read_leaves,
                                             restore_checkpoint,
                                             rollback_checkpoints,
                                             save_checkpoint,
                                             sweep_uncommitted)
from deeplearning_cfn_tpu_torch.config import apply_overrides
from deeplearning_cfn_tpu_torch.convert import params_from_flax
from deeplearning_cfn_tpu_torch.data.pipeline import build_pipeline, to_device
from deeplearning_cfn_tpu_torch.presets import get_preset
from deeplearning_cfn_tpu_torch.train import optim as toptim
from deeplearning_cfn_tpu_torch.train.run import run_experiment
from deeplearning_cfn_tpu_torch.train.state import create_train_state
from deeplearning_cfn_tpu_torch.train.task import build_task
from deeplearning_cfn_tpu_torch.train.trainer import Trainer

BERT = ["model.name=bert_tiny", "model.kwargs.hidden_size=32",
        "model.kwargs.num_layers=2", "model.kwargs.num_heads=2",
        "model.kwargs.mlp_dim=64", "model.kwargs.max_len=32",
        "model.kwargs.dropout_rate=0.0", "data.vocab_size=64",
        "data.seq_len=16", "train.dtype=float32", "train.global_batch=8",
        "data.num_train_examples=40", "data.num_eval_examples=16",
        "schedule.warmup_steps=2", "schedule.base_lr=5e-3"]
NMT = ["model.kwargs.hidden_size=32", "model.kwargs.num_layers=1",
       "model.kwargs.num_heads=2", "model.kwargs.mlp_dim=64",
       "data.vocab_size=64", "data.seq_len=16", "train.dtype=float32",
       "train.global_batch=8", "data.num_train_examples=64",
       "data.num_eval_examples=16", "model.kwargs.dropout_rate=0.0",
       "schedule.warmup_steps=2", "schedule.base_lr=0.01"]
RESNET = ["model.name=resnet18", "model.num_classes=10",
          "model.kwargs.num_filters=8", "data.image_size=32",
          "train.dtype=float32", "data.num_train_examples=80",
          "data.num_eval_examples=16", "train.global_batch=16",
          "schedule.scale_with_batch=false", "schedule.base_lr=1.0",
          "schedule.warmup_steps=2", "schedule.warmup_epochs=0"]
CASES = {"adamw": ("transformer_nmt_wmt", NMT),
         "lars": ("imagenet_resnet50", RESNET),
         "lamb": ("bert_base_wikipedia", BERT)}
STEPS = 4


# -- interchange with the JAX package ----------------------------------------


def _jax_side(jcfg, mesh):
    task = j_build_task(jcfg)
    tx = joptim.build_optimizer(
        jcfg.optimizer, joptim.build_schedule(jcfg.schedule, STEPS,
                                              jcfg.train.global_batch))
    state = j_create_state(jax.random.PRNGKey(0), task.init, tx, mesh)
    trainer = JaxTrainer(jcfg, task.loss_fn, tx, mesh=mesh, donate=False)
    return state, trainer


def _jax_steps(trainer, state, batches):
    losses = []
    for b in batches:
        state, m = trainer.train_step(state, trainer.device_batch(b),
                                      jax.random.PRNGKey(1))
        losses.append(float(m["loss"]))
    return state, losses


def _port_side(cfg, flat):
    dev = torch.device("cpu")
    task = build_task(cfg, dev)
    task.model.load_state_dict(params_from_flax(flat), strict=True)
    opt = toptim.build_optimizer(
        cfg.optimizer, toptim.build_schedule(cfg.schedule, STEPS,
                                             cfg.train.global_batch),
        task.model)
    return create_train_state(task.model, opt), Trainer(cfg, task, dev)


def _port_steps(trainer, state, batches):
    return [float(trainer.train_step(state, to_device(b, trainer.device))
                  ["loss"]) for b in batches]


@pytest.mark.parametrize("optimizer", sorted(CASES))
def test_checkpoints_interchange_with_jax(tmp_path, optimizer):
    preset, over = CASES[optimizer]
    cfg = apply_overrides(get_preset(preset), over)
    jcfg = j_overrides(j_preset(preset), over)
    assert cfg.optimizer.name == optimizer
    batches = [b for _, b in zip(range(STEPS), build_pipeline(
        cfg.data, cfg.train.global_batch, cfg.model.num_classes,
        seed=0).one_epoch())]
    mesh = build_mesh(MeshConfig(data=1, model=1), devices=jax.devices()[:1])

    # The JAX reference: 4 steps, its own checkpoint at step 2.
    jstate, jtrainer = _jax_side(jcfg, mesh)
    flat = {n: np.asarray(v) for n, v in
            flatten_with_names({"params": jstate.params,
                                "batch_stats": jstate.batch_stats})[0]}
    template = jstate
    jstate, j_head = _jax_steps(jtrainer, jstate, batches[:2])
    j_save(str(tmp_path / "jax"), 2, jstate)
    _, j_tail = _jax_steps(jtrainer, jstate, batches[2:])

    # The port from the same init: 4 steps, its checkpoint at step 2.
    state, trainer = _port_side(cfg, flat)
    t_head = _port_steps(trainer, state, batches[:2])
    save_checkpoint(str(tmp_path / "port"), 2, state)
    t_tail = _port_steps(trainer, state, batches[2:])
    np.testing.assert_allclose(t_head + t_tail, j_head + j_tail, rtol=1e-4)

    # JAX restores the port's checkpoint and continues.
    restored, step = j_restore(str(tmp_path / "port"), template)
    assert step == 2 and int(restored.step) == 2
    _, from_port = _jax_steps(jtrainer, restored, batches[2:])
    np.testing.assert_allclose(from_port, t_tail, rtol=1e-4)

    # The port restores the JAX checkpoint and continues.
    fresh, fresh_trainer = _port_side(cfg, flat)
    leaves, step = restore_checkpoint(str(tmp_path / "jax"), fresh)
    fresh.load_named(leaves)
    assert step == 2 and fresh.step == 2 and fresh.optimizer.count == 2
    from_jax = _port_steps(fresh_trainer, fresh, batches[2:])
    np.testing.assert_allclose(from_jax, j_tail, rtol=1e-4)


# -- resume ------------------------------------------------------------------


class _Killed(Exception):
    pass


RESUME = {"bert": ("bert_base_wikipedia",
                   BERT + ["model.kwargs.dropout_rate=0.1"]),
          "resnet": ("cifar10_resnet20",
                     ["train.global_batch=8", "data.num_train_examples=40",
                      "data.num_eval_examples=8", "schedule.name=constant",
                      "schedule.base_lr=0.1", "schedule.warmup_epochs=0"])}


def _run(cfg, kill_after=None):
    losses = {}

    def hook(step, state, record):
        losses[step] = record["loss"]
        if step == kill_after:
            raise _Killed()

    try:
        run_experiment(cfg, device="cpu", hooks=(hook,))
    except _Killed:
        pass
    return losses


@pytest.mark.parametrize("model", sorted(RESUME))
def test_resume_mid_epoch_equals_the_uninterrupted_run(tmp_path, model):
    preset, over = RESUME[model]
    common = over + ["train.steps=6", "train.log_every_steps=1",
                     "train.eval_every_steps=1000000",
                     "checkpoint.every_steps=1", "checkpoint.async_write=false",
                     "checkpoint.keep=0"]
    straight_cfg = apply_overrides(get_preset(preset),
                                   common + [f"workdir={tmp_path / 'a'}"])
    resumed_cfg = apply_overrides(get_preset(preset),
                                  common + [f"workdir={tmp_path / 'b'}"])
    straight = _run(straight_cfg)
    head = _run(resumed_cfg, kill_after=3)
    assert sorted(head) == [1, 2, 3]
    tail = _run(resumed_cfg)
    assert sorted(tail) == [4, 5, 6]  # across the epoch boundary at 5
    assert {**head, **tail} == straight  # bit for bit
    a = read_leaves(str(tmp_path / "a" / preset / "ckpt"), 6)
    b = read_leaves(str(tmp_path / "b" / preset / "ckpt"), 6)
    assert a.keys() == b.keys() and any(k.startswith("opt_state/")
                                        for k in a)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


# -- the store protocol --------------------------------------------------------


def _state(step=7):
    return {"step": np.asarray(step, np.int32),
            "params/w": torch.arange(12.0).reshape(3, 4),
            "params/b": np.ones(4, np.float32)}


def test_roundtrip_and_uncommitted_steps_are_invisible(tmp_path):
    root = str(tmp_path)
    path = save_checkpoint(root, 7, _state())
    assert latest_checkpoint(root) == 7 and committed_steps(root) == [7]
    leaves, step = restore_checkpoint(root, _state(0))
    assert step == 7 and int(leaves["step"]) == 7
    np.testing.assert_array_equal(leaves["params/w"],
                                  np.arange(12.0).reshape(3, 4))
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    assert manifest["processes"] == 1
    assert manifest["leaves"]["params/w"] == {
        "kind": "array", "shape": [3, 4], "dtype": "float32"}
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(root, {**_state(0), "params/extra": None})
    os.remove(os.path.join(path, "COMMIT"))
    assert latest_checkpoint(root) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(root, _state(0))
    assert sweep_uncommitted(root) == [7] and not os.listdir(root)
    with pytest.raises(FileNotFoundError, match="no such checkpoint"):
        committed_steps(str(tmp_path / "nowhere"))


def test_keep_rollback_and_the_async_manager(tmp_path):
    root = str(tmp_path / "ckpt")
    for step in (1, 2, 3, 4):
        save_checkpoint(root, step, _state(step), keep=2)
    assert committed_steps(root) == [3, 4]
    assert rollback_checkpoints(root, 3) == [4]
    assert committed_steps(root) == [3]
    with pytest.raises(FileNotFoundError, match="no committed checkpoint"):
        rollback_checkpoints(root, 4)

    manager = CheckpointManager(root, every_steps=2, keep=3,
                                async_write=True)
    live = {"step": np.asarray(0, np.int32),
            "params/w": torch.zeros(3, 4)}
    for step in range(4, 9):
        live["step"] = np.asarray(step, np.int32)
        live["params/w"].fill_(float(step))
        manager.save(step, live)  # only the multiples of 2
    manager.save(9, live, force=True)
    manager.wait()
    assert committed_steps(root) == [6, 8, 9]
    # The host copy was taken at save time, before the next step changed
    # the live tensor.
    leaves, step = manager.restore_or_none(live, step=6)
    assert step == 6
    np.testing.assert_array_equal(leaves["params/w"], np.full((3, 4), 6.0))
    with pytest.raises(FileNotFoundError, match="available"):
        manager.restore_or_none(live, step=5)
    empty = CheckpointManager(str(tmp_path / "empty"))
    assert empty.restore_or_none(_state(0)) == (None, None)


def test_object_store_roundtrip():
    store = MemoryObjectStore()
    save_checkpoint(store, 5, _state(5))
    save_checkpoint(store, 6, _state(6))
    assert committed_steps(store) == [5, 6]
    leaves, step = restore_checkpoint(store, _state(0))
    assert step == 6 and int(leaves["step"]) == 6
    store.delete_prefix("step_00000006/COMMIT")
    assert latest_checkpoint(store) == 5


# -- the CLI -------------------------------------------------------------------


def test_cli_ckpt_and_eval_verbs(tmp_path, capsys):
    from deeplearning_cfn_tpu_torch.cli.main import main

    over = BERT + [f"workdir={tmp_path}", "checkpoint.every_steps=2",
                   "checkpoint.keep=0", "train.log_every_steps=2"]
    assert main(["train", "--preset", "bert_base_wikipedia",
                 "--accelerator", "cpu", "--max-steps", "4", *over]) == 0
    ckpt_dir = str(tmp_path / "bert_base_wikipedia" / "ckpt")
    capsys.readouterr()
    assert main(["ckpt", "list", ckpt_dir]) == 0
    listed = json.loads(capsys.readouterr().out)
    assert listed["committed_steps"] == [2, 4]
    assert main(["eval", "--preset", "bert_base_wikipedia", "--accelerator",
                 "cpu", "--step", "2", *over]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["checkpoint_step"] == 2 and metrics["examples"] == 16.0
    assert {"mlm_loss", "nsp_accuracy"} <= set(metrics)
    assert main(["ckpt", "rollback", ckpt_dir, "--step", "2"]) == 0
    assert "deleted 1 later checkpoint(s): [4]" in capsys.readouterr().out
    assert committed_steps(ckpt_dir) == [2]
    # The next launch resumes from the rolled-back step.
    assert main(["train", "--preset", "bert_base_wikipedia",
                 "--accelerator", "cpu", "--max-steps", "4", *over]) == 0
    assert "resumed from step 2" in capsys.readouterr().out
    assert main(["ckpt", "list", str(tmp_path / "nowhere")]) == 1
    assert main(["eval", "--preset", "bert_base_wikipedia", "--accelerator",
                 "cpu", *BERT, f"workdir={tmp_path / 'empty'}"]) == 1
    assert "no committed checkpoint" in capsys.readouterr().err
