"""The port's BERT pretraining pieces (``Lamb``, ``MlmTask``, the
``wikipedia_mlm`` pipeline, the trainer on LAMB) against the JAX package's,
on the CPU.

- ``Lamb`` against ``optax.lamb`` (through each package's
  ``build_optimizer``, behind the global-norm clip) over 6 updates under a
  warmup-then-cosine learning rate, among the parameters an all-zero 2-D one
  and a 1-D one whose gradient is 0 (both trust ratios fall back to 1):
  parameters within 1e-6;
- ``MlmTask``: loss, the four metrics and the per-metric eval weights on one
  batch with a padded eval tail, from the same weights: within 1e-6;
- the ``wikipedia_mlm`` batches: identical, array for array, to the JAX
  ``DataPipeline``'s over two train epochs and the padded eval epoch;
- a 5-step trajectory of the ``bert_base_wikipedia`` recipe (LAMB with weight
  decay 0.01 behind the 1.0 clip, cosine with warmup) on ``bert_tiny`` in f32
  with dropout 0, from one Flax init: the port's ``Trainer`` against the JAX
  ``Trainer`` on a one-device mesh, at ``grad_accum_steps`` 1 and 2. Losses
  within 1e-5 relative, final parameters within 1e-5 (the key biases, whose
  true gradient is 0, by the losses only).
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
from deeplearning_cfn_tpu.data.pipeline import DataPipeline as JaxPipeline
from deeplearning_cfn_tpu.data.text import build_text_source as j_source
from deeplearning_cfn_tpu.parallel import build_mesh
from deeplearning_cfn_tpu.presets import get_preset as j_preset
from deeplearning_cfn_tpu.train import create_train_state
from deeplearning_cfn_tpu.train import optim as joptim
from deeplearning_cfn_tpu.train.task import MlmTask as JaxMlmTask
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
from deeplearning_cfn_tpu_torch.train.task import MlmTask
from deeplearning_cfn_tpu_torch.train.trainer import Trainer

TINY = ["model.name=bert_tiny", "model.kwargs.hidden_size=32",
        "model.kwargs.num_layers=2", "model.kwargs.num_heads=2",
        "model.kwargs.mlp_dim=64", "model.kwargs.max_len=32",
        "model.kwargs.dropout_rate=0.0", "data.vocab_size=64",
        "data.seq_len=16", "train.dtype=float32",
        "data.num_train_examples=40", "data.num_eval_examples=12",
        "train.global_batch=8", "schedule.warmup_steps=2",
        "schedule.base_lr=5e-3"]

LAMB_SCHED = dict(name="cosine", base_lr=0.05, warmup_steps=2,
                  end_lr_factor=0.1)


def test_lamb_matches_optax():
    spec = dict(name="lamb", weight_decay=0.01, b1=0.9, b2=0.99, eps=1e-6,
                grad_clip_norm=1.0)
    rng = np.random.RandomState(0)
    params = {"w": rng.normal(0, 1, (5, 3)).astype(np.float32),
              "zero_w": np.zeros((4, 3), np.float32),
              "b": rng.normal(0, 1, (3,)).astype(np.float32),
              "still_b": rng.normal(0, 1, (2,)).astype(np.float32)}
    sched_j = joptim.build_schedule(JSched(**LAMB_SCHED), 6, 8)
    sched_t = toptim.build_schedule(ScheduleConfig(**LAMB_SCHED), 6, 8)
    tx = joptim.build_optimizer(JOpt(**spec), sched_j)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = toptim.Optimizer(OptimizerConfig(**spec), sched_t,
                           list(tp.values()))
    update = jax.jit(tx.update)
    for step in range(6):
        g = {k: rng.normal(0, 2.0, v.shape).astype(np.float32)
             for k, v in params.items()}
        g["still_b"][:] = 0.0
        upd, state = update({k: jnp.asarray(v) for k, v in g.items()},
                            state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    assert opt.count == 6
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(),
                                   np.asarray(jp[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert not np.array_equal(tp["zero_w"].detach().numpy(), 0.0)


def _configs(extra=()):
    over = TINY + list(extra)
    return (apply_overrides(get_preset("bert_base_wikipedia"), over),
            j_overrides(j_preset("bert_base_wikipedia"), over))


@pytest.fixture(scope="module")
def init():
    _, jcfg = _configs()
    params = jax.jit(JaxMlmTask(jcfg).init)(jax.random.PRNGKey(0))["params"]
    return params, {n: np.asarray(v)
                    for n, v in flatten_with_names(params)[0]}


def test_mlm_task_loss_metrics_and_weights_match_jax(init):
    params, flat = init
    cfg, jcfg = _configs()
    batch = list(build_pipeline(cfg.data, 8, train=False,
                                drop_remainder=False).one_epoch())[-1]
    assert batch["eval_mask"].sum() == 4  # 12 examples in batches of 8
    jtask = JaxMlmTask(jcfg)
    task = MlmTask(cfg, torch.device("cpu"))
    task.model.load_state_dict(params_from_flax(flat), strict=True)
    for train in (False, True):
        j_loss, j_aux = jax.jit(lambda p, b: jtask.loss_fn(
            p, {}, b, None, train))(
                params, {k: jnp.asarray(v) for k, v in batch.items()})
        j_aux.pop("batch_stats", None)
        with torch.no_grad():
            loss, aux = task.loss_fn(to_device(batch, torch.device("cpu")),
                                     train)
        assert set(aux) == set(j_aux)
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-6)
        for k, v in j_aux.items():
            np.testing.assert_allclose(float(aux[k]), float(v), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        if not train:
            assert float(aux["eval_weight"]) == 4.0
            assert float(aux["mlm_loss__weight"]) == 4.0 * 2  # 2 per row


def test_mlm_pipeline_batches_match_jax():
    cfg, jcfg = _configs()
    for train, drop in ((True, True), (False, False)):
        port = build_pipeline(cfg.data, 8, seed=5, train=train,
                              drop_remainder=drop)
        ref = JaxPipeline(j_source(jcfg.data, train), 8, seed=5,
                          shuffle=train, drop_remainder=drop, prefetch=0,
                          native=False)
        assert port.steps_per_epoch == ref.steps_per_epoch
        epochs = 2 if train else 1
        got = [b for e in range(epochs) for b in port.one_epoch(e)]
        want = [b for e in range(epochs) for b in ref.one_epoch(e)]
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert got[0]["mlm_positions"].shape == (8, 3)


@pytest.mark.parametrize("accum", [1, 2])
def test_training_trajectory_matches_jax(init, accum):
    params, flat = init
    cfg, jcfg = _configs([f"train.grad_accum_steps={accum}"])
    assert cfg.optimizer.name == "lamb" and cfg.optimizer.grad_clip_norm == 1
    batches = [b for _, b in zip(range(5), build_pipeline(
        cfg.data, 8, seed=0).one_epoch())]

    mesh = build_mesh(MeshConfig(data=1, model=1), devices=jax.devices()[:1])
    jtask = JaxMlmTask(jcfg)
    tx = joptim.build_optimizer(
        jcfg.optimizer, joptim.build_schedule(jcfg.schedule, 5, 8))
    jstate = create_train_state(jax.random.PRNGKey(0), jtask.init, tx, mesh)
    jstate = jstate.replace(params=params, opt_state=tx.init(params))
    jtrainer = JaxTrainer(jcfg, jtask.loss_fn, tx, mesh=mesh, donate=False)
    j_losses = []
    for b in batches:
        jstate, m = jtrainer.train_step(jstate, jtrainer.device_batch(b),
                                        jax.random.PRNGKey(1))
        j_losses.append(float(m["loss"]))

    dev = torch.device("cpu")
    task = MlmTask(cfg, dev)
    task.model.load_state_dict(params_from_flax(flat), strict=True)
    state = t_create_state(task.model, toptim.build_optimizer(
        cfg.optimizer, toptim.build_schedule(cfg.schedule, 5, 8),
        task.model))
    trainer = Trainer(cfg, task, dev)
    t_losses = [float(trainer.train_step(state, to_device(b, dev))["loss"])
                for b in batches]
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert t_losses[-1] < t_losses[0]
    want = params_from_flax({n: np.asarray(v) for n, v in
                             flatten_with_names(jstate.params)[0]})
    got = task.model.state_dict()
    # The key projections' biases are left out: their true gradient is 0
    # (they shift every score of a row alike), and LAMB's normalised update
    # turns the rounding noise each package leaves there into steps of
    # random sign. They cannot change any output, as the losses show.
    compared = [n for n in want if not n.endswith("key.bias")]
    assert len(compared) == len(want) - 2  # one per layer
    for name in compared:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
