"""The port's Adafactor (deeplearning_cfn_tpu_torch.train.optim.Adafactor)
against ``optax.adafactor`` as the JAX package builds it, on the CPU in f32.

- 6 updates through each package's ``build_optimizer`` (behind the
  global-norm clip, under a warmup-then-cosine learning rate), with and
  without weight decay (masked to ``ndim > 1``, in front of Adafactor), on
  leaves that factor (two dims of at least 128: a Dense kernel, a square
  one where the two dims tie, a 1×1 conv kernel whose factored dims are its
  last two in Flax's HWIO layout, a stacked [L, in, out] leaf) and leaves
  that do not (a small kernel, biases, an all-zero kernel whose block RMS
  falls to the 1e-3 floor): every parameter within 1e-5, the second-moment
  slots within 1e-5 relative, in optax's shapes;
- the checkpoint state both ways: a tiny BERT (hidden 128, so its kernels
  and tables factor) on the ``bert_base_wikipedia`` recipe with
  ``optimizer.name=adafactor``: both packages train 4 steps and save at
  step 2; each restores the other's checkpoint (the JAX restore is strict:
  every ``FactoredState`` leaf, placeholders included) and repeats the
  losses of steps 3–4 within 1e-4 relative.

Inputs are numpy arrays made from seeds and handed to both packages.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning_cfn_tpu.ckpt import restore_checkpoint as j_restore
from deeplearning_cfn_tpu.ckpt import save_checkpoint as j_save
from deeplearning_cfn_tpu.config import MeshConfig
from deeplearning_cfn_tpu.config import OptimizerConfig as JOpt
from deeplearning_cfn_tpu.config import ScheduleConfig as JSched
from deeplearning_cfn_tpu.config import apply_overrides as j_overrides
from deeplearning_cfn_tpu.parallel import build_mesh
from deeplearning_cfn_tpu.presets import get_preset as j_preset
from deeplearning_cfn_tpu.train import create_train_state as j_create_state
from deeplearning_cfn_tpu.train import optim as joptim
from deeplearning_cfn_tpu.train.task import MlmTask as JMlmTask
from deeplearning_cfn_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning_cfn_tpu.utils.trees import flatten_with_names
from deeplearning_cfn_tpu_torch.ckpt import restore_checkpoint, \
    save_checkpoint
from deeplearning_cfn_tpu_torch.config import (OptimizerConfig,
                                               ScheduleConfig, apply_overrides)
from deeplearning_cfn_tpu_torch.convert import from_flax, params_from_flax
from deeplearning_cfn_tpu_torch.data.pipeline import build_pipeline, to_device
from deeplearning_cfn_tpu_torch.presets import get_preset
from deeplearning_cfn_tpu_torch.train import optim as toptim
from deeplearning_cfn_tpu_torch.train.state import create_train_state
from deeplearning_cfn_tpu_torch.train.task import build_task
from deeplearning_cfn_tpu_torch.train.trainer import Trainer

SCHED = dict(name="cosine", base_lr=0.05, warmup_steps=2, end_lr_factor=0.1)
# name -> (Flax-layout shape, the port's layout kind)
LEAVES = {"dense": ((200, 130), "dense"),
          "square": ((128, 128), "dense"),
          "conv1x1": ((1, 1, 256, 128), "conv"),
          "stacked": ((2, 128, 160), "none"),
          "small": ((5, 3), "dense"),
          "zero": ((4, 6), "dense"),
          "bias": ((300,), "none"),
          "scale": ((7,), "none")}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One worker's share of the cores (torch would start a thread per core
    in every pytest-xdist worker)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_adafactor_matches_optax(weight_decay):
    spec = dict(name="adafactor", weight_decay=weight_decay,
                grad_clip_norm=1.0)
    rng = np.random.RandomState(0)
    params = {k: rng.normal(0, 0.3, shape).astype(np.float32)
              for k, (shape, _) in LEAVES.items()}
    params["zero"][:] = 0.0
    grads = [{k: rng.normal(0, 1, v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(6)]
    j_sched = joptim.build_schedule(JSched(**SCHED), 6, 64)
    tx = joptim.build_optimizer(JOpt(**spec), j_sched)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(np.ascontiguousarray(
        from_flax(v, LEAVES[k][1])))) for k, v in params.items()}
    opt = toptim.Optimizer(
        OptimizerConfig(**spec), toptim.build_schedule(
            ScheduleConfig(**SCHED), 6, 64), list(tp.values()),
        {p: LEAVES[k][1] for k, p in tp.items()})
    assert isinstance(opt.inner, toptim.Adafactor)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(np.ascontiguousarray(
                from_flax(g[k], LEAVES[k][1])))
        opt.step()
        for k in params:
            got = tp[k].detach().numpy()
            np.testing.assert_allclose(
                got, from_flax(np.asarray(jp[k]), LEAVES[k][1]), rtol=1e-5,
                atol=1e-5, err_msg=f"{k} {opt.count}")
    assert opt.count == 6
    # The factored slots, in optax's shapes (Flax's layout).
    want = dict(flatten_with_names(state)[0])
    # The chain: the clip, the masked decay (when on), then Adafactor.
    prefix = "2/0/" if weight_decay else "1/0/"
    assert opt._chain_index == int(prefix[0])
    factored = {"dense", "square", "conv1x1", "stacked"}
    for k, p in tp.items():
        for field in ("v_row", "v_col", "v"):
            ref = np.asarray(want[f"{prefix}{field}/{k}"])
            got = opt.inner.slot(p, field).numpy()
            assert got.shape == ref.shape, (k, field)
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-30,
                                       err_msg=f"{k} {field}")
        assert (opt.inner.slot(p, "v").shape == (1,)) == (k in factored)
    assert int(want[f"{prefix}count"]) == 6
    # The zero kernel moved by lr × 1e-3-floored steps.
    assert 0 < float(tp["zero"].detach().abs().max()) < 1e-2


BERT = ["model.name=bert_tiny", "model.kwargs.num_layers=1",
        "model.kwargs.hidden_size=128", "model.kwargs.mlp_dim=256",
        "model.kwargs.num_heads=2", "model.kwargs.max_len=128",
        "model.kwargs.dropout_rate=0.0", "data.vocab_size=512",
        "data.seq_len=16", "train.dtype=float32", "train.global_batch=8",
        "data.num_train_examples=40", "data.num_eval_examples=16",
        "schedule.warmup_steps=2", "schedule.base_lr=1e-2",
        "optimizer.name=adafactor"]
STEPS = 4


def test_adafactor_checkpoints_interchange_with_jax(tmp_path):
    cfg = apply_overrides(get_preset("bert_base_wikipedia"), BERT)
    jcfg = j_overrides(j_preset("bert_base_wikipedia"), BERT)
    assert cfg.optimizer.weight_decay == 0.01  # the decay in front
    batches = [b for _, b in zip(range(STEPS), build_pipeline(
        cfg.data, 8, seed=0).one_epoch())]
    mesh = build_mesh(MeshConfig(data=1, model=1), devices=jax.devices()[:1])
    jtask = JMlmTask(jcfg)
    tx = joptim.build_optimizer(
        jcfg.optimizer, joptim.build_schedule(jcfg.schedule, STEPS, 8))
    jstate = j_create_state(jax.random.PRNGKey(0), jtask.init, tx, mesh)
    jtrainer = JaxTrainer(jcfg, jtask.loss_fn, tx, mesh=mesh, donate=False)
    template = jstate
    flat = {n: np.asarray(v) for n, v in
            flatten_with_names(jstate.params)[0]}
    assert flat["encoder/layer_0/mlp/mlp_in/kernel"].shape == (128, 256)

    def j_steps(state, bs):
        losses = []
        for b in bs:
            state, m = jtrainer.train_step(state, jtrainer.device_batch(b),
                                           jax.random.PRNGKey(1))
            losses.append(float(m["loss"]))
        return state, losses

    def port():
        task = build_task(cfg, torch.device("cpu"))
        task.model.load_state_dict(params_from_flax(flat), strict=True)
        opt = toptim.build_optimizer(cfg.optimizer, toptim.build_schedule(
            cfg.schedule, STEPS, 8), task.model)
        return create_train_state(task.model, opt), \
            Trainer(cfg, task, torch.device("cpu"))

    def t_steps(trainer, state, bs):
        return [float(trainer.train_step(state, to_device(
            b, torch.device("cpu")))["loss"]) for b in bs]

    jstate, j_head = j_steps(jstate, batches[:2])
    j_save(str(tmp_path / "jax"), 2, jstate)
    _, j_tail = j_steps(jstate, batches[2:])
    state, trainer = port()
    t_head = t_steps(trainer, state, batches[:2])
    names = dict(state.named_leaves())
    # [128, 256]: v_row keeps the smaller dim, v_col the larger.
    assert names["opt_state/2/0/v_row/encoder/layer_0/mlp/mlp_in/kernel"] \
        .shape == (128,)
    assert names["opt_state/2/0/v_col/encoder/layer_0/mlp/mlp_in/kernel"] \
        .shape == (256,)
    assert names["opt_state/2/0/v/encoder/layer_0/mlp/mlp_in/kernel"] \
        .shape == (1,)
    save_checkpoint(str(tmp_path / "port"), 2, state)
    t_tail = t_steps(trainer, state, batches[2:])
    np.testing.assert_allclose(t_head + t_tail, j_head + j_tail, rtol=1e-4)

    restored, step = j_restore(str(tmp_path / "port"), template)
    assert step == 2 and int(restored.step) == 2
    _, from_port = j_steps(restored, batches[2:])
    np.testing.assert_allclose(from_port, t_tail, rtol=1e-4)

    fresh, fresh_trainer = port()
    leaves, step = restore_checkpoint(str(tmp_path / "jax"), fresh)
    fresh.load_named(leaves)
    assert step == 2 and fresh.optimizer.count == 2
    from_jax = t_steps(fresh_trainer, fresh, batches[2:])
    np.testing.assert_allclose(from_jax, j_tail, rtol=1e-4)
