"""The port's causal-LM training (``train.task.CausalLmTask``, the trainer's
``eval_derived``) against the JAX package's, on the CPU in f32.

- ``CausalLmTask.loss_fn`` on ``gpt_tiny`` from one Flax init: the loss,
  ``token_accuracy`` and the clipped train ``perplexity``, and at eval
  ``ce_loss`` and ``eval_weight``, with a ragged ``loss_mask`` and a padded
  eval tail (``eval_mask``), within 1e-5 relative; the gradients within
  1e-4 of the largest gradient entry;
- ``Trainer.evaluate``: the evaluated ``perplexity`` is exp of the
  aggregated token-weighted CE, equal to the JAX trainer's;
- the training trajectory: 5 steps of the ``gpt_small_lm`` recipe (AdamW
  (0.9, 0.95) with weight decay 0.1 behind the 1.0 clip, cosine) on
  ``gpt_tiny`` with dropout 0, at ``grad_accum_steps`` 1 and 2, in both
  packages (the JAX side with the Pallas kernels in interpret mode, so its
  backward is the flash kernels'): losses within 1e-4 relative, final
  params within 1e-4, as ``tests/test_torch_train.py`` holds the NMT's;
- ``train.remat`` recomputes the same loss and gradients, with dropout.

Inputs are numpy arrays made from seeds and handed to both packages.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning_cfn_tpu.config import MeshConfig
from deeplearning_cfn_tpu.config import apply_overrides as j_overrides
from deeplearning_cfn_tpu.parallel import build_mesh
from deeplearning_cfn_tpu.presets import get_preset as j_preset
from deeplearning_cfn_tpu.train import create_train_state as j_create_state
from deeplearning_cfn_tpu.train import optim as joptim
from deeplearning_cfn_tpu.train.task import CausalLmTask as JaxTask
from deeplearning_cfn_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning_cfn_tpu.utils.trees import flatten_with_names
from deeplearning_cfn_tpu_torch.config import apply_overrides
from deeplearning_cfn_tpu_torch.convert import params_from_flax
from deeplearning_cfn_tpu_torch.data.pipeline import build_pipeline, to_device
from deeplearning_cfn_tpu_torch.data.text import make_lm_source
from deeplearning_cfn_tpu_torch.presets import get_preset
from deeplearning_cfn_tpu_torch.train import optim as toptim
from deeplearning_cfn_tpu_torch.train.state import create_train_state
from deeplearning_cfn_tpu_torch.train.task import CausalLmTask, build_task
from deeplearning_cfn_tpu_torch.train.trainer import Trainer

TINY = ["model.name=gpt_tiny", "model.kwargs.max_len=32",
        "model.kwargs.dropout_rate=0.0", "data.vocab_size=512",
        "data.seq_len=16", "train.dtype=float32",
        "data.num_train_examples=64", "data.num_eval_examples=16"]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One worker's share of the cores (torch would start a thread per core
    in every pytest-xdist worker)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_side():
    jcfg = j_overrides(j_preset("gpt_small_lm"), TINY)
    task = JaxTask(jcfg)
    params = jax.jit(task.init)(jax.random.PRNGKey(0))["params"]
    flat = {n: np.asarray(v) for n, v in flatten_with_names(params)[0]}
    return jcfg, task, params, flat


def _port(flat, over=()):
    cfg = apply_overrides(get_preset("gpt_small_lm"), TINY + list(over))
    task = build_task(cfg, CPU)
    assert isinstance(task, CausalLmTask)
    task.model.load_state_dict(params_from_flax(flat), strict=True)
    return cfg, task


def _batch(n=6, seed=3):
    """LM examples with a ragged ``loss_mask`` (rows 1 and 2 end early) and
    the rows from 4 on padding (``eval_mask`` 0)."""
    b = {k: v.copy() for k, v in make_lm_source(n, 16, 512, seed)
         .arrays.items()}
    b["loss_mask"][1, 9:] = 0.0
    b["loss_mask"][2, 3:] = 0.0
    b["eval_mask"] = (np.arange(n) < 4).astype(np.float32)
    return b


@pytest.mark.parametrize("train", [True, False])
def test_loss_and_metrics_match_jax(jax_side, train):
    _, jtask, params, flat = jax_side
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    j_loss, j_aux = jtask.loss_fn(params, {}, jb, None, train)
    _, task = _port(flat)
    t_loss, t_aux = task.loss_fn(to_device(b, CPU), train)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5)
    want = {k: float(v) for k, v in j_aux.items() if k != "batch_stats"}
    got = {k: v.item() for k, v in t_aux.items()}
    assert sorted(got) == sorted(want)
    assert sorted(got) == (["perplexity", "token_accuracy"] if train else
                           ["ce_loss", "eval_weight", "token_accuracy"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    if not train:
        assert got["eval_weight"] == 16 + 9 + 3 + 16  # rows 0-3 only


def test_gradients_match_jax_grad(jax_side):
    _, jtask, params, flat = jax_side
    b = _batch(n=4, seed=5)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jtask.loss_fn(p, {}, jb, None, True)[0]))(params)
    want = params_from_flax({n: np.asarray(v) for n, v in
                             flatten_with_names(j_grads)[0]})
    _, task = _port(flat)
    t_loss, _ = task.loss_fn(to_device(b, CPU), True)
    t_loss.backward()
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5)
    scale = max(v.abs().max().item() for v in want.values())
    got = dict(task.model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, g in want.items():
        if name.endswith("key.bias"):
            continue  # true gradient 0: rounding noise only
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(),
                                   rtol=0, atol=1e-4 * scale, err_msg=name)


def test_evaluated_perplexity_is_exp_of_the_aggregated_ce(jax_side):
    jcfg, jtask, params, flat = jax_side
    cfg, task = _port(flat, ["train.global_batch=8", "train.eval_batch=6"])
    jcfg = j_overrides(jcfg, ["train.global_batch=8", "train.eval_batch=6"])
    batches = [_batch(6, seed) for seed in (7, 8)]
    state = create_train_state(task.model, None)
    got = Trainer(cfg, task, CPU).evaluate(state, iter(batches))
    assert got["perplexity"] == pytest.approx(np.exp(got["ce_loss"]),
                                              rel=1e-12)
    assert got["ce_loss"] == pytest.approx(got["loss"], rel=1e-12)
    # Not the weighted mean of the per-batch perplexities (Jensen).
    per_batch = [task.loss_fn(to_device(b, CPU), False)[1] for b in batches]
    mean_exp = sum(float(torch.exp(a["ce_loss"].detach()) * a["eval_weight"])
                   for a in per_batch) / got["examples"]
    assert abs(mean_exp - got["perplexity"]) > 1e-6
    mesh = build_mesh(MeshConfig(data=1, model=1), devices=jax.devices()[:1])
    jtrainer = JaxTrainer(jcfg, jtask.loss_fn, optax.sgd(0.0), mesh=mesh,
                          eval_derived=jtask.eval_derived)
    jstate = j_create_state(jax.random.PRNGKey(0), jtask.init,
                            optax.sgd(0.0), mesh)
    want = jtrainer.evaluate(jstate, iter(batches))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def _jax_run(jcfg, params, batches, accum):
    task = JaxTask(jcfg)
    sched = joptim.build_schedule(jcfg.schedule, len(batches),
                                  jcfg.train.global_batch)
    tx = joptim.build_optimizer(jcfg.optimizer, sched)

    def loss(p, b):
        return task.loss_fn(p, {}, b, None, True)[0]

    @jax.jit
    def step(p, opt_state, batch):
        vals, gs = [], []
        for i in range(accum):
            mb = jax.tree_util.tree_map(lambda v: v[i::accum], batch)
            val, g = jax.value_and_grad(loss)(p, mb)
            vals.append(val)
            gs.append(g)
        grads = jax.tree_util.tree_map(lambda *g: sum(g) / accum, *gs)
        upd, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, upd), opt_state, sum(vals) / accum

    opt_state = tx.init(params)
    losses = []
    for b in batches:
        params, opt_state, value = step(params, opt_state, b)
        losses.append(float(value))
    return losses, params


@pytest.mark.parametrize("accum", [1, 2])
def test_training_trajectory_matches_jax(accum):
    over = TINY + ["train.global_batch=8", f"train.grad_accum_steps={accum}",
                   "train.seed=0", "schedule.warmup_steps=2",
                   "schedule.base_lr=3e-3"]
    cfg = apply_overrides(get_preset("gpt_small_lm"), over)
    jcfg = j_overrides(j_preset("gpt_small_lm"),
                       over + ["model.kwargs.attention_impl=interpret"])
    assert (cfg.optimizer.name, cfg.optimizer.b2, cfg.optimizer.weight_decay,
            cfg.optimizer.grad_clip_norm, cfg.schedule.name) == \
        ("adamw", 0.95, 0.1, 1.0, "cosine")
    params = JaxTask(jcfg).init(jax.random.PRNGKey(0))["params"]
    flat = {n: np.asarray(x) for n, x in flatten_with_names(params)[0]}
    batches = [b for _, b in zip(range(5), build_pipeline(
        cfg.data, 8, seed=0).one_epoch())]
    j_losses, j_params = _jax_run(jcfg, params,
                                  [{k: jnp.asarray(v) for k, v in b.items()}
                                   for b in batches], accum)
    _, task = _port(flat, over[len(TINY):])
    state = create_train_state(task.model, toptim.build_optimizer(
        cfg.optimizer, toptim.build_schedule(cfg.schedule, 5, 8), task.model))
    trainer = Trainer(cfg, task, CPU)
    t_losses = [float(trainer.train_step(state, to_device(b, CPU))["loss"])
                for b in batches]
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert t_losses[-1] < t_losses[0]
    want = params_from_flax({n: np.asarray(x) for n, x in
                             flatten_with_names(j_params)[0]})
    got = task.model.state_dict()
    # Key-projection biases: true gradient 0, Adam turns each package's
    # rounding noise into lr-sized steps (tests/test_torch_train.py).
    compared = [n for n in want if not n.endswith("key.bias")]
    assert len(compared) == len(want) - 2
    for name in compared:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def test_remat_recomputes_the_same_loss_and_gradients(jax_side):
    *_, flat = jax_side
    b = to_device(_batch(n=4, seed=9), CPU)
    grads = {}
    for remat in ("false", "true"):
        _, task = _port(flat, ["model.kwargs.dropout_rate=0.1",
                               f"train.remat={remat}"])
        loss, _ = task.loss_fn(b, True, torch.Generator().manual_seed(4))
        loss.backward()
        grads[remat] = (loss.item(), {n: p.grad.clone() for n, p in
                                      task.model.named_parameters()})
    assert grads["true"][0] == grads["false"][0]
    for n, g in grads["false"][1].items():
        torch.testing.assert_close(grads["true"][1][n], g, rtol=1e-6,
                                   atol=1e-7)
