"""The port's ViT (deeplearning_cfn_tpu_torch.models.vit and the stats-free
``ClassificationTask``) against the JAX package's, on the CPU in f32.

- ``vit_tiny`` (2 layers, hidden 64, 4 heads, patch 4, 16×16 images) from
  one Flax init (the zero head replaced by a random one) carried by
  ``convert.params_from_flax``: logits within 1e-5 of the largest logit,
  with the JAX attention through its plain reference and through the
  Pallas kernel in interpret mode; ``convert.flax_layout`` naming every
  leaf of ``vit_s16`` as the Flax tree does; the gradients of the
  label-smoothed task loss within 1e-4 of the largest gradient entry;
- the patch tokens in the Flax order, the row-major flatten of NHWC
  patches (a numpy reference; the h/w-transposed order differs);
- the stats-free ``ClassificationTask``: dropout active in train mode, the
  same masks from the same generator seed and other masks from another,
  none in eval mode, and ViT's own init (a zero head, ``pos_embed`` at
  std 0.02, the truncated-normal patch kernel);
- a 5-step trajectory of the ``imagenet_vit_s16`` recipe (AdamW with
  weight decay 0.05 behind the 1.0 clip, cosine with warmup, label
  smoothing 0.1) on ``vit_tiny`` with dropout 0: the port's ``Trainer``
  against the JAX ``Trainer`` on a one-device mesh, losses within 1e-4
  relative, final parameters within 1e-4, the eval's top-1 and top-5
  equal.

Inputs are numpy arrays made from seeds and handed to both packages.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from deeplearning_cfn_tpu.config import MeshConfig
from deeplearning_cfn_tpu.config import apply_overrides as j_overrides
from deeplearning_cfn_tpu.models import build_model as j_build_model
from deeplearning_cfn_tpu.parallel import build_mesh
from deeplearning_cfn_tpu.presets import get_preset as j_preset
from deeplearning_cfn_tpu.train import create_train_state as j_create_state
from deeplearning_cfn_tpu.train import optim as joptim
from deeplearning_cfn_tpu.train.task import ClassificationTask as JaxTask
from deeplearning_cfn_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning_cfn_tpu.utils.trees import flatten_with_names
from deeplearning_cfn_tpu_torch.config import apply_overrides
from deeplearning_cfn_tpu_torch.convert import flax_layout, params_from_flax
from deeplearning_cfn_tpu_torch.data.pipeline import build_pipeline, to_device
from deeplearning_cfn_tpu_torch.models import build_model
from deeplearning_cfn_tpu_torch.presets import get_preset
from deeplearning_cfn_tpu_torch.train import optim as toptim
from deeplearning_cfn_tpu_torch.train.state import create_train_state
from deeplearning_cfn_tpu_torch.train.task import ClassificationTask, \
    build_task
from deeplearning_cfn_tpu_torch.train.trainer import Trainer

CPU = torch.device("cpu")
TINY = ["model.name=vit_tiny", "model.num_classes=10",
        "model.kwargs.dropout_rate=0.0", "data.image_size=16",
        "train.dtype=float32", "data.num_train_examples=80",
        "data.num_eval_examples=24", "train.eval_batch=16",
        "train.global_batch=16", "data.prefetch=0", "train.seed=0",
        "schedule.warmup_steps=2", "schedule.warmup_epochs=0",
        "schedule.base_lr=3e-3"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One worker's share of the cores (torch would start a thread per core
    in every pytest-xdist worker)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def _configs(extra=()):
    over = TINY + list(extra)
    return (apply_overrides(get_preset("imagenet_vit_s16"), over),
            j_overrides(j_preset("imagenet_vit_s16"), over))


@pytest.fixture(scope="module")
def jax_side():
    _, jcfg = _configs()
    task = JaxTask(jcfg)
    params = jax.jit(task.init)(jax.random.PRNGKey(0))["params"]
    flat = {n: np.asarray(v) for n, v in flatten_with_names(params)[0]}
    assert not flat["head/kernel"].any()  # Flax's zero head
    rng = np.random.RandomState(7)
    flat["head/kernel"] = rng.normal(0, 0.5, flat["head/kernel"].shape) \
        .astype(np.float32)
    flat["head/bias"] = rng.normal(0, 0.1, flat["head/bias"].shape) \
        .astype(np.float32)
    params = traverse_util.unflatten_dict(
        {tuple(n.split("/")): v for n, v in flat.items()})
    return jcfg, task, params, flat


def _port(flat, extra=()):
    cfg, _ = _configs(extra)
    task = build_task(cfg, CPU)
    assert isinstance(task, ClassificationTask) and task.stats_free
    task.model.load_state_dict(params_from_flax(flat), strict=True)
    return task


def _images(n=4, seed=1):
    return np.random.RandomState(seed).standard_normal((n, 16, 16, 3)) \
        .astype(np.float32)


@pytest.mark.parametrize("jax_impl", ["auto", "interpret"])
def test_vit_tiny_logits_match_jax(jax_side, jax_impl):
    _, _, params, flat = jax_side
    jm = j_build_model("vit_tiny", 10, jnp.float32, attention_impl=jax_impl)
    x = _images()
    want = np.asarray(jm.apply({"params": params}, x, train=False))
    task = _port(flat)
    with torch.no_grad():
        got = task.model(torch.from_numpy(x), train=False)
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_flax_layout_names_every_vit_s16_leaf():
    jm = j_build_model("vit_s16", 1000, jnp.bfloat16)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))
    want = {"params/" + n: tuple(v.shape)
            for n, v in flatten_with_names(shapes["params"])[0]}
    tm = build_model("vit_s16", 1000, torch.bfloat16, device="meta")
    got = {}
    for name, _, t, kind in flax_layout(tm):
        shape = tuple(t.shape)
        if kind == "dense":
            shape = shape[::-1]
        elif kind == "conv":
            shape = (shape[2], shape[3], shape[1], shape[0])
        got[name] = shape
    assert got == want
    assert want["params/pos_embed"] == (196, 384)
    assert sum(t.numel() for t in tm.parameters()) == \
        sum(int(np.prod(s)) for s in want.values())


def test_patch_tokens_follow_the_flax_order(jax_side):
    _, _, _, flat = jax_side
    task = _port(flat)
    x = _images(n=2, seed=4)
    seen = {}
    task.model.layer[0].register_forward_pre_hook(
        lambda mod, args: seen.update(x=args[0]))
    with torch.no_grad():
        task.model(torch.from_numpy(x), train=False)
    tokens = (seen["x"] - task.model.pos_embed[None]).detach()
    # Flax: conv on NHWC, then reshape(b, -1, D) — row-major over (h, w).
    k = flat["patch_embed/kernel"]                      # HWIO [4, 4, 3, 64]
    patches = x.reshape(2, 4, 4, 4, 4, 3).transpose(0, 1, 3, 2, 4, 5)
    want = patches.reshape(2, 16, 48) @ k.reshape(48, 64) \
        + flat["patch_embed/bias"]
    np.testing.assert_allclose(tokens.numpy(), want, rtol=0, atol=1e-5)
    swapped = want.reshape(2, 4, 4, 64).transpose(0, 2, 1, 3) \
        .reshape(2, 16, 64)
    assert np.abs(tokens.numpy() - swapped).max() > 1e-2


def test_gradients_match_jax_grad(jax_side):
    _, jtask, params, flat = jax_side
    rng = np.random.RandomState(5)
    b = {"image": _images(n=6, seed=5),
         "label": rng.randint(0, 10, 6).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jtask.loss_fn(p, {}, jb, None, True)[0]))(params)
    task = _port(flat)
    loss, aux = task.loss_fn(to_device(b, CPU), True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-5)
    want = params_from_flax({n: np.asarray(v) for n, v in
                             flatten_with_names(j_grads)[0]})
    scale = max(float(v.abs().max()) for v in want.values())
    named = dict(task.model.named_parameters())
    assert set(named) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(),
                                   rtol=0, atol=1e-4 * scale, err_msg=name)


def test_stats_free_task_dropout_and_init():
    task = _port_random(["model.kwargs.dropout_rate=0.1"])
    model = task.model
    assert not list(model.buffers())
    assert not model.head.weight.any() and not model.head.bias.any()
    assert 0.015 < float(model.pos_embed.detach().std()) < 0.025
    w = model.patch_embed.weight.detach()  # fan-in 4·4·3, truncated at ±2σ
    std = (1.0 / 48) ** 0.5
    assert float(w.abs().max()) <= 2.0 * std / 0.8796 + 1e-6
    assert abs(float(w.std()) - std) < 0.15 * std
    with torch.no_grad():  # a nonzero head, so the logits carry the noise
        model.head.weight.normal_(0, 0.5, generator=torch.Generator()
                                  .manual_seed(1))
    rng = np.random.RandomState(2)
    batch = to_device({"image": _images(n=8, seed=2),
                       "label": rng.randint(0, 10, 8).astype(np.int32)}, CPU)
    gen = lambda seed: torch.Generator().manual_seed(seed)
    with torch.no_grad():
        a = task.loss_fn(batch, True, gen(3))[0]
        b = task.loss_fn(batch, True, gen(3))[0]
        c = task.loss_fn(batch, True, gen(4))[0]
        e1 = task.loss_fn(batch, False)[0]
        e2 = task.loss_fn(batch, False)[0]
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert torch.equal(e1, e2) and not torch.equal(a, e1)
    with pytest.raises(ValueError, match="Generator"):
        task.loss_fn(batch, True)
    loss, _ = task.loss_fn(batch, True, gen(3))
    loss.backward()
    assert model.patch_embed.weight.grad.abs().max() > 0


def _port_random(extra):
    cfg, _ = _configs(extra)
    task = build_task(cfg, CPU)
    task.init(torch.Generator().manual_seed(0))
    return task


def test_training_trajectory_matches_jax():
    cfg, jcfg = _configs()
    assert cfg.optimizer.name == "adamw" and cfg.train.label_smoothing == 0.1
    assert cfg.optimizer.weight_decay == 0.05 \
        and cfg.optimizer.grad_clip_norm == 1.0
    batches = [b for _, b in zip(range(5), build_pipeline(
        cfg.data, 16, 10, seed=0).one_epoch())]
    eval_batches = list(build_pipeline(cfg.data, 16, 10, train=False,
                                       drop_remainder=False).one_epoch())
    mesh = build_mesh(MeshConfig(data=1, model=1), devices=jax.devices()[:1])
    jtask = JaxTask(jcfg)
    tx = joptim.build_optimizer(
        jcfg.optimizer, joptim.build_schedule(jcfg.schedule, 5, 16))
    jstate = j_create_state(jax.random.PRNGKey(0), jtask.init, tx, mesh)
    flat = {n: np.asarray(v) for n, v in
            flatten_with_names(jax.device_get(jstate.params))[0]}
    jtrainer = JaxTrainer(jcfg, jtask.loss_fn, tx, mesh=mesh, donate=False)
    j_losses = []
    for b in batches:
        jstate, m = jtrainer.train_step(jstate, jtrainer.device_batch(b),
                                        jax.random.PRNGKey(1))
        j_losses.append(float(m["loss"]))
    j_final = jtrainer.evaluate(jstate, iter(eval_batches))

    task = _port(flat)
    state = create_train_state(task.model, toptim.build_optimizer(
        cfg.optimizer, toptim.build_schedule(cfg.schedule, 5, 16),
        task.model))
    trainer = Trainer(cfg, task, CPU)
    t_losses = [float(trainer.train_step(state, to_device(b, CPU))["loss"])
                for b in batches]
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert t_losses[-1] < t_losses[0]
    want = params_from_flax({n: np.asarray(v) for n, v in
                             flatten_with_names(jstate.params)[0]})
    got = task.model.state_dict()
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    t_final = trainer.evaluate(state, iter(eval_batches))
    assert t_final["examples"] == j_final["examples"] == 24
    assert t_final["accuracy"] == j_final["accuracy"]
    assert t_final["accuracy_top5"] == j_final["accuracy_top5"]
    np.testing.assert_allclose(t_final["loss"], j_final["loss"], rtol=1e-4)
