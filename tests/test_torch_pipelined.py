"""The port's pipelined BERT (deeplearning_cfn_tpu_torch.models.pipelined,
``ops.pipeline``) against the JAX package's, on the CPU in f32.

- ``bert_pipelined`` at a tiny size (2 layers, hidden 32, vocab 64) from
  one Flax init carried by ``convert.params_from_flax`` (the stacked
  ``pipe_stack`` leaves untransposed): MLM and NSP logits within 1e-5 of
  the JAX module's plain scan; the task loss and every gradient against
  ``jax.grad`` of the JAX ``MlmTask`` running the GPipe schedule over a
  (data 2, pipe 2) mesh of fake CPU devices (loss within 1e-6 relative,
  gradients within 1e-4 of the largest entry);
- the stacked leaves decay as the JAX mask (``ndim > 1``) decays them: the
  port's decay group is the set of leaves JAX's ``_non_bn_mask`` marks,
  the stacked LayerNorm scales and biases included, and a 3-step LAMB
  trajectory with weight decay 0.1 ends within 1e-5 of JAX's;
- ``scan_layers`` equals a loop over the layers, forward and gradient;
  ``gpipe`` on one process (one stage, 4 microbatches) equals the scan,
  forward and gradient (``tests/test_torch_pipe_expert.py`` runs it across
  processes); dropout is refused;
- ``MlmTask`` builds the ``bert_pipelined_wikipedia`` preset (printing that
  ``n_microbatches`` and ``mesh.pipe`` are ignored on one device), and
  ``flax_layout`` names every leaf of the full-width model as the Flax tree
  does.

Inputs are numpy arrays made from seeds and handed to both packages.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_cfn_tpu.config import MeshConfig
from deeplearning_cfn_tpu.config import apply_overrides as j_overrides
from deeplearning_cfn_tpu.models import build_model as j_build_model
from deeplearning_cfn_tpu.parallel import build_mesh
from deeplearning_cfn_tpu.presets import get_preset as j_preset
from deeplearning_cfn_tpu.train import create_train_state as j_create_state
from deeplearning_cfn_tpu.train import optim as joptim
from deeplearning_cfn_tpu.train.task import MlmTask as JMlmTask
from deeplearning_cfn_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning_cfn_tpu.utils.trees import flatten_with_names
from deeplearning_cfn_tpu_torch.config import apply_overrides
from deeplearning_cfn_tpu_torch.convert import flax_layout, params_from_flax
from deeplearning_cfn_tpu_torch.data.pipeline import build_pipeline, to_device
from deeplearning_cfn_tpu_torch.data.text import make_mlm_source
from deeplearning_cfn_tpu_torch.models import build_model
from deeplearning_cfn_tpu_torch.ops.pipeline import gpipe, scan_layers
from deeplearning_cfn_tpu_torch.presets import get_preset
from deeplearning_cfn_tpu_torch.train import optim as toptim
from deeplearning_cfn_tpu_torch.train.state import create_train_state
from deeplearning_cfn_tpu_torch.train.task import MlmTask, build_task
from deeplearning_cfn_tpu_torch.train.trainer import Trainer

CPU = torch.device("cpu")
TINY = ["model.kwargs.hidden_size=32", "model.kwargs.num_layers=2",
        "model.kwargs.num_heads=2", "model.kwargs.mlp_dim=64",
        "model.kwargs.max_len=32", "model.kwargs.n_microbatches=2",
        "data.vocab_size=64", "data.seq_len=16", "train.dtype=float32",
        "data.num_train_examples=40", "data.num_eval_examples=12",
        "train.global_batch=8", "schedule.warmup_steps=2",
        "schedule.base_lr=5e-3", "optimizer.weight_decay=0.1"]
TINY_KW = dict(hidden_size=32, num_layers=2, num_heads=2, mlp_dim=64,
               max_len=32, vocab_size=64)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One worker's share of the cores (torch would start a thread per core
    in every pytest-xdist worker)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def _configs(mesh=None):
    over = TINY + ([f"mesh.data={mesh[0]}", f"mesh.pipe={mesh[1]}"]
                   if mesh else [])
    return (apply_overrides(get_preset("bert_pipelined_wikipedia"), over),
            j_overrides(j_preset("bert_pipelined_wikipedia"), over))


@pytest.fixture(scope="module")
def jax_side():
    jm = j_build_model("bert_pipelined", 2, jnp.float32, **TINY_KW)
    b = _batch()
    params = jm.init(jax.random.PRNGKey(0), *_inputs(b), train=False)[
        "params"]
    flat = {n: np.asarray(v) for n, v in flatten_with_names(params)[0]}
    return jm, params, flat


def _batch(n=8, seed=3):
    b = {k: v.copy() for k, v in make_mlm_source(n, 16, 64, seed)
         .arrays.items()}
    for row, length in ((1, 9), (4, 12)):
        b["input_ids"][row, length:] = 0
        b["input_mask"][row, length:] = 0
        b["mlm_positions"][row] = np.minimum(b["mlm_positions"][row],
                                             length - 1)
    return b


def _inputs(b):
    return (b["input_ids"], b["input_mask"], b["segment_ids"],
            b["mlm_positions"])


def _port(flat, capsys=None):
    cfg, _ = _configs()
    task = build_task(cfg, CPU)
    assert isinstance(task, MlmTask)
    task.model.load_state_dict(params_from_flax(flat), strict=True)
    return cfg, task


def test_logits_match_jax_plain_scan(jax_side):
    jm, params, flat = jax_side
    _, task = _port(flat)
    assert {n for n, _, _, _ in flax_layout(task.model)} == \
        {"params/" + n for n in flat}
    assert tuple(task.model.pipe_stack.w_in.shape) == \
        flat["pipe_stack/w_in"].shape == (2, 32, 64)
    b = _batch()
    want = jm.apply({"params": params}, *_inputs(b), train=False)
    with torch.no_grad():
        got = task.model(*_inputs(to_device(b, CPU)), train=False)
    for k in ("mlm_logits", "nsp_logits"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_loss_and_gradients_match_jax_gpipe(jax_side, devices):
    _, params, flat = jax_side
    _, jcfg = _configs(mesh=(2, 2))
    mesh = build_mesh(jcfg.mesh, devices=devices[:4])
    jtask = JMlmTask(jcfg, mesh=mesh)
    b = _batch(seed=5)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jtask.loss_fn(p, {}, jb, None, True)[0]))(params)
    _, task = _port(flat)
    loss, _ = task.loss_fn(to_device(b, CPU), True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-6)
    want = params_from_flax({n: np.asarray(v) for n, v in
                             flatten_with_names(j_grads)[0]})
    scale = max(float(v.abs().max()) for v in want.values())
    named = dict(task.model.named_parameters())
    assert set(named) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(),
                                   rtol=0, atol=1e-4 * scale, err_msg=name)


def test_stacked_leaves_decay_as_the_jax_mask(jax_side, devices):
    _, params, flat = jax_side
    cfg, jcfg = _configs()
    cfg_, task = _port(flat)
    opt = toptim.build_optimizer(cfg.optimizer, toptim.build_schedule(
        cfg.schedule, 3, 8), task.model)
    decays = {id(p) for g in opt.inner.param_groups
              if g["weight_decay"] > 0 for p in g["params"]}
    jmask = dict(flatten_with_names(joptim._non_bn_mask(params))[0])
    by_name = dict(task.model.named_parameters())
    for name, t_name in ((n, params_from_flax({n: flat[n]}).popitem()[0])
                         for n in flat):
        assert (id(by_name[t_name]) in decays) == bool(jmask[name]), name
    assert jmask["pipe_stack/ln1_s"] and jmask["pipe_stack/b_in"]
    assert not jmask["mlm_bias"]

    batches = [b for _, b in zip(range(3), build_pipeline(
        cfg.data, 8, seed=0).one_epoch())]
    mesh = build_mesh(MeshConfig(data=1, model=1), devices=devices[:1])
    jtask = JMlmTask(jcfg, mesh=mesh)
    tx = joptim.build_optimizer(
        jcfg.optimizer, joptim.build_schedule(jcfg.schedule, 3, 8))
    jstate = j_create_state(jax.random.PRNGKey(0), jtask.init, tx, mesh)
    jstate = jstate.replace(params=params, opt_state=tx.init(params))
    jtrainer = JaxTrainer(jcfg, jtask.loss_fn, tx, mesh=mesh, donate=False)
    for b in batches:
        jstate, _ = jtrainer.train_step(jstate, jtrainer.device_batch(b),
                                        jax.random.PRNGKey(1))
    state = create_train_state(task.model, opt)
    trainer = Trainer(cfg, task, CPU)
    for b in batches:
        trainer.train_step(state, to_device(b, CPU))
    want = params_from_flax({n: np.asarray(v) for n, v in
                             flatten_with_names(jstate.params)[0]})
    got = task.model.state_dict()
    # The key projections' biases (``bk``, true gradient 0) by the other
    # leaves only, as tests/test_torch_mlm.py leaves them out.
    for name, value in want.items():
        if name.endswith("pipe_stack.bk"):
            continue
        np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_scan_layers_equals_a_loop():
    rng = np.random.RandomState(0)
    stack = {"w": torch.tensor(rng.normal(0, 0.5, (3, 4, 4)),
                               dtype=torch.float32, requires_grad=True),
             "b": torch.tensor(rng.normal(0, 0.5, (3, 4)),
                               dtype=torch.float32, requires_grad=True)}
    layer = lambda p, h: torch.tanh(h @ p["w"] + p["b"])
    x = torch.tensor(rng.normal(0, 1, (2, 4)), dtype=torch.float32)
    got = scan_layers(layer)(stack, x)
    want = x
    for i in range(3):
        want = layer({"w": stack["w"][i], "b": stack["b"][i]}, want)
    assert torch.equal(got, want)
    g_got = torch.autograd.grad(got.sum(), list(stack.values()))
    g_want = torch.autograd.grad(want.sum(), list(stack.values()))
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_gpipe_raises_and_dropout_is_refused():
    from deeplearning_cfn_tpu_torch.parallel.mesh import build_mesh as \
        t_build_mesh

    rng = np.random.RandomState(1)
    stack = {"w": torch.tensor(rng.normal(0, 0.5, (3, 4, 4)),
                               dtype=torch.float32, requires_grad=True),
             "b": torch.tensor(rng.normal(0, 0.5, (3, 4)),
                               dtype=torch.float32, requires_grad=True)}
    stage = scan_layers(lambda p, st: {"h": torch.tanh(st["h"] @ p["w"]
                                                       + p["b"])})
    x = torch.tensor(rng.normal(0, 1, (8, 4)), dtype=torch.float32)
    mesh = t_build_mesh(num_processes=1)
    got = gpipe(stage, stack, {"h": x}, mesh=mesh, n_microbatches=4)["h"]
    want = stage(stack, {"h": x})["h"]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    g_got = torch.autograd.grad(got.sum(), list(stack.values()))
    g_want = torch.autograd.grad(want.sum(), list(stack.values()))
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="microbatches"):
        gpipe(stage, stack, {"h": x}, mesh=mesh, n_microbatches=3)
    with pytest.raises(ValueError, match="dropout"):
        build_model("bert_pipelined", 2, torch.float32, dropout_rate=0.1,
                    **TINY_KW)


def test_mlm_task_builds_the_full_preset(capsys):
    cfg = apply_overrides(get_preset("bert_pipelined_wikipedia"), [])
    task = build_task(cfg, torch.device("meta"))
    assert isinstance(task, MlmTask)
    out = capsys.readouterr().out
    assert "n_microbatches=8" in out and "mesh.pipe=4" in out
    jm = j_build_model("bert_pipelined", 2, jnp.bfloat16)
    s, p = 128, 25
    ids = jnp.zeros((1, s), jnp.int32)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), ids, jnp.ones((1, s), jnp.int32), ids,
        jnp.zeros((1, p), jnp.int32), train=False))
    want = {"params/" + n: tuple(v.shape)
            for n, v in flatten_with_names(shapes["params"])[0]}
    got = {name: tuple(t.shape)[::-1] if kind == "dense" else tuple(t.shape)
           for name, _, t, kind in flax_layout(task.model)}
    assert got == want
    assert want["params/pipe_stack/wq"] == (12, 768, 768)
