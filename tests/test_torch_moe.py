"""The port's Mixture-of-Experts FFNs (deeplearning_cfn_tpu_torch.models.moe
and the MoE trunks of BERT and GPT) against the JAX package's, on the CPU
in f32.

- ``router_assignment``: dispatch equal and combine within 1e-7 of JAX's on
  seeded router probabilities, at capacities that drop tokens, top-1 and
  top-2; a hand case pins first-choice priority (a second choice only gets
  what first choices left) and the first-index tie break;
- ``MoeMlp``: output within 1e-5 of the largest entry and both aux losses
  within 1e-6 relative, from one Flax init, with tokens dropped;
- tiny BERT-MoE (``bert_tiny``, 2 layers, layer 1 MoE) and GPT-MoE
  (``gpt_tiny``): logits and aux losses, the task losses with the ST-MoE
  weights (``MlmTask``, ``CausalLmTask``: train and eval, metrics
  included), every gradient within 1e-4 of the largest entry;
- a 5-step trajectory of the ``bert_moe_wikipedia`` recipe (LAMB behind the
  1.0 clip) on the tiny BERT-MoE, the port's ``Trainer`` against the JAX
  ``Trainer``: losses within 1e-5 relative;
- greedy ``lm_generate`` on the tiny GPT-MoE: token-identical to JAX's.

The tiny models run at capacity factor 0.5, so every MoE layer drops
tokens. Routing is an argmax, so a router margin (top-1 against top-2, or
top-2 against top-3) within f32 rounding would send a token to another
expert in one package: that is a rounding tie, not a fault. Each test
asserts that no margin of its inputs lies within 1e-6 (``_margin``), on
weights from the init seeds chosen for that (``WEIGHT_SEED``).

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
from deeplearning_cfn_tpu.models.decoding import lm_generate as j_generate
from deeplearning_cfn_tpu.models.moe import MoeMlp as JMoeMlp
from deeplearning_cfn_tpu.models.moe import \
    router_assignment as j_router_assignment
from deeplearning_cfn_tpu.parallel import build_mesh
from deeplearning_cfn_tpu.presets import get_preset as j_preset
from deeplearning_cfn_tpu.train import create_train_state as j_create_state
from deeplearning_cfn_tpu.train import optim as joptim
from deeplearning_cfn_tpu.train.task import CausalLmTask as JLmTask
from deeplearning_cfn_tpu.train.task import MlmTask as JMlmTask
from deeplearning_cfn_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning_cfn_tpu.utils.trees import flatten_with_names
from deeplearning_cfn_tpu_torch.config import apply_overrides
from deeplearning_cfn_tpu_torch.convert import flax_layout, params_from_flax
from deeplearning_cfn_tpu_torch.data.pipeline import build_pipeline, to_device
from deeplearning_cfn_tpu_torch.data.text import make_lm_source, \
    make_mlm_source
from deeplearning_cfn_tpu_torch.models import build_model
from deeplearning_cfn_tpu_torch.models.decoding import lm_generate
from deeplearning_cfn_tpu_torch.models.moe import MoeMlp, router_assignment
from deeplearning_cfn_tpu_torch.presets import get_preset
from deeplearning_cfn_tpu_torch.train import optim as toptim
from deeplearning_cfn_tpu_torch.train.state import create_train_state
from deeplearning_cfn_tpu_torch.train.task import (
    MOE_LOAD_BALANCE_WEIGHT, MOE_ROUTER_Z_WEIGHT, CausalLmTask, MlmTask,
    build_task)
from deeplearning_cfn_tpu_torch.train.trainer import Trainer

CPU = torch.device("cpu")
# Init seeds whose routers keep every margin of these tests' inputs above
# 1e-6 (each test asserts it).
WEIGHT_SEED = {"bert": 0, "gpt": 0, "mlp": 0}
MOE = ["model.kwargs.num_experts=4", "model.kwargs.moe_every=2",
       "model.kwargs.moe_top_k=2", "model.kwargs.moe_capacity_factor=0.5"]
BERT_TINY = ["model.name=bert_tiny", "model.kwargs.hidden_size=32",
             "model.kwargs.num_layers=2", "model.kwargs.num_heads=2",
             "model.kwargs.mlp_dim=64", "model.kwargs.max_len=32",
             "model.kwargs.dropout_rate=0.0", "data.vocab_size=64",
             "data.seq_len=16", "train.dtype=float32",
             "data.num_train_examples=40", "data.num_eval_examples=12",
             "train.global_batch=8", "schedule.warmup_steps=2",
             "schedule.base_lr=5e-3"] + MOE
GPT_TINY = ["model.name=gpt_tiny", "model.kwargs.max_len=32",
            "model.kwargs.dropout_rate=0.0", "data.vocab_size=512",
            "data.seq_len=16", "train.dtype=float32"] + MOE


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One worker's share of the cores (torch would start a thread per core
    in every pytest-xdist worker)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def _margin(model, *inputs, **kw) -> float:
    """The smallest router margin of ``model`` on ``inputs``: over every
    token of every MoE layer, top-1 minus top-2 and top-2 minus top-3 of
    the router probabilities."""
    seen = []
    hooks = [m.router.register_forward_hook(
        lambda mod, args, out: seen.append(torch.softmax(out, -1)))
        for m in model.modules() if isinstance(m, MoeMlp)]
    try:
        with torch.no_grad():
            model(*inputs, **kw)
    finally:
        for h in hooks:
            h.remove()
    assert seen, "no MoE layer ran"
    top = torch.cat([p.flatten(0, -2) for p in seen]).topk(3, dim=-1).values
    return float(torch.minimum(top[:, 0] - top[:, 1],
                               top[:, 1] - top[:, 2]).min())


# -- routing ------------------------------------------------------------------


@pytest.mark.parametrize("capacity,top_k", [(2, 1), (3, 2), (5, 2), (40, 2)])
def test_router_assignment_matches_jax(capacity, top_k):
    logits = np.random.RandomState(capacity).standard_normal((3, 16, 6))
    probs = np.array(jax.nn.softmax(logits.astype(np.float32)))
    want_d, want_c = j_router_assignment(jnp.asarray(probs), capacity, top_k)
    got_d, got_c = router_assignment(torch.from_numpy(probs), capacity,
                                     top_k)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=1e-7)
    kept = got_d.sum(dim=(2, 3))  # choices kept per token
    assert int(kept.max()) <= top_k
    if capacity * 6 < 16 * top_k:  # fewer slots than choices: drops
        assert int(kept.sum()) < 3 * 16 * top_k
    # Every slot holds at most one token.
    assert float(got_d.sum(dim=1).max()) <= 1.0


def test_router_first_choice_priority_and_ties():
    # 3 tokens, 2 experts, capacity 2. Tokens 0 and 2 choose expert 0
    # first, token 1 expert 1. Their second choices come after every first
    # choice: token 1's second choice (expert 0) finds expert 0 full.
    # Token 2's probabilities tie: the first index (expert 0) wins.
    probs = torch.tensor([[[0.7, 0.3], [0.4, 0.6], [0.5, 0.5]]])
    dispatch, combine = router_assignment(probs, 2, 2)
    slots = {(s, e): int(torch.nonzero(dispatch[0, s, e]).flatten()[0])
             for s in range(3) for e in range(2)
             if dispatch[0, s, e].sum() > 0}
    assert slots == {(0, 0): 0, (2, 0): 1, (1, 1): 0, (0, 1): 1}
    # Kept gates renormalise over the token's chosen experts; token 1's
    # dropped second choice leaves its first at weight 0.6 / 1.0.
    assert torch.allclose(combine[0, 0, 0, 0], torch.tensor(0.7))
    assert torch.allclose(combine[0, 1, 1, 0], torch.tensor(0.6))
    want_d, want_c = j_router_assignment(jnp.asarray(probs.numpy()), 2, 2)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(want_d))
    np.testing.assert_allclose(combine.numpy(), np.asarray(want_c),
                               atol=1e-7)


def test_moe_mlp_matches_jax():
    jm = JMoeMlp(num_experts=4, mlp_dim=24, capacity_factor=0.75, top_k=2,
                 dtype=jnp.float32)
    x = np.random.RandomState(1).standard_normal((2, 12, 16)) \
        .astype(np.float32)
    params = jm.init(jax.random.PRNGKey(WEIGHT_SEED["mlp"]), x)["params"]
    flat = {n: np.asarray(v) * 4.0 for n, v in
            flatten_with_names(params)[0]}
    want, want_aux = jm.apply(
        {"params": traverse_util.unflatten_dict(
            {tuple(k.split("/")): v for k, v in flat.items()})}, x)
    tm = MoeMlp(16, 4, 24, capacity_factor=0.75, top_k=2,
                dtype=torch.float32)
    tm.load_state_dict(params_from_flax(flat), strict=True)
    assert tm.capacity(12) == 4  # int(2 * 12 / 4 * 0.75): drops
    xt = torch.from_numpy(x)
    assert _margin(tm, xt) > 1e-6
    with torch.no_grad():
        got, aux = tm(xt)
        dispatch = tm.route(xt)[2]
    assert float(dispatch.sum()) < 2 * 12 * 2  # some choices dropped
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(want).max())
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux[k]), float(want_aux[k]),
                                   rtol=1e-6, err_msg=k)


# -- the MoE trunks -------------------------------------------------------------


def _jax_init(task, seed):
    params = jax.jit(task.init)(jax.random.PRNGKey(seed))["params"]
    return params, {n: np.asarray(v) for n, v in
                    flatten_with_names(params)[0]}


@pytest.fixture(scope="module")
def bert():
    jcfg = j_overrides(j_preset("bert_moe_wikipedia"), BERT_TINY)
    jtask = JMlmTask(jcfg)
    params, flat = _jax_init(jtask, WEIGHT_SEED["bert"])
    return jcfg, jtask, params, flat


def _bert_port(flat, over=()):
    cfg = apply_overrides(get_preset("bert_moe_wikipedia"),
                          BERT_TINY + list(over))
    task = build_task(cfg, CPU)
    assert isinstance(task, MlmTask)
    task.model.load_state_dict(params_from_flax(flat), strict=True)
    return cfg, task


def _mlm_batch(n=6, seed=3):
    b = {k: v.copy() for k, v in make_mlm_source(n, 16, 64, seed)
         .arrays.items()}
    b["input_ids"][1, 9:] = 0
    b["input_mask"][1, 9:] = 0
    b["mlm_positions"][1] = np.minimum(b["mlm_positions"][1], 8)
    b["eval_mask"] = (np.arange(n) < 5).astype(np.float32)
    return b


def _mlm_inputs(t):
    return (t["input_ids"], t["input_mask"], t["segment_ids"],
            t["mlm_positions"])


def test_bert_moe_layout_and_logits_match_jax(bert):
    jcfg, jtask, params, flat = bert
    _, task = _bert_port(flat)
    names = {n for n, _, _, _ in flax_layout(task.model)}
    assert names == {"params/" + n for n in flat}
    assert "params/encoder/layer_1/moe_mlp/router/kernel" in names
    assert "params/encoder/layer_0/mlp/mlp_in/kernel" in names
    b = _mlm_batch()
    t = to_device(b, CPU)
    assert _margin(task.model, *_mlm_inputs(t), train=False) > 1e-6
    want = jtask.model.apply({"params": params}, b["input_ids"],
                             b["input_mask"], b["segment_ids"],
                             b["mlm_positions"], train=False)
    with torch.no_grad():
        got = task.model(*_mlm_inputs(t), train=False)
    assert sorted(got) == sorted(want) == [
        "mlm_logits", "moe_load_balance", "moe_router_z", "nsp_logits"]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("train", [True, False])
def test_mlm_task_moe_loss_matches_jax(bert, train):
    _, jtask, params, flat = bert
    _, task = _bert_port(flat)
    b = _mlm_batch()
    j_loss, j_aux = jtask.loss_fn(params, {}, {k: jnp.asarray(v) for k, v
                                               in b.items()}, None, train)
    with torch.no_grad():
        loss, aux = task.loss_fn(to_device(b, CPU), train)
    j_aux.pop("batch_stats", None)
    assert set(aux) == set(j_aux)
    assert {"moe_load_balance", "moe_router_z"} <= set(aux)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-6)
    for k, v in j_aux.items():
        np.testing.assert_allclose(float(aux[k]), float(v), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    # The objective is the two CEs plus the weighted aux losses.
    np.testing.assert_allclose(
        float(loss), float(aux["mlm_loss"] + aux["nsp_loss"]
                           + MOE_LOAD_BALANCE_WEIGHT * aux["moe_load_balance"]
                           + MOE_ROUTER_Z_WEIGHT * aux["moe_router_z"]),
        rtol=1e-6)


def _assert_grads_match(task, want):
    scale = max(float(v.abs().max()) for v in want.values())
    named = dict(task.model.named_parameters())
    assert set(named) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(),
                                   rtol=0, atol=1e-4 * scale, err_msg=name)
    router = [n for n in named if n.endswith("router.weight")]
    assert router and all(named[n].grad.abs().max() > 0 for n in router)


def test_bert_moe_gradients_match_jax_grad(bert):
    _, jtask, params, flat = bert
    b = _mlm_batch(n=8, seed=5)
    del b["eval_mask"]
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jtask.loss_fn(p, {}, jb, None, True)[0]))(params)
    _, task = _bert_port(flat)
    t = to_device(b, CPU)
    assert _margin(task.model, *_mlm_inputs(t), train=False) > 1e-6
    loss, _ = task.loss_fn(t, True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-6)
    _assert_grads_match(task, params_from_flax(
        {n: np.asarray(v) for n, v in flatten_with_names(j_grads)[0]}))


def test_bert_moe_trajectory_matches_jax(bert):
    jcfg, jtask, params, flat = bert
    cfg, task = _bert_port(flat)
    assert cfg.optimizer.name == "lamb" and cfg.optimizer.grad_clip_norm == 1
    batches = [b for _, b in zip(range(5), build_pipeline(
        cfg.data, 8, seed=0).one_epoch())]
    mesh = build_mesh(MeshConfig(data=1, model=1), devices=jax.devices()[:1])
    tx = joptim.build_optimizer(
        jcfg.optimizer, joptim.build_schedule(jcfg.schedule, 5, 8))
    jstate = j_create_state(jax.random.PRNGKey(0), jtask.init, tx, mesh)
    jstate = jstate.replace(params=params, opt_state=tx.init(params))
    jtrainer = JaxTrainer(jcfg, jtask.loss_fn, tx, mesh=mesh, donate=False)
    j_losses = []
    for b in batches:
        jstate, m = jtrainer.train_step(jstate, jtrainer.device_batch(b),
                                        jax.random.PRNGKey(1))
        j_losses.append(float(m["loss"]))
    state = create_train_state(task.model, toptim.build_optimizer(
        cfg.optimizer, toptim.build_schedule(cfg.schedule, 5, 8),
        task.model))
    trainer = Trainer(cfg, task, CPU)
    t_losses = []
    for b in batches:
        t = to_device(b, CPU)
        assert _margin(task.model, *_mlm_inputs(t), train=False) > 1e-6
        t_losses.append(float(trainer.train_step(state, t)["loss"]))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert t_losses[-1] < t_losses[0]


@pytest.fixture(scope="module")
def gpt():
    jcfg = j_overrides(j_preset("gpt_small_lm"), GPT_TINY)
    jtask = JLmTask(jcfg)
    params, flat = _jax_init(jtask, WEIGHT_SEED["gpt"])
    # Dense kernels and expert weights ×3, so greedy decoding does not
    # repeat one token (tests/test_torch_lm.py).
    flat = {n: v * (3.0 if n.endswith(("kernel", "w_in", "w_out")) else 1.0)
            for n, v in flat.items()}
    params = traverse_util.unflatten_dict(
        {tuple(n.split("/")): v for n, v in flat.items()})
    return jcfg, jtask, params, flat


def _gpt_port(flat):
    cfg = apply_overrides(get_preset("gpt_small_lm"), GPT_TINY)
    task = build_task(cfg, CPU)
    assert isinstance(task, CausalLmTask)
    task.model.load_state_dict(params_from_flax(flat), strict=True)
    return task


def _lm_batch(n=4, seed=3):
    b = {k: v.copy() for k, v in make_lm_source(n, 16, 512, seed)
         .arrays.items()}
    b["loss_mask"][1, 9:] = 0.0
    return b


@pytest.mark.parametrize("train", [True, False])
def test_causal_lm_task_moe_loss_matches_jax(gpt, train):
    _, jtask, params, flat = gpt
    task = _gpt_port(flat)
    b = _lm_batch()
    t = to_device(b, CPU)
    assert _margin(task.model, t["tokens"][:, :-1]) > 1e-6
    j_loss, j_aux = jtask.loss_fn(params, {}, {k: jnp.asarray(v) for k, v
                                               in b.items()}, None, train)
    with torch.no_grad():
        loss, aux = task.loss_fn(t, train)
    want = {k: float(v) for k, v in j_aux.items() if k != "batch_stats"}
    assert sorted(aux) == sorted(want)
    assert {"moe_load_balance", "moe_router_z"} <= set(aux)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    for k, v in want.items():
        np.testing.assert_allclose(float(aux[k]), v, rtol=1e-5, err_msg=k)
    # The perplexity is the cross-entropy's alone.
    ce = float(loss) - MOE_LOAD_BALANCE_WEIGHT * want["moe_load_balance"] \
        - MOE_ROUTER_Z_WEIGHT * want["moe_router_z"]
    key = "perplexity" if train else "ce_loss"
    np.testing.assert_allclose(
        float(aux[key]), np.exp(ce) if train else ce, rtol=1e-5)


def test_gpt_moe_gradients_match_jax_grad(gpt):
    _, jtask, params, flat = gpt
    b = _lm_batch(seed=5)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jtask.loss_fn(p, {}, jb, None, True)[0]))(params)
    task = _gpt_port(flat)
    t = to_device(b, CPU)
    assert _margin(task.model, t["tokens"][:, :-1]) > 1e-6
    loss, _ = task.loss_fn(t, True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-5)
    _assert_grads_match(task, params_from_flax(
        {n: np.asarray(v) for n, v in flatten_with_names(j_grads)[0]}))


def test_gpt_moe_greedy_generation_matches_jax(gpt):
    jcfg, _, params, flat = gpt
    task = _gpt_port(flat)
    jm = j_build_model("gpt_tiny", 0, jnp.float32, vocab_size=512,
                       max_len=32, num_experts=4, moe_every=2, moe_top_k=2,
                       moe_capacity_factor=0.5)
    prompt = np.array([[5, 9, 3, 11], [1, 2, 7, 300]], np.int32)
    want = np.asarray(j_generate(jm, {"params": params}, jnp.asarray(prompt),
                                 10))
    # A decode step routes one token: each chosen expert has its one slot.
    assert task.model.layer[1].moe_mlp.capacity(1) == 1
    got = lm_generate(task.model, torch.from_numpy(prompt).long(), 10)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(got[:, 4:].flatten().tolist())) > 2, "degenerate model"
    with pytest.raises(ValueError, match="top_k"):
        build_model("gpt_tiny", 0, torch.float32, num_experts=2, moe_top_k=3)
