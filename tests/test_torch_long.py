"""The port's long-context trunks on one process (``bert_long``:
``models/bert_long.py``; ``gpt_long``: ``models/lm.py:LongCausalLm``)
against the JAX package's, on the CPU in f32 at a tiny size (vocab 64,
hidden 32, 2 layers, 4 heads, sequence 32), inputs from numpy seeds.

With one process the ``seq`` axis is 1, so every attention is the port's
``fused_attention`` (the flash kernels on the card, the plain version
here) and JAX's the plain XLA attention (``SeqParallelAttention`` falls
back to it on a mesh without ``seq``).

- from one Flax init carried by ``convert.params_from_flax``: LongBert's
  MLM and NSP logits and LongCausalLm's logits within 1e-5 of the largest
  logit, and the gradients of a seeded projection of them within 1e-4 of
  the global gradient norm (the bounds of ``tests/test_torch_lm.py`` and
  ``tests/test_torch_bert.py``);
- ``convert.flax_layout`` names every leaf of the full-width presets'
  trees as Flax does (JAX's flat root names ``embed``, ``layer_{i}_*``,
  ``token``, ``position``...), and the tiny trees cross both ways;
- the presets ``bert_long_wikipedia`` (LAMB) and ``gpt_long_lm`` (AdamW,
  ``grad_accum_steps=2``) cut to the tiny size: three trainer steps against
  the JAX ``Trainer``'s losses (1e-4 relative), with checkpoints crossing
  both ways at step 2 (each package continues the other's);
- greedy ``gpt_long`` generation (recompute mode: no decode step)
  token-identical to JAX's ``lm_generate``;
- on a mesh with ``seq`` > 1 (resolved for 4 processes, no group made) an
  unknown ``seq_impl`` raises ``KeyError`` and Ulysses with heads that do
  not divide raises ``ValueError``, as the JAX modules do, before any
  collective.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from deeplearning_cfn_tpu.ckpt import restore_checkpoint as j_restore
from deeplearning_cfn_tpu.ckpt import save_checkpoint as j_save
from deeplearning_cfn_tpu.config import MeshConfig as JMeshConfig
from deeplearning_cfn_tpu.config import apply_overrides as j_overrides
from deeplearning_cfn_tpu.models import build_model as j_build_model
from deeplearning_cfn_tpu.models.decoding import lm_generate as j_generate
from deeplearning_cfn_tpu.parallel import build_mesh as j_build_mesh
from deeplearning_cfn_tpu.presets import get_preset as j_preset
from deeplearning_cfn_tpu.train import create_train_state as j_create_state
from deeplearning_cfn_tpu.train import optim as joptim
from deeplearning_cfn_tpu.train.task import build_task as j_build_task
from deeplearning_cfn_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning_cfn_tpu.utils.trees import flatten_with_names
from deeplearning_cfn_tpu_torch.ckpt import restore_checkpoint, \
    save_checkpoint
from deeplearning_cfn_tpu_torch.config import MeshConfig, apply_overrides
from deeplearning_cfn_tpu_torch.convert import flax_layout, \
    params_from_flax, to_flax
from deeplearning_cfn_tpu_torch.data.pipeline import build_pipeline, \
    to_device
from deeplearning_cfn_tpu_torch.models import build_model
from deeplearning_cfn_tpu_torch.models.bert_long import LongBert
from deeplearning_cfn_tpu_torch.models.decoding import lm_generate
from deeplearning_cfn_tpu_torch.models.lm import LongCausalLm
from deeplearning_cfn_tpu_torch.parallel import build_mesh
from deeplearning_cfn_tpu_torch.presets import get_preset
from deeplearning_cfn_tpu_torch.train import optim as toptim
from deeplearning_cfn_tpu_torch.train.state import create_train_state
from deeplearning_cfn_tpu_torch.train.task import build_task
from deeplearning_cfn_tpu_torch.train.trainer import Trainer

VOCAB, HIDDEN, LAYERS, HEADS, MLP, SEQ = 64, 32, 2, 4, 64, 32
TINY = dict(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=LAYERS,
            num_heads=HEADS, mlp_dim=MLP, max_len=SEQ)
PREDICTIONS = 6


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One worker's share of the cores (torch would start a thread per core
    in every pytest-xdist worker)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def _bert_inputs(seed, b=3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (b, SEQ)).astype(np.int32)
    segments = (np.arange(SEQ)[None, :] >= rng.randint(4, SEQ - 4, (b, 1))) \
        .astype(np.int32)
    positions = np.stack([rng.choice(SEQ, PREDICTIONS, replace=False)
                          for _ in range(b)]).astype(np.int32)
    return ids, np.ones_like(ids), segments, positions


def _gpt_inputs(seed, b=3):
    return (np.random.RandomState(seed).randint(0, VOCAB, (b, SEQ))
            .astype(np.int32),)


FAMILIES = {
    # name: (JAX init inputs, JAX apply, port call, output keys)
    "bert_long": (_bert_inputs,
                  lambda m, v, xs: m.apply(v, *xs, train=False),
                  lambda m, xs: m(*xs, train=False),
                  ("mlm_logits", "nsp_logits")),
    "gpt_long": (_gpt_inputs,
                 lambda m, v, xs: {"logits": m.apply(v, *xs, train=False)},
                 lambda m, xs: {"logits": m(*xs, train=False)},
                 ("logits",)),
}


def _pair(name, scale=1.0):
    """The JAX module and its Flax init (Dense kernels times ``scale``),
    and the port's model carrying the same weights."""
    inputs = FAMILIES[name][0](0)
    jm = j_build_model(name, 2 if name == "bert_long" else 0, jnp.float32,
                       **TINY)
    params = jm.init(jax.random.PRNGKey(0), *inputs, train=False)["params"]
    flat = {n: np.asarray(x) * (scale if n.endswith("kernel") else 1.0)
            for n, x in flatten_with_names(params)[0]}
    params = traverse_util.unflatten_dict(
        {tuple(n.split("/")): x for n, x in flat.items()})
    tm = build_model(name, 2 if name == "bert_long" else 0, torch.float32,
                     **TINY)
    tm.load_state_dict(params_from_flax(flat), strict=True)
    return jm, {"params": params}, tm, flat


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_logits_and_gradients_match_jax(name):
    make, j_apply, t_call, keys = FAMILIES[name]
    jm, v, tm, _ = _pair(name)
    xs = make(1)
    want = j_apply(jm, v, xs)
    got = t_call(tm, [torch.from_numpy(x).long() for x in xs])
    for k in keys:
        w = np.asarray(want[k])
        assert got[k].dtype == torch.float32 and got[k].shape == w.shape
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
    # Gradients of a seeded projection of every output.
    rng = np.random.RandomState(2)
    proj = {k: rng.standard_normal(np.shape(want[k])).astype(np.float32)
            for k in keys}

    def j_loss(p):
        out = j_apply(jm, {"params": p}, xs)
        return sum(jnp.sum(out[k] * proj[k]) for k in keys)

    j_grads = {n: np.asarray(g) for n, g in flatten_with_names(
        jax.grad(j_loss)(v["params"]))[0]}
    loss = sum((got[k] * torch.from_numpy(proj[k])).sum() for k in keys)
    loss.backward()
    norm = np.sqrt(sum((g ** 2).sum() for g in j_grads.values()))
    assert norm > 0
    for flax_name, _, t, kind in flax_layout(tm):
        g = to_flax(t.grad.numpy(), kind)
        want_g = j_grads[flax_name[len("params/"):]]
        err = np.linalg.norm(g - want_g) / norm
        assert err <= 1e-4, (flax_name, err)


@pytest.mark.parametrize("preset,name", [("bert_long_wikipedia",
                                          "bert_long"),
                                         ("gpt_long_lm", "gpt_long")])
def test_flax_layout_names_every_leaf_of_the_presets(preset, name):
    kw = dict(get_preset(preset).model.kwargs)
    kw.pop("seq_impl")
    jm = j_build_model(name, 2 if name == "bert_long" else 0, jnp.bfloat16,
                       **kw)
    inputs = FAMILIES[name][0](0, b=1)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), *(jnp.asarray(x) for x in inputs),
        train=False))["params"]
    want = {"params/" + n: tuple(x.shape)
            for n, x in flatten_with_names(shapes)[0]}
    tm = build_model(name, 2 if name == "bert_long" else 0, torch.bfloat16,
                     device="meta", **kw)
    got = {}
    for flax_name, _, t, kind in flax_layout(tm):
        shape = tuple(t.shape)
        got[flax_name] = shape[::-1] if kind == "dense" else shape
    assert got == want
    assert "params/layer_11_self_attn/query/kernel" in got
    assert sum(np.prod(s) for s in got.values()) == \
        sum(p.numel() for p in tm.parameters())


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_weights_cross_both_ways(name):
    _, _, tm, flat = _pair(name)
    back = {n[len("params/"):]: to_flax(t.detach().numpy(), kind)
            for n, _, t, kind in flax_layout(tm)}
    assert set(back) == set(flat)
    for n, x in flat.items():
        np.testing.assert_array_equal(back[n], x, err_msg=n)
    assert isinstance(tm, LongBert if name == "bert_long" else LongCausalLm)


def test_gpt_long_greedy_generation_matches_jax_lm_generate():
    jm, v, tm, _ = _pair("gpt_long", scale=3.0)
    assert not hasattr(type(tm), "decode_step")  # recompute mode
    prompt = np.array([[5, 9, 3, 11], [1, 2, 7, 30]], np.int32)
    want = np.asarray(j_generate(jm, v, jnp.asarray(prompt), 12))
    with torch.no_grad():
        got = lm_generate(tm, torch.from_numpy(prompt).long(), 12)
    assert got.shape == (2, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(got[:, 4:].flatten().tolist())) > 2, "degenerate model"


# -- the presets through the trainers, and their checkpoints -------------------

TRAIN = {
    "bert_long_wikipedia": [
        "data.num_train_examples=40", "data.num_eval_examples=16",
        "train.global_batch=8", "schedule.warmup_steps=2",
        "schedule.base_lr=5e-3"],
    "gpt_long_lm": [
        "data.num_train_examples=40", "data.num_eval_examples=16",
        "train.global_batch=8", "schedule.warmup_steps=2",
        "schedule.base_lr=3e-3"],
}
STEPS = 3


def _overrides(preset):
    return [f"model.kwargs.{k}={v}" for k, v in TINY.items()
            if k != "vocab_size"] + [
        f"data.vocab_size={VOCAB}", f"data.seq_len={SEQ}",
        "train.dtype=float32"] + TRAIN[preset]


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
        task.model, cfg.train.shard_opt_state)
    return create_train_state(task.model, opt), Trainer(cfg, task, dev)


def _port_steps(trainer, state, batches):
    return [float(trainer.train_step(state, to_device(b, trainer.device))
                  ["loss"]) for b in batches]


@pytest.mark.parametrize("preset", sorted(TRAIN))
def test_trainer_steps_and_checkpoints_cross_with_jax(tmp_path, preset):
    over = _overrides(preset)
    cfg = apply_overrides(get_preset(preset), over)
    # JAX on one device: the preset's seq axis collapsed (mesh.seq=1), so
    # its trunk takes the plain attention, as the port's does on one
    # process.
    jcfg = j_overrides(j_preset(preset), over + ["mesh.seq=1"])
    mesh = j_build_mesh(JMeshConfig(data=1), devices=jax.devices()[:1])
    batches = [b for _, b in zip(range(STEPS), build_pipeline(
        cfg.data, cfg.train.global_batch, cfg.model.num_classes,
        seed=0).one_epoch())]

    task = j_build_task(jcfg, mesh=mesh)
    tx = joptim.build_optimizer(jcfg.optimizer, joptim.build_schedule(
        jcfg.schedule, STEPS, jcfg.train.global_batch))
    jstate = j_create_state(jax.random.PRNGKey(0), task.init, tx, mesh,
                            shard_opt_state=jcfg.train.shard_opt_state)
    flat = {n: np.asarray(x) for n, x in
            flatten_with_names({"params": jstate.params})[0]}
    flat = {n[len("params/"):]: x for n, x in flat.items()}
    template = jstate
    jtrainer = JaxTrainer(jcfg, task.loss_fn, tx, mesh=mesh, donate=False)
    jstate, j_head = _jax_steps(jtrainer, jstate, batches[:2])
    j_save(str(tmp_path / "jax"), 2, jstate)
    _, j_tail = _jax_steps(jtrainer, jstate, batches[2:])

    state, trainer = _port_side(cfg, flat)
    assert isinstance(trainer.task.model,
                      LongBert if preset.startswith("bert") else LongCausalLm)
    t_head = _port_steps(trainer, state, batches[:2])
    save_checkpoint(str(tmp_path / "port"), 2, state)
    t_tail = _port_steps(trainer, state, batches[2:])
    np.testing.assert_allclose(t_head + t_tail, j_head + j_tail, rtol=1e-4)
    assert t_tail[-1] < t_head[0]

    restored, step = j_restore(str(tmp_path / "port"), template)
    assert step == 2
    _, from_port = _jax_steps(jtrainer, restored, batches[2:])
    np.testing.assert_allclose(from_port, t_tail, rtol=1e-4)

    fresh, fresh_trainer = _port_side(cfg, flat)
    leaves, step = restore_checkpoint(str(tmp_path / "jax"), fresh)
    fresh.load_named(leaves)
    assert step == 2 and fresh.step == 2
    np.testing.assert_allclose(_port_steps(fresh_trainer, fresh,
                                           batches[2:]), j_tail, rtol=1e-4)


# -- refusals on a seq mesh ----------------------------------------------------


@pytest.mark.parametrize("name,impl,heads,seq,error", [
    ("bert_long", "nope", HEADS, 2, KeyError),
    ("gpt_long", "nope", HEADS, 2, KeyError),
    ("bert_long", "ulysses", 2, 4, ValueError),
    ("gpt_long", "ulysses", 2, 4, ValueError),
])
def test_seq_mesh_refusals_match_jax(name, impl, heads, seq, error):
    kw = dict(TINY, num_heads=heads, seq_impl=impl)
    inputs = [jnp.asarray(x) for x in FAMILIES[name][0](0, b=2)]
    j_mesh = j_build_mesh(JMeshConfig(data=1, seq=seq),
                          devices=jax.devices()[:seq])
    jm = j_build_model(name, 2 if name == "bert_long" else 0, jnp.float32,
                       mesh=j_mesh, batch_axes="data", **kw)
    variables = jm.init(jax.random.PRNGKey(0), *inputs, train=False)
    with pytest.raises(error) as j_err:
        jm.apply(variables, *inputs, train=False)
    mesh = build_mesh(MeshConfig(data=1, seq=seq), num_processes=seq,
                      index=0)
    tm = build_model(name, 2 if name == "bert_long" else 0, torch.float32,
                     mesh=mesh, **kw)
    with pytest.raises(error) as t_err:
        tm(*(torch.from_numpy(np.array(x)).long() for x in inputs),
           train=False)
    if error is ValueError:
        assert "divisible" in str(j_err.value) and \
            str(t_err.value) == str(j_err.value)
    else:
        assert t_err.value.args == j_err.value.args == ("nope",)
