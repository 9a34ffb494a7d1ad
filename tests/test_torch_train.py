"""The port's training slice (deeplearning_cfn_tpu_torch.train, .data) against
the JAX package's, on the CPU.

- ``cross_entropy`` with optax's label smoothing, every schedule against
  optax's over 50 steps, one AdamW and one clipped-momentum update against
  optax on the same gradients;
- the data pipeline: batches identical to the JAX ``DataPipeline`` with the
  Python gather;
- the training trajectory: one ``transformer_nmt_tiny``-sized f32 init made
  by Flax and bridged with ``params_from_flax``, 5 steps of AdamW + rsqrt
  with label smoothing 0.1 and dropout 0, at ``grad_accum_steps`` 1 and 2,
  in both packages (the JAX side drives ``Seq2SeqTask.loss_fn`` + optax
  directly, with the Pallas kernels in interpreter mode, so its backward is
  the flash kernels'). Losses within 1e-4 relative, final params within
  1e-4;
- dropout: the identity when not training, keep rate ≈ 1 − p, one seed one
  mask;
- the ``train`` CLI verb on the CPU, and its refusal without a card.

Inputs are numpy arrays made from seeds and handed to both packages.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning_cfn_tpu.config import apply_overrides as j_overrides
from deeplearning_cfn_tpu.data.pipeline import DataPipeline as JaxPipeline
from deeplearning_cfn_tpu.data.text import build_text_source as j_source
from deeplearning_cfn_tpu.presets import get_preset as j_preset
from deeplearning_cfn_tpu.train import optim as joptim
from deeplearning_cfn_tpu.train.task import Seq2SeqTask as JaxTask
from deeplearning_cfn_tpu.train.task import cross_entropy as j_xent
from deeplearning_cfn_tpu.utils.trees import flatten_with_names
from deeplearning_cfn_tpu_torch.config import (OptimizerConfig,
                                               ScheduleConfig, apply_overrides)
from deeplearning_cfn_tpu_torch.convert import params_from_flax
from deeplearning_cfn_tpu_torch.data.pipeline import build_pipeline, to_device
from deeplearning_cfn_tpu_torch.models.transformer import dropout
from deeplearning_cfn_tpu_torch.presets import get_preset
from deeplearning_cfn_tpu_torch.train import optim as toptim
from deeplearning_cfn_tpu_torch.train.state import create_train_state
from deeplearning_cfn_tpu_torch.train.task import Seq2SeqTask, cross_entropy
from deeplearning_cfn_tpu_torch.train.trainer import Trainer

TINY = ["model.kwargs.hidden_size=32", "model.kwargs.num_layers=2",
        "model.kwargs.num_heads=2", "model.kwargs.mlp_dim=64",
        "data.vocab_size=64", "data.seq_len=16", "train.dtype=float32",
        "data.num_train_examples=64", "data.num_eval_examples=16"]


# -- loss, schedules, optimizer updates -------------------------------------


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    rng = np.random.RandomState(0)
    logits = rng.normal(0, 3, (4, 7, 50)).astype(np.float32)
    labels = rng.randint(0, 50, (4, 7))
    want = np.asarray(j_xent(jnp.asarray(logits), jnp.asarray(labels),
                             smoothing))
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        smoothing)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if smoothing:
        # Not torch's label smoothing, which also gives s/V to the true
        # class.
        torch_ls = torch.nn.functional.cross_entropy(
            torch.from_numpy(logits).reshape(-1, 50),
            torch.from_numpy(labels).reshape(-1), reduction="none",
            label_smoothing=smoothing).reshape(4, 7)
        assert not np.allclose(torch_ls.numpy(), want, rtol=1e-5, atol=1e-5)


SCHEDULES = {
    "constant": dict(name="constant", base_lr=0.3),
    "constant_warmup": dict(name="constant", base_lr=0.3, warmup_steps=7),
    "cosine_warmup": dict(name="cosine", base_lr=0.1, warmup_steps=5,
                          end_lr_factor=0.1),
    "cosine_epochs": dict(name="cosine", base_lr=0.1, warmup_epochs=0.5,
                          scale_with_batch=True, reference_batch=64),
    "step": dict(name="step", base_lr=0.2, warmup_steps=4,
                 step_boundaries=(0.3, 0.7), step_factors=(0.1, 0.01)),
    "rsqrt": dict(name="rsqrt", base_lr=1.0, warmup_steps=12),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_optax(name):
    from deeplearning_cfn_tpu.config import ScheduleConfig as JSched

    spec = SCHEDULES[name]
    j = joptim.build_schedule(JSched(**spec), 40, 128, steps_per_epoch=16)
    t = toptim.build_schedule(ScheduleConfig(**spec), 40, 128,
                              steps_per_epoch=16)
    for step in range(50):
        np.testing.assert_allclose(t(step), float(j(step)), rtol=2e-6,
                                   atol=1e-9, err_msg=f"step {step}")


def _param_tree(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.normal(0, 1, (5, 3)).astype(np.float32),
            "b": rng.normal(0, 1, (3,)).astype(np.float32)}


@pytest.mark.parametrize("spec", [
    dict(name="adamw", b1=0.9, b2=0.98, weight_decay=0.01),
    dict(name="momentum", momentum=0.9, weight_decay=1e-3,
         grad_clip_norm=0.5),
    dict(name="sgd", grad_clip_norm=100.0),
    dict(name="adam", weight_decay=0.01, grad_clip_norm=0.3),
], ids=lambda s: s["name"])
def test_optimizer_updates_match_optax(spec):
    from deeplearning_cfn_tpu.config import OptimizerConfig as JOpt

    params = _param_tree(0)
    grads = [_param_tree(1), _param_tree(2)]
    sched = lambda step: 0.05 * (step + 1)
    tx = joptim.build_optimizer(JOpt(**spec), sched)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = toptim.Optimizer(OptimizerConfig(**spec), sched, list(tp.values()))
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    assert opt.count == 2
    # f32 rounding only: Adam's normalised step m/(sqrt(v)+eps) is computed
    # in another order by torch.optim than by optax.
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(),
                                   np.asarray(jp[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_unported_optimizers_name_their_roadmap_item():
    p = [torch.nn.Parameter(torch.zeros(2, 2))]
    # lars is ported (tests/test_torch_classification.py); the rest raise.
    for name in ("lamb", "adafactor"):
        with pytest.raises(NotImplementedError, match="ROADMAP A.9"):
            toptim.Optimizer(OptimizerConfig(name=name), lambda s: 0.1, p)


# -- data ---------------------------------------------------------------------


def test_pipeline_batches_match_jax():
    cfg = apply_overrides(get_preset("transformer_nmt_wmt"), TINY)
    jcfg = j_overrides(j_preset("transformer_nmt_wmt"), TINY)
    for train, drop in ((True, True), (False, False)):
        port = build_pipeline(cfg.data, 24, seed=5, train=train,
                              drop_remainder=drop)
        ref = JaxPipeline(j_source(jcfg.data, train), 24, seed=5,
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
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    stream = port.epochs()
    first = next(iter(build_pipeline(cfg.data, 24, seed=5).epochs()))
    assert first["src_ids"].shape == (24, 16)
    stream.close()


# -- the training trajectory ---------------------------------------------------


def _jax_run(jcfg, params, batches, accum):
    task = JaxTask(jcfg)
    sched = joptim.build_schedule(jcfg.schedule, len(batches),
                                  jcfg.train.global_batch)
    tx = joptim.build_optimizer(jcfg.optimizer, sched)

    def loss(p, b):
        return task.loss_fn(p, {}, b, None, True)[0]

    @jax.jit
    def step(p, opt_state, batch):
        if accum == 1:
            value, grads = jax.value_and_grad(loss)(p, batch)
        else:
            micro = jax.tree_util.tree_map(
                lambda v: v.reshape(v.shape[0] // accum, accum,
                                    *v.shape[1:]).swapaxes(0, 1), batch)
            vals, gs = [], []
            for i in range(accum):
                mb = jax.tree_util.tree_map(lambda v: v[i], micro)
                val, g = jax.value_and_grad(loss)(p, mb)
                vals.append(val)
                gs.append(g)
            value = sum(vals) / accum
            grads = jax.tree_util.tree_map(lambda *g: sum(g) / accum, *gs)
        upd, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, upd), opt_state, value

    opt_state = tx.init(params)
    losses = []
    for b in batches:
        params, opt_state, value = step(params, opt_state, b)
        losses.append(float(value))
    return losses, params


@pytest.mark.parametrize("accum", [1, 2])
def test_training_trajectory_matches_jax(accum):
    over = TINY + ["model.kwargs.dropout_rate=0.0",
                   "train.label_smoothing=0.1", "train.global_batch=8",
                   f"train.grad_accum_steps={accum}", "train.seed=0",
                   "schedule.warmup_steps=3", "schedule.base_lr=0.01"]
    cfg = apply_overrides(get_preset("transformer_nmt_wmt"), over)
    jcfg = j_overrides(j_preset("transformer_nmt_wmt"),
                       over + ["model.kwargs.attention_impl=interpret"])
    jtask = JaxTask(jcfg)
    params = jtask.init(jax.random.PRNGKey(0))["params"]
    flat = {n: np.asarray(x) for n, x in flatten_with_names(params)[0]}
    batches = [b for _, b in zip(range(5), build_pipeline(
        cfg.data, 8, seed=0).one_epoch())]
    j_losses, j_params = _jax_run(jcfg, params,
                                  [{k: jnp.asarray(v) for k, v in b.items()}
                                   for b in batches], accum)

    dev = torch.device("cpu")
    task = Seq2SeqTask(cfg, dev)
    task.model.load_state_dict(params_from_flax(flat), strict=True)
    sched = toptim.build_schedule(cfg.schedule, 5, 8)
    state = create_train_state(task.model, toptim.build_optimizer(
        cfg.optimizer, sched, task.model))
    trainer = Trainer(cfg, task, dev)
    t_losses = [float(trainer.train_step(state, to_device(b, dev))["loss"])
                for b in batches]
    assert state.step == 5
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert t_losses[-1] < t_losses[0]
    want = params_from_flax({n: np.asarray(x) for n, x in
                             flatten_with_names(j_params)[0]})
    got = task.model.state_dict()
    # The key projections' biases are left out: their true gradient is 0
    # (they shift every logit of a row alike), and Adam turns the rounding
    # noise each package leaves there into lr-sized steps of random sign.
    # They cannot change any output, as the matching losses show.
    compared = [n for n in want if not n.endswith("key.bias")]
    assert len(compared) == len(want) - 6  # 2 encoder + 2×2 decoder attns
    for name in compared:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def test_trainer_refuses_what_this_slice_leaves_out():
    base = apply_overrides(get_preset("transformer_nmt_wmt"), TINY)
    task = Seq2SeqTask(base, torch.device("cpu"))
    for over, item in ((["train.step_window=4"], "step_window"),
                       (["train.remat=true"], "remat")):
        cfg = apply_overrides(get_preset("transformer_nmt_wmt"), TINY + over)
        with pytest.raises(NotImplementedError, match=f"ROADMAP A.5 {item}"):
            Trainer(cfg, task, torch.device("cpu"))


# -- dropout ------------------------------------------------------------------


def test_dropout_identity_rate_and_determinism():
    x = torch.ones(64, 512)
    assert dropout(x, 0.1, None) is x  # not training
    g = torch.Generator().manual_seed(3)
    y = dropout(x, 0.1, g)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.9) < 0.01
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))
    again = dropout(x, 0.1, torch.Generator().manual_seed(3))
    assert torch.equal(y, again)
    other = dropout(x, 0.1, torch.Generator().manual_seed(4))
    assert not torch.equal(y, other)
    bf = dropout(x.bfloat16(), 0.1, torch.Generator().manual_seed(3))
    assert bf.dtype == torch.bfloat16


def test_model_dropout_follows_the_train_flag():
    cfg = apply_overrides(get_preset("transformer_nmt_wmt"),
                          TINY + ["model.kwargs.dropout_rate=0.3"])
    task = Seq2SeqTask(cfg, torch.device("cpu"))
    task.init(torch.Generator().manual_seed(0))
    b = to_device(next(iter(build_pipeline(cfg.data, 4).one_epoch())),
                  torch.device("cpu"))
    args = (b["src_ids"], b["src_mask"], b["tgt_in_ids"])
    m = task.model
    with torch.no_grad():
        ev1, ev2 = m(*args, train=False), m(*args, train=False)
        tr1 = m(*args, train=True, generator=torch.Generator().manual_seed(1))
        tr2 = m(*args, train=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(ev1, ev2) and torch.equal(tr1, tr2)
    assert not torch.allclose(ev1, tr1)
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        m(*args, train=True)


# -- the CLI ------------------------------------------------------------------


def test_cli_train_on_cpu(tmp_path, capsys):
    from deeplearning_cfn_tpu_torch.cli.main import main

    argv = ["train", "--preset", "transformer_nmt_wmt", "--accelerator",
            "cpu", "--max-steps", "3", *TINY, f"workdir={tmp_path}",
            "train.global_batch=8", "train.log_every_steps=1",
            "eval.max_decode_len=6", "eval.beam_size=2"]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "final metrics:" in out and "'bleu'" in out
    records = [json.loads(ln) for ln in (
        tmp_path / "transformer_nmt_wmt" / "metrics.jsonl").read_text()
        .splitlines()]
    assert [r["step"] for r in records[:3]] == [1, 2, 3]
    assert "final_eval_bleu" in records[-1]


def test_cli_train_without_a_card_refuses(monkeypatch, tmp_path, capsys):
    from deeplearning_cfn_tpu_torch.cli.main import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = main(["train", "--preset", "transformer_nmt_wmt", *TINY,
               f"workdir={tmp_path}"])
    assert rc == 1
    assert "a CUDA card was asked for" in capsys.readouterr().err
