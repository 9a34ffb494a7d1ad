"""The GPT family's user loop in the port — checkpoints, the ``train`` and
``generate`` verbs — and the NMT recompute-mode searchers, against the JAX
package's, on the CPU in f32.

- Checkpoints cross over both ways for ``gpt_tiny`` under the
  ``gpt_small_lm`` recipe (AdamW (0.9, 0.95), weight decay 0.1, clip 1.0,
  cosine): from one Flax init both packages train 4 steps and save at
  step 2; the JAX ``restore_checkpoint`` reads the port's (every leaf of
  its target, the AdamW slots included) and the port reads the JAX one,
  and both continuations repeat steps 3–4 within 1e-4 relative;
- ``cli train`` on a byte corpus, then ``cli generate`` continues it (as
  ``tests/test_lm.py`` drives the JAX verbs), with ``--vocab`` and the
  error exits: no checkpoint, a step never committed, a model that is not
  a causal LM, a prompt that encodes to nothing, and no card;
- ``greedy_decode`` and ``beam_decode`` (recompute mode) token-identical to
  the JAX package's and to the port's cached searchers, and
  ``Seq2SeqTask.final_eval`` with ``eval.use_kv_cache=false``.
"""

import os

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from deeplearning_cfn_tpu.ckpt import restore_checkpoint as j_restore
from deeplearning_cfn_tpu.ckpt import save_checkpoint as j_save
from deeplearning_cfn_tpu.config import MeshConfig
from deeplearning_cfn_tpu.config import apply_overrides as j_overrides
from deeplearning_cfn_tpu.models import decoding as jdec
from deeplearning_cfn_tpu.models.transformer_nmt import \
    transformer_nmt_tiny as jax_nmt_tiny
from deeplearning_cfn_tpu.parallel import build_mesh
from deeplearning_cfn_tpu.presets import get_preset as j_preset
from deeplearning_cfn_tpu.train import create_train_state as j_create_state
from deeplearning_cfn_tpu.train import optim as joptim
from deeplearning_cfn_tpu.train.task import build_task as j_build_task
from deeplearning_cfn_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning_cfn_tpu.utils.trees import flatten_with_names
from deeplearning_cfn_tpu_torch.ckpt import (restore_checkpoint,
                                             save_checkpoint)
from deeplearning_cfn_tpu_torch.cli.main import main
from deeplearning_cfn_tpu_torch.config import apply_overrides
from deeplearning_cfn_tpu_torch.convert import params_from_flax
from deeplearning_cfn_tpu_torch.data.bpe import MLM_SPECIALS, Bpe
from deeplearning_cfn_tpu_torch.data.pipeline import build_pipeline, to_device
from deeplearning_cfn_tpu_torch.data.text import prepare_lm_text
from deeplearning_cfn_tpu_torch.models import decoding as tdec
from deeplearning_cfn_tpu_torch.models.transformer_nmt import \
    transformer_nmt_tiny as torch_nmt_tiny
from deeplearning_cfn_tpu_torch.presets import get_preset
from deeplearning_cfn_tpu_torch.train import optim as toptim
from deeplearning_cfn_tpu_torch.train.state import create_train_state
from deeplearning_cfn_tpu_torch.train.task import Seq2SeqTask, build_task
from deeplearning_cfn_tpu_torch.train.trainer import Trainer

GPT = ["model.name=gpt_tiny", "model.kwargs.max_len=32",
       "model.kwargs.dropout_rate=0.0", "data.vocab_size=512",
       "data.seq_len=16", "train.dtype=float32", "train.global_batch=8",
       "data.num_train_examples=40", "data.num_eval_examples=16",
       "schedule.warmup_steps=2", "schedule.base_lr=3e-3"]
STEPS = 4
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


# -- checkpoints --------------------------------------------------------------


def _jax_steps(trainer, state, batches):
    losses = []
    for b in batches:
        state, m = trainer.train_step(state, trainer.device_batch(b),
                                      jax.random.PRNGKey(1))
        losses.append(float(m["loss"]))
    return state, losses


def _port_side(cfg, flat):
    task = build_task(cfg, CPU)
    task.model.load_state_dict(params_from_flax(flat), strict=True)
    opt = toptim.build_optimizer(
        cfg.optimizer, toptim.build_schedule(cfg.schedule, STEPS,
                                             cfg.train.global_batch),
        task.model)
    return create_train_state(task.model, opt), Trainer(cfg, task, CPU)


def _port_steps(trainer, state, batches):
    return [float(trainer.train_step(state, to_device(b, CPU))["loss"])
            for b in batches]


def test_checkpoints_interchange_with_jax(tmp_path):
    cfg = apply_overrides(get_preset("gpt_small_lm"), GPT)
    jcfg = j_overrides(j_preset("gpt_small_lm"), GPT)
    assert (cfg.optimizer.name, cfg.optimizer.b2) == ("adamw", 0.95)
    batches = [b for _, b in zip(range(STEPS), build_pipeline(
        cfg.data, cfg.train.global_batch, seed=0).one_epoch())]
    mesh = build_mesh(MeshConfig(data=1, model=1), devices=jax.devices()[:1])
    task = j_build_task(jcfg)
    tx = joptim.build_optimizer(
        jcfg.optimizer, joptim.build_schedule(jcfg.schedule, STEPS,
                                              jcfg.train.global_batch))
    jstate = j_create_state(jax.random.PRNGKey(0), task.init, tx, mesh)
    jtrainer = JaxTrainer(jcfg, task.loss_fn, tx, mesh=mesh, donate=False)
    flat = {n: np.asarray(v)
            for n, v in flatten_with_names({"params": jstate.params})[0]}
    template = jstate
    jstate, j_head = _jax_steps(jtrainer, jstate, batches[:2])
    j_save(str(tmp_path / "jax"), 2, jstate)
    _, j_tail = _jax_steps(jtrainer, jstate, batches[2:])

    state, trainer = _port_side(cfg, flat)
    t_head = _port_steps(trainer, state, batches[:2])
    save_checkpoint(str(tmp_path / "port"), 2, state)
    t_tail = _port_steps(trainer, state, batches[2:])
    np.testing.assert_allclose(t_head + t_tail, j_head + j_tail, rtol=1e-4)

    restored, step = j_restore(str(tmp_path / "port"), template)
    assert step == 2 and int(restored.step) == 2
    _, from_port = _jax_steps(jtrainer, restored, batches[2:])
    np.testing.assert_allclose(from_port, t_tail, rtol=1e-4)

    fresh, fresh_trainer = _port_side(cfg, flat)
    leaves, step = restore_checkpoint(str(tmp_path / "jax"), fresh)
    assert "params/token/embedding" in leaves and \
        "params/position" in leaves
    fresh.load_named(leaves)
    assert step == 2 and fresh.step == 2 and fresh.optimizer.count == 2
    np.testing.assert_allclose(_port_steps(fresh_trainer, fresh,
                                           batches[2:]), j_tail, rtol=1e-4)


# -- the train and generate verbs --------------------------------------------


def test_cli_trains_then_generates_on_cpu(tmp_path, capsys):
    src = tmp_path / "c.txt"
    src.write_bytes(b"abcdefgh" * 600)
    tok = str(tmp_path / "tok")
    prepare_lm_text(str(src), tok, seq_len=15)
    common = [
        "--preset", "gpt_small_lm", "--accelerator", "cpu",
        f"workdir={tmp_path}", "model.name=gpt_tiny",
        'model.kwargs={"vocab_size": 260, "max_len": 16}',
        "data.name=lm_text", f"data.data_dir={tok}",
        "data.synthetic=false", "data.vocab_size=260", "data.seq_len=15",
        "train.global_batch=16", "train.dtype=float32",
        "train.eval_batch=16", "schedule.name=constant",
        "schedule.base_lr=3e-3", "schedule.warmup_steps=5",
        "checkpoint.async_write=false", "data.prefetch=0"]
    assert main(["train", *common, "train.steps=40",
                 "train.log_every_steps=10"]) == 0
    out = capsys.readouterr().out
    assert "'perplexity'" in out and "'ce_loss'" in out
    assert main(["generate", *common, "--prompt", "abcd",
                 "--max-new-tokens", "8"]) == 0
    out = capsys.readouterr().out
    # The corpus is the 8-cycle "abcdefgh": a model at ~100% token accuracy
    # continues it exactly.
    assert "checkpoint step 40:" in out and "abcdefghabcd" in out, out
    assert main(["generate", *common, "--prompt", "abcd",
                 "--max-new-tokens", "4", "--temperature", "0.7",
                 "--top-k", "3", "--seed", "1"]) == 0
    assert "abcd" in capsys.readouterr().out
    # --vocab: a zero-merge BPE maps bytes to the byte tokenizer's ids but
    # appends an end-of-word space the corpus never saw, so only the
    # prompt's echo is asserted.
    vocab = str(tmp_path / "vocab.json")
    Bpe([], MLM_SPECIALS).save(vocab)
    assert main(["generate", *common, "--prompt", "abcd", "--vocab", vocab,
                 "--max-new-tokens", "4"]) == 0
    assert "abcd" in capsys.readouterr().out
    capsys.readouterr()
    for argv, why in (
            ([*common, "--prompt", "   ", "--vocab", vocab],
             "encodes to zero tokens"),
            ([*common, "--prompt", "abcd", "--step", "999"],
             "no committed checkpoint at step 999"),
            (["--preset", "cifar10_resnet20", "--accelerator", "cpu",
              f"workdir={tmp_path}", "--prompt", "x"],
             "no committed checkpoint"),
            (["--preset", "transformer_nmt_wmt", "--accelerator", "cpu",
              f"workdir={tmp_path}",
              f"checkpoint.directory={tmp_path}/gpt_small_lm/ckpt",
              "--prompt", "x"], "is not a causal LM"),
            ([*common, "--prompt", "abcd", "--max-new-tokens", "13"],
             "exceeds the model's max_len")):
        assert main(["generate", *argv]) == 1, why
        assert why in capsys.readouterr().err


def test_cli_generate_without_a_card_refuses(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["generate", "--preset", "gpt_small_lm", "--prompt", "x",
                 f"workdir={tmp_path}"]) == 1
    assert "a CUDA card was asked for" in capsys.readouterr().err


# -- the NMT recompute-mode searchers ----------------------------------------

VOCAB, SRC, MAX_LEN = 96, 12, 32


@pytest.fixture(scope="module")
def nmt():
    """``transformer_nmt_tiny`` from one Flax init, Dense kernels ×3 (so the
    random model's argmax is not one repeated token), in both packages."""
    kw = dict(vocab_size=VOCAB, max_len=MAX_LEN)
    jm = jax_nmt_tiny(**kw)
    ids = np.zeros((1, SRC), np.int32)
    params = jm.init(jax.random.PRNGKey(0), ids, np.ones_like(ids), ids,
                     train=False)["params"]
    flat = {n: np.asarray(x) * (3.0 if n.endswith("kernel") else 1.0)
            for n, x in flatten_with_names(params)[0]}
    params = traverse_util.unflatten_dict(
        {tuple(n.split("/")): x for n, x in flat.items()})
    tm = torch_nmt_tiny(**kw)
    tm.load_state_dict(params_from_flax(flat), strict=True)
    tm.requires_grad_(False)
    return jm, {"params": params}, tm


def _src(seed, b=3):
    rng = np.random.RandomState(seed)
    src = rng.randint(3, VOCAB, size=(b, SRC)).astype(np.int32)
    for i, n in enumerate(rng.randint(2, SRC + 1, size=b)):
        src[i, n:] = 0
    return src, (src != 0).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


def test_greedy_decode_matches_jax_and_the_cached_searcher(nmt):
    jm, v, tm = nmt
    src, mask = _src(5, b=4)
    want = np.asarray(jdec.greedy_decode(jm, v, src, mask, 14))
    got = tdec.greedy_decode(tm, _t(src), _t(mask), 14)
    assert len({tuple(r) for r in got.tolist()}) > 1, "degenerate model"
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, tdec.greedy_decode_cached(tm, _t(src), _t(mask),
                                                      14))


@pytest.mark.parametrize("beam", [2, 3])
def test_beam_decode_matches_jax_and_the_cached_searcher(nmt, beam):
    jm, v, tm = nmt
    src, mask = _src(6 + beam)
    jt, js = jdec.beam_decode(jm, v, src, mask, 12, beam_size=beam)
    tt, ts = tdec.beam_decode(tm, _t(src), _t(mask), 12, beam_size=beam)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4, rtol=0)
    ct, cs = tdec.beam_decode_cached(tm, _t(src), _t(mask), 12,
                                     beam_size=beam)
    assert torch.equal(tt, ct)
    torch.testing.assert_close(ts, cs, atol=1e-4, rtol=0)


@pytest.mark.parametrize("beam", [1, 2])
def test_final_eval_without_the_kv_cache(monkeypatch, beam):
    over = ["model.kwargs.hidden_size=32", "model.kwargs.num_layers=1",
            "model.kwargs.num_heads=2", "model.kwargs.mlp_dim=64",
            "data.vocab_size=64", "data.seq_len=16", "train.dtype=float32",
            "data.num_eval_examples=6", "train.eval_batch=4",
            "eval.max_decode_len=8", f"eval.beam_size={beam}"]
    calls = []
    for name in ("greedy_decode", "beam_decode"):
        real = getattr(tdec, name)
        monkeypatch.setattr(tdec, name, lambda *a, real=real, name=name, **k:
                            calls.append(name) or real(*a, **k))
    bleu = {}
    for cached in ("true", "false"):
        cfg = apply_overrides(get_preset("transformer_nmt_wmt"),
                              over + [f"eval.use_kv_cache={cached}"])
        task = Seq2SeqTask(cfg, CPU)
        task.init(torch.Generator().manual_seed(0))
        pipe = build_pipeline(cfg.data, 4, seed=0, train=False,
                              drop_remainder=False)
        bleu[cached] = task.final_eval(create_train_state(task.model, None),
                                       lambda: pipe.one_epoch())["bleu"]
    assert calls == ["greedy_decode" if beam == 1 else "beam_decode"] * 2
    assert bleu["false"] == bleu["true"]
    assert 0.0 <= bleu["false"] <= 100.0
