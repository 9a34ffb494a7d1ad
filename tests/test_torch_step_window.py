"""``train.step_window`` K > 1 in the port (deeplearning_cfn_tpu_torch.train)
against the JAX package's fused windows, on the CPU.

- ``_plan_window`` equals the JAX one on the JAX test's cases;
- ``Trainer.window_step`` of both packages, from one tiny NMT init made by
  Flax and bridged with ``params_from_flax``, over the same batches (two
  windows of 4, dropout 0, the Pallas kernels in interpreter mode on the
  JAX side): losses within 1e-4 relative, final params within 1e-4, as
  ``test_torch_train.py::test_training_trajectory_matches_jax``;
- the port's K = 1 and K = 4 trajectories are bitwise equal, with dropout
  on, at accumulation 1 and 2 (on the CPU a window runs its steps eagerly:
  the plain version of the card's graph replays);
- the windowed ``run_experiment`` keeps every cadence, as JAX's
  ``test_step_window_preserves_cadences`` checks, and logs the same steps
  as the JAX ``run_experiment`` of the same config;
- every trainable preset's tiny cut builds with ``train.step_window=4`` and
  runs a window whose steps do nothing a CUDA graph capture refuses: no
  value read back to the host, no shape that depends on the data, no
  tensor made from host memory.

Inputs are numpy arrays made from seeds and handed to both packages.
"""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deeplearning_cfn_tpu.config import MeshConfig
from deeplearning_cfn_tpu.config import apply_overrides as j_overrides
from deeplearning_cfn_tpu.parallel.mesh import build_mesh
from deeplearning_cfn_tpu.presets import get_preset as j_preset
from deeplearning_cfn_tpu.train import optim as joptim
from deeplearning_cfn_tpu.train.run import run_experiment as j_run
from deeplearning_cfn_tpu.train.state import \
    create_train_state as j_create_state
from deeplearning_cfn_tpu.train.task import Seq2SeqTask as JaxTask
from deeplearning_cfn_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning_cfn_tpu.train.trainer import _plan_window as j_plan
from deeplearning_cfn_tpu.utils.trees import flatten_with_names
from deeplearning_cfn_tpu_torch.config import apply_overrides
from deeplearning_cfn_tpu_torch.convert import params_from_flax
from deeplearning_cfn_tpu_torch.data.pipeline import build_pipeline, to_device
from deeplearning_cfn_tpu_torch.presets import get_preset
from deeplearning_cfn_tpu_torch.train import optim as toptim
from deeplearning_cfn_tpu_torch.train.run import run_experiment
from deeplearning_cfn_tpu_torch.train.state import create_train_state
from deeplearning_cfn_tpu_torch.train.task import Seq2SeqTask, build_task
from deeplearning_cfn_tpu_torch.train.trainer import Trainer, _plan_window

CPU = torch.device("cpu")
NMT_TINY = ["model.kwargs.hidden_size=32", "model.kwargs.num_layers=2",
            "model.kwargs.num_heads=2", "model.kwargs.mlp_dim=64",
            "data.vocab_size=64", "data.seq_len=16", "train.dtype=float32",
            "data.num_train_examples=64", "data.num_eval_examples=16",
            "train.global_batch=8", "train.seed=0",
            "schedule.warmup_steps=3", "schedule.base_lr=0.01"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # Tiny models: one worker's share of the cores is plenty, and the
    # xdist workers do not oversubscribe the machine.
    n = torch.get_num_threads()
    torch.set_num_threads(max(1, min(n, 4)))
    yield
    torch.set_num_threads(n)


# -- window planning -----------------------------------------------------------

# tests/test_trainer.py::test_plan_window_respects_cadences's cases.
PLAN_CASES = [
    ((0, 100, 8, [3, 4]), {}),
    ((3, 100, 8, [3, 4]), {}),
    ((4, 100, 8, [3, 4]), {}),
    ((98, 100, 8, [100]), {}),
    ((4, 100, 8, [100]), {"boundaries": (6, 10)}),
    ((8, 100, 8, [100]), {"boundaries": (6, 10)}),
    ((0, 100, 8, [0, -1, 8]), {}),
    ((99, 100, 8, [1]), {}),
]


@pytest.mark.parametrize("args,kw", PLAN_CASES,
                         ids=[str(i) for i in range(len(PLAN_CASES))])
def test_plan_window_matches_jax(args, kw):
    assert _plan_window(*args, **kw) == j_plan(*args, **kw)


# -- window_step against JAX ---------------------------------------------------


def test_window_step_matches_jax():
    over = NMT_TINY + ["model.kwargs.dropout_rate=0.0",
                       "train.label_smoothing=0.1", "train.step_window=4"]
    cfg = apply_overrides(get_preset("transformer_nmt_wmt"), over)
    jcfg = j_overrides(j_preset("transformer_nmt_wmt"),
                       over + ["model.kwargs.attention_impl=interpret"])
    batches = [b for _, b in zip(range(8), build_pipeline(
        cfg.data, 8, seed=0).one_epoch())]

    mesh = build_mesh(MeshConfig(data=1, model=1), devices=jax.devices()[:1])
    jtask = JaxTask(jcfg)
    tx = joptim.build_optimizer(
        jcfg.optimizer, joptim.build_schedule(jcfg.schedule, 8, 8))
    jstate = j_create_state(jax.random.PRNGKey(0), jtask.init, tx, mesh)
    params = jstate.params
    flat = {n: np.asarray(x) for n, x in flatten_with_names(params)[0]}
    jtrainer = JaxTrainer(jcfg, jtask.loss_fn, tx, mesh=mesh, donate=False)
    j_losses = []
    for i in range(0, 8, 4):
        jstate, m = jtrainer.window_step(
            jstate, tuple(jtrainer.device_batch(b) for b in batches[i:i + 4]),
            jax.random.PRNGKey(1))
        j_losses.extend(np.asarray(m["loss"]).tolist())

    task = Seq2SeqTask(cfg, CPU)
    task.model.load_state_dict(params_from_flax(flat), strict=True)
    state = create_train_state(task.model, toptim.build_optimizer(
        cfg.optimizer, toptim.build_schedule(cfg.schedule, 8, 8),
        task.model))
    trainer = Trainer(cfg, task, CPU)
    t_losses = []
    for i in range(0, 8, 4):
        m = trainer.window_step(state, [to_device(b, CPU)
                                        for b in batches[i:i + 4]])
        assert m["loss"].shape == (4,)
        t_losses.extend(m["loss"].tolist())
    assert state.step == 8 == int(jstate.step)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert t_losses[-1] < t_losses[0]
    want = params_from_flax({n: np.asarray(x) for n, x in
                             flatten_with_names(jstate.params)[0]})
    got = task.model.state_dict()
    # The key projections' biases have a true gradient of 0 (see
    # test_torch_train.py): compared by the losses only.
    compared = [n for n in want if not n.endswith("key.bias")]
    for name in compared:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


# -- K = 1 against K = 4 in the port ---------------------------------------------


def _trajectory(window, accum, remat=False):
    over = NMT_TINY + ["model.kwargs.dropout_rate=0.1",
                       f"train.grad_accum_steps={accum}",
                       f"train.step_window={window}",
                       f"train.remat={str(remat).lower()}"]
    cfg = apply_overrides(get_preset("transformer_nmt_wmt"), over)
    task = Seq2SeqTask(cfg, CPU)
    task.init(torch.Generator().manual_seed(0))
    state = create_train_state(task.model, toptim.build_optimizer(
        cfg.optimizer, toptim.build_schedule(cfg.schedule, 8, 8),
        task.model))
    trainer = Trainer(cfg, task, CPU)
    batches = [to_device(b, CPU) for _, b in zip(range(8), build_pipeline(
        cfg.data, 8, seed=0).one_epoch())]
    losses = []
    for i in range(0, 8, window):
        if window == 1:
            losses.append(trainer.train_step(state, batches[i])["loss"])
        else:
            losses.extend(trainer.window_step(
                state, batches[i:i + window])["loss"].unbind())
    return torch.stack(losses), task.model.state_dict()


@pytest.mark.parametrize("accum", [1, 2])
def test_windows_reproduce_the_per_step_loop_bitwise(accum):
    l1, w1 = _trajectory(1, accum)
    l4, w4 = _trajectory(4, accum)
    assert torch.equal(l1, l4), (l1, l4)
    for name in w1:
        assert torch.equal(w1[name], w4[name]), name
    # With the forward recomputed in the backward, the recompute draws the
    # forward's masks again (StepGenerator.rewound).
    l_remat, _ = _trajectory(4, accum, remat=True)
    assert torch.equal(l_remat, l1)


# -- cadences through run_experiment ---------------------------------------------

CADENCE = ["train.global_batch=32", "train.steps=8",
           "train.log_every_steps=4", "train.eval_every_steps=4",
           "data.num_train_examples=256", "data.num_eval_examples=64",
           "train.eval_batch=32", "data.prefetch=0", "schedule.name=constant",
           "schedule.base_lr=0.1", "schedule.warmup_epochs=0",
           "checkpoint.async_write=false", "train.step_window=4",
           "checkpoint.every_steps=4", "train.hang_timeout_s=600"]


def _records(workdir):
    with open(os.path.join(workdir, "cifar10_resnet20",
                           "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def test_windowed_run_keeps_every_cadence(tmp_path, devices):
    """tests/test_trainer.py::test_step_window_preserves_cadences through
    the port's run_experiment, and the JAX run's logged steps."""
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    cfg = apply_overrides(get_preset("cifar10_resnet20"),
                          CADENCE + [f"workdir={port_dir}"])
    final = run_experiment(cfg, device="cpu")
    assert np.isfinite(final["loss"])
    ckpts = sorted(
        os.path.basename(os.path.dirname(p)) for p in
        glob.glob(os.path.join(port_dir, "cifar10_resnet20", "ckpt",
                               "step_*", "COMMIT")))
    assert "step_00000004" in ckpts and "step_00000008" in ckpts, ckpts
    records = _records(port_dir)
    eval_steps = [r["step"] for r in records
                  if any(k.startswith("eval_") for k in r)]
    assert 4 in eval_steps and 8 in eval_steps, records
    steps_logged = [r["step"] for r in records if "loss" in r]
    assert len(steps_logged) == len(set(steps_logged)), steps_logged
    assert steps_logged[-1] == 8
    assert sum(1 for r in records if "compile_s" in r) == 1
    assert all(r["examples_per_sec"] > 0 for r in records
               if "examples_per_sec" in r)

    jcfg = j_overrides(j_preset("cifar10_resnet20"),
                       CADENCE + [f"workdir={jax_dir}"])
    j_run(jcfg)
    assert [r["step"] for r in _records(jax_dir) if "loss" in r] \
        == steps_logged


# -- every trainable preset -------------------------------------------------------

MOE = ["model.kwargs.num_experts=4", "model.kwargs.moe_every=2",
       "model.kwargs.moe_top_k=2", "model.kwargs.moe_capacity_factor=0.5"]
BERT_WIDTHS = ["model.kwargs.hidden_size=32", "model.kwargs.num_layers=2",
               "model.kwargs.num_heads=2", "model.kwargs.mlp_dim=64",
               "model.kwargs.max_len=32", "data.vocab_size=64",
               "data.seq_len=16", "train.global_batch=8"]
IMAGE = ["model.num_classes=10", "data.image_size=32",
         "train.global_batch=4", "data.num_train_examples=16"]
PRESETS = {
    "transformer_nmt_wmt": NMT_TINY + ["model.kwargs.dropout_rate=0.1"],
    "cifar10_resnet20": ["train.global_batch=8",
                         "data.num_train_examples=32"],
    "imagenet_resnet50": IMAGE + ["model.kwargs.num_filters=8"],
    "bert_base_wikipedia": ["model.name=bert_tiny"] + BERT_WIDTHS,
    "maskrcnn_coco": [
        "model.num_classes=7", "model.kwargs.image_size=64",
        "model.kwargs.pre_nms_topk=64", "model.kwargs.post_nms_topk=16",
        "model.kwargs.num_mask_rois=4", "model.kwargs.anchor_scale=4.0",
        "data.image_size=64", "data.max_boxes=4", "train.global_batch=2",
        "data.num_train_examples=8"],
    "gpt_small_lm": ["model.name=gpt_tiny", "model.kwargs.max_len=32",
                     "data.vocab_size=512", "data.seq_len=16",
                     "train.global_batch=4"],
    "imagenet_vit_s16": ["model.name=vit_tiny", "model.num_classes=10",
                         "data.image_size=16", "train.global_batch=4",
                         "data.num_train_examples=16"],
    "bert_moe_wikipedia": ["model.name=bert_tiny"] + BERT_WIDTHS + MOE,
    "bert_pipelined_wikipedia": BERT_WIDTHS
    + ["model.kwargs.n_microbatches=2"],
    "bert_long_wikipedia": BERT_WIDTHS + ["data.num_train_examples=16"],
    "gpt_long_lm": ["model.kwargs.hidden_size=32", "model.kwargs.num_layers=2",
                    "model.kwargs.num_heads=2", "model.kwargs.mlp_dim=64",
                    "model.kwargs.max_len=32", "data.vocab_size=512",
                    "data.seq_len=16", "train.global_batch=4",
                    "data.num_train_examples=16"],
}


def _preset(name):
    cfg = apply_overrides(get_preset(name), PRESETS[name] + [
        "train.dtype=float32", "train.step_window=4", "train.seed=0",
        "data.num_eval_examples=8", "data.prefetch=0"])
    task = build_task(cfg, CPU)
    task.init(torch.Generator().manual_seed(0))
    return cfg, task


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_every_trainable_preset_builds_with_step_window_4(preset):
    cfg, task = _preset(preset)
    trainer = Trainer(cfg, task, CPU)
    assert cfg.train.step_window == 4 and trainer.graphs is None


# What a CUDA graph capture refuses: a value read back to the host, a shape
# that depends on the data (both synchronise), and a tensor made from host
# data (on the card, a copy from pageable memory).
_REFUSED = {"aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
            "aten._unique2", "aten.unique_dim", "aten.unique_consecutive",
            "aten.unique_dim_consecutive", "aten.lift_fresh"}


class _Refusals(TorchDispatchMode):
    """Records every op of the refused kinds, and indexing by a bool mask
    (a nonzero inside). ``F.one_hot`` checks its values on the host on the
    CPU only (on the card it leaves that to the scatter's device assert);
    its checks are not counted."""

    def __init__(self):
        super().__init__()
        self.seen = []
        self.one_hot_depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket._qualified_op_name.replace("::", ".")
        bool_index = name in ("aten.index", "aten.index_put") and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for i in (args[1] if len(args) > 1 else ()) if i is not None)
        if (name in _REFUSED or bool_index) and not self.one_hot_depth:
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_window_steps_do_nothing_a_capture_refuses(preset, monkeypatch):
    cfg, task = _preset(preset)
    state = create_train_state(task.model, toptim.build_optimizer(
        cfg.optimizer, toptim.build_schedule(cfg.schedule, 4,
                                             cfg.train.global_batch),
        task.model), ema=cfg.train.ema_decay > 0)
    trainer = Trainer(cfg, task, CPU)
    batch = next(iter(build_pipeline(cfg.data, cfg.train.global_batch,
                                     cfg.model.num_classes,
                                     seed=0).one_epoch()))
    batches = [to_device(batch, CPU), to_device(batch, CPU)]
    mode = _Refusals()
    one_hot = torch.nn.functional.one_hot

    def counted_one_hot(*args, **kwargs):
        mode.one_hot_depth += 1
        try:
            return one_hot(*args, **kwargs)
        finally:
            mode.one_hot_depth -= 1

    monkeypatch.setattr(torch.nn.functional, "one_hot", counted_one_hot)
    with mode:
        metrics = trainer.window_step(state, batches)
    assert mode.seen == [], sorted(set(mode.seen))
    assert state.step == 2 and metrics["loss"].shape == (2,)
    assert torch.isfinite(metrics["loss"]).all()
