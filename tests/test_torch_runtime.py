"""The train options the port honours since slice 6, on the CPU:
``train.hang_timeout_s`` (the hang watchdog), ``train.profile_steps`` (a
profiler trace) and ``train.remat`` (recompute in the backward).

- The watchdog: ``StepWatchdog`` calls its hang handler once the beats stop,
  and a training process whose input stalls after its first step exits with
  code 89 (``HANG_EXIT_CODE``) within a few timeouts.
- ``train.profile_steps = 2`` leaves a Chrome trace with events under
  ``<workdir>/<preset>/profile``.
- ``train.remat``: one train step with the forward recomputed gives the
  same loss, gradients and updated parameters as without, bit for bit —
  BERT with dropout 0.3 at ``grad_accum_steps`` 2 (the dropout generator is
  rewound for each recompute and handed back after it, so the second
  microbatch draws the same masks), and a ResNet, whose BatchNorm running
  statistics move once per microbatch, as without remat.
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from deeplearning_cfn_tpu_torch.config import apply_overrides
from deeplearning_cfn_tpu_torch.data.pipeline import build_pipeline, to_device
from deeplearning_cfn_tpu_torch.presets import get_preset
from deeplearning_cfn_tpu_torch.runtime.profiling import trace_files
from deeplearning_cfn_tpu_torch.runtime.watchdog import (HANG_EXIT_CODE,
                                                         StepWatchdog)
from deeplearning_cfn_tpu_torch.train import optim as toptim
from deeplearning_cfn_tpu_torch.train.run import run_experiment
from deeplearning_cfn_tpu_torch.train.state import create_train_state
from deeplearning_cfn_tpu_torch.train.task import build_task
from deeplearning_cfn_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BERT = ["model.name=bert_tiny", "model.kwargs.hidden_size=32",
        "model.kwargs.num_layers=2", "model.kwargs.num_heads=2",
        "model.kwargs.mlp_dim=64", "model.kwargs.max_len=32",
        "data.vocab_size=64", "data.seq_len=16", "train.dtype=float32",
        "train.global_batch=8", "data.num_train_examples=40",
        "data.num_eval_examples=16", "schedule.warmup_steps=2",
        "schedule.base_lr=5e-3"]


def test_watchdog_calls_its_handler_when_beats_stop():
    fired = threading.Event()
    stalls = []

    def on_hang(stalled_s):
        stalls.append(stalled_s)
        fired.set()

    dog = StepWatchdog(0.3, on_hang=on_hang, poll_interval_s=0.05)
    for _ in range(6):  # beating keeps it quiet
        time.sleep(0.1)
        dog.beat()
    assert not fired.is_set()
    assert fired.wait(timeout=5.0) and stalls[0] >= 0.3
    dog.stop()
    with pytest.raises(ValueError):
        StepWatchdog(0.0)


_STALLED_RUN = """
import sys, threading
sys.path.insert(0, {repo!r})
import torch
from deeplearning_cfn_tpu_torch.config import apply_overrides
from deeplearning_cfn_tpu_torch.data.pipeline import build_pipeline
from deeplearning_cfn_tpu_torch.presets import get_preset
from deeplearning_cfn_tpu_torch.train import optim
from deeplearning_cfn_tpu_torch.train.state import create_train_state
from deeplearning_cfn_tpu_torch.train.task import build_task
from deeplearning_cfn_tpu_torch.train.trainer import Trainer

cfg = apply_overrides(get_preset("bert_base_wikipedia"),
                      {over!r} + ["train.hang_timeout_s=1.5",
                                  "train.device_prefetch=0"])
dev = torch.device("cpu")
task = build_task(cfg, dev)
task.init(torch.Generator().manual_seed(0))
state = create_train_state(task.model, optim.build_optimizer(
    cfg.optimizer, optim.build_schedule(cfg.schedule, 10, 8), task.model))

def stalled():
    yield next(iter(build_pipeline(cfg.data, 8).one_epoch()))
    print("first step done", flush=True)
    threading.Event().wait()  # the input never comes again

Trainer(cfg, task, dev).fit(state, stalled(), num_steps=10, log_every=1)
print("fit returned", flush=True)
"""


def test_a_stalled_run_exits_with_the_hang_code():
    code = _STALLED_RUN.format(repo=REPO, over=BERT)
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == HANG_EXIT_CODE == 89, proc.stderr[-2000:]
    assert "first step done" in proc.stdout
    assert "fit returned" not in proc.stdout
    assert "WATCHDOG: no training progress" in proc.stderr
    assert time.monotonic() - t0 < 60


def test_profile_steps_writes_a_trace(tmp_path):
    cfg = apply_overrides(get_preset("bert_base_wikipedia"), BERT + [
        f"workdir={tmp_path}", "train.steps=4", "train.profile_steps=2"])
    run_experiment(cfg, device="cpu")
    files = trace_files(str(tmp_path / "bert_base_wikipedia" / "profile"))
    assert len(files) == 1
    with open(files[0]) as fh:
        trace = json.load(fh)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)


def _one_step(cfg, batch, seed=0):
    dev = torch.device("cpu")
    task = build_task(cfg, dev)
    task.init(torch.Generator().manual_seed(seed))
    opt = toptim.build_optimizer(
        cfg.optimizer, toptim.build_schedule(cfg.schedule, 4,
                                             cfg.train.global_batch),
        task.model)
    state = create_train_state(task.model, opt)
    forwards = []
    task.model.register_forward_pre_hook(lambda *_: forwards.append(1))
    metrics = Trainer(cfg, task, dev).train_step(state, to_device(batch,
                                                                  dev))
    grads = {n: p.grad.clone() for n, p in task.model.named_parameters()}
    return metrics, grads, task.model.state_dict(), len(forwards)


@pytest.mark.parametrize("model", ["bert", "resnet"])
def test_remat_matches_no_remat(model):
    if model == "bert":
        preset = "bert_base_wikipedia"
        over = BERT + ["model.kwargs.dropout_rate=0.3",
                       "train.grad_accum_steps=2"]
    else:
        preset = "cifar10_resnet20"
        over = ["train.global_batch=16", "train.grad_accum_steps=2",
                "data.num_train_examples=32"]
    plain_cfg = apply_overrides(get_preset(preset), over)
    remat_cfg = apply_overrides(get_preset(preset),
                                over + ["train.remat=true"])
    batch = next(iter(build_pipeline(plain_cfg.data,
                                     plain_cfg.train.global_batch,
                                     plain_cfg.model.num_classes,
                                     seed=0).one_epoch()))
    m0, g0, s0, n0 = _one_step(plain_cfg, batch)
    m1, g1, s1, n1 = _one_step(remat_cfg, batch)
    assert (n0, n1) == (2, 4)  # each microbatch's forward runs again
    assert float(m1["loss"]) == float(m0["loss"])
    for name in g0:
        assert torch.equal(g1[name], g0[name]), name
    for name in s0:  # parameters and, for the ResNet, running statistics
        assert torch.equal(s1[name], s0[name]), name
    if model == "resnet":
        moved = [n for n in s0 if n.endswith("running_mean")]
        assert moved and all(not torch.equal(s0[n], torch.zeros_like(s0[n]))
                             for n in moved)
