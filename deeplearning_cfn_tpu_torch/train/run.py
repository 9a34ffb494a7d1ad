"""Experiment runner: config in → trained model out — the port of
``deeplearning_cfn_tpu/train/run.py`` for one device.

``run_experiment`` builds the task (model on the device, seeded init), the
train and eval pipelines, the schedule and optimizer, the train state, runs
``Trainer.fit`` and then the weighted full-set eval (for the ResNets: loss,
top-1 and top-5 accuracy) plus the task's own acceptance metric where it
has one (BLEU for NMT). Records go to
``<workdir>/<preset>/metrics.jsonl`` and stdout, as in the JAX package.

Not in this slice: checkpoint writing and resume (the port's ``ckpt/``,
ROADMAP A.5), the mesh and multi-process runs (A.10), the profiler trace and
the hang watchdog.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence, Union

import torch

from ..config import ExperimentConfig
from ..data.pipeline import build_pipeline
from ..metrics.jsonl import MetricsWriter
from ..runtime.platform import resolve_device
from .optim import build_optimizer, build_schedule
from .state import create_train_state
from .task import build_task
from .trainer import Trainer


def _workdir(cfg: ExperimentConfig) -> str:
    """The experiment's directory, as in the JAX package's layout."""
    return os.path.join(cfg.workdir, cfg.preset or cfg.model.name)


def _describe(device: torch.device) -> str:
    if device.type == "cuda":
        return (f"one device: {torch.cuda.get_device_name(device)} "
                f"({device})")
    return "one device: cpu"


def run_experiment(cfg: ExperimentConfig, max_steps: Optional[int] = None,
                   device: Union[str, torch.device] = "gpu",
                   hooks: Sequence[Callable] = ()) -> Dict[str, float]:
    """Train the experiment from a seeded init on ``device`` (``"gpu"``, the
    default, raises without a card; ``"cpu"`` runs the plain versions of the
    kernels) and return the final eval metrics. ``hooks`` run after every
    step as ``hook(step, state, last_record)``."""
    dev = resolve_device(device)
    task = build_task(cfg, dev)
    eval_batch = cfg.train.eval_batch or cfg.train.global_batch
    train_pipe = build_pipeline(cfg.data, cfg.train.global_batch,
                                cfg.model.num_classes, seed=cfg.train.seed,
                                train=True)
    eval_pipe = build_pipeline(cfg.data, eval_batch, cfg.model.num_classes,
                               seed=cfg.train.seed, train=False,
                               drop_remainder=not task.exact_eval)

    steps_per_epoch = max(train_pipe.steps_per_epoch, 1)
    total_steps = (cfg.train.steps if cfg.train.steps > 0
                   else int(cfg.train.epochs * steps_per_epoch))
    if max_steps is not None:
        total_steps = min(total_steps, max_steps)

    schedule = build_schedule(cfg.schedule, total_steps,
                              cfg.train.global_batch, steps_per_epoch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(cfg.train.seed))
    task.init(gen)
    optimizer = build_optimizer(cfg.optimizer, schedule, task.model)
    state = create_train_state(task.model, optimizer,
                               ema=cfg.train.ema_decay > 0)
    trainer = Trainer(cfg, task, dev)

    workdir = _workdir(cfg)
    writer = MetricsWriter(os.path.join(workdir, "metrics.jsonl"))
    print(f"[dlcfn-tpu] {_describe(dev)}")
    print(f"[dlcfn-tpu] total_steps={total_steps} "
          f"steps_per_epoch={steps_per_epoch} "
          f"global_batch={cfg.train.global_batch}")
    print("[dlcfn-tpu] no checkpoint is written: the port's ckpt/ is not "
          "ported yet (ROADMAP A.5)")
    eval_every = cfg.train.eval_every_steps or steps_per_epoch
    try:
        state = trainer.fit(
            state, train_pipe.epochs(), num_steps=total_steps,
            eval_iter_fn=lambda: eval_pipe.one_epoch(),
            eval_every=eval_every, hooks=tuple(hooks),
            log_every=cfg.train.log_every_steps, metrics_writer=writer)
        final = trainer.evaluate(state, eval_pipe.one_epoch())
        final_eval = getattr(task, "final_eval", None)
        if final_eval is not None and cfg.eval.enabled:
            final.update(final_eval(state, lambda: eval_pipe.one_epoch()))
        writer.write({"step": state.step,
                      **{f"final_eval_{k}": v for k, v in final.items()}})
    finally:
        writer.close()
    return final
