"""Experiment runner: config in → trained model out — the port of
``deeplearning_cfn_tpu/train/run.py``.

``run_experiment`` builds the task (model on the device, seeded init), the
train and eval pipelines, the schedule and optimizer, the train state, and
the :class:`~..ckpt.CheckpointManager` (``<workdir>/<preset>/ckpt`` unless
``checkpoint.directory`` says otherwise; every ``checkpoint.every_steps``
steps or once per epoch, ``keep``, ``async_write``, the store's retry
policy). With ``checkpoint.resume`` it first sweeps torn step directories,
then restores the latest committed checkpoint — the port's own or the JAX
package's — and the pipeline starts at the restored step's batch. It runs
``Trainer.fit`` (checkpoint hook, ``train.profile_steps`` trace into
``<workdir>/<preset>/profile``, ``train.hang_timeout_s`` watchdog), forces a
final save and waits for it, then the weighted full-set eval plus the task's
own acceptance metric where it has one (BLEU for NMT). Records go to
``<workdir>/<preset>/metrics.jsonl`` and stdout, as in the JAX package; with
obs on (``DLCFN_OBS_OFF`` unset) the span records (``train.dispatch``,
``train.realize``, ``train.eval``, ``ckpt.save``, ``ckpt.restore``,
``ckpt.store_retry``) go into the same ``metrics.jsonl`` (not stdout), and
the end of the run writes ``<workdir>/<preset>/metrics.prom`` from the
tracer's registry. ``DLCFN_CHAOS_KILL_AT_STEP`` arms the chaos SIGKILL hook
after the checkpoint hook (``runtime/faults.py``; the launcher's crash
recovery test harness sets it).

Across processes (a job that ``runtime.cluster.initialize`` joined) every
process runs this function in lockstep on its own card: the mesh resolves
over the processes (``parallel/mesh.py``), each pipeline yields this
process's rows of the global batch (the same rows for the processes of a
``seq`` group, which split each row's sequence), ``train.shard_opt_state``
shards the optimizer's slots (ZeRO-1), and every process writes its part of
each checkpoint. Process 0 alone sweeps torn checkpoints, picks the step every
process restores, prints, and writes ``metrics.jsonl``, the span records
and ``metrics.prom``, as in the JAX package.

``run_eval`` evaluates a committed checkpoint without training.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from ..ckpt import CheckpointManager, latest_checkpoint, \
    retry_policy_from_config
from ..config import ExperimentConfig
from ..data.pipeline import build_pipeline
from ..metrics.jsonl import MetricsWriter
from ..obs.sinks import JsonlSink, write_prometheus
from ..obs.trace import get_tracer, obs_enabled
from ..parallel.collectives import broadcast_object
from ..parallel.mesh import Mesh, build_mesh, describe, local_batch_size
from ..runtime.faults import chaos_kill_hook_from_env
from ..runtime.platform import resolve_device
from .optim import build_optimizer, build_schedule
from .state import create_train_state
from .task import build_task
from .trainer import Trainer


def _workdir_and_ckpt_dir(cfg: ExperimentConfig) -> Tuple[str, str]:
    """The one definition of the experiment's on-disk layout (the JAX
    package's)."""
    workdir = os.path.join(cfg.workdir, cfg.preset or cfg.model.name)
    ckpt_dir = cfg.checkpoint.directory or os.path.join(workdir, "ckpt")
    return workdir, ckpt_dir


def _describe(device: torch.device, mesh: Optional[Mesh] = None) -> str:
    """The one device's line; across processes JAX's mesh line first."""
    if device.type == "cuda":
        line = (f"one device: {torch.cuda.get_device_name(device)} "
                f"({device})")
    else:
        line = "one device: cpu"
    if mesh is None or mesh.process_count == 1:
        return line
    return f"{describe(mesh)}; process {mesh.process_index}: {line}"


def _pipeline(cfg: ExperimentConfig, mesh: Mesh, batch: int, **kw):
    """This process's rows of every global batch of ``batch``: its block
    (``mesh.data_index`` of ``mesh.data_ways``; the processes of a ``seq``
    group read the same rows)."""
    return build_pipeline(cfg.data, local_batch_size(batch, mesh),
                          cfg.model.num_classes, seed=cfg.train.seed,
                          process_index=mesh.data_index,
                          process_count=mesh.data_ways, **kw)


def _eval_pipe(cfg: ExperimentConfig, task, mesh: Mesh):
    eval_batch = cfg.train.eval_batch or cfg.train.global_batch
    return _pipeline(cfg, mesh, eval_batch, train=False,
                     drop_remainder=not task.exact_eval)


def _final_eval(cfg, task, trainer, state, eval_pipe) -> Dict[str, float]:
    """Weighted full-set eval + the workload's own acceptance metric."""
    final = trainer.evaluate(state, eval_pipe.one_epoch())
    final_eval = getattr(task, "final_eval", None)
    if final_eval is not None and cfg.eval.enabled:
        final.update(final_eval(state, lambda: eval_pipe.one_epoch()))
    return final


def run_eval(cfg: ExperimentConfig, step: int = 0,
             device: Union[str, torch.device] = "gpu") -> Dict[str, float]:
    """Evaluate the latest committed checkpoint (or the exact ``step``) on
    ``device`` without taking a training step: the weighted full-set eval
    plus the task's acceptance metric, with ``checkpoint_step``. Only the
    step, params, batch stats and EMA are read, so a checkpoint of any
    optimizer (and of either package) evaluates."""
    _, ckpt_dir = _workdir_and_ckpt_dir(cfg)
    # Fail on a wrong workdir or preset before building anything.
    if latest_checkpoint(ckpt_dir) is None:
        raise FileNotFoundError(
            f"no committed checkpoint to evaluate in {ckpt_dir}")
    dev = resolve_device(device)
    mesh = build_mesh(cfg.mesh)
    task = build_task(cfg, dev, mesh=mesh)
    eval_pipe = _eval_pipe(cfg, task, mesh)
    state = create_train_state(task.model, None,
                               ema=cfg.train.ema_decay > 0)
    manager = CheckpointManager(ckpt_dir,
                                retry=retry_policy_from_config(cfg.checkpoint))
    leaves, at_step = manager.restore_or_none(state, step=step)
    state.load_named(leaves)
    if mesh.process_index == 0:
        print(f"[dlcfn-tpu] evaluating checkpoint step {at_step} "
              f"({_describe(dev, mesh)})")
    metrics = _final_eval(cfg, task, Trainer(cfg, task, dev, mesh), state,
                          eval_pipe)
    metrics["checkpoint_step"] = int(at_step)
    return metrics


def run_experiment(cfg: ExperimentConfig, max_steps: Optional[int] = None,
                   device: Union[str, torch.device] = "gpu",
                   hooks: Sequence[Callable] = ()) -> Dict[str, float]:
    """Train (or resume) the experiment on ``device`` (``"gpu"``, the
    default, raises without a card; ``"cpu"`` runs the plain versions of the
    kernels) and return the final eval metrics. ``hooks`` run after every
    step (at every window edge with ``train.step_window`` > 1), after the
    checkpoint hook (and before the chaos kill hook, when armed), as
    ``hook(step, state, last_record)``."""
    dev = resolve_device(device)
    mesh = build_mesh(cfg.mesh)
    lead = mesh.process_index == 0
    task = build_task(cfg, dev, mesh=mesh)
    train_pipe = _pipeline(cfg, mesh, cfg.train.global_batch, train=True)
    eval_pipe = _eval_pipe(cfg, task, mesh)

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
    optimizer = build_optimizer(cfg.optimizer, schedule, task.model,
                                shard_opt_state=cfg.train.shard_opt_state)
    state = create_train_state(task.model, optimizer,
                               ema=cfg.train.ema_decay > 0)
    if optimizer.owners is not None:
        print(f"[dlcfn-tpu] process {mesh.process_index}: ZeRO-1 optimizer "
              f"slots {optimizer.slot_bytes()} bytes on this process of "
              f"{optimizer.slot_bytes(owned_only=False)} in all "
              f"({mesh.process_count} processes)", flush=True)

    workdir, ckpt_dir = _workdir_and_ckpt_dir(cfg)
    ckpt_every = cfg.checkpoint.every_steps or steps_per_epoch
    manager = CheckpointManager(ckpt_dir, every_steps=ckpt_every,
                                keep=cfg.checkpoint.keep,
                                async_write=cfg.checkpoint.async_write,
                                retry=retry_policy_from_config(cfg.checkpoint))
    if cfg.checkpoint.resume:
        # Sweep torn step directories of a dead attempt before anything
        # else touches the store: no save is in flight yet, and a re-save
        # of a swept step must start from an empty directory. Process 0
        # sweeps and picks the step that every process restores.
        latest = None
        if lead:
            orphans = manager.sweep_orphans()
            if orphans:
                print(f"[dlcfn-tpu] swept {len(orphans)} uncommitted "
                      f"checkpoint dir(s): steps {orphans}")
            latest = latest_checkpoint(manager.store)
        latest = broadcast_object(latest)
        if latest is not None:
            leaves, at_step = manager.restore_or_none(state, step=latest)
            state.load_named(leaves)
            if lead:
                print(f"[dlcfn-tpu] resumed from step {at_step}")
    trainer = Trainer(cfg, task, dev, mesh)

    metrics_path = os.path.join(workdir, "metrics.jsonl")
    writer = MetricsWriter(metrics_path)
    # Span records flow into the same metrics.jsonl as additive lines with
    # a "span" key, not on stdout (spans are high-rate; stdout stays the
    # human stream).
    span_sink = None
    if obs_enabled():
        span_sink = JsonlSink(MetricsWriter(metrics_path, also_stdout=False))
        get_tracer().add_sink(span_sink)
    if lead:
        print(f"[dlcfn-tpu] {_describe(dev, mesh)}")
        print(f"[dlcfn-tpu] total_steps={total_steps} "
              f"steps_per_epoch={steps_per_epoch} "
              f"global_batch={cfg.train.global_batch}")

    def ckpt_hook(step, st, _record):
        manager.save(step, st)

    # The chaos kill (test harness, env-gated) goes last: the SIGKILL then
    # lands between a dispatched save and the next one — the torn-commit
    # window the recovery contract must survive.
    all_hooks = [ckpt_hook, *hooks]
    chaos_hook = chaos_kill_hook_from_env(
        committed=lambda step: step in manager.committed())
    if chaos_hook is not None:
        all_hooks.append(chaos_hook)

    eval_every = cfg.train.eval_every_steps or steps_per_epoch
    try:
        state = trainer.fit(
            state,
            train_pipe.epochs(start_epoch=state.step // steps_per_epoch,
                              skip_batches=state.step % steps_per_epoch),
            num_steps=total_steps,
            eval_iter_fn=lambda: eval_pipe.one_epoch(),
            eval_every=eval_every, hooks=tuple(all_hooks),
            log_every=cfg.train.log_every_steps, metrics_writer=writer,
            trace_dir=os.path.join(workdir, "profile")
            if cfg.train.profile_steps > 0 else None,
            trace_steps=cfg.train.profile_steps,
            # Windows (train.step_window > 1) clamp to the checkpoint
            # cadence, so checkpoints commit on their exact steps.
            hook_every=ckpt_every)
        manager.save(state.step, state, force=True)
        manager.wait()
        final = _final_eval(cfg, task, trainer, state, eval_pipe)
        writer.write({"step": state.step,
                      "ckpt_store_retries": manager.store_retries(),
                      **{f"final_eval_{k}": v for k, v in final.items()}})
    finally:
        # A save still in flight when the loop raised finishes before the
        # caller (a retry, a resume in this process) touches the store.
        manager.wait()
        writer.close()
        if span_sink is not None:
            get_tracer().remove_sink(span_sink)
            span_sink.close()
        if obs_enabled() and lead:
            # One end-of-run Prometheus text snapshot of every instrument
            # the tracer's registry accumulated (span_dur_s histograms
            # included): scrape-by-file, no server.
            write_prometheus(get_tracer().registry,
                             os.path.join(workdir, "metrics.prom"))
    return final
