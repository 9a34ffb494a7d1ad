"""The trainer — the port of ``deeplearning_cfn_tpu/train/trainer.py``.

The JAX step is one jitted program (forward, backward, psum, optimizer
update) over the mesh. Here it is eager PyTorch on one card per process:
the task's forward, autograd (through the flash kernels' ``autograd.Function``),
the gradients summed over the processes, and the optimizer's in-place
update. What carries over exactly:

- the mesh (``parallel/mesh.py``): the global batch must split over its
  data ways (``validate_batch``), and each process trains its contiguous
  block of rows (the processes of a ``seq`` group the same block, each its
  slice of the sequence; those of a ``pipe`` group the same block, each its
  stage; those of a ``model`` group the same block, each its heads and
  hidden units; those of a ``spatial`` group the same block, each its
  slice of every image's rows). The task's loss is this process's share of the global-batch mean
  (``train/task.py``), so the gradients, summed right after the backward
  and before the clip — a replicated leaf's over every process, a piece of
  a leaf split over ``pipe``, ``model`` or ``expert`` over the processes
  that hold that piece, in one flat buffer per group — are the single-program
  gradients, and ``grad_norm`` is their global norm (every piece counted
  once, ``Optimizer.grad_norm``). Metrics are summed over the processes once per log boundary (and
  per eval batch), not per step. ``examples_per_sec_per_device`` divides by
  the mesh's devices;

- one dropout generator, reseeded to ``(seed, step)`` before every step, so
  a step's noise does not depend on earlier steps (the role of
  ``fold_in(rng, state.step)``); microbatches draw from it in turn;
- gradient accumulation with the STRIDED microbatch split (row i goes to
  microbatch i % accum) and uniform averaging of microbatch means. Applied
  to each process's block it is JAX's split of the global batch while the
  block's rows divide by ``accum``, which is checked;
- ``grad_norm`` is the global norm of the unclipped (averaged) gradients;
- ``train.step_window`` K > 1 runs fused windows of up to K steps
  (:meth:`Trainer.window_step`, metrics stacked ``[k]``), planned by
  :func:`_plan_window` so that the log, eval, hook (checkpoint) and trace
  cadences land on window edges. On the card a window replays one captured
  CUDA graph per step (``train/graphs.py``; the first step eager, then the
  capture); on the CPU it runs k eager steps, the plain version. K = 1 is
  the per-step loop;
- across processes each process draws its rows' dropout from a
  ``(seed, step, data block)`` stream (``Mesh.data_index``), where the JAX
  step draws one mask over the global batch: a difference kept on purpose
  (ROADMAP). The processes of a ``model``, ``spatial``, ``seq`` or
  ``pipe`` group share a block, so they draw the same masks on the
  activations they share, and their replicated leaves stay equal;
- a task with ``spatial_keys`` (Mask R-CNN: ``image``) has each process of
  a ``spatial`` group keep its ``spatial_index``-th slice of dim
  ``spatial_dim`` (the height) of those keys' arrays of 4 or more dims
  (JAX's ``_spatial_for``): :meth:`Trainer.local_batch`, applied in every
  train and eval step;
- ``fit`` syncs only at ``log_every`` boundaries and once after the first
  window (whose time, kernel builds and graph capture included, is reported
  as ``compile_s`` and kept out of the throughput window), and writes the
  same JSONL records; with K > 1 a boundary realizes the PREVIOUS window,
  so records lag one boundary and the final one flushes both;
- ``evaluate`` aggregates by each batch's ``eval_weight``, so metrics are
  exact over the full eval set, then adds the task's ``eval_derived``
  metrics (functions of the aggregates: perplexity = exp(mean CE) is not
  the mean of per-batch exp(CE));
- BatchNorm running statistics (the JAX step's ``batch_stats``) are model
  buffers that each train-mode forward updates, so under accumulation they
  advance microbatch by microbatch in order, as the JAX scan threads them;
- an f32 ``train.dtype`` computes in f32 on the card: TF32 is switched off
  for cuDNN convolutions (on by default in PyTorch) and matmuls, in one
  place, when the trainer is built for such a run;
- ``train.hang_timeout_s > 0`` arms a :class:`~..runtime.watchdog.StepWatchdog`
  (exit code 89 when the beats stop), beaten where the JAX loop beats it:
  at the first sync, at every realized log boundary, after a hook that took
  over a second, after an eval, and after every eval batch;
- ``trace_dir`` + ``trace_steps`` (``train.profile_steps``) trace that many
  steps after the first with ``torch.profiler``, the card synchronised before
  the trace stops.

``train.remat`` is the task's (``train/task.py:remat``). The JAX
``train.grad_accum_unroll`` (how XLA lowers the microbatch loop) is
validated as JAX validates it; the port's microbatch loop is eager either
way.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ExperimentConfig
from ..data.pipeline import DevicePrefetcher, to_device
from ..obs.trace import span
from ..parallel.collectives import all_reduce_sum_, reduce_scalars
from ..parallel.mesh import build_mesh, validate_batch
from ..parallel.sharding import spatial_slice
from .graphs import GraphedStep, StepGenerator
from .state import TrainState

Metrics = Dict[str, torch.Tensor]


def _plan_window(step: int, num_steps: int, window: int,
                 cadences, boundaries=()) -> int:
    """Largest k <= ``window`` such that the half-open step range
    [step, step+k) crosses no cadence multiple and no explicit boundary
    except at its end — so log/eval/hook cadences and trace start/stop
    always land exactly on a window edge, never inside a fused window."""
    k = min(window, num_steps - step)
    for c in cadences:
        if c and c > 0:
            k = min(k, c - step % c)
    for b in boundaries:
        if b > step:
            k = min(k, b - step)
    return max(k, 1)


def check_window(step_window: int, processes: int) -> None:
    """Refuse ``train.step_window`` > 1 across processes (before a
    launch, too)."""
    if step_window > 1 and processes > 1:
        raise NotImplementedError(
            f"train.step_window={step_window} over {processes} processes: "
            f"a window replays CUDA graphs, which cannot capture gloo's "
            f"collectives, and NCCL under capture is not ported yet "
            f"(ROADMAP A.10)")


class Trainer:
    """Owns the train/eval steps and the step loop for one task on this
    process's device. ``task.loss_fn(batch, train, generator) -> (loss,
    aux)`` must return this process's share of the global-batch mean loss
    and of each metric (the whole mean with one process)."""

    def __init__(self, cfg: ExperimentConfig, task, device: torch.device,
                 mesh=None):
        self.cfg = cfg
        self.task = task
        self.device = torch.device(device)
        self.eval_derived = dict(getattr(task, "eval_derived", None) or {})
        self.mesh = mesh if mesh is not None else build_mesh(cfg.mesh)
        self.world = self.mesh.process_count
        # Metrics every process holds whole: taken from process 0, not
        # summed.
        self.replicated = ("grad_norm",
                           *getattr(task, "replicated_metrics", ()))
        gb = cfg.train.global_batch
        validate_batch(gb, self.mesh)
        accum = cfg.train.grad_accum_steps
        if accum < 1 or gb % accum != 0:
            raise ValueError(
                f"global batch {gb} must be divisible "
                f"by grad_accum_steps ({accum})")
        if accum > 1:
            # Each microbatch must still split over the data ways; then each
            # process's block of rows divides by accum, and the strided
            # split of the block is JAX's split of the global batch.
            validate_batch(gb // accum, self.mesh)
        if cfg.train.grad_accum_unroll not in ("auto", "scan", "unroll"):
            # Checked on every build, as the JAX trainer does, so a typo
            # does not stay silent until accumulation is switched on.
            raise ValueError(
                f"train.grad_accum_unroll must be auto|scan|unroll, got "
                f"{cfg.train.grad_accum_unroll!r}")
        if cfg.train.step_window < 1:
            raise ValueError(
                f"train.step_window must be >= 1, got "
                f"{cfg.train.step_window}")
        check_window(cfg.train.step_window, self.world)
        if cfg.train.device_prefetch < 0:
            raise ValueError(
                f"train.device_prefetch must be >= 0, got "
                f"{cfg.train.device_prefetch}")
        if cfg.train.dtype == "float32" and self.device.type == "cuda":
            # An f32 preset computes in f32. cuDNN runs f32 convolutions on
            # TF32 unless told not to (allow_tf32 defaults to True for
            # convs, unlike matmuls); the switch is process-wide.
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.generator = StepGenerator(
            self.device, cfg.train.seed,
            self.mesh.data_index if self.world > 1 else None)
        self.spatial_dim = getattr(task, "spatial_dim", None)
        self.spatial_keys = getattr(task, "spatial_keys", None)
        self.graphs = GraphedStep(self.device) if (
            cfg.train.step_window > 1 and self.device.type == "cuda") \
            else None

    # -- steps --------------------------------------------------------------

    def local_batch(self, batch: Dict) -> Dict:
        """This process's part of a batch of its rows: with a ``spatial``
        axis, its slice of dim ``spatial_dim`` of the task's
        ``spatial_keys`` (views; the batch itself without one)."""
        if self.spatial_dim is None or self.mesh.spatial_ways == 1:
            return batch
        return {k: spatial_slice(v, self.mesh, self.spatial_dim)
                if k in self.spatial_keys and v.ndim >= 4 else v
                for k, v in batch.items()}

    def grads_and_metrics(self, state: TrainState, batch: Dict,
                          generator: torch.Generator) -> Metrics:
        """Forward + backward of one step, leaving the (microbatch-mean)
        gradients in the parameters' ``.grad``. Returns detached metrics."""
        batch = self.local_batch(batch)
        state.optimizer.zero_grad()
        accum = self.cfg.train.grad_accum_steps
        loss_fn = self.task.loss_fn
        if accum == 1:
            loss, aux = loss_fn(batch, True, generator)
            loss.backward()
            return {"loss": loss.detach(),
                    **{k: v.detach() for k, v in aux.items()}}
        sums: Metrics = {}
        for i in range(accum):
            # Strided split: row r goes to microbatch r % accum.
            micro = {k: v[i::accum] for k, v in batch.items()}
            loss, aux = loss_fn(micro, True, generator)
            (loss / accum).backward()
            for k, v in (("loss", loss), *aux.items()):
                sums[k] = sums[k] + v.detach() if k in sums else v.detach()
        return {k: v / accum for k, v in sums.items()}

    def prepare_step(self, state: TrainState) -> None:
        """The host's part of a step, ahead of its device work: the dropout
        generator reseeded to ``(seed, state.step)`` and the optimizer's
        learning rate and count written to its device scalars."""
        self.generator.reseed(state.step)
        state.optimizer.prepare()

    def step_body(self, state: TrainState, batch: Dict) -> Metrics:
        """The device work of a step: forward and backward, the gradients
        summed over the processes, the global norm, the update and the EMA.
        With one process it reads no value from the host, so a CUDA graph
        can capture it (``train/graphs.py``)."""
        metrics = self.grads_and_metrics(state, batch, self.generator)
        all_reduce_sum_(state.optimizer.grads(),
                        state.optimizer.grad_groups())
        grad_norm = state.optimizer.grad_norm()
        state.update(self.cfg.train.ema_decay, grad_norm)
        metrics["grad_norm"] = grad_norm
        return metrics

    def train_step(self, state: TrainState, batch: Dict) -> Metrics:
        """One eager optimizer step; ``state`` is updated in place."""
        self.prepare_step(state)
        metrics = self.step_body(state, batch)
        state.advance()
        return metrics

    def window_step(self, state: TrainState,
                    batches: Sequence[Dict]) -> Metrics:
        """``len(batches)`` consecutive steps, each metric stacked ``[k]``
        (the JAX ``window_step``). On the card with ``train.step_window`` >
        1 each step replays its captured graph (after the eager warm-up
        step); otherwise the steps run eagerly, one by one."""
        if self.graphs is not None:
            return self.graphs.window(self, state, batches)
        steps = [self.train_step(state, b) for b in batches]
        return {k: torch.stack([m[k] for m in steps]) for k in steps[0]}

    def eval_step(self, state: TrainState, batch: Dict) -> Metrics:
        with torch.no_grad(), state.eval_weights():
            loss, aux = self.task.loss_fn(self.local_batch(batch), False)
        return {"loss": loss, **aux}

    # -- loops --------------------------------------------------------------

    def fit(self, state: TrainState, train_iter: Iterator[Dict[str,
                                                              np.ndarray]],
            num_steps: int,
            eval_iter_fn: Optional[Callable[[], Iterator]] = None,
            eval_every: int = 0,
            hooks: Tuple[Callable[[int, TrainState,
                                   Optional[Dict[str, float]]], None],
                         ...] = (),
            log_every: int = 50, metrics_writer=None,
            trace_dir: Optional[str] = None,
            trace_steps: int = 0, hook_every: int = 1) -> TrainState:
        """The step loop. Syncs with the card only at ``log_every``
        boundaries (and after the first window), so the host runs ahead
        enqueueing work; host batches are staged to the device
        ``train.device_prefetch`` deep on a background thread. Records carry
        ``examples_per_sec``, ``step_time_s`` and
        ``target_tokens_per_sec`` over the window since the last record.

        With ``train.step_window`` K > 1, up to K steps run as one
        :meth:`window_step`; windows are clamped so the log, eval and hook
        cadences and the trace start and stop land on a window edge. Hooks
        run at every window edge with ``(step, state, last record)``, and
        ``hook_every`` names the cadence (in steps) they must land on
        exactly (``run.py`` passes the checkpoint cadence). A boundary
        realizes the previous window, which has finished on the card, so
        records lag one boundary and the final boundary flushes both
        pending windows, as the JAX loop does. K = 1 is the per-step loop.

        ``trace_dir`` + ``trace_steps``: a profiler trace of that many steps,
        skipping the first (its kernel builds and allocations)."""
        from ..runtime.profiling import trace_steps as profiler_trace

        watchdog = None
        if self.cfg.train.hang_timeout_s > 0:
            from ..runtime.watchdog import StepWatchdog

            # The first window builds kernels (and captures the graph)
            # inside the first sync: it gets the same budget again on top.
            watchdog = StepWatchdog(
                self.cfg.train.hang_timeout_s,
                first_beat_grace_s=self.cfg.train.hang_timeout_s)
        step = state.step
        trace_start = step + 1 if trace_dir and trace_steps > 0 else -1
        trace_stop = trace_start + trace_steps
        trace_stack = contextlib.ExitStack()
        tracing = False
        gb = self.cfg.train.global_batch
        K = self.cfg.train.step_window
        # Cadences a window must not straddle. hook_every binds only when
        # there are hooks to land; log_every=0 still logs every step.
        cadences = [max(log_every, 1)]
        if eval_iter_fn is not None and eval_every > 0:
            cadences.append(eval_every)
        if hooks and hook_every > 0:
            cadences.append(hook_every)
        depth = self.cfg.train.device_prefetch
        if depth > 0:
            batch_iter = DevicePrefetcher(train_iter, self.device, depth)
        else:
            batch_iter = (to_device(b, self.device) for b in train_iter)
        window_start = time.perf_counter()
        window_examples = 0
        window_tokens: Optional[torch.Tensor] = None
        last: Optional[tuple] = None
        prev: Optional[tuple] = None
        realized_thru = step - 1  # the last step index already logged
        compile_s: Optional[float] = None
        first_sync_done = False
        last_realized: Optional[Dict[str, float]] = None
        try:
            while step < num_steps:
                if step == trace_start:
                    trace_stack.enter_context(profiler_trace(
                        trace_dir, cuda=self.device.type == "cuda"))
                    tracing = True
                k = 1 if K == 1 else _plan_window(
                    step, num_steps, K, cadences, (trace_start, trace_stop))
                batches = [next(batch_iter) for _ in range(k)]
                with span("train.dispatch", step=step, k=k):
                    metrics = self.train_step(state, batches[0]) if K == 1 \
                        else self.window_step(state, batches)
                prev, last = last, (step + k - 1, metrics)
                window_examples += gb * k
                for batch in batches:
                    if "tgt_mask" in batch:
                        tokens = batch["tgt_mask"].sum()
                        window_tokens = tokens if window_tokens is None \
                            else window_tokens + tokens
                step += k
                if tracing and step >= trace_stop:
                    self._sync()
                    trace_stack.close()
                    tracing = False
                if not first_sync_done and (
                        self.graphs is None or not self.graphs.warming_up
                        or step >= num_steps):
                    # The first window built the kernels (and captured the
                    # graph): sync on it, report it as compile_s, and
                    # restart the throughput window.
                    self._sync()
                    compile_s = time.perf_counter() - window_start
                    window_start = time.perf_counter()
                    window_examples = 0
                    window_tokens = None
                    first_sync_done = True
                    if watchdog is not None:
                        watchdog.beat()
                if step % max(log_every, 1) == 0 or step >= num_steps:
                    # The per-step loop realizes the latest step. Windowed
                    # runs realize the PREVIOUS window, which has finished
                    # on the card (its successor was dispatched after it);
                    # the final boundary flushes both pending windows.
                    at_end = step >= num_steps
                    to_realize = []
                    if K == 1:
                        to_realize.append(last)
                    else:
                        if prev is not None and prev[0] > realized_thru:
                            to_realize.append(prev)
                        if at_end and last[0] > realized_thru:
                            to_realize.append(last)
                    first_write = True
                    for w_end, w_metrics in to_realize:
                        with span("train.realize", step=w_end + 1):
                            realized = self._realize(w_metrics)
                        if first_write:
                            # Throughput covers everything dispatched since
                            # the last written boundary; the final flush's
                            # second record carries step metrics only.
                            tokens = None if window_tokens is None \
                                else self._realize(
                                    {"tokens": window_tokens})["tokens"]
                            elapsed = time.perf_counter() - window_start
                            if window_examples > 0:
                                realized["examples_per_sec"] = \
                                    window_examples / max(elapsed, 1e-9)
                                realized["examples_per_sec_per_device"] = \
                                    realized["examples_per_sec"] \
                                    / self.mesh.size
                                realized["step_time_s"] = \
                                    elapsed / max(window_examples // gb, 1)
                                if tokens is not None:
                                    realized["target_tokens_per_sec"] = \
                                        tokens / max(elapsed, 1e-9)
                            window_start = time.perf_counter()
                            window_examples = 0
                            window_tokens = None
                            first_write = False
                        realized["step"] = w_end + 1
                        if compile_s is not None:
                            realized["compile_s"] = compile_s
                            compile_s = None
                        if metrics_writer is not None:
                            metrics_writer.write(realized)
                        realized_thru = w_end
                        last_realized = realized
                    if to_realize and watchdog is not None:
                        watchdog.beat()  # the values above came off the card
                t_hooks = time.perf_counter()
                for hook in hooks:
                    hook(step, state, last_realized)
                if watchdog is not None and \
                        time.perf_counter() - t_hooks > 1.0:
                    # A hook that did real host work (a slow checkpoint
                    # write) and finished is progress; ordinary sub-ms hooks
                    # must not beat, or a device hang behind async launches
                    # would go unseen.
                    watchdog.beat()
                if eval_iter_fn is not None and eval_every > 0 \
                        and step % eval_every == 0:
                    with span("train.eval", step=step):
                        eval_metrics = self.evaluate(state, eval_iter_fn(),
                                                     watchdog=watchdog)
                    if metrics_writer is not None:
                        metrics_writer.write(
                            {"step": step, **{f"eval_{k}": v for k, v in
                                              eval_metrics.items()}})
                    if watchdog is not None:
                        watchdog.beat()
            return state
        finally:
            if watchdog is not None:
                watchdog.stop()
            trace_stack.close()  # a no-op unless the loop left mid-trace
            # Stop the staging thread (it closes train_iter) or close the
            # host iterator, so no prefetch worker outlives the loop.
            if isinstance(batch_iter, DevicePrefetcher):
                batch_iter.close()
            elif getattr(train_iter, "close", None) is not None:
                train_iter.close()

    def _realize(self, metrics: Metrics) -> Dict[str, float]:
        """Host values of a step's (or the last of a window's) metrics:
        summed over the processes in one collective, the replicated ones
        taken from process 0."""
        if self.world == 1:
            return {k: float(v.reshape(-1)[-1]) for k, v in metrics.items()}
        return reduce_scalars(metrics, self.replicated)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def evaluate(self, state: TrainState, eval_iter: Iterator,
                 watchdog=None) -> Dict[str, float]:
        """Weighted cross-batch aggregation: each batch's metrics carry
        their normalizer (``eval_weight``, or a per-metric
        ``<name>__weight``), so the result is the exact full-set metric.
        Across processes each batch's metrics and weights are first summed
        over the processes (each evaluates its rows of the global batch).
        ``watchdog`` is beaten after every realized batch."""
        totals: Dict[str, float] = {}
        wsums: Dict[str, float] = {}
        examples = 0.0
        eb = self.cfg.train.eval_batch or self.cfg.train.global_batch
        for batch in eval_iter:
            metrics = self._realize(self.eval_step(
                state, to_device(batch, self.device)))
            if watchdog is not None:
                watchdog.beat()
            default_w = metrics.pop("eval_weight", float(eb))
            examples += default_w
            for k, v in metrics.items():
                if k.endswith("__weight"):
                    continue
                w = metrics.get(f"{k}__weight", default_w)
                totals[k] = totals.get(k, 0.0) + v * w
                wsums[k] = wsums.get(k, 0.0) + w
        out = {k: totals[k] / max(wsums[k], 1e-9) for k in totals}
        out["examples"] = examples
        for name, fn in self.eval_derived.items():
            out[name] = float(fn(out))
        return out
