"""The trainer — the port of ``deeplearning_cfn_tpu/train/trainer.py`` for
one device.

The JAX step is one jitted program (forward, backward, psum, optimizer
update). Here it is eager PyTorch on one card: the task's forward, autograd
(through the flash kernels' ``autograd.Function``), and the optimizer's
in-place update. What carries over exactly:

- one dropout ``torch.Generator`` per step, seeded from ``(seed, step)``, so
  a step's noise does not depend on earlier steps (the role of
  ``fold_in(rng, state.step)``); microbatches draw from it in turn;
- gradient accumulation with the STRIDED microbatch split (row i goes to
  microbatch i % accum) and uniform averaging of microbatch means;
- ``grad_norm`` is the global norm of the unclipped (averaged) gradients;
- ``fit`` syncs only at ``log_every`` boundaries and on the first step
  (whose time, kernel builds included, is reported as ``compile_s`` and
  kept out of the throughput window), and writes the same JSONL records;
- ``evaluate`` aggregates by each batch's ``eval_weight``, so metrics are
  exact over the full eval set.

Not ported in this slice: ``train.step_window > 1`` (fused multi-step
windows; on the card that is CUDA graphs, ROADMAP A.5 step_window) and
``train.remat`` (``torch.utils.checkpoint`` restores only the global RNG,
so with the explicit dropout generator its recompute would draw different
masks; ROADMAP A.5 remat). Both raise.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..config import ExperimentConfig
from ..data.pipeline import DevicePrefetcher, to_device
from ..obs.trace import span
from .optim import global_norm
from .state import TrainState

Metrics = Dict[str, torch.Tensor]


def step_seed(seed: int, step: int) -> int:
    """A well-mixed 63-bit seed for ``(seed, step)``."""
    return int(np.random.SeedSequence([int(seed), int(step)])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


class Trainer:
    """Owns the train/eval steps and the step loop for one task on one
    device. ``task.loss_fn(batch, train, generator) -> (loss, aux)`` must
    return a batch-mean loss and scalar metrics."""

    def __init__(self, cfg: ExperimentConfig, task, device: torch.device):
        self.cfg = cfg
        self.task = task
        self.device = torch.device(device)
        accum = cfg.train.grad_accum_steps
        if accum < 1 or cfg.train.global_batch % accum != 0:
            raise ValueError(
                f"global batch {cfg.train.global_batch} must be divisible "
                f"by grad_accum_steps ({accum})")
        if cfg.train.step_window < 1:
            raise ValueError(
                f"train.step_window must be >= 1, got "
                f"{cfg.train.step_window}")
        if cfg.train.step_window > 1:
            raise NotImplementedError(
                "train.step_window > 1 is not ported yet (ROADMAP A.5 "
                "step_window: CUDA graphs over fused steps)")
        if cfg.train.remat:
            raise NotImplementedError(
                "train.remat is not ported yet (ROADMAP A.5 remat: "
                "torch.utils.checkpoint restores only the global RNG, so its "
                "recompute would draw other dropout masks than the explicit "
                "generator did)")
        if cfg.train.device_prefetch < 0:
            raise ValueError(
                f"train.device_prefetch must be >= 0, got "
                f"{cfg.train.device_prefetch}")

    # -- steps --------------------------------------------------------------

    def step_generator(self, step: int) -> torch.Generator:
        """The dropout generator of one step, seeded from (seed, step)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(step_seed(self.cfg.train.seed, step))
        return gen

    def grads_and_metrics(self, state: TrainState, batch: Dict,
                          generator: torch.Generator) -> Metrics:
        """Forward + backward of one step, leaving the (microbatch-mean)
        gradients in the parameters' ``.grad``. Returns detached metrics."""
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

    def train_step(self, state: TrainState, batch: Dict) -> Metrics:
        """One optimizer step; ``state`` is updated in place."""
        metrics = self.grads_and_metrics(state, batch,
                                         self.step_generator(state.step))
        grad_norm = global_norm(state.optimizer.grads())
        state.apply_gradients(self.cfg.train.ema_decay, grad_norm)
        metrics["grad_norm"] = grad_norm
        return metrics

    def eval_step(self, state: TrainState, batch: Dict) -> Metrics:
        with torch.no_grad(), state.eval_weights():
            loss, aux = self.task.loss_fn(batch, False)
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
            log_every: int = 50, metrics_writer=None) -> TrainState:
        """The step loop. Syncs with the card only at ``log_every``
        boundaries (and after the first step), so the host runs ahead
        enqueueing work; host batches are staged to the device
        ``train.device_prefetch`` deep on a background thread. Records carry
        ``examples_per_sec``, ``step_time_s`` and
        ``target_tokens_per_sec`` over the window since the last record.
        Hooks run after every step with ``(step, state, last record)``."""
        step = state.step
        gb = self.cfg.train.global_batch
        depth = self.cfg.train.device_prefetch
        if depth > 0:
            batch_iter = DevicePrefetcher(train_iter, self.device, depth)
        else:
            batch_iter = (to_device(b, self.device) for b in train_iter)
        window_start = time.perf_counter()
        window_examples = 0
        window_tokens: Optional[torch.Tensor] = None
        compile_s: Optional[float] = None
        first_sync_done = False
        last_realized: Optional[Dict[str, float]] = None
        try:
            while step < num_steps:
                batch = next(batch_iter)
                with span("train.dispatch", step=step, k=1):
                    metrics = self.train_step(state, batch)
                step += 1
                window_examples += gb
                if "tgt_mask" in batch:
                    tokens = batch["tgt_mask"].sum()
                    window_tokens = tokens if window_tokens is None \
                        else window_tokens + tokens
                if not first_sync_done:
                    self._sync()
                    compile_s = time.perf_counter() - window_start
                    window_start = time.perf_counter()
                    window_examples = 0
                    window_tokens = None
                    first_sync_done = True
                if step % max(log_every, 1) == 0 or step >= num_steps:
                    with span("train.realize", step=step):
                        realized = {k: float(v) for k, v in metrics.items()}
                        tokens = None if window_tokens is None \
                            else float(window_tokens)
                    elapsed = time.perf_counter() - window_start
                    if window_examples > 0:
                        realized["examples_per_sec"] = \
                            window_examples / max(elapsed, 1e-9)
                        realized["examples_per_sec_per_device"] = \
                            realized["examples_per_sec"]
                        realized["step_time_s"] = \
                            elapsed / max(window_examples // gb, 1)
                        if tokens is not None:
                            realized["target_tokens_per_sec"] = \
                                tokens / max(elapsed, 1e-9)
                    window_start = time.perf_counter()
                    window_examples = 0
                    window_tokens = None
                    realized["step"] = step
                    if compile_s is not None:
                        realized["compile_s"] = compile_s
                        compile_s = None
                    if metrics_writer is not None:
                        metrics_writer.write(realized)
                    last_realized = realized
                for hook in hooks:
                    hook(step, state, last_realized)
                if eval_iter_fn is not None and eval_every > 0 \
                        and step % eval_every == 0:
                    with span("train.eval", step=step):
                        eval_metrics = self.evaluate(state, eval_iter_fn())
                    if metrics_writer is not None:
                        metrics_writer.write(
                            {"step": step, **{f"eval_{k}": v for k, v in
                                              eval_metrics.items()}})
            return state
        finally:
            # Stop the staging thread (it closes train_iter) or close the
            # host iterator, so no prefetch worker outlives the loop.
            if isinstance(batch_iter, DevicePrefetcher):
                batch_iter.close()
            elif getattr(train_iter, "close", None) is not None:
                train_iter.close()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def evaluate(self, state: TrainState,
                 eval_iter: Iterator) -> Dict[str, float]:
        """Weighted cross-batch aggregation: each batch's metrics carry
        their normalizer (``eval_weight``, or a per-metric
        ``<name>__weight``), so the result is the exact full-set metric."""
        totals: Dict[str, float] = {}
        wsums: Dict[str, float] = {}
        examples = 0.0
        eb = self.cfg.train.eval_batch or self.cfg.train.global_batch
        for batch in eval_iter:
            metrics = {k: float(v) for k, v in self.eval_step(
                state, to_device(batch, self.device)).items()}
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
        return out
