"""Optimizer + LR-schedule factories — the port of
``deeplearning_cfn_tpu/train/optim.py``.

Schedules are plain Python functions of the update count with optax's
semantics (``linear_schedule`` warmup joined to the main schedule, which
then sees ``step - warmup``; ``cosine_decay_schedule``;
``piecewise_constant_schedule`` with ratios; the Transformer rsqrt schedule
with its own warmup).

:class:`Optimizer` wraps a ``torch.optim`` optimizer with optax's chain
semantics around it:

- ``clip_by_global_norm``: when the global norm ``n`` of the gradients is at
  least ``max_norm`` they are scaled by ``max_norm / n`` (optax's rule, not
  ``clip_grad_norm_``'s ``max_norm / (n + 1e-6)``);
- the learning rate of update ``t`` (counted from 0, before the increment,
  as optax's ``count``) is ``schedule(t)``, set on every param group before
  each step — no ``LambdaLR``, whose count runs one ahead of optax's;
- weight decay applies to parameters with ``ndim > 1`` only (optax's
  ``_non_bn_mask``), through two param groups.

``adamw`` is ``torch.optim.AdamW`` (decoupled decay, as ``optax.adamw``);
``adam``, ``sgd`` and ``momentum`` take decay as an L2 term added to the
gradient after clipping, as ``optax.add_decayed_weights`` does before them.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch
from torch import nn

from ..config import OptimizerConfig, ScheduleConfig

Schedule = Callable[[int], float]


def build_schedule(cfg: ScheduleConfig, total_steps: int, global_batch: int,
                   steps_per_epoch: Optional[int] = None) -> Schedule:
    base_lr = cfg.base_lr
    if cfg.scale_with_batch and cfg.reference_batch > 0:
        # Horovod linear-scaling rule: lr ∝ global batch.
        base_lr = cfg.base_lr * global_batch / cfg.reference_batch

    warmup = cfg.warmup_steps
    if warmup == 0 and cfg.warmup_epochs > 0 and steps_per_epoch:
        warmup = int(cfg.warmup_epochs * steps_per_epoch)
    warmup = min(warmup, max(total_steps - 1, 0))
    decay_steps = max(total_steps - warmup, 1)

    if cfg.name == "constant":
        def main(step):
            return base_lr
    elif cfg.name == "cosine":
        alpha = cfg.end_lr_factor

        def main(step):
            count = min(float(step), float(decay_steps))
            cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
            return base_lr * ((1.0 - alpha) * cosine + alpha)
    elif cfg.name == "step":
        # Boundaries are fractions of TOTAL steps; the main schedule runs
        # after the warmup join, whose counter is offset by `warmup`.
        boundaries = {
            max(int(frac * total_steps) - warmup, 1): factor
            for frac, factor in zip(cfg.step_boundaries, cfg.step_factors)
        }
        ratios = []
        prev = 1.0
        for b in sorted(boundaries):
            ratios.append((b, boundaries[b] / prev))
            prev = boundaries[b]

        def main(step):
            v = base_lr
            for b, r in ratios:
                if step >= b:
                    v *= r
            return v
    elif cfg.name == "rsqrt":
        # Transformer (Vaswani): lr = base * w^-0.5 * min(s/w, (s/w)^-0.5),
        # s = step + 1. It embeds its own warmup — no generic join below.
        w = max(warmup, 1)

        def rsqrt(step):
            s = (float(step) + 1.0) / w
            return base_lr * (w ** -0.5) * min(s, s ** -0.5)

        return rsqrt
    else:
        raise ValueError(f"unknown schedule {cfg.name!r}")

    if warmup > 0:
        def joined(step):
            if step < warmup:
                return base_lr * max(float(step), 0.0) / warmup
            return main(step - warmup)

        return joined
    return main


def _decays(p: torch.Tensor) -> bool:
    """optax ``_non_bn_mask``: weight decay for everything but 1-D params
    (LayerNorm scale/bias, biases)."""
    return p.ndim > 1


_NOT_PORTED = {
    "lars": "A.8 (the ResNet path)",
    "lamb": "A.9 (BERT)",
    "adafactor": "A.9 (the other model families)",
}


class Optimizer:
    """A ``torch.optim`` optimizer driven with optax's chain semantics (see
    the module docstring). ``count`` is the number of updates applied."""

    def __init__(self, cfg: OptimizerConfig, schedule: Schedule,
                 params: List[nn.Parameter]):
        name = cfg.name.lower()
        if name in _NOT_PORTED:
            raise NotImplementedError(
                f"optimizer {cfg.name!r} is not ported yet (ROADMAP "
                f"{_NOT_PORTED[name]})")
        self.params = [p for p in params if p.requires_grad]
        groups = [
            {"params": [p for p in self.params if _decays(p)],
             "weight_decay": cfg.weight_decay},
            {"params": [p for p in self.params if not _decays(p)],
             "weight_decay": 0.0},
        ]
        groups = [g for g in groups if g["params"]]
        lr0 = schedule(0)
        if name == "adamw":
            self.inner = torch.optim.AdamW(groups, lr=lr0,
                                           betas=(cfg.b1, cfg.b2),
                                           eps=cfg.eps)
        elif name == "adam":
            self.inner = torch.optim.Adam(groups, lr=lr0,
                                          betas=(cfg.b1, cfg.b2),
                                          eps=cfg.eps)
        elif name == "sgd":
            self.inner = torch.optim.SGD(groups, lr=lr0)
        elif name == "momentum":
            self.inner = torch.optim.SGD(groups, lr=lr0,
                                         momentum=cfg.momentum,
                                         nesterov=cfg.nesterov)
        else:
            raise ValueError(f"unknown optimizer {cfg.name!r}")
        self.schedule = schedule
        self.grad_clip_norm = cfg.grad_clip_norm
        self.count = 0

    def grads(self) -> List[torch.Tensor]:
        return [p.grad for p in self.params if p.grad is not None]

    def step(self, grad_norm: Optional[torch.Tensor] = None) -> None:
        """Apply one update from the parameters' ``.grad``. ``grad_norm``
        (the global norm of those gradients) is computed when clipping needs
        it and was not passed."""
        if self.grad_clip_norm > 0:
            grads = self.grads()
            if grad_norm is None:
                grad_norm = global_norm(grads)
            # optax: g if norm < max_norm else g / norm * max_norm.
            factor = torch.clamp(self.grad_clip_norm / grad_norm, max=1.0)
            torch._foreach_mul_(grads, factor)
        lr = float(self.schedule(self.count))
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """L2 norm over every gradient (optax ``global_norm``), on the device."""
    if not grads:
        return torch.zeros(())
    return torch.nn.utils.get_total_norm(grads, norm_type=2.0)


def build_optimizer(cfg: OptimizerConfig, schedule: Schedule,
                    model: nn.Module) -> Optimizer:
    return Optimizer(cfg, schedule, list(model.parameters()))
