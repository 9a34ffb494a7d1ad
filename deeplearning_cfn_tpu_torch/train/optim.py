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
``lars`` is :class:`Lars`, ``optax.lars`` step for step (the trust ratio and
the learning rate come BEFORE the momentum trace; see its docstring).
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
    "lamb": "A.9 (BERT)",
    "adafactor": "A.9 (the other model families)",
}


class Lars(torch.optim.Optimizer):
    """``optax.lars``: per update, for each parameter ``p`` with gradient
    ``g``:

    1. ``u = g + wd·p`` (``add_decayed_weights``) where the group decays;
    2. ``u = u · tc·‖p‖ / ‖u‖`` (``scale_by_trust_ratio``, eps 0) where the
       group takes the trust ratio — replaced by 1 where either norm is 0
       (at step 0 that covers the zero-initialised head and BN scales);
    3. ``u = −lr · u`` (the learning-rate scale);
    4. **then** the momentum trace ``t = u + μ·t``; the update is ``t``, or
       ``u + μ·t`` with Nesterov (``trace(nesterov=True)``), added to ``p``.

    A torch-style LARS that applies the learning rate after the momentum
    differs from this whenever the learning rate changes — under warmup and
    cosine, at every step. Each param group carries ``weight_decay`` and
    ``trust_ratio``; the trainer gives both only to params with ``ndim >
    1`` (optax's ``_non_bn_mask`` for both masks)."""

    def __init__(self, groups, lr: float, momentum: float = 0.9,
                 nesterov: bool = False, trust_coefficient: float = 0.001):
        super().__init__(groups, dict(
            lr=lr, weight_decay=0.0, trust_ratio=False, momentum=momentum,
            nesterov=nesterov, trust_coefficient=trust_coefficient))

    @torch.no_grad()
    def step(self, closure=None):
        del closure
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            updates = [p.grad for p in params]
            if group["weight_decay"]:
                updates = torch._foreach_add(updates, params,
                                             alpha=group["weight_decay"])
            if group["trust_ratio"]:
                p_norm = torch.stack(torch._foreach_norm(params))
                u_norm = torch.stack(torch._foreach_norm(updates))
                ratio = group["trust_coefficient"] * p_norm / u_norm
                ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                    torch.ones_like(ratio), ratio)
                updates = torch._foreach_mul(updates, list(ratio.unbind()))
            updates = torch._foreach_mul(updates, -group["lr"])
            traces = []
            for p in params:
                state = self.state[p]
                if "trace" not in state:
                    state["trace"] = torch.zeros_like(p)
                traces.append(state["trace"])
            momentum = group["momentum"]
            torch._foreach_mul_(traces, momentum)
            torch._foreach_add_(traces, updates)
            if group["nesterov"]:
                torch._foreach_add_(updates, torch._foreach_mul(traces,
                                                                momentum))
                torch._foreach_add_(params, updates)
            else:
                torch._foreach_add_(params, traces)


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
             "weight_decay": cfg.weight_decay, "trust_ratio": True},
            {"params": [p for p in self.params if not _decays(p)],
             "weight_decay": 0.0, "trust_ratio": False},
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
        elif name == "lars":
            self.inner = Lars(groups, lr=lr0, momentum=cfg.momentum,
                              nesterov=cfg.nesterov,
                              trust_coefficient=cfg.trust_coefficient)
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
