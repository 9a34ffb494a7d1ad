"""Train state on one device — the port of
``deeplearning_cfn_tpu/train/state.py``.

The JAX state is an immutable pytree (step, params, batch_stats, opt_state,
ema_params) that every step replaces. Here the model owns its parameters and
the optimizer its slots, both updated in place (the JAX step donates its
state buffers to the same effect); :class:`TrainState` holds them with the
step counter and the optional EMA copy of the parameters. One device, no
sharding: ZeRO-1 and the mesh belong to ROADMAP A.10. The JAX state's
``batch_stats`` (BatchNorm running statistics) are the model's buffers
here: a train-mode forward updates them in place, they are not parameters,
and the EMA does not cover them, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional

import torch
from torch import nn

from .optim import Optimizer


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: Optimizer
    ema_params: Optional[List[torch.Tensor]] = None

    @property
    def params(self) -> List[nn.Parameter]:
        return self.optimizer.params

    def apply_gradients(self, ema_decay: float = 0.0,
                        grad_norm: Optional[torch.Tensor] = None) -> None:
        """One optimizer update from the parameters' ``.grad``, then the EMA
        (``e = e·decay + p·(1 − decay)``) and ``step += 1``."""
        self.optimizer.step(grad_norm)
        if self.ema_params is not None and ema_decay > 0:
            with torch.no_grad():
                torch._foreach_mul_(self.ema_params, ema_decay)
                torch._foreach_add_(self.ema_params,
                                    [p.detach() for p in self.params],
                                    alpha=1.0 - ema_decay)
        self.step += 1

    @contextlib.contextmanager
    def eval_weights(self):
        """Evaluate with the EMA parameters when they are tracked (the
        preference of the JAX ``eval_step``), the live ones otherwise."""
        if self.ema_params is None:
            yield self.model
            return
        live = [p.detach().clone() for p in self.params]
        with torch.no_grad():
            for p, e in zip(self.params, self.ema_params):
                p.copy_(e)
        try:
            yield self.model
        finally:
            with torch.no_grad():
                for p, saved in zip(self.params, live):
                    p.copy_(saved)


def create_train_state(model: nn.Module, optimizer: Optimizer,
                       ema: bool = False) -> TrainState:
    """Step 0 over an initialized model; ``ema`` starts the EMA at the
    initial parameters, as the JAX state does."""
    ema_params = [p.detach().clone() for p in optimizer.params] if ema \
        else None
    return TrainState(step=0, model=model, optimizer=optimizer,
                      ema_params=ema_params)
