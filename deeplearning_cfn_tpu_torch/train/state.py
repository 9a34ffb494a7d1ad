"""Train state — the port of ``deeplearning_cfn_tpu/train/state.py``.

The JAX state is an immutable pytree (step, params, batch_stats, opt_state,
ema_params) that every step replaces. Here the model owns its parameters and
the optimizer its slots, both updated in place (the JAX step donates its
state buffers to the same effect); :class:`TrainState` holds them with the
step counter and the optional EMA copy of the parameters. Every process
holds the whole parameters; with ``train.shard_opt_state`` across
processes each holds the slots of the parameters it owns (ZeRO-1,
``train/optim.py``), where the JAX state shards each slot over the
``data`` axis: the same update, another layout. The JAX state's
``batch_stats`` (BatchNorm running statistics) are the model's buffers
here: a train-mode forward updates them in place, they are not parameters,
and the EMA does not cover them, as in the JAX package. Nothing here rebinds
a parameter, buffer or slot after the first update, which a CUDA graph that
captured a step relies on (``train/graphs.py``); :meth:`TrainState.load_named`
rebinds the optimizer's slots and runs before any capture.

Checkpoints: :meth:`TrainState.named_leaves` names every leaf as
``utils/trees.py:flatten_with_names`` names the JAX ``TrainState`` of the
same preset — ``step`` (int32), ``params/...`` and ``batch_stats/...`` (in
Flax's layout, through ``convert.flax_layout``), ``opt_state/...`` (the
optax state of the same chain, ``Optimizer.named_slots``) and
``ema_params/...`` — so the JAX restore, which requires every leaf of its
target, reads a port checkpoint, and :meth:`TrainState.load_named` loads a
JAX one. Across processes a leaf that another process writes is an
``Elsewhere`` (shape and dtype): the replicated leaves are process 0's and
a ZeRO-1 slot is its owner's. A parameter that holds a piece of a leaf
split over ``pipe``, ``model`` or ``expert``
(``parallel.sharding.param_pieces``) is named as its ``Rows`` of the whole
leaf (a range of the split dim), written by the first of the piece's
holders (its slots by their owner), and ``load_named`` takes this
process's range of a whole leaf: the weights carry over between one process
and any mesh, and between either package's checkpoints. A state built for evaluation only has no optimizer and names no
``opt_state`` leaves (the JAX ``run_eval`` template has none either).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..convert import flax_layout, from_flax, to_flax
from ..parallel.mesh import process_index
from ..parallel.sharding import Elsewhere, param_pieces
from .optim import Optimizer


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: Optional[Optimizer]
    ema_params: Optional[List[torch.Tensor]] = None

    @property
    def params(self) -> List[nn.Parameter]:
        """The trained parameters (the optimizer's), in model order."""
        return [p for p in self.model.parameters() if p.requires_grad]

    # -- checkpoint leaves (the JAX TrainState's names) ---------------------

    def _layout(self) -> Tuple[List[tuple], List[tuple]]:
        """(params, batch stats) of :func:`convert.flax_layout`, the params
        in :attr:`params` order."""
        layout = flax_layout(self.model)
        by_id = {id(row[2]): row for row in layout}
        params = [by_id[id(p)] for p in self.params]
        stats = [row for row in layout if row[0].startswith("batch_stats/")]
        return params, stats

    def named_leaves(self) -> List[Tuple[str, object]]:
        """``(flax name, host array)`` for every leaf this process writes,
        copied off the device now (into fresh host memory, also from a CPU
        tensor), and ``(flax name, Elsewhere)`` for the leaves another
        process writes (see the module docstring)."""
        params, stats = self._layout()
        pieces = param_pieces(self.model)
        host = lambda t, kind: to_flax(
            t if isinstance(t, np.ndarray)
            else t.detach().to("cpu", copy=True).numpy(), kind)
        mine = process_index() == 0

        def replicated(t, kind, param=None):
            piece = None if param is None else pieces.get(id(param))
            writes = mine if piece is None else piece.writes
            shape = to_flax(np.broadcast_to(np.zeros((), np.float32),
                                            tuple(t.shape)), kind).shape
            if piece is not None:
                shape = piece.shape(shape)
            if not writes:
                return Elsewhere(tuple(shape), str(t.dtype).replace(
                    "torch.", ""))
            if piece is not None:
                return piece.rows(host(t, kind))
            return host(t, kind)

        out = [("step", np.asarray(self.step, np.int32) if mine
                else Elsewhere((), "int32"))]
        out += [(name, replicated(t, kind, t)) for name, _, t, kind in params]
        out += [(name, replicated(t, kind)) for name, _, t, kind in stats]
        if self.optimizer is not None:
            out += self.optimizer.named_slots(
                [(name[len("params/"):], t,
                  lambda v, kind=kind: host(v, kind))
                 for name, _, t, kind in params], writes_replicated=mine)
        if self.ema_params is not None:
            out += [("ema_params/" + name[len("params/"):],
                     replicated(e, kind, t))
                    for (name, _, t, kind), e in zip(params,
                                                     self.ema_params)]
        return out

    @torch.no_grad()
    def load_named(self, leaves: Dict[str, np.ndarray]) -> None:
        """Load leaves named as :meth:`named_leaves` names them (a restored
        checkpoint of either package, whole leaves) into the live tensors;
        a parameter that holds a piece takes its range."""
        params, stats = self._layout()
        pieces = param_pieces(self.model)

        def put(dst: torch.Tensor, value: np.ndarray, kind: str,
                param=None) -> None:
            value = np.asarray(value)
            if id(param) in pieces:
                value = pieces[id(param)].of(value)
            value = from_flax(value, kind)
            src = np.ascontiguousarray(value)
            if not src.flags.writeable:
                src = src.copy()
            dst.copy_(torch.from_numpy(src).to(dst.dtype))

        self.step = int(leaves["step"])
        for name, _, t, kind in params + stats:
            put(t, leaves[name], kind, t)
        if self.optimizer is not None:
            self.optimizer.load_slots(
                leaves, [(name[len("params/"):], t,
                          lambda v, kind=kind: from_flax(v, kind))
                         for name, _, t, kind in params])
        if self.ema_params is not None:
            for (name, _, t, kind), e in zip(params, self.ema_params):
                put(e, leaves["ema_params/" + name[len("params/"):]], kind,
                    t)

    def update(self, ema_decay: float = 0.0,
               grad_norm: Optional[torch.Tensor] = None) -> None:
        """The device work of one optimizer update from the parameters'
        ``.grad`` (with the learning rate and count the optimizer's
        ``prepare`` wrote), then the EMA (``e = e·decay + p·(1 − decay)``).
        Everything is updated in place, so a CUDA graph that captured this
        replays it on the same tensors. :meth:`advance` moves the counts."""
        self.optimizer.apply(grad_norm)
        if self.ema_params is not None and ema_decay > 0:
            with torch.no_grad():
                torch._foreach_mul_(self.ema_params, ema_decay)
                torch._foreach_add_(self.ema_params,
                                    [p.detach() for p in self.params],
                                    alpha=1.0 - ema_decay)

    def advance(self) -> None:
        """After an update: ``step += 1`` and the optimizer's count."""
        self.optimizer.count += 1
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


def create_train_state(model: nn.Module, optimizer: Optional[Optimizer],
                       ema: bool = False) -> TrainState:
    """Step 0 over an initialized model; ``ema`` starts the EMA at the
    initial parameters, as the JAX state does."""
    ema_params = [p.detach().clone() for p in model.parameters()
                  if p.requires_grad] if ema else None
    return TrainState(step=0, model=model, optimizer=optimizer,
                      ema_params=ema_params)
