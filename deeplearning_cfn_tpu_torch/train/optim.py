"""Optimizer + LR-schedule factories — the port of
``deeplearning_cfn_tpu/train/optim.py``.

Schedules are plain Python functions of the update count with optax's
semantics (``linear_schedule`` warmup joined to the main schedule, which
then sees ``step - warmup``; ``cosine_decay_schedule``;
``piecewise_constant_schedule`` with ratios; the Transformer rsqrt schedule
with its own warmup).

:class:`Optimizer` drives one of the update rules below with optax's chain
semantics around it:

- ``clip_by_global_norm``: when the global norm ``n`` of the gradients is at
  least ``max_norm`` they are scaled by ``max_norm / n`` (optax's rule, not
  ``clip_grad_norm_``'s ``max_norm / (n + 1e-6)``);
- the learning rate of update ``t`` (counted from 0, before the increment,
  as optax's ``count``) is ``schedule(t)`` — no ``LambdaLR``, whose count
  runs one ahead of optax's;
- weight decay applies to parameters with ``ndim > 1`` only (optax's
  ``_non_bn_mask``), through two param groups.

Every rule reads its learning rate and update count from two f32 device
scalars (``Optimizer.lr``, ``Optimizer.count_t``) that the host fills before
each update (:meth:`Optimizer.prepare`, an asynchronous ``fill_``), and
computes its bias corrections from them on the device. An update therefore
reads nothing from the host, and a CUDA graph that captures it
(``train/graphs.py``) replays it with each step's values; the eager step
runs the same arithmetic.

``adamw`` and ``adam`` are :class:`Adam` (``optax.adamw`` with its decoupled
decay, ``optax.adam``), ``sgd`` and ``momentum`` are :class:`Sgd`
(``optax.sgd`` with and without the momentum trace); ``adam``, ``sgd`` and
``momentum`` take decay as an L2 term added to the gradient after clipping,
as ``optax.add_decayed_weights`` does before them. ``lars`` is :class:`Lars`,
``optax.lars`` step for step (the trust ratio and the learning rate come
BEFORE the momentum trace; see its docstring), ``lamb`` is :class:`Lamb`,
``optax.lamb`` step for step, and ``adafactor`` is :class:`Adafactor`,
``optax.adafactor(schedule)`` with optax's defaults (its weight decay, as for
sgd/momentum/adam, goes in front of it). Adafactor
factors a parameter's second moment by the parameter's Flax shape, so it is
told each parameter's layout (``convert.flax_layout``'s kind) and keeps its
statistics in Flax's layout.

Checkpoints carry the optimizer's slots under the names of the optax state
of the same chain (:meth:`Optimizer.named_slots`, :meth:`Optimizer.load_slots`;
``_OPTAX_STATE`` is the layout), so either package resumes the other's run.

ZeRO-1 (``train.shard_opt_state`` across processes, the JAX
``shard_opt_state``): every process still holds the whole parameters and
the whole summed gradients, but each parameter's slots live on one process,
its owner (:func:`zero1_owners`: largest parameters first, each to the
process with the fewest elements so far, as
``torch.distributed.optim.ZeroRedundancyOptimizer`` partitions). The clip
reads every gradient; the rule updates the owned parameters only, and then
each process broadcasts its parameters to the others in one flat buffer. A
parameter's update is the same arithmetic on the same values as without
ZeRO, so the result is the replicated update bit for bit, and LAMB's and
LARS's trust ratios and Adafactor's factored moments of a whole leaf stay
whole (sharding a parameter's rows would need summed norms). Slot memory
per process falls to about 1/N (:meth:`Optimizer.slot_bytes`). Checkpoints
name every slot; a process writes the slots it owns.
Leaves split over the ``pipe``, ``model`` or ``expert`` axis (``pieces``,
``parallel.sharding.param_pieces``, along any dim): each process holds its
piece of such a parameter. The rules stay the logical leaf's, as ``optax`` applies them
to JAX's sharded leaf: LAMB's and LARS's trust ratios sum ``‖p‖²`` and
``‖u‖²`` over the leaf's pieces (``Piece.peers``) before the ratio, and
:func:`global_norm` counts every piece once and every replicated leaf
once. Under ZeRO-1 a piece's owner is one of the processes that hold it,
at the same place among them for every piece of the leaf
(:func:`zero1_owners`), so the owners of a leaf's pieces sum its norms
together, and each broadcasts its pieces to their other holders.
Adafactor factors a piece's moments by the whole leaf's shape and sums
each mean over the split dim, and each block RMS, over the peers (see
:class:`Adafactor`); a moment that reduces the split dim away is whole on
every peer, and a checkpoint holds it once.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config import OptimizerConfig, ScheduleConfig
from ..parallel import mesh as _mesh
from ..parallel.collectives import WORLD, broadcast_, sum_
from ..parallel.sharding import Elsewhere, Piece, param_pieces

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


# The optax state of each optimizer's transform (the chain element after the
# clip and the sgd/momentum/adam weight decay): the chain-relative paths of
# its update counts (int32 scalars), and of each per-parameter slot with the
# torch state key that holds it. Masked transforms (weight decay, the LARS
# trust ratio) and the clip carry no leaves.
_OPTAX_STATE: Dict[str, Tuple[Tuple[str, ...], Dict[str, str]]] = {
    "sgd": (("1/count",), {}),
    "momentum": (("1/count",), {"0/trace": "momentum_buffer"}),
    "adam": (("0/count", "1/count"),
             {"0/mu": "exp_avg", "0/nu": "exp_avg_sq"}),
    "adamw": (("0/count", "2/count"),
              {"0/mu": "exp_avg", "0/nu": "exp_avg_sq"}),
    "lars": (("2/count",), {"3/trace": "trace"}),
    "lamb": (("0/count", "3/count"),
             {"0/mu": "exp_avg", "0/nu": "exp_avg_sq"}),
    # optax.adafactor: chain(scale_by_factored_rms -> FactoredState,
    # clip_by_block_rms, scale_by_learning_rate -> ScaleByScheduleState,
    # scale_by_param_block_rms, scale(-1)).
    "adafactor": (("0/count", "2/count"),
                  {"0/v_row": "v_row", "0/v_col": "v_col", "0/v": "v"}),
}
# Optimizers whose slots are kept in Flax's layout with shapes of their own
# (``inner.slot(p, key)`` gives one, its initial value if not created yet).
_FLAX_SLOTS = ("adafactor",)
# Optimizers that take ``add_decayed_weights`` in front of them in the
# optax chain (adamw, lars and lamb decay inside their own transform).
_DECAY_IN_FRONT = ("sgd", "momentum", "adam", "adafactor")


class _Rule(torch.optim.Optimizer):
    """An update rule whose learning rate ``lr`` and update count ``count``
    (the updates applied before this one) are f32 device scalars shared
    with :class:`Optimizer`, which fills them before each :meth:`step`. Each
    param group carries its ``weight_decay`` (and, for LARS, whether it
    takes the trust ratio)."""

    def __init__(self, groups, lr: torch.Tensor, count: torch.Tensor,
                 **defaults):
        super().__init__(groups, dict(weight_decay=0.0, **defaults))
        self.lr, self.count = lr, count
        self.pieces: Dict[int, Piece] = {}  # set by Optimizer
        self._split_at: Dict[tuple, List[Tuple[object, torch.Tensor]]] = {}

    def _norms(self, params, tensors) -> torch.Tensor:
        """The L2 norm of each of ``tensors`` (one per parameter of
        ``params``); for a parameter that holds a piece of its leaf, the
        norm over all the pieces (their squares summed over
        ``Piece.peers``, one collective per group)."""
        norms = torch.stack(torch._foreach_norm(tensors))
        split = self._split(params, norms.device)
        if not split:
            return norms
        norms = norms.clone()
        for group, at in split:
            norms[at] = sum_(norms[at].square(), group).sqrt()
        return norms

    def _split(self, params, device) -> List[Tuple[object, torch.Tensor]]:
        """``(peers, index)`` for each group of peers among ``params``'
        pieces, the index of their places in ``params`` on ``device``. Made
        once per list of parameters, at the first step, which runs eagerly
        before any CUDA graph capture (a tensor made from a host list is a
        copy a capture refuses)."""
        key = tuple(map(id, params))
        if key not in self._split_at:
            split: Dict[int, Tuple[object, List[int]]] = {}
            for i, p in enumerate(params):
                piece = self.pieces.get(id(p))
                if piece is not None and piece.peers() is not None:
                    split.setdefault(id(piece.peers()),
                                     (piece.peers(), []))[1].append(i)
            self._split_at[key] = [
                (group, torch.tensor(idx, device=device))
                for group, idx in split.values()]
        return self._split_at[key]

    def _slots(self, params, key: str) -> List[torch.Tensor]:
        """The ``key`` slot of each parameter, zeros where not created yet
        (optax's init)."""
        out = []
        for p in params:
            state = self.state[p]
            if key not in state:
                state[key] = torch.zeros_like(p)
            out.append(state[key])
        return out


def _with_grads(group) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    params = [p for p in group["params"] if p.grad is not None]
    return params, [p.grad for p in params]


class Sgd(_Rule):
    """``optax.sgd(lr, momentum, nesterov)`` after the chain's weight decay:
    ``u = g + wd·p`` where the group decays; with momentum the trace ``t =
    u + μ·t`` (zeros at first) and the update ``t``, or ``u + μ·t`` with
    Nesterov; then ``p = p − lr·update``. The trace is the slot
    ``momentum_buffer``."""

    def __init__(self, groups, lr, count, momentum: float = 0.0,
                 nesterov: bool = False):
        super().__init__(groups, lr, count, momentum=momentum,
                         nesterov=nesterov)

    @torch.no_grad()
    def step(self, closure=None):
        del closure
        for group in self.param_groups:
            params, updates = _with_grads(group)
            if not params:
                continue
            if group["weight_decay"]:
                updates = torch._foreach_add(updates, params,
                                             alpha=group["weight_decay"])
            momentum = group["momentum"]
            if momentum:
                traces = self._slots(params, "momentum_buffer")
                torch._foreach_mul_(traces, momentum)
                torch._foreach_add_(traces, updates)
                updates = torch._foreach_add(updates, traces,
                                             alpha=momentum) \
                    if group["nesterov"] else traces
            torch._foreach_sub_(params, torch._foreach_mul(updates, self.lr))


class Adam(_Rule):
    """``optax.adam`` / ``optax.adamw`` per update ``t = count + 1``: ``m =
    b1·m + (1 − b1)·g``, ``v = b2·v + (1 − b2)·g²``, ``u = m̂ / (√v̂ + eps)``
    with ``m̂ = m / (1 − b1^t)``, ``v̂ = v / (1 − b2^t)`` (the corrections
    computed on the device from ``count``). Weight decay goes in front as
    ``g + wd·p`` (adam, the chain's ``add_decayed_weights``), or, with
    ``decoupled`` (adamw), after as ``u + wd·p``; then ``p = p − lr·u``.
    The slots are ``exp_avg`` (optax's ``mu``) and ``exp_avg_sq``
    (``nu``)."""

    def __init__(self, groups, lr, count, betas=(0.9, 0.999),
                 eps: float = 1e-8, decoupled: bool = False):
        super().__init__(groups, lr, count, betas=betas, eps=eps)
        self.decoupled = decoupled

    @torch.no_grad()
    def step(self, closure=None):
        del closure
        t = self.count + 1.0
        for group in self.param_groups:
            params, grads = _with_grads(group)
            if not params:
                continue
            b1, b2 = group["betas"]
            wd = group["weight_decay"]
            if wd and not self.decoupled:
                grads = torch._foreach_add(grads, params, alpha=wd)
            mus = self._slots(params, "exp_avg")
            nus = self._slots(params, "exp_avg_sq")
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
            denom = torch._foreach_sqrt(
                torch._foreach_div(nus, 1.0 - b2 ** t))
            torch._foreach_add_(denom, group["eps"])
            updates = torch._foreach_div(
                torch._foreach_div(mus, 1.0 - b1 ** t), denom)
            if wd and self.decoupled:
                torch._foreach_add_(updates, params, alpha=wd)
            torch._foreach_mul_(updates, self.lr)
            torch._foreach_sub_(params, updates)


class Lars(_Rule):
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

    def __init__(self, groups, lr, count, momentum: float = 0.9,
                 nesterov: bool = False, trust_coefficient: float = 0.001):
        super().__init__(groups, lr, count, trust_ratio=False,
                         momentum=momentum, nesterov=nesterov,
                         trust_coefficient=trust_coefficient)

    @torch.no_grad()
    def step(self, closure=None):
        del closure
        for group in self.param_groups:
            params, updates = _with_grads(group)
            if not params:
                continue
            if group["weight_decay"]:
                updates = torch._foreach_add(updates, params,
                                             alpha=group["weight_decay"])
            if group["trust_ratio"]:
                p_norm = self._norms(params, params)
                u_norm = self._norms(params, updates)
                ratio = group["trust_coefficient"] * p_norm / u_norm
                ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                    torch.ones_like(ratio), ratio)
                updates = torch._foreach_mul(updates, list(ratio.unbind()))
            updates = torch._foreach_mul(updates, -self.lr)
            traces = self._slots(params, "trace")
            momentum = group["momentum"]
            torch._foreach_mul_(traces, momentum)
            torch._foreach_add_(traces, updates)
            if group["nesterov"]:
                torch._foreach_add_(updates, torch._foreach_mul(traces,
                                                                momentum))
                torch._foreach_add_(params, updates)
            else:
                torch._foreach_add_(params, traces)


class Lamb(_Rule):
    """``optax.lamb``: per update ``t = count + 1``, for each parameter
    ``p`` with gradient ``g``:

    1. ``scale_by_adam``: ``m = b1·m + (1 − b1)·g``,
       ``v = b2·v + (1 − b2)·g²``, ``u = m̂ / (√v̂ + eps)`` with the bias
       corrections ``m̂ = m / (1 − b1^t)``, ``v̂ = v / (1 − b2^t)``;
    2. ``u = u + wd·p`` (``add_decayed_weights``) where the group decays
       (the trainer gives decay to params with ``ndim > 1`` only);
    3. ``u = u · ‖p‖ / ‖u‖`` (``scale_by_trust_ratio``, on EVERY parameter,
       no mask) — replaced by 1 where either norm is 0;
    4. ``p = p − lr · u``.

    The slots are ``exp_avg`` (optax's ``mu``) and ``exp_avg_sq``
    (``nu``)."""

    def __init__(self, groups, lr, count, betas=(0.9, 0.999),
                 eps: float = 1e-6):
        super().__init__(groups, lr, count, betas=betas, eps=eps)

    @torch.no_grad()
    def step(self, closure=None):
        del closure
        t = self.count + 1.0
        for group in self.param_groups:
            params, grads = _with_grads(group)
            if not params:
                continue
            b1, b2 = group["betas"]
            mus = self._slots(params, "exp_avg")
            nus = self._slots(params, "exp_avg_sq")
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
            mu_hat = torch._foreach_div(mus, 1.0 - b1 ** t)
            nu_hat = torch._foreach_div(nus, 1.0 - b2 ** t)
            denom = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(denom, group["eps"])
            updates = torch._foreach_div(mu_hat, denom)
            if group["weight_decay"]:
                torch._foreach_add_(updates, params,
                                    alpha=group["weight_decay"])
            p_norm = self._norms(params, params)
            u_norm = self._norms(params, updates)
            ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                torch.ones_like(p_norm), p_norm / u_norm)
            torch._foreach_mul_(updates, list(ratio.unbind()))
            torch._foreach_mul_(updates, self.lr)
            torch._foreach_sub_(params, updates)


def _flax_view(t: torch.Tensor, kind: str) -> torch.Tensor:
    """``t`` seen in Flax's layout (a view: writes reach ``t``)."""
    if kind == "dense":
        return t.t()
    if kind == "conv":
        return t.permute(2, 3, 1, 0)
    return t


def _factored_dims(shape: Tuple[int, ...], min_dim: int
                   ) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: the two largest dims (second largest,
    largest) when the second largest is at least ``min_dim``, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(_Rule):
    """``optax.adafactor(lr)`` with optax's defaults: per update ``t =
    count`` (counted from 0), for each parameter ``p`` with gradient ``g``,
    both in Flax's layout (``kinds[p]``):

    1. ``u = g + wd·p`` where the group decays (the chain's
       ``add_decayed_weights`` in front);
    2. ``scale_by_factored_rms`` with the decay ``β = 1 − (t + 1)^−0.8``:
       where ``p`` has two dims of at least 128 (the two largest, ``d1``
       second and ``d0`` largest), ``v_row = β·v_row + (1 − β)·mean_d0(u² +
       1e-30)`` and ``v_col`` likewise over ``d1``, and ``u`` is scaled by
       ``(v_row / mean(v_row))^−½`` along ``d0`` and ``v_col^−½`` along
       ``d1``; elsewhere ``v = β·v + (1 − β)·(u² + 1e-30)`` and ``u =
       u·v^−½``;
    3. ``clip_by_block_rms(1)``: ``u /= max(1, rms(u))``;
    4. ``u *= lr``, then ``u *= max(rms(p), 1e-3)``
       (``scale_by_param_block_rms``);
    5. ``p = p − u``.

    The slots ``v_row``, ``v_col`` and ``v`` hold optax's shapes in Flax's
    layout, the placeholders (``[1]``) included, and are updated in place
    (a CUDA graph that captured an update keeps their addresses).

    A parameter that holds a piece of its leaf (``pieces``) follows the
    whole leaf, as optax does on JAX's global array: the factored dims are
    the whole leaf's (:meth:`slot_shapes`); a slot that keeps the split dim
    is a piece of the whole slot, and one that reduces it away is whole,
    the same on every peer (:meth:`slot_dims`). Each mean over the split
    dim, and each block RMS, sums its pieces' parts over ``Piece.peers``:
    one collective per group of peers for the moments and ``rms(p)``, and
    one for ``rms(u)`` (:meth:`_peer_sums`)."""

    SLOTS = ("v_row", "v_col", "v")

    def __init__(self, groups, lr, count, kinds: Dict[nn.Parameter, str],
                 decay_rate: float = 0.8, eps: float = 1e-30,
                 min_dim_size_to_factor: int = 128,
                 clipping_threshold: float = 1.0, min_scale: float = 1e-3):
        super().__init__(groups, lr, count)
        self.kinds = kinds
        self.decay_rate, self.eps = decay_rate, eps
        self.min_dim = min_dim_size_to_factor
        self.clipping_threshold, self.min_scale = clipping_threshold, \
            min_scale

    def _leaf(self, p: torch.Tensor):
        """``(whole leaf's Flax shape, its factored dims or None, the split
        dim or None)`` of ``p``."""
        shape = tuple(_flax_view(p, self.kinds.get(p, "none")).shape)
        piece = self.pieces.get(id(p))
        if piece is not None:
            shape = piece.shape(shape)
        return shape, _factored_dims(shape, self.min_dim), \
            None if piece is None else piece.dim

    def slot_dims(self, p: torch.Tensor) -> Dict[str, Optional[int]]:
        """The dim of each of ``p``'s slots along which this process holds
        a piece of it: for a piece of a leaf, the split dim of a slot that
        keeps it; None for a whole slot (every slot of a whole leaf, and
        a moment that reduces the split dim away)."""
        _, dims, s = self._leaf(p)
        if s is None:
            return dict.fromkeys(self.SLOTS)
        if dims is None:
            return {"v_row": None, "v_col": None, "v": s}
        d1, d0 = dims
        kept = lambda d: None if s == d else s - int(s > d)
        return {"v_row": kept(d0), "v_col": kept(d1), "v": None}

    def slot_shapes(self, p: torch.Tensor, whole: bool = False
                    ) -> Dict[str, Tuple[int, ...]]:
        """The shapes of ``p``'s slots: optax's for the whole leaf, in
        Flax's layout, with this process's range of a split dim (all of it
        when ``whole``)."""
        shape, dims, _ = self._leaf(p)
        if dims is None:
            out = {"v_row": (1,), "v_col": (1,), "v": shape}
        else:
            d1, d0 = dims
            out = {"v_row": shape[:d0] + shape[d0 + 1:],
                   "v_col": shape[:d1] + shape[d1 + 1:], "v": (1,)}
        piece = self.pieces.get(id(p))
        if whole or piece is None:
            return out
        for key, dim in self.slot_dims(p).items():
            if dim is not None:
                out[key] = out[key][:dim] + (piece.stop - piece.start,) \
                    + out[key][dim + 1:]
        return out

    def _initial(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros(s, dtype=p.dtype, device=p.device)
                for k, s in self.slot_shapes(p).items()}

    def slot(self, p: torch.Tensor, key: str) -> torch.Tensor:
        state = self.state.get(p, {})
        return state[key] if key in state else self._initial(p)[key]

    def _peer_sums(self, params, parts: List[List[torch.Tensor]]
                   ) -> List[List[torch.Tensor]]:
        """``parts[i]``, tensors of ``params[i]``, summed over the peers of
        its piece (as they are for a whole leaf): one collective per group
        of peers, over one flat f32 buffer of the group's parts. It reads
        nothing from the host, so a CUDA graph captures it."""
        by_group: Dict[int, Tuple[object, List[int]]] = {}
        for i, p in enumerate(params):
            piece = self.pieces.get(id(p))
            if parts[i] and piece is not None and piece.peers() is not None:
                by_group.setdefault(id(piece.peers()),
                                    (piece.peers(), []))[1].append(i)
        out = list(parts)
        for group, idx in by_group.values():
            tensors = [t for i in idx for t in parts[i]]
            flat = sum_(torch.cat([t.reshape(-1).float() for t in tensors]),
                        group)
            chunks = iter(flat.split([t.numel() for t in tensors]))
            for i in idx:
                out[i] = [next(chunks).view(t.shape).to(t.dtype)
                          for t in parts[i]]
        return out

    @torch.no_grad()
    def step(self, closure=None):
        del closure
        beta = 1.0 - (self.count + 1.0) ** -self.decay_rate
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            ws, us, leaves, parts = [], [], [], []
            for p in params:
                state = self.state[p]
                if "v" not in state:
                    state.update(self._initial(p))
                kind = self.kinds.get(p, "none")
                w, u = _flax_view(p, kind), _flax_view(p.grad, kind)
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * w
                shape, dims, s = self._leaf(p)
                sq = u * u + self.eps
                # Σ p² of a piece, and each sum over a split dim, waits
                # for the peers' parts.
                mine = [w.square().sum()]
                d1, d0 = dims if dims is not None else (None, None)
                if dims is not None and s == d0:
                    mine.append(sq.sum(d0))  # v_row's, whole on every peer
                elif dims is not None and s == d1:
                    # v_row is a piece along d1: updated now, its sum over
                    # d1 waits beside v_col's.
                    v_row = state["v_row"]
                    v_row.copy_(beta * v_row
                                + (1.0 - beta) * sq.sum(d0) / shape[d0])
                    mine += [sq.sum(d1), v_row.sum(d1 - int(d1 > d0),
                                                   keepdim=True)]
                ws.append(w)
                us.append(u)
                leaves.append((shape, dims, s, sq))
                parts.append(mine)
            summed = self._peer_sums(params, parts)
            updates = []
            for p, u, (shape, dims, s, sq), got in zip(params, us, leaves,
                                                       summed):
                state = self.state[p]
                if dims is None:
                    v = state["v"]
                    v.copy_(beta * v + (1.0 - beta) * sq)
                    updates.append(u * v ** -0.5)
                    continue
                d1, d0 = dims
                v_row, v_col = state["v_row"], state["v_col"]
                if s != d1:
                    row = got[1] if s == d0 else sq.sum(d0)
                    v_row.copy_(beta * v_row + (1.0 - beta) * row / shape[d0])
                col = got[1] if s == d1 else sq.sum(d1)
                v_col.copy_(beta * v_col + (1.0 - beta) * col / shape[d1])
                row_sum = got[2] if s == d1 \
                    else v_row.sum(d1 - int(d1 > d0), keepdim=True)
                row_factor = (v_row / (row_sum / shape[d1])) ** -0.5
                updates.append(u * row_factor.unsqueeze(d0)
                               * (v_col ** -0.5).unsqueeze(d1))
            u_sq = self._peer_sums(params, [[u.square().sum()]
                                            for u in updates])
            for w, update, leaf, (usq,), got in zip(ws, updates, leaves,
                                                    u_sq, summed):
                n = math.prod(leaf[0])
                rms = (usq / n).sqrt()
                update = update / torch.clamp(rms / self.clipping_threshold,
                                              min=1.0)
                update = update * self.lr
                p_rms = (got[0] / n).sqrt()
                update = update * torch.where(
                    p_rms <= self.min_scale,
                    torch.full_like(p_rms, self.min_scale), p_rms)
                w.sub_(update)


def zero1_owners(params: Sequence[torch.Tensor], world: int,
                 pieces: Optional[Dict[int, Piece]] = None) -> List[int]:
    """The owning process of each parameter under ZeRO-1: largest first
    (ties by position), each to the process holding the fewest elements so
    far (ties to the lowest index). A parameter that holds a piece of its
    leaf (``pieces``) goes to one of the processes that hold that piece:
    the same place among the holders for every piece of the leaf, the
    place whose busiest process holds the fewest elements so far. Every
    process computes every process's loads, so all agree."""
    pieces = pieces or {}
    loads = [0] * world
    owners = [0] * len(params)
    for i in sorted(range(len(params)),
                    key=lambda i: (-params[i].numel(), i)):
        n = params[i].numel()
        piece = pieces.get(id(params[i]))
        if piece is None:
            rank = min(range(world), key=lambda r: (loads[r], r))
            loads[rank] += n
            owners[i] = rank
            continue
        mesh = piece.mesh
        # holders[j][k]: the k-th holder of the piece at coordinate j.
        holders = [_mesh.Mesh(mesh.shape, mesh.rank_of(
            {**mesh.coords, piece.axis: j}), world).holder_ranks(piece.axis)
            for j in range(mesh.shape[piece.axis])]
        k = min(range(len(holders[0])),
                key=lambda k: (max(loads[h[k]] for h in holders), k))
        for h in holders:
            loads[h[k]] += n
        owners[i] = mesh.holder_ranks(piece.axis)[k]
    return owners


class Optimizer:
    """An update rule driven with optax's chain semantics (see the module
    docstring). ``count`` is the number of updates applied; ``lr`` and
    ``count_t`` are the f32 device scalars the rule reads, filled by
    :meth:`prepare`. ``kinds`` gives each parameter's Flax layout
    (``"dense"``, ``"conv"`` or ``"none"``, default ``"none"``); only
    Adafactor reads it. ``shard_opt_state`` over more than one process is
    ZeRO-1 (see the module docstring); with one process it changes
    nothing."""

    def __init__(self, cfg: OptimizerConfig, schedule: Schedule,
                 params: List[nn.Parameter],
                 kinds: Optional[Dict[nn.Parameter, str]] = None,
                 shard_opt_state: bool = False,
                 pieces: Optional[Dict[int, Piece]] = None):
        name = cfg.name.lower()
        self.params = [p for p in params if p.requires_grad]
        self.world, self.rank = _mesh.process_count(), _mesh.process_index()
        self.pieces = dict(pieces or {})
        # ZeRO-1: the owning process of each parameter (None: replicated).
        self.owners: Optional[List[int]] = zero1_owners(
            self.params, self.world, self.pieces) if shard_opt_state and \
            self.world > 1 else None
        self._owner_of = {} if self.owners is None else {
            id(p): r for p, r in zip(self.params, self.owners)}
        mine = [p for p in self.params if self.owns(p)]
        groups = [
            {"params": [p for p in mine if _decays(p)],
             "weight_decay": cfg.weight_decay, "trust_ratio": True},
            {"params": [p for p in mine if not _decays(p)],
             "weight_decay": 0.0, "trust_ratio": False},
        ]
        groups = [g for g in groups if g["params"]]
        if not groups:  # a process that owns no parameter
            groups = [{"params": [], "weight_decay": 0.0,
                       "trust_ratio": False}]
        device = self.params[0].device if self.params else None
        self.lr = torch.zeros((), dtype=torch.float32, device=device)
        self.count_t = torch.zeros((), dtype=torch.float32, device=device)
        hyper = (self.lr, self.count_t)
        if name in ("adamw", "adam"):
            self.inner = Adam(groups, *hyper, betas=(cfg.b1, cfg.b2),
                              eps=cfg.eps, decoupled=name == "adamw")
        elif name == "sgd":
            self.inner = Sgd(groups, *hyper)
        elif name == "momentum":
            self.inner = Sgd(groups, *hyper, momentum=cfg.momentum,
                             nesterov=cfg.nesterov)
        elif name == "lars":
            self.inner = Lars(groups, *hyper, momentum=cfg.momentum,
                              nesterov=cfg.nesterov,
                              trust_coefficient=cfg.trust_coefficient)
        elif name == "lamb":
            self.inner = Lamb(groups, *hyper, betas=(cfg.b1, cfg.b2),
                              eps=cfg.eps)
        elif name == "adafactor":
            self.inner = Adafactor(groups, *hyper, kinds=kinds or {})
        else:
            raise ValueError(f"unknown optimizer {cfg.name!r}")
        self.inner.pieces = self.pieces
        self.name = name
        self.schedule = schedule
        self.grad_clip_norm = cfg.grad_clip_norm
        self.count = 0
        # The optax chain's leading elements: the clip, then (for sgd,
        # momentum and adam) the weight decay; this optimizer's state sits
        # at the next index.
        self._chain_index = int(cfg.grad_clip_norm > 0) + int(
            cfg.weight_decay > 0 and name in _DECAY_IN_FRONT)

    def grads(self) -> List[torch.Tensor]:
        return [p.grad for p in self.params if p.grad is not None]

    def grad_pieces(self) -> List[Optional[Piece]]:
        """The :class:`Piece` of each of :meth:`grads` (None: replicated)."""
        return [self.pieces.get(id(p)) for p in self.params
                if p.grad is not None]

    def grad_groups(self) -> List[object]:
        """The group each of :meth:`grads` is summed over: the processes
        that hold the same leaf (``collectives.WORLD`` for a replicated
        one)."""
        return [WORLD if pc is None else pc.holders()
                for pc in self.grad_pieces()]

    def grad_norm(self) -> torch.Tensor:
        """:func:`global_norm` of :meth:`grads`, every piece counted
        once."""
        return global_norm(self.grads(), self.grad_pieces())

    def prepare(self) -> None:
        """Write this update's learning rate, ``schedule(count)``, and the
        update count into the device scalars (asynchronous fills on the
        current stream, ordered before the update that reads them)."""
        self.lr.fill_(float(self.schedule(self.count)))
        self.count_t.fill_(float(self.count))

    def apply(self, grad_norm: Optional[torch.Tensor] = None) -> None:
        """The device work of one update from the parameters' ``.grad``,
        with the values :meth:`prepare` wrote: the clip, then the rule.
        ``grad_norm`` (the global norm of those gradients) is computed when
        clipping needs it and was not passed. Does not advance ``count``."""
        if self.grad_clip_norm > 0:
            grads = self.grads()
            if grad_norm is None:
                grad_norm = self.grad_norm()
            # optax: g if norm < max_norm else g / norm * max_norm.
            factor = torch.clamp(self.grad_clip_norm / grad_norm, max=1.0)
            torch._foreach_mul_(grads, factor)
        self.inner.step()
        if self.owners is not None:
            self._broadcast_owned()

    def owns(self, p: torch.Tensor) -> bool:
        """Whether this process holds (and updates) ``p``'s slots."""
        return self._owner_of.get(id(p), self.rank) == self.rank

    @torch.no_grad()
    def _broadcast_owned(self) -> None:
        """ZeRO-1: every process's updated parameters to the others that
        hold them: one flat broadcast per owning process, over the world
        for the replicated ones, then over each holders group for the
        pieces."""
        def send(owned, rank, group):
            if rank == self.rank:
                flat = torch.cat([p.reshape(-1) for p in owned])
            else:
                flat = torch.empty(sum(p.numel() for p in owned),
                                   dtype=owned[0].dtype,
                                   device=owned[0].device)
            broadcast_(flat, rank, group)
            if rank != self.rank:
                offset = 0
                for p in owned:
                    p.copy_(flat[offset:offset + p.numel()].view_as(p))
                    offset += p.numel()

        for rank in range(self.world):
            owned = [p for p, r in zip(self.params, self.owners)
                     if r == rank and id(p) not in self.pieces]
            if owned:
                send(owned, rank, None)
        split: Dict[str, List[Tuple[torch.Tensor, int]]] = {}
        for p, r in zip(self.params, self.owners):
            if id(p) in self.pieces:
                split.setdefault(self.pieces[id(p)].axis, []).append((p, r))
        for axis, held in split.items():
            piece = self.pieces[id(held[0][0])]
            if piece.holders() is None:
                continue
            for rank in piece.mesh.holder_ranks(axis):
                owned = [p for p, r in held if r == rank]
                if owned:
                    send(owned, rank, piece.holders())

    def slot_bytes(self, owned_only: bool = True) -> int:
        """Bytes of the optimizer's slots on this process (``owned_only``)
        or of every parameter's slots (one process's without ZeRO-1), from
        their shapes: slots are made at the first update."""
        _, slots = _OPTAX_STATE[self.name]
        total = 0
        for p in self.params:
            if owned_only and not self.owns(p):
                continue
            if self.name in _FLAX_SLOTS:
                total += sum(math.prod(s) for s in
                             self.inner.slot_shapes(p).values()) \
                    * p.element_size()
            else:
                total += len(slots) * p.numel() * p.element_size()
        return total

    def step(self, grad_norm: Optional[torch.Tensor] = None) -> None:
        """One update: :meth:`prepare`, :meth:`apply`, ``count += 1``."""
        self.prepare()
        self.apply(grad_norm)
        self.count += 1

    def zero_grad(self) -> None:
        """Every parameter's gradient to None (under ZeRO-1 the rule holds
        the owned parameters only, and the others' gradients are summed
        too)."""
        for p in self.params:
            p.grad = None

    # -- checkpoint slots (optax's names) -----------------------------------

    def named_slots(self, named_params: Sequence[Tuple[str, torch.Tensor,
                                                       Callable]],
                    writes_replicated: bool = True):
        """``(opt_state/... name, value)`` for every leaf of the optax state
        of this chain. ``named_params`` gives each parameter's Flax path
        (under ``params/``), the parameter, and the function that puts a
        tensor of its shape into Flax's layout. Slots not created yet (no
        update applied) are zeros, as optax's init makes them; slots kept
        in Flax's layout (``_FLAX_SLOTS``) are named as they are. A leaf
        this process does not write is an :class:`Elsewhere` (its shape
        and dtype): under ZeRO-1 the slots of a parameter another process
        owns, otherwise every slot, and the counts, unless
        ``writes_replicated``."""
        counts, slots = _OPTAX_STATE[self.name]
        prefix = f"opt_state/{self._chain_index}/"
        count = np.asarray(self.count, np.int32) if writes_replicated \
            else Elsewhere((), "int32")
        out = [(prefix + c, count) for c in counts]
        flax_slots = self.name in _FLAX_SLOTS
        for field, key in slots.items():
            for path, p, to_flax in named_params:
                piece = self.pieces.get(id(p))
                # The dim along which this process holds a piece of the
                # slot (None: the slot is whole).
                dim = None if piece is None else \
                    self.inner.slot_dims(p)[key] if flax_slots else piece.dim
                if self.owners is not None:
                    writes = self.owns(p)
                else:
                    writes = writes_replicated if piece is None \
                        else piece.writes
                if piece is not None and dim is None:
                    # A whole slot of a split leaf, the same on every peer:
                    # written once, with the leaf's first piece.
                    writes = writes and piece.start == 0
                if not writes:
                    if flax_slots:
                        shape = self.inner.slot_shapes(p, whole=True)[key]
                    else:
                        shape = piece.shape(tuple(to_flax(_shape_only(
                            p)).shape)) if piece is not None \
                            else tuple(to_flax(_shape_only(p)).shape)
                    out.append((f"{prefix}{field}/{path}",
                                Elsewhere(shape, _dtype_name(p.dtype))))
                    continue
                if flax_slots:
                    value = self.inner.slot(p, key).detach().to(
                        "cpu", copy=True).numpy()
                else:
                    value = self.inner.state.get(p, {}).get(key)
                    if value is None:
                        value = torch.zeros_like(p)
                    value = to_flax(value)
                if dim is not None:
                    value = piece.rows(value, dim)
                out.append((f"{prefix}{field}/{path}", value))
        return out

    def load_slots(self, leaves: Dict[str, np.ndarray],
                   named_params: Sequence[Tuple[str, torch.Tensor,
                                                Callable]]) -> None:
        """Set the update count and every slot from optax-named ``leaves``
        (as :meth:`named_slots` names them); ``named_params`` gives each
        parameter's Flax path, the parameter, and the function that puts a
        Flax-layout array into its layout."""
        counts, slots = _OPTAX_STATE[self.name]
        prefix = f"opt_state/{self._chain_index}/"
        self.count = int(leaves[prefix + counts[-1]])
        for path, p, from_flax in named_params:
            if not self.owns(p):
                continue
            state = self.inner.state[p]
            piece = self.pieces.get(id(p))
            dims = self.inner.slot_dims(p) if self.name in _FLAX_SLOTS \
                else None
            for field, key in slots.items():
                value = leaves[f"{prefix}{field}/{path}"]
                if dims is None:
                    if piece is not None:
                        value = piece.of(value)
                    value = from_flax(value)
                elif dims[key] is not None:
                    value = piece.of(value, dims[key])
                # A copy: the update writes the slot in place, and the
                # leaves are the caller's (a JAX state's are read-only).
                state[key] = torch.tensor(np.ascontiguousarray(value),
                                          dtype=p.dtype).to(p.device)


def _shape_only(p: torch.Tensor) -> np.ndarray:
    """A host array with ``p``'s shape and no storage of its own (a
    stride-0 view of one element), to read a layout function's output
    shape."""
    return np.broadcast_to(np.zeros((), np.float32), tuple(p.shape))


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def global_norm(grads: List[torch.Tensor],
                pieces: Optional[Sequence[Optional[Piece]]] = None
                ) -> torch.Tensor:
    """L2 norm over every gradient (optax ``global_norm``), on the device.
    ``pieces`` gives each gradient's :class:`Piece` (None: replicated): a
    piece's squares are summed over its leaf's pieces (``Piece.peers``), so
    every process gets the norm of the logical gradients."""
    if not grads:
        return torch.zeros(())
    if not pieces or all(pc is None for pc in pieces):
        return torch.nn.utils.get_total_norm(grads, norm_type=2.0)
    norm = lambda ts: torch.nn.utils.get_total_norm(ts, norm_type=2.0)
    replicated = [g for g, pc in zip(grads, pieces) if pc is None]
    total = norm(replicated).square() if replicated \
        else grads[0].new_zeros((), dtype=torch.float32)
    split: Dict[int, Tuple[object, List[torch.Tensor]]] = {}
    for g, pc in zip(grads, pieces):
        if pc is not None:
            split.setdefault(id(pc.peers()), (pc.peers(), []))[1].append(g)
    for group, gs in split.values():
        sq = norm(gs).square()
        if group is not None:
            sum_(sq, group)
        total = total + sq
    return total.sqrt()


def build_optimizer(cfg: OptimizerConfig, schedule: Schedule,
                    model: nn.Module,
                    shard_opt_state: bool = False) -> Optimizer:
    from ..convert import flax_layout

    kinds = {t: kind for _, _, t, kind in flax_layout(model)}
    return Optimizer(cfg, schedule, list(model.parameters()), kinds,
                     shard_opt_state=shard_opt_state,
                     pieces=param_pieces(model))
