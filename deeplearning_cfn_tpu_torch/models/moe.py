"""Mixture-of-Experts FFN — the port of ``deeplearning_cfn_tpu/models/moe.py``.

The GShard/Switch formulation with static shapes, as in the JAX package:

- the router is an f32 ``Dense`` without a bias over the f32 activations,
  then a softmax over the experts;
- ``router_assignment`` places tokens by ``argmax`` plus a ``cumsum`` over
  the sequence (first come, first served), choice by choice: every
  first-choice token claims its slot before any second-choice token; a
  token whose slot index reaches the fixed capacity is dropped, and the
  kept choices' gates are renormalised to sum to 1;
- the dispatch, expert and combine products are einsums over dense 0/1
  masks in the compute dtype, with the tanh-approximation ``gelu`` between
  the two expert products and no dropout;
- the aux losses are f32 per-token means: the load balance
  ``E · Σ_e f_e · p_e`` (``f_e`` the share of first choices, ``p_e`` the
  mean router probability) and the router z-loss, the mean squared
  ``logsumexp`` of the router logits.

``torch.argmax`` and ``jnp.argmax`` both give the first index among equal
maxima, so ties route the same way in both packages. The expert weights
are stacked ``w_in [E, F, M]``, ``b_in [E, M]``, ``w_out [E, M, F]``,
``b_out [E, F]`` and keep the JAX layout (``convert.py`` carries them
untransposed); the router is a ``Dense`` named ``router``.

Across processes (a ``mesh`` of more than one) the layer is the JAX layer
under GSPMD, made explicit:

- with an ``expert`` axis of ``n`` ways, each process holds the ``E/n``
  experts of its coordinate (``parallel.sharding.PARAM_RULES``, the copy
  of ``MOE_PARAM_RULES``; the router stays replicated). Routing is per row,
  so dispatch stays local; the dispatched slots ``x_e [B, E, C, F]`` go
  through an all-to-all along ``E`` over the ``expert`` group
  (``collectives.all_to_all_grad``), each process runs its experts on every
  member's slots, and a second all-to-all brings the outputs back to be
  combined;
- the aux losses are the global batch's: ``f_e`` and ``p_e`` are sums over
  the processes that hold different rows (the mesh's data group) divided
  by the global token count, and each process returns its share of the
  global values (the load balance over the processes, the z-loss's sum
  over its tokens), so that, like the task's losses, the shares add up to
  them.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_to_all_grad, global_sum, \
    global_total
from ..parallel.sharding import piece_rows
from .transformer import Dense


def router_assignment(probs: torch.Tensor, capacity: int, top_k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-shape token→expert assignment.

    ``probs`` [B, S, E] router probabilities → (dispatch, combine), each
    [B, S, E, C]: dispatch is a 0/1 mask placing each kept token in one
    capacity slot of each chosen expert; combine is dispatch scaled by the
    token's renormalised gate for that expert."""
    b, s, e = probs.shape
    slots = torch.arange(capacity, device=probs.device)
    remaining = probs
    kept_per_expert = torch.zeros((b, e), dtype=probs.dtype,
                                  device=probs.device)
    dispatch = torch.zeros((b, s, e, capacity), dtype=probs.dtype,
                           device=probs.device)
    gates, masks = [], []
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)                       # [B, S]
        mask = F.one_hot(idx, e).to(probs.dtype)                    # [B,S,E]
        # Slot of each token: earlier tokens first, after the slots that
        # higher-priority choices already claimed.
        pos = (torch.cumsum(mask, dim=1) - mask) \
            + kept_per_expert[:, None, :]
        keep = mask * (pos < capacity).to(probs.dtype)
        # one_hot of a slot past the capacity is all zeros (jax.nn.one_hot).
        slot = (pos.long()[..., None] == slots).to(probs.dtype)   # [B,S,E,C]
        dispatch = dispatch + keep[..., None] * slot
        kept_per_expert = kept_per_expert + keep.sum(dim=1)
        gates.append((probs * mask).sum(dim=-1))
        masks.append(keep)
        remaining = remaining * (1.0 - mask)
    gate_stack = torch.stack(gates, dim=-1)                         # [B,S,K]
    gate_stack = gate_stack / torch.clamp(
        gate_stack.sum(dim=-1, keepdim=True), min=1e-9)
    combine = torch.zeros_like(dispatch)
    for k, keep in enumerate(masks):
        combine = combine + dispatch * keep[..., None] \
            * gate_stack[..., k][..., None, None]
    return dispatch, combine


class MoeMlp(nn.Module):
    """Drop-in MoE replacement for ``transformer.Mlp``: ``forward`` returns
    ``(y, {"load_balance", "router_z"})`` (unweighted f32 scalars; across
    processes this process's shares of them). ``mesh``: the job's mesh
    (None, or one process: the one-device layer)."""

    def __init__(self, features: int, num_experts: int, mlp_dim: int,
                 capacity_factor: float = 1.25, top_k: int = 2,
                 dtype: torch.dtype = torch.bfloat16, mesh=None):
        super().__init__()
        if top_k > num_experts:
            raise ValueError(f"top_k={top_k} > num_experts={num_experts}")
        self.num_experts, self.mlp_dim = num_experts, mlp_dim
        self.capacity_factor, self.top_k, self.dtype = \
            capacity_factor, top_k, dtype
        self.mesh = mesh if mesh is not None and mesh.process_count > 1 \
            else None
        self.ways = 1 if self.mesh is None else self.mesh.expert_ways
        rows = piece_rows(self.mesh, "expert", num_experts)
        e, f, m = rows.stop - rows.start, features, mlp_dim
        self.router = Dense(f, num_experts, torch.float32, use_bias=False)
        self.w_in = nn.Parameter(torch.empty(e, f, m))
        self.b_in = nn.Parameter(torch.zeros(e, m))
        self.w_out = nn.Parameter(torch.empty(e, m, f))
        self.b_out = nn.Parameter(torch.zeros(e, f))

    def capacity(self, seq_len: int) -> int:
        """Each expert's slots per sequence: the JAX expression, so 40 at
        sequence 128 (8 experts, top-2, factor 1.25) and 1 at a decode
        step."""
        return max(1, int(self.top_k * seq_len / self.num_experts
                          * self.capacity_factor))

    def route(self, x: torch.Tensor):
        """(f32 router logits, probs, dispatch, combine) of ``x`` [B, S, F];
        dispatch and combine in f32."""
        logits = self.router(x.float())
        probs = torch.softmax(logits, dim=-1)
        dispatch, combine = router_assignment(
            probs, self.capacity(x.shape[1]), self.top_k)
        return logits, probs, dispatch, combine

    def _swap(self, t: torch.Tensor, out: bool) -> torch.Tensor:
        """All-to-all of expert slots over the ``expert`` group: this
        process's rows of every expert ``[B, E, C, F]`` to every member's
        rows of its experts ``[n·B, E/n, C, F]`` (``out`` False), and
        back (``out`` True)."""
        n = self.ways
        if out:
            nb, el, c, f = t.shape
            b = nb // n
            got = all_to_all_grad(t.reshape(n, b, el, c, f),
                                  self.mesh.expert_group())
            return got.transpose(0, 1).reshape(b, n * el, c, f)
        b, e, c, f = t.shape
        parts = t.reshape(b, n, e // n, c, f).transpose(0, 1).contiguous()
        got = all_to_all_grad(parts, self.mesh.expert_group())
        return got.reshape(n * b, e // n, c, f)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        dt = self.dtype
        logits, probs, dispatch, combine = self.route(x)
        dispatch, combine = dispatch.to(dt), combine.to(dt)
        x_e = torch.einsum("bsec,bsf->becf", dispatch, x.to(dt))
        if self.ways > 1:
            x_e = self._swap(x_e, out=False)
        h = torch.einsum("becf,efm->becm", x_e, self.w_in.to(dt))
        h = F.gelu(h + self.b_in.to(dt)[None, :, None, :],
                   approximate="tanh")
        y_e = torch.einsum("becm,emf->becf", h, self.w_out.to(dt))
        y_e = y_e + self.b_out.to(dt)[None, :, None, :]
        if self.ways > 1:
            y_e = self._swap(y_e, out=True)
        y = torch.einsum("bsec,becf->bsf", combine, y_e)
        first_choice = F.one_hot(torch.argmax(probs, dim=-1),
                                 self.num_experts).float()
        z = torch.logsumexp(logits, dim=-1) ** 2
        if self.mesh is None:
            f_e = first_choice.mean(dim=(0, 1))
            p_e = probs.mean(dim=(0, 1))
            return y, {"load_balance": self.num_experts * (f_e * p_e).sum(),
                       "router_z": z.mean()}
        mesh = self.mesh
        group = mesh.data_group()
        f_e, p_e = first_choice.sum(dim=(0, 1)), probs.sum(dim=(0, 1))
        tokens = torch.tensor(float(z.numel()), device=z.device)
        if group is not None:
            f_e, p_e = global_total(f_e, group), global_sum(p_e, group)
            tokens = global_total(tokens, group)
        load_balance = self.num_experts * (f_e * p_e).sum() / tokens ** 2
        return y, {"load_balance": load_balance / mesh.process_count,
                   "router_z": z.sum() / tokens / mesh.replicas}


def init_moe_(model: nn.Module, generator: torch.Generator) -> None:
    """Flax's init of every ``MoeMlp`` in ``model``: the router kernel
    ``normal(0.02)``; ``w_in``/``w_out`` ``xavier_uniform`` over the stacked
    shape, whose leading expert dim counts as receptive field
    (limit √(6 / (E·(F + M)))); zero biases. A process that holds some of
    the experts draws them all and keeps its own, so its experts are the
    one-process model's."""
    with torch.no_grad():
        for mod in model.modules():
            if not isinstance(mod, MoeMlp):
                continue
            mod.router.weight.normal_(0.0, 0.02, generator=generator)
            rows = piece_rows(mod.mesh, "expert", mod.num_experts)
            for w in (mod.w_in, mod.w_out):
                e, (fan_in, fan_out) = mod.num_experts, w.shape[1:]
                limit = math.sqrt(6.0 / (e * (fan_in + fan_out)))
                whole = torch.empty((e,) + w.shape[1:], dtype=w.dtype,
                                    device=w.device)
                whole.uniform_(-limit, limit, generator=generator)
                w.copy_(whole[rows])
            mod.b_in.zero_()
            mod.b_out.zero_()


def moe_flops(seq_len: int, features: int, mlp_dim: int, num_experts: int,
              capacity: int) -> int:
    """Multiply-add FLOPs (2 per MAC) of one sequence through a ``MoeMlp``
    as it executes: the router, the dispatch and combine einsums over every
    (token, expert, slot), and both expert products at every capacity slot,
    filled or not."""
    s, f, m, e, c = seq_len, features, mlp_dim, num_experts, capacity
    return 2 * s * f * e + 2 * 2 * s * e * c * f + 2 * 2 * e * c * f * m
