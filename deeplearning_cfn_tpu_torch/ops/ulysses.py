"""Ulysses (all-to-all) sequence parallelism, exact attention — the port of
``deeplearning_cfn_tpu/ops/ulysses.py``.

Where ring attention keeps the sequence split and rotates K/V, this form
reswizzles the layout for the attention itself:

    [B, H, S/n, D]  --all-to-all-->  [B, H/n, S, D]
      (sequence slices)                (head groups, whole sequence)

Each process then runs ordinary whole-sequence attention for its H/n heads
— ``ops.attention.fused_attention``, so on the card the three flash kernels
(forward, and under grad dK/dV and dQ), causal masking local — and a second
all-to-all restores the sequence slices. The backward of each all-to-all is
the inverse all-to-all. It needs ``H`` divisible by the group's size.

The all-to-alls go through ``parallel.collectives.all_to_all`` over the
mesh's ``seq`` group (a CUDA tensor is staged through the host under gloo)
and are timed, when ``collectives.comm_timer`` is on, as ``"ulysses"``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.collectives import all_to_all, comm_timer
from .attention import fused_attention


def _swizzle(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[B, H, S/n, D] → [B, H/n, S, D]: head group ``j`` goes to process
    ``j``, and the slices that come back line up in sequence order."""
    b, h, s, d = x.shape
    parts = x.reshape(b, n, h // n, s, d).permute(1, 0, 2, 3, 4)
    with comm_timer.measure("ulysses", x.device):
        got = all_to_all(parts, group)  # [n (source), B, H/n, S/n, D]
    return got.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * s, d)


def _unswizzle(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[B, H/n, S, D] → [B, H, S/n, D]: the inverse of :func:`_swizzle`."""
    b, hn, s_all, d = x.shape
    s = s_all // n
    parts = x.reshape(b, hn, n, s, d).permute(2, 0, 1, 3, 4)
    with comm_timer.measure("ulysses", x.device):
        got = all_to_all(parts, group)  # [n (source head group), B, H/n, ...]
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * hn, s, d)


def _check_heads(h: int, n: int) -> None:
    if h % n:
        raise ValueError(
            f"ulysses attention needs num_heads ({h}) divisible by the "
            f"sequence-parallel axis size ({n}); use ring_attention for "
            f"head counts that don't divide")


class _Swizzle(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _swizzle(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _unswizzle(g, ctx.group, ctx.n), None, None


class _Unswizzle(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _unswizzle(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _swizzle(g, ctx.group, ctx.n), None, None


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group, n: int, causal: bool = False,
                      sm_scale: Optional[float] = None,
                      implementation: str = "auto") -> torch.Tensor:
    """All-to-all attention of this process's slice ``[B, H, S/n, D]`` of a
    sequence split over the ``n`` processes of ``group`` (in sequence
    order)."""
    _check_heads(q.shape[1], n)
    qh, kh, vh = (_Swizzle.apply(t, group, n) for t in (q, k, v))
    out = fused_attention(qh, kh, vh, causal=causal, sm_scale=sm_scale,
                          implementation=implementation)
    return _Unswizzle.apply(out, group, n)


def ulysses_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, mesh, causal: bool = False,
                              sm_scale: Optional[float] = None,
                              implementation: str = "auto") -> torch.Tensor:
    """All-to-all attention over ``mesh``'s ``seq`` group: the entry the
    sequence-parallel trunks call (the same signature as
    ``ring_attention_sharded``, so a trunk switches strategy by name)."""
    _check_heads(q.shape[1], mesh.seq_ways)  # before the group is made
    return ulysses_attention(q, k, v, mesh.seq_group(), mesh.seq_ways,
                             causal, sm_scale, implementation)
