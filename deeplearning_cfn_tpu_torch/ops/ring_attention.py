"""Ring attention: exact attention over a sequence split across the processes
of a ``seq`` group — the port of ``deeplearning_cfn_tpu/ops/ring_attention.py``.

Each process holds its ``[B, H, S/n, D]`` slice of Q, K and V (slice ``i``
is positions ``i·S/n`` onwards). K and V rotate around the group, process
``i`` sending to ``i + 1``, so after ``r`` rotations process ``i`` holds
the slice of ``i − r``; each visiting block adds to this process's queries
through the same online softmax (running max ``m``, sum ``l``, accumulator)
that the flash kernel keeps per tile. The result is exact attention; causal
masking compares global positions, so a block wholly above the diagonal
contributes nothing.

``ring_attention`` is a ``torch.autograd.Function``. The forward returns
the output and keeps ``q, k, v, out`` and the per-row logsumexp, so memory
stays O(S/n) whatever the group's size. The backward rotates ``k, v`` and
the visiting block's ``dk, dv`` partials together: each step recomputes P
from the saved logsumexp for one (local Q, visiting KV) block, adds this
process's queries' share to the visitor's ``dk, dv`` and accumulates ``dq``
at home; one last rotation brings every ``dk, dv`` back to its own process.

The block step is two products and the softmax bookkeeping, which the JAX
package computes outside any Pallas kernel (``einsum`` with f32
accumulation); here they are plain PyTorch products in f32, the softmax
weights cast to V's dtype before the PV product as in JAX. The rotations go
through ``parallel.collectives.send_recv`` (``torch.distributed``'s batched
point-to-point over the group; a CUDA tensor is staged through the host
under gloo) and are timed, when ``collectives.comm_timer`` is on, as
``"ring"``.

``ring_attention_sharded`` is the entry the sequence-parallel trunks call:
the mesh's ``seq`` group and this process's place in it.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from ..parallel.collectives import comm_timer, send_recv

_NEG_INF = -1e30


def _masked(s, q_off: int, k_off: int, causal: bool):
    """Block logits with the global causal mask: key position ``k_off + j``
    visible to query position ``q_off + i`` when it is not later."""
    if not causal:
        return s
    sq, sk = s.shape[-2], s.shape[-1]
    q_pos = torch.arange(sq, device=s.device)[:, None] + q_off
    k_pos = torch.arange(sk, device=s.device)[None, :] + k_off
    return torch.where(k_pos <= q_pos, s, torch.full_like(s, _NEG_INF))


def _block_attn(q, k, v, q_off, k_off, causal, scale):
    """One (local Q, visiting KV) block: the block's row max, row sum and
    unnormalised PV, in f32."""
    s = _masked(torch.matmul(q.float(), k.float().transpose(-1, -2))
                * scale, q_off, k_off, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    pv = torch.matmul(p.to(v.dtype).float(), v.float())
    return m, l, pv


class _Ring:
    """Where this process sits in its ``seq`` group: global ranks in
    ``seq`` order, its own index, the group."""

    def __init__(self, ranks: List[int], index: int, group):
        self.ranks, self.index, self.group = ranks, index, group
        self.n = len(ranks)

    def rotate(self, tensors, device):
        """Every tensor to the next process, the previous one's in."""
        if self.n == 1:
            return list(tensors)
        with comm_timer.measure("ring", device):
            return send_recv(tensors, self.ranks[(self.index + 1) % self.n],
                             self.ranks[(self.index - 1) % self.n],
                             self.group)

    def source(self, r: int) -> int:
        """The ``seq`` index whose slice this process holds after ``r``
        rotations."""
        return (self.index - r) % self.n


def _ring_forward(q, k, v, ring: _Ring, causal: bool, scale: float):
    """The online-softmax ring pass → (out in q's dtype, lse [B,H,S,1])."""
    b, h, s_local, d = q.shape
    q_off = ring.index * s_local
    m = torch.full((b, h, s_local, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s_local, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s_local, d), dtype=torch.float32,
                      device=q.device)
    kv = [k.contiguous(), v.contiguous()]
    for r in range(ring.n):
        if r:
            # Rotate first, then accumulate: the own block (r = 0) needs no
            # exchange, so n - 1 rotations happen in all.
            kv = ring.rotate(kv, q.device)
        k_off = ring.source(r) * s_local
        m_cur, l_cur, pv = _block_attn(q, kv[0], kv[1], q_off, k_off, causal,
                                       scale)
        m_new = torch.maximum(m, m_cur)
        alpha_prev, alpha_cur = torch.exp(m - m_new), torch.exp(m_cur - m_new)
        l = l * alpha_prev + l_cur * alpha_cur
        acc = acc * alpha_prev + pv * alpha_cur
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    lse = m + torch.log(torch.clamp(l, min=1e-37))
    return out, lse


def _ring_backward(q, k, v, out, lse, g, ring: _Ring, causal: bool,
                   scale: float):
    """``(dq, dk, dv)``: q, dO and lse stay home while k, v and the
    visiting block's dk, dv partials rotate."""
    s_local = q.shape[-2]
    q_off = ring.index * s_local
    do = g.float()
    qf = q.float()
    delta = (do * out.float()).sum(-1, keepdim=True)

    def block_grads(k_r, v_r, r):
        kf = k_r.float()
        s = _masked(torch.matmul(qf, kf.transpose(-1, -2)) * scale, q_off,
                    ring.source(r) * s_local, causal)
        p = torch.exp(s - lse)  # 0 where masked
        dv_c = torch.matmul(p.transpose(-1, -2), do)
        dp = torch.matmul(do, v_r.float().transpose(-1, -2))
        ds = p * (dp - delta)
        dq_c = scale * torch.matmul(ds, kf)
        dk_c = scale * torch.matmul(ds.transpose(-1, -2), qf)
        return dq_c, dk_c, dv_c

    dq, dk, dv = block_grads(k, v, 0)
    kv = [k.contiguous(), v.contiguous()]
    for r in range(1, ring.n):
        k_r, v_r, dk_r, dv_r = ring.rotate([*kv, dk, dv], q.device)
        kv = [k_r, v_r]
        dq_c, dk_c, dv_c = block_grads(k_r, v_r, r)
        dq, dk, dv = dq + dq_c, dk_r + dk_c, dv_r + dv_c
    if ring.n > 1:
        # The visiting block is one final hop from home.
        dk, dv = ring.rotate([dk, dv], q.device)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class RingAttention(torch.autograd.Function):
    """Ring attention with the JAX custom VJP's residuals: ``q, k, v, out``
    and the logsumexp."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal, scale):
        out, lse = _ring_forward(q, k, v, ring, causal, scale)
        ctx.ring, ctx.causal, ctx.scale = ring, causal, scale
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, out, lse, g, ctx.ring,
                                    ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   ranks: List[int], index: int, group,
                   causal: bool = False,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention of this process's slice ``[B, H, S/n, D]`` of a
    sequence split over ``ranks`` (global ranks in sequence order; this
    process is ``ranks[index]``) in ``group``."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return RingAttention.apply(q, k, v, _Ring(ranks, index, group), causal,
                               scale)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mesh, causal: bool = False,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention over ``mesh``'s ``seq`` group (``parallel/mesh.py``):
    the entry the sequence-parallel trunks call."""
    return ring_attention(q, k, v, mesh.seq_ranks, mesh.seq_index,
                          mesh.seq_group(), causal, sm_scale)
