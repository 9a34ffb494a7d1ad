"""Shared transformer building blocks (the NMT encoder-decoder's layers).

The port of ``deeplearning_cfn_tpu/models/transformer.py``. Numerics follow
the Flax modules exactly:

- ``Dense`` is ``nn.Dense(dtype=compute, param_dtype=f32)``: input, kernel
  and bias are cast to the compute dtype before the product;
- ``LayerNorm`` is Flax's: statistics in f32, ``epsilon=1e-6``, output in
  the compute dtype;
- the MLP activation is Flax's default ``gelu`` (the tanh approximation);
- attention goes through ``ops.fused_attention`` — on the card the
  hand-written flash kernels for every call, the decode steps included, and
  under grad their backward;
- dropout sits where Flax puts it: after ``attn_out`` and after ``mlp_out``
  (none on the attention weights, so none inside a kernel). It draws its
  masks from an explicit ``torch.Generator`` passed down the call
  (``generator=None`` means not training: dropout is the identity).

``MultiHeadAttention`` has the three modes of the JAX module that the
serving slice uses: dense (full sequences), the per-row ``decode_pos``
cache [B, H, max_len, D], and the paged block pool
[num_blocks, H, block_size, D] with a null block 0. Caches are tensors the
caller owns and are updated in place (the JAX engine donates them to the
same effect). The multi-position (speculative) writes and the int8 KV pool
are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import fused_attention

_NEG_INF = -1e30

KvCache = Tuple[torch.Tensor, torch.Tensor]


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep each element with probability ``1 - rate``
    and scale kept values by ``1 / (1 - rate)``. The mask is drawn from
    ``generator`` (``F.dropout`` takes none); without one — not training —
    or at rate 0 this is the identity."""
    if generator is None or rate <= 0.0:
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator)
    return torch.where(keep.bool(), x / (1.0 - rate), torch.zeros_like(x))


class Dense(nn.Module):
    """``y = x @ W.T + b`` with f32 params, computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(dtype=dtype, param_dtype=f32)``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16,
                 eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


def padding_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, S] 1/0 attention mask → additive f32 bias [B, 1, 1, S]."""
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    neg = torch.full((), _NEG_INF, dtype=torch.float32, device=mask.device)
    return torch.where(mask.bool(), zero, neg)[:, None, None, :]


def step_bias(pos: torch.Tensor, span: int) -> torch.Tensor:
    """Per-row decode bias [B, 1, 1, span]: row b sees positions <= pos[b]."""
    keys = torch.arange(span, device=pos.device)
    live = keys[None, :] <= pos[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=pos.device)
    neg = torch.full((), _NEG_INF, dtype=torch.float32, device=pos.device)
    return torch.where(live, zero, neg)[:, None, None, :]


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention over [B, S, H*D] activations."""

    def __init__(self, features: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16,
                 attention_impl: str = "auto", dropout_rate: float = 0.0):
        super().__init__()
        if features % num_heads:
            raise ValueError(f"hidden size {features} not divisible by "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.head_dim = features // num_heads
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.dropout_rate = dropout_rate
        self.query = Dense(features, features, dtype)
        self.key = Dense(features, features, dtype)
        self.value = Dense(features, features, dtype)
        self.attn_out = Dense(features, features, dtype)

    def _split(self, t: torch.Tensor) -> torch.Tensor:  # [B,S,F] -> [B,H,S,D]
        b, s, _ = t.shape
        return t.view(b, s, self.num_heads, self.head_dim).transpose(1, 2)

    def _merge(self, out: torch.Tensor) -> torch.Tensor:  # [B,H,S,D] -> [B,S,F]
        b, h, s, d = out.shape
        return self.attn_out(out.transpose(1, 2).reshape(b, s, h * d))

    def _attend(self, q, k, v, bias, causal):
        return fused_attention(q, k, v, bias=bias, causal=causal,
                               implementation=self.attention_impl)

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                causal: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        kv = x if kv is None else kv
        q = self._split(self.query(x))
        k = self._split(self.key(kv))
        v = self._split(self.value(kv))
        out = self._merge(self._attend(q, k, v, bias, causal))
        return dropout(out, self.dropout_rate, generator)

    def decode_at(self, x: torch.Tensor, cache: KvCache,
                  pos: torch.Tensor) -> torch.Tensor:
        """Single-position self-attention against a per-row cache
        [B, H, max_len, D]: row b's K/V land at ``pos[b]`` (in place) and
        row b attends to positions ``<= pos[b]``."""
        ck, cv = cache
        q = self._split(self.query(x))
        k = self._split(self.key(x))
        v = self._split(self.value(x))
        rows = torch.arange(q.shape[0], device=q.device)
        ck[rows, :, pos, :] = k[:, :, 0, :].to(ck.dtype)
        cv[rows, :, pos, :] = v[:, :, 0, :].to(cv.dtype)
        out = self._attend(q, ck, cv, step_bias(pos, ck.shape[2]), False)
        return self._merge(out)

    def decode_paged(self, x: torch.Tensor, cache: KvCache,
                     pos: torch.Tensor,
                     block_tables: torch.Tensor) -> torch.Tensor:
        """Single-position self-attention against a shared block pool
        [num_blocks, H, block_size, D]: row b's logical position p lives in
        block ``block_tables[b, p // block_size]`` at offset
        ``p % block_size``. Unbound table entries point at the null block
        0 (writes from idle rows land there; the step bias hides it). With
        ``max_blocks * block_size == max_len`` the gathered span equals the
        dense row, so the output is bit-identical to :meth:`decode_at`."""
        pk, pv = cache
        bs = pk.shape[2]
        q = self._split(self.query(x))
        k = self._split(self.key(x))
        v = self._split(self.value(x))
        b = q.shape[0]
        rows = torch.arange(b, device=q.device)
        blk = block_tables[rows, pos // bs]
        off = pos % bs
        pk[blk, :, off, :] = k[:, :, 0, :].to(pk.dtype)
        pv[blk, :, off, :] = v[:, :, 0, :].to(pv.dtype)
        span = block_tables.shape[1] * bs

        def gathered(pool):  # [B, MB, H, bs, D] -> [B, H, span, D]
            return pool[block_tables].transpose(1, 2).reshape(
                b, self.num_heads, span, self.head_dim)

        out = self._attend(q, gathered(pk), gathered(pv),
                           step_bias(pos, span), False)
        return self._merge(out)


class Mlp(nn.Module):
    def __init__(self, features: int, mlp_dim: int,
                 dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.mlp_in = Dense(features, mlp_dim, dtype)
        self.mlp_out = Dense(mlp_dim, features, dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.mlp_out(F.gelu(self.mlp_in(x), approximate="tanh"))
        return dropout(y, self.dropout_rate, generator)


class TransformerLayer(nn.Module):
    """One block: self-attn (+ optional cross-attn) + FFN.

    ``prenorm=False`` is the post-LN layout, ``prenorm=True`` the pre-LN one
    the NMT preset uses. The self-attention runs in one of three modes:
    dense (``cache=None``), per-row decode (``cache`` + ``pos``), or paged
    decode (``cache`` + ``pos`` + ``block_tables``).
    """

    def __init__(self, features: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype = torch.bfloat16, prenorm: bool = False,
                 cross_attention: bool = False,
                 attention_impl: str = "auto", dropout_rate: float = 0.0):
        super().__init__()
        self.prenorm = prenorm
        attn = lambda: MultiHeadAttention(features, num_heads, dtype,
                                          attention_impl, dropout_rate)
        ln = lambda: LayerNorm(features, dtype)
        self.self_attn = attn()
        self.self_attn_norm = ln()
        self.cross_attention = cross_attention
        if cross_attention:
            self.cross_attn = attn()
            self.cross_attn_norm = ln()
        self.mlp = Mlp(features, mlp_dim, dtype, dropout_rate)
        self.mlp_norm = ln()

    def _residual(self, x, sub, norm):
        if self.prenorm:
            return x + sub(norm(x))
        return norm(x + sub(x))

    def forward(self, x: torch.Tensor, enc: Optional[torch.Tensor] = None,
                self_bias: Optional[torch.Tensor] = None,
                cross_bias: Optional[torch.Tensor] = None,
                causal: bool = False, cache: Optional[KvCache] = None,
                pos: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` (dense mode only) draws the dropout masks; None
        means not training."""
        if cache is None:
            self_sub = lambda y: self.self_attn(y, bias=self_bias,
                                                causal=causal,
                                                generator=generator)
        elif block_tables is None:
            self_sub = lambda y: self.self_attn.decode_at(y, cache, pos)
        else:
            self_sub = lambda y: self.self_attn.decode_paged(
                y, cache, pos, block_tables)
        x = self._residual(x, self_sub, self.self_attn_norm)
        if self.cross_attention:
            if enc is None:
                raise ValueError("cross_attention layer needs encoder output")
            x = self._residual(
                x, lambda y: self.cross_attn(y, kv=enc, bias=cross_bias,
                                             generator=generator),
                self.cross_attn_norm)
        return self._residual(x, lambda y: self.mlp(y, generator),
                              self.mlp_norm)
