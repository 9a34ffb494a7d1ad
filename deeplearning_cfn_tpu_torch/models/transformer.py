"""Shared transformer building blocks (the NMT encoder-decoder's and the
BERT encoder's layers, and BERT's ``Embed``).

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
same effect). Both cached modes take S >= 1 positions per row (the
speculative verify span): the S K/V vectors are written before the S
queries attend, under a span bias that keeps query j causal. The paged pool
may be int8 (``kv_quant``): codes plus per-block, per-head f32 scales,
requantized on every write and dequantized in the gather.

``QuantDense`` and ``QuantEmbed`` are the int8 weight-only layers of the
quantized serving copy (``serve/quant.py:quantize_model``).

Tensor parallelism (a ``mesh`` with ``model`` > 1, training across
processes): JAX's ``TRANSFORMER_PARAM_RULES`` split the query, key, value
and ``mlp_in`` kernels by their output features and the ``attn_out`` and
``mlp_out`` kernels by their input features, and GSPMD inserts the sums.
Here a ``Dense`` with ``split="column"`` holds its process's share of the
output features (and uses its columns of the whole, replicated bias), and
one with ``split="row"`` its share of the input features: its partial
products are summed over the ``model`` group
(``parallel.collectives.model_sum``, in the compute dtype, as GSPMD sums
the partial products of a bf16 product) before the whole bias is added
once. So ``MultiHeadAttention`` holds ``num_heads / model`` heads
(its per-row KV cache too) and runs ``fused_attention`` on them, and
``Mlp`` its share of ``mlp_dim``; everything else is replicated over the
group. Serving's paged path stays one process, as JAX's ``Engine`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import fused_attention
from ..parallel.collectives import model_copy, model_sum

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


def model_ways(mesh) -> int:
    """The ``model`` axis's size (1 without a mesh)."""
    return 1 if mesh is None else mesh.model_ways


class Dense(nn.Module):
    """``y = x @ W.T + b`` with f32 params, computed in ``dtype``
    (``use_bias=False``: no ``b``, as the MoE router). With ``split`` and a
    ``mesh`` whose ``model`` axis is above 1 it is this process's share of
    a tensor-parallel layer (the module docstring): ``"column"`` holds
    ``out_features / model`` output features, ``"row"`` ``in_features /
    model`` input features; the bias stays whole."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.bfloat16, use_bias: bool = True,
                 split: Optional[str] = None, mesh=None):
        super().__init__()
        self.dtype = dtype
        self.split = split if model_ways(mesh) > 1 else None
        bias = out_features  # whole, split or not
        if self.split is not None:
            # The leaf rules (parallel.sharding.PARAM_RULES) size the piece
            # from this module's mesh.
            self.mesh = mesh
            ways = mesh.model_ways
            dim = out_features if self.split == "column" else in_features
            if dim % ways:
                raise ValueError(f"{dim} features do not split over the "
                                 f"model axis ({ways} ways)")
            if self.split == "column":
                out_features //= ways
            else:
                in_features //= ways
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.register_parameter(
            "bias", nn.Parameter(torch.zeros(bias)) if use_bias else None)

    def piece_of(self, whole: torch.Tensor) -> torch.Tensor:
        """This process's piece of the whole ``[out, in]`` weight (all of
        it unless split)."""
        if self.split is None:
            return whole
        dim = 0 if self.split == "column" else 1
        n = self.weight.shape[dim]
        return whole.narrow(dim, self.mesh.model_index * n, n)

    @property
    def whole_shape(self) -> Tuple[int, int]:
        """The whole layer's ``[out, in]`` weight shape."""
        out, inp = self.weight.shape
        if self.split == "column":
            out *= self.mesh.model_ways
        elif self.split == "row":
            inp *= self.mesh.model_ways
        return out, inp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        w = self.weight.to(self.dtype)
        if self.split == "column":
            n = self.weight.shape[0]
            at = self.mesh.model_index * n
            b = None if b is None else b[at:at + n]
            return F.linear(model_copy(x, self.mesh).to(self.dtype), w, b)
        if self.split == "row":
            y = model_sum(F.linear(x.to(self.dtype), w), self.mesh)
            return y if b is None else y + b
        return F.linear(x.to(self.dtype), w, b)


class QuantDense(nn.Module):
    """Weight-only int8 ``Dense``: ``y = (x @ codes.T) * scale + bias``.

    ``weight`` holds the int8 codes ``[out, in]`` (the Flax kernel ``[in,
    out]`` transposed), ``scale`` one f32 factor per output channel and
    ``bias`` stays f32 — all buffers: the layer is built by quantizing a
    trained ``Dense``, never trained. The codes widen to the compute dtype
    inside the op; the scale multiplies after the product and the bias is
    added after that, as three ops in the JAX order (an ``addmm`` rounds
    differently in bf16)."""

    def __init__(self, codes: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("weight", codes)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)

    @classmethod
    def from_dense(cls, dense: "Dense") -> "QuantDense":
        from ..serve.quant import quantize_weight

        codes, scale = quantize_weight(dense.weight, transposed=True)
        return cls(codes, scale, dense.bias.detach().clone(), dense.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return y * self.scale.to(self.dtype) + self.bias.to(self.dtype)


class QuantEmbed(nn.Module):
    """Weight-only int8 token table with the tied-output ``attend``.

    ``weight`` holds the int8 codes ``[V, H]`` and ``scale`` one f32 factor
    per hidden channel, which serves both directions: the lookup
    dequantizes the gathered rows, and ``attend`` folds the scale into the
    query, so no float ``[V, H]`` table is ever made."""

    def __init__(self, codes: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("weight", codes)
        self.register_buffer("scale", scale)

    @classmethod
    def from_embedding(cls, emb: nn.Embedding) -> "QuantEmbed":
        from ..serve.quant import quantize_weight

        return cls(*quantize_weight(emb.weight, transposed=False))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.weight[ids].float() * self.scale

    def attend(self, query: torch.Tensor) -> torch.Tensor:
        # query @ (codes * scale).T == (query * scale) @ codes.T
        return torch.matmul(query * self.scale.to(query.dtype),
                            self.weight.to(query.dtype).t())


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


def span_bias(pos: torch.Tensor, s: int, span: int) -> torch.Tensor:
    """Multi-position decode bias [B, 1, s, span]: query j of row b (at
    position ``pos[b] + j``) sees positions <= ``pos[b] + j``."""
    keys = torch.arange(span, device=pos.device)
    last = pos[:, None] + torch.arange(s, device=pos.device)  # [B, s]
    live = keys[None, None, :] <= last[:, :, None]
    zero = torch.zeros((), dtype=torch.float32, device=pos.device)
    neg = torch.full((), _NEG_INF, dtype=torch.float32, device=pos.device)
    return torch.where(live, zero, neg)[:, None, :, :]


def _span_positions(pos: torch.Tensor, s: int, limit: int):
    """Row b's write positions ``pos[b] .. pos[b]+s-1`` [B, s] and which of
    them lie below ``limit`` (the cache's span)."""
    pos_mat = pos[:, None] + torch.arange(s, device=pos.device)
    return pos_mat, pos_mat < limit


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention over [B, S, H*D] activations. With a
    ``mesh`` whose ``model`` axis is above 1, ``num_heads`` is the heads
    this process holds (``H / model``): its query, key and value columns
    and its rows of ``attn_out``."""

    def __init__(self, features: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16,
                 attention_impl: str = "auto", dropout_rate: float = 0.0,
                 mesh=None):
        super().__init__()
        if features % num_heads:
            raise ValueError(f"hidden size {features} not divisible by "
                             f"{num_heads} heads")
        ways = model_ways(mesh)
        if num_heads % ways:
            raise ValueError(f"{num_heads} heads do not split over the "
                             f"model axis ({ways} ways)")
        self.num_heads = num_heads // ways
        self.head_dim = features // num_heads
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.dropout_rate = dropout_rate
        column = lambda: Dense(features, features, dtype, split="column",
                               mesh=mesh)
        self.query = column()
        self.key = column()
        self.value = column()
        self.attn_out = Dense(features, features, dtype, split="row",
                              mesh=mesh)

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
        """Self-attention of S >= 1 positions per row against a per-row
        cache [B, H, max_len, D]: row b's S K/V vectors land at ``pos[b]``
        .. ``pos[b]+S-1`` (in place, before the attend) and query j attends
        to positions ``<= pos[b]+j``. Positions ``>= max_len`` are dropped,
        as the JAX scatter drops them; ``pos[b]`` itself must be below
        ``max_len``."""
        ck, cv = cache
        q = self._split(self.query(x))
        k = self._split(self.key(x))
        v = self._split(self.value(x))
        b, _, s, _ = q.shape
        rows = torch.arange(b, device=q.device)
        if s == 1:
            ck[rows, :, pos, :] = k[:, :, 0, :].to(ck.dtype)
            cv[rows, :, pos, :] = v[:, :, 0, :].to(cv.dtype)
            bias = step_bias(pos, ck.shape[2])
        else:
            # index_put has no drop mode, and a clamped index would let a
            # dropped entry overwrite position max_len - 1. So a dropped
            # entry repeats the row's last in-range entry, index AND value:
            # each in-range position is written with its own K/V only, and
            # no host sync is needed to count the dropped entries.
            pos_mat, valid = _span_positions(pos, s, ck.shape[2])
            last = valid.long().sum(1, keepdim=True) - 1  # [B, 1]
            j = torch.minimum(torch.arange(s, device=q.device)[None, :],
                              last)  # [B, S]
            at = pos[:, None] + j
            r = rows[:, None].expand(b, s)
            ck[r, :, at, :] = k.transpose(1, 2)[r, j].to(ck.dtype)
            cv[r, :, at, :] = v.transpose(1, 2)[r, j].to(cv.dtype)
            bias = span_bias(pos, s, ck.shape[2])
        return self._merge(self._attend(q, ck, cv, bias, False))

    def decode_paged(self, x: torch.Tensor, cache, pos: torch.Tensor,
                     block_tables: torch.Tensor) -> torch.Tensor:
        """:meth:`decode_at` against a shared block pool
        [num_blocks, H, block_size, D]: row b's logical position p lives in
        block ``block_tables[b, p // block_size]`` at offset
        ``p % block_size``. Unbound table entries point at the null block
        0 (writes from idle rows land there; the bias hides it), and so do
        positions past the table's span. With ``max_blocks * block_size ==
        max_len`` the gathered span equals the dense row, so the output is
        bit-identical to :meth:`decode_at`.

        ``cache`` is ``(pk, pv)``, or ``(pk, pv, sk, sv)`` for the int8
        pool: int8 codes with f32 scales [num_blocks, H] per block and
        head (:meth:`_requant_write`)."""
        pk, pv, *scales = cache
        sk, sv = scales or (None, None)
        bs = pk.shape[2]
        q = self._split(self.query(x))
        k = self._split(self.key(x))
        v = self._split(self.value(x))
        b, _, s, _ = q.shape
        rows = torch.arange(b, device=q.device)
        mb = block_tables.shape[1]
        span = mb * bs
        if sk is not None:
            self._requant_write(pk, sk, k, pos, block_tables)
            self._requant_write(pv, sv, v, pos, block_tables)
            bias = step_bias(pos, span) if s == 1 \
                else span_bias(pos, s, span)
        elif s == 1:
            blk = block_tables[rows, pos // bs]
            off = pos % bs
            pk[blk, :, off, :] = k[:, :, 0, :].to(pk.dtype)
            pv[blk, :, off, :] = v[:, :, 0, :].to(pv.dtype)
            bias = step_bias(pos, span)
        else:
            # Positions past the span go to the null block 0 at offset 0,
            # never through a clamped table index (that would overwrite the
            # row's real last block).
            pos_mat, valid = _span_positions(pos, s, span)
            entry = torch.clamp(pos_mat // bs, max=mb - 1)
            blk = torch.where(valid, block_tables[rows[:, None], entry], 0)
            off = torch.where(valid, pos_mat % bs, 0)
            # Advanced indices at dims 0 and 2 put [B, S] first.
            pk[blk, :, off, :] = k.transpose(1, 2).to(pk.dtype)
            pv[blk, :, off, :] = v.transpose(1, 2).to(pv.dtype)
            bias = span_bias(pos, s, span)

        def gathered(pool, scale):  # [B, MB, H, bs, D] -> [B, H, span, D]
            g = pool[block_tables]
            if scale is not None:
                # Dequantize in the gather: the pool itself stays int8.
                g = (g.float() * scale[block_tables][..., None, None]) \
                    .to(self.dtype)
            return g.transpose(1, 2).reshape(
                b, self.num_heads, span, self.head_dim)

        out = self._attend(q, gathered(pk, sk), gathered(pv, sv), bias,
                           False)
        return self._merge(out)

    def _requant_write(self, codes: torch.Tensor, scale: torch.Tensor,
                       new: torch.Tensor, pos: torch.Tensor,
                       block_tables: torch.Tensor) -> None:
        """Write this step's K or V ``new`` [B, H, S, D] into the int8 pool
        by read-modify-write, one code path for S = 1 and the verify span
        (JAX ``models/transformer.py:240-288``): gather the window of
        ``T = (S + 2·bs − 2) // bs`` blocks from ``pos // bs``, dequantize
        it in f32, insert the S vectors, zero every position at or above
        ``min(pos + S, span)`` (recycled blocks' leftovers would inflate the
        absmax), requantize each (block, head) to absmax / 127 and write
        codes and scales back.

        JAX sends window blocks past the table, or on the null block 0, to
        the index ``num_blocks``, which its scatter drops; positions past
        the span go to an offset past the window. ``index_put`` drops
        nothing, so only the selected (row, block) pairs are written
        (:func:`_put_selected`): no index is clamped, and block 0 is never
        given anything but its own content."""
        b, h, s, d = new.shape
        bs = codes.shape[2]
        mb = block_tables.shape[1]
        span = mb * bs
        dev = new.device
        n_win = (s + 2 * bs - 2) // bs
        rows = torch.arange(b, device=dev)[:, None]
        base = pos // bs
        entry = base[:, None] + torch.arange(n_win, device=dev)  # [B, T]
        in_table = entry < mb
        phys = torch.where(
            in_table, block_tables[rows, torch.clamp(entry, max=mb - 1)], 0)
        pos_mat, valid = _span_positions(pos, s, span)
        # Window offsets; a position past the span goes to the spare slot
        # n_win * bs, cut off below.
        woff = torch.where(valid, pos_mat - base[:, None] * bs, n_win * bs)
        win = codes[phys].float() * scale[phys][..., None, None]
        win = win.transpose(2, 3).reshape(b, n_win * bs, h, d)
        win = torch.cat([win, win.new_zeros(b, 1, h, d)], dim=1)
        win[rows.expand(b, s), woff] = new.transpose(1, 2).float()
        win = win[:, :n_win * bs]
        wpos = base[:, None] * bs + torch.arange(n_win * bs, device=dev)
        live = wpos < torch.clamp(pos + s, max=span)[:, None]
        win = torch.where(live[:, :, None, None], win, 0.0)
        blocks = win.reshape(b, n_win, bs, h, d).transpose(2, 3)
        amax = blocks.abs().amax(dim=(3, 4))  # [B, T, H]
        new_scale = torch.where(amax > 0.0, amax / 127.0,
                                torch.ones_like(amax))
        new_codes = torch.clamp(
            torch.round(blocks / new_scale[..., None, None]), -127.0,
            127.0).to(torch.int8)
        sel = in_table & (phys > 0)
        _put_selected(codes, phys, new_codes, sel)
        _put_selected(scale, phys, new_scale, sel)


def _put_selected(pool: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                  sel: torch.Tensor) -> None:
    """``pool[idx[sel]] = val[sel]`` with no host sync (a boolean index
    waits for the card to count it): an unselected entry repeats the first
    selected one, index and value, so it rewrites what that entry writes;
    with none selected every entry rewrites block 0 with its own content.
    The selected indices must be distinct."""
    idx = idx.reshape(-1)
    sel = sel.reshape(-1)
    val = val.reshape(idx.shape[0], *val.shape[2:])
    first = torch.argmax(sel.to(torch.uint8))  # the first selected, or 0
    some = sel.any()
    fill_idx = torch.where(some, idx[first], 0)
    fill_val = torch.where(some, val[first], pool[0])
    keep = sel.view(-1, *([1] * (val.ndim - 1)))
    pool[torch.where(sel, idx, fill_idx)] = torch.where(keep, val, fill_val)


class Mlp(nn.Module):
    """The FFN; with a ``mesh`` whose ``model`` axis is above 1, this
    process's ``mlp_dim / model`` hidden units."""

    def __init__(self, features: int, mlp_dim: int,
                 dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.0, mesh=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.mlp_in = Dense(features, mlp_dim, dtype, split="column",
                            mesh=mesh)
        self.mlp_out = Dense(mlp_dim, features, dtype, split="row",
                             mesh=mesh)

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

    ``num_experts > 0`` swaps the dense FFN for a Mixture-of-Experts FFN
    (``moe_mlp``, ``models/moe.py``; its norm keeps the name ``mlp_norm``)
    and makes ``forward`` return ``(x, moe_aux)``, as the JAX layer does;
    ``mesh`` is the MoE layer's (its experts and router statistics across
    processes) and both sublayers' (their heads and hidden units over the
    ``model`` axis).
    """

    def __init__(self, features: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype = torch.bfloat16, prenorm: bool = False,
                 cross_attention: bool = False,
                 attention_impl: str = "auto", dropout_rate: float = 0.0,
                 num_experts: int = 0, moe_capacity_factor: float = 1.25,
                 moe_top_k: int = 2, mesh=None):
        super().__init__()
        self.prenorm = prenorm
        attn = lambda: MultiHeadAttention(features, num_heads, dtype,
                                          attention_impl, dropout_rate,
                                          mesh)
        ln = lambda: LayerNorm(features, dtype)
        self.self_attn = attn()
        self.self_attn_norm = ln()
        self.cross_attention = cross_attention
        if cross_attention:
            self.cross_attn = attn()
            self.cross_attn_norm = ln()
        self.num_experts = num_experts
        if num_experts > 0:
            from .moe import MoeMlp

            self.moe_mlp = MoeMlp(features, num_experts, mlp_dim,
                                  moe_capacity_factor, moe_top_k, dtype,
                                  mesh)
        else:
            self.mlp = Mlp(features, mlp_dim, dtype, dropout_rate, mesh)
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
                generator: Optional[torch.Generator] = None):
        """``generator`` (dense mode only) draws the dropout masks; None
        means not training. Returns ``x``, or ``(x, moe_aux)`` for a MoE
        layer."""
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
        if self.num_experts > 0:
            aux = {}

            def moe_sub(y):
                out, layer_aux = self.moe_mlp(y)
                aux.update(layer_aux)
                return out

            return self._residual(x, moe_sub, self.mlp_norm), aux
        return self._residual(x, lambda y: self.mlp(y, generator),
                              self.mlp_norm)


def is_moe_layer(i: int, num_experts: int, moe_every: int) -> bool:
    """GShard's every-``moe_every``-th-layer convention, shared by the BERT
    and GPT trunks."""
    return num_experts > 0 and i % moe_every == moe_every - 1


class MoeAuxAccumulator:
    """Sum the MoE aux losses over a trunk's MoE layers and return their
    per-layer mean (keys as ``MoeMlp``'s aux dict; zeros without a MoE
    layer)."""

    def __init__(self, device):
        zero = lambda: torch.zeros((), dtype=torch.float32, device=device)
        self.totals = {"load_balance": zero(), "router_z": zero()}
        self.n = 0

    def add(self, aux) -> None:
        self.totals = {k: self.totals[k] + aux[k] for k in self.totals}
        self.n += 1

    def mean(self):
        return {k: v / max(self.n, 1) for k, v in self.totals.items()}


def xavier_uniform_(dense: Dense, generator: torch.Generator) -> None:
    """Flax's ``xavier_uniform`` kernel of ``dense``, drawn whole (a
    tensor-parallel piece takes its part of the whole draw, so the
    generator's stream and the layer are one process's)."""
    fan_out, fan_in = dense.whole_shape
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    whole = torch.empty(dense.whole_shape, device=dense.weight.device)
    whole.uniform_(-limit, limit, generator=generator)
    dense.weight.copy_(dense.piece_of(whole))


def init_flax_defaults(model: nn.Module, generator: torch.Generator,
                       tables) -> None:
    """The Flax init of the encoder-decoder, decoder-only and ViT families:
    xavier-uniform ``Dense`` kernels, zero biases, ``LayerNorm`` ones/zeros,
    ``normal(0.02)`` for each tensor of ``tables`` (token tables, position
    tables), and the MoE layers' own init (``moe.init_moe_``). Runs on the
    model's device with ``generator`` (which must live there too)."""
    from .moe import init_moe_

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Dense):
                xavier_uniform_(mod, generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for t in tables:
            t.normal_(0.0, 0.02, generator=generator)
    init_moe_(model, generator)


class Embed(nn.Module):
    """Token + learned-position (+ optional segment) embeddings — Flax's
    ``Embed`` of ``models/transformer.py``: the sum in f32, cast to the
    compute dtype, LayerNorm (``norm``), then dropout. ``forward`` returns
    the activations and the token table, which the MLM decoder attends
    with (tied output embedding)."""

    def __init__(self, vocab_size: int, hidden_size: int, max_len: int,
                 num_segments: int = 0, dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.token = nn.Embedding(vocab_size, hidden_size)
        self.position = nn.Parameter(torch.empty(max_len, hidden_size))
        self.segment = nn.Embedding(num_segments, hidden_size) \
            if num_segments else None
        self.norm = LayerNorm(hidden_size, dtype)

    def forward(self, ids: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """``offset``: the position of ``ids[:, 0]`` (a sequence-parallel
        trunk embeds its slice of each row)."""
        x = self.token(ids) \
            + self.position[None, offset:offset + ids.shape[1], :]
        if self.segment is not None and segment_ids is not None:
            x = x + self.segment(segment_ids)
        x = dropout(self.norm(x.to(self.dtype)), self.dropout_rate,
                    generator)
        return x, self.token.weight
