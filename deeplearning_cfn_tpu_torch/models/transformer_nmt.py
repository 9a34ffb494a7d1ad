"""Transformer NMT (encoder-decoder) — the port of
``deeplearning_cfn_tpu/models/transformer_nmt.py``.

Pre-LN transformer-base with one token table tied three ways (source,
target and output projection) plus learned source/target positions. The
methods the serving engine and the offline decoders call are here:
``encode`` (and ``encode_partial``, the chunked-prefill encode), ``decode``
(teacher-forced), ``decode_step`` (one shared position, for the offline
oracles), ``decode_step_at`` (per-row positions over a dense cache),
``decode_step_paged`` (per-row positions over a block pool), the
fused-argmax ``greedy_step_at``/``greedy_step_paged``, and the speculative
verify spans ``decode_span_at``/``decode_span_paged`` (S positions per row
in one call).

Decoder KV caches are explicit: :meth:`TransformerNMT.init_cache` returns a
list of per-layer ``(k, v)`` tensors [B, H, max_len, D] and
:meth:`TransformerNMT.init_paged_cache` a list of per-layer pools
[num_blocks, H, block_size, D] (with ``kv_quant="int8"``: int8 codes plus
their per-block, per-head f32 scales); the decode steps update them in
place.

Int8 serving: ``serve/quant.py:quantize_model`` returns a copy whose
projections are ``QuantDense`` and whose token table (tied three ways) is a
``QuantEmbed``; ``quantized`` tells the two apart.

Training: ``forward(src_ids, src_mask, tgt_in_ids, train=True,
generator=g)`` applies dropout (embeddings, after every attention and MLP
block, as Flax does) with masks drawn from the ``torch.Generator`` ``g``.

Batch contract: src_ids [B, S], src_mask [B, S], tgt ids [B, T].
Special ids: 0=[PAD], 1=[BOS], 2=[EOS].
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from . import register_model
from .transformer import (KvCache, LayerNorm, QuantEmbed, TransformerLayer,
                          dropout, init_flax_defaults, padding_bias)


class NmtEmbeddings(nn.Module):
    """Shared token table (tied 3 ways) plus separate learned source/target
    positions."""

    def __init__(self, vocab_size: int, hidden_size: int, max_len: int,
                 dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.token = nn.Embedding(vocab_size, hidden_size)
        self.src_position = nn.Parameter(torch.empty(max_len, hidden_size))
        self.tgt_position = nn.Parameter(torch.empty(max_len, hidden_size))
        self.src_norm = LayerNorm(hidden_size, dtype)
        self.tgt_norm = LayerNorm(hidden_size, dtype)

    def embed_src(self, ids: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
        x = self.token(ids) + self.src_position[None, :ids.shape[1], :]
        return dropout(self.src_norm(x.to(self.dtype)), self.dropout_rate,
                       generator)

    def embed_tgt(self, ids: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
        y = self.token(ids) + self.tgt_position[None, :ids.shape[1], :]
        return dropout(self.tgt_norm(y.to(self.dtype)), self.dropout_rate,
                       generator)

    def embed_tgt_at(self, ids: torch.Tensor, pos: torch.Tensor
                     ) -> torch.Tensor:
        """[B, S] ids at per-row positions ``pos`` [B] .. ``pos + S - 1``,
        each clamped to the last position-table row (as JAX clamps; the
        engine never emits from a clamped position)."""
        s = ids.shape[1]
        if s == 1:
            pos_emb = self.tgt_position[pos][:, None, :]
        else:
            pos_mat = torch.clamp(
                pos[:, None] + torch.arange(s, device=pos.device),
                max=self.tgt_position.shape[0] - 1)
            pos_emb = self.tgt_position[pos_mat]
        y = self.token(ids) + pos_emb
        return self.tgt_norm(y.to(self.dtype))

    def logits(self, y: torch.Tensor) -> torch.Tensor:
        # Tied output projection, in f32 (Flax Embed.attend on an f32 query).
        if isinstance(self.token, QuantEmbed):
            return self.token.attend(y.float())
        return torch.matmul(y.float(), self.token.weight.t())


class TransformerNMT(nn.Module):
    def __init__(self, vocab_size: int = 32000, hidden_size: int = 512,
                 num_layers: int = 6, num_heads: int = 8, mlp_dim: int = 2048,
                 max_len: int = 512, dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.0, attention_impl: str = "auto",
                 mesh=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.mlp_dim = mlp_dim
        self.max_len = max_len
        self.dtype = dtype
        self.quantized = False  # True on serve/quant.py's int8 copy
        self.embed = NmtEmbeddings(vocab_size, hidden_size, max_len, dtype,
                                   dropout_rate)
        layer = lambda cross: TransformerLayer(
            hidden_size, num_heads, mlp_dim, dtype, prenorm=True,
            cross_attention=cross, attention_impl=attention_impl,
            dropout_rate=dropout_rate, mesh=mesh)
        self.enc = nn.ModuleList([layer(False) for _ in range(num_layers)])
        self.enc_norm = LayerNorm(hidden_size, dtype)
        self.dec = nn.ModuleList([layer(True) for _ in range(num_layers)])
        self.dec_norm = LayerNorm(hidden_size, dtype)

    @property
    def device(self) -> torch.device:
        return self.embed.token.weight.device

    # -- caches ------------------------------------------------------------

    @property
    def local_heads(self) -> int:
        """The heads each attention of this process holds (``num_heads``
        over the mesh's ``model`` axis)."""
        return self.dec[0].self_attn.num_heads

    def init_cache(self, batch: int) -> List[KvCache]:
        """Per-layer dense decoder caches [B, H, max_len, D] (zeros; H the
        heads this process holds)."""
        shape = (batch, self.local_heads, self.max_len,
                 self.hidden_size // self.num_heads)
        return [(torch.zeros(shape, dtype=self.dtype, device=self.device),
                 torch.zeros(shape, dtype=self.dtype, device=self.device))
                for _ in range(self.num_layers)]

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         kv_quant: str = "") -> List[tuple]:
        """Per-layer block pools [num_blocks, H, block_size, D] (zeros).
        ``kv_quant="int8"``: int8 code pools plus f32 scale sidecars
        [num_blocks, H] (ones, as JAX initialises them), per layer
        ``(k codes, v codes, k scales, v scales)``."""
        shape = (num_blocks, self.num_heads, block_size,
                 self.hidden_size // self.num_heads)
        dev = self.device
        if not kv_quant:
            return [(torch.zeros(shape, dtype=self.dtype, device=dev),
                     torch.zeros(shape, dtype=self.dtype, device=dev))
                    for _ in range(self.num_layers)]
        from ..serve.quant import check_kv_quant_dtype

        check_kv_quant_dtype(kv_quant)
        codes = lambda: torch.zeros(shape, dtype=torch.int8, device=dev)
        ones = lambda: torch.ones(shape[:2], dtype=torch.float32,
                                  device=dev)
        return [(codes(), codes(), ones(), ones())
                for _ in range(self.num_layers)]

    # -- forward paths -----------------------------------------------------

    def encode(self, src_ids: torch.Tensor, src_mask: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the dropout masks (None: not training)."""
        x = self.embed.embed_src(src_ids, generator)
        enc_bias = padding_bias(src_mask)
        for lyr in self.enc:
            x = lyr(x, self_bias=enc_bias, generator=generator)
        return self.enc_norm(x)

    def encode_partial(self, src_ids: torch.Tensor, src_mask: torch.Tensor
                       ) -> torch.Tensor:
        """Chunked-prefill partial encode: the same computation as
        :meth:`encode` over a prefix-truncated source (PAD past the chunk
        cursor, mask to match). The rows are provisional — the engine runs
        the full-source :meth:`encode` at chunk completion, which keeps
        chunked prefill token-identical to the one-shot path. A method of
        its own so that the launch audit and traces count chunk work."""
        return self.encode(src_ids, src_mask)

    def decode(self, tgt_in_ids: torch.Tensor, enc: torch.Tensor,
               src_mask: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced full-sequence decoder → f32 logits [B, T, V]."""
        y = self.embed.embed_tgt(tgt_in_ids, generator)
        cross_bias = padding_bias(src_mask)
        for lyr in self.dec:
            y = lyr(y, enc=enc, cross_bias=cross_bias, causal=True,
                    generator=generator)
        return self.embed.logits(self.dec_norm(y))

    def _step(self, tgt_id, enc, src_mask, pos, cache, block_tables=None):
        y = self.embed.embed_tgt_at(tgt_id, pos)
        cross_bias = padding_bias(src_mask)
        for lyr, c in zip(self.dec, cache):
            y = lyr(y, enc=enc, cross_bias=cross_bias, cache=c, pos=pos,
                    block_tables=block_tables)
        return self.embed.logits(self.dec_norm(y))

    def decode_step_at(self, tgt_id: torch.Tensor, enc: torch.Tensor,
                       src_mask: torch.Tensor, pos: torch.Tensor,
                       cache: List[KvCache]) -> torch.Tensor:
        """Single-position decode with per-row positions ``pos`` [B]: row b's
        token ``tgt_id[b]`` sits at position ``pos[b]`` and its K/V land at
        that cache row's ``pos[b]`` slot. Returns logits [B, 1, V]."""
        return self._step(tgt_id, enc, src_mask, pos, cache)

    def decode_step(self, tgt_id: torch.Tensor, enc: torch.Tensor,
                    src_mask: torch.Tensor, pos: int,
                    cache: List[KvCache]) -> torch.Tensor:
        """:meth:`decode_step_at` with every row at position ``pos`` — the
        form the offline searchers drive."""
        pos_t = torch.full((tgt_id.shape[0],), int(pos), dtype=torch.long,
                           device=tgt_id.device)
        return self._step(tgt_id, enc, src_mask, pos_t, cache)

    def decode_step_paged(self, tgt_id: torch.Tensor, enc: torch.Tensor,
                          src_mask: torch.Tensor, pos: torch.Tensor,
                          block_tables: torch.Tensor,
                          cache: List[tuple]) -> torch.Tensor:
        """Paged-KV form of :meth:`decode_step_at` over per-layer block
        pools; ``block_tables`` [B, max_blocks] maps row b's position p to
        pool block ``block_tables[b, p // block_size]``."""
        return self._step(tgt_id, enc, src_mask, pos, cache, block_tables)

    def decode_span_at(self, tgt_ids: torch.Tensor, enc: torch.Tensor,
                       src_mask: torch.Tensor, pos: torch.Tensor,
                       cache: List[KvCache]) -> torch.Tensor:
        """Speculative verify: score S positions per row in one call.
        ``tgt_ids`` [B, S] are the tokens at positions ``pos[b]`` ..
        ``pos[b]+S-1``; logits [B, S, V] slice j is the distribution for
        position ``pos[b]+j+1``. Every decoder layer writes the S K/V
        vectors before attending, and the span bias keeps query j causal,
        so slice j equals what S sequential :meth:`decode_step_at` calls
        give. Positions past ``max_len`` are dropped from the cache and
        their logits are garbage; the engine never emits from them."""
        return self._step(tgt_ids, enc, src_mask, pos, cache)

    def decode_span_paged(self, tgt_ids: torch.Tensor, enc: torch.Tensor,
                          src_mask: torch.Tensor, pos: torch.Tensor,
                          block_tables: torch.Tensor,
                          cache: List[tuple]) -> torch.Tensor:
        """Paged-KV form of :meth:`decode_span_at` (positions past the
        table's span are written to the null block 0)."""
        return self._step(tgt_ids, enc, src_mask, pos, cache, block_tables)

    def greedy_step_at(self, tgt_id, enc, src_mask, pos, cache
                       ) -> torch.Tensor:
        """Fused greedy :meth:`decode_step_at`: next-token ids [B] (ties
        break to the lowest index)."""
        logits = self.decode_step_at(tgt_id, enc, src_mask, pos, cache)
        return torch.argmax(logits[:, 0, :], dim=-1)

    def greedy_step_paged(self, tgt_id, enc, src_mask, pos, block_tables,
                          cache) -> torch.Tensor:
        """Fused greedy :meth:`decode_step_paged`."""
        logits = self.decode_step_paged(tgt_id, enc, src_mask, pos,
                                        block_tables, cache)
        return torch.argmax(logits[:, 0, :], dim=-1)

    def forward(self, src_ids, src_mask, tgt_in_ids, train: bool = True,
                generator: Optional[torch.Generator] = None):
        """Teacher-forced logits [B, T, V] (f32). ``train`` applies dropout
        with masks from ``generator``, which a nonzero rate then requires
        (as Flax requires a 'dropout' rng); ``train=False`` is the
        deterministic forward."""
        if not train:
            generator = None
        elif generator is None and self.dropout_rate > 0:
            raise ValueError(
                f"train=True with dropout_rate={self.dropout_rate} needs a "
                f"torch.Generator for the dropout masks")
        enc = self.encode(src_ids, src_mask, generator)
        return self.decode(tgt_in_ids, enc, src_mask, generator)


def forward_flops(model: TransformerNMT, src_len: int, tgt_len: int) -> int:
    """Multiply-add FLOPs (2 per MAC) of one pair's teacher-forced forward,
    counted from the model's shapes: per encoder layer the four attention
    projections, QKᵀ and PV over every (query, key) pair, and the two MLP
    products; per decoder layer the self-attention's projections, QKᵀ and
    PV over the (query, key) pairs the causal mask keeps, the
    cross-attention's projections (K and V over the source) and its QKᵀ and
    PV, and the two MLP products; the tied logits. Embedding gathers,
    LayerNorm, softmax and the masked-out half of the decoder's QKᵀ and PV
    are left out."""
    h, m, s, t = model.hidden_size, model.mlp_dim, src_len, tgt_len
    enc = 2 * s * (4 * h * h + 2 * h * m) + 2 * 2 * s * s * h
    pairs = t * (t + 1) // 2
    dec = 2 * t * (4 * h * h + 2 * h * m) + 2 * 2 * pairs * h \
        + 2 * (2 * t * h * h + 2 * s * h * h) + 2 * 2 * t * s * h
    return model.num_layers * (enc + dec) + 2 * t * h * model.vocab_size


@register_model("transformer_nmt")
def transformer_nmt(num_classes: int = 0, dtype=torch.bfloat16, *,
                    vocab_size: int = 32000, hidden_size: int = 512,
                    num_layers: int = 6, num_heads: int = 8,
                    mlp_dim: int = 2048, max_len: int = 512,
                    dropout_rate: float = 0.0, attention_impl: str = "auto",
                    mesh=None, device: Optional[torch.device] = None):
    del num_classes  # vocab_size plays that role
    with torch.device(device or "cpu"):
        return TransformerNMT(
            vocab_size=vocab_size, hidden_size=hidden_size,
            num_layers=num_layers, num_heads=num_heads, mlp_dim=mlp_dim,
            max_len=max_len, dtype=dtype, dropout_rate=dropout_rate,
            attention_impl=attention_impl, mesh=mesh)


@register_model("transformer_nmt_tiny")
def transformer_nmt_tiny(num_classes: int = 0, dtype=torch.float32, **kw):
    """Test-scale config for CPU smoke/parity."""
    del num_classes
    device = kw.pop("device", None)
    defaults = dict(vocab_size=128, hidden_size=64, num_layers=2,
                    num_heads=4, mlp_dim=128, max_len=64)
    defaults.update(kw)
    with torch.device(device or "cpu"):
        return TransformerNMT(dtype=dtype, **defaults)


def init_weights(model: TransformerNMT, generator: torch.Generator) -> None:
    """Seeded init with Flax's distributions (``init_flax_defaults``): the
    token table and both position tables ``normal(0.02)``."""
    emb = model.embed
    init_flax_defaults(model, generator,
                       (emb.token.weight, emb.src_position,
                        emb.tgt_position))
