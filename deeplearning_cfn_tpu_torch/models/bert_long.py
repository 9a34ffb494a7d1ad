"""Long-context BERT with sequence-parallel attention over the mesh's ``seq``
axis — the port of ``deeplearning_cfn_tpu/models/bert_long.py``.

The same MLM+NSP contract as ``models/bert.py``'s ``BertPretrain`` (a
drop-in for ``MlmTask`` under the model name ``bert_long``), with every
self-attention a :class:`SeqParallelAttention`:

- with ``seq`` = 1 (one process, or a mesh without a ``seq`` axis) it is
  ``ops.fused_attention`` with no bias — on the card the three flash
  kernels;
- with ``seq`` > 1 each process runs its ``seq_index``-th slice of every
  row, and the attention is ``seq_impl``'s: ``"ring"``
  (``ops/ring_attention.py``: K/V rotate around the ``seq`` group, no
  head-count constraint) or ``"ulysses"`` (``ops/ulysses.py``: two
  all-to-alls around the flash kernels; needs the heads divisible by the
  ``seq`` ways). Another name raises ``KeyError``, as in JAX;
- with ``model`` > 1 each process holds ``num_heads / model`` heads
  (``models/transformer.py``'s tensor-parallel layers) and the ring or
  Ulysses runs on those; Ulysses then needs the heads divisible by
  ``model × seq``, and a model that does not divide them is refused when
  it is built, with the numbers.

Packed-sequence contract: no padding bias (``input_mask`` is ignored; the
synthetic MLM source emits full-length sequences), so a slice of a row
needs nothing from the other slices outside the attention. ``mlm_weights``
still mask the loss.

Where JAX constrains the activations to ``P(batch, "seq", None)`` between
layers (``constrain_seq_sharding``), each process here holds whole rows of
tokens ``[B_local, S]`` and embeds only its own positions
(:func:`seq_positions`, the position table read at the slice's offset);
the layers run on ``[B_local, S/n, hidden]``. The heads read
``mlm_positions`` anywhere in a row and token 0 for NSP, so the final
activations are gathered over the ``seq`` group first
(``parallel.collectives.gather_seq``: its backward sums the group's
gradients and keeps this process's slice), and every process of the group
runs the heads on the whole rows, as JAX runs them on the global array.

Module names follow the Flax tree: ``embed``, ``layer_{i}_self_attn``,
``layer_{i}_self_attn_norm``, ``layer_{i}_mlp``, ``layer_{i}_mlp_norm`` are
attributes at the root (not a list), and the heads are
:class:`~.bert.PretrainHeads`' (``mlm_transform``, ``mlm_norm``,
``mlm_bias``, ``pooler``, ``nsp_head``), so ``convert.flax_layout`` gives
JAX's names.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import register_model
from .bert import PretrainHeads
from .bert import init_weights as _bert_init_weights
from .transformer import Embed, LayerNorm, Mlp, MultiHeadAttention
from ..ops import fused_attention
from ..ops.ring_attention import ring_attention_sharded
from ..ops.ulysses import ulysses_attention_sharded
from ..parallel.collectives import gather_seq
from ..parallel.sharding import seq_slice


class SeqParallelAttention(MultiHeadAttention):
    """``MultiHeadAttention`` with its attention swapped for a
    sequence-parallel strategy over ``mesh``'s ``seq`` group; projections
    and names are inherited."""

    def __init__(self, features: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16,
                 attention_impl: str = "auto", dropout_rate: float = 0.0,
                 seq_impl: str = "ring", mesh=None):
        super().__init__(features, num_heads, dtype, attention_impl,
                         dropout_rate, mesh)
        self.seq_impl = seq_impl
        self.mesh = mesh
        if seq_impl == "ulysses" and mesh is not None and \
                mesh.model_ways > 1 and \
                num_heads % (mesh.model_ways * mesh.seq_ways):
            raise ValueError(
                f"ulysses attention needs num_heads ({num_heads}) divisible "
                f"by model x seq ({mesh.model_ways} x {mesh.seq_ways} = "
                f"{mesh.model_ways * mesh.seq_ways}): each process holds "
                f"{num_heads} / {mesh.model_ways} heads and swaps them over "
                f"{mesh.seq_ways} sequence slices; use ring attention for "
                f"head counts that don't divide")

    def _attend(self, q, k, v, bias, causal):
        # Packed-sequence contract: no padding bias (it would have to travel
        # with the K/V slices). Causal is supported: the ring masks by
        # global position, Ulysses holds each head group's whole sequence.
        assert bias is None, \
            "sequence-parallel attention is the packed (no-bias) contract"
        if self.mesh is not None and self.mesh.seq_ways > 1:
            fn = {"ring": ring_attention_sharded,
                  "ulysses": ulysses_attention_sharded}[self.seq_impl]
            return fn(q, k, v, self.mesh, causal=causal)
        return fused_attention(q, k, v, causal=causal,
                               implementation=self.attention_impl)


def seq_positions(mesh, seq_len: int) -> slice:
    """This process's positions of a row of ``seq_len``: its slice over the
    ``seq`` axis, or the whole row without one. The counterpart of JAX's
    ``constrain_seq_sharding``, shared by every sequence-parallel trunk
    (:class:`LongBert`, ``lm.LongCausalLm``)."""
    if mesh is None or mesh.seq_ways == 1:
        return slice(0, seq_len)
    return seq_slice(mesh, seq_len)


def add_seq_layers(module: torch.nn.Module, num_layers: int,
                   hidden_size: int, num_heads: int, mlp_dim: int,
                   dtype: torch.dtype, dropout_rate: float, seq_impl: str,
                   mesh, attention_impl: str) -> None:
    """Give ``module`` the root attributes ``layer_{i}_self_attn``,
    ``layer_{i}_self_attn_norm``, ``layer_{i}_mlp`` and
    ``layer_{i}_mlp_norm`` of a sequence-parallel trunk (JAX's flat
    names)."""
    for i in range(num_layers):
        setattr(module, f"layer_{i}_self_attn", SeqParallelAttention(
            hidden_size, num_heads, dtype, attention_impl, dropout_rate,
            seq_impl, mesh))
        setattr(module, f"layer_{i}_self_attn_norm",
                LayerNorm(hidden_size, dtype))
        setattr(module, f"layer_{i}_mlp",
                Mlp(hidden_size, mlp_dim, dtype, dropout_rate, mesh))
        setattr(module, f"layer_{i}_mlp_norm", LayerNorm(hidden_size, dtype))


def seq_layer(module: torch.nn.Module, i: int):
    """Layer ``i``'s (attention, its norm, MLP, its norm)."""
    return tuple(getattr(module, f"layer_{i}_{part}") for part in
                 ("self_attn", "self_attn_norm", "mlp", "mlp_norm"))


class LongBert(PretrainHeads):
    """``BertPretrain``'s contract with sequence-parallel attention."""

    def __init__(self, vocab_size: int, num_classes: int = 2,
                 hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, mlp_dim: int = 3072,
                 max_len: int = 4096, dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.0, seq_impl: str = "ring",
                 mesh=None, attention_impl: str = "auto"):
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.mlp_dim = mlp_dim
        self.mesh = mesh
        self.embed = Embed(vocab_size, hidden_size, max_len, num_segments=2,
                           dtype=dtype, dropout_rate=dropout_rate)
        add_seq_layers(self, num_layers, hidden_size, num_heads, mlp_dim,
                       dtype, dropout_rate, seq_impl, mesh, attention_impl)
        self._init_heads(vocab_size, hidden_size, num_classes, dtype)

    def forward(self, input_ids, input_mask, segment_ids, mlm_positions,
                train: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """``{"mlm_logits": [B, P, V], "nsp_logits": [B, classes]}``, f32,
        of whole rows ``[B, S]`` (every process of a ``seq`` group gets the
        same). ``train`` applies dropout with masks from ``generator``,
        which a nonzero rate then requires."""
        del input_mask  # packed-sequence contract: no padding bias
        if not train:
            generator = None
        elif generator is None and self.dropout_rate > 0:
            raise ValueError(
                f"train=True with dropout_rate={self.dropout_rate} needs a "
                f"torch.Generator for the dropout masks")
        mine = seq_positions(self.mesh, input_ids.shape[1])
        x, token_table = self.embed(input_ids[:, mine],
                                    segment_ids[:, mine], generator,
                                    offset=mine.start)
        for i in range(self.num_layers):
            attn, attn_norm, mlp, mlp_norm = seq_layer(self, i)
            # Post-LN, as transformer.TransformerLayer's BERT layout.
            x = attn_norm(x + attn(x, generator=generator))
            x = mlp_norm(x + mlp(x, generator))
        if self.mesh is not None:
            x = gather_seq(x, self.mesh)
        return self._heads(x, token_table, mlm_positions)


@register_model("bert_long")
def bert_long(num_classes: int = 2, dtype=torch.bfloat16, *,
              vocab_size: int = 30522, hidden_size: int = 768,
              num_layers: int = 12, num_heads: int = 12,
              mlp_dim: int = 3072, max_len: int = 4096,
              dropout_rate: float = 0.0, seq_impl: str = "ring",
              mesh=None, attention_impl: str = "auto",
              device: Optional[torch.device] = None):
    with torch.device(device or "cpu"):
        return LongBert(vocab_size=vocab_size, num_classes=num_classes,
                        hidden_size=hidden_size, num_layers=num_layers,
                        num_heads=num_heads, mlp_dim=mlp_dim,
                        max_len=max_len, dtype=dtype,
                        dropout_rate=dropout_rate, seq_impl=seq_impl,
                        mesh=mesh, attention_impl=attention_impl)


def init_weights(model: LongBert, generator: torch.Generator) -> None:
    """``models/bert.py``'s seeded init (Flax's distributions)."""
    _bert_init_weights(model, generator)


def forward_flops(model: LongBert, seq_len: int,
                  num_predictions: int) -> int:
    """Multiply-add FLOPs (2 per MAC) of one whole row's forward, counted
    from the shapes, as ``bert.forward_flops``: per layer the four
    attention projections, QKᵀ and PV over every (query, key) pair, and the
    two MLP products; the MLM transform and the tied decoder at
    ``num_predictions`` positions; the pooler and the NSP head."""
    h, s, p = model.hidden_size, seq_len, num_predictions
    per_layer = 2 * s * (4 * h * h + 2 * h * model.mlp_dim) \
        + 2 * 2 * s * s * h
    heads = 2 * p * (h * h + h * model.vocab_size) \
        + 2 * (h * h + h * model.nsp_head.weight.shape[0])
    return model.num_layers * per_layer + heads
