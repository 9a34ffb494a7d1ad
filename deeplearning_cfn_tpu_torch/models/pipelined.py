"""Pipeline-parallel BERT — the port of
``deeplearning_cfn_tpu/models/pipelined.py``.

``PipelinedBert`` has ``BertPretrain``'s contract (the MLM+NSP heads of
``bert.PretrainHeads``) with the encoder's L layers held as STACKED
parameters [L, ...] under ``pipe_stack`` (``PipeStack``): every trunk
kernel [L, in, out] as the JAX package holds it (``convert.py`` carries
them untransposed), the biases and LayerNorm scales [L, F]. The stack stays
2-D and up, so the optimizers' ``ndim > 1`` decay and trust-ratio mask
covers the stacked LayerNorm scales and biases exactly as the JAX mask does.

Each layer is ``_block``, the functional post-LN BERT block: the four
projections and two MLP products as ``t @ w + b`` in the compute dtype,
attention through ``ops.fused_attention`` with the padding bias (on the
card: the flash forward kernel, and under grad the reference-VJP
recompute), the tanh ``gelu``, and the block's own ``_layer_norm`` (f32
statistics, the biased two-pass variance, eps 1e-6; not ``LayerNorm``).

Given a ``mesh`` with a ``pipe`` axis above 1, ``PipeStack`` holds only its
stage's L/S layers (the rows ``parallel.sharding.PARAM_RULES`` give it) and
runs them under ``ops.pipeline.gpipe`` with the preset's
``n_microbatches``; ``num_layers`` must divide over the stages, as in JAX.
The embeddings and heads run replicated over ``pipe``. Without one (one
process, or a mesh whose ``pipe`` is 1) it runs the plain layer scan
(``ops.pipeline.scan_layers``), which is what the JAX module runs whenever
its mesh has no live ``pipe`` axis. Dropout is not supported (rate must be
0), as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import register_model
from ..ops import fused_attention
from ..ops.pipeline import gpipe, scan_layers
from ..parallel.sharding import piece_rows
from .bert import PretrainHeads, init_weights as _init_bert
from .transformer import Embed, padding_bias

_EPS = 1e-6


def _layer_norm(x: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + _EPS)
    return (y * scale + bias).to(x.dtype)


def _block(num_heads: int, attention_impl: str, params: Dict[str, torch.Tensor],
           state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One post-LN BERT block over ``state["h"]`` [B, S, F] with the
    pass-through ``state["bias"]``; ``params`` are one layer's slices."""
    h, bias = state["h"], state["bias"]
    dt = h.dtype
    b, s, f = h.shape
    d = f // num_heads

    def dense(t, w, bb):
        return torch.matmul(t, w.to(dt)) + bb.to(dt)

    def split(t):  # [B, S, F] -> [B, H, S, D]
        return t.view(b, s, num_heads, d).transpose(1, 2)

    q = split(dense(h, params["wq"], params["bq"]))
    k = split(dense(h, params["wk"], params["bk"]))
    v = split(dense(h, params["wv"], params["bv"]))
    attn = fused_attention(q, k, v, bias=bias, implementation=attention_impl)
    attn = attn.transpose(1, 2).reshape(b, s, f)
    attn = dense(attn, params["wo"], params["bo"])
    h = _layer_norm(h + attn, params["ln1_s"], params["ln1_b"])
    y = F.gelu(dense(h, params["w_in"], params["b_in"]), approximate="tanh")
    y = dense(y, params["w_out"], params["b_out"])
    h = _layer_norm(h + y, params["ln2_s"], params["ln2_b"])
    return {"h": h, "bias": bias}


# (name, shape after [L], init): "kernel" xavier-uniform over its last two
# dims, "zeros", "ones".
def _stack_shapes(f: int, m: int):
    return (("wq", (f, f), "kernel"), ("bq", (f,), "zeros"),
            ("wk", (f, f), "kernel"), ("bk", (f,), "zeros"),
            ("wv", (f, f), "kernel"), ("bv", (f,), "zeros"),
            ("wo", (f, f), "kernel"), ("bo", (f,), "zeros"),
            ("ln1_s", (f,), "ones"), ("ln1_b", (f,), "zeros"),
            ("w_in", (f, m), "kernel"), ("b_in", (m,), "zeros"),
            ("w_out", (m, f), "kernel"), ("b_out", (f,), "zeros"),
            ("ln2_s", (f,), "ones"), ("ln2_b", (f,), "zeros"))


class PipeStack(nn.Module):
    """Owns the stacked trunk parameters (this stage's rows of them under a
    ``pipe`` axis) and runs them as one stage, or as its stage of
    ``gpipe``."""

    def __init__(self, num_layers: int, features: int, num_heads: int,
                 mlp_dim: int, dtype: torch.dtype = torch.bfloat16,
                 attention_impl: str = "auto", mesh=None,
                 n_microbatches: int = 4):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.attention_impl = attention_impl
        self.num_layers, self.n_microbatches = num_layers, n_microbatches
        self.mesh = mesh if mesh is not None and mesh.pipe_ways > 1 else None
        if self.mesh is not None and num_layers % self.mesh.pipe_ways:
            raise ValueError(
                f"num_layers={num_layers} not divisible by pipe axis "
                f"{self.mesh.pipe_ways}")
        rows = piece_rows(self.mesh, "pipe", num_layers)
        self.inits = {}
        for name, shape, init in _stack_shapes(features, mlp_dim):
            self.register_parameter(name, nn.Parameter(
                torch.empty((rows.stop - rows.start,) + shape)))
            self.inits[name] = init
        self._stage = scan_layers(
            lambda lp, st: _block(self.num_heads, self.attention_impl, lp,
                                  st))

    def forward(self, h: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        params = {name: getattr(self, name) for name in self.inits}
        state = {"h": h.to(self.dtype), "bias": bias}
        if self.mesh is None:
            return self._stage(params, state)["h"]
        return gpipe(self._stage, params, state, mesh=self.mesh,
                     n_microbatches=self.n_microbatches)["h"]


class PipelinedBert(PretrainHeads):
    """``BertPretrain``'s contract with the stacked trunk."""

    def __init__(self, vocab_size: int, num_classes: int = 2,
                 hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, mlp_dim: int = 3072,
                 max_len: int = 512, dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.0, attention_impl: str = "auto",
                 mesh=None, n_microbatches: int = 4):
        super().__init__()
        if dropout_rate:
            raise ValueError("pipelined trunk does not support dropout; "
                             "set dropout_rate=0")
        self.dtype = dtype
        self.dropout_rate = 0.0
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.mlp_dim = mlp_dim
        self.embed = Embed(vocab_size, hidden_size, max_len, num_segments=2,
                           dtype=dtype)
        self.pipe_stack = PipeStack(num_layers, hidden_size, num_heads,
                                    mlp_dim, dtype, attention_impl, mesh,
                                    n_microbatches)
        self._init_heads(vocab_size, hidden_size, num_classes, dtype)

    def forward(self, input_ids, input_mask, segment_ids, mlm_positions,
                train: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """``{"mlm_logits": [B, P, V], "nsp_logits": [B, classes]}``, both
        f32; no dropout, so ``train`` and ``generator`` change nothing."""
        del train, generator
        x, token_table = self.embed(input_ids, segment_ids)
        x = self.pipe_stack(x, padding_bias(input_mask))
        return self._heads(x, token_table, mlm_positions)


@register_model("bert_pipelined")
def bert_pipelined(num_classes: int = 2, dtype=torch.bfloat16, *,
                   vocab_size: int = 30522, hidden_size: int = 768,
                   num_layers: int = 12, num_heads: int = 12,
                   mlp_dim: int = 3072, max_len: int = 512,
                   dropout_rate: float = 0.0, attention_impl: str = "auto",
                   mesh=None, n_microbatches: int = 4, batch_spec="data",
                   device: Optional[torch.device] = None):
    del batch_spec  # JAX's; each process feeds its own rows
    with torch.device(device or "cpu"):
        return PipelinedBert(vocab_size=vocab_size, num_classes=num_classes,
                             hidden_size=hidden_size, num_layers=num_layers,
                             num_heads=num_heads, mlp_dim=mlp_dim,
                             max_len=max_len, dtype=dtype,
                             dropout_rate=dropout_rate,
                             attention_impl=attention_impl, mesh=mesh,
                             n_microbatches=n_microbatches)


def init_weights(model: PipelinedBert, generator: torch.Generator) -> None:
    """Seeded init with Flax's distributions: the embeddings and heads as
    ``bert.init_weights``; every stacked kernel [L, in, out]
    ``variance_scaling(1, "fan_avg", "uniform")`` over its last two dims
    (limit √(6 / (in + out))), the stacked biases 0 and LayerNorm scales 1.
    Runs on the model's device with ``generator``. A stage draws every
    layer's kernels and keeps its own, so each stage's layers are the
    one-process model's."""
    _init_bert(model, generator)
    stack = model.pipe_stack
    rows = piece_rows(stack.mesh, "pipe", stack.num_layers)
    with torch.no_grad():
        for name, init in stack.inits.items():
            p = getattr(stack, name)
            if init == "kernel":
                fan_in, fan_out = p.shape[-2:]
                limit = math.sqrt(6.0 / (fan_in + fan_out))
                whole = torch.empty((stack.num_layers,) + p.shape[1:],
                                    dtype=p.dtype, device=p.device)
                whole.uniform_(-limit, limit, generator=generator)
                p.copy_(whole[rows])
            else:
                p.fill_(1.0 if init == "ones" else 0.0)


def forward_flops(model: PipelinedBert, seq_len: int,
                  num_predictions: int) -> int:
    """Multiply-add FLOPs (2 per MAC) of one sequence's forward, counted as
    ``bert.forward_flops`` counts BERT-base's (the same products)."""
    h, s, p = model.hidden_size, seq_len, num_predictions
    per_layer = 2 * s * (4 * h * h + 2 * h * model.mlp_dim) \
        + 2 * 2 * s * s * h
    heads = 2 * p * (h * h + h * model.vocab_size) \
        + 2 * (h * h + h * model.nsp_head.weight.shape[0])
    return model.num_layers * per_layer + heads
