"""Fused multi-head attention: hand-written CUDA flash kernels + torch reference.

The port of ``deeplearning_cfn_tpu/ops/attention.py``:

- ``attention_reference``: plain torch softmax(QKᵀ·scale + bias)V, computed in
  f32 whatever the input dtype, with the same ``-1e30`` mask, ends-aligned
  causal masking, and softmax weights cast to ``v.dtype`` before the PV
  product. It is the numerics oracle and the CPU path.
- ``flash_attention_forward``: the wrapper of ``csrc/flash_attn_fwd.cu``,
  the CUDA port of the Pallas ``_flash_kernel``. For a CUDA tensor it
  launches the kernel or raises; for a CPU tensor it computes the plain
  version (the only reason it ever does). ``flash_attention_forward.launches``
  counts kernel launches, and ``.variant_launches`` splits them by variant
  (``forward_variant``).
- ``flash_attn_bwd_dkdv`` / ``flash_attn_bwd_dq``: the wrappers of
  ``csrc/flash_attn_bwd_dkdv.cu`` and ``csrc/flash_attn_bwd_dq.cu``, the CUDA
  ports of ``_flash_bwd_dkdv_kernel`` and ``_flash_bwd_dq_kernel``, with their
  plain versions ``flash_bwd_dkdv_reference`` / ``flash_bwd_dq_reference``
  beside them and a ``launches`` counter each, split by variant in
  ``.variant_launches`` (``backward_variant``).
- ``forward_variant`` / ``backward_variant``: the one rule that picks each
  kernel's variant (``backward_variant`` for both backward kernels) —
  ``tc`` (bf16 on tensor cores: wgmma fed by TMA), ``decode`` (bf16 with
  fewer than 16 query rows: split-K over the block's warps) or ``simt``
  (the CUDA-core kernels; f32 always, because they are exact there). The
  wrapper passes the choice to the C entry point, which launches that
  variant or returns an error.
- ``FlashAttention``: the ``torch.autograd.Function`` that mirrors the JAX
  custom VJP (``_fwd``/``_bwd``): without a bias the forward keeps O and the
  per-row lse and the backward runs the two backward kernels; with a bias the
  backward recomputes the reference VJP (``attention_reference_vjp``, whose
  ``calls`` counter audits how often), returning the bias's gradient too.
- ``fused_attention``: the public entry, with the JAX contract
  (``[B,H,S,D]`` inputs, causal ``Sq <= Sk``, bias broadcastable to
  ``[B,H,Sq,Sk]``). Under grad it goes through ``FlashAttention``.

Deliberate differences from the JAX package:

- ``implementation="auto"`` means the kernels for CUDA tensors and the plain
  versions for CPU tensors. The v5e short-sequence crossover
  (``_auto_use_pallas``) is not carried over: on a TPU it sent every call
  with ``Sk < 1024`` — this whole NMT model — to XLA.
- The single-position decode attentions of ``models/transformer.py``, which
  JAX pins to ``implementation="reference"``, go through the kernel here as
  well. Both compute the same function, so on the card every attention call
  of the serving path is a kernel launch and the plain version serves only
  as the comparison.
- Causal masking in the forward kernel removes the keys above the diagonal
  rather than setting them to ``-1e30`` (whole tiles of them are skipped).
  The two agree except for a causal row whose every visible key a bias also
  masks: the kernel spreads that row's uniform weight over the visible
  keys, the plain version over all keys. No serving or training call is
  causal with a bias.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import kernels

_NEG_INF = -1e30  # large-negative instead of -inf: keeps masked softmax NaN-free

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The variant argument of the C entry points.
_VARIANT_CODES = {"simt": 0, "tc": 1, "decode": 2}
_TC_HEAD_DIMS = (64, 128)


def forward_variant(dtype: torch.dtype, sq: int, d: int) -> str:
    """The variant of ``csrc/flash_attn_fwd.cu`` to launch for this dtype,
    query length and head dim: ``decode`` for bf16 with ``sq < 16`` (a wgmma
    needs 64 rows), ``tc`` for bf16 with ``d`` in (64, 128), else ``simt``."""
    if dtype != torch.bfloat16:
        return "simt"
    if sq < 16:
        return "decode"
    return "tc" if d in _TC_HEAD_DIMS else "simt"


def backward_variant(dtype: torch.dtype, d: int) -> str:
    """The variant of both backward kernels (``csrc/flash_attn_bwd_dkdv.cu``
    and ``csrc/flash_attn_bwd_dq.cu``) to launch: ``tc`` for bf16 with ``d``
    in (64, 128), else ``simt``."""
    return "tc" if dtype == torch.bfloat16 and d in _TC_HEAD_DIMS else "simt"


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        causal: bool = False,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain torch attention; computes in f32 regardless of input dtype (the
    softmax accumulator precision the kernel also uses)."""
    sq, d = q.shape[-2], q.shape[-1]
    sk = k.shape[-2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        logits = torch.where(_causal_live(sq, sk, q.device), logits,
                             torch.full_like(logits, _NEG_INF))
    weights = torch.softmax(logits, dim=-1)
    return torch.matmul(weights.to(v.dtype).float(), v.float()).to(q.dtype)


def _causal_live(sq: int, sk: int, device) -> torch.Tensor:
    """[Sq, Sk] True where key j is visible to query i (ends aligned)."""
    q_pos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    k_pos = torch.arange(sk, device=device)[None, :]
    return k_pos <= q_pos


def _check_shapes(q, k, v, causal):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected [B,H,S,D] inputs, got {tuple(q.shape)}")
    if causal and q.shape[-2] > k.shape[-2]:
        # Ill-defined: ends are aligned, so the leading queries would precede
        # every key.
        raise ValueError(
            f"causal attention requires Sq <= Sk, got {q.shape[-2]} > "
            f"{k.shape[-2]}")


def _kernel_bias(bias: Optional[torch.Tensor], b: int, h: int, sq: int,
                 sk: int) -> Optional[torch.Tensor]:
    """The bias as an f32 [B,H,Sq,Sk] view with stride 0 on broadcast dims
    (never materialised), or None when there is none to apply."""
    if bias is None:
        return None
    if bias.shape[-1] == 1:
        # Constant across the softmax axis: shifts every logit of a row
        # equally, so it contributes nothing (attention.py:218-225).
        return None
    if bias.shape[-1] != sk:
        raise ValueError(
            f"bias K dim {bias.shape[-1]} incompatible with kv length {sk}")
    try:
        return bias.to(torch.float32).expand(b, h, sq, sk)
    except RuntimeError as e:
        raise ValueError(
            f"bias of shape {tuple(bias.shape)} does not broadcast to "
            f"{(b, h, sq, sk)}") from e


def _check_kernel_inputs(q, k, v, **others):
    """What every kernel of this module refuses: dtypes other than f32/bf16
    or differing, mismatched shapes, head dims outside 16..128 in steps of
    16, tensors on different devices, and a non-unit head-dim stride."""
    b, h, _, d = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernels take float32 or bfloat16, got "
                        f"{q.dtype}")
    same = {"k": k, "v": v, **others}
    for name, t in same.items():
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if k.shape[:2] != (b, h) or v.shape != k.shape or k.shape[-1] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if d < 16 or d > 128 or d % 16:
        raise ValueError(f"head dim {d} not supported (16..128, multiple "
                         f"of 16)")
    for name, t in (("q", q), *same.items()):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride on the head dim")


def _bind(name: str, argtypes):
    """The C entry point of kernel ``name`` with its argument types set.
    Every launcher here takes its pointers first, then the int shape, then
    long long strides, then (float scale, int causal, int dtype, int
    variant, void* stream), and returns a cudaError_t."""
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(kernels.load(name), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


_bound = {}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_TAIL = [ctypes.c_float, _I, _I, _I, _P]  # scale, causal, dtype, variant, stream


def _strides3(t):
    """Batch, head and sequence strides in elements. A dim of size 1 is never
    stepped, so its stride is set to span the dims inside it: views such as
    ``x.t()`` of a row vector can carry any stride there, and the TMA maps of
    the tensor-core variants need 16-byte multiples."""
    b, h, s, d = t.shape  # the head dim has unit stride
    sb, sh, ss, _ = t.stride()
    if s == 1:
        ss = d
    if h == 1:
        sh = ss * s
    if b == 1:
        sb = sh * h
    return sb, sh, ss


def _check_aligned(variant, **tensors):
    """The bf16 variants read rows with TMA or 16-byte vector loads: every
    row must start on a 16-byte boundary. Each value is a tensor and its
    :func:`_strides3`."""
    for name, (t, strides) in tensors.items():
        if t.data_ptr() % 16 or any(s % 8 for s in strides):
            raise ValueError(
                f"{name}: the bf16 {variant} kernel needs 16-byte aligned "
                f"rows (data pointer and batch/head/sequence strides), got "
                f"strides {tuple(t.stride())}")


def _launched(name, err, variant, counter):
    """Raise on a C entry point's failed launch, else count it on
    ``counter`` under ``variant``."""
    if err != 0:
        raise RuntimeError(f"{name} ({variant}) launch failed: cudaError_t "
                           f"{err}")
    counter.launches += 1
    counter.variant_launches[variant] += 1


def _launch(q, k, v, bias, causal, scale, return_lse, variant=None):
    """Kernel #1 on the card as ``variant`` (default: ``forward_variant``'s
    choice; chip_smoke.py also times ``simt``, the first port's kernel, at
    the bf16 shapes)."""
    b, h, sq, d = q.shape
    sk = k.shape[-2]
    _check_kernel_inputs(q, k, v)
    kb = _kernel_bias(bias, b, h, sq, sk)
    if kb is not None and kb.device != q.device:
        raise ValueError(f"bias is on {kb.device}, q on {q.device}")
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    variant = variant or forward_variant(q.dtype, sq, d)
    qs, ks, vs = _strides3(q), _strides3(k), _strides3(v)
    if variant != "simt":
        _check_aligned(variant, q=(q, qs), k=(k, ks), v=(v, vs))
    fn = _bind("flash_attn_fwd",
               [_P] * 6 + [_I] * 5 + [_L] * 13 + _TAIL)
    bstr = kb.stride() if kb is not None else (0, 0, 0, 0)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             kb.data_ptr() if kb is not None else None, out.data_ptr(),
             lse.data_ptr() if lse is not None else None,
             b, h, sq, sk, d, *qs, *ks, *vs, *bstr, float(scale),
             int(bool(causal)), _DTYPE_CODES[q.dtype], _VARIANT_CODES[variant],
             stream)
    _launched("flash_attn_fwd", err, variant, flash_attention_forward)
    return out, lse


def _reference_lse(q, k, bias, causal, scale):
    """Per-row logsumexp of the kernel's logits (the plain version of the
    kernel's optional ``lse`` output)."""
    sq, sk = q.shape[-2], k.shape[-2]
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if bias is not None and bias.shape[-1] != 1:
        s = s + bias.float()
    if causal:
        s = torch.where(_causal_live(sq, sk, q.device), s,
                        torch.full_like(s, _NEG_INF))
    return torch.logsumexp(s, dim=-1)


def _forward(q, k, v, bias, causal, scale, return_lse):
    """Kernel #1 on the card, its plain version on the CPU; no autograd."""
    if q.device.type == "cpu":
        out = attention_reference(q, k, v, bias, causal, scale)
        lse = _reference_lse(q, k, bias, causal, scale) if return_lse \
            else None
        return out, lse
    return _launch(q, k, v, bias, causal, scale, return_lse)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            bias: Optional[torch.Tensor] = None,
                            causal: bool = False,
                            sm_scale: Optional[float] = None,
                            return_lse: bool = False):
    """The flash kernel's wrapper: launches ``csrc/flash_attn_fwd.cu`` for
    CUDA tensors (raising on anything it does not take), the plain version
    for CPU tensors. Under grad the call goes through :class:`FlashAttention`
    so that the output carries its backward. Returns ``out`` or
    ``(out, lse)``."""
    _check_shapes(q, k, v, causal)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if _wants_grad(q, k, v, bias):
        out, lse = FlashAttention.apply(q, k, v, bias, causal, scale)
    else:
        out, lse = _forward(q, k, v, bias, causal, scale, return_lse)
    return (out, lse) if return_lse else out


flash_attention_forward.launches = 0
flash_attention_forward.variant_launches = {"tc": 0, "decode": 0, "simt": 0}


# ---------------------------------------------------------------------------
# Backward kernels (#2, #3) and their plain versions
# ---------------------------------------------------------------------------


def _bwd_probs(q, k, lse, causal, scale):
    """P = exp(scale·QKᵀ − lse) in f32 with the forward's masking
    (``_bwd_mask``: masked logits at -1e30, so they underflow to 0)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = torch.where(_causal_live(q.shape[-2], k.shape[-2], q.device), s,
                        torch.full_like(s, _NEG_INF))
    return torch.exp(s - lse[..., None])


def _bwd_ds(q, k, v, do, lse, delta, causal, scale):
    p = _bwd_probs(q, k, lse, causal, scale)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None])


def flash_bwd_dkdv_reference(q, k, v, do, lse, delta, causal, scale):
    """Plain version of kernel #2: ``(dK, dV)`` in k's / v's dtype."""
    p, ds = _bwd_ds(q, k, v, do, lse, delta, causal, scale)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    dk = scale * torch.matmul(ds.transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, scale):
    """Plain version of kernel #3: ``dQ`` in q's dtype."""
    _, ds = _bwd_ds(q, k, v, do, lse, delta, causal, scale)
    return (scale * torch.matmul(ds, k.float())).to(q.dtype)


def _launch_bwd(name, q, k, v, do, lse, delta, causal, scale, outs,
                variant, counter):
    """Check what a backward kernel refuses, then launch it (as ``variant``)
    to fill ``outs`` and count the launch on ``counter``."""
    _check_kernel_inputs(q, k, v, dO=do)
    if do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} does not match q "
                         f"{tuple(q.shape)}")
    want = tuple(q.shape[:3])
    for stat, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != want:
            raise ValueError(f"{stat} must be float32 {want}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{stat} is on {t.device}, q on {q.device}")
    strides = [_strides3(t) for t in (q, k, v, do)]
    if variant != "simt":
        _check_aligned(variant, **{n: (t, st) for n, t, st in zip(
            ("q", "k", "v", "dO"), (q, k, v, do), strides)})
    lse, delta = lse.contiguous(), delta.contiguous()
    b, h, sq, d = q.shape
    sk = k.shape[-2]
    fn = _bind(name, [_P] * (6 + len(outs)) + [_I] * 5 + [_L] * 12 + _TAIL)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
             b, h, sq, sk, d, *(x for st in strides for x in st),
             float(scale), int(bool(causal)), _DTYPE_CODES[q.dtype],
             _VARIANT_CODES[variant], stream)
    _launched(name, err, variant, counter)


def flash_attn_bwd_dkdv(q, k, v, do, lse, delta, causal: bool, scale: float):
    """Kernel #2's wrapper → ``(dK, dV)``: launches
    ``csrc/flash_attn_bwd_dkdv.cu`` for CUDA tensors (raising on anything it
    does not take), the plain version for CPU tensors. ``lse``/``delta`` are
    f32 ``[B,H,Sq]``; q/k/v/dO share one dtype and have a unit head-dim
    stride."""
    _check_shapes(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_bwd_dkdv_reference(q, k, v, do, lse, delta, causal,
                                        scale)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd("flash_attn_bwd_dkdv", q, k, v, do, lse, delta, causal,
                scale, (dk, dv), backward_variant(q.dtype, q.shape[-1]),
                flash_attn_bwd_dkdv)
    return dk, dv


flash_attn_bwd_dkdv.launches = 0
flash_attn_bwd_dkdv.variant_launches = {"tc": 0, "simt": 0}


def flash_attn_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float):
    """Kernel #3's wrapper → ``dQ``: launches ``csrc/flash_attn_bwd_dq.cu``
    for CUDA tensors (raising on anything it does not take), the plain
    version for CPU tensors. Same arguments as :func:`flash_attn_bwd_dkdv`."""
    _check_shapes(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("flash_attn_bwd_dq", q, k, v, do, lse, delta, causal, scale,
                (dq,), backward_variant(q.dtype, q.shape[-1]),
                flash_attn_bwd_dq)
    return dq


flash_attn_bwd_dq.launches = 0
flash_attn_bwd_dq.variant_launches = {"tc": 0, "simt": 0}


def flash_attention_backward(q, k, v, out, lse, g, causal, scale):
    """``(dq, dk, dv)`` of the bias-free flash path (``_flash_backward``):
    ``delta = rowsum(dO·O)`` as a plain op on the stored (possibly bf16) O,
    dO cast to q's dtype, then kernels #2 and #3."""
    delta = (g.float() * out.float()).sum(-1)
    do = g.to(q.dtype)
    if do.stride(-1) != 1:
        do = do.contiguous()
    dk, dv = flash_attn_bwd_dkdv(q, k, v, do, lse, delta, causal, scale)
    dq = flash_attn_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


def attention_reference_vjp(q, k, v, bias, g, causal, scale, wanted):
    """The biased path's backward (``_bwd`` at attention.py:557-565):
    recompute :func:`attention_reference` under grad and pull ``g`` back.
    ``wanted`` flags which of (q, k, v, bias) need a gradient; the others
    come back as None. ``attention_reference_vjp.calls`` counts recomputes."""
    attention_reference_vjp.calls += 1
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(w)
                  for t, w in zip((q, k, v, bias), wanted)]
        out = attention_reference(*leaves, causal=causal, sm_scale=scale)
        want = [t for t, w in zip(leaves, wanted) if t is not None and w]
        grads = iter(torch.autograd.grad(out, want, g))
    return tuple(next(grads) if t is not None and w else None
                 for t, w in zip(leaves, wanted))


attention_reference_vjp.calls = 0


class FlashAttention(torch.autograd.Function):
    """The JAX custom VJP of ``_fused_attention`` in PyTorch: returns
    ``(out, lse)`` with ``lse`` non-differentiable. Forward: kernel #1 (with
    lse). Backward without a bias: kernels #2 and #3; with a bias: the
    reference VJP, including the bias's gradient when it requires one."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale):
        out, lse = _forward(q, k, v, bias, causal, scale, True)
        ctx.causal, ctx.scale = causal, scale
        ctx.has_bias = bias is not None
        if ctx.has_bias:
            ctx.save_for_backward(q, k, v, bias)
        else:
            ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        if not ctx.has_bias:
            q, k, v, out, lse = ctx.saved_tensors
            dq, dk, dv = flash_attention_backward(q, k, v, out, lse, g,
                                                  ctx.causal, ctx.scale)
            return dq, dk, dv, None, None, None
        q, k, v, bias = ctx.saved_tensors
        grads = attention_reference_vjp(q, k, v, bias, g, ctx.causal,
                                        ctx.scale, ctx.needs_input_grad[:4])
        return (*grads, None, None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    implementation: str = "auto") -> torch.Tensor:
    """Multi-head attention. ``implementation``: 'auto' and 'kernel' go
    through :func:`flash_attention_forward` (the CUDA kernels on the card,
    the plain versions on the CPU; under grad, :class:`FlashAttention`);
    'reference' is the plain version with plain autograd."""
    _check_shapes(q, k, v, causal)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if implementation in ("auto", "kernel"):
        return flash_attention_forward(q, k, v, bias, causal, scale)
    if implementation == "reference":
        return attention_reference(q, k, v, bias, causal, scale)
    raise ValueError(f"unknown implementation {implementation!r}")
