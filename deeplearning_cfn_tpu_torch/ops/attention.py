"""Fused multi-head attention: a hand-written CUDA flash kernel + torch reference.

The port of ``deeplearning_cfn_tpu/ops/attention.py``:

- ``attention_reference``: plain torch softmax(QKᵀ·scale + bias)V, computed in
  f32 whatever the input dtype, with the same ``-1e30`` mask, ends-aligned
  causal masking, and softmax weights cast to ``v.dtype`` before the PV
  product. It is the numerics oracle and the CPU path.
- ``flash_attention_forward``: the wrapper of ``csrc/flash_attn_fwd.cu``,
  the CUDA port of the Pallas ``_flash_kernel``. For a CUDA tensor it
  launches the kernel or raises; for a CPU tensor it computes the plain
  version (the only reason it ever does). ``flash_attention_forward.launches``
  counts kernel launches.
- ``fused_attention``: the public entry, with the JAX contract
  (``[B,H,S,D]`` inputs, causal ``Sq <= Sk``, bias broadcastable to
  ``[B,H,Sq,Sk]``).

Deliberate differences from the JAX package:

- ``implementation="auto"`` means the kernel for CUDA tensors and the plain
  version for CPU tensors. The v5e short-sequence crossover
  (``_auto_use_pallas``) is not carried over: on a TPU it sent every call
  with ``Sk < 1024`` — this whole NMT model — to XLA.
- The single-position decode attentions of ``models/transformer.py``, which
  JAX pins to ``implementation="reference"``, go through the kernel here as
  well. Both compute the same function, so on the card every attention call
  of the serving path is a kernel launch and the plain version serves only
  as the comparison.
- Causal masking in the kernel removes the keys above the diagonal rather
  than setting them to ``-1e30`` (whole tiles of them are skipped). The
  two agree except for a causal row whose every visible key a bias also
  masks: the kernel spreads that row's uniform weight over the visible
  keys, the plain version over all keys. No serving call is causal with a
  bias.
- Forward only: the backward kernels (``_flash_bwd_dkdv_kernel``,
  ``_flash_bwd_dq_kernel``) belong to the training slice.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import kernels

_NEG_INF = -1e30  # large-negative instead of -inf: keeps masked softmax NaN-free

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
        q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        k_pos = torch.arange(sk, device=q.device)[None, :]
        logits = torch.where(k_pos <= q_pos, logits,
                             torch.full_like(logits, _NEG_INF))
    weights = torch.softmax(logits, dim=-1)
    return torch.matmul(weights.to(v.dtype).float(), v.float()).to(q.dtype)


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


def _launch(q, k, v, bias, causal, scale, return_lse):
    b, h, sq, d = q.shape
    sk = k.shape[-2]
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.shape[:2] != (b, h) or v.shape != k.shape or k.shape[-1] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if d < 16 or d > 128 or d % 16:
        raise ValueError(f"head dim {d} not supported (16..128, multiple "
                         f"of 16)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride on the head dim")
    kb = _kernel_bias(bias, b, h, sq, sk)
    if kb is not None and kb.device != q.device:
        raise ValueError(f"bias is on {kb.device}, q on {q.device}")
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    lib = kernels.load("flash_attn_fwd")
    fn = lib.flash_attn_fwd
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I,
                       L, L, L, L, L, L, L, L, L, L, L, L, L,
                       ctypes.c_float, I, I, P]
        fn.restype = I
    bstr = kb.stride() if kb is not None else (0, 0, 0, 0)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             kb.data_ptr() if kb is not None else None, out.data_ptr(),
             lse.data_ptr() if lse is not None else None,
             b, h, sq, sk, d,
             q.stride(0), q.stride(1), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             *bstr, float(scale), int(bool(causal)), _DTYPE_CODES[q.dtype],
             stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: cudaError_t {err}")
    flash_attention_forward.launches += 1
    return out, lse


def _reference_lse(q, k, bias, causal, scale):
    """Per-row logsumexp of the kernel's logits (the plain version of the
    kernel's optional ``lse`` output)."""
    sq, sk = q.shape[-2], k.shape[-2]
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if bias is not None and bias.shape[-1] != 1:
        s = s + bias.float()
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        k_pos = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(k_pos <= q_pos, s, torch.full_like(s, _NEG_INF))
    return torch.logsumexp(s, dim=-1)


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            bias: Optional[torch.Tensor] = None,
                            causal: bool = False,
                            sm_scale: Optional[float] = None,
                            return_lse: bool = False):
    """The flash kernel's wrapper: launches ``csrc/flash_attn_fwd.cu`` for
    CUDA tensors (raising on anything it does not take), the plain version
    for CPU tensors. Returns ``out`` or ``(out, lse)``."""
    _check_shapes(q, k, v, causal)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        out = attention_reference(q, k, v, bias, causal, scale)
        lse = _reference_lse(q, k, bias, causal, scale) if return_lse \
            else None
    else:
        out, lse = _launch(q, k, v, bias, causal, scale, return_lse)
    return (out, lse) if return_lse else out


flash_attention_forward.launches = 0


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    implementation: str = "auto") -> torch.Tensor:
    """Multi-head attention. ``implementation``: 'auto' and 'kernel' go
    through :func:`flash_attention_forward` (the CUDA kernel on the card,
    the plain version on the CPU); 'reference' is the plain version."""
    _check_shapes(q, k, v, causal)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if implementation in ("auto", "kernel"):
        return flash_attention_forward(q, k, v, bias, causal, scale)
    if implementation == "reference":
        return attention_reference(q, k, v, bias, causal, scale)
    raise ValueError(f"unknown implementation {implementation!r}")
