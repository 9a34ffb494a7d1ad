"""Gradients of the port's attention (deeplearning_cfn_tpu_torch.ops.attention)
against the JAX package's, on the CPU.

- The plain versions of the backward kernels (``flash_bwd_dkdv_reference``,
  ``flash_bwd_dq_reference``, driven through the wrappers' CPU path) against
  the JAX ``_flash_backward(..., interpret=True)`` — the Pallas dK/dV and dQ
  kernels in interpreter mode — on the same q/k/v/O/lse/dO, over the
  (Sq, Sk) × causal grid of tests/test_ops.py, within its 5e-4.
- The ``FlashAttention`` Function's gradients against ``jax.grad`` of the
  JAX ``fused_attention(implementation="interpret")``, with and without a
  bias (the bias's gradient too): 5e-4 in f32 (summation order only), 5e-2
  in bf16 (one bf16 rounding of each gradient).
- Under grad the output carries the Function's ``grad_fn`` (the slice-1
  fault was an output without one on the card), and the counters audit
  which backward ran.

Inputs are made from numpy seeds and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_cfn_tpu.ops import attention as jattn
from deeplearning_cfn_tpu_torch.ops import attention as tattn

TOL = {"float32": 5e-4, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(seed, b, h, sq, sk, d):
    rng = np.random.RandomState(seed)
    mk = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    return mk(b, h, sq, d), mk(b, h, sk, d), mk(b, h, sk, d), mk(b, h, sq, d)


def _t(x, dtype="float32", grad=False):
    return torch.from_numpy(np.array(x, np.float32)).to(
        TDT[dtype]).requires_grad_(grad)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(64, 64), (100, 100), (64, 128),
                                   (40, 72)])
def test_backward_plain_versions_match_pallas_interpret(causal, sq, sk):
    q, k, v, g = _arrays(sq * 7 + sk, 2, 2, sq, sk, 16)
    scale = 0.25
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    out, lse = jattn._flash_forward(jq, jk, jv, None, causal, scale,
                                    interpret=True, return_stats=True)
    jdq, jdk, jdv = jattn._flash_backward(jq, jk, jv, out, lse, jg, causal,
                                          scale, interpret=True)
    launches = (tattn.flash_attn_bwd_dkdv.launches,
                tattn.flash_attn_bwd_dq.launches)
    dq, dk, dv = tattn.flash_attention_backward(
        _t(q), _t(k), _t(v), _t(out), _t(lse), _t(g), causal, scale)
    assert (tattn.flash_attn_bwd_dkdv.launches,
            tattn.flash_attn_bwd_dq.launches) == launches, \
        "a CPU call must not count a kernel launch"
    for name, got, ref in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-4,
                                   rtol=5e-4, err_msg=f"{name} mismatch")


def test_plain_versions_are_the_wrappers_cpu_path():
    q, k, v, g = (_t(x) for x in _arrays(3, 1, 2, 9, 20, 16))
    out, lse = tattn.flash_attention_forward(q, k, v, causal=True,
                                             return_lse=True)
    delta = (g * out).sum(-1)
    args = (q, k, v, g, lse, delta, True, 0.25)
    for got, ref in zip((*tattn.flash_attn_bwd_dkdv(*args),
                         tattn.flash_attn_bwd_dq(*args)),
                        (*tattn.flash_bwd_dkdv_reference(*args),
                         tattn.flash_bwd_dq_reference(*args))):
        assert torch.equal(got, ref)


def _jax_grads(q, k, v, bias, g, causal, dtype):
    args = [jnp.asarray(x, JDT[dtype]) for x in (q, k, v)]
    jb = None if bias is None else jnp.asarray(bias)
    jg = jnp.asarray(g, JDT[dtype])

    def loss(q, k, v, b):
        out = jattn.fused_attention(q, k, v, bias=b, causal=causal,
                                    implementation="interpret")
        return jnp.vdot(out.astype(jnp.float32), jg.astype(jnp.float32))

    argnums = (0, 1, 2) if jb is None else (0, 1, 2, 3)
    return [np.asarray(x, np.float32)
            for x in jax.grad(loss, argnums=argnums)(*args, jb)]


FUNCTION_CASES = {
    "causal": dict(sq=24, sk=24, causal=True),
    "ragged_causal": dict(sq=13, sk=37, causal=True),
    "cross": dict(sq=13, sk=37),
    "padding_bias": dict(sq=24, sk=24, bias_shape=(2, 1, 1, 24),
                         pad_from=17),
    "head_bias": dict(sq=9, sk=20, bias_shape=(1, 2, 9, 20)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FUNCTION_CASES))
def test_function_grads_match_jax_custom_vjp(name, dtype):
    spec = dict(FUNCTION_CASES[name])
    causal = spec.pop("causal", False)
    bias_shape = spec.pop("bias_shape", None)
    pad_from = spec.pop("pad_from", None)
    q, k, v, g = _arrays(len(name), 2, 2, spec["sq"], spec["sk"], 16)
    bias = None
    if bias_shape is not None:
        bias = np.random.RandomState(1).normal(0, 1, bias_shape).astype(
            np.float32)
        if pad_from is not None:
            bias[..., pad_from:] = -1e30
    want = _jax_grads(q, k, v, bias, g, causal, dtype)
    ins = [_t(x, dtype, grad=True) for x in (q, k, v)]
    if bias is not None:
        ins.append(_t(bias, grad=True))
    vjps = tattn.attention_reference_vjp.calls
    out = tattn.fused_attention(*ins[:3], bias=ins[3] if bias is not None
                                else None, causal=causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, ins, _t(g, dtype))
    assert tattn.attention_reference_vjp.calls == \
        vjps + (bias is not None)
    for label, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.shape == b.shape, label
        np.testing.assert_allclose(a.float().numpy(), b, atol=TOL[dtype],
                                   rtol=TOL[dtype], err_msg=label)


def test_output_under_grad_has_the_functions_grad_fn():
    """What the slice-1 fault lacked: on the card, the kernel's output came
    back without a grad_fn, so no projection below attention trained."""
    q, k, v, _ = _arrays(9, 1, 2, 8, 8, 16)
    tq = _t(q, grad=True)
    out, lse = tattn.flash_attention_forward(tq, _t(k), _t(v), causal=True,
                                             return_lse=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert not lse.requires_grad
    with torch.no_grad():
        assert tattn.fused_attention(tq, _t(k), _t(v)).grad_fn is None
    ref = tattn.fused_attention(tq, _t(k), _t(v), implementation="reference")
    assert type(ref.grad_fn).__name__ != "FlashAttentionBackward"


def test_bias_gradient_only_when_asked():
    q, k, v, g = _arrays(4, 1, 2, 6, 10, 16)
    bias = torch.zeros((1, 1, 1, 10))  # a padding bias: no grad wanted
    tq = _t(q, grad=True)
    out = tattn.fused_attention(tq, _t(k), _t(v), bias=bias)
    (dq,) = torch.autograd.grad(out, (tq,), _t(g))
    assert dq.shape == tq.shape and bias.grad is None


def test_rows_that_saw_no_key_get_exactly_zero():
    """lse = +1e30 (what the forward writes for a row that saw no key)
    makes P underflow to 0: such rows get dQ exactly 0 and give dK/dV
    nothing."""
    q, k, v, g = (_t(x) for x in _arrays(6, 1, 2, 12, 20, 16))
    out, lse = tattn.flash_attention_forward(q, k, v, return_lse=True)
    delta = (g * out).sum(-1)
    dead = lse.clone()
    dead[:, :, 3] = 1e30
    args = (q, k, v, g, dead, delta, False, 0.25)
    dq = tattn.flash_attn_bwd_dq(*args)
    assert torch.equal(dq[:, :, 3], torch.zeros_like(dq[:, :, 3]))
    dk, dv = tattn.flash_attn_bwd_dkdv(*args)
    keep = torch.ones(12, dtype=torch.bool)
    keep[3] = False
    rk, rv = tattn.flash_attn_bwd_dkdv(
        q[:, :, keep], k, v, g[:, :, keep], lse[:, :, keep],
        delta[:, :, keep], False, 0.25)
    torch.testing.assert_close(dk, rk, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(dv, rv, atol=1e-6, rtol=1e-6)
