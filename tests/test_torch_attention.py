"""Parity of the port's attention (deeplearning_cfn_tpu_torch.ops.attention)
with the JAX package's on the CPU.

The same numpy inputs, made from a seed, go through the JAX
``fused_attention(implementation="interpret")`` (the Pallas kernel in
interpreter mode, as tests/test_ops.py runs it), JAX ``attention_reference``,
and the port's ``fused_attention`` — which on CPU tensors is the plain
version, so the launch counter must stay at 0. Tolerances: 1e-5 in f32
(summation order only), 2e-2 in bf16 (one bf16 rounding of P and of O).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_cfn_tpu.ops import attention as jattn
from deeplearning_cfn_tpu_torch.ops import attention as tattn

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, b, h, sq, sk, d, bias_shape=None, pad_from=None):
    rng = np.random.RandomState(seed)
    q = rng.normal(0, 1, (b, h, sq, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, h, sk, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, h, sk, d)).astype(np.float32)
    bias = None
    if bias_shape is not None:
        bias = rng.normal(0, 1, bias_shape).astype(np.float32)
        if pad_from is not None:
            bias[..., pad_from:] = -1e30
    return q, k, v, bias


def _run_both(q, k, v, bias, causal, dtype):
    jargs = [jnp.asarray(x, JDT[dtype]) for x in (q, k, v)]
    jb = None if bias is None else jnp.asarray(bias)
    interp = jattn.fused_attention(*jargs, bias=jb, causal=causal,
                                   implementation="interpret")
    ref = jattn.attention_reference(*jargs, bias=jb, causal=causal)
    targs = [torch.from_numpy(x).to(TDT[dtype]) for x in (q, k, v)]
    tb = None if bias is None else torch.from_numpy(bias)
    before = tattn.flash_attention_forward.launches
    out = tattn.fused_attention(*targs, bias=tb, causal=causal)
    assert tattn.flash_attention_forward.launches == before, \
        "a CPU call must not count a kernel launch"
    assert out.dtype == TDT[dtype]
    return (np.asarray(interp, np.float32), np.asarray(ref, np.float32),
            out.float().numpy())


CASES = {
    "plain": dict(b=2, h=2, sq=32, sk=32, d=16),
    "causal": dict(b=2, h=2, sq=40, sk=40, d=16, causal=True),
    "ragged_cross": dict(b=1, h=3, sq=13, sk=37, d=32),
    "ragged_causal": dict(b=1, h=2, sq=13, sk=37, d=16, causal=True),
    "padding_bias": dict(b=2, h=2, sq=24, sk=24, d=16,
                         bias_shape=(2, 1, 1, 24), pad_from=17),
    "broadcast_head_bias": dict(b=2, h=3, sq=9, sk=20, d=16,
                                bias_shape=(1, 3, 9, 20)),
    "k_dim_one_bias": dict(b=2, h=2, sq=8, sk=16, d=16,
                           bias_shape=(2, 1, 8, 1)),
    "decode_row_bias": dict(b=4, h=2, sq=1, sk=32, d=16,
                            bias_shape=(4, 1, 1, 32), pad_from=11),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_port_attention_matches_jax(name, dtype):
    spec = dict(CASES[name])
    causal = spec.pop("causal", False)
    q, k, v, bias = _inputs(len(name), **spec)
    interp, ref, out = _run_both(q, k, v, bias, causal, dtype)
    np.testing.assert_allclose(out, ref, atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(out, interp, atol=TOL[dtype], rtol=0)


def test_all_masked_row_is_uniform_like_jax():
    """An all-PAD prefill slot: every key at -1e30 → uniform softmax, no
    NaN, in the JAX kernel and the port alike. (Sk is a multiple of 8: the
    Pallas kernel pads K to one, and its padded columns would then share
    the uniform weight of an all-masked row.)"""
    q, k, v, bias = _inputs(3, 2, 2, 6, 16, 16, bias_shape=(2, 1, 1, 16))
    bias[1] = -1e30
    interp, ref, out = _run_both(q, k, v, bias, False, "float32")
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, interp, atol=1e-5, rtol=0)
    np.testing.assert_allclose(out[1], np.broadcast_to(
        v[1].mean(axis=1, keepdims=True), out[1].shape), atol=1e-5)


def test_lse_plain_version_matches_jax_kernel_stats():
    q, k, v, _ = _inputs(5, 1, 2, 10, 20, 16)
    _, jlse = jattn._flash_forward(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), None, True, 0.25,
                                   interpret=True, return_stats=True)
    out, lse = tattn.flash_attention_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, sm_scale=0.25, return_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5)


def test_validation_errors_match_jax():
    z = np.zeros((1, 1, 4, 16), np.float32)
    zt = torch.zeros(1, 1, 4, 16)
    with pytest.raises(ValueError, match=r"expected \[B,H,S,D\]"):
        jattn.fused_attention(jnp.asarray(z[0]), jnp.asarray(z),
                              jnp.asarray(z))
    with pytest.raises(ValueError, match=r"expected \[B,H,S,D\]"):
        tattn.fused_attention(zt[0], zt, zt)
    long_q = np.zeros((1, 1, 6, 16), np.float32)
    with pytest.raises(ValueError, match="causal attention requires"):
        jattn.fused_attention(jnp.asarray(long_q), jnp.asarray(z),
                              jnp.asarray(z), causal=True)
    with pytest.raises(ValueError, match="causal attention requires"):
        tattn.fused_attention(torch.zeros(1, 1, 6, 16), zt, zt, causal=True)
    with pytest.raises(ValueError, match="unknown implementation"):
        jattn.fused_attention(jnp.asarray(z), jnp.asarray(z), jnp.asarray(z),
                              implementation="nope")
    with pytest.raises(ValueError, match="unknown implementation"):
        tattn.fused_attention(zt, zt, zt, implementation="nope")
    assert tattn.flash_attention_forward.launches == 0
