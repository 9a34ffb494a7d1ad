"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

They hold each hand-written kernel against its plain PyTorch version on the
card, at the serving path's shapes and at the edges the kernel must mask
(ragged lengths, causal, broadcast biases, all-masked rows, head dims 16 to
128). This file imports no JAX, so it runs on a machine that has only
PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from deeplearning_cfn_tpu_torch.ops import attention as attn

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(rng, b, h, sq, sk, d, dtype, device):
    mk = lambda s: torch.from_numpy(
        rng.standard_normal((b, h, s, d)).astype(np.float32)).to(device, dtype)
    return mk(sq), mk(sk), mk(sk)


def _bias(rng, shape, device, pad_from=None):
    bias = rng.standard_normal(shape).astype(np.float32)
    if pad_from is not None:
        bias[..., pad_from:] = -1e30
    return torch.from_numpy(bias).to(device)


CASES = [
    # (b, h, sq, sk, d, causal, bias_shape)
    (8, 8, 128, 128, 64, False, (8, 1, 1, 128)),   # encoder self-attention
    (8, 8, 1, 128, 64, False, (8, 1, 1, 128)),     # decode cross-attention
    (8, 8, 1, 128, 64, False, None),
    (2, 3, 77, 77, 64, True, None),
    (2, 3, 33, 100, 32, True, None),                # ragged, Sq != Sk
    (2, 2, 50, 70, 16, False, (1, 2, 50, 70)),      # per-head, per-row bias
    (1, 2, 19, 45, 128, False, (1, 1, 19, 45)),
    (3, 1, 5, 200, 48, True, (3, 1, 1, 200)),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_flash_kernel_matches_reference(cuda, case, dtype):
    b, h, sq, sk, d, causal, bshape = case
    rng = np.random.default_rng(sq * 1000 + sk)
    q, k, v = _qkv(rng, b, h, sq, sk, d, dtype, cuda)
    bias = _bias(rng, bshape, cuda, pad_from=sk - 7) if bshape else None
    before = attn.flash_attention_forward.launches
    out, lse = attn.flash_attention_forward(q, k, v, bias, causal,
                                            return_lse=True)
    torch.cuda.synchronize()
    assert attn.flash_attention_forward.launches == before + 1
    ref = attn.attention_reference(q, k, v, bias, causal)
    assert out.dtype == q.dtype and out.shape == ref.shape
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err
    ref_lse = attn._reference_lse(q, k, bias, causal, 1.0 / d ** 0.5)
    rel = ((lse - ref_lse).abs() / ref_lse.abs().clamp_min(1.0)).max().item()
    assert rel <= 1e-3, rel


def test_flash_kernel_all_masked_row_is_uniform(cuda):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, 2, 2, 1, 64, 64, torch.float32, cuda)
    bias = torch.zeros((2, 1, 1, 64), device=cuda)
    bias[1] = -1e30  # every key of batch row 1 masked (an all-PAD slot)
    out = attn.flash_attention_forward(q, k, v, bias)
    ref = attn.attention_reference(q, k, v, bias)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-4
    assert torch.allclose(out[1, :, 0], v[1].mean(dim=1), atol=1e-5)


def test_flash_kernel_reads_strided_views(cuda):
    """The model hands the kernel [B,S,H,D] -> [B,H,S,D] transposed views."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 40, 8, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    view = x.transpose(1, 2)
    out = attn.flash_attention_forward(view, view, view)
    ref = attn.attention_reference(view, view, view)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 1, 4, 72), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        attn.flash_attention_forward(q, q, q)
    q = torch.zeros((1, 1, 4, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        attn.flash_attention_forward(q, q, q)
    q = torch.zeros((1, 1, 4, 128), device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        attn.flash_attention_forward(q, q, q)


def test_flash_kernel_causal_all_masked_row_spreads_over_visible_keys(cuda):
    """The one documented corner where kernel and plain version differ:
    keys above the causal diagonal do not exist for the kernel."""
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 1, 1, 4, 8, 16, torch.float32, cuda)
    bias = torch.full((1, 1, 1, 8), -1e30, device=cuda)
    out = attn.flash_attention_forward(q, k, v, bias, causal=True)
    for i in range(4):
        visible = v[0, 0, :i + 5].mean(dim=0)
        assert torch.allclose(out[0, 0, i], visible, atol=1e-5)
