"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

They hold each hand-written kernel — the flash forward and the dK/dV and dQ
backward kernels — against its plain PyTorch version on the card (and the
ResNet, which launches none of them, against itself on the CPU), at the
serving and training paths' shapes and at the edges the kernels must mask
(ragged lengths, causal, broadcast biases, all-masked rows, rows that saw
no key, head dims 16 to 128), and the autograd Function against autograd of
the plain attention. This file imports no JAX, so it runs on a machine that
has only PyTorch and the CUDA toolkit:

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


def _qkv(rng, b, h, sq, sk, d, dtype, device, strided=False):
    """q, k, v as [B,H,S,D]; ``strided`` gives the model's layout instead: a
    [B,S,H,D] tensor seen through ``transpose(1, 2)``."""
    def mk(s):
        x = rng.standard_normal((b, s, h, d) if strided else (b, h, s, d))
        x = torch.from_numpy(x.astype(np.float32)).to(device, dtype)
        return x.transpose(1, 2) if strided else x
    return mk(sq), mk(sk), mk(sk)


def _bias(rng, shape, device, pad_from=None):
    bias = rng.standard_normal(shape).astype(np.float32)
    if pad_from is not None:
        bias[..., pad_from:] = -1e30
    return torch.from_numpy(bias).to(device)


CASES = [
    # (b, h, sq, sk, d, causal, bias_shape[, strided])
    (8, 8, 128, 128, 64, False, (8, 1, 1, 128)),   # encoder self-attention
    (8, 8, 1, 128, 64, False, (8, 1, 1, 128)),     # decode cross-attention
    (8, 8, 1, 128, 64, False, None),
    (2, 3, 77, 77, 64, True, None),
    (2, 3, 33, 100, 32, True, None),                # ragged, Sq != Sk
    (2, 2, 50, 70, 16, False, (1, 2, 50, 70)),      # per-head, per-row bias
    (1, 2, 19, 45, 128, False, (1, 1, 19, 45)),
    (3, 1, 5, 200, 48, True, (3, 1, 1, 200)),
    # The boundaries of the bf16 variants (decode below Sq = 16, tc from 16
    # with D in {64, 128}): ragged Sk, broadcast padding and per-row biases,
    # causal with Sq != Sk, and the model's strided [B,S,H,D] views.
    (4, 8, 1, 101, 64, False, (4, 1, 1, 101)),
    (2, 4, 1, 77, 128, True, None),
    (2, 4, 15, 77, 64, True, None),
    (2, 4, 15, 101, 128, False, (2, 1, 15, 101)),
    (2, 4, 16, 77, 64, True, None),
    (2, 4, 16, 16, 128, False, (2, 1, 1, 16)),
    (2, 4, 63, 101, 64, False, (2, 1, 1, 101)),
    (2, 4, 64, 64, 128, True, None),
    (2, 4, 65, 101, 64, True, (2, 1, 1, 101)),
    (2, 4, 65, 77, 128, False, (2, 1, 65, 77)),
    (1, 2, 128, 128, 128, False, (1, 1, 128, 128)),
    (4, 8, 128, 128, 64, True, None, True),         # decoder self-attention
    (8, 8, 128, 128, 64, False, (8, 1, 1, 128), True),
    (8, 8, 1, 128, 64, False, (8, 1, 1, 128), True),
    (2, 4, 65, 101, 128, True, None, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_flash_kernel_matches_reference(cuda, case, dtype):
    b, h, sq, sk, d, causal, bshape, *strided = case
    rng = np.random.default_rng(sq * 1000 + sk)
    q, k, v = _qkv(rng, b, h, sq, sk, d, dtype, cuda, bool(strided))
    bias = _bias(rng, bshape, cuda, pad_from=sk - 7) if bshape else None
    before = attn.flash_attention_forward.launches
    variant = attn.forward_variant(dtype, sq, d)
    n_variant = attn.flash_attention_forward.variant_launches[variant]
    out, lse = attn.flash_attention_forward(q, k, v, bias, causal,
                                            return_lse=True)
    torch.cuda.synchronize()
    assert attn.flash_attention_forward.launches == before + 1
    assert attn.flash_attention_forward.variant_launches[variant] == \
        n_variant + 1
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
    # The bf16 variants (TMA, 16-byte loads) raise on rows off 16 bytes;
    # there is no fallback to the CUDA-core kernel.
    q = torch.zeros((1, 1, 32, 72), device=cuda, dtype=torch.bfloat16)
    for rows in (32, 1):
        view = q[:, :, :rows, 4:68]
        with pytest.raises(ValueError, match="16-byte aligned"):
            attn.flash_attention_forward(view, q[..., :64], q[..., :64])


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


# -- backward kernels (#2 dK/dV, #3 dQ) and the autograd Function -------------

# Tolerances of tests/test_ops.py's flash backward tests, absolute + relative:
# f32 differs from the plain version by summation order only; bf16 inputs are
# read into f32 by both, and each output is rounded to bf16 once.
BWD_TOL = {torch.float32: 5e-4, torch.bfloat16: 5e-2}

BWD_CASES = [
    # (b, h, sq, sk, d, causal[, strided])
    (128, 8, 128, 128, 64, True),    # the training shape (decoder self-attn)
    (4, 8, 128, 128, 64, False),
    (2, 3, 37, 101, 64, True),       # ragged Sq != Sk, ends-aligned diagonal
    (2, 3, 37, 101, 64, False),
    (3, 2, 45, 45, 16, True),        # lengths not a multiple of the tile
    (2, 2, 33, 65, 128, False),
    (1, 2, 70, 70, 128, True),
    # Q-tile boundaries of the tc variant (64 rows), ragged Sk, and the
    # model's strided views.
    (4, 8, 1, 128, 64, False),
    (2, 3, 15, 77, 64, True),
    (2, 3, 16, 101, 128, True),
    (2, 3, 63, 64, 64, False),
    (2, 3, 64, 77, 64, True),
    (2, 3, 65, 77, 128, True),
    (2, 2, 128, 128, 128, True),
    (8, 8, 128, 128, 64, True, True),
    (2, 3, 65, 101, 64, False, True),
    # dQ's tc Q tiles (64 rows) end at Sq 63/64/65 and 127/128/129, its K/V
    # tiles (64 keys) off Sk.
    (2, 3, 63, 63, 128, True),
    (2, 3, 127, 129, 64, True),
    (2, 3, 128, 150, 128, True),
    (2, 3, 129, 129, 64, False),
    (2, 3, 129, 200, 128, False),
    (2, 3, 127, 127, 64, False, True),
]


def _close(a, b, tol):
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= tol + tol * b.abs()).all())


def _bwd_inputs(rng, case, dtype, device):
    b, h, sq, sk, d, causal, *strided = case
    q, k, v = _qkv(rng, b, h, sq, sk, d, dtype, device, bool(strided))
    do = torch.from_numpy(rng.standard_normal((b, h, sq, d)).astype(
        np.float32)).to(device, dtype)
    scale = 1.0 / d ** 0.5
    out, lse = attn.flash_attention_forward(q, k, v, causal=causal,
                                            return_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    return q, k, v, do, lse, delta, causal, scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CASES)
def test_backward_kernels_match_plain_versions(cuda, case, dtype):
    rng = np.random.default_rng(case[2] * 100 + case[3])
    args = _bwd_inputs(rng, case, dtype, cuda)
    n_dkdv, n_dq = attn.flash_attn_bwd_dkdv.launches, \
        attn.flash_attn_bwd_dq.launches
    variant = attn.backward_variant(dtype, case[4])
    n_variant = attn.flash_attn_bwd_dkdv.variant_launches[variant]
    n_dq_variant = attn.flash_attn_bwd_dq.variant_launches[variant]
    dk, dv = attn.flash_attn_bwd_dkdv(*args)
    dq = attn.flash_attn_bwd_dq(*args)
    torch.cuda.synchronize()
    assert attn.flash_attn_bwd_dkdv.launches == n_dkdv + 1
    assert attn.flash_attn_bwd_dkdv.variant_launches[variant] == n_variant + 1
    assert attn.flash_attn_bwd_dq.launches == n_dq + 1
    assert attn.flash_attn_bwd_dq.variant_launches[variant] == n_dq_variant + 1
    rk, rv = attn.flash_bwd_dkdv_reference(*args)
    rq = attn.flash_bwd_dq_reference(*args)
    for name, got, ref in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        assert got.dtype == dtype and got.shape == ref.shape, name
        assert torch.isfinite(got).all(), name
        assert _close(got, ref, BWD_TOL[dtype]), \
            (name, (got.float() - ref.float()).abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CASES[1:])
def test_function_grads_match_autograd_of_reference(cuda, case, dtype):
    b, h, sq, sk, d, causal, *strided = case
    rng = np.random.default_rng(7 + sq + sk)
    q, k, v = (t.detach().requires_grad_() for t in _qkv(
        rng, b, h, sq, sk, d, dtype, cuda, bool(strided)))
    g = torch.from_numpy(rng.standard_normal((b, h, sq, d)).astype(
        np.float32)).to(cuda, dtype)
    out = attn.fused_attention(q, k, v, causal=causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, (q, k, v), g)
    ref_out = attn.attention_reference(q, k, v, causal=causal)
    ref = torch.autograd.grad(ref_out, (q, k, v), g)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert _close(a, r, BWD_TOL[dtype]), \
            (name, (a.float() - r.float()).abs().max().item())


def test_biased_call_recomputes_the_reference_vjp(cuda):
    rng = np.random.default_rng(11)
    q, k, v = (t.requires_grad_() for t in _qkv(rng, 2, 2, 20, 30, 64,
                                                 torch.float32, cuda))
    bias = _bias(rng, (2, 1, 1, 30), cuda, pad_from=25).requires_grad_()
    n_vjp, n_dq = attn.attention_reference_vjp.calls, \
        attn.flash_attn_bwd_dq.launches
    out = attn.fused_attention(q, k, v, bias)
    got = torch.autograd.grad(out.sum(), (q, k, v, bias))
    ref = torch.autograd.grad(attn.attention_reference(q, k, v, bias).sum(),
                              (q, k, v, bias))
    assert attn.attention_reference_vjp.calls == n_vjp + 1
    assert attn.flash_attn_bwd_dq.launches == n_dq
    for a, r in zip(got, ref):
        assert _close(a, r, 5e-4)


def test_output_under_grad_has_the_functions_grad_fn(cuda):
    """The slice-1 fault: a kernel output without a grad_fn silently cut
    every projection below attention out of training."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 2, 16, 16, 64, torch.bfloat16, cuda)
    q.requires_grad_()
    out = attn.flash_attention_forward(q, k, v, causal=True)
    assert out.requires_grad
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    with torch.no_grad():
        assert attn.flash_attention_forward(q, k, v).grad_fn is None


def test_backward_is_deterministic_and_reads_strided_dout(cuda):
    """No atomics: two backward calls are bit-identical. dO arrives as the
    transposed view of the model's [B,S,H,D] gradient."""
    rng = np.random.default_rng(5)
    args = list(_bwd_inputs(rng, (4, 8, 128, 128, 64, True), torch.bfloat16,
                            cuda))
    do = args[3]
    args[3] = do.transpose(1, 2).contiguous().transpose(1, 2)  # strided view
    assert not args[3].is_contiguous()
    first = (*attn.flash_attn_bwd_dkdv(*args), attn.flash_attn_bwd_dq(*args))
    second = (*attn.flash_attn_bwd_dkdv(*args),
              attn.flash_attn_bwd_dq(*args))
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    args[3] = do
    ref = (*attn.flash_attn_bwd_dkdv(*args), attn.flash_attn_bwd_dq(*args))
    for a, b in zip(first, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_rows_that_saw_no_key_get_exactly_zero(cuda, causal, dtype):
    """lse = +1e30 (the forward kernel's value for a row that saw no key)
    makes P underflow to 0 in both kernels, in every variant: dQ of such a
    row is exactly 0, and dK/dV equal those of the batch without it."""
    rng = np.random.default_rng(13)
    q, k, v, do, lse, delta, _, scale = _bwd_inputs(
        rng, (2, 2, 40, 72, 64, causal), dtype, cuda)
    dead = lse.clone()
    dead[:, :, 5] = 1e30
    dead[1, 0, 33:] = 1e30
    args = (q, k, v, do, dead, delta, causal, scale)
    dq = attn.flash_attn_bwd_dq(*args)
    dk, dv = attn.flash_attn_bwd_dkdv(*args)
    torch.cuda.synchronize()
    assert (dq[:, :, 5] == 0).all() and (dq[1, 0, 33:] == 0).all()
    rq = attn.flash_bwd_dq_reference(*args)
    rk, rv = attn.flash_bwd_dkdv_reference(*args)
    for got, ref in ((dq, rq), (dk, rk), (dv, rv)):
        assert _close(got, ref, BWD_TOL[dtype])


# -- the ResNet on the card (no kernel of ours: cuDNN convs, eager BN) --------


def _resnet_pair(dtype, device):
    from deeplearning_cfn_tpu_torch.models import resnet

    cpu = resnet.ResNet([1, 1, 1, 1], resnet.BottleneckBlock, 10,
                        num_filters=8, dtype=dtype)
    resnet.init_weights(cpu, torch.Generator().manual_seed(0))
    with torch.no_grad():  # no trivially-zero gradients
        torch.nn.init.normal_(cpu.head.weight, std=0.5)
        for block in cpu.blocks:
            block.norms[-1].weight.fill_(0.5)
    card = resnet.ResNet([1, 1, 1, 1], resnet.BottleneckBlock, 10,
                         num_filters=8, dtype=dtype).to(device)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def test_resnet_f32_forward_backward_on_card_matches_cpu(cuda):
    """f32 with TF32 off (the trainer's rule for f32 runs): train-mode
    logits, running statistics and every gradient match the CPU."""
    torch.backends.cudnn.allow_tf32 = False
    cpu, card = _resnet_pair(torch.float32, cuda)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 64, 64, 3))
                         .astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 10)).astype(np.float32))
    out_cpu = cpu(x, train=True)
    (out_cpu * w).sum().backward()
    out = card(x.to(cuda), train=True)
    (out * w.to(cuda)).sum().backward()
    assert _close(out.cpu(), out_cpu.detach(), 1e-4)
    for (name, b), (_, ref) in zip(card.named_buffers(),
                                   cpu.named_buffers()):
        assert _close(b.cpu(), ref, 1e-5), name
    for (name, p), (_, ref) in zip(card.named_parameters(),
                                   cpu.named_parameters()):
        err = (p.grad.cpu() - ref.grad).norm() / ref.grad.norm()
        assert err <= 1e-4, f"{name}: {err:.2e} of its norm"


def test_resnet_bf16_on_card_is_channels_last_and_close_to_cpu(cuda):
    cpu, card = _resnet_pair(torch.bfloat16, cuda)
    layouts = []
    for conv in card.modules():
        if conv.__class__.__name__ == "Conv":
            conv.register_forward_hook(lambda m, i, o: layouts.append(
                o.is_contiguous(memory_format=torch.channels_last)))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, 64, 64, 3)).astype(np.float32))
    out = card(x.to(cuda), train=True)
    out.float().sum().backward()
    assert layouts and all(layouts)
    ref = cpu(x, train=True)
    scale = ref.abs().max()
    assert ((out.detach().cpu() - ref.detach()).abs().max() / scale) < 5e-2
    assert all(torch.isfinite(p.grad).all() for p in card.parameters())
