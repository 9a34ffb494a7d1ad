"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

They hold each hand-written kernel — the flash forward and the dK/dV and dQ
backward kernels — against its plain PyTorch version on the card (and the
ResNet, which launches none of them, against itself on the CPU), at the
serving and training paths' shapes and at the edges the kernels must mask
(ragged lengths, causal, broadcast biases, all-masked rows, rows that saw
no key, head dims 16 to 128), and the autograd Function against autograd of
the plain attention; BERT's padded self-attention path (kernel #1, then the
reference-VJP recompute) against the CPU, ``train.remat`` with a card
generator, and Mask R-CNN's plain-PyTorch path (``nms_static``,
``multilevel_roi_align`` forward and backward, the tiny ``DetectionTask``
loss) against the CPU, and GPT's path: the three kernels at 1023, 1024 and
1025 causal keys, the decode variant over a 1024-slot cache with the step
bias at batch 1 and 8, and the tiny f32 ``CausalLmTask`` against the CPU;
and speculative serving: the verify span (γ = 1, 4, 8, dense and paged)
against the plain version, and a tiny f32 speculative engine on the card
against the CPU; ViT's attention at [256, 6, 196, 64] (neither causal nor
biased) against the plain versions, the tiny f32 ViT (with 5 Adafactor
steps) and the tiny f32 BERT-MoE and GPT-MoE on the card against the CPU;
and int8 serving: the bf16 ``QuantDense``/``QuantEmbed`` on the card against
their f32 CPU versions, and the int8 paged write (codes within ±1) and a
tiny int8 engine on the card against the CPU; and data parallelism: two
gloo processes on the card (``chip_smoke.py --dp-worker``) each launch the
three kernels in their steps of a tiny f32 NMT, whose losses match one
process on the same global batches; and the long-context trunks: the three
kernels at ``bert_long``'s 4096 keys and ``gpt_long``'s 16384 causal keys
(heads cut so the plain versions fit) against the plain versions, the tiny
f32 ``bert_long`` and ``gpt_long`` on the card against the CPU, and two
gloo processes on the card with ``mesh.seq=2`` (ring and Ulysses) against
one process. This file imports no JAX, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from chip_smoke import scaled_error
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


# -- BERT on the card (kernel #1 with a padding bias; reference-VJP backward) -


def _bert_task(cuda, dtype, extra=()):
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.presets import get_preset
    from deeplearning_cfn_tpu_torch.train.task import MlmTask

    cfg = apply_overrides(get_preset("bert_base_wikipedia"), [
        "model.name=bert_tiny", "model.kwargs.hidden_size=128",
        "model.kwargs.num_layers=2", "model.kwargs.num_heads=2",
        "model.kwargs.mlp_dim=256", "model.kwargs.dropout_rate=0.0",
        "data.vocab_size=256", "data.seq_len=64", "train.global_batch=8",
        f"train.dtype={dtype}", *extra])
    cpu = MlmTask(cfg, torch.device("cpu"))
    cpu.init(torch.Generator().manual_seed(0))
    card = MlmTask(cfg, cuda)
    card.model.load_state_dict(cpu.model.state_dict())
    return cfg, cpu, card


def _mlm_batch(cfg, device):
    from deeplearning_cfn_tpu_torch.data.pipeline import (build_pipeline,
                                                          to_device)

    b = next(iter(build_pipeline(cfg.data, 8, seed=0).one_epoch()))
    b["input_mask"][1, 40:] = 0  # a padded row: the bias matters
    b["input_ids"][1, 40:] = 0
    return to_device(b, device)


def test_bert_f32_on_card_matches_cpu(cuda):
    cfg, cpu, card = _bert_task(cuda, "float32")
    fwd0 = attn.flash_attention_forward.launches
    vjp0 = attn.attention_reference_vjp.calls
    bwd0 = attn.flash_attn_bwd_dkdv.launches + attn.flash_attn_bwd_dq.launches
    ref, _ = cpu.loss_fn(_mlm_batch(cfg, torch.device("cpu")), True)
    ref.backward()
    vjp_cpu = attn.attention_reference_vjp.calls - vjp0
    got, _ = card.loss_fn(_mlm_batch(cfg, cuda), True)
    got.backward()
    assert attn.flash_attention_forward.launches - fwd0 == 2  # 2 layers
    assert attn.attention_reference_vjp.calls - vjp0 == 2 * vjp_cpu == 4
    assert attn.flash_attn_bwd_dkdv.launches + \
        attn.flash_attn_bwd_dq.launches == bwd0
    assert abs(float(got) - float(ref)) <= 1e-5 * abs(float(ref))
    for (name, p), (_, r) in zip(card.model.named_parameters(),
                                 cpu.model.named_parameters()):
        err = (p.grad.cpu() - r.grad).norm() / r.grad.norm().clamp_min(1e-6)
        assert err <= 1e-4 or name.endswith("key.bias"), \
            f"{name}: {err:.2e} of its norm"


def test_bert_bf16_self_attention_takes_tc(cuda):
    cfg, _, card = _bert_task(cuda, "bfloat16")
    tc0 = attn.flash_attention_forward.variant_launches["tc"]
    loss, _ = card.loss_fn(_mlm_batch(cfg, cuda), True)
    loss.backward()
    assert attn.flash_attention_forward.variant_launches["tc"] - tc0 == 2
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all()
               for p in card.model.parameters())


def test_remat_with_a_card_generator_matches_no_remat(cuda):
    from deeplearning_cfn_tpu_torch.train import optim
    from deeplearning_cfn_tpu_torch.train.state import create_train_state
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer

    runs = []
    for remat in ("false", "true"):
        cfg, _, card = _bert_task(cuda, "float32", [
            "model.kwargs.dropout_rate=0.3", "train.grad_accum_steps=2",
            f"train.remat={remat}"])
        state = create_train_state(card.model, optim.build_optimizer(
            cfg.optimizer, optim.build_schedule(cfg.schedule, 4, 8),
            card.model))
        metrics = Trainer(cfg, card, cuda).train_step(state,
                                                      _mlm_batch(cfg, cuda))
        runs.append((float(metrics["loss"]),
                     {n: p.grad.detach().clone()
                      for n, p in card.model.named_parameters()}))
    (l0, g0), (l1, g1) = runs
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    for name in g0:  # the embedding backward's atomics reorder additions
        err = (g1[name] - g0[name]).norm() / g0[name].norm().clamp_min(1e-6)
        assert err <= 1e-5 or name.endswith("key.bias"), name


# -- Mask R-CNN on the card (plain PyTorch: NMS loop, ROI-align gathers) -----


def _nms_inputs(rng, lead, n):
    y0, x0 = rng.uniform(0, 40, lead + (n,)), rng.uniform(0, 40, lead + (n,))
    h, w = rng.uniform(6, 20, lead + (n,)), rng.uniform(6, 20, lead + (n,))
    boxes = np.stack([y0, x0, y0 + h, x0 + w], -1).astype(np.float32)
    scores = np.round(rng.uniform(0, 1, lead + (n,)) * 8) / 8  # ties
    scores[..., -5:] = -1e30  # padding sentinels
    valid = rng.uniform(0, 1, lead + (n,)) > 0.2
    return (torch.from_numpy(boxes), torch.from_numpy(
        scores.astype(np.float32)), torch.from_numpy(valid))


def test_nms_static_on_card_matches_cpu(cuda):
    from deeplearning_cfn_tpu_torch.ops.detection import nms_static

    boxes, scores, valid = _nms_inputs(np.random.default_rng(0), (4, 6), 300)
    for k, v in ((256, None), (100, valid)):
        ref = nms_static(boxes, scores, 0.5, k, v)
        got = nms_static(boxes.to(cuda), scores.to(cuda), 0.5, k,
                         None if v is None else v.to(cuda))
        assert torch.equal(got[0].cpu(), ref[0])
        assert torch.equal(got[1].cpu(), ref[1])
        assert 0 < int(ref[1].sum()) < ref[1].numel()


def test_multilevel_roi_align_on_card_matches_cpu(cuda):
    """Forward and the gradient into the features (an index_add with
    atomics on the card) against the CPU in f32: within 1e-5 of the largest
    value. bf16 features (gathered in bf16, weighted in f32, the output
    and the accumulated gradient rounded to bf16, the gradient's adds in
    bf16 in an atomic order) against the same f32 reference: within 2e-2
    of its norm."""
    from deeplearning_cfn_tpu_torch.ops.detection import multilevel_roi_align

    rng = np.random.default_rng(1)
    strides = {2: 4, 3: 8, 4: 16, 5: 32, 6: 64}
    b, n, c = 2, 64, 16
    feats = {l: torch.from_numpy(rng.standard_normal(
        (b, 512 // s, 512 // s, c)).astype(np.float32)).permute(0, 3, 1, 2)
        for l, s in strides.items()}
    y0, x0 = rng.uniform(-20, 500, (b, n)), rng.uniform(-20, 500, (b, n))
    side = np.exp(rng.uniform(np.log(4), np.log(1100), (b, n)))
    boxes = torch.from_numpy(np.stack([y0, x0, y0 + side, x0 + side], -1)
                             .astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((b, n, 7, 7, c)).astype(
        np.float32))

    def run(dev, dtype):
        fs = {l: f.detach().to(dev, dtype).contiguous(
            memory_format=torch.channels_last).requires_grad_()
            for l, f in feats.items()}
        out = multilevel_roi_align(fs, boxes.to(dev), 7, strides)
        assert out.dtype == dtype
        out.backward(ct.to(dev, dtype))
        return out.detach().float().cpu(), {l: f.grad.float().cpu()
                                            for l, f in fs.items()}

    ref, ref_g = run(torch.device("cpu"), torch.float32)
    got, got_g = run(cuda, torch.float32)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    for l in ref_g:
        assert (got_g[l] - ref_g[l]).abs().max() <= \
            1e-5 * ref_g[l].abs().max(), l
    got, got_g = run(cuda, torch.bfloat16)
    err = float((got - ref).norm() / ref.norm())
    assert err <= 2e-2, err
    for l in ref_g:
        err = float((got_g[l] - ref_g[l]).norm() / ref_g[l].norm())
        assert err <= 2e-2, (l, err)


def test_detection_loss_on_card_matches_cpu(cuda):
    """The tiny f32 Mask R-CNN's loss_fn (tests/test_detection.py's config)
    from one seeded init and batch: the chosen proposals equal, the five
    losses and proposal recall within 1e-5 relative, every gradient within
    1e-3 of the global norm, the running statistics within 1e-5. f32 with
    TF32 off (the trainer's rule for f32 runs).

    The gradient tolerance is the loss's own: it is piecewise smooth
    (ReLU and max-pool kinks, the top-k and NMS choices), and on the CPU
    alone an input change of 1e-7 relative moves these gradients by up to
    5.7e-4 of the global norm, so two devices' f32 roundings cannot agree
    closer. The losses and forward values do (3.8e-7 in chip_smoke.py
    phase 16)."""
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.data.detection import \
        make_detection_source
    from deeplearning_cfn_tpu_torch.data.pipeline import to_device
    from deeplearning_cfn_tpu_torch.presets import get_preset
    from deeplearning_cfn_tpu_torch.train.detection_task import DetectionTask

    cfg = apply_overrides(get_preset("maskrcnn_coco"), [
        "model.num_classes=7", "model.kwargs.image_size=64",
        "model.kwargs.pre_nms_topk=64", "model.kwargs.post_nms_topk=16",
        "model.kwargs.num_mask_rois=4", "model.kwargs.anchor_scale=4.0",
        "data.image_size=64", "data.max_boxes=4", "train.global_batch=4",
        "train.dtype=float32"])
    torch.backends.cudnn.allow_tf32 = False
    host = make_detection_source(4, 64, 7, 4, seed=11).arrays
    runs, init = [], None
    for dev in (torch.device("cpu"), cuda):
        task = DetectionTask(cfg, dev)
        if init is None:
            task.init(torch.Generator().manual_seed(0))
            init = {k: v.clone() for k, v in task.model.state_dict().items()}
        else:
            task.model.load_state_dict(init)
        batch = to_device(host, dev)
        with torch.no_grad():
            out = task.model(batch["image"], train=True)
            _, keep, idx = task._proposals_infer(out["rpn_logits"],
                                                 out["rpn_deltas"])
        task.model.load_state_dict(init)
        loss, aux = task.loss_fn(batch, True)
        loss.backward()
        runs.append((idx.cpu(), keep.cpu(),
                     {k: float(v.detach()) for k, v in aux.items()},
                     {n: p.grad.cpu() for n, p in
                      task.model.named_parameters()},
                     {n: b.cpu() for n, b in task.model.named_buffers()}))
    (i0, k0, l0, g0, s0), (i1, k1, l1, g1, s1) = runs
    assert torch.equal(i0, i1) and torch.equal(k0, k1)
    for key, v in l0.items():
        assert abs(l1[key] - v) <= 1e-5 * abs(v), key
    norm = torch.sqrt(sum((g * g).sum() for g in g0.values()))
    for name, g in g0.items():
        assert (g1[name] - g).norm() <= 1e-3 * norm, name
    for name, s in s0.items():
        assert (s1[name] - s).abs().max() <= 1e-5 * s.abs().max().clamp_min(
            1.0), name


# -- GPT on the card (all three kernels at sequence 1024; decode steps) ------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1023, 1024, 1025])
def test_long_causal_rows_match_plain_versions(cuda, s, dtype):
    """GPT's sequence: 16 KV tiles of 64 keys, off the tile on both sides,
    the causal tile skip and the online softmax across them, and the
    16-step loops of dK/dV and dQ, in the model's strided layout."""
    rng = np.random.default_rng(s)
    case = (2, 3, s, s, 64, True, True)
    args = _bwd_inputs(rng, case, dtype, cuda)
    q, k, v = args[:3]
    variant = attn.forward_variant(dtype, s, 64)
    n = attn.flash_attention_forward.variant_launches[variant]
    out = attn.flash_attention_forward(q, k, v, causal=True)
    assert attn.flash_attention_forward.variant_launches[variant] == n + 1
    ref = attn.attention_reference(q, k, v, causal=True)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert scaled_error(out, ref)["ok"], scaled_error(out, ref)
    dk, dv = attn.flash_attn_bwd_dkdv(*args)
    dq = attn.flash_attn_bwd_dq(*args)
    rk, rv = attn.flash_bwd_dkdv_reference(*args)
    rq = attn.flash_bwd_dq_reference(*args)
    for name, got, want in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        assert torch.isfinite(got).all(), name
        assert _close(got, want, BWD_TOL[dtype]), \
            (name, (got.float() - want.float()).abs().max().item())
        assert scaled_error(got, want)["ok"], (name, scaled_error(got, want))


@pytest.mark.parametrize("batch", [1, 8])
def test_gpt_decode_step_over_a_1024_slot_cache(cuda, batch):
    """The decode variant at GPT's generation shape: one query per row
    against the [B, 12, 1024, 64] cache, the [B, 1, 1, 1024] step bias of
    ``models/transformer.py:step_bias`` (rows at different positions)."""
    from deeplearning_cfn_tpu_torch.models.transformer import step_bias

    rng = np.random.default_rng(batch)
    q, _, _ = _qkv(rng, batch, 12, 1, 1, 64, torch.bfloat16, cuda,
                   strided=True)
    _, k, v = _qkv(rng, batch, 12, 1, 1024, 64, torch.bfloat16, cuda)
    pos = torch.from_numpy(rng.integers(0, 1024, batch)).to(cuda)
    pos[0] = 1023 if batch > 1 else 700
    bias = step_bias(pos, 1024)
    n = attn.flash_attention_forward.variant_launches["decode"]
    out = attn.flash_attention_forward(q, k, v, bias)
    torch.cuda.synchronize()
    assert attn.flash_attention_forward.variant_launches["decode"] == n + 1
    ref = attn.attention_reference(q, k, v, bias)
    assert (out.float() - ref.float()).abs().max().item() <= \
        TOL[torch.bfloat16]
    assert scaled_error(out, ref)["ok"], scaled_error(out, ref)


def test_gpt_tiny_f32_on_card_matches_cpu(cuda):
    """``gpt_tiny`` through ``CausalLmTask`` on the card against the CPU,
    one seeded init and batch, TF32 off: the loss within 1e-5 relative,
    every gradient within 1e-4 of the global gradient norm; the forward,
    dK/dV and dQ kernels launched once per layer, the reference VJP
    never."""
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.data.pipeline import (build_pipeline,
                                                          to_device)
    from deeplearning_cfn_tpu_torch.presets import get_preset
    from deeplearning_cfn_tpu_torch.train.task import CausalLmTask

    cfg = apply_overrides(get_preset("gpt_small_lm"), [
        "model.name=gpt_tiny", "model.kwargs.max_len=64",
        "model.kwargs.dropout_rate=0.0", "data.vocab_size=512",
        "data.seq_len=64", "train.dtype=float32",
        "data.num_train_examples=16"])
    cpu = CausalLmTask(cfg, torch.device("cpu"))
    cpu.init(torch.Generator().manual_seed(0))
    card = CausalLmTask(cfg, cuda)
    card.model.load_state_dict(cpu.model.state_dict())
    batch = next(iter(build_pipeline(cfg.data, 8, seed=0).one_epoch()))
    ref, _ = cpu.loss_fn(to_device(batch, torch.device("cpu")), True)
    ref.backward()
    before = (attn.flash_attention_forward.launches,
              attn.flash_attn_bwd_dkdv.launches,
              attn.flash_attn_bwd_dq.launches,
              attn.attention_reference_vjp.calls)
    got, _ = card.loss_fn(to_device(batch, cuda), True)
    got.backward()
    torch.cuda.synchronize()
    after = (attn.flash_attention_forward.launches,
             attn.flash_attn_bwd_dkdv.launches,
             attn.flash_attn_bwd_dq.launches,
             attn.attention_reference_vjp.calls)
    assert [a - b for a, b in zip(after, before)] == [2, 2, 2, 0]
    assert abs(float(got) - float(ref)) <= 1e-5 * abs(float(ref))
    norm = torch.sqrt(sum((p.grad ** 2).sum()
                          for p in cpu.model.parameters()))
    for (name, p), (_, r) in zip(card.model.named_parameters(),
                                 cpu.model.named_parameters()):
        assert (p.grad.cpu() - r.grad).norm() <= 1e-4 * norm, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("gamma", [1, 4, 8])
def test_verify_span_matches_plain_version(cuda, gamma, paged, dtype):
    """The speculative verify span: q [8, 8, γ+1, 64] in the model's strided
    layout with the span bias of ``models/transformer.py:span_bias`` (rows
    at their own positions, the last spans past max_len) against the
    128-slot cache or the paged gather (``chip_smoke.span_inputs``); bf16
    on ``decode``."""
    from chip_smoke import span_inputs

    q, k, v, bias = span_inputs(torch, gamma, gamma + 1, dtype, paged)
    variant = attn.forward_variant(dtype, gamma + 1, 64)
    assert variant == ("decode" if dtype == torch.bfloat16 else "simt")
    n = attn.flash_attention_forward.variant_launches[variant]
    out = attn.flash_attention_forward(q, k, v, bias)
    torch.cuda.synchronize()
    assert attn.flash_attention_forward.variant_launches[variant] == n + 1
    ref = attn.attention_reference(q, k, v, bias)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert scaled_error(out, ref)["ok"], scaled_error(out, ref)


def test_spec_engine_tiny_f32_on_card_matches_cpu(cuda):
    """A tiny f32 speculative engine (paged, γ = 3, the device chain, a
    shrunk distinct draft) on the card against the same engine on the CPU,
    from one seeded init with the Dense weights scaled ×3 (so that greedy
    choices are clear of ties): identical tokens, and the first verify's
    logits within 1e-4 of the largest."""
    from deeplearning_cfn_tpu_torch.models.transformer import Dense
    from deeplearning_cfn_tpu_torch.models.transformer_nmt import (
        init_weights, transformer_nmt_tiny)
    from deeplearning_cfn_tpu_torch.serve import Engine

    def pair(seed, **kw):
        cpu = transformer_nmt_tiny(vocab_size=64, max_len=32, **kw)
        init_weights(cpu, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            for mod in cpu.modules():
                if isinstance(mod, Dense):
                    mod.weight.mul_(3.0)
        card = transformer_nmt_tiny(vocab_size=64, max_len=32,
                                    device=cuda, **kw)
        card.load_state_dict(cpu.state_dict())
        return cpu.requires_grad_(False), card.requires_grad_(False)

    target, draft = pair(0), pair(1, hidden_size=32, num_layers=1,
                                  num_heads=2)
    rng = np.random.default_rng(0)
    srcs = [[int(t) for t in rng.integers(3, 64, 2 + i % 6)] + [2]
            for i in range(8)]
    tokens, first = [], []
    for i in range(2):
        eng = Engine(target[i], capacity=4, max_src_len=8, kv_block_size=8,
                     decode_window=4, speculate_gamma=3,
                     speculate_device=True, draft_model=draft[i])
        ids = [eng.submit(s, max_new_tokens=6 + 2 * j).id
               for j, s in enumerate(srcs)]
        eng.run_until_drained()
        tokens.append([list(eng.poll(r).tokens) for r in ids])
        m = target[i]
        src = torch.tensor([s + [0] * (8 - len(s)) for s in srcs[:4]],
                           device=m.device)
        mask = (src != 0).long()
        tgt = torch.tensor([[1, 5, 9, 13]] * 4, device=m.device)
        with torch.no_grad():
            first.append(m.decode_span_at(
                tgt, m.encode(src, mask), mask,
                torch.tensor([0, 3, 28, 30], device=m.device),
                m.init_cache(4)).cpu())
    assert tokens[0] == tokens[1]
    assert len({tuple(t) for t in tokens[0]}) > 1
    assert (first[1] - first[0]).abs().max() <= 1e-4 * first[0].abs().max()


# -- ViT, the MoE trunks and Adafactor on the card ---------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vit_shape_kernels_match_plain_versions(cuda, dtype):
    """ViT-S/16's self-attention: [256, 6, 196, 64] (batch 16 in f32),
    neither causal nor biased, in the model's strided layout. 196 keys end
    every row in a partial 64-key tile and leave 4 rows in the last 64-row
    Q tile; O, lse, dK, dV and dQ against their plain versions."""
    b = 256 if dtype == torch.bfloat16 else 16
    rng = np.random.default_rng(196)
    args = _bwd_inputs(rng, (b, 6, 196, 196, 64, False, True), dtype, cuda)
    q, k, v, _, lse, _, _, scale = args
    variant = attn.forward_variant(dtype, 196, 64)
    assert variant == ("tc" if dtype == torch.bfloat16 else "simt")
    n = attn.flash_attention_forward.variant_launches[variant]
    out = attn.flash_attention_forward(q, k, v)
    assert attn.flash_attention_forward.variant_launches[variant] == n + 1
    ref = attn.attention_reference(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert scaled_error(out, ref)["ok"], scaled_error(out, ref)
    ref_lse = attn._reference_lse(q, k, None, False, scale)
    assert ((lse - ref_lse).abs() / ref_lse.abs().clamp_min(1.0)).max() \
        <= 1e-3
    bwd = attn.backward_variant(dtype, 64)
    before = (attn.flash_attn_bwd_dkdv.variant_launches[bwd],
              attn.flash_attn_bwd_dq.variant_launches[bwd])
    dk, dv = attn.flash_attn_bwd_dkdv(*args)
    dq = attn.flash_attn_bwd_dq(*args)
    assert (attn.flash_attn_bwd_dkdv.variant_launches[bwd],
            attn.flash_attn_bwd_dq.variant_launches[bwd]) == \
        (before[0] + 1, before[1] + 1)
    rk, rv = attn.flash_bwd_dkdv_reference(*args)
    rq = attn.flash_bwd_dq_reference(*args)
    for name, got, want in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        assert torch.isfinite(got).all(), name
        assert _close(got, want, BWD_TOL[dtype]), \
            (name, (got.float() - want.float()).abs().max().item())
        assert scaled_error(got, want)["ok"], (name, scaled_error(got, want))


def test_vit_tiny_f32_and_adafactor_on_card_match_cpu(cuda):
    """``chip_smoke.vit_parity``: the tiny f32 ViT's logits, loss and
    gradients on the card against the CPU, then 5 Adafactor steps on
    each."""
    from chip_smoke import vit_parity

    out = vit_parity(torch, attn)
    assert out["launches"] == {"fwd": 2, "dkdv": 2, "dq": 2, "vjp": 0}


def test_moe_tiny_f32_on_card_matches_cpu(cuda):
    """``chip_smoke.moe_parity``: the tiny f32 BERT-MoE and GPT-MoE on the
    card against the CPU — dispatch masks equal, loss and gradients, and
    GPT-MoE's greedy generation token-identical."""
    from chip_smoke import moe_parity

    out = moe_parity(torch, attn)
    assert out["bert_moe"]["dispatch_equal"]
    assert out["gpt_moe"]["dispatch_equal"]
    assert out["bert_moe"]["dropped_choices"] > 0


# -- train.step_window > 1: steps replayed from CUDA graphs ------------------


def _window_nmt(dtype, extra=()):
    """``cfg_of`` for ``chip_smoke.window_runs``: a tiny NMT (head dim 64,
    dropout 0.1)."""
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.presets import get_preset

    return lambda k: apply_overrides(get_preset("transformer_nmt_wmt"), [
        "model.kwargs.hidden_size=128", "model.kwargs.num_layers=2",
        "model.kwargs.num_heads=2", "model.kwargs.mlp_dim=256",
        "model.kwargs.dropout_rate=0.1", "data.vocab_size=256",
        "data.seq_len=32", "train.global_batch=8", f"train.dtype={dtype}",
        "train.seed=0", "schedule.warmup_steps=3", "schedule.base_lr=0.01",
        f"train.step_window={k}", *extra])


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_step_window_graphs_follow_the_eager_nmt(cuda, remat):
    """K = 1 eager steps against K = 4 windows replaying the captured step,
    from one seed, with dropout on and two microbatches (and, with remat,
    the recompute drawing from the capture's twin generators): the losses
    and weights agree to phase 24's f32 bound (the embedding backward's
    atomics reorder additions), and the launches per step are equal."""
    from chip_smoke import WINDOW_TOL, check_windows, window_runs

    runs = window_runs(torch, attn, _window_nmt("float32", [
        "train.grad_accum_steps=2", f"train.remat={str(remat).lower()}"]),
        8)
    out = check_windows("nmt_tiny", runs, WINDOW_TOL["float32"],
                        kernels=True)
    # Per microbatch: 6 forwards (run again by the recompute under remat),
    # 2 dK/dV and dQ for the decoder self-attentions, 4 reference VJPs.
    assert out["launches_per_step"] == {"fwd": 6 * 2 * (1 + remat),
                                        "dkdv": 2 * 2, "dq": 2 * 2,
                                        "vjp": 4 * 2}


def test_replays_count_their_launches(cuda):
    """A window of 4 (the eager warm-up step, the capture, three replays)
    counts the launches of 4 eager steps: each replay adds its graph's
    launches, the capture none; on the tc variant in bf16."""
    from deeplearning_cfn_tpu_torch.data.pipeline import (build_pipeline,
                                                          to_device)
    from deeplearning_cfn_tpu_torch.train import optim
    from deeplearning_cfn_tpu_torch.train.state import create_train_state
    from deeplearning_cfn_tpu_torch.train.task import Seq2SeqTask
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer

    cfg = _window_nmt("bfloat16")(4)
    task = Seq2SeqTask(cfg, cuda)
    task.init(torch.Generator(device=cuda).manual_seed(0))
    state = create_train_state(task.model, optim.build_optimizer(
        cfg.optimizer, optim.build_schedule(cfg.schedule, 9, 8), task.model))
    trainer = Trainer(cfg, task, cuda)
    batches = [to_device(b, cuda) for _, b in zip(range(4), build_pipeline(
        cfg.data, 8, seed=0).one_epoch())]
    before = attn.launch_counts()
    trainer.train_step(state, batches[0])
    torch.cuda.synchronize()
    one = attn.launch_counts()
    per_step = {n: {v: c - before[n][v] for v, c in by.items()}
                for n, by in one.items()}
    assert per_step["flash_attn_fwd"]["tc"] == 6
    assert per_step["flash_attn_bwd_dkdv"]["tc"] == 2
    metrics = trainer.window_step(state, batches)
    torch.cuda.synchronize()
    assert trainer.graphs is not None and not trainer.graphs.warming_up
    after = attn.launch_counts()
    assert {n: {v: c - one[n][v] for v, c in by.items()}
            for n, by in after.items()} == \
        {n: {v: 4 * c for v, c in by.items()} for n, by in per_step.items()}
    assert state.step == 5 and torch.isfinite(metrics["loss"]).all()


def test_no_collection_runs_during_a_capture(cuda, monkeypatch):
    """A graph destroyed during another's capture (a dead trainer's,
    collected from a reference cycle) invalidates the capture: the
    collector is off while a step is captured, and on again after."""
    import gc

    from chip_smoke import window_runs
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer

    body, seen = Trainer.step_body, []

    def watched(self, state, batch):
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
        return body(self, state, batch)

    monkeypatch.setattr(Trainer, "step_body", watched)
    window_runs(torch, attn, _window_nmt("float32"), 4)
    assert seen == [False] and gc.isenabled()


# -- int8 serving on the card -------------------------------------------------


def test_quant_layers_bf16_on_card_match_cpu_f32(cuda):
    """The bf16 ``QuantDense`` and ``QuantEmbed`` (lookup and ``attend``) on
    the card against the same layers in f32 on the CPU, each output on its
    own scale (``scaled_error``)."""
    from deeplearning_cfn_tpu_torch.models.transformer import (Dense,
                                                               QuantDense,
                                                               QuantEmbed)

    g = torch.Generator().manual_seed(0)
    dense = Dense(512, 2048, torch.float32)
    with torch.no_grad():
        dense.weight.normal_(0.0, 0.05, generator=g)
        dense.bias.normal_(0.0, 0.1, generator=g)
    emb = torch.nn.Embedding(1000, 512)
    with torch.no_grad():
        emb.weight.normal_(0.0, 0.02, generator=g)
    x = torch.randn(8, 16, 512, generator=g)
    ids = torch.randint(0, 1000, (8, 16), generator=g)
    cpu_d, cpu_e = QuantDense.from_dense(dense), QuantEmbed.from_embedding(emb)
    card_d = QuantDense.from_dense(dense).to(cuda)
    card_d.dtype = torch.bfloat16
    card_e = QuantEmbed.from_embedding(emb).to(cuda)
    assert card_d.weight.dtype == card_e.weight.dtype == torch.int8
    with torch.no_grad():
        pairs = [(card_d(x.to(cuda)), cpu_d(x)),
                 (card_e(ids.to(cuda)), cpu_e(ids)),
                 (card_e.attend(x.to(cuda, torch.bfloat16)),
                  cpu_e.attend(x))]
    assert pairs[0][0].dtype == torch.bfloat16
    for got, ref in pairs:
        err = scaled_error(got.float().cpu(), ref)
        assert err["ok"], err
    # The lookup is exact: int8 codes times an f32 scale on both.
    assert torch.equal(pairs[1][0].cpu(), pairs[1][1])


def _int8_pair(cuda):
    from deeplearning_cfn_tpu_torch.models.transformer import Dense
    from deeplearning_cfn_tpu_torch.models.transformer_nmt import (
        init_weights, transformer_nmt_tiny)

    cpu = transformer_nmt_tiny(vocab_size=64, max_len=32)
    init_weights(cpu, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for mod in cpu.modules():
            if isinstance(mod, Dense):
                mod.weight.mul_(3.0)
    card = transformer_nmt_tiny(vocab_size=64, max_len=32, device=cuda)
    card.load_state_dict(cpu.state_dict())
    return cpu.requires_grad_(False), card.requires_grad_(False)


@pytest.mark.parametrize("s", [1, 5], ids=["step", "span5"])
def test_int8_paged_write_on_card_matches_cpu(cuda, s):
    """The int8 pool's requantizing write and dequantizing gather, f32 on
    the card against the CPU from the same prior pool (spans past the
    table, an unbound entry, a row on the null block): codes within ±1,
    scales within 1e-5 relative, logits within 1e-3 of the largest."""
    models = _int8_pair(cuda)
    b, nb, bs = 4, 17, 8
    rng = np.random.default_rng(s)
    src = torch.from_numpy(rng.integers(3, 64, (b, 8)))
    tgt = torch.from_numpy(rng.integers(3, 64, (b, s)))
    pos = torch.tensor([6, 9, 29, 31])
    tables = torch.tensor([[1, 0, 0, 0], [0, 0, 0, 0], [6, 7, 8, 9],
                           [10, 11, 12, 13]])
    prior = [(torch.from_numpy(rng.integers(-127, 128, (nb, 4, bs, 16))
                               .astype(np.int8)) if j < 2 else
              torch.from_numpy(rng.uniform(0.01, 0.05, (nb, 4))
                               .astype(np.float32)))
             for j in range(4)]
    outs = []
    for m in models:
        dev = m.device
        cache = m.init_paged_cache(nb, bs, kv_quant="int8")
        for layer in cache:
            for t, p in zip(layer, prior):
                t.copy_(p)
        mask = torch.ones_like(src)
        with torch.no_grad():
            logits = m.decode_span_paged(
                tgt.to(dev), m.encode(src.to(dev), mask.to(dev)),
                mask.to(dev), pos.to(dev), tables.to(dev), cache)
        outs.append((logits.cpu(), [[t.cpu() for t in layer]
                                    for layer in cache]))
    (ref, ref_cache), (got, got_cache) = outs
    assert (got - ref).abs().max() <= 1e-3 * ref.abs().max()
    for ref_layer, got_layer in zip(ref_cache, got_cache):
        for j, (r, g) in enumerate(zip(ref_layer, got_layer)):
            if j < 2:
                assert (r.int() - g.int()).abs().max() <= 1
            else:
                assert ((r - g).abs() <= 1e-5 * r.abs()).all()


def test_int8_engine_tiny_f32_on_card_matches_cpu(cuda):
    """A tiny f32 engine with int8 weights and the int8 KV pool (paged,
    window 4, beams) on the card against the CPU: identical tokens."""
    from deeplearning_cfn_tpu_torch.serve import Engine

    models = _int8_pair(cuda)
    rng = np.random.default_rng(1)
    srcs = [[int(t) for t in rng.integers(3, 64, 2 + i % 6)] + [2]
            for i in range(8)]
    tokens = []
    for m in models:
        eng = Engine(m, capacity=4, max_src_len=8, kv_block_size=8,
                     decode_window=4, quantize="int8", kv_quant="int8")
        ids = [eng.submit(s, max_new_tokens=6 + 2 * j,
                          beam_size=2 if j % 4 == 3 else 1).id
               for j, s in enumerate(srcs)]
        eng.run_until_drained()
        assert eng.allocator.blocks_in_use == 0
        tokens.append([list(eng.poll(r).tokens) for r in ids])
    assert tokens[0] == tokens[1]
    assert len({tuple(t) for t in tokens[0]}) > 1


def test_two_processes_launch_the_kernels_and_match_one(cuda, tmp_path):
    """Two gloo processes sharing the card, each on its half of every
    global batch: every rank launches the forward and both backward kernels
    in its steps, and the summed losses equal one process's on the whole
    batches within 1e-5 relative (f32, TF32 off: the sums change order
    only)."""
    import os

    import chip_smoke as cs
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.presets import get_preset

    over = ["model.kwargs.hidden_size=128", "model.kwargs.num_layers=2",
            "model.kwargs.num_heads=2", "model.kwargs.mlp_dim=256",
            "model.kwargs.dropout_rate=0.0", "data.vocab_size=512",
            "data.seq_len=32", "train.dtype=float32", "train.seed=0",
            "train.global_batch=16", "data.num_train_examples=256",
            "schedule.warmup_steps=2", "schedule.base_lr=1e-3"]
    cfg = apply_overrides(get_preset("transformer_nmt_wmt"), over)
    batches = cs.dp_batches(cfg, 3)
    path = str(tmp_path / "batches.npz")
    cs.save_batches(path, batches)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    ranks = cs.spawn_dp_workers(str(tmp_path), "dp", dict(
        mode="fed", preset="transformer_nmt_wmt", overrides=over,
        batches=path))
    for rank in ranks:
        assert all(n > 0 for n in rank["launches"].values()), rank
        assert rank["losses"] == ranks[0]["losses"]
    want, _ = cs.fed_run(torch, cfg, batches, "cuda")
    np.testing.assert_allclose(ranks[0]["losses"], want, rtol=1e-5)


# -- the long-context trunks ---------------------------------------------------


@pytest.mark.parametrize("case", [(1, 12, 4096, False), (1, 2, 16384, True)],
                         ids=["bert_long_4096", "gpt_long_16384"])
def test_long_rows_match_plain_versions(cuda, case):
    """The three kernels (tc) at the long trunks' rows: 64 KV tiles of 64
    keys, or 256 with the causal tile skip and the heaviest-tiles-first
    order over 256 query tiles, in the model's strided layout; O, the lse
    and dK, dV, dQ against the plain versions on their own scale. Heads are
    cut (12 at 16384 keys would be
    12.9 GB per S x S matrix in the plain version)."""
    b, h, s, causal = case
    rng = np.random.default_rng(s)
    args = _bwd_inputs(rng, (b, h, s, s, 64, causal, True), torch.bfloat16,
                       cuda)
    q, k, v = args[:3]
    n = attn.flash_attention_forward.variant_launches["tc"]
    out, lse = attn.flash_attention_forward(q, k, v, causal=causal,
                                            return_lse=True)
    assert attn.flash_attention_forward.variant_launches["tc"] == n + 1
    ref = attn.attention_reference(q, k, v, causal=causal)
    ref_lse = attn._reference_lse(q, k, None, causal, 1.0 / 8.0)
    assert scaled_error(out, ref)["ok"], scaled_error(out, ref)
    assert ((lse - ref_lse).abs() / ref_lse.abs().clamp_min(1.0)).max() \
        <= 1e-3
    del out, ref
    before = (attn.flash_attn_bwd_dkdv.variant_launches["tc"],
              attn.flash_attn_bwd_dq.variant_launches["tc"])
    got = attn.flash_attn_bwd_dkdv(*args) + (attn.flash_attn_bwd_dq(*args),)
    assert (attn.flash_attn_bwd_dkdv.variant_launches["tc"],
            attn.flash_attn_bwd_dq.variant_launches["tc"]) == \
        (before[0] + 1, before[1] + 1)
    want = attn.flash_bwd_dkdv_reference(*args) \
        + (attn.flash_bwd_dq_reference(*args),)
    for name, a, r in zip(("dk", "dv", "dq"), got, want):
        assert scaled_error(a, r)["ok"], (name, scaled_error(a, r))


_LONG_TINY = ["model.kwargs.hidden_size=64", "model.kwargs.num_layers=2",
              "model.kwargs.num_heads=4", "model.kwargs.mlp_dim=128",
              "model.kwargs.max_len=64", "data.vocab_size=512",
              "data.seq_len=64", "train.dtype=float32",
              "data.num_train_examples=32", "schedule.warmup_steps=1",
              "schedule.base_lr=1e-3", "train.global_batch=8",
              "train.seed=0"]


@pytest.mark.parametrize("preset", ["bert_long_wikipedia", "gpt_long_lm"])
def test_long_tiny_f32_on_card_matches_cpu(cuda, preset):
    """The tiny f32 long trunk (head dim 16) through its task on the card
    against the CPU, TF32 off: the loss within 1e-5 relative, every
    gradient within 1e-4 of the global norm, the three kernels once per
    layer."""
    import chip_smoke as cs
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.data.pipeline import (build_pipeline,
                                                          to_device)
    from deeplearning_cfn_tpu_torch.presets import get_preset
    from deeplearning_cfn_tpu_torch.train.task import CausalLmTask, MlmTask

    cfg = apply_overrides(get_preset(preset), _LONG_TINY)
    task_cls = MlmTask if preset.startswith("bert") else CausalLmTask
    cpu, card = cs._card_and_cpu(torch, task_cls, cfg)
    batch = next(iter(build_pipeline(cfg.data, 4, cfg.model.num_classes,
                                     seed=0).one_epoch()))
    ref, _ = cpu.loss_fn(to_device(batch, torch.device("cpu")), True)
    ref.backward()
    before = cs.counts(attn)
    got, _ = card.loss_fn(to_device(batch, cuda), True)
    got.backward()
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in cs.counts(attn).items()}
    assert launched == {"fwd": 2, "dkdv": 2, "dq": 2, "vjp": 0}
    assert abs(float(got) - float(ref)) <= 1e-5 * abs(float(ref))
    assert cs._grad_check(preset, cpu.model, card.model) <= 1e-4


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_seq_two_processes_on_card_match_one(cuda, impl, tmp_path):
    """Two gloo processes sharing the card on a ``(data=1, seq=2)`` mesh,
    each its half of every row: the tiny f32 ``gpt_long`` with ``impl``
    matches one process on the same global batches within 1e-5 relative
    (f32, TF32 off: the exchanged slices change the sums' order only); with
    Ulysses each process launches the three kernels in its steps."""
    import os

    import chip_smoke as cs
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.presets import get_preset

    over = _LONG_TINY + [f"model.kwargs.seq_impl={impl}", "mesh.seq=2"]
    cfg = apply_overrides(get_preset("gpt_long_lm"), over)
    batches = cs.dp_batches(cfg, 3, ranks=1)
    path = str(tmp_path / "batches.npz")
    cs.save_batches(path, batches)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    ranks = cs.spawn_dp_workers(str(tmp_path), "seq", dict(
        mode="fed", preset="gpt_long_lm", overrides=over, batches=path,
        comm=True))
    for rank in ranks:
        assert rank["losses"] == ranks[0]["losses"]
        assert rank["comm_calls"].get(impl, 0) > 0
        if impl == "ulysses":
            assert all(n > 0 for n in rank["launches"].values()), rank
    torch.backends.cuda.matmul.allow_tf32 = False
    want, _ = cs.fed_run(torch, cfg, batches, "cuda")
    np.testing.assert_allclose(ranks[0]["losses"], want, rtol=1e-5)
