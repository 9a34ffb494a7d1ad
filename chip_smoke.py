#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit. It imports only torch, numpy, the standard library and the port
(``deeplearning_cfn_tpu_torch``) — never JAX or the JAX package. Phases, in
order; a failing phase raises, so the exit code is nonzero:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of the path from ``csrc/`` (one ``nvcc`` per source,
   in parallel) and print the build seconds;
3. hold the flash-attention kernel against its plain PyTorch version on the
   card: the serving path's three shapes at 8 slots, contiguous and in the
   model's strided [B,S,H,D] layout, plus causal, ragged Sq != Sk, the
   boundaries of the bf16 variants (Sq 15/16/65, head dims 16 and 128) and
   the lse output; f32 within 1e-4, bf16 within 2e-2 (absolute); each bf16
   call must take the variant ``forward_variant`` names (tc or decode on
   the main path's shapes);
4. time each of the three shapes: the kernel, the first port's kernel
   body on the same inputs (the ``simt`` variant, the CUDA-core kernel
   before the tensor-core redesign: ``*_before``), the plain version and one
   ``scaled_dot_product_attention`` call (a yardstick only; the port never
   calls it) with CUDA events over back-to-back calls (``ms``,
   ``kernel_ms_before``, ``plain_ms``, ``library_ms``: the host's time
   included, as the first timings were taken), and all but the plain
   version by their device time per call (``device_ms``,
   ``device_ms_before``, ``library_device_ms``: torch.profiler's kernel
   rows; the kernel also in the model's strided layout,
   ``device_ms_strided``), beside the byte/operation bound;
5. serve: ``load_engine`` on the ``transformer_nmt_wmt`` preset at full
   width (seeded random init, seed 0, bf16), 8 slots, paged KV blocks of
   16, decode window 4, prefix cache 32; 24 seeded requests (sources of 8
   to 120 tokens, 32 new tokens, 4 of them beam 4), drained. Every request
   must be done, the kernel's launch count over this phase must equal
   6 per encoder forward plus 12 per decoder step, as the engine tallied,
   and every one of those bf16 launches must have taken the tc or decode
   variant (none the CUDA-core simt kernel);
6. the same engine in f32 through the kernel and through the plain
   version: the first decode step's logits agree within 1e-3, and the
   number of token-identical greedy requests is printed;
7. hold the backward kernels (dK/dV, dQ) against their plain versions on
   the card — the training shape, causal and not, ragged Sq != Sk (37/101),
   lengths off the tile, head dims 16 and 128, f32 within 5e-4 and bf16
   within 5e-2 (absolute + relative, the tolerances of tests/test_ops.py's
   flash backward tests; the tc variants' 64-row Q tiles end at Sq
   63/64/65 and 127/128/129, keys off the 64-key tile, strided views
   included, every bf16 launch of both kernels on the variant
   ``backward_variant`` names) — and the autograd Function's (dq, dk, dv)
   against ``torch.autograd.grad`` of ``attention_reference``; rows that saw
   no key (lse = +1e30) must get a dQ of exactly 0 on the tc variant, and
   two backward calls must be bit-identical;
8. time, as phase 4 does, at the training shape (q/k/v/dO [128, 8, 128,
   64] bf16, causal) the forward kernel with lse, dK/dV and dQ, beside
   each one's simt body, their plain versions, their byte/operation
   bounds and, as a yardstick the port never calls,
   ``scaled_dot_product_attention`` forward and backward;
9. train ``transformer_nmt_wmt`` at full width in bf16 through
   ``train.run.run_experiment``: global batch 128, dropout 0.1, label
   smoothing 0.1, AdamW + rsqrt with warmup 10 and base lr 1e-3 (peak
   3.2e-4; the schedule clamps warmup to steps - 1, so in a 30-step run the
   preset's base lr 1.0 would peak at 0.19 and diverge), 30 steps, then the
   eval loss and BLEU on 128 eval examples (decode length 32).
   Every loss must be finite, the mean of the last 5 below the mean of the
   first 5, and the launch counts over the 30 steps exactly 18 forward,
   6 dK/dV, 6 dQ and 12 reference-VJP recomputes per microbatch step,
   every forward, dK/dV and dQ launch on its tc variant;
10. f32 gradient parity at full width (batch 16): one train step from the
   same init and dropout seed through the kernels and through the plain
   attention — losses within 1e-5 relative, every parameter's gradient
   within 1e-3 of its norm (floored at 1e-4 of the largest gradient norm:
   the key biases' true gradient is 0), and every attention projection's
   gradient present and nonzero.

11. train ``imagenet_resnet50`` at full width in bf16 through
   ``train.run.run_experiment`` (224² images, the 7×7/s2 stem, [3, 4, 6, 3]
   bottlenecks, 1000 classes, LARS + cosine, label smoothing 0.1) on
   synthetic ImageNet: global batch 256, 2 warm-up steps then 30 timed,
   each step synced (log every step). Cuts, printed by the phase: batch 256
   for the preset's 8192 (the lr follows the preset's ``scale_with_batch``
   rule), 1024 train examples for 8192, warmup scaled to the step count,
   eval on 512 examples. It prints step time p50 and images/s p50 (host
   clock), the MFU share (images/s × 3 × the forward FLOPs counted from
   the model's conv and Dense shapes, over 989 TFLOP/s), the peak memory,
   the loss (first-5 and last-5 means, which must fall), eval top-1 and
   top-5, and asserts that every parameter and buffer is on the card, the
   activations are channels_last, the running statistics finite and moved.
   It then measures the host's feed rate of the sharded ImageNet source
   through the C++ ``dataio`` loader (1024 synthetic u8 256² images written
   by ``write_shards``, batch 256) against the card's images/s. The ResNet
   launches none of the three kernels; the counts stay as phase 9 left them;
12. f32 ``cifar10_resnet20`` at full width (batch 128) on the card against
   the CPU, from one seeded init and the same 3 host batches (TF32 off, as
   the trainer sets it for an f32 run): losses within 1e-4 relative, every
   gradient within 1e-5 of the global gradient norm, running statistics
   within 1e-5.

``python3 chip_smoke.py --profile`` instead profiles steady greedy decode
ticks, ``--profile-train`` steady full-width bf16 NMT train steps, and
``--profile-resnet`` steady full-width bf16 ResNet-50 train steps (batch
256): host time against device-busy time, device ops per step, kernels
ranked and, for the ResNet, device time by kind (convolutions forward /
data-gradient / weight-gradient, elementwise and reductions — BatchNorm's
share —, copies and casts, the optimizer); none prints a result line.

The line before the last is the kernels JSON line; the last line is
``{"ok": true, "device": {...}}``. Without a card, or outside a checkout,
it exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"                 # the card every phase runs on
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
SLOTS, SRC_LEN, HEADS, HEAD_DIM = 8, 128, 8, 64
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
BWD_TOL = {"float32": 5e-4, "bfloat16": 5e-2}
TRAIN_BATCH, TRAIN_STEPS, PARITY_BATCH = 128, 30, 16
# Attention calls per microbatch step of the NMT model (6+6 layers): the
# forward kernel for every call; the backward kernels for the 6 bias-free
# causal decoder self-attentions; the reference VJP for the 6 encoder
# self-attentions and 6 cross-attentions (padding bias).
PER_STEP = {"fwd": 18, "dkdv": 6, "dq": 6, "vjp": 12}
# Phase 11: ResNet-50 at full width, bf16.
RESNET_BATCH, RESNET_WARMUP, RESNET_STEPS = 256, 2, 30
RESNET_CUTS = ["train.global_batch=256 (preset 8192, a 128-chip batch; lr "
               "by the preset's scale_with_batch rule)",
               "data.num_train_examples=1024 (preset 8192: 4.9 GB of f32 "
               "on the host)",
               "schedule.warmup_steps=2 (the preset's 5 of 90 epochs, "
               "scaled to 32 steps)",
               "eval on 512 examples"]
FEED_IMAGES, FEED_STORED, FEED_OUT = 1024, 256, 224
# Phase 12: ResNet-20 f32, card against CPU.
CIFAR_BATCH, CIFAR_STEPS = 128, 3


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str):
    log(f"== {name}")
    return time.perf_counter()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


# (name, Sq, bias?) of the three attention calls of the serving path at 8
# slots: encoder self-attention, decode cross-attention, decode
# self-attention over the gathered paged span (per-row step bias).
MAIN_PATH_SHAPES = [("encoder_self", SRC_LEN, True),
                    ("decode_cross", 1, True),
                    ("decode_self_paged", 1, True)]


def make_inputs(torch, seed, b, h, sq, sk, d, dtype, bias_kind,
                causal=False, strided=False):
    """q, k, v [b, h, s, d] (``strided``: the model's layout, a [b, s, h, d]
    tensor seen through ``transpose(1, 2)``) and an optional padding bias."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def mk(s):
        shape = (b, s, h, d) if strided else (b, h, s, d)
        x = torch.randn(shape, generator=g, device=DEVICE,
                        dtype=torch.float32).to(dtype)
        return x.transpose(1, 2) if strided else x

    q, k, v = mk(sq), mk(sk), mk(sk)
    bias = None
    if bias_kind:
        # A padding/step bias [b, 1, 1, sk]: row i keeps its first
        # lengths[i] keys; without causal the last row is all masked (an
        # all-PAD slot — see csrc/flash_attn_fwd.cu on causal + all-masked).
        lengths = torch.randint(1, sk + 1, (b,), generator=g, device=DEVICE)
        if not causal:
            lengths[-1] = 0
        keys = torch.arange(sk, device=DEVICE)
        bias = torch.where(keys[None, :] < lengths[:, None], 0.0, -1e30)
        bias = bias.float()[:, None, None, :]
    return q, k, v, bias


def check_kernel(torch, attn):
    """Phase 3: kernel vs plain version on the card. Returns max errors."""
    errs = {"float32": 0.0, "bfloat16": 0.0}
    cases = [(name, SLOTS, HEADS, sq, SRC_LEN, HEAD_DIM, False, bias, False)
             for name, sq, bias in MAIN_PATH_SHAPES]
    cases += [(name + "_strided", SLOTS, HEADS, sq, SRC_LEN, HEAD_DIM, False,
               bias, True) for name, sq, bias in MAIN_PATH_SHAPES]
    cases += [("train_strided", 4, HEADS, SRC_LEN, SRC_LEN, HEAD_DIM, True,
               False, True),
              ("causal", 2, 4, 96, 96, 64, True, False, False),
              ("ragged_causal", 2, 4, 37, 101, 64, True, False, False),
              ("ragged_bias", 3, 2, 45, 77, 64, False, True, False),
              ("decode_15", 2, 4, 15, 77, 64, True, False, False),
              ("tc_16", 2, 4, 16, 101, 64, False, True, False),
              ("tc_65", 2, 4, 65, 101, 64, True, False, True),
              ("head_dim_16", 2, 3, 50, 70, 16, False, True, False),
              ("head_dim_128", 2, 2, 33, 65, 128, True, True, False),
              ("head_dim_128_decode", 2, 2, 1, 65, 128, False, True, True)]
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        for i, (name, b, h, sq, sk, d, causal, bias_kind, strided) in \
                enumerate(cases):
            q, k, v, bias = make_inputs(torch, 100 + i, b, h, sq, sk, d,
                                        dtype, bias_kind, causal, strided)
            variant = attn.forward_variant(dtype, sq, d)
            before = attn.flash_attention_forward.variant_launches[variant]
            out, lse = attn.flash_attention_forward(q, k, v, bias, causal,
                                                    return_lse=True)
            torch.cuda.synchronize()
            if attn.flash_attention_forward.variant_launches[variant] \
                    != before + 1:
                raise AssertionError(f"{name}: not launched as {variant}")
            ref = attn.attention_reference(q, k, v, bias, causal)
            err = (out.float() - ref.float()).abs().max().item()
            ref_lse = attn._reference_lse(q, k, bias, causal,
                                          1.0 / math.sqrt(d))
            lse_err = ((lse - ref_lse).abs()
                       / ref_lse.abs().clamp_min(1.0)).max().item()
            ok = err <= TOL[dtype_name] and lse_err <= 1e-3 \
                and bool(torch.isfinite(out).all())
            log(f"  {dtype_name:8s} {name:24s} [{b},{h},{sq},{sk},{d}] "
                f"causal={causal} {variant:6s} max_abs_err={err:.3e} "
                f"lse_rel_err={lse_err:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(
                    f"flash kernel disagrees with its plain version: "
                    f"{dtype_name} {name} err={err} lse_err={lse_err}")
            errs[dtype_name] = max(errs[dtype_name], err)
    return errs


def time_fn(torch, fn, iters=200, warmup=20):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters=50, warmup=5):
    """Device time per call: the summed duration of every kernel the call
    launched (torch.profiler's CUDA rows, kernels only), over ``iters``
    calls. Unlike ``time_fn`` it leaves out the host's time between
    launches, which at the serving shapes is most of a call. A profiler
    session now and then records no device activity at all; such a
    session is run again, up to three times in all."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = kernel_rows(prof)
        if events:
            return sum(dev_time(e) for e in events) / iters / 1e3
        log(f"  (profiler session {attempt + 1} saw no device time)")
    raise AssertionError("three profiler sessions saw no device time")


def dev_time(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def kernel_rows(prof):
    """The profile's kernel rows. An operator's, autograd Function's or
    annotated range's row (the optimizer step is one, on the device timeline
    too) repeats the device time of the kernels it launched, which have rows
    of their own."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if dev_time(e) > 0 and e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def time_row(torch, kernel, strided, before, plain, library, iters, warmup,
             plain_iters, plain_warmup):
    """One timing row: CUDA events over back-to-back calls (``*_ms``, the
    host's time included where it is the slower side) and device times
    (``*device_ms*``) of the kernel, of the first port's kernel body on the
    same inputs (``before``: the ``simt`` variant, the CUDA-core kernel
    before the tensor-core redesign), and of the library call; events of the plain version; device time
    of the kernel on the model's strided layout."""
    return dict(
        kernel_ms=time_fn(torch, kernel, iters, warmup),
        kernel_ms_before=time_fn(torch, before, iters, warmup),
        plain_ms=time_fn(torch, plain, plain_iters, plain_warmup),
        library_ms=time_fn(torch, library, iters, warmup),
        device_ms=device_ms(torch, kernel, iters, warmup),
        device_ms_strided=device_ms(torch, strided, iters, warmup),
        device_ms_before=device_ms(torch, before, iters, warmup),
        library_device_ms=device_ms(torch, library, iters, warmup))


def bound_ms(b, h, sq, sk, d, elem_bytes, bias):
    """Least time for one call: each input read once and the output written
    once over HBM bandwidth, vs QKᵀ and PV operations over the peak rate."""
    nbytes = elem_bytes * (b * h * sq * d + 2 * b * h * sk * d
                           + b * h * sq * d)
    if bias is not None:
        nbytes += 4 * bias.numel()
    flops = 4.0 * b * h * sq * sk * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def time_kernel(torch, attn):
    """Phase 4: kernel / plain / library times at the three shapes (bf16,
    the serving dtype)."""
    F = torch.nn.functional
    rows = []
    for i, (name, sq, bias_kind) in enumerate(MAIN_PATH_SHAPES):
        q, k, v, bias = make_inputs(torch, 200 + i, SLOTS, HEADS, sq,
                                    SRC_LEN, HEAD_DIM, torch.bfloat16,
                                    bias_kind)
        qs, ks, vs, _ = make_inputs(torch, 200 + i, SLOTS, HEADS, sq,
                                    SRC_LEN, HEAD_DIM, torch.bfloat16,
                                    bias_kind, strided=True)
        lib_mask = None if bias is None else bias.to(torch.bfloat16)
        # (Timing launches are comparisons, not the main path's: the counts
        # are set to 0 before phase 5.)
        t = time_row(
            torch, lambda: attn.flash_attention_forward(q, k, v, bias),
            lambda: attn.flash_attention_forward(qs, ks, vs, bias),
            lambda: attn._launch(q, k, v, bias, False, HEAD_DIM ** -0.5,
                                 False, "simt"),
            lambda: attn.attention_reference(q, k, v, bias),
            lambda: F.scaled_dot_product_attention(q, k, v,
                                                   attn_mask=lib_mask),
            200, 20, 200, 20)
        b_ms, by, nbytes, flops = bound_ms(SLOTS, HEADS, sq, SRC_LEN,
                                           HEAD_DIM, 2, bias)
        row = dict(shape=name, q=[SLOTS, HEADS, sq, HEAD_DIM],
                   kv=[SLOTS, HEADS, SRC_LEN, HEAD_DIM], dtype="bfloat16",
                   variant=attn.forward_variant(torch.bfloat16, sq,
                                                HEAD_DIM),
                   **t, bound_ms=b_ms, bound_by=by, bytes=nbytes,
                   flops=flops)
        log_times(name, row)
        rows.append(row)
    return rows


def log_times(name, row):
    us = {k: v * 1e3 for k, v in row.items() if "_ms" in k}
    log(f"  {name:20s} {row['variant']:6s} per call (events): kernel "
        f"{us['kernel_ms']:8.2f} us (simt {us['kernel_ms_before']:8.2f})  "
        f"plain {us['plain_ms']:8.2f}  library {us['library_ms']:7.2f}; "
        f"device time: kernel {us['device_ms']:7.2f} (strided "
        f"{us['device_ms_strided']:7.2f}, simt {us['device_ms_before']:7.2f})"
        f"  library {us['library_device_ms']:7.2f}; bound "
        f"{us['bound_ms']:6.3f} ({row['bound_by']})")


def make_requests(n=24, n_beam=4, vocab=32000, seed=0):
    import numpy as np

    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        length = int(rng.randint(8, 121))
        src = [int(t) for t in rng.randint(3, vocab, size=length - 1)] + [2]
        beam = 4 if i % (n // n_beam) == n // n_beam - 1 else 1
        reqs.append((f"r{i}", src, 32, beam))
    return reqs


def smoke_cfg(dtype: str):
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.presets import get_preset

    # The workdir holds no checkpoint: the engine serves a seeded init.
    nowhere = os.path.join(REPO, "deeplearning_cfn_tpu_torch", "_build",
                           "no_checkpoint")
    return apply_overrides(get_preset("transformer_nmt_wmt"),
                           [f"workdir={nowhere}", f"train.dtype={dtype}",
                            "train.seed=0"])


def build_engine(cfg, attention_impl=None):
    from deeplearning_cfn_tpu_torch.serve.loader import load_engine

    engine, _, at_step = load_engine(
        cfg, capacity=SLOTS, max_src_len=SRC_LEN, decode_window=4,
        kv_block_size=16, prefix_cache_size=32, allow_init=True,
        device="gpu", attention_impl=attention_impl)
    assert at_step == -1
    return engine


def serve(torch, attn, reqs):
    """Phase 5: the main path, with every launch count set to 0 first."""
    set_counts(attn, 0)
    t_build = time.perf_counter()
    engine = build_engine(smoke_cfg("bfloat16"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rid, src, budget, beam in reqs:
        engine.submit(src, max_new_tokens=budget, beam_size=beam,
                      request_id=rid)
    ticks = engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = attn.flash_attention_forward.launches
    variants = dict(attn.flash_attention_forward.variant_launches)
    model = engine.model
    states = {rid: engine.poll(rid).state.value for rid, *_ in reqs}
    bad = {r: s for r, s in states.items() if s != "done"}
    if bad:
        raise AssertionError(f"requests not done: {bad}")
    tokens = {rid: list(engine.poll(rid).tokens) for rid, *_ in reqs}
    for rid, toks in tokens.items():
        if not toks or any(not 0 <= t < model.vocab_size for t in toks):
            raise AssertionError(f"{rid}: bad tokens {toks}")
    expect = (model.num_layers * engine.encoder_forwards
              + 2 * model.num_layers * engine.decoder_steps)
    log(f"  model: vocab {model.vocab_size}, hidden {model.hidden_size}, "
        f"{model.num_layers}+{model.num_layers} layers, {model.num_heads} "
        f"heads, max_len {model.max_len}, {model.dtype}; engine built in "
        f"{t0 - t_build:.2f} s")
    log(f"  {len(reqs)} requests done in {ticks} ticks, {wall:.3f} s; "
        f"encoder forwards {engine.encoder_forwards}, decoder steps "
        f"{engine.decoder_steps}; flash launches {launches} (expected "
        f"{model.num_layers}*{engine.encoder_forwards} + "
        f"{2 * model.num_layers}*{engine.decoder_steps} = {expect})")
    if launches <= 0 or launches != expect:
        raise AssertionError(
            f"flash kernel launches {launches} != expected {expect}")
    log(f"  launches by variant: {variants}")
    if variants["simt"] or variants["tc"] + variants["decode"] != launches:
        raise AssertionError(f"bf16 serving launches off the tc/decode "
                             f"variants: {variants}")
    snap = engine.metrics.snapshot()
    generated = sum(len(t) for t in tokens.values())
    step_ms = snap["serve_step_latency_p50_s"] * 1e3
    log(f"  tokens/s {generated / wall:.1f} ({generated} tokens), TTFT p50 "
        f"{snap['serve_ttft_p50_s'] * 1e3:.2f} ms, decode-step p50 "
        f"{step_ms:.3f} ms, slot occupancy {snap['serve_slot_occupancy']}")
    return dict(launches=launches, variant_launches=variants,
                encoder_forwards=engine.encoder_forwards,
                decoder_steps=engine.decoder_steps, wall_s=wall,
                tokens=generated, tokens_per_s=generated / wall,
                ttft_p50_s=snap["serve_ttft_p50_s"],
                decode_step_p50_ms=step_ms)


def f32_parity(torch, reqs):
    """Phase 6: f32 engine through the kernel vs through the plain
    version — first decode step logits, then greedy tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = smoke_cfg("float32")
    engines = {impl: build_engine(cfg, impl)
               for impl in ("kernel", "reference")}
    greedy = [r for r in reqs if r[3] == 1]
    src = torch.zeros((SLOTS, SRC_LEN), dtype=torch.long, device="cuda")
    for i, (_, ids, _, _) in enumerate(greedy[:SLOTS]):
        src[i, :len(ids)] = torch.tensor(ids, device="cuda")
    mask = (src != 0).long()
    pos = torch.zeros((SLOTS,), dtype=torch.long, device="cuda")
    bos = torch.ones((SLOTS, 1), dtype=torch.long, device="cuda")
    logits = {}
    with torch.no_grad():
        for impl, eng in engines.items():
            model = eng.model
            enc = model.encode(src, mask)
            logits[impl] = model.decode_step_at(
                bos, enc, mask, pos, model.init_cache(SLOTS))
    err = (logits["kernel"] - logits["reference"]).abs().max().item()
    log(f"  first decode step logits, kernel vs plain (f32): max abs diff "
        f"{err:.3e}")
    if not err <= 1e-3:
        raise AssertionError(f"f32 logits differ by {err} > 1e-3")
    outs = {}
    for impl, eng in engines.items():
        for rid, ids, budget, _ in greedy:
            eng.submit(ids, max_new_tokens=budget, request_id=rid)
        eng.run_until_drained()
        outs[impl] = {rid: list(eng.poll(rid).tokens)
                      for rid, *_ in greedy}
    same = sum(outs["kernel"][r] == outs["reference"][r] for r in outs[
        "kernel"])
    log(f"  greedy requests token-identical, kernel vs plain (f32): "
        f"{same}/{len(greedy)}")
    return err, same, len(greedy)


# -- training slice: backward kernels, their timing, the train path --------

TRAIN_SHAPE = (TRAIN_BATCH, HEADS, SRC_LEN, SRC_LEN, HEAD_DIM)


def close_enough(got, ref, tol):
    """|got - ref| <= tol + tol * |ref| everywhere (absolute + relative)."""
    got, ref = got.float(), ref.float()
    return bool(((got - ref).abs() <= tol + tol * ref.abs()).all())


def bwd_inputs(torch, attn, seed, b, h, sq, sk, d, dtype, causal,
               strided=False):
    q, k, v, _ = make_inputs(torch, seed, b, h, sq, sk, d, dtype, False,
                             strided=strided)
    g = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    do = torch.randn((b, sq, h, d) if strided else (b, h, sq, d),
                     generator=g, device=DEVICE).to(dtype)
    if strided:  # the gradient _merge hands back: a transposed view
        do = do.transpose(1, 2)
    out, lse = attn.flash_attention_forward(q, k, v, causal=causal,
                                            return_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    return q, k, v, do, lse, delta, causal, 1.0 / math.sqrt(d)


def check_backward(torch, attn):
    """Phase 7: the backward kernels and the autograd Function vs their
    plain versions on the card. Returns max abs errors per kernel."""
    errs = {"flash_attn_bwd_dkdv": 0.0, "flash_attn_bwd_dq": 0.0}
    cases = [("train_causal", *TRAIN_SHAPE, True, False),
             ("train_strided", *TRAIN_SHAPE, True, True),
             ("train_full", 8, HEADS, SRC_LEN, SRC_LEN, HEAD_DIM, False,
              False),
             ("ragged_causal", 2, 3, 37, 101, 64, True, False),
             ("ragged", 2, 3, 37, 101, 64, False, False),
             ("q_rows_1", 4, 8, 1, 128, 64, False, True),
             ("q_rows_63", 2, 3, 63, 63, 64, False, False),
             ("q_rows_64", 2, 3, 64, 100, 128, True, False),
             ("q_rows_65", 2, 3, 65, 77, 64, True, True),
             ("q_rows_127", 2, 3, 127, 129, 64, True, True),
             ("q_rows_129", 2, 3, 129, 200, 128, False, False),
             ("q_rows_129_causal", 2, 3, 129, 150, 64, True, False),
             ("off_tile_d16", 3, 2, 45, 45, 16, True, False),
             ("d16_ragged", 2, 2, 50, 70, 16, False, False),
             ("d128", 2, 2, 33, 65, 128, False, False),
             ("d128_causal", 1, 2, 70, 70, 128, True, False)]
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        tol = BWD_TOL[dtype_name]
        for i, (name, b, h, sq, sk, d, causal, strided) in enumerate(cases):
            args = bwd_inputs(torch, attn, 300 + i, b, h, sq, sk, d, dtype,
                              causal, strided)
            variant = attn.backward_variant(dtype, d)
            before = {fn: fn.variant_launches[variant] for fn in (
                attn.flash_attn_bwd_dkdv, attn.flash_attn_bwd_dq)}
            dk, dv = attn.flash_attn_bwd_dkdv(*args)
            dq = attn.flash_attn_bwd_dq(*args)
            torch.cuda.synchronize()
            for fn, n in before.items():
                if fn.variant_launches[variant] != n + 1:
                    raise AssertionError(f"{name}: {fn.__name__} not "
                                         f"launched as {variant}")
            rk, rv = attn.flash_bwd_dkdv_reference(*args)
            rq = attn.flash_bwd_dq_reference(*args)
            line = []
            for kname, pairs in (("flash_attn_bwd_dkdv", ((dk, rk), (dv, rv))),
                                 ("flash_attn_bwd_dq", ((dq, rq),))):
                for got, ref in pairs:
                    err = (got.float() - ref.float()).abs().max().item()
                    errs[kname] = max(errs[kname], err)
                    line.append(err)
                    if not (close_enough(got, ref, tol)
                            and bool(torch.isfinite(got).all())):
                        raise AssertionError(
                            f"{kname} disagrees with its plain version: "
                            f"{dtype_name} {name} max abs err {err}")
            # The Function against autograd of the plain attention.
            q, k, v = (t.detach().requires_grad_() for t in args[:3])
            g = args[3]
            got = torch.autograd.grad(
                attn.fused_attention(q, k, v, causal=causal), (q, k, v), g)
            ref = torch.autograd.grad(
                attn.attention_reference(q, k, v, causal=causal), (q, k, v),
                g)
            fn_err = max((a.float() - r.float()).abs().max().item()
                         for a, r in zip(got, ref))
            if not all(close_enough(a, r, tol) for a, r in zip(got, ref)):
                raise AssertionError(
                    f"FlashAttention grads disagree with autograd of the "
                    f"reference: {dtype_name} {name} max abs err {fn_err}")
            log(f"  {dtype_name:8s} {name:14s} [{b},{h},{sq},{sk},{d}] "
                f"causal={causal} {variant:4s} dk {line[0]:.3e} "
                f"dv {line[1]:.3e} "
                f"dq {line[2]:.3e} Function vs autograd {fn_err:.3e} ok")
    # Rows that saw no key carry lse = +1e30: their dQ is exactly 0.
    for causal in (False, True):
        q, k, v, do, lse, delta, _, scale = bwd_inputs(
            torch, attn, 398, 2, 3, 129, 150, HEAD_DIM, torch.bfloat16,
            causal)
        lse = lse.clone()
        lse[:, :, 5] = 1e30
        lse[1, 0, 63:] = 1e30
        args = (q, k, v, do, lse, delta, causal, scale)
        dq = attn.flash_attn_bwd_dq(*args)
        rq = attn.flash_bwd_dq_reference(*args)
        if not ((dq[:, :, 5] == 0).all() and (dq[1, 0, 63:] == 0).all()
                and close_enough(dq, rq, BWD_TOL["bfloat16"])):
            raise AssertionError(f"dQ of rows that saw no key is not 0 "
                                 f"(causal={causal})")
    log("  rows that saw no key (lse = +1e30): dQ exactly 0")
    # No atomics: a second call gives the same bits.
    args = bwd_inputs(torch, attn, 399, *TRAIN_SHAPE, torch.bfloat16, True)
    first = (*attn.flash_attn_bwd_dkdv(*args), attn.flash_attn_bwd_dq(*args))
    second = (*attn.flash_attn_bwd_dkdv(*args),
              attn.flash_attn_bwd_dq(*args))
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError("two backward calls are not bit-identical")
    log("  two backward calls at the training shape: bit-identical")
    return errs


def train_bounds(b, h, sq, sk, d, causal, elem_bytes=2):
    """Bytes and operations each kernel must spend at one shape: every
    input read once and every output written once; operations for the
    (query, key) pairs this causal mask keeps (forward: QKᵀ and PV, 4·D per
    pair; dK/dV: QKᵀ, dO Vᵀ, Pᵀ dO, dSᵀ Q, 8·D; dQ: QKᵀ, dO Vᵀ, dS K,
    6·D)."""
    if causal:
        pairs = sum(min(sk, i + 1 + sk - sq) for i in range(sq))
    else:
        pairs = sq * sk
    heads = b * h
    qd, kd = heads * sq * d * elem_bytes, heads * sk * d * elem_bytes
    row = heads * sq * 4  # one f32 per query row (lse, delta)
    nbytes = {"flash_attn_fwd": qd + 2 * kd + qd + row,
              "flash_attn_bwd_dkdv": 2 * qd + 2 * kd + 2 * row + 2 * kd,
              "flash_attn_bwd_dq": 2 * qd + 2 * kd + 2 * row + qd}
    flops = {"flash_attn_fwd": 4.0 * d * pairs * heads,
             "flash_attn_bwd_dkdv": 8.0 * d * pairs * heads,
             "flash_attn_bwd_dq": 6.0 * d * pairs * heads}
    out = {}
    for name in nbytes:
        t_bytes = nbytes[name] / HBM_BYTES_PER_S * 1e3
        t_ops = flops[name] / BF16_FLOP_PER_S * 1e3
        out[name] = dict(bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations",
                         bytes=nbytes[name], flops=flops[name])
    return out


def time_training_kernels(torch, attn):
    """Phase 8: kernel / plain / library times at the training shape."""
    F = torch.nn.functional
    args = bwd_inputs(torch, attn, 500, *TRAIN_SHAPE, torch.bfloat16, True)
    q, k, v, do, lse, delta, causal, scale = args
    # The same call in the model's layout: q/k/v and dO as transposed views.
    sargs = bwd_inputs(torch, attn, 500, *TRAIN_SHAPE, torch.bfloat16, True,
                       strided=True)
    strided = {
        "flash_attn_fwd": lambda: attn.flash_attention_forward(
            *sargs[:3], causal=True, return_lse=True),
        "flash_attn_bwd_dkdv": lambda: attn.flash_attn_bwd_dkdv(*sargs),
        "flash_attn_bwd_dq": lambda: attn.flash_attn_bwd_dq(*sargs),
    }
    kernel = {
        "flash_attn_fwd": lambda: attn.flash_attention_forward(
            q, k, v, causal=True, return_lse=True),
        "flash_attn_bwd_dkdv": lambda: attn.flash_attn_bwd_dkdv(*args),
        "flash_attn_bwd_dq": lambda: attn.flash_attn_bwd_dq(*args),
    }
    # The first port's kernel bodies (the ``simt`` variants) on the same
    # inputs.
    dk, dv, dq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)
    before = {
        "flash_attn_fwd": lambda: attn._launch(q, k, v, None, True, scale,
                                               True, "simt"),
        "flash_attn_bwd_dkdv": lambda: attn._launch_bwd(
            "flash_attn_bwd_dkdv", *args, (dk, dv), "simt",
            attn.flash_attn_bwd_dkdv),
        "flash_attn_bwd_dq": lambda: attn._launch_bwd(
            "flash_attn_bwd_dq", *args, (dq,), "simt",
            attn.flash_attn_bwd_dq),
    }
    plain = {
        "flash_attn_fwd": lambda: (
            attn.attention_reference(q, k, v, causal=True),
            attn._reference_lse(q, k, None, True, scale)),
        "flash_attn_bwd_dkdv": lambda: attn.flash_bwd_dkdv_reference(*args),
        "flash_attn_bwd_dq": lambda: attn.flash_bwd_dq_reference(*args),
    }
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    library = {
        "flash_attn_fwd": lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True),
        # One call computes dq, dk and dv together; it stands beside both
        # backward kernels.
        "flash_attn_bwd_dkdv": lambda: torch.autograd.grad(
            sdpa_out, (qg, kg, vg), do, retain_graph=True),
    }
    library["flash_attn_bwd_dq"] = library["flash_attn_bwd_dkdv"]
    bounds = train_bounds(*TRAIN_SHAPE, True)
    rows = {}
    # (Launches made here and in phase 7 are comparisons, not the main
    # path's: every count is set to 0 before phase 9.)
    bwd = attn.backward_variant(q.dtype, q.shape[3])
    variant = {"flash_attn_fwd": attn.forward_variant(q.dtype, q.shape[2],
                                                      q.shape[3]),
               "flash_attn_bwd_dkdv": bwd, "flash_attn_bwd_dq": bwd}
    for name in kernel:
        t = time_row(torch, kernel[name], strided[name], before[name],
                     plain[name], library[name], 50, 5, 20, 3)
        rows[name] = dict(shape="train_decoder_self", q=list(q.shape),
                          kv=list(k.shape), dtype="bfloat16", causal=True,
                          variant=variant[name], **t, **bounds[name])
        log_times(name, rows[name])
    return rows


def train_cfg(torch, dtype, batch, steps, workdir_name):
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.presets import get_preset

    workdir = os.path.join(REPO, "deeplearning_cfn_tpu_torch", "_build",
                           workdir_name)
    # Preset recipe kept (dropout 0.1, label smoothing 0.1, AdamW(0.9,
    # 0.98), rsqrt) but for the schedule's scale: warmup is clamped to
    # steps - 1, so a short run needs a small base lr for the loss to fall.
    return apply_overrides(get_preset("transformer_nmt_wmt"), [
        f"workdir={workdir}", f"train.dtype={dtype}", "train.seed=0",
        f"train.global_batch={batch}", f"train.steps={steps}",
        "train.log_every_steps=1", "schedule.warmup_steps=10",
        "schedule.base_lr=1e-3", "data.num_eval_examples=128",
        "eval.max_decode_len=32"])


def counts(attn):
    return {"fwd": attn.flash_attention_forward.launches,
            "dkdv": attn.flash_attn_bwd_dkdv.launches,
            "dq": attn.flash_attn_bwd_dq.launches,
            "vjp": attn.attention_reference_vjp.calls}


def variant_counts(attn):
    return {"fwd": dict(attn.flash_attention_forward.variant_launches),
            "dkdv": dict(attn.flash_attn_bwd_dkdv.variant_launches),
            "dq": dict(attn.flash_attn_bwd_dq.variant_launches)}


def set_counts(attn, value):
    for fn in (attn.flash_attention_forward, attn.flash_attn_bwd_dkdv,
               attn.flash_attn_bwd_dq):
        fn.launches = value
        fn.variant_launches = dict.fromkeys(fn.variant_launches, value)
    attn.attention_reference_vjp.calls = value


def train(torch, attn):
    """Phase 9: the training path, with every count set to 0 first."""
    from deeplearning_cfn_tpu_torch.train.run import run_experiment

    cfg = train_cfg(torch, "bfloat16", TRAIN_BATCH, TRAIN_STEPS,
                    "smoke_train")
    records, at_end = [], {}

    by_variant = {}

    def hook(step, state, record):
        records.append(record)
        if step == TRAIN_STEPS:
            at_end.update(counts(attn))  # before the eval's forwards
            by_variant.update(variant_counts(attn))

    torch.cuda.reset_peak_memory_stats()
    set_counts(attn, 0)
    t0 = time.perf_counter()
    final = run_experiment(cfg, device=DEVICE, hooks=(hook,))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in records]
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x)
                                             for x in losses):
        raise AssertionError(f"bad losses: {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    log(f"  losses: {' '.join(f'{x:.4f}' for x in losses)}")
    if not last < first:
        raise AssertionError(f"loss did not fall: first-5 mean {first}, "
                             f"last-5 mean {last}")
    accum = cfg.train.grad_accum_steps
    expect = {k: v * TRAIN_STEPS * accum for k, v in PER_STEP.items()}
    log(f"  launches over {TRAIN_STEPS} steps (accum {accum}): {at_end} "
        f"(expected {expect})")
    if at_end != expect:
        raise AssertionError(f"launch counts {at_end} != {expect}")
    log(f"  launches by variant: {by_variant}")
    if any(by_variant[key]["tc"] != at_end[key]
           for key in ("fwd", "dkdv", "dq")):
        raise AssertionError(f"bf16 training launches off the tc variant: "
                             f"{by_variant}")
    stepped = [r for r in records if "step_time_s" in r]
    step_s = sorted(r["step_time_s"] for r in stepped)
    tok_s = sorted(r["target_tokens_per_sec"] for r in stepped)
    p50 = lambda xs: xs[len(xs) // 2]
    out = dict(steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
               grad_accum_steps=accum, first5_loss=first, last5_loss=last,
               step_time_p50_s=p50(step_s),
               target_tokens_per_s_p50=p50(tok_s),
               first_step_s=records[0]["compile_s"],
               max_memory_allocated_bytes=peak, wall_s=wall,
               final_eval_loss=final["loss"],
               final_eval_token_accuracy=final["token_accuracy"],
               final_eval_bleu=final["bleu"], launches=at_end,
               variant_launches=by_variant)
    log(f"  step time p50 {out['step_time_p50_s'] * 1e3:.2f} ms, target "
        f"tokens/s p50 {out['target_tokens_per_s_p50']:.1f}, first step "
        f"{out['first_step_s']:.2f} s, max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; final eval loss {final['loss']:.4f}, "
        f"token accuracy {final['token_accuracy']:.4f}, BLEU "
        f"{final['bleu']:.4f}; run {wall:.1f} s")
    return out


def grad_parity(torch, attn):
    """Phase 10: one f32 train step through the kernels and through the
    plain attention, from the same init and dropout seed."""
    from deeplearning_cfn_tpu_torch.data.pipeline import (build_pipeline,
                                                          to_device)
    from deeplearning_cfn_tpu_torch.train.optim import (build_optimizer,
                                                        build_schedule)
    from deeplearning_cfn_tpu_torch.train.state import create_train_state
    from deeplearning_cfn_tpu_torch.train.task import build_task
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = train_cfg(torch, "float32", PARITY_BATCH, 1, "smoke_parity")
    dev = torch.device(DEVICE)
    host = next(iter(build_pipeline(cfg.data, PARITY_BATCH,
                                    seed=0).one_epoch()))
    results = {}
    for impl in ("kernel", "reference"):
        task = build_task(cfg, dev, attention_impl=impl)
        task.init(torch.Generator(device=dev).manual_seed(0))
        opt = build_optimizer(cfg.optimizer, build_schedule(
            cfg.schedule, 1, PARITY_BATCH), task.model)
        state = create_train_state(task.model, opt)
        before = counts(attn)
        metrics = Trainer(cfg, task, dev).train_step(
            state, to_device(host, dev))
        used = {k: counts(attn)[k] - before[k] for k in before}
        grads = {n: None if p.grad is None else p.grad.detach().clone()
                 for n, p in task.model.named_parameters()}
        results[impl] = (float(metrics["loss"]), grads, used)
    (lk, gk, used_k), (lr, gr, used_r) = results["kernel"], \
        results["reference"]
    if used_k["dkdv"] != PER_STEP["dkdv"] or used_r["dkdv"] != 0:
        raise AssertionError(f"kernel run launched {used_k}, plain run "
                             f"{used_r}")
    rel_loss = abs(lk - lr) / abs(lr)
    missing = [n for n in gr if gk[n] is None or gr[n] is None]
    if missing:
        raise AssertionError(f"gradients missing: {missing}")
    # The key projections' biases have a true gradient of 0 (they shift
    # every logit of a row alike), so their norm is rounding noise: each
    # norm is floored at 1e-4 of the largest parameter gradient norm.
    floor = 1e-4 * max(g.norm().item() for g in gr.values())
    worst, worst_name = 0.0, ""
    for name, ref in gr.items():
        rel = (gk[name] - ref).norm().item() / max(ref.norm().item(), floor)
        if rel > worst:
            worst, worst_name = rel, name
        if not rel <= 1e-3:
            raise AssertionError(f"{name}: gradient differs by {rel} of its "
                                 f"norm")
    projections = [n for n in gk if any(
        f"{a}.{p}.weight" in n for a in ("self_attn", "cross_attn")
        for p in ("query", "key", "value"))]
    dead = [n for n in projections if not gk[n].abs().sum().item() > 0]
    if len(projections) != 6 * 3 * 3 or dead:
        raise AssertionError(f"attention projections without gradient: "
                             f"{dead} of {len(projections)}")
    log(f"  loss kernel {lk:.7f} vs plain {lr:.7f} (rel {rel_loss:.2e}); "
        f"{len(gk)} parameters, worst gradient diff {worst:.2e} of its norm "
        f"({worst_name}); {len(projections)} attention projections all "
        f"have nonzero gradients")
    if not rel_loss <= 1e-5:
        raise AssertionError(f"f32 losses differ by {rel_loss} relative")
    return dict(loss_rel_diff=rel_loss, worst_grad_rel_diff=worst,
                worst_grad_param=worst_name, params=len(gk),
                projections=len(projections))


def profile_training(torch, steps: int = 3) -> None:
    """``--profile-train``: where a full-width bf16 train step (batch 128)
    spends its time — host wall time per step against device-busy time
    (torch.profiler), the CUDA kernels ranked by device time — and the step
    time through the kernels against the plain attention, in turns
    (kernel, plain, plain, kernel)."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning_cfn_tpu_torch.data.pipeline import (build_pipeline,
                                                          to_device)
    from deeplearning_cfn_tpu_torch.train.optim import (build_optimizer,
                                                        build_schedule)
    from deeplearning_cfn_tpu_torch.train.state import create_train_state
    from deeplearning_cfn_tpu_torch.train.task import build_task
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer

    cfg = train_cfg(torch, "bfloat16", TRAIN_BATCH, 100, "smoke_profile")
    dev = torch.device(DEVICE)
    batches = [to_device(b, dev) for _, b in zip(
        range(steps + 2), build_pipeline(cfg.data, TRAIN_BATCH,
                                         seed=0).one_epoch())]

    def setup(impl):
        task = build_task(cfg, dev, attention_impl=impl)
        task.init(torch.Generator(device=dev).manual_seed(0))
        opt = build_optimizer(cfg.optimizer, build_schedule(
            cfg.schedule, 100, TRAIN_BATCH), task.model)
        return Trainer(cfg, task, dev), create_train_state(task.model, opt)

    def run(trainer, state, bs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in bs:
            trainer.train_step(state, b)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    runs = {impl: setup(impl) for impl in ("kernel", "reference")}
    for impl in runs:
        run(*runs[impl], batches[:2])  # warm up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        wall = run(*runs["kernel"], batches[2:])
    report_profile(prof, wall, steps, "train step")
    times = {"kernel": [], "reference": []}
    for impl in ("kernel", "reference", "reference", "kernel"):
        times[impl].append(run(*runs[impl], batches[2:]) / steps * 1e3)
    log(f"  train step through the kernels "
        f"{' / '.join(f'{t:.2f}' for t in times['kernel'])} ms, through "
        f"the plain attention "
        f"{' / '.join(f'{t:.2f}' for t in times['reference'])} ms "
        f"(turns kernel, plain, plain, kernel; {steps} steps each)")


def report_profile(prof, wall, steps, what):
    events = kernel_rows(prof)
    busy_us = sum(dev_time(e) for e in events)
    n_kernels = sum(e.count for e in events)
    log(f"  {steps} {what}s in {wall * 1e3:.1f} ms: "
        f"{wall * 1e3 / steps:.3f} ms per {what} on the host clock, "
        f"{busy_us / 1e3 / steps:.3f} ms device-busy per {what} "
        f"({busy_us / (wall * 1e6):.1%} busy), {n_kernels / steps:.0f} "
        f"device ops per {what}")
    ranked = sorted(events, key=dev_time, reverse=True)
    # The top 15, then the port's own kernels wherever they rank.
    for i, e in enumerate(ranked):
        if i < 15 or "flash_attn" in e.key:
            log(f"    {dev_time(e) / steps:9.1f} us/{what}  "
                f"x{e.count / steps:5.1f}  #{i + 1:<3d} {e.key[:90]}")


# -- the ResNet path (no kernel of ours: cuDNN convs, eager f32 BatchNorm) --


def resnet_cfg(batch, steps, workdir_name):
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.presets import get_preset

    workdir = os.path.join(REPO, "deeplearning_cfn_tpu_torch", "_build",
                           workdir_name)
    return apply_overrides(get_preset("imagenet_resnet50"), [
        f"workdir={workdir}", "train.seed=0", f"train.global_batch={batch}",
        f"train.steps={steps}", "train.log_every_steps=1",
        "train.eval_every_steps=1000000", "schedule.warmup_steps=2",
        "data.num_train_examples=1024", "data.num_eval_examples=512"])


def train_resnet(torch):
    """Phase 11: ResNet-50 at full width in bf16 through run_experiment."""
    from deeplearning_cfn_tpu_torch.models.resnet import forward_flops
    from deeplearning_cfn_tpu_torch.train.run import run_experiment

    steps = RESNET_WARMUP + RESNET_STEPS
    cfg = resnet_cfg(RESNET_BATCH, steps, "smoke_resnet")
    for cut in RESNET_CUTS:
        log(f"  cut: {cut}")
    records, seen = [], {}

    def hook(step, state, record):
        records.append(record)
        if step == steps:
            seen["model"] = state.model

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    final = run_experiment(cfg, device=DEVICE, hooks=(hook,))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    model = seen["model"]
    losses = [r["loss"] for r in records]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"bad losses: {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    log(f"  losses: {' '.join(f'{x:.4f}' for x in losses)}")
    if not last < first:
        raise AssertionError(f"loss did not fall: first-5 mean {first}, "
                             f"last-5 mean {last}")
    off = [n for n, t in [*model.named_parameters(), *model.named_buffers()]
           if t.device.type != torch.device(DEVICE).type]
    if off:
        raise AssertionError(f"{len(off)} tensors not on the card, e.g. "
                             f"{off[:3]}")
    # The seeded init leaves every running mean at 0 and variance at 1.
    moved, buffers = 0, dict(model.named_buffers())
    for name, buf in buffers.items():
        if not bool(torch.isfinite(buf).all()):
            raise AssertionError(f"{name}: non-finite running statistic")
        start = 0.0 if name.endswith("running_mean") else 1.0
        moved += int(bool((buf != start).any()))
    if moved != len(buffers):
        raise AssertionError(f"only {moved} of {len(buffers)} running "
                             f"statistics moved")
    layouts = channels_last_share(torch, model, cfg.data.image_size)
    timed = [r for r in records[RESNET_WARMUP:] if "step_time_s" in r]
    step_s = sorted(r["step_time_s"] for r in timed)
    img_s = sorted(r["examples_per_sec"] for r in timed)
    p50 = lambda xs: xs[len(xs) // 2]
    flops = forward_flops(model, cfg.data.image_size)
    mfu = p50(img_s) * 3 * flops / BF16_FLOP_PER_S
    out = dict(steps=steps, timed_steps=len(timed),
               global_batch=RESNET_BATCH, image_size=cfg.data.image_size,
               params=sum(p.numel() for p in model.parameters()),
               forward_gflop_per_image=flops / 1e9,
               first5_loss=first, last5_loss=last,
               step_time_p50_s=p50(step_s), images_per_s_p50=p50(img_s),
               mfu_share=mfu, first_step_s=records[0]["compile_s"],
               max_memory_allocated_bytes=peak, wall_s=wall,
               final_eval_loss=final["loss"],
               final_eval_top1=final["accuracy"],
               final_eval_top5=final["accuracy_top5"],
               final_eval_examples=final["examples"],
               channels_last_activations=layouts, cuts=RESNET_CUTS)
    log(f"  model: ResNet-50, {out['params']} parameters, "
        f"{out['forward_gflop_per_image']:.3f} GFLOP forward per "
        f"{cfg.data.image_size}² image (counted from the conv/Dense shapes; "
        f"published ~8.2)")
    log(f"  step time p50 {out['step_time_p50_s'] * 1e3:.2f} ms, images/s "
        f"p50 {out['images_per_s_p50']:.1f}, MFU share {mfu:.4f} (of 989 "
        f"TFLOP/s dense bf16), first step {out['first_step_s']:.2f} s, "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; eval on "
        f"{final['examples']:.0f}: loss {final['loss']:.4f}, top-1 "
        f"{final['accuracy']:.4f}, top-5 {final['accuracy_top5']:.4f}; "
        f"{moved} running statistics moved, all finite; activations "
        f"channels_last: {layouts}; run {wall:.1f} s")
    out["feed"] = feed_rate(torch, out["images_per_s_p50"])
    return out


def channels_last_share(torch, model, size):
    """Every conv and BatchNorm output of one train-mode forward (batch 8)
    must be channels_last; returns 'n/n'. The forward runs under no_grad
    and its statistics update is undone."""
    from deeplearning_cfn_tpu_torch.models import resnet

    saved = {n: b.clone() for n, b in model.named_buffers()}
    flags = []
    handles = [m.register_forward_hook(lambda m, i, o: flags.append(
        o.is_contiguous(memory_format=torch.channels_last)))
        for m in model.modules()
        if isinstance(m, (resnet.Conv, resnet.BatchNorm))]
    try:
        with torch.no_grad():
            model(torch.randn(8, size, size, 3, device=DEVICE), train=True)
    finally:
        for h in handles:
            h.remove()
        with torch.no_grad():
            for n, b in model.named_buffers():
                b.copy_(saved[n])
    if not flags or not all(flags):
        raise AssertionError(f"activations not channels_last: "
                             f"{sum(flags)}/{len(flags)}")
    return f"{sum(flags)}/{len(flags)}"


def feed_rate(torch, card_images_per_s):
    """The host's feed rate of the sharded ImageNet source through dataio
    (random-resized-crop to 224, flip, normalize), at batch 256, with the
    preset's 4 loader threads and with one per core."""
    import shutil

    import numpy as np

    from deeplearning_cfn_tpu_torch import dataio
    from deeplearning_cfn_tpu_torch.data.imagenet import (
        ShardedImageNetSource, measure_feed_rate, write_shards)
    from deeplearning_cfn_tpu_torch.data.pipeline import DataPipeline

    if not dataio.available():
        raise AssertionError("the dataio C++ loader did not build (g++)")
    root = os.path.join(REPO, "deeplearning_cfn_tpu_torch", "_build",
                        "feed_shards")
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    write_shards(root, rng.randint(0, 256, (FEED_IMAGES, FEED_STORED,
                                            FEED_STORED, 3), dtype=np.uint8),
                 rng.randint(0, 1000, FEED_IMAGES), 1000, shard_records=256)
    write_s = time.perf_counter() - t0
    out = {"shards_write_s": write_s, "images": FEED_IMAGES,
           "stored": f"{FEED_STORED}x{FEED_STORED} u8", "out": FEED_OUT,
           "card_images_per_s": card_images_per_s}
    try:
        for workers in (4, os.cpu_count() or 4):
            source = ShardedImageNetSource(root, train=True,
                                           image_size=FEED_OUT,
                                           num_workers=workers)
            pipe = DataPipeline(source, RESNET_BATCH, prefetch=0)
            if not pipe._seeded or not source._native:
                raise AssertionError("feed path is not the native seeded "
                                     "gather")
            rate = measure_feed_rate(pipe, num_batches=8, warmup=1)
            out[f"images_per_s_{workers}_threads"] = rate["images_per_sec"]
            log(f"  feed rate ({workers} loader threads, batch "
                f"{RESNET_BATCH}, {FEED_STORED}² u8 → {FEED_OUT}² f32): "
                f"{rate['images_per_sec']:.1f} images/s — "
                f"{rate['images_per_sec'] / card_images_per_s:.2f}× the "
                f"card's {card_images_per_s:.1f}; "
                f"{'enough' if rate['images_per_sec'] >= card_images_per_s else 'NOT enough'} "
                f"to feed it")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def cifar_parity(torch):
    """Phase 12: f32 ResNet-20 at full width, the card against the CPU."""
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.data.pipeline import (build_pipeline,
                                                          to_device)
    from deeplearning_cfn_tpu_torch.presets import get_preset
    from deeplearning_cfn_tpu_torch.train.optim import (build_optimizer,
                                                        build_schedule)
    from deeplearning_cfn_tpu_torch.train.state import create_train_state
    from deeplearning_cfn_tpu_torch.train.task import build_task
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer
    from deeplearning_cfn_tpu_torch.train.optim import global_norm

    cfg = apply_overrides(get_preset("cifar10_resnet20"), [
        "train.seed=0", f"train.global_batch={CIFAR_BATCH}",
        f"data.num_train_examples={CIFAR_BATCH * CIFAR_STEPS}"])
    host = [b for _, b in zip(range(CIFAR_STEPS), build_pipeline(
        cfg.data, CIFAR_BATCH, cfg.model.num_classes, seed=0).one_epoch())]
    runs = {}
    init = None
    for name in ("cpu", DEVICE):
        dev = torch.device(name)
        task = build_task(cfg, dev)
        if init is None:
            task.init(torch.Generator(device=dev).manual_seed(0))
            init = {k: v.clone() for k, v in task.model.state_dict().items()}
        else:
            task.model.load_state_dict(init)
        sched = build_schedule(cfg.schedule, 100, CIFAR_BATCH, 100)
        state = create_train_state(task.model, build_optimizer(
            cfg.optimizer, sched, task.model))
        trainer = Trainer(cfg, task, dev)
        losses = [float(trainer.train_step(state, to_device(b, dev))["loss"])
                  for b in host]
        grads = {n: p.grad.detach().cpu() for n, p in
                 task.model.named_parameters()}
        stats = {n: b.detach().cpu() for n, b in
                 task.model.named_buffers()}
        runs[name] = (losses, grads, stats)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    (lc, gc, sc), (lg, gg, sg) = runs["cpu"], runs[DEVICE]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    gnorm = float(global_norm(list(gc.values())))
    grad_rel = max(float((gg[n] - gc[n]).norm()) for n in gc) / gnorm
    stat_err = max(float((sg[n] - sc[n]).abs().max() /
                         max(float(sc[n].abs().max()), 1.0)) for n in sc)
    log(f"  losses card {' '.join(f'{x:.7f}' for x in lg)} vs CPU "
        f"{' '.join(f'{x:.7f}' for x in lc)} (worst rel {loss_rel:.2e}); "
        f"{len(gc)} gradients, worst {grad_rel:.2e} of the global norm "
        f"{gnorm:.4f}; {len(sc)} running statistics, worst {stat_err:.2e}; "
        f"TF32 (cudnn, matmul) during the run: {tf32}")
    if tf32 != (False, False):
        raise AssertionError(f"TF32 on for an f32 run: {tf32}")
    if not (loss_rel <= 1e-4 and grad_rel <= 1e-5 and stat_err <= 1e-5):
        raise AssertionError(
            f"card vs CPU: losses {loss_rel}, gradients {grad_rel}, "
            f"statistics {stat_err}")
    return dict(steps=CIFAR_STEPS, global_batch=CIFAR_BATCH,
                losses_card=lg, losses_cpu=lc, loss_rel_diff=loss_rel,
                grad_rel_to_global_norm=grad_rel, running_stat_err=stat_err,
                params=len(gc))


# Device-time kinds of a ResNet step, by kernel name, first match wins.
# PyTorch's own kernels (at::native) are copies and casts, reductions,
# the optimizer's foreach ops, max-pool or elementwise; the rest are
# cuDNN's and cuBLAS's convolutions and GEMMs.
KINDS = (("copy / cast", ("copy_kernel",)),
         ("reduction (BN statistics and their backward)",
          ("reduce_kernel",)),
         ("optimizer (foreach)", ("multi_tensor",)),
         ("max-pool", ("max_pool",)),
         ("elementwise (BN, ReLU, residual)", ("at::native",)),
         ("conv wgrad", ("wgrad",)),
         ("conv dgrad", ("dgrad",)),
         ("conv fprop", ("fprop",)),
         ("conv / gemm, other cuDNN and cuBLAS kernels",
          ("xmma", "gemm", "conv", "cudnn", "cutlass", "sm90", "nvjet")))


def kernel_kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k.lower() in low for k in keys):
            return kind
    return "other"


def profile_resnet(torch, steps: int = 3) -> None:
    """``--profile-resnet``: where a steady full-width bf16 ResNet-50 train
    step (batch 256, LARS) spends its time."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning_cfn_tpu_torch.train.optim import (build_optimizer,
                                                        build_schedule)
    from deeplearning_cfn_tpu_torch.train.state import create_train_state
    from deeplearning_cfn_tpu_torch.train.task import build_task
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer

    cfg = resnet_cfg(RESNET_BATCH, 100, "smoke_resnet_profile")
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(0)
    size = cfg.data.image_size
    batches = [{"image": torch.randn(RESNET_BATCH, size, size, 3, device=dev,
                                     generator=g),
                "label": torch.randint(0, 1000, (RESNET_BATCH,), device=dev,
                                       generator=g)}
               for _ in range(steps + 2)]
    task = build_task(cfg, dev)
    task.init(torch.Generator(device=dev).manual_seed(0))
    opt = build_optimizer(cfg.optimizer, build_schedule(
        cfg.schedule, 100, RESNET_BATCH, 4), task.model)
    trainer, state = Trainer(cfg, task, dev), create_train_state(task.model,
                                                                 opt)

    def run(bs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in bs:
            trainer.train_step(state, b)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(batches[:2])  # warm up
    plain = run(batches[2:])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        wall = run(batches[2:])
    log(f"  host clock without the profiler: {plain * 1e3 / steps:.2f} ms "
        f"per step ({RESNET_BATCH * steps / plain:.1f} images/s)")
    report_profile(prof, wall, steps, "train step")
    by_kind = {}
    for e in kernel_rows(prof):
        kind = kernel_kind(e.key)
        t, n, rows = by_kind.get(kind, (0.0, 0, []))
        by_kind[kind] = (t + dev_time(e), n + e.count, rows + [e])
    busy = sum(t for t, _, _ in by_kind.values())
    log("  device time by kind (the top 3 kernels of each, names cut at "
        "200 characters):")
    for kind, (t, n, rows) in sorted(by_kind.items(),
                                      key=lambda kv: -kv[1][0]):
        log(f"    {t / steps / 1e3:9.3f} ms/step  {t / busy:6.1%}  "
            f"x{n / steps:6.1f}  {kind}")
        for e in sorted(rows, key=dev_time, reverse=True)[:3]:
            log(f"        {dev_time(e) / steps / 1e3:8.3f} ms  "
                f"x{e.count / steps:5.1f}  {e.key[:200]}")


def profile_serving(torch, ticks: int = 16) -> None:
    """``--profile``: where a steady greedy decode tick spends its time —
    host wall time per tick against device-busy time (torch.profiler),
    and the CUDA kernels ranked by device time."""
    from torch.profiler import ProfilerActivity, profile

    engine = build_engine(smoke_cfg("bfloat16"))
    for rid, src, _, _ in make_requests(n=SLOTS, n_beam=1)[:SLOTS]:
        engine.submit(src, max_new_tokens=120, request_id=rid)
    engine.step()  # admission + prefill + the first window
    engine.step()
    torch.cuda.synchronize()
    steps_before = engine.decoder_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(prof, wall, engine.decoder_steps - steps_before,
                   "decode step")


def main() -> int:
    profiles = {"--profile": profile_serving,
                "--profile-train": profile_training,
                "--profile-resnet": profile_resnet}
    wanted = [a for a in sys.argv[1:] if a in profiles]
    if wanted:
        import torch

        if not torch.cuda.is_available():
            return 2
        sys.path.insert(0, REPO)
        from deeplearning_cfn_tpu_torch import kernels

        log(card_line())
        kernels.build(kernels.KERNEL_NAMES)
        for flag in wanted:
            phase(f"profile ({flag}), bf16, full width")
            profiles[flag](torch)
        return 0
    if not os.path.isdir(os.path.join(REPO, "deeplearning_cfn_tpu_torch")):
        print("chip_smoke.py: run it from a checkout of the repository "
              "(deeplearning_cfn_tpu_torch/ not found)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from deeplearning_cfn_tpu_torch import kernels
    from deeplearning_cfn_tpu_torch.ops import attention as attn

    t = phase("1. card")
    card = card_line()
    log(card)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t = phase("2. build kernels")
    paths = kernels.build(kernels.KERNEL_NAMES)
    build_s = time.perf_counter() - t
    log(f"  built {sorted(paths)} in {build_s:.2f} s")

    phase("3. kernel vs plain version")
    errs = check_kernel(torch, attn)

    phase("4. timing (bf16, 8 slots)")
    rows = time_kernel(torch, attn)

    phase("5. serve transformer_nmt_wmt (full width, bf16)")
    served = serve(torch, attn, make_requests())

    phase("6. f32: kernel vs plain version through the engine")
    logit_err, same, n_greedy = f32_parity(torch, make_requests())

    phase("7. backward kernels vs plain versions")
    bwd_errs = check_backward(torch, attn)

    phase("8. timing at the training shape (bf16, [128,8,128,64], causal)")
    train_rows = time_training_kernels(torch, attn)

    phase("9. train transformer_nmt_wmt (full width, bf16, batch 128)")
    trained = train(torch, attn)

    phase("10. f32 gradients: kernels vs plain attention (batch 16)")
    parity = grad_parity(torch, attn)
    after_nmt = counts(attn)

    phase("11. train imagenet_resnet50 (full width, bf16, batch 256)")
    resnet = train_resnet(torch)
    if counts(attn) != after_nmt:
        raise AssertionError("the ResNet path launched an attention kernel")

    phase("12. f32 cifar10_resnet20 (full width, batch 128): card vs CPU")
    cifar = cifar_parity(torch)

    # The forward kernel serves both paths: its numbers cover the three
    # serving shapes and the training shape (one call at each).
    rows = rows + [train_rows["flash_attn_fwd"]]
    timings = ("kernel_ms_before", "device_ms", "device_ms_strided",
               "device_ms_before", "plain_ms", "bound_ms", "library_ms",
               "library_device_ms")
    fwd = {
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "deeplearning_cfn_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "deeplearning_cfn_tpu/ops/attention.py:96 "
                    "(_flash_kernel, launched by _flash_forward at :291)",
        "launches": served["launches"] + trained["launches"]["fwd"],
        "launches_serve": served["launches"],
        "launches_train": trained["launches"]["fwd"],
        "variant_launches": {
            v: served["variant_launches"][v]
            + trained["variant_launches"]["fwd"][v]
            for v in served["variant_launches"]},
        "max_abs_err": max(errs.values()),
        "max_abs_err_f32": errs["float32"],
        "max_abs_err_bf16": errs["bfloat16"],
        "ms": sum(r["kernel_ms"] for r in rows),
        **{key: sum(r[key] for r in rows) for key in timings},
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
        else "operations",
        "shapes": rows,
    }
    replaces = {
        "flash_attn_bwd_dkdv": "deeplearning_cfn_tpu/ops/attention.py:344 "
                               "(_flash_bwd_dkdv_kernel, launched by "
                               "_flash_backward at :490)",
        "flash_attn_bwd_dq": "deeplearning_cfn_tpu/ops/attention.py:402 "
                             "(_flash_bwd_dq_kernel, launched by "
                             "_flash_backward at :511)",
    }
    records = [fwd]
    for name, key in (("flash_attn_bwd_dkdv", "dkdv"),
                      ("flash_attn_bwd_dq", "dq")):
        r = train_rows[name]
        records.append({
            "name": name, "route": "cuda",
            "source": f"deeplearning_cfn_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": trained["launches"][key],
            "variant_launches": trained["variant_launches"][key],
            "max_abs_err": bwd_errs[name],
            "ms": r["kernel_ms"], **{t: r[t] for t in timings},
            "bound_by": r["bound_by"],
            # library_ms: SDPA's backward, one call giving dq, dk and dv.
            "shapes": [r],
        })
    summary = {
        "build_s": build_s,
        "serve": served,
        "f32_first_step_logit_max_abs_diff": logit_err,
        "f32_greedy_token_identical": f"{same}/{n_greedy}",
        "train": trained,
        "f32_grad_parity": parity,
        "resnet50_train": resnet,
        "resnet20_f32_card_vs_cpu": cifar,
    }
    log(json.dumps({"summary": summary}))
    log(card)
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
