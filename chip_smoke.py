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
   card: the serving path's three shapes at 8 slots, plus causal, ragged
   Sq != Sk, the lse output and head dim 16; f32 within 1e-4, bf16 within
   2e-2 (absolute);
4. time each of the three shapes with CUDA events: the kernel, the plain
   version, one ``scaled_dot_product_attention`` call (a yardstick only;
   the port never calls it) and the byte/operation bound;
5. serve: ``load_engine`` on the ``transformer_nmt_wmt`` preset at full
   width (seeded random init, seed 0, bf16), 8 slots, paged KV blocks of
   16, decode window 4, prefix cache 32; 24 seeded requests (sources of 8
   to 120 tokens, 32 new tokens, 4 of them beam 4), drained. Every request
   must be done, and the kernel's launch count over this phase must equal
   6 per encoder forward plus 12 per decoder step, as the engine tallied;
6. the same engine in f32 through the kernel and through the plain
   version: the first decode step's logits agree within 1e-3, and the
   number of token-identical greedy requests is printed;
7. hold the backward kernels (dK/dV, dQ) against their plain versions on
   the card — the training shape, causal and not, ragged Sq != Sk (37/101),
   lengths off the tile, head dims 16 and 128, f32 within 5e-4 and bf16
   within 5e-2 (absolute + relative, the tolerances of tests/test_ops.py's
   flash backward tests) — and the autograd Function's (dq, dk, dv) against
   ``torch.autograd.grad`` of ``attention_reference``; two backward calls
   must be bit-identical;
8. time, at the training shape (q/k/v/dO [128, 8, 128, 64] bf16, causal),
   the forward kernel with lse, dK/dV and dQ with CUDA events, beside
   their plain versions, their byte/operation bounds and, as a yardstick
   the port never calls, ``scaled_dot_product_attention`` forward and
   backward;
9. train ``transformer_nmt_wmt`` at full width in bf16 through
   ``train.run.run_experiment``: global batch 128, dropout 0.1, label
   smoothing 0.1, AdamW + rsqrt with warmup 10 and base lr 1e-3 (peak
   3.2e-4; the schedule clamps warmup to steps - 1, so in a 30-step run the
   preset's base lr 1.0 would peak at 0.19 and diverge), 30 steps, then the
   eval loss and BLEU on 128 eval examples (decode length 32).
   Every loss must be finite, the mean of the last 5 below the mean of the
   first 5, and the launch counts over the 30 steps exactly 18 forward,
   6 dK/dV, 6 dQ and 12 reference-VJP recomputes per microbatch step;
10. f32 gradient parity at full width (batch 16): one train step from the
   same init and dropout seed through the kernels and through the plain
   attention — losses within 1e-5 relative, every parameter's gradient
   within 1e-3 of its norm (floored at 1e-4 of the largest gradient norm:
   the key biases' true gradient is 0), and every attention projection's
   gradient present and nonzero.

``python3 chip_smoke.py --profile`` instead profiles steady greedy decode
ticks, and ``--profile-train`` steady full-width bf16 train steps (host
time against device-busy time, kernels ranked); neither prints a result
line.

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
                causal=False):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    mk = lambda s: torch.randn((b, h, s, d), generator=g, device=DEVICE,
                               dtype=torch.float32).to(dtype)
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
    cases = [(name, SLOTS, HEADS, sq, SRC_LEN, HEAD_DIM, False, bias)
             for name, sq, bias in MAIN_PATH_SHAPES]
    cases += [("causal", 2, 4, 96, 96, 64, True, False),
              ("ragged_causal", 2, 4, 37, 101, 64, True, False),
              ("ragged_bias", 3, 2, 45, 77, 64, False, True),
              ("head_dim_16", 2, 3, 50, 70, 16, False, True),
              ("head_dim_128", 2, 2, 33, 65, 128, True, True)]
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        for i, (name, b, h, sq, sk, d, causal, bias_kind) in \
                enumerate(cases):
            q, k, v, bias = make_inputs(torch, 100 + i, b, h, sq, sk, d,
                                        dtype, bias_kind, causal)
            out, lse = attn.flash_attention_forward(q, k, v, bias, causal,
                                                    return_lse=True)
            torch.cuda.synchronize()
            ref = attn.attention_reference(q, k, v, bias, causal)
            err = (out.float() - ref.float()).abs().max().item()
            ref_lse = attn._reference_lse(q, k, bias, causal,
                                          1.0 / math.sqrt(d))
            lse_err = ((lse - ref_lse).abs()
                       / ref_lse.abs().clamp_min(1.0)).max().item()
            ok = err <= TOL[dtype_name] and lse_err <= 1e-3 \
                and bool(torch.isfinite(out).all())
            log(f"  {dtype_name:8s} {name:18s} [{b},{h},{sq},{sk},{d}] "
                f"causal={causal} max_abs_err={err:.3e} "
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
        lib_mask = None if bias is None else bias.to(torch.bfloat16)
        before = attn.flash_attention_forward.launches
        k_ms = time_fn(torch, lambda: attn.flash_attention_forward(
            q, k, v, bias))
        attn.flash_attention_forward.launches = before  # timing, not path
        p_ms = time_fn(torch, lambda: attn.attention_reference(q, k, v,
                                                                bias))
        l_ms = time_fn(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=lib_mask))
        b_ms, by, nbytes, flops = bound_ms(SLOTS, HEADS, sq, SRC_LEN,
                                           HEAD_DIM, 2, bias)
        row = dict(shape=name, q=[SLOTS, HEADS, sq, HEAD_DIM],
                   kv=[SLOTS, HEADS, SRC_LEN, HEAD_DIM], dtype="bfloat16",
                   kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                   bound_ms=b_ms, bound_us=b_ms * 1e3, bound_by=by,
                   bytes=nbytes, flops=flops)
        log(f"  {name:18s} kernel {k_ms * 1e3:8.2f} us  plain "
            f"{p_ms * 1e3:8.2f} us  sdpa {l_ms * 1e3:8.2f} us  bound "
            f"{b_ms * 1e3:6.3f} us ({by})")
        rows.append(row)
    return rows


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
    attn.flash_attention_forward.launches = 0
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
    snap = engine.metrics.snapshot()
    generated = sum(len(t) for t in tokens.values())
    step_ms = snap["serve_step_latency_p50_s"] * 1e3
    log(f"  tokens/s {generated / wall:.1f} ({generated} tokens), TTFT p50 "
        f"{snap['serve_ttft_p50_s'] * 1e3:.2f} ms, decode-step p50 "
        f"{step_ms:.3f} ms, slot occupancy {snap['serve_slot_occupancy']}")
    return dict(launches=launches, encoder_forwards=engine.encoder_forwards,
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


def bwd_inputs(torch, attn, seed, b, h, sq, sk, d, dtype, causal):
    q, k, v, _ = make_inputs(torch, seed, b, h, sq, sk, d, dtype, False)
    g = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    do = torch.randn((b, h, sq, d), generator=g, device=DEVICE).to(dtype)
    out, lse = attn.flash_attention_forward(q, k, v, causal=causal,
                                            return_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    return q, k, v, do, lse, delta, causal, 1.0 / math.sqrt(d)


def check_backward(torch, attn):
    """Phase 7: the backward kernels and the autograd Function vs their
    plain versions on the card. Returns max abs errors per kernel."""
    errs = {"flash_attn_bwd_dkdv": 0.0, "flash_attn_bwd_dq": 0.0}
    cases = [("train_causal", *TRAIN_SHAPE, True),
             ("train_full", 8, HEADS, SRC_LEN, SRC_LEN, HEAD_DIM, False),
             ("ragged_causal", 2, 3, 37, 101, 64, True),
             ("ragged", 2, 3, 37, 101, 64, False),
             ("off_tile_d16", 3, 2, 45, 45, 16, True),
             ("d16_ragged", 2, 2, 50, 70, 16, False),
             ("d128", 2, 2, 33, 65, 128, False),
             ("d128_causal", 1, 2, 70, 70, 128, True)]
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        tol = BWD_TOL[dtype_name]
        for i, (name, b, h, sq, sk, d, causal) in enumerate(cases):
            args = bwd_inputs(torch, attn, 300 + i, b, h, sq, sk, d, dtype,
                              causal)
            dk, dv = attn.flash_attn_bwd_dkdv(*args)
            dq = attn.flash_attn_bwd_dq(*args)
            torch.cuda.synchronize()
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
                f"causal={causal} dk {line[0]:.3e} dv {line[1]:.3e} "
                f"dq {line[2]:.3e} Function vs autograd {fn_err:.3e} ok")
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
    kernel = {
        "flash_attn_fwd": lambda: attn.flash_attention_forward(
            q, k, v, causal=True, return_lse=True),
        "flash_attn_bwd_dkdv": lambda: attn.flash_attn_bwd_dkdv(*args),
        "flash_attn_bwd_dq": lambda: attn.flash_attn_bwd_dq(*args),
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
    for name in kernel:
        k_ms = time_fn(torch, kernel[name], iters=50, warmup=5)
        p_ms = time_fn(torch, plain[name], iters=20, warmup=3)
        l_ms = time_fn(torch, library[name], iters=50, warmup=5)
        rows[name] = dict(shape="train_decoder_self", q=list(q.shape),
                          kv=list(k.shape), dtype="bfloat16", causal=True,
                          kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                          **bounds[name])
        log(f"  {name:20s} kernel {k_ms * 1e3:9.2f} us  plain "
            f"{p_ms * 1e3:9.2f} us  library {l_ms * 1e3:8.2f} us  bound "
            f"{bounds[name]['bound_ms'] * 1e3:7.3f} us "
            f"({bounds[name]['bound_by']})")
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


def set_counts(attn, value):
    attn.flash_attention_forward.launches = value
    attn.flash_attn_bwd_dkdv.launches = value
    attn.flash_attn_bwd_dq.launches = value
    attn.attention_reference_vjp.calls = value


def train(torch, attn):
    """Phase 9: the training path, with every count set to 0 first."""
    from deeplearning_cfn_tpu_torch.train.run import run_experiment

    cfg = train_cfg(torch, "bfloat16", TRAIN_BATCH, TRAIN_STEPS,
                    "smoke_train")
    records, at_end = [], {}

    def hook(step, state, record):
        records.append(record)
        if step == TRAIN_STEPS:
            at_end.update(counts(attn))  # before the eval's forwards

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
    timed = [r for r in records if "step_time_s" in r]
    step_s = sorted(r["step_time_s"] for r in timed)
    tok_s = sorted(r["target_tokens_per_sec"] for r in timed)
    p50 = lambda xs: xs[len(xs) // 2]
    out = dict(steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
               grad_accum_steps=accum, first5_loss=first, last5_loss=last,
               step_time_p50_s=p50(step_s),
               target_tokens_per_s_p50=p50(tok_s),
               first_step_s=records[0]["compile_s"],
               max_memory_allocated_bytes=peak, wall_s=wall,
               final_eval_loss=final["loss"],
               final_eval_token_accuracy=final["token_accuracy"],
               final_eval_bleu=final["bleu"], launches=at_end)
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
    from torch.autograd import DeviceType

    dev_time = lambda e: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0))
    # Kernel rows only: an operator's, autograd Function's or annotated
    # range's row (the optimizer step is one, on the device timeline too)
    # repeats the device time of the kernels it launched, which have rows
    # of their own.
    events = [e for e in prof.key_averages()
              if dev_time(e) > 0 and e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(dev_time(e) for e in events)
    n_kernels = sum(e.count for e in events)
    log(f"  {steps} {what}s in {wall * 1e3:.1f} ms: "
        f"{wall * 1e3 / steps:.3f} ms per {what} on the host clock, "
        f"{busy_us / 1e3 / steps:.3f} ms device-busy per {what} "
        f"({busy_us / (wall * 1e6):.1%} busy), {n_kernels / steps:.0f} "
        f"device ops per {what}")
    for e in sorted(events, key=dev_time, reverse=True)[:15]:
        log(f"    {dev_time(e) / steps:9.1f} us/{what}  "
            f"x{e.count / steps:5.1f}  {e.key[:90]}")


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
                "--profile-train": profile_training}
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

    # The forward kernel serves both paths: its numbers cover the three
    # serving shapes and the training shape (one call at each).
    rows = rows + [dict(train_rows["flash_attn_fwd"], bound_us=train_rows[
        "flash_attn_fwd"]["bound_ms"] * 1e3)]
    total = lambda key: sum(r[key] for r in rows)
    fwd = {
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "deeplearning_cfn_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "deeplearning_cfn_tpu/ops/attention.py:96 "
                    "(_flash_kernel, launched by _flash_forward at :291)",
        "launches": served["launches"] + trained["launches"]["fwd"],
        "launches_serve": served["launches"],
        "launches_train": trained["launches"]["fwd"],
        "max_abs_err": max(errs.values()),
        "max_err": max(errs.values()),
        "max_abs_err_f32": errs["float32"],
        "max_abs_err_bf16": errs["bfloat16"],
        "ms": total("kernel_ms"),
        "kernel_ms": total("kernel_ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_us": total("bound_us"),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
        else "operations",
        "library_ms": total("library_ms"),
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
            "max_abs_err": bwd_errs[name],
            "ms": r["kernel_ms"], "kernel_ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            # SDPA's backward: one call giving dq, dk and dv together.
            "library_ms": r["library_ms"], "shapes": [r],
        })
    summary = {
        "build_s": build_s,
        "serve": served,
        "f32_first_step_logit_max_abs_diff": logit_err,
        "f32_greedy_token_identical": f"{same}/{n_greedy}",
        "train": trained,
        "f32_grad_parity": parity,
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
