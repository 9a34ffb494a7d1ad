#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one CUDA card.

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
   number of token-identical greedy requests is printed.

``python3 chip_smoke.py --profile`` instead profiles steady greedy decode
ticks (host time against device-busy time, kernels ranked) and prints no
result line.

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
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
SLOTS, SRC_LEN, HEADS, HEAD_DIM = 8, 128, 8, 64
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


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
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda s: torch.randn((b, h, s, d), generator=g, device="cuda",
                               dtype=torch.float32).to(dtype)
    q, k, v = mk(sq), mk(sk), mk(sk)
    bias = None
    if bias_kind:
        # A padding/step bias [b, 1, 1, sk]: row i keeps its first
        # lengths[i] keys; without causal the last row is all masked (an
        # all-PAD slot — see csrc/flash_attn_fwd.cu on causal + all-masked).
        lengths = torch.randint(1, sk + 1, (b,), generator=g, device="cuda")
        if not causal:
            lengths[-1] = 0
        keys = torch.arange(sk, device="cuda")
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
    steps = engine.decoder_steps - steps_before
    dev_time = lambda e: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0))
    # Device work only: an aten:: operator's row repeats the device time of
    # the kernels it launched, which have rows of their own.
    events = [e for e in prof.key_averages()
              if dev_time(e) > 0 and not e.key.startswith("aten::")]
    busy_us = sum(dev_time(e) for e in events)
    n_kernels = sum(e.count for e in events)
    log(f"  {ticks} ticks, {steps} decode steps in {wall * 1e3:.1f} ms: "
        f"{wall * 1e3 / steps:.3f} ms per step on the host clock, "
        f"{busy_us / 1e3 / steps:.3f} ms device-busy per step "
        f"({busy_us / (wall * 1e6):.1%} busy), {n_kernels / steps:.0f} "
        f"device ops per step")
    for e in sorted(events, key=dev_time, reverse=True)[:15]:
        log(f"    {dev_time(e) / steps:9.1f} us/step  x{e.count / steps:5.1f}"
            f"  {e.key[:90]}")


def main() -> int:
    if "--profile" in sys.argv[1:]:
        import torch

        if not torch.cuda.is_available():
            return 2
        sys.path.insert(0, REPO)
        from deeplearning_cfn_tpu_torch import kernels

        log(card_line())
        kernels.build(kernels.KERNEL_NAMES)
        phase("profile: steady greedy decode (bf16, 8 slots, window 4)")
        profile_serving(torch)
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

    total = lambda key: sum(r[key] for r in rows)
    record = {
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "deeplearning_cfn_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "deeplearning_cfn_tpu/ops/attention.py:96 "
                    "(_flash_kernel, launched by _flash_forward at :291)",
        "launches": served["launches"],
        "max_abs_err": max(errs.values()),
        "max_err": max(errs.values()),
        "max_abs_err_f32": errs["float32"],
        "max_abs_err_bf16": errs["bfloat16"],
        # Top-level times: one call at each of the three main-path shapes.
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
    summary = {
        "build_s": build_s,
        "serve": served,
        "f32_first_step_logit_max_abs_diff": logit_err,
        "f32_greedy_token_identical": f"{same}/{n_greedy}",
    }
    log(json.dumps({"summary": summary}))
    log(card)
    log(json.dumps({"kernels": [record]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
