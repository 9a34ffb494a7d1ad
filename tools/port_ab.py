#!/usr/bin/env python3
"""Host-side A/B of the PyTorch/CUDA port: one checkout per run, on one card.

    python3 tools/port_ab.py TREE

``TREE`` is the root of a checkout of the repository (this one, or a copy
of another commit unpacked with ``git archive``); the port and its
``chip_smoke.py`` are imported from there, so two commits compare by running
this script on each in turns (A, B, B, A) in one call on the same card. It
imports torch, numpy and the port, never JAX. It prints:

1. the forward wrapper's time per call at the serving shapes (encoder
   self-attention [8,8,128,64] with a padding bias, one decode attention
   [8,8,1,64] against 128 keys), contiguous and in the model's strided
   [B,S,H,D] layout, by CUDA events over 200 back-to-back calls (the median
   of 5 repeats, taken in turns), beside one ``scaled_dot_product_attention``
   call on the same inputs as a control for the host's speed;
2. the host time of each step of the wrapper at the decode shape
   (``time.perf_counter`` over 2000 calls; steps this commit lacks are left
   out), and of the whole call on each layout;
3. serving: the 24 seeded requests of ``chip_smoke.py`` phase 5 at full
   width, bf16, through the kernels and through the plain attention in
   turns (kernel, plain, plain, kernel): generated tokens/s and decode-step
   p50 of each turn. The plain turns run no code of the kernels' wrappers,
   so they are the control for the host's speed.
"""

from __future__ import annotations

import os
import statistics
import sys
import time


def main() -> int:
    if len(sys.argv) != 2 or not os.path.isfile(
            os.path.join(sys.argv[1], "chip_smoke.py")):
        print(__doc__, file=sys.stderr)
        return 2
    tree = os.path.abspath(sys.argv[1])
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("port_ab.py: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deeplearning_cfn_tpu_torch import kernels
    from deeplearning_cfn_tpu_torch.ops import attention as attn

    cs.log(f"tree {tree}")
    cs.log(cs.card_line())
    kernels.build(kernels.KERNEL_NAMES)
    F = torch.nn.functional

    def inputs(sq, strided):
        g = torch.Generator(device="cuda").manual_seed(sq)

        def mk(s):
            shape = (8, s, 8, 64) if strided else (8, 8, s, 64)
            x = torch.randn(shape, generator=g, device="cuda").bfloat16()
            return x.transpose(1, 2) if strided else x

        q, k, v = mk(sq), mk(128), mk(128)
        keys = torch.arange(128, device="cuda")
        lengths = torch.randint(1, 129, (8,), generator=g, device="cuda")
        bias = torch.where(keys[None] < lengths[:, None], 0.0, -1e30)
        return q, k, v, bias.float()[:, None, None, :]

    cs.log("== wrapper per call, CUDA events (us, median of 5 turns)")
    for name, sq in (("encoder_self", 128), ("decode", 1)):
        q, k, v, bias = inputs(sq, False)
        qs, ks, vs, _ = inputs(sq, True)
        calls = {
            "contiguous": lambda: attn.flash_attention_forward(q, k, v, bias),
            "strided": lambda: attn.flash_attention_forward(qs, ks, vs, bias),
            "sdpa": lambda m=bias.bfloat16(): F.scaled_dot_product_attention(
                q, k, v, attn_mask=m),
        }
        got = {key: [] for key in calls}
        for turn in range(5):
            for key in (list(calls) if turn % 2 == 0 else list(calls)[::-1]):
                got[key].append(cs.time_fn(torch, calls[key]) * 1e3)
        cs.log(f"  {name:12s} " + "  ".join(
            f"{key} {statistics.median(ts):7.2f}" for key, ts in got.items()))

    cs.log("== wrapper steps at the decode shape, host perf_counter (us)")
    q, k, v, bias = inputs(1, False)
    qs, ks, vs, _ = inputs(1, True)
    b, h, sq, d = q.shape
    steps = [
        ("_check_shapes", lambda: attn._check_shapes(q, k, v, False)),
        ("_check_kernel_inputs", lambda: attn._check_kernel_inputs(q, k, v)),
        ("_kernel_bias", lambda: attn._kernel_bias(bias, b, h, sq, 128)),
        ("torch.empty", lambda: torch.empty((b, h, sq, d), dtype=q.dtype,
                                            device=q.device)),
        ("current_stream", lambda: torch.cuda.current_stream(
            q.device).cuda_stream),
        ("_bind", lambda: attn._bind("flash_attn_fwd", None)),
        ("_strides3 x3, strided", lambda: (
            attn._strides3(qs), attn._strides3(ks), attn._strides3(vs))),
    ]
    if hasattr(attn, "forward_variant"):
        st = {n: (t, attn._strides3(t)) for n, t in zip("qkv", (qs, ks, vs))}
        steps += [
            ("forward_variant", lambda: attn.forward_variant(q.dtype, sq, d)),
            ("_check_aligned", lambda: attn._check_aligned("decode", **st)),
        ]
    steps += [
        ("whole call, contiguous", lambda: attn.flash_attention_forward(
            q, k, v, bias)),
        ("whole call, strided", lambda: attn.flash_attention_forward(
            qs, ks, vs, bias)),
    ]
    for label, fn in steps:
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        dt = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
        cs.log(f"  {label:24s} {dt:7.2f}")

    cs.log("== serving, 24 requests, bf16 (turns kernel, plain, plain, kernel)")
    reqs = cs.make_requests()
    for impl in ("kernel", "reference", "reference", "kernel"):
        engine = cs.build_engine(cs.smoke_cfg("bfloat16"), impl)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for rid, src, budget, beam in reqs:
            engine.submit(src, max_new_tokens=budget, beam_size=beam,
                          request_id=rid)
        engine.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tokens = sum(len(engine.poll(rid).tokens) for rid, *_ in reqs)
        snap = engine.metrics.snapshot()
        cs.log(f"  {impl:9s} tokens/s {tokens / wall:8.2f}  decode-step p50 "
               f"{snap['serve_step_latency_p50_s'] * 1e3:7.3f} ms  "
               f"({tokens} tokens, {engine.decoder_steps} decoder steps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
