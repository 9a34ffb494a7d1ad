"""Serving benchmark scenario: a fixed request trace through the engine.

The port of the JAX package's ``serve/bench.py``. One JSON record in the
BENCH_* contract shape ({"metric", "value", "unit", "vs_baseline", "mfu",
"measured"} + diagnostics) measuring continuous-batching decode
throughput (tokens/sec) and request latency (p50/p95) over a deterministic
synthetic trace on a tiny random-init NMT model. Checkpoint-free: the
model's weights come from :func:`tiny_model`, drawn from a
``torch.Generator`` seeded with ``seed`` on the device the bench runs on
(the JAX bench draws them from ``PRNGKey(seed)``; a test carries those in
by replacing :func:`tiny_model`).

The record's diagnostics carry the knobs the perf trajectory needs to
attribute wins: the decode-window size the run used and per-step decode
latency p50/p95 (the dispatch-amortization signal windows exist to move).

``cli bench --serve`` prints this record; ``--smoke`` is the fast mode
(few requests, tiny budget — same contract shape, seconds on the CPU).
"""

from __future__ import annotations

import time
from typing import Dict, Union

import numpy as np
import torch

from ..runtime.platform import resolve_device
from .engine import Engine
from .metrics import percentile
from .queue import OverloadError

METRIC = "serve_tiny_nmt_tokens_per_sec"
UNIT = "tokens/sec"

# The window size `bench --serve` defaults to (the JAX bench's choice on
# its fixed trace: K=4 keeps admission latency at 4 steps worst-case).
DEFAULT_DECODE_WINDOW = 4

#: The tiny bench model's geometry (``transformer_nmt_tiny``, f32).
TINY_VOCAB = 96
TINY_MAX_LEN = 64


def tiny_model(seed: int, device: torch.device) -> torch.nn.Module:
    """The bench's tiny NMT (vocab :data:`TINY_VOCAB`, ``max_len``
    :data:`TINY_MAX_LEN`, f32) on ``device``, with Flax's init
    distributions drawn from a ``torch.Generator`` on ``device`` seeded
    with ``seed``. Every bench (serve, fleet, the net fleet's children and
    their reference) builds its model here."""
    from ..models.transformer_nmt import init_weights, transformer_nmt_tiny

    model = transformer_nmt_tiny(vocab_size=TINY_VOCAB,
                                 max_len=TINY_MAX_LEN, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    init_weights(model, gen)
    return model.requires_grad_(False)


def device_name(device: torch.device) -> str:
    """The record's ``device``: ``"gpu"`` on the card, ``"cpu"`` on the
    CPU (the JAX bench's ``jax.default_backend()`` vocabulary)."""
    return "gpu" if device.type == "cuda" else device.type


def _fixed_trace(num_requests: int, src_len: int, vocab_size: int,
                 reserved: int = 3, seed: int = 0,
                 prefix_dup: float = 0.0):
    """Deterministic request trace: seeded lengths + token ids, so every
    run measures the same work. ``prefix_dup`` is the fraction of follow-up
    requests that repeat the first request's source (seeded draw) — the
    knob that gives the encoder prefix cache something to hit."""
    rng = np.random.RandomState(seed)
    trace = []
    for _ in range(num_requests):
        n = int(rng.randint(max(2, src_len // 2), src_len + 1))
        ids = rng.randint(reserved, vocab_size, size=n).astype(np.int32)
        trace.append([int(t) for t in ids])
    for i in range(1, num_requests):
        if rng.rand() < prefix_dup:
            trace[i] = list(trace[0])
    return trace


def _drain_trace(engine: Engine, trace, max_new_tokens: int,
                 beam_size: int):
    """Submit every trace request (stepping through backpressure) and run
    the engine to drain; returns (request ids, engine ticks)."""
    ids = []
    for src in trace:
        while True:
            try:
                ids.append(engine.submit(src,
                                         max_new_tokens=max_new_tokens,
                                         beam_size=beam_size).id)
                break
            except OverloadError:
                engine.step()  # backpressure: make room, then retry
    ticks = engine.run_until_drained()
    return ids, ticks


def _bound(ref: torch.Tensor, got: torch.Tensor):
    """(max |got - ref|, 0.1 * max(1, max |ref|), within): the relative
    bound both divergence checks use."""
    diff = float((got.float() - ref.float()).abs().max())
    bound = 0.1 * max(1.0, float(ref.float().abs().max()))
    return diff, bound, diff <= bound


def _kv_quant_divergence(model, src_len: int, vocab_size: int,
                         seed: int, steps: int = 8, block_size: int = 4):
    """Bounded logits-divergence check for the int8 KV cache: the same
    teacher-forced token sequence decoded step-by-step through the paged
    path with f32 blocks vs int8 blocks + per-block scales. Same relative
    bound as :func:`_quant_divergence`."""
    dev = model.device
    rng = np.random.RandomState(seed + 2)
    b = 2
    src = rng.randint(3, vocab_size, size=(b, src_len)).astype(np.int32)
    toks = rng.randint(3, vocab_size, size=(b, steps)).astype(np.int32)
    max_blocks = -(-steps // block_size)
    nb = b * max_blocks + 1  # + block 0, the null sentinel
    tables = torch.arange(1, nb, device=dev).view(b, max_blocks)
    src_t = torch.as_tensor(src, dtype=torch.long, device=dev)
    mask = torch.ones_like(src_t)
    toks_t = torch.as_tensor(toks, dtype=torch.long, device=dev)

    def run(kv_quant):
        cache = model.init_paged_cache(nb, block_size, kv_quant=kv_quant)
        with torch.no_grad():
            enc = model.encode(src_t, mask)
            return torch.cat([
                model.decode_step_paged(
                    toks_t[:, t:t + 1], enc, mask,
                    torch.full((b,), t, dtype=torch.long, device=dev),
                    tables, cache)
                for t in range(steps)], dim=1)

    return _bound(run(""), run("int8"))


def _quant_divergence(model, src_len: int, vocab_size: int, seed: int):
    """Bounded logits-divergence check for int8 weight-only serving: one
    forward pass f32 vs quantized on a fixed seeded batch. Returns
    (max_abs_diff, bound, ok) — the bound is relative to the f32 logit
    scale, so the check tracks the model rather than a magic constant."""
    from .quant import quantize_model

    dev = model.device
    rng = np.random.RandomState(seed + 1)
    src = rng.randint(3, vocab_size, size=(2, src_len)).astype(np.int32)
    tgt = rng.randint(3, vocab_size, size=(2, src_len)).astype(np.int32)
    src_t = torch.as_tensor(src, dtype=torch.long, device=dev)
    tgt_t = torch.as_tensor(tgt, dtype=torch.long, device=dev)
    mask = torch.ones_like(src_t)
    with torch.no_grad():
        ref = model(src_t, mask, tgt_t, train=False)
        q = quantize_model(model)(src_t, mask, tgt_t, train=False)
    return _bound(ref, q)


def run_serve_bench(num_requests: int = 16, slots: int = 4,
                    max_new_tokens: int = 16, beam_size: int = 1,
                    src_len: int = 12, seed: int = 0,
                    decode_window: int = DEFAULT_DECODE_WINDOW,
                    kv_block_size: int = 16, kv_blocks: int = 0,
                    prefix_cache: int = 16, prefix_dup: float = 0.0,
                    speculate: int = 0, speculate_device: bool = False,
                    draft: str = "self", quantize: str = "",
                    kv_quant: str = "",
                    smoke: bool = False,
                    accelerator: Union[str, torch.device] = "gpu") -> Dict:
    """Run the fixed trace to drain; return the BENCH-contract record.

    The JAX bench's parameters and record, on the device ``accelerator``
    names (``gpu``, the default, raises without a card). ``smoke=True``
    shrinks the scenario to a few tiny requests. ``speculate=γ`` turns on
    self-draft speculative decoding and re-runs the same trace through a
    plain-greedy reference engine to assert the token-identical contract
    (``token_identical``). ``speculate_device=True`` chains γ-windows on
    the device and additionally runs the host accept loop over the same
    trace, so the record carries both paths' host syncs per emitted token
    (``host_syncs_per_token`` vs ``host_syncs_per_token_host_path``).
    ``draft="tiny-distilled"`` swaps the self-draft for the committed
    distilled draft. ``quantize="int8"`` serves weight-only int8 and
    reports the weight/KV footprint next to f32 plus a bounded
    logits-divergence check; ``kv_quant="int8"`` stores the paged KV pool
    as int8 codes + per-block scales (``kv_divergence*``,
    ``kv_cache_bytes`` vs ``kv_cache_bytes_fp32``)."""
    from .quant import kv_pool_bytes, variables_bytes

    dev = resolve_device(accelerator)
    if smoke:
        num_requests, slots = min(num_requests, 4), min(slots, 2)
        max_new_tokens, src_len = min(max_new_tokens, 4), min(src_len, 8)

    model = tiny_model(seed, dev)
    engine_kwargs = dict(
        capacity=slots, max_src_len=src_len, queue_depth=num_requests,
        default_max_new_tokens=max_new_tokens,
        decode_window=decode_window, kv_block_size=kv_block_size,
        kv_blocks=kv_blocks, prefix_cache_size=prefix_cache,
        quantize=quantize, kv_quant=kv_quant)
    draft_model = None
    if draft and draft != "self":
        from .loader import distilled_draft

        draft_model = distilled_draft(draft, device=dev)
    engine = Engine(model, speculate_gamma=speculate,
                    speculate_device=speculate_device,
                    draft_model=draft_model, **engine_kwargs)
    trace = _fixed_trace(num_requests, src_len, TINY_VOCAB, seed=seed,
                         prefix_dup=prefix_dup)
    # Warmup outside the timed window: the kernels' first launches, the
    # allocator's first blocks, the admit path.
    engine.submit(trace[0], max_new_tokens=min(2, max_new_tokens),
                  beam_size=beam_size)
    engine.run_until_drained()
    warmup_tokens = engine.metrics.tokens_generated

    t0 = time.monotonic()
    ids, ticks = _drain_trace(engine, trace, max_new_tokens, beam_size)
    elapsed = time.monotonic() - t0

    # The speculative contract is "token-identical to plain greedy": rerun
    # the identical trace through a reference engine with speculation off
    # (same quantization) and compare every request's tokens. Outside the
    # timed window — it's a check, not work.
    token_identical = None
    if speculate > 0 and beam_size == 1:
        ref = Engine(model, speculate_gamma=0, **engine_kwargs)
        ref_ids, _ = _drain_trace(ref, trace, max_new_tokens, beam_size)
        token_identical = all(
            engine.poll(i).tokens == ref.poll(ri).tokens
            for i, ri in zip(ids, ref_ids))

    # With the device-resident chain on, also run the host accept loop
    # over the identical trace: both paths' host syncs per emitted token.
    host_path_syncs = None
    if speculate > 0 and speculate_device and beam_size == 1:
        host_eng = Engine(model, speculate_gamma=speculate,
                          draft_model=draft_model, **engine_kwargs)
        _drain_trace(host_eng, trace, max_new_tokens, beam_size)
        host_path_syncs = host_eng.metrics.spec_host_syncs_per_token

    divergence = bound = divergence_ok = None
    if quantize:
        divergence, bound, divergence_ok = _quant_divergence(
            model, src_len, TINY_VOCAB, seed)

    kv_divergence = kv_bound = kv_divergence_ok = None
    if kv_quant:
        kv_divergence, kv_bound, kv_divergence_ok = _kv_quant_divergence(
            model, src_len, TINY_VOCAB, seed)

    lat = [engine.poll(i).latency_s for i in ids
           if engine.poll(i).latency_s is not None]
    m = engine.metrics
    toks = m.tokens_generated - warmup_tokens  # minus the warmup request
    kv_cache_bytes = kv_cache_bytes_fp32 = None
    if engine.kv_blocks:
        kv_cache_bytes, kv_cache_bytes_fp32 = kv_pool_bytes(
            engine.cache, engine.kv_blocks)
    snap = m.snapshot()
    return {
        "metric": METRIC,
        "value": round(toks / elapsed, 2) if elapsed > 0 else None,
        "unit": UNIT,
        "vs_baseline": None,  # no serving baseline exists yet
        "mfu": None,  # decode-step MFU is not meaningful at tiny scale
        "measured": True,
        "p50_latency_s": percentile(lat, 50),
        "p95_latency_s": percentile(lat, 95),
        "ttft_p50_s": percentile(m.ttft_s, 50),
        "ttft_p95_s": percentile(m.ttft_s, 95),
        "queue_wait_p50_s": percentile(m.queue_wait_s, 50),
        "queue_wait_p95_s": percentile(m.queue_wait_s, 95),
        "step_latency_p50_s": percentile(m.step_latency_s, 50),
        "step_latency_p95_s": percentile(m.step_latency_s, 95),
        "decode_window": engine.decode_window,
        "requests": num_requests,
        "slots": slots,
        "beam_size": beam_size,
        "max_new_tokens": max_new_tokens,
        "engine_steps": ticks,
        "decode_steps": m.steps,
        "smoke": smoke,
        "mean_slot_occupancy": round(m.mean_slot_occupancy or 0.0, 4),
        "kv_block_size": kv_block_size,
        "kv_blocks": engine.kv_blocks,
        "kv_block_utilization": None if m.kv_block_utilization is None
        else round(m.kv_block_utilization, 4),
        "prefix_dup": prefix_dup,
        "prefix_hit_rate": m.prefix_hit_rate,
        "encoder_invocations": engine.encoder_invocations,
        "admitted": m.admitted,
        "spec_gamma": speculate,
        "spec_accept_rate": None if m.spec_accept_rate is None
        else round(m.spec_accept_rate, 4),
        "tokens_per_target_step": None
        if m.spec_tokens_per_target_step is None
        else round(m.spec_tokens_per_target_step, 4),
        "token_identical": token_identical,
        "speculate_device": speculate_device,
        "draft": draft,
        "spec_chain_len_p50": snap.get("serve_spec_chain_len_p50"),
        "host_syncs_per_token": None
        if m.spec_host_syncs_per_token is None
        else round(m.spec_host_syncs_per_token, 4),
        "host_syncs_per_token_host_path": None if host_path_syncs is None
        else round(host_path_syncs, 4),
        "quantize": quantize,
        "weight_bytes": variables_bytes(engine.model),
        "weight_bytes_fp32": variables_bytes(model),
        "kv_bytes": int(sum(t.numel() * t.element_size()
                            for layer in engine.cache for t in layer)),
        "logits_divergence": None if divergence is None
        else round(divergence, 6),
        "divergence_bound": None if bound is None else round(bound, 6),
        "divergence_ok": divergence_ok,
        "kv_quant": kv_quant,
        "kv_cache_bytes": kv_cache_bytes,
        "kv_cache_bytes_fp32": kv_cache_bytes_fp32,
        "kv_divergence": None if kv_divergence is None
        else round(kv_divergence, 6),
        "kv_divergence_bound": None if kv_bound is None
        else round(kv_bound, 6),
        "kv_divergence_ok": kv_divergence_ok,
        "device": device_name(dev),
    }
