"""Offline decoders — the port of
``deeplearning_cfn_tpu/models/decoding.py``.

- The NMT searchers, greedy and beam, in the two drive modes of the JAX
  package: *cached* (``greedy_decode_cached``/``beam_decode_cached``, one
  ``decode_step`` per position against per-layer caches updated in place;
  the oracles the serving engine's parity tests compare against) and
  *recompute* (``greedy_decode``/``beam_decode``, the full teacher-forced
  decoder over the growing prefix each step, ``eval.use_kv_cache=false``).
  The encoder runs once. A fixed-length loop over target positions with a
  ``done`` mask freezes finished sequences, exactly as the JAX
  ``lax.scan`` does.
- ``lm_generate`` for the causal LM family: cached through the model's
  ``decode_step``, or recomputing the full causal forward for a model
  without one; greedy, or temperature sampling with a top-k cut.

Beam candidate selection keeps the JAX tie-breaking: ``jax.lax.top_k``
puts the lower flat index first among equal scores, which a stable
descending sort reproduces (``torch.topk`` does not promise it).

Special ids: 0=[PAD], 1=[BOS], 2=[EOS].
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

PAD_ID, BOS_ID, EOS_ID = 0, 1, 2


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, ties broken to the lower index (the
    ``jax.lax.top_k`` order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def pad_only_logp(v: int, device) -> torch.Tensor:
    """The continuation row of a finished beam: PAD at zero cost, everything
    else at -1e9."""
    row = torch.full((v,), -1e9, dtype=torch.float32, device=device)
    row[PAD_ID] = 0.0
    return row


@torch.no_grad()
def greedy_decode(model, src_ids: torch.Tensor, src_mask: torch.Tensor,
                  max_len: int) -> torch.Tensor:
    """Recompute-mode :func:`greedy_decode_cached`: each step runs the whole
    teacher-forced decoder over the prefix (O(T²) attention, no cache) and
    reads position ``t``. Same output."""
    enc = model.encode(src_ids, src_mask)
    b = src_ids.shape[0]
    tokens = torch.full((b, max_len + 1), PAD_ID, dtype=torch.long,
                        device=src_ids.device)
    tokens[:, 0] = BOS_ID
    done = torch.zeros((b,), dtype=torch.bool, device=src_ids.device)
    for t in range(max_len):
        logits = model.decode(tokens[:, :-1], enc, src_mask)
        nxt = torch.argmax(logits[:, t, :], dim=-1)
        nxt = torch.where(done, torch.full_like(nxt, PAD_ID), nxt)
        tokens[:, t + 1] = nxt
        done = done | (nxt == EOS_ID)
    return tokens[:, 1:]


@torch.no_grad()
def greedy_decode_cached(model, src_ids: torch.Tensor, src_mask: torch.Tensor,
                         max_len: int) -> torch.Tensor:
    """Argmax decoding → token ids [B, max_len] (PAD after EOS; the EOS
    itself is kept). ``max_len`` must be <= the model's ``max_len``."""
    enc = model.encode(src_ids, src_mask)
    b = src_ids.shape[0]
    cache = model.init_cache(b)
    tokens = torch.full((b, max_len), PAD_ID, dtype=torch.long,
                        device=src_ids.device)
    prev = torch.full((b, 1), BOS_ID, dtype=torch.long, device=src_ids.device)
    done = torch.zeros((b,), dtype=torch.bool, device=src_ids.device)
    for t in range(max_len):
        logits = model.decode_step(prev, enc, src_mask, t, cache)
        nxt = torch.argmax(logits[:, 0, :], dim=-1)
        nxt = torch.where(done, torch.full_like(nxt, PAD_ID), nxt)
        tokens[:, t] = nxt
        done = done | (nxt == EOS_ID)
        prev = nxt[:, None]
    return tokens


def _gnmt_best(tokens, scores, length_penalty):
    lengths = (tokens[:, :, 1:] != PAD_ID).sum(-1).float()
    norm = ((5.0 + lengths) / 6.0) ** length_penalty
    best = torch.argmax(scores / torch.clamp(norm, min=1e-6), dim=1)
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    return tokens[rows, best, 1:], scores[rows, best]


def _beam_select(tokens, scores, done, logits, t, rows):
    """One beam step from the [B·W, V] logits of position ``t``: f32
    log-probs, the PAD-only row for finished beams, the top W of the
    B × (W·V) candidates (ties to the lower index). Returns the reordered
    tokens with position ``t + 1`` set, the new scores and done flags, and
    the surviving beams' parents [B, W]."""
    b, w = scores.shape
    logp = torch.log_softmax(logits.float(), dim=-1)
    v = logp.shape[-1]
    logp = logp.view(b, w, v)
    logp = torch.where(done[:, :, None], pad_only_logp(v, logp.device), logp)
    cand = scores[:, :, None] + logp
    scores, top_flat = top_k_stable(cand.view(b, w * v), w)
    beam_idx = top_flat // v
    tok_idx = top_flat % v
    tokens = tokens[rows, beam_idx]
    tokens[:, :, t + 1] = tok_idx
    done = done[rows, beam_idx] | (tok_idx == EOS_ID)
    return tokens, scores, done, beam_idx


def _beam_start(b, w, max_len, dev):
    tokens = torch.full((b, w, max_len + 1), PAD_ID, dtype=torch.long,
                        device=dev)
    tokens[:, :, 0] = BOS_ID
    # All beams start identical: only beam 0 is live at t=0, or every beam
    # would pick the same argmax forever.
    scores = torch.full((b, w), -1e9, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    done = torch.zeros((b, w), dtype=torch.bool, device=dev)
    return tokens, scores, done, torch.arange(b, device=dev)[:, None]


@torch.no_grad()
def beam_decode(model, src_ids: torch.Tensor, src_mask: torch.Tensor,
                max_len: int, beam_size: int = 4,
                length_penalty: float = 0.6
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recompute-mode :func:`beam_decode_cached`: each step runs the whole
    teacher-forced decoder over every beam's prefix. Same output."""
    b = src_ids.shape[0]
    w = beam_size
    enc = model.encode(src_ids, src_mask)
    enc_b = enc.repeat_interleave(w, dim=0)
    mask_b = src_mask.repeat_interleave(w, dim=0)
    tokens, scores, done, rows = _beam_start(b, w, max_len, src_ids.device)
    for t in range(max_len):
        flat = tokens.reshape(b * w, max_len + 1)
        logits = model.decode(flat[:, :-1], enc_b, mask_b)[:, t, :]
        tokens, scores, done, _ = _beam_select(tokens, scores, done, logits,
                                               t, rows)
    return _gnmt_best(tokens, scores, length_penalty)


@torch.no_grad()
def beam_decode_cached(model, src_ids: torch.Tensor, src_mask: torch.Tensor,
                       max_len: int, beam_size: int = 4,
                       length_penalty: float = 0.6
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV-cached beam search → (tokens [B, max_len], scores [B]) for the best
    beam: log-prob accumulation in f32, PAD-only zero-cost continuation for
    finished beams, GNMT length normalization ((5+|Y|)/6)^alpha at the end.
    The cache rows live flattened [B*W, ...] and are re-gathered along the
    beam dim after each step's selection."""
    b = src_ids.shape[0]
    w = beam_size
    enc = model.encode(src_ids, src_mask)
    enc_b = enc.repeat_interleave(w, dim=0)
    mask_b = src_mask.repeat_interleave(w, dim=0)
    cache = model.init_cache(b * w)
    tokens, scores, done, rows = _beam_start(b, w, max_len, src_ids.device)
    for t in range(max_len):
        prev = tokens[:, :, t].reshape(b * w, 1)
        logits = model.decode_step(prev, enc_b, mask_b, t, cache)[:, 0, :]
        tokens, scores, done, beam_idx = _beam_select(
            tokens, scores, done, logits, t, rows)
        flat_idx = (rows * w + beam_idx).reshape(-1)
        for ck, cv in cache:
            ck.copy_(ck[flat_idx])
            cv.copy_(cv[flat_idx])
    return _gnmt_best(tokens, scores, length_penalty)


@torch.no_grad()
def lm_generate(model, prompt_ids: torch.Tensor, max_new_tokens: int,
                temperature: float = 0.0, top_k: int = 0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Autoregressive generation for the causal LM family
    (``models/lm.py``): ``prompt_ids`` [B, P] → [B, P + max_new_tokens].

    A model with ``decode_step`` is driven *cached*: every position from 0
    goes through ``decode_step`` against the KV caches, and at a prompt
    position the real next prompt token replaces the model's choice. A
    model without one is driven in *recompute* mode: the full causal
    forward over the whole token buffer each step, reading position ``t``
    (the not-yet-filled tail is inert under the causal mask), from the
    last prompt position on. ``temperature == 0`` is greedy argmax (ties to
    the lowest id); otherwise softmax sampling at that temperature from
    ``generator`` (required), optionally cut to the logits ``>=`` the
    ``top_k``-th largest, so ties at the cut survive. The draws cannot
    follow ``jax.random``'s stream; greedy output equals the JAX
    package's."""
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs an rng (a "
                         "torch.Generator)")
    b, p = prompt_ids.shape
    total = p + max_new_tokens
    max_len = getattr(model, "max_len", None)
    if max_len is not None and total > max_len:
        raise ValueError(
            f"prompt ({p}) + max_new_tokens ({max_new_tokens}) = {total} "
            f"exceeds the model's max_len ({max_len})")
    cached = hasattr(type(model), "decode_step")
    cache = model.init_cache(b) if cached else None
    tokens = torch.zeros((b, total), dtype=torch.long,
                         device=prompt_ids.device)
    tokens[:, :p] = prompt_ids
    for t in range(0 if cached else p - 1, total - 1):
        if cached:
            logits = model.decode_step(tokens[:, t:t + 1], t, cache)[:, 0]
        else:
            logits = model(tokens, train=False)[:, t]
        if t + 1 < p:
            continue  # a prompt position keeps its real token
        if temperature > 0.0:
            scaled = logits / temperature
            if top_k > 0:
                kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
                scaled = torch.where(scaled < kth,
                                     torch.full_like(scaled, -math.inf),
                                     scaled)
            nxt = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                    generator=generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        tokens[:, t + 1] = nxt
    return tokens


def strip_special(ids) -> list:
    """Token-id row → python list up to (excluding) EOS, dropping PAD/BOS."""
    out = []
    for t in [int(x) for x in ids]:
        if t == EOS_ID:
            break
        if t not in (PAD_ID, BOS_ID):
            out.append(t)
    return out
