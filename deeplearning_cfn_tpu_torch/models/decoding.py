"""Offline KV-cached decoders for the NMT workload: greedy and beam search.

The port of ``greedy_decode_cached`` / ``beam_decode_cached`` from
``deeplearning_cfn_tpu/models/decoding.py`` — the oracles the serving
engine's parity tests compare against. The encoder runs once; each step is
one ``decode_step`` against per-layer caches updated in place. A fixed-
length loop over target positions with a ``done`` mask freezes finished
sequences, exactly as the JAX ``lax.scan`` does.

Beam candidate selection keeps the JAX tie-breaking: ``jax.lax.top_k``
puts the lower flat index first among equal scores, which a stable
descending sort reproduces (``torch.topk`` does not promise it).

Special ids: 0=[PAD], 1=[BOS], 2=[EOS].
"""

from __future__ import annotations

from typing import Tuple

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
    dev = src_ids.device
    enc = model.encode(src_ids, src_mask)
    enc_b = enc.repeat_interleave(w, dim=0)
    mask_b = src_mask.repeat_interleave(w, dim=0)
    cache = model.init_cache(b * w)
    tokens = torch.full((b, w, max_len + 1), PAD_ID, dtype=torch.long,
                        device=dev)
    tokens[:, :, 0] = BOS_ID
    scores = torch.full((b, w), -1e9, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    done = torch.zeros((b, w), dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    for t in range(max_len):
        prev = tokens[:, :, t].reshape(b * w, 1)
        logits = model.decode_step(prev, enc_b, mask_b, t, cache)
        logp = torch.log_softmax(logits[:, 0, :].float(), dim=-1)
        v = logp.shape[-1]
        logp = logp.view(b, w, v)
        logp = torch.where(done[:, :, None], pad_only_logp(v, dev), logp)
        cand = scores[:, :, None] + logp
        scores, top_flat = top_k_stable(cand.view(b, w * v), w)
        beam_idx = top_flat // v
        tok_idx = top_flat % v
        tokens = tokens[rows, beam_idx]
        tokens[:, :, t + 1] = tok_idx
        done = done[rows, beam_idx] | (tok_idx == EOS_ID)
        flat_idx = (rows * w + beam_idx).reshape(-1)
        for ck, cv in cache:
            ck.copy_(ck[flat_idx])
            cv.copy_(cv[flat_idx])
    return _gnmt_best(tokens, scores, length_penalty)


def strip_special(ids) -> list:
    """Token-id row → python list up to (excluding) EOS, dropping PAD/BOS."""
    out = []
    for t in [int(x) for x in ids]:
        if t == EOS_ID:
            break
        if t not in (PAD_ID, BOS_ID):
            out.append(t)
    return out
