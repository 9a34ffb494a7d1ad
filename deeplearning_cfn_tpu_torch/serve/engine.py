"""Continuous-batching inference engine over the KV-cache decoder.

The port of ``deeplearning_cfn_tpu/serve/engine.py``. A fixed-capacity
**slot table** of KV-cache rows is driven by decode steps against per-row
positions (``decode_step_at`` / ``greedy_step_at`` of
models/transformer_nmt.py): queued requests are admitted into free rows
mid-flight, rows are evicted the moment their request hits EOS / budget /
deadline, and recycled without stalling their neighbours. Row recycling
needs no cache zeroing: the per-row step bias only exposes positions
``<= pos[row]``.

What is ported:

- greedy and beam search (beam candidate selection replicates
  models/decoding.py: f32 log-softmax, PAD-only zero-cost continuation for
  finished beams, flattened top-k with lower-index tie-breaking, GNMT
  length norm for the final pick);
- the fused greedy window: up to ``decode_window`` greedy steps per tick
  with argmax, EOS/budget/cache-exhaustion detection and prev/pos advance
  on the device, surfacing only [K, capacity] tokens and done marks to the
  host (a Python loop over ``greedy_step_*`` where JAX uses ``lax.scan``);
- dense per-row KV rows or the paged block pool (block 0 = null sentinel,
  token-budget admission, copy-on-write beam forks) — bit-identical to each
  other when the block size divides ``max_len``;
- the encoder prefix cache, cancel, deadlines and overload backpressure;
- speculative decoding (``speculate_gamma``): a draft model — the target
  itself unless ``draft_model`` is given — proposes γ tokens per row, the
  target scores all γ+1 positions in one ``decode_span_*`` call, and the
  accept-prefix rule keeps the output token-identical to plain greedy. The
  host path surfaces [capacity, 2γ+1] ids per window; with
  ``speculate_device`` windows are chained on the device (accept and
  advance included) with one host sync per chain. Beams and deadlines take
  the plain paths, tick by tick;
- the radix token-prefix KV cache (``radix_cache``, paged engines): finished
  greedy streams donate their full decoder blocks to a per-source tree
  (serve/radix.py) and a later same-source request completes from it or
  resumes at the block boundary;
- chunked prefill (``prefill_chunk``): admission encodes ``prefill_chunk``
  source tokens per tick (provisional partial encodes), then the
  full-source encode at completion, so tokens equal the one-shot path's;
- multi-tenant QoS (``qos_classes``, ``tenant`` / ``qos_class`` on submit):
  weighted fair share in the queue, and a blocked higher-priority head
  preempts a best-effort group, which restarts from scratch later (the
  tokens it had emitted are kept for the zero-loss audit);
- int8 serving: ``quantize="int8"`` serves a weight-only int8 copy of the
  model (serve/quant.py; a distinct draft is quantized too), and
  ``kv_quant="int8"`` (paged engines) keeps the target's block pool as int8
  codes with per-block, per-head scales — the draft's pool stays float.
  Every block-keyed move (beam copy-on-write) carries the scales with the
  codes;
- ``swap_variables`` (an idle engine's weight swap, requantized under
  ``quantize``) and the brownout knobs ``_degrade_no_spec`` and
  ``_degrade_window_cap`` that the fleet's degrade controller sets;
- disaggregated serving (``phase``, paged engines): a ``"prefill"`` engine
  runs admission prefill and exactly one decode step per request, then
  parks it with its rows and blocks bound; :meth:`Engine.export_handoff`
  serializes the parked state (serve/handoff.py), a ``"decode"`` engine
  resumes it with :meth:`Engine.import_handoff` — into its own pool, no
  encoder call — and :meth:`Engine.release_handoff` frees the prefill
  side. The artifact's ``kv_<i>`` leaves follow the JAX package's cache
  tree order, so artifacts cross between the two packages both ways.

The KV caches, the encoder tables and the source-mask table are updated in
place (the JAX engine donates them into each device call for the same
effect). The draft model carries its own weights (the JAX engine's
``draft_variables``).

Every device call is counted for the launch audit: ``encoder_forwards``
(target encoder applications, the constructor's warmup included),
``partial_encodes`` (chunked-prefill encodes), ``decoder_steps``
(single-position decode steps), ``verify_steps`` (speculative verify spans),
``draft_steps`` and ``draft_encoder_forwards`` (the distinct draft's own
encoder). On the card every encode launches the flash kernel once per
encoder layer, and every decoder, verify or draft step twice per decoder
layer of its model.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.decoding import (BOS_ID, EOS_ID, PAD_ID, pad_only_logp,
                               top_k_stable)
from ..obs.trace import span
from .blockpool import BlockAllocator
from .handoff import (as_tensor, kv_leaf_count, pack_meta,
                      validate_artifact)
from .metrics import ServeMetrics
from .prefix import PrefixCache, unpadded_key
from .quant import (check_kv_quant_dtype, dequantize_kv_blocks,
                    kv_pool_bytes, quantize_model, quantize_state_dict)
from .queue import DeadlineExceededError, OverloadError, QosSpec, Request, \
    RequestQueue, RequestState
from .radix import RadixCache


def pool_leaf_slots(cache) -> List[tuple]:
    """``(layer, part)`` of every block-pool tensor of a paged cache, in
    the JAX package's cache-tree leaf order — the order of a handoff
    artifact's ``kv_<i>`` leaves. The JAX tree sorts its keys: layers by
    the name ``dec_<i>``, and within a layer ``cached_key``,
    ``cached_key_scale``, ``cached_value``, ``cached_value_scale``. The
    port's per-layer tuple is ``(k, v)`` or, int8, ``(k, v, k scale, v
    scale)``: ``part`` indexes it."""
    slots = []
    for i in sorted(range(len(cache)), key=lambda i: f"dec_{i}"):
        parts = (0, 2, 1, 3) if len(cache[i]) == 4 else (0, 1)
        slots.extend((i, p) for p in parts)
    return slots


def _host(t: torch.Tensor):
    """A device tensor as an artifact leaf: a numpy array, or a CPU torch
    tensor for bfloat16 (numpy has none; serve/handoff.py encodes it)."""
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


@dataclass
class _Group:
    """Host-side bookkeeping for one RUNNING request (1 or beam_size rows)."""

    req: Request
    rows: List[int]
    budget: int  # decode-step budget (< model.max_len)
    steps: int = 0
    # Row-steps that produced a token, kept or not — the goodput/waste
    # ledger's denominator.
    decoded: int = 0
    # Beam state (beam_size > 1): replicates beam_decode_cached's carry.
    # beam_tokens column 0 is BOS, column t+1 the step-t choice.
    scores: Optional[np.ndarray] = None
    beam_done: Optional[np.ndarray] = None
    beam_tokens: Optional[np.ndarray] = None
    # Paged mode: worst-case KV blocks reserved at admission.
    committed_blocks: int = 0
    # Radix cache: tokens resumed from cached blocks (never decoded here,
    # so not goodput) and how many bound blocks came shared from the tree.
    radix_hit_tokens: int = 0
    radix_shared_blocks: int = 0
    # Chunked prefill: source tokens the chunk quota has covered and chunk
    # ticks taken. The group waits in ``_prefilling`` until the cursor
    # covers its source.
    prefill_cursor: int = 0
    chunk_ticks: int = 0
    # Disaggregated serving: decode steps this group arrived with through
    # a KV handoff (decoded, and ledgered, on the prefill engine).
    imported_tokens: int = 0


class Engine:
    """Continuous-batching serving engine for the NMT encoder-decoder.

    ``model`` is a :class:`~..models.transformer_nmt.TransformerNMT` with
    its weights, on the device the engine runs on; ``draft_model`` (same
    vocab, ``max_len`` at least the target's, same device) drafts for
    speculation. ``capacity`` is the number of KV-cache rows; ``max_src_len``
    the fixed source padding every request is encoded at. :meth:`step` runs
    one decode window over all rows with admission/eviction around it;
    :meth:`run_until_drained` loops it.
    """

    def __init__(self, model, capacity: int = 4, max_src_len: int = 0,
                 queue_depth: int = 64, default_max_new_tokens: int = 64,
                 length_penalty: float = 0.6, decode_window: int = 1,
                 kv_block_size: int = 0, kv_blocks: int = 0,
                 prefix_cache_size: int = 0,
                 radix_cache: bool = False,
                 speculate_gamma: int = 0,
                 speculate_device: bool = False,
                 draft_model=None,
                 quantize: str = "",
                 kv_quant: str = "",
                 phase: str = "both",
                 clock=time.monotonic,
                 metrics: Optional[ServeMetrics] = None,
                 retry_after_floor_s: Optional[float]
                 = RequestQueue.DEFAULT_RETRY_AFTER_FLOOR_S,
                 qos_classes: Optional[Dict[str, QosSpec]] = None,
                 prefill_chunk: int = 0):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if decode_window <= 0:
            raise ValueError(
                f"decode_window must be positive, got {decode_window}")
        if speculate_gamma < 0:
            raise ValueError(
                f"speculate_gamma must be >= 0, got {speculate_gamma}")
        if speculate_device and speculate_gamma <= 0:
            raise ValueError(
                "speculate_device requires speculate_gamma > 0 — there "
                "is no speculative loop to move on-device")
        # Disaggregated phase: "both" is the co-located engine; "prefill"
        # prefills, runs one decode step per request and parks it for the
        # KV handoff; "decode" also imports handoffs and resumes them.
        self.phase = str(phase or "both")
        if self.phase not in ("both", "prefill", "decode"):
            raise ValueError(
                f"phase must be 'both', 'prefill' or 'decode', got "
                f"{phase!r}")
        if self.phase != "both" and int(kv_block_size) <= 0:
            raise ValueError(
                "disaggregated phases require the paged KV path "
                "(kv_block_size > 0) — the handoff artifact is "
                "block-structured")
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0, got {prefill_chunk}")
        if self.prefill_chunk > 0 and self.phase != "both":
            raise ValueError(
                "chunked prefill is a co-located-engine feature — "
                "disaggregated phases already split prefill off the "
                "decode tick")
        # Int8 weights: the engine owns the quantized copy, so that
        # swap_variables can requantize an incoming f32 state.
        self.quantize = str(quantize or "")
        if self.quantize:
            model = quantize_model(model, self.quantize)
            if draft_model is not None:
                draft_model = quantize_model(draft_model, self.quantize)
        # Int8 KV: paged only, since the quantization grid is the pool
        # block. Only the target's pool is int8.
        self.kv_quant = str(kv_quant or "")
        if self.kv_quant:
            if int(kv_block_size) <= 0:
                raise ValueError(
                    "kv_quant requires the paged KV path "
                    "(kv_block_size > 0) — the quantization grid is per "
                    "pool block")
            check_kv_quant_dtype(self.kv_quant)
        self.model = model
        self.device = model.device
        self.capacity = capacity
        self.decode_window = int(decode_window)
        # Brownout knobs, set by the fleet's degrade controller (or by
        # hand). Neither changes an emitted token: speculation and fused
        # windows are exact accelerations of the plain greedy path.
        self._degrade_no_spec = False
        self._degrade_window_cap: Optional[int] = None
        self.model_max_len = int(getattr(model, "max_len", 0) or 0)
        if self.model_max_len <= 0:
            raise ValueError("model must expose max_len (the KV-cache size)")
        self.max_src_len = int(max_src_len) if max_src_len else \
            self.model_max_len
        # Position max_len - 1 is the last writable KV slot, so budgets are
        # clamped to max_len - 1.
        self.default_max_new_tokens = min(default_max_new_tokens,
                                          self.model_max_len - 1)
        self.length_penalty = length_penalty
        self._clock = clock
        self.queue = RequestQueue(max_depth=queue_depth, clock=clock,
                                  retry_after_floor_s=retry_after_floor_s,
                                  qos_classes=qos_classes)
        self.metrics = metrics if metrics is not None \
            else ServeMetrics(capacity, clock=clock)
        self.metrics.configure_request_ledger()
        if self.prefill_chunk > 0:
            self.metrics.configure_chunked_prefill(self.prefill_chunk)
            # The overload hint stretches by the queued prompt-token
            # backlog over this quota.
            self.queue.configure_prefill_chunk(self.prefill_chunk)
        # The QoS metrics appear at construction for an explicit policy,
        # else at the first tenant-tagged submit.
        if self.queue.qos_active:
            self.metrics.configure_qos()

        # Speculative decoding: without a draft_model the target drafts for
        # itself (acceptance is then total: the γ+1 tokens-per-verify
        # ceiling).
        self.speculate_gamma = int(speculate_gamma)
        self.speculate_device = bool(speculate_device)
        self._self_draft = draft_model is None
        self.draft_model = None
        if self.speculate_gamma > 0:
            self.draft_model = self.model if draft_model is None \
                else draft_model
            draft_max_len = int(getattr(self.draft_model, "max_len", 0)
                                or 0)
            if draft_max_len < self.model_max_len:
                raise ValueError(
                    f"draft max_len {draft_max_len} is shorter than the "
                    f"target's {self.model_max_len} — the draft must be "
                    f"able to reach every target position")
            draft_vocab = int(getattr(self.draft_model, "vocab_size", 0)
                              or 0)
            tgt_vocab = int(getattr(model, "vocab_size", 0) or 0)
            if draft_vocab != tgt_vocab:
                raise ValueError(
                    f"draft vocab_size {draft_vocab} != target's "
                    f"{tgt_vocab} — proposals would not be comparable")
            if self.draft_model.device != self.device:
                raise ValueError(
                    f"draft model is on {self.draft_model.device}, the "
                    f"target on {self.device}")
            self.metrics.configure_speculation(self.speculate_gamma)
            self.metrics.configure_spec_chain(self.speculate_device)

        # Paged KV: the gathered span (max_blocks * block_size) must equal
        # max_len — the paged-vs-dense bit-identity condition.
        self.kv_block_size = int(kv_block_size)
        self.paged = self.kv_block_size > 0
        cap = self.capacity
        if self.paged:
            if self.model_max_len % self.kv_block_size:
                raise ValueError(
                    f"kv_block_size {self.kv_block_size} must divide the "
                    f"model max_len {self.model_max_len} (the paged-vs-"
                    f"dense parity condition)")
            self.max_blocks_per_row = \
                self.model_max_len // self.kv_block_size
            # Default pool: capacity full rows plus the null sentinel.
            self.kv_blocks = int(kv_blocks) or \
                cap * self.max_blocks_per_row + 1
            self.allocator = BlockAllocator(self.kv_blocks,
                                            self.kv_block_size)
            self._block_tables = np.zeros((cap, self.max_blocks_per_row),
                                          np.int64)
            self._blocks_bound: List[List[int]] = [[] for _ in range(cap)]
            self.metrics.configure_kv_pool(self.allocator.usable_blocks,
                                           self.kv_block_size)
        else:
            self.kv_blocks = 0
            self.max_blocks_per_row = 0
            self.allocator = None
            self._block_tables = None
            self._blocks_bound = None
        self._prefix = PrefixCache(prefix_cache_size) \
            if prefix_cache_size > 0 else None
        if self._prefix is not None:
            self.metrics.configure_prefix_cache(prefix_cache_size)
        if radix_cache:
            if not self.paged:
                raise ValueError(
                    "radix_cache requires the paged KV path "
                    "(kv_block_size > 0) — cached prefixes are shared "
                    "pool blocks")
            if self.phase != "both":
                raise ValueError(
                    "radix_cache is a co-located-engine feature — "
                    "disaggregated phases hand blocks off instead of "
                    "retaining them")
            self.radix = RadixCache(self.kv_block_size)
            self.metrics.configure_radix()
        else:
            self.radix = None
        # Logical source encodes (one per admitted request that missed the
        # prefix cache) and the device-call tallies of the launch audit.
        self.encoder_invocations = 0
        self.encoder_forwards = 0
        self.partial_encodes = 0
        self.decoder_steps = 0
        self.verify_steps = 0
        self.draft_steps = 0
        self.draft_encoder_forwards = 0

        # Device state. One warmup encode at the admission batch shape
        # fixes the encoder table's width and dtype.
        s = self.max_src_len
        with torch.no_grad():
            zeros = torch.zeros((cap, s), dtype=torch.long,
                                device=self.device)
            enc1 = self._encode(zeros, zeros)
            # The draft cache follows the target's layout (the same block
            # tables index its own pools). Self-draft reads the target's
            # encoder table; a distinct draft has its own, refreshed by the
            # same admission prefill.
            self._enc_d = None
            self._draft_cache = None
            if self.speculate_gamma > 0:
                if not self._self_draft:
                    enc1d = self._encode_draft(zeros, zeros)
                    self._enc_d = torch.zeros(
                        (cap, s, enc1d.shape[-1]), dtype=enc1d.dtype,
                        device=self.device)
                dm = self.draft_model
                self._draft_cache = dm.init_paged_cache(
                    self.kv_blocks, self.kv_block_size) if self.paged \
                    else dm.init_cache(cap)
        self._enc = torch.zeros((cap, s, enc1.shape[-1]), dtype=enc1.dtype,
                                device=self.device)
        self._src_mask = torch.zeros((cap, s), dtype=torch.long,
                                     device=self.device)
        if self.paged:
            self.cache = model.init_paged_cache(
                self.kv_blocks, self.kv_block_size, kv_quant=self.kv_quant)
        else:
            self.cache = model.init_cache(cap)
        if self.kv_quant:
            stored, _ = kv_pool_bytes(self.cache, self.kv_blocks)
            self.metrics.configure_kv_quant(stored)
        # Host-side per-row state (scheduler-authoritative; uploaded into
        # each device call and refreshed from its outputs).
        self._prev = np.full((cap,), PAD_ID, np.int64)
        self._pos = np.zeros((cap,), np.int64)
        self._row_owner: List[Optional[str]] = [None] * cap
        self._groups: List[_Group] = []
        # Chunked prefill: admitted groups (rows owned, block commit held)
        # whose source encode is still in progress; no decode path runs
        # them until the full-source encode at completion.
        self._prefilling: List[_Group] = []
        # Prefill phase: groups whose one decode step ran, parked with
        # their rows and blocks bound until export_handoff +
        # release_handoff (or a cancel or expiry, _reap_parked). Later
        # ticks' device calls see their table rows as unbound (_tables),
        # so nothing is written into a parked block; the fused window
        # does reset their _prev mirror to PAD, so export rebuilds prev
        # from the group.
        self._handoff_ready: Dict[str, _Group] = {}

    # -- client surface ----------------------------------------------------

    def submit(self, src_ids: List[int],
               max_new_tokens: Optional[int] = None, beam_size: int = 1,
               deadline_s: Optional[float] = None,
               request_id: Optional[str] = None,
               trace_id: Optional[str] = None,
               tenant: Optional[str] = None,
               qos_class: Optional[str] = None) -> Request:
        """Validate + enqueue. Raises OverloadError when the queue is full
        (RateLimitError when a class's per-tenant rate limit rejects),
        ValueError on requests the engine could never place."""
        if not src_ids:
            raise ValueError("src_ids must be non-empty")
        if len(src_ids) > self.max_src_len:
            raise ValueError(
                f"source length {len(src_ids)} exceeds the engine's "
                f"max_src_len {self.max_src_len}")
        if beam_size > self.capacity:
            raise ValueError(
                f"beam_size {beam_size} exceeds the slot capacity "
                f"{self.capacity} — it could never be admitted")
        budget = min(max_new_tokens or self.default_max_new_tokens,
                     self.model_max_len - 1)
        if self.paged:
            peak = self._peak_blocks(beam_size, budget)
            if peak > self.allocator.usable_blocks:
                raise ValueError(
                    f"request needs {peak} KV blocks at peak but the pool "
                    f"only has {self.allocator.usable_blocks} usable — it "
                    f"could never be admitted")
        try:
            req = self.queue.submit(src_ids, budget, beam_size=beam_size,
                                    deadline_s=deadline_s,
                                    request_id=request_id,
                                    trace_id=trace_id,
                                    tenant=tenant, qos_class=qos_class)
        except OverloadError as e:
            if self.queue.qos_active:
                self.metrics.configure_qos()
            self.metrics.record_reject(e.retry_after_s)
            raise
        if self.queue.qos_active:
            self.metrics.configure_qos()
        self.metrics.record_submit()
        return req

    def poll(self, request_id: str) -> Request:
        return self.queue.poll(request_id)

    def cancel(self, request_id: str) -> bool:
        return self.queue.cancel(request_id)

    def slot_view(self) -> List[Optional[str]]:
        """Row → owning request id (None = free). For tests/diagnostics."""
        return list(self._row_owner)

    def swap_variables(self, state: Dict[str, torch.Tensor]) -> None:
        """Swap in new weights — the fleet rollout's checkpoint swap.

        ``state`` is an f32 state_dict in the port's key layout (what
        ``convert.params_from_flax`` returns); under ``quantize`` it is
        requantized first. The weights load in place, so a self-draft
        still aliases the target. Only legal on an idle engine: a request's
        KV was computed under the old weights. The encoder prefix cache and
        the radix cache hold old-weight outputs and are dropped."""
        if self._groups or self._prefilling or self.queue.depth > 0 \
                or self._handoff_ready:
            raise RuntimeError(
                f"swap_variables requires an idle engine "
                f"({len(self._groups)} running, "
                f"{len(self._prefilling)} prefilling, "
                f"{self.queue.depth} queued, "
                f"{len(self._handoff_ready)} parked for handoff) "
                f"— drain first")
        if self.quantize:
            state = quantize_state_dict(state, self.quantize)
        self.model.load_state_dict(state, strict=True)
        if self._prefix is not None:
            self._prefix = PrefixCache(self._prefix.max_entries)
        # Radix entries are old-weight decoder KV: resuming from them would
        # splice generations across checkpoints.
        self.reset_radix_cache()

    def reset_radix_cache(self) -> int:
        """Drop every radix-cached block. Returns blocks released; 0 when
        radix is off."""
        if self.radix is None:
            return 0
        dropped = self.radix.reset(self.allocator)
        self.metrics.record_radix_evictions("reset", dropped)
        self._radix_sync_gauges()
        return dropped

    def _radix_sync_gauges(self) -> None:
        if self.radix is not None:
            self.metrics.set_radix_size(self.radix.node_count,
                                        self.radix.block_count)

    @property
    def active_requests(self) -> int:
        return len(self._groups) + len(self._prefilling)

    @property
    def active_rows(self) -> int:
        return sum(1 for o in self._row_owner if o is not None)

    @property
    def handoff_pending(self) -> int:
        """Requests parked on this (prefill) engine awaiting handoff."""
        return len(self._handoff_ready)

    def handoff_ready(self, request_id: str) -> bool:
        return request_id in self._handoff_ready

    # -- device calls ------------------------------------------------------

    def _encode(self, src: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        self.encoder_forwards += 1
        return self.model.encode(src, mask)

    def _encode_partial(self, src: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
        self.partial_encodes += 1
        return self.model.encode_partial(src, mask)

    def _encode_draft(self, src: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
        self.draft_encoder_forwards += 1
        return self.draft_model.encode(src, mask)

    def _tables(self) -> Optional[torch.Tensor]:
        """The block tables for a device call. A parked row's entries go
        up as 0: its stray writes (every row runs each step) land in the
        null block, so the parked blocks keep exactly what the prefill
        step wrote — an int8 block would otherwise be requantized around
        a garbage vector before its export."""
        if not self.paged:
            return None
        tables = self._block_tables
        if self._handoff_ready:
            tables = tables.copy()
            for g in self._handoff_ready.values():
                tables[g.rows] = 0
        return torch.as_tensor(tables, device=self.device)

    def _logits_step(self, prev, pos, tables) -> torch.Tensor:
        self.decoder_steps += 1
        if self.paged:
            return self.model.decode_step_paged(
                prev[:, None], self._enc, self._src_mask, pos, tables,
                self.cache)
        return self.model.decode_step_at(prev[:, None], self._enc,
                                         self._src_mask, pos, self.cache)

    def _greedy_step(self, prev, pos, tables) -> torch.Tensor:
        self.decoder_steps += 1
        if self.paged:
            return self.model.greedy_step_paged(
                prev[:, None], self._enc, self._src_mask, pos, tables,
                self.cache)
        return self.model.greedy_step_at(prev[:, None], self._enc,
                                         self._src_mask, pos, self.cache)

    def _draft_step(self, prev, pos, tables) -> torch.Tensor:
        self.draft_steps += 1
        enc = self._enc if self._enc_d is None else self._enc_d
        if self.paged:
            return self.draft_model.greedy_step_paged(
                prev[:, None], enc, self._src_mask, pos, tables,
                self._draft_cache)
        return self.draft_model.greedy_step_at(
            prev[:, None], enc, self._src_mask, pos, self._draft_cache)

    def _verify(self, tgt_in, pos, tables) -> torch.Tensor:
        """The target's argmax at each of the span's γ+1 positions."""
        self.verify_steps += 1
        if self.paged:
            logits = self.model.decode_span_paged(
                tgt_in, self._enc, self._src_mask, pos, tables, self.cache)
        else:
            logits = self.model.decode_span_at(
                tgt_in, self._enc, self._src_mask, pos, self.cache)
        return torch.argmax(logits.float(), dim=-1)

    def _draft_propose(self, prev, pos, active, tables) -> torch.Tensor:
        """γ proposals per row [capacity, γ]. The draft runs γ+1 steps: it
        feeds ``prev`` then each of its own proposals, so its cache holds
        K/V at every position ``pos .. pos+γ`` — the bonus position of a
        fully accepted window included — and the next window's first write
        overwrites the one position whose token the target corrected. Only
        the last step's output is discarded."""
        max_len = self.model_max_len
        pad = torch.full_like(prev, PAD_ID)
        dprev, dpos = prev, pos
        props = []
        for _ in range(self.speculate_gamma + 1):
            nxt = self._draft_step(dprev, dpos, tables)
            dprev = torch.where(active, nxt, pad)
            dpos = torch.clamp(dpos + active.long(), max=max_len - 1)
            props.append(dprev)
        return torch.stack(props[:self.speculate_gamma], dim=1)

    # -- scheduler ---------------------------------------------------------

    def _free_rows(self) -> List[int]:
        return [r for r in range(self.capacity)
                if self._row_owner[r] is None]

    def _peak_blocks(self, w: int, budget: int) -> int:
        """Worst-case pool blocks a request can hold at once: every row
        fully extended over the budget, plus (beam only) one transient
        fresh tail block per row during a copy-on-write fork."""
        per_row = self.allocator.blocks_for_tokens(budget)
        return w * per_row + (w if w > 1 else 0)

    def _bind_rows(self, k: int) -> None:
        """Bind pool blocks to every active row to cover the next ``k``
        decode positions, drawing on the group's admission-time reservation
        (so :meth:`BlockAllocator.alloc` cannot fail here). Writes past the
        bound span land in the null block (table entries default 0)."""
        for g in self._groups:
            span_ = min(g.steps + k, g.budget)
            need = min(self.allocator.blocks_for_tokens(span_),
                       self.max_blocks_per_row)
            for r in g.rows:
                bound = self._blocks_bound[r]
                while len(bound) < need:
                    b = self.allocator.alloc()
                    self._block_tables[r, len(bound)] = b
                    bound.append(b)

    def _fork_beam_blocks(self, g: _Group, beam_idx, copy_dst: List[int],
                          copy_src: List[int]) -> None:
        """Copy-on-write block fork after a beam reorder (called after the
        step that wrote KV position ``g.steps``, before ``g.steps``
        advances). Fully-written prefix blocks are shared by refcount; only
        a partial tail block is copied (pairs appended to ``copy_dst`` /
        ``copy_src`` and executed in one batch after the group loop)."""
        s = g.steps
        bs = self.kv_block_size
        tail = s // bs
        tail_full = (s + 1) % bs == 0
        w = len(g.rows)
        beam_idx = [int(b) for b in beam_idx]
        old = {j: list(self._blocks_bound[g.rows[j]]) for j in range(w)}
        changed = [j for j in range(w) if beam_idx[j] != j]
        if not changed:
            return
        shared_upto = tail + 1 if tail_full else tail
        new_lists = {}
        for j in changed:
            anc = old[beam_idx[j]]
            new = []
            for b in anc[:shared_upto]:
                self.allocator.ref(b)
                new.append(b)
            if not tail_full:
                fresh = self.allocator.alloc()
                copy_dst.append(fresh)
                copy_src.append(anc[tail])
                new.append(fresh)
            new_lists[j] = new
        # Refs/allocs above, frees below: a row that is both ancestor and
        # replaced keeps its blocks alive through the handover.
        for j in changed:
            for b in old[j]:
                self.allocator.free(b)
        for j in changed:
            r = g.rows[j]
            self._blocks_bound[r] = new_lists[j]
            self._block_tables[r] = 0
            self._block_tables[r, :len(new_lists[j])] = new_lists[j]

    def _free_group_resources(self, group: _Group) -> None:
        """Return a group's rows + KV blocks to the scheduler/pool."""
        for r in group.rows:
            self._row_owner[r] = None
            self._prev[r] = PAD_ID
            self._pos[r] = 0
            if self.paged:
                for b in self._blocks_bound[r]:
                    self.allocator.free(b)
                self._blocks_bound[r] = []
                self._block_tables[r] = 0
        if self.paged:
            self.allocator.uncommit(group.committed_blocks)
            group.committed_blocks = 0

    def _radix_instant_complete(self, req: Request, tokens: List[int],
                                now: float) -> None:
        """A cached stream covers this request's whole response: admit and
        release at once, with no rows and no blocks. The ledger sees no
        decode work."""
        group = _Group(req=req, rows=[], budget=req.max_new_tokens)
        group.radix_hit_tokens = len(tokens)
        req.state = RequestState.RUNNING
        req.admitted_at = now
        if req.preempted_at is not None:
            req.preempted_s += now - req.preempted_at
            req.preempted_at = None
        else:
            self.metrics.record_admit(now - req.submitted_at)
        req.tokens = list(tokens)
        if req.first_token_at is None:
            req.first_token_at = now
            self.metrics.record_first_token(req.ttft_s)
        self.metrics.record_radix_lookup("instant", len(tokens))
        self._release(group, RequestState.DONE, now)

    def _radix_retire(self, group: _Group, state: RequestState,
                      now: float) -> None:
        """On release, before the blocks go back to the pool: a DONE greedy
        stream donates its fully-written blocks to the tree (each new node
        takes its own reference). Partial tail blocks are never donated."""
        if not group.rows or group.req.beam_size > 1:
            return
        r = group.rows[0]
        self.metrics.record_radix_blocks(group.radix_shared_blocks,
                                         len(self._blocks_bound[r]))
        if state is not RequestState.DONE:
            return
        bs = self.kv_block_size
        full = len(group.req.tokens) // bs
        if full <= 0:
            return
        self.radix.insert(
            unpadded_key(group.req.src_ids, PAD_ID),
            group.req.tokens[:full * bs], self._blocks_bound[r][:full],
            self.allocator, now, tenant=group.req.tenant)
        self._radix_sync_gauges()

    def _release(self, group: _Group, state: RequestState,
                 now: float) -> None:
        if self.radix is not None:
            self._radix_retire(group, state, now)
        self._free_group_resources(group)
        req = group.req
        req.state = state
        req.finished_at = now
        if group in self._groups:
            self._groups.remove(group)
        elif group in self._prefilling:
            self._prefilling.remove(group)  # cancelled/expired mid-chunking
        else:
            # Cancelled/expired while parked for handoff (_reap_parked).
            self._handoff_ready.pop(req.id, None)
        self.metrics.record_finish(state.value, req.latency_s)
        # Goodput/waste ledger: every decoded row-step is attributed once;
        # tokens resumed from the radix tree, or imported with a handoff
        # (decoded on the prefill engine), were not decoded here.
        kept = max(0, len(req.tokens) - group.imported_tokens
                   - group.radix_hit_tokens)
        if state is RequestState.DONE:
            self.metrics.record_ledger(
                goodput=kept, wasted=max(0, group.decoded - kept),
                reason="beam_discard")
            self.metrics.record_qos_finish(req.qos_class, req.latency_s)
            if req.parked_tokens:
                # Zero-token-loss audit: the resumed stream must reproduce
                # every token it emitted before its preemption.
                matched = 0
                for a, b in zip(req.parked_tokens, req.tokens):
                    if a != b:
                        break
                    matched += 1
                self.metrics.record_preempt_resume_audit(
                    replayed=matched, lost=len(req.parked_tokens) - matched)
        else:
            reason = ("deadline" if state is RequestState.EXPIRED
                      else "preempted")
            self.metrics.record_ledger(wasted=group.decoded, reason=reason)
        decode_s = None
        if req.admitted_at is not None:
            decode_s = max(now - req.admitted_at - (req.prefill_s or 0.0),
                           0.0)
        self.metrics.record_phases(req.prefill_s, decode_s)
        self.metrics.record_request_trace(req)

    def _finalize_beam(self, group: _Group) -> None:
        """Best-hypothesis pick, exactly beam_decode_cached's rule: GNMT
        length norm over non-PAD generated tokens, argmax of score/norm."""
        gen = group.beam_tokens[:, 1:group.steps + 1]
        lengths = (gen != PAD_ID).sum(axis=-1).astype(np.float32)
        norm = ((5.0 + lengths) / 6.0) ** self.length_penalty
        best = int(np.argmax(group.scores / np.maximum(norm, 1e-6)))
        group.req.tokens = [int(t) for t in gen[best]]

    def _reap(self, now: float) -> None:
        """Evict cancelled/expired running or mid-chunked-prefill requests —
        their rows are free for this very step's admission."""
        for g in list(self._groups) + list(self._prefilling):
            if g.req.cancel_requested:
                state = RequestState.CANCELLED
            elif g.req.deadline is not None and now >= g.req.deadline:
                state = RequestState.EXPIRED
            else:
                continue
            if g.req.beam_size > 1:
                self._finalize_beam(g)
            self._release(g, state, now)

    def _reap_parked(self, now: float) -> None:
        """Cancel or expire requests parked for the KV handoff: their rows
        and blocks free like a running group's (the router then finds
        handoff_ready False and the poll state terminal)."""
        for g in list(self._handoff_ready.values()):
            if g.req.cancel_requested:
                state = RequestState.CANCELLED
            elif g.req.deadline is not None and now >= g.req.deadline:
                state = RequestState.EXPIRED
            else:
                continue
            if g.req.beam_size > 1:
                self._finalize_beam(g)
            self._release(g, state, now)

    def _park_ready(self) -> None:
        """Prefill phase: every group whose decode step has run leaves the
        tick loop and parks, rows and blocks bound (the KV state is the
        handoff payload), pollable as PREFILLED: the stream goes on on a
        decode engine."""
        for g in list(self._groups):
            if g.steps >= 1:
                self._groups.remove(g)
                g.req.state = RequestState.PREFILLED
                self._handoff_ready[g.req.id] = g

    def _preempt(self, group: _Group, now: float) -> None:
        """Evict a preemptible group so a higher-priority request can place:
        ledger its decode work as preempted waste, free its rows and blocks,
        park its emitted tokens for the zero-loss audit and reinstate it at
        the front of its class. Not a release: the request goes on."""
        self.metrics.record_ledger(wasted=group.decoded, reason="preempted")
        self._free_group_resources(group)
        if group in self._groups:
            self._groups.remove(group)
        else:
            # Half-prefilled: no decode work sunk; the resumed attempt
            # re-chunks from cursor 0 in a fresh group.
            self._prefilling.remove(group)
            if self.prefill_chunk > 0:
                self.queue.note_prefill_backlog(
                    self._chunk_backlog_tokens())
        req = group.req
        if len(req.tokens) > len(req.parked_tokens):
            req.parked_tokens = list(req.tokens)
        req.tokens = []
        req.prefill_s = None
        req.preemptions += 1
        req.preempted_at = now
        self.metrics.record_preemption()
        self.queue.reinstate(req)

    def _pick_victim(self, now: float) -> Optional[_Group]:
        """The group a blocked higher-priority head may evict: among groups
        whose class is preemptible and strictly outranked by the head's,
        the lowest-ranked class, then the least sunk decode work, then the
        most recent admission."""
        head = self.queue.peek_priority_head(now)
        if head is None:
            return None
        head_prio = self.queue.qos_spec(head.qos_class).priority
        candidates = []
        for g in self._groups + self._prefilling:
            spec = self.queue.qos_spec(g.req.qos_class)
            if spec.preemptible and spec.priority > head_prio:
                candidates.append((spec.priority, -g.decoded,
                                   g.req.admitted_at or 0.0, g))
        if not candidates:
            return None
        candidates.sort(key=lambda c: (-c[0], c[1], -c[2]))
        return candidates[0][3]

    def _admit(self, now: float) -> None:
        """Admit every queued request that fits (in queue order; a beam
        group that does not fit blocks later requests of its class), then
        prefill them all in one padded encode — or, under chunked prefill,
        hold their rows and blocks and leave the encode to the chunk ticks.
        With QoS active, a higher-priority head that still cannot place
        preempts best-effort groups one at a time."""
        free = self._free_rows()
        admits: List[_Group] = []
        can_place = None
        if self.paged:
            # Token-budget admission: the head is admissible only while the
            # pool can cover its worst-case block reservation. ``free`` is
            # read through the closure, so it tracks this loop's hand-outs.
            def can_place(req):
                if req.beam_size > len(free):
                    return False
                peak = self._peak_blocks(req.beam_size, req.max_new_tokens)
                if self.radix is not None:
                    # Tree-held blocks back no commitment: evict cold
                    # leaves until this reservation fits, touching the
                    # head's own chain first so it is evicted last.
                    self.radix.lookup(unpadded_key(req.src_ids, PAD_ID),
                                      now)
                    evs = self.radix.ensure_free(
                        self.allocator, peak, tenant=req.tenant)
                    for cause, n in evs.items():
                        self.metrics.record_radix_evictions(cause, n)
                    if evs:
                        self._radix_sync_gauges()
                return self.allocator.can_commit(peak)
        while True:
            while free:
                req = self.queue.pop_ready(now, can_place=can_place)
                if req is None:
                    break
                w = req.beam_size
                if w > len(free):
                    self.queue.requeue_front(req)
                    break
                # Radix walk (greedy only). Greedy decoding is
                # deterministic, so a cached stream for the same unpadded
                # source is what this request would generate: complete at
                # once if it covers the response, else resume at the last
                # cached block boundary.
                hit_tokens: List[int] = []
                hit_blocks: List[int] = []
                if self.radix is not None and w == 1:
                    hit_tokens, hit_blocks = self.radix.lookup(
                        unpadded_key(req.src_ids, PAD_ID), now)
                    lim = min(len(hit_tokens), req.max_new_tokens)
                    eos = next((i for i in range(lim)
                                if hit_tokens[i] == EOS_ID), -1)
                    if eos >= 0 or (lim and lim == req.max_new_tokens):
                        self._radix_instant_complete(
                            req, hit_tokens[:eos + 1] if eos >= 0
                            else hit_tokens[:lim], now)
                        continue
                rows, free = free[:w], free[w:]
                resumed = req.preempted_at is not None
                for r in rows:
                    if self._row_owner[r] is not None:
                        raise RuntimeError(f"admit into occupied row {r}")
                    self._prev[r] = BOS_ID
                    self._pos[r] = 0
                    self._row_owner[r] = req.id
                group = _Group(req=req, rows=rows, budget=req.max_new_tokens)
                if self.paged:
                    peak = self._peak_blocks(w, group.budget)
                    self.allocator.commit(peak)
                    group.committed_blocks = peak
                if w > 1:
                    group.scores = np.full((w,), -1e9, np.float32)
                    group.scores[0] = 0.0
                    group.beam_done = np.zeros((w,), bool)
                    group.beam_tokens = np.full((w, group.budget + 1),
                                                PAD_ID, np.int64)
                    group.beam_tokens[:, 0] = BOS_ID
                admits.append(group)
                self._groups.append(group)
                req.state = RequestState.RUNNING
                req.admitted_at = now
                if resumed:
                    # A preempted stream restarts from scratch (determinism
                    # regenerates its parked prefix); the parked time goes
                    # to the ledger's preempted phase, not the queue wait.
                    req.preempted_s += now - req.preempted_at
                    req.preempted_at = None
                    req.tokens = []
                else:
                    self.metrics.record_admit(now - req.submitted_at)
                if hit_tokens:
                    # Resume from the cached prefix: share the matched full
                    # blocks by refcount and restart at position m. The
                    # next write lands in a fresh tail block (_bind_rows
                    # appends after the shared entries), so shared blocks
                    # are never written.
                    m = len(hit_tokens)
                    r = rows[0]
                    for b in hit_blocks:
                        self.allocator.ref(b)
                    self._blocks_bound[r] = list(hit_blocks)
                    self._block_tables[r, :len(hit_blocks)] = hit_blocks
                    req.tokens = list(hit_tokens)
                    group.steps = m
                    group.radix_hit_tokens = m
                    group.radix_shared_blocks = len(hit_blocks)
                    self._prev[r] = hit_tokens[-1]
                    self._pos[r] = m
                    if req.first_token_at is None:
                        req.first_token_at = now
                        self.metrics.record_first_token(req.ttft_s)
                    self.metrics.record_radix_lookup("hit", m)
                elif self.radix is not None and w == 1:
                    self.metrics.record_radix_lookup("miss", 0)
            if not self.queue.qos_active:
                break
            victim = self._pick_victim(now)
            if victim is None or victim in admits:
                break
            self._preempt(victim, now)
            free = self._free_rows()
        if not admits:
            return
        self.metrics.set_qos_fair_share(self.queue.fair_share_violation_max())
        if self.prefill_chunk > 0:
            # Rows and the block commit are held from now; the encode runs
            # in per-tick chunks and prefill_s accumulates across them.
            self._groups = [g for g in self._groups if g not in admits]
            for group in admits:
                group.req.state = RequestState.PREFILLING
                group.req.prefill_s = 0.0
                self._prefilling.append(group)
            self.queue.note_prefill_backlog(self._chunk_backlog_tokens())
            return
        t_prefill = self._clock()
        try:
            self._prefill(admits)
        finally:
            # The batch prefilled as one device call; each admitted request
            # experienced the whole call as its prefill phase.
            dt = self._clock() - t_prefill
            for group in admits:
                group.req.prefill_s = dt

    def _admit_batch(self, groups: List[_Group], cursor: bool = False):
        """The [capacity, S] source batch of ``groups`` (slot j encodes the
        source of row ``targets[j]``; a beam group takes one slot per row;
        unused slots stay all-PAD), each source cut at its chunk cursor when
        ``cursor``. Returns the host sources, their unpadded keys, the
        device source and mask, the target rows and the slot count."""
        cap, s = self.capacity, self.max_src_len
        src = np.full((cap, s), PAD_ID, np.int64)
        row_targets: List[int] = []
        keys: List[tuple] = []
        for group in groups:
            ids = group.req.src_ids
            if cursor:
                ids = ids[:group.prefill_cursor]
            row_src = np.full((s,), PAD_ID, np.int64)
            row_src[:len(ids)] = ids
            keys.append(unpadded_key(row_src, PAD_ID))
            for r in group.rows:
                src[len(row_targets)] = row_src
                row_targets.append(r)
        mask = (src != PAD_ID).astype(np.int64)
        return (keys, torch.as_tensor(src, device=self.device),
                torch.as_tensor(mask, device=self.device),
                torch.as_tensor(row_targets, device=self.device),
                len(row_targets))

    def _prefill(self, admits: List[_Group]) -> None:
        """Batched prefill into the encoder and source-mask tables, through
        the prefix cache when there is one, then the distinct draft's own
        encoder table."""
        group_keys, src_t, mask_t, targets, n = self._admit_batch(admits)
        if self._prefix is None:
            self.encoder_invocations += len(admits)
            enc_new = self._encode(src_t, mask_t)[:n]
        else:
            # Prefix-cached prefill, keyed on the unpadded source tuple; the
            # encoder runs only when at least one admitted source missed. A
            # source admitted twice in one tick counts as two misses.
            cached_encs = []
            for key in group_keys:
                cached = self._prefix.get(key)
                self.metrics.record_prefix(cached is not None)
                cached_encs.append(cached)
            misses = sum(1 for c in cached_encs if c is None)
            self.encoder_invocations += misses
            enc_dev = self._encode(src_t, mask_t) if misses else None
            rows_out = []
            evicted = 0
            for group, key, cached in zip(admits, group_keys, cached_encs):
                if cached is None:
                    cached = enc_dev[len(rows_out)].clone()
                    evicted += self._prefix.put(key, cached)
                rows_out.extend([cached] * len(group.rows))
            self.metrics.record_prefix_evictions(evicted)
            enc_new = torch.stack(rows_out)
        self._enc[targets] = enc_new
        self._src_mask[targets] = mask_t[:n]
        if self._enc_d is not None:
            # Never prefix-cached: caching buys target-encoder work only.
            self._enc_d[targets] = self._encode_draft(src_t, mask_t)[:n]

    # -- chunked prefill ---------------------------------------------------

    def _chunk_backlog_tokens(self) -> int:
        """Source tokens still awaiting a chunk across PREFILLING groups —
        the backlog term of the queue's retry-after hint."""
        return sum(len(g.req.src_ids) - g.prefill_cursor
                   for g in self._prefilling)

    def _chunk_tick(self) -> int:
        """Spend the per-tick quota (``prefill_chunk`` source tokens) across
        the PREFILLING groups' cursors — QoS priority first, admission
        order within a class — then run one partial encode over the
        advanced but incomplete groups and the full-width :meth:`_prefill`
        over those whose cursor now covers their source. Returns the number
        of groups advanced."""
        if not self._prefilling:
            return 0
        had_decode = bool(self._groups)
        order = sorted(
            self._prefilling,
            key=lambda g: (
                self.queue.qos_spec(g.req.qos_class).priority
                if self.queue.qos_active else 0,
                g.req.admitted_at or 0.0))
        quota = self.prefill_chunk
        used = 0
        advanced: List[_Group] = []
        for g in order:
            if quota <= 0:
                break
            take = min(quota, len(g.req.src_ids) - g.prefill_cursor)
            if take <= 0:
                continue
            g.prefill_cursor += take
            quota -= take
            used += take
            g.chunk_ticks += 1
            g.req.prefill_chunks += 1
            advanced.append(g)
        if not advanced:
            return 0
        completing = [g for g in advanced
                      if g.prefill_cursor >= len(g.req.src_ids)]
        partial = [g for g in advanced
                   if g.prefill_cursor < len(g.req.src_ids)]
        t0 = self._clock()
        if partial:
            self._partial_encode(partial)
        if completing:
            for g in completing:
                self._prefilling.remove(g)
                g.req.state = RequestState.RUNNING
                # Fused windows run meanwhile set this row's _prev mirror
                # to PAD: restore BOS, or the radix-resume tail token,
                # before the first decode step reads it.
                if g.steps > 0:
                    self._prev[g.rows[0]] = g.req.tokens[-1]
                    self._pos[g.rows[0]] = g.steps
                else:
                    for r in g.rows:
                        self._prev[r] = BOS_ID
                        self._pos[r] = 0
                self._groups.append(g)
            self._prefill(completing)
        # Each advanced group spent this whole tick in its prefill phase.
        dt = self._clock() - t0
        for g in advanced:
            g.req.prefill_s = (g.req.prefill_s or 0.0) + dt
        for g in completing:
            self.metrics.record_chunk_prefill_done(g.chunk_ticks)
        self.metrics.record_chunk_tick(
            chunks=len(advanced), tokens=used,
            partial_rows=len(self._prefilling), decode_active=had_decode)
        self.queue.note_prefill_backlog(self._chunk_backlog_tokens())
        return len(advanced)

    def _partial_encode(self, groups: List[_Group]) -> None:
        """Encode the groups' chunk-covered source prefixes at the admission
        shape into the encoder tables. The rows are provisional: no decode
        step attends a PREFILLING row, and the completion's full-source
        encode overwrites them. The draft's table is refreshed only then."""
        _, src_t, mask_t, targets, n = self._admit_batch(groups, cursor=True)
        self._enc[targets] = self._encode_partial(src_t, mask_t)[:n]
        self._src_mask[targets] = mask_t[:n]

    def _beam_select(self, logits_rows: np.ndarray, scores: np.ndarray,
                     done: np.ndarray):
        """One beam group's candidate selection, as beam_decode_cached does
        it: f32 log-softmax, PAD-only continuation for finished beams,
        flattened top-w with lower-index tie-breaking."""
        w = len(scores)
        logp = torch.log_softmax(torch.from_numpy(logits_rows), dim=-1)
        v = logp.shape[-1]
        logp = torch.where(torch.from_numpy(done)[:, None],
                           pad_only_logp(v, "cpu"), logp)
        cand = torch.from_numpy(scores)[:, None] + logp
        top_scores, top_flat = top_k_stable(cand.reshape(w * v), w)
        return (top_scores.numpy(), (top_flat // v).numpy(),
                (top_flat % v).numpy())

    def _plan_window(self) -> int:
        """How many fused steps (or chained speculative windows) the next
        tick may run. More than one only when the scheduler provably has
        nothing to do in between: no chunked prefill in progress,
        greedy-only traffic, no running deadlines, no admissible queued
        work, and no pending request that outranks a preemptible group.
        The brownout knob ``_degrade_window_cap`` caps it."""
        if self.decode_window <= 1:
            return 1
        if self._prefilling:
            return 1
        if self.phase == "prefill":
            # One decode step per request, then the handoff: a wider
            # window would decode past it on the wrong replica.
            return 1
        if any(g.req.beam_size > 1 for g in self._groups):
            return 1
        if any(g.req.deadline is not None for g in self._groups):
            return 1
        if self.queue.depth > 0 and any(o is None for o in self._row_owner):
            return 1
        if self.queue.qos_active:
            pend = self.queue.min_pending_priority()
            if pend is not None:
                for g in self._groups:
                    spec = self.queue.qos_spec(g.req.qos_class)
                    if spec.preemptible and spec.priority > pend:
                        return 1
        k = self.decode_window
        if self._degrade_window_cap is not None:
            # Brownout: shorter windows keep the per-tick latency (and
            # admission freshness) bounded at some throughput cost.
            k = min(k, self._degrade_window_cap)
        return max(1, k)

    # -- the step ----------------------------------------------------------

    @torch.no_grad()
    def step(self) -> int:
        """One engine tick: reap → admit → one chunk tick over the
        PREFILLING groups → one decode window over all running rows →
        per-group bookkeeping → evict finished. Returns the number of
        decode steps run (0 = idle; a chunk-only tick reports 1). Ticks
        with a beam group take the single-step logits path; speculation
        runs only on pure-greedy ticks without deadlines, never on a
        prefill engine, and not while the brownout knob
        ``_degrade_no_spec`` is set. A prefill engine parks every group
        its tick decoded."""
        now = self._clock()
        self._reap(now)
        self._reap_parked(now)
        with span("serve.admit", queued=self.queue.depth) as sp:
            before_g = len(self._groups)
            before_p = len(self._prefilling)
            self._admit(now)
            admitted = self._groups[before_g:] + self._prefilling[before_p:]
            if admitted:
                sp.annotate(request_ids=[g.req.id for g in admitted])
        chunked = 0
        if self._prefilling:
            with span("serve.chunk_prefill",
                      rows=len(self._prefilling)) as sp:
                chunked = self._chunk_tick()
                sp.annotate(advanced=chunked)
        if not self._groups:
            return 1 if chunked else 0
        active_ids = [g.req.id for g in self._groups]
        if any(g.req.beam_size > 1 for g in self._groups):
            with span("serve.decode", path="host", k=1,
                      request_ids=active_ids):
                n = self._host_step()
        elif self.speculate_gamma > 0 and self.phase != "prefill" \
                and not self._degrade_no_spec \
                and not any(g.req.deadline is not None
                            for g in self._groups):
            if self.speculate_device:
                k = self._plan_window()
                with span("serve.decode", path="spec-device", k=k,
                          request_ids=active_ids):
                    n = self._spec_chain_step(k)
            else:
                with span("serve.decode", path="spec",
                          k=self.speculate_gamma, request_ids=active_ids):
                    n = self._spec_step()
        else:
            k = self._plan_window()
            with span("serve.decode", path="fused", k=k,
                      request_ids=active_ids):
                n = self._fused_step(k)
        if self.phase == "prefill":
            self._park_ready()
        return n

    def _fused_step(self, k: int) -> int:
        """Greedy fast path: K fused steps, one host sync at the end."""
        cap = self.capacity
        max_len = self.model_max_len
        steps_left = np.zeros((cap,), np.int64)
        active = np.zeros((cap,), bool)
        for g in self._groups:
            r = g.rows[0]
            steps_left[r] = g.budget - g.steps
            active[r] = True
        if self.paged:
            self._bind_rows(k)
        kv_in_use = self.allocator.blocks_in_use if self.paged else None
        t0 = self._clock()
        dev = self.device
        tables = self._tables()
        prev = torch.as_tensor(self._prev, device=dev)
        pos = torch.as_tensor(self._pos, device=dev)
        left = torch.as_tensor(steps_left, device=dev)
        act = torch.as_tensor(active, device=dev)
        pad = torch.full_like(prev, PAD_ID)
        toks, dones = [], []
        for _ in range(k):
            nxt = self._greedy_step(prev, pos, tables)
            token = torch.where(act, nxt, pad)
            left = left - act.long()
            new_pos = pos + act.long()
            # Position max_len - 1 was the last writable slot: a row whose
            # next step would need position max_len terminates.
            done_now = act & ((token == EOS_ID) | (left <= 0)
                              | (new_pos >= max_len))
            act = act & ~done_now
            prev = torch.where(act, token, pad)
            pos = torch.clamp(new_pos, max=max_len - 1)
            toks.append(token)
            dones.append(done_now)
        # The only device→host traffic of the window: [K, capacity] tokens
        # and done marks plus the [capacity] carry vectors.
        tokens = torch.stack(toks).cpu().numpy()
        done_at = torch.stack(dones).cpu().numpy()
        self._prev = prev.cpu().numpy().copy()
        self._pos = pos.cpu().numpy().copy()
        dt = self._clock() - t0
        now = self._clock()
        new_tokens = 0
        for g in list(self._groups):
            r = g.rows[0]
            for step_k in range(k):
                g.req.tokens.append(int(tokens[step_k, r]))
                g.steps += 1
                g.decoded += 1
                new_tokens += 1
                if g.req.first_token_at is None:
                    g.req.first_token_at = now
                    self.metrics.record_first_token(g.req.ttft_s)
                if done_at[step_k, r]:
                    self._release(g, RequestState.DONE, now)
                    break
        # Occupancy numerator: row·steps of real decode work this window.
        done_idx = np.where(done_at.any(axis=0),
                            done_at.argmax(axis=0) + 1, k)
        active_row_steps = int(done_idx[active].sum())
        self.metrics.record_step(
            active_row_steps, self.queue.depth, new_tokens, dt, steps=k,
            kv_blocks_in_use=kv_in_use)
        return k

    def _emit(self, g: _Group, r: int, tok: int, now: float) -> bool:
        """Emit one speculative token into group ``g`` (row ``r``) with the
        fused window's termination rules; True when the request is done."""
        g.req.tokens.append(tok)
        g.steps += 1
        g.decoded += 1
        if g.req.first_token_at is None:
            g.req.first_token_at = now
            self.metrics.record_first_token(g.req.ttft_s)
        new_pos = int(self._pos[r]) + 1
        exhausted = new_pos >= self.model_max_len
        self._pos[r] = min(new_pos, self.model_max_len - 1)
        self._prev[r] = tok
        return tok == EOS_ID or g.steps >= g.budget or exhausted

    def _spec_step(self) -> int:
        """One speculative tick on the host path: the draft proposes γ, the
        target verifies the γ+1 positions in one call, and the host emits
        the longest accepted prefix plus the target's next token, with EOS,
        budget and cache exhaustion enforced token by token."""
        cap = self.capacity
        gamma = self.speculate_gamma
        active = np.zeros((cap,), bool)
        for g in self._groups:
            active[g.rows[0]] = True
        if self.paged:
            # The verify writes positions pos .. pos+γ (clamped to each
            # row's budget; past it, writes land in the null block).
            self._bind_rows(gamma + 1)
        kv_in_use = self.allocator.blocks_in_use if self.paged else None
        t0 = self._clock()
        dev = self.device
        tables = self._tables()
        prev = torch.as_tensor(self._prev, device=dev)
        pos = torch.as_tensor(self._pos, device=dev)
        act = torch.as_tensor(active, device=dev)
        props = self._draft_propose(prev, pos, act, tables)
        tgt = self._verify(torch.cat([prev[:, None], props], dim=1), pos,
                           tables)
        # Host traffic: [capacity, 2γ+1] ids — γ proposals and γ+1 target
        # tokens per row.
        ids = torch.cat([props, tgt], dim=1).cpu().numpy()
        props, tgt = ids[:, :gamma], ids[:, gamma:]
        dt = self._clock() - t0
        self.queue.note_decode_window(dt)
        now = self._clock()
        new_tokens = 0
        rows_active = 0
        accepted_total = 0
        rates: List[float] = []
        for g in list(self._groups):
            r = g.rows[0]
            rows_active += 1
            a = 0
            while a < gamma and props[r, a] == tgt[r, a]:
                a += 1
            accepted_total += a
            rates.append(a / gamma)
            for j in range(a + 1):
                new_tokens += 1
                if self._emit(g, r, int(tgt[r, j]), now):
                    self._release(g, RequestState.DONE, now)
                    break
        self.metrics.record_step(
            rows_active, self.queue.depth, new_tokens, dt, steps=1,
            kv_blocks_in_use=kv_in_use)
        self.metrics.record_spec(
            proposed=gamma * rows_active, accepted=accepted_total,
            target_row_steps=rows_active, emitted=new_tokens, rates=rates)
        # One device→host sync per window, counted as the chain path counts
        # them so that host syncs per token compare across the two.
        self.metrics.record_spec_chain(windows=1, syncs=1,
                                       emitted=new_tokens)
        return 1

    def _spec_chain_step(self, chain: int) -> int:
        """One device-resident speculative tick: ``chain`` windows of
        propose → verify → accept → advance, chained on the device with no
        host sync between them, then one transfer of the [chain, capacity,
        γ+1] target ids and [chain, capacity] accept counts. The host
        replays emission under the rules the device applied, so its mirrors
        land where the device left prev/pos."""
        cap = self.capacity
        gamma = self.speculate_gamma
        max_len = self.model_max_len
        active = np.zeros((cap,), bool)
        steps_left = np.zeros((cap,), np.int64)
        for g in self._groups:
            r = g.rows[0]
            active[r] = True
            steps_left[r] = g.budget - g.steps
        if self.paged:
            # Worst case every window accepts everything.
            self._bind_rows(chain * (gamma + 1))
        kv_in_use = self.allocator.blocks_in_use if self.paged else None
        t0 = self._clock()
        dev = self.device
        tables = self._tables()
        prev = torch.as_tensor(self._prev, device=dev)
        pos = torch.as_tensor(self._pos, device=dev)
        left = torch.as_tensor(steps_left, device=dev)
        act = torch.as_tensor(active, device=dev)
        pad = torch.full_like(prev, PAD_ID)
        windows = []
        for _ in range(chain):
            props = self._draft_propose(prev, pos, act, tables)
            tgt = self._verify(torch.cat([prev[:, None], props], dim=1),
                               pos, tables)
            # Accept-prefix length per row: the cumulative product stops at
            # the first disagreement.
            acc = (props == tgt[:, :gamma]).long().cumprod(dim=1).sum(dim=1)
            # Emit positions j = 0..acc with the fused window's rules: an
            # EOS mid-window ends the row for every later window too.
            for j in range(gamma + 1):
                can = act & (acc >= j)
                tok = torch.where(can, tgt[:, j], pad)
                left = left - can.long()
                new_pos = pos + can.long()
                done_now = can & ((tok == EOS_ID) | (left <= 0)
                                  | (new_pos >= max_len))
                act = act & ~done_now
                prev = torch.where(can, tok, prev)
                pos = torch.clamp(new_pos, max=max_len - 1)
            windows.append(torch.cat([tgt, acc[:, None]], dim=1))
        # The one host sync of the chain.
        out = torch.stack(windows).cpu().numpy()  # [chain, cap, γ+2]
        tgts, accs = out[:, :, :gamma + 1], out[:, :, gamma + 1]
        dt = self._clock() - t0
        self.queue.note_decode_window(dt)
        now = self._clock()
        new_tokens = 0
        active_row_steps = 0
        accepted_total = 0
        rates: List[float] = []
        for g in list(self._groups):
            r = g.rows[0]
            done = False
            for w in range(chain):
                a = int(accs[w, r])
                active_row_steps += 1
                accepted_total += a
                rates.append(a / gamma)
                for j in range(a + 1):
                    new_tokens += 1
                    if self._emit(g, r, int(tgts[w, r, j]), now):
                        done = True
                        break
                if done:
                    break
            if done:
                self._release(g, RequestState.DONE, now)
        self.metrics.record_step(
            active_row_steps, self.queue.depth, new_tokens, dt,
            steps=chain, kv_blocks_in_use=kv_in_use)
        self.metrics.record_spec(
            proposed=gamma * active_row_steps, accepted=accepted_total,
            target_row_steps=active_row_steps, emitted=new_tokens,
            rates=rates)
        self.metrics.record_spec_chain(windows=chain, syncs=1,
                                       emitted=new_tokens)
        return chain

    def _host_step(self) -> int:
        """Logits-returning path for ticks with beam rows: beam candidate
        selection on host-visible logits; greedy rows sharing the tick ride
        along."""
        if self.paged:
            self._bind_rows(1)
        kv_in_use = self.allocator.blocks_in_use if self.paged else None
        t0 = self._clock()
        dev = self.device
        logits = self._logits_step(torch.as_tensor(self._prev, device=dev),
                                   torch.as_tensor(self._pos, device=dev),
                                   self._tables())
        logits = logits[:, 0, :].float().cpu().numpy()  # [capacity, V]
        rows_active = sum(len(g.rows) for g in self._groups)
        new_tokens = 0
        perm = np.arange(self.capacity)
        perm_needed = False
        copy_dst: List[int] = []
        copy_src: List[int] = []
        now = self._clock()
        last = self.model_max_len - 1
        for g in list(self._groups):
            new_tokens += len(g.rows)
            g.decoded += len(g.rows)
            if g.req.beam_size == 1:
                r = g.rows[0]
                nxt = int(np.argmax(logits[r]))
                g.req.tokens.append(nxt)
                self._prev[r] = nxt
                exhausted = self._pos[r] + 1 >= self.model_max_len
                self._pos[r] = min(self._pos[r] + 1, last)
                g.steps += 1
                if g.req.first_token_at is None:
                    g.req.first_token_at = now
                    self.metrics.record_first_token(g.req.ttft_s)
                if nxt == EOS_ID or g.steps >= g.budget or exhausted:
                    self._release(g, RequestState.DONE, now)
                continue
            w = g.req.beam_size
            top_scores, beam_idx, tok_idx = self._beam_select(
                logits[np.asarray(g.rows)], g.scores, g.beam_done)
            g.scores = top_scores
            g.beam_tokens = g.beam_tokens[beam_idx]
            g.beam_tokens[:, g.steps + 1] = tok_idx
            g.beam_done = g.beam_done[beam_idx] | (tok_idx == EOS_ID)
            if not np.array_equal(beam_idx, np.arange(w)):
                # Surviving beams inherit their ancestor's cache: a row
                # permutation (dense) or a copy-on-write block fork (paged).
                if self.paged:
                    self._fork_beam_blocks(g, beam_idx, copy_dst, copy_src)
                else:
                    for j in range(w):
                        perm[g.rows[j]] = g.rows[beam_idx[j]]
                    perm_needed = True
            exhausted = False
            for j, r in enumerate(g.rows):
                self._prev[r] = int(tok_idx[j])
                exhausted |= self._pos[r] + 1 >= self.model_max_len
                self._pos[r] = min(self._pos[r] + 1, last)
            g.steps += 1
            if g.req.first_token_at is None:
                g.req.first_token_at = now
                self.metrics.record_first_token(g.req.ttft_s)
            if bool(g.beam_done.all()) or g.steps >= g.budget or exhausted:
                # Finished beams only extend with PAD at zero cost, so an
                # all-done early exit cannot change the winner.
                self._finalize_beam(g)
                self._release(g, RequestState.DONE, now)
        if perm_needed:
            idx = torch.as_tensor(perm, device=self.device)
            for ck, cv in self.cache:
                ck.copy_(ck[idx])
                cv.copy_(cv[idx])
        if copy_dst:
            # Gathers read the pre-update pool, so a block freed and
            # re-handed-out within this tick still sources its old content.
            # Every pool tensor moves: an int8 block's scales go with its
            # codes, or the copy decodes wrong.
            dst = torch.as_tensor(copy_dst, device=self.device)
            src = torch.as_tensor(copy_src, device=self.device)
            for layer in self.cache:
                for p in layer:
                    p[dst] = p[src]
        self.metrics.record_step(
            rows_active, self.queue.depth, new_tokens, self._clock() - t0,
            kv_blocks_in_use=kv_in_use)
        return 1

    # -- KV handoff (disaggregated prefill/decode) -------------------------

    def export_handoff(self, request_id: str) -> Dict[str, object]:
        """Serialize a parked request's resume state (the schema is in
        serve/handoff.py). Read-only: the group stays parked and intact
        until :meth:`release_handoff`, so a failed import can retry."""
        g = self._handoff_ready.get(request_id)
        if g is None:
            raise KeyError(
                f"no parked handoff for request {request_id!r}")
        rows = g.rows
        w = len(rows)
        # Unique blocks in first-appearance order: beam rows sharing a
        # prefix block reference one artifact index, and the importer
        # re-shares it by refcount.
        block_index: Dict[int, int] = {}
        rbi = np.full((w, self.max_blocks_per_row), -1, np.int32)
        for j, r in enumerate(rows):
            for i, b in enumerate(self._blocks_bound[r]):
                if b not in block_index:
                    block_index[b] = len(block_index)
                rbi[j, i] = block_index[b]
        unique = torch.as_tensor(list(block_index), device=self.device)
        artifact: Dict[str, object] = {"row_block_index": rbi}
        for li, (layer, part) in enumerate(pool_leaf_slots(self.cache)):
            artifact[f"kv_{li}"] = _host(self.cache[layer][part][unique])
        # prev comes from the group: the fused window resets a parked
        # row's _prev mirror to PAD.
        if w == 1:
            prev = np.asarray([g.req.tokens[-1]], np.int32)
        else:
            prev = np.asarray(g.beam_tokens[:, g.steps], np.int32)
        artifact.update({
            "enc": _host(self._enc[rows[0]]),
            "src_mask": _host(self._src_mask[rows[0]]).astype(np.int32),
            "src_ids": np.asarray(g.req.src_ids, np.int32),
            "tokens": np.asarray(g.req.tokens, np.int32),
            "prev": prev,
            "pos": np.asarray([self._pos[r] for r in rows], np.int32),
            "meta": pack_meta(
                version=1, width=w, steps=g.steps, budget=g.budget,
                kv_block_size=self.kv_block_size,
                model_max_len=self.model_max_len,
                max_src_len=self.max_src_len,
                enc_hid=self._enc.shape[-1]),
            "deadline": np.asarray(
                [np.nan if g.req.deadline is None else g.req.deadline],
                np.float64),
        })
        if w > 1:
            artifact["scores"] = np.asarray(g.scores, np.float32)
            artifact["beam_done"] = np.asarray(g.beam_done, bool)
            artifact["beam_tokens"] = np.asarray(g.beam_tokens, np.int32)
        return artifact

    def import_handoff(self, artifact: Dict[str, object], request_id: str,
                       trace_id: Optional[str] = None,
                       tenant: Optional[str] = None,
                       qos_class: Optional[str] = None) -> Request:
        """Resume a handoff artifact mid-stream in this engine's own block
        pool. Block ids are remapped through this pool's free list; rows,
        blocks and the worst-case commit are reserved as a fresh admission
        would. Every refusal — geometry, KV precision, capacity
        (OverloadError), a deadline that passed in transit
        (DeadlineExceededError) — raises before any state commits, so the
        exporter's parked copy stays valid for a retry."""
        if self.phase == "prefill":
            raise RuntimeError(
                "a prefill-phase engine cannot import handoffs")
        if not self.paged:
            raise RuntimeError(
                "import_handoff requires the paged KV path")
        meta = validate_artifact(artifact)
        for key, mine in (("kv_block_size", self.kv_block_size),
                          ("model_max_len", self.model_max_len),
                          ("max_src_len", self.max_src_len),
                          ("enc_hid", self._enc.shape[-1])):
            if meta[key] != mine:
                raise ValueError(
                    f"handoff artifact {key}={meta[key]} does not match "
                    f"this engine's {mine}")
        # KV precision before anything commits: an int8 exporter ships
        # scale sidecars as extra kv_* leaves, so a cross-precision pair
        # disagrees on the leaf count.
        slots = pool_leaf_slots(self.cache)
        if len(slots) != kv_leaf_count(artifact):
            raise ValueError(
                f"handoff artifact carries {kv_leaf_count(artifact)} KV "
                f"leaves, this engine's pool has {len(slots)} — the pair "
                f"must agree on --kv-quant")
        payloads = [as_tensor(artifact[f"kv_{i}"])
                    for i in range(len(slots))]
        for i, ((layer, part), p) in enumerate(zip(slots, payloads)):
            leaf = self.cache[layer][part]
            if tuple(p.shape[1:]) != tuple(leaf.shape[1:]):
                raise ValueError(
                    f"handoff artifact kv_{i} blocks are "
                    f"{tuple(p.shape[1:])}, this engine's pool "
                    f"{tuple(leaf.shape[1:])}")
        w, steps, budget = meta["width"], meta["steps"], meta["budget"]
        free = self._free_rows()
        peak = self._peak_blocks(w, budget)
        rbi = np.asarray(artifact["row_block_index"], np.int64)
        n_unique = int(payloads[0].shape[0])
        if w > len(free) or not self.allocator.can_commit(peak) \
                or n_unique > self.allocator.free_blocks:
            raise OverloadError(
                self.queue.depth, self.queue.max_depth,
                retry_after_s=self.queue.retry_after_floor_s)
        now = self._clock()
        deadline = float(np.asarray(artifact["deadline"])[0])
        if not np.isnan(deadline) and now >= deadline:
            # A stream whose budget lapsed in transit is refused before
            # any state commits; the exporter's parked copy expires
            # through its own reap and ledgers the waste there.
            raise DeadlineExceededError(
                f"request {request_id!r} deadline passed "
                f"{now - deadline:.3f}s before handoff import")
        req = Request(
            id=request_id,
            src_ids=[int(t) for t in np.asarray(artifact["src_ids"])],
            max_new_tokens=budget, beam_size=w,
            deadline=None if np.isnan(deadline) else deadline,
            state=RequestState.RUNNING, submitted_at=now,
            admitted_at=now,
            tokens=[int(t) for t in np.asarray(artifact["tokens"])],
            trace_id=trace_id, tenant=tenant,
            qos_class=qos_class or "standard")
        self.queue.adopt(req)
        if tenant is not None or req.qos_class != "standard":
            # An imported best-effort stream stays preemptible here.
            self.queue.qos_active = True
            self.metrics.configure_qos()
        self.metrics.record_submit()
        self.metrics.record_admit(0.0)
        self.allocator.commit(peak)
        # One fresh block per unique exported block from this pool's free
        # list; every further row referencing it takes a reference.
        new_ids = [self.allocator.alloc() for _ in range(n_unique)]
        rows = free[:w]
        prev = np.asarray(artifact["prev"], np.int64)
        pos = np.asarray(artifact["pos"], np.int64)
        refs = np.zeros((n_unique,), np.int64)
        for j, r in enumerate(rows):
            bound = []
            for idx in rbi[j]:
                if idx < 0:
                    break
                bound.append(new_ids[idx])
                refs[idx] += 1
            self._blocks_bound[r] = bound
            self._block_tables[r] = 0
            self._block_tables[r, :len(bound)] = bound
            self._row_owner[r] = request_id
            self._prev[r] = prev[j]
            self._pos[r] = pos[j]
        for idx in range(n_unique):
            for _ in range(int(refs[idx]) - 1):
                self.allocator.ref(new_ids[idx])
        ids = torch.as_tensor(new_ids, device=self.device)
        for (layer, part), p in zip(slots, payloads):
            leaf = self.cache[layer][part]
            leaf[ids] = p.to(device=self.device, dtype=leaf.dtype)
        # The encoder output and source mask arrive precomputed: the
        # decode engine never runs the encoder for a handed-off stream.
        rows_t = torch.as_tensor(rows, device=self.device)
        self._enc[rows_t] = as_tensor(artifact["enc"]).to(
            device=self.device, dtype=self._enc.dtype)
        mask = as_tensor(artifact["src_mask"]).to(
            device=self.device, dtype=self._src_mask.dtype)
        self._src_mask[rows_t] = mask
        if self.speculate_gamma > 0:
            self._warm_draft_rows(artifact, rows_t, ids, payloads, slots,
                                  mask)
        g = _Group(req=req, rows=rows, budget=budget, steps=steps,
                   committed_blocks=peak, imported_tokens=steps)
        if w > 1:
            g.scores = np.asarray(artifact["scores"], np.float32).copy()
            g.beam_done = np.asarray(artifact["beam_done"], bool).copy()
            bt = np.full((w, budget + 1), PAD_ID, np.int64)
            src_bt = np.asarray(artifact["beam_tokens"], np.int64)
            bt[:, :src_bt.shape[1]] = src_bt
            g.beam_tokens = bt
        self._groups.append(g)
        return req

    def _warm_draft_rows(self, artifact, rows_t, ids, payloads, slots,
                         mask) -> None:
        """Speculation on a decode engine. The draft pool is indexed by the
        same block tables as the target's, so self-draft takes the
        imported blocks as they are — dequantized when the target pool is
        int8 (the draft pool stays float) — and its acceptance stays what
        it would have been. A distinct draft gets its encoder table
        refreshed; its pool for the skipped positions stays cold, which
        costs acceptance, never tokens (the accept-prefix rule)."""
        if not self._self_draft:
            src = torch.full((len(rows_t), self.max_src_len), PAD_ID,
                             dtype=torch.long, device=self.device)
            src_ids = torch.as_tensor(
                np.asarray(artifact["src_ids"], np.int64),
                device=self.device)
            src[:, :len(src_ids)] = src_ids
            m = mask.expand(len(rows_t), -1)
            self._enc_d[rows_t] = self._encode_draft(src, m)
            return
        by_slot = dict(zip(slots, payloads))
        for layer, dcache in enumerate(self._draft_cache):
            quant = len(self.cache[layer]) == 4
            for part in (0, 1):
                blocks = by_slot[(layer, part)]
                if quant:
                    blocks = dequantize_kv_blocks(
                        blocks, by_slot[(layer, part + 2)])
                dleaf = dcache[part]
                dleaf[ids] = blocks.to(device=self.device, dtype=dleaf.dtype)

    def release_handoff(self, request_id: str) -> None:
        """Free a parked request's rows and blocks once the decode side has
        imported them. The request finalizes here as PREFILLED (the stream
        lives on elsewhere); its decode work is ledgered as handoff
        goodput, and its serve.request span is emitted — the prefill half
        of the cross-replica flow link in ``obs export --fleet``."""
        g = self._handoff_ready.pop(request_id, None)
        if g is None:
            raise KeyError(
                f"no parked handoff for request {request_id!r}")
        now = self._clock()
        self._free_group_resources(g)
        g.req.state = RequestState.PREFILLED
        g.req.finished_at = now
        self.metrics.record_finish(RequestState.PREFILLED.value,
                                   g.req.latency_s)
        self.metrics.record_ledger(goodput=g.decoded, wasted=0,
                                   reason="handoff")
        decode_s = None
        if g.req.admitted_at is not None:
            decode_s = max(now - g.req.admitted_at
                           - (g.req.prefill_s or 0.0), 0.0)
        self.metrics.record_phases(g.req.prefill_s, decode_s)
        self.metrics.record_request_trace(g.req)

    def run_until_drained(self, max_steps: int = 1_000_000,
                          writer=None, emit_every: int = 0) -> int:
        """Step until queue and slots are empty (the offline driver loop).
        Optionally emits a metrics record every ``emit_every`` ticks and a
        final one on drain. Returns the number of engine ticks taken."""
        steps = 0
        while (self.queue.depth > 0 or self._groups or self._prefilling) \
                and steps < max_steps:
            self.step()
            steps += 1
            if writer is not None and emit_every > 0 \
                    and steps % emit_every == 0:
                self.metrics.emit(writer)
        if writer is not None:
            self.metrics.emit(writer, drained=True)
        return steps
