"""Continuous-batching inference engine over the KV-cache decoder.

The port of ``deeplearning_cfn_tpu/serve/engine.py``, restricted to what
slice 1 serves. A fixed-capacity **slot table** of KV-cache rows is driven
by decode steps against per-row positions (``decode_step_at`` /
``greedy_step_at`` of models/transformer_nmt.py): queued requests are
admitted into free rows mid-flight, rows are evicted the moment their
request hits EOS / budget / deadline, and recycled without stalling their
neighbours. Row recycling needs no cache zeroing: the per-row step bias
only exposes positions ``<= pos[row]``.

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
- the encoder prefix cache, cancel, deadlines and overload backpressure.

The KV cache, the encoder table and the source-mask table are updated in
place (the JAX engine donates them into each device call for the same
effect). Constructor arguments of later slices raise ``NotImplementedError``
naming the ROADMAP.md item that ports them.

Every device call is counted for the launch audit: ``encoder_forwards``
(encoder applications, the constructor's warmup included) and
``decoder_steps`` (decode-step applications). On the card each encoder
forward launches the flash kernel once per encoder layer and each decoder
step twice per decoder layer.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..models.decoding import (BOS_ID, EOS_ID, PAD_ID, pad_only_logp,
                               top_k_stable)
from ..obs.trace import span
from .blockpool import BlockAllocator
from .metrics import ServeMetrics
from .prefix import PrefixCache, unpadded_key
from .queue import OverloadError, Request, RequestQueue, RequestState

# Out-of-slice options → the ROADMAP.md item that ports them.
_LATER = {
    "radix_cache": "A.6b (radix token-prefix KV cache)",
    "speculate_gamma": "A.6a (speculative decoding)",
    "speculate_device": "A.6a (speculative decoding)",
    "draft_model": "A.6a (speculative decoding)",
    "draft_variables": "A.6a (speculative decoding)",
    "prefill_chunk": "A.6c (chunked prefill)",
    "phase": "A.6d (disaggregated prefill/decode handoff)",
    "quantize": "A.6e (int8 weights and KV)",
    "kv_quant": "A.6e (int8 weights and KV)",
    "qos_classes": "A.6f (multi-tenant QoS and preemption)",
}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to deeplearning_cfn_tpu_torch yet "
        f"(ROADMAP.md {_LATER[what]})")


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


class Engine:
    """Continuous-batching serving engine for the NMT encoder-decoder.

    ``model`` is a :class:`~..models.transformer_nmt.TransformerNMT` with
    its weights, on the device the engine runs on. ``capacity`` is the
    number of KV-cache rows; ``max_src_len`` the fixed source padding every
    request is encoded at. :meth:`step` runs one decode window over all
    rows with admission/eviction around it; :meth:`run_until_drained` loops
    it.
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
                 draft_variables=None,
                 quantize: str = "",
                 kv_quant: str = "",
                 phase: str = "both",
                 clock=time.monotonic,
                 metrics: Optional[ServeMetrics] = None,
                 retry_after_floor_s: Optional[float]
                 = RequestQueue.DEFAULT_RETRY_AFTER_FLOOR_S,
                 qos_classes=None,
                 prefill_chunk: int = 0):
        later = dict(radix_cache=radix_cache, speculate_gamma=speculate_gamma,
                     speculate_device=speculate_device,
                     draft_model=draft_model,
                     draft_variables=draft_variables,
                     prefill_chunk=prefill_chunk, quantize=quantize,
                     kv_quant=kv_quant, qos_classes=qos_classes)
        for name, value in later.items():
            if value:
                raise _not_ported(name)
        if (phase or "both") != "both":
            raise _not_ported("phase")
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if decode_window <= 0:
            raise ValueError(
                f"decode_window must be positive, got {decode_window}")
        self.model = model
        self.device = model.device
        self.capacity = capacity
        self.decode_window = int(decode_window)
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
                                  retry_after_floor_s=retry_after_floor_s)
        self.metrics = metrics if metrics is not None \
            else ServeMetrics(capacity, clock=clock)
        self.metrics.configure_request_ledger()

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
        # Logical source encodes (one per admitted request that missed the
        # prefix cache) and the device-call tallies of the launch audit.
        self.encoder_invocations = 0
        self.encoder_forwards = 0
        self.decoder_steps = 0

        # Device state. One warmup encode at the admission batch shape
        # fixes the encoder table's width and dtype.
        s = self.max_src_len
        with torch.no_grad():
            zeros = torch.zeros((cap, s), dtype=torch.long,
                                device=self.device)
            enc1 = self._encode(zeros, zeros)
        self._enc = torch.zeros((cap, s, enc1.shape[-1]), dtype=enc1.dtype,
                                device=self.device)
        self._src_mask = torch.zeros((cap, s), dtype=torch.long,
                                     device=self.device)
        if self.paged:
            self.cache = model.init_paged_cache(self.kv_blocks,
                                                self.kv_block_size)
        else:
            self.cache = model.init_cache(cap)
        # Host-side per-row state (scheduler-authoritative; uploaded into
        # each device call and refreshed from its outputs).
        self._prev = np.full((cap,), PAD_ID, np.int64)
        self._pos = np.zeros((cap,), np.int64)
        self._row_owner: List[Optional[str]] = [None] * cap
        self._groups: List[_Group] = []

    # -- client surface ----------------------------------------------------

    def submit(self, src_ids: List[int],
               max_new_tokens: Optional[int] = None, beam_size: int = 1,
               deadline_s: Optional[float] = None,
               request_id: Optional[str] = None,
               trace_id: Optional[str] = None,
               tenant: Optional[str] = None,
               qos_class: Optional[str] = None) -> Request:
        """Validate + enqueue. Raises OverloadError when the queue is full,
        ValueError on requests the engine could never place."""
        if tenant is not None or qos_class is not None:
            raise _not_ported("qos_classes")
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
                                    trace_id=trace_id)
        except OverloadError as e:
            self.metrics.record_reject(e.retry_after_s)
            raise
        self.metrics.record_submit()
        return req

    def poll(self, request_id: str) -> Request:
        return self.queue.poll(request_id)

    def cancel(self, request_id: str) -> bool:
        return self.queue.cancel(request_id)

    def slot_view(self) -> List[Optional[str]]:
        """Row → owning request id (None = free). For tests/diagnostics."""
        return list(self._row_owner)

    @property
    def active_requests(self) -> int:
        return len(self._groups)

    @property
    def active_rows(self) -> int:
        return sum(1 for o in self._row_owner if o is not None)

    # -- device calls ------------------------------------------------------

    def _encode(self, src: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        self.encoder_forwards += 1
        return self.model.encode(src, mask)

    def _tables(self) -> Optional[torch.Tensor]:
        if not self.paged:
            return None
        return torch.as_tensor(self._block_tables, device=self.device)

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
        decode steps, drawing on the group's admission-time reservation (so
        :meth:`BlockAllocator.alloc` cannot fail here)."""
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

    def _release(self, group: _Group, state: RequestState,
                 now: float) -> None:
        self._free_group_resources(group)
        req = group.req
        req.state = state
        req.finished_at = now
        self._groups.remove(group)
        self.metrics.record_finish(state.value, req.latency_s)
        # Goodput/waste ledger: every decoded row-step is attributed once.
        kept = len(req.tokens)
        if state is RequestState.DONE:
            self.metrics.record_ledger(
                goodput=kept, wasted=max(0, group.decoded - kept),
                reason="beam_discard")
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
        """Evict cancelled/expired running requests — their rows are free
        for this very step's admission."""
        for g in list(self._groups):
            if g.req.cancel_requested:
                state = RequestState.CANCELLED
            elif g.req.deadline is not None and now >= g.req.deadline:
                state = RequestState.EXPIRED
            else:
                continue
            if g.req.beam_size > 1:
                self._finalize_beam(g)
            self._release(g, state, now)

    def _admit(self, now: float) -> None:
        """Admit every queued request that fits (FIFO; a beam group that
        does not fit blocks later requests), then prefill them all in one
        padded encode."""
        free = self._free_rows()
        admits: List[_Group] = []
        can_place = None
        if self.paged:
            # Token-budget admission: the head is admissible only while the
            # pool can cover its worst-case block reservation.
            def can_place(req):
                if req.beam_size > len(free):
                    return False
                return self.allocator.can_commit(
                    self._peak_blocks(req.beam_size, req.max_new_tokens))
        while free:
            req = self.queue.pop_ready(now, can_place=can_place)
            if req is None:
                break
            w = req.beam_size
            if w > len(free):
                self.queue.requeue_front(req)
                break
            rows, free = free[:w], free[w:]
            for r in rows:
                assert self._row_owner[r] is None, \
                    f"admit into occupied row {r}"
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
                group.beam_tokens = np.full((w, group.budget + 1), PAD_ID,
                                            np.int64)
                group.beam_tokens[:, 0] = BOS_ID
            admits.append(group)
            self._groups.append(group)
            req.state = RequestState.RUNNING
            req.admitted_at = now
            self.metrics.record_admit(now - req.submitted_at)
        if not admits:
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

    def _prefill(self, admits: List[_Group]) -> None:
        """Batched prefill: the encode batch is always [capacity, S]; slot j
        encodes the source for row ``row_targets[j]``, and unused slots
        stay all-PAD. A beam group's source occupies one slot per row."""
        cap, s = self.capacity, self.max_src_len
        src = np.full((cap, s), PAD_ID, np.int64)
        row_targets: List[int] = []
        group_keys: List[tuple] = []
        for group in admits:
            row_src = np.full((s,), PAD_ID, np.int64)
            row_src[:len(group.req.src_ids)] = group.req.src_ids
            group_keys.append(unpadded_key(row_src, PAD_ID))
            for r in group.rows:
                src[len(row_targets)] = row_src
                row_targets.append(r)
        n = len(row_targets)
        mask = (src != PAD_ID).astype(np.int64)
        src_t = torch.as_tensor(src, device=self.device)
        mask_t = torch.as_tensor(mask, device=self.device)
        targets = torch.as_tensor(row_targets, device=self.device)
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
        """How many fused steps the next tick may run. Windows > 1 only
        when the scheduler provably has nothing to do at intermediate
        steps: greedy-only traffic, no running deadlines, and no admissible
        queued work."""
        if self.decode_window <= 1:
            return 1
        if any(g.req.beam_size > 1 for g in self._groups):
            return 1
        if any(g.req.deadline is not None for g in self._groups):
            return 1
        if self.queue.depth > 0 and any(o is None for o in self._row_owner):
            return 1
        return self.decode_window

    # -- the step ----------------------------------------------------------

    @torch.no_grad()
    def step(self) -> int:
        """One engine tick: reap → admit (batched prefill) → one decode
        window over all running rows → per-group bookkeeping → evict
        finished. Returns the number of decode steps run (0 = idle). Ticks
        with a beam group take the single-step logits path."""
        now = self._clock()
        self._reap(now)
        with span("serve.admit", queued=self.queue.depth) as sp:
            before = len(self._groups)
            self._admit(now)
            admitted = self._groups[before:]
            if admitted:
                sp.annotate(request_ids=[g.req.id for g in admitted])
        if not self._groups:
            return 0
        active_ids = [g.req.id for g in self._groups]
        if any(g.req.beam_size > 1 for g in self._groups):
            with span("serve.decode", path="host", k=1,
                      request_ids=active_ids):
                return self._host_step()
        k = self._plan_window()
        with span("serve.decode", path="fused", k=k, request_ids=active_ids):
            return self._fused_step(k)

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
            dst = torch.as_tensor(copy_dst, device=self.device)
            src = torch.as_tensor(copy_src, device=self.device)
            for pk, pv in self.cache:
                pk[dst] = pk[src]
                pv[dst] = pv[src]
        self.metrics.record_step(
            rows_active, self.queue.depth, new_tokens, self._clock() - t0,
            kv_blocks_in_use=kv_in_use)
        return 1

    def run_until_drained(self, max_steps: int = 1_000_000,
                          writer=None, emit_every: int = 0) -> int:
        """Step until queue and slots are empty (the offline driver loop).
        Optionally emits a metrics record every ``emit_every`` ticks and a
        final one on drain. Returns the number of engine ticks taken."""
        steps = 0
        while (self.queue.depth > 0 or self._groups) and steps < max_steps:
            self.step()
            steps += 1
            if writer is not None and emit_every > 0 \
                    and steps % emit_every == 0:
                self.metrics.emit(writer)
        if writer is not None:
            self.metrics.emit(writer, drained=True)
        return steps
