"""Serving counters, emitted through the existing metrics/jsonl.py writer.

One flat record per emit, every key prefixed ``serve_`` so serving metrics
coexist with training records in the same JSONL stream (and `dlcfn-tpu
metrics` keeps ignoring them). The headline signals:

- queue depth (admission backlog) and queue wait (submit → admit — the
  admission latency that TTFT alone hides),
- time-to-first-token (submit → first generated token),
- tokens/sec (generated tokens over engine-busy wall time),
- slot occupancy (active rows / capacity, averaged over decode steps),
- per-step decode latency (device call time / steps in the call — the
  number decode windows exist to shrink).

Step accounting is window-aware: one :meth:`record_step` call covers one
device call, which since the device-resident fast path may span several
fused decode steps (``steps``). ``serve_steps`` counts decode steps,
``serve_decode_windows`` counts device calls.

Storage lives in an :class:`obs.MetricsRegistry` (typed Counter/Gauge/
Histogram instruments — one ``serve_requests_total{state=...}`` counter
family instead of six loose ints, distribution histograms that retain raw
samples). The public surface is unchanged: every pre-registry attribute
(``submitted``, ``ttft_s`` as a list, settable ``ckpt_load_retries``, ...)
is a property over the instruments, and :meth:`snapshot` emits the exact
same keys and values — parity-tested in tests/test_obs.py.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ..metrics.jsonl import MetricsWriter
from ..obs.metrics import MetricsRegistry, percentile  # noqa: F401  (re-export)
from ..obs.trace import get_tracer, obs_enabled


class ServeMetrics:
    """Accumulates engine-side counters; snapshot() flattens them."""

    def __init__(self, capacity: int, clock=time.monotonic,
                 registry: Optional[MetricsRegistry] = None):
        self.capacity = capacity
        self._clock = clock
        self.started_at = clock()
        # Per-instance registry by default: two engines in one process
        # (tests spin several) must not share counters. Pass one in to
        # export serve metrics alongside a run's other instruments.
        self.registry = registry or MetricsRegistry()
        r = self.registry
        # Lifecycle counters — one family, labelled by terminal state.
        self._requests = r.counter(
            "serve_requests_total", "request lifecycle events by state")
        # Step accounting. `steps` counts decode steps; `windows` counts
        # device calls (a fused window is one call spanning many steps).
        self._steps = r.counter("serve_steps_total", "decode steps")
        self._windows = r.counter("serve_windows_total", "device calls")
        self._tokens = r.counter("serve_tokens_total", "generated tokens")
        self._busy = r.counter("serve_busy_time_s", "engine-busy seconds")
        self._occupancy_sum_c = r.counter(
            "serve_occupancy_sum", "sum of per-step occupancy fractions")
        self._queue_depth = r.gauge("serve_queue_depth", "admission backlog")
        # Robustness surface: store retries absorbed while loading the
        # checkpoint (set by serve/loader.py), and the most recent
        # retry-after hint handed out with an overload rejection.
        self._ckpt_retries = r.gauge(
            "serve_ckpt_load_retries", "store retries during ckpt load")
        self._retry_after = r.gauge(
            "serve_retry_after_hint_s", "last overload retry-after hint")
        # Distributions (raw samples retained — the p50/p95 contract is
        # exact percentiles, not bucket interpolation).
        self._ttft = r.histogram("serve_ttft_s", "submit to first token")
        self._latency = r.histogram("serve_latency_s", "submit to finish")
        self._queue_wait = r.histogram("serve_queue_wait_s",
                                       "submit to admit")
        self._step_latency = r.histogram("serve_step_latency_s",
                                         "per decode step device time")
        # Optional surfaces — instruments (and snapshot keys) exist only
        # once the engine configures the feature, so slot-table engines
        # keep emitting byte-identical records (the exact-key snapshot
        # contract in tests/test_obs.py).
        self._kv_pool = None  # (usable_blocks, block_size) when paged
        self._kv_in_use = None
        self._kv_util_sum = None
        self._kv_util_calls = None
        self._prefix_size = 0
        self._prefix_lookups = None
        self._prefix_evictions = None
        self._radix_lookups = None
        self._radix_hit_tokens = None
        self._radix_shared_blocks = None
        self._radix_request_blocks = None
        self._radix_evictions = None
        self._radix_nodes = None
        self._radix_blocks = None
        self._spec_gamma = 0
        self._spec_proposed = None
        self._spec_accepted = None
        self._spec_emitted = None
        self._spec_target_steps = None
        self._spec_accept_rate = None
        self._spec_device = False
        self._spec_chain_windows = None
        self._spec_chain_syncs = None
        self._spec_chain_emitted = None
        self._spec_chain_len = None
        self._kv_quant_bytes = None
        self._qos_preemptions = None
        self._qos_replayed = None
        self._qos_token_loss = None
        self._qos_completed = None
        self._qos_latency: Dict[str, object] = {}
        self._qos_fair_share = None
        self._goodput = None
        self._waste = None
        self._phase_prefill = None
        self._phase_decode = None
        self._chunk_size = 0
        self._chunk_ticks = None
        self._chunk_tokens = None
        self._chunks_per_tick = None
        self._chunk_partial_rows = None
        self._chunk_stall_avoided = None
        self._chunk_ticks_per_prefill = None

    # -- optional feature surfaces -----------------------------------------

    def configure_kv_pool(self, usable_blocks: int, block_size: int) -> None:
        """Enable the paged-KV metric surface (serve_kv_block_*)."""
        r = self.registry
        self._kv_pool = (usable_blocks, block_size)
        self._kv_in_use = r.gauge(
            "serve_kv_blocks_in_use", "allocated KV pool blocks")
        self._kv_util_sum = r.counter(
            "serve_kv_block_util_sum",
            "sum of per-device-call pool utilization fractions")
        self._kv_util_calls = r.counter(
            "serve_kv_block_util_calls", "device calls with pool readings")

    def configure_prefix_cache(self, max_entries: int) -> None:
        """Enable the encoder-prefix-cache metric surface (serve_prefix_*)."""
        r = self.registry
        self._prefix_size = max_entries
        self._prefix_lookups = r.counter(
            "serve_prefix_lookups_total", "prefix cache lookups by result")
        self._prefix_evictions = r.counter(
            "serve_prefix_evictions_total", "prefix cache LRU evictions")

    def configure_radix(self) -> None:
        """Enable the radix token-prefix KV cache surface (serve_radix_*).
        Turned on by the engine only when --radix-cache is set, so every
        other configuration keeps its exact snapshot key set."""
        if self._radix_lookups is not None:
            return
        r = self.registry
        self._radix_lookups = r.counter(
            "serve_radix_lookups_total",
            "radix cache admissions by result (hit/miss/instant)")
        self._radix_hit_tokens = r.counter(
            "serve_radix_hit_tokens_total",
            "decode tokens served from cached prefix blocks")
        self._radix_shared_blocks = r.counter(
            "serve_radix_shared_blocks_total",
            "pool blocks shared from the radix tree, at request release")
        self._radix_request_blocks = r.counter(
            "serve_radix_request_blocks_total",
            "pool blocks bound by released requests (shared + fresh)")
        self._radix_evictions = r.counter(
            "serve_radix_evictions_total", "radix evictions by cause")
        self._radix_nodes = r.gauge(
            "serve_radix_nodes", "radix tree block nodes resident")
        self._radix_blocks = r.gauge(
            "serve_radix_blocks", "pool blocks the radix tree references")

    def configure_chunked_prefill(self, chunk: int) -> None:
        """Enable the chunked-prefill surface (serve_chunk_*). Turned on
        by the engine only when ``prefill_chunk > 0``, so unchunked
        configurations keep their exact snapshot key set."""
        if self._chunk_ticks is not None:
            return
        r = self.registry
        self._chunk_size = int(chunk)
        self._chunk_ticks = r.counter(
            "serve_chunk_ticks_total", "ticks that advanced prefill chunks")
        self._chunk_tokens = r.counter(
            "serve_chunk_tokens_total", "source tokens encoded via chunks")
        self._chunks_per_tick = r.histogram(
            "serve_chunks_per_tick", "partial-prefill rows advanced per "
            "chunk tick")
        self._chunk_partial_rows = r.gauge(
            "serve_chunk_partial_rows", "rows mid-prefill after the tick")
        self._chunk_stall_avoided = r.counter(
            "serve_chunk_stall_ticks_avoided_total",
            "chunk ticks that shared the tick with live decode rows — "
            "each one a full-prompt encode stall the unchunked admission "
            "path would have imposed on them")
        self._chunk_ticks_per_prefill = r.histogram(
            "serve_chunk_ticks_per_prefill",
            "chunk ticks one request's source encode spanned")

    def record_chunk_tick(self, chunks: int, tokens: int,
                          partial_rows: int, decode_active: bool) -> None:
        """One chunk tick: ``chunks`` rows advanced by ``tokens`` source
        tokens total, ``partial_rows`` still mid-prefill afterwards;
        ``decode_active`` means decode rows shared this tick (the
        stall-avoided signal)."""
        if self._chunk_ticks is None:
            return
        self._chunk_ticks.inc()
        if tokens:
            self._chunk_tokens.inc(tokens)
        self._chunks_per_tick.observe(float(chunks))
        self._chunk_partial_rows.set(int(partial_rows))
        if decode_active:
            self._chunk_stall_avoided.inc()

    def record_chunk_prefill_done(self, ticks: int) -> None:
        """One request's source encode completed after ``ticks`` chunk
        ticks."""
        if self._chunk_ticks_per_prefill is not None:
            self._chunk_ticks_per_prefill.observe(float(ticks))

    def record_radix_lookup(self, result: str, matched_tokens: int) -> None:
        """One admission walk: ``result`` is ``hit`` (resume from cached
        blocks), ``instant`` (the cached stream already covers the whole
        response) or ``miss``; ``matched_tokens`` the decode steps the
        cache saved."""
        if self._radix_lookups is None:
            return
        self._radix_lookups.inc(result=result)
        if matched_tokens:
            self._radix_hit_tokens.inc(matched_tokens)

    def record_radix_blocks(self, shared: int, total: int) -> None:
        """One released request's block provenance: ``shared`` of its
        ``total`` bound blocks came from the tree (the shared-block
        ratio's numerator/denominator)."""
        if self._radix_shared_blocks is None:
            return
        if shared:
            self._radix_shared_blocks.inc(shared)
        if total:
            self._radix_request_blocks.inc(total)

    def record_radix_evictions(self, cause: str, n: int) -> None:
        if self._radix_evictions is not None and n:
            self._radix_evictions.inc(n, cause=cause)

    def set_radix_size(self, nodes: int, blocks: int) -> None:
        if self._radix_nodes is not None:
            self._radix_nodes.set(int(nodes))
            self._radix_blocks.set(int(blocks))

    def configure_speculation(self, gamma: int) -> None:
        """Enable the speculative-decoding metric surface (serve_spec_*)."""
        r = self.registry
        self._spec_gamma = int(gamma)
        self._spec_proposed = r.counter(
            "serve_spec_proposed_total", "draft tokens proposed")
        self._spec_accepted = r.counter(
            "serve_spec_accepted_total", "draft tokens accepted")
        self._spec_emitted = r.counter(
            "serve_spec_emitted_total",
            "tokens emitted by speculative steps (accepted + corrections)")
        self._spec_target_steps = r.counter(
            "serve_spec_target_row_steps_total",
            "target verify row-steps (one per active row per spec call)")
        self._spec_accept_rate = r.histogram(
            "serve_spec_accept_rate",
            "per-row accepted/proposed fraction per spec call")

    def configure_spec_chain(self, device: bool) -> None:
        """Enable the speculative-chain sync accounting
        (serve_spec_chain_*): windows per device call and host syncs per
        emitted token. Recorded by BOTH the host `_spec_step` path
        (always 1 window per sync) and the device-resident chain, so the
        two paths' sync cost is directly comparable."""
        r = self.registry
        self._spec_device = bool(device)
        self._spec_chain_windows = r.counter(
            "serve_spec_chain_windows_total",
            "speculative gamma-windows executed")
        self._spec_chain_syncs = r.counter(
            "serve_spec_chain_syncs_total",
            "device->host syncs paid by speculative calls")
        self._spec_chain_emitted = r.counter(
            "serve_spec_chain_emitted_total",
            "tokens emitted across speculative chains")
        self._spec_chain_len = r.histogram(
            "serve_spec_chain_len",
            "gamma-windows chained per speculative device call")

    def configure_kv_quant(self, pool_bytes: int) -> None:
        """Enable the int8 KV-cache gauge (serve_kv_quant_bytes): the
        block pool's as-stored footprint, codes plus scale sidecars."""
        self._kv_quant_bytes = self.registry.gauge(
            "serve_kv_quant_bytes",
            "quantized KV pool bytes as stored (codes + scales)")
        self._kv_quant_bytes.set(int(pool_bytes))

    def configure_qos(self) -> None:
        """Enable the multi-tenant QoS surface (serve_preemptions,
        serve_qos_*). The engine turns this on lazily, the first time a
        submit names a tenant or a non-default class — single-tenant
        runs keep emitting byte-identical records (the exact-key
        snapshot contract)."""
        if self._qos_preemptions is not None:
            return
        r = self.registry
        self._qos_preemptions = r.counter(
            "serve_preemptions_total",
            "running streams evicted for a higher-priority request")
        self._qos_replayed = r.counter(
            "serve_preempted_tokens_replayed_total",
            "parked tokens regenerated token-identically after resume")
        self._qos_token_loss = r.counter(
            "serve_qos_token_loss_total",
            "parked tokens a resumed stream failed to reproduce")
        self._qos_completed = r.counter(
            "serve_qos_completed_total", "completed requests by qos class")
        self._qos_fair_share = r.gauge(
            "serve_fair_share_violation_max",
            "worst per-class shortfall vs weighted fair share")

    def record_preemption(self) -> None:
        if self._qos_preemptions is not None:
            self._qos_preemptions.inc()

    def record_preempt_resume_audit(self, replayed: int, lost: int) -> None:
        """Zero-token-loss audit at a resumed stream's finish: ``replayed``
        parked tokens were reproduced identically, ``lost`` were not
        (always 0 under the determinism contract — nonzero fails the
        QOS_SMOKE gate)."""
        if self._qos_replayed is None:
            return
        if replayed:
            self._qos_replayed.inc(replayed)
        if lost:
            self._qos_token_loss.inc(lost)

    def record_qos_finish(self, qos_class: str,
                          latency: Optional[float]) -> None:
        """Per-class completion + latency sample (DONE requests only)."""
        if self._qos_completed is None:
            return
        self._qos_completed.inc(qos_class=qos_class)
        if latency is not None:
            hist = self._qos_latency.get(qos_class)
            if hist is None:
                hist = self.registry.histogram(
                    f"serve_qos_latency_s_{qos_class}",
                    f"submit to finish, class {qos_class}")
                self._qos_latency[qos_class] = hist
            hist.observe(latency)

    def set_qos_fair_share(self, violation: Optional[float]) -> None:
        if self._qos_fair_share is not None and violation is not None:
            self._qos_fair_share.set(violation)

    def record_spec_chain(self, windows: int, syncs: int,
                          emitted: int) -> None:
        """One speculative device call: how many γ windows it chained,
        how many host syncs it cost (1 for both paths today — the point
        is windows/sync), and the tokens it emitted."""
        if self._spec_chain_windows is None:
            return
        self._spec_chain_windows.inc(windows)
        self._spec_chain_syncs.inc(syncs)
        self._spec_chain_emitted.inc(emitted)
        self._spec_chain_len.observe(float(windows))

    def configure_request_ledger(self) -> None:
        """Enable the per-request phase ledger + goodput surface
        (serve_phase_*, serve_goodput_*, serve_wasted_*). The engine
        turns this on unconditionally; bare ServeMetrics instances (and
        their exact-key snapshot contract) are unchanged."""
        r = self.registry
        self._goodput = r.counter(
            "serve_goodput_tokens_total",
            "decoded tokens that reached a completed (DONE) response")
        self._waste = r.counter(
            "serve_wasted_tokens_total",
            "decoded tokens that reached no response, by reason")
        self._phase_prefill = r.histogram(
            "serve_phase_prefill_s", "admission prefill device time")
        self._phase_decode = r.histogram(
            "serve_phase_decode_s", "prefill-end to finish")

    def record_ledger(self, goodput: int = 0, wasted: int = 0,
                      reason: str = "preempted") -> None:
        """Account one released request's decoded tokens: ``goodput``
        reached the response, ``wasted`` did not (``reason`` labels why:
        beam_discard, preempted, deadline). goodput + wasted must equal the
        tokens the engine decoded for the request — the sum contract
        ``bench --fleet`` asserts."""
        if self._goodput is None:
            return
        if goodput:
            self._goodput.inc(goodput)
        if wasted:
            self._waste.inc(wasted, reason=reason)

    def record_phases(self, prefill_s: Optional[float],
                      decode_s: Optional[float]) -> None:
        """Observe one finished request's prefill/decode phase durations
        (None skips — e.g. a request cancelled before admission)."""
        if self._phase_prefill is None:
            return
        if isinstance(prefill_s, (int, float)):
            self._phase_prefill.observe(max(float(prefill_s), 0.0))
        if isinstance(decode_s, (int, float)):
            self._phase_decode.observe(max(float(decode_s), 0.0))

    def record_spec(self, proposed: int, accepted: int,
                    target_row_steps: int, emitted: int,
                    rates=()) -> None:
        """One speculative device call: ``proposed``/``accepted`` draft
        tokens summed over active rows, ``target_row_steps`` verify
        row-steps and ``emitted`` tokens committed (the ratio is
        tokens-per-target-step — kept separate from serve_tokens so
        fallback fused windows don't dilute it), ``rates`` the per-row
        acceptance fractions for the histogram."""
        if self._spec_proposed is None:
            return
        self._spec_proposed.inc(proposed)
        self._spec_accepted.inc(accepted)
        self._spec_emitted.inc(emitted)
        self._spec_target_steps.inc(target_row_steps)
        for rate in rates:
            self._spec_accept_rate.observe(float(rate))

    def record_prefix(self, hit: bool) -> None:
        if self._prefix_lookups is not None:
            self._prefix_lookups.inc(result="hit" if hit else "miss")

    def record_prefix_evictions(self, n: int) -> None:
        if self._prefix_evictions is not None and n:
            self._prefix_evictions.inc(n)

    # -- recording hooks (called by the engine) ----------------------------

    def record_submit(self) -> None:
        self._requests.inc(state="submitted")

    def record_reject(self, retry_after_s: Optional[float] = None) -> None:
        self._requests.inc(state="rejected")
        if retry_after_s is not None:
            self._retry_after.set(retry_after_s)

    def record_admit(self, queue_wait_s: Optional[float] = None) -> None:
        self._requests.inc(state="admitted")
        if queue_wait_s is not None:
            self._queue_wait.observe(queue_wait_s)

    def record_first_token(self, ttft: float) -> None:
        self._ttft.observe(ttft)

    def record_finish(self, state: str, latency: Optional[float]) -> None:
        if state in ("done", "cancelled", "expired"):
            self._requests.inc(
                state="completed" if state == "done" else state)
        if latency is not None:
            self._latency.observe(latency)

    def record_request_trace(self, req) -> None:
        """Emit the request's lifecycle as retroactive spans at finish:
        one ``serve.request`` span (submit → finish, tagged with the
        request id and terminal state) with ``serve.request.queue``
        (submit → admit) and ``serve.request.decode`` (admit → finish)
        children — the admit→decode phases the trace exporter renders as
        a per-request gantt row. Timestamps are the engine-clock values
        already on the request; a request rejected before admission has
        no finished_at and emits nothing."""
        if not obs_enabled():
            return
        t0 = getattr(req, "submitted_at", None)
        t_end = getattr(req, "finished_at", None)
        if not isinstance(t0, (int, float)) \
                or not isinstance(t_end, (int, float)):
            return
        tracer = get_tracer()
        state = getattr(req, "state", None)
        rid = getattr(req, "id", None)
        trace_id = getattr(req, "trace_id", None) or rid
        parent = tracer.record_span(
            "serve.request", t0, max(t_end - t0, 0.0),
            request_id=rid,
            trace_id=trace_id,
            state=getattr(state, "value", state),
            beam_size=getattr(req, "beam_size", 1),
            tokens=len(getattr(req, "tokens", ()) or ()),
        )
        if parent is None:
            return
        t_admit = getattr(req, "admitted_at", None)
        if isinstance(t_admit, (int, float)):
            tracer.record_span(
                "serve.request.queue", t0, max(t_admit - t0, 0.0),
                parent_id=parent, request_id=rid)
            prefill_s = getattr(req, "prefill_s", None)
            t_decode = t_admit
            if isinstance(prefill_s, (int, float)) and prefill_s > 0:
                prefill_s = min(max(float(prefill_s), 0.0),
                                max(t_end - t_admit, 0.0))
                tracer.record_span(
                    "serve.request.prefill", t_admit, prefill_s,
                    parent_id=parent, request_id=rid)
                t_decode = t_admit + prefill_s
            tracer.record_span(
                "serve.request.decode", t_decode,
                max(t_end - t_decode, 0.0), parent_id=parent,
                request_id=rid,
                ttft_s=getattr(req, "ttft_s", None))

    def record_step(self, active_rows: float, queue_depth: int,
                    new_tokens: int, step_time_s: float,
                    steps: int = 1,
                    kv_blocks_in_use: Optional[int] = None) -> None:
        """One device call covering ``steps`` decode steps.

        ``active_rows`` is the total active row-steps across the call
        (for a single step, simply the active row count), so occupancy
        stays an average over decode steps whatever the window size.
        ``kv_blocks_in_use`` is the paged engine's pool occupancy at the
        call (only meaningful after :meth:`configure_kv_pool`).
        """
        steps = max(int(steps), 1)
        self._steps.inc(steps)
        self._windows.inc()
        self._tokens.inc(new_tokens)
        self._busy.inc(step_time_s)
        self._occupancy_sum_c.inc(active_rows / max(self.capacity, 1))
        self._step_latency.observe(step_time_s / steps)
        self._queue_depth.set(queue_depth)
        if kv_blocks_in_use is not None and self._kv_pool is not None:
            self._kv_in_use.set(kv_blocks_in_use)
            self._kv_util_sum.inc(
                kv_blocks_in_use / max(self._kv_pool[0], 1))
            self._kv_util_calls.inc()

    # -- pre-registry attribute surface (properties over instruments) ------

    @property
    def submitted(self) -> int:
        return int(self._requests.value(state="submitted"))

    @property
    def rejected(self) -> int:
        return int(self._requests.value(state="rejected"))

    @property
    def admitted(self) -> int:
        return int(self._requests.value(state="admitted"))

    @property
    def completed(self) -> int:
        return int(self._requests.value(state="completed"))

    @property
    def cancelled(self) -> int:
        return int(self._requests.value(state="cancelled"))

    @property
    def expired(self) -> int:
        return int(self._requests.value(state="expired"))

    @property
    def steps(self) -> int:
        return int(self._steps.value())

    @property
    def windows(self) -> int:
        return int(self._windows.value())

    @property
    def tokens_generated(self) -> int:
        return int(self._tokens.value())

    @property
    def busy_time_s(self) -> float:
        return self._busy.value()

    @property
    def last_queue_depth(self) -> int:
        v = self._queue_depth.value()
        return int(v) if v is not None else 0

    @property
    def ckpt_load_retries(self) -> int:
        v = self._ckpt_retries.value()
        return int(v) if v is not None else 0

    @ckpt_load_retries.setter
    def ckpt_load_retries(self, v: int) -> None:
        self._ckpt_retries.set(v)

    @property
    def last_retry_after_s(self) -> Optional[float]:
        return self._retry_after.value()

    @property
    def ttft_s(self) -> List[float]:
        return self._ttft.samples()

    @property
    def latency_s(self) -> List[float]:
        return self._latency.samples()

    @property
    def queue_wait_s(self) -> List[float]:
        return self._queue_wait.samples()

    @property
    def step_latency_s(self) -> List[float]:
        return self._step_latency.samples()

    # -- reporting ---------------------------------------------------------

    @property
    def tokens_per_sec(self) -> Optional[float]:
        busy = self.busy_time_s
        if busy <= 0:
            return None
        return self.tokens_generated / busy

    @property
    def mean_slot_occupancy(self) -> Optional[float]:
        steps = self.steps
        if steps == 0:
            return None
        return self._occupancy_sum_c.value() / steps

    @property
    def mean_steps_per_window(self) -> Optional[float]:
        windows = self.windows
        if windows == 0:
            return None
        return self.steps / windows

    @property
    def kv_block_utilization(self) -> Optional[float]:
        """Mean allocated-pool fraction over device calls (paged only)."""
        if self._kv_util_calls is None:
            return None
        calls = self._kv_util_calls.value()
        if calls == 0:
            return None
        return self._kv_util_sum.value() / calls

    @property
    def prefix_hits(self) -> int:
        if self._prefix_lookups is None:
            return 0
        return int(self._prefix_lookups.value(result="hit"))

    @property
    def prefix_misses(self) -> int:
        if self._prefix_lookups is None:
            return 0
        return int(self._prefix_lookups.value(result="miss"))

    @property
    def prefix_hit_rate(self) -> Optional[float]:
        lookups = self.prefix_hits + self.prefix_misses
        if lookups == 0:
            return None
        return self.prefix_hits / lookups

    @property
    def radix_hits(self) -> int:
        """Resumed + instantly-completed admissions (any cached reuse)."""
        if self._radix_lookups is None:
            return 0
        return int(self._radix_lookups.value(result="hit")
                   + self._radix_lookups.value(result="instant"))

    @property
    def radix_misses(self) -> int:
        if self._radix_lookups is None:
            return 0
        return int(self._radix_lookups.value(result="miss"))

    @property
    def radix_hit_rate(self) -> Optional[float]:
        lookups = self.radix_hits + self.radix_misses
        if lookups == 0:
            return None
        return self.radix_hits / lookups

    @property
    def radix_hit_tokens(self) -> int:
        if self._radix_hit_tokens is None:
            return 0
        return int(self._radix_hit_tokens.value())

    @property
    def radix_shared_block_ratio(self) -> Optional[float]:
        """Fraction of released requests' bound blocks that came shared
        from the tree instead of freshly prefilled."""
        if self._radix_request_blocks is None:
            return None
        total = self._radix_request_blocks.value()
        if total == 0:
            return None
        return self._radix_shared_blocks.value() / total

    def radix_evictions_by_cause(self) -> Dict[str, int]:
        if self._radix_evictions is None:
            return {}
        out: Dict[str, int] = {}
        for key, count in self._radix_evictions.series().items():
            cause = dict(key).get("cause")
            if cause is not None:
                out[cause] = int(count)
        return out

    @property
    def spec_proposed(self) -> int:
        if self._spec_proposed is None:
            return 0
        return int(self._spec_proposed.value())

    @property
    def spec_accepted(self) -> int:
        if self._spec_accepted is None:
            return 0
        return int(self._spec_accepted.value())

    @property
    def spec_accept_rate(self) -> Optional[float]:
        """Overall accepted/proposed fraction across all spec calls."""
        proposed = self.spec_proposed
        if proposed == 0:
            return None
        return self.spec_accepted / proposed

    @property
    def spec_tokens_per_target_step(self) -> Optional[float]:
        """Tokens committed per target verify row-step; > 1.0 means
        speculation is amortizing target forward passes."""
        if self._spec_target_steps is None:
            return None
        steps = self._spec_target_steps.value()
        if steps == 0:
            return None
        return self._spec_emitted.value() / steps

    @property
    def spec_windows_per_chain(self) -> Optional[float]:
        """Mean γ-windows per speculative device call (per host sync)."""
        if self._spec_chain_syncs is None:
            return None
        syncs = self._spec_chain_syncs.value()
        if syncs == 0:
            return None
        return self._spec_chain_windows.value() / syncs

    @property
    def spec_host_syncs_per_token(self) -> Optional[float]:
        """Host syncs paid per emitted token — the number the
        device-resident chain exists to shrink (the host path pays
        1/(accepted+1) per token; a chain divides that by its length)."""
        if self._spec_chain_syncs is None:
            return None
        emitted = self._spec_chain_emitted.value()
        if emitted == 0:
            return None
        return self._spec_chain_syncs.value() / emitted

    @property
    def preemptions(self) -> int:
        if self._qos_preemptions is None:
            return 0
        return int(self._qos_preemptions.value())

    @property
    def preempted_tokens_replayed(self) -> int:
        if self._qos_replayed is None:
            return 0
        return int(self._qos_replayed.value())

    @property
    def qos_token_loss(self) -> int:
        if self._qos_token_loss is None:
            return 0
        return int(self._qos_token_loss.value())

    def qos_by_class(self) -> Dict[str, Dict]:
        """Per-class completion counts and latency percentiles."""
        if self._qos_completed is None:
            return {}
        out: Dict[str, Dict] = {}
        for key, count in self._qos_completed.series().items():
            cls = dict(key).get("qos_class")
            if cls is None:
                continue
            hist = self._qos_latency.get(cls)
            out[cls] = {
                "completed": int(count),
                "latency_p50_s":
                    hist.percentile(50) if hist is not None else None,
                "latency_p95_s":
                    hist.percentile(95) if hist is not None else None,
            }
        return out

    @property
    def goodput_tokens(self) -> int:
        if self._goodput is None:
            return 0
        return int(self._goodput.value())

    @property
    def wasted_tokens(self) -> int:
        """Total decoded-but-unused tokens across waste reasons."""
        if self._waste is None:
            return 0
        return int(sum(self._waste.series().values()))

    @property
    def preempted_wasted_tokens(self) -> int:
        """Tokens ledgered as waste by preemptive eviction. Preemption
        is engine-internal — the router never abandons the stream — so
        fleet-level goodput accounting must read this from the engines,
        not from the router's evacuation ledger."""
        if self._waste is None:
            return 0
        return int(sum(v for k, v in self._waste.series().items()
                       if dict(k).get("reason") == "preempted"))

    @property
    def deadline_wasted_tokens(self) -> int:
        """Tokens decoded for requests that then missed their deadline
        (``wasted{reason="deadline"}``). Split out from preemption waste
        so chaos / brownout audits can tell scheduler churn from
        client-budget misses; both buckets stay inside the
        goodput + wasted == decoded conservation sum."""
        if self._waste is None:
            return 0
        return int(sum(v for k, v in self._waste.series().items()
                       if dict(k).get("reason") == "deadline"))

    @property
    def wasted_draft_tokens(self) -> int:
        """Rejected speculation drafts. Tracked separately from
        :attr:`wasted_tokens`: draft proposals never enter
        ``tokens_generated`` (only emitted tokens do), so they sit
        outside the goodput + wasted == decoded sum contract."""
        return max(0, self.spec_proposed - self.spec_accepted)

    def snapshot(self) -> Dict:
        snap = {
            "serve_submitted": self.submitted,
            "serve_rejected": self.rejected,
            "serve_admitted": self.admitted,
            "serve_completed": self.completed,
            "serve_cancelled": self.cancelled,
            "serve_expired": self.expired,
            "serve_steps": self.steps,
            "serve_decode_windows": self.windows,
            "serve_steps_per_window": self.mean_steps_per_window,
            "serve_queue_depth": self.last_queue_depth,
            "serve_slot_capacity": self.capacity,
            "serve_slot_occupancy": self.mean_slot_occupancy,
            "serve_tokens_generated": self.tokens_generated,
            "serve_tokens_per_sec": self.tokens_per_sec,
            "serve_ckpt_load_retries": self.ckpt_load_retries,
            "serve_retry_after_hint_s": self.last_retry_after_s,
            "serve_queue_wait_p50_s": self._queue_wait.percentile(50),
            "serve_queue_wait_p95_s": self._queue_wait.percentile(95),
            "serve_ttft_p50_s": self._ttft.percentile(50),
            "serve_ttft_p95_s": self._ttft.percentile(95),
            "serve_latency_p50_s": self._latency.percentile(50),
            "serve_latency_p95_s": self._latency.percentile(95),
            "serve_step_latency_p50_s": self._step_latency.percentile(50),
            "serve_step_latency_p95_s": self._step_latency.percentile(95),
            "serve_uptime_s": self._clock() - self.started_at,
        }
        # Feature-gated keys: present only when the engine configured the
        # paged pool / prefix cache, so the base snapshot surface (and the
        # exact-key parity tests over it) is untouched for slot engines.
        if self._kv_pool is not None:
            usable, block_size = self._kv_pool
            in_use = self._kv_in_use.value()
            snap["serve_kv_blocks_total"] = usable
            snap["serve_kv_block_size"] = block_size
            snap["serve_kv_blocks_in_use"] = \
                int(in_use) if in_use is not None else 0
            snap["serve_kv_block_utilization"] = self.kv_block_utilization
        if self._prefix_size:
            snap["serve_prefix_cache_size"] = self._prefix_size
            snap["serve_prefix_hits"] = self.prefix_hits
            snap["serve_prefix_misses"] = self.prefix_misses
            snap["serve_prefix_evictions"] = \
                int(self._prefix_evictions.value())
            snap["serve_prefix_hit_rate"] = self.prefix_hit_rate
        if self._radix_lookups is not None:
            nodes = self._radix_nodes.value()
            blocks = self._radix_blocks.value()
            snap["serve_radix_nodes"] = \
                int(nodes) if nodes is not None else 0
            snap["serve_radix_blocks"] = \
                int(blocks) if blocks is not None else 0
            snap["serve_radix_hits"] = self.radix_hits
            snap["serve_radix_misses"] = self.radix_misses
            snap["serve_radix_hit_rate"] = self.radix_hit_rate
            snap["serve_radix_instant_completes"] = \
                int(self._radix_lookups.value(result="instant"))
            snap["serve_radix_hit_tokens"] = self.radix_hit_tokens
            snap["serve_radix_shared_blocks"] = \
                int(self._radix_shared_blocks.value())
            snap["serve_radix_shared_block_ratio"] = \
                self.radix_shared_block_ratio
            snap["serve_radix_evictions"] = \
                int(sum(self._radix_evictions.series().values()))
            snap["serve_radix_evictions_by_cause"] = \
                self.radix_evictions_by_cause()
        if self._spec_gamma:
            snap["serve_spec_gamma"] = self._spec_gamma
            snap["serve_spec_proposed"] = self.spec_proposed
            snap["serve_spec_accepted"] = self.spec_accepted
            snap["serve_spec_accept_rate"] = self.spec_accept_rate
            snap["serve_spec_accept_rate_p50"] = \
                self._spec_accept_rate.percentile(50)
            snap["serve_spec_accept_rate_p95"] = \
                self._spec_accept_rate.percentile(95)
            snap["serve_spec_tokens_per_target_step"] = \
                self.spec_tokens_per_target_step
        if self._spec_chain_windows is not None:
            snap["serve_spec_device"] = self._spec_device
            snap["serve_spec_chain_windows"] = \
                int(self._spec_chain_windows.value())
            snap["serve_spec_chain_syncs"] = \
                int(self._spec_chain_syncs.value())
            snap["serve_spec_windows_per_chain"] = \
                self.spec_windows_per_chain
            snap["serve_spec_host_syncs_per_token"] = \
                self.spec_host_syncs_per_token
            snap["serve_spec_chain_len_p50"] = \
                self._spec_chain_len.percentile(50)
            snap["serve_spec_chain_len_p95"] = \
                self._spec_chain_len.percentile(95)
        if self._kv_quant_bytes is not None:
            snap["serve_kv_quant_bytes"] = \
                int(self._kv_quant_bytes.value())
        if self._qos_preemptions is not None:
            snap["serve_preemptions"] = self.preemptions
            snap["serve_preempted_tokens_replayed"] = \
                self.preempted_tokens_replayed
            snap["serve_qos_token_loss"] = self.qos_token_loss
            snap["serve_fair_share_violation_max"] = \
                self._qos_fair_share.value()
            snap["serve_qos_by_class"] = self.qos_by_class()
        if self._goodput is not None:
            snap["serve_goodput_tokens"] = self.goodput_tokens
            snap["serve_wasted_tokens"] = self.wasted_tokens
            snap["serve_deadline_wasted_tokens"] = self.deadline_wasted_tokens
            snap["serve_wasted_draft_tokens"] = self.wasted_draft_tokens
            snap["serve_phase_prefill_p50_s"] = \
                self._phase_prefill.percentile(50)
            snap["serve_phase_prefill_p95_s"] = \
                self._phase_prefill.percentile(95)
            snap["serve_phase_decode_p50_s"] = \
                self._phase_decode.percentile(50)
            snap["serve_phase_decode_p95_s"] = \
                self._phase_decode.percentile(95)
        if self._chunk_ticks is not None:
            snap["serve_chunk_size"] = self._chunk_size
            snap["serve_chunk_ticks"] = int(self._chunk_ticks.value())
            snap["serve_chunk_tokens"] = int(self._chunk_tokens.value())
            snap["serve_chunks_per_tick_p50"] = \
                self._chunks_per_tick.percentile(50)
            snap["serve_chunks_per_tick_p95"] = \
                self._chunks_per_tick.percentile(95)
            rows = self._chunk_partial_rows.value()
            snap["serve_chunk_partial_rows"] = \
                int(rows) if rows is not None else 0
            snap["serve_chunk_stall_ticks_avoided"] = \
                int(self._chunk_stall_avoided.value())
            snap["serve_chunk_ticks_per_prefill_p50"] = \
                self._chunk_ticks_per_prefill.percentile(50)
            snap["serve_chunk_ticks_per_prefill_p95"] = \
                self._chunk_ticks_per_prefill.percentile(95)
        return snap

    def emit(self, writer: MetricsWriter, **extra) -> None:
        writer.write({**self.snapshot(), **extra})
