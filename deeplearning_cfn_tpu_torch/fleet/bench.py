"""Fleet benchmark: the serve fixed trace routed across N replicas.

The port of the JAX package's ``fleet/bench.py``. ``cli bench --fleet`` —
same deterministic trace and tiny random-init NMT model as serve/bench.py,
driven through the Router over N in-process engine replicas on the device
``accelerator`` names. The record keeps the BENCH_* contract
shape and adds the fleet contract fields CI gates on: ``replicas``,
``dropped_requests`` (must be 0 — the router's zero-drop guarantee),
``per_replica`` utilization, and (in smoke mode) ``token_identical`` —
the fleet's aggregate output compared token-for-token against a
single-engine run of the same trace, which holds because greedy decode
is deterministic and the router never loses a request.

All replicas share ONE model (one ``serve.bench.tiny_model``), so parity
with the single-engine baseline is exact by construction.

``chaos_kill_step > 0`` arms a runtime/faults.py crash spec that kills
replica 0 mid-decode on its Nth step — the chaos-tested variant of the
same contract (``dropped_requests`` still 0, tokens still identical).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np

from ..loadgen import LoadGenerator, VirtualClock, parse_trace_spec, replay
from ..runtime.faults import FaultPlan, FaultSpec
from ..runtime.platform import resolve_device
from ..serve import bench as serve_bench
from ..serve.bench import TINY_VOCAB, _fixed_trace, device_name
from ..serve.engine import Engine
from ..serve.metrics import percentile
from ..serve.queue import OverloadError
from .autoscale import AutoscalePolicy, Autoscaler
from .replica import EngineReplica
from .router import Router

METRIC = "fleet_tiny_nmt_tokens_per_sec"
UNIT = "tokens/sec"


def _single_engine_tokens(model, pairs, slots: int,
                          src_len: int, max_new_tokens: int,
                          decode_window: int,
                          kv_block_size: int = 0,
                          speculate: int = 0,
                          speculate_device: bool = False,
                          kv_quant: str = "") -> List[List[int]]:
    """The baseline: the same (src, budget) trace through ONE engine;
    returns the per-trace-index token lists the fleet output must
    match. ``kv_block_size > 0`` runs the paged path (the disagg
    topologies are paged, so their baseline is too). The speculation and
    KV-quant knobs mirror the fleet's so parity stays apples-to-apples.
    The radix knob deliberately does NOT: the baseline is always
    cold-cache, so a radix fleet's ``token_identical`` proves cached
    reuse changes no tokens."""
    engine = Engine(model, capacity=slots, max_src_len=src_len,
                    queue_depth=len(pairs) + 1,
                    default_max_new_tokens=max_new_tokens,
                    decode_window=decode_window,
                    kv_block_size=kv_block_size,
                    speculate_gamma=speculate,
                    speculate_device=speculate_device,
                    kv_quant=kv_quant)
    ids = []
    for src, budget in pairs:
        while True:
            try:
                ids.append(engine.submit(
                    src, max_new_tokens=budget).id)
                break
            except OverloadError:
                engine.step()
    engine.run_until_drained()
    return [list(engine.poll(i).tokens) for i in ids]


def _tenants_trace(num_requests: int, src_len: int, vocab: int,
                   max_new_tokens: int, seed: int, corpus=None):
    """The noisy-neighbour mix for the fixed-trace path: tenant-b's
    bulk batch-class jobs (long prompt, full budget, submitted first so
    they hold the slots) flood the fleet around tenant-a's
    latency-class interactive streams. Returns ``(pairs, tags)`` —
    ``tags[i]`` is the tenant/qos submit kwargs for ``pairs[i]``.
    ``corpus`` (one token list per entry, e.g. wmt_sliver lines)
    replaces the random prompts."""
    rng = np.random.default_rng(seed)
    short_len = max(2, src_len // 3)
    pairs, tags = [], []
    for i in range(num_requests):
        if i % 3 == 2:
            n, budget = short_len, max(1, max_new_tokens // 2)
            tag = {"tenant": "tenant-a", "qos_class": "latency"}
        else:
            n, budget = src_len, max_new_tokens
            tag = {"tenant": "tenant-b", "qos_class": "batch"}
        if corpus is not None:
            src = [int(t) for t in corpus[i % len(corpus)]][:n]
            if not src:
                raise ValueError(f"trace entry {i % len(corpus)} is empty")
        else:
            src = [int(t) for t in rng.integers(3, vocab, size=n)]
        pairs.append((src, budget))
        tags.append(tag)
    return pairs, tags


#: The fixed prompt pool size for the prefix-heavy trace. Pools are
#: NESTED: the group-g trace draws its prompts from the first g entries
#: of one seeded pool, so sweeping g only removes distinct sources —
#: cold decode work is monotone in g by construction, which is what the
#: radix sweep's monotonicity contract leans on.
_PREFIX_POOL = 8


def _prefix_group_trace(num_requests: int, src_len: int, vocab: int,
                        max_new_tokens: int, seed: int, groups: int,
                        corpus=None):
    """The shared-system-prompt mix the radix cache feeds on: requests
    repeat ``groups`` WHOLE prompts round-robin (identical full sources
    — the condition decoder-KV sharing needs in an encoder-decoder
    model). Returns ``(pairs, tags)``; ``tags[i]`` carries the group id
    as the router ``affinity_key`` so cache-aware policies can steer
    group members to one replica. ``corpus`` (one token list per entry,
    e.g. wmt_sliver lines) replaces the random prompt pool."""
    if groups < 1:
        raise ValueError(f"groups must be >= 1, got {groups}")
    rng = np.random.default_rng(seed)
    pool = [[int(t) for t in rng.integers(3, vocab, size=src_len)]
            for _ in range(max(_PREFIX_POOL, groups))]
    if corpus is not None:
        for j in range(len(pool)):
            src = [int(t) for t in corpus[j % len(corpus)]][:src_len]
            if not src:
                raise ValueError(f"corpus entry {j % len(corpus)} is empty")
            pool[j] = src
    pairs, tags = [], []
    for i in range(num_requests):
        g = i % groups
        pairs.append((list(pool[g]), max_new_tokens))
        tags.append({"affinity_key": f"grp-{g}"})
    return pairs, tags


def _prefill_heavy_trace(num_requests: int, src_len: int, vocab: int,
                         max_new_tokens: int, seed: int):
    """The adversarial mix: even arrivals are long-prompt/short-decode
    requests (maximum admission-prefill work per token of output), odd
    arrivals are short-prompt latency streams decoding to full budget.
    On a co-located fleet the long prompts stall the latency streams'
    decode; a disaggregated fleet absorbs them on the prefill pool."""
    rng = np.random.default_rng(seed)
    short_len = max(2, src_len // 3)
    pairs = []
    for i in range(num_requests):
        if i % 2 == 0:
            n, budget = src_len, min(2, max_new_tokens)   # the adversary
        else:
            n, budget = short_len, max_new_tokens         # latency stream
        pairs.append(([int(t) for t in rng.integers(3, vocab, size=n)],
                      budget))
    return pairs


def run_fleet_bench(replicas: int = 2, num_requests: int = 16,
                    slots: int = 2, max_new_tokens: int = 16,
                    src_len: int = 12, seed: int = 0,
                    decode_window: int = 4,
                    policy: str = "least_loaded",
                    chaos_kill_step: int = 0,
                    smoke: bool = False,
                    trace_dir: Optional[str] = None,
                    prefill_replicas: int = 0,
                    decode_replicas: int = 0,
                    trace_mix: str = "uniform",
                    trace: Optional[List[List[int]]] = None,
                    speculate: int = 0,
                    speculate_device: bool = False,
                    kv_quant: str = "",
                    radix: bool = False,
                    trace_spec: Optional[str] = None,
                    autoscale: bool = False,
                    min_replicas: int = 1,
                    max_replicas: int = 0,
                    tick_s: float = 0.05,
                    prefill_chunk: int = 0,
                    chaos_plan: Optional[str] = None,
                    degrade: bool = False,
                    degrade_policy=None,
                    accelerator="gpu") -> Dict:
    """Route the fixed trace across the fleet to drain; return the
    BENCH-contract record with the fleet fields. ``smoke`` shrinks the
    scenario AND runs the single-engine parity baseline (the t1.sh gate
    asserts ``token_identical`` and ``dropped_requests == 0``).

    ``prefill_replicas``/``decode_replicas`` (both > 0) build a
    DISAGGREGATED topology instead of ``replicas`` co-located engines:
    prefill engines park each finished admission prefill and the router
    hops the stream's KV blocks to a decode engine through the handoff
    codec. The record then carries the contract run — the SAME trace
    through a co-located paged fleet in the same invocation — yielding
    ``token_identical_colocated`` plus ``decode_p95_disagg`` vs
    ``decode_p95_colocated`` (measured over the latency streams when
    ``trace_mix='prefill-heavy'``).

    ``trace_mix='prefill-heavy'`` interleaves long-prompt/short-decode
    adversaries with short-prompt latency streams: on a co-located
    fleet the adversaries' admission prefill stalls the streams' decode
    (the interference baseline); a disaggregated fleet absorbs them on
    the prefill pool.

    ``trace`` overrides the generated prompts (one src-id list per
    request, each decoded to the full budget).

    ``speculate``/``speculate_device``/``kv_quant`` thread the serve
    engine's speculative-decoding and int8 KV-cache knobs through every
    replica AND the single-engine parity baseline (``kv_quant`` forces
    the paged path fleet-wide, since int8 blocks only exist there).

    ``radix`` arms each replica's radix token-prefix KV cache (forcing
    the paged path fleet-wide). The parity baseline stays COLD-cache so
    ``token_identical`` proves cached reuse changes no tokens. With
    ``trace_mix='prefix-heavy'`` (requests repeating a handful of whole
    prompts, each tagged with its group id as the router affinity key)
    the record additionally carries the cache-efficiency evidence: a
    sharing sweep (``radix_sweep`` — decoded tokens per request must
    fall monotonically as the prompt-group count shrinks) and the
    policy comparison (``radix_hit_rate_prefix_affinity`` vs
    ``radix_hit_rate_round_robin`` over the same trace and fleet).

    ``trace_dir`` arms fleet tracing: each replica writes its span shard
    to ``<dir>/<replica>/metrics.jsonl``, the router writes its
    ``fleet.request`` spans to ``<dir>/router.jsonl`` and the end-of-run
    signal snapshot to ``<dir>/signals.jsonl`` — the layout
    ``obs export --fleet <dir>`` merges into one Perfetto timeline.

    ``trace_spec`` (a ``--trace`` string, e.g. ``"burst"`` or
    ``"poisson:rate=8,duration=2"``) replaces the fixed submit-to-drain
    loop with OPEN-LOOP replay: a seeded :class:`~..loadgen
    .LoadGenerator` schedule drives ``Router.submit`` on a
    :class:`~..loadgen.VirtualClock` shared by the router AND every
    engine, so queue waits, retry-after hints, and latency percentiles
    are virtual-time quantities — fully deterministic under the seed.
    A ``trace`` prompt list then serves as the replay's prompt corpus.

    ``autoscale`` (requires ``trace_spec``) arms the closed loop: the
    fleet starts at ``min_replicas`` and an :class:`~.autoscale
    .Autoscaler` fed by a live SignalBus scales it between
    ``min_replicas`` and ``max_replicas`` (default: ``replicas``) on
    the replay clock, emitting ``scale_event`` records into the record
    (and ``<trace_dir>/autoscale.jsonl``). The contract: scale-up on
    the burst onset, drain-based scale-down in the trough,
    ``dropped_requests == 0``, and ``token_identical`` against a
    FIXED fleet of ``max_replicas`` replaying the same schedule.

    ``prefill_chunk > 0`` arms Sarathi-style chunked prefill on every
    co-located replica (engine ``--prefill-chunk``). Outside replay/
    chaos runs the record then carries the stall-free contract pair —
    the SAME trace through a fresh UNCHUNKED fleet in the same
    invocation (``token_identical_unchunked``, ``chunked_decode_p95``
    vs ``unchunked_decode_p95``) — and, under
    ``trace_mix='prefill-heavy'``, a no-adversary baseline over the
    warmed chunked members (``decode_p95_no_adversary``): the
    co-located form of the contract disaggregation pinned, without a
    split fleet.

    ``chaos_plan`` (a JSON path, or an already-parsed plan dict) arms
    site-addressable fleet fault injection: the plan's
    :class:`~..runtime.faults.FaultSpec` rules are consulted at
    ``replica.step`` / ``replica.submit`` (by every
    :class:`~.replica.EngineReplica`) and ``handoff.export`` /
    ``handoff.import`` / ``router.cancel`` (by the router). The record
    then carries ``chaos_plan`` and ``faults_injected`` (kind → fire
    count) so a green run proves the plan actually bit. The chaos
    contract is unchanged from ``chaos_kill_step``: zero drops, token
    parity, balanced goodput ledger.

    ``degrade`` attaches a :class:`~.degrade.DegradeController`
    brownout loop to the router: SignalBus queue pressure steps the
    fleet through no-speculation → capped decode windows → batch-class
    shedding (and hysteretically back), every transition audited in the
    record's ``degrade_transitions``/``degrade_events`` (and
    ``<trace_dir>/degrade.jsonl``). All three levels are
    token-preserving, so ``token_identical`` still holds.
    ``degrade_policy`` substitutes a custom
    :class:`~.degrade.DegradePolicy` (thresholds, streak lengths,
    cooldown) for the controller's defaults — smoke-scale harnesses
    need far more sensitive thresholds than a production fleet.

    ``accelerator``: the device every engine runs on (``gpu``, the
    default, raises without a card; ``cpu``)."""
    dev = resolve_device(accelerator)
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    if (prefill_replicas > 0) != (decode_replicas > 0):
        raise ValueError(
            "disaggregation needs BOTH prefill and decode replicas (got "
            f"prefill={prefill_replicas}, decode={decode_replicas})")
    if trace_mix not in ("uniform", "prefill-heavy", "tenants",
                         "prefix-heavy"):
        raise ValueError(f"unknown trace mix {trace_mix!r}")
    disagg = prefill_replicas > 0
    if prefill_chunk < 0:
        raise ValueError(
            f"prefill_chunk must be >= 0, got {prefill_chunk}")
    if prefill_chunk > 0 and disagg:
        raise ValueError("chunked prefill needs co-located replicas "
                         "(phase='both'): disaggregated phases already "
                         "split prefill off the decode tick")
    if radix and disagg:
        raise ValueError("the radix cache needs co-located replicas "
                         "(phase='both'): a split prefill/decode stream "
                         "never owns a reusable finished block table)")
    if autoscale and trace_spec is None:
        raise ValueError("autoscale needs a trace spec (--trace): the "
                         "controller runs on the open-loop replay clock")
    if trace_spec is not None and disagg:
        raise ValueError("trace replay does not drive disaggregated "
                         "topologies yet (use the fixed-trace bench)")
    if min_replicas < 1:
        raise ValueError(f"min_replicas must be >= 1, got {min_replicas}")
    if smoke:
        replicas = 2
        if disagg:
            prefill_replicas = decode_replicas = 1
        num_requests, slots = min(num_requests, 6), min(slots, 2)
        max_new_tokens, src_len = min(max_new_tokens, 4), min(src_len, 8)
    if autoscale and max_replicas <= 0:
        max_replicas = max(replicas, min_replicas)

    model = serve_bench.tiny_model(seed, dev)
    spec = gen = vclock = None
    qos_tags: Optional[List[Dict[str, str]]] = None
    if trace_spec is not None:
        # Open-loop replay: the seeded schedule is the trace. A `trace`
        # prompt list becomes the generator's prompt corpus; the bench
        # mix maps onto the spec unless the spec string pins its own.
        txt = trace_spec
        if trace_mix != "uniform" and "mix=" not in txt:
            txt += (":" if ":" not in txt else ",") + f"mix={trace_mix}"
        spec = parse_trace_spec(txt, src_len=src_len,
                                max_new_tokens=max_new_tokens,
                                requests=num_requests)
        gen = LoadGenerator(spec, seed=seed, vocab_size=TINY_VOCAB,
                            prompt_corpus=trace)
        pairs = gen.pairs()
        num_requests = len(pairs)
        vclock = VirtualClock()
    elif trace_mix == "tenants":
        # The tenant mix keeps its tags even when a prompt corpus
        # (`trace`) supplies the tokens — the QOS_SMOKE gate replays
        # wmt_sliver lines as two tenants' prompts.
        pairs, qos_tags = _tenants_trace(
            num_requests if trace is None else len(trace),
            src_len, TINY_VOCAB, max_new_tokens, seed, corpus=trace)
        num_requests = len(pairs)
    elif trace_mix == "prefix-heavy":
        # Two whole-prompt groups by default — every group repeats many
        # times, the shape the radix cache (and the RADIX_SMOKE gate's
        # wmt_sliver corpus replay) feeds on. The sweep below varies the
        # group count itself.
        pairs, qos_tags = _prefix_group_trace(
            num_requests if trace is None else max(len(trace),
                                                   num_requests),
            src_len, TINY_VOCAB, max_new_tokens, seed, groups=2,
            corpus=trace)
        num_requests = len(pairs)
    elif trace is not None:
        pairs = [([int(t) for t in src], max_new_tokens) for src in trace]
        num_requests = len(pairs)
    elif trace_mix == "prefill-heavy":
        pairs = _prefill_heavy_trace(num_requests, src_len, TINY_VOCAB,
                                     max_new_tokens, seed)
    else:
        pairs = [(src, max_new_tokens)
                 for src in _fixed_trace(num_requests, src_len, TINY_VOCAB,
                                         seed=seed)]

    # Disaggregation rides the paged KV path (the handoff artifact is
    # block-structured); the co-located contract fleet and the parity
    # baseline use the same block size so the comparison is
    # apples-to-apples.
    kv_block_size = 4 if (disagg or kv_quant or radix) else 0

    fault_plan = None
    if chaos_plan is not None:
        fault_plan = (FaultPlan.from_json(chaos_plan)
                      if isinstance(chaos_plan, str)
                      else FaultPlan.from_dict(chaos_plan))
    if chaos_kill_step > 0:
        # chaos_kill_step is 1-based ("kill on the Nth router step of
        # the first replica"); FaultSpec.at_calls counts from 0.
        kill = FaultSpec(
            op="step", key="prefill-0" if disagg else "replica-0",
            kind="crash", at_calls=(chaos_kill_step - 1,))
        if fault_plan is None:
            fault_plan = FaultPlan([kill])
        else:
            fault_plan.specs.append(kill)

    # Under trace replay, every engine AND the router read ONE virtual
    # clock — retry-after hints, queue waits, and latency percentiles
    # become virtual-time quantities, so every autoscale decision is a
    # pure function of the seed. ``_clock_ref`` is a rebindable cell so
    # the fixed-fleet parity run gets a fresh clock through the same
    # engine-building closure.
    _clock_ref = [vclock]

    def _fleet_clock():
        return _clock_ref[0].read() if _clock_ref[0] is not None \
            else time.monotonic()

    def _build_fleet(specs, plan, chunk=None):
        # ``chunk`` overrides the fleet-wide prefill_chunk (the chunked
        # contract block builds an UNCHUNKED comparison fleet with 0);
        # disaggregated phases never chunk (the engine rejects it).
        chunk = prefill_chunk if chunk is None else chunk
        built: List[EngineReplica] = []
        warm: Dict[str, int] = {}
        for name, phase in specs:
            engine = Engine(model, capacity=slots,
                            max_src_len=src_len,
                            queue_depth=max(num_requests, 4),
                            default_max_new_tokens=max_new_tokens,
                            decode_window=decode_window,
                            kv_block_size=kv_block_size,
                            speculate_gamma=speculate,
                            speculate_device=speculate_device,
                            kv_quant=kv_quant,
                            radix_cache=radix,
                            phase=phase,
                            prefill_chunk=chunk if phase == "both" else 0,
                            clock=_fleet_clock)
            rep = EngineReplica(name, engine, fault_plan=plan)
            # Warmup per replica, outside the timed window. Full budget,
            # so every fused-window shape the timed run decodes through
            # has run once up front — a decode replica otherwise pays
            # its first launches inside the first stream's decode_s and
            # poisons the p95 contract.
            warm_req = engine.submit(
                pairs[0][0], max_new_tokens=max_new_tokens)
            if chunk > 0 and phase == "both" and slots >= 2:
                # Chunked engines drop to window-1 fused steps whenever
                # a partial prefill coexists with decode — a shape one
                # warm request never exercises (its own chunk ticks
                # have nothing decoding yet). Overlap a second warm
                # prompt: the quota drains heads in order, so the first
                # finishes encoding and decodes window-1 while the
                # second is still partial — running that variant once
                # here instead of inside the first timed stream's
                # decode_s.
                engine.submit(pairs[0][0],
                              max_new_tokens=max_new_tokens)
            engine.run_until_drained()
            if phase == "prefill" and engine.handoff_ready(warm_req.id):
                # Prefill engines park instead of finishing — free the
                # warmup stream's blocks before traffic arrives.
                engine.release_handoff(warm_req.id)
            warm[rep.id] = engine.metrics.tokens_generated
            built.append(rep)
        return built, warm

    def _drive(rt, drive_pairs, rid_prefix=None, tags=None):
        out = []
        for i, (src, budget) in enumerate(drive_pairs):
            rid = None if rid_prefix is None else f"{rid_prefix}{i}"
            kw = dict(tags[i]) if tags is not None else {}
            while True:
                try:
                    out.append(rt.submit(src, max_new_tokens=budget,
                                         request_id=rid, **kw))
                    break
                except OverloadError:
                    rt.step()   # fleet backpressure: drain, then retry
        return out, rt.run_until_drained()

    def _drive_staggered(rt, drive_pairs, tags):
        """Noisy-neighbour drive for the tenants mix: tenant-b's batch
        flood is submitted first and stepped until it holds the decode
        slots, THEN tenant-a's latency streams arrive mid-flight — the
        arrival shape that exercises preemptive eviction (a latency
        head that cannot place evicts a running batch stream). A
        single up-front submit loop would let fair-share admission
        seat the latency heads first and nothing would ever need
        evicting. Returned rids stay in ``drive_pairs`` order so the
        parity baselines line up index-for-index."""
        out = [None] * len(drive_pairs)

        def _submit(i):
            src, budget = drive_pairs[i]
            while True:
                try:
                    out[i] = rt.submit(src, max_new_tokens=budget,
                                       **dict(tags[i]))
                    return
                except OverloadError:
                    rt.step()

        order = sorted(range(len(drive_pairs)),
                       key=lambda i: tags[i]["qos_class"] == "latency")
        n_flood = sum(1 for t in tags if t["qos_class"] != "latency")
        for pos, i in enumerate(order):
            if pos == n_flood:  # flood is in; let it start decoding
                for _ in range(2):
                    rt.step()
            _submit(i)
        return out, rt.run_until_drained()

    def _decode_p95(rt, rt_rids, rt_pairs):
        """Decode-phase p95 from the router ledger; under the
        adversarial mix, measured over the latency streams only (the
        adversaries' two-token decode is trivially short either way)."""
        vals = []
        for rid, (_, budget) in zip(rt_rids, rt_pairs):
            if trace_mix == "prefill-heavy" and budget != max_new_tokens:
                continue
            entry = rt.ledger.get(rid)
            d = None if entry is None else entry["phases"].get("decode_s")
            if d is not None:
                vals.append(d)
        return percentile(vals, 95)

    if disagg:
        specs = [(f"prefill-{i}", "prefill")
                 for i in range(prefill_replicas)] \
            + [(f"decode-{i}", "decode") for i in range(decode_replicas)]
    elif autoscale:
        # The autoscaled fleet starts at the floor; the controller grows
        # it toward max_replicas when the trace demands.
        specs = [(f"replica-{i}", "both") for i in range(min_replicas)]
    else:
        specs = [(f"replica-{i}", "both") for i in range(replicas)]
    members, warmup_tokens = _build_fleet(specs, fault_plan)
    if radix:
        # The per-replica warmup stream populated each radix tree with
        # pairs[0] — drop it so the timed run starts cold and every hit
        # the record reports came from routed traffic actually sharing.
        for rep in members:
            rep.engine.reset_radix_cache()

    # Per-replica radix counters at the start of the timed window: the
    # warmup stream's lookup (a miss on the fresh cache) must not skew
    # the record's hit rate, so everything below reads deltas.
    warm_radix: Dict[str, tuple] = {}

    def _radix_mark(rep):
        m = rep.engine.metrics
        warm_radix[rep.id] = (m.radix_hits, m.radix_misses,
                              m.radix_hit_tokens)

    for rep in members:
        _radix_mark(rep)
    if vclock is not None:
        router = Router(members, policy=policy, clock=_fleet_clock,
                        fault_plan=fault_plan)
    else:
        router = Router(members, policy=policy, fault_plan=fault_plan)
    # Every replica that ever served traffic, in spawn order — retired
    # replicas leave the router but keep their engines (and token
    # counters) for the per-replica accounting below.
    members_all = list(members)

    writers = []
    if trace_dir is not None:
        from ..metrics.jsonl import MetricsWriter
        from ..obs.sinks import JsonlSink

        # One shard per process-equivalent: warmup ran before the sinks
        # attach, so the shards hold only routed traffic.
        router_writer = MetricsWriter(
            os.path.join(trace_dir, "router.jsonl"),
            also_stdout=False, all_processes=True)
        writers.append(router_writer)
        router.trace_sink = JsonlSink(router_writer)
        rep_writers: Dict[str, MetricsWriter] = {}
        for rep in members:
            w = MetricsWriter(
                os.path.join(trace_dir, rep.id, "metrics.jsonl"),
                also_stdout=False, all_processes=True)
            writers.append(w)
            rep_writers[rep.id] = w
            rep.trace_sink = JsonlSink(w)

    degrade_ctrl = None
    if degrade:
        from ..obs.signals import SignalBus
        from .degrade import DegradeController

        deg_bus = SignalBus(names=[rep.id for rep in members])
        deg_sink = None
        if trace_dir is not None:
            degrade_writer = MetricsWriter(
                os.path.join(trace_dir, "degrade.jsonl"),
                also_stdout=False, all_processes=True)
            writers.append(degrade_writer)
            # degrade_event records carry their own (virtual) "ts",
            # which MetricsWriter preserves over its wall stamp.
            deg_sink = degrade_writer.write
        degrade_ctrl = DegradeController(router, deg_bus,
                                         policy=degrade_policy,
                                         clock=_fleet_clock,
                                         event_sink=deg_sink)
        _ctrl_tick = degrade_ctrl.tick

        def _deg_tick():
            # Router.step ticks the controller first thing; feed this
            # tick's LIVE queue depths beforehand so brownout decisions
            # track admission pressure, not an end-of-run snapshot.
            now2 = _fleet_clock()
            for rid2 in router.replica_ids():
                deg_bus.observe(
                    rid2,
                    {"serve_queue_depth":
                     router.replica(rid2).engine.queue.depth},
                    ts=now2)
            return _ctrl_tick()

        degrade_ctrl.tick = _deg_tick
        router.degrade = degrade_ctrl

    scaler = None
    report = None
    as_policy = None
    if autoscale:
        from ..obs.signals import SignalBus

        bus = SignalBus(names=[rep.id for rep in members])
        as_policy = AutoscalePolicy(min_replicas=min_replicas,
                                    max_replicas=max_replicas)

        def _spawn(phase, rid):
            built, w = _build_fleet([(rid, phase)], None)
            warmup_tokens.update(w)
            rep = built[0]
            _radix_mark(rep)
            members_all.append(rep)
            if trace_dir is not None:
                w2 = MetricsWriter(
                    os.path.join(trace_dir, rep.id, "metrics.jsonl"),
                    also_stdout=False, all_processes=True)
                writers.append(w2)
                rep_writers[rep.id] = w2
                rep.trace_sink = JsonlSink(w2)
            return rep

        event_sink = None
        if trace_dir is not None:
            autoscale_writer = MetricsWriter(
                os.path.join(trace_dir, "autoscale.jsonl"),
                also_stdout=False, all_processes=True)
            writers.append(autoscale_writer)
            # scale_event records carry their own (virtual) "ts", which
            # MetricsWriter preserves over its wall stamp.
            event_sink = autoscale_writer.write
        scaler = Autoscaler(router, bus, _spawn, policy=as_policy,
                            clock=vclock.read, event_sink=event_sink)

        def _on_tick(now):
            # Feed this tick's serve snapshots (live queue depth — the
            # step-time gauge lags admission), then let the controller
            # decide.
            for rid2 in router.replica_ids():
                rep2 = router.replica(rid2)
                rec = rep2.engine.metrics.snapshot()
                rec["serve_queue_depth"] = rep2.engine.queue.depth
                bus.observe(rep2.id, rec, ts=now)
            scaler.tick()
    else:
        _on_tick = None

    t0 = time.monotonic()
    if gen is not None:
        report = replay(gen, router, vclock, tick_s=tick_s,
                        on_tick=_on_tick)
        rids, ticks = report.rids, report.ticks
        if scaler is not None and scaler.draining:
            # A drain that began on the final tick still completes —
            # keep ticking the (idle) fleet through the grace window.
            for _ in range(as_policy.drain_grace_ticks + 1):
                if not scaler.draining:
                    break
                router.step()
                _on_tick(vclock.read())
                vclock.advance(tick_s)
    elif trace_mix == "tenants" and qos_tags is not None:
        rids, ticks = _drive_staggered(router, pairs, qos_tags)
    else:
        rids, ticks = _drive(router, pairs, tags=qos_tags)
    elapsed = time.monotonic() - t0

    results = [router.result(rid) for rid in rids]
    done = [r for r in results if r["state"] == "done"]
    # The contract number: every submitted logical request must reach
    # DONE — anything else (backlogged, cancelled, expired) is a drop.
    dropped = len(results) - len(done)
    lat = [r["latency_s"] for r in done if r["latency_s"] is not None]
    total_tokens = 0
    per_replica = []
    for rep in members_all:
        m = rep.engine.metrics
        toks = m.tokens_generated - warmup_tokens[rep.id]
        total_tokens += toks
        per_replica.append({
            "replica": rep.id,
            "phase": rep.phase,
            "state": rep.state.value,
            "routed": router.routed.get(rep.id, 0),
            "tokens": toks,
            "decode_steps": m.steps,
            "mean_slot_occupancy": round(m.mean_slot_occupancy or 0.0, 4),
        })

    # Per-request ledger aggregates (router._finalize ran for every
    # finished rid via result() above). The goodput contract: every
    # decoded token is either goodput (in a DONE result) or waste
    # (decoded on an attempt the router abandoned) — the two sum to the
    # fleet's total decoded tokens, exactly.
    e2e = [router.ledger[rid]["e2e_s"] for rid in rids
           if rid in router.ledger
           and router.ledger[rid]["e2e_s"] is not None]
    goodput = router.goodput_tokens
    # Preemption waste is engine-internal (the router never abandons the
    # stream), so it lives in the engines' ledgers, not the router's.
    deadline_wasted = sum(
        rep.engine.metrics.deadline_wasted_tokens for rep in members_all)
    wasted = router.wasted_tokens + deadline_wasted + sum(
        rep.engine.metrics.preempted_wasted_tokens for rep in members_all)
    # Radix-supplied tokens appear in results (so the router's goodput
    # and evacuation-waste ledgers count them) without ever being
    # decoded by an engine — the conservation identity gains them on
    # the decoded side. Zero when the cache is off.
    radix_hits_n = radix_lookups_n = radix_hit_tok = 0
    if radix:
        for rep in members_all:
            m = rep.engine.metrics
            h0, m0, t0_ = warm_radix.get(rep.id, (0, 0, 0))
            radix_hits_n += m.radix_hits - h0
            radix_lookups_n += (m.radix_hits - h0) + (m.radix_misses - m0)
            radix_hit_tok += m.radix_hit_tokens - t0_
    goodput_sum_ok = (goodput + wasted) == total_tokens + radix_hit_tok

    # Multi-tenant QoS aggregates — None unless some request was
    # tenant/class-tagged, so untagged records keep the pre-QoS shape.
    qos_p95_by_class = None
    preempt_total = replayed_total = token_loss_total = None
    fair_share_max = None
    if any(rep.engine.queue.qos_active for rep in members_all):
        by_cls: Dict[str, List[float]] = {}
        for rid in rids:
            entry = router.ledger.get(rid)
            if entry is None or "qos_class" not in entry:
                continue
            d = entry["phases"].get("decode_s")
            if d is not None:
                by_cls.setdefault(entry["qos_class"], []).append(d)
        qos_p95_by_class = {c: percentile(v, 95)
                            for c, v in sorted(by_cls.items())}
        preempt_total = replayed_total = token_loss_total = 0
        for rep in members_all:
            m = rep.engine.metrics
            preempt_total += m.preemptions
            replayed_total += m.preempted_tokens_replayed
            token_loss_total += m.qos_token_loss
            v = rep.engine.queue.fair_share_violation_max()
            if v is not None:
                fair_share_max = (v if fair_share_max is None
                                  else max(fair_share_max, v))

    if trace_dir is not None:
        from ..obs.signals import SignalBus

        bus = SignalBus(names=[rep.id for rep in members_all])
        for rep in members_all:
            rep.engine.metrics.emit(rep_writers[rep.id], replica=rep.id,
                                    phase=rep.phase)
            bus.observe(rep.id, rep.engine.metrics.snapshot())
        signals_writer = MetricsWriter(
            os.path.join(trace_dir, "signals.jsonl"),
            also_stdout=False, all_processes=True)
        writers.append(signals_writer)
        signals_writer.write(bus.snapshot())
        router.trace_sink = None
        for rep in members_all:
            rep.trace_sink = None
        for w in writers:
            w.close()

    token_identical = None
    if autoscale:
        # The autoscale parity contract: the SAME schedule replayed
        # through a FIXED fleet of max_replicas on a fresh virtual
        # clock. Greedy decode is deterministic and the router never
        # loses a request, so membership churn must not change a single
        # token.
        vclock2 = VirtualClock()
        _clock_ref[0] = vclock2
        f_members, _ = _build_fleet(
            [(f"fixed-{i}", "both") for i in range(max_replicas)], None)
        f_router = Router(f_members, policy=policy, clock=_fleet_clock)
        f_report = replay(gen, f_router, vclock2, tick_s=tick_s)
        f_results = [f_router.result(r) for r in f_report.rids]
        token_identical = ([r["tokens"] for r in results]
                           == [r["tokens"] for r in f_results])
        _clock_ref[0] = vclock
    elif smoke:
        baseline = _single_engine_tokens(
            model, pairs, slots, src_len, max_new_tokens,
            decode_window, kv_block_size=kv_block_size,
            speculate=speculate, speculate_device=speculate_device,
            kv_quant=kv_quant)
        fleet_tokens = [r["tokens"] for r in results]
        token_identical = fleet_tokens == baseline

    # Loadgen / autoscale derived fields (null when the feature is off —
    # root bench.py _finalize_green nulls them for unmeasured records).
    p95_during_burst = None
    time_to_scale_s = None
    scale_ups = scale_downs = 0
    if gen is not None:
        lo, hi = spec.hot_window()
        burst_e2e = [
            router.ledger[s.request_id]["e2e_s"] for s in gen.schedule
            if lo <= s.at_s < hi and s.request_id in router.ledger
            and router.ledger[s.request_id]["e2e_s"] is not None]
        p95_during_burst = percentile(burst_e2e, 95)
    if scaler is not None:
        scale_ups = sum(1 for ev in scaler.events
                        if ev["action"] == "scale_up")
        scale_downs = sum(1 for ev in scaler.events
                          if ev["action"] == "scale_down")
        first_up = next((ev["ts"] for ev in scaler.events
                         if ev["action"] == "scale_up"), None)
        if first_up is not None and gen.schedule:
            # Virtual seconds from the first arrival to the first
            # scale-up — the controller's reaction time.
            time_to_scale_s = round(first_up - gen.schedule[0].at_s, 6)

    record = {
        "metric": METRIC,
        "value": round(total_tokens / elapsed, 2) if elapsed > 0 else None,
        "unit": UNIT,
        "vs_baseline": None,
        "mfu": None,
        "measured": True,
        "replicas": len(members_all),
        "policy": router.policy.name,
        "dropped_requests": dropped,
        "evacuations": router.evacuations,
        "chaos_kill_step": chaos_kill_step,
        # -- site-addressable chaos / brownout (None when off) --------
        "chaos_plan": (chaos_plan if isinstance(chaos_plan, str)
                       else "inline" if chaos_plan is not None else None),
        "faults_injected":
            dict(sorted(fault_plan.fired_counts.items()))
            if fault_plan is not None else None,
        "degrade_transitions":
            degrade_ctrl.transitions if degrade_ctrl is not None
            else None,
        "degrade_events":
            list(degrade_ctrl.events) if degrade_ctrl is not None
            else None,
        "deadline_wasted_tokens":
            deadline_wasted if (fault_plan is not None or degrade)
            else None,
        "token_identical": token_identical,
        "p50_latency_s": percentile(lat, 50),
        "p95_latency_s": percentile(lat, 95),
        "e2e_latency_p50_s": percentile(e2e, 50),
        "e2e_latency_p95_s": percentile(e2e, 95),
        "goodput_tokens": goodput,
        "wasted_tokens": wasted,
        "goodput_tokens_per_sec":
            round(goodput / elapsed, 2) if elapsed > 0 else None,
        "goodput_sum_ok": goodput_sum_ok,
        "trace_dir": trace_dir,
        "requests": num_requests,
        "slots": slots,
        "max_new_tokens": max_new_tokens,
        "decode_window": decode_window,
        "fleet_ticks": ticks,
        "per_replica": per_replica,
        "smoke": smoke,
        "device": device_name(dev),
        "prefill_replicas": prefill_replicas,
        "decode_replicas": decode_replicas,
        "trace_mix": trace_mix,
        "qos_p95_by_class": qos_p95_by_class,
        "preemptions": preempt_total,
        "preempted_tokens_replayed": replayed_total,
        "qos_token_loss": token_loss_total,
        "fair_share_violation_max": fair_share_max,
        "spec_gamma": speculate,
        "speculate_device": speculate_device,
        "kv_quant": kv_quant,
        # -- radix token-prefix KV cache (None when the cache is off) --
        "radix": radix,
        "radix_hit_rate":
            round(radix_hits_n / radix_lookups_n, 4)
            if radix and radix_lookups_n else None,
        "radix_hit_tokens_per_request":
            round(radix_hit_tok / num_requests, 3)
            if radix and num_requests else None,
        "prefill_tokens_saved_ratio":
            round(radix_hit_tok / (radix_hit_tok + total_tokens), 4)
            if radix and (radix_hit_tok + total_tokens) else None,
        "radix_sweep": None,
        "radix_prefill_monotonic": None,
        "radix_hit_rate_prefix_affinity": None,
        "radix_hit_rate_round_robin": None,
        # -- chunked prefill (None when --prefill-chunk is off) --------
        "prefill_chunk": prefill_chunk if prefill_chunk > 0 else None,
        "token_identical_unchunked": None,
        "chunked_decode_p95": None,
        "unchunked_decode_p95": None,
        "chunk_ticks_per_prefill_p50": None,
        # -- open-loop replay / closed-loop autoscale -----------------
        "trace_spec": trace_spec,
        "autoscale": autoscale,
        "offered_load_rps":
            round(report.offered_load_rps, 3)
            if report is not None and report.offered_load_rps is not None
            else None,
        "loadgen_rejections":
            report.rejections if report is not None else None,
        "retry_after_honored":
            report.retries_honored if report is not None else None,
        "arrival_schedule":
            [[round(s.at_s, 6), len(s.src_ids), s.max_new_tokens]
             for s in gen.schedule] if gen is not None else None,
        "p95_during_burst": p95_during_burst,
        "scale_events": list(scaler.events) if scaler is not None
            else None,
        "scale_ups": scale_ups if scaler is not None else None,
        "scale_downs": scale_downs if scaler is not None else None,
        "time_to_scale_s": time_to_scale_s,
        "replicas_initial":
            min_replicas if autoscale else len(members),
        "replicas_final": len(router.replica_ids()),
        "min_replicas": min_replicas if autoscale else None,
        "max_replicas": max_replicas if autoscale else None,
    }

    if radix and trace_mix == "prefix-heavy" and not disagg \
            and trace_spec is None and chaos_kill_step == 0:
        # The cache-efficiency evidence, over the SAME warmed members
        # (fresh router + cold caches per run, so every number is a
        # clean per-run delta):
        #   1. the sharing sweep — fewer prompt groups means more
        #      requests repeat a source, and the nested prompt pool
        #      makes decoded-tokens-per-request monotone in the group
        #      count by construction (cold work is a sum over the first
        #      g pool entries);
        #   2. prefix_affinity vs round_robin on one trace — rendezvous
        #      steering keeps each group's repeats on one replica's
        #      cache, round-robin splits them, so the hit rate must
        #      separate.

        def _measured_drive(drive_pairs, drive_tags, pol, rid_prefix):
            for rep in members:
                rep.engine.reset_radix_cache()
            rt = Router(members, policy=pol)
            before = {}
            for rep in members:
                m = rep.engine.metrics
                before[rep.id] = (m.tokens_generated, m.radix_hits,
                                  m.radix_misses)
            rr, _ = _drive(rt, drive_pairs, rid_prefix=rid_prefix,
                           tags=drive_tags)
            for rid2 in rr:
                rt.result(rid2)
            dec = hits = lookups = 0
            for rep in members:
                m = rep.engine.metrics
                t0_, h0, m0 = before[rep.id]
                dec += m.tokens_generated - t0_
                hits += m.radix_hits - h0
                lookups += (m.radix_hits - h0) + (m.radix_misses - m0)
            return dec, hits, lookups

        sweep = []
        for g in (4, 2, 1):
            if g > num_requests:
                continue
            sp, st = _prefix_group_trace(num_requests, src_len, TINY_VOCAB,
                                         max_new_tokens, seed, groups=g,
                                         corpus=trace)
            dec, h, lk = _measured_drive(sp, st, "prefix_affinity",
                                         f"sw{g}-")
            sweep.append({
                "prefix_groups": g,
                "decoded_tokens_per_request": round(dec / num_requests, 3),
                "hit_rate": round(h / lk, 4) if lk else None,
            })
        dpr = [row["decoded_tokens_per_request"] for row in sweep]
        record["radix_sweep"] = sweep
        record["radix_prefill_monotonic"] = all(
            a >= b for a, b in zip(dpr, dpr[1:]))

        sp, st = _prefix_group_trace(num_requests, src_len, TINY_VOCAB,
                                     max_new_tokens, seed, groups=2,
                                     corpus=trace)
        _, h_aff, lk_aff = _measured_drive(sp, st, "prefix_affinity",
                                           "aff-")
        _, h_rr, lk_rr = _measured_drive(sp, st, "round_robin", "rr-")
        record["radix_hit_rate_prefix_affinity"] = (
            round(h_aff / lk_aff, 4) if lk_aff else None)
        record["radix_hit_rate_round_robin"] = (
            round(h_rr / lk_rr, 4) if lk_rr else None)

    if prefill_chunk > 0 and not disagg and trace_spec is None \
            and chaos_kill_step == 0:
        # The stall-free contract, co-located form: the SAME trace
        # through a fresh UNCHUNKED fleet of the same size, in the same
        # invocation. Token parity proves chunking changes nothing (the
        # completion tick re-runs the full-width prefill, so outputs
        # are bit-identical by construction); the decode-p95 pair
        # quantifies the admission stall the chunk quota removes —
        # visible under the prefill-heavy mix, where a long adversary
        # prompt otherwise monopolises the admission encode.
        un_specs = [(f"unchunked-{i}", "both")
                    for i in range(len(members))]
        un_members, _ = _build_fleet(un_specs, None, chunk=0)
        un_router = Router(un_members, policy=policy)
        un_rids, _ = _drive(un_router, pairs, tags=qos_tags)
        un_results = [un_router.result(rid) for rid in un_rids]
        record["token_identical_unchunked"] = (
            [r["tokens"] for r in results]
            == [r["tokens"] for r in un_results])
        record["chunked_decode_p95"] = _decode_p95(router, rids, pairs)
        record["unchunked_decode_p95"] = _decode_p95(
            un_router, un_rids, pairs)
        # How many chunk ticks each source encode took, from the
        # router's honest phase ledger (prefill_chunks accumulates
        # across preempt/resume attempts, so this is per-request truth,
        # not a per-engine histogram).
        ticks_per = [
            router.ledger[rid]["phases"]["prefill_chunks"]
            for rid in rids
            if rid in router.ledger
            and "prefill_chunks" in router.ledger[rid]["phases"]]
        record["chunk_ticks_per_prefill_p50"] = percentile(ticks_per, 50)
        if trace_mix == "prefill-heavy":
            # The no-adversary baseline: the SAME warmed chunked fleet,
            # fresh router, latency streams only. "chunked decode p95
            # flat vs this number" is the pinned stall-free contract —
            # the co-located analogue of the disagg block below.
            streams = [p for p in pairs if p[1] == max_new_tokens]
            base_router = Router(members, policy=policy)
            base_rids, _ = _drive(base_router, streams,
                                  rid_prefix="noadv-")
            for rid in base_rids:
                base_router.result(rid)
            record["decode_p95_no_adversary"] = _decode_p95(
                base_router, base_rids, streams)

    if disagg:
        # The contract run: the SAME trace through a co-located paged
        # fleet of the same size, in the same invocation. Token parity
        # proves the handoff changes nothing; the decode-p95 pair
        # quantifies what disaggregation removes (prefill-induced
        # decode stall — visible under the prefill-heavy mix).
        co_specs = [(f"colocated-{i}", "both")
                    for i in range(prefill_replicas + decode_replicas)]
        co_members, _ = _build_fleet(co_specs, None)
        co_router = Router(co_members, policy=policy)
        co_rids, _ = _drive(co_router, pairs)
        co_results = [co_router.result(rid) for rid in co_rids]
        record["token_identical_colocated"] = (
            [r["tokens"] for r in results]
            == [r["tokens"] for r in co_results])
        record["decode_p95_disagg"] = _decode_p95(router, rids, pairs)
        record["decode_p95_colocated"] = _decode_p95(co_router, co_rids,
                                                     pairs)
        if trace_mix == "prefill-heavy":
            # The no-adversary baseline: the SAME warmed disagg fleet,
            # fresh router, latency streams only. "Flat vs this number"
            # is the in-process form of the contract — one process
            # steps every phase in turn, so wall-clock decode_s charges
            # each stream for the whole tick and the co-located
            # comparison understates what separate hosts would show.
            streams = [p for p in pairs if p[1] == max_new_tokens]
            base_router = Router(members, policy=policy)
            base_rids, _ = _drive(base_router, streams,
                                  rid_prefix="noadv-")
            for rid in base_rids:
                base_router.result(rid)
            record["decode_p95_no_adversary"] = _decode_p95(
                base_router, base_rids, streams)
        record["handoffs"] = router.handoffs
        record["handoff_latency_p50_s"] = percentile(
            router.handoff_latencies, 50)
        record["handoff_latency_p95_s"] = percentile(
            router.handoff_latencies, 95)
        record["handoff_bytes"] = (
            round(router.handoff_bytes_total / router.handoffs)
            if router.handoffs else None)

    if trace_mix == "tenants" and not disagg:
        # The QoS contract baseline: the SAME latency-class traffic
        # with tenant-b's batch flood removed, through a fresh router
        # over the same warmed members. "tenant-a's decode p95 flat vs
        # this number" is the pinned contract — DRR admission plus
        # preemptive eviction must hold the latency class at its
        # uncontended bound while batch absorbs the slack.
        if gen is not None:
            import dataclasses

            # Fresh request ids: the warmed engines' queues still hold
            # the main run's finished entries under the lg-* ids.
            lat_sched = tuple(
                dataclasses.replace(s, request_id=f"noadv-{s.index:04d}")
                for s in gen.schedule if s.qos_class == "latency")

            class _LatencyOnly:
                schedule = lat_sched
                spec = gen.spec

            vclock3 = VirtualClock()
            _clock_ref[0] = vclock3
            base_router = Router(members, policy=policy,
                                 clock=_fleet_clock)
            base_report = replay(_LatencyOnly, base_router, vclock3,
                                 tick_s=tick_s)
            base_rids = base_report.rids
            _clock_ref[0] = vclock
        else:
            streams = [p for p, t in zip(pairs, qos_tags)
                       if t["qos_class"] == "latency"]
            stream_tags = [t for t in qos_tags
                           if t["qos_class"] == "latency"]
            base_router = Router(members, policy=policy)
            base_rids, _ = _drive(base_router, streams,
                                  rid_prefix="noadv-", tags=stream_tags)
        vals = []
        for rid in base_rids:
            base_router.result(rid)
            entry = base_router.ledger.get(rid)
            d = None if entry is None else entry["phases"].get("decode_s")
            if d is not None:
                vals.append(d)
        record["qos_decode_p95_no_adversary"] = percentile(vals, 95)

    return record
