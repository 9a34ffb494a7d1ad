"""The fleet bench over processes: replicas are processes, wires are sockets.

The port of the JAX package's ``net/bench.py``. Everything the in-process
fleet bench measured on one thread and one clock is re-measured here with
actual process parallelism:

- ``net_decode_p95_colocated`` / ``net_decode_p95_disagg`` — wall-clock
  honest: prefill and decode really overlap across processes, and the KV
  artifact really crosses a socket.
- ``net_stream_ttfb_p50/p95`` — time-to-first-byte observed CLIENT-side
  through the async front door (wire + queue + routing + replica RTT).
- ``autoscale_time_to_scale_s`` — burst arrives, the fleet overloads,
  ``SupervisedSpawner`` forks a new replica server, and the clock runs
  until that replica is connected and routable. Real seconds: process
  spawn + torch import + model build + warmup + socket accept.

Each child is ``python -m deeplearning_cfn_tpu_torch.net.server`` on the
device ``accelerator`` names, passed as its ``--accelerator`` (the JAX
child pins ``JAX_PLATFORMS`` instead). ``fleet up --net`` builds its
:class:`~..fleet.autoscale.SupervisedSpawner` specs from
:func:`make_server_spec` too.

Honesty rules carried over from the in-process bench: parity against
the same seeded trace (greedy decode on bit-identical weights — every
server and the in-process reference draw the weights from a generator
seeded with ``seed`` on the same kind of device), zero dropped requests
as a hard assertion, and every unmeasured record field is ``None``,
never 0.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional, Tuple

from .client import RemoteReplica
from .router import NetRouter
from ..fleet.replica import ReplicaProcSpec, ReplicaSupervisor
from ..fleet.router import FleetOverloadError, NoReplicasError
from ..serve.queue import OverloadError

METRIC = "net_fleet_tiny_nmt_tokens_per_sec"
UNIT = "tokens/sec"

#: Record fields that must be null (never 0) when unmeasured — root
#: bench.py's ``_finalize_green`` nulls these on red/unmeasured runs.
NULLABLE_FIELDS = ("net_decode_p95_disagg", "net_decode_p95_colocated",
                   "autoscale_time_to_scale_s", "net_stream_ttfb_p50",
                   "net_stream_ttfb_p95")


def _percentile(values, pct: float) -> Optional[float]:
    vals = sorted(v for v in values if v is not None)
    if not vals:
        return None
    k = max(0, min(len(vals) - 1, int(round((pct / 100.0) * (len(vals) - 1)))))
    return float(vals[k])


def _child_env() -> Dict[str, str]:
    """The replica child's extra environment: the obs switch, when the
    parent has it set (the device is an argument, not the environment)."""
    env = {}
    if os.environ.get("DLCFN_OBS_OFF"):
        env["DLCFN_OBS_OFF"] = os.environ["DLCFN_OBS_OFF"]
    return env


def make_server_spec(replica_id: str, run_dir: str, phase: str = "both",
                     slots: int = 2, src_len: int = 8,
                     max_new_tokens: int = 4, queue_depth: int = 16,
                     decode_window: int = 4, kv_block_size: int = 0,
                     seed: int = 0, warmup_src=(),
                     trace: bool = False, accelerator: str = "gpu"
                     ) -> Tuple[ReplicaProcSpec, str]:
    """Build the (spec, address) pair for one replica server child.
    Unix socket in the replica's run dir: zero port arithmetic, and a
    supervisor-restarted child reclaims the same address."""
    address = f"unix://{os.path.join(run_dir, 'replica.sock')}"
    argv = [sys.executable, "-m", "deeplearning_cfn_tpu_torch.net.server",
            "--listen", address,
            "--replica-id", replica_id,
            "--slots", str(slots),
            "--src-len", str(src_len),
            "--max-new-tokens", str(max_new_tokens),
            "--queue-depth", str(queue_depth),
            "--decode-window", str(decode_window),
            "--kv-block-size", str(kv_block_size),
            "--phase", phase,
            "--seed", str(seed),
            "--accelerator", accelerator]
    if warmup_src:
        argv += ["--warmup-src", ",".join(str(int(t)) for t in warmup_src)]
    if trace:
        argv += ["--run-dir", run_dir]
    return ReplicaProcSpec(replica_id, argv, run_dir,
                           env=_child_env()), address


def spawn_process_fleet(run_root: str, phases: List[str],
                        connect_deadline_s: float = 180.0,
                        max_restarts: int = 1, trace: bool = False,
                        **engine_kwargs
                        ) -> Tuple[ReplicaSupervisor, List[RemoteReplica]]:
    """Spawn one server process per phase entry and connect to all.
    Children build + warm in PARALLEL; connect order doesn't matter
    because the first successful connect per child is its readiness
    barrier."""
    specs, addrs = [], []
    for i, phase in enumerate(phases):
        rid = f"r{i}"
        run_dir = os.path.join(run_root, rid)
        os.makedirs(run_dir, exist_ok=True)
        spec, addr = make_server_spec(rid, run_dir, phase=phase,
                                      trace=trace, **engine_kwargs)
        specs.append(spec)
        addrs.append((rid, addr, phase))
    sup = ReplicaSupervisor(specs, max_restarts=max_restarts)
    sup.start()
    replicas = []
    try:
        for rid, addr, phase in addrs:
            replicas.append(RemoteReplica(
                rid, addr, phase=phase,
                connect_retry_deadline_s=connect_deadline_s).connect())
    except BaseException:
        for r in replicas:
            r.close()
        sup.terminate()
        raise
    return sup, replicas


def _submit_all(router, trace, max_new_tokens: int, beam_size: int,
                sup=None) -> List[str]:
    """Submit the whole seeded trace with the fleet-bench retry loop:
    overload → tick the fleet (draining queues) → retry."""
    rids = []
    for i, src in enumerate(trace):
        while True:
            try:
                rids.append(router.submit(
                    src, max_new_tokens=max_new_tokens,
                    beam_size=beam_size, request_id=f"q{i}"))
                break
            except (FleetOverloadError, OverloadError, NoReplicasError):
                if sup is not None:
                    sup.poll()
                router.step()
                time.sleep(0.01)
    return rids


def _decode_p95(router, rids) -> Optional[float]:
    vals = []
    for rid in rids:
        entry = router.ledger.get(rid)
        if entry is None:
            continue
        decode = (entry.get("phases") or {}).get("decode_s")
        if decode is not None:
            vals.append(decode)
    return _percentile(vals, 95)


def _reference_tokens(trace, max_new_tokens: int, beam_size: int,
                      slots: int, src_len: int, queue_depth: int,
                      decode_window: int, seed: int,
                      accelerator: str = "gpu") -> Dict[str, List[int]]:
    """In-process fleet on the SAME seeded trace — the parity baseline.
    The engine the server children build (``net.server
    .tiny_recipe_engine``: same geometry, same seeded generator, same
    kind of device), run through the plain in-process Router."""
    from ..fleet.replica import EngineReplica
    from ..fleet.router import Router
    from .server import tiny_recipe_engine

    def _engine():
        return tiny_recipe_engine(
            slots=slots, src_len=src_len, max_new_tokens=max_new_tokens,
            queue_depth=queue_depth, decode_window=decode_window,
            seed=seed, device=accelerator)

    replicas = [EngineReplica(f"ref{i}", _engine()) for i in range(2)]
    rt = Router(replicas)
    rids = _submit_all(rt, trace, max_new_tokens, beam_size)
    rt.run_until_drained()
    return {rid: list(rt.result(rid)["tokens"]) for rid in rids}


def _tokens_identical(router, rids, expected: Dict[str, List[int]]) -> bool:
    for rid in rids:
        if list(router.result(rid)["tokens"]) != expected.get(rid):
            return False
    return True


def run_net_fleet_bench(run_root: str, smoke: bool = True,
                        replicas: int = 2, num_requests: int = 6,
                        slots: int = 2, max_new_tokens: int = 4,
                        src_len: int = 8, queue_depth: int = 16,
                        decode_window: int = 4, beam_size: int = 1,
                        policy: str = "least_loaded",
                        disagg: bool = True, chaos_kill: bool = False,
                        autoscale: bool = False, seed: int = 0,
                        trace_dir: str = "",
                        idle_timeout_s: float = 60.0,
                        accelerator: str = "gpu") -> Dict:
    """The ``bench --fleet --net`` record, every child and the reference
    on the device ``accelerator`` names (``gpu``, the default, raises
    without a card). Phases:

    1. in-process reference run (parity baseline),
    2. co-located process fleet driven through the async front door
       (→ throughput, ``net_decode_p95_colocated``, client-side TTFB,
       optional mid-stream SIGKILL),
    3. disaggregated process fleet, KV bytes over sockets
       (→ ``net_decode_p95_disagg``),
    4. optional burst autoscale (→ ``autoscale_time_to_scale_s``).
    """
    from ..runtime.platform import resolve_device
    from ..serve.bench import TINY_VOCAB, _fixed_trace, device_name

    dev = resolve_device(accelerator)
    if smoke:
        replicas = 2
        num_requests = min(num_requests, 6)
        slots = min(slots, 2)
        max_new_tokens = min(max_new_tokens, 4)
        src_len = min(src_len, 8)
    trace = _fixed_trace(num_requests, src_len, TINY_VOCAB, seed=seed)
    engine_kwargs = dict(slots=slots, src_len=src_len,
                         max_new_tokens=max_new_tokens,
                         queue_depth=queue_depth,
                         decode_window=decode_window, seed=seed,
                         warmup_src=trace[0], accelerator=accelerator)
    expected = _reference_tokens(trace, max_new_tokens, beam_size, slots,
                                 src_len, queue_depth, decode_window, seed,
                                 accelerator)

    record: Dict = {
        "metric": METRIC, "value": None, "unit": UNIT,
        "vs_baseline": None, "mfu": None, "measured": True,
        "net": True, "transport": "unix", "smoke": bool(smoke),
        "replicas": replicas, "policy": policy,
        "requests": num_requests, "slots": slots,
        "max_new_tokens": max_new_tokens, "src_len": src_len,
        "decode_window": decode_window, "beam_size": beam_size,
        "dropped_requests": 0, "evacuations": 0, "reconnects": 0,
        "chaos_kills": 0, "token_identical": None,
        "token_identical_disagg": None,
        "handoffs": None, "handoff_bytes": None,
        "handoff_latency_p50_s": None, "handoff_latency_p95_s": None,
        "trace_dir": trace_dir or None, "flow_events": None,
    }
    for field in NULLABLE_FIELDS:
        record[field] = None

    # -- phase 2: co-located fleet behind the front door ---------------------
    colo_root = os.path.join(run_root, "colocated")
    sup, remotes = spawn_process_fleet(
        colo_root, ["both"] * replicas, trace=bool(trace_dir),
        **engine_kwargs)
    try:
        record.update(_run_colocated(
            sup, remotes, trace, expected, record, colo_root,
            max_new_tokens=max_new_tokens, beam_size=beam_size,
            policy=policy, chaos_kill=chaos_kill, trace_dir=trace_dir,
            idle_timeout_s=idle_timeout_s))
    finally:
        _teardown(sup, remotes)

    # -- phase 3: disaggregated fleet, KV bytes over sockets -----------------
    if disagg:
        disagg_root = os.path.join(run_root, "disagg")
        dk = dict(engine_kwargs)
        dk["kv_block_size"] = 4
        sup, remotes = spawn_process_fleet(
            disagg_root, ["prefill"] + ["decode"] * (replicas - 1), **dk)
        try:
            rt = NetRouter(remotes, supervisor=sup, policy=policy)
            rids = _submit_all(rt, trace, max_new_tokens, beam_size, sup)
            rt.run_until_drained(idle_timeout_s=idle_timeout_s)
            record["dropped_requests"] += rt.dropped_requests
            record["token_identical_disagg"] = \
                _tokens_identical(rt, rids, expected)
            record["net_decode_p95_disagg"] = _decode_p95(rt, rids)
            record["handoffs"] = rt.handoffs
            record["handoff_bytes"] = rt.handoff_bytes_total or None
            record["handoff_latency_p50_s"] = \
                _percentile(rt.handoff_latencies, 50)
            record["handoff_latency_p95_s"] = \
                _percentile(rt.handoff_latencies, 95)
        finally:
            _teardown(sup, remotes)

    # -- phase 4: burst autoscale (real wall-clock time-to-scale) ------------
    if autoscale:
        record["autoscale_time_to_scale_s"] = _run_autoscale(
            os.path.join(run_root, "autoscale"), trace, record,
            max_new_tokens=max_new_tokens, beam_size=beam_size,
            policy=policy, idle_timeout_s=idle_timeout_s,
            engine_kwargs=engine_kwargs)

    if trace_dir:
        from ..obs.export import export_fleet_trace
        os.makedirs(trace_dir, exist_ok=True)
        summary = export_fleet_trace(
            colo_root, os.path.join(trace_dir, "net_fleet_trace.json"))
        record["flow_events"] = summary.get("flow_events")
        record["trace_dir"] = trace_dir

    record["device"] = device_name(dev)
    return record


def _run_colocated(sup, remotes, trace, expected, record, run_root,
                   max_new_tokens: int, beam_size: int, policy: str,
                   chaos_kill: bool, trace_dir: str,
                   idle_timeout_s: float) -> Dict:
    from .frontdoor import FrontDoor, FrontDoorClient
    from ..metrics.jsonl import MetricsWriter
    from ..obs.sinks import JsonlSink

    rt = NetRouter(remotes, supervisor=sup, policy=policy)
    router_writer = None
    if trace_dir:
        # Parent-side shard: fleet.request spans land in router.jsonl
        # at the run root; each child's serve.request spans land in its
        # own <rid>/metrics.jsonl — the merged Perfetto export links
        # them by trace_id ACROSS pids.
        router_writer = MetricsWriter(
            os.path.join(run_root, "router.jsonl"), also_stdout=False)
        rt.trace_sink = JsonlSink(router_writer)
        for r in remotes:
            client_writer = MetricsWriter(
                os.path.join(run_root, r.id, "client.jsonl"),
                also_stdout=False)
            r.trace_sink = JsonlSink(client_writer)

    fd = FrontDoor(rt, f"unix://{os.path.join(run_root, 'frontdoor.sock')}")
    out: Dict = {}
    killed = 0
    t0 = time.monotonic()
    try:
        fd.start()
        client = FrontDoorClient(fd.address)
        try:
            logicals = []
            for i, src in enumerate(trace):
                while True:
                    try:
                        logicals.append(client.submit(
                            src, max_new_tokens=max_new_tokens,
                            beam_size=beam_size, request_id=f"q{i}"))
                        break
                    except (FleetOverloadError, OverloadError,
                            NoReplicasError) as e:
                        time.sleep(min(getattr(e, "retry_after_s", None)
                                       or 0.02, 0.2))
            if chaos_kill and len(remotes) > 1:
                # SIGKILL a replica process mid-stream: the dead socket
                # marks it DOWN, the router evacuates, the supervisor
                # restarts it, and the zero-drop contract still holds.
                client.wait(logicals[:1], timeout_s=60.0)
                sup._replicas[1].handle._procs[0].proc.kill()
                killed = 1
            results = client.wait(logicals, timeout_s=300.0)
            wall = max(time.monotonic() - t0, 1e-9)
            goodput = sum(len((r or {}).get("tokens") or ())
                          for r in results.values())
            unfinished = [l for l, r in results.items()
                          if r is None or r.get("state") != "done"]
            stats = fd.call(lambda router: router.stats())
            ledger = fd.call(lambda router: {
                rid: dict(router.ledger.get(rid) or {})
                for rid in logicals})
            tokens = fd.call(lambda router: {
                rid: list(router.result(rid)["tokens"])
                for rid in logicals})
            out["value"] = goodput / wall
            out["net_decode_p95_colocated"] = _percentile(
                [(e.get("phases") or {}).get("decode_s")
                 for e in ledger.values()], 95)
            ttfbs = [client.ttfb_s.get(l) for l in logicals]
            out["net_stream_ttfb_p50"] = _percentile(ttfbs, 50)
            out["net_stream_ttfb_p95"] = _percentile(ttfbs, 95)
            out["token_identical"] = all(
                tokens.get(rid) == expected.get(rid) for rid in logicals)
            out["dropped_requests"] = record["dropped_requests"] \
                + stats["dropped_requests"] + len(unfinished)
            out["evacuations"] = stats["evacuations"]
            out["reconnects"] = fd.call(
                lambda router: getattr(router, "reconnects", 0))
            out["chaos_kills"] = killed
            out["goodput_tokens"] = goodput
        finally:
            client.close()
    finally:
        fd.stop()
        if router_writer is not None:
            router_writer.close()
    return out


def _run_autoscale(run_root: str, trace, record, max_new_tokens: int,
                   beam_size: int, policy: str, idle_timeout_s: float,
                   engine_kwargs: Dict) -> Optional[float]:
    """Start ONE replica, submit the burst until it overloads, then
    spawn a second through SupervisedSpawner and measure wall-clock
    burst-start → new-replica-routable. This is the number the
    in-process autoscaler could only simulate: it includes process
    fork, torch import, model build, warmup, and the socket accept."""
    from ..fleet.autoscale import SupervisedSpawner

    os.makedirs(run_root, exist_ok=True)
    # The burst must actually overload one replica or there is nothing
    # to scale from: tight queue (2 slots + 2 queued → the 5th
    # concurrent submit trips FleetOverloadError), a 4x-repeated trace,
    # and a heavier decode budget so the single replica cannot simply
    # outrun the submission loop.
    burst_tokens = max(int(max_new_tokens) * 4, 16)
    # decode_window=1: the server answers RPCs once per engine-step
    # loop, so each routed submit (health + submit RPC) lets it advance
    # ~2 steps. At window 4 a 16-token request drains in 4 steps — one
    # request per submit, the queue never fills. At window 1 it takes
    # 16 steps, the burst genuinely outruns the replica.
    engine_kwargs = dict(engine_kwargs, queue_depth=2,
                         max_new_tokens=burst_tokens, decode_window=1)
    burst = [src for _ in range(4) for src in trace]
    sup, remotes = spawn_process_fleet(run_root, ["both"],
                                       **engine_kwargs)
    spawner = None
    extra: List[RemoteReplica] = []
    try:
        rt = NetRouter(remotes, supervisor=sup, policy=policy)

        def spec_factory(phase, replica_id):
            run_dir = os.path.join(run_root, replica_id)
            os.makedirs(run_dir, exist_ok=True)
            spec, _ = make_server_spec(
                replica_id, run_dir, phase=phase, **engine_kwargs)
            return spec

        def replica_factory(phase, replica_id):
            sock = os.path.join(run_root, replica_id, "replica.sock")
            addr = f"unix://{sock}"
            return RemoteReplica(replica_id, addr, phase=phase,
                                 connect_retry_deadline_s=180.0)

        spawner = SupervisedSpawner(spec_factory, replica_factory)
        burst_t0 = time.monotonic()
        time_to_scale = None
        rids = []
        for i, src in enumerate(burst):
            while True:
                try:
                    rids.append(rt.submit(
                        src, max_new_tokens=burst_tokens,
                        beam_size=beam_size, request_id=f"b{i}"))
                    break
                except (FleetOverloadError, OverloadError):
                    if time_to_scale is None:
                        # First overload under the burst: scale out.
                        new = spawner.spawn("both", "r-scale")
                        new.connect()   # blocks until built + warm
                        rt.add(new)
                        extra.append(new)
                        time_to_scale = time.monotonic() - burst_t0
                    rt.step()
                    time.sleep(0.01)
                except NoReplicasError:
                    rt.step()
                    time.sleep(0.01)
        rt.run_until_drained(idle_timeout_s=idle_timeout_s)
        record["dropped_requests"] += rt.dropped_requests
        record["replicas_initial"] = 1
        record["replicas_final"] = 1 + len(extra)
        return time_to_scale
    finally:
        for r in extra:
            r.close()
        if spawner is not None:
            spawner.close()
        _teardown(sup, remotes)


def _teardown(sup, remotes) -> None:
    for r in remotes:
        try:
            r.drain()
        except Exception:
            pass
        r.close()
    try:
        sup.wait(timeout_s=10.0)
    except Exception:
        pass
    sup.terminate()
    sup.close()
