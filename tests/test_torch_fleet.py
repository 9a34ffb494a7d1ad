"""The port's fleet (deeplearning_cfn_tpu_torch.fleet) and ``fleet`` CLI verbs
against the JAX package's, on the CPU in f32.

The router runs over the same scripted fake replicas and fault plans in
both packages, as cases of one parametrised test (policies under membership
churn, the circuit breaker, crash failover, backlog retry pacing, forced
evacuation, brownout steps): every routing decision, result and ledger
entry, and ``stats()``, must be equal. Then fleets of real tiny engines
(weights carried across by ``convert.py``): the disaggregated hop (tokens,
handoff count and bytes), a rolling upgrade in mid-stream, and a chaos kill
of the decode replica. Then the CLI: ``fleet route`` and ``fleet up
--prefill 1 --decode 1`` print JAX's result lines, ``fleet status`` reads
the run root, and ``fleet up`` names the port's module in its children's
argv. Tolerance: token-identical; counts exact.
"""

import importlib
import json
import os
import types

import numpy as np
import pytest
import torch
from flax import traverse_util

from deeplearning_cfn_tpu.ckpt.checkpoint import save_checkpoint
from deeplearning_cfn_tpu.models.transformer_nmt import (
    transformer_nmt_tiny as jax_tiny)
from deeplearning_cfn_tpu.serve.engine import Engine as JaxEngine
from deeplearning_cfn_tpu_torch.convert import params_from_flax
from deeplearning_cfn_tpu_torch.models.transformer_nmt import (
    transformer_nmt_tiny as torch_tiny)
from deeplearning_cfn_tpu_torch.serve.engine import Engine
from torch_tiny_nmt import tiny_nmt_params

PACKAGES = {"jax": "deeplearning_cfn_tpu", "port": "deeplearning_cfn_tpu_torch"}
VOCAB, SRC, MAX_LEN, MAX_NEW = 96, 8, 64, 5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One worker's share of the cores (torch would start a thread per core
    in every pytest-xdist worker)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def _pkg(name):
    base = PACKAGES[name]
    mod = lambda m: importlib.import_module(f"{base}.{m}")
    return types.SimpleNamespace(
        fleet=mod("fleet"), faults=mod("runtime.faults"),
        queue=mod("serve.queue"), degrade=mod("fleet.degrade"),
        signals=mod("obs.signals"), store=mod("ckpt.store"))


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# -- fakes (tests/test_fleet.py's, over either package's queue types) ------


def _fake_engine_cls(q):
    class FakeQueue:
        def __init__(self, max_depth):
            self.max_depth = max_depth
            self.items = []

        @property
        def depth(self):
            return len(self.items)

    class FakeMetrics:
        def __init__(self):
            self.step_latency_s = []
            self.tokens_generated = 0
            self.last_retry_after_s = None

    class FakeEngine:
        """Bounded queue, ``capacity`` slots, every admitted request ends
        after ``work`` steps; ``fail_on`` lists the step calls (1-based)
        that raise."""

        def __init__(self, capacity=2, queue_depth=8, retry_after=None,
                     work=1, fail_on=()):
            self.capacity = capacity
            self.queue = FakeQueue(queue_depth)
            self.metrics = FakeMetrics()
            self.retry_after = retry_after
            self.work = work
            self.fail_on = set(fail_on)
            self.step_calls = 0
            self.variables = "v0"
            self._running = {}
            self._by_id = {}

        @property
        def active_requests(self):
            return len(self._running)

        def submit(self, src_ids, max_new_tokens=None, beam_size=1,
                   deadline_s=None, request_id=None, trace_id=None):
            if self.queue.depth >= self.queue.max_depth:
                raise q.OverloadError(self.queue.depth,
                                      self.queue.max_depth,
                                      retry_after_s=self.retry_after)
            rid = request_id if request_id is not None \
                else f"fake-{len(self._by_id)}"
            req = q.Request(id=rid, src_ids=list(src_ids),
                            max_new_tokens=max_new_tokens or 4,
                            beam_size=beam_size, trace_id=trace_id)
            self.queue.items.append(req)
            self._by_id[rid] = req
            return req

        def poll(self, request_id):
            if request_id not in self._by_id:
                raise KeyError(request_id)
            return self._by_id[request_id]

        def cancel(self, request_id):
            req = self.poll(request_id)
            if req.finished:
                return False
            req.state = q.RequestState.CANCELLED
            if req in self.queue.items:
                self.queue.items.remove(req)
            self._running.pop(req.id, None)
            return True

        def step(self):
            self.step_calls += 1
            if self.step_calls in self.fail_on:
                raise RuntimeError(f"scripted failure {self.step_calls}")
            while self.queue.items and len(self._running) < self.capacity:
                req = self.queue.items.pop(0)
                if req.finished:
                    continue
                req.state = q.RequestState.RUNNING
                self._running[req.id] = self.work
            decoded = 0
            for rid in list(self._running):
                req = self._by_id[rid]
                self._running[rid] -= 1
                req.tokens.append(1)
                decoded += 1
                self.metrics.tokens_generated += 1
                if self._running[rid] <= 0:
                    req.state = q.RequestState.DONE
                    req.finished_at = 0.0
                    del self._running[rid]
            return decoded

        def run_until_drained(self, max_steps=1_000_000, **_):
            steps = 0
            while (self.queue.items or self._running) and steps < max_steps:
                self.step()
                steps += 1
            return steps

        def swap_variables(self, variables):
            if self.queue.items or self._running:
                raise RuntimeError("swap_variables requires an idle engine")
            self.variables = variables

    return FakeEngine


def _rig(p):
    fake = _fake_engine_cls(p.queue)

    def replica(rid, fault_plan=None, **kw):
        return p.fleet.EngineReplica(rid, fake(**kw), fault_plan=fault_plan)

    return replica


def _where(router, rids):
    return [router._requests[r].replica_id for r in rids]


def _outcome(router, rids):
    return {"results": [{k: router.result(r)[k]
                         for k in ("id", "state", "tokens", "replica")}
                        for r in rids],
            "ledger": router.ledger, "stats": router.stats()}


def _churn(p, policy):
    replica = _rig(p)
    reps = {f"replica-{i}": replica(f"replica-{i}", capacity=8,
                                    queue_depth=64) for i in range(3)}
    router = p.fleet.Router([reps["replica-0"], reps["replica-1"]],
                            policy=policy, clock=Clock())
    log, rids = [], []

    def place(n):
        new = [router.submit([5, 4, 3]) for _ in range(n)]
        rids.extend(new)
        log.append(_where(router, new))

    place(3)
    router.add(reps["replica-2"])
    place(3)
    router.remove("replica-2")           # evacuates its queued copies
    log.append(_where(router, rids))
    router.run_until_drained()
    router.remove("replica-1")
    place(3)
    router.run_until_drained()
    router.add(replica("replica-1", capacity=8, queue_depth=64))
    place(4)
    router.run_until_drained()
    return log, _outcome(router, rids)


def _breaker(p):
    replica = _rig(p)
    bad = replica("replica-0", fail_on=(1, 2))
    router = p.fleet.Router([bad, replica("replica-1")],
                            policy="round_robin", breaker_threshold=2,
                            clock=Clock())
    rids = [router.submit([5, 4, 3])]
    log = [_where(router, rids)]
    for _ in range(2):
        router.step()
        log.append((bad.state.value, _where(router, rids)))
    router.run_until_drained()
    router.readmit("replica-0")
    log.append((bad.state.value, bad.routable))
    rids.append(router.submit([6, 5, 4]))
    router.run_until_drained()
    return log, _outcome(router, rids)


def _crash_failover(p):
    replica = _rig(p)
    plan = p.faults.FaultPlan([p.faults.FaultSpec(
        op="step", key="replica-0", kind="crash", at_calls=(0,))])
    victim = replica("replica-0", fault_plan=plan)
    router = p.fleet.Router([victim, replica("replica-1", work=2)],
                            policy="round_robin", clock=Clock())
    rids = [router.submit([5, 4, 3]), router.submit([6, 5, 4]),
            router.submit([7, 6, 5])]
    log = [_where(router, rids)]
    router.run_until_drained()
    log.append((victim.state.value, victim.crashed, router.evacuations,
                _where(router, rids)))
    return log, _outcome(router, rids)


def _backlog_retry(p):
    replica = _rig(p)
    clock = Clock()
    plan = p.faults.FaultPlan([p.faults.FaultSpec(
        op="step", key="replica-0", kind="crash", at_calls=(0,))])
    router = p.fleet.Router([replica("replica-0", fault_plan=plan)],
                            clock=clock)
    rid = router.submit([5, 4, 3])
    router.step()                        # crash: nowhere to go, backlog
    log = [router.result(rid)["state"]]
    for dt in (0.0, 0.013, 0.013, 0.5, 10.0, 0.013, 10.0):
        clock.advance(dt)
        router.step()
        log.append(router.stats()["router_backlog_retries"])
    router.add(replica("replica-1"))
    clock.advance(10.0)
    router.run_until_drained()
    return log, _outcome(router, [rid])


def _forced_evacuation(p):
    replica = _rig(p)
    router = p.fleet.Router([replica("replica-0", work=5),
                             replica("replica-1", work=5)],
                            policy="round_robin", clock=Clock())
    rid = router.submit([5, 4, 3], max_new_tokens=5)
    router.step()                        # one token decoded on replica-0
    router.drain("replica-0")
    router.evacuate("replica-0")
    req = router.poll(rid)
    log = [req.id, req.trace_id]
    router.run_until_drained()
    return log, _outcome(router, [rid])


def _brownout(p):
    replica = _rig(p)
    reps = [replica(f"replica-{i}", queue_depth=64) for i in range(2)]
    router = p.fleet.Router(reps, policy="round_robin", clock=Clock())
    bus = p.signals.SignalBus(names=[r.id for r in reps])
    clock = Clock()
    ctrl = p.degrade.DegradeController(
        router, bus, policy=p.degrade.DegradePolicy(
            up_stable_ticks=1, down_stable_ticks=1, cooldown_ticks=0),
        clock=clock)
    router.degrade = ctrl
    log = []
    for depth in (100, 100, 100, 100, 0, 0, 0):
        clock.advance(0.01)
        for r in reps:
            bus.observe(r.id, {"serve_queue_depth": depth}, ts=clock())
        ctrl.tick()
        log.append((ctrl.level, ctrl.level_name,
                    [(r.engine._degrade_no_spec, r.engine._degrade_window_cap,
                      sorted(r.engine.queue.shed_classes)) for r in reps]))
    events = [{k: e[k] for k in ("event", "action") if k in e}
              for e in ctrl.events]
    log.append((events, ctrl.transitions))
    rids = [router.submit([5, 4, 3]) for _ in range(3)]
    router.run_until_drained()
    return log, _outcome(router, rids)


SCENARIOS = {
    "round_robin_churn": lambda p: _churn(p, "round_robin"),
    "least_loaded_churn": lambda p: _churn(p, "least_loaded"),
    "breaker": _breaker,
    "crash_failover": _crash_failover,
    "backlog_retry_pacing": _backlog_retry,
    "forced_evacuation": _forced_evacuation,
    "brownout_steps": _brownout,
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_router_decisions_and_stats_equal_jax(scenario):
    runs = {name: SCENARIOS[scenario](_pkg(name)) for name in PACKAGES}
    jax_log, jax_out = runs["jax"]
    port_log, port_out = runs["port"]
    assert port_log == jax_log
    assert port_out == jax_out
    assert port_out["stats"]["dropped_requests"] == 0


# -- fleets of real tiny engines, JAX against port --------------------------


def _unflat(flat):
    return traverse_util.unflatten_dict(
        {tuple(n.split("/")): x for n, x in flat.items()})


@pytest.fixture(scope="module")
def tiny():
    jm = jax_tiny(vocab_size=VOCAB, max_len=MAX_LEN)
    flat = tiny_nmt_params(jm, SRC, kernel_scale=3.0)
    # The rollout's new weights: the same draws, kernels ×2.5.
    flat2 = {n: x * (2.5 / 3.0) if n.endswith("kernel") else x
             for n, x in flat.items()}
    tm = torch_tiny(vocab_size=VOCAB, max_len=MAX_LEN)
    tm.load_state_dict(params_from_flax(flat), strict=True)
    tm.requires_grad_(False)
    rng = np.random.RandomState(5)
    trace = [[int(t) for t in rng.randint(3, VOCAB, size=SRC - 1)] + [2]
             for _ in range(4)]

    def engine(pkg, phase="both", **kw):
        kw = dict(capacity=2, max_src_len=SRC, queue_depth=16,
                  default_max_new_tokens=MAX_NEW, decode_window=2,
                  kv_block_size=4, phase=phase, **kw)
        if pkg == "jax":
            return JaxEngine(jm, {"params": _unflat(flat)}, **kw)
        model = torch_tiny(vocab_size=VOCAB, max_len=MAX_LEN)
        model.load_state_dict(tm.state_dict())
        return Engine(model.requires_grad_(False), **kw)

    return {"engine": engine, "trace": trace, "flat": flat, "flat2": flat2}


def _route(router, trace, overload):
    rids = []
    for src in trace:
        while True:
            try:
                rids.append(router.submit(src, max_new_tokens=MAX_NEW))
                break
            except overload:
                router.step()
    return rids


def _artifact_layout(engine, src):
    req = engine.submit(src, max_new_tokens=MAX_NEW)
    engine.run_until_drained()
    art = engine.export_handoff(req.id)
    return {k: (str(getattr(v, "dtype", "")), tuple(v.shape))
            for k, v in art.items()}


def test_disaggregated_hop_matches_jax(tiny):
    out = {}
    for name in PACKAGES:
        p = _pkg(name)
        router = p.fleet.Router(
            [p.fleet.EngineReplica("prefill-0",
                                   tiny["engine"](name, "prefill")),
             p.fleet.EngineReplica("decode-0",
                                   tiny["engine"](name, "decode"))],
            policy="least_loaded")
        rids = _route(router, tiny["trace"], p.queue.OverloadError)
        router.run_until_drained()
        st = router.stats()
        out[name] = ([router.result(r)["tokens"] for r in rids],
                     st["handoffs"], st["handoff_bytes"],
                     st["dropped_requests"],
                     [router.ledger[r]["replicas"] for r in rids])
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1] == len(tiny["trace"])
    if out["port"][2] != out["jax"][2]:
        layouts = {n: _artifact_layout(tiny["engine"](n, "prefill"),
                                       tiny["trace"][0]) for n in PACKAGES}
        differ = sorted(k for k in set(layouts["jax"]) | set(layouts["port"])
                        if layouts["jax"].get(k) != layouts["port"].get(k))
        pytest.fail(f"handoff_bytes {out['port'][2]} != JAX's "
                    f"{out['jax'][2]}; keys that differ: "
                    + ", ".join(f"{k} {layouts['port'].get(k)} vs "
                                f"{layouts['jax'].get(k)}" for k in differ))
    assert out["port"][3:] == out["jax"][3:]
    assert out["port"][3] == 0


def test_rolling_upgrade_mid_stream_matches_jax(tiny):
    out = {}
    for name in PACKAGES:
        p = _pkg(name)
        router = p.fleet.Router(
            [p.fleet.EngineReplica(f"replica-{i}", tiny["engine"](name))
             for i in range(2)], policy="round_robin")
        half = len(tiny["trace"]) // 2
        rids = _route(router, tiny["trace"][:half], p.queue.OverloadError)
        router.step()
        new = {"params": _unflat(tiny["flat2"])} if name == "jax" \
            else params_from_flax(tiny["flat2"])
        report = p.fleet.rolling_upgrade(router, new)
        rids += _route(router, tiny["trace"][half:], p.queue.OverloadError)
        router.run_until_drained()
        out[name] = ([router.result(r)["tokens"] for r in rids],
                     report.ok, report.upgraded,
                     router.stats()["dropped_requests"])
    assert out["port"] == out["jax"]
    assert out["port"][1] and out["port"][3] == 0


def test_chaos_kill_of_the_decode_replica_drops_nothing(tiny):
    p = _pkg("port")
    plan = p.faults.FaultPlan([p.faults.FaultSpec(
        op="step", key="decode-0", kind="crash", at_calls=(1,))])
    base = tiny["engine"]("port")
    ids = [base.submit(s, max_new_tokens=MAX_NEW).id for s in tiny["trace"]]
    base.run_until_drained()
    want = [list(base.poll(i).tokens) for i in ids]
    reps = [p.fleet.EngineReplica(n, tiny["engine"]("port", ph),
                                  fault_plan=plan)
            for n, ph in (("prefill-0", "prefill"), ("decode-0", "decode"),
                          ("decode-1", "decode"))]
    router = p.fleet.Router(reps, policy="least_loaded")
    rids = _route(router, tiny["trace"], p.queue.OverloadError)
    router.run_until_drained()
    assert reps[1].state is p.fleet.ReplicaState.DOWN
    assert router.evacuations >= 1
    assert router.stats()["dropped_requests"] == 0
    assert [router.result(r)["tokens"] for r in rids] == want


# -- the CLI ----------------------------------------------------------------

# transformer_nmt_tiny's geometry, the one the fleets above serve.
CFG_OVERRIDES = [
    "model.kwargs.hidden_size=64", "model.kwargs.num_layers=2",
    "model.kwargs.num_heads=4", "model.kwargs.mlp_dim=128",
    f"model.kwargs.max_len={MAX_LEN}", f"model.kwargs.vocab_size={VOCAB}",
    f"data.seq_len={SRC}", "train.dtype=float32",
]


@pytest.fixture(scope="module")
def cli_workdir(tmp_path_factory, tiny):
    """A JAX checkpoint of the tiny fleets' weights in the preset's layout,
    and a request trace."""
    root = tmp_path_factory.mktemp("fleet_cli")
    save_checkpoint(str(root / "transformer_nmt_wmt" / "ckpt"), 3,
                    {"params": _unflat(tiny["flat"])})
    rng = np.random.RandomState(9)
    reqs = root / "reqs.jsonl"
    reqs.write_text("".join(
        json.dumps({"id": f"q{i}", "src_ids": [int(t) for t in rng.randint(
            3, VOCAB, size=5)] + [2], "max_new_tokens": 4}) + "\n"
        for i in range(4)))
    return root, reqs


def _cli_lines(pkg, argv, capsys):
    main = importlib.import_module(f"{PACKAGES[pkg]}.cli.main").main
    capsys.readouterr()
    rc = main(argv)
    out, err = capsys.readouterr()
    lines = [json.loads(ln) for ln in out.splitlines()
             if ln.startswith("{")]
    return rc, [{k: ln[k] for k in ("id", "state", "tokens")}
                for ln in lines], err


@pytest.mark.parametrize("verb", ["route", "up_disaggregated"])
def test_cli_fleet_result_lines_equal_jax(cli_workdir, capsys, verb):
    root, reqs = cli_workdir
    got = {}
    for pkg in PACKAGES:
        argv = ["fleet", "route" if verb == "route" else "up", "--preset",
                "transformer_nmt_wmt", "--accelerator", "cpu", "--requests",
                str(reqs), "--max-new-tokens", "4", "--slots", "2"]
        if verb != "route":
            argv += ["--prefill", "1", "--decode", "1", "--kv-block-size",
                     "4", "--run-root", str(root / f"run_{pkg}")]
        argv += [*CFG_OVERRIDES, f"workdir={root}"]
        rc, lines, err = _cli_lines(pkg, argv, capsys)
        assert rc == 0, err
        got[pkg] = lines
    assert got["port"] == got["jax"]
    assert len(got["port"]) == 4
    assert all(ln["state"] == "done" for ln in got["port"])
    if verb != "route":
        from deeplearning_cfn_tpu_torch.cli.main import main

        run_root = str(root / "run_port")
        assert sorted(os.listdir(run_root)) == [
            "decode-0", "prefill-0", "router.jsonl"]
        assert main(["fleet", "status", run_root]) == 0
        out = capsys.readouterr().out
        assert "fleet 2 replica(s)" in out
        assert "phase prefill" in out and "phase decode" in out
        assert main(["fleet", "status", run_root, "--json"]) == 0
        summary = json.loads(capsys.readouterr().out)
        assert summary["source"]["replicas"] == 2


def test_cli_fleet_up_children_run_the_port(cli_workdir, monkeypatch,
                                            capsys):
    """``fleet up`` (co-located) starts one supervised ``serve`` child per
    replica: the argv names the port's CLI module and forwards
    ``--accelerator``. The supervisor is stubbed so that nothing spawns."""
    import deeplearning_cfn_tpu_torch.fleet as fleet
    from deeplearning_cfn_tpu_torch.cli.main import main

    root, reqs = cli_workdir
    seen = []

    class Sup:
        def __init__(self, specs, max_restarts=1):
            seen.extend(specs)

        def start(self):
            pass

        def wait(self, timeout_s=None):
            return True

        def close(self):
            pass

        def status(self):
            return [{"replica": s.replica_id, "state": "ok", "attempt": 0,
                     "outcomes": ["ok"]} for s in seen]

    monkeypatch.setattr(fleet, "ReplicaSupervisor", Sup)
    rc = main(["fleet", "up", "--preset", "transformer_nmt_wmt",
               "--accelerator", "cpu", "--requests", str(reqs),
               "--replicas", "2", "--run-root", str(root / "co"),
               "--allow-init", *CFG_OVERRIDES, f"workdir={root}"])
    capsys.readouterr()
    assert rc == 0 and [s.replica_id for s in seen] == ["replica-0",
                                                        "replica-1"]
    for i, spec in enumerate(seen):
        assert spec.argv[1:4] == ["-m", "deeplearning_cfn_tpu_torch.cli",
                                  "serve"]
        at = spec.argv.index("--accelerator")
        assert spec.argv[at + 1] == "cpu" and "--allow-init" in spec.argv
        shard = spec.argv[spec.argv.index("--requests") + 1]
        with open(shard) as fh:
            assert len(fh.read().splitlines()) == 2
