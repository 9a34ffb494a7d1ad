"""The port's launch layer (deeplearning_cfn_tpu_torch.launch,
.runtime.cluster, .runtime.faults, .train.worker) against the JAX
package's, on the CPU.

- The cluster env contract: ``cluster_env`` and ``current_cluster`` give
  the JAX package's env blocks and specs; ``initialize`` is a no-op for one
  host and refuses more, naming ROADMAP A.10.
- Fault injection: the same scripted store operations through both
  ``FaultInjectionStore``s fire the same faults; a torn checkpoint commit
  leaves the same objects behind in both packages' stores, and the port
  sweeps and rolls it back; the chaos hook arms only on attempt 0.
- The launcher: the same scripted host programs (small Python scripts that
  print their env and exit with given codes, crash once, or sleep) through
  both ``JobLauncher``s over ``LocalTransport`` and a fake-ssh
  ``SshTransport`` give equal results, env blocks, attempt indices, log
  files, launch events and ssh argvs.
- Recovery: an in-process interrupt and resume of the port's run is
  step-exact; ``run_crash_recovery(accelerator="cpu")`` on a tiny NMT is
  step-exact through a real SIGKILL of the worker and a restart.
"""

import concurrent.futures
import dataclasses
import importlib
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from deeplearning_cfn_tpu_torch.ckpt import (MemoryObjectStore,
                                             committed_steps,
                                             latest_checkpoint,
                                             restore_checkpoint,
                                             rollback_checkpoints,
                                             save_checkpoint,
                                             sweep_uncommitted)
from deeplearning_cfn_tpu_torch.config import apply_overrides
from deeplearning_cfn_tpu_torch.presets import get_preset
from deeplearning_cfn_tpu_torch.runtime import cluster as t_cluster
from deeplearning_cfn_tpu_torch.runtime.faults import (
    ATTEMPT_ENV, CHAOS_KILL_ENV, FaultInjectionStore, FaultPlan, FaultSpec,
    StoreCrashed, chaos_kill_hook_from_env)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("deeplearning_cfn_tpu", "deeplearning_cfn_tpu_torch")
TINY_NMT = ["model.kwargs.hidden_size=32", "model.kwargs.num_layers=1",
            "model.kwargs.num_heads=2", "model.kwargs.mlp_dim=64",
            "data.vocab_size=64", "data.seq_len=16", "train.global_batch=8",
            "data.num_train_examples=64", "data.num_eval_examples=16",
            "eval.max_decode_len=8", "schedule.warmup_steps=2",
            "schedule.base_lr=0.01"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One worker's share of the cores (torch would start a thread per core
    in every pytest-xdist worker)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# -- the cluster env contract -------------------------------------------------


def _cluster_cases(pkg, tmp_path):
    c = _mod(pkg, "runtime.cluster")
    hostfile = str(tmp_path / pkg / "hosts")
    c.write_hostfile(hostfile, ["10.0.0.1", "10.0.0.2", "10.0.0.3"])
    specs = [c.ClusterSpec(hosts=["localhost"], chips_per_host=1),
             c.ClusterSpec(hosts=["a", "b"], process_id=1,
                           coordinator_port=9000),
             c.ClusterSpec(hosts=c.read_hostfile(hostfile),
                           chips_per_host=8, hostfile=hostfile)]
    out = []
    for spec in specs:
        for rank in range(spec.num_processes):
            env = c.cluster_env(spec, rank)
            back = c.current_cluster(env)
            out.append((env, dataclasses.asdict(back), back.coordinator,
                        back.is_multi_host))
    # The coordinator-only contract (no hostfile) and no contract at all.
    only = c.current_cluster({c.ENV_COORDINATOR: "10.1.1.1:1234",
                              c.ENV_WORKERS_COUNT: "3",
                              c.ENV_PROCESS_ID: "2"})
    out.append(dataclasses.asdict(only))
    out.append(c.current_cluster({}))
    try:
        c.current_cluster({c.ENV_WORKERS_PATH: hostfile + "-gone"})
    except FileNotFoundError as e:
        out.append(str(e).replace(pkg, "PKG"))
    try:
        c.ClusterSpec(hosts=["a"], process_id=1).validate()
    except ValueError as e:
        out.append(str(e))
    return json.loads(json.dumps(out).replace(str(tmp_path / pkg), "TMP"))


def test_cluster_env_round_trips_equal_jax(tmp_path):
    assert _cluster_cases(PKGS[1], tmp_path) == \
        _cluster_cases(PKGS[0], tmp_path)


def test_initialize_is_one_host_and_refuses_more_naming_a10(monkeypatch):
    for var in (t_cluster.ENV_COORDINATOR, t_cluster.ENV_WORKERS_PATH):
        monkeypatch.delenv(var, raising=False)
    assert t_cluster.initialize().num_processes == 1  # no contract: no-op
    one = t_cluster.ClusterSpec(hosts=["localhost"], chips_per_host=1)
    assert t_cluster.initialize(one) is one
    monkeypatch.setenv(t_cluster.ENV_COORDINATOR, "localhost:8476")
    monkeypatch.setenv(t_cluster.ENV_WORKERS_COUNT, "1")
    assert t_cluster.initialize().hosts == ["localhost"]
    with pytest.raises(NotImplementedError, match="A.10"):
        t_cluster.initialize(t_cluster.ClusterSpec(hosts=["a", "b"]))


# -- fault injection ----------------------------------------------------------


def _fault_script(pkg):
    """One scripted sequence of store operations under several plans; the
    outcome of every call, the counters and the fired kinds."""
    faults = _mod(pkg, "runtime.faults")
    store_mod = _mod(pkg, "ckpt.store")
    slept = []
    plans = {
        "first_n": faults.FaultPlan([faults.FaultSpec(
            op="put", kind="transient", first_n=2)]),
        "at_calls": faults.FaultPlan([faults.FaultSpec(
            op="put", key="DONE", kind="transient", at_calls=(1,))]),
        "seeded": faults.FaultPlan([faults.FaultSpec(
            op="put", kind="transient", probability=0.5)], seed=7),
        "latency": faults.FaultPlan([faults.FaultSpec(
            op="get", kind="latency", latency_s=1.5)]),
        "crash": faults.FaultPlan.crash_before_commit(),
        "fleet_sites": faults.FaultPlan.from_dict({"seed": 3, "specs": [
            {"op": "step", "key": "r0", "kind": "hang", "at_calls": [1]},
            {"op": "replica.submit", "kind": "fatal", "first_n": 1}]}),
    }
    keys = ["a", "b", "step_1/DONE_p0", "step_1/DONE_p0", "step_1/COMMIT",
            "a", "k3", "k4", "k5", "k6"]
    out = {}
    for name, plan in plans.items():
        store = faults.FaultInjectionStore(store_mod.MemoryObjectStore(),
                                           plan, sleep=slept.append)
        log = []
        for i, key in enumerate(keys):
            for op in ("put_bytes", "get_bytes", "exists", "list"):
                try:
                    if op == "put_bytes":
                        store.put_bytes(key, str(i).encode())
                        log.append("put ok")
                    elif op == "get_bytes":
                        log.append(store.get_bytes(key).decode())
                    else:
                        log.append(repr(getattr(store, op)(key)))
                except Exception as e:  # the outcome is what is compared
                    log.append(f"{type(e).__name__}: {e}")
        sites = [plan.consult(op, key) for op, key in (
            ("replica.step", "r0"), ("replica.step", "r0"),
            ("replica.submit", "q1"), ("replica.submit", "q1"))]
        out[name] = (log, store.op_counts, store.injected, store.crashed,
                     plan.fired_counts, [[s.kind for s in f] for f in sites],
                     store.describe())
    try:
        faults.FaultSpec(kind="gremlins")
    except ValueError as e:
        out["bad_kind"] = str(e)
    try:
        faults.FaultPlan.from_dict({"specs": [{"op": "put", "bogus": 1}]})
    except ValueError as e:
        out["bad_field"] = str(e)
    out["slept"] = slept
    return out


def test_fault_injection_store_fires_as_jax_does():
    assert _fault_script(PKGS[1]) == _fault_script(PKGS[0])


def _torn_objects(pkg, plan_name):
    """The objects a crash mid-save leaves in a memory store."""
    faults = _mod(pkg, "runtime.faults")
    store_mod = _mod(pkg, "ckpt.store")
    ckpt = _mod(pkg, "ckpt.checkpoint")
    w = np.arange(6.0, dtype=np.float32).reshape(2, 3)
    if pkg == PKGS[0]:
        state = {"params": {"w": w}, "step": np.asarray(5, np.int32)}
    else:
        state = {"params/w": w, "step": np.asarray(5, np.int32)}
    inner = store_mod.MemoryObjectStore()
    ckpt.save_checkpoint(inner, 1, state, async_write=False)
    faulty = faults.FaultInjectionStore(
        inner, getattr(faults.FaultPlan, plan_name)())
    try:
        ckpt.save_checkpoint(faulty, 2, state, async_write=False)
    except faults.StoreCrashed as e:
        crashed = str(e)
    return inner, sorted(inner.list("")), crashed


@pytest.mark.parametrize("plan", ["crash_before_done", "crash_before_commit"])
def test_torn_commit_leaves_jax_objects_and_is_swept(plan):
    inner, objects, crashed = _torn_objects(PKGS[1], plan)
    _, j_objects, j_crashed = _torn_objects(PKGS[0], plan)
    assert (objects, crashed) == (j_objects, j_crashed)
    assert latest_checkpoint(inner) == 1  # the torn step stays invisible
    leaves, step = restore_checkpoint(inner, {"params/w": None,
                                              "step": None})
    assert step == 1 and leaves["params/w"].shape == (2, 3)
    if plan == "crash_before_commit":
        assert rollback_checkpoints(inner, 1) == [2]
    else:
        assert sweep_uncommitted(inner) == [2]
    assert inner.list("step_00000002/") == []
    assert committed_steps(inner) == [1]


def test_dead_store_never_writes_again():
    store = FaultInjectionStore(MemoryObjectStore(),
                                FaultPlan([FaultSpec(op="put", key="DONE_p1",
                                                     kind="crash")]))
    store.put_bytes("step_4/DONE_p0", b"4")
    with pytest.raises(StoreCrashed):
        store.put_bytes("step_4/DONE_p1", b"4")
    with pytest.raises(StoreCrashed):
        store.get_bytes("step_4/DONE_p0")
    assert not store.inner.exists("step_4/DONE_p1")
    save_checkpoint(store.inner, 3, {"w": np.zeros(2, np.float32)})
    assert committed_steps(store.inner) == [3]


def test_chaos_hook_arming_contract(monkeypatch):
    """The SIGKILL hook arms only on attempt 0 with the env set — a
    restarted attempt must run to completion."""
    monkeypatch.delenv(CHAOS_KILL_ENV, raising=False)
    monkeypatch.delenv(ATTEMPT_ENV, raising=False)
    assert chaos_kill_hook_from_env() is None  # unarmed by default
    monkeypatch.setenv(CHAOS_KILL_ENV, "4")
    assert chaos_kill_hook_from_env() is not None  # armed, attempt 0
    monkeypatch.setenv(ATTEMPT_ENV, "1")
    assert chaos_kill_hook_from_env() is None  # restarted attempt: never


def test_run_experiment_arms_the_chaos_hook_after_the_checkpoint(
        tmp_path, monkeypatch):
    """The armed hook runs after the checkpoint hook, so the step it fires
    at is already saved (here the kill is stubbed to record what the store
    holds when it lands)."""
    from deeplearning_cfn_tpu_torch.runtime import faults
    from deeplearning_cfn_tpu_torch.train.run import run_experiment

    ckpt_dir = str(tmp_path / "transformer_nmt_wmt" / "ckpt")
    fired = []
    monkeypatch.setattr(faults.os, "kill", lambda pid, sig: fired.append(
        (sig, committed_steps(ckpt_dir))))
    monkeypatch.setenv(CHAOS_KILL_ENV, "2")
    monkeypatch.setenv(ATTEMPT_ENV, "0")
    cfg = apply_overrides(get_preset("transformer_nmt_wmt"), [
        f"workdir={tmp_path}", *TINY_NMT, "train.steps=2",
        "checkpoint.every_steps=2", "checkpoint.async_write=false",
        "eval.enabled=false"])
    run_experiment(cfg, device="cpu")
    assert fired == [(faults.signal.SIGKILL, [2])]


# -- the launcher: the same host programs through both packages --------------

# A host program: records its DLCFN_* env per attempt, then acts by the
# scenario (argv[1]) — "ok", "crash1" (rank 1 exits 7 on attempt 0 once
# rank 0 has printed, and rank 0 waits to be killed), "exit3" (every rank
# exits 3), "hang0" (exits the hang code on attempt 0), "kill" (rank 1 exits
# 1, rank 0 sleeps an hour).
HOST_PROGRAM = r"""
import json, os, sys, time
out, scenario = os.environ["OUT"], sys.argv[1]
rank = int(os.environ["DLCFN_PROCESS_ID"])
attempt = os.environ["DLCFN_ATTEMPT"]
env = {k: v for k, v in os.environ.items() if k.startswith("DLCFN_")}
with open(os.path.join(out, f"env-{attempt}-{rank}.json"), "w") as fh:
    json.dump(env, fh)
print("rank", rank, "attempt", attempt, "scenario", scenario, flush=True)
if scenario == "crash1" and attempt == "0":
    # The same logs and exit codes in every run: rank 1 fails only after
    # rank 0 has printed, and rank 0 is always the survivor the launcher
    # kills.
    printed = os.path.join(os.path.dirname(out), "rank0-printed")
    if rank == 0:
        open(printed, "w").close()
        time.sleep(3600)
    while not os.path.exists(printed):
        time.sleep(0.01)
    sys.exit(7)
if scenario == "exit3":
    sys.exit(3)
if scenario == "hang0" and attempt == "0":
    sys.exit(89)
if scenario == "kill":
    sys.exit(1) if rank == 1 else time.sleep(3600)
print("RESUMED" if attempt != "0" else "DONE", "rank", rank)
"""

_SSH_SHIM = r"""#!/usr/bin/env bash
# Fake ssh for tests: record argv, then run the remote command locally.
rec=$(mktemp "$FAKE_SSH_DIR/call_XXXXXX.argv")
printf '%s\n' "$@" > "$rec"
while [ $# -gt 0 ]; do
  case "$1" in
    -o|-p|-i|-l|-F|-E) shift 2 ;;
    -*) shift ;;
    *) break ;;
  esac
done
host="$1"; shift
exec bash -c "$*"
"""


@pytest.fixture
def fake_ssh(tmp_path, monkeypatch):
    """A fake ``ssh`` first on PATH that records every argv (one directory
    per package) and runs the remote command locally."""
    bindir = tmp_path / "fake_bin"
    bindir.mkdir()
    shim = bindir / "ssh"
    shim.write_text(_SSH_SHIM)
    shim.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    return tmp_path


def _launch(pkg, root, scenario, hosts, max_restarts, ssh, setenv=None):
    """One scenario through one package's launcher; everything observable,
    with the package's directory replaced by a placeholder."""
    launch = _mod(pkg, "launch")
    cluster = _mod(pkg, "runtime.cluster")
    base = root / pkg
    out, logs, calls = base / "out", base / "logs", base / "ssh_calls"
    for d in (out, calls):
        d.mkdir(parents=True)
    script = base / "host.py"
    script.write_text(HOST_PROGRAM)
    transport = launch.SshTransport() if ssh else launch.LocalTransport()
    failures = []
    env = {"OUT": str(out)}
    if ssh:
        setenv("FAKE_SSH_DIR", str(calls))  # the shim's, from this process
    launcher = launch.JobLauncher(transport=transport,
                                  max_restarts=max_restarts,
                                  tail_rank0=False, poll_interval_s=0.05)
    t0 = time.monotonic()
    result = launcher.run(
        cluster.ClusterSpec(hosts=hosts),
        [sys.executable, str(script), scenario], str(logs), extra_env=env,
        cwd=str(base), on_failure=lambda i, h: failures.append((i, h)))
    elapsed = time.monotonic() - t0
    envs = {p.name: json.loads(p.read_text()) for p in sorted(out.iterdir())}
    texts = {p.name: p.read_text() for p in sorted(logs.iterdir())
             if p.suffix == ".log"}
    events = [json.loads(line) for line in
              (logs / "launch.jsonl").read_text().splitlines()]
    for rec in events:
        rec.pop("ts")
        rec.pop("t0_s", None)
        rec.pop("dur_s", None)
        rec.pop("span_id", None)
    argvs = sorted(p.read_text() for p in calls.iterdir())
    observed = dict(result=dataclasses.asdict(result), failures=failures,
                    envs=envs, logs=texts, events=events, argvs=argvs)
    return json.loads(json.dumps(observed).replace(str(base), "BASE")), \
        elapsed


LAUNCH_CASES = {
    # name: (scenario, hosts, max_restarts, ssh)
    "fanout": ("ok", ["127.0.0.1"] * 3, 2, False),
    "crash_restart_resume": ("crash1", ["127.0.0.1"] * 2, 2, False),
    "budget_exhausted": ("exit3", ["127.0.0.1"], 1, False),
    "hang_then_ok": ("hang0", ["127.0.0.1"], 2, False),
    "kill_survivors": ("kill", ["127.0.0.1"] * 2, 0, False),
    "ssh_fanout": ("ok", ["worker-a", "worker-b"], 2, True),
    "ssh_crash_restart_resume": ("crash1", ["worker-a", "worker-b"], 2, True),
    "ssh_kill_survivors": ("kill", ["worker-a", "worker-b"], 0, True),
}


@pytest.mark.parametrize("case", sorted(LAUNCH_CASES))
def test_launcher_runs_host_programs_as_jax_does(case, fake_ssh,
                                                monkeypatch):
    scenario, hosts, max_restarts, ssh = LAUNCH_CASES[case]
    if ssh:
        # Both packages' ssh calls run one after the other: the shim reads
        # its record directory from this process's environment.
        runs = [_launch(pkg, fake_ssh, scenario, hosts, max_restarts, ssh,
                        monkeypatch.setenv) for pkg in PKGS]
    else:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            runs = list(pool.map(
                lambda pkg: _launch(pkg, fake_ssh, scenario, hosts,
                                    max_restarts, ssh), PKGS))
    (want, _), (got, elapsed) = runs
    assert got == want
    res = got["result"]
    assert res["log_dir"] == "BASE/logs"
    if scenario == "kill":
        assert not res["success"] and res["exit_codes"][1] == 1
        assert elapsed < 30  # the sleeper was killed, not waited out
    if scenario == "crash1":
        assert res["attempt_outcomes"] == ["crash", "ok"]
        first = next(e for e in got["events"]
                     if e.get("event") == "launch_attempt")
        assert first["exit_codes"] == [-15, 7]
        assert "RESUMED rank 1" in got["logs"]["attempt1-host1.log"]
        assert got["failures"] == [[1, hosts[1]]]
    if ssh:
        assert len(got["argvs"]) == len(hosts) * (1 + res["restarts"])
        assert all(a.startswith("-tt\n") and "BatchMode=yes" in a
                   for a in got["argvs"])
    # Every host of every attempt saw its rank and the attempt index.
    for name, env in got["envs"].items():
        _, attempt, rank = name[:-5].split("-")
        assert env["DLCFN_PROCESS_ID"] == rank
        assert env["DLCFN_ATTEMPT"] == attempt
        assert env["DLCFN_WORKERS_COUNT"] == str(len(hosts))


def test_handle_start_poll_and_terminate(tmp_path):
    """The non-blocking JobHandle: per-host liveness while running, the
    classified outcome once every host exits, terminate kills."""
    from deeplearning_cfn_tpu_torch.launch import JobLauncher, LocalTransport
    from deeplearning_cfn_tpu_torch.runtime.cluster import ClusterSpec

    launcher = JobLauncher(transport=LocalTransport(), tail_rank0=False)
    assert launcher.poll() is None
    handle = launcher.start(
        ClusterSpec(hosts=["127.0.0.1"] * 2),
        [sys.executable, "-c", "import os, sys, time; "
         "sys.exit(5) if os.environ['DLCFN_PROCESS_ID'] == '1' "
         "else time.sleep(600)"], str(tmp_path / "logs"))
    try:
        deadline = time.time() + 30
        while handle.poll()[1] is None and time.time() < deadline:
            time.sleep(0.02)
        assert handle.poll() == [None, 5] and handle.alive() == [True, False]
        assert handle.outcome() is None and launcher.poll() == [None, 5]
    finally:
        handle.terminate()
    codes = handle.wait(timeout_s=30)
    assert codes[0] is not None and codes[0] != 0
    assert handle.outcome() == "crash"
    assert sorted(p.name for p in (tmp_path / "logs").iterdir()) == [
        "attempt0-host0.log", "attempt0-host1.log"]


# -- recovery -----------------------------------------------------------------


def _step_losses(workdir):
    """step -> [loss, ...] from every per-step record in metrics.jsonl."""
    out = {}
    path = os.path.join(workdir, "transformer_nmt_wmt", "metrics.jsonl")
    with open(path) as fh:
        for line in fh:
            rec = json.loads(line)
            if "step" in rec and "loss" in rec and "span" not in rec:
                out.setdefault(int(rec["step"]), []).append(rec["loss"])
    return out


def test_inprocess_interrupt_resume_is_step_exact(tmp_path):
    """Interrupt a run at a committed step, plant a torn checkpoint dir,
    resume: the orphan is swept and the trajectory matches an uninterrupted
    control run exactly."""
    from deeplearning_cfn_tpu_torch.train.run import run_experiment

    def cfg(workdir):
        return apply_overrides(get_preset("transformer_nmt_wmt"), [
            f"workdir={workdir}", *TINY_NMT, "train.steps=6",
            "checkpoint.every_steps=2", "checkpoint.async_write=false",
            "train.log_every_steps=1", "train.eval_every_steps=1000000",
            "eval.enabled=false"])

    base_dir, chaos_dir = tmp_path / "base", tmp_path / "chaos"
    run_experiment(cfg(base_dir), device="cpu")
    run_experiment(cfg(chaos_dir), max_steps=4, device="cpu")
    ckpt_dir = chaos_dir / "transformer_nmt_wmt" / "ckpt"
    torn = ckpt_dir / "step_00000099"
    torn.mkdir()
    (torn / "shards_p0.npz").write_bytes(b"half-written garbage")
    run_experiment(cfg(chaos_dir), device="cpu")  # sweep, resume 4 -> 6

    assert not torn.exists(), "orphaned uncommitted dir not swept"
    base, chaos = _step_losses(base_dir), _step_losses(chaos_dir)
    assert set(chaos) == set(base) == set(range(1, 7))
    for step, losses in chaos.items():
        for loss in losses:
            assert loss == base[step][0], (step, loss, base[step])
    assert 6 in committed_steps(str(ckpt_dir))
    path = chaos_dir / "transformer_nmt_wmt" / "metrics.jsonl"
    finals = [json.loads(line) for line in path.read_text().splitlines()
              if "ckpt_store_retries" in line]
    assert finals and all(r["ckpt_store_retries"] == 0 for r in finals)


def test_sigkill_restart_resumes_step_exact_on_cpu(tmp_path, monkeypatch):
    """The full contract through the launcher: the port's worker SIGKILLs
    itself right after the step-4 checkpoint (saved synchronously, so it
    committed), the launcher restarts it, and the resumed run is step-exact
    against the control."""
    from deeplearning_cfn_tpu_torch.launch.chaos import run_crash_recovery

    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
    report = run_crash_recovery(
        str(tmp_path), preset="transformer_nmt_wmt",
        overrides=TINY_NMT + ["checkpoint.async_write=false"],
        total_steps=8, kill_at_step=4, ckpt_every=4, max_restarts=2,
        accelerator="cpu")
    assert report.baseline_result.success, report.baseline_result
    assert report.chaos_result.success, report.chaos_result
    assert report.chaos_result.attempt_outcomes == ["crash", "ok"]
    assert report.resumed_from == 4
    assert report.parity_ok, report.mismatches
    assert report.chaos_steps == report.baseline_steps == list(range(1, 9))
    assert report.uncommitted_after == []
    assert report.ok
    log = (tmp_path / "logs-chaos" / "attempt0-host0.log").read_text()
    assert "CHAOS: SIGKILL self at step 4" in log
    assert "one device: cpu" in log


def test_worker_refuses_profiler_port_and_a_missing_card(monkeypatch):
    from deeplearning_cfn_tpu_torch.train import worker

    with pytest.raises(ValueError, match="profile_steps"):
        worker.main(["--preset", "transformer_nmt_wmt", "--accelerator",
                     "cpu", "--profiler-port", "9999"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        worker.main(["--preset", "transformer_nmt_wmt"])
