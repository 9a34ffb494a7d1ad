"""The port's fleet benches (``fleet/bench.py``, ``net/bench.py``) against the
JAX package's, on the CPU.

- ``run_fleet_bench(smoke=True)``, co-located and 1+1 disaggregated, with
  the JAX bench's tiny weights carried across: JAX's key set and JAX's
  deterministic fields (drops, token identity, the goodput ledger, ticks,
  per-replica routing and tokens, handoffs). Tolerance: equal.
- ``--trace burst --autoscale``: JAX's run costs ~28 s on the CPU
  (``tests/test_fleet.py``), so it is not made; ``arrival_schedule`` equals
  the schedule JAX's loadgen draws for the same spec, exactly, two port
  runs give the same ``scale_events``, and the record holds what JAX's own
  test of the scenario pins.
- ``run_net_fleet_bench(smoke=True)`` over real child processes: the
  record's contract (zero drops, both parities), ``NULLABLE_FIELDS`` equal
  to JAX's, and JAX's key set (the keys its record is built with, listed
  here: its run starts JAX child processes).
"""

import os

import pytest
import torch

from deeplearning_cfn_tpu import loadgen as jax_loadgen
from deeplearning_cfn_tpu.fleet import bench as jax_fleet_bench
from deeplearning_cfn_tpu.net import bench as jax_net_bench
from deeplearning_cfn_tpu_torch.fleet import bench as fleet_bench
from deeplearning_cfn_tpu_torch.net import bench as net_bench
from torch_tiny_nmt import bench_model_from_jax


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One worker's share of the cores (torch would start a thread per core
    in every pytest-xdist worker)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_colocated():
    return jax_fleet_bench.run_fleet_bench(smoke=True)


FLEET_DETERMINISTIC = (
    "metric", "unit", "replicas", "policy", "dropped_requests",
    "evacuations", "token_identical", "goodput_tokens", "wasted_tokens",
    "goodput_sum_ok", "requests", "slots", "max_new_tokens",
    "decode_window", "fleet_ticks", "smoke", "device", "prefill_replicas",
    "decode_replicas", "trace_mix", "replicas_initial", "replicas_final",
    "token_identical_colocated", "handoffs", "handoff_bytes")


@pytest.mark.parametrize("kw", [{}, {"prefill_replicas": 1,
                                     "decode_replicas": 1}],
                         ids=["colocated", "disagg"])
def test_fleet_bench_smoke_equals_jax(kw, monkeypatch, request):
    ref = request.getfixturevalue("jax_colocated") if not kw else \
        jax_fleet_bench.run_fleet_bench(smoke=True, **kw)
    bench_model_from_jax(monkeypatch)
    got = fleet_bench.run_fleet_bench(smoke=True, accelerator="cpu", **kw)
    assert set(got) == set(ref)
    for key in FLEET_DETERMINISTIC:
        assert got.get(key) == ref.get(key), key
    assert got["per_replica"] == ref["per_replica"]
    assert got["dropped_requests"] == 0 and got["token_identical"] is True
    assert got["goodput_sum_ok"] is True
    if kw:
        assert got["token_identical_colocated"] is True
        assert got["handoffs"] > 0


def test_fleet_bench_burst_autoscale_contract(jax_colocated):
    kw = dict(smoke=True, autoscale=True, trace_spec="burst",
              policy="round_robin", accelerator="cpu")
    rec = fleet_bench.run_fleet_bench(**kw)
    assert set(rec) == set(jax_colocated)
    # The schedule JAX's bench replays: its loadgen at the smoke sizes.
    spec = jax_loadgen.parse_trace_spec("burst", src_len=8,
                                        max_new_tokens=4, requests=6)
    gen = jax_loadgen.LoadGenerator(spec, seed=0, vocab_size=96)
    assert rec["arrival_schedule"] == [
        [round(s.at_s, 6), len(s.src_ids), s.max_new_tokens]
        for s in gen.schedule]
    # tests/test_fleet.py's pins of the scenario.
    assert rec["autoscale"] is True and rec["trace_spec"] == "burst"
    assert rec["dropped_requests"] == 0
    assert rec["token_identical"] is True
    assert rec["scale_ups"] >= 1
    first_up = next(e for e in rec["scale_events"]
                    if e["action"] == "scale_up")
    assert first_up["replica"].startswith("auto-") and first_up["reason"]
    assert first_up["signals"]["queue_depth"] is not None
    downs = [e for e in rec["scale_events"] if e["action"] == "scale_down"]
    assert downs and all(e["drained"] is True for e in downs)
    assert 0.0 <= rec["time_to_scale_s"] < 1.0
    assert rec["p95_during_burst"] is not None
    assert rec["offered_load_rps"] > 0
    assert rec["replicas_initial"] == rec["min_replicas"] == 1
    assert rec["replicas_final"] == 1
    assert rec["max_replicas"] >= 2
    ts = [e["ts"] for e in rec["scale_events"]]
    assert ts == sorted(ts)
    again = fleet_bench.run_fleet_bench(**kw)
    assert again["arrival_schedule"] == rec["arrival_schedule"]
    assert again["scale_events"] == rec["scale_events"]
    assert [r["tokens"] for r in again["per_replica"]] == \
        [r["tokens"] for r in rec["per_replica"]]


# JAX's run_net_fleet_bench record: the keys it is built with, its phase
# 2 and 3 updates and "device" (autoscale off).
JAX_NET_KEYS = {
    "metric", "value", "unit", "vs_baseline", "mfu", "measured", "net",
    "transport", "smoke", "replicas", "policy", "requests", "slots",
    "max_new_tokens", "src_len", "decode_window", "beam_size",
    "dropped_requests", "evacuations", "reconnects", "chaos_kills",
    "token_identical", "token_identical_disagg", "handoffs",
    "handoff_bytes", "handoff_latency_p50_s", "handoff_latency_p95_s",
    "trace_dir", "flow_events", "goodput_tokens", "device",
    *jax_net_bench.NULLABLE_FIELDS}


def test_net_fleet_bench_record_contract(tmp_path):
    assert net_bench.NULLABLE_FIELDS == jax_net_bench.NULLABLE_FIELDS
    assert net_bench.METRIC == jax_net_bench.METRIC
    rec = net_bench.run_net_fleet_bench(str(tmp_path), smoke=True,
                                        accelerator="cpu")
    assert set(rec) == JAX_NET_KEYS
    assert rec["metric"] == jax_net_bench.METRIC and rec["net"] is True
    assert rec["dropped_requests"] == 0
    assert rec["token_identical"] is True
    assert rec["token_identical_disagg"] is True
    assert rec["handoffs"] == rec["requests"] == 6
    assert rec["value"] > 0 and rec["goodput_tokens"] == 6 * 4
    assert rec["device"] == "cpu"
    # Measured here; autoscale off, so its field stays null, never 0.
    for field in net_bench.NULLABLE_FIELDS:
        if field == "autoscale_time_to_scale_s":
            assert rec[field] is None
        else:
            assert rec[field] is not None and rec[field] >= 0, field
