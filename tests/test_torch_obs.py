"""The port's observability (deeplearning_cfn_tpu_torch.obs) against the JAX
package's, on the CPU.

- A training run's span records: a tiny ``transformer_nmt_wmt`` run through
  each package's ``run_experiment`` writes the same span names, each with the
  same record keys, into ``metrics.jsonl``, and a ``metrics.prom`` naming the
  same instruments and span series (ROADMAP C.4: the port wrote neither).
- Every obs function of the port on the JAX-made fixtures
  (``tests/fixtures/obs/{train,serve,breach,fleet}``, ``rules.json``) gives
  exactly the JAX function's output (they are pure-Python copies).
"""

import importlib
import io
import json
import os

import pytest
import torch

from deeplearning_cfn_tpu.obs import trace as j_trace
from deeplearning_cfn_tpu.presets import get_preset as j_preset
from deeplearning_cfn_tpu.config import apply_overrides as j_overrides
from deeplearning_cfn_tpu.train.run import run_experiment as j_run
from deeplearning_cfn_tpu_torch.config import apply_overrides
from deeplearning_cfn_tpu_torch.obs import trace as t_trace
from deeplearning_cfn_tpu_torch.presets import get_preset
from deeplearning_cfn_tpu_torch.train.run import run_experiment

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "obs")
TINY_NMT = ["model.kwargs.hidden_size=32", "model.kwargs.num_layers=1",
            "model.kwargs.num_heads=2", "model.kwargs.mlp_dim=64",
            "data.vocab_size=64", "data.seq_len=16", "train.global_batch=8",
            "data.num_train_examples=64", "data.num_eval_examples=16",
            "eval.max_decode_len=8", "schedule.warmup_steps=2",
            "schedule.base_lr=0.01", "train.steps=4",
            "checkpoint.every_steps=2", "train.log_every_steps=1",
            "checkpoint.async_write=false"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One worker's share of the cores (torch would start a thread per core
    in every pytest-xdist worker)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def _span_keys(metrics_path):
    """span name -> the set of keys its records carry."""
    out = {}
    with open(metrics_path) as fh:
        for line in fh:
            rec = json.loads(line)
            if "span" in rec:
                out.setdefault(rec["span"], set()).update(rec)
    return out


def _prom_instruments(path):
    """(TYPE lines, the span names of span_dur_s's series)."""
    types, names = set(), set()
    with open(path) as fh:
        for line in fh:
            if line.startswith("# TYPE "):
                types.add(line.strip())
            elif line.startswith("span_dur_s_count{"):
                names.add(line.split('name="', 1)[1].split('"', 1)[0])
    return types, names


def _fresh_tracer(module):
    """A fresh default tracer for one run (the registry is process-wide, and
    other tests' spans would land in this run's metrics.prom)."""
    before = module.get_tracer()
    module.configured(module.Tracer())
    return before


def test_train_run_writes_the_jax_runs_spans_and_prometheus_file(tmp_path):
    """ROADMAP C.4: the port's run_experiment attaches a JsonlSink on
    metrics.jsonl and writes metrics.prom at the end, as JAX's does."""
    before = _fresh_tracer(j_trace)
    try:
        j_run(j_overrides(j_preset("transformer_nmt_wmt"),
                          [f"workdir={tmp_path / 'jax'}", *TINY_NMT]))
    finally:
        j_trace.configured(before)
    before = _fresh_tracer(t_trace)
    try:
        run_experiment(apply_overrides(get_preset("transformer_nmt_wmt"),
                                       [f"workdir={tmp_path / 'port'}",
                                        *TINY_NMT]), device="cpu")
    finally:
        t_trace.configured(before)

    jdir = tmp_path / "jax" / "transformer_nmt_wmt"
    tdir = tmp_path / "port" / "transformer_nmt_wmt"
    jspans = _span_keys(jdir / "metrics.jsonl")
    tspans = _span_keys(tdir / "metrics.jsonl")
    assert {"train.dispatch", "train.realize", "ckpt.save"} <= set(jspans)
    assert tspans == jspans
    assert (tdir / "metrics.prom").exists()
    assert _prom_instruments(tdir / "metrics.prom") == \
        _prom_instruments(jdir / "metrics.prom")


# -- every obs function on the JAX-made fixtures ------------------------------

RUNS = {"train": os.path.join(FIXTURES, "train"),
        "serve": os.path.join(FIXTURES, "serve", "metrics.jsonl"),
        "breach": os.path.join(FIXTURES, "breach", "metrics.jsonl")}
FLEET = os.path.join(FIXTURES, "fleet")
RULES = os.path.join(FIXTURES, "rules.json")


def _obs(pkg, module):
    return importlib.import_module(f"{pkg}.obs.{module}")


def _read_json(path):
    with open(path) as fh:
        return json.load(fh)


def _summarize(pkg, tmp_path):
    report = _obs(pkg, "report")
    out = {}
    for name, path in RUNS.items():
        s = report.summarize(path)
        out[name] = (s, report.render_report(s))
    s = report.summarize(RUNS["train"], since_step=3)
    out["since_step"] = (s, report.render_report(s))
    fleet = report.summarize_fleet(FLEET)
    out["fleet"] = (fleet, report.render_fleet_report(fleet),
                    report.fleet_status_line(fleet))
    return out


def _check_run(pkg, tmp_path):
    slo = _obs(pkg, "slo")
    return {name: slo.check_run(path, RULES) for name, path in RUNS.items()}


def _build_trace(pkg, tmp_path):
    export = _obs(pkg, "export")
    report = _obs(pkg, "report")
    out = {}
    for name, path in RUNS.items():
        records, _, _ = report.collect(path)
        trace = export.build_trace(records)
        dest = str(tmp_path / f"{name}.json")
        summary = export.export_trace(path, dest)
        summary.pop("out")
        out[name] = (trace, export.validate_trace(trace), summary,
                     _read_json(dest))
    return out


def _export_fleet_trace(pkg, tmp_path):
    export = _obs(pkg, "export")
    dest = str(tmp_path / "fleet.json")
    summary = export.export_fleet_trace(FLEET, dest)
    summary.pop("out")
    trace = _read_json(dest)
    return summary, trace, export.validate_trace(trace)


def _diff_runs(pkg, tmp_path):
    diff = _obs(pkg, "diff")
    out = {}
    for a, b in (("train", "train"), ("train", "breach"),
                 ("breach", "train"), ("serve", "serve")):
        report = diff.diff_runs(RUNS[a], RUNS[b], tolerance=0.05)
        out[f"{a}-{b}"] = (report, diff.render_diff(report))
    return out


def _tail_fold(pkg, tmp_path):
    """TailState folded record by record (the status line after each), and
    tail --once over a run and over the fleet root."""
    tail = _obs(pkg, "tail")
    report = _obs(pkg, "report")
    out = {}
    for name, path in RUNS.items():
        state = tail.TailState()
        lines = []
        for rec in report.collect(path)[0]:
            state.update(rec)
            lines.append(state.status_line())
        buf = io.StringIO()
        rc = tail.tail(path, once=True, out=buf)
        out[name] = (lines, rc, buf.getvalue())
    buf = io.StringIO()
    rc = tail.tail(FLEET, once=True, fleet=True, out=buf)
    out["fleet"] = (rc, buf.getvalue())
    return out


def _signal_bus(pkg, tmp_path):
    """SignalBus over the fleet fixture's replica streams in record order,
    with a snapshot after each record; a RollingWindow over one series."""
    signals = _obs(pkg, "signals")
    report = _obs(pkg, "report")
    dirs = report.fleet_replica_dirs(FLEET)
    bus = signals.SignalBus(names=[name for name, _ in dirs])
    snaps = []
    for name, path in dirs:
        for rec in report.collect(path)[0]:
            bus.observe(name, rec)
            snaps.append(bus.snapshot())
    window = signals.RollingWindow(window_s=2.0)
    for rec in report.collect(RUNS["serve"])[0]:
        if "serve_tokens_per_sec" in rec and "ts" in rec:
            window.add(rec["ts"], rec["serve_tokens_per_sec"])
    return snaps, bus.fleet(), window.snapshot()


def _render_prometheus(pkg, tmp_path):
    """One registry, the same operations, rendered and written."""
    metrics = _obs(pkg, "metrics")
    sinks = _obs(pkg, "sinks")
    reg = metrics.MetricsRegistry()
    reg.counter("requests_total", "requests served").inc(3, route="a")
    reg.counter("requests_total").inc(route='b"q\\n')
    reg.gauge("queue_depth", "queued requests").set(7)
    hist = reg.histogram("latency_s", "request latency",
                         buckets=metrics.exponential_buckets(0.001, 2.0, 6))
    for i, v in enumerate((0.0005, 0.003, 0.02, 0.02, 1.5, 99.0)):
        hist.observe(v, phase="decode" if i % 2 else "prefill")
    text = sinks.render_prometheus(reg)
    dest = str(tmp_path / "metrics.prom")
    assert sinks.write_prometheus(reg, dest) == text
    with open(dest) as fh:
        return text, fh.read()


OBS_CASES = {
    "summarize+render_report": _summarize,
    "check_run": _check_run,
    "build_trace+validate_trace": _build_trace,
    "export_fleet_trace": _export_fleet_trace,
    "diff_runs": _diff_runs,
    "TailState": _tail_fold,
    "SignalBus+RollingWindow": _signal_bus,
    "render_prometheus": _render_prometheus,
}


@pytest.mark.parametrize("case", sorted(OBS_CASES))
def test_obs_function_equals_jax(case, tmp_path):
    fn = OBS_CASES[case]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = fn("deeplearning_cfn_tpu", tmp_path / "jax")
    got = fn("deeplearning_cfn_tpu_torch", tmp_path / "port")
    assert got == want
