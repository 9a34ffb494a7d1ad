"""The port's benches (``bench.py``, ``opsbench.py``, ``serve/bench.py``) and
the ``bench`` verb's guards against the JAX package's, on the CPU.

- serve bench: ``_fixed_trace`` equal; with the JAX bench's tiny weights
  carried across, ``run_serve_bench(smoke=True)`` (plain, ``speculate=2``,
  ``quantize`` + ``kv_quant`` int8) has JAX's key set and JAX's
  deterministic fields (steps, admissions, prefix hits, encoder calls,
  token identity, the divergences' verdicts; JAX's int8 run, 16–34 s, is
  not made). Tolerance: equal.
- ``run_bench`` and ``run_obs_overhead_smoke`` at ``cifar10_resnet20``,
  batch 8, 2 steps, K = 1 and 2: JAX's key set, metric, unit, batch, steps,
  window and mesh axes, ``mfu == 0.0`` (no peak on the CPU), a valid
  trace.
- every model's ``forward_flops`` that ``run_bench`` uses, against
  ``torch.utils.flop_counter.FlopCounterMode`` over the plain path's
  forward at tiny widths: equal, less the masked-out half of the causal
  products, which the causal counts leave out (the plain path computes
  them and masks them away).
- opsbench: ``timed_scalar`` orders work by cost, and each suite emits
  JAX's op names. JAX's ``suite_resnet`` costs ~85 s on the CPU
  (``tests/test_opsbench.py``), so the names are read from the JAX
  functions' source, and JAX's own smoke pins are checked on the port.
- ``cli bench``: each guard's rc and message equal JAX's ``main()``'s.
"""

import importlib
import inspect
import json
import os
import re
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from deeplearning_cfn_tpu import bench as jax_bench
from deeplearning_cfn_tpu import opsbench as jax_opsbench
from deeplearning_cfn_tpu.serve import bench as jax_serve_bench
from deeplearning_cfn_tpu_torch import bench, opsbench
from deeplearning_cfn_tpu_torch.serve import bench as serve_bench
from torch_tiny_nmt import bench_model_from_jax

jax_cli = importlib.import_module("deeplearning_cfn_tpu.cli.main")
cli = importlib.import_module("deeplearning_cfn_tpu_torch.cli.main")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One worker's share of the cores (torch would start a thread per core
    in every pytest-xdist worker)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


# -- serve bench ---------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(num_requests=6, src_len=12, vocab_size=96, seed=0),
    dict(num_requests=8, src_len=8, vocab_size=96, seed=3, prefix_dup=0.5),
])
def test_fixed_trace_equals_jax(kw):
    assert serve_bench._fixed_trace(**kw) == jax_serve_bench._fixed_trace(**kw)


SERVE_DETERMINISTIC = ("engine_steps", "decode_steps", "admitted",
                       "prefix_hit_rate", "encoder_invocations",
                       "token_identical", "divergence_ok",
                       "kv_divergence_ok", "requests", "slots",
                       "max_new_tokens", "decode_window", "kv_block_size",
                       "kv_blocks", "spec_gamma", "quantize", "kv_quant",
                       "metric", "unit", "smoke")


@pytest.fixture(scope="module")
def jax_serve_plain():
    return jax_serve_bench.run_serve_bench(smoke=True)


@pytest.mark.parametrize("kw", [
    {}, {"speculate": 2}, {"quantize": "int8", "kv_quant": "int8"}],
    ids=["plain", "speculate", "int8"])
def test_serve_bench_smoke_equals_jax(kw, monkeypatch, jax_serve_plain):
    """JAX's int8 smoke costs 16–34 s on the CPU (its divergence checks run
    Flax eagerly), so that case is held to JAX's plain record with the four
    fields int8 changes set as JAX's own int8 record sets them (the same
    steps and admissions; both divergences within their bound, as
    tests/test_serve.py pins)."""
    if kw.get("quantize"):
        ref = dict(jax_serve_plain, quantize="int8", kv_quant="int8",
                   divergence_ok=True, kv_divergence_ok=True)
    elif kw:
        ref = jax_serve_bench.run_serve_bench(smoke=True, **kw)
    else:
        ref = jax_serve_plain
    bench_model_from_jax(monkeypatch)
    got = serve_bench.run_serve_bench(smoke=True, accelerator="cpu", **kw)
    assert set(got) == set(ref)
    for key in SERVE_DETERMINISTIC:
        assert got[key] == ref[key], key
    assert got["device"] == ref["device"] == "cpu"
    assert got["value"] > 0
    if kw.get("speculate"):
        assert got["token_identical"] is True
        assert got["tokens_per_target_step"] > 1.0
    if kw.get("quantize"):
        assert got["weight_bytes"] <= 0.35 * got["weight_bytes_fp32"]
        assert got["kv_cache_bytes"] <= 0.30 * got["kv_cache_bytes_fp32"]
        assert got["divergence_ok"] and got["kv_divergence_ok"]


# -- run_bench and run_obs_overhead_smoke --------------------------------------

BENCH_KW = dict(preset="cifar10_resnet20", steps=2, global_batch=8,
                warmup=1)


@pytest.fixture(scope="module")
def jax_record():
    return jax_bench.run_bench(step_window=1, **BENCH_KW)


@pytest.mark.parametrize("window", [1, 2])
def test_run_bench_record_equals_jax(window, jax_record):
    """JAX's K = 2 record costs ~30 s on the CPU (its scan compile), so both
    windows are held to JAX's K = 1 record: the same keys and values, but
    the window itself (``steps`` = 2 both ways: one window of 2)."""
    ref = dict(jax_record, step_window=window)
    got = bench.run_bench(step_window=window, accelerator="cpu",
                          **BENCH_KW)
    assert set(got) == set(ref)
    for key in ("metric", "unit", "global_batch", "steps", "step_window",
                "mfu", "vs_baseline", "measured", "batch_underfilled",
                "preset_global_batch"):
        assert got[key] == ref[key], key
    # The port's bench runs one process (JAX's, every local device: the
    # tests' 8 CPU devices): the same axes, each 1.
    assert got["mesh"] == dict.fromkeys(ref["mesh"], 1)
    assert got["n_chips"] == 1
    assert got["mfu"] == 0.0
    assert got["mfu_source"] == "forward_flops_x3"
    assert got["device_kind"] == "cpu"
    assert got["value"] > 0 and got["mean_step_s"] > 0
    assert json.dumps(got)


def test_run_bench_with_input_and_obs_smoke_equal_jax():
    got = bench.run_bench(include_input=True, accelerator="cpu", **BENCH_KW)
    assert got["value_with_input"] > 0
    assert got["mean_step_s_with_input"] > 0
    kw = dict(preset="cifar10_resnet20", steps=2, warmup=1, global_batch=8)
    ref = jax_bench.run_obs_overhead_smoke(**kw)
    got = bench.run_obs_overhead_smoke(accelerator="cpu", **kw)
    assert set(got) == set(ref)
    for key in ("metric", "unit", "steps", "global_batch", "preset",
                "measured", "trace_valid", "trace_events"):
        assert got[key] == ref[key], key
    assert got["trace_valid"] is True


def test_bench_helpers():
    assert bench.peak_flops_per_chip(CPU) is None
    assert bench.device_kind(CPU) == "cpu"
    assert bench._UNITS == jax_bench._UNITS
    assert bench.HOROVOD_V100_IMG_PER_SEC_PER_GPU == \
        jax_bench.HOROVOD_V100_IMG_PER_SEC_PER_GPU
    for preset, shape, gb, pgb in [
            ("gpt_long_lm", {"seq": 1}, 1, 8),
            ("bert_long_wikipedia", {"seq": 2}, 64, 64),
            ("imagenet_resnet50", {}, 512, 8192)]:
        assert bench.annotate_record({}, preset, shape, gb, pgb) == \
            jax_bench.annotate_record({}, preset, shape, gb, pgb)
    with pytest.raises(ValueError, match="step_window"):
        bench.run_bench(step_window=0, accelerator="cpu")


# -- forward_flops against FlopCounterMode -------------------------------------

_TINY_BERT = ["model.kwargs.hidden_size=32", "model.kwargs.num_layers=2",
              "model.kwargs.num_heads=2", "model.kwargs.mlp_dim=64",
              "data.vocab_size=64", "data.seq_len=16"]
FLOPS_CASES = {
    "cifar10_resnet20": [],
    "imagenet_resnet50": ["data.image_size=32", "model.num_classes=10"],
    "transformer_nmt_wmt": _TINY_BERT,
    "bert_base_wikipedia": ["model.name=bert_tiny"] + _TINY_BERT,
    "bert_moe_wikipedia": ["model.name=bert_tiny",
                           "model.kwargs.num_experts=4"] + _TINY_BERT,
    "bert_pipelined_wikipedia": _TINY_BERT,
    "bert_long_wikipedia": _TINY_BERT,
    "gpt_small_lm": ["model.name=gpt_tiny",
                     'model.kwargs={"vocab_size":64,"max_len":32}',
                     "data.vocab_size=64", "data.seq_len=16"],
    "gpt_long_lm": _TINY_BERT + ["model.kwargs.max_len=32"],
    "imagenet_vit_s16": ["model.name=vit_tiny", "model.num_classes=10",
                         "data.image_size=16"],
    "maskrcnn_coco": ["model.num_classes=7", "model.kwargs.image_size=64",
                      "model.kwargs.pre_nms_topk=64",
                      "model.kwargs.post_nms_topk=16",
                      "model.kwargs.num_mask_rois=4",
                      "model.kwargs.anchor_scale=4.0", "data.image_size=64",
                      "data.max_boxes=4"],
}


def _masked_causal_flops(model, q_len: int) -> int:
    """QKᵀ and PV over the (query, key) pairs the causal mask drops, which
    the causal counts leave out: 2 products × 2 FLOPs × H per pair."""
    n = q_len * (q_len - 1) // 2
    return model.num_layers * 2 * 2 * n * model.hidden_size


@pytest.mark.parametrize("preset", sorted(FLOPS_CASES))
def test_forward_flops_against_flop_counter(preset):
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.data.pipeline import (build_pipeline,
                                                          to_device)
    from deeplearning_cfn_tpu_torch.presets import get_preset
    from deeplearning_cfn_tpu_torch.train.task import build_task

    cfg = get_preset(preset)
    apply_overrides(cfg, FLOPS_CASES[preset] + [
        "train.dtype=float32", "data.synthetic=true", "data.prefetch=0",
        "train.global_batch=2", "data.num_train_examples=2",
        "data.num_eval_examples=2", "train.grad_accum_steps=1"])
    task = build_task(cfg, CPU)
    gen = torch.Generator()
    gen.manual_seed(0)
    task.init(gen)
    host = next(iter(build_pipeline(cfg.data, 2, cfg.model.num_classes,
                                    seed=0, train=True).one_epoch(0)))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        task.loss_fn(to_device(host, CPU), False)
    left_out = 0
    model = task.model
    if preset == "transformer_nmt_wmt":
        left_out = _masked_causal_flops(model, host["tgt_in_ids"].shape[1])
    elif preset in ("gpt_small_lm", "gpt_long_lm"):
        left_out = _masked_causal_flops(model, host["tokens"].shape[1] - 1)
    counted = bench.example_flops(cfg, task, host)
    assert counted > 0
    assert counter.get_total_flops() == 2 * (counted + left_out)


# -- opsbench ------------------------------------------------------------------


def test_timed_scalar_orders_by_cost():
    small, big = torch.ones(64, 64), torch.ones(512, 512)

    def f_small(x, tok):
        return ((x + tok) @ x).sum() * 1e-9

    def f_big(x, tok):
        y = x + tok
        for _ in range(50):
            y = y @ x * 1e-3
        return y.sum() * 1e-9

    ms_small = opsbench.timed_scalar(f_small, small, steps=3, warmup=1)
    ms_big = opsbench.timed_scalar(f_big, big, steps=3, warmup=1)
    assert 0.0 < ms_small < ms_big


def _op_names(fn):
    """The op names a JAX suite emits, from its source."""
    src = inspect.getsource(fn)
    return re.findall(r'(?:run|_emit)\(\s*(?:f?"([\w{}]+)")', src)


def test_suites_emit_jax_op_names(capsys, monkeypatch):
    """Each piece runs once (``timed_scalar``'s loop is held above)."""
    def once(fn, *args, steps=10, warmup=2):
        t0 = time.perf_counter()
        float(fn(*args, torch.zeros(())))
        return (time.perf_counter() - t0) * 1000.0

    monkeypatch.setattr(opsbench, "timed_scalar", once)
    res = opsbench.suite_resnet(batch=2, steps=1, image_size=32, device=CPU)
    assert set(res) == {"resnet50", "resnet50_s2d"}  # JAX's smoke pin
    assert all(v > 0 for v in res.values())
    opsbench.suite_detection(batch=1, steps=1, image_size=64, device=CPU)
    lines = [json.loads(line) for line in
             capsys.readouterr().out.splitlines()]
    names = [rec["op"] for rec in lines]
    jax_resnet = [n.replace("{name}", m) for n in
                  _op_names(jax_opsbench.suite_resnet)
                  for m in ("resnet50", "resnet50_s2d")]
    assert names == jax_resnet + _op_names(jax_opsbench.suite_detection)
    assert all(rec["ms"] >= 0 for rec in lines)


# -- cli bench's guards --------------------------------------------------------

GUARDS = [
    ["--smoke"],
    ["--trace", "burst"],
    ["--autoscale"],
    ["--radix-cache"],
    ["--chaos-plan", "plan.json"],
    ["--degrade"],
    ["--fleet", "--radix-cache", "--fleet-prefill", "1", "--fleet-decode",
     "1"],
    ["--fleet", "--prefill-chunk", "3", "--fleet-prefill", "1",
     "--fleet-decode", "1"],
    ["--net"],
    ["--fleet", "--ops", "resnet"],
    ["--fleet", "--serve"],
    ["--fleet", "--net", "--degrade"],
    ["--fleet", "--net", "--trace-mix", "tenants"],
    ["--fleet", "--autoscale"],
    ["--serve", "--ops", "resnet"],
    ["--sweep-batches", "8", "--collectives"],
    ["--sweep-batches", "8", "--global-batch", "8"],
    ["--sweep-batches", "8,x"],
    ["--sweep-batches", "8,0"],
]


@pytest.mark.parametrize("argv", GUARDS, ids=lambda a: " ".join(a))
def test_bench_guards_equal_jax(argv, capsys):
    rc_ref = jax_cli.main(["bench", *argv])
    ref = capsys.readouterr()
    rc = cli.main(["bench", *argv])
    got = capsys.readouterr()
    assert rc == rc_ref == 2
    assert got.err == ref.err and got.err.startswith("[dlcfn-tpu] ")
    assert got.out == ref.out == ""


def test_bench_parser_has_jax_flags_and_defaults():
    def flags(parser):
        sub = next(a for a in parser._actions
                   if a.__class__.__name__ == "_SubParsersAction")
        be = sub.choices["bench"]
        return {a.dest: a.default for a in be._actions if a.dest != "help"}

    ref, got = flags(jax_cli.build_parser()), flags(cli.build_parser())
    assert got.pop("accelerator") == "gpu"
    # The port's own: the processes of a bench over this host's cards.
    assert got.pop("processes") is None
    assert got == ref


def test_bench_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["bench", "--serve", "--smoke"],
                 ["bench", "--fleet", "--smoke"],
                 ["bench", "--preset", "cifar10_resnet20", "--steps", "1"]):
        with pytest.raises(RuntimeError, match="CUDA card"):
            cli.main(argv)


def test_serve_bench_fails_the_verb_on_a_broken_contract(monkeypatch,
                                                         capsys):
    """rc 1 where JAX's verb exits 1: a speculative parity break, or either
    int8 divergence past its bound."""
    for key in ("token_identical", "divergence_ok", "kv_divergence_ok"):
        monkeypatch.setattr(
            serve_bench, "run_serve_bench",
            lambda key=key, **kw: {key: False, "metric": "m"})
        assert cli.main(["bench", "--serve", "--smoke",
                         "--accelerator", "cpu"]) == 1
    assert capsys.readouterr().err.count("[dlcfn-tpu]") == 3

