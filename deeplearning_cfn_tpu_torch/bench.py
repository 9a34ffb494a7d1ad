"""In-package benchmark harness: step-time/throughput for any preset.

The port of the JAX package's ``bench.py``, with the JAX record's keys.
``cli bench --preset P`` runs it over every card of the host, one process
per card (``--processes N`` sets the count; ``cli/main.py``), as the JAX
harness runs one process over every local device; in each process
:func:`run_bench` trains on a ``data``-only mesh over the job's processes
(one process: the whole mesh 1, on one card or the CPU when the caller
asks for it). ``python -m deeplearning_cfn_tpu_torch.bench`` runs one
process. Where the JAX harness reads the step's FLOPs from XLA's cost
analysis of the compiled step, the port counts them from the model's
shapes: 3 × the model's own ``forward_flops`` per example
(``mfu_source: "forward_flops_x3"``).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, Optional, Union

_T0 = time.monotonic()


def stage(name: str, **info) -> None:
    """Emit a stage-timestamped marker to stderr. The wrapper (root
    bench.py) parses the LAST marker out of a timed-out child's stderr, so
    a hang is localized to the exact phase (import? device? first step?)
    instead of reading as a bare 'timeout'."""
    extra = "".join(f" {k}={v}" for k, v in info.items())
    print(f"[bench-stage] t=+{time.monotonic() - _T0:.1f}s {name}{extra}",
          file=sys.stderr, flush=True)

# External context anchor (BASELINE.md): TF+Horovod ResNet-50 on V100, the
# stack the reference's flagship workload ran on (~375 img/s/GPU, Horovod
# paper arXiv:1802.05799). The reference itself publishes no numbers.
HOROVOD_V100_IMG_PER_SEC_PER_GPU = 375.0

# Presets whose parallelism strategy needs a >1 mesh axis to engage: on a
# single card they run a DENSE fallback, and the number must say so (a
# fallback number must never read as a ring measurement).
_SEQ_PARALLEL_PRESETS = {"bert_long_wikipedia", "gpt_long_lm"}

_UNITS = {
    "cifar10_resnet20": "images/sec/chip",
    "imagenet_resnet50": "images/sec/chip",
    "maskrcnn_coco": "images/sec/chip",
    "bert_base_wikipedia": "sequences/sec/chip",
    "transformer_nmt_wmt": "sequences/sec/chip",
    "bert_moe_wikipedia": "sequences/sec/chip",
    "bert_pipelined_wikipedia": "sequences/sec/chip",
    "bert_long_wikipedia": "sequences/sec/chip",
    "gpt_small_lm": "sequences/sec/chip",
    "gpt_long_lm": "sequences/sec/chip",
    "imagenet_vit_s16": "images/sec/chip",
}

# The bench's batch per card when the caller names none: the JAX bench's
# per-chip batches, kept so that the two harnesses' records line up.
_PER_CHIP_BATCH = {
    "imagenet_resnet50": 512, "cifar10_resnet20": 512,
    "bert_base_wikipedia": 32, "transformer_nmt_wmt": 64,
    "maskrcnn_coco": 4, "bert_long_wikipedia": 8, "gpt_small_lm": 16,
    "gpt_long_lm": 1, "imagenet_vit_s16": 256,
}

# Peak dense bf16 FLOPs/sec per card, keyed by a substring of
# ``torch.cuda.get_device_name()`` (NVIDIA's data sheet, without sparsity;
# the figure the kernels' bounds use).
_PEAK_FLOPS_BF16 = (
    ("h100 80gb hbm3", 989e12),   # the SXM part
)


def peak_flops_per_chip(device) -> Optional[float]:
    """Peak bf16 FLOPs/sec of the card ``device`` is on, or None if
    unknown (an unlisted card, or the CPU)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    kind = torch.cuda.get_device_name(device).lower()
    for key, peak in _PEAK_FLOPS_BF16:
        if key in kind:
            return peak
    return None


def device_kind(device) -> str:
    """The record's ``device_kind``: the card's name, or ``"cpu"``."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def example_flops(cfg, task, batch) -> int:
    """Forward FLOPs (2 per multiply-add) of one example of ``batch``, from
    the model's own ``forward_flops`` at the batch's shapes."""
    import importlib

    model = task.model
    mod = importlib.import_module(type(model).__module__)
    kind = mod.__name__.rsplit(".", 1)[-1]
    if kind == "resnet":
        return mod.forward_flops(model, cfg.data.image_size)
    if kind == "vit":
        return mod.forward_flops(model)
    if kind == "maskrcnn":
        # The box head runs on the proposals plus the padded ground truth.
        return mod.forward_flops(model, cfg.data.image_size,
                                 task.post_nms_topk + cfg.data.max_boxes,
                                 task.num_mask_rois)
    if kind in ("bert", "bert_long", "pipelined"):
        return mod.forward_flops(model, batch["input_ids"].shape[1],
                                 batch["mlm_positions"].shape[1])
    if kind == "lm":
        return mod.forward_flops(model, batch["tokens"].shape[1] - 1)
    if kind == "transformer_nmt":
        return mod.forward_flops(model, batch["src_ids"].shape[1],
                                 batch["tgt_in_ids"].shape[1])
    raise ValueError(f"no forward_flops for the model of {cfg.preset!r} "
                     f"({mod.__name__})")


def annotate_record(record: Dict, preset: str, mesh_shape: Dict[str, int],
                    gb: int, preset_gb: int) -> Dict:
    """Fallback/underfill labels: a number measured in a degraded
    configuration must say so in the artifact itself."""
    if preset in _SEQ_PARALLEL_PRESETS:
        seq_ways = int(mesh_shape.get("seq", 1))
        record["fallback"] = seq_ways == 1
        if seq_ways == 1:
            record["fallback_note"] = (
                "dense-attention fallback (mesh seq=1): NOT a ring/Ulysses "
                "sequence-parallel measurement")
    if gb < preset_gb:
        record["batch_underfilled"] = True
        record["preset_global_batch"] = preset_gb
    return record


def _sync(metrics) -> float:
    """The one host read that ends a timed loop: the last step's loss,
    which depends on every step before it (the state chains through)."""
    return float(metrics["loss"].reshape(-1)[-1])


class _Bench:
    """One preset's task, trainer, state and first device batch on
    synthetic data, on this process's device over the job's processes —
    what both harnesses below time.

    The batch is ``global_batch`` when given (accumulation off: an
    explicit batch is a step-time probe, and it need not divide a
    preset's factor); else with one process ``default_batch``, a per-card
    batch (accumulation off), and with several the preset's global batch,
    with its accumulation when ``keep_accum`` — the JAX harness's rule. With
    several processes the mesh is ``data`` over all of them, as the JAX
    harness's ``MeshConfig(data=-1)``."""

    def __init__(self, preset: str, global_batch: int, accelerator,
                 default_batch: int, schedule_steps: int,
                 keep_accum: bool = False):
        import torch

        from .config import MeshConfig, apply_overrides
        from .data.pipeline import to_device
        from .parallel.mesh import build_mesh, process_count
        from .presets import get_preset
        from .runtime.platform import resolve_device
        from .train.optim import build_optimizer, build_schedule
        from .train.state import create_train_state
        from .train.task import build_task
        from .train.trainer import Trainer

        stage("backend_init")
        self.dev = dev = resolve_device(accelerator)
        n = process_count()
        stage("devices_ok", n=n, kind=device_kind(dev))
        self.cfg = cfg = get_preset(preset)
        if global_batch or n == 1:
            cfg.train.global_batch = global_batch or default_batch
            cfg.train.grad_accum_steps = 1
        elif not keep_accum:
            cfg.train.grad_accum_steps = 1
        if n > 1:
            cfg.mesh = MeshConfig(data=-1)
        apply_overrides(cfg, ["data.prefetch=0", "data.synthetic=true"])
        # One batch is all the bench consumes — don't materialize the
        # default synthetic dataset.
        cfg.data.num_train_examples = cfg.train.global_batch
        cfg.data.num_eval_examples = cfg.train.global_batch
        self.mesh = build_mesh(cfg.mesh)
        self.gb = gb = cfg.train.global_batch

        self.task = build_task(cfg, dev, mesh=self.mesh)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        self.task.init(gen)
        optimizer = build_optimizer(
            cfg.optimizer, build_schedule(cfg.schedule, schedule_steps, gb,
                                          100),
            self.task.model, shard_opt_state=cfg.train.shard_opt_state)
        self.state = create_train_state(self.task.model, optimizer,
                                        ema=cfg.train.ema_decay > 0)
        self.trainer = Trainer(cfg, self.task, dev, self.mesh)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        stage("build", preset=preset, global_batch=gb)
        self.host_batch = next(iter(self.pipeline(0).one_epoch(0)))
        self.to_device = lambda b: to_device(b, dev)
        self.dev_batch = self.to_device(self.host_batch)

    def pipeline(self, seed: int):
        """This process's pipeline: its share of each global batch."""
        from .data.pipeline import build_pipeline
        from .parallel.mesh import local_batch_size

        return build_pipeline(self.cfg.data,
                              local_batch_size(self.gb, self.mesh),
                              self.cfg.model.num_classes, seed=seed,
                              train=True)

    def timed(self, loop) -> float:
        """Seconds of ``loop()`` (which ends with a host read of its last
        step) on the slowest process: every process enters it after a
        barrier, and their times are reduced with MAX."""
        if self.mesh.process_count == 1:
            t0 = time.perf_counter()
            loop()
            return time.perf_counter() - t0
        import torch.distributed as dist

        from .parallel.collectives import all_gather_objects

        dist.barrier()
        t0 = time.perf_counter()
        loop()
        return max(all_gather_objects(time.perf_counter() - t0))


def run_bench(
    preset: str = "imagenet_resnet50",
    steps: int = 20,
    global_batch: int = 0,
    warmup: int = 4,
    include_input: bool = False,
    step_window: int = 1,
    accelerator: Union[str, object] = "gpu",
) -> Dict:
    """Run ``steps`` timed train steps of ``preset`` on synthetic data and
    return the one-line JSON record the driver expects, on the device
    ``accelerator`` names (``gpu``, the default, raises without a card).

    The headline number reuses one device-resident batch — pure step
    throughput, no host input in the timed path. ``include_input=True``
    additionally times a loop that pulls a fresh batch from the host
    pipeline (+ the host-to-device copy) every step and reports it as
    ``value_with_input``.

    ``step_window`` > 1 benches the windowed step instead
    (``Trainer.window_step``, K steps per call: on the card each step a
    CUDA graph replay, as ``cli train`` runs ``train.step_window=K``); the
    record says which was measured (``step_window``). ``compile_s`` is the
    first step's (the first window's, with its capture) time: the kernels'
    loads and the libraries' plans.

    Over several processes (a process group set up by
    ``runtime.cluster.initialize``, as ``cli bench`` does) each trains its
    share of the global batch on a ``data`` mesh over all of them, the JAX
    harness's ``mesh`` over every local device: ``n_chips`` is the count,
    ``mean_step_s`` the slowest process's, ``value`` per card, the MFU of
    one card's share of the FLOPs, the memory keys this process's card's;
    a window replays its graphs under NCCL and runs eagerly over gloo
    (``runtime.cluster.windows_replay``). Every process returns the
    record."""
    if step_window < 1:
        raise ValueError(f"step_window must be >= 1, got {step_window}")
    stage("import_torch")
    import torch

    from .presets import get_preset

    b = _Bench(preset, global_batch, accelerator,
               _PER_CHIP_BATCH.get(preset, 64), max(steps * 10, 1000),
               keep_accum=True)
    cfg, dev, mesh, gb, task = b.cfg, b.dev, b.mesh, b.gb, b.task
    trainer, state, dev_batch = b.trainer, b.state, b.dev_batch
    cfg.train.step_window = step_window
    n_chips = mesh.process_count

    # step_window > 1 runs K steps per call, each fed the same device
    # batch (a replayed step copies it into the graph's static inputs).
    k = step_window
    if k > 1:
        def dispatch(batch):
            return trainer.window_step(state, (batch,) * k)
    else:
        def dispatch(batch):
            return trainer.train_step(state, batch)

    stage("first_compile", step_window=k)
    t_c = time.perf_counter()
    _sync(dispatch(dev_batch))
    compile_s = time.perf_counter() - t_c

    stage("warmup", n=max(warmup, 1))
    for _ in range(max(warmup, 1)):
        m = dispatch(dev_batch)
    _sync(m)
    n_windows = max(1, steps // k)
    stage("timed", steps=n_windows * k)

    # Timed block: every step back-to-back with NO per-step sync —
    # steady-state pipelined throughput — then one trailing sync on a
    # scalar that depends on every step.
    def loop():
        for _ in range(n_windows):
            m = dispatch(dev_batch)
        _sync(m)

    mean_step_s = b.timed(loop) / (n_windows * k)

    # MFU: 3 × the model's forward FLOPs per example (forward + the
    # backward's two products) over one card's share of the batch, against
    # one card's peak bf16 rate. 0.0 when the peak is unknown (the CPU, an
    # unlisted card).
    flops = 3 * example_flops(cfg, task, b.host_batch) * gb / n_chips
    mfu_source = "forward_flops_x3"
    peak = peak_flops_per_chip(dev)
    mfu = flops / (mean_step_s * peak) if flops and peak else 0.0

    per_chip = gb / mean_step_s / n_chips
    unit = _UNITS.get(preset, "items/sec/chip")
    record = {
        "metric": f"{preset}_train_{unit.split('/')[0]}_per_sec_per_chip",
        "value": round(per_chip, 2),
        "unit": unit,
        # The V100 anchor is a ResNet-50/ImageNet number — a ratio against
        # it is only meaningful for that preset.
        "vs_baseline": round(per_chip / HOROVOD_V100_IMG_PER_SEC_PER_GPU, 3)
        if preset == "imagenet_resnet50" else 0.0,
        "mfu": round(mfu, 4),
        "steps": n_windows * k,
        "step_window": k,
        "steps_per_sec": round(1.0 / mean_step_s, 3),
        "compile_s": round(compile_s, 2),
        "global_batch": gb,
        "n_chips": n_chips,
        "mean_step_s": round(mean_step_s, 5),
        "device_kind": device_kind(dev),
        # The mesh the step ran on: data over the processes, every other
        # axis 1 — in particular bert_long then runs its DENSE attention,
        # not ring/Ulysses (those need a seq axis > 1).
        "mesh": {a: int(v) for a, v in mesh.shape.items()},
        "mfu_source": mfu_source,
        "measured": True,
    }
    annotate_record(record, preset, dict(mesh.shape), gb,
                    get_preset(preset).train.global_batch)
    # Card memory after the run (absent on the CPU), this process's card
    # (the JAX harness reads its first local device): the peak is the
    # batch-headroom number.
    if dev.type == "cuda":
        gib = 2 ** 30
        record["hbm_gib_peak"] = round(
            torch.cuda.max_memory_allocated(dev) / gib, 2)
        record["hbm_gib_in_use"] = round(
            torch.cuda.memory_allocated(dev) / gib, 2)
        record["hbm_gib_limit"] = round(
            torch.cuda.mem_get_info(dev)[1] / gib, 2)

    if include_input:
        stage("timed_with_input", steps=steps)
        # A few distinct host batches (bounded memory) cycled through the
        # real pipeline path: host batch → device copy → step, with the
        # preset's host prefetch depth.
        cfg.data.num_train_examples = 2 * gb
        cfg.data.prefetch = get_preset(preset).data.prefetch or 2
        it = b.pipeline(1).epochs()

        def feed():
            return b.to_device(next(it))

        if k > 1:
            def step_fed():
                return trainer.window_step(state,
                                           tuple(feed() for _ in range(k)))
        else:
            def step_fed():
                return trainer.train_step(state, feed())
        def fed_loop():
            for _ in range(n_windows):
                m = step_fed()
            _sync(m)

        try:
            _sync(step_fed())
            step_s = b.timed(fed_loop) / (n_windows * k)
        finally:
            it.close()  # stop the prefetch worker, release its buffers
        record["value_with_input"] = round(gb / step_s / n_chips, 2)
        record["mean_step_s_with_input"] = round(step_s, 5)

    stage("done", value=record["value"])
    return record


def run_obs_overhead_smoke(
    preset: str = "transformer_nmt_wmt",
    steps: int = 30,
    warmup: int = 5,
    global_batch: int = 0,
    accelerator: Union[str, object] = "gpu",
) -> Dict:
    """Measure the obs span tracer's per-step cost: the SAME step, once
    with spans disabled (``DLCFN_OBS_OFF``-equivalent) and once fully
    instrumented (span + sink write per step — the train loop's worst
    case). The record reports ``overhead_pct``, and proves the Perfetto
    export of the instrumented loop's spans (``trace_valid``). Over
    several processes it runs as :func:`run_bench` does (the preset's
    global batch by default, each loop's time the slowest process's)."""
    stage("import_torch")
    import os
    import tempfile

    from .obs.export import build_trace, validate_trace
    from .obs.sinks import MemorySink
    from .obs.trace import Tracer, configured, set_enabled, span

    b = _Bench(preset, global_batch, accelerator, 64, 1000)
    trainer, state, dev_batch = b.trainer, b.state, b.dev_batch
    stage("first_compile")
    _sync(trainer.train_step(state, dev_batch))

    def loop():
        for i in range(steps):
            with span("train.dispatch", step=i, k=1):
                m = trainer.train_step(state, dev_batch)
        _sync(m)

    def timed_loop(enabled: bool) -> float:
        set_enabled(enabled)
        try:
            for _ in range(max(warmup, 1)):
                m = trainer.train_step(state, dev_batch)
            _sync(m)
            return b.timed(loop) / steps
        finally:
            set_enabled(None)

    # A dedicated tracer with a live sink so the "on" loop pays the FULL
    # instrumented cost (id alloc, record build, sink write) — then the
    # process default is restored.
    tracer = Tracer()
    sink = MemorySink()
    tracer.add_sink(sink)
    configured(tracer)
    try:
        stage("timed_obs_off", steps=steps)
        off_s = timed_loop(False)
        stage("timed_obs_on", steps=steps)
        on_s = timed_loop(True)
    finally:
        configured(None)

    overhead_pct = (on_s - off_s) / off_s * 100.0
    record = {
        "metric": f"{preset}_obs_overhead_pct",
        "value": round(overhead_pct, 3),
        "unit": "percent",
        "obs_off_step_s": round(off_s, 6),
        "obs_on_step_s": round(on_s, 6),
        "steps": steps,
        "global_batch": b.gb,
        "preset": preset,
        "device_kind": device_kind(b.dev),
        "measured": True,
    }
    # The spans the instrumented loop just emitted must round-trip
    # through the Perfetto exporter into structurally valid trace-event
    # JSON (parse + nesting check, nothing rendered).
    stage("trace_export", spans=len(sink.records))
    trace = build_trace(sink.records)
    problems = validate_trace(trace)
    trace_path = os.path.join(
        tempfile.mkdtemp(prefix="dlcfn_obs_smoke_"), "trace.json")
    with open(trace_path, "w") as fh:
        json.dump(trace, fh)
    with open(trace_path) as fh:
        reparsed = json.load(fh)
    trace_valid = (not problems
                   and isinstance(reparsed.get("traceEvents"), list)
                   and len(reparsed["traceEvents"]) > 0)
    record["trace_json_path"] = trace_path
    record["trace_events"] = len(trace["traceEvents"])
    record["trace_valid"] = trace_valid
    if problems:
        record["trace_problems"] = problems[:5]
    stage("done", overhead_pct=record["value"])
    return record


def main(argv=None) -> None:
    """Child-process entry for a driver bench: run one preset and print
    the contract JSON line."""
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--preset", default="imagenet_resnet50")
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--global-batch", type=int, default=0)
    parser.add_argument("--with-input", action="store_true",
                        help="also time steps with the host input pipeline "
                             "in the loop (value_with_input)")
    parser.add_argument("--step-window", type=int, default=1,
                        help="K steps per call (each a CUDA graph replay "
                             "on the card, as train.step_window=K)")
    parser.add_argument("--obs-smoke", action="store_true",
                        help="measure obs span overhead (instrumented vs "
                             "disabled step time) instead of throughput")
    parser.add_argument("--accelerator", default="gpu",
                        choices=["gpu", "cpu"],
                        help="the device (gpu: the CUDA card, raising "
                             "without one)")
    args = parser.parse_args(argv)
    stage("start", preset=args.preset)
    if args.obs_smoke:
        record = run_obs_overhead_smoke(
            preset=args.preset, steps=args.steps, warmup=args.warmup,
            global_batch=args.global_batch, accelerator=args.accelerator)
    else:
        record = run_bench(preset=args.preset, steps=args.steps,
                           warmup=args.warmup,
                           global_batch=args.global_batch,
                           include_input=args.with_input,
                           step_window=args.step_window,
                           accelerator=args.accelerator)
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
