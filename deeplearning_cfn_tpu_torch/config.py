"""Unified two-tier config system (a jax-free copy of the JAX package's
``config.py``, kept here so the port never imports that package).

The reference has two config tiers (SURVEY.md §6 "Config / flag system"): the
CloudFormation template *Parameters* (cluster shape: instance type, worker
count, key name) and per-training-script argparse flags (``--network``,
``--kv-store``, ``--batch-size``). This module unifies both tiers as nested
dataclasses: :class:`StackConfig` is the cluster tier, the rest are the
training tier, and :class:`ExperimentConfig` is the root. Named presets (one
per BASELINE.json config) live in :mod:`deeplearning_cfn_tpu_torch.presets`; CLI
dotted-key overrides (``train.base_lr=0.2``) replace per-script flags.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass
class MeshConfig:
    """Logical device-mesh shape. Product of axis sizes must equal (or divide
    evenly into) the device count; ``data = -1`` means "all remaining devices".

    Axes:
      data     — batch-dim sharding (the reference's only strategy: Horovod
                 DP-allreduce / KVStore dist_sync both map here).
      model    — tensor-parallel axis; reserved so pjit specs extend later.
      spatial  — image H/W sharding for Mask R-CNN's "data+spatial shard".
      expert   — expert-parallel axis (MoE): stacked expert weights shard
                 over it; batch shards ride it too outside MoE layers, so
                 non-expert compute stays fully data-parallel.
      pipe     — pipeline-parallel axis: stacked trunk layers shard their
                 leading layer dim over it and run the SPMD GPipe schedule
                 (ops/pipeline.py); batch stays replicated across 'pipe'.
      seq      — sequence-parallel (long-context) axis: the bert_long
                 model shards activations' sequence dim over it and runs
                 ring or Ulysses all-to-all attention (ops/ring_attention,
                 ops/ulysses).
      num_slices — multi-slice (DCN) scale-out: >1 builds a hybrid mesh
                 with an outer 'dcn_data' axis spanning slice boundaries.
                 Batch dim shards over (dcn_data, data) jointly; params stay
                 replicated, so the gradient reduction is hierarchical —
                 ICI within each slice, one DCN hop across slices (the
                 reference's analogue: NCCL rings inside a node + TCP/EFA
                 across nodes).
    """

    data: int = -1
    model: int = 1
    spatial: int = 1
    expert: int = 1
    pipe: int = 1
    seq: int = 1
    num_slices: int = 1


@dataclasses.dataclass
class OptimizerConfig:
    name: str = "sgd"  # sgd | momentum | adamw | lars | lamb | adafactor
    momentum: float = 0.9
    nesterov: bool = False
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    # LARS/LAMB trust-region knobs (ResNet-50 large-batch recipe).
    trust_coefficient: float = 0.001
    grad_clip_norm: float = 0.0  # 0 = off


@dataclasses.dataclass
class ScheduleConfig:
    """LR schedule; base_lr is scaled linearly with global batch when
    ``scale_with_batch`` (the Horovod linear-scaling rule the reference's
    ResNet script used)."""

    name: str = "cosine"  # constant | cosine | step | rsqrt
    base_lr: float = 0.1
    warmup_steps: int = 0
    warmup_epochs: float = 0.0
    scale_with_batch: bool = False
    reference_batch: int = 256
    step_boundaries: Tuple[float, ...] = ()  # fractions of total steps
    step_factors: Tuple[float, ...] = ()
    end_lr_factor: float = 0.0


@dataclasses.dataclass
class TrainConfig:
    global_batch: int = 128
    eval_batch: int = 0  # 0 = same as global_batch
    epochs: float = 10.0
    steps: int = 0  # if >0, overrides epochs
    eval_every_steps: int = 0  # 0 = per-epoch
    log_every_steps: int = 50
    seed: int = 0
    dtype: str = "bfloat16"  # compute dtype; params stay f32
    remat: bool = False
    # Capture a device+host profiler trace of this many hot-loop steps
    # (starting after the compile step) to <workdir>/<preset>/profile —
    # the Horovod-timeline role, natively. 0 = off.
    profile_steps: int = 0
    # ZeRO-1: shard param-mirroring optimizer slots over the 'data' axis
    # (params/grads stay replicated; updates bit-identical — see
    # train/state.py). Big win for Adam/LAMB-family state at pod scale.
    shard_opt_state: bool = False
    label_smoothing: float = 0.0
    ema_decay: float = 0.0  # 0 = off
    # Hang watchdog: hard-exit the process (code 89) if no host-sync
    # progress for this many seconds — converts a wedged accelerator
    # backend (process alive, device sync never returns) into the process
    # death the launcher's failure detection already handles: kill,
    # restart, auto-resume from the last committed checkpoint. Must
    # comfortably exceed one full logging interval + compile time
    # (completed long host work — a slow checkpoint write — re-arms the
    # timer rather than counting against it). 0 = off.
    hang_timeout_s: float = 0.0
    # Gradient accumulation: split each global batch into this many
    # microbatches, lax.scan over them accumulating grads, apply the
    # optimizer once. Reproduces the reference recipes' pod-scale global
    # batches (LARS@32k, LAMB@64k) on few chips, and caps activation
    # memory for long-sequence models. Semantics match the Horovod path:
    # the step loss/grad is the mean of per-microbatch means (identical to
    # the full-batch mean for unweighted losses; for weighted losses —
    # MLM, NMT padding — it reweights exactly like per-GPU averaging did).
    # BatchNorm sees microbatch statistics sequentially.
    grad_accum_steps: int = 1
    # Microbatch loop lowering: "scan" (O(1) compile + strict sequential
    # memory — the TPU choice), "unroll" (straight-line bodies), or "auto"
    # (unroll on CPU, where XLA executes convs inside loop bodies ~10x
    # slower than straight-line — measured r04; scan elsewhere).
    grad_accum_unroll: str = "auto"
    # Device-resident fast path: run this many consecutive train steps as
    # one train *window* (the JAX package jits them as ONE lax.scan, paying
    # dispatch and input staging once per window). On the card each step
    # of a window is one replay of a CUDA graph of the whole step, captured
    # after one eager warm-up step (train/graphs.py): one launch in place
    # of the step's thousands. On the CPU a window runs its steps eagerly.
    # Per-step RNG is reseeded from the global step, so the loss
    # trajectory is the per-step loop's for any K (bit for bit where the
    # step has no atomics). Windows clamp to the next
    # log/eval/trace/hook-cadence boundary so every existing cadence lands
    # exactly where it does today. 1 (the default) is the per-step loop.
    step_window: int = 1
    # Host→device input staging depth: batches are device_put with their
    # target shardings on a background thread (double-buffered at the
    # default 2) so transfer overlaps device compute and the step loop
    # never blocks on device_batch. 0 = stage synchronously in the loop.
    device_prefetch: int = 2


@dataclasses.dataclass
class ModelConfig:
    name: str = "resnet20"
    num_classes: int = 10
    # Free-form per-model kwargs (depth, hidden size, heads, ...).
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DataConfig:
    name: str = "cifar10"
    data_dir: str = ""  # empty → synthetic data (no-network environments)
    synthetic: bool = False  # force synthetic even if data_dir exists
    image_size: int = 32
    seq_len: int = 128  # text workloads
    vocab_size: int = 30522
    max_boxes: int = 16  # detection: GT padding size
    num_train_examples: int = 0  # 0 = dataset default
    num_eval_examples: int = 0
    shuffle_buffer: int = 50_000
    prefetch: int = 2
    num_workers: int = 4  # native loader threads
    use_native_loader: bool = True  # C++ dataio if built, else Python


@dataclasses.dataclass
class EvalConfig:
    """Final acceptance-metric evaluation — the reference workloads' own
    yardsticks (SURVEY.md §3.1): corpus BLEU over beam-decoded outputs for
    the Sockeye NMT workload, COCO-style mAP for Mask R-CNN. Runs once at
    the end of ``run_experiment`` and lands in metrics.jsonl as
    ``final_eval_bleu`` / ``final_eval_map``."""

    enabled: bool = True
    # NMT decoding (models/decoding.py).
    beam_size: int = 4  # 1 = greedy
    length_penalty: float = 0.6
    max_decode_len: int = 0  # 0 = data.seq_len
    use_kv_cache: bool = True  # cached O(T) decode vs full recompute
    # Detection inference (train/detection_task.py post-processing).
    detect_topk: int = 100  # fixed detections per image (COCO maxDets)
    detect_score_threshold: float = 0.05
    detect_nms_iou: float = 0.5


@dataclasses.dataclass
class CheckpointConfig:
    directory: str = ""  # empty → <workdir>/ckpt
    every_steps: int = 0  # 0 = per-epoch
    keep: int = 3
    async_write: bool = True
    resume: bool = True  # auto-resume from latest on startup
    # Store-I/O retry policy (ckpt/store.py:RetryingStore): transient
    # faults (GCS 5xx/429, OSError) retry with exponential backoff +
    # deterministic jitter; permanent errors (FileNotFoundError,
    # ValueError) fail fast. retry_attempts counts TOTAL tries per op;
    # <=1 disables the retry layer entirely. retry_timeout_s bounds one
    # logical op across all its attempts so a dead store converts into
    # the process death the launcher's restart path handles.
    retry_attempts: int = 3
    retry_backoff_s: float = 0.5
    retry_backoff_max_s: float = 8.0
    retry_jitter: float = 0.1
    retry_timeout_s: float = 60.0
    # NOTE deliberately no restore-step knob here: rolling back is the
    # imperative `dlcfn-tpu ckpt rollback` verb. A persisted rollback
    # setting would re-delete new progress on every relaunch.


@dataclasses.dataclass
class StackConfig:
    """Cluster tier — the CFN template Parameters, TPU-shaped.

    Reference parameters (instance type, worker count, key name, SSH CIDR,
    EFS id) map to: accelerator type + topology (the slice IS the cluster),
    zone/project (the account context), and no SSH/EFS knobs at all — slice
    hosts rendezvous through the TPU runtime and share storage via GCS.
    """

    name: str = "dlcfn"
    accelerator: str = "tpu"  # tpu | cpu (cpu = local simulation)
    slice_type: str = "v5p-8"  # e.g. v5p-8 ... v5p-256
    zone: str = "us-east5-a"
    project: str = ""
    runtime_version: str = "tpu-ubuntu2204-base"
    preemptible: bool = False
    provisioner: str = "auto"  # auto | gcp | dryrun
    state_dir: str = ""  # empty → ~/.dlcfn_tpu/stacks
    create_timeout_s: int = 1800  # WaitCondition-timeout equivalent


@dataclasses.dataclass
class ExperimentConfig:
    preset: str = ""
    workdir: str = "/tmp/dlcfn_tpu"
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    schedule: ScheduleConfig = dataclasses.field(default_factory=ScheduleConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    checkpoint: CheckpointConfig = dataclasses.field(default_factory=CheckpointConfig)
    stack: StackConfig = dataclasses.field(default_factory=StackConfig)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, default=str)


# ---------------------------------------------------------------------------
# Dotted-key overrides (replaces the reference scripts' argparse flags).
# ---------------------------------------------------------------------------

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off"}


def _coerce(value: str, typ: Any) -> Any:
    """Coerce a CLI string to the dataclass field's annotated type."""
    origin = getattr(typ, "__origin__", None)
    if typ is bool:
        low = value.lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise ValueError(f"cannot parse {value!r} as bool")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    if typ is str:
        return value
    if origin in (tuple, list):
        if not value:
            return origin()
        items = [v.strip() for v in value.split(",")]
        args = getattr(typ, "__args__", (str,))
        elem = args[0] if args else str
        return origin(_coerce(v, elem) for v in items)
    if origin is dict or typ in (dict, Dict[str, Any]):
        return json.loads(value)
    # Optional[...] / Union fallthrough: try each member type.
    args = getattr(typ, "__args__", ())
    for member in args:
        if member is type(None):
            continue
        try:
            return _coerce(value, member)
        except (TypeError, ValueError):
            continue
    raise TypeError(f"unsupported override type {typ!r}")


def _resolve_type(annotation: Any) -> Any:
    if isinstance(annotation, str):
        # from __future__ import annotations stores strings; eval in module ns.
        return eval(annotation, globals())  # noqa: S307 - our own annotations
    return annotation


def apply_overrides(cfg: ExperimentConfig, overrides: List[str]) -> ExperimentConfig:
    """Apply ``a.b.c=value`` strings in place; returns cfg for chaining.

    Unknown keys raise, with the valid keys in the message — the equivalent
    of argparse's unknown-flag error in the reference scripts.
    """
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not of the form key=value")
        dotted, _, raw = item.partition("=")
        parts = dotted.strip().split(".")
        obj: Any = cfg
        for part in parts[:-1]:
            if not dataclasses.is_dataclass(obj) or part not in {
                f.name for f in dataclasses.fields(obj)
            }:
                raise KeyError(f"unknown config section {part!r} in {dotted!r}")
            obj = getattr(obj, part)
        leaf = parts[-1]
        if dataclasses.is_dataclass(obj):
            fields = {f.name: f for f in dataclasses.fields(obj)}
            if leaf not in fields:
                raise KeyError(
                    f"unknown config key {dotted!r}; valid keys in this section: "
                    f"{sorted(fields)}"
                )
            typ = _resolve_type(fields[leaf].type)
            setattr(obj, leaf, _coerce(raw, typ))
        elif isinstance(obj, dict):
            # model.kwargs.depth=20 style: store as JSON-ish scalar.
            try:
                obj[leaf] = json.loads(raw)
            except json.JSONDecodeError:
                obj[leaf] = raw
        else:
            raise KeyError(f"cannot set {dotted!r} on {type(obj).__name__}")
    return cfg
