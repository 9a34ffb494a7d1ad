"""Named experiment presets — the five BASELINE.json acceptance configs
(a copy of the JAX package's ``presets.py``).

These are the rebuild's equivalent of the reference's bundled example scripts
(SURVEY.md §3.1): each preset pins the model/data/optimizer/schedule recipe the
corresponding reference workload used, re-expressed for the pjit-DP trainer.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List

from .config import (
    CheckpointConfig,
    DataConfig,
    ExperimentConfig,
    MeshConfig,
    ModelConfig,
    OptimizerConfig,
    ScheduleConfig,
    StackConfig,
    TrainConfig,
)

_REGISTRY: Dict[str, Callable[[], ExperimentConfig]] = {}


def register_preset(name: str):
    def deco(fn: Callable[[], ExperimentConfig]):
        if name in _REGISTRY:
            raise ValueError(f"duplicate preset {name!r}")
        _REGISTRY[name] = fn
        return fn

    return deco


def list_presets() -> List[str]:
    return sorted(_REGISTRY)


def get_preset(name: str) -> ExperimentConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown preset {name!r}; available: {list_presets()}")
    cfg = _REGISTRY[name]()
    cfg.preset = name
    return copy.deepcopy(cfg)


@register_preset("cifar10_resnet20")
def _cifar10_resnet20() -> ExperimentConfig:
    """CIFAR-10 ResNet-20 — the reference's CPU-runnable smoke workload
    (MXNet ``train_cifar10.py --network resnet --kv-store dist_sync``)."""
    return ExperimentConfig(
        model=ModelConfig(name="resnet20", num_classes=10),
        data=DataConfig(name="cifar10", image_size=32),
        train=TrainConfig(global_batch=128, epochs=60.0, dtype="float32"),
        optimizer=OptimizerConfig(name="momentum", momentum=0.9, weight_decay=1e-4),
        schedule=ScheduleConfig(
            name="step",
            base_lr=0.1,
            warmup_epochs=1.0,
            step_boundaries=(0.5, 0.75),
            step_factors=(0.1, 0.01),
        ),
        mesh=MeshConfig(data=-1),
        stack=StackConfig(slice_type="v5p-8"),
    )


@register_preset("imagenet_resnet50")
def _imagenet_resnet50() -> ExperimentConfig:
    """ImageNet ResNet-50 DP — the north-star config (reference: TF+Horovod
    ResNet-50, NCCL allreduce over EFA). Large-batch LARS recipe to 75.9%."""
    return ExperimentConfig(
        model=ModelConfig(name="resnet50", num_classes=1000),
        data=DataConfig(name="imagenet", image_size=224),
        train=TrainConfig(global_batch=8192, epochs=90.0, dtype="bfloat16",
                          label_smoothing=0.1),
        optimizer=OptimizerConfig(
            name="lars", momentum=0.9, weight_decay=1e-4, trust_coefficient=0.001
        ),
        schedule=ScheduleConfig(
            name="cosine",
            base_lr=2.0,  # LARS base for batch 8192 ("
            warmup_epochs=5.0,
            scale_with_batch=True,
            reference_batch=8192,
        ),
        mesh=MeshConfig(data=-1),
        stack=StackConfig(slice_type="v5p-256"),
    )


@register_preset("bert_base_wikipedia")
def _bert_base() -> ExperimentConfig:
    """BERT-base MLM+NSP pretraining (reference: TF+Horovod BERT scripts).

    Recipe fidelity: hidden/layers/heads/mlp and dropout 0.1 match the
    BERT-base paper config the reference scripts ran. Intentional
    deviations: LAMB instead of Adam (the established large-batch BERT
    recipe — the reference's batch was per-GPU Adam at an older scale) and
    a cosine decay instead of linear (equivalent envelope, one scheduler
    fewer).
    """
    return ExperimentConfig(
        model=ModelConfig(
            name="bert_base",
            num_classes=2,  # NSP head
            kwargs=dict(
                hidden_size=768, num_layers=12, num_heads=12, mlp_dim=3072,
                max_len=512, dropout_rate=0.1,
            ),
        ),
        data=DataConfig(name="wikipedia_mlm", seq_len=128, vocab_size=30522),
        train=TrainConfig(global_batch=1024, steps=100_000, dtype="bfloat16",
                          shard_opt_state=True),  # ZeRO-1: LAMB slots /N
        optimizer=OptimizerConfig(name="lamb", weight_decay=0.01,
                                  grad_clip_norm=1.0),
        schedule=ScheduleConfig(name="cosine", base_lr=1e-3, warmup_steps=3000),
        mesh=MeshConfig(data=-1),
        stack=StackConfig(slice_type="v5p-64"),
    )


@register_preset("bert_moe_wikipedia")
def _bert_moe() -> ExperimentConfig:
    """BERT-base with Mixture-of-Experts FFNs (every other layer, 8
    experts, top-2) on a data×expert mesh — the expert-parallelism
    flagship. No reference equivalent (SURVEY.md §3.2 lists EP as absent);
    recipe is bert_base_wikipedia's with the GShard layer convention and
    ST-MoE aux-loss weights (train/task.py)."""
    return ExperimentConfig(
        model=ModelConfig(
            name="bert_base",
            num_classes=2,
            kwargs=dict(
                hidden_size=768, num_layers=12, num_heads=12, mlp_dim=3072,
                max_len=512, dropout_rate=0.1,
                num_experts=8, moe_every=2, moe_top_k=2,
            ),
        ),
        data=DataConfig(name="wikipedia_mlm", seq_len=128, vocab_size=30522),
        train=TrainConfig(global_batch=1024, steps=100_000, dtype="bfloat16",
                          shard_opt_state=True),
        optimizer=OptimizerConfig(name="lamb", weight_decay=0.01,
                                  grad_clip_norm=1.0),
        schedule=ScheduleConfig(name="cosine", base_lr=1e-3, warmup_steps=3000),
        mesh=MeshConfig(data=-1, expert=8),
        stack=StackConfig(slice_type="v5p-64"),
    )


@register_preset("bert_pipelined_wikipedia")
def _bert_pipelined() -> ExperimentConfig:
    """BERT-base with the trunk pipelined over 4 stages (GPipe schedule,
    ops/pipeline.py) — the pipeline-parallelism flagship. No reference
    equivalent (SURVEY.md §3.2 lists PP as absent). Dropout must be 0 in
    the pipelined trunk (models/pipelined.py); 8 microbatches keep the
    bubble at (4-1)/(8+4-1) ≈ 27% of ticks."""
    return ExperimentConfig(
        model=ModelConfig(
            name="bert_pipelined",
            num_classes=2,
            kwargs=dict(
                hidden_size=768, num_layers=12, num_heads=12, mlp_dim=3072,
                max_len=512, n_microbatches=8,
            ),
        ),
        data=DataConfig(name="wikipedia_mlm", seq_len=128, vocab_size=30522),
        train=TrainConfig(global_batch=1024, steps=100_000, dtype="bfloat16",
                          shard_opt_state=True),
        optimizer=OptimizerConfig(name="lamb", weight_decay=0.01,
                                  grad_clip_norm=1.0),
        schedule=ScheduleConfig(name="cosine", base_lr=1e-3, warmup_steps=3000),
        mesh=MeshConfig(data=-1, pipe=4),
        stack=StackConfig(slice_type="v5p-64"),
    )


@register_preset("bert_long_wikipedia")
def _bert_long() -> ExperimentConfig:
    """Long-context BERT: sequence 4096 with ring attention over a 'seq'
    mesh axis (models/bert_long.py) — the long-context flagship. No
    reference equivalent (its max sequence was BERT's 512 — SURVEY.md §6);
    packed-sequence contract (no padding bias). Switch strategy with
    model.kwargs.seq_impl=ulysses (needs heads % seq ways == 0)."""
    return ExperimentConfig(
        model=ModelConfig(
            name="bert_long",
            num_classes=2,
            kwargs=dict(
                hidden_size=768, num_layers=12, num_heads=12, mlp_dim=3072,
                max_len=4096, seq_impl="ring",
            ),
        ),
        data=DataConfig(name="wikipedia_mlm", seq_len=4096,
                        vocab_size=30522),
        train=TrainConfig(global_batch=256, steps=100_000, dtype="bfloat16",
                          shard_opt_state=True),
        optimizer=OptimizerConfig(name="lamb", weight_decay=0.01,
                                  grad_clip_norm=1.0),
        schedule=ScheduleConfig(name="cosine", base_lr=6e-4,
                                warmup_steps=3000),
        mesh=MeshConfig(data=-1, seq=4),
        stack=StackConfig(slice_type="v5p-64"),
    )


@register_preset("gpt_long_lm")
def _gpt_long() -> ExperimentConfig:
    """Long-context causal LM: GPT trunk at sequence 16384 with ring
    attention over a 'seq' mesh axis (models/lm.py LongCausalLm) — the
    causal long-context flagship, proving the sequence-parallel ops'
    causal masking at scale. Same recipe family as gpt_small_lm; packed
    sequences. seq_impl=ulysses needs heads % seq ways == 0 — with this
    preset's 12 heads that means also setting mesh.seq to 4 or 6 (the
    default 8 does not divide 12)."""
    return ExperimentConfig(
        model=ModelConfig(
            name="gpt_long",
            kwargs=dict(
                hidden_size=768, num_layers=12, num_heads=12, mlp_dim=3072,
                max_len=16384, seq_impl="ring",
            ),
        ),
        data=DataConfig(name="lm_text", seq_len=16384, vocab_size=32768),
        train=TrainConfig(global_batch=64, steps=100_000, dtype="bfloat16",
                          shard_opt_state=True, grad_accum_steps=2),
        optimizer=OptimizerConfig(name="adamw", b1=0.9, b2=0.95,
                                  weight_decay=0.1, grad_clip_norm=1.0),
        schedule=ScheduleConfig(name="cosine", base_lr=3e-4,
                                warmup_steps=2000),
        mesh=MeshConfig(data=-1, seq=8),
        stack=StackConfig(slice_type="v5p-64"),
    )


@register_preset("maskrcnn_coco")
def _maskrcnn() -> ExperimentConfig:
    """Mask R-CNN COCO — the one beyond-DP config: pjit data+spatial shard
    (reference: TensorPack HorovodTrainer multi-node)."""
    return ExperimentConfig(
        model=ModelConfig(
            name="maskrcnn_resnet50",
            num_classes=91,
            kwargs=dict(image_size=1024),  # GT padding is data.max_boxes
        ),
        data=DataConfig(name="coco", image_size=1024, max_boxes=100),
        train=TrainConfig(global_batch=64, epochs=24.0, dtype="bfloat16"),
        optimizer=OptimizerConfig(name="momentum", momentum=0.9,
                                  weight_decay=1e-4, grad_clip_norm=10.0),
        schedule=ScheduleConfig(
            name="step", base_lr=0.08, warmup_steps=500,
            step_boundaries=(0.66, 0.88), step_factors=(0.1, 0.01),
        ),
        mesh=MeshConfig(data=-1, spatial=2),
        stack=StackConfig(slice_type="v5p-64"),
    )


@register_preset("imagenet_vit_s16")
def _vit_s16() -> ExperimentConfig:
    """ViT-Small/16 ImageNet from scratch — beyond the reference's
    conv-era vision stack (models/vit.py explains the inclusion). Recipe:
    the DeiT-style from-scratch setup — AdamW(0.9, 0.999) wd 0.05, cosine
    with warmup, dropout 0.1, 300-epoch-equivalent step budget; GAP head.
    """
    return ExperimentConfig(
        model=ModelConfig(
            name="vit_s16", num_classes=1000,
            kwargs=dict(dropout_rate=0.1),
        ),
        data=DataConfig(name="imagenet", image_size=224),
        train=TrainConfig(global_batch=1024, epochs=300, dtype="bfloat16",
                          label_smoothing=0.1, shard_opt_state=True),
        optimizer=OptimizerConfig(name="adamw", weight_decay=0.05,
                                  grad_clip_norm=1.0),
        schedule=ScheduleConfig(name="cosine", base_lr=1e-3,
                                warmup_epochs=5.0),
        mesh=MeshConfig(data=-1),
        stack=StackConfig(slice_type="v5p-64"),
    )


@register_preset("gpt_small_lm")
def _gpt_small() -> ExperimentConfig:
    """GPT-2-small decoder-only LM pretraining — beyond the reference's
    workload era (its newest family is BERT); included because one causal
    trunk exercises flash causal attention, KV-cached decode, TP rules,
    and gradient accumulation together (models/lm.py). Recipe: GPT-2/124M
    dims, AdamW(0.9, 0.95) wd 0.1, cosine to zero after linear warmup,
    grad clip 1.0 — the now-standard small-LM pretraining recipe."""
    return ExperimentConfig(
        model=ModelConfig(
            name="gpt_small",
            kwargs=dict(max_len=1024, dropout_rate=0.1),
        ),
        data=DataConfig(name="lm_text", seq_len=1024, vocab_size=32768),
        train=TrainConfig(global_batch=512, steps=100_000, dtype="bfloat16",
                          grad_accum_steps=1, shard_opt_state=True),
        optimizer=OptimizerConfig(name="adamw", b1=0.9, b2=0.95,
                                  weight_decay=0.1, grad_clip_norm=1.0),
        schedule=ScheduleConfig(name="cosine", base_lr=6e-4,
                                warmup_steps=2000),
        mesh=MeshConfig(data=-1),
        stack=StackConfig(slice_type="v5p-32"),
    )


@register_preset("transformer_nmt_wmt")
def _nmt() -> ExperimentConfig:
    """Transformer NMT WMT En-De (reference: Sockeye + MXNet
    ``--kvstore dist_device_sync``).

    Recipe fidelity: transformer-base dims, dropout 0.1, label smoothing
    0.1, Adam(0.9, 0.98) with rsqrt/4000-warmup — the Sockeye/"Attention
    Is All You Need" base recipe. Intentional deviations: pre-LN blocks
    (stable without Sockeye's custom init; post-LN needs it) and tied
    source/target/output embeddings (Sockeye's default, kept).
    """
    return ExperimentConfig(
        model=ModelConfig(
            name="transformer_nmt",
            kwargs=dict(
                hidden_size=512, num_layers=6, num_heads=8, mlp_dim=2048,
                dropout_rate=0.1,
            ),
        ),
        data=DataConfig(name="wmt_en_de", seq_len=128, vocab_size=32000),
        train=TrainConfig(global_batch=2048, steps=100_000, dtype="bfloat16",
                          label_smoothing=0.1),
        optimizer=OptimizerConfig(name="adamw", b1=0.9, b2=0.98,
                                  weight_decay=0.0, grad_clip_norm=0.0),
        schedule=ScheduleConfig(name="rsqrt", base_lr=1.0, warmup_steps=4000),
        mesh=MeshConfig(data=-1),
        stack=StackConfig(slice_type="v5p-32"),
    )
