"""Task definitions: glue a model into the Trainer's loss_fn contract — the
port of ``deeplearning_cfn_tpu/train/task.py`` for the NMT, ResNet, BERT and
GPT workloads.

A task owns its model and gives the trainer
``loss_fn(batch, train, generator) -> (loss, aux)``: a global-batch mean loss
and a dict of scalar metrics (on eval, ``eval_weight`` and per-metric
``<name>__weight`` too). Across processes each process holds a block of the
global batch's rows, and a mean divides this process's sum by the count
over every process (``parallel.collectives.global_total``), as the JAX
loss, one program over the global batch, does: the processes' losses and
metrics are then partials that add up to the global ones, and so do their
gradients. A weight is this process's own count. The processes of a
``seq``, ``pipe``, ``model`` or ``spatial`` group hold the same rows
(``Mesh.replicas`` of them each): a model that returns a slice of each
row's positions (``gpt_long``) has the task take that slice's targets, and
a model that returns whole rows on each of them (every other model: the
gathered ``bert_long``, the pipelined trunk's last stage and the
tensor-parallel layers' summed outputs included) has its weights divided
by the replicas, so that every denominator counts each example and token
once. Metrics that every process
computes whole are listed in the task's ``replicated_metrics``. A task's ``eval_derived`` maps a metric name to a
function of the aggregated eval metrics (the trainer adds it after the
cross-batch aggregation). Detection (Mask R-CNN) is
``train/detection_task.py``. A model whose output carries MoE aux losses
adds them to the objective at the ST-MoE weights (``MOE_LOAD_BALANCE_WEIGHT``,
``MOE_ROUTER_Z_WEIGHT``), as the JAX tasks do; every transformer model gets
the task's mesh (its heads and hidden units over the ``model`` axis, its
experts or layers across processes, and the router's global-batch
statistics), as JAX gives the tasks the trainer's mesh.

``train.remat`` recomputes the train forward in the backward, where the JAX
tasks wrap it in ``jax.checkpoint`` (:func:`remat`).
"""

from __future__ import annotations

import contextlib
import sys
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import ExperimentConfig
from ..models import build_model
from ..parallel.collectives import gather_batches, global_total
from ..parallel.mesh import Mesh, build_mesh

Batch = Dict[str, torch.Tensor]

# MoE auxiliary-loss weights (ST-MoE's standard values), for models whose
# outputs report router losses (models/moe.py).
MOE_LOAD_BALANCE_WEIGHT = 0.01
MOE_ROUTER_Z_WEIGHT = 0.001


def init_model(model: nn.Module, generator: torch.Generator) -> None:
    """The seeded Flax-distribution init of the module that defines
    ``model``'s class (each model family owns its ``init_weights``)."""
    sys.modules[type(model).__module__].init_weights(model, generator)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  smoothing: float = 0.0) -> torch.Tensor:
    """Per-position cross-entropy in f32, with optax's label smoothing: the
    true class gets ``1 − s`` and every other class ``s / (V − 1)``. (That
    is not ``F.cross_entropy(label_smoothing=s)``, which spreads ``s / V``
    over every class, the true one included.) Computed as
    ``−(on − off)·logp[label] − off·Σ logp`` without building the one-hot."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None]).squeeze(-1)
    if smoothing > 0:
        num_classes = logits.shape[-1]
        on = 1.0 - smoothing
        off = smoothing / (num_classes - 1)
        return (on - off) * nll - off * logp.sum(-1)
    return nll


def example_mask(batch: Batch, n: int) -> torch.Tensor:
    """Per-example validity [B]: the pipeline's eval-tail padding mask when
    present (drop_remainder=False), else all-ones."""
    mask = batch.get("eval_mask")
    if mask is None:
        device = next(iter(batch.values())).device
        return torch.ones((n,), dtype=torch.float32, device=device)
    return mask.float()


def remat(model: nn.Module, fn: Callable, generator: Optional[torch.Generator],
          *args):
    """``jax.checkpoint`` of a train forward: ``fn(*args)`` keeps only its
    inputs for the backward, which runs it again (``torch.utils.checkpoint``,
    non-reentrant). The recompute must be the same function of the same
    inputs, so its context (1) draws from the explicit dropout ``generator``
    as it stood at entry — the stock recompute restores only the global
    RNGs, and would draw other masks — and afterwards leaves the generator
    where the recompute found it, and (2) holds every module with a
    ``freeze_stats`` flag (the port's BatchNorm) to its running statistics,
    which the forward already moved once, as the JAX step returns them once.
    The trainer's generator (``train.graphs.StepGenerator``) does (1) in a
    way a CUDA graph can capture; any other is rewound by its state.
    """
    from torch.utils.checkpoint import checkpoint

    from .graphs import StepGenerator, rewound_to_state

    if isinstance(generator, StepGenerator):
        point = generator.rewind_point()
        rewound = lambda: generator.rewound(point)
    elif generator is not None:
        entry = generator.get_state()
        rewound = lambda: rewound_to_state(generator, entry)
    else:
        rewound = contextlib.nullcontext

    @contextlib.contextmanager
    def recompute():
        frozen = [m for m in model.modules() if hasattr(m, "freeze_stats")]
        for m in frozen:
            m.freeze_stats = True
        try:
            with rewound():
                yield
        finally:
            for m in frozen:
                m.freeze_stats = False

    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          recompute()))


class Seq2SeqTask:
    """Transformer NMT (reference: Sockeye MXNet, dist_device_sync).

    Per-token label-smoothed cross-entropy, masked to real target positions,
    normalized by the batch's token count (Sockeye's per-token loss).
    """

    exact_eval = True

    def __init__(self, cfg: ExperimentConfig, device: torch.device,
                 attention_impl: Optional[str] = None,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.device = device
        self.mesh = mesh if mesh is not None else build_mesh(cfg.mesh)
        dtype = torch.bfloat16 if cfg.train.dtype == "bfloat16" \
            else torch.float32
        kwargs = dict(cfg.model.kwargs)
        kwargs.setdefault("vocab_size", cfg.data.vocab_size)
        kwargs.setdefault("max_len", max(cfg.data.seq_len, 64))
        kwargs.setdefault("mesh", self.mesh)
        if attention_impl is not None:
            kwargs["attention_impl"] = attention_impl
        self.model = build_model(cfg.model.name, 0, dtype, device=device,
                                 **kwargs)
        self.remat = cfg.train.remat

    def init(self, generator: torch.Generator) -> None:
        """Seeded init with Flax's distributions, on the model's device."""
        from ..models.transformer_nmt import init_weights

        init_weights(self.model, generator)

    def loss_fn(self, batch: Batch, train: bool,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        apply = lambda *ids: self.model(*ids, train=train,
                                        generator=generator)
        ids = (batch["src_ids"], batch["src_mask"], batch["tgt_in_ids"])
        logits = remat(self.model, apply, generator, *ids) \
            if train and self.remat else apply(*ids)
        ex_mask = example_mask(batch, batch["src_ids"].shape[0]) \
            / self.mesh.replicas
        mask = batch["tgt_mask"].float() * ex_mask[:, None]
        ce = cross_entropy(logits, batch["tgt_out_ids"],
                           self.cfg.train.label_smoothing)
        denom = torch.clamp(global_total(mask.sum()), min=1e-6)
        loss = (ce * mask).sum() / denom
        hits = (torch.argmax(logits, -1) == batch["tgt_out_ids"]).float()
        aux = {"token_accuracy": (hits * mask).sum() / denom}
        if not train:
            # Token-weighted: Sockeye's per-token loss convention.
            aux["eval_weight"] = mask.sum()
        return loss, aux

    def final_eval(self, state, eval_iter_fn: Callable[[], Iterator]
                   ) -> Dict[str, float]:
        """Decode the eval set with the beam (or greedy, ``beam_size <=
        1``) searcher — KV-cached, or recomputing the decoder each step with
        ``eval.use_kv_cache=false`` — and score corpus BLEU, the Sockeye
        workload's acceptance metric."""
        from ..data.pipeline import to_device
        from ..metrics.bleu import corpus_bleu
        from ..models import decoding
        from ..models.decoding import strip_special

        ev = self.cfg.eval
        if not ev.enabled:
            return {}
        max_len = ev.max_decode_len or self.cfg.data.seq_len
        if max_len > self.model.max_len:
            raise ValueError(
                f"eval decode length {max_len} exceeds the model's "
                f"max_len {self.model.max_len}")
        greedy = decoding.greedy_decode_cached if ev.use_kv_cache \
            else decoding.greedy_decode
        beam = decoding.beam_decode_cached if ev.use_kv_cache \
            else decoding.beam_decode
        per_batch = []
        with state.eval_weights() as model:
            for batch in eval_iter_fn():
                dev = to_device(batch, self.device)
                if ev.beam_size <= 1:
                    out = greedy(model, dev["src_ids"], dev["src_mask"],
                                 max_len)
                else:
                    out, _ = beam(model, dev["src_ids"], dev["src_mask"],
                                  max_len, ev.beam_size, ev.length_penalty)
                out = out.cpu().numpy()
                tgt = np.asarray(batch["tgt_out_ids"])
                emask = batch.get("eval_mask")
                per_batch.append([
                    (strip_special(out[i]), strip_special(tgt[i]))
                    for i in range(out.shape[0])
                    if emask is None or emask[i] != 0])
        # Across processes every one scores the whole eval set (the JAX
        # task all-gathers the decoded ids), each row once.
        pairs = gather_batches(per_batch, self.mesh)
        return {"bleu": corpus_bleu([h for h, _ in pairs],
                                    [r for _, r in pairs], smooth=True)}


class ClassificationTask:
    """Image classification (CIFAR ResNet-20, ImageNet ResNet-50, ViT).

    Batch contract: ``{"image": [B,H,W,C] float32, "label": [B] int}``.
    A ResNet's BatchNorm running statistics are buffers, not parameters:
    a train-mode forward updates them (in microbatch order under gradient
    accumulation, as the JAX step threads ``batch_stats``), an eval-mode
    forward reads them, and the parameters' EMA does not cover them. A
    stats-free model (ViT) takes a true train-mode forward, its dropout
    drawn from the step's generator.
    """

    exact_eval = True  # consumes eval_mask; gets the padded full eval set

    def __init__(self, cfg: ExperimentConfig, device: torch.device,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.device = device
        self.mesh = mesh if mesh is not None else build_mesh(cfg.mesh)
        dtype = torch.bfloat16 if cfg.train.dtype == "bfloat16" \
            else torch.float32
        kwargs = dict(cfg.model.kwargs)
        self.stats_free = cfg.model.name.startswith("vit")
        if self.stats_free:
            # The JAX module sizes its position table from the init's
            # dummy image; the port's from the data config.
            kwargs.setdefault("image_size", cfg.data.image_size)
            kwargs.setdefault("mesh", self.mesh)
        self.model = build_model(cfg.model.name, cfg.model.num_classes,
                                 dtype, device=device, **kwargs)
        self.remat = cfg.train.remat

    def init(self, generator: torch.Generator) -> None:
        """Seeded init with Flax's distributions, on the model's device."""
        init_model(self.model, generator)

    def loss_fn(self, batch: Batch, train: bool,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if self.stats_free:
            apply = lambda images: self.model(images, train=train,
                                              generator=generator)
        else:
            generator = None  # no dropout in the ResNets
            apply = lambda images: self.model(images, train=train)
        logits = remat(self.model, apply, generator, batch["image"]) \
            if train and self.remat else apply(batch["image"])
        labels = batch["label"]
        mask = example_mask(batch, logits.shape[0]) / self.mesh.replicas
        denom = torch.clamp(global_total(mask.sum()), min=1e-6)
        ce = cross_entropy(logits, labels, self.cfg.train.label_smoothing)
        loss = (ce * mask).sum() / denom
        correct = (torch.argmax(logits, -1) == labels).float()
        aux = {"accuracy": (correct * mask).sum() / denom}
        if not train:
            # Top-5 by a rank comparison (one reduction, no sort): the
            # label is in the top 5 when fewer than 5 logits beat it.
            label_logit = logits.gather(-1, labels.long()[:, None])
            rank = (logits > label_logit).sum(-1)
            aux["accuracy_top5"] = ((rank < 5).float() * mask).sum() / denom
            aux["eval_weight"] = mask.sum()
        return loss, aux


class MlmTask:
    """BERT MLM+NSP pretraining (reference: TF+Horovod BERT scripts).

    Loss = the masked-LM cross-entropy, a weighted mean over the real
    predictions (``mlm_weights``), plus the next-sentence cross-entropy, an
    example mean, plus, for a MoE trunk, the weighted aux losses (reported
    as ``moe_load_balance`` and ``moe_router_z``). Eval metrics carry their
    own weights: the MLM ones by token (``mlm_loss__weight``,
    ``mlm_accuracy__weight``), the rest by example (``eval_weight``).
    ``bert_pipelined`` gets the mesh and runs its stacked trunk under the
    GPipe schedule across a ``pipe`` axis; on one process it runs the plain
    layer scan, and the preset's ``n_microbatches`` and ``mesh.pipe`` are
    printed as ignored. Every trunk gets the mesh, as JAX gives the long and
    pipelined trunks the trainer's mesh and batch axes (and GSPMD the MoE
    and tensor-parallel layers).
    """

    exact_eval = True

    def __init__(self, cfg: ExperimentConfig, device: torch.device,
                 attention_impl: Optional[str] = None,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.device = device
        self.mesh = mesh if mesh is not None else build_mesh(cfg.mesh)
        if cfg.model.name == "bert_pipelined" and \
                self.mesh.pipe_ways == 1:
            print(f"[dlcfn-tpu] bert_pipelined on one device: the plain "
                  f"layer scan; n_microbatches="
                  f"{cfg.model.kwargs.get('n_microbatches', 4)} and "
                  f"mesh.pipe={cfg.mesh.pipe} are ignored (the GPipe "
                  f"schedule runs across the processes of a pipe axis)")
        dtype = torch.bfloat16 if cfg.train.dtype == "bfloat16" \
            else torch.float32
        kwargs = dict(cfg.model.kwargs)
        kwargs.setdefault("vocab_size", cfg.data.vocab_size)
        kwargs.setdefault("max_len", max(cfg.data.seq_len, 128))
        if attention_impl is not None:
            kwargs["attention_impl"] = attention_impl
        kwargs.setdefault("mesh", self.mesh)
        self.model = build_model(cfg.model.name, cfg.model.num_classes,
                                 dtype, device=device, **kwargs)
        self.remat = cfg.train.remat

    def init(self, generator: torch.Generator) -> None:
        """Seeded init with Flax's distributions, on the model's device."""
        init_model(self.model, generator)

    def loss_fn(self, batch: Batch, train: bool,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        apply = lambda *xs: self.model(*xs, train=train, generator=generator)
        xs = (batch["input_ids"], batch["input_mask"], batch["segment_ids"],
              batch["mlm_positions"])
        out = remat(self.model, apply, generator, *xs) \
            if train and self.remat else apply(*xs)
        # Whole rows on every process of a seq, pipe or model group: each
        # holds a 1/n share of them.
        mask = example_mask(batch, batch["input_ids"].shape[0]) \
            / self.mesh.replicas
        weights = batch["mlm_weights"].float() * mask[:, None]
        mlm_ce = cross_entropy(out["mlm_logits"], batch["mlm_ids"])
        token_denom = torch.clamp(global_total(weights.sum()), min=1e-6)
        mlm_loss = (mlm_ce * weights).sum() / token_denom
        example_denom = torch.clamp(global_total(mask.sum()), min=1e-6)
        nsp_ce = cross_entropy(out["nsp_logits"], batch["nsp_label"])
        nsp_loss = (nsp_ce * mask).sum() / example_denom
        mlm_hits = (torch.argmax(out["mlm_logits"], -1)
                    == batch["mlm_ids"]).float()
        nsp_hits = (torch.argmax(out["nsp_logits"], -1)
                    == batch["nsp_label"]).float()
        aux = {"mlm_loss": mlm_loss, "nsp_loss": nsp_loss,
               "mlm_accuracy": (mlm_hits * weights).sum() / token_denom,
               "nsp_accuracy": (nsp_hits * mask).sum() / example_denom}
        loss = mlm_loss + nsp_loss
        if "moe_load_balance" in out:
            loss = loss + MOE_LOAD_BALANCE_WEIGHT * out["moe_load_balance"] \
                + MOE_ROUTER_Z_WEIGHT * out["moe_router_z"]
            aux["moe_load_balance"] = out["moe_load_balance"]
            aux["moe_router_z"] = out["moe_router_z"]
        if not train:
            aux["eval_weight"] = mask.sum()
            aux["mlm_loss__weight"] = weights.sum()
            aux["mlm_accuracy__weight"] = weights.sum()
        return loss, aux


class CausalLmTask:
    """Decoder-only next-token pretraining (the GPT family).

    Loss = the token-weighted mean cross-entropy of ``tokens[:, 1:]`` given
    ``tokens[:, :-1]``, weighted by ``loss_mask`` × the example mask, plus,
    for a MoE trunk, the weighted aux losses (the perplexity stays on the
    cross-entropy alone). Train
    metrics: ``token_accuracy`` and this step's ``perplexity`` (exp of its
    CE, clipped at 20 against a random init's overflow); eval metrics are
    token-weighted (``eval_weight`` is the batch's real token count) and
    include ``ce_loss``, from which ``eval_derived`` makes the exact
    perplexity after aggregation — a mean of per-batch exp(CE) is not one.
    ``gpt_long`` gets the mesh, as JAX gives it the trainer's mesh and batch
    axes; with a ``seq`` axis it returns the logits of this process's
    positions, and the loss takes those positions' targets and weights.
    Batch contract: ``data/text.py:make_lm_source``.
    """

    exact_eval = True
    eval_derived = {
        "perplexity": lambda m: float(np.exp(min(m["ce_loss"], 20.0))),
    }
    replicated_metrics = ("perplexity",)

    def __init__(self, cfg: ExperimentConfig, device: torch.device,
                 attention_impl: Optional[str] = None,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.device = device
        self.mesh = mesh if mesh is not None else build_mesh(cfg.mesh)
        dtype = torch.bfloat16 if cfg.train.dtype == "bfloat16" \
            else torch.float32
        kwargs = dict(cfg.model.kwargs)
        kwargs.setdefault("vocab_size", cfg.data.vocab_size)
        kwargs.setdefault("max_len", max(cfg.data.seq_len, 128))
        if attention_impl is not None:
            kwargs["attention_impl"] = attention_impl
        kwargs.setdefault("mesh", self.mesh)
        self.model = build_model(cfg.model.name, 0, dtype, device=device,
                                 **kwargs)
        self.remat = cfg.train.remat

    def init(self, generator: torch.Generator) -> None:
        """Seeded init with Flax's distributions, on the model's device."""
        init_model(self.model, generator)

    def loss_fn(self, batch: Batch, train: bool,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        apply = lambda ids: self.model(ids, train=train, generator=generator)
        inputs = batch["tokens"][:, :-1]
        targets = batch["tokens"][:, 1:]
        out = remat(self.model, apply, generator, inputs) \
            if train and self.remat else apply(inputs)
        logits, moe_aux = out if isinstance(out, tuple) else (out, None)
        mask = example_mask(batch, inputs.shape[0])
        weights = batch["loss_mask"].float() * mask[:, None]
        if hasattr(self.model, "seq_slice"):
            # This process's positions: the label of its last one is the
            # next slice's first token, which the whole row holds.
            mine = self.model.seq_slice(inputs.shape[1])
            targets, weights = targets[:, mine], weights[:, mine]
        else:
            weights = weights / self.mesh.replicas
        ce = cross_entropy(logits, targets)
        denom = torch.clamp(global_total(weights.sum()), min=1e-6)
        ce_loss = (ce * weights).sum() / denom
        hits = (torch.argmax(logits, -1) == targets).float()
        aux = {"token_accuracy": (hits * weights).sum() / denom}
        loss = ce_loss
        if moe_aux is not None:
            loss = loss + MOE_LOAD_BALANCE_WEIGHT * moe_aux["load_balance"] \
                + MOE_ROUTER_Z_WEIGHT * moe_aux["router_z"]
            aux["moe_load_balance"] = moe_aux["load_balance"]
            aux["moe_router_z"] = moe_aux["router_z"]
        if train:
            # Of the global CE: every process holds the whole value.
            aux["perplexity"] = torch.exp(torch.clamp(
                global_total(ce_loss.detach()), max=20.0))
        else:
            aux["ce_loss"] = ce_loss
            aux["eval_weight"] = weights.sum()
        return loss, aux


def build_task(cfg: ExperimentConfig, device: torch.device,
               attention_impl: Optional[str] = None,
               mesh: Optional[Mesh] = None):
    """Task registry keyed by model family (NMT, ResNet, ViT, BERT and its
    MoE, pipelined and long-context trunks, GPT and its long-context trunk,
    Mask R-CNN). ``mesh`` defaults to ``build_mesh(cfg.mesh)``."""
    name = cfg.model.name
    if name.startswith("transformer_nmt"):
        return Seq2SeqTask(cfg, device, attention_impl, mesh)
    if name.startswith(("resnet", "vit")):
        return ClassificationTask(cfg, device, mesh)
    if name.startswith("gpt"):
        return CausalLmTask(cfg, device, attention_impl, mesh)
    if name.startswith("bert"):
        return MlmTask(cfg, device, attention_impl, mesh)
    if name.startswith("maskrcnn"):
        from .detection_task import DetectionTask

        return DetectionTask(cfg, device, mesh)
    raise KeyError(f"no task for model {name!r}")
